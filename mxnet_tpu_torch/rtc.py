"""Runtime kernel compilation: CUDA-C source compiled at run time with
NVRTC and launched with the CUDA driver API, the port of
``mxnet_tpu/rtc.py``.

The JAX package's ``PallasModule`` ``exec``s Pallas Python source and
runs it through ``pl.pallas_call`` (``mxnet_tpu/rtc.py:88``), with
``CudaModule`` as an alias. This module makes ``CudaModule`` what it was
in the reference MXNet (``src/common/rtc.cc``, ``python/mxnet/rtc.py``):

* ``CudaModule(source, options, exports)`` compiles CUDA-C ``source``
  with NVRTC, for the card's own architecture (``sm_90a`` on an H100),
  to a CUBIN, and loads it with ``cuModuleLoadData`` into torch's
  primary context of the current device. A CUBIN and not PTX: PTX from
  an NVRTC newer than the driver does not JIT. The options are
  ``--std=c++17`` and ``-I$CUDA_HOME/include`` (so ``#include
  <cuda_fp16.h>`` works), then the user's own. ``exports`` may name C++
  template instantiations (``"fwd<float>"``); an ``extern "C"`` kernel
  is found under its own name.
* ``get_kernel(name, signature)`` binds a kernel to a C-style signature:
  ``const`` pointers and by-value scalars are inputs, non-``const``
  pointers are outputs, as in the JAX package.
* ``Kernel.launch(args, ctx, grid_dims, block_dims, shared_mem)`` packs
  one pointer per tensor and one C value per scalar and calls
  ``cuLaunchKernel`` on torch's current stream, without synchronising.
  Outputs are contiguous NDArrays on the card in the signature's dtype,
  written in place (the reference's CUDA semantics, and the JAX
  package's "contents replaced" for any kernel that writes every
  element). Inputs of another dtype, and numbers or numpy arrays, are
  copied to temporaries, which are freed after the launch: the caching
  allocator reuses a block only in stream order. A scalar parameter
  takes a Python or numpy number; an NDArray there raises, so that no
  device-to-host copy hides in a launch.

What bounds a kernel launched here is the user's kernel; the path's own
cost is the host work of packing and launching. ``Kernel`` works out a
launch plan once, when it is bound (each parameter's kind, dtype and C
type), and keeps one set of ctypes holders per thread, so a launch
writes each argument's pointer or value into a holder, checks the
thread's current context and calls ``cuLaunchKernel``; an input already
of the signature's dtype and contiguous passes its own pointer, and an
error message is built only when a check or a driver call fails.

There is no fallback: without a card or without NVRTC the constructor
raises :class:`MXNetError`, and nothing is compiled in a subprocess or
interpreted on the host. Loaded modules stay loaded for the life of the
process (no ``cuModuleUnload``): unloading safely would need the device
synchronised at an arbitrary point in garbage collection. The JAX
package's ``PallasModule`` has no counterpart: Pallas source cannot run
on the card.

Launches are counted per kernel (``Kernel.launches``) and in all
(``Kernel.total_launches``). A launch recorded into a CUDA graph runs at
each replay, not at the capture: the capturer reads the launches a
capture recorded (:func:`launch_counts` before and after), takes them back
and adds them at every replay (:func:`add_launches`).
"""
from __future__ import annotations

import ctypes
import glob
import os
import re
import threading
import weakref
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from .base import MXNetError, np_dtype, torch_dtype
from .ndarray.ndarray import NDArray

__all__ = ["CudaModule", "Kernel", "versions", "launch_counts",
           "add_launches"]

# ---------------------------------------------------------------------------
# signatures (the JAX package's _SIG_RE, _CTYPE_DT and _parse_signature)
# ---------------------------------------------------------------------------

_SIG_RE = re.compile(
    r"^\s*(?P<const>const\s+)?(?P<type>\w+)\s*(?P<ptr>\*)?\s*(?P<name>\w+)\s*$")

_CTYPE_DT = {"float": np.float32, "double": np.float64, "int": np.int32,
             "long": np.int64, "half": np.float16,
             "bfloat16": torch.bfloat16, "uint8": np.uint8, "int8": np.int8}


class Param(NamedTuple):
    """One parameter of a kernel signature."""
    name: str
    dtype: object  # a numpy dtype, or torch.bfloat16
    is_out: bool   # a non-const pointer
    is_ptr: bool   # a pointer (else passed by value)


def _parse_signature(sig: str) -> List[Param]:
    spec = []
    for part in sig.split(","):
        m = _SIG_RE.match(part)
        if not m:
            raise MXNetError("cannot parse signature fragment %r" % part)
        base = m.group("type")
        dt = _CTYPE_DT.get(base)
        if dt is None:
            dt = np_dtype(base)
        is_ptr = bool(m.group("ptr"))
        spec.append(Param(m.group("name"), dt if dt is torch.bfloat16
                          else np.dtype(dt), is_ptr and not m.group("const"),
                          is_ptr))
    return spec


# by-value scalars: the C type of each signature dtype (half and bfloat16
# travel as their 16 bits)
_SCALAR_CTYPE = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double,
                 torch.int32: ctypes.c_int32, torch.int64: ctypes.c_int64,
                 torch.uint8: ctypes.c_uint8, torch.int8: ctypes.c_int8,
                 torch.bool: ctypes.c_bool}


def _scalar_value(kernel, p: Param, v):
    if isinstance(v, (NDArray, torch.Tensor)):
        raise MXNetError(
            "kernel %s: scalar parameter %s takes a Python or numpy number, "
            "not an array (that would hide a device-to-host copy)"
            % (kernel, p.name))
    if not isinstance(v, (int, float, bool, np.number, np.bool_)):
        raise MXNetError("kernel %s: scalar parameter %s takes a number, got "
                         "%s" % (kernel, p.name, type(v).__name__))
    dt = torch_dtype(p.dtype)
    if dt in (torch.float16, torch.bfloat16):
        bits = torch.tensor([float(v)], dtype=dt).view(torch.int16).item()
        return ctypes.c_uint16(bits & 0xFFFF)
    if dt.is_floating_point:
        return _SCALAR_CTYPE[dt](float(v))
    return _SCALAR_CTYPE[dt](int(v))


# ---------------------------------------------------------------------------
# the launch checks: pure functions, reachable without a card
# ---------------------------------------------------------------------------


def _dims3(dims) -> tuple:
    """``dims`` as three Python ints, padded with 1s."""
    if type(dims) is tuple and len(dims) == 3:
        d0, d1, d2 = dims
        if type(d0) is int and type(d1) is int and type(d2) is int:
            return dims
    dims = tuple(int(d) for d in dims)
    return dims + (1,) * (3 - len(dims))


def _check_launch(kernel: str, spec: Sequence[Param], args: Sequence,
                  grid_dims) -> tuple:
    """The JAX package's checks, with its messages, before any driver
    call: the argument count, every output an NDArray, every grid dim at
    least 1. Returns the grid as three dims."""
    if len(args) != len(spec):
        raise MXNetError("kernel %s: %d args for %d-parameter signature"
                         % (kernel, len(args), len(spec)))
    for a, p in zip(args, spec):
        if p.is_out and not isinstance(a, NDArray):
            raise MXNetError("kernel %s: output args must be NDArrays"
                             % kernel)
    grid = tuple(int(g) for g in grid_dims)
    if any(g < 1 for g in grid):
        raise MXNetError("kernel %s: invalid grid_dims %r (all dims must be "
                         ">= 1)" % (kernel, grid_dims))
    if len(grid) > 3:
        raise MXNetError("kernel %s: grid_dims %r has more than 3 dims"
                         % (kernel, grid_dims))
    return _dims3(grid)


def _pack_pointer(kernel: str, p: Param, a, device: torch.device):
    """The tensor whose device pointer parameter ``p`` passes for ``a``:
    an output's own storage, an input's own storage when it already has
    the signature's dtype and is contiguous, else a temporary. Raises on
    an array on another device, a torch.Tensor, and an output that is not
    a contiguous NDArray in the signature's dtype."""
    want = torch_dtype(p.dtype)
    if isinstance(a, NDArray):
        t = a._data
        if t.device != device:
            raise MXNetError(
                "kernel %s: argument %s is on %s; the module's kernels "
                "run on %s" % (kernel, p.name, t.device, device))
        if p.is_out:
            if t.dtype != want or not t.is_contiguous():
                raise MXNetError(
                    "kernel %s: output %s must be a contiguous %s array, "
                    "got %s%s" % (kernel, p.name, want, t.dtype,
                                  "" if t.is_contiguous()
                                  else " (not contiguous)"))
            return t
        return t.detach().to(want).contiguous()
    if isinstance(a, torch.Tensor):
        raise MXNetError("kernel %s: argument %s: pass an NDArray, a "
                         "number or a numpy array, not a torch.Tensor"
                         % (kernel, p.name))
    return torch.as_tensor(np.asarray(a), dtype=want, device=device)


def _pack_args(kernel: str, spec: Sequence[Param], args: Sequence,
               device: torch.device):
    """``(values, keep)``: one ctypes value per parameter (a ``c_uint64``
    device pointer per array, a C scalar per by-value parameter), and the
    tensors that must stay alive until the launch is issued. Raises on an
    array on another device, and on an output that is not a contiguous
    NDArray in the signature's dtype."""
    values, keep = [], []
    for a, p in zip(args, spec):
        if not p.is_ptr:
            values.append(_scalar_value(kernel, p, a))
            continue
        t = _pack_pointer(kernel, p, a, device)
        keep.append(t)
        values.append(ctypes.c_uint64(t.data_ptr()))
    return values, keep


class _LaunchPlan:
    """What ``_check_launch`` and ``_pack_args`` work out from the
    signature, worked out once per kernel: each parameter's kind, torch
    dtype and C type. :meth:`fill` writes one launch's values into
    preallocated ctypes holders and returns the temporaries it made (None
    when there are none). An argument off the fast path (an input of
    another dtype or layout, a number for a pointer, anything that
    raises) goes through ``_pack_pointer`` / ``_scalar_value``, so the
    values and the errors are those of ``_pack_args``."""

    __slots__ = ("kernel", "spec", "n", "dtypes", "ctypes", "convert",
                 "outs", "ptrs")

    def __init__(self, kernel: str, spec: Sequence[Param]):
        self.kernel = kernel
        self.spec = tuple(spec)
        self.n = len(spec)
        self.dtypes = tuple(torch_dtype(p.dtype) for p in spec)
        self.ctypes, self.convert = [], []
        for p, dt in zip(spec, self.dtypes):
            if p.is_ptr:
                self.ctypes.append(ctypes.c_uint64)
                self.convert.append(None)
            elif dt in (torch.float16, torch.bfloat16):
                self.ctypes.append(ctypes.c_uint16)
                self.convert.append(None)  # its bits, by _scalar_value
            else:
                self.ctypes.append(_SCALAR_CTYPE[dt])
                self.convert.append(float if dt.is_floating_point else int)
        self.ctypes = tuple(self.ctypes)
        self.convert = tuple(self.convert)
        self.outs = tuple(i for i, p in enumerate(spec) if p.is_out)
        self.ptrs = tuple(p.is_ptr for p in spec)

    def holders(self):
        """One launch's ctypes holders and the parameter array that points
        at them (``cuLaunchKernel`` copies the values before it
        returns, so one set per thread is reused by every launch)."""
        values = [c() for c in self.ctypes]
        params = (ctypes.c_void_p * max(self.n, 1))(
            *[ctypes.addressof(v) for v in values])
        return values, params

    def check(self, args: Sequence, grid_dims) -> tuple:
        """``_check_launch``, skipped where the arguments' count and
        outputs and the grid are plainly right."""
        if len(args) == self.n and all(
                type(args[i]) is NDArray for i in self.outs) and \
                type(grid_dims) is tuple and len(grid_dims) == 3:
            g0, g1, g2 = grid_dims
            if type(g0) is int and type(g1) is int and type(g2) is int \
                    and g0 >= 1 and g1 >= 1 and g2 >= 1:
                return grid_dims
        return _check_launch(self.kernel, self.spec, args, grid_dims)

    def fill(self, values, args: Sequence, device: torch.device):
        keep = None
        for i, a in enumerate(args):
            dt = self.dtypes[i]
            if self.ptrs[i]:
                if type(a) is NDArray:
                    t = a._data
                    if t.dtype == dt and t.device == device and \
                            t.is_contiguous():
                        values[i].value = t.data_ptr()
                        continue
                t = _pack_pointer(self.kernel, self.spec[i], a, device)
                if keep is None:
                    keep = []
                keep.append(t)
                values[i].value = t.data_ptr()
                continue
            conv = self.convert[i]
            if conv is not None and type(a) in _PLAIN_NUMBERS:
                values[i].value = conv(a)
            else:
                values[i].value = _scalar_value(self.kernel, self.spec[i],
                                                a).value
        return keep


_PLAIN_NUMBERS = frozenset((int, float, bool, np.float32, np.float64,
                            np.int32, np.int64))


# ---------------------------------------------------------------------------
# the two libraries, loaded at first use
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_LIBS = {}
_MAX_DYN_SMEM_ATTR = 8  # CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES
_CUDA_ERROR_NOT_FOUND = 500


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def _nvrtc_dirs() -> List[str]:
    """Where NVRTC is looked for: the toolkit, then torch's wheel."""
    site = os.path.dirname(os.path.dirname(os.path.abspath(torch.__file__)))
    return [os.path.join(_cuda_home(), "lib64"),
            os.path.join(site, "nvidia", "cuda_nvrtc", "lib")]


def _driver():
    """``libcuda.so.1`` with ``argtypes`` on every function used (ctypes
    would otherwise cut a pointer to 32 bits)."""
    lib = _LIBS.get("cuda")  # bound once; every launch asks for it
    if lib is not None:
        return lib
    with _LOCK:
        if "cuda" in _LIBS:
            return _LIBS["cuda"]
        lib = ctypes.CDLL("libcuda.so.1")
        P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        PP = ctypes.POINTER(ctypes.c_void_p)
        sigs = {
            "cuInit": [U],
            "cuDriverGetVersion": [ctypes.POINTER(I)],
            "cuDeviceGet": [ctypes.POINTER(I), I],
            "cuDevicePrimaryCtxRetain": [PP, I],
            "cuCtxGetCurrent": [PP],
            "cuCtxSetCurrent": [P],
            "cuModuleLoadData": [PP, P],
            "cuModuleGetFunction": [PP, P, ctypes.c_char_p],
            "cuFuncSetAttribute": [P, I, I],
            "cuLaunchKernel": [P, U, U, U, U, U, U, U, P, PP, PP],
            "cuGetErrorName": [I, ctypes.POINTER(ctypes.c_char_p)],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = I
        _LIBS["cuda"] = lib
        return lib


def _cu_check(res: int, what: str):
    if res != 0:
        name = ctypes.c_char_p()
        _driver().cuGetErrorName(res, ctypes.byref(name))
        raise MXNetError("%s failed: %s (CUresult %d)"
                         % (what, (name.value or b"?").decode(), res))


def _driver_version() -> int:
    v = ctypes.c_int()
    _cu_check(_driver().cuDriverGetVersion(ctypes.byref(v)),
              "cuDriverGetVersion")
    return v.value


def _bind_nvrtc(path: str):
    # its builtins library sits beside it; load that first, by path, so
    # NVRTC's own dlopen of it by name finds it loaded
    for b in sorted(glob.glob(os.path.join(os.path.dirname(path),
                                           "libnvrtc-builtins.so*"))):
        ctypes.CDLL(b, mode=ctypes.RTLD_GLOBAL)
        break
    lib = ctypes.CDLL(path)
    P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    CP, PP = ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)
    sigs = {
        "nvrtcVersion": [ctypes.POINTER(I), ctypes.POINTER(I)],
        "nvrtcCreateProgram": [PP, CP, CP, I, P, P],
        "nvrtcAddNameExpression": [P, CP],
        "nvrtcCompileProgram": [P, I, ctypes.POINTER(CP)],
        "nvrtcGetProgramLogSize": [P, ctypes.POINTER(S)],
        "nvrtcGetProgramLog": [P, CP],
        "nvrtcGetCUBINSize": [P, ctypes.POINTER(S)],
        "nvrtcGetCUBIN": [P, CP],
        "nvrtcGetLoweredName": [P, CP, ctypes.POINTER(CP)],
        "nvrtcDestroyProgram": [PP],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = I
    lib.nvrtcGetErrorString.argtypes = [I]
    lib.nvrtcGetErrorString.restype = CP
    major, minor = I(), I()
    lib.nvrtcVersion(ctypes.byref(major), ctypes.byref(minor))
    return lib, (major.value, minor.value)


def _nvrtc():
    """``(lib, (major, minor), path)`` of the first NVRTC found whose major
    version the driver supports (a CUBIN from a newer major release may
    not load); the first found if none is. Raises naming the paths tried
    when there is none."""
    with _LOCK:
        if "nvrtc" in _LIBS:
            return _LIBS["nvrtc"]
    dirs = _nvrtc_dirs()
    found = []
    for d in dirs:
        libs = [p for p in glob.glob(os.path.join(d, "libnvrtc.so*"))
                if "builtins" not in p]
        # the unversioned name first, then the shortest (all name one file)
        libs.sort(key=lambda p: (os.path.basename(p) != "libnvrtc.so",
                                 len(p), p))
        found.extend(libs[:1])
    if not found:
        raise MXNetError("rtc: NVRTC (libnvrtc.so*) not found; tried %s"
                         % dirs)
    driver_major = _driver_version() // 1000
    bound = []
    for path in found:
        lib, ver = _bind_nvrtc(path)
        bound.append((lib, ver, path))
        if ver[0] <= driver_major:
            break
    chosen = next((b for b in bound if b[1][0] <= driver_major), bound[0])
    with _LOCK:
        _LIBS.setdefault("nvrtc", chosen)
        return _LIBS["nvrtc"]


def versions() -> dict:
    """The NVRTC the port compiles with and the driver it loads into:
    ``{"nvrtc": "12.8", "nvrtc_path": ..., "driver": 12080}``."""
    _, ver, path = _nvrtc()
    return {"nvrtc": "%d.%d" % ver, "nvrtc_path": path,
            "driver": _driver_version()}


def _arch(device: torch.device) -> str:
    major, minor = torch.cuda.get_device_capability(device)
    # the "a" target has Hopper's wgmma and setmaxnreg; plain sm_90 lacks them
    return "sm_%d%d%s" % (major, minor, "a" if (major, minor) == (9, 0)
                          else "")


def _primary_context(device: torch.device) -> ctypes.c_void_p:
    """torch's primary context of ``device`` (retained once more)."""
    torch.cuda.init()
    drv = _driver()
    _cu_check(drv.cuInit(0), "cuInit")
    dev = ctypes.c_int()
    _cu_check(drv.cuDeviceGet(ctypes.byref(dev), device.index), "cuDeviceGet")
    ctx = ctypes.c_void_p()
    _cu_check(drv.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
              "cuDevicePrimaryCtxRetain")
    return ctx


class _CurrentContext:
    """Make ``ctx`` current on this thread for driver calls, and put
    back the one that was (a thread that never touched CUDA through
    torch has none). One instance may be entered again and again, not
    nested and on one thread only: a ``Kernel`` keeps one a thread, so a
    launch allocates no ctypes object for it."""

    def __init__(self, ctx: ctypes.c_void_p):
        self._ctx = ctx
        self._cur = ctypes.c_void_p()
        self._cur_ref = ctypes.byref(self._cur)
        self._prev = None

    def __enter__(self):
        drv = _driver()
        _cu_check(drv.cuCtxGetCurrent(self._cur_ref), "cuCtxGetCurrent")
        prev = self._cur.value
        if prev != self._ctx.value:
            _cu_check(drv.cuCtxSetCurrent(self._ctx), "cuCtxSetCurrent")
        else:
            prev = None
        self._prev = prev
        return self

    def __exit__(self, *exc):
        if self._prev:
            _driver().cuCtxSetCurrent(self._prev)


# ---------------------------------------------------------------------------
# module and kernel
# ---------------------------------------------------------------------------


def _raw_stream(index: int) -> int:
    """torch's current stream on device ``index`` as a raw handle (a
    CUDA build of torch has the binding; a CPU build never launches)."""
    return torch._C._cuda_getCurrentRawStream(index)


class Kernel(object):
    """One launchable kernel (reference rtc.py:CudaKernel).

    ``__init__`` works out the launch plan once (each parameter's kind,
    dtype and C type); each launch then only writes its values into this
    thread's preallocated ctypes holders, makes torch's primary context
    current where it is not, and calls ``cuLaunchKernel``. The holders
    are per thread: a custom op's backward launches on torch's autograd
    thread."""

    #: launches of every kernel of every module
    total_launches = 0
    #: every kernel made in this process (for :func:`launch_counts`)
    _live = weakref.WeakSet()

    def __init__(self, module: "CudaModule", fn: ctypes.c_void_p, name: str,
                 spec: List[Param]):
        self._module = module
        self._fn = fn
        self._name = name
        self._spec = spec
        self._plan = _LaunchPlan(name, spec)
        self._tls = threading.local()
        self._smem_set = 48 * 1024  # what a launch may use without opting in
        self.launches = 0
        Kernel._live.add(self)

    def _thread_state(self):
        """This thread's (holders, parameter array, context switch)."""
        st = getattr(self._tls, "st", None)
        if st is None:
            values, params = self._plan.holders()
            st = self._tls.st = (values, params,
                                 _CurrentContext(self._module._ctx))
        return st

    def launch(self, args: Sequence, ctx=None,
               grid_dims: Sequence[int] = (1, 1, 1),
               block_dims: Sequence[int] = (1, 1, 1), shared_mem: int = 0):
        """Launch over ``grid_dims`` blocks of ``block_dims`` threads with
        ``shared_mem`` bytes of dynamic shared memory, on torch's current
        stream (reference rtc.py:CudaKernel.launch). ``args`` pairs with
        the signature; outputs are written in place and returned (one
        NDArray, or a list of them)."""
        plan = self._plan
        grid = plan.check(args, grid_dims)
        module = self._module
        device = module.device
        if ctx is not None and ctx.torch_device() != device:
            raise MXNetError("kernel %s: ctx %s, but the module was loaded "
                             "on %s" % (self._name, ctx, device))
        block = _dims3(block_dims)
        if type(shared_mem) is not int:
            shared_mem = int(shared_mem)
        values, params, switch = self._thread_state()
        keep = plan.fill(values, args, device)
        # torch's current stream as a raw handle: what
        # torch.cuda.current_stream(device).cuda_stream gives, without
        # building a Stream object (microseconds a launch)
        stream = _raw_stream(module.device_index)
        drv = _driver()
        with switch:
            if shared_mem > self._smem_set:
                _cu_check(drv.cuFuncSetAttribute(
                    self._fn, _MAX_DYN_SMEM_ATTR, shared_mem),
                    "kernel %s: cuFuncSetAttribute(max dynamic shared "
                    "memory %d)" % (self._name, shared_mem))
                self._smem_set = shared_mem
            res = drv.cuLaunchKernel(
                self._fn, grid[0], grid[1], grid[2], block[0], block[1],
                block[2], shared_mem, stream, params, None)
            if res:  # the message is built only for a refused launch
                _cu_check(res, "kernel %s: cuLaunchKernel(grid %s, block "
                          "%s, shared %d)" % (self._name, grid, block,
                                              shared_mem))
        self.launches += 1
        Kernel.total_launches += 1
        del keep  # temporaries: freed in stream order after the launch
        outs = plan.outs
        if len(outs) == 1:
            return args[outs[0]]
        return [args[i] for i in outs]


def launch_counts():
    """``{kernel: launches}`` of every live kernel."""
    return {k: k.launches for k in list(Kernel._live)}


def add_launches(counts, times=1):
    """Add ``times`` x ``counts`` (``{kernel: launches}``, a difference of
    two :func:`launch_counts`) to the launch counts: what a CUDA graph
    launches when it replays the rtc kernels its capture recorded. The
    wrappers ran only during the capture, which launches nothing, so the
    capturer takes the capture's own counts back with ``times=-1``."""
    for kernel, n in counts.items():
        kernel.launches += n * times
        Kernel.total_launches += n * times


class CudaModule(object):
    """Compile CUDA-C source at run time with NVRTC (reference
    rtc.py:CudaModule).

    Example::

        mod = mx.rtc.CudaModule(r'''
        extern "C" __global__ void axpy(const float *a, const float *x,
                                        const float *y, float *out, int n) {
            int i = blockIdx.x * blockDim.x + threadIdx.x;
            if (i < n) out[i] = a[0] * x[i] + y[i];
        }''')
        k = mod.get_kernel("axpy", "const float *a, const float *x, "
                                   "const float *y, float *out, int n")
        k.launch((a, x, y, out, n), grid_dims=((n + 255) // 256, 1, 1),
                 block_dims=(256, 1, 1))
    """

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        if not torch.cuda.is_available():
            raise MXNetError("rtc.CudaModule needs a CUDA device, and none "
                             "is available")
        nvrtc, _, _ = _nvrtc()
        self.device = torch.device("cuda", torch.cuda.current_device())
        self.device_index = self.device.index
        self._exports = tuple(exports)
        opts = ["--gpu-architecture=%s" % _arch(self.device), "--std=c++17"]
        include = os.path.join(_cuda_home(), "include")
        if os.path.isdir(include):
            opts.append("-I" + include)
        opts.extend(options)
        cubin, self._lowered = self._compile(nvrtc, source, opts)
        self._ctx = _primary_context(self.device)
        self._module = ctypes.c_void_p()
        with _CurrentContext(self._ctx):
            _cu_check(_driver().cuModuleLoadData(
                ctypes.byref(self._module), cubin), "cuModuleLoadData")
        self._cubin = cubin  # the image stays alive beside the module

    def _compile(self, nvrtc, source, opts):
        def check(res, what):
            if res != 0:
                raise MXNetError("CudaModule: %s failed: %s" % (
                    what, nvrtc.nvrtcGetErrorString(res).decode()))

        prog = ctypes.c_void_p()
        check(nvrtc.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                       b"mxnet_rtc.cu", 0, None, None),
              "nvrtcCreateProgram")
        try:
            for name in self._exports:
                check(nvrtc.nvrtcAddNameExpression(prog, name.encode()),
                      "nvrtcAddNameExpression(%s)" % name)
            c_opts = (ctypes.c_char_p * len(opts))(
                *[o.encode() for o in opts])
            res = nvrtc.nvrtcCompileProgram(prog, len(opts), c_opts)
            size = ctypes.c_size_t()
            nvrtc.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
            log = ctypes.create_string_buffer(size.value)
            nvrtc.nvrtcGetProgramLog(prog, log)
            if res != 0:
                raise MXNetError(
                    "CudaModule: kernel source does not compile (%s, options "
                    "%s):\n%s" % (nvrtc.nvrtcGetErrorString(res).decode(),
                                  opts, log.value.decode(errors="replace")))
            check(nvrtc.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                  "nvrtcGetCUBINSize")
            cubin = ctypes.create_string_buffer(size.value)
            check(nvrtc.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
            lowered = {}
            for name in self._exports:
                low = ctypes.c_char_p()
                check(nvrtc.nvrtcGetLoweredName(prog, name.encode(),
                                                ctypes.byref(low)),
                      "nvrtcGetLoweredName(%s)" % name)
                lowered[name] = low.value.decode()
        finally:
            nvrtc.nvrtcDestroyProgram(ctypes.byref(prog))
        return cubin, lowered

    def get_kernel(self, name: str, signature: str) -> Kernel:
        """Bind a kernel by name and C-style signature (reference
        rtc.py:CudaModule.get_kernel); each call gives a fresh binding.
        An exported name is looked up by its lowered name, any other by
        its own (an ``extern "C"`` kernel); a name the module does not
        hold raises "not exported"."""
        spec = _parse_signature(signature)
        fn = ctypes.c_void_p()
        with _CurrentContext(self._ctx):
            res = _driver().cuModuleGetFunction(
                ctypes.byref(fn), self._module,
                self._lowered.get(name, name).encode())
        if res == _CUDA_ERROR_NOT_FOUND:
            raise MXNetError("kernel %r not exported (exports: %s)"
                             % (name, list(self._exports)))
        _cu_check(res, "cuModuleGetFunction(%s)" % name)
        return Kernel(self, fn, name, spec)
