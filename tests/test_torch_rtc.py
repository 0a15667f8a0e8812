"""The port's rtc (CPU, and on the card where one is present).

* ``_parse_signature`` equals the JAX package's on signatures of every
  C type it knows, const and not, pointers and scalars, with any
  spacing, and raises the same messages on fragments it cannot parse;
* the launch checks (argument count, an output that is not an NDArray,
  a grid dim below 1) give the JAX package's messages, and the port's
  own (an array on another device, a scalar given an array, an output
  of the wrong dtype or not contiguous) raise MXNetError, all before any
  driver call;
* ``CudaModule`` raises MXNetError on a box without a card: there is no
  fallback;
* the JAX ``PallasModule`` kernels of ``tests/test_rtc.py`` (axpy, a
  grid over rows, two outputs), run in interpret mode, equal the port's
  plain versions (``example/rtc_spec.py``) that ``chip_smoke.py`` holds
  the CUDA-C kernels against, exactly (fp32, the same operations);
* ``cuda``-marked: every spec case in CUDA-C against its plain version
  (1e-5: NVRTC may fuse a multiply-add, one ulp), and the launch counts.
  They skip without a card.
"""
import ctypes

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import rtc as jrtc
from mxnet_tpu.base import dtype_name as jax_dtype_name
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, rtc
from mxnet_tpu_torch.base import dtype_name
from mxnet_tpu_torch.example import rtc_spec
from mxnet_tpu_torch.ndarray.ndarray import NDArray

SIGNATURES = [
    "const float *a, const float *x, const float *y, float *out",
    "float alpha, const float *x, const float *y, float *out, int n",
    "const double *d, double *o, double s",
    "int n", "long n, const long *idx, long *o",
    "const half *h, half *o, half s",
    "const bfloat16 *b, bfloat16 *o, bfloat16 s",
    "const uint8 *u, uint8 *o, uint8 s", "int8 v, const int8 *w, int8* o",
    "const float32 *x, int32 *o, float16 h, const int64 *i",
    "float* x", "  const   float   *  x ,float*y", "const float x",
]


@pytest.mark.parametrize("sig", SIGNATURES)
def test_parse_signature_matches_jax(sig):
    ours = rtc._parse_signature(sig)
    theirs = jrtc._parse_signature(sig)
    assert [(p.name, dtype_name(p.dtype), p.is_out) for p in ours] == \
        [(n, jax_dtype_name(dt), out) for n, dt, out in theirs]
    # a by-value parameter is never an output
    assert all(p.is_ptr or not p.is_out for p in ours)


@pytest.mark.parametrize("sig", ["float *& bad sig", "", "const",
                                 "float x y", "float *x, ",
                                 "unknowntype x"])
def test_parse_signature_errors_match_jax(sig):
    with pytest.raises(jmx.MXNetError) as theirs:
        jrtc._parse_signature(sig)
    with pytest.raises(MXNetError) as ours:
        rtc._parse_signature(sig)
    assert str(ours.value) == str(theirs.value)


AXPY_SIG = "const float *a, const float *x, const float *y, float *out"
AXPY_PALLAS = """
def axpy(a_ref, x_ref, y_ref, out_ref):
    out_ref[...] = a_ref[0] * x_ref[...] + y_ref[...]
"""


def _jax_launch_error(args, grid):
    k = jrtc.PallasModule(AXPY_PALLAS).get_kernel("axpy", AXPY_SIG)
    with pytest.raises(jmx.MXNetError) as e:
        k.launch(args, grid_dims=grid)
    return str(e.value)


@pytest.mark.parametrize("case", ["count", "output", "grid"])
def test_launch_checks_match_jax(case):
    a, x, y = [np.ones(8, np.float32)] * 3
    jout = jmx.nd.zeros((8,))
    with mx.cpu():
        tout = mx.nd.zeros((8,))
    if case == "count":
        jargs, targs, grid = (a, x, y), (a, x, y), (1, 1, 1)
    elif case == "output":
        jargs = targs = (a, x, y, np.zeros(8, np.float32))
        grid = (1, 1, 1)
    else:
        jargs, targs, grid = (a, x, y, jout), (a, x, y, tout), (2, 0, 1)
    with pytest.raises(MXNetError) as ours:
        rtc._check_launch("axpy", rtc._parse_signature(AXPY_SIG), targs,
                          grid)
    assert str(ours.value) == _jax_launch_error(jargs, grid)


def test_launch_check_pads_the_grid():
    spec = rtc._parse_signature(AXPY_SIG)
    with mx.cpu():
        args = (1, 2, 3, mx.nd.zeros((2,)))
    assert rtc._check_launch("k", spec, args, (4,)) == (4, 1, 1)
    assert rtc._check_launch("k", spec, args, ()) == (1, 1, 1)
    with pytest.raises(MXNetError, match="more than 3"):
        rtc._check_launch("k", spec, args, (1, 1, 1, 1))


def test_port_argument_checks():
    """An array on another device, an array for a scalar, an output of
    the wrong dtype or not contiguous: each raises before any launch."""
    spec = rtc._parse_signature("float alpha, const float *x, float *out")
    cuda = torch.device("cuda", 0)
    with mx.cpu():
        x, out = mx.nd.ones((4, 2)), mx.nd.zeros((4, 2))
        out64 = mx.nd.zeros((4, 2), dtype="float64")
    with pytest.raises(MXNetError, match="argument x is on cpu"):
        rtc._pack_args("k", spec, (1.0, x, out), cuda)
    with pytest.raises(MXNetError, match="scalar parameter alpha"):
        rtc._pack_args("k", spec, (x, x, out), torch.device("cpu"))
    with pytest.raises(MXNetError, match="output out must be a contiguous"):
        rtc._pack_args("k", spec, (1.0, x, out64), torch.device("cpu"))
    with pytest.raises(MXNetError, match="not contiguous"):
        rtc._pack_args("k", spec, (1.0, x, NDArray(out._data.t())),
                       torch.device("cpu"))
    # what is accepted: numbers, numpy inputs (copied and cast), a cast
    # NDArray input; one 64-bit pointer per array, a C value per scalar
    vals, keep = rtc._pack_args("k", spec, (np.float32(2), np.arange(8),
                                            out), torch.device("cpu"))
    assert [type(v).__name__ for v in vals] == ["c_float", "c_ulong",
                                                "c_ulong"]
    assert keep[0].dtype == torch.float32 and keep[1] is out._data
    assert vals[2].value == out._data.data_ptr()


def test_cuda_module_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the module would compile")
    with pytest.raises(MXNetError, match="needs a CUDA device"):
        rtc.CudaModule(rtc_spec.SOURCE)
    assert not hasattr(rtc, "PallasModule")


SCALE_ROWS_PALLAS = """
def scale_rows(x_ref, out_ref):
    i = pl.program_id(0)
    out_ref[pl.ds(i, 1), :] = x_ref[pl.ds(i, 1), :] * (i + 1).astype(
        jnp.float32)
"""
SPLIT_SIGN_PALLAS = """
def split_sign(x_ref, pos_ref, neg_ref):
    pos_ref[...] = jnp.maximum(x_ref[...], 0.0)
    neg_ref[...] = jnp.minimum(x_ref[...], 0.0)
"""
# tests/test_rtc.py's scale_rows writes the whole array at every grid
# step; this one writes row i at step i, what blockIdx does in CUDA-C
PALLAS = {"axpy": AXPY_PALLAS, "scale_rows": SCALE_ROWS_PALLAS,
          "split_sign": SPLIT_SIGN_PALLAS}


@pytest.mark.parametrize("name", sorted(PALLAS))
def test_jax_pallas_kernel_equals_the_plain_version(name):
    case = next(c for c in rtc_spec.cases(np.random.RandomState(5))
                if c.name == name)
    k = jrtc.PallasModule(PALLAS[name]).get_kernel(case.kernel,
                                                   case.signature)
    outs = [jmx.nd.zeros(shape) for shape, _ in case.outputs]
    k.launch([jmx.nd.array(a) for a in case.inputs] + outs,
             grid_dims=case.grid)
    want = case.plain(*[torch.from_numpy(a) for a in case.inputs])
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o.asnumpy(), w.numpy())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs these cases")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["axpy", "axpy_scalars", "scale_rows",
                                  "split_sign", "template_float",
                                  "template_half", "shared_64k"])
def test_cuda_spec_case_matches_plain_version(cuda_device, name):
    mod = rtc.CudaModule(rtc_spec.SOURCE, exports=rtc_spec.EXPORTS)
    case = next(c for c in rtc_spec.cases(np.random.RandomState(5))
                if c.name == name)
    before = rtc.Kernel.total_launches
    outs, want, kernel = rtc_spec.launch_case(mod, case, cuda_device)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    assert rtc.Kernel.total_launches == before + 1
    for o, w in zip(outs, want):
        torch.testing.assert_close(o.float(), w.float(), rtol=0, atol=1e-5)


# the launch plan (Kernel.__init__) against _pack_args, on the CPU: the
# same values for the same arguments, the same errors with the same text
PLAN_SIG = ("float alpha, const float *x, const double *d, float *out, "
            "int n, half h, bfloat16 b, const int8 *i8, long big, bool f")


def _plan_args(case):
    with mx.cpu():
        x, out = mx.nd.ones((4, 2)), mx.nd.zeros((4, 2))
        d = mx.nd.ones((3,), dtype="float64")
    args = [1.5, x, d, out, 7, 0.333, -2.5, np.arange(5, dtype=np.int8),
            2 ** 40, True]
    if case == "numpy_scalars":
        args[0], args[4], args[8] = np.float32(0.1), np.int64(9), np.int32(3)
    elif case == "float_for_int":
        args[4], args[0] = 2.7, 3
    elif case == "cast_input":
        args[1] = NDArray(torch.arange(8.0, dtype=torch.float64).view(4, 2))
    elif case == "strided_input":
        args[1] = NDArray(torch.arange(8.0).view(2, 4).t())
    elif case == "numpy_input":
        args[1], args[2] = np.arange(8, dtype=np.int64), [1.0, 2.0]
    elif case == "bool_scalar":
        args[9] = np.bool_(False)
    return args


@pytest.mark.parametrize("case", ["plain", "numpy_scalars", "float_for_int",
                                  "cast_input", "strided_input",
                                  "numpy_input", "bool_scalar"])
def test_launch_plan_packs_what_pack_args_packs(case):
    spec = rtc._parse_signature(PLAN_SIG)
    plan = rtc._LaunchPlan("k", spec)
    cpu = torch.device("cpu")
    args = _plan_args(case)
    want, want_keep = rtc._pack_args("k", spec, args, cpu)
    values, params = plan.holders()
    keep = plan.fill(values, args, cpu)
    assert [type(v) for v in values] == [type(v) for v in want]
    for i, (got, ref, p) in enumerate(zip(values, want, spec)):
        if p.is_ptr and ref.value not in [a._data.data_ptr() for a in args
                                          if isinstance(a, NDArray)]:
            # a temporary: the same contents, in a tensor of its own
            tmp = next(t for t in keep if t.data_ptr() == got.value)
            ref_t = next(t for t in want_keep if t.data_ptr() == ref.value)
            assert tmp.dtype == ref_t.dtype and torch.equal(tmp, ref_t)
        else:
            assert got.value == ref.value, (i, p.name)
    # the parameter array points at the holders
    assert [params[i] for i in range(len(spec))] == \
        [ctypes.addressof(v) for v in values]
    # inputs of the signature's dtype, contiguous, pass their own storage
    if case in ("plain", "numpy_scalars", "float_for_int", "bool_scalar"):
        assert len(keep) == 1 and keep[0].dtype == torch.int8  # numpy i8


@pytest.mark.parametrize("bad", range(6))
def test_launch_plan_raises_what_pack_args_raises(bad):
    spec = rtc._parse_signature(PLAN_SIG)
    plan = rtc._LaunchPlan("k", spec)
    cpu = torch.device("cpu")
    args = _plan_args("plain")
    with mx.cpu():
        if bad == 0:
            args[0] = mx.nd.ones((1,))  # an array for a scalar
        elif bad == 1:
            args[4] = "7"  # not a number
        elif bad == 2:
            args[3] = mx.nd.zeros((4, 2), dtype="float64")  # output dtype
        elif bad == 3:
            args[3] = NDArray(torch.zeros(2, 4).t())  # not contiguous
        elif bad == 4:
            args[1] = torch.ones(4, 2)  # a torch.Tensor
        else:
            args[6] = torch.ones(1)  # a tensor for a bfloat16 scalar
    with pytest.raises(MXNetError) as want:
        rtc._pack_args("k", spec, args, cpu)
    values, _ = plan.holders()
    with pytest.raises(MXNetError) as got:
        plan.fill(values, args, cpu)
    assert str(got.value) == str(want.value)
    # and an array on another device than the module's
    with pytest.raises(MXNetError) as want:
        rtc._pack_args("k", spec, _plan_args("plain"), torch.device("meta"))
    with pytest.raises(MXNetError) as got:
        plan.fill(values, _plan_args("plain"), torch.device("meta"))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("args,grid", [
    ((1, 2, 3), (1, 1, 1)), ((1, 2, 3, np.zeros(2)), (1, 1, 1)),
    ((1, 2, 3, "out"), (2, 0, 1)), ((1, 2, 3, "out"), (4,)),
    ((1, 2, 3, "out"), ()), ((1, 2, 3, "out"), (1, 1, 1, 1)),
    ((1, 2, 3, "out"), (2, 3, 4)), ((1, 2, 3, "out"), [2, np.int64(3)])])
def test_launch_plan_checks_as_check_launch(args, grid):
    spec = rtc._parse_signature(AXPY_SIG)
    plan = rtc._LaunchPlan("axpy", spec)
    with mx.cpu():
        args = tuple(mx.nd.zeros((2,)) if isinstance(a, str) else a
                     for a in args)
    try:
        want = rtc._check_launch("axpy", spec, args, grid)
    except MXNetError as e:
        with pytest.raises(MXNetError) as got:
            plan.check(args, grid)
        assert str(got.value) == str(e)
        return
    assert plan.check(args, grid) == want


@pytest.mark.cuda
def test_cuda_launch_from_a_second_thread(cuda_device):
    """A launch from a thread torch never touched (the custom op's
    backward runs on the autograd thread) gets holders and a current
    context of its own, and leaves that thread's context as it found
    it."""
    import threading

    mod = rtc.CudaModule(rtc_spec.SOURCE, exports=rtc_spec.EXPORTS)
    case = next(c for c in rtc_spec.cases(np.random.RandomState(5))
                if c.name == "axpy")
    result = {}

    def body():
        try:
            result["run"] = rtc_spec.launch_case(mod, case, cuda_device)
        except Exception as e:  # reported on the main thread
            result["error"] = e

    for _ in range(2):  # the main thread's holders, then a new thread's
        outs, want, kernel = rtc_spec.launch_case(mod, case, cuda_device)
        th = threading.Thread(target=body)
        th.start()
        th.join()
        assert "error" not in result, result.get("error")
        torch.cuda.synchronize()
        for got, ref in ((outs, want), result["run"][:2]):
            for o, w in zip(got, ref):
                torch.testing.assert_close(o.float(), w.float(), rtol=0,
                                           atol=1e-5)
