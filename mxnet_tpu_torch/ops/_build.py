"""Build the port's CUDA kernels and host libraries at first use and
load them with ctypes.

Each kernel source under ``ops/csrc/`` (``<name>.cu``) is compiled by
``nvcc`` into a shared library with a plain ``extern "C"`` entry point
(no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o <lib> <source>

A host-only source (``<name>.cc``, no CUDA) is compiled by the host C++
compiler, the one ``nvcc`` drives (``c++``, else ``g++``):

    c++ -std=c++17 -O3 -shared -fPIC -ffp-contract=off -o <lib> <source>

The library lands in ``ops/_build/`` (listed in ``.gitignore``) under a
name keyed by a hash of the source and the flags, so an edited source
rebuilds and an unchanged one is reused. Nothing is built at import:
:func:`load` runs inside the wrapper that launches the kernel. A failed
build raises :class:`~mxnet_tpu_torch.base.MXNetError` with nvcc's
output; there is no fallback. :func:`build_log` gives what ``ptxas -v``
said of a loaded library's build (registers, shared memory, spills),
kept in ``<lib>.log`` beside it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

from ..base import MXNetError

__all__ = ["build_log", "load", "source_path", "host_compiler"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_OUT = os.path.join(_HERE, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                      "-Xptxas=-v")
# no fused multiply-add: the host codec's double arithmetic (Pillow's
# resample coefficients) must round as the plain version's does
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-ffp-contract=off")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


def source_path(name: str) -> str:
    """Absolute path of ``ops/csrc/<name>.cu``, or of ``<name>.cc`` where
    the source is host code."""
    cu = os.path.join(_CSRC, name + ".cu")
    cc = os.path.join(_CSRC, name + ".cc")
    return cc if not os.path.isfile(cu) and os.path.isfile(cc) else cu


def build_log(name: str) -> str:
    """nvcc's output for the loaded library of kernel ``name`` (kept
    beside the library, so a library from an earlier build has it too),
    or an empty string if the library is not loaded or has no log."""
    return _logs.get(name, "")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise MXNetError("nvcc not found (PATH, CUDA_HOME/bin, /usr/local/cuda/"
                     "bin): the port's CUDA kernels are built at first use")


def host_compiler() -> str:
    """The host C++ compiler (``c++``, else ``g++``, on PATH)."""
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise MXNetError("no host C++ compiler (c++ or g++ on PATH): the port's "
                     "host libraries are built at first use")


def _command(src: str, out: str):
    if src.endswith(".cc"):
        return [host_compiler(), *HOST_FLAGS, "-o", out, src]
    return [_nvcc(), *FLAGS, "-o", out, src]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        src = source_path(name)
        with open(src, "rb") as f:
            blob = f.read()
        flags = HOST_FLAGS if src.endswith(".cc") else FLAGS
        key = hashlib.sha256(blob + " ".join(flags).encode()).hexdigest()
        out = os.path.join(_OUT, "%s-%s.so" % (name, key[:16]))
        if not os.path.isfile(out):
            _compile(src, out)
        if os.path.isfile(out + ".log"):
            with open(out + ".log") as f:
                _logs[name] = f.read()
        lib = ctypes.CDLL(out)
        _loaded[name] = lib
        return lib


def _compile(src: str, out: str) -> None:
    os.makedirs(_OUT, exist_ok=True)
    # build beside the target and rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_OUT)
    os.close(fd)
    try:
        cmd = _command(src, tmp)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise MXNetError("%s failed (%d) building %s:\n%s\n%s"
                             % (os.path.basename(cmd[0]), proc.returncode,
                                src, proc.stdout, proc.stderr))
        with open(tmp + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp + ".log", out + ".log")  # the log first: a library
        os.replace(tmp, out)                    # is never without its log
    finally:
        for path in (tmp, tmp + ".log"):
            if os.path.exists(path):
                os.remove(path)
