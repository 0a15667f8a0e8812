"""MXNet ``.params`` file (de)serialization: the port of
``mxnet_tpu/ndarray/io_utils.py``, byte for byte the same container
(reference ``src/ndarray/ndarray.cc:1537`` NDArray::Save and ``:1733``
list save):

    file      := uint64 kMXAPINDArrayListMagic(0x112) | uint64 reserved
               | vec<ndarray> | vec<string names>
    vec<T>    := uint64 count | T*count                       (dmlc::Stream)
    ndarray   := uint32 NDARRAY_V2_MAGIC(0xF993fac9) | int32 stype(=1 dense)
               | tshape | int32 dev_type | int32 dev_id | int32 type_flag
               | raw data bytes
    tshape    := uint32 ndim | int64*ndim                     (int64 TShape)

Legacy V1 (int64 shape, no stype) and pre-V1 (uint32 ndim leading) files
load, as ``NDArray::LegacyLoad`` reads them, and row_sparse and CSR
entries load made dense. bfloat16 is written as float32 and a 0-d array
as ``(1,)``, as in the JAX package. The port keeps int64 and float64
arrays, so it writes their type flags (6 and 1) where the JAX package,
which runs without 64-bit types, writes int32 and float32.

The device side: :func:`save` takes every device array to the host in
one batched transfer (``base.fetch_host``: non-blocking copies into one
pinned host buffer a dtype, then one synchronisation), as the JAX
package's checkpoint snapshot does (``mxnet_tpu/elastic.py:397-406``);
:func:`load` returns NDArrays on the current context, the card by
default, staged the other way (:func:`device_arrays`).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from ..base import MXNetError, fetch_host, torch_dtype
from ..context import current_context

__all__ = ["save", "load", "load_np", "device_arrays"]

kMXAPINDArrayListMagic = 0x112
NDARRAY_V1_MAGIC = 0xF993FAC8
NDARRAY_V2_MAGIC = 0xF993FAC9

# mshadow type codes (reference include/mxnet/base.h / mshadow dtype flags)
_TYPE_FLAG_TO_NP = {
    0: np.float32,
    1: np.float64,
    2: np.float16,
    3: np.uint8,
    4: np.int32,
    5: np.int8,
    6: np.int64,
}
_NP_TO_TYPE_FLAG = {np.dtype(v): k for k, v in _TYPE_FLAG_TO_NP.items()}


def device_arrays(arrays, device) -> List[torch.Tensor]:
    """Tensors on ``device`` of numpy arrays, in order. To the card: one
    pinned staging buffer a dtype and one host-to-device copy of it,
    split into a tensor of its own for each array. A bfloat16 array
    (ml_dtypes, as the JAX package's states hold) goes through
    float32."""
    device = torch.device(device)
    host = []
    for a in arrays:
        a = np.asarray(a)
        low = a.dtype.name == "bfloat16"
        host.append((a.astype(np.float32) if low else a, low))
    if device.type != "cuda":
        out = []
        for a, low in host:
            t = torch.from_numpy(np.array(a))
            out.append(t.to(torch.bfloat16) if low else t)
        return out
    out: list = [None] * len(host)
    by_dtype: Dict[np.dtype, list] = {}
    for i, (a, _) in enumerate(host):
        by_dtype.setdefault(a.dtype, []).append(i)
    for dt, idx in by_dtype.items():
        total = sum(host[i][0].size for i in idx)
        buf = torch.empty(total, dtype=torch_dtype(dt), pin_memory=True)
        flat = buf.numpy()
        off = 0
        for i in idx:
            n = host[i][0].size
            flat[off:off + n] = host[i][0].reshape(-1)
            off += n
        dev_buf = buf.to(device, non_blocking=True)
        off = 0
        for i in idx:
            a, low = host[i]
            t = dev_buf[off:off + a.size].view(a.shape).clone()
            out[i] = t.to(torch.bfloat16) if low else t
            off += a.size
    return out


def _save_one(parts: list, a: np.ndarray):
    dt = np.dtype(a.dtype)
    if dt.name == "bfloat16":  # no mshadow code for bf16 in 1.x files
        a = a.astype(np.float32)
        dt = np.dtype(np.float32)
    if a.ndim == 0:
        # the reference format has no 0-d arrays (ndim 0 marks a "none"
        # NDArray with no payload, ndarray.cc:1556); persist as (1,)
        a = a.reshape(1)
    if dt not in _NP_TO_TYPE_FLAG:
        raise MXNetError("dtype %s not serializable to .params" % dt)
    parts.append(struct.pack("<I", NDARRAY_V2_MAGIC))
    parts.append(struct.pack("<i", 0))  # kDefaultStorage (ndarray.h:63)
    parts.append(struct.pack("<I", a.ndim))
    parts.append(struct.pack("<%dq" % a.ndim, *a.shape))
    parts.append(struct.pack("<ii", 1, 0))  # Context: cpu(0)
    parts.append(struct.pack("<i", _NP_TO_TYPE_FLAG[dt]))
    parts.append(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from("<" + fmt, self.buf, self.pos)
        self.pos += size
        return vals if len(vals) > 1 else vals[0]

    def read_bytes(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out


def _load_shape_v2(r: _Reader) -> Tuple[int, ...]:
    ndim = r.read("I")
    if ndim == 0:
        return ()
    return tuple(r.read("%dq" % ndim) if ndim > 1 else (r.read("q"),))


def _load_sparse_v2(r: _Reader, stype: int) -> np.ndarray:
    """Parse a V2 sparse entry (row_sparse=1: 1 aux [indices]; csr=2: 2 aux
    [indptr, indices] — reference ndarray.cc NDArray::Save) and densify."""
    nad = 1 if stype == 1 else 2
    storage_shape = _load_shape_v2(r)
    shape = _load_shape_v2(r)
    if len(shape) == 0:
        return np.zeros((), dtype=np.float32)
    r.read("ii")  # context
    type_flag = r.read("i")
    aux = []
    for _ in range(nad):
        aux_type = r.read("i")
        aux_shape = _load_shape_v2(r)
        aux.append((np.dtype(_TYPE_FLAG_TO_NP[aux_type]), aux_shape))
    dt = np.dtype(_TYPE_FLAG_TO_NP[type_flag])
    count = int(np.prod(storage_shape)) if storage_shape else 0
    data = np.frombuffer(r.read_bytes(count * dt.itemsize), dtype=dt)
    data = data.reshape(storage_shape) if storage_shape else data
    aux_data = []
    for adt, ashape in aux:
        acount = int(np.prod(ashape)) if ashape else 0
        ad = np.frombuffer(r.read_bytes(acount * adt.itemsize), dtype=adt)
        aux_data.append(ad.reshape(ashape) if ashape else ad)
    dense = np.zeros(shape, dtype=dt)
    if stype == 1:  # row_sparse: aux[0] = row indices
        if aux_data[0].size:
            dense[aux_data[0].astype(np.int64)] = data
    else:  # csr: aux[0] = indptr, aux[1] = col indices
        indptr, indices = aux_data
        for row in range(shape[0]):
            lo, hi = int(indptr[row]), int(indptr[row + 1])
            if hi > lo:
                dense[row, indices[lo:hi].astype(np.int64)] = data[lo:hi]
    return dense


def _load_one(r: _Reader) -> np.ndarray:
    magic = r.read("I")
    if magic == NDARRAY_V2_MAGIC:
        stype = r.read("i")
        if stype not in (0, 1, 2):
            raise MXNetError("unknown storage type in .params (stype=%d)"
                             % stype)
        if stype != 0:
            return _load_sparse_v2(r, stype)
        shape = _load_shape_v2(r)
    elif magic == NDARRAY_V1_MAGIC:
        shape = _load_shape_v2(r)
    else:
        # pre-V1: magic itself is ndim, uint32 dims
        ndim = magic
        shape = tuple(r.read("%dI" % ndim)) if ndim > 1 else (
            (r.read("I"),) if ndim else ())
    if len(shape) == 0:
        return np.zeros((), dtype=np.float32)
    r.read("ii")  # context
    type_flag = r.read("i")
    dt = np.dtype(_TYPE_FLAG_TO_NP[type_flag])
    count = int(np.prod(shape))
    data = np.frombuffer(r.read_bytes(count * dt.itemsize), dtype=dt)
    return data.reshape(shape).copy()


def save(fname: str, data) -> None:
    """Save a dict of NDArrays, a list of them or one NDArray (reference
    ``mx.nd.save``); device arrays come to the host in one batched
    transfer."""
    from .ndarray import NDArray

    if isinstance(data, NDArray):
        data = [data]
    names: List[str] = []
    if isinstance(data, dict):
        names = list(data.keys())
        values = list(data.values())
    elif isinstance(data, (list, tuple)):
        values = list(data)
    else:
        raise MXNetError("save expects dict, list, or NDArray")
    tensors = [getattr(v, "_data", v) for v in values]
    dev = [i for i, t in enumerate(tensors) if isinstance(t, torch.Tensor)]
    arrays = [None if isinstance(t, torch.Tensor) else np.asarray(t)
              for t in tensors]
    for i, host in zip(dev, fetch_host([tensors[i] for i in dev])):
        arrays[i] = host

    parts: list = [struct.pack("<QQ", kMXAPINDArrayListMagic, 0)]
    parts.append(struct.pack("<Q", len(arrays)))
    for a in arrays:
        _save_one(parts, a)
    parts.append(struct.pack("<Q", len(names)))
    for n in names:
        nb = n.encode("utf-8")
        parts.append(struct.pack("<Q", len(nb)))
        parts.append(nb)
    with open(fname, "wb") as f:
        for p in parts:
            f.write(p)


def load_np(fname: str) -> Union[Dict[str, np.ndarray], List[np.ndarray]]:
    """Load a .params file into numpy arrays (names preserved)."""
    with open(fname, "rb") as f:
        buf = f.read()
    r = _Reader(buf)
    header, _reserved = r.read("QQ")
    if header != kMXAPINDArrayListMagic:
        raise MXNetError("Invalid NDArray file format (bad magic 0x%x)"
                         % header)
    n_arrays = r.read("Q")
    arrays = [_load_one(r) for _ in range(n_arrays)]
    n_names = r.read("Q")
    names = []
    for _ in range(n_names):
        ln = r.read("Q")
        names.append(r.read_bytes(ln).decode("utf-8"))
    if names:
        if len(names) != len(arrays):
            raise MXNetError("Invalid NDArray file format (names/arrays "
                             "mismatch)")
        return dict(zip(names, arrays))
    return arrays


def load(fname: str, ctx=None):
    """Load a .params file into NDArrays (reference ``mx.nd.load``) on
    ``ctx``, by default the current context."""
    from .ndarray import NDArray

    out = load_np(fname)
    dev = (ctx or current_context()).torch_device()
    if isinstance(out, dict):
        tensors = device_arrays(list(out.values()), dev)
        return {k: NDArray(t) for k, t in zip(out, tensors)}
    return [NDArray(t) for t in device_arrays(out, dev)]
