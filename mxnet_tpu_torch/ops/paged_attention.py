"""Ragged paged attention: the decode plane's kernels and their plain
versions.

The port of ``mxnet_tpu/ops/pallas_kernels.py:292-707``. The one-row
decode step:

* :func:`ragged_paged_attention` — the wrapper of the hand-written CUDA
  kernel ``ops/csrc/paged_attention.cu`` (it replaces the Pallas
  ``_paged_kernel``). CUDA fp32 tensors only; it checks device, dtype,
  contiguity and shapes, allocates its output with ``torch.empty``,
  launches on the current stream and counts each launch in
  ``ragged_paged_attention.launches``;
* :func:`paged_attention_reference` — the plain PyTorch version of the
  same function (the JAX ``paged_attention_reference``, line for line):
  what CPU tensors run, and what the kernel is held against on the card;
* :func:`paged_attention` — the dispatcher the decode model calls: a CUDA
  tensor goes to the kernel, a CPU tensor to the plain version, anything
  else raises. There is no fallback from the kernel to the plain version
  and no shape gate: unlike the JAX dispatcher (which sent work to Pallas
  only when ``page_size % 8 == 0 and head_dim % 128 == 0``), the kernel
  takes any ``head_dim <= 256``, any ``page_size`` and any
  ``H % KH == 0``;
* :func:`paged_prefill_attention` — C chunk queries of ONE sequence over
  that sequence's pages, causal (the prefix-cache tail and
  chunked-prefill path): on the card :func:`ragged_prefill_attention`,
  the same kernel's chunk entry point, which reads the sequence's K/V
  once per tile of chunk rows (given ``start`` and ``length`` as 0-d
  device tensors, a third entry point reads them on the card: what a
  captured CUDA graph replays); on the CPU each chunk row becomes a row
  of the plain version with the page row repeated and ``q_pos``.

The kernel's entry points split each row's positions into spans of
:data:`SPAN` tokens, one block per span, and merge the spans' partial
softmax states in a second kernel (launched only where a row may reach a
second span, which the device-scalar chunk entry point decides from the
table's size); :func:`_split_plan` mirrors that tiling (span count, grid,
rows per block, workspace) in plain Python.

Shapes: q ``(S, H, D)``; pools ``(P, page_size, KH, D)``; page_table
``(S, max_pages)`` page ids (unused entries point at the null page 0);
seq_lens / q_pos ``(S,)``. Returns ``(S, H, D)``; a slot with nothing to
attend to is exact zeros.

The speculative verify step, W query rows per slot sharing ONE page-table
row, with per-row ``seq_lens (S*W,)`` carrying the causality between a
slot's draft rows:

* :func:`ragged_spec_attention` — the wrapper of the hand-written CUDA
  kernel ``ops/csrc/paged_spec_attention.cu`` (it replaces the Pallas
  ``_paged_spec_kernel``), q ``(S, W, H, D)``; it reads each slot's K/V
  once for up to :data:`MAX_UNITS` of its W x groups query vectors,
  splits the slot over spans of :data:`SPAN` positions and merges the
  spans in the same launch (:func:`_spec_plan` mirrors the tiling); counts
  ``ragged_spec_attention.launches``;
* :func:`paged_spec_attention_reference` — its plain version (the JAX
  ``paged_spec_attention_reference``, line for line), q ``(S*W, H, D)``;
* :func:`paged_spec_attention` — the dispatcher the decode model calls
  for W > 1: W derived from ``q.shape[0] // page_table.shape[0]``, CUDA
  to the kernel, CPU to the plain version, anything else raises. Like
  :func:`paged_attention` it has no shape gate and no fallback (the JAX
  dispatcher's ``page_size % 8 == 0 and head_dim % 128 == 0`` gate meant
  the TPU never ran its spec kernel at ``head_dim`` 64; this one does).
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple, Tuple

import torch

from ..base import MXNetError
from . import _build

__all__ = ["ragged_paged_attention", "paged_attention_reference",
           "paged_attention", "paged_prefill_attention",
           "ragged_prefill_attention", "ragged_spec_attention",
           "paged_spec_attention_reference", "paged_spec_attention",
           "launch_counts", "add_launches", "MAX_HEAD_DIM", "SPAN"]

#: The largest head_dim the kernels take.
MAX_HEAD_DIM = 256
#: Positions one block of ``paged_attention.cu`` or
#: ``paged_spec_attention.cu`` covers (their ``kSpan``).
SPAN = 128
#: Query vectors one block holds (``kMaxUnits`` of both kernels): a
#: chunk block of kernel 1 holds ``MAX_UNITS // min(groups, MAX_UNITS)``
#: rows, a verify block up to ``MAX_UNITS`` of a slot's W x groups.
MAX_UNITS = 8

_NEG_BIG = -1e30  # the JAX reference's mask value
# the entry points' own codes, returned before any launch
_LAUNCH_ERRORS = {-1: "the workspace does not match the built kernel"}
_SAME_DEVICE = contextlib.nullcontext()


class SplitPlan(NamedTuple):
    """The tiling of one launch of ``paged_attention.cu``."""
    nsplit: int          # spans per row: ceil(max_pages * page_size / span)
    rows_tile: int       # rows per block (1 for decode)
    gpb: int             # query heads of one kv head per block
    grid: Tuple[int, int, int]   # (row tiles, KH x group chunks, nsplit)
    acc_shape: Tuple[int, ...]   # partial acc: (rows, H, nsplit, D)
    ml_shape: Tuple[int, ...]    # partial (m, l): (rows, H, nsplit, 2)
    workspace_numel: int         # acc then (m, l), one fp32 allocation


def _split_plan(rows, n_heads, n_kv, d, page_size, max_pages, chunk=False,
                span=SPAN):
    """The tiling of a launch, as the entry points compute it: ``rows``
    query rows (decode slots, each with its own table row, or ``chunk``
    rows of one sequence sharing one), ``n_heads`` query heads over
    ``n_kv`` kv heads of size ``d``, tables of ``max_pages`` pages of
    ``page_size``. It depends on shapes alone, so one shape always
    launches the same grid. ``span`` is the kernel's :data:`SPAN`; the
    tests replay other spans through it."""
    groups = _check_heads(n_heads, n_kv, "_split_plan")
    nsplit = -(-max_pages * page_size // span)
    gpb = min(groups, MAX_UNITS)
    rows_tile = max(1, min(rows, MAX_UNITS // gpb)) if chunk else 1
    grid = (-(-rows // rows_tile), n_kv * -(-groups // gpb), nsplit)
    cells = rows * n_heads * nsplit
    return SplitPlan(nsplit, rows_tile, gpb, grid, (rows, n_heads, nsplit, d),
                     (rows, n_heads, nsplit, 2), cells * (d + 2))


class SpecPlan(NamedTuple):
    """The tiling of one launch of ``paged_spec_attention.cu``."""
    nsplit: int          # spans per row: ceil(max_pages * page_size / span)
    rchunks: int         # row chunks of MAX_UNITS query vectors per kv head
    grid: Tuple[int, int, int]   # (slots, KH x rchunks, nsplit)
    tiles: int                   # arrival counters: slots x KH x rchunks
    workspace_numel: int         # partial acc (S*W, H, nsplit, D), then
                                 # (m, l) (S*W, H, nsplit, 2): one fp32


def _spec_plan(slots, width, n_heads, n_kv, d, page_size, max_pages,
               span=SPAN):
    """The tiling of a verify launch, as the entry point computes it:
    ``slots`` page-table rows, each shared by ``width`` query rows, whose
    ``width * groups`` query vectors per kv head go MAX_UNITS to a block
    (unit ``w * groups + g``). It depends on shapes alone, so one shape
    always launches the same grid. ``span`` is the kernel's :data:`SPAN`;
    the tests replay other spans through it."""
    groups = _check_heads(n_heads, n_kv, "_spec_plan")
    nsplit = -(-max_pages * page_size // span)
    rchunks = -(-width * groups // MAX_UNITS)
    return SpecPlan(nsplit, rchunks, (slots, n_kv * rchunks, nsplit),
                    slots * n_kv * rchunks,
                    slots * width * n_heads * nsplit * (d + 2))


def _check_heads(n_heads: int, n_kv: int, who: str) -> int:
    if n_kv < 1 or n_heads % n_kv:
        raise ValueError("%s: %d heads not divisible by %d kv heads"
                         % (who, n_heads, n_kv))
    return n_heads // n_kv


def _bind(lib: ctypes.CDLL, name: str, n_ptrs: int, n_ints: int):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_launch(who, q, q_dims, k_pool, v_pool, ints):
    """The checks both kernel wrappers make before a launch: everything on
    q's CUDA device, q and the pools contiguous fp32, q with the named
    dims (``"SHD"`` or ``"SWHD"``), pools ``(P, page_size, KH, D)`` with
    ``1 <= D <= 256`` and ``H % KH == 0``. ``ints`` are the integer
    operands by name (cast to contiguous int32 by the caller). Returns
    ``(page_size, KH, D)``."""
    if not q.is_cuda:
        raise MXNetError("%s runs on a CUDA tensor, got one on %s (use the "
                         "dispatcher)" % (who, q.device))
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)) + tuple(ints):
        if t.device != dev:
            raise MXNetError("%s: %s on %s, q on %s"
                             % (who, name, t.device, dev))
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != torch.float32:
            raise MXNetError("%s: %s must be float32, got %s"
                             % (who, name, t.dtype))
        if not t.is_contiguous():
            raise MXNetError("%s: %s must be contiguous" % (who, name))
    if q.dim() != len(q_dims) or k_pool.dim() != 4 \
            or v_pool.shape != k_pool.shape:
        raise MXNetError("%s: q (%s) and pools (P, page_size, KH, D) "
                         "expected, got %s / %s / %s"
                         % (who, ", ".join(q_dims), tuple(q.shape),
                            tuple(k_pool.shape), tuple(v_pool.shape)))
    _n_pages, page_size, n_kv, d_pool = k_pool.shape
    d = q.shape[-1]
    _check_heads(q.shape[-2], n_kv, who)
    if d_pool != d or not 1 <= d <= MAX_HEAD_DIM:
        raise MXNetError("%s: head_dim %d (pool %d) outside 1..%d"
                         % (who, d, d_pool, MAX_HEAD_DIM))
    return page_size, n_kv, d


def _launch(lib_name, fn_name, q, args, ints, scale, d, scratch=()):
    """Allocate the output, launch on q's current stream, raise on a CUDA
    error. ``args`` are the tensor operands before the output,
    ``scratch`` the buffers after it, ``ints`` the integer arguments after
    those."""
    out = torch.empty_like(q)
    ptrs = [a.data_ptr() if a is not None else None for a in args]
    ptrs.append(out.data_ptr())
    ptrs.extend(t.data_ptr() for t in scratch)
    fn = _bind(_build.load(lib_name), fn_name, len(ptrs), len(ints))
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    index = q.device.index
    # the current stream as a raw handle (no Stream object), and the
    # device made current only where it is not: host time on every tick
    stream = torch._C._cuda_getCurrentRawStream(index)
    with (_SAME_DEVICE if torch.cuda.current_device() == index
          else torch.cuda.device(index)):
        err = fn(*ptrs, *ints, float(scale), stream)
    if err != 0:
        raise MXNetError("%s kernel launch failed: %s"
                         % (lib_name,
                            _LAUNCH_ERRORS.get(err, "CUDA error %d" % err)))
    return out


def _workspace(plan, like):
    """The span blocks' partial states, uninitialised: every entry a merge
    reads is written by a span block first."""
    return torch.empty(plan.workspace_numel, dtype=torch.float32,
                       device=like.device)


# (device index, raw stream, tiles) -> the verify kernel's arrival
# counters: zeroed once, and back at zero after every launch, so each
# launch (and a captured launch's replay) finds them at zero. Launches on
# one stream are ordered; another stream gets counters of its own.
_ARRIVALS = {}


def _arrivals(plan, like):
    """The cached zeroed int32 counters of a verify launch on ``like``'s
    device and current stream. A CUDA graph capture must find them made:
    zeroing them inside the capture would put the memset in the graph and
    cache memory of the graph's own pool, so it raises instead (an eager
    launch on the capturing stream, before the capture, makes them)."""
    index = like.device.index
    key = (index, torch._C._cuda_getCurrentRawStream(index), plan.tiles)
    buf = _ARRIVALS.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise MXNetError(
                "ragged_spec_attention: no arrival counters for this stream "
                "and shape; run the launch once on the capturing stream "
                "before the capture")
        buf = _ARRIVALS[key] = torch.zeros(plan.tiles, dtype=torch.int32,
                                           device=like.device)
    return buf


def ragged_paged_attention(q, k_pool, v_pool, page_table, seq_lens,
                           q_pos=None, scale=None):
    """Launch the CUDA paged-attention kernel (one query row per slot).

    Every tensor must lie on the same CUDA device; q and the pools are
    contiguous fp32, page_table / seq_lens / q_pos integer (cast to
    contiguous int32 here). Raises on anything else — the kernel has no
    CPU form; :func:`paged_attention` sends CPU tensors to the plain
    version instead.
    """
    ints = (("page_table", page_table), ("seq_lens", seq_lens)) + \
        ((("q_pos", q_pos),) if q_pos is not None else ())
    page_size, n_kv, d = _check_launch(
        "ragged_paged_attention", q, "SHD", k_pool, v_pool, ints)
    s_slots, n_heads, _ = q.shape
    if page_table.dim() != 2 or page_table.shape[0] != s_slots \
            or tuple(seq_lens.shape) != (s_slots,) \
            or (q_pos is not None and tuple(q_pos.shape) != (s_slots,)):
        raise MXNetError("ragged_paged_attention: page_table (S, max_pages) "
                         "and seq_lens/q_pos (S,) expected for S=%d" % s_slots)
    pt = page_table.to(torch.int32).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    qp = q_pos.to(torch.int32).contiguous() if q_pos is not None else None
    if s_slots == 0:
        return torch.empty_like(q)
    plan = _split_plan(s_slots, n_heads, n_kv, d, page_size, pt.shape[1])
    out = _launch("paged_attention", "paged_attention_f32", q,
                  (q, k_pool, v_pool, pt, sl, qp),
                  (s_slots, n_heads, n_kv, d, page_size, pt.shape[1],
                   plan.nsplit), scale, d, (_workspace(plan, q),))
    ragged_paged_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0
ragged_paged_attention.launches = 0


def paged_attention_reference(q, k_pool, v_pool, page_table, seq_lens,
                              q_pos=None, scale=None):
    """Plain PyTorch ragged paged attention — the kernel's parity oracle
    and the decode path for CPU tensors. Gathers (S, max_pages*page_size)
    K/V views through the page table, exactly as the JAX reference."""
    s_slots, n_heads, d = q.shape
    _, page_size, n_kv, _ = k_pool.shape
    groups = _check_heads(n_heads, n_kv, "paged_attention_reference")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    t = page_table.shape[1] * page_size
    pt = page_table.long()
    # (S, max_pages, page_size, KH, D) -> (S, T, KH, D)
    k = k_pool[pt].reshape(s_slots, t, n_kv, d)
    v = v_pool[pt].reshape(s_slots, t, n_kv, d)
    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    scores = torch.einsum("shd,sthd->sht", q.float(), k.float()) * scale
    pos = torch.arange(t, device=q.device)
    valid = pos[None, :] < seq_lens.long()[:, None]
    if q_pos is not None:
        valid = valid & (pos[None, :] <= q_pos.long()[:, None])
    scores = torch.where(valid[:, None, :], scores,
                         torch.full_like(scores, _NEG_BIG))
    any_valid = valid.any(dim=1)[:, None, None]
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("sht,sthd->shd", p, v.float())
    return torch.where(any_valid, out, torch.zeros_like(out)).to(q.dtype)


def paged_attention(q, k_pool, v_pool, page_table, seq_lens, q_pos=None,
                    scale=None):
    """Dispatcher the decode model calls: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor, an error otherwise."""
    _check_heads(q.shape[1], k_pool.shape[2], "paged_attention")
    if q.is_cuda:
        return ragged_paged_attention(q, k_pool, v_pool, page_table,
                                      seq_lens, q_pos=q_pos, scale=scale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, page_table,
                                         seq_lens, q_pos=q_pos, scale=scale)
    raise MXNetError("paged_attention: no kernel for device %s (cuda or "
                     "cpu)" % (q.device,))


def ragged_spec_attention(q, k_pool, v_pool, page_table, seq_lens,
                          scale=None):
    """Launch the CUDA multi-query paged-attention kernel (the
    speculative verify step).

    q: ``(S, W, H, D)`` — W query rows per slot (committed token + drafts,
    in position order); page_table: ``(S, max_pages)``, ONE row per slot,
    shared by its W queries; seq_lens: ``(S*W,)`` PER ROW — row w of slot
    s attends positions ``< seq_lens[s*W + w]``, so a draft row sees the
    committed prefix and the draft rows below it, and a padded or
    inactive row carries 0 and returns exact zeros. Same device, dtype
    and layout rules as :func:`ragged_paged_attention`. Returns
    ``(S, W, H, D)``. One launch at every length: the last span block of
    each (slot, kv head, row chunk) merges its rows' spans, counted on
    zeroed counters cached per device and stream (:func:`_arrivals`).
    """
    ints = (("page_table", page_table), ("seq_lens", seq_lens))
    page_size, n_kv, d = _check_launch(
        "ragged_spec_attention", q, "SWHD", k_pool, v_pool, ints)
    s_slots, width, n_heads, _ = q.shape
    if page_table.dim() != 2 or page_table.shape[0] != s_slots \
            or tuple(seq_lens.shape) != (s_slots * width,):
        raise MXNetError("ragged_spec_attention: page_table (S, max_pages) "
                         "and seq_lens (S*W,) expected for S=%d, W=%d"
                         % (s_slots, width))
    pt = page_table.to(torch.int32).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    if s_slots == 0 or width == 0:
        return torch.empty_like(q)
    plan = _spec_plan(s_slots, width, n_heads, n_kv, d, page_size,
                      pt.shape[1])
    out = _launch("paged_spec_attention", "paged_spec_attention_f32", q,
                  (q, k_pool, v_pool, pt, sl),
                  (s_slots, width, n_heads, n_kv, d, page_size, pt.shape[1],
                   plan.nsplit, plan.tiles), scale, d,
                  (_workspace(plan, q), _arrivals(plan, q)))
    ragged_spec_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0
ragged_spec_attention.launches = 0


def launch_counts():
    """``(kernel 1, kernel 2)``: the launch counts of
    :func:`ragged_paged_attention` (with :func:`ragged_prefill_attention`)
    and :func:`ragged_spec_attention`."""
    return (ragged_paged_attention.launches, ragged_spec_attention.launches)


def add_launches(counts, times=1):
    """Add ``times`` x ``counts``, a ``(kernel 1, kernel 2)`` pair, to the
    launch counts: what a CUDA graph launches when it replays the kernels
    its capture recorded. Their wrappers ran only during the capture,
    which launches nothing, so the caller takes the capture's own counts
    back with ``times=-1``."""
    ragged_paged_attention.launches += counts[0] * times
    ragged_spec_attention.launches += counts[1] * times


def paged_spec_attention_reference(q, k_pool, v_pool, page_table, seq_lens,
                                   scale=None):
    """Plain PyTorch multi-query verify step — the spec kernel's parity
    oracle and the path for CPU tensors: each of a slot's W query rows is
    treated as its own single-query slot sharing the slot's page-table
    row, with the per-row seq_lens carrying causality. q: ``(S*W, H, D)``,
    page_table: ``(S, max_pages)``, seq_lens: ``(S*W,)``. Returns
    ``(S*W, H, D)``."""
    s_rows = q.shape[0]
    width = s_rows // page_table.shape[0]
    pt = torch.repeat_interleave(page_table.to(torch.int32), width, dim=0)
    return paged_attention_reference(q, k_pool, v_pool, pt, seq_lens,
                                     scale=scale)


def paged_spec_attention(q, k_pool, v_pool, page_table, seq_lens,
                         scale=None):
    """Dispatcher for the widened (speculative) decode step: q is the
    flattened ``(S*W, H, D)`` query block, W derived from the page-table
    row count, so the model's decode needs no signature change. The CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor, an
    error otherwise."""
    _check_heads(q.shape[1], k_pool.shape[2], "paged_spec_attention")
    s_slots = page_table.shape[0]
    width = q.shape[0] // s_slots
    if q.is_cuda:
        out = ragged_spec_attention(
            q.reshape(s_slots, width, q.shape[1], q.shape[2]), k_pool,
            v_pool, page_table, seq_lens, scale=scale)
        return out.reshape(q.shape)
    if q.device.type == "cpu":
        return paged_spec_attention_reference(q, k_pool, v_pool, page_table,
                                              seq_lens, scale=scale)
    raise MXNetError("paged_spec_attention: no kernel for device %s (cuda "
                     "or cpu)" % (q.device,))


def _chunk_scalars(start, length, like):
    """``(start, length)`` as the int32 pair on ``like``'s device that
    ``paged_prefill_attention_dev_f32`` reads: the pair itself where
    ``length`` sits right after ``start`` in one int32 buffer (the decode
    engine's static chunk operand), a new two-element tensor otherwise."""
    for name, t in (("start", start), ("length", length)):
        if t.dim() != 0 or t.device != like.device \
                or t.dtype not in (torch.int32, torch.int64):
            raise MXNetError("ragged_prefill_attention: %s must be an int "
                             "or a 0-d integer tensor on %s" % (name,
                                                                like.device))
    if start.dtype == length.dtype == torch.int32 \
            and length.data_ptr() == start.data_ptr() + 4:
        return start
    return torch.stack((start, length)).to(torch.int32)


def ragged_prefill_attention(q, k_pool, v_pool, page_row, start, length,
                             scale=None):
    """Launch the CUDA paged-attention kernel's chunk entry point: C chunk
    rows of ONE sequence over its page row, row i causal at position
    ``start + i``, rows at or past ``length`` exact zeros. One block holds
    a tile of chunk rows and reads each K/V tile once for all of them.

    q: ``(C, H, D)``; page_row: ``(max_pages,)`` integer (cast to
    contiguous int32 here); same device, dtype and layout rules as
    :func:`ragged_paged_attention`, whose launch count it adds to (the
    chunk was a launch of that kernel before it had its own entry
    point). ``start`` and ``length`` are ints, passed to the kernel as
    launch arguments, or 0-d integer tensors on q's device, which the
    kernel reads there (``paged_prefill_attention_dev_f32``: no host read,
    so a CUDA graph can capture the launch and replay it for every chunk
    of the shape; it launches the merge wherever the table holds more
    than :data:`SPAN` positions). Returns ``(C, H, D)``.
    """
    ints = (("page_row", page_row),)
    page_size, n_kv, d = _check_launch(
        "ragged_prefill_attention", q, "CHD", k_pool, v_pool, ints)
    c, n_heads, _ = q.shape
    if page_row.dim() != 1:
        raise MXNetError("ragged_prefill_attention: page_row (max_pages,) "
                         "expected, got %s" % (tuple(page_row.shape),))
    on_device = torch.is_tensor(start) or torch.is_tensor(length)
    if on_device:
        sl = _chunk_scalars(torch.as_tensor(start, device=q.device),
                            torch.as_tensor(length, device=q.device), q)
    row = page_row.to(torch.int32).contiguous()
    if c == 0:
        return torch.empty_like(q)
    plan = _split_plan(c, n_heads, n_kv, d, page_size, row.shape[0],
                       chunk=True)
    if on_device:
        out = _launch("paged_attention", "paged_prefill_attention_dev_f32",
                      q, (q, k_pool, v_pool, row, sl),
                      (c, n_heads, n_kv, d, page_size, row.shape[0],
                       plan.nsplit), scale, d, (_workspace(plan, q),))
    else:
        out = _launch("paged_attention", "paged_prefill_attention_f32", q,
                      (q, k_pool, v_pool, row),
                      (c, int(start), int(length), n_heads, n_kv, d,
                       page_size, row.shape[0], plan.nsplit), scale, d,
                      (_workspace(plan, q),))
    ragged_paged_attention.launches += 1
    return out


def paged_prefill_attention(q, k_pool, v_pool, page_row, start, length,
                            scale=None):
    """Chunk attention: C chunk queries of ONE sequence attend over that
    sequence's pages (the prefix already in the pool AND the chunk's own
    rows, which the model writes before calling this).

    q: (C, H, D) — the chunk's queries at absolute positions
    ``start .. start+C-1``; page_row: (max_pages,) the sequence's
    page-table row; ``length`` the chunk's real token count (padding rows
    beyond it come back zeroed). ``start`` and ``length`` are ints or 0-d
    integer tensors on q's device. A CUDA tensor goes to
    :func:`ragged_prefill_attention`; on the CPU each chunk token becomes
    its own row of the plain version, all sharing one page table row,
    with the causal bound ``q_pos = start + i``. Returns (C, H, D).
    """
    _check_heads(q.shape[1], k_pool.shape[2], "paged_prefill_attention")
    if q.is_cuda:
        return ragged_prefill_attention(q, k_pool, v_pool, page_row, start,
                                        length, scale=scale)
    if q.device.type != "cpu":
        raise MXNetError("paged_prefill_attention: no kernel for device %s "
                         "(cuda or cpu)" % (q.device,))
    c = q.shape[0]
    idx = torch.arange(c, dtype=torch.int32, device=q.device)
    if torch.is_tensor(start):
        start = start.to(torch.int32)
    else:
        start = int(start)
    if not torch.is_tensor(length):
        length = int(length)
    q_pos = idx + start
    # query i sees positions <= start+i (causal), padding rows see nothing
    seq_lens = torch.where(idx < length, q_pos + 1,
                           torch.zeros_like(q_pos))
    pt = page_row.to(device=q.device, dtype=torch.int32)[None, :] \
        .expand(c, page_row.shape[0]).contiguous()
    return paged_attention_reference(q, k_pool, v_pool, pt, seq_lens,
                                     q_pos=q_pos, scale=scale)
