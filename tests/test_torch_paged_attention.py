"""mxnet_tpu_torch.ops.paged_attention against the JAX package (CPU).

The port's plain PyTorch version is held against the JAX reference
(``pallas_kernels.paged_attention_reference``) and the Pallas kernel in
interpret mode (``ragged_paged_attention(..., interpret=True)``) on the
cases of ``test_decode.py``'s kernel suite, at ``atol=rtol=2e-5`` in fp32
(the tolerance that suite holds the Pallas kernel to: float32 sums taken
in different orders by XLA-CPU and torch-CPU). The CUDA kernel itself
runs only on the card: ``test_cuda_kernel_matches_plain_version`` holds
it to the plain version there and skips elsewhere.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import paged_attention as pa

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture
def cuda_device():
    # decided here, per test, never at import: every xdist worker must
    # collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


def _rand_pool(rng, s, h, kh, d, pages, page_size, max_pages):
    q = rng.randn(s, h, d).astype(np.float32)
    kp = rng.randn(pages, page_size, kh, d).astype(np.float32)
    vp = rng.randn(pages, page_size, kh, d).astype(np.float32)
    pt = rng.randint(1, pages, (s, max_pages)).astype(np.int32)
    return q, kp, vp, pt


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _assert_parity(q, kp, vp, pt, sl, q_pos=None):
    jq = _jax(q, kp, vp, pt, sl)
    jqp = None if q_pos is None else jnp.asarray(q_pos)
    ref = np.asarray(pk.paged_attention_reference(*jq, q_pos=jqp))
    ker = np.asarray(pk.ragged_paged_attention(*jq, q_pos=jqp,
                                               interpret=True))
    tq = _torch(q, kp, vp, pt, sl)
    tqp = None if q_pos is None else torch.from_numpy(q_pos)
    got = pa.paged_attention_reference(*tq, q_pos=tqp).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, ker, **TOL)
    return got


# the kernel cases of test_decode.py:54-104, one parametrised test:
# (seed, S, H, KH, D, pages, page_size, max_pages, seq_lens, q_pos)
_CASES = {
    "ragged_noncausal": (0, 4, 8, 8, 16, 9, 8, 3, [1, 7, 13, 24], None),
    "causal_q_pos": (1, 4, 4, 4, 8, 7, 8, 3, [5, 9, 16, 24],
                     [0, 3, 8, 20]),
    "page_boundaries": (2, 4, 4, 4, 8, 11, 8, 4, [7, 8, 9, 32], None),
    "gqa_8_over_2": (3, 3, 8, 2, 16, 6, 8, 2, [3, 10, 16], None),
    "head_dim_4": (8, 3, 2, 1, 4, 5, 4, 3, [0, 5, 12], [0, 2, 11]),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_plain_version_matches_jax_reference_and_pallas(case):
    seed, s, h, kh, d, pages, ps, mp, sl, qpos = _CASES[case]
    rng = np.random.RandomState(seed)
    q, kp, vp, pt = _rand_pool(rng, s, h, kh, d, pages, ps, mp)
    _assert_parity(q, kp, vp, pt, np.asarray(sl, np.int32),
                   None if qpos is None else np.asarray(qpos, np.int32))


def test_inactive_slot_is_exact_zeros():
    rng = np.random.RandomState(4)
    q, kp, vp, pt = _rand_pool(rng, 3, 4, 4, 8, 5, 8, 2)
    got = _assert_parity(q, kp, vp, pt, np.asarray([0, 5, 0], np.int32))
    assert (got[0] == 0).all() and (got[2] == 0).all()
    assert np.abs(got[1]).sum() > 0


def test_indivisible_gqa_raises_with_the_jax_message():
    rng = np.random.RandomState(5)
    q, kp, vp, pt = _rand_pool(rng, 2, 6, 4, 8, 4, 8, 1)
    sl = np.asarray([4, 4], np.int32)
    with pytest.raises(ValueError, match="not divisible"):
        pk.ragged_paged_attention(*_jax(q, kp, vp, pt, sl), interpret=True)
    for fn in (pa.paged_attention, pa.paged_attention_reference):
        with pytest.raises(ValueError, match="not divisible"):
            fn(*_torch(q, kp, vp, pt, sl))


def test_prefill_attention_matches_jax():
    # a 6-token chunk at absolute position 9 of one sequence, 2 padding
    # rows: queries see the prefix and the chunk causally, padding zeros
    rng = np.random.RandomState(9)
    q, kp, vp, pt = _rand_pool(rng, 8, 4, 2, 8, 7, 4, 5)
    row = pt[0]
    ref = np.asarray(pk.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(row),
        jnp.asarray(9, jnp.int32), jnp.asarray(6, jnp.int32)))
    tq, tk, tv, trow = _torch(q, kp, vp, row)
    got = pa.paged_prefill_attention(tq, tk, tv, trow, 9, 6).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert (got[6:] == 0).all()


def test_dispatcher_sends_cpu_tensors_to_the_plain_version(monkeypatch):
    rng = np.random.RandomState(6)
    args = _torch(*_rand_pool(rng, 2, 4, 4, 8, 4, 8, 2),
                  np.asarray([5, 12], np.int32))

    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA kernel")

    monkeypatch.setattr(pa, "ragged_paged_attention", no_kernel)
    got = pa.paged_attention(*args)
    np.testing.assert_array_equal(got.numpy(),
                                  pa.paged_attention_reference(*args).numpy())


def test_kernel_wrapper_refuses_cpu_and_dispatcher_refuses_other_devices():
    rng = np.random.RandomState(7)
    args = _torch(*_rand_pool(rng, 2, 4, 4, 8, 4, 8, 2),
                  np.asarray([5, 12], np.int32))
    before = pa.ragged_paged_attention.launches
    with pytest.raises(MXNetError, match="CUDA tensor"):
        pa.ragged_paged_attention(*args)
    meta = [a.to("meta") for a in args]
    with pytest.raises(MXNetError, match="no kernel for device"):
        pa.paged_attention(*meta)
    assert pa.ragged_paged_attention.launches == before


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    # bench shape: S=16, H=KH=8, D=64, page_size=16, max_pages=72, ragged
    # lengths incl. 0 and k*16+-1; fp32 with another summation order than
    # the plain version's einsum -> atol=rtol=1e-4
    rng = np.random.RandomState(11)
    q, kp, vp, pt = _rand_pool(rng, 16, 8, 8, 64, 200, 16, 72)
    sl = np.asarray([0, 1, 15, 16, 17, 31, 32, 33, 100, 255, 256, 257,
                     600, 1000, 1151, 1152], np.int32)
    args = [a.to(cuda_device) for a in _torch(q, kp, vp, pt, sl)]
    got = pa.ragged_paged_attention(*args)
    torch.cuda.synchronize(cuda_device)
    want = pa.paged_attention_reference(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


# -- the kernel's tiling (_split_plan) and its split-and-merge arithmetic --

def _row_limits(seq_lens=None, q_pos=None, chunk=None, rows=None,
                tokens=None):
    """Each row's limit as the kernel computes it: decode min(seq_len,
    q_pos + 1); chunk (start, length): start + i + 1, 0 for padding."""
    if chunk is not None:
        start, length = chunk
        lim = [start + i + 1 if i < length else 0 for i in range(rows)]
    else:
        lim = list(seq_lens)
        if q_pos is not None:
            lim = [min(n, p + 1) for n, p in zip(lim, q_pos)]
    return [max(0, min(n, tokens)) for n in lim]


def _launched(plan, n_heads, n_kv, limits, span):
    """The blocks the grid launches and the kernel does not skip:
    [(rows, heads, first position, end position)]."""
    groups = n_heads // n_kv
    gchunks = -(-groups // plan.gpb)
    out = []
    for bx in range(plan.grid[0]):
        rows = range(bx * plan.rows_tile,
                     min(len(limits), (bx + 1) * plan.rows_tile))
        blk = max(limits[r] for r in rows)
        for by in range(plan.grid[1]):
            kh, g0 = by // gchunks, (by % gchunks) * plan.gpb
            heads = [kh * groups + g
                     for g in range(g0, min(groups, g0 + plan.gpb))]
            for bz in range(plan.grid[2]):
                if bz * span < blk:
                    out.append((list(rows), heads, bz * span,
                                min(bz * span + span, blk)))
    return out


# (rows, H, KH, D, page_size, max_pages, chunk (start, length) or None,
#  seq_lens or None): the decode bench tick, every slot at max_seq_len,
# the 32-row prefix-hit chunk, the 64-row chunk, GQA
_PLAN_CASES = {
    "decode_bench": (16, 8, 8, 64, 16, 72, None,
                     [0, 1, 15, 16, 17, 31, 32, 33, 47, 100, 255, 256, 257,
                      600, 1151, 1152]),
    "decode_1152": (16, 8, 8, 64, 16, 72, None, [1152] * 16),
    "decode_gqa_8_over_2": (16, 8, 2, 64, 16, 72, None,
                            [5, 128, 129, 1152] * 4),
    "chunk_32": (32, 8, 8, 64, 16, 72, (32, 20), None),
    "chunk_64": (64, 8, 8, 64, 16, 72, (512, 64), None),
    "chunk_64_gqa_8_over_2": (64, 8, 2, 64, 16, 72, (512, 64), None),
    "chunk_head_dim_256": (64, 16, 4, 256, 16, 72, (1000, 50), None),
}


@pytest.mark.parametrize("span", [16, 64, pa.SPAN])
@pytest.mark.parametrize("case", sorted(_PLAN_CASES))
def test_split_plan_covers_each_position_below_the_limit_once(case, span):
    rows, h, kh, d, ps, mp, chunk, lens = _PLAN_CASES[case]
    plan = pa._split_plan(rows, h, kh, d, ps, mp, chunk=chunk is not None,
                          span=span)
    limits = _row_limits(lens, chunk=chunk, rows=rows, tokens=mp * ps)
    seen = np.zeros((rows, h, mp * ps), np.int64)
    for block_rows, heads, lo, hi in _launched(plan, h, kh, limits, span):
        for r in block_rows:
            seen[r, heads, lo:hi] += 1
    for r, lim in enumerate(limits):
        assert (seen[r, :, :lim] == 1).all(), (r, lim)
        # the merge reads spans below ceil(limit / span): all launched
        assert -(-lim // span) <= plan.nsplit
    assert plan.grid[1] <= 65535 and plan.grid[2] <= 65535
    assert plan.nsplit == -(-mp * ps // span)
    assert plan.acc_shape == (rows, h, plan.nsplit, d)
    assert plan.ml_shape == (rows, h, plan.nsplit, 2)
    assert plan.workspace_numel == rows * h * plan.nsplit * (d + 2)
    assert plan.rows_tile * plan.gpb <= pa.MAX_UNITS
    assert plan.rows_tile == (1 if chunk is None else
                              min(rows, pa.MAX_UNITS // plan.gpb))


def test_split_plan_grid_is_static_per_shape():
    # the grid depends on shapes alone: lengths never enter the plan
    a = pa._split_plan(16, 8, 8, 64, 16, 72)
    assert a == pa._split_plan(16, 8, 8, 64, 16, 72)
    assert a.grid == (16, 8, 9) and a.workspace_numel == 16 * 8 * 9 * 66
    # more query heads per kv head than a block holds: group chunks
    g = pa._split_plan(4, 64, 1, 64, 16, 8)
    assert g.gpb == pa.MAX_UNITS and g.grid[1] == 64 // pa.MAX_UNITS


def _replay(q, kp, vp, tables, limits, plan, span, scale, max_limit):
    """The kernels' arithmetic in torch, block by block from the plan,
    into an output and a workspace that start as NaN (the wrapper's
    ``torch.empty``). The span-0 block of a row tile writes exact zeros
    for its rows with limit 0. Each launched block then takes, per (row,
    head) it holds, the partial state (m, l, acc) over the positions of
    its span below the row's limit; a block whose span starts at or past
    the row's limit writes nothing for that row, a row of one span is
    finished by its span-0 block, and a longer row's span goes to the
    workspace. The merge runs only where ``max_limit`` (the entry point's
    bound on every limit) passes the span; it skips rows of at most one
    span, combines the others' spans below ceil(limit / span) with
    weights exp(m_j - max m), and writes zeros where the total is 0.
    Returns the output and how often each (row, head) was written."""
    rows, h, d = q.shape
    kh = kp.shape[2]
    groups = h // kh
    nan = float("nan")
    m = torch.full((rows, h, plan.nsplit), nan)
    l = torch.full((rows, h, plan.nsplit), nan)
    acc = torch.full((rows, h, plan.nsplit, d), nan)
    out = torch.full((rows, h, d), nan)
    writes = np.zeros((rows, h), np.int64)
    for r in range(rows):  # every span-0 block runs this, launched or not
        if limits[r] == 0:
            out[r] = 0.0
            writes[r] += 1
    for block_rows, heads, lo, hi in _launched(plan, h, kh, limits, span):
        z = lo // span
        for r in block_rows:
            if lo >= limits[r]:
                continue
            pos = torch.arange(lo, hi)
            pages = tables[r][pos // kp.shape[1]].long()
            ok = pos < limits[r]
            for hh in heads:
                k = kp[pages, pos % kp.shape[1], hh // groups]
                v = vp[pages, pos % kp.shape[1], hh // groups]
                s = torch.where(ok, (k @ q[r, hh]) * scale,
                                torch.tensor(float("-inf")))
                mj = s.max()
                e = torch.exp(s - mj)
                if limits[r] <= span:
                    out[r, hh] = (e @ v) / e.sum()
                    writes[r, hh] += 1
                else:
                    m[r, hh, z], l[r, hh, z] = mj, e.sum()
                    acc[r, hh, z] = e @ v
    if max_limit > span:
        for r in range(rows):
            ns = -(-limits[r] // span)
            if ns <= 1:
                continue
            mj = m[r, :, :ns]
            mx = mj.max(dim=1, keepdim=True).values
            w = torch.where(mj == float("-inf"), torch.zeros_like(mj),
                            torch.exp(mj - mx))
            tot = (l[r, :, :ns] * w).sum(dim=1)
            num = (acc[r, :, :ns] * w[..., None]).sum(dim=1)
            out[r] = torch.where(tot[:, None] > 0,
                                 num / tot.clamp_min(1e-38)[:, None],
                                 torch.zeros_like(num))
            writes[r] += 1
    return out, writes


# (seed, rows, H, KH, D, span, chunk (start, length) or None, seq_lens,
#  q_pos): lengths at span - 1, span, span + 1; a causal bound ending
# inside a split; GQA 8/2; a slot of length 0; a chunk with padding rows;
# chunks whose row tiles straddle a span boundary, their start not a
# multiple of the tile (8 rows at H = KH; 2 at GQA 8/2; 4 at 4/2); a chunk
# that ends inside span 0 (no merge)
_REPLAY_CASES = {
    "span16_edges": (20, 4, 4, 2, 16, 16, None, [15, 16, 17, 40], None),
    "span64_edges": (21, 4, 4, 4, 16, 64, None, [63, 64, 65, 130], None),
    "span128_edges": (22, 4, 4, 4, 16, 128, None, [127, 128, 129, 0], None),
    "q_pos_inside_a_split": (23, 4, 4, 4, 16, 16, None, [100, 100, 64, 9],
                             [40, 70, 63, 3]),
    "gqa_8_over_2": (24, 4, 8, 2, 16, 16, None, [0, 33, 48, 129], None),
    "length_0": (25, 3, 4, 4, 8, 64, None, [0, 65, 0], None),
    "chunk_with_padding": (26, 12, 4, 2, 16, 16, (30, 9), None, None),
    "chunk_start_0": (27, 12, 4, 4, 16, 64, (0, 12), None, None),
    "chunk_straddles_span128": (28, 12, 4, 4, 16, 128, (125, 9), None, None),
    "chunk_straddles_span16_gqa_8_over_2": (29, 12, 8, 2, 16, 16, (15, 10),
                                            None, None),
    "chunk_straddles_span16_gqa_4_over_2": (30, 12, 4, 2, 16, 16, (13, 9),
                                            None, None),
    "chunk_within_span0": (31, 12, 4, 2, 16, 64, (20, 7), None, None),
}


@pytest.mark.parametrize("case", sorted(_REPLAY_CASES))
def test_split_and_merge_replay_matches_jax_reference(case):
    seed, rows, h, kh, d, span, chunk, lens, qpos = _REPLAY_CASES[case]
    rng = np.random.RandomState(seed)
    ps, mp = 8, 17  # 136 positions: room for 2 * 64 + 1
    q, kp, vp, pt = _rand_pool(rng, rows, h, kh, d, 30, ps, mp)
    if chunk is not None:
        start, length = chunk
        pt = np.repeat(pt[:1], rows, axis=0)  # one sequence's row
        idx = np.arange(rows, dtype=np.int32)
        qpos_arr = (start + idx).astype(np.int32)
        sl = np.where(idx < length, qpos_arr + 1, 0).astype(np.int32)
    else:
        sl = np.asarray(lens, np.int32)
        qpos_arr = None if qpos is None else np.asarray(qpos, np.int32)
    ref = np.asarray(pk.paged_attention_reference(
        *_jax(q, kp, vp, pt, sl),
        q_pos=None if qpos_arr is None else jnp.asarray(qpos_arr)))
    plan = pa._split_plan(rows, h, kh, d, ps, mp, chunk=chunk is not None,
                          span=span)
    limits = _row_limits(None if chunk else lens, q_pos=qpos, chunk=chunk,
                         rows=rows, tokens=mp * ps)
    # the entry points' bound on every limit: a chunk's last real row, a
    # decode table's width
    max_limit = sum(chunk) if chunk is not None else mp * ps
    got, writes = _replay(*_torch(q, kp, vp, pt), limits, plan, span,
                          1.0 / d ** 0.5, max_limit)
    got = got.numpy()
    # every output row written once, by one block: no two blocks race
    assert (writes == 1).all(), writes
    np.testing.assert_allclose(got, ref, **TOL)
    for r, lim in enumerate(limits):
        if lim == 0:
            assert (got[r] == 0).all()


def test_prefill_wrapper_refuses_cpu_and_counts_no_launch():
    rng = np.random.RandomState(12)
    q, kp, vp, pt = _rand_pool(rng, 6, 4, 2, 8, 7, 4, 5)
    before = pa.ragged_paged_attention.launches
    with pytest.raises(MXNetError, match="CUDA tensor"):
        pa.ragged_prefill_attention(*_torch(q, kp, vp, pt[0]), 3, 4)
    assert pa.ragged_paged_attention.launches == before


def _cuda_chunk(rng, dev, c, start, n, h, kh, d=64, ps=16, mp=72):
    q, kp, vp, pt = _rand_pool(rng, c, h, kh, d, 200, ps, mp)
    q, kp, vp, row = [a.to(dev) for a in _torch(q, kp, vp, pt[0])]
    idx = torch.arange(c, dtype=torch.int32, device=dev)
    plain = pa.paged_attention_reference(
        q, kp, vp, row[None].expand(c, -1).contiguous(),
        torch.where(idx < n, idx + start + 1, torch.zeros_like(idx)),
        q_pos=idx + start)
    return (q, kp, vp, row), plain


# lengths and causal bounds at the kernel's span boundaries, and prefill
# chunks: the 64-row chunk, a first chunk shorter than its rung, one
# starting mid-page, GQA 8/2; fp32, another summation order than the
# plain version's einsum -> atol=rtol=1e-4
@pytest.mark.cuda
@pytest.mark.parametrize("case", ["span_edges", "span_edges_causal",
                                  "chunk_64", "chunk_start_0",
                                  "chunk_mid_page", "chunk_gqa_8_over_2",
                                  "chunk_straddles_span",
                                  "chunk_straddles_span_gqa_8_over_2"])
def test_cuda_kernel_boundaries_and_chunks(cuda_device, case):
    rng = np.random.RandomState(13)
    s = pa.SPAN
    edges = [k * s + e for k in range(1, 6) for e in (-1, 0, 1)] + [1152]
    if case.startswith("span_edges"):
        q, kp, vp, pt = _rand_pool(rng, 16, 8, 8, 64, 200, 16, 72)
        causal = case.endswith("causal")
        sl = np.asarray([1152] * 16 if causal else edges, np.int32)
        qp = np.asarray([n - 1 for n in edges], np.int32) if causal else None
        args = [a.to(cuda_device) for a in _torch(q, kp, vp, pt, sl)]
        qpt = None if qp is None else torch.from_numpy(qp).to(cuda_device)
        got = pa.ragged_paged_attention(*args, q_pos=qpt)
        want = pa.paged_attention_reference(*args, q_pos=qpt)
    else:
        c, start, n, kh = {"chunk_64": (64, 512, 64, 8),
                           "chunk_start_0": (64, 0, 37, 8),
                           "chunk_mid_page": (64, 40, 64, 8),
                           "chunk_gqa_8_over_2": (64, 512, 64, 2),
                           # row tiles of 8 (2 at GQA 8/2) across position
                           # SPAN, the start no multiple of the tile
                           "chunk_straddles_span": (64, 125, 64, 8),
                           "chunk_straddles_span_gqa_8_over_2":
                               (64, 101, 60, 2)}[case]
        args, want = _cuda_chunk(rng, cuda_device, c, start, n, 8, kh)
        got = pa.paged_prefill_attention(*args, start, n)
        assert (got[n:] == 0).all()
    torch.cuda.synchronize(cuda_device)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
