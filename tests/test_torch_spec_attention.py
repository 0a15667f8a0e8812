"""The speculative verify step's attention: mxnet_tpu_torch against the
JAX package (CPU).

The port's plain version (``paged_spec_attention_reference``) is held
against the JAX reference of the same name and the Pallas kernel in
interpret mode (``ragged_spec_attention(..., interpret=True)``) on the
cases of ``test_speculative.py:135-185`` and a few more (GQA, page
boundaries, a slot padded with the null page), at ``atol=rtol=2e-5``:
float32 sums taken in different orders by XLA-CPU and torch-CPU. Rows
whose limit is 0 (inactive slots, padded draft rows) must be exact
zeros, W=1 must equal the port's one-row plain version, and the
dispatcher must derive W from the shapes. The CUDA kernel runs only on
the card: ``test_cuda_spec_kernel_matches_plain_version`` holds it to
the plain version there and skips elsewhere.

The kernel's tiling (``_spec_plan``) must cover each position below each
row's limit once per head, from shapes alone; and its arithmetic is
replayed in torch block by block (``_replay``), in several arrival
orders, from NaN-started output and workspace and zeroed arrival
counters: each (row, head) must be written exactly once, the counters
must be back at zero, and the result must match the JAX reference and
the Pallas kernel in interpret mode at 2e-5.
"""
import functools

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


def _case(seed, s, w, h, kh, d, pages, page_size, max_pages, row_lens,
          null_pad=False):
    """q (S, W, H, D), pools, page table (S, max_pages), per-row lens."""
    rng = np.random.RandomState(seed)
    q = rng.randn(s, w, h, d).astype(np.float32)
    kp = rng.randn(pages, page_size, kh, d).astype(np.float32)
    vp = rng.randn(pages, page_size, kh, d).astype(np.float32)
    pt = rng.randint(1, pages, (s, max_pages)).astype(np.int32)
    sl = np.asarray(row_lens, np.int32)
    if null_pad:
        # the engine's layout: pages past a slot's largest row limit are
        # the null page 0
        for i in range(s):
            used = -(-int(sl[i * w:(i + 1) * w].max()) // page_size)
            pt[i, used:] = 0
    return q, kp, vp, pt, sl


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# (seed, S, W, H, KH, D, pages, page_size, max_pages, per-row lens)
_CASES = {
    # test_speculative.py:135: slot 0 mid-speculation, slot 1 inactive,
    # slot 2 speculating with its last row padded out
    "ragged_rows_gqa": (0, 3, 3, 4, 2, 8, 16, 8, 4,
                        [5, 6, 7, 0, 0, 0, 12, 13, 0]),
    # test_speculative.py:173, the dispatcher's case
    "dispatcher_case": (2, 2, 3, 2, 2, 8, 8, 8, 2, [4, 5, 6, 9, 10, 0]),
    "page_boundaries": (3, 2, 4, 4, 4, 8, 12, 8, 4,
                        [7, 8, 9, 10, 29, 30, 31, 32]),
    "gqa_8_over_2_w5": (4, 2, 5, 8, 2, 16, 10, 4, 6,
                        [17, 18, 19, 20, 21, 3, 0, 0, 0, 0]),
    "head_dim_4_w2": (5, 3, 2, 2, 1, 4, 6, 4, 3, [1, 2, 0, 0, 11, 12]),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_plain_version_matches_jax_reference_and_pallas(case):
    seed, s, w, h, kh, d, pages, ps, mp, sl = _CASES[case]
    q, kp, vp, pt, sl = _case(seed, s, w, h, kh, d, pages, ps, mp, sl)
    jq, jk, jv, jpt, jsl = [jnp.asarray(a) for a in (q, kp, vp, pt, sl)]
    ref = np.asarray(pk.paged_spec_attention_reference(
        jq.reshape(s * w, h, d), jk, jv, jpt, jsl))
    ker = np.asarray(pk.ragged_spec_attention(
        jq, jk, jv, jpt, jsl, interpret=True)).reshape(s * w, h, d)
    tq, tk, tv, tpt, tsl = _torch(q.reshape(s * w, h, d), kp, vp, pt, sl)
    got = pa.paged_spec_attention_reference(tq, tk, tv, tpt, tsl).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, ker, **TOL)
    # every row with limit 0 is exact zeros; every other row is not
    dead = sl == 0
    assert (got[dead] == 0).all()
    assert (np.abs(got[~dead]).sum(axis=(1, 2)) > 0).all()


def test_null_padded_table_gives_the_same_rows():
    # padding a slot's table past its largest row limit with the null
    # page changes nothing: no row reads page 0 below its limit
    seed, s, w, h, kh, d, pages, ps, mp, sl = _CASES["page_boundaries"]
    a = _torch(*_case(seed, s, w, h, kh, d, pages, ps, mp, sl))
    b = _torch(*_case(seed, s, w, h, kh, d, pages, ps, mp, sl,
                      null_pad=True))
    assert (b[3] == 0).any() and not (a[3] == 0).any()
    for args in (a, b):
        args[0] = args[0].reshape(s * w, h, d)
    np.testing.assert_array_equal(pa.paged_spec_attention_reference(*a),
                                  pa.paged_spec_attention_reference(*b))


def test_width_one_equals_the_one_row_plain_version():
    # test_speculative.py:156: W=1 is the one-row kernel's function
    q, kp, vp, pt, sl = _case(1, 4, 1, 4, 2, 8, 8, 8, 3, [3, 0, 17, 24])
    tq, tk, tv, tpt, tsl = _torch(q[:, 0], kp, vp, pt, sl)
    spec = pa.paged_spec_attention_reference(tq, tk, tv, tpt, tsl)
    one = pa.paged_attention_reference(tq, tk, tv, tpt, tsl)
    np.testing.assert_array_equal(spec.numpy(), one.numpy())
    ker = pk.ragged_spec_attention(
        *[jnp.asarray(x) for x in (q, kp, vp, pt, sl)], interpret=True)
    np.testing.assert_allclose(spec.numpy(), np.asarray(ker)[:, 0], **TOL)


def test_dispatcher_derives_width_and_sends_cpu_to_the_plain_version(
        monkeypatch):
    seed, s, w, h, kh, d, pages, ps, mp, sl = _CASES["dispatcher_case"]
    q, kp, vp, pt, sl = _case(seed, s, w, h, kh, d, pages, ps, mp, sl)
    args = _torch(q.reshape(s * w, h, d), kp, vp, pt, sl)

    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA kernel")

    monkeypatch.setattr(pa, "ragged_spec_attention", no_kernel)
    out = pa.paged_spec_attention(*args)
    assert tuple(out.shape) == (s * w, h, d)
    ref = pk.paged_spec_attention(*[jnp.asarray(a.numpy()) for a in args])
    assert ref.shape == (s * w, h, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the width comes from the rows per page-table row: the same q read
    # as W=6 over one slot gives another function
    one_slot = pa.paged_spec_attention(args[0], args[1], args[2],
                                       args[3][:1], args[4])
    assert tuple(one_slot.shape) == (s * w, h, d)
    assert not torch.equal(one_slot, out)


def test_kernel_wrapper_refuses_cpu_and_dispatcher_refuses_other_devices():
    seed, s, w, h, kh, d, pages, ps, mp, sl = _CASES["ragged_rows_gqa"]
    q, kp, vp, pt, sl = _case(seed, s, w, h, kh, d, pages, ps, mp, sl)
    before = pa.ragged_spec_attention.launches
    with pytest.raises(MXNetError, match="CUDA tensor"):
        pa.ragged_spec_attention(*_torch(q, kp, vp, pt, sl))
    meta = [a.to("meta") for a in _torch(q.reshape(s * w, h, d), kp, vp,
                                         pt, sl)]
    with pytest.raises(MXNetError, match="no kernel for device"):
        pa.paged_spec_attention(*meta)
    with pytest.raises(ValueError, match="not divisible"):
        pa.paged_spec_attention(*_torch(
            np.zeros((s * w, 3, d), np.float32), kp, vp, pt, sl))
    assert pa.ragged_spec_attention.launches == before


@pytest.mark.cuda
def test_cuda_spec_kernel_matches_plain_version(cuda_device):
    # the verify shape of the decode bench: S=16, W=5, H=KH=8 and GQA
    # 8/2, D=64, page_size=16, max_pages=72, ragged per-row limits incl.
    # inactive slots and padded rows; fp32 with another summation order
    # than the plain version's einsum -> atol=rtol=1e-4
    rng = np.random.RandomState(11)
    for kh in (8, 2):
        lens = np.zeros((16, 5), np.int32)
        for i in range(16):
            base = int(rng.randint(1, 1148))
            live = int(rng.randint(1, 6)) if i % 4 else 0
            lens[i, :live] = base + np.arange(live)
        q, kp, vp, pt, sl = _case(int(rng.randint(1 << 30)), 16, 5, 8, kh,
                                  64, 16 * 72 + 1, 16, 72, lens.ravel(),
                                  null_pad=True)
        args = [a.to(cuda_device) for a in _torch(q, kp, vp, pt, sl)]
        got = pa.ragged_spec_attention(*args)
        torch.cuda.synchronize(cuda_device)
        want = pa.paged_spec_attention_reference(
            args[0].reshape(80, 8, 64), *args[1:]).reshape(got.shape)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)
        assert (got.reshape(80, 8, 64)[args[4] == 0] == 0).all()
    # W=1 against the one-row kernel on the same inputs
    one = pa.ragged_paged_attention(args[0][:, 0].contiguous(), args[1],
                                    args[2], args[3],
                                    args[4].reshape(16, 5)[:, 0])
    w1 = pa.ragged_spec_attention(args[0][:, :1].contiguous(), args[1],
                                  args[2], args[3],
                                  args[4].reshape(16, 5)[:, 0].contiguous())
    torch.cuda.synchronize(cuda_device)
    np.testing.assert_allclose(w1[:, 0].cpu().numpy(), one.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


# -- the kernel's tiling (_spec_plan) and its split-and-merge arithmetic --

def _limits(row_lens, tokens):
    """Each row's limit as the kernel computes it: clamp(seq_len, 0,
    max_pages * page_size)."""
    return np.clip(np.asarray(row_lens, np.int64), 0, tokens)


def _blocks(plan, w, n_heads, n_kv):
    """Every block of the grid in launch order: (slot, tile, span,
    [(row w, head h), ...]) with the block's query vectors, unit u =
    w * groups + g, MAX_UNITS a row chunk; the grid is (slot, kv head x
    row chunk, span) and its tile (slot, kv head x row chunk) indexes the
    arrival counters."""
    groups = n_heads // n_kv
    units = w * groups
    out = []
    for z in range(plan.grid[2]):
        for y in range(plan.grid[1]):
            kh, c = divmod(y, plan.rchunks)
            mine = [(u // groups, kh * groups + u % groups)
                    for u in range(c * pa.MAX_UNITS,
                                   min(units, (c + 1) * pa.MAX_UNITS))]
            for x in range(plan.grid[0]):
                out.append((x, x * plan.grid[1] + y, z, mine))
    return out


# (slots, W, H, KH, D, page_size, max_pages): the spec bench's verify
# tick, GQA 8/2 at W = 5 (20 query vectors a kv head: 3 row chunks), W = 9
# with 4 groups (36: 5 row chunks), W = 1
_PLAN_CASES = {
    "spec_bench": (16, 5, 8, 8, 64, 16, 72),
    "gqa_8_over_2_w5": (16, 5, 8, 2, 64, 16, 72),
    "w9_groups_4": (4, 9, 8, 2, 80, 16, 72),
    "w1": (16, 1, 8, 8, 64, 16, 72),
}


@pytest.mark.parametrize("span", [16, 64, pa.SPAN, 256])
@pytest.mark.parametrize("case", sorted(_PLAN_CASES))
def test_spec_plan_covers_each_position_below_each_limit_once(case, span):
    s, w, h, kh, d, ps, mp = _PLAN_CASES[case]
    rng = np.random.RandomState(40)
    tokens = mp * ps
    lim = _limits(rng.randint(-3, tokens + 20, s * w), tokens).reshape(s, w)
    lim[0] = 0  # an inactive slot
    plan = pa._spec_plan(s, w, h, kh, d, ps, mp, span=span)
    seen = np.zeros((s, w, h, tokens), np.int64)
    for x, _tile, z, units in _blocks(plan, w, h, kh):
        blk = max(lim[x, r] for r, _ in units)
        if z * span >= blk:
            continue  # returns before it stages
        for r, hh in units:
            seen[x, r, hh, z * span:min(z * span + span, lim[x, r])] += 1
    for x in range(s):
        for r in range(w):
            assert (seen[x, r, :, :lim[x, r]] == 1).all()
            assert (seen[x, r, :, lim[x, r]:] == 0).all()
    groups = h // kh
    assert plan.rchunks == -(-w * groups // pa.MAX_UNITS)
    assert plan.grid == (s, kh * plan.rchunks, -(-tokens // span))
    assert plan.tiles == s * kh * plan.rchunks
    assert plan.workspace_numel == s * w * h * plan.nsplit * (d + 2)


def test_spec_plan_grid_is_static_per_shape():
    # the grid depends on shapes alone: lengths never enter the plan
    a = pa._spec_plan(16, 5, 8, 8, 64, 16, 72)
    assert a == pa._spec_plan(16, 5, 8, 8, 64, 16, 72)
    assert a.grid == (16, 8, 9) and a.tiles == 128
    assert a.workspace_numel == 80 * 8 * 9 * 66
    # 36 query vectors a kv head: five row chunks of at most 8
    assert pa._spec_plan(4, 9, 8, 2, 64, 16, 72).grid == (4, 10, 9)


def _replay(q, kp, vp, pt, sl, plan, span, scale, order, arrivals):
    """The kernel's arithmetic in torch, block by block from the plan, in
    the arrival ``order`` (a permutation of the grid's blocks), into an
    output and a workspace that start as NaN (the wrapper's
    ``torch.empty``) and the ``arrivals`` counters (the wrapper's cached
    zeroed buffer). A span-0 block writes exact zeros for its rows of limit
    0. A block whose span starts at or past all its rows' limits returns.
    Each other block takes, per (row, head) it holds, the partial state
    (m, l, acc) over the positions of its span below the row's limit; it
    writes nothing for a row whose limit its span starts at or past, it
    finishes a row of one span (span 0), and it puts a longer row's span
    in the workspace. Then, if its tile has two active spans or more
    (ceil(largest limit / span)), it arrives: the block that finds the
    count at the active spans less one is the last, resets the counter to
    0 and merges its rows of two spans or more (weights exp(m_j - max m),
    zeros where the total is 0). Returns the output and how often each
    (row, head) was written."""
    s_slots, w, h, d = q.shape
    n_kv = kp.shape[2]
    groups = h // n_kv
    ps = kp.shape[1]
    lim = _limits(sl, pt.shape[1] * ps).reshape(s_slots, w)
    nan = float("nan")
    rows = s_slots * w
    m = torch.full((rows, h, plan.nsplit), nan)
    l = torch.full((rows, h, plan.nsplit), nan)
    acc = torch.full((rows, h, plan.nsplit, d), nan)
    out = torch.full((s_slots, w, h, d), nan)
    writes = np.zeros((s_slots, w, h), np.int64)
    blocks = _blocks(plan, w, h, n_kv)
    for i in order:
        x, tile, z, units = blocks[i]
        lims = [int(lim[x, r]) for r, _ in units]
        if z == 0:
            for (r, hh), lr in zip(units, lims):
                if lr == 0:
                    out[x, r, hh] = 0.0
                    writes[x, r, hh] += 1
        blk = max(lims)
        span0 = z * span
        if span0 >= blk:
            continue
        for (r, hh), lr in zip(units, lims):
            if span0 >= lr:
                continue
            pos = torch.arange(span0, min(span0 + span, lr))
            pages = torch.from_numpy(pt[x]).long()[pos // ps]
            k = kp[pages, pos % ps, hh // groups]
            v = vp[pages, pos % ps, hh // groups]
            sc = (k @ q[x, r, hh]) * scale
            mj = sc.max()
            e = torch.exp(sc - mj)
            if lr <= span:
                out[x, r, hh] = (e @ v) / e.sum()
                writes[x, r, hh] += 1
            else:
                cell = (x * w + r, hh, z)
                m[cell], l[cell], acc[cell] = mj, e.sum(), e @ v
        nact = -(-blk // span)
        if nact <= 1:
            continue
        seen = int(arrivals[tile])
        arrivals[tile] += 1
        if seen != nact - 1:
            continue
        arrivals[tile] = 0
        for (r, hh), lr in zip(units, lims):
            if lr <= span:
                continue
            ns = -(-lr // span)
            mj = m[x * w + r, hh, :ns]
            wj = torch.where(mj == float("-inf"), torch.zeros_like(mj),
                             torch.exp(mj - mj.max()))
            tot = (l[x * w + r, hh, :ns] * wj).sum()
            num = (acc[x * w + r, hh, :ns] * wj[:, None]).sum(dim=0)
            out[x, r, hh] = num / tot if tot > 0 else torch.zeros_like(num)
            writes[x, r, hh] += 1
    return out, writes


# (seed, S, W, H, KH, D, span, per-row lens), page_size 8, 17 pages a
# table (136 positions; 34, 272 positions, for a span of 256):
# rows straddling a span boundary inside one slot (limits 126..130 at
# span 128, 254..258 at 256), at H = KH and at GQA 8/2 (20 query vectors
# a kv head, three row chunks); W = 9 with 4 groups (36, five row
# chunks) over many 16-position spans with rows of limit 0 among live
# ones; a limit-0 slot
# and padded draft rows beside live rows at span 64; odd head dims; W = 1
_REPLAY_CASES = {
    "straddle_128": (50, 2, 5, 2, 2, 16, 128,
                     [126, 127, 128, 129, 130, 3, 4, 5, 6, 7]),
    "straddle_128_gqa_8_over_2": (51, 2, 5, 8, 2, 8, 128,
                                  [126, 127, 128, 129, 130,
                                   60, 61, 62, 0, 0]),
    "straddle_256_gqa_8_over_2": (57, 2, 5, 8, 2, 8, 256,
                                  [254, 255, 256, 257, 258,
                                   200, 201, 0, 0, 0]),
    "w9_groups_4_span16": (52, 2, 9, 8, 2, 8, 16,
                           [40, 41, 42, 43, 0, 0, 0, 0, 0,
                            120, 121, 122, 123, 124, 125, 126, 127, 128]),
    "limit_0_beside_live_span64": (53, 3, 5, 4, 2, 16, 64,
                                   [0, 0, 0, 0, 0,
                                    65, 66, 0, 0, 0,
                                    0, 0, 130, 131, 0]),
    "head_dim_5_span16": (54, 2, 3, 2, 1, 5, 16, [17, 18, 19, 1, 2, 0]),
    "head_dim_80_span64": (55, 2, 2, 4, 4, 80, 64, [63, 64, 65, 136]),
    "w1_span16": (56, 4, 1, 4, 2, 8, 16, [0, 16, 17, 100]),
}
_ORDERS = ("launch", "reversed", "shuffled_0", "shuffled_1")


def _order(name, n):
    if name == "launch":
        return list(range(n))
    if name == "reversed":
        return list(range(n))[::-1]
    return list(np.random.RandomState(int(name[-1])).permutation(n))


def _pages(span):
    """Pages of 8 positions a table row: room for a row past 128 or 256."""
    return 34 if span > 128 else 17


@functools.lru_cache(maxsize=None)
def _replay_case(case):
    """A replay case's inputs and the JAX package's answers: its
    reference, the Pallas kernel in interpret mode and, at W = 1, the
    one-row Pallas kernel (computed once for every arrival order)."""
    seed, s, w, h, kh, d, span, lens = _REPLAY_CASES[case]
    q, kp, vp, pt, sl = _case(seed, s, w, h, kh, d, 30, 8, _pages(span),
                              lens, null_pad=True)
    jq, jk, jv, jpt, jsl = [jnp.asarray(a) for a in (q, kp, vp, pt, sl)]
    ref = np.asarray(pk.paged_spec_attention_reference(
        jq.reshape(s * w, h, d), jk, jv, jpt, jsl)).reshape(s, w, h, d)
    ker = np.asarray(pk.ragged_spec_attention(jq, jk, jv, jpt, jsl,
                                              interpret=True))
    one = None if w != 1 else np.asarray(pk.ragged_paged_attention(
        jq[:, 0], jk, jv, jpt, jsl, interpret=True))
    return (q, kp, vp, pt, sl), ref, ker, one


@pytest.mark.parametrize("order", _ORDERS)
@pytest.mark.parametrize("case", sorted(_REPLAY_CASES))
def test_split_and_merge_replay_matches_jax(case, order):
    _seed, s, w, h, kh, d, span, _lens = _REPLAY_CASES[case]
    ps, mp = 8, _pages(span)
    (q, kp, vp, pt, sl), ref, ker, one = _replay_case(case)
    plan = pa._spec_plan(s, w, h, kh, d, ps, mp, span=span)
    arrivals = np.zeros(plan.tiles, np.int64)
    n = len(_blocks(plan, w, h, kh))
    tq, tk, tv = _torch(q, kp, vp)
    # twice on the same counters, in two orders: the first launch leaves
    # them at zero for the second (a captured launch's replay)
    for o in (_order(order, n), _order(order, n)[::-1]):
        got, writes = _replay(tq, tk, tv, pt, sl, plan, span,
                              1.0 / d ** 0.5, o, arrivals)
        # every (row, head) written once, by one block: no two blocks race
        assert (writes == 1).all(), writes
        assert (arrivals == 0).all()
        got = got.numpy()
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_allclose(got, ker, **TOL)
        assert (got.reshape(s * w, h, d)[sl == 0] == 0).all()
    if one is not None:
        # W = 1 is the one-row kernel's function
        np.testing.assert_allclose(got[:, 0], one, **TOL)


def test_spec_wrapper_refuses_cpu_before_any_scratch_or_launch():
    seed, s, w, h, kh, d, pages, ps, mp, sl = _CASES["ragged_rows_gqa"]
    args = _torch(*_case(seed, s, w, h, kh, d, pages, ps, mp, sl))
    before = (pa.ragged_spec_attention.launches, dict(pa._ARRIVALS))
    with pytest.raises(MXNetError, match="CUDA tensor"):
        pa.ragged_spec_attention(*args)
    assert (pa.ragged_spec_attention.launches, pa._ARRIVALS) == before
