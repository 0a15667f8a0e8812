"""mxnet_tpu_torch.ops.nms and the ops that call it, against the JAX
package (CPU).

* ``nms_keep_reference`` against ``mxnet_tpu.ops.pallas_kernels.nms_keep``
  (the Pallas ``_nms_kernel`` in interpret mode on the CPU, as the JAX
  package's own tests run it): keep masks exactly equal, over N in
  {1, 7, 64, 65, 300, 512}, thresholds {0.3, 0.45, 0.7}, with and without
  ``force_suppress``, on box sets with duplicates and invalid boxes, and
  on integer boxes whose IoU lands exactly on the threshold;
* ``box_nms`` and ``MultiBoxDetection`` through each package's
  ``nd.contrib``: which rows survive (and the -1 rows) exactly, the
  coordinates and scores within 1e-6 (the decode's exp and products may
  round differently in the last bit);
* the dispatcher: a CPU tensor goes to the plain version, a ``meta``
  tensor gets an empty mask, and the kernel wrapper refuses a CPU tensor;
* ``_replay``, a numpy model of the CUDA kernels' order of work
  (compaction, the split at ``nms.CAP``, the division-free threshold
  test, held alone against float32 division near the threshold, the mask
  pass's grid-stride
  loop over triangle tiles, each 64-box group resolved against its
  diagonal words, the near word OR-ed at once and the far words one group
  later), against the Pallas kernel for N <= 512 and the plain version
  above: keep masks exactly equal, at valid counts around the group and
  cap boundaries, with invalid boxes between valid ones, duplicates,
  threshold ties, ``force_suppress`` both ways and batches whose images
  fall on both sides of the cap; and ``nms_plan``, fixed by shape;
* the CUDA kernel against the plain version, exactly, on the card only
  (``test_cuda_kernel_matches_plain_version`` skips elsewhere).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import pallas_kernels as pk
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import nms


@pytest.fixture
def cuda_device():
    # decided here, per test, never at import: every xdist worker must
    # collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


def _boxes(rs, n, ncls=3, frac_valid=0.8):
    """Random corner boxes, a fifth of them exact duplicates of another,
    classes in 0..ncls-1, ``frac_valid`` of them valid."""
    xy = rs.rand(n, 2)
    wh = rs.rand(n, 2) * 0.4 + 0.01
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    dup = rs.rand(n) < 0.2
    boxes[dup] = boxes[rs.randint(0, n, int(dup.sum()))]
    cls = rs.randint(0, ncls, n).astype(np.float32)
    valid = rs.rand(n) < frac_valid
    return boxes, cls, valid


def _exact_boxes(rs, n):
    """Integer boxes: 2x2 boxes shifted by whole units overlap with IoU
    1/3 or 1/7 exactly, ties the threshold then has to break alike."""
    xy = rs.randint(0, 6, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + 2.0], 1), np.zeros(n, np.float32), \
        np.ones(n, bool)


def _port(boxes, cls, valid, thresh, force):
    return nms.nms_keep(torch.from_numpy(boxes)[None],
                        torch.from_numpy(cls)[None],
                        torch.from_numpy(valid)[None], thresh, force)[0]


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("thresh", [0.3, 0.45, 0.7])
@pytest.mark.parametrize("n", [1, 7, 64, 65, 300, 512])
def test_plain_version_matches_pallas_kernel(n, thresh, force):
    boxes, cls, valid = _boxes(np.random.RandomState(n), n)
    want = np.asarray(pk.nms_keep(boxes, cls, valid, thresh, force))
    got = _port(boxes, cls, valid, thresh, force)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("thresh", [1.0 / 7.0, 1.0 / 3.0, 0.3])
def test_threshold_exact_boxes_decide_alike(thresh):
    boxes, cls, valid = _exact_boxes(np.random.RandomState(11), 200)
    for force in (False, True):
        want = np.asarray(pk.nms_keep(boxes, cls, valid, thresh, force))
        np.testing.assert_array_equal(
            _port(boxes, cls, valid, thresh, force).numpy(), want)


def test_dispatcher_devices():
    boxes, cls, valid = (torch.from_numpy(a)[None] for a in
                         _boxes(np.random.RandomState(1), 50))
    want = nms.nms_keep_reference(boxes, cls, valid, 0.5, False)
    nms.nms_keep_cuda.launches = 0
    np.testing.assert_array_equal(
        nms.nms_keep(boxes, cls, valid, 0.5, False).numpy(), want.numpy())
    assert nms.nms_keep_cuda.launches == 0  # the CPU launches nothing
    m = nms.nms_keep(boxes.to("meta"), cls.to("meta"), valid.to("meta"),
                     0.5, False)
    assert m.device.type == "meta" and m.shape == (1, 50)
    assert m.dtype == torch.bool
    with pytest.raises(MXNetError, match="CUDA tensors expected"):
        nms.nms_keep_cuda(boxes, cls, valid, 0.5, False)
    with pytest.raises(MXNetError, match="must be"):
        nms.nms_keep(boxes, cls[:, :10], valid, 0.5, False)


def _table(rs, b, n):
    """(B, N, 6) rows [class, score, x1, y1, x2, y2], some scores at or
    below 0 (invalid), some tied."""
    boxes = np.stack([_boxes(rs, n)[0] for _ in range(b)])
    cls = rs.randint(0, 3, (b, n, 1)).astype(np.float32)
    score = rs.rand(b, n, 1).astype(np.float32) - 0.2
    score[:, ::7] = 0.5  # ties: the stable sort keeps them in order
    return np.concatenate([cls, score, boxes], -1)


def _assert_tables(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got == -1, want == -1)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(overlap_thresh=0.5, id_index=0),
    dict(overlap_thresh=0.3, id_index=0, topk=20, force_suppress=True),
    dict(overlap_thresh=0.45, valid_thresh=0.1, out_format="center"),
])
def test_box_nms_matches_jax(kw):
    data = _table(np.random.RandomState(4), 2, 100)
    want = jmx.nd.contrib.box_nms(jmx.nd.array(data), **kw).asnumpy()
    with mx.cpu():
        got = mx.nd.contrib.box_nms(mx.nd.array(data), **kw).asnumpy()
    _assert_tables(got, want)


def test_box_nms_alias_and_center_input():
    data = _table(np.random.RandomState(6), 2, 40)
    data[..., 4:6] = np.abs(data[..., 4:6])  # center format: w, h >= 0
    kw = dict(overlap_thresh=0.4, id_index=0, in_format="center")
    want = jmx.nd.contrib.box_nms(jmx.nd.array(data), **kw).asnumpy()
    with mx.cpu():
        got = mx.nd.contrib.box_non_maximum_suppression(
            mx.nd.array(data), **kw).asnumpy()
    _assert_tables(got, want)


def _detection_inputs(rs, b, n, c):
    logits = rs.randn(b, c + 1, n).astype(np.float32) * 2.0
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rs.randn(b, n * 4) * 0.5).astype(np.float32)
    xy = rs.rand(n, 2) * 0.8
    anchors = np.concatenate([xy, xy + 0.05 + rs.rand(n, 2) * 0.3], 1)
    return prob.astype(np.float32), loc, \
        anchors.reshape(1, n, 4).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(nms_threshold=0.45, nms_topk=100),
    dict(nms_threshold=0.5, force_suppress=True, threshold=0.2),
])
def test_multibox_detection_matches_jax(kw):
    inputs = _detection_inputs(np.random.RandomState(9), 2, 200, 3)
    want = jmx.nd.contrib.MultiBoxDetection(
        *[jmx.nd.array(a) for a in inputs], **kw).asnumpy()
    with mx.cpu():
        got = mx.nd.contrib.MultiBoxDetection(
            *[mx.nd.array(a) for a in inputs], **kw).asnumpy()
    _assert_tables(got, want)
    assert (got[..., 0] >= 0).any()  # the case keeps some detections


# ---------------------------------------------------------------------------
# A model of the CUDA kernels' order of work (ops/csrc/nms.cu)
# ---------------------------------------------------------------------------

_G = 64  # boxes a group, bits a mask word
_COMPACT_THREADS, _ITEMS = 512, 8
_F32 = np.float32


def _tile_index(g, w, wc):
    """nms.cu:tile_index: tile (g, w >= g) of an image of wc groups."""
    return g * wc - g * (g - 1) // 2 + (w - g)


def _compact(valid_row):
    """nms_keep_compact_kernel's compaction: rounds of 512 threads x 8
    boxes, each thread's count of valid boxes, a block-wide exclusive
    prefix sum, then each thread's indices at its offset."""
    n = valid_row.shape[0]
    idx = np.full(n, -7, np.int64)  # the wrapper's torch.empty
    count = 0
    per_round = _COMPACT_THREADS * _ITEMS
    for base in range(0, n, per_round):
        flags = np.zeros(per_round, bool)
        chunk = valid_row[base:base + per_round]
        flags[:chunk.shape[0]] = chunk
        flags = flags.reshape(_COMPACT_THREADS, _ITEMS)
        offs = np.concatenate([[0], np.cumsum(flags.sum(1))[:-1]])
        for t in range(_COMPACT_THREADS):
            pos = count + int(offs[t])
            for k in np.nonzero(flags[t])[0]:
                idx[pos] = base + t * _ITEMS + k
                pos += 1
        count += int(flags.sum())
    return idx, count


def _above(inter, denom, t):
    """nms.cu:Threshold: fl(inter / denom) > t decided without dividing,
    as inter > mid * denom in float64 (exact), mid = (t + the next float32
    above t) / 2, and a tie going up when t's last mantissa bit is 1."""
    t = _F32(t)
    mid = (np.float64(t) + np.float64(np.nextafter(t, _F32(np.inf)))) / 2
    tie_up = bool(t.view(np.uint32) & 1)
    lhs, rhs = inter.astype(np.float64), mid * denom.astype(np.float64)
    return (lhs > rhs) | (tie_up & (lhs == rhs))


def _pair_bits(bx, cl, rows, cols, thresh, force):
    """(len(rows), len(cols)) bool: row box suppresses column box, in the
    kernel's float32 order of operations and its division-free threshold
    test (the rows and columns are compacted positions; the caller keeps
    columns after rows)."""
    xi1, yi1, xi2, yi2 = (bx[rows, k][:, None] for k in range(4))
    xj1, yj1, xj2, yj2 = (bx[cols, k][None, :] for k in range(4))
    zero = _F32(0)

    def area(x1, y1, x2, y2):
        return np.maximum(x2 - x1, zero) * np.maximum(y2 - y1, zero)

    iw = np.maximum(np.minimum(xj2, xi2) - np.maximum(xj1, xi1), zero)
    ih = np.maximum(np.minimum(yj2, yi2) - np.maximum(yj1, yi1), zero)
    inter = iw * ih
    denom = np.maximum((area(xj1, yj1, xj2, yj2) + area(xi1, yi1, xi2, yi2))
                       - inter, _F32(1e-12))
    hit = _above(inter, denom, thresh)
    if not force:
        hit &= cl[cols][None, :] == cl[rows][:, None]
    return hit


def _resolve(cur, live, diag, visits):
    """nms.cu:resolve: the group's kept rows given the removed bits ``cur``
    and the diagonal words; only live, not removed rows whose diagonal
    word is not 0 are visited."""
    nz = sum(1 << r for r in range(_G) if diag[r])
    cand = live & ~cur & nz
    while cand:
        r = (cand & -cand).bit_length() - 1
        visits.append(r)
        d = diag[r]
        cur |= d
        cand = (cand & (cand - 1)) & ~d
    return live & ~cur


def _live(g, count):
    rows = count - g * _G
    return (1 << _G) - 1 if rows >= _G else (1 << rows) - 1


def _small(pos, bx, cl, count, thresh, force, visits):
    """The compaction block's path for count <= CAP: the mask in shared
    memory from (row, 32-column) halves, then warp 0 walks the groups and
    ORs each group's kept rows into the later words at once."""
    wc = -(-count // _G)
    halves = np.zeros((count, 2 * wc), np.uint64)
    for p in range(count):
        for c in range(2 * wc):
            q0 = 32 * c
            if q0 + 31 > p:
                cols = np.arange(max(q0, p + 1), min(q0 + 32, count))
                hit = np.zeros(32, bool)
                hit[cols - q0] = _pair_bits(bx, cl, pos[[p]], pos[cols],
                                            thresh, force)[0]
                halves[p, c] = np.packbits(hit, bitorder="little").view(
                    "<u4")[0]
    word = [[int(halves[p, 2 * w]) | int(halves[p, 2 * w + 1]) << 32
             for w in range(wc)] for p in range(count)]
    removed = [0] * wc
    kept_rows = []
    for g in range(wc):
        live = _live(g, count)
        diag = [word[g * _G + r][g] if (live >> r) & 1 else 0
                for r in range(_G)]
        kept = _resolve(removed[g], live, diag, visits)
        for w in range(g + 1, wc):
            for r in range(_G):
                if (kept >> r) & 1:
                    removed[w] |= word[g * _G + r][w]
        kept_rows += [g * _G + r for r in range(_G) if (kept >> r) & 1]
    return kept_rows


def _mask_pass(pos, bx, cl, count, thresh, force, tiles, blocks, rs):
    """nms_keep_mask_kernel for one image: the grid-stride loop of each
    warp (8 a block) over 4 wc^2 quarter-tile slots (64 rows x 16
    columns), those below the diagonal skipped, each writing 16 bits of
    its rows' words into a workspace of garbage bits (the wrapper's
    torch.empty). Returns the workspace and how often each quarter tile
    was written."""
    wc = -(-count // _G)
    ws = rs.randint(0, 2 ** 63, size=(tiles, _G), dtype=np.int64).view(
        np.uint64)
    writes = np.zeros((tiles, 4), np.int64)
    for warp in range(blocks * 8):
        for s in range(warp, 4 * wc * wc, blocks * 8):
            g, w = divmod(s // 4, wc)
            quarter = s % 4
            if w < g:
                continue
            rows = np.arange(g * _G, g * _G + _G)
            q0 = w * _G + 16 * quarter
            cols = np.arange(q0, max(q0, min(q0 + 16, count)))
            live = rows < count
            hit = np.zeros((_G, 16), bool)
            hit[live, :cols.shape[0]] = _pair_bits(
                bx, cl, pos[rows[live]], pos[cols], thresh, force) & (
                cols[None, :] > rows[live][:, None])
            t = _tile_index(g, w, wc)
            piece = np.packbits(hit, axis=1, bitorder="little").view("<u2")
            ws[t].view("<u2").reshape(_G, 4)[:, quarter] = piece[:, 0]
            writes[t, quarter] += 1
    return ws, writes


def _scan(ws, count, visits):
    """nms_keep_scan_kernel for one image: group k is resolved by warp 0
    from the staged tiles (k, k) and (k, k + 1) with the removed word
    k | the near word of group k - 1; the far words (w >= k + 1) of
    group k - 1 reach the removed set during group k (warps 1..15, from
    registers loaded during group k - 1). Checks that every word group k
    reads holds all earlier kept rows' bits."""
    wc = -(-count // _G)

    def tile(g, w):
        return [int(x) for x in ws[_tile_index(g, w, wc)]]

    removed = [0] * wc
    truth = [0] * wc  # the OR of every earlier kept row, word by word
    near, skept, kept_rows = 0, [0, 0], []

    def finish(g, kept):
        for w in range(g + 2, wc):
            tl = tile(g, w)
            for r in range(_G):
                if (kept >> r) & 1:
                    removed[w] |= tl[r]

    for k in range(wc):
        live = _live(k, count)
        cur = removed[k] | near
        assert cur & live == truth[k] & live
        diag = tile(k, k)
        kept = _resolve(cur, live, diag, visits)
        if k + 1 < wc:
            nxt = tile(k, k + 1)
            near = 0
            for r in range(_G):
                if (kept >> r) & 1:
                    near |= nxt[r]
        for w in range(k + 1, wc):  # the eager truth, not the kernel
            tl = tile(k, w)
            for r in range(_G):
                if (kept >> r) & 1:
                    truth[w] |= tl[r]
        if k > 0:
            finish(k - 1, skept[(k - 1) & 1])
        skept[k & 1] = kept
        kept_rows += [k * _G + r for r in range(_G) if (kept >> r) & 1]
    return kept_rows


def _replay(boxes, cls, valid, thresh, force, cap=nms.CAP, sms=132,
            seed=0):
    """The CUDA kernels' order of work on a (B, N) batch in numpy: keep
    (B, N) bool, and the path each image took ("small" or "scan")."""
    b, n = valid.shape
    rs = np.random.RandomState(seed)
    plan = nms.nms_plan(b, n, sms)
    keep = np.zeros((b, n), bool)  # the compaction block's zeros
    paths = []
    for img in range(b):
        idx, count = _compact(valid[img])
        np.testing.assert_array_equal(idx[:count], np.nonzero(valid[img])[0])
        pos = idx[:count]
        bx, cl = boxes[img].astype(_F32), cls[img].astype(_F32)
        visits = []
        if count <= cap:
            kept = _small(pos, bx, cl, count, thresh, force, visits)
            paths.append("small")
        else:
            ws, writes = _mask_pass(pos, bx, cl, count, thresh, force,
                                    plan.tiles, plan.mask_blocks, rs)
            wc = -(-count // _G)
            assert (writes[:wc * (wc + 1) // 2] == 1).all()
            assert (writes[wc * (wc + 1) // 2:] == 0).all()  # never read
            kept = _scan(ws, count, visits)
            paths.append("scan")
        assert len(visits) <= len(kept)  # the chain: kept rows at most
        keep[img, pos[kept]] = True
    return keep, paths


def _interleaved(rs, n_valid, n_invalid, ncls=3):
    """n_valid + n_invalid boxes of ``_boxes``, exactly n_valid of them
    valid, the invalid ones spread between them."""
    n = n_valid + n_invalid
    boxes, cls, _ = _boxes(rs, max(n, 1), ncls)
    valid = np.zeros(n, bool)
    valid[rs.permutation(n)[:n_valid]] = True
    return boxes[:n], cls[:n], valid


def _pallas_rows(boxes, cls, valid, thresh, force):
    return np.stack([np.asarray(pk.nms_keep(bx, c, v, thresh, force))
                     for bx, c, v in zip(boxes, cls, valid)])


@pytest.mark.parametrize("t", [0.0, 1.0 / 7.0, 1.0 / 3.0, 0.3, 0.45, 0.5,
                               0.7, 1e-40, -0.25])
def test_division_free_threshold_is_exact(t):
    # quotients within a few ulps of t, others anywhere, and 0 / denom
    rs = np.random.RandomState(7)
    denom = (rs.rand(100000) * 2 + 1e-6).astype(_F32)
    near = denom.astype(np.float64) * _F32(t) * (
        1 + (rs.rand(100000) - 0.5) * 1e-6)
    inter = np.concatenate([np.abs(near).astype(_F32),
                            rs.rand(1000).astype(_F32), np.zeros(10, _F32)])
    denom = np.concatenate([denom, (rs.rand(1000) + 0.5).astype(_F32),
                            np.ones(10, _F32)])
    want = inter / denom > _F32(t)
    np.testing.assert_array_equal(_above(inter, denom, t), want)
    if t > 0:
        assert 0 < want.sum() < want.shape[0]  # both sides are hit


def test_plan_is_fixed_by_shape():
    a = nms.nms_plan(8, 3840, 132)
    assert a == nms.nms_plan(8, 3840, 132)
    assert a.words == 60 and a.tiles == 60 * 61 // 2
    assert a.mask_blocks == 4 * 132 // 8
    assert nms.nms_plan(1, 6000, 132).mask_blocks == 4 * 132
    assert nms.nms_plan(1, 100, 132).mask_blocks == 2  # 16 slots, 8 warps
    assert nms.nms_plan(1, 1000, 132).mask_blocks == 128  # 1024 slots
    assert nms.nms_plan(70000, 64, 132).mask_blocks == 1
    # the triangle of tiles fills [0, tiles) once, row-group by row-group
    for wc in (1, 2, 5, 60):
        got = sorted(_tile_index(g, w, wc) for g in range(wc)
                     for w in range(g, wc))
        assert got == list(range(wc * (wc + 1) // 2))
        assert all(_tile_index(g, g + 1, wc) == _tile_index(g, g, wc) + 1
                   for g in range(wc - 1))


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("n_valid", [0, 1, 63, 64, 65, 127, 128, 129,
                                     nms.CAP, nms.CAP + 1])
def test_replay_matches_pallas_kernel(n_valid, force):
    rs = np.random.RandomState(1000 + n_valid)
    boxes, cls, valid = _interleaved(rs, n_valid, n_valid // 3 + 3)
    args = (boxes[None], cls[None], valid[None], 0.45, force)
    got, paths = _replay(*args)
    assert paths == ["small" if n_valid <= nms.CAP else "scan"]
    np.testing.assert_array_equal(got, _pallas_rows(*args))
    np.testing.assert_array_equal(got, nms.nms_keep_reference(
        *(torch.from_numpy(a) for a in args[:3]), 0.45, force).numpy())


@pytest.mark.parametrize("thresh", [1.0 / 7.0, 1.0 / 3.0])
@pytest.mark.parametrize("n", [200, 300])
def test_replay_threshold_ties_match_pallas_kernel(n, thresh):
    boxes, cls, valid = _exact_boxes(np.random.RandomState(n), n)
    for force in (False, True):
        args = (boxes[None], cls[None], valid[None], thresh, force)
        got, paths = _replay(*args)
        assert paths == ["small" if n <= nms.CAP else "scan"]
        np.testing.assert_array_equal(got, _pallas_rows(*args))


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("counts,n,thresh", [
    ((0, 100, nms.CAP, nms.CAP + 1, 300), 400, 0.45),   # Pallas, N <= 512
    ((5, 700, 1100, 64), 1500, 0.7),                     # plain version
])
def test_replay_mixed_batch(counts, n, thresh, force):
    rs = np.random.RandomState(n)
    parts = [_interleaved(rs, c, n - c) for c in counts]
    boxes, cls, valid = (np.stack(p) for p in zip(*parts))
    got, paths = _replay(boxes, cls, valid, thresh, force)
    assert paths == ["small" if c <= nms.CAP else "scan" for c in counts]
    if n <= 512:
        want = _pallas_rows(boxes, cls, valid, thresh, force)
    else:
        want = nms.nms_keep_reference(
            *(torch.from_numpy(a) for a in (boxes, cls, valid)), thresh,
            force).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0 and (got <= valid).all()


def _cuda_case(rs, b, n, frac_valid):
    if isinstance(frac_valid, tuple):  # exact valid counts, interleaved
        return [_interleaved(rs, c, n - c) for c in frac_valid]
    return [_boxes(rs, n, frac_valid=frac_valid) for _ in range(b)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,force,frac_valid", [
    (8, 3840, False, 100 / 3840), (8, 3840, False, 1.0), (2, 3840, True, 0.9),
    (1, 1, False, 1.0), (3, 77, False, 0.8), (2, 1000, False, 0.8),
    (1, 6000, False, 0.5),
    (10, 400, False, (0, 1, 63, 64, 65, 127, 128, 129, nms.CAP,
                      nms.CAP + 1)),
    (10, 400, True, (0, 1, 63, 64, 65, 127, 128, 129, nms.CAP,
                     nms.CAP + 1)),
    (4, 3840, False, (100, 3000, nms.CAP, 3840))])
def test_cuda_kernel_matches_plain_version(cuda_device, b, n, force,
                                           frac_valid):
    rs = np.random.RandomState(n)
    parts = _cuda_case(rs, b, n, frac_valid)
    boxes, cls, valid = (torch.tensor(np.stack(p), device=cuda_device)
                         for p in zip(*parts))
    nms.nms_keep_cuda.launches = 0
    got = nms.nms_keep(boxes, cls, valid, 0.45, force)
    torch.cuda.synchronize()
    assert nms.nms_keep_cuda.launches == 1
    want = nms.nms_keep_reference(boxes, cls, valid, 0.45, force)
    assert torch.equal(got, want)
