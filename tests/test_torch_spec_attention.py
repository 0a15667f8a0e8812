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
