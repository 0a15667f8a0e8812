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
