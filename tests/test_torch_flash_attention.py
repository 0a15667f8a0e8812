"""mxnet_tpu_torch.ops.flash_attention against the JAX package (CPU).

The port's plain version is held against ``pk.flash_attention`` (the
Pallas ``_flash_kernel``, run in interpret mode on the CPU as
``test_sequence_parallel.py`` runs it) on that file's shapes plus the GPT
example's at batch 2, at ``rtol=2e-4, atol=2e-5`` (the tolerance that
file holds the Pallas kernel to against a dense oracle). The autograd
Function's gradients, run on the CPU through the plain forward, are held
against ``jax.grad`` of ``pk.flash_attention`` at the same tolerance;
``_contrib_flash_attention`` runs through the port's ``invoke`` under
``autograd.record()``. The CUDA kernel itself runs only on the card:
``test_cuda_kernel_matches_plain_version`` skips elsewhere.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, nd
from mxnet_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-4, atol=2e-5)

# (b, h, s, d), causal: test_sequence_parallel.py:129-131, then the GPT
# example's attention at batch 2 (dim 64 over 4 heads, SEQ 64)
_SHAPES = [((2, 2, 64, 16), False), ((1, 2, 100, 32), True),
           ((1, 1, 9, 8), True), ((2, 4, 64, 16), True)]


@pytest.fixture
def cuda_device():
    # decided here, per test, never at import: every xdist worker must
    # collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


def _qkv(seed, shape):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) * 0.5 for _ in range(3)]


@pytest.mark.parametrize("shape,causal", _SHAPES)
def test_plain_version_matches_pallas_kernel(shape, causal):
    q, k, v = _qkv(5, shape)
    want = np.asarray(pk.flash_attention(*map(jnp.asarray, (q, k, v)),
                                         causal=causal))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = fa.flash_attention_reference(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the wrapper sends a CPU tensor to the plain version, launching nothing
    fa.flash_attention_forward.launches = 0
    np.testing.assert_array_equal(
        fa.flash_attention_forward(tq, tk, tv, causal=causal).numpy(),
        got.numpy())
    assert fa.flash_attention_forward.launches == 0


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax(causal):
    q, k, v = _qkv(6, (1, 2, 32, 16))
    w = np.random.RandomState(7).randn(1, 2, 32, 16).astype(np.float32)
    want = jax.grad(lambda a, b, c: (pk.flash_attention(
        a, b, c, causal=causal) * w).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    for t, ref in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), **TOL)


def test_registered_op_through_invoke_under_record():
    import mxnet_tpu as jmx

    q, k, v = _qkv(7, (1, 2, 16, 8))
    jq, jk, jv = (jmx.nd.array(a) for a in (q, k, v))
    jq.attach_grad()
    with jmx.autograd.record():
        jy = jmx.nd.invoke("_contrib_flash_attention", jq, jk, jv,
                           causal=True, scale=0.3)
        jloss = (jy * jy).sum()
    jloss.backward()

    tq, tk, tv = (nd.array(a, ctx=mx.cpu()) for a in (q, k, v))
    tq.attach_grad()
    with autograd.record():
        y = nd.invoke("_contrib_flash_attention", tq, tk, tv, causal=True,
                      scale=0.3)
        loss = (y * y).sum()
    loss.backward()
    assert y.shape == (1, 2, 16, 8)
    np.testing.assert_allclose(y.asnumpy(), jy.asnumpy(), **TOL)
    np.testing.assert_allclose(tq.grad.asnumpy(), jq.grad.asnumpy(), **TOL)
    # the alias and the generated nd function reach the same op
    np.testing.assert_array_equal(
        nd.flash_attention(tq, tk, tv, causal=True, scale=0.3).asnumpy(),
        y.asnumpy())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(MXNetError, match="one shape"):
        fa.flash_attention_forward(q, q[:, :, :2], q)
    with pytest.raises(MXNetError, match="head_dim"):
        z = torch.zeros(1, 1, 4, 300)
        fa.flash_attention_forward(z, z, z)
    with pytest.raises(MXNetError, match="is torch.float64"):
        fa.flash_attention_forward(q, q.double(), q)
    with pytest.raises(MXNetError, match="no kernel for device meta"):
        m = torch.zeros(1, 1, 4, 8, device="meta")
        fa.flash_attention_forward(m, m, m)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,dtype,tol", [
    ((32, 4, 64, 16), True, torch.float32, 1e-4),
    ((1, 2, 1000, 64), False, torch.float32, 1e-4),
    ((1, 2, 100, 32), True, torch.bfloat16, 2e-2),
])
def test_cuda_kernel_matches_plain_version(cuda_device, shape, causal, dtype,
                                           tol):
    q, k, v = (torch.tensor(a, device=cuda_device).to(dtype)
               for a in _qkv(8, shape))
    fa.flash_attention_forward.launches = 0
    got = fa.flash_attention_forward(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_forward.launches == 1
    want = fa.flash_attention_reference(q, k, v, causal=causal)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_fits_shared_memory_and_pads_head_dim(itemsize):
    """For every head_dim the kernel takes: D padded to a multiple of 8
    (the mma depth), shared memory within a block's 227 KB, the tiles
    1024-byte aligned (TMA's 128B swizzle), and TMA wherever the row
    stride is a multiple of 16 bytes."""
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        plan = fa.flash_plan(d, itemsize)
        assert plan.d_pad % 8 == 0 and d <= plan.d_pad < d + 8
        assert plan.d_pad <= plan.d_max <= fa.MAX_HEAD_DIM
        assert plan.smem_bytes <= fa.MAX_SHARED_BYTES
        assert plan.rows == 16 * plan.warps and plan.kv_tile % 8 == 0
        assert plan.stages >= 2
        assert plan.line_blocks * 128 >= plan.d_pad * itemsize
        tiles = (plan.rows + 2 * plan.stages * plan.kv_tile) * \
            plan.line_blocks * 128
        assert tiles % 1024 == 0 and plan.smem_bytes >= tiles + 1024
        if d * itemsize % 16 == 0:
            assert (plan.route, plan.vec) == ("tma", 0)
        else:
            assert plan.route in ("cp.async", "ld.st")
            assert d * itemsize % plan.vec == 0 and plan.vec < 16
    # pointers that are not 16-byte aligned cannot be staged by TMA
    assert fa.flash_plan(64, 4, align=8).route == "cp.async"
    assert fa.flash_plan(6, 4).route == "cp.async"
    assert fa.flash_plan(100, 2).route == "cp.async"
    assert fa.flash_plan(101, 2).route == "ld.st"
    with pytest.raises(MXNetError, match="head_dim"):
        fa.flash_plan(257, itemsize)


# bf16: both versions round an fp32 result to bf16 (8 significant bits);
# their summation orders may tip the rounding by one step, at most 2^-7
# of the value
_BF16_RTOL, _BF16_ATOL = 2.0 ** -7, 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,dtype,rtol,atol", [
    ((2, 2, s, 64), causal, torch.float32, 1e-4, 1e-4)
    for s in (1, 63, 65, 129, 2048) for causal in (True, False)] + [
    ((2, 2, 200, d), True, torch.float32, 1e-4, 1e-4)
    for d in (6, 8, 24, 100)
] + [((4, 8, 2048, 64), True, torch.bfloat16, _BF16_RTOL, _BF16_ATOL),
     ((1, 2, 129, 100), False, torch.bfloat16, _BF16_RTOL, _BF16_ATOL)])
def test_cuda_kernel_long_and_ragged(cuda_device, shape, causal, dtype, rtol,
                                     atol):
    q, k, v = (torch.tensor(a, device=cuda_device).to(dtype)
               for a in _qkv(9, shape))
    fa.flash_attention_forward.launches = 0
    got = fa.flash_attention_forward(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_forward.launches == 1
    want = fa.flash_attention_reference(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
