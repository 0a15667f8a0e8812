"""The decode plane's compile-once contract, the port against the JAX package
(CPU).

The JAX engine compiles each device path once per shape (the decode step
at its width, each prefill rung, each chunk rung, the CoW copy) and counts
them in ``compile_count``; ``warmup()`` returns that count and anchors
``steady_state_recompiles`` at 0. The port captures the same paths as CUDA
graphs on the card, and on the CPU runs each eagerly and counts it at its
first run, keyed the same way. Here both engines take the same small
``TinyDecoder`` (2 layers, 4 heads of 8, 2 kv heads, vocab 32) and the same
seeded requests: ``warmup()`` must return the same count in both, the
outputs must be equal (and equal the port's no-cache oracle), and after
the traffic both must show ``steady_state_recompiles == 0`` with
``compile_count`` still at the warm count. Logits of the model's chunk and
prefill passes with 0-d tensor scalars (what the engine passes, so that a
graph can be captured) are held to the JAX model at fp32 2e-5 (one pass
of 2 layers; XLA-CPU and torch-CPU order their sums differently), and to
the same passes with ints exactly. The ``cuda``-marked cases replay
captured paths on the card against eager calls, exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import serving as jserving
from mxnet_tpu.resilience import RetryPolicy as JRetryPolicy
from mxnet_tpu.resilience import chaos as jchaos
from mxnet_tpu.serving import kvcache as jkv
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.ops import paged_attention as pa
from mxnet_tpu_torch.resilience import RetryPolicy, chaos
from mxnet_tpu_torch.serving import kvcache as tkv
from mxnet_tpu_torch.telemetry import STEADY_STATE_RECOMPILES

LOGIT_TOL = dict(atol=2e-5, rtol=2e-5)
_DIMS = dict(vocab_size=32, num_layers=2, num_heads=4, head_dim=8,
             num_kv_heads=2)
_BASE = dict(num_slots=3, max_seq_len=48, prefill_buckets=(8, 16),
             timeout_ms=0)


@pytest.fixture(autouse=True)
def _no_chaos():
    chaos.disable()
    jchaos.disable()
    yield
    chaos.disable()
    jchaos.disable()


@pytest.fixture(scope="module")
def models():
    jm = jserving.TinyDecoder(**_DIMS)
    tm = tserving.TinyDecoder(**_DIMS)
    jp = jm.init_params(0)
    tp = tserving.params_from_jax(jax.device_get(jp), device="cpu")
    return jm, jp, tm, tp


def _engines(models, **kw):
    jm, jp, tm, tp = models
    kw = dict(_BASE, **kw)
    tag = np.random.randint(1 << 30)
    jkw = dict(kw)
    if isinstance(jkw.get("retry_policy"), RetryPolicy):
        jkw["retry_policy"] = JRetryPolicy(max_attempts=1)
    jeng = jserving.DecodeEngine(jm, jp, name="jcap%d" % tag, **jkw)
    teng = tserving.DecodeEngine(tm, tp, name="tcap%d" % tag, device="cpu",
                                 **kw)
    return jeng, teng


def _collect(futs):
    out = []
    for f in futs:
        try:
            out.append(np.asarray(f.result(timeout=120)))
        except Exception as exc:  # noqa: BLE001 - an evicted request
            out.append(type(exc).__name__)
    return out


def _churn(pkg, eng, params_b):
    rng = np.random.RandomState(7)
    reqs = [(rng.randint(1, 32, int(rng.randint(1, 14))).astype(np.int32),
             int(rng.randint(1, 9))) for _ in range(9)]
    return reqs, _collect([eng.submit(p, m) for p, m in reqs])


def _evict(pkg, eng, params_b):
    # a decode fault at the third tick evicts both in-flight requests
    # (pools zeroed, nothing recaptured); later requests are served
    mod = chaos if pkg == "torch" else jchaos
    with mod.active("seed=1,site=serving.decode,at=3"):
        first = _collect([eng.submit([20 + i, 5], 6) for i in range(2)])
    assert first == ["FaultInjected"] * 2
    reqs = [(np.asarray([25 + i], np.int32), 4) for i in range(3)]
    return reqs, _collect([eng.submit(p, m) for p, m in reqs])


def _cow(pkg, eng, params_b):
    # a cold shared prefix: prompts of 12 shared tokens diverge inside
    # their second page, so every hit after the first copies that page
    sysp = [5, 9, 2, 7, 1, 3, 8, 4, 6, 2, 11, 13]
    reqs = [(np.asarray(sysp + [20 + i], np.int32), 5) for i in range(6)]
    return reqs, _collect([eng.submit(p, m) for p, m in reqs])


def _spec(pkg, eng, params_b):
    rng = np.random.RandomState(5)
    reqs = []
    for i in range(6):
        motif = rng.randint(1, 32, int(rng.randint(2, 5))).astype(np.int32)
        reqs.append((np.concatenate([motif, motif, motif[:1]]), 8))
    return reqs, _collect([eng.submit(p, m) for p, m in reqs])


def _swap(pkg, eng, params_b):
    # wave, swap on the live engine, wave: the second wave is served by
    # the new weights through the same captured paths
    reqs, outs = _churn(pkg, eng, params_b)
    eng.swap_params(params_b, variant="B", timeout=120)
    more = [(np.asarray([9, 4, 2, 12, 3], np.int32), 6),
            (np.asarray([1, 2, 3], np.int32), 5)]
    return reqs + more, outs + _collect([eng.submit(p, m) for p, m in more])


# scenario -> (traffic, engine arguments, expected warm count: 1 step +
# ladder rungs unless chunked + chunk rungs + 1 CoW with the prefix cache)
_SCENARIOS = {
    "churn": (_churn, dict(prefix_cache=False), 1 + 3),
    "evict_after_decode_fault": (
        _evict, dict(num_slots=2, prefix_cache=False,
                     retry_policy=RetryPolicy(max_attempts=1)), 1 + 3),
    "cold_shared_prefix_cow": (
        _cow, dict(num_slots=2, page_size=8, prefix_cache=True),
        1 + 3 + 3 + 1),
    "chunked_prefill": (_churn, dict(prefix_cache=True, prefill_chunk=4),
                        1 + 1 + 1),
    "spec_prompt_lookup": (_spec, dict(prefix_cache=False, spec_k=2,
                                       spec_draft="prompt_lookup"), 1 + 3),
    "swap_params": (_swap, dict(prefix_cache=False), 1 + 3),
}


@pytest.mark.parametrize("scenario", sorted(_SCENARIOS))
def test_warm_count_outputs_and_no_steady_recompiles_match_jax(models,
                                                               scenario):
    jm, jp, tm, tp = models
    traffic, kw, want_warm = _SCENARIOS[scenario]
    jp_b = jm.init_params(1)
    tp_b = tserving.params_from_jax(jax.device_get(jp_b), device="cpu")
    jeng, teng = _engines(models, **kw)
    with jeng, teng:
        jwarm, twarm = jeng.warmup(), teng.warmup()
        jreqs, jouts = traffic("jax", jeng, jp_b)
        treqs, touts = traffic("torch", teng, tp_b)
        jstats, tstats = jeng.stats(), teng.stats()
    assert twarm == jwarm == want_warm
    assert len(jreqs) == len(treqs)
    for i, ((p, m), got, want) in enumerate(zip(treqs, touts, jouts)):
        np.testing.assert_array_equal(got, want)
        # the swap scenario's second wave runs under the new weights
        swapped = scenario == "swap_params" and i >= 9
        np.testing.assert_array_equal(
            got, tm.reference_generate(tp_b if swapped else tp, p, m))
    for stats in (jstats, tstats):
        assert stats["compile_count"] == want_warm
        assert stats["steady_state_recompiles"] == 0
        assert stats["kvcache"]["pages_in_use"] == 0
    assert STEADY_STATE_RECOMPILES.value(site="serving." + teng.name) == 0
    if scenario == "cold_shared_prefix_cow":
        assert tstats["cow_copies"] >= 1 and jstats["cow_copies"] >= 1
    if scenario == "chunked_prefill":
        assert tstats["prefill_chunks"] > len(treqs)
    if scenario == "spec_prompt_lookup":
        assert tstats["speculative"]["proposed_tokens"] > 0
    if scenario == "evict_after_decode_fault":
        assert tstats["evictions"] == jstats["evictions"] == 2
    if scenario == "swap_params":
        assert tstats["weight_swaps"] == jstats["weight_swaps"] == 1


def test_unwarmed_engine_serves_counts_and_has_no_steady_key(models):
    # without warmup() the paths compile (are captured) at first use: the
    # count rises as the traffic reaches them, and neither package reports
    # a steady-state count
    jeng, teng = _engines(models, prefix_cache=False)
    prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
    with jeng, teng:
        assert "steady_state_recompiles" not in teng.stats()
        assert "steady_state_recompiles" not in jeng.stats()
        assert teng.compile_count == 0
        want = jeng.generate(prompt, 4, timeout=120)
        got = teng.generate(prompt, 4, timeout=120)
        jstats, tstats = jeng.stats(), teng.stats()
    np.testing.assert_array_equal(got, want)
    # the decode step and the one prefill rung this prompt pads to
    assert tstats["compile_count"] == jstats["compile_count"] == 2
    assert "steady_state_recompiles" not in tstats
    assert "steady_state_recompiles" not in jstats


def test_swap_copies_into_the_engine_own_params_and_the_draft_sees_it(
        models):
    # the captured paths read the engine's own parameter tensors: a swap
    # copies into them (never into the caller's), and a model draft, which
    # reads the same tensors, proposes under the new weights
    _jm, _jp, tm, tp = models
    before = {k: v.clone() for k, v in tp["layers"][0].items()}
    tp_b = tm.init_params(1, device="cpu")
    with tserving.DecodeEngine(tm, tp, spec_k=2, spec_draft="model",
                               device="cpu", name="tcapdraft",
                               **_BASE) as eng:
        eng.warmup()
        eng.swap_params(tp_b, timeout=120)
        got = eng.generate([7, 7, 3, 7, 7], 6, timeout=120)
        stats = eng.stats()
        draft_params = eng._draft._params
    np.testing.assert_array_equal(got, tm.reference_generate(
        tp_b, [7, 7, 3, 7, 7], 6))
    for k, v in tp["layers"][0].items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    torch.testing.assert_close(draft_params["embed"], tp_b["embed"],
                               rtol=0, atol=0)
    assert stats["speculative"]["acceptance_rate"] == 1.0
    assert stats["steady_state_recompiles"] == 0


def _chunk_setup(jm, jp, tm, tp):
    kw = dict(num_slots=2, max_seq_len=32, num_layers=2, num_kv_heads=2,
              head_dim=8, page_size=4)
    jc = jkv.PagedKVCache(name="jcapchunk", **kw)
    tc = tkv.PagedKVCache(name="tcapchunk", device="cpu", **kw)
    for c in (jc, tc):
        c.reserve(0, 24)
    rng = np.random.RandomState(3)
    prompt = rng.randint(1, 32, 14).astype(np.int32)
    return jc, tc, prompt


def test_prefill_and_chunk_with_device_scalars_match_jax(models):
    jm, jp, tm, tp = models
    jc, tc, prompt = _chunk_setup(jm, jp, tm, tp)
    # prefill of 9 real tokens padded to 16, then a chunk of positions
    # 9..13 padded to 8 over the same pages
    toks = np.zeros(16, np.int32)
    toks[:9] = prompt[:9]
    wp, wo = jc.write_slots(0, 0, 9)
    npg, noff = jc.null_write_slots(7)
    wp, wo = np.concatenate([wp, npg]), np.concatenate([wo, noff])
    jl, jc.k_pool, jc.v_pool = jax.jit(jm.prefill)(
        jp, jnp.asarray(toks), jnp.asarray(9, jnp.int32), jc.k_pool,
        jc.v_pool, jnp.asarray(wp), jnp.asarray(wo))
    t_args = (torch.from_numpy(wp), torch.from_numpy(wo))
    tl = tm.prefill(tp, torch.from_numpy(toks), torch.tensor(9,
                    dtype=torch.int32), tc.k_pool, tc.v_pool, *t_args)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    pools = (tc.k_pool.clone(), tc.v_pool.clone())
    tl_int = tm.prefill(tp, torch.from_numpy(toks), 9, *pools, *t_args)
    torch.testing.assert_close(tl, tl_int, rtol=0, atol=0)
    torch.testing.assert_close(pools[0], tc.k_pool, rtol=0, atol=0)

    chunk = np.zeros(8, np.int32)
    chunk[:5] = prompt[9:14]
    cp, co = jc.write_slots(0, 9, 5)
    npg, noff = jc.null_write_slots(3)
    cp, co = np.concatenate([cp, npg]), np.concatenate([co, noff])
    row = jc.page_table[0].copy()
    jl, jc.k_pool, jc.v_pool = jax.jit(jm.prefill_chunk)(
        jp, jnp.asarray(chunk), jnp.asarray(9, jnp.int32),
        jnp.asarray(5, jnp.int32), jc.k_pool, jc.v_pool, jnp.asarray(row),
        jnp.asarray(cp), jnp.asarray(co))
    sl = torch.tensor([9, 5], dtype=torch.int32)
    c_args = (torch.from_numpy(row), torch.from_numpy(cp),
              torch.from_numpy(co))
    pools = (tc.k_pool.clone(), tc.v_pool.clone())
    tl = tm.prefill_chunk(tp, torch.from_numpy(chunk), sl[0], sl[1],
                          tc.k_pool, tc.v_pool, *c_args)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tc.k_pool.numpy(), np.asarray(jc.k_pool),
                               **LOGIT_TOL)
    tl_int = tm.prefill_chunk(tp, torch.from_numpy(chunk), 9, 5, *pools,
                              *c_args)
    torch.testing.assert_close(tl, tl_int, rtol=0, atol=0)


@pytest.mark.parametrize("start,length", [(0, 6), (5, 8), (13, 3)])
def test_chunk_attention_cpu_branch_takes_tensor_scalars(start, length):
    rng = np.random.RandomState(start)
    c, h, kh, d, ps, mp = 8, 4, 2, 8, 4, 6
    q = torch.from_numpy(rng.randn(c, h, d).astype(np.float32))
    kp = torch.from_numpy(rng.randn(9, ps, kh, d).astype(np.float32))
    vp = torch.from_numpy(rng.randn(9, ps, kh, d).astype(np.float32))
    row = torch.from_numpy(rng.randint(1, 9, mp).astype(np.int32))
    want = pa.paged_prefill_attention(q, kp, vp, row, start, length)
    pair = torch.tensor([start, length], dtype=torch.int32)
    got = pa.paged_prefill_attention(q, kp, vp, row, pair[0], pair[1])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not got[length:].any()


@pytest.fixture
def cuda_device():
    # decided here, per test, never at import: every xdist worker must
    # collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have "
                    "no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_tick_and_chunk_replay_equal_eager_calls(models,
                                                          cuda_device):
    # a warmed engine serves through graph replays; the same requests
    # served by an engine whose paths are run eagerly (each path's function
    # called instead of its graph) give the same tokens, and every output
    # equals the oracle on the card
    _jm, _jp, tm, tp = models
    prompts = [np.asarray([5, 9, 2, 7, 1, 3, 8, 4, 6, 2, 11, 13, 20 + i],
                          np.int32) for i in range(4)]
    outs = {}
    for mode in ("graph", "eager"):
        eng = tserving.DecodeEngine(tm, tp, device=cuda_device,
                                    prefill_chunk=4, page_size=4,
                                    name="tcapcuda_" + mode, **_BASE)
        with eng:
            warm = eng.warmup()
            if mode == "eager":
                for path in eng._paths.values():
                    path.graph = None
            outs[mode] = [eng.generate(p, 6, timeout=120) for p in prompts]
            stats = eng.stats()
        assert stats["compile_count"] == warm
        assert stats["steady_state_recompiles"] == 0
        if mode == "graph":
            assert stats["graph_replays"] > 0
    dev_params = tm.init_params(0, device=cuda_device)  # tp's weights
    for p, a, b in zip(prompts, outs["graph"], outs["eager"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            a, tm.reference_generate(dev_params, p, 6))
