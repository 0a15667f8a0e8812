"""mxnet_tpu_torch.serving.decode against the JAX package (CPU).

The port's TinyDecoder gets the JAX model's weights (``params_from_jax``)
and the same inputs; its logits must match the JAX model's at
``atol=rtol=1e-4`` — fp32 through 2 layers of matmuls whose sums XLA-CPU
and torch-CPU order differently, compounding per layer. Token streams
must match exactly: ``reference_generate`` against JAX's, and the port's
``DecodeEngine(device="cpu")`` against both its own oracle and the JAX
engine, under slot churn (the ``test_decode.py:263`` setup) and with
chunked prefill (alone, with the prefix cache, under speculation).
"""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import serving as jserving
from mxnet_tpu.serving import kvcache as jkv
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import RetryPolicy, chaos
from mxnet_tpu_torch.serving import kvcache as tkv

TOL = dict(atol=1e-4, rtol=1e-4)
_DIMS = dict(vocab_size=32, num_layers=2, num_heads=4, head_dim=8,
             num_kv_heads=2)


@pytest.fixture(autouse=True)
def _no_chaos():
    chaos.disable()
    yield
    chaos.disable()


@pytest.fixture(scope="module")
def models():
    jm = jserving.TinyDecoder(**_DIMS)
    tm = tserving.TinyDecoder(**_DIMS)
    jp = jm.init_params(0)
    tp = tserving.params_from_jax(jax.device_get(jp), device="cpu")
    return jm, jp, tm, tp


def _engine(tm, tp, **kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("max_seq_len", 48)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("timeout_ms", 0)
    kw.setdefault("name", "tt%d" % np.random.randint(1 << 30))
    kw.setdefault("device", "cpu")
    return tserving.DecodeEngine(tm, tp, **kw)


def _churn_reqs():
    rng = np.random.RandomState(7)
    return [(rng.randint(1, 32, int(rng.randint(1, 14))).astype(np.int32),
             int(rng.randint(1, 9))) for _ in range(9)]


def test_init_params_bit_identical_to_jax(models):
    _jm, jp, tm, tp = models
    mine = tm.init_params(0, device="cpu")
    flat_j = jax.tree_util.tree_leaves(jp)
    flat_t = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x: x.numpy(), mine))
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert set(tp) == set(mine) and len(tp["layers"]) == len(mine["layers"])


def test_prefill_chunk_and_decode_logits_match_jax(models):
    jm, jp, tm, tp = models
    kw = dict(num_slots=2, max_seq_len=32, num_layers=2, num_kv_heads=2,
              head_dim=8, page_size=4)
    jc = jkv.PagedKVCache(name="jlog", **kw)
    tc = tkv.PagedKVCache(name="tlog", device="cpu", **kw)
    rng = np.random.RandomState(3)
    prompt = rng.randint(1, 32, 10).astype(np.int32)
    for c in (jc, tc):
        c.reserve(0, 16)
        c.reserve(1, 16)
    # prefill slot 0 (rung 16, 10 real tokens)
    toks = np.zeros(16, np.int32)
    toks[:10] = prompt
    wp, wo = jc.write_slots(0, 0, 10)
    npg, noff = jc.null_write_slots(6)
    wp, wo = np.concatenate([wp, npg]), np.concatenate([wo, noff])
    jl, jc.k_pool, jc.v_pool = jax.jit(jm.prefill)(
        jp, jnp.asarray(toks), jnp.asarray(10, jnp.int32), jc.k_pool,
        jc.v_pool, jnp.asarray(wp), jnp.asarray(wo))
    tl = tm.prefill(tp, torch.from_numpy(toks), 10, tc.k_pool, tc.v_pool,
                    torch.from_numpy(wp), torch.from_numpy(wo))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc.k_pool.numpy(), np.asarray(jc.k_pool),
                               **TOL)
    # slot 1 shares the first 8 tokens' pages' content by recomputing a
    # 5-token chunk at position 5 through the page table (causal q_pos)
    for c in (jc, tc):
        c.page_table[1, :2] = c.page_table[0, :2]
    chunk = np.zeros(8, np.int32)
    chunk[:5] = prompt[5:10]
    cp, co = jc.null_write_slots(8)
    row = jc.page_table[1].copy()
    jl, jc.k_pool, jc.v_pool = jax.jit(jm.prefill_chunk)(
        jp, jnp.asarray(chunk), jnp.asarray(5, jnp.int32),
        jnp.asarray(5, jnp.int32), jc.k_pool, jc.v_pool, jnp.asarray(row),
        jnp.asarray(cp), jnp.asarray(co))
    tl = tm.prefill_chunk(tp, torch.from_numpy(chunk), 5, 5, tc.k_pool,
                          tc.v_pool, torch.from_numpy(row),
                          torch.from_numpy(cp), torch.from_numpy(co))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # one decode tick: slot 0 at position 10, slot 1 inactive
    packed = np.zeros((5, 2), np.int32)
    packed[4] = np.arange(2) % 4
    packed[:, 0] = [7, 10, 11, jc.page_table[0, 10 // 4], 10 % 4]
    jl, _k, _v = jax.jit(jm.decode)(jp, *[jnp.asarray(r) for r in packed[:2]],
                           jc.k_pool, jc.v_pool, jnp.asarray(jc.page_table),
                           *[jnp.asarray(r) for r in packed[2:]])
    tl = tm.decode(tp, *[torch.from_numpy(r) for r in packed[:2]],
                   tc.k_pool, tc.v_pool, torch.from_numpy(tc.page_table),
                   *[torch.from_numpy(r) for r in packed[2:]])
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0], **TOL)


def test_reference_generate_token_exact_vs_jax(models):
    # JAX's eager oracle compiles every op anew for each sequence length
    # (about 1.5 s a length on the CPU), so these cases share lengths; the
    # churn test below holds longer streams to the JAX engine
    jm, jp, tm, tp = models
    cases = [(np.asarray([3, 5, 7], np.int32), 4),
             (np.asarray([30, 1, 9, 4], np.int32), 3)]
    for prompt, m in cases:
        np.testing.assert_array_equal(
            tm.reference_generate(tp, prompt, m),
            jm.reference_generate(jp, prompt, m))


def test_engine_matches_own_oracle_and_jax_engine_under_churn(models):
    jm, jp, tm, tp = models
    reqs = _churn_reqs()
    with _engine(tm, tp) as eng:
        assert eng.warmup() > 0
        outs = [f.result(timeout=120)
                for f in [eng.submit(p, m) for p, m in reqs]]
        stats = eng.stats()
    with jserving.DecodeEngine(jm, jp, num_slots=3, max_seq_len=48,
                               prefill_buckets=(8, 16), timeout_ms=0,
                               name="jchurn") as jeng:
        jouts = [f.result(timeout=120)
                 for f in [jeng.submit(p, m) for p, m in reqs]]
    for (p, m), got, jgot in zip(reqs, outs, jouts):
        np.testing.assert_array_equal(got, tm.reference_generate(tp, p, m))
        np.testing.assert_array_equal(got, jgot)
    assert stats["completed"] == len(reqs)
    assert stats["kvcache"]["pages_in_use"] == 0
    assert stats["device"] == "cpu"


def test_eos_frees_slot_early(models):
    _jm, _jp, tm, tp = models
    prompt = np.asarray([3, 5, 7], np.int32)
    ref = tm.reference_generate(tp, prompt, 16)
    eos = int(ref[2])  # force a stop at the 3rd generated token
    with _engine(tm, tp) as eng:
        out = eng.generate(prompt, 16, eos_id=eos)
        stats = eng.stats()
    np.testing.assert_array_equal(out, ref[:3])
    assert stats["kvcache"]["pages_in_use"] == 0


def test_prefix_cache_hits_equal_the_oracle(models):
    # a shared 16-token system prompt (2 full pages of 8) plus distinct
    # tails: later requests map the shared pages, CoW the divergent one
    # and run only their tail through prefill_chunk
    _jm, _jp, tm, tp = models
    rng = np.random.RandomState(5)
    system = rng.randint(1, 32, 16).astype(np.int32)
    prompts = [np.concatenate([system, rng.randint(1, 32, n)]).astype(
        np.int32) for n in (3, 5, 1, 7)]
    prompts.append(prompts[1].copy())  # a full-prompt hit
    with _engine(tm, tp, num_slots=2, max_seq_len=40, page_size=8) as eng:
        eng.warmup()
        outs = []
        for p in prompts:  # one at a time: each sees the index so far
            outs.append(eng.generate(p, 6, timeout=120))
        stats = eng.stats()
    for p, got in zip(prompts, outs):
        np.testing.assert_array_equal(got, tm.reference_generate(tp, p, 6))
    assert stats["kvcache"]["prefix_hits"] >= 4
    assert stats["prefill_chunks"] >= 4
    assert stats["kvcache"]["pages_in_use"] == 0


def test_queue_shed(models):
    _jm, _jp, tm, tp = models
    with _engine(tm, tp, num_slots=1, queue_depth=1) as eng:
        futs = [eng.submit([1, 2], 24)]
        shed = 0
        for _ in range(30):
            try:
                futs.append(eng.submit([3], 24))
            except tserving.QueueFullError:
                shed += 1
        assert shed > 0
        for f in futs:
            f.result(timeout=120)
        assert eng.stats()["shed"] == shed


def test_close_drain_and_fail_fast(models):
    _jm, _jp, tm, tp = models
    eng = _engine(tm, tp)
    futs = [eng.submit([1 + i], 5) for i in range(3)]
    drained = eng.close(drain=True)
    for f in futs:
        assert len(f.result(timeout=5)) == 5
    assert 0 <= drained <= 3 and eng.stats()["completed"] == 3
    with pytest.raises(tserving.ServerClosedError):
        eng.submit([1], 2)
    assert eng.close() == 0

    eng2 = _engine(tm, tp, num_slots=1)
    futs = [eng2.submit([1], 20) for _ in range(3)]
    assert eng2.close(drain=False) == 0
    failed = 0
    for f in futs:
        try:
            f.result(timeout=5)
        except tserving.ServerClosedError:
            failed += 1
    assert failed >= 1
    assert eng2._cache.pages_in_use == 0


def test_chaos_prefill_fault_isolates_one_request(models):
    _jm, _jp, tm, tp = models
    with _engine(tm, tp, num_slots=1,
                 retry_policy=RetryPolicy(max_attempts=1)) as eng:
        with chaos.active("seed=1,site=serving.decode.prefill,at=2"):
            futs = [eng.submit([10 + i], 3) for i in range(4)]
            kinds = []
            for i, f in enumerate(futs):
                try:
                    np.testing.assert_array_equal(
                        f.result(timeout=120),
                        tm.reference_generate(tp, [10 + i], 3))
                    kinds.append("ok")
                except chaos.FaultInjected:
                    kinds.append("fault")
        stats = eng.stats()
    assert kinds.count("fault") == 1 and kinds.count("ok") == 3
    assert stats["errors"] == 1 and stats["kvcache"]["pages_in_use"] == 0


def test_chaos_decode_fault_evicts_in_flight_then_serves(models):
    _jm, _jp, tm, tp = models
    with _engine(tm, tp, num_slots=2,
                 retry_policy=RetryPolicy(max_attempts=1)) as eng:
        with chaos.active("seed=1,site=serving.decode,at=3"):
            futs = [eng.submit([20 + i, 5], 6) for i in range(2)]
            evicted = 0
            for f in futs:
                try:
                    f.result(timeout=120)
                except chaos.FaultInjected:
                    evicted += 1
        assert evicted == 2 and eng.stats()["evictions"] == 2
        after = [eng.submit([25 + i], 4) for i in range(3)]
        for i, f in enumerate(after):
            np.testing.assert_array_equal(
                f.result(timeout=120), tm.reference_generate(tp, [25 + i], 4))
        with pytest.raises(MXNetError, match="token ids"):
            eng.submit([32], 2)  # past the vocab: refused at the door


def test_swap_params_serves_new_weights_and_flushes_prefix_index(models):
    # the prompt's cached KV was computed under the old weights: after the
    # swap the same prompt must match nothing and equal the new oracle
    _jm, _jp, tm, tp = models
    tp_b = tm.init_params(1, device="cpu")
    prompt = np.asarray([8, 6, 7, 5, 3, 1, 9, 4, 2, 12], np.int32)
    with _engine(tm, tp, page_size=8) as eng:
        np.testing.assert_array_equal(eng.generate(prompt, 5, timeout=120),
                                      tm.reference_generate(tp, prompt, 5))
        eng.swap_params(tp_b, variant="B", timeout=120)
        np.testing.assert_array_equal(eng.generate(prompt, 5, timeout=120),
                                      tm.reference_generate(tp_b, prompt, 5))
        other = tserving.TinyDecoder(vocab_size=32, num_layers=1,
                                     num_heads=2, head_dim=16)
        with pytest.raises(MXNetError, match="signature differs"):
            eng.swap_params(other.init_params(0, device="cpu"))
        stats = eng.stats()
    assert stats["weight_swaps"] == 1 and stats["active_variant"] == "B"
    assert stats["kvcache"]["prefix_hits"] == 0


def test_deadline_mid_decode_evicts_at_tick_boundary(models):
    _jm, _jp, tm, tp = models
    with _engine(tm, tp, num_slots=1, max_seq_len=128) as eng:
        eng.warmup()
        orig_step = eng._step_once

        def slow_step(active):  # 5 ms a tick: 100 tokens take >= 500 ms
            time.sleep(0.005)
            return orig_step(active)

        eng._step_once = slow_step
        fut = eng.submit([1, 2], 100, timeout_ms=100)
        with pytest.raises(tserving.RequestTimeoutError, match="mid-decode"):
            fut.result(timeout=120)
        eng._step_once = orig_step
        stats = eng.stats()
        assert stats["deadline_evictions"] == 1
        assert stats["kvcache"]["pages_in_use"] == 0
        np.testing.assert_array_equal(eng.generate([5], 4, timeout=120),
                                      tm.reference_generate(tp, [5], 4))


# the chunked-prefill configurations of test_decode.py:847-890, and the
# chunk lane under a speculating tick (prefilling slots ride the widened
# tick as inactive rows)
_CHUNKED = {
    "alone": dict(num_slots=2, prefix_cache=False, prefill_chunk=4),
    "with_prefix_cache": dict(num_slots=2, page_size=8, prefix_cache=True,
                              prefill_chunk=4),
    "with_spec_k_2": dict(num_slots=2, prefix_cache=False, prefill_chunk=4,
                          spec_k=2, spec_draft="prompt_lookup"),
}


def _chunked_reqs(case):
    rng = np.random.RandomState(3)
    if case == "with_prefix_cache":
        system = [7, 3, 7, 3, 1, 1, 2, 2, 9]
        return [(np.asarray(system + [15 + i, 14 - i], np.int32), 5)
                for i in range(5)]
    return [(rng.randint(1, 32, int(rng.randint(1, 14))).astype(np.int32),
             int(rng.randint(1, 7))) for _ in range(7)]


@pytest.mark.parametrize("case", sorted(_CHUNKED))
def test_chunked_prefill_equals_oracle_and_jax_engine(models, case):
    jm, jp, tm, tp = models
    kw = _CHUNKED[case]
    reqs = _chunked_reqs(case)
    with _engine(tm, tp, **kw) as eng:
        assert eng.warmup() > 0
        outs = [f.result(timeout=120)
                for f in [eng.submit(p, m) for p, m in reqs]]
        stats = eng.stats()
    with jserving.DecodeEngine(jm, jp, max_seq_len=48,
                               prefill_buckets=(8, 16), timeout_ms=0,
                               name="jchunk-" + case, **kw) as jeng:
        jouts = [f.result(timeout=120)
                 for f in [jeng.submit(p, m) for p, m in reqs]]
    for (p, m), got, jgot in zip(reqs, outs, jouts):
        np.testing.assert_array_equal(got, tm.reference_generate(tp, p, m))
        np.testing.assert_array_equal(got, jgot)
    assert stats["prefill_chunk"] == 4
    assert stats["kvcache"]["pages_in_use"] == 0
    if case == "with_prefix_cache":
        assert stats["kvcache"]["prefix_hits"] >= 3
        assert stats["prefill_chunks"] > 0
    else:
        # every prompt runs through the one chunk rung: ceil(p / C) each
        assert stats["prefill_chunks"] == sum(-(-p.size // 4)
                                              for p, _m in reqs)
    if "spec_k" in kw:
        assert stats["speculative"]["proposed_tokens"] > 0


def test_chunked_short_prompt_not_blocked_by_long(models):
    # test_decode.py:892: a short request submitted alongside a LONG
    # prompt (8 chunks) completes while the long one is still
    # prefilling — one chunk per tick, round-robin over prefilling slots
    _jm, _jp, tm, tp = models
    with _engine(tm, tp, num_slots=2, prefix_cache=False,
                 prefill_chunk=4) as eng:
        eng.warmup()
        order = []
        f_long = eng.submit(np.arange(1, 33, dtype=np.int32) % 32, 4)
        f_short = eng.submit([2, 4], 2)
        f_long.add_done_callback(lambda _f: order.append("long"))
        f_short.add_done_callback(lambda _f: order.append("short"))
        f_long.result(timeout=120)
        f_short.result(timeout=120)
        stats = eng.stats()
    assert order[0] == "short"
    assert stats["prefill_chunks"] == 9


def test_swap_mid_chunked_prefill_never_reindexes_stale_kv(models):
    # test_decode.py:1022: a swap landing BETWEEN chunks of an in-flight
    # prefill flushes the index; the straddling sequence's pages hold
    # old-weight KV and must not be re-indexed at completion
    _jm, _jp, tm, tp = models
    tp_b = tm.init_params(1, device="cpu")
    prompt = np.arange(1, 33, dtype=np.int32) % 32  # 16 chunks of 2
    with _engine(tm, tp, num_slots=1, page_size=8, prefix_cache=True,
                 prefill_chunk=2) as eng:
        eng.warmup()
        orig = eng._run_chunk

        def slow_chunk(*a):  # 16 chunks take >= 80 ms
            time.sleep(0.005)
            return orig(*a)

        eng._run_chunk = slow_chunk
        f = eng.submit(prompt, 2)
        time.sleep(0.02)  # some chunks land under the old weights
        eng.swap_params(tp_b, timeout=120)
        f.result(timeout=120)  # mixed-weight output: not checked
        eng._run_chunk = orig
        np.testing.assert_array_equal(
            eng.generate(prompt, 5, timeout=120),
            tm.reference_generate(tp_b, prompt, 5))
        assert eng.stats()["kvcache"]["prefix_hits"] == 0


@pytest.mark.parametrize("kw", [{"ring_prefill_len": 8}])
def test_unported_options_raise(models, kw):
    _jm, _jp, tm, tp = models
    with pytest.raises(MXNetError, match="not ported"):
        _engine(tm, tp, **kw)
