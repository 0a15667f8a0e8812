"""The serving and resilience API gaps, and the small ones: the port
against the JAX package (CPU).

Named variants served live through ``register_variant``/``use_variant``
(written into the served tensors in place: nothing captured again);
``kvcache_stats``; ``PagedKVCache.pages_owned``/``can_admit``/
``swap_pools`` on the same operations as the JAX cache;
``pad_to_bucket``; ``Deadline`` and ``RetryPolicy.call(deadline=)``; the
chaos actions (``kill``, ``torn-write``, ``drop-shard``: ``ChaosAction``s,
never transient) and ``summary()``; ``DecodeEngine.release``; and
``Symbol.simple_bind(shared_buffer=)``, the ``Context`` device-type
tables, ``Updater.sync_state_context``, ``BaseModule``'s abstract names,
``model.BatchEndParam``, ``gluon.utils.HookHandle`` and ``base``'s type
tuples and ``DTYPE_NAMES``.
"""
import inspect

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import resilience as jres
from mxnet_tpu import serving as jserving
from mxnet_tpu.serving import buckets as jbuckets
from mxnet_tpu.serving import kvcache as jkv

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import buckets as tbuckets
from mxnet_tpu_torch.serving import kvcache as tkv

_DIMS = dict(vocab_size=32, num_layers=2, num_heads=4, head_dim=8,
             num_kv_heads=2)


@pytest.fixture(autouse=True)
def _no_chaos():
    for res in (jres, tres):
        res.chaos.disable()
    yield
    for res in (jres, tres):
        res.chaos.disable()


@pytest.fixture(scope="module")
def tiny():
    jm = jserving.TinyDecoder(**_DIMS)
    jp = jm.init_params(0)
    tm = tserving.TinyDecoder(**_DIMS)
    tp = tserving.params_from_jax(jax.device_get(jp), device="cpu")
    return jm, jp, tm, tp


def _engine(tm, tp, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq_len", 48)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("timeout_ms", 0)
    kw.setdefault("name", "gap%d" % np.random.randint(1 << 30))
    return tserving.DecodeEngine(tm, tp, device="cpu", **kw)


# -- variants, kvcache_stats, release -----------------------------------

def test_variants_serve_the_jax_tokens_without_a_recapture(tiny):
    jm, _jp, tm, tp = tiny
    jb = jm.init_params(1)
    tb = tserving.params_from_jax(jax.device_get(jb), device="cpu")
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    eng = _engine(tm, tp)
    jeng = jserving.DecodeEngine(jm, _jp, num_slots=2, max_seq_len=48,
                                 prefill_buckets=(8, 16), timeout_ms=0,
                                 name="jgap%d" % np.random.randint(1 << 30))
    try:
        warm = eng.warmup()
        eng.register_variant("b", tb)
        jeng.register_variant("b", jb)
        np.testing.assert_array_equal(eng.generate(prompt, 4, timeout=60),
                                      tm.reference_generate(tp, prompt, 4))
        assert eng.use_variant("b").result(60) is True
        jeng.use_variant("b")
        got = eng.generate(prompt, 4, timeout=60)
        np.testing.assert_array_equal(got, jeng.generate(prompt, 4,
                                                         timeout=60))
        np.testing.assert_array_equal(got, tm.reference_generate(tb, prompt,
                                                                 4))
        st = eng.stats()
        assert st["active_variant"] == "b" and st["weight_swaps"] == 1
        assert st["compile_count"] == warm and \
            st["steady_state_recompiles"] == 0
        # the variant's tensors were copied into the served ones: the
        # caller's tree is untouched and still the variant's
        assert eng._params["embed"] is not tb["embed"]
        torch.testing.assert_close(eng._params["embed"], tb["embed"])
        with pytest.raises(MXNetError, match="unknown variant"):
            eng.use_variant("nope")
        bad = dict(tb, embed=tb["embed"][:, :4])
        with pytest.raises(MXNetError, match="signature"):
            eng.register_variant("bad", bad)
    finally:
        eng.close(timeout=60)
        jeng.close(timeout=60)


def test_kvcache_stats_is_the_stats_subset(tiny):
    _jm, _jp, tm, tp = tiny
    eng = _engine(tm, tp, prefix_cache=True)
    try:
        eng.generate(list(range(1, 20)), 3, timeout=60)
        assert eng.kvcache_stats() == eng.stats()["kvcache"]
        assert eng.kvcache_stats()["prefix_cache"] is True
    finally:
        eng.close(timeout=60)


def test_release_gives_back_graphs_pools_and_params(tiny):
    _jm, _jp, tm, tp = tiny
    eng = _engine(tm, tp)
    eng.warmup()
    with pytest.raises(MXNetError, match="before close"):
        eng.release()
    eng.generate([1, 2, 3], 2, timeout=60)
    eng.close(timeout=60)
    assert eng.release() is True
    assert eng._paths == {} and eng._params is None
    assert eng._cache.k_pool.numel() == 0 == eng._cache.v_pool.numel()
    assert eng.stats()["completed"] == 1  # stats still answer
    assert eng.release() is True  # idempotent


# -- the paged cache -------------------------------------------------------

def _caches():
    kw = dict(num_slots=3, max_seq_len=32, num_layers=2, num_kv_heads=2,
              head_dim=4, page_size=4, num_pages=12)
    return (jkv.PagedKVCache(**kw),
            tkv.PagedKVCache(device="cpu", **kw))


def test_pages_owned_and_can_admit_match_jax():
    jc, tc = _caches()
    for op, args in (("reserve", (0, 9)), ("reserve", (1, 20)),
                     ("free", (0,)), ("reserve", (2, 4))):
        getattr(jc, op)(*args)
        getattr(tc, op)(*args)
        for slot in range(3):
            assert tc.pages_owned(slot) == jc.pages_owned(slot)
        for n in (1, 4, 16, 28, 40, 44, 60):
            assert tc.can_admit(n) == jc.can_admit(n)


def test_swap_pools_stores_contents_in_place():
    _jc, tc = _caches()
    k0, v0 = tc.k_pool, tc.v_pool
    k = torch.randn(tuple(k0.shape))
    v = torch.randn(tuple(v0.shape))
    tc.swap_pools(k, v)
    assert tc.k_pool is k0 and tc.v_pool is v0  # graphs keep the address
    torch.testing.assert_close(tc.k_pool, k, rtol=0, atol=0)
    torch.testing.assert_close(tc.v_pool, v, rtol=0, atol=0)
    with pytest.raises(MXNetError, match="does not match"):
        tc.swap_pools(k[:1], v)


# -- buckets ----------------------------------------------------------------

@pytest.mark.parametrize("n,bucket", [(1, 4), (3, 4), (4, 4), (5, 16)])
def test_pad_to_bucket_matches_jax(n, bucket):
    rows = [np.full((2, 3), i + 1, np.float32) for i in range(n)]
    got = tbuckets.pad_to_bucket(rows, bucket)
    np.testing.assert_array_equal(got, jbuckets.pad_to_bucket(rows, bucket))
    assert got.shape == (bucket, 2, 3) and not got[n:].any()


@pytest.mark.parametrize("n,bucket", [(0, 4), (5, 4)])
def test_pad_to_bucket_refuses_what_jax_refuses(n, bucket):
    rows = [np.zeros(2, np.float32)] * n
    with pytest.raises(MXNetError):
        tbuckets.pad_to_bucket(rows, bucket)
    with pytest.raises(jmx.MXNetError):
        jbuckets.pad_to_bucket(rows, bucket)


# -- resilience --------------------------------------------------------------

def test_deadline_matches_jax():
    for res in (tres, jres):
        assert res.Deadline().remaining() == float("inf")
        assert not res.Deadline().expired()
        d = res.Deadline(0.0)
        assert d.expired() and d.remaining() == 0.0
        assert res.Deadline.after_ms(None).remaining() == float("inf")
        assert 0.0 < res.Deadline.after_ms(5000).remaining() <= 5.0
        assert "unbounded" in repr(res.Deadline())


def test_retry_call_stops_at_the_deadline():
    slept = []
    policy = tres.RetryPolicy(max_attempts=10, base_delay_ms=50,
                              jitter=0.0, sleep=slept.append)
    calls = []

    def always():
        calls.append(1)
        raise tres.TransientError("down")

    with pytest.raises(tres.TransientError):
        policy.call(always, site="t.deadline", deadline=tres.Deadline(0.0))
    assert len(calls) == 1 and slept == []
    calls.clear()
    with pytest.raises(tres.TransientError):
        tres.call("t.deadline", always, deadline=tres.Deadline(0.0))
    assert len(calls) == 1
    assert tres.snapshot()["retries"]["t.deadline/exhausted"] >= 2


@pytest.mark.parametrize("action,cls", [
    ("kill", "Killed"), ("torn-write", "TornWrite"), ("torn", "TornWrite"),
    ("drop-shard", "DropShard"), ("drop", "DropShard")])
def test_chaos_actions_are_not_transient_and_match_jax(action, cls):
    for res in (tres, jres):
        res.chaos.configure("seed=3,site=x.site,p=1.0,max=1,action=%s"
                            % action)
        with pytest.raises(getattr(res, cls)) as ei:
            res.chaos.maybe_fail("x.site")
        exc = ei.value
        assert isinstance(exc, res.ChaosAction)
        assert not isinstance(exc, res.TransientError)
        assert (exc.site, exc.call_index, exc.action) == \
            ("x.site", 1, getattr(res, cls).action)
        # never retried: it reaches the layer that owns the failure
        calls = []

        def once():
            calls.append(1)
            res.chaos.maybe_fail("x.site")

        res.chaos.configure("seed=3,site=x.site,p=1.0,max=1,action=%s"
                            % action)
        with pytest.raises(res.ChaosAction):
            res.RetryPolicy(max_attempts=5, base_delay_ms=0).call(
                once, site="x.site")
        assert len(calls) == 1
        res.chaos.disable()


def test_chaos_summary_matches_jax():
    spec = "seed=7,site=a.*,p=1.0,max=2"
    out = []
    for res in (tres, jres):
        assert res.chaos.summary() == {"enabled": False}
        res.chaos.configure(spec)
        for _ in range(3):
            try:
                res.chaos.maybe_fail("a.b")
            except res.FaultInjected:
                pass
        out.append(res.chaos.summary())
        res.chaos.disable()
    assert out[0] == out[1] == {"enabled": True, "spec": spec, "seed": 7,
                                "faults_injected": {"a.b": 2}}


def test_resilience_all_matches_jax():
    assert set(tres.__all__) == set(jres.__all__)


# -- the small gaps ---------------------------------------------------------

def test_simple_bind_shared_buffer_matches_jax():
    results = []
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, mx.cpu())):
        data = pkg.sym.var("data")
        net = pkg.sym.FullyConnected(data=data, num_hidden=4, name="fc")
        buf = {}
        ex1 = net.simple_bind(ctx, data=(2, 3), shared_buffer=buf)
        assert set(buf) == {"data", "fc_weight", "fc_bias"}
        ex2 = net.simple_bind(ctx, data=(2, 3), shared_buffer=buf)
        same = [ex2.arg_dict[n] is buf[n] is ex1.arg_dict[n] for n in buf]
        # a shape that no longer fits gets its own array, which takes
        # the buffer's entry (the JAX package's rule)
        ex3 = net.simple_bind(ctx, data=(5, 3), shared_buffer=buf)
        results.append((same, ex3.arg_dict["data"] is buf["data"],
                        ex3.arg_dict["fc_weight"] is buf["fc_weight"],
                        tuple(buf["data"].shape)))
    assert results[0] == results[1] == ([True] * 3, True, True, (5, 3))


def test_context_device_type_tables_match_jax():
    assert mx.Context.devtype2str == jmx.Context.devtype2str
    assert mx.Context.devstr2type == jmx.Context.devstr2type
    assert mx.cpu().device_typeid == jmx.cpu().device_typeid == 1
    assert mx.cpu(0).empty_cache() is None


def test_updater_sync_state_context_returns_the_state():
    upd = mx.optimizer.get_updater(mx.optimizer.SGD(momentum=0.9))
    state = object()
    assert upd.sync_state_context(state, mx.cpu()) is state
    jupd = jmx.optimizer.get_updater(jmx.optimizer.SGD(momentum=0.9))
    assert jupd.sync_state_context(state, jmx.cpu()) is state


def _abstract(cls):
    out = set()
    for name, member in vars(cls).items():
        fn = member.fget if isinstance(member, property) else member
        if callable(fn):
            try:
                src = inspect.getsource(fn)
            except (OSError, TypeError):
                continue
            if "raise NotImplementedError" in src:
                out.add(name)
    return out


def test_base_module_has_the_jax_abstract_names():
    from mxnet_tpu.module.base_module import BaseModule as JBase
    from mxnet_tpu_torch.module.base_module import BaseModule as TBase

    names = _abstract(TBase)
    assert names == _abstract(JBase) and len(names) == 16
    mod = TBase()
    with pytest.raises(NotImplementedError):
        mod.forward(None)
    with pytest.raises(NotImplementedError):
        mod.data_names


def test_batch_end_param_hook_handle_and_base_types():
    p = mx.model.BatchEndParam(epoch=1, nbatch=2, eval_metric=None,
                               locals={})
    assert p._fields == jmx.model.BatchEndParam._fields
    assert type(p).__name__ == type(jmx.model.BatchEndParam(
        1, 2, None, {})).__name__
    from mxnet_tpu_torch.gluon.block import _HookHandle
    from mxnet_tpu_torch.gluon.utils import HookHandle

    assert HookHandle is _HookHandle
    assert "HookHandle" in mx.gluon.utils.__all__
    from mxnet_tpu import base as jbase
    from mxnet_tpu_torch import base as tbase

    for name in ("string_types", "numeric_types", "integer_types"):
        assert getattr(tbase, name) == getattr(jbase, name)
    assert tbase.DTYPE_NAMES == jbase.DTYPE_NAMES
