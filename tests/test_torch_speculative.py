"""Speculative decoding in mxnet_tpu_torch against the JAX package (CPU).

The drafts (``serving/speculative.py``, a copy of the JAX module) must
propose what the JAX drafts propose on the same seeded histories. The
engine's bar is the one every decode test holds: served token ids equal
the port's no-cache oracle AND the JAX engine's, token for token, under
slot churn, whatever the draft proposed — accept-all (``model``),
``prompt_lookup`` and a reject-all draft, at k = 0, 2 and 4. Beside
that: the per-tick clamps (reservation, ``max_new``, tenant caps), the
audit rule that a verify tick never allocates, EOS inside an accepted
run, the rollback under a faulted tick, and the spec counters under the
JAX package's metric names and labels.
"""
import numpy as np
import pytest

import jax

from mxnet_tpu import serving as jserving
from mxnet_tpu.serving import speculative as jspec
from mxnet_tpu.serving import tenancy as jten
from mxnet_tpu.telemetry.registry import REGISTRY as JREGISTRY
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import RetryPolicy, chaos
from mxnet_tpu_torch.serving import speculative as tspec
from mxnet_tpu_torch.serving import tenancy as tten
from mxnet_tpu_torch.telemetry import REGISTRY as TREGISTRY

_DIMS = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=8,
             num_kv_heads=2)
_ENGINE = dict(num_slots=3, max_seq_len=48, prefill_buckets=(8, 16),
               timeout_ms=0)


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
    for key, val in _ENGINE.items():
        kw.setdefault(key, val)
    kw.setdefault("name", "tspec%d" % np.random.randint(1 << 30))
    kw.setdefault("device", "cpu")
    return tserving.DecodeEngine(tm, tp, **kw)


class _RejectAllDraft(tspec.DraftProposer):
    """Proposes (true next + 1) % vocab: the first draft row is always
    wrong, so greedy verification accepts ZERO drafts every tick — the
    worst case the rollback path must survive token-exactly."""

    name = "reject_all"

    def __init__(self, model, params):
        self._model = model
        self._params = params

    def propose(self, history, k):
        nxt = self._model.reference_generate(self._params, history, int(k))
        return (np.asarray(nxt, np.int64) + 1) % self._model.vocab_size


def _churn_reqs():
    # more requests than slots; half repeat a motif so prompt lookup has
    # something to find, half are random
    rng = np.random.RandomState(11)
    reqs = []
    for i in range(8):
        if i % 2:
            motif = rng.randint(1, 64, int(rng.randint(2, 5)))
            p = np.concatenate([motif, motif, motif[:1]])
        else:
            p = rng.randint(1, 64, int(rng.randint(1, 12)))
        reqs.append((p.astype(np.int32), int(rng.randint(3, 14))))
    return reqs


@pytest.fixture(scope="module")
def churn(models):
    """The churn requests, the port oracle's outputs, and the JAX
    engine's outputs at each k (spec_k 0, and 2/4 with prompt lookup)."""
    jm, jp, tm, tp = models
    reqs = _churn_reqs()
    oracle = [tm.reference_generate(tp, p, m) for p, m in reqs]
    jax_outs = {}
    for k in (0, 2, 4):
        with jserving.DecodeEngine(
                jm, jp, name="jspec-churn-%d" % k, spec_k=k,
                spec_draft="prompt_lookup" if k else None,
                **_ENGINE) as jeng:
            jax_outs[k] = [f.result(timeout=120)
                           for f in [jeng.submit(p, m) for p, m in reqs]]
    return reqs, oracle, jax_outs


# ---------------------------------------------------------------------------
# the drafts: the port's copy proposes what the JAX module proposes
# ---------------------------------------------------------------------------

def test_prompt_lookup_matches_jax_on_seeded_histories():
    rng = np.random.RandomState(0)
    hits = 0
    for _ in range(300):
        n = int(rng.randint(0, 24))
        hist = rng.randint(0, int(rng.randint(2, 6)), n).astype(np.int32)
        ngram = int(rng.randint(1, 5))
        k = int(rng.randint(0, 6))
        got = tspec.PromptLookupDraft(ngram_max=ngram).propose(hist, k)
        want = jspec.PromptLookupDraft(ngram_max=ngram).propose(hist, k)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        hits += int(got.size > 0)
    assert hits > 100  # the histories really exercise the lookup


@pytest.mark.parametrize("hist,k,want", [
    # the suffix (1,2,3) recurs at 1 and 5: the MOST RECENT wins
    ([7, 1, 2, 3, 9, 1, 2, 3, 4, 1, 2, 3], 4, [4, 1, 2, 3]),
    # no 3- or 2-gram recurrence of the tail, but token 5 recurs
    ([5, 8, 9, 5], 2, [8, 9]),
    ([1, 2, 3, 4], 4, []),
    ([1], 4, []),
    ([1, 1, 1], 0, []),
])
def test_prompt_lookup_cases(hist, k, want):
    got = tspec.PromptLookupDraft(ngram_max=3).propose(
        np.asarray(hist, np.int32), k)
    np.testing.assert_array_equal(got, np.asarray(want, np.int32))


def test_ngram_knob_is_read_like_jax(monkeypatch):
    monkeypatch.setenv("MXNET_DECODE_SPEC_NGRAM", "1")
    t, j = tspec.PromptLookupDraft(), jspec.PromptLookupDraft()
    assert t.ngram_max == j.ngram_max == 1
    hist = np.asarray([4, 2, 7, 1, 2, 3, 9, 1, 2], np.int32)
    np.testing.assert_array_equal(t.propose(hist, 3), j.propose(hist, 3))


def test_model_draft_matches_jax_and_the_oracle(models):
    jm, jp, tm, tp = models
    hist = np.asarray([9, 3, 9, 3, 9, 5], np.int32)
    got = tspec.make_draft("model", tm, tp).propose(hist, 2)
    np.testing.assert_array_equal(got, tm.reference_generate(tp, hist, 2))
    np.testing.assert_array_equal(
        got, jspec.make_draft("model", jm, jp).propose(hist, 2))
    assert tspec.ModelDraft(tm, tp).propose(hist, 0).size == 0
    with pytest.raises(MXNetError, match="reference_generate"):
        tspec.ModelDraft(object(), tp)


def test_registry_and_sanitize_match_jax():
    assert tspec.available_drafts() == jspec.available_drafts() \
        == ["model", "prompt_lookup"]
    with pytest.raises(MXNetError, match="unknown speculative draft"):
        tspec.make_draft("no_such_draft")
    tspec.register_draft("not_a_draft", lambda model, params: object())
    try:
        with pytest.raises(MXNetError, match="not a DraftProposer"):
            tspec.make_draft("not_a_draft")
    finally:
        tspec._DRAFTS.pop("not_a_draft")
    # truncation at the first out-of-vocab id, cap at k
    np.testing.assert_array_equal(
        tspec.sanitize([3, 5, 99, 4], k=4, vocab_size=32), [3, 5])
    assert tspec.sanitize([1, 2, 3], k=2, vocab_size=32).size == 2
    assert tspec.sanitize([-1], k=4, vocab_size=32).size == 0
    rng = np.random.RandomState(1)
    for _ in range(100):
        arr = rng.randint(-3, 40, int(rng.randint(0, 8)))
        k = int(rng.randint(-1, 6))
        got = tspec.sanitize(arr, k, 32)
        np.testing.assert_array_equal(got, jspec.sanitize(arr, k, 32))
        assert got.dtype == np.int32


# ---------------------------------------------------------------------------
# the cache and tenant pieces of speculation
# ---------------------------------------------------------------------------

def test_kvcache_reserved_tokens():
    from mxnet_tpu_torch.serving import kvcache as tkv

    cache = tkv.PagedKVCache(2, 64, 1, 2, 8, page_size=8, device="cpu",
                             name="rsv%d" % np.random.randint(1 << 30))
    assert cache.reserved_tokens(0) == 0
    cache.reserve(0, 12)  # 2 pages
    assert cache.reserved_tokens(0) == 16
    assert cache.reserved_tokens(1) == 0
    cache.free(0)
    assert cache.reserved_tokens(0) == 0


def test_tenant_spec_k_parse_and_snapshot_match_jax():
    spec = "acme,weight=2,spec_k=1;beta;gamma,spec_k=0"
    assert tten.parse_tenants(spec) == jten.parse_tenants(spec)
    with pytest.raises(MXNetError, match="bad value"):
        tten.parse_tenants("acme,spec_k=x")
    reg = tten.TenantRegistry(server="spk%d" % np.random.randint(1 << 30),
                              spec=spec)
    assert reg.get("acme").spec_k == 1
    assert reg.get("beta").spec_k is None  # inherit the engine k
    assert reg.get("gamma").spec_k == 0
    snap = reg.snapshot()
    assert snap["acme"]["spec_k"] == 1 and snap["beta"]["spec_k"] is None
    for row in snap.values():
        assert row["spec_proposed_tokens"] == 0
        assert row["spec_acceptance_rate"] == 0.0


def test_tenant_spec_k_caps_draft_depth_and_is_set_at_runtime(models):
    _jm, _jp, tm, tp = models
    prompts = [np.asarray([15 + i, 2, 15 + i, 2], np.int32)
               for i in range(4)]
    with _engine(tm, tp, spec_k=3, spec_draft="model",
                 tenants="slow,spec_k=0;fast") as eng:
        futs = [eng.submit(p, 6, tenant="slow" if i % 2 else "fast")
                for i, p in enumerate(prompts)]
        for p, f in zip(prompts, futs):
            np.testing.assert_array_equal(f.result(timeout=120),
                                          tm.reference_generate(tp, p, 6))
        snap = eng.stats()["tenants"]
        assert snap["slow"]["spec_proposed_tokens"] == 0
        assert snap["fast"]["spec_proposed_tokens"] > 0
        assert snap["fast"]["spec_acceptance_rate"] == 1.0
        assert snap["slow"]["spec_k"] == 0 and snap["fast"]["spec_k"] is None
        # a runtime cap of 0 stops the fast tenant speculating too
        eng.set_tenant_spec_k("fast", 0)
        assert eng.tenants.get("fast").spec_k == 0
        before = snap["fast"]["spec_proposed_tokens"]
        np.testing.assert_array_equal(
            eng.submit(prompts[0], 6, tenant="fast").result(timeout=120),
            tm.reference_generate(tp, prompts[0], 6))
        assert eng.stats()["tenants"]["fast"]["spec_proposed_tokens"] \
            == before
        eng.set_tenant_spec_k("fast", None)
        assert eng.tenants.get("fast").spec_k is None
        eng.set_tenant_spec_k("newcomer", -3)  # clamps, auto-registers
        assert eng.tenants.get("newcomer").spec_k == 0


# ---------------------------------------------------------------------------
# engine == port oracle == JAX engine under churn, across drafts and k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,draft", [
    (0, None), (2, "model"), (2, "prompt_lookup"), (2, "reject_all"),
    (4, "model"), (4, "prompt_lookup"), (4, "reject_all")])
def test_engine_equals_oracle_and_jax_engine_under_churn(models, churn, k,
                                                         draft):
    _jm, _jp, tm, tp = models
    reqs, oracle, jax_outs = churn
    spec_draft = _RejectAllDraft(tm, tp) if draft == "reject_all" else draft
    with _engine(tm, tp, spec_k=k, spec_draft=spec_draft) as eng:
        assert eng.warmup() > 0
        outs = [f.result(timeout=120)
                for f in [eng.submit(p, m) for p, m in reqs]]
        stats = eng.stats()
    for got, want, jgot in zip(outs, oracle, jax_outs[k]):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jgot)
    assert stats["kvcache"]["pages_in_use"] == 0
    assert stats["completed"] == len(reqs)
    spec = stats["speculative"]
    assert spec["k"] == k
    assert stats["tokens_generated"] == sum(m for _p, m in reqs)
    if k == 0:
        assert spec["draft"] is None and spec["proposed_tokens"] == 0
        return
    assert spec["draft"] == draft and spec["proposed_tokens"] > 0
    if draft == "model":
        assert spec["accepted_tokens"] == spec["proposed_tokens"]
        assert spec["accepted_per_tick"] > 1.0
    elif draft == "reject_all":
        # the first draft row is always wrong: exactly one committed
        # token per speculating slot-tick — pure rollback traffic
        assert spec["accepted_tokens"] == 0
        assert spec["accepted_per_tick"] == 1.0
    else:
        assert 0 < spec["accepted_tokens"] <= spec["proposed_tokens"]


def test_eos_inside_an_accepted_run(models):
    # an accept-all tick that would commit k+1 tokens stops at EOS exactly
    # where the oracle does
    _jm, _jp, tm, tp = models
    rng = np.random.RandomState(5)
    with _engine(tm, tp, spec_k=4, spec_draft="model") as eng:
        for _ in range(3):
            p = rng.randint(1, 64, 4).astype(np.int32)
            full = tm.reference_generate(tp, p, 12)
            eos = int(full[2])  # lands inside the first verify tick
            want = tm.reference_generate(tp, p, 12, eos_id=eos)
            got = eng.submit(p, 12, eos_id=eos).result(timeout=120)
            np.testing.assert_array_equal(got, want)
            assert got[-1] == eos and len(got) <= 3
        assert eng.stats()["kvcache"]["pages_in_use"] == 0


def test_propose_clamps_to_reservation_and_max_new(models):
    # max_new=2: after the first token at most ONE more may be committed,
    # so drafts are suppressed although the engine k is 4; then max_new
    # 10 against a 16-token reservation: every verify row stays inside
    # the reserved run (write_slots would fault past it)
    _jm, _jp, tm, tp = models
    with _engine(tm, tp, spec_k=4, spec_draft="model", max_seq_len=16,
                 prefill_buckets=(8,)) as eng:
        got = eng.submit([7, 8, 9], 2).result(timeout=120)
        np.testing.assert_array_equal(
            got, tm.reference_generate(tp, [7, 8, 9], 2))
        assert eng.stats()["speculative"]["proposed_tokens"] == 0
        p = [1, 2, 3, 4, 5, 6]
        np.testing.assert_array_equal(
            eng.submit(p, 10).result(timeout=120),
            tm.reference_generate(tp, p, 10))


def test_audit_on_verify_tick_never_allocates(models, monkeypatch):
    _jm, _jp, tm, tp = models
    monkeypatch.setenv("MXNET_KVCACHE_AUDIT", "1")
    with _engine(tm, tp, spec_k=3, spec_draft="model",
                 tenants="fast,pages=12;beta,pages=12") as eng:
        assert eng._cache.audit
        futs = [eng.submit([10 + i, 3], 10,
                           tenant="fast" if i % 2 else "beta")
                for i in range(6)]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(
                f.result(timeout=120),
                tm.reference_generate(tp, [10 + i, 3], 10))
        stats = eng.stats()
        assert stats["evictions"] == 0
        assert stats["speculative"]["accepted_per_tick"] > 1.0
        assert stats["kvcache"]["pages_in_use"] == 0
        # the rule bites: a draft step that grows the slot's reservation
        # mid-tick fails the tick under audit
        orig = eng._propose

        def greedy_propose(req, slot, pos):
            eng._cache.reserve(slot, eng._cache.reserved_tokens(slot) + 1)
            return orig(req, slot, pos)

        eng._propose = greedy_propose
        with pytest.raises(MXNetError, match="grew pages_in_use"):
            eng.submit([4, 4, 4], 6).result(timeout=120)
        eng._propose = orig
        assert eng.stats()["evictions"] == 1
        np.testing.assert_array_equal(
            eng.submit([5, 6], 4).result(timeout=120),
            tm.reference_generate(tp, [5, 6], 4))


def test_chaos_fault_on_a_verify_tick_evicts_in_flight_no_page_leak(models):
    _jm, _jp, tm, tp = models
    with _engine(tm, tp, num_slots=2, spec_k=3, spec_draft="prompt_lookup",
                 retry_policy=RetryPolicy(max_attempts=1)) as eng:
        with chaos.active("seed=1,site=serving.decode,at=3"):
            futs = [eng.submit([20 + i, 5, 20 + i, 5], 8) for i in range(2)]
            evicted = 0
            for f in futs:
                try:
                    f.result(timeout=120)
                except chaos.FaultInjected:
                    evicted += 1
        assert evicted == 2  # both in flight on the faulted tick
        mid = eng.stats()
        assert mid["evictions"] == 2
        assert mid["kvcache"]["pages_in_use"] == 0  # rollback leaks nothing
        after = [eng.submit([30 + i, 7, 30 + i, 7], 6) for i in range(2)]
        for i, f in enumerate(after):
            np.testing.assert_array_equal(
                f.result(timeout=120),
                tm.reference_generate(tp, [30 + i, 7, 30 + i, 7], 6))
        assert eng.stats()["evictions"] == 2  # no bystanders joined them


def test_a_failing_draft_degrades_to_the_one_token_tick(models):
    _jm, _jp, tm, tp = models

    class Broken(tspec.DraftProposer):
        name = "broken"

        def propose(self, history, k):
            raise RuntimeError("draft bug")

    with _engine(tm, tp, spec_k=2, spec_draft=Broken()) as eng:
        np.testing.assert_array_equal(
            eng.submit([3, 1, 4], 7).result(timeout=120),
            tm.reference_generate(tp, [3, 1, 4], 7))
        stats = eng.stats()
    assert stats["speculative"]["proposed_tokens"] == 0
    assert stats["evictions"] == 0 and stats["errors"] == 0


def test_spec_knobs_pick_k_and_draft(models, monkeypatch):
    _jm, _jp, tm, tp = models
    monkeypatch.setenv("MXNET_DECODE_SPEC_K", "2")
    monkeypatch.setenv("MXNET_DECODE_SPEC_DRAFT", "model")
    with _engine(tm, tp) as eng:
        spec = eng.stats()["speculative"]
    assert spec["k"] == 2 and spec["draft"] == "model"
    with pytest.raises(MXNetError, match="unknown speculative draft"):
        _engine(tm, tp, spec_draft="nope")


# ---------------------------------------------------------------------------
# the spec counters: engine, tenant and registry series
# ---------------------------------------------------------------------------

def test_spec_counters_and_metric_names(models):
    _jm, _jp, tm, tp = models
    with _engine(tm, tp, spec_k=2, spec_draft="model") as eng:
        name = eng.name
        out = eng.submit([9, 9, 9], 8).result(timeout=120)
        stats = eng.stats()
    assert len(out) == 8
    spec = stats["speculative"]
    assert spec["proposed_tokens"] == spec["accepted_tokens"] > 0
    assert stats["spec_proposed_tokens"] == spec["proposed_tokens"]
    assert stats["spec_accepted_tokens"] == spec["accepted_tokens"]
    assert stats["spec_acceptance_rate"] == spec["acceptance_rate"] == 1.0
    # tokens_generated counts COMMITTED tokens, not verify rows
    assert stats["tokens_generated"] == 8
    row = stats["tenants"]["default"]
    assert row["spec_proposed_tokens"] == spec["proposed_tokens"]
    assert row["spec_acceptance_rate"] == 1.0
    names = ("mxnet_spec_proposed_tokens_total",
             "mxnet_spec_accepted_tokens_total",
             "mxnet_spec_acceptance_rate")
    for metric in names:
        t, j = TREGISTRY.get(metric), JREGISTRY.get(metric)
        assert t is not None and j is not None, metric
        assert (t.kind, t.label_names) == (j.kind, j.label_names)
    assert TREGISTRY.get(names[0]).value(server=name) \
        == spec["proposed_tokens"]
    assert TREGISTRY.get(names[1]).value(server=name) \
        == spec["accepted_tokens"]
    assert TREGISTRY.get(names[2]).value(server=name,
                                         tenant="_engine") == 1.0
    assert TREGISTRY.get(names[2]).value(server=name,
                                         tenant="default") == 1.0


def test_tokens_total_counts_accepted_not_proposed(models):
    _jm, _jp, tm, tp = models
    with _engine(tm, tp, spec_k=2,
                 spec_draft=_RejectAllDraft(tm, tp)) as eng:
        out = eng.submit([11, 12], 6).result(timeout=120)
        stats = eng.stats()
    assert len(out) == 6
    assert stats["tokens_generated"] == 6
    assert stats["speculative"]["accepted_tokens"] == 0
    assert stats["speculative"]["proposed_tokens"] > 0
