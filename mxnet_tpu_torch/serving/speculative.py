"""Speculative decoding drafts: propose k tokens, verify in one tick.

Ported from ``mxnet_tpu/serving/speculative.py`` whole (the module has no
JAX in it; the port keeps its own copy). The decode plane's per-token
cost is one tick of launches; a draft that guesses the next k tokens
lets the engine verify all k+1 positions in ONE widened tick
(:mod:`~mxnet_tpu_torch.serving.decode`, whose attention is the
multi-query CUDA kernel of :mod:`mxnet_tpu_torch.ops.paged_attention`),
so a correct guess turns k+1 launch-bound tokens into one. Greedy rejection
keeps the output *bit-exact* against the no-cache oracle: the engine
accepts the longest draft prefix whose tokens equal the model's own
argmax at each position, plus the one "free" token the verify pass
computed anyway — by construction the committed tokens are exactly what
sequential greedy decode would have produced, whatever the draft said.

Drafts are **proposers**, not samplers: a :class:`DraftProposer` sees a
sequence's token history (prompt + generated so far) and returns up to
``k`` guessed continuation token ids. Registered by name
(:func:`register_draft` / :func:`make_draft`) so the engine knob
``MXNET_DECODE_SPEC_DRAFT`` picks one without code:

* ``prompt_lookup`` (default) — model-free n-gram lookup over the
  sequence's OWN history: find the most recent earlier occurrence of the
  current suffix and propose the tokens that followed it. Zero extra
  weights, zero extra launches — the draft is pure host work — and it
  wins exactly where decode output repeats its context (code edits, RAG
  quoting, templated answers, short-cycle chatter).
* ``model`` — the served model itself run greedily (dense, no cache, on
  the params' device) as its own draft: acceptance is ~100% by
  construction, which makes it the accept-all schedule of the test/bench
  plane rather than a production speed win (it re-pays the model per
  drafted token). A real deployment would register a *smaller* decoder
  here; the interface — history in, tokens out — is the same.

A draft can be WRONG with no correctness cost (rejected rows' KV is
rolled back by simply not advancing ``seq_lens`` — masked, then
overwritten) and no shape cost (the widened step is a fixed ``K+1``
query block per slot; non-speculating rows pad with null positions, so
speculation changes data, never shapes).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from ..base import MXNetError, get_env

__all__ = ["DraftProposer", "PromptLookupDraft", "ModelDraft",
           "register_draft", "make_draft", "available_drafts", "sanitize"]

_EMPTY = np.zeros((0,), np.int32)

_DEFAULT_NGRAM_MAX = 3
_DEFAULT_NGRAM_MIN = 1


class DraftProposer:
    """Contract a draft serves speculation through.

    ``propose(history, k)`` returns up to ``k`` guessed continuation
    token ids (np.int32, possibly empty) for a sequence whose tokens so
    far — prompt AND generated — are ``history``. Called on the engine
    worker thread once per speculating slot per tick: keep it host-cheap
    (the prompt-lookup draft is pure numpy). Proposals are *hints*: a
    wrong token costs one wasted verify row, never correctness.
    """

    name = "draft"

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        raise NotImplementedError


class PromptLookupDraft(DraftProposer):
    """Model-free prompt-lookup (n-gram) draft.

    Match the history's current suffix of ``ngram_max`` (falling back to
    shorter n-grams down to ``ngram_min``) against every earlier window
    of the history; on the MOST RECENT earlier occurrence, propose the
    tokens that followed it. Repetitive-suffix workloads — code, RAG
    quoting, a greedy model that has entered a cycle — resolve almost
    every tick this way; a history with no recurrence proposes nothing
    and the tick degrades to the ordinary single-token step.
    """

    name = "prompt_lookup"

    def __init__(self, ngram_max: Optional[int] = None,
                 ngram_min: Optional[int] = None):
        if ngram_max is None:
            ngram_max = get_env("MXNET_DECODE_SPEC_NGRAM",
                                _DEFAULT_NGRAM_MAX, int, cache=False)
        self.ngram_max = max(1, int(ngram_max))
        self.ngram_min = max(1, min(int(ngram_min or _DEFAULT_NGRAM_MIN),
                                    self.ngram_max))

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        h = np.asarray(history, np.int64).ravel()
        n = int(h.size)
        k = int(k)
        if k <= 0 or n < self.ngram_min + 1:
            return _EMPTY
        for g in range(min(self.ngram_max, n - 1), self.ngram_min - 1, -1):
            tail = h[n - g:]
            # windows h[i:i+g] for i in 0..n-g-1 (the window at n-g IS
            # the tail itself — excluded); one vectorized compare, then
            # the LAST match = the most recent earlier occurrence
            windows = np.lib.stride_tricks.sliding_window_view(h, g)[:-1]
            hits = np.flatnonzero((windows == tail).all(axis=1))
            if hits.size:
                i = int(hits[-1])
                cont = h[i + g:i + g + k]
                if cont.size:
                    return cont.astype(np.int32)
        return _EMPTY


class ModelDraft(DraftProposer):
    """The served model as its own draft: greedy dense decode of the
    next ``k`` tokens through the model's no-cache oracle
    (``reference_generate``, on the params' device). Acceptance is ~100%
    by construction (the verify pass computes the same argmax), so this
    is the accept-all schedule for tests/benches and the template for
    plugging a genuinely smaller draft decoder behind the same interface
    — NOT a production win with the full-size model (it re-pays the
    model per drafted token)."""

    name = "model"

    def __init__(self, model, params):
        if model is None or not hasattr(model, "reference_generate"):
            raise MXNetError(
                "ModelDraft needs a model with reference_generate() "
                "(the no-cache greedy oracle); got %r" % (model,))
        self._model = model
        self._params = params

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        if k <= 0:
            return _EMPTY
        return np.asarray(
            self._model.reference_generate(self._params, history, int(k)),
            np.int32)


# -- the registry -----------------------------------------------------------
#: name -> factory(model, params) -> DraftProposer. Model-free drafts
#: ignore the arguments; model-backed ones capture them.
_DRAFTS: Dict[str, Callable] = {
    "prompt_lookup": lambda model, params: PromptLookupDraft(),
    "model": lambda model, params: ModelDraft(model, params),
}


def register_draft(name: str, factory: Callable) -> None:
    """Register a draft variant: ``factory(model, params)`` must return
    a :class:`DraftProposer`. Re-registering a name replaces it (tests
    swap in schedule-shaped drafts this way)."""
    _DRAFTS[str(name)] = factory


def available_drafts() -> List[str]:
    return sorted(_DRAFTS)


def make_draft(name: str, model=None, params=None) -> DraftProposer:
    """Instantiate the draft registered as ``name`` (the
    ``MXNET_DECODE_SPEC_DRAFT`` values) for one engine."""
    factory = _DRAFTS.get(str(name))
    if factory is None:
        raise MXNetError(
            "unknown speculative draft %r (registered: %s)"
            % (name, ", ".join(available_drafts())))
    draft = factory(model, params)
    if not isinstance(draft, DraftProposer):
        raise MXNetError(
            "draft factory %r returned %r, not a DraftProposer"
            % (name, type(draft).__name__))
    return draft


def sanitize(proposed, k: int, vocab_size: int) -> np.ndarray:
    """Clamp a draft's proposal to the engine's contract: at most ``k``
    tokens, all valid ids — the proposal is truncated at the first
    out-of-vocab token rather than letting a buggy draft index the
    embedding out of range. Wrongness is fine; invalidity is not."""
    arr = np.asarray(proposed, np.int64).ravel()[:max(0, int(k))]
    if arr.size == 0:
        return _EMPTY
    bad = np.flatnonzero((arr < 0) | (arr >= int(vocab_size)))
    if bad.size:
        arr = arr[:int(bad[0])]
    return arr.astype(np.int32)
