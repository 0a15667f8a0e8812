"""Token-level continuous batching: the LLM decode plane, on PyTorch/CUDA.

The port of ``mxnet_tpu/serving/decode.py``. A fixed number of decode
**slots** each hold one live sequence; every engine tick runs ONE decode
step over all slots (one new token per active slot), and the moment a
sequence finishes its slot is re-admitted from the queue. KV lives in the
paged pools of :mod:`~mxnet_tpu_torch.serving.kvcache`; attention reads
through the page table with the hand-written CUDA kernel of
:mod:`mxnet_tpu_torch.ops.paged_attention`.

Anatomy of a request (the same as the JAX plane's):

1. **submit** — prompt validated on the caller's thread; per-tenant and
   global bounded queues (shed with :class:`QueueFullError`) and a
   per-request deadline;
2. **admission** — weighted-fair pick over tenants, a free slot and a
   full worst-case page reservation (prompt + ``max_new_tokens``; an
   admitted sequence can always finish). With the prefix cache on
   (default) a matching prompt prefix maps shared pages into the slot,
   and the first divergent page is copied on write;
3. **prefill** — the prompt runs once, padded to a ladder rung, writes
   its KV into the reserved pages and yields the first token (TTFT). A
   prefix hit runs only the tail through :meth:`TinyDecoder.
   prefill_chunk`, whose attention is the paged kernel with a causal
   ``q_pos``. With **chunked prefill** (``prefill_chunk=C`` /
   ``MXNET_DECODE_PREFILL_CHUNK``) the prompt instead runs ``C`` tokens
   at a time through the same chunk path, ONE chunk per engine tick,
   round-robin over the prefilling slots, interleaved with the decode
   ticks of the other slots — a long prompt no longer stalls every
   in-flight sequence, and a short prompt is not stuck behind it;
4. **decode ticks** — one step per tick over all decoding slots: exactly
   ONE packed ``(5, S*W)`` host->device copy (tokens, positions,
   lengths, write pages, write offsets; the page table rides a
   version-keyed device copy re-sent only when admission or completion
   changes it), paged attention, greedy argmax on the device, and ONE
   fetch of the sampled tokens. W is 1, or ``spec_k + 1`` with
   **speculative decoding** (``spec_k`` / ``MXNET_DECODE_SPEC_K``): a
   draft (:mod:`.speculative`) proposes up to k tokens per slot, the
   tick verifies all k+1 positions at once through the multi-query CUDA
   kernel, and greedy rejection commits the longest agreeing prefix
   plus one — outputs stay token-for-token equal to sequential greedy
   decode;
5. **completion** — EOS or the token budget frees the pages and the slot
   admits the next queued sequence.

Where JAX threads donated pools through ``jit``, the port preallocates
the pools once and updates them in place. Where JAX compiles each device
path once per shape, the port captures it once as a CUDA graph on the
card: the decode tick at its width, each prefill rung, each chunk rung and
the copy-on-write page copy, each over static operands (a pinned host
buffer copied into a device tensor of fixed shape), the engine's own
parameter tensors and the pools, with the sampled token's argmax inside
the graph. ``warmup()`` captures them all before traffic; a path not
warmed is captured at its first use. ``compile_count`` counts the captured
paths as the JAX engine counts its jit caches, and ``stats()`` reports it
with ``steady_state_recompiles`` (captures since ``warmup()``, which stay
0). On the CPU (the tests) nothing is captured: each path runs eagerly
over the same static operands and is counted at its first run, so the
counts mean the same on both devices.

Resilience (chaos sites ``serving.decode``, ``serving.decode.prefill``,
``serving.decode.tenant.<id>``): prefill runs per sequence under the
retry policy, so a poisoned prompt fails only its own future; the decode
step retries transients, and a step that still fails evicts exactly the
sequences in flight (pools zeroed, slots reset) under one circuit
breaker whose open state sheds with :class:`EngineUnavailableError`.

Observability (:mod:`~mxnet_tpu_torch.telemetry`), at the JAX engine's
places: a sampled request (``MXNET_TRACE_SAMPLE``) carries a trace
minted at :meth:`DecodeEngine.submit` through every hop — enqueue,
admission-guard deferral verdicts, admission, prefill and its chunks,
prefix hits/CoW, every decode tick, the terminal — queryable by
``trace_id``; the flight recorder keeps each tick's in-flight request
set plus evictions/swaps/faults, and the worker's catch-all dumps it;
``stats()["alerts"]`` carries the live SLO engine's verdicts (the queue
depth is registered as its bound); and with ``MXNET_DEVPROF_SAMPLE`` > 0
each graph replay of a sampled tick is timed by a CUDA event pair under
the JAX site names ``serving.decode_step``, ``serving.decode_prefill``,
``serving.decode_prefill_chunk`` and ``serving.decode_cow``.

Memory (:mod:`~mxnet_tpu_torch.resilience.hbm`): the engine registers
its KV pools and its worst-case pending prefill with the HBM pressure
governor and consults the governor's ladder at every admission pass —
yellow sheds cached prefix pages, orange admits one sequence a pass and
defers ``batch``-class tenants, red admits nothing while in-flight
sequences keep decoding. A classified OOM (the allocator's
``torch.OutOfMemoryError``, or chaos ``action=oom``) latches the governor
red, evicts every sequence in flight (the pools are zeroed in place) and
re-admits at a governed count until the governor is green again.

Named weight variants (:meth:`DecodeEngine.register_variant`,
:meth:`DecodeEngine.use_variant`) are written into the served parameter
tensors in place, as :meth:`DecodeEngine.swap_params` is, so no graph is
captured again. :class:`~mxnet_tpu_torch.serving.fleet.FleetRouter` puts
several engines behind one door.

Ring prefill (``ring_prefill_len``, ``MXNET_DECODE_RING_PREFILL_LEN``):
a prompt of at least that many tokens takes the long-context route of
the JAX engine (``mxnet_tpu/serving/decode.py:1154``, ``:1301-1340``,
``:1488``, ``:1520-1551``): no prefix-cache match and no index insert, no
chunking, and an eager prefill outside the captured rungs (so no
capture, and ``steady_state_recompiles`` stays 0), whose attention is
``sequence_parallel.ring_attention`` over the process's local members
(:func:`ring_prefill_attention`). A process of the port drives one
device, so there the prefill keeps the model's own dense attention, as
the JAX engine does on one local device.
"""
from __future__ import annotations

import gc
import itertools
import logging
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resilience, telemetry
from ..telemetry import accounting as _accounting
from ..telemetry import devprof as _devprof
from ..telemetry import flightrec as _flightrec
from ..telemetry import slo as _slo
from ..telemetry import tracing as _tracing
from ..base import MXNetError, fetch_host, get_env, resolve_device
from ..ops import paged_attention as _pa
from ..resilience import CircuitBreaker, chaos
from ..resilience import hbm as _hbm
from .batcher import (EngineUnavailableError, QueueFullError,
                      RequestTimeoutError, ServerClosedError)
from .buckets import select_bucket
from .kvcache import PagedKVCache, PrefixMatch, write_kv
from .speculative import make_draft, sanitize
from .stats import ServingStats
from .tenancy import (PRIORITY_CLASSES, SHARED_TENANT, Tenant,
                      TenantRegistry, TenantUnavailableError,
                      WeightedFairQueue)

__all__ = ["DecodeEngine", "PagedDecodeModel", "TinyDecoder",
           "params_from_jax"]

_log = logging.getLogger(__name__)

_DEFAULT_SLOTS = 8
_DEFAULT_MAX_SEQ_LEN = 256
_DEFAULT_PREFILL_BUCKETS = "16,64"
_DEFAULT_TIMEOUT_MS = 10000.0
_DEFAULT_QUEUE_DEPTH = 256
_DEFAULT_PREFIX_CACHE = 1  # sharing is exact by construction: default on
_DEFAULT_PREFILL_CHUNK = 0  # 0 = monolithic prefill (one rung per prompt)

_T_TOKENS = telemetry.counter(
    "mxnet_decode_tokens_total",
    "output tokens generated by the decode plane",
    labels=("server",))
_T_OCCUPANCY = telemetry.gauge(
    "mxnet_decode_slot_occupancy",
    "active decode slots over total slots, most recent tick",
    labels=("server",))
_T_EVENTS = telemetry.counter(
    "mxnet_decode_events_total",
    "decode engine lifecycle events (prefill, admitted, completed, "
    "evicted, shed_open_breaker, shed_tenant_breaker, deadline_evicted, "
    "weight_swap, cow_copy)",
    labels=("server", "event"))


#: capture streams given back by released engines, per device. cuBLAS
#: keeps a workspace for every stream it ran on for the life of the
#: process (32 MiB on Hopper), so an engine rebuilt in place of a released
#: one captures on its predecessor's stream instead of growing the card's
#: reserved memory by a workspace a rebuild.
_FREE_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


def _take_stream(device: torch.device):
    with _STREAMS_LOCK:
        free = _FREE_STREAMS.get(device)
        if free:
            return free.pop()
    return torch.cuda.Stream(device)


def _give_stream(device: torch.device, stream) -> None:
    with _STREAMS_LOCK:
        _FREE_STREAMS.setdefault(device, []).append(stream)


def _tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a dict/list param tree."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_sig(tree):
    """(shape, dtype) signature of a param tree: a swap must keep it."""
    return _tree_map(lambda x: (tuple(x.shape), str(x.dtype)), tree)


def _tree_copy(dst, src):
    """Copy every leaf of ``src`` into the same leaf of ``dst``, in place:
    the captured paths keep reading ``dst``'s tensors."""
    if isinstance(dst, dict):
        for k in dst:
            _tree_copy(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, x in zip(dst, src):
            _tree_copy(d, x)
    else:
        dst.copy_(src)


class _Feed:
    """A static int32 device operand and the host buffer that fills it:
    one host-to-device copy a pass. On the card the buffer is pinned and
    the copy asynchronous, so :meth:`put` first waits for the previous
    copy out of the buffer (not for the work queued behind it)."""

    def __init__(self, numel: int, device: torch.device):
        cuda = device.type == "cuda"
        self.host = torch.zeros(numel, dtype=torch.int32, pin_memory=cuda)
        self.dev = torch.zeros(numel, dtype=torch.int32, device=device)
        self._sent = torch.cuda.Event() if cuda else None

    def put(self, values) -> None:
        if self._sent is not None:
            self._sent.synchronize()
        self.host.numpy()[:] = np.asarray(values, np.int32).ravel()
        self.dev.copy_(self.host, non_blocking=True)
        if self._sent is not None:
            self._sent.record(torch.cuda.current_stream(self.dev.device))


class _Path:
    """One device path of the engine at one shape, keyed ``(kind, rows or
    rung)``: its static operand, the function over it (which reads only
    the operand, the engine's parameters and the pools, and returns the
    path's device output) and, on the card, the CUDA graph captured from
    it with that output and the kernel launches the graph replays."""

    __slots__ = ("key", "feed", "fn", "ready", "graph", "out", "launches")

    def __init__(self, key, feed: _Feed, fn):
        self.key = key
        self.feed = feed
        self.fn = fn
        self.ready = False     # captured (the card) or run once (the CPU)
        self.graph = None
        self.out = None
        self.launches = (0, 0)


def params_from_jax(tree, device=None):
    """The port's param dict from the JAX package's (leaves converted to
    numpy, e.g. by ``jax.device_get``): same keys and layouts — ``embed``,
    ``layers[i].{ln1,wq,wk,wv,wo,ln2,w1,w2}``, ``lnf``, ``unembed`` — as
    float32 tensors on ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return _tree_map(
        lambda x: torch.tensor(np.asarray(x, np.float32), device=dev), tree)


class PagedDecodeModel:
    """Contract a model serves decode through: functions over the paged
    cache that update the pools IN PLACE and return logits.

    Attributes the engine sizes the cache from: ``num_layers``,
    ``num_heads``, ``num_kv_heads``, ``head_dim``, ``vocab_size``.
    """

    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    vocab_size: int

    def decode(self, params, tokens, positions, k_pool, v_pool,
               page_tables, seq_lens, write_pages, write_offsets):
        """W query rows per slot (W = 1, or ``spec_k + 1`` in a
        speculative verify tick, where slot s owns rows ``s*W ..
        s*W+W-1``): ``tokens``/``positions``/``seq_lens``/``write_*`` are
        ``(S*W,)``, ``page_tables`` ``(S, max_pages)`` (one row per slot,
        so ``W = rows // S``). ``seq_lens`` INCLUDES the row's own token.
        Inactive slots and unused draft rows carry ``seq_len 0`` and the
        null write page; their logits are garbage the engine ignores.
        Returns logits ``(S*W, vocab)``."""
        raise NotImplementedError

    def prefill(self, params, tokens, length, k_pool, v_pool,
                write_pages, write_offsets, attn=None):
        """Whole prompt in one pass: ``tokens`` ``(T,)`` padded to a
        ladder rung, ``length`` the real token count, ``write_*`` ``(T,)``
        (padding rows target the null page). ``attn(q, k, v, scale)``
        replaces the dense causal attention (the ring prefill's). Returns
        the last real token's logits ``(vocab,)``.

        The engine passes every scalar (``length`` here, ``start`` and
        ``length`` of :meth:`prefill_chunk`) as a 0-d int32 tensor on the
        device, and runs each of these functions as a captured CUDA graph
        on the card: a model reads no host value of its operands and
        synchronises nothing. Direct callers may pass ints."""
        raise NotImplementedError

    def prefill_chunk(self, params, tokens, start, length, k_pool, v_pool,
                      page_table_row, write_pages, write_offsets):
        """One chunk of one sequence, attending THROUGH the page table:
        ``tokens`` ``(C,)`` padded to a rung at absolute positions
        ``start .. start+C-1``, ``page_table_row`` ``(max_pages,)`` the
        slot's row. Writes the chunk's K/V at ``write_*`` (already-cached
        positions and padding target the null page), then attends each
        query over the sequence's pages. Returns the last real token's
        logits ``(vocab,)``."""
        raise NotImplementedError


#: process-wide request ids for the flight recorder's per-tick in-flight
#: set — ALWAYS minted (unlike trace ids, which are sampled): the black
#: box must identify every sequence on the failing tick, not just the
#: sampled ones. itertools.count.__next__ is GIL-atomic — no lock.
_RID = itertools.count(1)


class _DecodeRequest:
    __slots__ = ("prompt", "max_new", "eos_id", "future", "t_submit",
                 "deadline", "tokens", "last_t", "slot", "tenant",
                 "match", "kv_cached", "filled", "prefilling", "seq",
                 "epoch", "rid", "trace")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 eos_id: Optional[int], deadline: Optional[float],
                 tenant: Tenant):
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = deadline
        self.tokens: List[int] = []
        self.last_t = 0.0
        self.slot = -1
        self.tenant = tenant
        # prefix-cache / chunked-prefill state: the admission-time match
        # (stashed by the guard), how many prompt tokens' KV came from
        # shared pages, the next position the chunk scheduler processes,
        # whether prefill is still in flight, and the admission order
        # the chunk lane round-robins over
        self.match: Optional[PrefixMatch] = None
        self.kv_cached = 0
        self.filled = 0
        self.prefilling = False
        self.seq = 0
        self.epoch = 0  # weight-swap epoch at prefill start (stale guard)
        self.rid = next(_RID)
        # the sampled request trace (None = unsampled: every hop's
        # tracing.event() is then a single `is None` check)
        self.trace: Optional[_tracing.Trace] = None


class DecodeEngine:
    """Continuous-batching decode service over one :class:`PagedDecodeModel`.

    ``submit(prompt, max_new_tokens)`` from any thread returns a Future of
    the generated token ids (``np.int32``, EOS included when hit). One
    engine thread runs the admit/step/complete loop; sampling is greedy
    argmax on the device. ``device`` is the card unless ``device="cpu"``
    (no card and no such request raises :class:`MXNetError`); the params
    are moved there. ``name`` keys the stats series, the breaker site and
    the kv-cache gauges; keep it unique among live engines.
    """

    def __init__(self, model: PagedDecodeModel, params,
                 num_slots: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 queue_depth: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 ring_prefill_len: Optional[int] = None,
                 name: str = "decode", retry_policy=None,
                 breaker_threshold: Optional[int] = None,
                 breaker_reset_s: Optional[float] = None,
                 dtype="float32", tenants=None,
                 prefix_cache: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 spec_k: Optional[int] = None,
                 spec_draft=None, device=None):
        if ring_prefill_len is None:
            ring_prefill_len = get_env("MXNET_DECODE_RING_PREFILL_LEN", 0,
                                       int, cache=False)
        self._ring_len = max(0, int(ring_prefill_len))
        self.device = resolve_device(device)
        self._model = model
        # the engine's own parameter tensors, which the captured paths read
        # (a swap copies into them): never the caller's
        self._params = _tree_map(lambda x: x.to(self.device, copy=True),
                                 params)
        if num_slots is None:
            num_slots = get_env("MXNET_DECODE_SLOTS", _DEFAULT_SLOTS, int,
                                cache=False)
        if max_seq_len is None:
            max_seq_len = get_env("MXNET_DECODE_MAX_SEQ_LEN",
                                  _DEFAULT_MAX_SEQ_LEN, int, cache=False)
        if queue_depth is None:
            queue_depth = get_env("MXNET_SERVING_QUEUE_DEPTH",
                                  _DEFAULT_QUEUE_DEPTH, int, cache=False)
        if timeout_ms is None:
            timeout_ms = get_env("MXNET_SERVING_TIMEOUT_MS",
                                 _DEFAULT_TIMEOUT_MS, float, cache=False)
        if prefix_cache is None:
            prefix_cache = bool(get_env("MXNET_DECODE_PREFIX_CACHE",
                                        _DEFAULT_PREFIX_CACHE, int,
                                        cache=False))
        if prefill_chunk is None:
            prefill_chunk = get_env("MXNET_DECODE_PREFILL_CHUNK",
                                    _DEFAULT_PREFILL_CHUNK, int,
                                    cache=False)
        if spec_k is None:
            spec_k = get_env("MXNET_DECODE_SPEC_K", 0, int, cache=False)
        self.num_slots = max(1, int(num_slots))
        self.max_seq_len = int(max_seq_len)
        self._queue_depth = max(1, int(queue_depth))
        self._timeout_s = float(timeout_ms) / 1e3
        self._prefix_cache = bool(prefix_cache)
        self._chunk = max(0, min(int(prefill_chunk), self.max_seq_len))
        # speculative decoding: the step carries a fixed width of
        # spec_k+1 query rows per slot (committed token + up to k draft
        # rows). k=0 keeps the classic 1-row tick (the packed operand is
        # then (5, S) exactly as before). Per-tick draft depth,
        # acceptance and per-tenant caps vary only the DATA inside it.
        self._spec_k = max(0, int(spec_k))
        self._spec_w = self._spec_k + 1
        if self._spec_k == 0:
            self._draft = None
        elif spec_draft is not None and not isinstance(spec_draft, str):
            self._draft = spec_draft   # a DraftProposer instance
        else:
            if spec_draft is None:
                spec_draft = get_env("MXNET_DECODE_SPEC_DRAFT",
                                     "prompt_lookup", str, cache=False)
            self._draft = make_draft(spec_draft, model, self._params)
        self._ladder = self._prefill_ladder(prefill_buckets)
        # the chunk path's rungs: chunked prefill uses ONE rung (the
        # chunk size); with chunking off the prefix-cache tail pads to
        # the prefill ladder instead
        if self._chunk:
            self._chunk_rungs: tuple = (self._chunk,)
        elif self._prefix_cache:
            self._chunk_rungs = self._ladder
        else:
            self._chunk_rungs = ()
        self._cache = PagedKVCache(
            self.num_slots, self.max_seq_len, model.num_layers,
            model.num_kv_heads, model.head_dim, page_size=page_size,
            num_pages=num_pages, dtype=dtype, name=name,
            prefix_cache=self._prefix_cache, device=self.device)
        self._stats = ServingStats(name)
        self._name = name
        self._retry = retry_policy
        self._breaker = CircuitBreaker(
            "serving.%s.decode" % name, failure_threshold=breaker_threshold,
            reset_timeout_s=breaker_reset_s)
        # multi-tenant control plane: registry (tenants= is a
        # TenantRegistry, a MXNET_TENANTS-style spec string, or None =
        # the env spec), weighted-fair sub-queues costed in worst-case
        # tokens so weights apportion token throughput
        if isinstance(tenants, TenantRegistry):
            self._tenants = tenants
        else:
            self._tenants = TenantRegistry(
                server=name, spec=tenants,
                max_cost=float(self.max_seq_len),
                default_queue_depth=self._queue_depth)
        self._wfq = WeightedFairQueue(
            self._tenants,
            cost_fn=lambda r: float(int(r.prompt.size) + r.max_new))
        # the SLO engine's burn ratios divide by bounds the registry
        # cannot carry — register this engine's queue capacity
        _slo.note_bound("queue_depth", name, self._queue_depth)
        # HBM pressure governor: register this engine's worst-case byte
        # bounds and consult the degradation ladder at admission (see
        # _admit/_admit_guard). The KV pools are allocated once, so
        # their bound is a constant; pending prefill is a callable bound
        # — every queued request may reserve up to max_seq_len of pages
        # (total_queued() reads one int, safe from any thread).
        self._governor = _hbm.governor()
        pool_bytes = int(self._cache.k_pool.nbytes
                         + self._cache.v_pool.nbytes)
        self._governor.register_bound("serving.%s.kv_pool" % name,
                                      pool_bytes)
        page_bytes = pool_bytes // max(1, self._cache.num_pages)
        worst_pages = self._cache.pages_for(self.max_seq_len)
        self._governor.register_bound(
            "serving.%s.pending_prefill" % name,
            lambda: self._wfq.total_queued() * worst_pages * page_bytes)
        #: post-OOM governed re-admission cap (admit FEWER sequences at
        #: the same slot shapes); None = ungoverned. Worker-only.
        self._governed_limit: Optional[int] = None
        #: the tier _admit observed this pass; _admit_guard (same worker
        #: pass, under _cv) reads it for the orange batch-defer rung
        self._tick_tier = "green"
        self._params_sig = _tree_sig(self._params)
        self._pending_swaps: List[tuple] = []
        self._variants: dict = {}
        self._active_variant: Optional[str] = None
        self._swaps = 0
        self._deadline_evictions = 0
        # the page table's static device copy, re-sent when the allocator
        # moved its version; the captured paths, keyed (kind, size); the
        # capture count at warmup (None before it) and the replays
        self._pt = _Feed(self.num_slots * self._cache.max_pages, self.device)
        self._pt_version = -1
        self._paths: dict = {}
        self._captures = 0
        self._warm_compiles: Optional[int] = None
        self._replays = 0
        self._capture_stream = None
        self._calls: List[tuple] = []  # (fn, Future) for the worker
        # the ring prefill's mesh: this process's local members (its one
        # device), as the JAX engine rings over its local devices
        from .. import _dist, parallel
        self._ring_mesh = parallel.Mesh([(_dist.rank(), self.device)],
                                        ("sp",))

        self._slots: List[Optional[_DecodeRequest]] = \
            [None] * self.num_slots
        self._cv = threading.Condition()
        self._closed = False
        self._tokens_total = 0
        self._prefills = 0
        self._evictions = 0
        self._occ_sum = 0.0
        self._ticks = 0
        # speculation accounting (worker-confined): draft tokens
        # proposed/accepted, and the accepted-per-tick numerator/
        # denominator over SPECULATING slot-ticks only
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_new = 0         # tokens committed by speculating slots
        self._spec_slot_ticks = 0  # slot-ticks where a draft was in play
        self._cow_copies = 0   # written/read under _cv only
        self._admit_seq = 0    # admission order among prefilling slots
        self._rr_last = 0      # round-robin cursor over that order
        self._swap_epoch = 0   # worker-confined; bumps per applied swap
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="mxnet-decode-" + name)
        self._thread.start()

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    def _sync_page_table(self):
        """Copy the page table into its static device tensor when the
        allocator mutated it (admission/free) — steady ticks with stable
        membership skip the transfer entirely."""
        ver = self._cache.version
        if self._pt_version != ver:
            self._pt.put(self._cache.page_table)
            self._pt_version = ver

    def _prefill_ladder(self, buckets):
        if buckets is None:
            raw = get_env("MXNET_DECODE_PREFILL_BUCKETS",
                          _DEFAULT_PREFILL_BUCKETS, str, cache=False)
            try:
                buckets = [int(t) for t in str(raw).split(",") if t.strip()]
            except ValueError:
                raise MXNetError("MXNET_DECODE_PREFILL_BUCKETS must be "
                                 "comma-separated ints, got %r" % (raw,))
        ladder = sorted({int(b) for b in buckets if int(b) > 0})
        if not ladder:
            raise MXNetError("empty prefill bucket ladder")
        # the top rung must cover every admissible prompt: cap the ladder
        # with max_seq_len so select_bucket never under-sizes a pad
        ladder = [b for b in ladder if b < self.max_seq_len]
        ladder.append(self.max_seq_len)
        return tuple(ladder)

    # ------------------------------------------------------------------
    # client side
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               eos_id: Optional[int] = None,
               timeout_ms: Optional[float] = None,
               tenant: Optional[str] = None) -> Future:
        """Enqueue one sequence; returns a Future resolving to the
        generated ``np.int32`` token ids. Thread-safe. ``timeout_ms``
        bounds the WHOLE request — queue wait and generation: a sequence
        whose deadline expires mid-decode is evicted at the next tick
        boundary (pages freed, future fails with
        :class:`RequestTimeoutError`); ``<= 0`` disables. ``tenant``
        names the submitting tenant; untagged callers ride ``default``."""
        arr = np.asarray(prompt, np.int32).ravel()
        if arr.size < 1:
            raise MXNetError("decode submit needs >= 1 prompt token")
        if arr.min() < 0 or arr.max() >= self._model.vocab_size:
            # an out-of-range id would index past the embedding on the
            # device (a device-side fault on the card): refuse it here
            raise MXNetError("prompt token ids must lie in [0, %d)"
                             % self._model.vocab_size)
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        if arr.size + max_new > self.max_seq_len:
            raise MXNetError(
                "prompt %d + max_new %d exceeds max_seq_len %d"
                % (arr.size, max_new, self.max_seq_len))
        # a worst-case reservation larger than the WHOLE pool — or than
        # the tenant's own page budget / rate burst — could never be
        # admitted: reject it at the door instead
        total = int(arr.size) + max_new
        need = self._cache.pages_for(total)
        capacity = self._cache.num_pages - 1
        tobj = self._tenants.resolve(tenant)
        # the trace is minted HERE — at submit(), the contract — so
        # EVERY door-reject (pool capacity, budgets, breaker) and shed
        # leaves a queryable chain too
        trace = _tracing.start_trace("decode", self._name, tobj.tenant_id)
        _tracing.event(trace, "submit", prompt_tokens=int(arr.size),
                       max_new=max_new)
        if need > capacity:
            _tracing.finish(trace, "rejected", reason="pool_capacity")
            raise MXNetError(
                "prompt %d + max_new %d needs %d KV pages but the pool "
                "only has %d: raise MXNET_KVCACHE_PAGES or shrink the "
                "request" % (arr.size, max_new, need, capacity))
        if tobj.page_budget is not None and need > tobj.page_budget:
            _tracing.finish(trace, "rejected", reason="page_budget")
            raise MXNetError(
                "request needs %d KV pages but tenant %r's page budget "
                "is %d: it could never be admitted"
                % (need, tobj.tenant_id, tobj.page_budget))
        if tobj.rate > 0.0 and total > tobj.burst:
            _tracing.finish(trace, "rejected", reason="burst_budget")
            raise MXNetError(
                "request costs %d tokens but tenant %r's burst budget "
                "is %.0f: it could never be admitted"
                % (total, tobj.tenant_id, tobj.burst))
        state = tobj.breaker.state
        if state == "open":
            # the tenant's own breaker is open: shed THIS tenant at the
            # door while every other tenant keeps flowing
            tobj.stats.on_shed(breaker=True)
            _T_EVENTS.inc(server=self._name, event="shed_tenant_breaker")
            _tracing.finish(trace, "shed", reason="tenant_breaker")
            raise TenantUnavailableError(tobj.tenant_id, state)
        timeout_s = (self._timeout_s if timeout_ms is None
                     else float(timeout_ms) / 1e3)
        deadline = (None if timeout_s <= 0
                    else time.perf_counter() + timeout_s)
        req = _DecodeRequest(arr, max_new, eos_id, deadline, tobj)
        req.trace = trace
        shed = None
        depth = gdepth = 0
        with self._cv:
            if self._closed:
                raise ServerClosedError("submit() on a closed DecodeEngine")
            if len(tobj.queue) >= tobj.queue_depth:
                shed = "tenant %r queue full (depth %d): request shed " \
                       "before the global queue" \
                       % (tobj.tenant_id, tobj.queue_depth)
            elif self._wfq.total_queued() >= self._queue_depth:
                shed = "decode queue full (depth %d): request shed" \
                       % self._queue_depth
            else:
                depth = self._wfq.push(tobj, req)
                gdepth = self._wfq.total_queued()
                self._cv.notify_all()
        if shed:
            self._stats.on_shed()
            tobj.stats.on_shed()
            _tracing.finish(trace, "shed", reason="queue_full")
            raise QueueFullError(shed)
        _tracing.event(trace, "enqueue", rid=req.rid, tenant_depth=depth,
                       queue_depth=gdepth)
        self._stats.on_submit(gdepth)
        tobj.stats.on_submit(depth)
        return req.future

    def generate(self, prompt, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None,
                 timeout: Optional[float] = None,
                 tenant: Optional[str] = None) -> np.ndarray:
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(prompt, max_new_tokens, eos_id=eos_id,
                           tenant=tenant).result(timeout)

    # ------------------------------------------------------------------
    # live weight swap
    # ------------------------------------------------------------------
    def swap_params(self, params, variant: Optional[str] = None,
                    wait: bool = True,
                    timeout: Optional[float] = None) -> Future:
        """Hot-swap the served weights between ticks — zero dropped
        requests. The new tree must carry the SAME (structure, shape,
        dtype) signature as the current one. In-flight sequences keep
        their slots and KV pages and continue under the new weights from
        the next tick; the prefix index is flushed (its KV was computed
        under the old weights). Returns a Future resolving True once a
        tick boundary applied the swap (``wait=True`` blocks on it)."""
        params = _tree_map(lambda x: x.to(self.device), params)
        if _tree_sig(params) != self._params_sig:
            raise MXNetError(
                "swap_params: new param tree signature differs from the "
                "served one (tree structure, leaf shape or dtype)")
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise ServerClosedError("swap_params() on a closed engine")
            self._pending_swaps.append((params, variant, fut))
            self._cv.notify_all()
        if wait:
            fut.result(timeout)
        return fut

    def register_variant(self, name: str, params) -> None:
        """Register a named fine-tuned variant (same architecture) for
        :meth:`use_variant` — N variants served from ONE engine, written
        into the served parameter tensors between ticks."""
        params = _tree_map(lambda x: x.to(self.device), params)
        if _tree_sig(params) != self._params_sig:
            raise MXNetError(
                "variant %r: param signature differs from the served "
                "model" % name)
        self._variants[str(name)] = params

    def use_variant(self, name: str, wait: bool = True,
                    timeout: Optional[float] = None) -> Future:
        """Swap a registered variant live (see :meth:`swap_params`)."""
        if name not in self._variants:
            raise MXNetError("unknown variant %r (registered: %s)"
                             % (name, sorted(self._variants) or "none"))
        return self.swap_params(self._variants[name], variant=str(name),
                                wait=wait, timeout=timeout)

    @property
    def active_variant(self) -> Optional[str]:
        with self._cv:
            return self._active_variant

    def warmup(self) -> int:
        """Capture every device path before traffic — the decode step at
        its width (``spec_k + 1`` rows per slot when speculating), every
        prefill rung (none in chunked mode, which never runs them), every
        chunk rung and the CoW copy — each first run eagerly over
        operands whose writes aim at the null page only. That pass also
        builds the CUDA kernels (nvcc at first use) and warms cuBLAS, so
        the first request pays none of it. Anchors the steady-state
        recompile gauge at 0: a cold first shared-prefix request captures
        NOTHING. Runs on the engine's worker thread, between ticks.
        Returns the compile count (:attr:`compile_count`)."""
        return self._on_worker(self._warmup)

    def _warmup(self) -> int:
        cache = self._cache
        rows = self.num_slots * self._spec_w
        packed = np.zeros((5, rows), np.int32)
        packed[3], packed[4] = cache.null_write_slots(rows)
        self._sync_page_table()
        self._run(self._path(("step", rows)), packed)
        if not self._chunk:
            # chunked mode never dispatches the monolithic rungs — every
            # prompt runs through the one chunk rung captured below
            for rung in self._ladder:
                pre = np.zeros((3, rung), np.int32)
                pre[1], pre[2] = cache.null_write_slots(rung)
                self._run(self._path(("prefill", rung)), pre, [1])
        null_row = np.zeros(cache.max_pages, np.int32)
        for rung in self._chunk_rungs:
            pre = np.zeros((3, rung), np.int32)
            pre[1], pre[2] = cache.null_write_slots(rung)
            self._run(self._path(("chunk", rung)), pre, null_row, [0, 1])
        if self._prefix_cache:
            self._run(self._path(("cow", 1)), [0, 0])  # null -> null
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        count = self.compile_count
        self._warm_compiles = count
        _accounting.set_steady_state_recompiles("serving." + self._name, 0)
        return count

    @property
    def compile_count(self) -> int:
        """Device paths captured so far: on the card, CUDA graphs; on the
        CPU, paths that have run. The counterpart of the JAX engine's
        summed jit cache sizes."""
        return self._captures

    def _on_worker(self, fn):
        """Run ``fn()`` on the engine's worker thread between ticks and
        return its result. Every CUDA call of the engine comes from that
        one thread, so a capture never races a tick; the captures also use
        ``capture_error_mode="thread_local"``, so CUDA work of other
        threads (a caller's own kernels, the copy a ``swap_params`` makes)
        cannot invalidate them."""
        if threading.current_thread() is self._thread:
            return fn()
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise ServerClosedError("engine is closed")
            self._calls.append((fn, fut))
            self._cv.notify_all()
        while True:
            try:
                return fut.result(timeout=1.0)
            except FutureTimeout:
                if not self._thread.is_alive():
                    raise MXNetError("DecodeEngine %r: the worker thread "
                                     "died before it ran the call"
                                     % self._name)

    def _path(self, key) -> _Path:
        """The path ``key`` = ``(kind, size)``, made (not yet captured) at
        its first request: ``("step", S*W)``, ``("prefill", rung)``,
        ``("chunk", rung)`` or ``("cow", 1)``."""
        path = self._paths.get(key)
        if path is None:
            path = self._paths[key] = self._make_path(key)
        return path

    def _make_path(self, key) -> _Path:
        kind, n = key
        model, params, cache = self._model, self._params, self._cache
        mp = cache.max_pages
        if kind == "step":
            # rows: tokens, positions, seq_lens, write pages, offsets
            feed = _Feed(5 * n, self.device)

            def fn():
                d = feed.dev.view(5, n)
                logits = model.decode(
                    params, d[0], d[1], cache.k_pool, cache.v_pool,
                    self._pt.dev.view(self.num_slots, mp), d[2], d[3], d[4])
                return torch.argmax(logits, dim=-1)
        elif kind == "prefill":
            # tokens, write pages, write offsets; then the length
            feed = _Feed(3 * n + 1, self.device)

            def fn():
                d = feed.dev
                pre = d[:3 * n].view(3, n)
                last = model.prefill(params, pre[0], d[3 * n], cache.k_pool,
                                     cache.v_pool, pre[1], pre[2])
                return torch.argmax(last)
        elif kind == "chunk":
            # tokens, write pages, write offsets; the slot's page row;
            # then start and length, side by side (the kernel reads the
            # pair where it lies)
            feed = _Feed(3 * n + mp + 2, self.device)

            def fn():
                d = feed.dev
                pre = d[:3 * n].view(3, n)
                o = 3 * n + mp
                last = model.prefill_chunk(
                    params, pre[0], d[o], d[o + 1], cache.k_pool,
                    cache.v_pool, d[3 * n:o], pre[1], pre[2])
                return torch.argmax(last)
        elif kind == "cow":
            feed = _Feed(2, self.device)  # source page, destination page

            def fn():
                idx = feed.dev.long()
                for pool in (cache.k_pool, cache.v_pool):
                    pool.index_copy_(1, idx[1:], pool.index_select(1, idx[:1]))
        else:
            raise MXNetError("unknown device path %r" % (key,))
        return _Path(key, feed, fn)

    def _run(self, path: _Path, *operand, site: Optional[str] = None):
        """Fill ``path``'s static operand from ``operand`` (host arrays,
        concatenated) and run the path: on the card, replay its graph
        (captured here at the path's first run); on the CPU, call its
        function. Returns the path's device output, which the caller reads
        before the next run. Chaos and the retry policy stay around
        this call, on the host. ``site`` names the dispatch for devprof
        and the ``jit.compile`` chaos site (the JAX engine's ``jit_call``
        sites); ``warmup()`` passes none, as the JAX engine calls its
        jits bare there."""
        path.feed.put(np.concatenate(
            [np.asarray(a, np.int32).ravel() for a in operand]))
        return self._replay(path, site)

    def _replay(self, path: _Path, site: Optional[str] = None):
        probe = None
        if site is not None:
            if chaos.ENABLED:
                chaos.maybe_fail("jit.compile")
            hook = _accounting._DEVPROF_HOOK
            # a first run captures: its cost is compile cost, never timed
            if hook is not None and path.ready:
                probe = hook(site, self.device)
        if not path.ready:
            self._capture(path)
        if path.graph is None:  # the CPU: no graphs
            out = path.fn()
        else:
            path.graph.replay()
            _pa.add_launches(path.launches)
            self._replays += 1
            out = path.out
        if probe is not None:
            probe.stop()
        return out

    def _capture(self, path: _Path):
        """Capture ``path`` as a CUDA graph (on the CPU, only count it).
        One eager pass on the capture stream comes first, as PyTorch asks:
        it launches each kernel once (building it at first use) and makes
        the verify kernel's arrival counters on that stream. The graph has
        a memory pool of its own, so no other graph's replay reuses its
        output. A capture that fails raises: the path is never served
        eagerly instead."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            if self._capture_stream is None:
                self._capture_stream = _take_stream(self.device)
            stream = self._capture_stream
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                path.fn()
            torch.cuda.current_stream(self.device).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            before = _pa.launch_counts()
            # no garbage collection inside the capture: a collection on
            # this thread could destroy an unreachable engine's graph
            # here, a call a thread_local capture refuses on its own
            # thread (the capture is then invalidated); torch.cuda.graph
            # collects once before it begins
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, stream=stream,
                                      capture_error_mode="thread_local"):
                    out = path.fn()
            except Exception as exc:
                raise MXNetError(
                    "DecodeEngine %r: capturing the %s path %r as a CUDA "
                    "graph failed: %s" % (self._name, path.key[0], path.key,
                                          exc)) from exc
            finally:
                if collecting:
                    gc.enable()
                # the capture ran the wrappers but launched nothing
                after = _pa.launch_counts()
                launches = (after[0] - before[0], after[1] - before[1])
                _pa.add_launches(launches, -1)
            path.graph, path.out, path.launches = graph, out, launches
        path.ready = True
        self._captures += 1
        _accounting.note_recompile("serving." + self._name, 1,
                                   time.perf_counter() - t0)

    def queue_depth(self) -> int:
        """Requests queued but not yet slotted."""
        with self._cv:
            return self._wfq.total_queued()

    def kvcache_stats(self) -> dict:
        """The paged pool's counters alone (pages in use/free, prefix
        hit ratio) — the cheap subset of :meth:`stats`."""
        return self._cache.stats()

    def stats(self) -> dict:
        out = self._stats.snapshot()
        with self._cv:
            active = sum(1 for r in self._slots if r is not None)
            out.update({
                "slots": self.num_slots,
                "active_slots": active,
                "queued": self._wfq.total_queued(),
                "tokens_generated": self._tokens_total,
                "prefills": self._prefills,
                "evictions": self._evictions,
                "deadline_evictions": self._deadline_evictions,
                "ticks": self._ticks,
                "slot_occupancy": (self._occ_sum / self._ticks
                                   if self._ticks else 0.0),
                "prefill_buckets": list(self._ladder),
                "prefill_chunk": self._chunk,
                "cow_copies": self._cow_copies,
                "breaker": self._breaker.state,
                "weight_swaps": self._swaps,
                "active_variant": self._active_variant,
                "device": str(self.device),
                # process-wide launches of the paged-attention kernels,
                # those the engine's graph replays made included
                "kernel_launches": _pa.ragged_paged_attention.launches,
                "spec_kernel_launches": _pa.ragged_spec_attention.launches,
                "graph_replays": self._replays,
                "speculative": {
                    "k": self._spec_k,
                    "draft": (getattr(self._draft, "name", None)
                              if self._draft is not None else None),
                    "proposed_tokens": self._spec_proposed,
                    "accepted_tokens": self._spec_accepted,
                    "acceptance_rate": (self._spec_accepted /
                                        self._spec_proposed
                                        if self._spec_proposed else 0.0),
                    # tokens committed per SPECULATING slot-tick (1.0 =
                    # drafts never helped; k+1 = every draft accepted)
                    "accepted_per_tick": (self._spec_new /
                                          self._spec_slot_ticks
                                          if self._spec_slot_ticks else 0.0),
                },
            })
            governed = self._governed_limit
        out["tenants"] = self._tenants.snapshot()
        out["kvcache"] = self._cache.stats()
        # the governor's verdict rides every stats snapshot (the fleet's
        # replica rows and /debug/state read it from here)
        hv = self._governor.healthz_view()
        hv["governed_limit"] = governed
        hv["pressure_sheds"] = self._cache.pressure_sheds
        out["hbm"] = hv
        out["prefix_cache_enabled"] = self._prefix_cache
        if self._prefix_cache:
            out["prefix_hit_ratio"] = out["kvcache"]["prefix_hit_ratio"]
            # refcount>1 pages belong to the `shared` pseudo-tenant: no
            # real tenant's budget is charged for them
            out["tenants"][SHARED_TENANT] = {
                "pseudo": True,
                "pages_in_use_now": out["kvcache"]["shared_pages"],
                "pages_cached": out["kvcache"]["pages_cached"],
            }
        count = self.compile_count
        out["compile_count"] = count
        if self._warm_compiles is not None:
            steady = count - self._warm_compiles
            out["steady_state_recompiles"] = steady
            _accounting.set_steady_state_recompiles(
                "serving." + self._name, steady)
        # live SLO verdicts over the series this snapshot just refreshed
        out["alerts"] = _slo.evaluate()
        return out

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> int:
        """Stop intake; ``drain=True`` finishes every queued AND admitted
        sequence first, ``drain=False`` fails them with
        :class:`ServerClosedError` now. Idempotent. Returns the number of
        requests that completed during the drain (0 for ``drain=False``
        and for repeat closes)."""
        before = self._stats.completed
        with self._cv:
            self._closed = True
            dropped: List[_DecodeRequest] = []
            if not drain:
                dropped = [req for _t, req in self._wfq.drain()]
                for i, req in enumerate(self._slots):
                    if req is not None:
                        dropped.append(req)
                        self._slots[i] = None
                        self._release_slot(i, req)
            self._cv.notify_all()
        exc = ServerClosedError("engine closed before completion")
        for req in dropped:
            self._fail(req, exc)
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)
        # the governor outlives the engine (process-global): replace the
        # live-state bounds with zeros so a closed engine neither skews
        # pressure nor stays pinned through the pending-prefill closure
        self._governor.register_bound(
            "serving.%s.kv_pool" % self._name, 0)
        self._governor.register_bound(
            "serving.%s.pending_prefill" % self._name, 0)
        if not drain:
            return 0
        drained = max(0, self._stats.completed - before)
        self._stats.on_drain(drained)
        return drained

    def release(self, timeout: Optional[float] = 60.0) -> bool:
        """After :meth:`close`: wait (up to ``timeout`` seconds) for the
        worker to exit, then give back the engine's device memory — the
        captured graphs with their private memory pools, the KV pools and
        the parameters — and return the freed blocks to the card
        (``torch.cuda.empty_cache``). A fleet calls this on a killed or
        drained replica, so a rebuild does not stack a second set of
        pools on the first. :meth:`stats` still answers. Returns False
        (nothing released) when the worker is still running, as it is
        when the call comes from the worker itself."""
        if not self._closed:
            raise MXNetError("DecodeEngine %r: release() before close()"
                             % self._name)
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)
        if self._thread.is_alive():
            return False
        self._paths = {}
        if self._capture_stream is not None:
            _give_stream(self.device, self._capture_stream)
            self._capture_stream = None
        self._params = None
        self._draft = None
        self._cache.release_pools()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def name(self) -> str:
        return self._name

    @property
    def page_size(self) -> int:
        """Tokens per KV page — the chunk granularity of the prefix
        cache's rolling hash."""
        return self._cache.page_size

    @property
    def tenants(self) -> TenantRegistry:
        return self._tenants

    # ------------------------------------------------------------------
    # engine thread
    # ------------------------------------------------------------------
    def _any_active(self) -> bool:
        return any(r is not None for r in self._slots)

    @torch.no_grad()
    def _worker(self):
        if self.device.index is not None:
            torch.cuda.set_device(self.device)
        while True:
            with self._cv:
                while not self._wfq.total_queued() \
                        and not self._any_active() and not self._closed \
                        and not self._pending_swaps and not self._calls:
                    self._cv.wait()
                calls, self._calls = self._calls, []
                stop = self._closed and not self._wfq.total_queued() \
                    and not self._any_active()
                if stop:
                    swaps, self._pending_swaps = self._pending_swaps, []
            for fn, fut in calls:  # warmup(), handed over between ticks
                if fut.set_running_or_notify_cancel():
                    try:
                        fut.set_result(fn())
                    except BaseException as exc:  # noqa: BLE001 - to caller
                        fut.set_exception(exc)
            if stop:
                break
            self._apply_pending_swaps()
            self._expire_queued()
            self._evict_expired()
            self._shed_tenant_breakers()
            with self._cv:
                has_work = bool(self._wfq.total_queued()) \
                    or self._any_active()
            if not has_work:
                continue
            if not self._breaker.allow():
                # open ENGINE breaker: answer all queued work explicitly
                # instead of letting it age out; the reset timeout admits
                # a half-open probe later
                self._shed_open_breaker()
                time.sleep(0.005)
                continue
            try:
                # devprof tick scope: the sampling decision is drawn once
                # for the whole tick so a timed tick's prefill/step/host-
                # gap breakdown is coherent; one global read when off
                tick_t0 = time.perf_counter()
                tick_timed = _devprof.tick_begin()
                toks_before = self._tokens_total
                self._admit()
                prefilling = [(i, r) for i, r in enumerate(self._slots)
                              if r is not None and r.prefilling]
                decoding = [(i, r) for i, r in enumerate(self._slots)
                            if r is not None and not r.prefilling]
                if prefilling:
                    # ONE chunk per tick, ROUND-ROBIN over prefilling
                    # slots (admission order, wrapping), then the tick
                    # goes back to decoding. Round-robin — not oldest-
                    # first — is what decouples TTFT from the longest
                    # prompt: a 1-chunk prompt lands on its next turn
                    # instead of waiting out a 100-chunk neighbour.
                    cands = sorted(prefilling, key=lambda t: t[1].seq)
                    slot, req = next(
                        (t for t in cands if t[1].seq > self._rr_last),
                        cands[0])
                    self._rr_last = req.seq
                    self._advance_prefill(slot, req)
                if decoding:
                    self._step_once(decoding)
                elif not prefilling:
                    # every queued tenant deferred (pages/rate/breaker)
                    # with nothing in flight: yield instead of spinning
                    if tick_timed:
                        _devprof.tick_end()
                    time.sleep(0.001)
                    continue
                if tick_timed:
                    _devprof.note_decode_tick(
                        self._name,
                        (time.perf_counter() - tick_t0) * 1e3,
                        self._tokens_total - toks_before)
            except Exception as exc:  # noqa: BLE001 - engine must survive
                _devprof.tick_end()  # don't leak the tick scope into the
                # eviction/recovery path's dispatches
                # NO exception may kill the engine thread — that would
                # hang every in-flight and queued future forever. Evict
                # whatever was in flight and keep serving. This is also a
                # black-box moment: something unexpected reached the
                # catch-all, so commit the ring before state is torn down.
                _log.exception("decode engine %r: tick failed", self._name)
                _flightrec.record("decode.engine_exception",
                                  server=self._name, error=repr(exc))
                _flightrec.dump("decode engine catch-all: %r" % (exc,))
                self._breaker.on_failure()
                self._evict([(i, r) for i, r in enumerate(self._slots)
                             if r is not None], exc)
        # drained close: resolve any swap still pending so its waiter
        # does not hang on a dead worker
        exc = ServerClosedError("engine closed before the swap applied")
        for _params, _variant, fut in swaps:
            if fut.set_running_or_notify_cancel():
                fut.set_exception(exc)

    def _apply_pending_swaps(self):
        """Tick-boundary weight swap: copy the newest tree into the
        engine's own parameter tensors, which every captured path (and a
        ``model`` draft) reads, between steps. In-flight sequences
        continue on the new weights next tick; nothing is evicted and
        (same signature) nothing is captured again."""
        with self._cv:
            if not self._pending_swaps:
                return
            swaps, self._pending_swaps = self._pending_swaps, []
            _tree_copy(self._params, swaps[-1][0])
            for _params, variant, _fut in swaps:
                self._active_variant = variant
                self._swaps += 1
            self._swap_epoch += len(swaps)
            if self._prefix_cache:
                # cached KV was computed under the OLD weights: a prompt
                # prefilled under the new ones must not match it
                self._cache.clear_prefix_index()
        for _params, variant, fut in swaps:
            _T_EVENTS.inc(server=self._name, event="weight_swap")
            _flightrec.record("decode.weight_swap", server=self._name,
                              variant=variant)
            if fut.set_running_or_notify_cancel():
                fut.set_result(True)

    def _expire_queued(self):
        now = time.perf_counter()
        with self._cv:
            expired = self._wfq.expire(now)
        for tenant, req in expired:
            self._stats.on_timeout()
            tenant.stats.on_timeout()
            _tracing.finish(req.trace, "timeout", where="queued")
            self._fail(req, RequestTimeoutError(
                "request spent > its deadline queued"))

    def _evict_expired(self):
        """A sequence whose deadline passed mid-decode is evicted at the
        tick boundary — pages freed, future failed."""
        now = time.perf_counter()
        victims: List[tuple] = []
        with self._cv:
            for i, req in enumerate(self._slots):
                if req is not None and req.deadline is not None \
                        and now > req.deadline:
                    victims.append((i, req))
                    self._slots[i] = None
                    self._release_slot(i, req)
            self._deadline_evictions += len(victims)
        for i, req in victims:
            self._stats.on_timeout()
            req.tenant.stats.on_timeout()
            _T_EVENTS.inc(server=self._name, event="deadline_evicted")
            _tracing.finish(req.trace, "timeout", where="mid_decode",
                            tokens=len(req.tokens))
            _flightrec.record("decode.deadline_evict", server=self._name,
                              rid=req.rid, tenant=req.tenant.tenant_id)
            self._fail(req, RequestTimeoutError(
                "deadline expired mid-decode after %d generated tokens: "
                "evicted at the tick boundary" % len(req.tokens)))

    def _shed_tenant_breakers(self):
        """A tenant whose breaker is open has its QUEUED work answered
        now with :class:`TenantUnavailableError` — that tenant alone."""
        dropped: List[tuple] = []
        for tenant in self._tenants:
            if not tenant.queue:
                continue
            if tenant.breaker.state == "open":
                with self._cv:
                    dropped.extend(self._wfq.drain(tenant))
        for tenant, req in dropped:
            tenant.stats.on_shed(breaker=True)
            _T_EVENTS.inc(server=self._name, event="shed_tenant_breaker")
            _tracing.finish(req.trace, "shed", reason="tenant_breaker")
            self._fail(req, TenantUnavailableError(tenant.tenant_id,
                                                   "open"))

    def _shed_open_breaker(self):
        with self._cv:
            dropped = self._wfq.drain()
        if not dropped:
            return
        exc = EngineUnavailableError(
            "decode breaker is %s: request shed" % self._breaker.state)
        for tenant, req in dropped:
            self._stats.on_unavailable(1)
            tenant.stats.on_shed()
            _tracing.finish(req.trace, "shed", reason="engine_breaker")
            self._fail(req, exc)
            _T_EVENTS.inc(server=self._name, event="shed_open_breaker")

    # -- admission ------------------------------------------------------
    def _admit_guard(self, tenant: Tenant, req: "_DecodeRequest") -> bool:
        """Per-tenant admission veto, called by the weighted-fair pick
        under ``self._cv``. False = defer THIS tenant (its turn passes;
        other tenants' heads still admit this round)."""
        # non-consuming open-state check FIRST, so a deferred tenant's
        # tokens are never charged for an admission its breaker would
        # refuse anyway (the worker's shed pass drains it shortly)
        if tenant.breaker.state == "open":
            _tracing.event(req.trace, "defer", reason="breaker")
            return False
        # orange-tier ladder rung: batch-class tenants defer while the
        # governor reports pressure — a deferral, not a shed (the
        # request stays queued and admits when the tier recedes), and
        # it NEVER touches interactive/standard heads
        if self._tick_tier in ("orange", "red") \
                and tenant.priority >= PRIORITY_CLASSES["batch"]:
            tenant.stats.on_defer("pressure")
            _tracing.event(req.trace, "defer", reason="pressure")
            return False
        total = int(req.prompt.size) + req.max_new
        # the admission walk: map-able shared prefix pages reduce both
        # the global reservation AND the tenant's charge. Stashed on the
        # request; _prefill consumes it on the same worker pass.
        match = (self._cache.match_prefix(req.prompt)
                 if self._prefix_cache and not self._ring(req) else None)
        req.match = match
        need = self._cache.pages_for(total)
        if match is not None:
            need -= len(match.full)
        if not self._cache.can_admit_prefix(total, match):
            tenant.stats.on_defer("pages")
            _tracing.event(req.trace, "defer", reason="pages_global")
            return False
        if not tenant.within_page_budget(need):
            tenant.stats.on_defer("pages")
            _tracing.event(req.trace, "defer", reason="pages_budget")
            return False
        if not tenant.take_tokens(total):
            tenant.stats.on_defer("rate")
            _tracing.event(req.trace, "defer", reason="rate")
            return False
        # allow() LAST: it may consume the half-open probe, so it must
        # only run when the pop really happens next; a veto refunds
        if not tenant.breaker.allow():
            tenant.refund_tokens(total)
            _tracing.event(req.trace, "defer", reason="breaker")
            return False
        _tracing.event(req.trace, "admission_verdict", pages_needed=need,
                       matched_pages=len(match.full) if match else 0)
        return True

    def _admit(self):
        # the governor's degradation ladder, consulted once per
        # admission pass (observe() is pure host arithmetic over the
        # bound registry — tick-rate cheap):
        #   yellow+  shed cached-LRU ref-0 prefix pages proactively
        #   orange   shrink the admission quantum to 1/pass and defer
        #            batch-class tenants (_admit_guard, never interactive)
        #   red      stop new admissions entirely; in-flight sequences
        #            keep decoding — completion is what drains pressure
        tier = self._governor.observe(source="decode.admit")
        with self._cv:
            # _cv guards both governor fields: _admit_guard reads
            # _tick_tier under the pop's lock, stats() reads
            # _governed_limit from caller threads
            self._tick_tier = tier
            if self._governed_limit is not None and tier == "green" \
                    and not self._governor.latched:
                self._governed_limit = None
            governed = self._governed_limit
        if tier != "green":
            shed = self._cache.shed_cached()
            if shed:
                self._governor.note_shed(shed, self._cache.name)
                _T_EVENTS.inc(server=self._name, event="pressure_shed")
        if tier == "red":
            return
        limit = self.num_slots
        if governed is not None:
            # post-OOM governed re-admission: fewer sequences, same
            # slot shapes, until the governor recovers green
            limit = min(limit, governed)
        quantum = 1 if tier == "orange" else self.num_slots
        admitted = 0
        while True:
            if sum(1 for r in self._slots if r is not None) >= limit:
                return
            slot = next((i for i, r in enumerate(self._slots)
                         if r is None), None)
            if slot is None:
                return
            with self._cv:
                picked = self._wfq.pop(self._admit_guard)
            if picked is None:
                return
            tenant, req = picked
            tenant.stats.set_depth(len(tenant.queue))
            try:
                self._prefill(req, slot)
            except Exception as exc:  # noqa: BLE001 - isolate to request
                # per-request isolation: a prefill failure answers ONLY
                # this future and feeds the TENANT breaker. Prefill writes
                # only this slot's pages (and the null page), so the
                # other sequences' KV is untouched...
                self._release_slot(slot, req)
                tenant.on_request_failure()
                self._stats.on_error()
                self._fail(req, exc)
                if self._on_oom("serving.decode.prefill", exc):
                    # ...unless the failure classified as an OOM (an
                    # allocation died — every pool byte is suspect, and
                    # the governor just latched red): evict every live
                    # sequence onto zeroed pools (empty `active` still
                    # re-zeroes)
                    self._evict([(i, r) for i, r
                                 in enumerate(self._slots)
                                 if r is not None], exc)
                    return
            admitted += 1
            if admitted >= quantum:
                # orange's shrunk admission quantum: one admission per
                # pass keeps new prefill load trickling while pressure
                # is worked off
                return

    def _on_oom(self, plane: str, exc: BaseException) -> bool:
        """OOM classification at a failure site: False (untouched) for a
        non-OOM exception. A classified OOM — the allocator's
        ``torch.OutOfMemoryError`` or the chaos harness's ``action=oom``
        — runs the shared survival routine (``hbm.oom_survival``:
        diagnostic into the flight recorder, governor latched red,
        per-plane counter) and arms governed re-admission: after the
        caller's full eviction, ``_admit`` re-admits at half the sequence
        count that was in flight (``MXNET_HBM_RED_ADMIT`` overrides)
        until the governor recovers green. Slot shapes never change —
        fewer sequences, the same graphs, nothing captured again."""
        if not _hbm.oom_survival(plane, exc, dump=False):
            return False
        active = sum(1 for r in self._slots if r is not None)
        with self._cv:
            self._governed_limit = self._governor.governed_admit(
                max(1, active))
        _T_EVENTS.inc(server=self._name, event="oom")
        return True

    def _prefill(self, req: _DecodeRequest, slot: int):
        # tenant-scoped chaos site, OUTSIDE the retry policy: a fault
        # scheduled against this tenant fails this request (feeding the
        # tenant's breaker), it is not an engine transient
        chaos.maybe_fail("serving.decode.tenant.%s" % req.tenant.tenant_id)
        p = int(req.prompt.size)
        total = p + req.max_new
        req.epoch = self._swap_epoch  # worker-confined read
        ring = self._ring(req)
        if self._prefix_cache and not ring:
            matched, cow_src, cow_dst = self._cache.admit_prefix(
                slot, total, req.match)
        else:
            self._cache.reserve(slot, total)
            matched, cow_src, cow_dst = 0, None, None
        # shared pages charge the `shared` pseudo-tenant (i.e. nobody)
        req.tenant.charge_pages(self._cache.exclusive_pages(slot))
        if cow_src is not None:
            self._run_cow(cow_src, cow_dst)
        req.kv_cached = matched
        _tracing.event(req.trace, "admit", slot=slot, ring=ring,
                       queue_wait_ms=round(
                           (time.perf_counter() - req.t_submit) * 1e3, 3))
        if matched:
            _tracing.event(req.trace, "prefix_hit", tokens_cached=matched)
        if cow_src is not None:
            _tracing.event(req.trace, "cow_copy", src_page=cow_src,
                           dst_page=cow_dst)
        # at least the LAST prompt position always runs through the
        # model: its logits are the first output token — a full hit
        # recomputes that one position over the shared/CoW pages
        req.filled = min(matched, p - 1)
        if self._chunk and not ring:
            # chunked prefill: the slot joins the round-robin chunk lane
            # and stays out of the decode tick until its last chunk lands
            req.prefilling = True
            with self._cv:
                self._admit_seq += 1
                req.seq = self._admit_seq
            self._slots[slot] = req
            _T_EVENTS.inc(server=self._name, event="admitted")
            return
        if matched == 0:
            tok = self._run_full_prefill(req, slot, ring=ring)
        else:
            rung = select_bucket(p - req.filled, self._ladder)
            tok = self._run_chunk(slot, req, req.filled, p, rung)
        self._finish_prefill(req, slot, tok)

    def _ring(self, req: _DecodeRequest) -> bool:
        """Whether ``req`` takes the long-context (ring prefill) route."""
        return bool(self._ring_len and req.prompt.size >= self._ring_len)

    def _run_full_prefill(self, req: _DecodeRequest, slot: int,
                          ring: bool = False):
        """The monolithic prefill: whole prompt padded to a ladder rung,
        dense causal attention in the captured rung (or, for a ring
        prompt, :meth:`_run_ring_prefill`). Returns the device argmax
        token."""
        p = int(req.prompt.size)
        rung = select_bucket(p, self._ladder)
        _tracing.event(req.trace, "prefill", rung=rung, tokens=p,
                       ring=ring)
        pre = np.zeros((3, rung), np.int32)  # tokens, write pages, offsets
        pre[0, :p] = req.prompt
        wpg, woff = self._cache.write_slots(slot, 0, p)
        npg, noff = self._cache.null_write_slots(rung - p)
        pre[1] = np.concatenate([wpg, npg])
        pre[2] = np.concatenate([woff, noff])
        path = self._path(("prefill", rung))
        policy = self._retry or resilience.default_policy()

        def attempt():
            chaos.maybe_fail("serving.decode.prefill")
            if ring:
                return self._run_ring_prefill(pre, p)
            return self._run(path, pre, [p], site="serving.decode_prefill")

        return policy.call(attempt, site="serving.decode.prefill")

    def _run_ring_prefill(self, pre, length: int):
        """The long-context prefill: the model's prefill run eagerly, out
        of the captured rungs, its attention ring attention over the
        process's local members where there are several (a process of
        the port has one, and keeps the dense attention, as the JAX
        engine on one local device)."""
        mesh = self._ring_mesh
        dev = self.device
        tokens, wpg, woff = (torch.from_numpy(np.ascontiguousarray(r)).to(
            dev) for r in pre)
        use_ring = mesh.size > 1 and tokens.shape[0] % mesh.size == 0
        last = self._model.prefill(
            self._params, tokens, length, self._cache.k_pool,
            self._cache.v_pool, wpg, woff,
            attn=ring_prefill_attention(mesh, self._model)
            if use_ring else None)
        return torch.argmax(last)

    def _run_chunk(self, slot: int, req: _DecodeRequest, start: int,
                   end: int, rung: int):
        """Prompt positions ``[start, end)`` of ``slot``, padded to
        ``rung``, attending over the slot's page row. Positions below
        ``req.kv_cached`` are only *recomputed* (their KV already sits in
        shared/CoW pages — writes go to the null page). Returns the device
        argmax token of position ``end - 1``."""
        n = end - start
        _tracing.event(req.trace, "prefill_chunk", start=start, end=end,
                       rung=rung)
        pre = np.zeros((3, rung), np.int32)
        pre[0, :n] = req.prompt[start:end]
        cached_n = max(0, min(req.kv_cached, end) - start)
        pages, offs = [], []
        if cached_n:
            npg, noff = self._cache.null_write_slots(cached_n)
            pages.append(npg)
            offs.append(noff)
        if n - cached_n:
            wpg, woff = self._cache.write_slots(slot, start + cached_n,
                                                n - cached_n)
            pages.append(wpg)
            offs.append(woff)
        if rung - n:
            npg, noff = self._cache.null_write_slots(rung - n)
            pages.append(npg)
            offs.append(noff)
        pre[1] = np.concatenate(pages)
        pre[2] = np.concatenate(offs)
        row = self._cache.page_table[slot]
        path = self._path(("chunk", rung))
        policy = self._retry or resilience.default_policy()

        def attempt():
            chaos.maybe_fail("serving.decode.prefill")
            return self._run(path, pre, row, [start, n],
                             site="serving.decode_prefill_chunk")

        tok = policy.call(attempt, site="serving.decode.prefill")
        self._stats.on_prefill_chunk()
        return tok

    def _run_cow(self, src: int, dst: int):
        """The copy-on-write copy: the divergent/partial page's K/V (all
        layers) duplicated into the writer's own page BEFORE any of its
        writes can land there — sharers never observe each other's
        tokens. A device copy, captured like the other paths."""
        self._run(self._path(("cow", 1)), [src, dst],
                  site="serving.decode_cow")
        with self._cv:
            self._cow_copies += 1
        _T_EVENTS.inc(server=self._name, event="cow_copy")

    def _advance_prefill(self, slot: int, req: _DecodeRequest):
        """Chunked prefill: ONE chunk for ``slot``, then the tick yields
        back to decoding. Completion delivers the first token (the TTFT
        mark). A chunk failure is request-level — exactly this future
        fails (feeding the TENANT breaker), the engine keeps ticking."""
        p = int(req.prompt.size)
        end = min(req.filled + self._chunk, p)
        try:
            tok = self._run_chunk(slot, req, req.filled, end, self._chunk)
        except Exception as exc:  # noqa: BLE001 - isolate to request
            self._slots[slot] = None
            self._release_slot(slot, req)
            req.tenant.on_request_failure()
            self._stats.on_error()
            self._fail(req, exc)
            if self._on_oom("serving.decode.prefill", exc):
                self._evict([(i, r) for i, r in enumerate(self._slots)
                             if r is not None], exc)
            return
        req.filled = end
        if end >= p:
            self._finish_prefill(req, slot, tok)

    def _finish_prefill(self, req: _DecodeRequest, slot: int, tok):
        """Prefill complete (monolithic, tail or final chunk): index the
        prompt's pages for future sharers, deliver the first token and
        hand the slot to the decode tick."""
        p = int(req.prompt.size)
        self._breaker.on_success()
        req.tenant.breaker.on_success()
        self._cache.seq_lens[slot] = p
        if not self._ring(req) and req.epoch == self._swap_epoch:
            # a swap that landed mid-prefill (between chunks) flushed
            # the index AND left this sequence's earlier pages holding
            # old-weight KV: serving the request is the documented
            # in-flight rollout semantic, but RE-INDEXING those pages
            # would hand stale KV to future prompts — skip the insert
            self._cache.insert_prefix(slot, req.prompt)
        self._prefills += 1
        _T_EVENTS.inc(server=self._name, event="prefill")
        # first token: ONE scalar fetch per admitted sequence (prefill
        # rate, not token rate)
        first = int(fetch_host([tok])[0])
        now = time.perf_counter()
        ttft = (now - req.t_submit) * 1e3
        _tracing.event(req.trace, "first_token", ttft_ms=round(ttft, 3))
        self._stats.on_first_token(ttft)
        req.tenant.stats.on_first_token(ttft)
        req.tokens.append(first)
        req.last_t = now
        self._tokens_total += 1
        _T_TOKENS.inc(server=self._name)
        req.slot = slot
        req.prefilling = False
        if not self._chunk:
            _T_EVENTS.inc(server=self._name, event="admitted")
        if self._finished(req, first):
            self._slots[slot] = None
            self._complete(req, slot, now)
        else:
            self._slots[slot] = req

    # -- the decode tick ------------------------------------------------
    def _step_once(self, active):
        s = self.num_slots
        w = self._spec_w
        ps = self._cache.page_size
        # rows: tokens, positions, seq_lens, write pages, write offsets —
        # ONE packed host->device copy per tick (into the step graph's
        # static operand), W = spec_k+1 query rows
        # per slot (slot s owns rows s*W .. s*W+W-1: row 0 the committed
        # token, rows 1..k its draft guesses at the next positions).
        # Inactive slots and unused draft rows keep seq_len 0 and the
        # null write page (row 3 stays 0); their offsets cycle the page
        # so write indices stay in range. Several such rows write the
        # same null-page positions; harmless, as no row reads page 0
        # below its limit.
        packed = np.zeros((5, s * w), np.int32)
        packed[4] = np.arange(s * w) % ps
        drafts: dict = {}
        pages_before = self._cache.pages_in_use if self._cache.audit else 0
        for slot, req in active:
            pos = int(req.prompt.size) + len(req.tokens) - 1
            base = slot * w
            draft = (self._propose(req, slot, pos)
                     if self._draft is not None else ())
            drafts[slot] = draft
            row_toks = [req.tokens[-1]]
            row_toks.extend(int(t) for t in draft)
            for j, row_tok in enumerate(row_toks):
                # row j carries the token at absolute position pos+j and
                # attends up to itself (per-row seq_len) — rows below it
                # in the same tick write their KV before attention reads,
                # so draft rows see each other causally. Admission's
                # worst-case reserve() plus the _propose clamp guarantee
                # pos+j is covered, so index the page table directly.
                packed[0, base + j] = row_tok
                packed[1, base + j] = pos + j
                packed[2, base + j] = pos + j + 1
                packed[3, base + j] = \
                    self._cache.page_table[slot, (pos + j) // ps]
                packed[4, base + j] = (pos + j) % ps
        # black box: the in-flight set BEFORE the step executes, so a
        # mid-tick death's dump names the failing tick's sequences and
        # their tenants. One event per tick, one deque append — the
        # enabled() guard keeps even the reqs-list BUILD off the
        # MXNET_TELEMETRY=0 hot path.
        if telemetry.enabled():
            _flightrec.record(
                "decode.tick", server=self._name, tick=self._ticks,
                reqs=[[req.rid, req.tenant.tenant_id,
                       "prefill" if req.prefilling else "decode"]
                      for req in self._slots if req is not None])
        path = self._path(("step", s * w))
        self._sync_page_table()
        policy = self._retry or resilience.default_policy()

        def attempt():
            chaos.maybe_fail("serving.decode")
            return self._run(path, packed, site="serving.decode_step")

        try:
            sampled = policy.call(attempt, site="serving.decode")
            # the one per-token device->host sync of the plane: the
            # sampled token ids must reach the host for EOS/stop checks
            # and feedback. Inside the try: a failed transfer evicts the
            # tick like a failed step instead of killing the worker.
            toks = fetch_host([sampled])[0]
        except Exception as exc:  # noqa: BLE001 - evict, don't die
            # OOM first: a classified OOM (or injected action=oom)
            # additionally latches the governor red and arms governed
            # re-admission before the same full-eviction path below
            # reclaims every page
            self._on_oom("serving.decode", exc)
            self._breaker.on_failure()
            # the pool re-zero kills EVERY in-flight sequence's KV —
            # chunked-prefilling slots included, not just this tick's
            self._evict([(i, r) for i, r in enumerate(self._slots)
                         if r is not None], exc)
            return
        self._breaker.on_success()
        now = time.perf_counter()
        tpots = []
        tenant_tpots: dict = {}
        tenant_slots: dict = {}
        tenant_spec: dict = {}
        total_new = 0
        tick_proposed = 0
        tick_accepted = 0
        for slot, req in active:
            base = slot * w
            draft = drafts.get(slot, ())
            k_eff = len(draft)
            # greedy rejection: accept the longest draft prefix that
            # equals the model's own argmax chain — committed token j is
            # the model's prediction from row j, and draft[j] rode row
            # j+1, so draft[j] was a correct guess iff it equals
            # toks[base+j]. The committed tokens are ALWAYS the model's
            # outputs (never the draft's), so output == sequential
            # greedy decode whatever the draft proposed.
            a = 0
            while a < k_eff and int(draft[a]) == int(toks[base + a]):
                a += 1
            n_new = 0
            for j in range(a + 1):
                tok = int(toks[base + j])
                req.tokens.append(tok)
                n_new += 1
                if self._finished(req, tok):
                    break
            # commit = advance seq_lens past the rows that verified;
            # rejected rows' KV (positions >= the new seq_len) is the
            # ROLLBACK: never committed, masked by the ragged attention
            # bound, and overwritten by the next tick's rows — no page
            # alloc/free happened mid-tick, so there is nothing else to
            # unwind and no bystander is touched.
            self._cache.seq_lens[slot] += n_new
            accepted = min(a, n_new)
            total_new += n_new
            # every decode tick the sequence participates in is a hop of
            # its (sampled) trace — the None path is one pointer check.
            # A multi-token tick amortizes the wall interval over its
            # commits so TPOT keeps meaning time-per-OUTPUT-token.
            per_tok = (now - req.last_t) * 1e3 / n_new
            _tracing.event(req.trace, "tick",
                           token_index=len(req.tokens),
                           tpot_ms=round(per_tok, 3),
                           **({"drafted": k_eff, "accepted": accepted}
                              if self._spec_k else {}))
            tpots.extend([per_tok] * n_new)
            tenant_tpots.setdefault(req.tenant, []).extend(
                [per_tok] * n_new)
            tenant_slots[req.tenant] = tenant_slots.get(req.tenant, 0) + 1
            if k_eff:
                self._spec_slot_ticks += 1
                self._spec_new += n_new
                tick_proposed += k_eff
                tick_accepted += accepted
                row = tenant_spec.setdefault(req.tenant, [0, 0])
                row[0] += k_eff
                row[1] += accepted
            req.last_t = now
            if self._finished(req, int(req.tokens[-1])):
                self._slots[slot] = None
                tenant_slots[req.tenant] -= 1
                self._complete(req, slot, now)
        # per-TICK accounting, not per token
        self._stats.on_output_tokens(tpots)
        for tenant, ms_batch in tenant_tpots.items():
            tenant.stats.on_output_tokens(ms_batch)
            tenant.stats.set_slots(tenant_slots.get(tenant, 0))
        if tick_proposed or tick_accepted:
            self._spec_proposed += tick_proposed
            self._spec_accepted += tick_accepted
            self._stats.on_spec(tick_proposed, tick_accepted)
            for tenant, (p_cnt, a_cnt) in tenant_spec.items():
                tenant.stats.on_spec(p_cnt, a_cnt)
        self._tokens_total += total_new
        _T_TOKENS.inc(total_new, server=self._name)
        self._ticks += 1
        occ = len(active) / float(s)
        self._occ_sum += occ
        _T_OCCUPANCY.set(occ, server=self._name)
        if self._cache.audit:
            # MXNET_KVCACHE_AUDIT: re-prove the page refcount invariant
            # at every tick boundary, not just on cache mutations
            self._cache.audit_check()
            # the speculation-specific tick invariants: a verify tick
            # allocates NOTHING (completions above can only free), and
            # no speculating tenant stands over the page budget it was
            # admitted under — the gauge-proven form of "k+1 writes fit
            # the admission-time reservation".
            if self._cache.pages_in_use > pages_before:
                raise MXNetError(
                    "kvcache %r audit: decode tick grew pages_in_use "
                    "%d -> %d — a speculative write escaped its "
                    "admission-time reservation" %
                    (self._name, pages_before, self._cache.pages_in_use))
            if self._spec_k:
                for tenant in {req.tenant for _slot, req in active}:
                    if tenant.page_budget is not None and \
                            tenant.pages_in_use > tenant.page_budget:
                        raise MXNetError(
                            "tenant %r audit: pages_in_use %d exceeds "
                            "page_budget %d after a speculative tick"
                            % (tenant.tenant_id, tenant.pages_in_use,
                               tenant.page_budget))

    def _propose(self, req: _DecodeRequest, slot: int, pos: int):
        """Draft tokens for one slot's verify tick, clamped so the tick
        can NEVER outgrow what admission reserved:

        * the engine k (the fixed width bound);
        * the tenant's ``spec_k`` cap, if set (can only lower);
        * the request's remaining output budget (a tick commits at most
          k+1 tokens; committing past ``max_new`` would over-generate);
        * the slot's page reservation (every row writes KV at pos+j, and
          ``write_slots`` hard-faults past the reserved run — the tenant
          page budget was charged for exactly that run at admission, so
          staying inside it keeps the budget invariant mid-tick with
          zero page traffic).
        """
        k = self._spec_k
        cap = req.tenant.spec_k
        if cap is not None:
            k = min(k, cap)
        k = min(k, req.max_new - len(req.tokens) - 1)
        k = min(k, self._cache.reserved_tokens(slot) - (pos + 1))
        if k <= 0:
            return ()
        history = np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])
        try:
            proposed = self._draft.propose(history, k)
        except Exception:  # noqa: BLE001 - a draft bug must not kill ticks
            # drafts are hints: a failing proposer degrades this slot to
            # the classic single-token tick instead of faulting the tick
            # (which would evict every in-flight sequence)
            return ()
        return sanitize(proposed, k, self._model.vocab_size)

    def set_tenant_spec_k(self, tenant_id: str, spec_k: Optional[int]):
        """Set (or clear, with ``None``) one tenant's speculative draft
        cap at runtime. Caps only LOWER the engine's ``spec_k`` — the
        verify width K+1 is fixed per engine — so a slow-accepting tenant
        can be throttled to 0 without touching anyone else's tick."""
        tenant = self._tenants.resolve(tenant_id)
        tenant.spec_k = None if spec_k is None else max(0, int(spec_k))

    @staticmethod
    def _finished(req: _DecodeRequest, tok: int) -> bool:
        return (len(req.tokens) >= req.max_new
                or (req.eos_id is not None and tok == req.eos_id))

    def _release_slot(self, slot: int, req: _DecodeRequest):
        """Free a slot's page mappings AND return its EXCLUSIVE pages to
        the owning tenant's budget. Idempotent (a slot already freed owns
        0 pages), so the close()/worker race can double-call it."""
        freed = self._cache.exclusive_pages(slot)
        self._cache.free(slot)
        req.tenant.release_pages(freed)

    def _complete(self, req: _DecodeRequest, slot: int, now: float):
        self._release_slot(slot, req)
        _T_EVENTS.inc(server=self._name, event="completed")
        _tracing.finish(req.trace, "complete", tokens=len(req.tokens),
                        latency_ms=round((now - req.t_submit) * 1e3, 3))
        if req.future.done():
            # close(drain=False) raced the in-flight tick and already
            # failed this future; completing it now would raise
            return
        if req.future.set_running_or_notify_cancel():
            req.future.set_result(np.asarray(req.tokens, np.int32))
            lat = (now - req.t_submit) * 1e3
            self._stats.on_complete(lat)
            req.tenant.stats.on_complete(lat)

    def _evict(self, active, exc: BaseException):
        """A decode step failed after retries: fail exactly the sequences
        in flight, reset their slots and zero the pools, and keep serving
        new traffic. A TICK-level fault: it feeds the engine breaker (the
        caller), not the tenants'."""
        _flightrec.record(
            "decode.evict", server=self._name, error=repr(exc),
            reqs=[[req.rid, req.tenant.tenant_id]
                  for _slot, req in active])
        for slot, req in active:
            self._slots[slot] = None
            self._release_slot(slot, req)
            self._stats.on_error()
            req.tenant.stats.on_error()
            self._evictions += 1
            _T_EVENTS.inc(server=self._name, event="evicted")
            _tracing.finish(req.trace, "evict",
                            tokens=len(req.tokens), error=repr(exc))
            self._fail(req, exc)
        self._cache.reset_pools()

    @staticmethod
    def _fail(req: _DecodeRequest, exc: BaseException):
        # generic terminal fallback: paths with a more specific verdict
        # (evict/timeout/shed) finish the trace first and this no-ops
        _tracing.finish(req.trace, "error", error=type(exc).__name__)
        if req.future.done():
            return
        if req.future.set_running_or_notify_cancel():
            req.future.set_exception(exc)


# ---------------------------------------------------------------------------
# Reference model: a tiny pre-norm transformer over the paged cache
# ---------------------------------------------------------------------------

def ring_prefill_attention(mesh, model):
    """The ``attn`` of a ring prefill over ``mesh``: q ``(T, H, D)`` and
    k/v ``(T, KH, D)``, the kv heads repeated for GQA
    (``mxnet_tpu/serving/decode.py:1535-1543``), through
    ``sequence_parallel.ring_attention`` in its ``(1, H, T, D)`` layout,
    causal; every member's block gathered back into the whole ``(T, H,
    D)`` output the model goes on with."""
    from .. import _dist, sequence_parallel

    groups = model.num_heads // model.num_kv_heads

    def attn(q, k, v, scale):
        if groups > 1:
            k = k.repeat_interleave(groups, dim=1)
            v = v.repeat_interleave(groups, dim=1)
        out = sequence_parallel.ring_attention(
            q.permute(1, 0, 2)[None], k.permute(1, 0, 2)[None],
            v.permute(1, 0, 2)[None], mesh=mesh, causal=True, scale=scale)
        block = out[0].permute(1, 0, 2).contiguous()
        if mesh.size == 1:
            return block
        whole = block.new_empty((mesh.size,) + tuple(block.shape))
        _dist.group().all_gather(whole, block)
        return whole.reshape((-1,) + tuple(block.shape[1:]))

    return attn


def _row(logits, length):
    """``logits[length - 1]``: ``length`` an int, or a 0-d integer tensor
    on the logits' device that is read there (no host read, so the pass
    can be captured as a CUDA graph)."""
    if torch.is_tensor(length):
        return logits.index_select(0, length.reshape(1).long() - 1)[0]
    return logits[int(length) - 1]


class TinyDecoder(PagedDecodeModel):
    """Small causal transformer implementing the paged-decode contract —
    the port of the JAX package's ``TinyDecoder``, op for op.

    Per layer: RMSNorm, QKV projections, :func:`~mxnet_tpu_torch.serving.
    kvcache.write_kv` of the new K/V rows (in place), paged attention
    through :func:`mxnet_tpu_torch.ops.paged_attention.paged_attention`
    (one row per slot) or :func:`~mxnet_tpu_torch.ops.paged_attention.
    paged_spec_attention` (a speculative verify tick; both the CUDA
    kernels on the card), output projection, RMSNorm + ReLU MLP.
    Prefill's dense causal attention stays plain PyTorch, as JAX computed
    it outside Pallas. Weights ride a plain dict of tensors;
    ``embed_dim == num_heads * head_dim``; positions are sinusoidal.
    """

    def __init__(self, vocab_size=128, num_layers=2, num_heads=4,
                 head_dim=16, num_kv_heads=None, mlp_ratio=2):
        if num_kv_heads is None:
            num_kv_heads = num_heads
        if num_heads % num_kv_heads:
            raise MXNetError("num_heads %d %% num_kv_heads %d != 0"
                             % (num_heads, num_kv_heads))
        self.vocab_size = int(vocab_size)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.embed_dim = self.num_heads * self.head_dim
        self.mlp_dim = self.embed_dim * int(mlp_ratio)
        self.scale = 1.0 / float(self.head_dim) ** 0.5

    # -- params ---------------------------------------------------------
    def init_params(self, seed: int = 0, device=None):
        """Random weights from ``np.random.RandomState(seed)`` — the same
        draws, in the same order, as the JAX model's ``init_params``, so
        both packages hold bit-identical weights. On the card unless
        ``device="cpu"``."""
        dev = resolve_device(device)
        rng = np.random.RandomState(seed)
        e, v, h, kh, d, m = (self.embed_dim, self.vocab_size,
                             self.num_heads, self.num_kv_heads,
                             self.head_dim, self.mlp_dim)

        def w(*shape):
            # float32 draws times a float64 scale, rounded to float32 —
            # the rounding the JAX model's jnp.asarray applies
            x = rng.randn(*shape).astype(np.float32) \
                * (1.0 / np.sqrt(shape[0]))
            return torch.tensor(np.asarray(x, np.float32), device=dev)

        def ones(n):
            return torch.ones(n, dtype=torch.float32, device=dev)

        layers = []
        for _ in range(self.num_layers):
            layers.append({
                "ln1": ones(e),
                "wq": w(e, h * d), "wk": w(e, kh * d), "wv": w(e, kh * d),
                "wo": w(h * d, e),
                "ln2": ones(e),
                "w1": w(e, m), "w2": w(m, e),
            })
        embed = w(v, e)
        return {"embed": embed, "layers": layers, "lnf": ones(e),
                "unembed": w(e, v)}

    # -- shared pieces --------------------------------------------------
    @staticmethod
    def _norm(x, scale):
        return x * scale / torch.sqrt(
            torch.mean(torch.square(x), dim=-1, keepdim=True) + 1e-6)

    def _pe(self, positions):
        half = self.embed_dim // 2
        freq = 1.0 / (10000.0 ** (torch.arange(
            half, dtype=torch.float32, device=positions.device)
            / float(half)))
        ang = positions.to(torch.float32)[:, None] * freq[None, :]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

    def _dense_causal(self, q, k, v, scale):
        """(T, H, D) causal attention: the prefill path and the no-cache
        reference."""
        groups = self.num_heads // self.num_kv_heads
        if groups > 1:
            k = k.repeat_interleave(groups, dim=1)
            v = v.repeat_interleave(groups, dim=1)
        scores = torch.einsum("qhd,khd->hqk", q, k) * scale
        t = q.shape[0]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(mask[None], scores,
                             torch.full_like(scores, -1e30))
        p = torch.softmax(scores, dim=-1)
        return torch.einsum("hqk,khd->qhd", p, v)

    @staticmethod
    def _mlp(x, layer):
        return torch.relu(x @ layer["w1"]) @ layer["w2"]

    def _embed(self, params, tokens, positions):
        return params["embed"][tokens.long()] + self._pe(positions)

    # -- contract -------------------------------------------------------
    def prefill(self, params, tokens, length, k_pool, v_pool,
                write_pages, write_offsets, attn=None):
        t = tokens.shape[0]
        h, kh, d = self.num_heads, self.num_kv_heads, self.head_dim
        positions = torch.arange(t, dtype=torch.int32, device=tokens.device)
        x = self._embed(params, tokens, positions)
        for li, layer in enumerate(params["layers"]):
            hx = self._norm(x, layer["ln1"])
            q = (hx @ layer["wq"]).reshape(t, h, d)
            k = (hx @ layer["wk"]).reshape(t, kh, d)
            v = (hx @ layer["wv"]).reshape(t, kh, d)
            write_kv(k_pool, v_pool, li, k, v, write_pages, write_offsets)
            att = (attn or self._dense_causal)(q, k, v, self.scale)
            x = x + att.reshape(t, h * d) @ layer["wo"]
            x = x + self._mlp(self._norm(x, layer["ln2"]), layer)
        logits = self._norm(x, params["lnf"]) @ params["unembed"]
        return _row(logits, length)

    def prefill_chunk(self, params, tokens, start, length, k_pool, v_pool,
                      page_table_row, write_pages, write_offsets):
        c = tokens.shape[0]
        h, kh, d = self.num_heads, self.num_kv_heads, self.head_dim
        positions = torch.arange(c, dtype=torch.int32, device=tokens.device) \
            + (start.to(torch.int32) if torch.is_tensor(start)
               else int(start))
        x = self._embed(params, tokens, positions)
        for li, layer in enumerate(params["layers"]):
            hx = self._norm(x, layer["ln1"])
            q = (hx @ layer["wq"]).reshape(c, h, d)
            k = (hx @ layer["wk"]).reshape(c, kh, d)
            v = (hx @ layer["wv"]).reshape(c, kh, d)
            # write FIRST so in-chunk positions read their own K/V back
            # through the pages like the prefix's (already-cached
            # positions write to the null page — their KV is in the
            # shared/CoW pages, this pass only recomputes activations)
            write_kv(k_pool, v_pool, li, k, v, write_pages, write_offsets)
            att = _pa.paged_prefill_attention(
                q, k_pool[li], v_pool[li], page_table_row, start, length,
                scale=self.scale)
            x = x + att.reshape(c, h * d) @ layer["wo"]
            x = x + self._mlp(self._norm(x, layer["ln2"]), layer)
        logits = self._norm(x, params["lnf"]) @ params["unembed"]
        return _row(logits, length)

    def decode(self, params, tokens, positions, k_pool, v_pool,
               page_tables, seq_lens, write_pages, write_offsets):
        s = tokens.shape[0]
        # the per-slot query width (1 = classic tick, K+1 = speculative
        # verify tick) falls out of the operands' shapes — the contract's
        # operands widen, the signature doesn't
        w = s // page_tables.shape[0]
        h, kh, d = self.num_heads, self.num_kv_heads, self.head_dim
        x = self._embed(params, tokens, positions)
        for li, layer in enumerate(params["layers"]):
            hx = self._norm(x, layer["ln1"])
            q = (hx @ layer["wq"]).reshape(s, h, d)
            k = (hx @ layer["wk"]).reshape(s, kh, d)
            v = (hx @ layer["wv"]).reshape(s, kh, d)
            write_kv(k_pool, v_pool, li, k, v, write_pages, write_offsets)
            if w > 1:
                att = _pa.paged_spec_attention(
                    q, k_pool[li], v_pool[li], page_tables, seq_lens,
                    scale=self.scale)
            else:
                att = _pa.paged_attention(
                    q, k_pool[li], v_pool[li], page_tables, seq_lens,
                    scale=self.scale)
            x = x + att.reshape(s, h * d) @ layer["wo"]
            x = x + self._mlp(self._norm(x, layer["ln2"]), layer)
        return self._norm(x, params["lnf"]) @ params["unembed"]

    # -- oracle ---------------------------------------------------------
    @torch.no_grad()
    def reference_logits(self, params, tokens):
        """Dense no-cache forward of a whole token sequence on the params'
        device: logits ``(T, vocab)`` for every position (position i
        predicts token i+1). The oracle's one step."""
        dev = params["embed"].device
        arr = torch.as_tensor(np.asarray(tokens, np.int32).ravel(),
                              device=dev)
        t = arr.shape[0]
        h, kh, d = self.num_heads, self.num_kv_heads, self.head_dim
        positions = torch.arange(t, dtype=torch.int32, device=dev)
        x = self._embed(params, arr, positions)
        for layer in params["layers"]:
            hx = self._norm(x, layer["ln1"])
            q = (hx @ layer["wq"]).reshape(t, h, d)
            k = (hx @ layer["wk"]).reshape(t, kh, d)
            v = (hx @ layer["wv"]).reshape(t, kh, d)
            att = self._dense_causal(q, k, v, self.scale)
            x = x + att.reshape(t, h * d) @ layer["wo"]
            x = x + self._mlp(self._norm(x, layer["ln2"]), layer)
        return self._norm(x, params["lnf"]) @ params["unembed"]

    @torch.no_grad()
    def reference_generate(self, params, prompt, max_new_tokens,
                           eos_id=None):
        """No-cache greedy decode: re-runs the full dense forward per
        token on the params' device. O(T^2) per token — the correctness
        oracle the engine's paged path is held against, never a serving
        path."""
        toks = [int(t) for t in np.asarray(prompt).ravel()]
        out: List[int] = []
        for _ in range(int(max_new_tokens)):
            logits = self.reference_logits(params, toks)
            nxt = int(torch.argmax(logits[-1]).item())
            out.append(nxt)
            toks.append(nxt)
            if eos_id is not None and nxt == eos_id:
                break
        return np.asarray(out, np.int32)
