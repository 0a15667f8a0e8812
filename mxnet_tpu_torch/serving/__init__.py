"""mxnet_tpu_torch.serving — the decode-serving plane on PyTorch/CUDA.

The port of ``mxnet_tpu.serving`` as far as this slice goes:

* :mod:`.decode`   — :class:`DecodeEngine` (token-level continuous
  batching over fixed slots, one decode step per tick, prefill through a
  bucket ladder or in chunks interleaved with the ticks, prefix cache
  with copy-on-write, speculative decoding with a widened verify tick)
  and the reference model :class:`TinyDecoder`; ``params_from_jax``
  carries the JAX model's weights across;
* :mod:`.speculative` — the drafts of speculative decoding: the
  model-free prompt-lookup (n-gram) draft, the accept-all ``model``
  draft, and the registry the ``MXNET_DECODE_SPEC_DRAFT`` knob picks
  from;
* :mod:`.kvcache`  — :class:`PagedKVCache`: pools preallocated on the
  device, host free-list allocator, refcounted prefix index;
* :mod:`.tenancy`  — tenant registry, weighted-fair queue, per-tenant
  breakers and budgets;
* :mod:`.fleet`    — :class:`FleetRouter`: N engines behind the
  single-engine surface, with prefix-affinity placement, tenant-aware
  spillover, per-replica breakers, drain/add/kill with rebuild, rolling
  weight swaps and SLO-driven autoscaling;
* :mod:`.stats`, :mod:`.buckets`, :mod:`.batcher` (error types).

The request-granularity ``Server`` (with ``BlockEngine`` and
``StableHLOEngine``) and ring prefill are later slices.
"""
from __future__ import annotations

from .batcher import (EngineUnavailableError, QueueFullError,
                      RequestTimeoutError, ServerClosedError, ServingError)
from .buckets import bucket_ladder, pad_to_bucket, select_bucket
from .decode import (DecodeEngine, PagedDecodeModel, TinyDecoder,
                     params_from_jax)
from .fleet import FleetRouter
from .kvcache import OutOfPagesError, PagedKVCache, PrefixMatch
from .speculative import (DraftProposer, ModelDraft, PromptLookupDraft,
                          available_drafts, make_draft, register_draft)
from .stats import ServingStats, TenantStats
from .tenancy import (PRIORITY_CLASSES, Tenant, TenantBreaker,
                      TenantRegistry, TenantUnavailableError,
                      WeightedFairQueue)

__all__ = [
    "ServingError", "QueueFullError", "RequestTimeoutError",
    "ServerClosedError", "EngineUnavailableError",
    "ServingStats", "TenantStats", "bucket_ladder", "select_bucket",
    "pad_to_bucket",
    "DecodeEngine", "PagedDecodeModel", "TinyDecoder", "params_from_jax",
    "FleetRouter",
    "PagedKVCache", "OutOfPagesError", "PrefixMatch",
    "DraftProposer", "PromptLookupDraft", "ModelDraft",
    "register_draft", "make_draft", "available_drafts",
    "Tenant", "TenantRegistry", "TenantBreaker",
    "TenantUnavailableError", "WeightedFairQueue", "PRIORITY_CLASSES",
]
