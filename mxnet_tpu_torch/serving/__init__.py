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
* :mod:`.batcher`  — :class:`Server`: the request-granularity server
  (bounded submit queue, deadline-driven micro-batcher over a bucket
  ladder, load shedding, per-request timeout, error isolation, graceful
  drain, weighted-fair batch fill by tenant, retry and a circuit breaker
  per engine with a fallback engine);
* :mod:`.engine`   — the ``Engine`` interface: a live Gluon block
  (:class:`BlockEngine`) or a loaded ``aot`` artifact, a ``torch.export``
  program (:class:`StableHLOEngine`), each one CUDA graph a bucket rung;
* :mod:`.stats`, :mod:`.buckets`.

Typical use::

    from mxnet_tpu_torch import serving
    srv = serving.serve_block(net, sample_shape=(3, 224, 224))
    srv.warmup()                      # capture every bucket up front
    fut = srv.submit(image)           # thread-safe, from any thread
    probs = fut.result(timeout=1.0)
    srv.close()                       # graceful drain

Ring prefill is a later slice.
"""
from __future__ import annotations

from .batcher import (EngineUnavailableError, QueueFullError,
                      RequestTimeoutError, Server, ServerClosedError,
                      ServingError)
from .buckets import bucket_ladder, pad_to_bucket, select_bucket
from .engine import BlockEngine, Engine, StableHLOEngine
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
    "Engine", "BlockEngine", "StableHLOEngine",
    "Server", "ServingError", "QueueFullError", "RequestTimeoutError",
    "ServerClosedError", "EngineUnavailableError",
    "ServingStats", "TenantStats", "bucket_ladder", "select_bucket",
    "pad_to_bucket", "serve_block", "serve_stablehlo",
    "DecodeEngine", "PagedDecodeModel", "TinyDecoder", "params_from_jax",
    "FleetRouter",
    "PagedKVCache", "OutOfPagesError", "PrefixMatch",
    "DraftProposer", "PromptLookupDraft", "ModelDraft",
    "register_draft", "make_draft", "available_drafts",
    "Tenant", "TenantRegistry", "TenantBreaker",
    "TenantUnavailableError", "WeightedFairQueue", "PRIORITY_CLASSES",
]


def serve_block(block, sample_shape, dtype="float32", device=None,
                **kwargs) -> Server:
    """Serve a live (initialized) Gluon block.

    ``sample_shape`` is the per-request shape *without* the batch axis —
    the server stacks requests along a new leading axis before running
    the block. ``device``: where the :class:`BlockEngine` serves (the
    current context by default: the card unless inside
    ``with mx.cpu():``).
    """
    return Server(BlockEngine(block, dtype=dtype, device=device),
                  sample_shape, dtype=dtype, **kwargs)


def serve_stablehlo(out_dir: str, fallback_block=None, device=None,
                    **kwargs) -> Server:
    """Serve a loaded ``aot.export_model`` artifact.

    Reads ``manifest.json`` for the sample shape/dtype. Artifacts exported
    with ``poly_batch=True`` serve every bucket from one program;
    fixed-shape artifacts serve only the bucket equal to their exported
    batch size (the ladder collapses to it unless ``buckets`` is given).

    ``fallback_block`` (a live initialized Gluon block) arms degraded
    mode: if the artifact engine's circuit breaker trips, traffic falls
    to a :class:`BlockEngine` over that block before the server
    load-sheds.
    """
    from .. import aot

    manifest = aot.read_manifest(out_dir)
    sample_shape = tuple(manifest["input_shape"][1:])
    dtype = manifest.get("input_dtype", "float32")
    if not manifest.get("poly_batch") and kwargs.get("buckets") is None:
        # a fixed-shape artifact runs exactly one batch size: serve it as
        # the single bucket instead of failing every other rung
        kwargs["buckets"] = [int(manifest["input_shape"][0])]
    if fallback_block is not None and kwargs.get("fallback_engine") is None:
        kwargs["fallback_engine"] = BlockEngine(fallback_block, dtype=dtype,
                                                device=device)
    return Server(StableHLOEngine(out_dir, device=device), sample_shape,
                  dtype=dtype, **kwargs)
