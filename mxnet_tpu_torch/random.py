"""``mx.random``: global seeding, the port of ``mxnet_tpu/random.py``.

Two streams, seeded together by :func:`seed`:

* :func:`np_rng` — the host ``RandomState`` that one-time setup draws
  from (weight init in ``initializer.py``), seeded exactly as the JAX
  package seeds its own, so the same seed gives the same weights in both;
* :func:`generator` — an explicit ``torch.Generator`` for draws on the
  device. Its numbers differ from the JAX package's PRNG keys for the same
  seed; the GPT path draws nothing from it.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["seed", "np_rng", "generator"]

_NP_RNG = np.random.RandomState()
_GENERATORS = {}
_SEED = {"value": None}


def np_rng() -> np.random.RandomState:
    """Host-side RNG stream used for one-time setup (weight init)."""
    return _NP_RNG


def generator(device="cpu") -> torch.Generator:
    """The device stream's ``torch.Generator`` for ``device``."""
    dev = torch.device(device)
    key = str(dev)
    if key not in _GENERATORS:
        gen = torch.Generator(device=dev)
        if _SEED["value"] is not None:
            gen.manual_seed(_SEED["value"])
        _GENERATORS[key] = gen
    return _GENERATORS[key]


def seed(seed_state, ctx="all"):
    """Seed every stream (MXNet's ``mx.random.seed``; one stream per
    device, as the JAX package collapses per-ctx seeding to one)."""
    np.random.seed(seed_state % (2 ** 32))
    _NP_RNG.seed(seed_state % (2 ** 32))
    _SEED["value"] = int(seed_state)
    for gen in _GENERATORS.values():
        gen.manual_seed(_SEED["value"])
