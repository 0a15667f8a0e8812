"""``mx.random``: seeding, the samplers and the state of every stream,
the port of ``mxnet_tpu/random.py``.

Two kinds of stream, seeded together by :func:`seed`:

* :func:`np_rng` — the host ``RandomState`` that one-time setup draws
  from (weight init in ``initializer.py``), seeded exactly as the JAX
  package seeds its own, so the same seed gives the same weights in both;
* :func:`generator` — one explicit ``torch.Generator`` a device, which
  every draw on that device takes (the sampling ops, dropout). Nothing in
  the port draws from torch's global generator. Its numbers differ from
  the JAX package's PRNG keys for the same seed (a kept deviation).

:func:`get_state` snapshots every generator, ``np_rng`` and numpy's global
stream; :func:`set_state` puts them back, so the run after it replays the
draws made after the snapshot, one for one. The samplers (``uniform``,
``normal``, ...) are ``nd.random``'s.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["seed", "np_rng", "generator", "get_state", "set_state",
           "uniform", "normal", "randn", "randint", "exponential", "gamma",
           "poisson", "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle"]

_NP_RNG = np.random.RandomState()
_GENERATORS = {}
_SEED = {"value": None}


def np_rng() -> np.random.RandomState:
    """Host-side RNG stream used for one-time setup (weight init)."""
    return _NP_RNG


def _key(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def generator(device="cpu") -> torch.Generator:
    """The device stream's ``torch.Generator`` for ``device`` (``cuda``
    and ``cuda:0`` name the same one)."""
    key = _key(device)
    if key not in _GENERATORS:
        gen = torch.Generator(device=key)
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


def get_state():
    """A picklable snapshot of every stream: each device generator's
    state (a CPU uint8 tensor), the seed new generators take, ``np_rng``'s
    and numpy's global state."""
    return {
        "generators": {k: g.get_state() for k, g in _GENERATORS.items()},
        "seed": _SEED["value"],
        "np_rng": _NP_RNG.get_state(),
        "np_global": np.random.get_state(),
    }


def set_state(state):
    """Restore a :func:`get_state` snapshot. A generator made after the
    snapshot is dropped, so it is made again, seeded, at its next use, as
    it was in the run that took the snapshot."""
    _SEED["value"] = state["seed"]
    for key in list(_GENERATORS):
        if key not in state["generators"]:
            del _GENERATORS[key]
    for key, st in state["generators"].items():
        generator(key).set_state(st)
    _NP_RNG.set_state(state["np_rng"])
    np.random.set_state(state["np_global"])


def _sampler(name):
    def fn(*args, **kwargs):
        from .ndarray import random as nd_random

        return getattr(nd_random, name)(*args, **kwargs)

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = "``nd.random.%s``." % name
    return fn


uniform = _sampler("uniform")
normal = _sampler("normal")
randn = _sampler("randn")
randint = _sampler("randint")
exponential = _sampler("exponential")
gamma = _sampler("gamma")
poisson = _sampler("poisson")
negative_binomial = _sampler("negative_binomial")
generalized_negative_binomial = _sampler("generalized_negative_binomial")
multinomial = _sampler("multinomial")
shuffle = _sampler("shuffle")
