"""mxnet_tpu_torch.fastpath: the fused optimizer apply, the port of
``mxnet_tpu/fastpath/`` as far as its :mod:`.fused` piece.

:func:`fused_apply` runs an optimizer's list kernel (``Optimizer.
_leaf_step`` over ``torch._foreach_*`` ops) once over every parameter of
a step, where the per-parameter loop calls it once per parameter.
``gluon.Trainer.step`` and ``module.Module.update`` route through
:func:`apply_updater`; ``MXNET_FASTPATH=0`` brings back the per-parameter
loop.

Not ported yet: buffer donation (the port updates in place, so there is
no stale handle to guard), ``bucketing``, ``cache`` and ``zero``.
"""
from __future__ import annotations

from ..base import get_env
from .fused import FusedApplyError, apply_updater, fused_apply

__all__ = ["enabled", "supports", "fused_apply", "apply_updater",
           "FusedApplyError"]


def enabled() -> bool:
    """Whether the fused apply is on (``MXNET_FASTPATH``, default on; read
    at every call so a live process can flip it)."""
    return bool(get_env("MXNET_FASTPATH", 1, int, cache=False))


def supports(optimizer, n_positions: int = 1) -> bool:
    """Whether ``optimizer`` can be fused for a caller holding
    ``n_positions`` device positions. The JAX package declines more than
    one position for optimizers whose host prologue is order-sensitive
    (Nadam, SGLD, an ``lr_scheduler``); the port has none of those, so
    every optimizer with a list kernel fuses."""
    return bool(getattr(optimizer, "fastpath_capable", False))
