"""mxnet_tpu_torch.fastpath: the fused optimizer apply, the port of
``mxnet_tpu/fastpath/`` as far as its :mod:`.fused` piece.

:func:`fused_apply` runs an optimizer's list kernel (``Optimizer.
_leaf_step`` over ``torch._foreach_*`` ops) once over every parameter of
a step, where the per-parameter loop calls it once per parameter.
``gluon.Trainer.step`` and ``module.Module.update`` route through
:func:`apply_updater`; ``MXNET_FASTPATH=0`` brings back the per-parameter
loop.

:func:`tree_kernel` is the kernel's composition over the parameters,
``multi_precision`` pairs included; ``trainplane`` captures it inside its
whole step.

:mod:`.bucketing` packs small gradients into flat buckets for the
kvstore's aggregate phase across copies or ranks.

:mod:`.zero` shards the optimizer states over the job's ranks
(``MXNET_ZERO``); :func:`apply_updater` hands it the update first.

Not ported: buffer donation (the port updates in place, so there is no
stale handle to guard) and ``cache``.
"""
from __future__ import annotations

from ..base import get_env
from .fused import FusedApplyError, apply_updater, fused_apply, tree_kernel

__all__ = ["enabled", "supports", "fused_apply", "apply_updater",
           "tree_kernel", "FusedApplyError"]


def enabled() -> bool:
    """Whether the fused apply is on (``MXNET_FASTPATH``, default on; read
    at every call so a live process can flip it)."""
    return bool(get_env("MXNET_FASTPATH", 1, int, cache=False))


def supports(optimizer, n_positions: int = 1) -> bool:
    """Whether ``optimizer`` can be fused for a caller holding
    ``n_positions`` device positions. Optimizers whose host prologue is
    order-sensitive (``_host_scalars_stateful``: Nadam's schedule, SGLD's
    draws; or an ``lr_scheduler``, which reads the global ``num_update``)
    fuse for one position only, as in the JAX package
    (``mxnet_tpu/fastpath/__init__.py:76-92``): the fused path would
    reorder their prologue calls across positions."""
    if not getattr(optimizer, "fastpath_capable", False):
        return False
    if n_positions <= 1:
        return True
    return not (getattr(optimizer, "_host_scalars_stateful", False)
                or getattr(optimizer, "lr_scheduler", None) is not None)
