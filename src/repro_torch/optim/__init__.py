"""Optimizers with the optax-style contract of ``repro.optim``.

``init(params) -> state``, ``update(grads, state, params) -> (updates,
state)`` and ``apply_updates(params, updates)``, over dict pytrees of
tensors.
"""
from repro_torch.optim.adam import ScaleByAdamState, adam, adamw, scale_by_adam
from repro_torch.optim.base import (
    GradientTransformation,
    apply_updates,
    chain,
    clip_by_global_norm,
    scale,
)
from repro_torch.optim.sgd import momentum, sgd

__all__ = [
    "GradientTransformation",
    "ScaleByAdamState",
    "adam",
    "adamw",
    "apply_updates",
    "chain",
    "clip_by_global_norm",
    "momentum",
    "scale",
    "scale_by_adam",
    "sgd",
]
