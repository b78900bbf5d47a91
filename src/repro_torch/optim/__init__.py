"""Optimizers with the optax-style contract of ``repro.optim``.

``init(params) -> state``, ``update(grads, state, params) -> (updates,
state)`` and ``apply_updates(params, updates)``, over dict pytrees of
tensors.
"""
from repro_torch.optim.adam import ScaleByAdamState, adam, adamw, scale_by_adam
from repro_torch.optim.base import (
    GradientTransformation,
    ScaleByScheduleState,
    apply_updates,
    chain,
    clip_by_global_norm,
    scale,
    scale_by_schedule,
)
from repro_torch.optim.schedules import (
    constant_schedule,
    cosine_decay_schedule,
    linear_warmup_cosine_decay,
    warmup_schedule,
)
from repro_torch.optim.sgd import momentum, sgd

__all__ = [
    "GradientTransformation",
    "ScaleByAdamState",
    "ScaleByScheduleState",
    "adam",
    "adamw",
    "apply_updates",
    "chain",
    "clip_by_global_norm",
    "constant_schedule",
    "cosine_decay_schedule",
    "linear_warmup_cosine_decay",
    "momentum",
    "scale",
    "scale_by_adam",
    "scale_by_schedule",
    "sgd",
    "warmup_schedule",
]
