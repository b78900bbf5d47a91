"""Adam / AdamW (Kingma & Ba, 2015) — the optimizer used by every paper experiment.

State layout equals ``repro.optim.adam``: ``adam`` is
``chain(scale_by_adam, scale)``, so its state is the tuple
``(ScaleByAdamState(count, mu, nu), ())`` with an int32 ``count``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.optim.base import GradientTransformation, chain, scale
from repro_torch.tree import tree_leaves, tree_map


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: object  # first-moment pytree
    nu: object  # second-moment pytree


def scale_by_adam(
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    mu_dtype: Optional[torch.dtype] = None,
) -> GradientTransformation:
    def init(params):
        mu = tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype or p.dtype), params)
        nu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        leaves = tree_leaves(params)
        count = torch.zeros((), dtype=torch.int32,
                            device=leaves[0].device if leaves else None)
        return ScaleByAdamState(count=count, mu=mu, nu=nu)

    def update(grads, state, params=None):
        del params
        count = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1.0 - b1) * g.to(m.dtype), state.mu, grads)
        nu = tree_map(
            lambda v, g: b2 * v + (1.0 - b2) * torch.square(g.float()), state.nu, grads)
        bc1 = 1.0 - b1 ** count.float()
        bc2 = 1.0 - b2 ** count.float()
        updates = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps), mu, nu)
        return updates, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def adam(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    maximize: bool = False,
) -> GradientTransformation:
    """Adam. ``maximize=True`` flips the sign (VI *maximizes* the ELBO)."""
    sign = 1.0 if maximize else -1.0
    return chain(scale_by_adam(b1=b1, b2=b2, eps=eps), scale(sign * learning_rate))


class AdamWState(NamedTuple):
    adam: ScaleByAdamState


def adamw(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
) -> GradientTransformation:
    inner = scale_by_adam(b1=b1, b2=b2, eps=eps)

    def init(params):
        return AdamWState(adam=inner.init(params))

    def update(grads, state, params):
        updates, adam_state = inner.update(grads, state.adam, params)
        updates = tree_map(
            lambda u, p: -learning_rate * (u + weight_decay * p.to(u.dtype)),
            updates, params)
        return updates, AdamWState(adam=adam_state)

    return GradientTransformation(init, update)
