"""Core optimizer plumbing: GradientTransformation, chain, clipping.

The optax-style contract of ``repro.optim.base``: ``init(params) ->
state``, ``update(grads, state, params) -> (updates, state)`` and
``apply_updates(params, updates)``, with states in the same containers,
so a JAX optimizer state converts to the port's leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


class GradientTransformation(NamedTuple):
    """A pair of pure functions (init, update) — the optax contract."""

    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple]


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    """params <- params + updates (updates already carry the sign/LR)."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Compose gradient transformations left-to-right."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state, strict=True):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        del params
        return ()

    def update(grads, state, params=None):
        del params
        norm = global_norm(grads)
        factor = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
        return tree_map(lambda g: g * factor, grads), state

    return GradientTransformation(init, update)


def scale(factor: float) -> GradientTransformation:
    def init(params):
        del params
        return ()

    def update(grads, state, params=None):
        del params
        return tree_map(lambda g: g * factor, grads), state

    return GradientTransformation(init, update)


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor  # int32 0-d: the number of updates taken


def scale_by_schedule(schedule: Callable[[torch.Tensor], torch.Tensor]) -> GradientTransformation:
    """Scale the updates by ``schedule(count)``, then count one step."""

    def init(params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return ScaleByScheduleState(count=torch.zeros((), dtype=torch.int32, device=device))

    def update(grads, state, params=None):
        del params
        step_size = schedule(state.count)
        updates = tree_map(lambda g: g * step_size, grads)
        return updates, ScaleByScheduleState(count=state.count + 1)

    return GradientTransformation(init, update)
