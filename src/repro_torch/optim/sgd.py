"""SGD and momentum — used as baselines and in tests."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.base import GradientTransformation
from repro_torch.tree import tree_map


def sgd(learning_rate: float, maximize: bool = False) -> GradientTransformation:
    sign = 1.0 if maximize else -1.0

    def init(params):
        del params
        return ()

    def update(grads, state, params=None):
        del params
        return tree_map(lambda g: sign * learning_rate * g, grads), state

    return GradientTransformation(init, update)


class MomentumState(NamedTuple):
    velocity: object


def momentum(learning_rate: float, beta: float = 0.9) -> GradientTransformation:
    def init(params):
        return MomentumState(velocity=tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        del params
        velocity = tree_map(lambda v, g: beta * v + g, state.velocity, grads)
        updates = tree_map(lambda v: -learning_rate * v, velocity)
        return updates, MomentumState(velocity=velocity)

    return GradientTransformation(init, update)
