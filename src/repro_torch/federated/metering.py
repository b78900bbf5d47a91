"""Byte accounting for federated exchanges — the single metering path.

Mirrors ``repro.federated.metering``: the meter bills ALGORITHM-level
bytes (what each silo ships), computed from shapes and dtypes only.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_leaves

PyTree = Any


def is_array(x: Any) -> bool:
    """True for the leaves that occupy wire bytes (tensors or numpy arrays)."""
    return isinstance(x, (torch.Tensor, np.ndarray))


def _itemsize(x) -> int:
    return x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize


def tree_bytes(tree: PyTree) -> int:
    """Metered size of a message pytree in bytes (Σ elements × itemsize)."""
    return sum(int(np.prod(x.shape)) * _itemsize(x)
               for x in tree_leaves(tree) if is_array(x))


@dataclasses.dataclass
class CommMeter:
    """Algorithm-level bytes-on-wire accounting (host side, per round)."""

    rounds: int = 0
    bytes_up: int = 0  # silo -> server (post-compression)
    bytes_down: int = 0  # server -> silo broadcast

    def record(self, up: int, down: int) -> None:
        """Log one round's realized (up, down) bytes."""
        self.rounds += 1
        self.bytes_up += int(up)
        self.bytes_down += int(down)

    @property
    def total(self) -> int:
        return self.bytes_up + self.bytes_down

    @property
    def per_round(self) -> float:
        return self.total / max(self.rounds, 1)
