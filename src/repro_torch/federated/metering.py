"""Byte accounting for federated exchanges — the single metering path.

Mirrors ``repro.federated.metering``: the meter bills ALGORITHM-level
bytes (what each silo ships), computed from shapes and dtypes only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

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
    """Algorithm-level bytes-on-wire accounting (host side, per round).

    ``sim_seconds`` accumulates the simulated wall-clock between the
    buffered-async engine's flushes (``async_engine.run_buffered``);
    synchronous rounds leave it at zero.

    ``bytes_gathered`` counts the encoded wire each rank of a multi-rank
    mesh assembled from the silo blocks (J_pad rows an exchange, every
    row gathered whether its silo was active or not); with J_pad == J and
    every silo active it equals ``bytes_up``. It is a run-time counter:
    the checkpointed :meth:`state_dict` is the reference's and omits it.
    """

    rounds: int = 0
    bytes_up: int = 0  # silo -> server (post-compression)
    bytes_down: int = 0  # server -> silo broadcast
    sim_seconds: float = 0.0  # simulated wall-clock (async latency model)
    bytes_gathered: int = 0  # wire assembled across ranks (not checkpointed)

    def record(self, up: int, down: int, sim_seconds: float = 0.0) -> None:
        """Log one round's realized (up, down) bytes [+ simulated time]."""
        self.rounds += 1
        self.bytes_up += int(up)
        self.bytes_down += int(down)
        self.sim_seconds += float(sim_seconds)

    @property
    def total(self) -> int:
        return self.bytes_up + self.bytes_down

    @property
    def per_round(self) -> float:
        return self.total / max(self.rounds, 1)

    def state_dict(self) -> Dict[str, Any]:
        """Serializable counters (checkpointed by ``federated.api``)."""
        return {"rounds": self.rounds, "bytes_up": self.bytes_up,
                "bytes_down": self.bytes_down,
                "sim_seconds": self.sim_seconds}

    def load_state(self, state: Dict[str, Any]) -> None:
        """Restore counters saved by :meth:`state_dict`."""
        self.rounds = int(state["rounds"])
        self.bytes_up = int(state["bytes_up"])
        self.bytes_down = int(state["bytes_down"])
        # Checkpoints written before the async clock lack the key (0.0).
        self.sim_seconds = float(state.get("sim_seconds", 0.0))
