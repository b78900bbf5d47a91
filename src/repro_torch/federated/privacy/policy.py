"""Per-silo differential privacy mechanism for federated uploads.

Mirrors ``repro.federated.privacy.policy``: the silo→server message of
one exchange (or its delta from the round's public broadcast) is clipped
to global L2 norm ``clip_norm`` and noised with per-coordinate std
``noise_multiplier * clip_norm`` BEFORE compression and the gather.

The one difference is where the randomness comes from. The reference
folds a threefry key per (round, step, silo); torch cannot reproduce that
stream, so here the standard-normal draw is an argument (``draw``, a
pytree shaped like the upload). The runtime draws it once per exchange
as a ``(J, P)`` tensor (or takes it from its ``draws`` hook), and the
flat and fused wires consume the same tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class PrivacyPolicy:
    """Clip-and-noise policy for one silo upload (see the reference)."""

    clip_norm: float = 1.0
    noise_multiplier: float = 1.0
    delta: float = 1e-5

    def __post_init__(self):
        if self.clip_norm <= 0:
            raise ValueError(f"clip_norm must be > 0, got {self.clip_norm}")
        if self.noise_multiplier < 0:
            raise ValueError(
                f"noise_multiplier must be >= 0, got {self.noise_multiplier}")
        if not (0.0 < self.delta < 1.0):
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")

    def global_norm(self, tree: PyTree) -> torch.Tensor:
        """Global L2 norm over every leaf of ``tree`` (0 for empty trees)."""
        leaves = tree_leaves(tree)
        if not leaves:
            return torch.zeros(())
        return torch.sqrt(sum(torch.sum(torch.square(x)) for x in leaves))

    def clip(self, tree: PyTree) -> PyTree:
        """Scale ``tree`` so its global L2 norm is at most ``clip_norm``."""
        norm = self.global_norm(tree)
        factor = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return tree_map(lambda x: x * factor, tree)

    def noise(self, tree: PyTree, draw: PyTree) -> PyTree:
        """``tree + (z·C)·draw`` with ``draw`` ~ N(0, I) shaped like ``tree``."""
        std = self.noise_multiplier * self.clip_norm
        return tree_map(lambda x, e: x + std * e, tree, draw)

    def privatize(self, tree: PyTree, draw: PyTree,
                  reference: Optional[PyTree] = None) -> PyTree:
        """Clip-and-noise ``tree`` (or its delta from ``reference``)."""
        if reference is not None:
            delta = tree_map(torch.sub, tree, reference)
            priv = self.noise(self.clip(delta), draw)
            return tree_map(torch.add, reference, priv)
        return self.noise(self.clip(tree), draw)
