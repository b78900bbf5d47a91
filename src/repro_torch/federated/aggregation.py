"""Pluggable server-side aggregation and wire compression.

Mirrors ``repro.federated.aggregation``. An aggregator turns the stacked
``(J, ...)`` uploads plus the round's weights into one mean-like
estimate; a compressor sits on the silo→server edge. Capability
attributes tell the runtime which fused CUDA kernels compute them:
``fused_reduction`` ("mean"/"trimmed"; absent -> ``combine`` on the
dequantized matrix) and ``wire_codec`` ("identity"/"int8"; absent ->
per-silo ``encode``/``decode``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.federated.metering import is_array, tree_bytes
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

PyTree = Any


def _check_wire(wire: str) -> None:
    if wire not in ("flat", "fused", "legacy"):
        raise ValueError(f"unknown wire layout {wire!r} (flat/fused/legacy)")


def _tree_elements(tree: PyTree) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree) if is_array(x))


def _bcast_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape((mask.shape[0],) + (1,) * (x.ndim - 1))


@dataclasses.dataclass(frozen=True)
class MeanAggregator:
    """Weighted mean over the round's active silos (zero guard only at 0)."""

    fused_reduction = "mean"

    def combine(self, stacked: PyTree, mask: torch.Tensor) -> PyTree:
        total = torch.sum(mask)
        denom = torch.where(total > 0.0, total, torch.ones_like(total))
        return tree_map(
            lambda x: torch.sum(_bcast_mask(mask, x) * x, dim=0) / denom, stacked)


@dataclasses.dataclass(frozen=True)
class TrimmedMeanAggregator:
    """Coordinate-wise trimmed mean over active silos (Yin et al., 2018).

    Inactive silos sort to the top as a +inf sentinel and are masked by
    rank; k = min(⌊tf·n⌋, ⌊(n−1)/2⌋) values are dropped at each end.
    """

    fused_reduction = "trimmed"

    trim_frac: float = 0.1

    def combine(self, stacked: PyTree, mask: torch.Tensor) -> PyTree:
        active = (mask > 0.0).to(mask.dtype)
        any_active = torch.sum(active) > 0.0
        n_active = torch.clamp(torch.sum(active), min=1.0)
        k = torch.floor(self.trim_frac * n_active)
        k = torch.minimum(k, torch.floor((n_active - 1.0) / 2.0))

        def leaf(x):
            m = _bcast_mask(mask, x) > 0.0
            order = torch.sort(torch.where(m, x, torch.full_like(x, float("inf"))),
                               dim=0).values
            rank = torch.arange(x.shape[0], device=x.device).reshape(
                (-1,) + (1,) * (x.ndim - 1))
            keep = (rank >= k) & (rank < n_active - k)
            total = torch.sum(torch.where(keep, order, torch.zeros_like(order)), dim=0)
            mean = total / torch.clamp(torch.sum(keep, dim=0), min=1)
            return torch.where(any_active, mean, torch.zeros_like(mean))

        return tree_map(leaf, stacked)


@dataclasses.dataclass(frozen=True)
class NoCompression:
    """Identity codec: ships raw float leaves (4 bytes/element for f32)."""

    wire_codec = "identity"

    def encode(self, tree: PyTree) -> PyTree:
        return tree

    def decode(self, enc: PyTree) -> PyTree:
        return enc

    def wire_bytes(self, tree: PyTree, wire: str = "legacy") -> int:
        """``flat``/``fused``: 4 B per element; ``legacy``: native dtypes."""
        _check_wire(wire)
        if wire in ("flat", "fused"):
            return 4 * _tree_elements(tree)
        return tree_bytes(tree)


@dataclasses.dataclass(frozen=True)
class Int8Compressor:
    """Per-leaf symmetric int8 quantization: (round(x/s) : int8, s : f32)."""

    wire_codec = "int8"

    def encode(self, tree: PyTree) -> PyTree:
        leaves, treedef = tree_flatten(tree)

        def leaf(x):
            scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
            q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
            return {"q": q, "scale": scale.float()}

        return {"leaves": [leaf(x) for x in leaves], "treedef": treedef}

    def decode(self, enc: PyTree) -> PyTree:
        leaves = [d["q"].float() * d["scale"] for d in enc["leaves"]]
        return tree_unflatten(enc["treedef"], leaves)

    def wire_bytes(self, tree: PyTree, wire: str = "legacy") -> int:
        """``flat``/``fused``: P + 4 (one scale per silo); ``legacy``: per leaf."""
        _check_wire(wire)
        n = _tree_elements(tree)
        if wire in ("flat", "fused"):
            return n + 4
        return n + 4 * sum(1 for x in tree_leaves(tree) if is_array(x))
