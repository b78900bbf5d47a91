"""Flat-vector <-> structured packing (families, latents, wire payloads).

Two bijections, mirroring ``repro.core.flatten``:

  * :class:`VectorSpec` — named blocks <-> one flat vector, in the
    order the blocks were declared (models think in named blocks,
    families in flat vectors).
  * :class:`TreeSpec` — a pytree of tensor leaves <-> ONE contiguous
    float32 vector: the federated wire format. Leaves are taken in
    JAX's order (sorted dict keys, :mod:`repro_torch.tree`), so a port
    wire row agrees with the reference row column for column.

Both accept leading batch axes: ``TreeSpec.pack(tree, batch_ndim=1)``
packs a stacked ``(J, ...)`` tree into the ``(J, P)`` wire matrix, and
``unpack`` of a ``(J, P)`` matrix restores stacked leaves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import tree_flatten, tree_unflatten


def _numel(shape: Tuple[int, ...]) -> int:
    return int(math.prod(shape))


@dataclasses.dataclass(frozen=True)
class VectorSpec:
    shapes: Tuple[Tuple[str, Tuple[int, ...]], ...]

    @staticmethod
    def create(shapes: Dict[str, Tuple[int, ...]]) -> VectorSpec:
        return VectorSpec(tuple((k, tuple(v)) for k, v in shapes.items()))

    @property
    def dim(self) -> int:
        return sum(_numel(s) for _, s in self.shapes)

    def unpack(self, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, start = {}, 0
        lead = vec.shape[:-1]
        for name, shape in self.shapes:
            size = _numel(shape)
            out[name] = vec[..., start:start + size].reshape(lead + shape)
            start += size
        return out

    def pack(self, parts: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([parts[name].reshape(-1) for name, _ in self.shapes])


@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """Static descriptor of a pytree of tensor leaves: structure + shapes."""

    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]

    @classmethod
    def of(cls, tree: Any) -> TreeSpec:
        """Descriptor for ``tree``'s structure (values are ignored)."""
        leaves, treedef = tree_flatten(tree)
        return cls(
            treedef=treedef,
            shapes=tuple(tuple(x.shape) for x in leaves),
            dtypes=tuple(x.dtype for x in leaves),
        )

    @property
    def dim(self) -> int:
        """Total scalar count P of the packed vector."""
        return sum(_numel(s) for s in self.shapes)

    def pack(self, tree: Any, batch_ndim: int = 0) -> torch.Tensor:
        """Pytree -> (..., P) float32 wire vector(s).

        ``batch_ndim`` leading axes of every leaf are kept (a stacked
        ``(J, ...)`` tree packs to the ``(J, P)`` wire matrix).
        """
        leaves, _ = tree_flatten(tree)
        if not leaves:
            return torch.zeros((0,), dtype=torch.float32)
        lead = tuple(leaves[0].shape[:batch_ndim])
        return torch.cat(
            [x.float().reshape(lead + (-1,)) for x in leaves], dim=batch_ndim)

    def unpack(self, vec: torch.Tensor) -> Any:
        """Inverse of :meth:`pack`: leading axes of ``vec`` are kept."""
        leaves, off = [], 0
        lead = tuple(vec.shape[:-1])
        for shape, dtype in zip(self.shapes, self.dtypes, strict=True):
            size = _numel(shape)
            leaves.append(vec[..., off:off + size].reshape(lead + shape).to(dtype))
            off += size
        return tree_unflatten(self.treedef, leaves)
