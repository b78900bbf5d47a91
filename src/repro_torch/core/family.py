"""The variational-family protocol (mirrors ``repro.core.family``).

Families are frozen dataclasses deriving from :class:`VariationalFamily`.
Capability flags replace type probes:

  * ``conditional`` — the family parameterizes q(Z_L | Z_G); its
    ``sample``/``log_prob`` take ``(params, z_G, mu_G, eps)`` /
    ``(params, z_L, z_G, mu_G)``;
  * ``eps_shape`` — the shape of the N(0, I) draw ``sample`` consumes;
  * ``has_moments`` + ``moment_form`` — whether the Gaussian moment
    bridge (``to_moments``/``from_moments``) exists, and its form.

Parameters are plain dicts of tensors with the reference's key names.
"""
from __future__ import annotations

from typing import Any, ClassVar, Dict, Optional, Tuple

import torch

from repro_torch.core.flatten import VectorSpec

Params = Dict[str, torch.Tensor]


class VariationalFamily:
    """Protocol base class for variational families (see module docstring)."""

    conditional: ClassVar[bool] = False
    has_moments: ClassVar[bool] = False
    moment_form: ClassVar[Optional[str]] = None  # "diag" | "full" | None

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Name -> shape of every parameter leaf (defines the pack layout)."""
        raise NotImplementedError

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return ()

    @property
    def eps_shape(self) -> Tuple[int, ...]:
        return self.batch_shape + (self.dim,)  # type: ignore[attr-defined]

    @property
    def num_params(self) -> int:
        return self.vector_spec.dim

    @property
    def vector_spec(self) -> VectorSpec:
        return VectorSpec.create(self.param_shapes())

    def pack(self, params: Params) -> torch.Tensor:
        return self.vector_spec.pack(params)

    def unpack(self, vec: torch.Tensor) -> Params:
        return self.vector_spec.unpack(vec)

    def init(self, gen: torch.Generator, **kwargs) -> Params:
        raise NotImplementedError

    def sample(self, params: Params, *args) -> torch.Tensor:
        raise NotImplementedError

    def log_prob(self, params: Params, *args) -> torch.Tensor:
        raise NotImplementedError

    def entropy(self, params: Params) -> torch.Tensor:
        raise NotImplementedError

    def mean(self, params: Params) -> torch.Tensor:
        """The (unconditional) mean — the μ the C-coupling centers on."""
        return params["mu"]

    def to_moments(self, params: Params):
        raise NotImplementedError(
            f"{type(self).__name__} exposes no Gaussian moments")

    def from_moments(self, mean, second) -> Params:
        raise NotImplementedError(
            f"{type(self).__name__} exposes no Gaussian moments")


def eps_shape(family: Any) -> Tuple[int, ...]:
    """Shape of the N(0, I) draw ``family.sample`` consumes."""
    return tuple(family.eps_shape)


def is_conditional(family: Any) -> bool:
    """True when ``family`` parameterizes q(Z_L | Z_G) (the C-coupling)."""
    return bool(getattr(family, "conditional", False))


def supports_moments(family: Any) -> bool:
    """True when ``family`` exposes the to_moments/from_moments bridge."""
    return bool(getattr(family, "has_moments", False))
