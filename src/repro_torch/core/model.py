"""The structured latent-variable model contract (paper eqs. (1)–(3)).

A model supplies two log-density callables over tensors,

    log_prior_global(theta, z_G)          = log p_θ(Z_G)
    log_local(theta, z_G, z_L, data_j)    = log p_θ(y_j, Z_{L_j} | Z_G)

plus an optional ``predict`` and the latent dimensionalities. Models with
no local latents set ``local_dim=0`` and receive ``z_L=None``; models
with θ = ∅ pass an empty dict.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

LogDensity = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StructuredModel:
    """Generative model p_θ(Z_G) ∏_j p_θ(y_j, Z_{L_j} | Z_G)."""

    global_dim: int
    local_dim: int  # n_{L_j}; 0 means Z_{L_j} = ∅
    log_prior_global: LogDensity  # (theta, z_G) -> scalar
    log_local: LogDensity  # (theta, z_G, z_L, data_j) -> scalar
    predict: Optional[Callable[..., Any]] = None
    name: str = "structured_model"

    @property
    def has_local(self) -> bool:
        return self.local_dim > 0


def empty_theta() -> dict:
    """θ = ∅ — fully-Bayesian inference over latents only."""
    return {}
