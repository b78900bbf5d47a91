"""Variational families of the slice: ``DiagGaussian`` and ``ConditionalGaussian``.

Mirrors ``repro.core.families``:

    Z_G           = mu_G + sigma_G ⊙ eps_G                         (DiagGaussian)
    Z_{L_j} | Z_G = mu_bar_j + C_j (Z_G − mu_G) + sigma_j ⊙ eps_{L_j}

``ConditionalGaussian`` supports both ``use_coupling`` values; the
unitriangular factor (``use_chol=True``) is not ported yet and raises.
Initial values come from an explicit ``torch.Generator`` (the reference
draws from ``jax.random``, so the two inits differ; parity tests start
both sides from one state).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch.core.family import VariationalFamily

Params = Dict[str, torch.Tensor]

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class DiagGaussian(VariationalFamily):
    """Mean-field Gaussian: z = mu + sigma ⊙ eps. The paper's workhorse family."""

    dim: int

    has_moments = True
    moment_form = "diag"

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {"mu": (self.dim,), "log_sigma": (self.dim,)}

    def init(self, gen: torch.Generator, *, mu_scale: float = 0.01,
             log_sigma_init: float = -2.0) -> Params:
        device = gen.device
        return {
            "mu": mu_scale * torch.randn((self.dim,), generator=gen, device=device),
            "log_sigma": torch.full((self.dim,), log_sigma_init,
                                    dtype=torch.float32, device=device),
        }

    def sample(self, params: Params, eps: torch.Tensor) -> torch.Tensor:
        return params["mu"] + torch.exp(params["log_sigma"]) * eps

    def log_prob(self, params: Params, z: torch.Tensor) -> torch.Tensor:
        sigma = torch.exp(params["log_sigma"])
        eps = (z - params["mu"]) / sigma
        return (-0.5 * torch.sum(eps**2) - torch.sum(params["log_sigma"])
                - 0.5 * self.dim * _LOG_2PI)

    def entropy(self, params: Params) -> torch.Tensor:
        return torch.sum(params["log_sigma"]) + 0.5 * self.dim * (1.0 + _LOG_2PI)

    def to_moments(self, params: Params):
        """(mean, marginal std) — consumed by the Wasserstein barycenter."""
        return params["mu"], torch.exp(params["log_sigma"])

    def from_moments(self, mu: torch.Tensor, sigma: torch.Tensor) -> Params:
        return {"mu": mu, "log_sigma": torch.log(sigma)}


@dataclasses.dataclass(frozen=True)
class ConditionalGaussian(VariationalFamily):
    """q(Z_L | Z_G) = N(mu_bar + C (z_G − mu_G), diag(sigma²))  (paper §3.1).

    ``use_coupling=False`` drops C (mean-field across the G/L boundary).
    """

    dim: int
    global_dim: int
    use_coupling: bool = True
    use_chol: bool = False

    conditional = True

    def __post_init__(self):
        if self.use_chol:
            raise NotImplementedError(
                "ConditionalGaussian(use_chol=True) is not ported yet; the "
                "unitriangular factor arrives with CholeskyGaussian")

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        shapes: Dict[str, Tuple[int, ...]] = {
            "mu_bar": (self.dim,),
            "log_sigma": (self.dim,),
        }
        if self.use_coupling:
            shapes["C"] = (self.dim, self.global_dim)
        return shapes

    def mean(self, params: Params) -> torch.Tensor:
        return params["mu_bar"]

    def init(self, gen: torch.Generator, *, mu_scale: float = 0.01,
             log_sigma_init: float = -2.0) -> Params:
        device = gen.device
        params = {
            "mu_bar": mu_scale * torch.randn((self.dim,), generator=gen, device=device),
            "log_sigma": torch.full((self.dim,), log_sigma_init,
                                    dtype=torch.float32, device=device),
        }
        if self.use_coupling:
            params["C"] = torch.zeros((self.dim, self.global_dim), device=device)
        return params

    def _cond_mean(self, params: Params, z_G, mu_G):
        mean = params["mu_bar"]
        if self.use_coupling:
            mean = mean + params["C"] @ (z_G - mu_G)
        return mean

    def sample(self, params: Params, z_G: torch.Tensor, mu_G: torch.Tensor,
               eps: torch.Tensor) -> torch.Tensor:
        return self._cond_mean(params, z_G, mu_G) + torch.exp(params["log_sigma"]) * eps

    def log_prob(self, params: Params, z_L: torch.Tensor, z_G: torch.Tensor,
                 mu_G: torch.Tensor) -> torch.Tensor:
        resid = z_L - self._cond_mean(params, z_G, mu_G)
        eps = resid / torch.exp(params["log_sigma"])
        return (-0.5 * torch.sum(eps**2) - torch.sum(params["log_sigma"])
                - 0.5 * self.dim * _LOG_2PI)

    def entropy(self, params: Params) -> torch.Tensor:
        """H[q(Z_L | Z_G)] — independent of z_G."""
        return torch.sum(params["log_sigma"]) + 0.5 * self.dim * (1.0 + _LOG_2PI)
