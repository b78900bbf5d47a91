"""Variational families of the port (mirrors ``repro.core.families``).

The paper's structured Gaussian family:

    Z_G           = mu_G + sigma_G ⊙ (L_G @ eps_G)
    Z_{L_j} | Z_G = mu_bar_j + C_j (Z_G − mu_G) + sigma_j ⊙ (L_j @ eps_{L_j})

with L_G, L_j lower-unitriangular. ``DiagGaussian`` is L ≡ I;
``CholeskyGaussian`` carries the full unitriangular factor;
``ConditionalGaussian`` adds the coupling C_j (and L_j with
``use_chol=True``); ``LowRankGaussian`` is diag + rank r;
``BatchedDiagGaussian`` a batch of independent diagonal Gaussians.

Initial values come from an explicit ``torch.Generator`` (the reference
draws from ``jax.random``, so the two inits differ; parity tests start
both sides from one state).

Differences forced by PyTorch, each held against the reference in
``tests/test_torch_families_full.py``:

  * the unitriangular factor is built out of place
    (``eye.index_put((rows, cols), packed)``): an in-place ``m[rows, cols]
    = packed`` fails under ``torch.func.vmap``;
  * ``torch.linalg.cholesky`` raises on a matrix that is not positive
    definite where ``jnp.linalg.cholesky`` returns NaN, so
    ``from_moments`` uses ``cholesky_ex`` and fills a failed factor with
    NaN: a round never raises midway;
  * ``LowRankGaussian.from_moments`` runs ``eigh``, whose eigenvector
    signs are not unique: U may differ from the reference's by column
    signs (U Uᵀ and every density agree).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch.core.family import VariationalFamily, register_family

Params = Dict[str, torch.Tensor]

_LOG_2PI = math.log(2.0 * math.pi)


def _tril_indices(dim: int, device=None) -> torch.Tensor:
    """Strictly-lower (rows, cols), row-major: ``jnp.tril_indices(dim, k=-1)``."""
    return torch.tril_indices(dim, dim, offset=-1, device=device)


def _unpack_unitriangular(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """Packed strictly-lower entries -> lower-unitriangular (dim, dim) matrix."""
    mat = torch.eye(dim, dtype=packed.dtype, device=packed.device)
    if dim > 1:
        rows, cols = _tril_indices(dim, packed.device)
        mat = mat.index_put((rows, cols), packed)
    return mat


def _solve_lower(scaled: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``solve_triangular(scaled, b, lower=True)`` for a vector ``b``."""
    return torch.linalg.solve_triangular(scaled, b[:, None], upper=False)[:, 0]


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _full(shape, value, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=torch.float32, device=device)


@register_family("diag")
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
            "log_sigma": _full((self.dim,), log_sigma_init, device),
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


@register_family("cholesky")
@dataclasses.dataclass(frozen=True)
class CholeskyGaussian(VariationalFamily):
    """z = mu + sigma ⊙ (L eps), L lower-unitriangular (paper §3.1).

    Covariance = D L Lᵀ D with D = diag(sigma); log|det| = Σ log sigma.
    """

    dim: int

    has_moments = True
    moment_form = "full"

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {
            "mu": (self.dim,),
            "log_sigma": (self.dim,),
            "L_packed": (self.dim * (self.dim - 1) // 2,),
        }

    def init(self, gen: torch.Generator, *, mu_scale: float = 0.01,
             log_sigma_init: float = -2.0) -> Params:
        device = gen.device
        return {
            "mu": mu_scale * torch.randn((self.dim,), generator=gen, device=device),
            "log_sigma": _full((self.dim,), log_sigma_init, device),
            "L_packed": _zeros((self.dim * (self.dim - 1) // 2,), device),
        }

    def _chol(self, params: Params) -> torch.Tensor:
        sigma = torch.exp(params["log_sigma"])
        L = _unpack_unitriangular(params["L_packed"], self.dim)
        return sigma[:, None] * L  # scaled Cholesky factor of the covariance

    def sample(self, params: Params, eps: torch.Tensor) -> torch.Tensor:
        L = _unpack_unitriangular(params["L_packed"], self.dim)
        return params["mu"] + torch.exp(params["log_sigma"]) * (L @ eps)

    def log_prob(self, params: Params, z: torch.Tensor) -> torch.Tensor:
        eps = _solve_lower(self._chol(params), z - params["mu"])
        return (-0.5 * torch.sum(eps**2) - torch.sum(params["log_sigma"])
                - 0.5 * self.dim * _LOG_2PI)

    def entropy(self, params: Params) -> torch.Tensor:
        return torch.sum(params["log_sigma"]) + 0.5 * self.dim * (1.0 + _LOG_2PI)

    def covariance(self, params: Params) -> torch.Tensor:
        chol = self._chol(params)
        return chol @ chol.mT

    def to_moments(self, params: Params):
        """(mean, full covariance) — consumed by the full-Σ barycenter."""
        return params["mu"], self.covariance(params)

    def from_moments(self, mu: torch.Tensor, cov: torch.Tensor) -> Params:
        chol, info = torch.linalg.cholesky_ex(cov)
        # jnp.linalg.cholesky returns NaN for a matrix that is not PD.
        chol = torch.where(info[..., None, None] == 0, chol,
                           torch.full_like(chol, float("nan")))
        diag = torch.diagonal(chol, dim1=-2, dim2=-1)
        L = chol / diag[..., :, None]
        if self.dim > 1:
            rows, cols = _tril_indices(self.dim, cov.device)
            packed = L[..., rows, cols]
        else:
            packed = torch.zeros(mu.shape[:-1] + (0,), dtype=mu.dtype, device=mu.device)
        return {"mu": mu, "log_sigma": torch.log(diag), "L_packed": packed}


@register_family("lowrank")
@dataclasses.dataclass(frozen=True)
class LowRankGaussian(VariationalFamily):
    """z = mu + sigma ⊙ eps_d + U eps_r  with  Σ = diag(σ²) + U Uᵀ.

    ``eps_shape`` is ``(dim + rank,)``: the first ``dim`` coordinates
    drive the diagonal part, the last ``rank`` the factor. ``log_prob``
    uses the Woodbury identity and the matrix determinant lemma.
    """

    dim: int
    rank: int = 1

    has_moments = True
    moment_form = "full"

    def __post_init__(self):
        if not 1 <= self.rank <= self.dim:
            raise ValueError(f"rank must be in [1, dim={self.dim}], got {self.rank}")

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {
            "mu": (self.dim,),
            "log_sigma": (self.dim,),
            "U": (self.dim, self.rank),
        }

    @property
    def eps_shape(self) -> Tuple[int, ...]:
        return (self.dim + self.rank,)

    def init(self, gen: torch.Generator, *, mu_scale: float = 0.01,
             log_sigma_init: float = -2.0) -> Params:
        device = gen.device
        return {
            "mu": mu_scale * torch.randn((self.dim,), generator=gen, device=device),
            "log_sigma": _full((self.dim,), log_sigma_init, device),
            "U": _zeros((self.dim, self.rank), device),
        }

    def sample(self, params: Params, eps: torch.Tensor) -> torch.Tensor:
        eps_d, eps_r = eps[: self.dim], eps[self.dim:]
        return (params["mu"] + torch.exp(params["log_sigma"]) * eps_d
                + params["U"] @ eps_r)

    def _capacitance(self, params: Params) -> torch.Tensor:
        """M = I_r + Uᵀ D⁻¹ U with D = diag(σ²) (the Woodbury core)."""
        inv_d = torch.exp(-2.0 * params["log_sigma"])
        u = params["U"]
        eye = torch.eye(self.rank, dtype=u.dtype, device=u.device)
        return eye + (u.mT * inv_d) @ u

    def _logdet(self, params: Params) -> torch.Tensor:
        """log|Σ| = Σ log σ² + log|M| (matrix determinant lemma)."""
        _, logdet_m = torch.linalg.slogdet(self._capacitance(params))
        return 2.0 * torch.sum(params["log_sigma"]) + logdet_m

    def log_prob(self, params: Params, z: torch.Tensor) -> torch.Tensor:
        inv_d = torch.exp(-2.0 * params["log_sigma"])
        u = params["U"]
        x = z - params["mu"]
        dx = inv_d * x
        # Woodbury: Σ⁻¹x = D⁻¹x − D⁻¹U M⁻¹ Uᵀ D⁻¹ x
        utdx = u.mT @ dx
        w = torch.linalg.solve(self._capacitance(params), utdx)
        quad = torch.dot(x, dx) - torch.dot(utdx, w)
        return -0.5 * quad - 0.5 * self._logdet(params) - 0.5 * self.dim * _LOG_2PI

    def entropy(self, params: Params) -> torch.Tensor:
        return 0.5 * self._logdet(params) + 0.5 * self.dim * (1.0 + _LOG_2PI)

    def covariance(self, params: Params) -> torch.Tensor:
        u = params["U"]
        return torch.diag_embed(torch.exp(2.0 * params["log_sigma"])) + u @ u.mT

    def to_moments(self, params: Params):
        """(mean, full covariance) — the barycenter's ``"full"`` form."""
        return params["mu"], self.covariance(params)

    def from_moments(self, mu: torch.Tensor, cov: torch.Tensor,
                     num_iters: int = 200) -> Params:
        """Best diag + rank-r fit of ``cov`` by alternating projection.

        Alternates the top-r eigenpair factor of ``cov − diag(s)`` and the
        diagonal that matches ``diag(cov)`` given the factor, from the
        Guttman bound ``1 / diag(Σ⁻¹)`` (``repro/core/families.py:247-272``).
        """
        r = self.rank
        inv, _ = torch.linalg.inv_ex(cov)
        diag_s = torch.clamp(1.0 / torch.diagonal(inv), min=1e-12)
        u = torch.zeros((self.dim, r), dtype=cov.dtype, device=cov.device)
        cov_diag = torch.diagonal(cov)
        for _ in range(num_iters):
            vals, vecs = torch.linalg.eigh(cov - torch.diag(diag_s))
            top = torch.clamp(vals[-r:], min=0.0)
            u = vecs[:, -r:] * torch.sqrt(top)
            diag_s = torch.clamp(cov_diag - torch.sum(u * u, dim=1), min=1e-12)
        return {"mu": mu, "log_sigma": 0.5 * torch.log(diag_s), "U": u}


@register_family("conditional")
@dataclasses.dataclass(frozen=True)
class ConditionalGaussian(VariationalFamily):
    """q(Z_L | Z_G) = N(mu_bar + C (z_G − mu_G), D L Lᵀ D)  (paper §3.1).

    ``use_coupling=False`` drops C (mean-field across the G/L boundary);
    ``use_chol=False`` sets L ≡ I (the paper's choice for the GLMM).
    """

    dim: int
    global_dim: int
    use_coupling: bool = True
    use_chol: bool = False

    conditional = True

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        shapes: Dict[str, Tuple[int, ...]] = {
            "mu_bar": (self.dim,),
            "log_sigma": (self.dim,),
        }
        if self.use_coupling:
            shapes["C"] = (self.dim, self.global_dim)
        if self.use_chol:
            shapes["L_packed"] = (self.dim * (self.dim - 1) // 2,)
        return shapes

    def mean(self, params: Params) -> torch.Tensor:
        return params["mu_bar"]

    def init(self, gen: torch.Generator, *, mu_scale: float = 0.01,
             log_sigma_init: float = -2.0) -> Params:
        device = gen.device
        params = {
            "mu_bar": mu_scale * torch.randn((self.dim,), generator=gen, device=device),
            "log_sigma": _full((self.dim,), log_sigma_init, device),
        }
        if self.use_coupling:
            params["C"] = _zeros((self.dim, self.global_dim), device)
        if self.use_chol:
            params["L_packed"] = _zeros((self.dim * (self.dim - 1) // 2,), device)
        return params

    def _cond_mean(self, params: Params, z_G, mu_G):
        mean = params["mu_bar"]
        if self.use_coupling:
            mean = mean + params["C"] @ (z_G - mu_G)
        return mean

    def sample(self, params: Params, z_G: torch.Tensor, mu_G: torch.Tensor,
               eps: torch.Tensor) -> torch.Tensor:
        noise = eps
        if self.use_chol:
            noise = _unpack_unitriangular(params["L_packed"], self.dim) @ eps
        return self._cond_mean(params, z_G, mu_G) + torch.exp(params["log_sigma"]) * noise

    def log_prob(self, params: Params, z_L: torch.Tensor, z_G: torch.Tensor,
                 mu_G: torch.Tensor) -> torch.Tensor:
        resid = z_L - self._cond_mean(params, z_G, mu_G)
        if self.use_chol:
            L = _unpack_unitriangular(params["L_packed"], self.dim)
            eps = _solve_lower(torch.exp(params["log_sigma"])[:, None] * L, resid)
        else:
            eps = resid / torch.exp(params["log_sigma"])
        return (-0.5 * torch.sum(eps**2) - torch.sum(params["log_sigma"])
                - 0.5 * self.dim * _LOG_2PI)

    def entropy(self, params: Params) -> torch.Tensor:
        """H[q(Z_L | Z_G)] — independent of z_G (L is unitriangular)."""
        return torch.sum(params["log_sigma"]) + 0.5 * self.dim * (1.0 + _LOG_2PI)


@register_family("batched_diag")
@dataclasses.dataclass(frozen=True)
class BatchedDiagGaussian(VariationalFamily):
    """A batch of independent diagonal Gaussians, shape (batch, dim)."""

    batch: int
    dim: int

    has_moments = True
    moment_form = "diag"

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {"mu": (self.batch, self.dim), "log_sigma": (self.batch, self.dim)}

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return (self.batch,)

    def init(self, gen: torch.Generator, *, mu_scale: float = 0.01,
             log_sigma_init: float = -2.0) -> Params:
        device = gen.device
        return {
            "mu": mu_scale * torch.randn((self.batch, self.dim), generator=gen,
                                         device=device),
            "log_sigma": _full((self.batch, self.dim), log_sigma_init, device),
        }

    def sample(self, params: Params, eps: torch.Tensor) -> torch.Tensor:
        return params["mu"] + torch.exp(params["log_sigma"]) * eps

    def log_prob(self, params: Params, z: torch.Tensor) -> torch.Tensor:
        eps = (z - params["mu"]) / torch.exp(params["log_sigma"])
        return (-0.5 * torch.sum(eps**2) - torch.sum(params["log_sigma"])
                - 0.5 * self.batch * self.dim * _LOG_2PI)

    def entropy(self, params: Params) -> torch.Tensor:
        return (torch.sum(params["log_sigma"])
                + 0.5 * self.batch * self.dim * (1.0 + _LOG_2PI))

    def to_moments(self, params: Params):
        """(mean, marginal std), both (batch, dim) — elementwise diag form."""
        return params["mu"], torch.exp(params["log_sigma"])

    def from_moments(self, mu: torch.Tensor, sigma: torch.Tensor) -> Params:
        return {"mu": mu, "log_sigma": torch.log(sigma)}
