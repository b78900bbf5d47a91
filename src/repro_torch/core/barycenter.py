"""2-Wasserstein barycenters of Gaussians (paper §3.2, point 3).

Mirrors ``repro.core.barycenter``. For Gaussians {N(μ_j, Σ_j)} the
barycenter is Gaussian (Mallasto & Feragen 2017, Thm 4) with

    μ* = J⁻¹ Σ_j μ_j
    Σ* = the unique PSD root of   Σ* = J⁻¹ Σ_j (Σ*^{1/2} Σ_j Σ*^{1/2})^{1/2}

solved by fixed-point iteration (Álvarez-Esteban et al., 2016). When every
Σ_j is diagonal the solution is analytic: mean of the μ_j and of the σ_j.

Matrix square roots take leading batch axes: the J inner roots of one
fixed-point step are ONE batched call on (J, d, d), which is what the
reference's ``jax.vmap`` over its Pallas kernel does (a batch grid axis;
the CUDA step kernel launches from raw pointers, so ``torch.func.vmap``
cannot batch it). Two backends:

  * :func:`sqrtm_eigh` — eigendecomposition; exact.
  * :func:`sqrtm_newton_schulz` — matmuls only; the plain form of the
    Newton–Schulz step kernel
    (:func:`repro_torch.kernels.wire.sqrtm_newton_schulz_fused`), which
    the fused wire plugs in instead.
"""
from __future__ import annotations

import inspect
from typing import Optional, Sequence

import torch
from torch.func import vmap

from repro_torch.kernels.ref import newton_schulz_sqrtm_ref


def diag_barycenter(mus: torch.Tensor, sigmas: torch.Tensor,
                    weights: Optional[torch.Tensor] = None):
    """Analytic barycenter for diagonal Gaussians: (mu*, sigma*), each (d,)."""
    if weights is None:
        return torch.mean(mus, dim=0), torch.mean(sigmas, dim=0)
    w = weights[:, None]
    return torch.sum(w * mus, dim=0), torch.sum(w * sigmas, dim=0)


def sqrtm_eigh(mat: torch.Tensor) -> torch.Tensor:
    """PSD matrix square root via symmetric eigendecomposition."""
    vals, vecs = torch.linalg.eigh(mat)
    vals = torch.clamp(vals, min=0.0)
    return (vecs * torch.sqrt(vals)[..., None, :]) @ vecs.mT


def sqrtm_newton_schulz(mat: torch.Tensor, num_iters: int = 25) -> torch.Tensor:
    """Newton–Schulz iteration for the PSD square root — matmuls only.

    Per matrix: Frobenius-normalize, iterate t = ½(3I − zy); y←yt, z←tz,
    rescale by √norm. Converges for PSD input. The plain form of
    :func:`repro_torch.kernels.wire.sqrtm_newton_schulz_fused`.
    """
    return newton_schulz_sqrtm_ref(mat, num_iters)


def gaussian_barycenter_cov(covs: torch.Tensor, weights: Optional[torch.Tensor] = None,
                            num_fp_iters: int = 50, sqrtm=sqrtm_eigh) -> torch.Tensor:
    """Fixed-point iteration for the barycenter covariance of (J, d, d) ``covs``.

    Each step takes one root of the iterate and one batched root of the J
    matrices ``root @ c_j @ root``; the products and weighted sums are
    plain tensor code (the reference leaves them to XLA too).
    """
    J = covs.shape[0]
    w = (torch.full((J,), 1.0 / J, dtype=covs.dtype, device=covs.device)
         if weights is None else weights)
    cov = torch.einsum("j,jab->ab", w, covs)  # start from the linear mixture
    for _ in range(num_fp_iters):
        root = sqrtm(cov)
        inner = sqrtm(root @ covs @ root)
        mixed = torch.einsum("j,jab->ab", w, inner)
        cov = 0.5 * (mixed + mixed.mT)  # symmetry against fp drift
    return cov


def gaussian_barycenter(mus: torch.Tensor, covs: torch.Tensor,
                        weights: Optional[torch.Tensor] = None, **kw):
    """(μ*, Σ*) for full-covariance Gaussians."""
    mu = torch.mean(mus, dim=0) if weights is None else torch.einsum("j,jd->d", weights, mus)
    return mu, gaussian_barycenter_cov(covs, weights=weights, **kw)


def wasserstein2_gaussian(mu1, cov1, mu2, cov2, sqrtm=sqrtm_eigh) -> torch.Tensor:
    """Squared 2-Wasserstein distance between Gaussians (Bures metric).

    W₂² = ||μ₁−μ₂||² + tr(Σ₁ + Σ₂ − 2 (Σ₁^{1/2} Σ₂ Σ₁^{1/2})^{1/2})
    """
    root1 = sqrtm(cov1)
    cross = sqrtm(root1 @ cov2 @ root1)
    bures = torch.trace(cov1) + torch.trace(cov2) - 2.0 * torch.trace(cross)
    return torch.sum((mu1 - mu2) ** 2) + torch.clamp(bures, min=0.0)


def barycenter_params_diag(family, params_list: Sequence[dict]) -> dict:
    """Barycenter of diagonal-Gaussian family members given as a list of
    params: the mean of the μ and of the σ = e^{log σ}, mapped back through
    ``family.from_moments``."""
    mus = torch.stack([p["mu"] for p in params_list])
    sigmas = torch.stack([torch.exp(p["log_sigma"]) for p in params_list])
    mu, sigma = diag_barycenter(mus, sigmas)
    return family.from_moments(mu, sigma)


def barycenter_params_full(family, params_list: Sequence[dict], **kw) -> dict:
    """Barycenter of full-covariance family members given as a list of params."""
    mus = torch.stack([p["mu"] for p in params_list])
    covs = torch.stack([family.covariance(p) for p in params_list])
    mu, cov = gaussian_barycenter(mus, covs, **kw)
    return family.from_moments(mu, cov)


def family_barycenter(family, stacked_params, weights: torch.Tensor, aggregator=None,
                      *, sqrtm=sqrtm_newton_schulz, num_fp_iters: int = 50,
                      sqrtm_iters: int = 40):
    """W2 barycenter of J family members through the moment bridge.

    Map the stacked parameters to moments (``vmap(to_moments)``), merge in
    moment space, map back with ``from_moments``. Dispatch on
    ``family.moment_form``:

      * ``"diag"`` — analytic: ``aggregator.combine`` (or the normalized
        weighted mean) merges the means and the standard deviations.
      * ``"full"`` — the aggregator merges the means; the covariance is the
        weight-based fixed point (weights normalized to the simplex) with
        the ``sqrtm`` backend. ``sqrtm_iters`` is forwarded as
        ``num_iters`` to any backend whose signature takes it.
    """
    form = getattr(family, "moment_form", None)
    if not getattr(family, "has_moments", False) or form is None:
        raise ValueError(
            f"eta_mode='barycenter' needs a family with to_moments/"
            f"from_moments; {type(family).__name__} has none — use "
            f"eta_mode='param'")
    means, seconds = vmap(family.to_moments)(stacked_params)

    def combine(stacked):
        if aggregator is not None:
            return aggregator.combine(stacked, weights)
        w = weights / torch.clamp(torch.sum(weights), min=1e-12)
        return torch.tensordot(w, stacked, dims=1)

    if form == "diag":
        return family.from_moments(combine(means), combine(seconds))
    if form != "full":
        raise ValueError(f"unknown moment_form {form!r} (diag/full)")
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    try:
        takes_iters = "num_iters" in inspect.signature(sqrtm).parameters
    except (TypeError, ValueError):
        takes_iters = False
    root = (lambda m: sqrtm(m, num_iters=sqrtm_iters)) if takes_iters else sqrtm
    cov = gaussian_barycenter_cov(seconds, weights=w, num_fp_iters=num_fp_iters, sqrtm=root)
    return family.from_moments(combine(means), cov)
