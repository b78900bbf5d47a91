"""2-Wasserstein barycenters of Gaussians (paper §3.2, point 3) — diag form.

For diagonal Gaussians the barycenter is analytic (Mallasto & Feragen
2017): mean of the μ_j and mean of the σ_j. The full-covariance fixed
point (and its Newton–Schulz square root) waits for the slice that
ports ``CholeskyGaussian``; ``family_barycenter`` raises for any other
``moment_form``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.func import vmap


def diag_barycenter(mus: torch.Tensor, sigmas: torch.Tensor,
                    weights: Optional[torch.Tensor] = None):
    """Analytic barycenter for diagonal Gaussians: (mu*, sigma*), each (d,)."""
    if weights is None:
        return torch.mean(mus, dim=0), torch.mean(sigmas, dim=0)
    w = weights[:, None]
    return torch.sum(w * mus, dim=0), torch.sum(w * sigmas, dim=0)


def family_barycenter(family, stacked_params, weights: torch.Tensor, aggregator=None):
    """W2 barycenter of J family members through the moment bridge.

    ``moment_form == "diag"`` only: map the stacked parameters to moments,
    merge each with ``aggregator.combine`` (or the normalized weighted
    mean), and map back with ``from_moments``.
    """
    form = getattr(family, "moment_form", None)
    if not getattr(family, "has_moments", False) or form is None:
        raise ValueError(
            f"eta_mode='barycenter' needs a family with to_moments/"
            f"from_moments; {type(family).__name__} has none — use "
            f"eta_mode='param'")
    if form != "diag":
        raise NotImplementedError(
            f"moment_form {form!r} barycenters (the full-covariance fixed "
            "point) are not ported yet; only 'diag' is")
    means, seconds = vmap(family.to_moments)(stacked_params)

    def combine(stacked):
        if aggregator is not None:
            return aggregator.combine(stacked, weights)
        w = weights / torch.clamp(torch.sum(weights), min=1e-12)
        return torch.tensordot(w, stacked, dims=1)

    return family.from_moments(combine(means), combine(seconds))
