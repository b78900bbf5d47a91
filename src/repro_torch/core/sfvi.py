"""SFVI — Structured Federated Variational Inference (paper Algorithm 1 + S1).

The PyTorch twin of ``repro.core.sfvi``. With L̂_0 = log[p_θ(Z_G)/q(Z_G)]
and L̂_j = log[p_θ(y_j, Z_{L_j}|Z_G)/q(Z_{L_j}|Z_G)], one
``torch.func.grad_and_value`` of L̂_j over (θ, η_G, η_{L_j}) gives the
silo's (g_j^θ, g_j^η, ∇̂_{η_{L_j}}) of the supplement's (S5)–(S8); the
server's own term is the gradient of L̂_0.

STL: the variational parameters are ``.detach()``-ed inside the log q
terms only, never in the reparametrized samples.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.family import eps_shape, is_conditional
from repro_torch.core.model import StructuredModel
from repro_torch.tree import tree_map

PyTree = Any


def _stop(tree: PyTree) -> PyTree:
    return tree_map(lambda x: x.detach(), tree)


@dataclasses.dataclass(frozen=True)
class SFVIProblem:
    """Bundles the generative model with the variational families."""

    model: StructuredModel
    global_family: Any
    local_family: Optional[Any] = None

    # ---- objective pieces -------------------------------------------------

    def hat_L0(self, theta: PyTree, eta_G: PyTree, eps_G: torch.Tensor) -> torch.Tensor:
        """L̂_0 = log p_θ(Z_G) − log q_{η_G}(Z_G), STL-stopped inside log q."""
        z_G = self.global_family.sample(eta_G, eps_G)
        logq = self.global_family.log_prob(_stop(eta_G), z_G)
        return self.model.log_prior_global(theta, z_G) - logq

    def hat_Lj(self, theta, eta_G, eta_Lj, eps_G, eps_Lj, data_j,
               likelihood_scale=1.0) -> torch.Tensor:
        """L̂_j, times SFVI-Avg's N/N_j ``likelihood_scale`` (§3.2 point 2)."""
        z_G = self.global_family.sample(eta_G, eps_G)
        if self.model.has_local:
            z_L = self._sample_local(eta_Lj, z_G, eta_G, eps_Lj)
            logq = self._log_prob_local(_stop(eta_Lj), z_L, z_G, _stop(eta_G))
        else:
            z_L, logq = None, 0.0
        loglik = self.model.log_local(theta, z_G, z_L, data_j)
        return likelihood_scale * (loglik - logq)

    def _sample_local(self, eta_Lj, z_G, eta_G, eps_Lj):
        fam = self.local_family
        if is_conditional(fam):
            return fam.sample(eta_Lj, z_G, self.global_family.mean(eta_G), eps_Lj)
        return fam.sample(eta_Lj, eps_Lj)

    def _log_prob_local(self, eta_Lj, z_L, z_G, eta_G):
        fam = self.local_family
        if is_conditional(fam):
            return fam.log_prob(eta_Lj, z_L, z_G, self.global_family.mean(eta_G))
        return fam.log_prob(eta_Lj, z_L)

    # ---- per-silo gradient computation ------------------------------------

    def silo_grads(self, theta, eta_G, eta_Lj, eps_G, eps_Lj, data_j,
                   likelihood_scale=1.0) -> Tuple[PyTree, PyTree, Optional[PyTree], torch.Tensor]:
        """Returns (g_j^θ, g_j^η, ∇̂_{η_{L_j}}L, L̂_j)."""
        if self.model.has_local:
            def obj(th, eg, el):
                return self.hat_Lj(th, eg, el, eps_G, eps_Lj, data_j, likelihood_scale)

            (g_theta, g_eta, g_local), val = grad_and_value(
                obj, argnums=(0, 1, 2))(theta, eta_G, eta_Lj)
        else:
            def obj(th, eg):
                return self.hat_Lj(th, eg, None, eps_G, None, data_j, likelihood_scale)

            (g_theta, g_eta), val = grad_and_value(obj, argnums=(0, 1))(theta, eta_G)
            g_local = None
        return g_theta, g_eta, g_local, val

    def server_grads(self, theta, eta_G, eps_G) -> Tuple[PyTree, PyTree, torch.Tensor]:
        """The server's own contribution: gradients of L̂_0."""
        (g_theta, g_eta), val = grad_and_value(self.hat_L0, argnums=(0, 1))(
            theta, eta_G, eps_G)
        return g_theta, g_eta, val

    # ---- single-machine reference (for the partition-invariance Remark) ---

    def centralized_objective(self, theta, eta_G, eta_L_all: Optional[Sequence],
                              eps_G, eps_L_all: Optional[Sequence],
                              data_all: Sequence) -> torch.Tensor:
        """L̂ = L̂_0 + Σ_j L̂_j in one graph — the single-silo answer.

        The paper's Remark (§3): SFVI is invariant to data partitioning;
        this is the oracle the property test compares the federated
        gradient against.
        """
        total = self.hat_L0(theta, eta_G, eps_G)
        for j, data_j in enumerate(data_all):
            eta_Lj = eta_L_all[j] if eta_L_all is not None else None
            eps_Lj = eps_L_all[j] if eps_L_all is not None else None
            total = total + self.hat_Lj(theta, eta_G, eta_Lj, eps_G, eps_Lj, data_j)
        return total

    # ---- convenience ------------------------------------------------------

    def sample_posterior(self, eta_G, eta_L,
                         draws: Union[torch.Generator, Tuple[torch.Tensor, Optional[torch.Tensor]]],
                         num_samples: int = 1):
        """Draw (Z_G, Z_L) from the variational posterior (for prediction).

        ``draws`` is a generator (ε_G, then ε_L, each with a leading
        ``num_samples`` axis) or the injected pair ``(eps_G, eps_L)``;
        Z_L is None when the model has no local latents or ``eta_L`` is None.
        """
        local = self.model.has_local and eta_L is not None
        if isinstance(draws, torch.Generator):
            def draw(fam):
                return torch.randn((num_samples,) + eps_shape(fam), generator=draws,
                                   device=draws.device)

            eps_G = draw(self.global_family)
            eps_L = draw(self.local_family) if local else None
        else:
            eps_G, eps_L = draws
        z_G = vmap(lambda e: self.global_family.sample(eta_G, e))(eps_G)
        if not local:
            return z_G, None
        z_L = vmap(lambda zg, e: self._sample_local(eta_L, zg, eta_G, e))(z_G, eps_L)
        return z_G, z_L
