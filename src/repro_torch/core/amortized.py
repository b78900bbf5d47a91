"""Amortized inference (paper Remark, §3.2), the port of ``repro.core.amortized``.

Instead of training η_{L_j} directly, an inference network f_φ maps each
observation to its local variational parameters, η_{L_{j,k}} = f_φ(y_{j,k}).
φ is part of θ, so SFVI trains it with the summed silo gradients and never
exposes per-observation posteriors. The encoder is a small MLP giving
(μ, log σ) per observation. The population engine uses the deterministic
:func:`encoder_warm_init` to warm-start a joining silo's η_L.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.tree import tree_map

_LOG_2PI = math.log(2.0 * math.pi)


def encoder_init(gen: torch.Generator, in_dim: int, hidden: int,
                 latent_dim: int) -> Dict[str, Any]:
    """Random encoder weights from ``gen`` (three draws, in the reference's order)."""
    dev = gen.device
    s1 = 1.0 / math.sqrt(in_dim)
    s2 = 1.0 / math.sqrt(hidden)
    w1 = s1 * torch.randn((in_dim, hidden), generator=gen, device=dev)
    w_mu = s2 * torch.randn((hidden, latent_dim), generator=gen, device=dev)
    w_ls = 0.1 * s2 * torch.randn((hidden, latent_dim), generator=gen, device=dev)
    return {
        "w1": w1,
        "b1": torch.zeros((hidden,), device=dev),
        "w_mu": w_mu,
        "b_mu": torch.zeros((latent_dim,), device=dev),
        "w_ls": w_ls,
        "b_ls": torch.full((latent_dim,), -1.0, device=dev),
    }


def encoder_warm_init(in_dim: int, latent_dim: int, *, pre_scale: float = 0.1,
                      gain: float = 1.0, log_sigma: float = -1.0,
                      device=None) -> Dict[str, Any]:
    """Deterministic near-linear encoder for cold-silo warm starts.

    No draw, so a resumed run re-derives it bit for bit: the hidden layer
    is a scaled identity inside tanh's linear range and the mean head
    averages it back, so ``encode(φ, y)[0][k] ≈ gain · mean_i y[k, i]``;
    the log-σ head is the constant ``log_sigma``.
    """
    return {
        "w1": pre_scale * torch.eye(in_dim, device=device),
        "b1": torch.zeros((in_dim,), device=device),
        "w_mu": torch.full((in_dim, latent_dim), gain / (pre_scale * in_dim), device=device),
        "b_mu": torch.zeros((latent_dim,), device=device),
        "w_ls": torch.zeros((in_dim, latent_dim), device=device),
        "b_ls": torch.full((latent_dim,), log_sigma, device=device),
    }


def encode(phi: Dict[str, Any], y: torch.Tensor):
    """y: (N, in_dim) -> (mu, log_sigma), each (N, latent_dim)."""
    h = torch.tanh(y @ phi["w1"] + phi["b1"])
    return h @ phi["w_mu"] + phi["b_mu"], h @ phi["w_ls"] + phi["b_ls"]


def sample_local(phi, y, eps):
    """z_{L,k} = mu_k + sigma_k * eps_k per observation; eps: (N, latent)."""
    mu, ls = encode(phi, y)
    return mu + torch.exp(ls) * eps


def log_q_local(phi, y, z, stop_params: bool = True):
    """Σ_k log q(z_k ; f_φ(y_k)), φ detached (STL) unless ``stop_params`` is False."""
    if stop_params:
        phi = tree_map(lambda x: x.detach(), phi)
    mu, ls = encode(phi, y)
    e = (z - mu) * torch.exp(-ls)
    return -0.5 * torch.sum(e * e) - torch.sum(ls) - 0.5 * z.numel() * _LOG_2PI
