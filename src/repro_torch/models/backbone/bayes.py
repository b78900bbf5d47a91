"""SFVI <-> backbone integration: the paper's structured latents on the LM head.

Counterpart of ``repro/models/backbone/bayes.py``:

    θ    = backbone weights
    Z_G  = global latent: rank-r_g LM-head adapter (A_G: r_g x d,
           B_G: r_g x V) + a log-scale ω_G
    Z_Lj = per-silo latent: rank-r_l head adapter + logit bias

    logits = h W_head + (h A_Gᵀ) B_G / r_g + (h A_Ljᵀ) B_Lj / r_l + b_j
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.backbone.config import ArchConfig


def latent_dims(cfg: ArchConfig) -> Tuple[int, int]:
    d, V = cfg.d_model, cfg.vocab_size
    b = cfg.bayes
    n_G = b.global_rank * (d + V) + 1  # +1: ω_G hierarchical log-scale
    n_L = b.local_rank * (d + V) + (V if b.local_bias else 0)
    return n_G, n_L


def split_global(cfg: ArchConfig, z_G: torch.Tensor):
    """z_G -> (A_G (r, d), B_G (r, V), ω_G scalar)."""
    d, V, r = cfg.d_model, cfg.vocab_size, cfg.bayes.global_rank
    A = z_G[: r * d].reshape(r, d)
    B = z_G[r * d: r * (d + V)].reshape(r, V)
    return A, B, z_G[-1]


def split_local(cfg: ArchConfig, z_L: torch.Tensor):
    """z_L -> (A_L (r, d), B_L (r, V), bias (V) or None); a leading silo
    axis is kept: (J, n_L) -> (J, r, d), ..."""
    d, V, r = cfg.d_model, cfg.vocab_size, cfg.bayes.local_rank
    lead = z_L.shape[:-1]
    A = z_L[..., : r * d].reshape(*lead, r, d)
    B = z_L[..., r * d: r * (d + V)].reshape(*lead, r, V)
    bias = z_L[..., r * (d + V):] if cfg.bayes.local_bias else None
    return A, B, bias


def log_prior_global(cfg: ArchConfig, z_G: torch.Tensor) -> torch.Tensor:
    """log p(Z_G): standard normal over all components (up to a constant)."""
    return -0.5 * torch.sum(z_G.float() ** 2)


def log_prior_local(cfg: ArchConfig, z_G: torch.Tensor, z_L: torch.Tensor) -> torch.Tensor:
    """log p(Z_Lj | Z_G) = N(0, exp(2 ω_G) I), one silo's z_L (n_L,)."""
    omega = z_G[-1].float()
    zl = z_L.float()
    return -0.5 * torch.sum(zl * zl) * torch.exp(-2.0 * omega) - zl.numel() * omega


def bayes_logits(cfg: ArchConfig, base_logits: torch.Tensor, h: torch.Tensor,
                 z_G: torch.Tensor, z_L: torch.Tensor) -> torch.Tensor:
    """base_logits (..., S, V) = h W_head; h (..., S, d); z_G (n_G,); z_L
    (n_L,): ONE silo's latents (the caller maps over silos)."""
    A_G, B_G, _ = split_global(cfg, z_G)
    out = base_logits + (h @ A_G.T.to(h.dtype)) @ B_G.to(base_logits.dtype) \
        / cfg.bayes.global_rank
    A_L, B_L, bias = split_local(cfg, z_L)
    out = out + (h @ A_L.T.to(h.dtype)) @ B_L.to(base_logits.dtype) / cfg.bayes.local_rank
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed negative log-likelihood. logits (..., S, V); labels (..., S).
    (The JAX package's ``masked_gather`` is a sharding lever for the same
    number; the port has no mesh.)"""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return torch.sum(logz - gold)
