"""Serve steps of the backbone: the posterior-mean model (θ, E[Z_G], E[Z_Lj]).

Counterpart of the serve part of ``repro/launch/steps.py``
(``init_eta_G``, ``init_eta_L``, ``make_serve_prefill``,
``make_serve_decode``). Every silo keeps its personal head adapter, so one
batch serves requests of several silos: the batch axis is grouped by silo
(J groups of B / J requests), and each group's logits get its silo's
adapter. Serving needs no optimizer state, so the port builds none (the
JAX CLI builds Adam state through ``init_train_state`` and never reads it).
"""
from __future__ import annotations

import torch
from torch.func import vmap

from repro_torch.models.backbone import transformer as T
from repro_torch.models.backbone.bayes import bayes_logits, latent_dims
from repro_torch.models.backbone.config import ArchConfig


def init_eta_G(gen: torch.Generator, cfg: ArchConfig):
    n_G, _ = latent_dims(cfg)
    dev = gen.device
    return {"mu": 0.01 * torch.randn((n_G,), generator=gen, device=dev),
            "log_sigma": torch.full((n_G,), -3.0, device=dev)}


def init_eta_L(gen: torch.Generator, cfg: ArchConfig, num_silos: int):
    _, n_L = latent_dims(cfg)
    dev = gen.device
    return {"mu": 0.01 * torch.randn((num_silos, n_L), generator=gen, device=dev),
            "log_sigma": torch.full((num_silos, n_L), -3.0, device=dev)}


def _silo_heads(cfg, num_silos, logits, h, eta_G, eta_L):
    """(B, 1, V) base logits -> each silo group's Bayesian-head logits."""
    B = logits.shape[0]
    Bj = B // num_silos
    z_G = eta_G["mu"]
    lj = logits.reshape(num_silos, Bj, 1, -1)
    hj = h.reshape(num_silos, Bj, 1, -1)
    out = vmap(lambda b, hh, zl: bayes_logits(cfg, b, hh, z_G, zl))(lj, hj, eta_L["mu"])
    return out.reshape(B, 1, -1)


def make_serve_prefill(cfg: ArchConfig, num_silos: int, max_len: int):
    def serve_step_prefill(theta, eta_G, eta_L, batch):
        logits, cache, h = T.prefill(theta, cfg, batch, max_len=max_len)
        return _silo_heads(cfg, num_silos, logits, h, eta_G, eta_L), cache

    return serve_step_prefill


def make_serve_decode(cfg: ArchConfig, num_silos: int):
    def serve_step_decode(theta, eta_G, eta_L, tokens, cache):
        logits, new_cache, h = T.decode_step(theta, cfg, tokens, cache)
        return _silo_heads(cfg, num_silos, logits, h, eta_G, eta_L), new_cache

    return serve_step_decode
