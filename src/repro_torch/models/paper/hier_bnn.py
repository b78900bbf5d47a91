"""Hierarchical Bayesian neural network (paper §4.1).

    μ_ik ~ N(0,1),  σ ~ N₊(0,1)                     — global
    ε_ik^(j) ~ N(0,1),  W^(1,j) = μ + σ ε^(j)       — local (non-centered)
    W^(2,j) ~ N(0,1)                                 — local
    f_j(x) = softmax(ReLU(x W^(1,j)) W^(2,j))

Z_G = (μ, log σ) with the half-normal prior on σ handled by a log-space
change of variables; Z_{L_j} = (ε^(j), W^(2,j)); θ = ∅.

``fedpop=True`` gives the fully-Bayesian FedPop variant: the first layer
is a purely global latent and only the final layer is silo-personal.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.families import ConditionalGaussian, DiagGaussian
from repro_torch.core.flatten import VectorSpec
from repro_torch.core.model import StructuredModel
from repro_torch.core.sfvi import SFVIProblem

_LOG_2PI = math.log(2.0 * math.pi)


def _std_normal_logpdf(x):
    return -0.5 * torch.sum(x * x) - 0.5 * x.numel() * _LOG_2PI


@dataclasses.dataclass(frozen=True)
class HierBNN:
    problem: SFVIProblem
    global_spec: VectorSpec
    local_spec: VectorSpec
    in_dim: int
    hidden: int
    num_classes: int
    fedpop: bool

    def predict_logits(self, z_G, z_L, x):
        return _predict_logits(self.global_spec, self.local_spec, self.fedpop, z_G, z_L, x)

    def accuracy(self, z_G, z_L, x, y) -> torch.Tensor:
        logits = self.predict_logits(z_G, z_L, x)
        return torch.mean((torch.argmax(logits, -1) == y).float())


def _predict_logits(gspec, lspec, fedpop, z_G, z_L, x):
    g = gspec.unpack(z_G)
    l = lspec.unpack(z_L)
    if fedpop:
        w1 = g["mu_w1"]
    else:
        w1 = g["mu_w1"] + torch.exp(g["log_sigma_w1"]) * l["eps_w1"]
    return torch.relu(x @ w1) @ l["w2"]


def build_hier_bnn(
    in_dim: int = 784,
    hidden: int = 64,
    num_classes: int = 10,
    fedpop: bool = False,
    use_coupling: bool = False,
) -> HierBNN:
    if fedpop:
        gspec = VectorSpec.create({"mu_w1": (in_dim, hidden)})
        lspec = VectorSpec.create({"w2": (hidden, num_classes)})
    else:
        gspec = VectorSpec.create({"mu_w1": (in_dim, hidden), "log_sigma_w1": ()})
        lspec = VectorSpec.create(
            {"eps_w1": (in_dim, hidden), "w2": (hidden, num_classes)})

    def log_prior_global(theta, z_G):
        del theta
        g = gspec.unpack(z_G)
        lp = _std_normal_logpdf(g["mu_w1"])
        if not fedpop:
            # σ ~ N₊(0,1) via ω = log σ: log p(ω) = log 2 + log N(e^ω;0,1) + ω.
            omega = g["log_sigma_w1"]
            sigma = torch.exp(omega)
            lp = lp + (-0.5 * sigma**2 + math.log(2.0) - 0.5 * _LOG_2PI) + omega
        return lp

    def log_local(theta, z_G, z_L, data_j):
        del theta
        l = lspec.unpack(z_L)
        lp = _std_normal_logpdf(l["w2"])
        if not fedpop:
            lp = lp + _std_normal_logpdf(l["eps_w1"])
        logits = _predict_logits(gspec, lspec, fedpop, z_G, z_L, data_j["x"])
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.sum(torch.gather(logp, -1, data_j["y"][:, None]))
        return lp + ll

    def predict(theta, z_G, z_L, x):
        del theta
        return _predict_logits(gspec, lspec, fedpop, z_G, z_L, x)

    model = StructuredModel(
        global_dim=gspec.dim,
        local_dim=lspec.dim,
        log_prior_global=log_prior_global,
        log_local=log_local,
        predict=predict,
        name="fedpop_bnn" if fedpop else "hier_bnn",
    )
    gfam = DiagGaussian(gspec.dim)
    lfam = ConditionalGaussian(lspec.dim, gspec.dim, use_coupling=use_coupling,
                               use_chol=False)
    return HierBNN(
        problem=SFVIProblem(model, gfam, lfam),
        global_spec=gspec,
        local_spec=lspec,
        in_dim=in_dim,
        hidden=hidden,
        num_classes=num_classes,
        fedpop=fedpop,
    )
