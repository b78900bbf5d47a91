"""Bayesian logistic mixed model — six-cities (paper supplement S3.1).

Mirrors ``repro/models/paper/glmm.py``:

    y_ij | β, b_i ~ Bern(logit⁻¹(β₀ + β₁ smoke_i + β₂ age_ij + β₃ smoke·age + b_i))
    β_k ~ N(0, 10²),  ω ~ N(0, 10²),  b_i | ω ~ N(0, exp(−2ω))

Z_G = (β, ω) ∈ R⁵; Z_{L_j} = silo j's random intercepts b (one per child);
θ = ∅. The local family uses the C_j coupling with L_j ≡ I, as the paper
prescribes (the b_i are conditionally independent a posteriori given Z_G).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.families import ConditionalGaussian, DiagGaussian
from repro_torch.core.model import StructuredModel
from repro_torch.core.sfvi import SFVIProblem

_LOG_2PI = math.log(2.0 * math.pi)
GLOBAL_DIM = 5  # (β₀..β₃, ω)


def glmm_logits(beta: torch.Tensor, b: torch.Tensor, smoke: torch.Tensor,
                age: torch.Tensor) -> torch.Tensor:
    return (beta[0] + beta[1] * smoke[:, None] + beta[2] * age
            + beta[3] * smoke[:, None] * age + b[:, None])


def glmm_log_joint_local(z_G: torch.Tensor, b: torch.Tensor, data: dict) -> torch.Tensor:
    """log p(y_j, b | β, ω) for one silo."""
    beta, omega = z_G[:4], z_G[4]
    lp_b = torch.sum(-0.5 * b**2 * torch.exp(2.0 * omega) + omega - 0.5 * _LOG_2PI)
    logits = glmm_logits(beta, b, data["smoke"], data["age"])
    y = data["y"]
    ll = torch.sum(y * F.logsigmoid(logits) + (1.0 - y) * F.logsigmoid(-logits))
    return lp_b + ll


@dataclasses.dataclass(frozen=True)
class GLMM:
    problem: SFVIProblem
    num_children: int


def build_glmm(num_children_j: int, use_coupling: bool = True) -> GLMM:
    def log_prior_global(theta, z_G):
        del theta
        return torch.sum(-0.5 * z_G**2 / 100.0 - 0.5 * math.log(100.0) - 0.5 * _LOG_2PI)

    def log_local(theta, z_G, z_L, data_j):
        del theta
        return glmm_log_joint_local(z_G, z_L, data_j)

    model = StructuredModel(
        global_dim=GLOBAL_DIM, local_dim=num_children_j,
        log_prior_global=log_prior_global, log_local=log_local,
        name="glmm_six_cities")
    gfam = DiagGaussian(GLOBAL_DIM)
    lfam = ConditionalGaussian(num_children_j, GLOBAL_DIM, use_coupling=use_coupling,
                               use_chol=False)
    return GLMM(problem=SFVIProblem(model, gfam, lfam), num_children=num_children_j)
