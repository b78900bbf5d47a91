"""Empirically-Bayesian multinomial regression (paper supplement S3.2).

    W_jk ~ N(0, σ_W²),  b_j ~ N(0, σ_b²),  c_k | W,b ~ Cat(softmax(W x_k + b))

Z_G = (vec(W), b) ∈ R^7850 at MNIST width, Z_L = ∅, θ = (log σ_W, log σ_b)
— prior scales learned by empirical Bayes. The model of the paper's
averaging-frequency study (Table S1) and of the repo's benchmark smoke
config; its diagonal q takes the analytic barycenter. Mirrors
``repro.models.paper.multinomial``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.families import DiagGaussian
from repro_torch.core.flatten import VectorSpec
from repro_torch.core.model import StructuredModel
from repro_torch.core.sfvi import SFVIProblem
from repro_torch.data.partition import ROW_WEIGHT_KEY

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class MultinomialRegression:
    problem: SFVIProblem
    spec: VectorSpec
    in_dim: int
    num_classes: int

    def predict_logits(self, z_G, x):
        g = self.spec.unpack(z_G)
        return x @ g["W"] + g["b"]

    def accuracy(self, z_G, x, y) -> torch.Tensor:
        return torch.mean((torch.argmax(self.predict_logits(z_G, x), -1) == y).float())


def build_multinomial(in_dim: int = 784, num_classes: int = 10) -> MultinomialRegression:
    spec = VectorSpec.create({"W": (in_dim, num_classes), "b": (num_classes,)})

    def log_prior_global(theta, z_G):
        g = spec.unpack(z_G)
        var_w = torch.exp(2.0 * theta["log_sigma_w"])
        var_b = torch.exp(2.0 * theta["log_sigma_b"])
        lp_w = torch.sum(-0.5 * g["W"] ** 2 / var_w) - 0.5 * g["W"].numel() * (
            2.0 * theta["log_sigma_w"] + _LOG_2PI)
        lp_b = torch.sum(-0.5 * g["b"] ** 2 / var_b) - 0.5 * g["b"].numel() * (
            2.0 * theta["log_sigma_b"] + _LOG_2PI)
        return lp_w + lp_b

    def log_local(theta, z_G, z_L, data_j):
        del theta, z_L
        g = spec.unpack(z_G)
        logits = data_j["x"] @ g["W"] + g["b"]
        logp = torch.log_softmax(logits, dim=-1)
        rows = torch.gather(logp, -1, data_j["y"][:, None])[:, 0]
        if ROW_WEIGHT_KEY in data_j:
            # Ragged federations pad silos to a common size and mark real
            # rows with weight 1 (data.pad_ragged_silos): padded rows add 0.
            rows = rows * data_j[ROW_WEIGHT_KEY]
        return torch.sum(rows)

    model = StructuredModel(
        global_dim=spec.dim,
        local_dim=0,
        log_prior_global=log_prior_global,
        log_local=log_local,
        name="eb_multinomial",
    )
    return MultinomialRegression(
        problem=SFVIProblem(model, DiagGaussian(spec.dim), None),
        spec=spec,
        in_dim=in_dim,
        num_classes=num_classes,
    )


def init_theta(device=None) -> dict:
    return {"log_sigma_w": torch.zeros((), device=device),
            "log_sigma_b": torch.zeros((), device=device)}
