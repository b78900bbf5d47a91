"""Product Latent Dirichlet Allocation (paper §4.2; Srivastava & Sutton 2017).

    T_t  ~ Dirichlet(β·1_vocab)             t = 1..n_topics     — global
    W_k  ~ N(α·1_topics, I)                 k = 1..n_docs       — local (per doc)
    c_k  ~ Multinom(l_k, softmax(T W_k))                        — bag-of-words

θ = (α, log β). Z_G = vec(T) in softmax basis, with the logistic-normal
Laplace approximation to the Dirichlet prior; Z_{L_j} = the W_k of silo
j's documents (``BatchedDiagGaussian``). Both families are diagonal, as
the paper specifies. Mirrors ``repro.models.paper.prodlda``;
:func:`umass_coherence` is its numpy copy.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.families import BatchedDiagGaussian, DiagGaussian
from repro_torch.core.model import StructuredModel
from repro_torch.core.sfvi import SFVIProblem

_LOG_2PI = math.log(2.0 * math.pi)


def dirichlet_laplace_moments(beta: torch.Tensor, dim: int):
    """Logistic-normal (softmax-basis) Laplace approximation to the symmetric
    Dirichlet(β·1_dim): mean 0 and one variance for every coordinate
    (Srivastava & Sutton 2017, eq. 4; Hennig et al. 2012)."""
    mean = torch.zeros((dim,), dtype=beta.dtype, device=beta.device)
    var = (1.0 / beta) * (1.0 - 2.0 / dim) + (1.0 / (dim * beta)) * 1.0
    return mean, var.expand(dim)


@dataclasses.dataclass(frozen=True)
class ProdLDA:
    problem: SFVIProblem
    num_topics: int
    vocab_size: int
    docs_per_silo: int

    def topics(self, z_G: torch.Tensor) -> torch.Tensor:
        """Softmax-basis latent -> (n_topics, vocab) word distributions."""
        t = z_G.reshape(self.num_topics, self.vocab_size)
        return torch.softmax(t, dim=-1)

    def doc_word_probs(self, z_G: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """ProdLDA mixes in natural-parameter space: softmax(w T)."""
        t = z_G.reshape(self.num_topics, self.vocab_size)
        return torch.softmax(w @ t, dim=-1)


def umass_coherence(topics: np.ndarray, counts: np.ndarray, top_n: int = 10) -> np.ndarray:
    """UMass topic coherence (Mimno et al., 2011) per topic.

    C(t) = Σ_{m<l} log [ (D(w_m, w_l) + 1) / D(w_l) ]
    over the topic's top-N words, with document co-occurrence counts D.
    """
    doc_occ = counts > 0  # (docs, vocab) bool
    scores = []
    for t in range(topics.shape[0]):
        top = np.argsort(-topics[t])[:top_n]
        c = 0.0
        for m in range(1, top_n):
            for l in range(m):
                d_l = doc_occ[:, top[l]].sum()
                d_ml = (doc_occ[:, top[m]] & doc_occ[:, top[l]]).sum()
                c += np.log((d_ml + 1.0) / max(d_l, 1.0))
        scores.append(c)
    return np.asarray(scores)


def build_prodlda(
    vocab_size: int = 2000,
    num_topics: int = 21,
    docs_per_silo: int = 400,
) -> ProdLDA:
    global_dim = num_topics * vocab_size

    def log_prior_global(theta, z_G):
        # Dirichlet(β 1) in softmax basis via the Laplace approximation.
        beta = torch.exp(theta["log_beta"])
        mean, var = dirichlet_laplace_moments(beta, vocab_size)
        resid = z_G.reshape(num_topics, vocab_size) - mean[None, :]
        return torch.sum(-0.5 * resid**2 / var[None, :] - 0.5 * torch.log(var)[None, :]
                         - 0.5 * _LOG_2PI)

    def log_local(theta, z_G, z_L, data_j):
        # z_L: (docs_per_silo, num_topics) doc-topic weights W_k.
        w = z_L
        lp = torch.sum(-0.5 * (w - theta["alpha"]) ** 2 - 0.5 * _LOG_2PI)
        logits = w @ z_G.reshape(num_topics, vocab_size)  # (docs, vocab)
        logp = torch.log_softmax(logits, dim=-1)
        # Multinomial log-lik up to the (data-only) normalizing constant.
        return lp + torch.sum(data_j["counts"].to(logp.dtype) * logp)

    model = StructuredModel(
        global_dim=global_dim,
        local_dim=num_topics,  # per document; batched over docs_per_silo
        log_prior_global=log_prior_global,
        log_local=log_local,
        name="prodlda",
    )
    return ProdLDA(
        problem=SFVIProblem(model, DiagGaussian(global_dim),
                            BatchedDiagGaussian(batch=docs_per_silo, dim=num_topics)),
        num_topics=num_topics,
        vocab_size=vocab_size,
        docs_per_silo=docs_per_silo,
    )


def init_theta(device=None) -> dict:
    return {"alpha": torch.zeros((), device=device),
            "log_beta": torch.full((), math.log(0.05), device=device)}
