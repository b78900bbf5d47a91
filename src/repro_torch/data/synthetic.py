"""Synthetic data (numpy), after ``repro.data.synthetic``: the MNIST
stand-in, the LDA corpus, the six-cities GLMM data and the LLM drivers'
Zipf token stream.

The reference draws with ``jax.random``; this version draws from a numpy
``Generator`` (the token stream from a ``torch.Generator``), so its data
differ from the reference's for the same seed. Parity tests stage data
with the reference and hand the arrays to the port (``datas=`` on the
registry builders; tokens to the train step).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticClassification:
    x: np.ndarray  # (n, d) float32
    y: np.ndarray  # (n,) int64 labels
    num_classes: int


def _bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) half-pixel bilinear interpolation weights."""
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = src - lo
    mat = np.zeros((n_out, n_in))
    mat[np.arange(n_out), lo] += 1.0 - frac
    mat[np.arange(n_out), hi] += frac
    return mat


def make_synthetic_mnist(
    rng: np.random.Generator,
    num_train: int = 6000,
    num_test: int = 1000,
    dim: int = 784,
    num_classes: int = 10,
    prototype_scale: float = 2.0,
    noise_scale: float = 1.0,
) -> tuple:
    """Class-conditional Gaussians around smooth (upsampled 7x7) prototypes."""
    side = int(np.sqrt(dim))
    coarse = rng.standard_normal((num_classes, 7, 7))
    up = _bilinear_matrix(7, side)
    protos = np.einsum("ai,cij,bj->cab", up, coarse, up)
    protos = prototype_scale * protos.reshape(num_classes, dim)

    def sample_split(n):
        y = rng.integers(0, num_classes, size=n)
        x = protos[y] + noise_scale * rng.standard_normal((n, dim))
        return SyntheticClassification(
            x=x.astype(np.float32), y=y.astype(np.int64), num_classes=num_classes)

    return sample_split(num_train), sample_split(num_test)


def make_lda_corpus(
    rng: np.random.Generator,
    num_docs: int = 1200,
    vocab_size: int = 2000,
    num_topics: int = 21,
    doc_length_mean: int = 80,
    beta: float = 0.05,
    alpha: float = 0.3,
) -> tuple:
    """A corpus drawn from a *true* LDA model (20Newsgroups stand-in).

    Topics ~ Dirichlet(β·1_vocab), doc-topic weights ~ Dirichlet(α·1_topics),
    lengths ~ Poisson(``doc_length_mean``) clipped below at 10, then each
    document's words ~ Categorical(doc_topic @ topics). Returns ``(counts,
    true_topics)``: counts (num_docs, vocab_size) int32 bag-of-words,
    true_topics (num_topics, vocab_size) float32.
    """
    true_topics = rng.dirichlet(np.full(vocab_size, beta), size=num_topics)
    doc_topic = rng.dirichlet(np.full(num_topics, alpha), size=num_docs)
    lengths = np.clip(rng.poisson(doc_length_mean, num_docs), 10, None)
    word_probs = doc_topic @ true_topics
    word_probs /= word_probs.sum(axis=-1, keepdims=True)
    counts = rng.multinomial(lengths, word_probs)
    return counts.astype(np.int32), true_topics.astype(np.float32)


def make_six_cities(rng: np.random.Generator, num_children: int = 537) -> tuple:
    """Six-cities longitudinal wheeze stand-in (Fitzmaurice & Laird 1993).

    ``num_children`` × 4 yearly visits; covariates maternal smoking
    (binary, per child) and age centred at 9 (−2..1, per visit). Responses
    follow the paper's logistic mixed model with known ground truth.
    Returns ``(data, truth)`` with float32 ``smoke`` (n,), ``age`` (n, 4)
    and ``y`` (n, 4).
    """
    smoke = (rng.random(num_children) < 0.4).astype(np.float32)
    age = np.tile(np.array([-2.0, -1.0, 0.0, 1.0], np.float32), (num_children, 1))
    true_beta = np.array([-1.8, 0.4, -0.15, 0.08], np.float32)
    true_omega = 0.0  # random-intercept sd = exp(-omega) = 1.0
    b = (np.exp(-true_omega) * rng.standard_normal(num_children)).astype(np.float32)
    logits = (true_beta[0] + true_beta[1] * smoke[:, None] + true_beta[2] * age
              + true_beta[3] * smoke[:, None] * age + b[:, None])
    y = (rng.random(logits.shape) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    data = {"smoke": smoke, "age": age, "y": y}
    return data, {"beta": true_beta, "omega": float(true_omega)}


def zipf_probs(vocab_size: int, zipf_a: float = 1.2) -> np.ndarray:
    """Zipf(a) unigram probabilities over ranks 1..V: normalized in float64,
    then float32, as the reference hands them to ``jax.random.choice``."""
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks ** (-zipf_a)
    probs /= probs.sum()
    return probs.astype(np.float32)


def make_token_stream(gen: torch.Generator, num_tokens: int, vocab_size: int,
                      zipf_a: float = 1.2) -> np.ndarray:
    """Zipf-distributed token stream for the LLM training driver: (num_tokens,)
    int32 ids drawn with replacement from :func:`zipf_probs` on ``gen``'s
    device (torch's stream, not the reference's threefry one)."""
    probs = torch.from_numpy(zipf_probs(vocab_size, zipf_a)).to(gen.device)
    tokens = torch.multinomial(probs, num_tokens, replacement=True, generator=gen)
    return tokens.to(torch.int32).cpu().numpy()
