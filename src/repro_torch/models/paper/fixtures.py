"""Shared federation fixtures for the paper's §4 experiments.

The port's twins of ``repro.models.paper.fixtures``: the same protocols
(§4.1: synthetic MNIST, 90 %-one-label heterogeneity, equal shards; §4.2:
a synthetic LDA corpus in equal document shards), with the data drawn
from a numpy ``Generator``. Callers that need the reference's exact
arrays pass them in: ``datas``/``test`` (numpy dicts with ``x``/``y``)
for the BNN, ``counts`` (the (docs, vocab) matrix) for ProdLDA.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.convert import datas_from_numpy
from repro_torch.data import (
    heterogeneous_label_partition,
    make_lda_corpus,
    make_synthetic_mnist,
)
from repro_torch.models.paper.hier_bnn import HierBNN, build_hier_bnn
from repro_torch.models.paper.prodlda import ProdLDA, build_prodlda


def hier_bnn_federation(
    seed: int,
    num_silos: int,
    *,
    device: torch.device,
    fedpop: bool = False,
    in_dim: int = 196,
    hidden: int = 32,
    train_per_silo: int = 200,
    test_per_silo: int = 40,
    prototype_scale: float = 1.0,
    noise_scale: float = 2.5,
    datas: Optional[Sequence[dict]] = None,
    test: Optional[Sequence[dict]] = None,
) -> Tuple[HierBNN, List[dict], List[dict]]:
    """§4.1 protocol. Returns ``(bnn, train, test)`` as tensors on ``device``."""
    if datas is None:
        rng = np.random.default_rng(seed)
        tr, te = make_synthetic_mnist(
            rng, train_per_silo * num_silos, test_per_silo * num_silos,
            dim=in_dim, prototype_scale=prototype_scale, noise_scale=noise_scale)
        parts_tr = heterogeneous_label_partition(rng, tr.y, num_silos)
        parts_te = heterogeneous_label_partition(rng, te.y, num_silos)
        datas = [{"x": tr.x[p], "y": tr.y[p]} for p in parts_tr]
        test = [{"x": te.x[p], "y": te.y[p]} for p in parts_te]
    if len(datas) != num_silos:
        raise ValueError(f"got {len(datas)} silo datasets for {num_silos} silos")
    bnn = build_hier_bnn(in_dim=in_dim, hidden=hidden, fedpop=fedpop)
    return (bnn, datas_from_numpy(datas, device),
            datas_from_numpy(test if test is not None else [], device))


def bnn_posterior_accuracy(bnn: HierBNN, eta_G: dict, eta_L_stacked: dict,
                           test: List[dict]) -> Tuple[float, float]:
    """Per-silo posterior-mean test accuracy; (mean, std) over silos."""
    accs = []
    for j in range(len(test)):
        accs.append(float(bnn.accuracy(
            eta_G["mu"], eta_L_stacked["mu_bar"][j], test[j]["x"], test[j]["y"])))
    return float(np.mean(accs)), float(np.std(accs))


def prodlda_federation(
    seed: int,
    num_silos: int,
    *,
    device: torch.device,
    vocab_size: int = 300,
    num_topics: int = 8,
    docs_per_silo: int = 40,
    counts: Optional[np.ndarray] = None,
) -> Tuple[ProdLDA, List[dict], np.ndarray]:
    """§4.2 protocol. Returns ``(lda, datas, counts)``: J silos of
    ``docs_per_silo`` consecutive documents on ``device``, and the full
    (docs, vocab) numpy matrix for coherence evaluation."""
    if counts is None:
        counts, _ = make_lda_corpus(
            np.random.default_rng(seed), num_docs=num_silos * docs_per_silo,
            vocab_size=vocab_size, num_topics=num_topics)
    counts = np.asarray(counts)
    if counts.shape != (num_silos * docs_per_silo, vocab_size):
        raise ValueError(f"counts of shape {counts.shape} for {num_silos} silos of "
                         f"{docs_per_silo} documents over {vocab_size} words")
    lda = build_prodlda(vocab_size=vocab_size, num_topics=num_topics,
                        docs_per_silo=docs_per_silo)
    datas = [{"counts": counts[j * docs_per_silo:(j + 1) * docs_per_silo]}
             for j in range(num_silos)]
    return lda, datas_from_numpy(datas, device), counts
