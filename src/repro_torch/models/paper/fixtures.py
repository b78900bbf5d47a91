"""Shared federation fixtures for the paper's §4.1 experiment.

The port's twin of ``repro.models.paper.fixtures.hier_bnn_federation``:
same protocol (synthetic MNIST, 90 %-one-label heterogeneity, equal
shards), with the data drawn from a numpy ``Generator``. Callers that
need the reference's exact arrays pass them in as ``datas``/``test``
(numpy dicts with ``x``/``y``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.convert import datas_from_numpy
from repro_torch.data import heterogeneous_label_partition, make_synthetic_mnist
from repro_torch.models.paper.hier_bnn import HierBNN, build_hier_bnn


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
