"""Federated silo partitioners (numpy), copied from ``repro.data.partition``.

The paper's §4.1 heterogeneity protocol and the explicit-size split of
the GLMM.
"""
from __future__ import annotations

from typing import List

import numpy as np


def sizes_partition(rng: np.random.Generator, n: int, sizes: List[int]) -> List[np.ndarray]:
    """Random split with explicit per-silo sizes (e.g. the GLMM's 300/237)."""
    if sum(sizes) != n:
        raise ValueError(f"sizes {sizes} must sum to n={n}")
    perm = rng.permutation(n)
    out, start = [], 0
    for s in sizes:
        out.append(np.sort(perm[start:start + s]))
        start += s
    return out


def heterogeneous_label_partition(
    rng: np.random.Generator,
    labels: np.ndarray,
    num_silos: int,
    dominant_frac: float = 0.9,
) -> List[np.ndarray]:
    """The paper's §4.1 protocol: each silo gets an equal number of samples,
    ``dominant_frac`` of which carry a single (round-robin) label; the rest
    are drawn ~uniformly from the other labels.
    """
    n = len(labels)
    num_classes = int(labels.max()) + 1
    per_silo = n // num_silos
    n_dom = int(round(dominant_frac * per_silo))

    by_class = [list(rng.permutation(np.where(labels == c)[0])) for c in range(num_classes)]
    assignments: List[List[int]] = [[] for _ in range(num_silos)]

    # Dominant label pass (round-robin over classes).
    for j in range(num_silos):
        c = j % num_classes
        take = min(n_dom, len(by_class[c]))
        assignments[j].extend(by_class[c][:take])
        by_class[c] = by_class[c][take:]

    # Fill the remainder uniformly from leftovers.
    leftovers = list(rng.permutation([i for pool in by_class for i in pool]))
    for j in range(num_silos):
        need = per_silo - len(assignments[j])
        assignments[j].extend(leftovers[:need])
        leftovers = leftovers[need:]

    return [np.sort(np.asarray(a, np.int64)) for a in assignments]
