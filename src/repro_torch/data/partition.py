"""Federated silo partitioners (numpy), copied from ``repro.data.partition``.

The random equal split, the explicit-size split of the GLMM, the
Dirichlet non-IID split with unequal N_j and its padding to a common
silo size, and the paper's §4.1 heterogeneity protocol. Pure numpy: the
same ``np.random.default_rng(seed)`` gives the reference's index arrays
bit for bit.
"""
from __future__ import annotations

from typing import List

import numpy as np


def iid_partition(rng: np.random.Generator, n: int, num_silos: int) -> List[np.ndarray]:
    """Random equal split."""
    perm = rng.permutation(n)
    return [np.sort(chunk) for chunk in np.array_split(perm, num_silos)]


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


def dirichlet_label_partition(
    rng: np.random.Generator,
    labels: np.ndarray,
    num_silos: int,
    alpha: float = 0.5,
    min_per_silo: int = 1,
) -> List[np.ndarray]:
    """Dirichlet non-IID partition (Hsu et al., 2019) with unequal N_j.

    For every class, per-silo proportions ``p ~ Dir(alpha · 1_J)`` split
    that class's samples (largest-remainder apportionment). Silos left
    below ``min_per_silo`` samples are topped up from the largest silo;
    raises ``ValueError`` when that cannot be done.
    """
    labels = np.asarray(labels)
    num_classes = int(labels.max()) + 1
    assignments: List[List[int]] = [[] for _ in range(num_silos)]
    for c in range(num_classes):
        idx = rng.permutation(np.where(labels == c)[0])
        if len(idx) == 0:
            continue
        p = rng.dirichlet(np.full(num_silos, alpha))
        quota = p * len(idx)
        counts = np.floor(quota).astype(np.int64)
        short = len(idx) - int(counts.sum())
        for j in np.argsort(-(quota - counts))[:short]:
            counts[j] += 1
        start = 0
        for j in range(num_silos):
            assignments[j].extend(idx[start:start + counts[j]])
            start += counts[j]
    for j in range(num_silos):
        while len(assignments[j]) < min_per_silo:
            donor = max(range(num_silos), key=lambda i: len(assignments[i]))
            if len(assignments[donor]) <= min_per_silo:
                raise ValueError(
                    f"cannot give every silo {min_per_silo} samples: "
                    f"only {len(labels)} samples over {num_silos} silos")
            assignments[j].append(assignments[donor].pop())
    return [np.sort(np.asarray(a, np.int64)) for a in assignments]


ROW_WEIGHT_KEY = "w"


def pad_ragged_silos(datas: List[dict]) -> List[dict]:
    """Pad unequal-N_j silo dicts to the widest silo + 0/1 row weights.

    Every array is padded by repeating its row 0 (inert values) and a
    ``ROW_WEIGHT_KEY`` float32 vector is added: 1.0 on real rows, 0.0 on
    padding, so a model that weights its likelihood by it (``hetero_mn``)
    gets exactly nothing from padded rows.
    """
    sizes = [len(next(iter(d.values()))) for d in datas]
    n_max = max(sizes)
    out = []
    for d, n in zip(datas, sizes, strict=True):
        if ROW_WEIGHT_KEY in d:
            raise ValueError(f"silo data already has a {ROW_WEIGHT_KEY!r} key")
        pad = n_max - n
        padded = {
            k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)], axis=0)
            if pad else np.asarray(v)
            for k, v in d.items()
        }
        w = np.zeros((n_max,), np.float32)
        w[:n] = 1.0
        padded[ROW_WEIGHT_KEY] = w
        out.append(padded)
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
