"""Synthetic data and silo partitioners of the port (numpy only)."""
from repro_torch.data.partition import (
    dirichlet_label_partition,
    heterogeneous_label_partition,
    iid_partition,
    pad_ragged_silos,
    sizes_partition,
)
from repro_torch.data.synthetic import (
    SyntheticClassification,
    make_lda_corpus,
    make_six_cities,
    make_synthetic_mnist,
)

__all__ = [
    "SyntheticClassification",
    "dirichlet_label_partition",
    "heterogeneous_label_partition",
    "iid_partition",
    "make_lda_corpus",
    "make_six_cities",
    "make_synthetic_mnist",
    "pad_ragged_silos",
    "sizes_partition",
]
