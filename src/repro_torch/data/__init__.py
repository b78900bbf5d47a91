"""Synthetic data and silo partitioners of the port (numpy only)."""
from repro_torch.data.partition import heterogeneous_label_partition, sizes_partition
from repro_torch.data.synthetic import (
    SyntheticClassification,
    make_six_cities,
    make_synthetic_mnist,
)

__all__ = [
    "SyntheticClassification",
    "heterogeneous_label_partition",
    "make_six_cities",
    "make_synthetic_mnist",
    "sizes_partition",
]
