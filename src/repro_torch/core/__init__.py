"""Core SFVI machinery of the port: families, model contract, objective."""
from repro_torch.core.families import (
    BatchedDiagGaussian,
    CholeskyGaussian,
    ConditionalGaussian,
    DiagGaussian,
    LowRankGaussian,
)
from repro_torch.core.family import (
    FamilySpec,
    VariationalFamily,
    build_family,
    eps_shape,
    family_names,
    get_family,
    is_conditional,
    supports_moments,
)
from repro_torch.core.flatten import TreeSpec, VectorSpec
from repro_torch.core.model import StructuredModel, empty_theta
from repro_torch.core.sfvi import SFVIProblem

__all__ = [
    "BatchedDiagGaussian",
    "CholeskyGaussian",
    "ConditionalGaussian",
    "DiagGaussian",
    "FamilySpec",
    "LowRankGaussian",
    "SFVIProblem",
    "StructuredModel",
    "TreeSpec",
    "VariationalFamily",
    "VectorSpec",
    "build_family",
    "empty_theta",
    "eps_shape",
    "family_names",
    "get_family",
    "is_conditional",
    "supports_moments",
]
