"""Core SFVI machinery of the port: families, model contract, objectives."""
from repro_torch.core.elbo import (
    elbo_objective,
    elbo_value,
    iwae_objective,
    iwae_value,
    stl_objective,
)
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
    "elbo_objective",
    "elbo_value",
    "empty_theta",
    "eps_shape",
    "family_names",
    "get_family",
    "is_conditional",
    "iwae_objective",
    "iwae_value",
    "stl_objective",
    "supports_moments",
]
