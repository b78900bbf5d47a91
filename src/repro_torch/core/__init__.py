"""Core SFVI machinery of the port: families, model contract, objective."""
from repro_torch.core.families import ConditionalGaussian, DiagGaussian
from repro_torch.core.family import (
    VariationalFamily,
    eps_shape,
    is_conditional,
    supports_moments,
)
from repro_torch.core.flatten import TreeSpec, VectorSpec
from repro_torch.core.model import StructuredModel, empty_theta
from repro_torch.core.sfvi import SFVIProblem

__all__ = [
    "ConditionalGaussian",
    "DiagGaussian",
    "SFVIProblem",
    "StructuredModel",
    "TreeSpec",
    "VariationalFamily",
    "VectorSpec",
    "empty_theta",
    "eps_shape",
    "is_conditional",
    "supports_moments",
]
