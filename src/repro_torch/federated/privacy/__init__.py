"""Differentially private federated rounds: the mechanism and the ledger."""
from repro_torch.federated.privacy.accountant import (
    DEFAULT_ORDERS,
    RdpAccountant,
    rdp_sampled_gaussian,
    rdp_to_epsilon,
)
from repro_torch.federated.privacy.policy import PrivacyPolicy

__all__ = [
    "DEFAULT_ORDERS",
    "PrivacyPolicy",
    "RdpAccountant",
    "rdp_sampled_gaussian",
    "rdp_to_epsilon",
]
