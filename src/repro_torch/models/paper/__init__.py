"""The paper's experiment models, ported: the hierarchical BNN and its registry."""
from repro_torch.models.paper.hier_bnn import HierBNN, build_hier_bnn

__all__ = ["HierBNN", "build_hier_bnn"]
