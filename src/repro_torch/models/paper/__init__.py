"""The paper's experiment models, ported, and their registry."""
from repro_torch.models.paper.hier_bnn import HierBNN, build_hier_bnn
from repro_torch.models.paper.multinomial import MultinomialRegression, build_multinomial
from repro_torch.models.paper.prodlda import ProdLDA, build_prodlda

__all__ = ["HierBNN", "MultinomialRegression", "ProdLDA", "build_hier_bnn",
           "build_multinomial", "build_prodlda"]
