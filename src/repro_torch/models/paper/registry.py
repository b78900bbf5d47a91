"""Model registry of the port — the slice's paper models as named entries.

Mirrors ``repro.models.paper.registry``: a name resolves to a builder
``build(seed, num_silos, *, device=None, **kwargs) -> ModelBundle`` that
stages the problem, θ₀, J per-silo data dicts (tensors on ``device``)
and N_j. Builders run on ``cuda`` unless ``device="cpu"`` is passed.
``datas=`` (numpy silo dicts) replaces the generated data, so parity
tests can stage the reference's arrays.

Registered here: ``hier_bnn`` and ``fedpop_bnn``. The other reference
entries (toy, multinomial, hetero_mn, prodlda, glmm) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.device import resolve_device

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """Everything one federation run needs, staged on one device."""

    problem: Any
    theta0: PyTree
    datas: List[PyTree]
    num_obs: Optional[List[int]] = None
    eval_fn: Optional[Callable[[Any], Dict[str, float]]] = None


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str
    description: str
    build: Callable[..., ModelBundle]


_REGISTRY: Dict[str, ModelEntry] = {}


def register(name: str, description: str):
    """Decorator: register ``fn(seed, num_silos, **kwargs) -> ModelBundle``."""

    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"model {name!r} registered twice")
        _REGISTRY[name] = ModelEntry(name=name, description=description, build=fn)
        return fn

    return deco


def get_model(name: str) -> ModelEntry:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; registered models: "
            + ", ".join(sorted(_REGISTRY))) from None


def model_names() -> List[str]:
    return sorted(_REGISTRY)


def _bnn_bundle(seed: int, num_silos: int, *, fedpop: bool, device, kwargs) -> ModelBundle:
    from repro_torch.models.paper.fixtures import (
        bnn_posterior_accuracy,
        hier_bnn_federation,
    )

    dev = resolve_device(device)
    bnn, train, test = hier_bnn_federation(
        seed=seed, num_silos=num_silos, fedpop=fedpop, device=dev, **kwargs)

    def eval_fn(server):
        acc, std = bnn_posterior_accuracy(bnn, server.eta_G, server.eta_L, test)
        return {"test_acc": acc, "test_acc_std": std}

    return ModelBundle(
        problem=bnn.problem, theta0={}, datas=train,
        num_obs=[int(d["y"].shape[0]) for d in train], eval_fn=eval_fn)


@register("hier_bnn", "Hierarchical BNN on heterogeneous synthetic MNIST (§4.1)")
def _build_hier_bnn(seed: int, num_silos: int, *, device=None, **kwargs) -> ModelBundle:
    return _bnn_bundle(seed, num_silos, fedpop=False, device=device, kwargs=kwargs)


@register("fedpop_bnn", "Fully-Bayesian FedPop BNN variant (§4.1, Table 1 row 2)")
def _build_fedpop_bnn(seed: int, num_silos: int, *, device=None, **kwargs) -> ModelBundle:
    return _bnn_bundle(seed, num_silos, fedpop=True, device=device, kwargs=kwargs)
