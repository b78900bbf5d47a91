"""Model registry of the port — the slice's paper models as named entries.

Mirrors ``repro.models.paper.registry``: a name resolves to a builder
``build(seed, num_silos, *, device=None, **kwargs) -> ModelBundle`` that
stages the problem, θ₀, J per-silo data dicts (tensors on ``device``)
and N_j. Builders run on ``cuda`` unless ``device="cpu"`` is passed.
``datas=`` (numpy silo dicts) replaces the generated data, so parity
tests can stage the reference's arrays.

Registered here: ``hier_bnn``, ``fedpop_bnn``, ``glmm`` and ``toy``. The
other reference entries (multinomial, hetero_mn, prodlda) are not ported
yet. :func:`apply_family_spec` swaps a staged bundle's families
(``--global-family``/``--local-family``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

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


def apply_family_spec(bundle: ModelBundle, global_family=None,
                      local_family=None) -> ModelBundle:
    """Swap the staged problem's variational families from FamilySpecs.

    The structural dimensions (``dim``, ``global_dim``) come from the
    staged model; data, θ₀, counts and the eval hook are untouched.
    """
    if global_family is None and local_family is None:
        return bundle
    from repro_torch.core.family import build_family

    problem = bundle.problem
    model = problem.model
    gfam, lfam = problem.global_family, problem.local_family
    if global_family is not None:
        gfam = build_family(global_family, dim=model.global_dim)
    if local_family is not None:
        lfam = build_family(local_family, dim=model.local_dim, global_dim=model.global_dim)
    problem = dataclasses.replace(problem, global_family=gfam, local_family=lfam)
    return dataclasses.replace(bundle, problem=problem)


def _float_tensors(datas: Sequence[dict], device) -> List[dict]:
    """Numpy (or array-like) silo dicts -> float32 tensors on ``device``."""
    return [{k: torch.as_tensor(np.array(v, dtype=np.float32), device=device)
             for k, v in d.items()} for d in datas]


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


@register("toy", "Hierarchical Gaussian with a closed-form posterior (quickstart)")
def _build_toy(seed: int, num_silos: int, *, device=None, num_obs: int = 40,
               true_mu: float = 2.0, use_coupling: bool = True) -> ModelBundle:
    """μ ~ N(0, 10²); b_j | μ ~ N(μ, 1); y_jk | b_j ~ N(b_j, 0.5²).

    Z_G = μ, Z_{L_j} = b_j, θ = ∅. The data come from
    ``np.random.default_rng(seed)`` exactly as in the reference, so the
    closed-form posterior of μ (b_j integrated out) is the reference's.
    """
    from repro_torch.core import ConditionalGaussian, DiagGaussian, SFVIProblem, StructuredModel

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    true_b = rng.normal(true_mu, 1.0, num_silos)
    ys = [rng.normal(true_b[j], 0.5, num_obs).astype(np.float32) for j in range(num_silos)]
    model = StructuredModel(
        global_dim=1, local_dim=1,
        log_prior_global=lambda th, zg: -0.5 * torch.sum(zg**2) / 10.0**2,
        log_local=lambda th, zg, zl, d: (
            -0.5 * torch.sum((zl - zg) ** 2)
            - 0.5 * torch.sum((d["y"] - zl) ** 2) / 0.5**2),
        name="toy_hier_gaussian")
    problem = SFVIProblem(model, DiagGaussian(1),
                          ConditionalGaussian(1, 1, use_coupling=use_coupling))

    ybar = np.array([float(np.mean(y)) for y in ys])
    var_j = 1.0 + 0.5**2 / num_obs  # var of ȳ_j | μ, identical across silos
    post_prec = 1.0 / 10.0**2 + num_silos / var_j
    post_mu = float(np.sum(ybar) / var_j / post_prec)

    def eval_fn(server):
        mu_hat = float(server.eta_G["mu"][0])
        return {"abs_error_vs_exact": abs(mu_hat - post_mu)}

    return ModelBundle(
        problem=problem, theta0={}, datas=_float_tensors([{"y": y} for y in ys], dev),
        num_obs=[num_obs] * num_silos, eval_fn=eval_fn)


@register("glmm", "Bayesian logistic GLMM, six-cities protocol (supplement S3.1)")
def _build_glmm(seed: int, num_silos: int, *, device=None, num_children: int = 120,
                datas: Optional[Sequence[dict]] = None) -> ModelBundle:
    """Even split of the six-cities children across silos.

    Every silo carries ``num_children // num_silos`` children (the leftover
    children are dropped, as in the reference). The data are drawn from
    numpy Generators (the reference draws with ``jax.random``); ``datas``
    (numpy dicts with ``smoke``/``age``/``y``) replaces them. No eval hook.
    """
    from repro_torch.data import make_six_cities, sizes_partition
    from repro_torch.models.paper.glmm import build_glmm

    dev = resolve_device(device)
    per_silo = num_children // num_silos
    if datas is None:
        total = per_silo * num_silos
        data, _ = make_six_cities(np.random.default_rng(seed + 3), num_children=total)
        parts = sizes_partition(np.random.default_rng(seed), total, [per_silo] * num_silos)
        datas = [{k: v[p] for k, v in data.items()} for p in parts]
    if len(datas) != num_silos:
        raise ValueError(f"got {len(datas)} silo datasets for {num_silos} silos")
    glmm = build_glmm(num_children_j=per_silo)
    return ModelBundle(problem=glmm.problem, theta0={}, datas=_float_tensors(datas, dev),
                       num_obs=[per_silo] * num_silos, eval_fn=None)
