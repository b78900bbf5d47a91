"""Model registry of the port — the slice's paper models as named entries.

Mirrors ``repro.models.paper.registry``: a name resolves to a builder
``build(seed, num_silos, *, device=None, **kwargs) -> ModelBundle`` that
stages the problem, θ₀, J per-silo data dicts (tensors on ``device``)
and N_j. Builders run on ``cuda`` unless ``device="cpu"`` is passed.
The reference draws its data with ``jax.random``, the port with numpy,
so each builder takes the data in their place and partitions them as
the reference does, so parity tests can stage the reference's arrays:
``datas=`` (numpy silo dicts) for ``hier_bnn``/``fedpop_bnn``/``glmm``,
``train=``/``test=`` (``(x, y)`` numpy pairs) for ``multinomial`` and
``hetero_mn``, ``counts=`` (the (docs, vocab) matrix) for ``prodlda``.

Registered: every model of the reference registry — ``toy``,
``hier_bnn``, ``fedpop_bnn``, ``glmm``, ``multinomial``, ``hetero_mn``
and ``prodlda``. :func:`apply_family_spec` swaps a staged bundle's
families (``--global-family``/``--local-family``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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


Split = Tuple[np.ndarray, np.ndarray]  # (x (n, d) float32, y (n,) integer labels)


def _mnist_splits(seed: int, num_train: int, num_test: int, in_dim: int,
                  prototype_scale: float, noise_scale: float,
                  train: Optional[Split], test: Optional[Split]) -> Tuple[Split, Split]:
    """The synthetic-MNIST train/test pairs, or the given ones (both or neither)."""
    from repro_torch.data import make_synthetic_mnist

    if (train is None) != (test is None):
        raise ValueError("pass both train= and test=, or neither")
    if train is None:
        tr, te = make_synthetic_mnist(
            np.random.default_rng(seed), num_train, num_test, dim=in_dim,
            prototype_scale=prototype_scale, noise_scale=noise_scale)
        return (tr.x, tr.y), (te.x, te.y)
    for name, (x, y) in (("train", train), ("test", test)):
        if np.shape(x) != (len(y), in_dim):
            raise ValueError(f"{name} x of shape {np.shape(x)} for {len(y)} labels "
                             f"and in_dim {in_dim}")
    return train, test


def _multinomial_bundle(datas, num_obs, in_dim, train: Split, test: Split,
                        device) -> ModelBundle:
    """The multinomial model over staged silos; eval: posterior-mean accuracy
    on the whole training set and on the test set."""
    from repro_torch.convert import datas_from_numpy
    from repro_torch.models.paper.multinomial import build_multinomial, init_theta

    model = build_multinomial(in_dim=in_dim)
    train_all, test_all = datas_from_numpy(
        [{"x": train[0], "y": train[1]}, {"x": test[0], "y": test[1]}], device)

    def eval_fn(server):
        mu = server.eta_G["mu"]
        return {"train_acc": float(model.accuracy(mu, train_all["x"], train_all["y"])),
                "test_acc": float(model.accuracy(mu, test_all["x"], test_all["y"]))}

    return ModelBundle(problem=model.problem, theta0=init_theta(device),
                       datas=datas_from_numpy(datas, device), num_obs=num_obs,
                       eval_fn=eval_fn)


@register("hetero_mn",
          "Multinomial regression under Dirichlet non-IID silos "
          "(unequal N_j, label skew)")
def _build_hetero_mn(seed: int, num_silos: int, *, device=None, n_total: int = 240,
                     in_dim: int = 196, alpha: float = 0.5, min_per_silo: int = 2,
                     prototype_scale: float = 0.6, noise_scale: float = 3.0,
                     train: Optional[Split] = None,
                     test: Optional[Split] = None) -> ModelBundle:
    """The multinomial model over a Dirichlet(α) label partition (Hsu et
    al., 2019): per-silo label skew AND unequal N_j. Ragged silos are padded
    to the widest with a 0/1 row-weight ``w`` that the likelihood applies,
    so padded rows add exactly nothing; ``num_obs`` holds the true N_j,
    which SFVI-Avg's N/N_j rescale sees."""
    from repro_torch.data import dirichlet_label_partition, pad_ragged_silos

    dev = resolve_device(device)
    train, test = _mnist_splits(seed, n_total, max(200, num_silos * 20), in_dim,
                                prototype_scale, noise_scale, train, test)
    x, y = train
    parts = dirichlet_label_partition(np.random.default_rng(seed), y, num_silos,
                                      alpha=alpha, min_per_silo=min_per_silo)
    datas = pad_ragged_silos([{"x": x[p], "y": y[p]} for p in parts])
    return _multinomial_bundle(datas, [len(p) for p in parts], in_dim, train, test, dev)


@register("multinomial",
          "Empirically-Bayesian multinomial regression (supplement S3.2)")
def _build_multinomial(seed: int, num_silos: int, *, device=None, n_per: int = 60,
                       in_dim: int = 196, prototype_scale: float = 0.6,
                       noise_scale: float = 3.0, train: Optional[Split] = None,
                       test: Optional[Split] = None) -> ModelBundle:
    """IID equal silos of ``n_per`` samples (the benchmark smoke model)."""
    from repro_torch.data import iid_partition

    dev = resolve_device(device)
    train, test = _mnist_splits(seed, num_silos * n_per, max(200, num_silos * 20), in_dim,
                                prototype_scale, noise_scale, train, test)
    x, y = train
    parts = iid_partition(np.random.default_rng(seed), len(y), num_silos)
    datas = [{"x": x[p], "y": y[p]} for p in parts]
    return _multinomial_bundle(datas, [len(p) for p in parts], in_dim, train, test, dev)


@register("prodlda", "Federated ProdLDA topic model on a synthetic corpus (§4.2)")
def _build_prodlda(seed: int, num_silos: int, *, device=None,
                   counts: Optional[np.ndarray] = None, **kwargs) -> ModelBundle:
    """Equal document shards of an LDA corpus; eval: UMass coherence of the
    posterior-mean topics (top 8 words), median and mean over topics."""
    from repro_torch.models.paper.fixtures import prodlda_federation
    from repro_torch.models.paper.prodlda import init_theta, umass_coherence

    dev = resolve_device(device)
    lda, datas, counts = prodlda_federation(seed, num_silos, device=dev, counts=counts,
                                            **kwargs)

    def eval_fn(server):
        topics = lda.topics(server.eta_G["mu"]).cpu().numpy()
        coh = umass_coherence(topics, counts, top_n=8)
        return {"coherence_median": float(np.median(coh)),
                "coherence_mean": float(np.mean(coh))}

    return ModelBundle(problem=lda.problem, theta0=init_theta(dev), datas=datas,
                       num_obs=[lda.docs_per_silo] * num_silos, eval_fn=eval_fn)
