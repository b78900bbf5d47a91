"""The paper's central Remark (§3) on the port: SFVI is invariant to how the
data is partitioned across silos — the federated gradient equals the
centralized gradient, for any partition. Mirrors
``tests/test_partition_invariance.py`` (same hypothesis strategies and
tolerances; float32 throughout, so invariance holds up to float32
reduction order), with the inputs drawn from numpy and the port's
``torch.Generator`` in place of JAX keys.

Against the JAX package: on one drawn case the port's
``centralized_objective`` and its gradient equal the reference's within
rtol 1e-5, and ``sample_posterior`` on the reference's ε gives the
reference's (Z_G, Z_L) within rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

pytest.importorskip("hypothesis", reason="hypothesis not installed; pip install -e .[test]")
from hypothesis import given, settings, strategies as st

from repro.core import ConditionalGaussian as JCond
from repro.core import DiagGaussian as JDiag
from repro.core import SFVIProblem as JProblem
from repro.core import StructuredModel as JModel
from repro_torch.core import ConditionalGaussian, DiagGaussian, SFVIProblem, StructuredModel
from repro_torch.tree import tree_leaves, tree_map


def _make_problem(dG, dL, use_coupling):
    def log_prior_global(theta, zg):
        return -0.5 * torch.sum((zg - theta["m"]) ** 2)

    def log_local(theta, zg, zl, data):
        lp = -0.5 * torch.sum((zl - torch.mean(zg)) ** 2)
        ll = -0.5 * torch.sum((data - zl[None, :]) ** 2) * torch.exp(theta["lt"])
        return lp + ll

    model = StructuredModel(global_dim=dG, local_dim=dL,
                            log_prior_global=log_prior_global, log_local=log_local)
    return SFVIProblem(model, DiagGaussian(dG),
                       ConditionalGaussian(dL, dG, use_coupling=use_coupling))


def _make_reference(dG, dL, use_coupling):
    def log_prior_global(theta, zg):
        return -0.5 * jnp.sum((zg - theta["m"]) ** 2)

    def log_local(theta, zg, zl, data):
        lp = -0.5 * jnp.sum((zl - jnp.mean(zg)) ** 2)
        ll = -0.5 * jnp.sum((data - zl[None, :]) ** 2) * jnp.exp(theta["lt"])
        return lp + ll

    model = JModel(global_dim=dG, local_dim=dL,
                   log_prior_global=log_prior_global, log_local=log_local)
    return JProblem(model, JDiag(dG), JCond(dL, dG, use_coupling=use_coupling))


def _flat(tree):
    return torch.cat([x.reshape(-1) for x in tree_leaves(tree)])


def _case(prob, num_silos, dG, dL, seed):
    """θ, η_G, ε_G and per-silo (η_L, ε_L, data), all from ``seed``."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))

    theta = {"m": normal(), "lt": torch.tensor(-0.5)}
    eta_G = prob.global_family.init(gen, mu_scale=0.5)
    eps_G = normal(dG)
    etas_L = [prob.local_family.init(gen, mu_scale=0.5) for _ in range(num_silos)]
    eps_L = [normal(dL) for _ in range(num_silos)]
    datas = [normal(3, dL) for _ in range(num_silos)]
    return theta, eta_G, eps_G, etas_L, eps_L, datas


@settings(max_examples=20, deadline=None)
@given(
    num_silos=st.integers(1, 5),
    dG=st.integers(1, 4),
    dL=st.integers(1, 3),
    use_coupling=st.booleans(),
    seed=st.integers(0, 10_000),
)
def test_federated_equals_centralized_gradient(num_silos, dG, dL, use_coupling, seed):
    prob = _make_problem(dG, dL, use_coupling)
    theta, eta_G, eps_G, etas_L, eps_L, datas = _case(prob, num_silos, dG, dL, seed)

    # Federated: server term + Σ_j silo terms.
    g_theta, g_eta, _ = prob.server_grads(theta, eta_G, eps_G)
    for j in range(num_silos):
        gtj, gej, _, _ = prob.silo_grads(theta, eta_G, etas_L[j], eps_G, eps_L[j], datas[j])
        g_theta = tree_map(torch.add, g_theta, gtj)
        g_eta = tree_map(torch.add, g_eta, gej)

    # Centralized single-graph gradient.
    cent = grad(
        lambda th, eg: prob.centralized_objective(th, eg, etas_L, eps_G, eps_L, datas),
        argnums=(0, 1))(theta, eta_G)

    np.testing.assert_allclose(_flat(g_theta).numpy(), _flat(cent[0]).numpy(),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(_flat(g_eta).numpy(), _flat(cent[1]).numpy(),
                               rtol=2e-4, atol=2e-5)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1000))
def test_repartitioning_preserves_objective(seed):
    """Moving observations between silos (with their local latents) leaves the
    total objective unchanged when local latents are per-observation."""
    dG = 2
    prob = _make_problem(dG, 1, use_coupling=False)
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    theta = {"m": torch.tensor(0.1), "lt": torch.tensor(0.0)}
    eta_G = prob.global_family.init(gen, mu_scale=0.3)
    eps_G = torch.as_tensor(rng.standard_normal(dG).astype(np.float32))

    # 6 observations, each its own "micro-silo".
    n = 6
    etas = [prob.local_family.init(gen) for _ in range(n)]
    eps = [torch.as_tensor(rng.standard_normal(1).astype(np.float32)) for _ in range(n)]
    datas = [torch.as_tensor(rng.standard_normal((1, 1)).astype(np.float32))
             for _ in range(n)]

    def total_for_partition(groups):
        val = prob.hat_L0(theta, eta_G, eps_G)
        for grp in groups:
            for i in grp:
                val = val + prob.hat_Lj(theta, eta_G, etas[i], eps_G, eps[i], datas[i])
        return float(val)

    v1 = total_for_partition([[0, 1, 2], [3, 4, 5]])
    v2 = total_for_partition([[0], [1, 2, 3, 4], [5]])
    v3 = total_for_partition([[0, 1, 2, 3, 4, 5]])
    np.testing.assert_allclose(v1, v2, rtol=1e-6)
    np.testing.assert_allclose(v1, v3, rtol=1e-6)


def _to_jax(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tree)


def test_centralized_objective_matches_reference():
    num_silos, dG, dL = 3, 3, 2
    prob, jprob = _make_problem(dG, dL, True), _make_reference(dG, dL, True)
    theta, eta_G, eps_G, etas_L, eps_L, datas = _case(prob, num_silos, dG, dL, 1234)
    jargs = [_to_jax(a) for a in (theta, eta_G, etas_L, eps_G, eps_L, datas)]

    def jobj(th, eg):
        return jprob.centralized_objective(th, eg, jargs[2], jargs[3], jargs[4], jargs[5])

    jv, (jg_th, jg_eg) = jax.value_and_grad(jobj, argnums=(0, 1))(jargs[0], jargs[1])

    def tobj(th, eg):
        return prob.centralized_objective(th, eg, etas_L, eps_G, eps_L, datas)

    np.testing.assert_allclose(float(tobj(theta, eta_G)), float(jv), rtol=1e-5)
    tg_th, tg_eg = grad(tobj, argnums=(0, 1))(theta, eta_G)
    for t_tree, j_tree in ((tg_th, jg_th), (tg_eg, jg_eg)):
        for k in t_tree:
            np.testing.assert_allclose(t_tree[k].numpy(), np.asarray(j_tree[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_sample_posterior_matches_reference():
    dG, dL, n = 3, 2, 5
    prob, jprob = _make_problem(dG, dL, True), _make_reference(dG, dL, True)
    gen = torch.Generator().manual_seed(3)
    eta_G = prob.global_family.init(gen, mu_scale=0.5)
    eta_L = prob.local_family.init(gen, mu_scale=0.5)
    eta_L["C"] = 0.3 * torch.randn(eta_L["C"].shape, generator=gen)
    key = jax.random.PRNGKey(21)
    jz_G, jz_L = jprob.sample_posterior(_to_jax(eta_G), _to_jax(eta_L), key, num_samples=n)
    # The reference's ε: one split of its key, ε_G then ε_L.
    kG, kL = jax.random.split(key)
    eps_G = torch.as_tensor(np.array(jax.random.normal(kG, (n, dG))))
    eps_L = torch.as_tensor(np.array(jax.random.normal(kL, (n, dL))))
    z_G, z_L = prob.sample_posterior(eta_G, eta_L, (eps_G, eps_L), num_samples=n)
    np.testing.assert_allclose(z_G.numpy(), np.asarray(jz_G), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(z_L.numpy(), np.asarray(jz_L), rtol=1e-5, atol=1e-6)
    # From a generator: shapes, and no Z_L without local parameters.
    z_G, z_L = prob.sample_posterior(eta_G, eta_L, torch.Generator().manual_seed(0),
                                     num_samples=n)
    assert z_G.shape == (n, dG) and z_L.shape == (n, dL)
    z_G, z_L = prob.sample_posterior(eta_G, None, torch.Generator().manual_seed(0))
    assert z_G.shape == (1, dG) and z_L is None
