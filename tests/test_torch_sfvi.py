"""The port's SFVI objective and STL gradients against the JAX reference.

hier_bnn and fedpop_bnn (in_dim 16, hidden 8), data staged by the
reference's fixture, the same (θ, η_G, η_L, ε) from a numpy seed on both
sides. Tolerance: rtol 1e-5, atol 1e-6 — float32 reassociation in the
matmuls and sums (XLA and PyTorch reduce in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.paper.fixtures import hier_bnn_federation as j_federation
from repro_torch.convert import datas_from_numpy
from repro_torch.models.paper.hier_bnn import build_hier_bnn as t_build
from repro_torch.tree import tree_leaves

RTOL, ATOL = 1e-5, 1e-6


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


def _random_params(shapes, rng):
    return {k: ((0.3 if k != "log_sigma" else 0.2) * rng.standard_normal(s)
                - (1.5 if k == "log_sigma" else 0.0)).astype(np.float32)
            for k, s in shapes.items()}


@pytest.fixture(scope="module", params=[False, True], ids=["hier_bnn", "fedpop_bnn"])
def case(request):
    fedpop = request.param
    jbnn, train, _ = j_federation(seed=0, num_silos=3, fedpop=fedpop, in_dim=16,
                                  hidden=8, train_per_silo=20, test_per_silo=4)
    tbnn = t_build(in_dim=16, hidden=8, fedpop=fedpop)
    rng = np.random.default_rng(5 + fedpop)
    jprob, tprob = jbnn.problem, tbnn.problem
    eta_G = _random_params(tprob.global_family.param_shapes(), rng)
    eta_L = _random_params(tprob.local_family.param_shapes(), rng)
    eps_G = rng.standard_normal(tprob.global_family.eps_shape).astype(np.float32)
    eps_L = rng.standard_normal(tprob.local_family.eps_shape).astype(np.float32)
    data_np = {k: np.asarray(v) for k, v in train[1].items()}
    return dict(
        jprob=jprob, tprob=tprob,
        j=dict(eta_G={k: jnp.asarray(v) for k, v in eta_G.items()},
               eta_L={k: jnp.asarray(v) for k, v in eta_L.items()},
               eps_G=jnp.asarray(eps_G), eps_L=jnp.asarray(eps_L),
               data={k: jnp.asarray(v) for k, v in data_np.items()}),
        t=dict(eta_G={k: torch.as_tensor(v) for k, v in eta_G.items()},
               eta_L={k: torch.as_tensor(v) for k, v in eta_L.items()},
               eps_G=torch.as_tensor(eps_G), eps_L=torch.as_tensor(eps_L),
               data=datas_from_numpy([data_np], "cpu")[0]),
    )


def test_model_dims_match(case):
    jm, tm = case["jprob"].model, case["tprob"].model
    assert (jm.global_dim, jm.local_dim, jm.name) == (tm.global_dim, tm.local_dim, tm.name)


def test_hat_L0_and_hat_Lj_match(case):
    j, t = case["j"], case["t"]
    _close(case["tprob"].hat_L0({}, t["eta_G"], t["eps_G"]),
           case["jprob"].hat_L0({}, j["eta_G"], j["eps_G"]))
    for scale in (1.0, 3.0):
        _close(case["tprob"].hat_Lj({}, t["eta_G"], t["eta_L"], t["eps_G"], t["eps_L"],
                                    t["data"], scale),
               case["jprob"].hat_Lj({}, j["eta_G"], j["eta_L"], j["eps_G"], j["eps_L"],
                                    j["data"], scale))


def test_silo_grads_match(case):
    j, t = case["j"], case["t"]
    jg = case["jprob"].silo_grads({}, j["eta_G"], j["eta_L"], j["eps_G"], j["eps_L"],
                                  j["data"])
    tg = case["tprob"].silo_grads({}, t["eta_G"], t["eta_L"], t["eps_G"], t["eps_L"],
                                  t["data"])
    assert tg[0] == {} and jg[0] == {}
    for part in (1, 2):
        jl, tl = jax.tree_util.tree_leaves(jg[part]), tree_leaves(tg[part])
        assert len(jl) == len(tl) > 0
        for a, b in zip(tl, jl, strict=True):
            _close(a, b)
    _close(tg[3], jg[3])


def test_server_grads_match(case):
    j, t = case["j"], case["t"]
    jg = case["jprob"].server_grads({}, j["eta_G"], j["eps_G"])
    tg = case["tprob"].server_grads({}, t["eta_G"], t["eps_G"])
    for a, b in zip(tree_leaves(tg[1]), jax.tree_util.tree_leaves(jg[1]), strict=True):
        _close(a, b)
    _close(tg[2], jg[2])


def test_stl_gradient_differs_from_the_full_score(case):
    """STL: η is detached inside log q only. Without the detach the
    gradient gains the score term, so the parity above is sensitive to it.
    """
    t, prob = case["t"], case["tprob"]
    fam = prob.global_family

    def full_L0(eta_G):  # no detach anywhere
        z = fam.sample(eta_G, t["eps_G"])
        return prob.model.log_prior_global({}, z) - fam.log_prob(eta_G, z)

    g_full = torch.func.grad(full_L0)(t["eta_G"])
    _, g_stl, _ = prob.server_grads({}, t["eta_G"], t["eps_G"])
    assert float(torch.abs(g_full["log_sigma"] - g_stl["log_sigma"]).max()) > 0.5
