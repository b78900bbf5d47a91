"""The paper's GLMM (six cities) and the toy model in the port, against the
JAX package; the structured global families through the whole round.

* ``Server`` on glmm + ``--global-family cholesky`` (24 children, J = 3,
  K = 2), SFVI and SFVI-Avg, 3 rounds, fed the reference's draws, against
  the JAX ``Server(wire="flat")``; the port runs its default fused wire,
  whose kernel wrappers take their plain versions on the CPU, so SFVI-Avg's
  barycenter runs ``sqrtm_newton_schulz_fused``. ELBO and state within
  rtol 1e-4 (atol 1e-5 for entries near zero; Adam amplifies float32
  reassociation, see ``test_torch_runtime.py``); bytes and active counts
  exact.
* ``lowrank`` (rank 2) for one SFVI-Avg round: U's column signs are not
  unique after the barycenter's eigh, so the covariance U Uᵀ + diag(σ²) is
  compared.
* The model pieces (log joint, data generator shapes, the partition), the
  toy data bit for bit and its closed-form posterior, and the bytes per
  round of the full-width configurations ``chip_smoke.py`` asserts.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.family import FamilySpec as JSpec
from repro.data import sizes_partition as j_sizes_partition
from repro.federated.aggregation import TrimmedMeanAggregator as JTrimmed
from repro.federated.runtime import Server as JServer
from repro.federated.strategy import global_eps, silo_eps
from repro.models.paper.glmm import glmm_log_joint_local as j_log_joint
from repro.models.paper.registry import apply_family_spec as j_apply
from repro.models.paper.registry import get_model as j_get
from repro.optim.adam import adam as j_adam
from repro_torch.convert import from_jax_state
from repro_torch.core.family import FamilySpec as TSpec
from repro_torch.data import make_six_cities, sizes_partition
from repro_torch.federated.aggregation import TrimmedMeanAggregator as TTrimmed
from repro_torch.federated.runtime import Server as TServer
from repro_torch.models.paper.glmm import glmm_log_joint_local as t_log_joint
from repro_torch.models.paper.registry import apply_family_spec as t_apply
from repro_torch.models.paper.registry import get_model as t_get
from repro_torch.optim.adam import adam as t_adam
from repro_torch.tree import tree_leaves

SEED, LR = 0, 2e-2
RTOL, ATOL = 1e-4, 1e-5


def _np_state(state):
    return jax.tree_util.tree_map(np.asarray, state)


def reference_draws(jprob, J):
    """draws(r, t) reproducing the reference's ε streams (no DP)."""
    base = jax.random.PRNGKey(SEED)

    def draws(r, t):
        rk = jax.random.fold_in(base, r)
        eps_G = np.array(global_eps(jprob, rk, t))
        eps_L = np.stack([np.array(silo_eps(jprob, rk, t, j)) for j in range(J)])
        return torch.as_tensor(eps_G), torch.as_tensor(eps_L), None

    return draws


def _build(algo, J, children, gspec, lspec=None, trim=None):
    jb = j_get("glmm").build(SEED, J, num_children=children)
    jb = j_apply(jb, global_family=JSpec(*gspec),
                 local_family=None if lspec is None else JSpec(*lspec))
    jprob = jb.problem
    jsrv = JServer(jprob, jb.datas, {}, jprob.global_family.init(jax.random.PRNGKey(SEED)),
                   num_obs=jb.num_obs, server_opt=j_adam(LR), local_opt=j_adam(LR),
                   aggregator=None if trim is None else JTrimmed(trim),
                   wire="flat", seed=SEED, strategy=algo)
    tb = t_get("glmm").build(SEED, J, device="cpu", num_children=children,
                             datas=[{k: np.asarray(v) for k, v in d.items()} for d in jb.datas])
    tb = t_apply(tb, global_family=TSpec(*gspec),
                 local_family=None if lspec is None else TSpec(*lspec))
    state = from_jax_state(_np_state(jsrv.state), "cpu")
    tsrv = TServer(tb.problem, tb.datas, state["theta"], state["eta_G"], num_obs=tb.num_obs,
                   server_opt=t_adam(LR), local_opt=t_adam(LR),
                   aggregator=None if trim is None else TTrimmed(trim),
                   seed=SEED, strategy=algo, device="cpu")
    tsrv.state = state
    assert tsrv.wire == "fused"
    return jsrv, tsrv, reference_draws(jprob, J)


def _assert_close(tree_t, tree_j, what, keys=("theta", "eta_G", "eta_L")):
    for key in keys:
        tl, jl = tree_leaves(tree_t[key]), jax.tree_util.tree_leaves(tree_j[key])
        assert len(tl) == len(jl), key
        for a, b in zip(tl, jl, strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}: {key}")


@pytest.mark.parametrize("algo", ["sfvi", "sfvi_avg"])
def test_glmm_cholesky_server_matches_reference(algo):
    J, K = 3, 2
    jsrv, tsrv, draws = _build(algo, J, 24, ("cholesky",))
    assert sorted(tsrv.eta_G) == ["L_packed", "log_sigma", "mu"]
    assert tsrv.wire_spec().dim == jsrv.wire_spec().dim == 5 + 5 + 10
    assert tsrv.bytes_up_per_silo() == jsrv.bytes_up_per_silo()
    assert tsrv.bytes_down_per_silo() == jsrv.bytes_down_per_silo()
    for r in range(3):
        jh = jsrv.run(1, local_steps=K, start_round=r)
        th = tsrv.run(1, local_steps=K, start_round=r, draws=draws)
        for key in ("bytes_up", "bytes_down", "n_active"):
            assert th[key] == jh[key], (r, key)
        np.testing.assert_allclose(th["elbo_trace"], jh["elbo_trace"], rtol=RTOL,
                                   err_msg=f"round {r}: elbo")
        _assert_close(tsrv.state, jsrv.state, f"round {r}")


def test_glmm_lowrank_one_round_matches_reference_covariance():
    J, K = 3, 2
    jsrv, tsrv, draws = _build("sfvi_avg", J, 24, ("lowrank", {"rank": 2}),
                               lspec=("conditional", {"use_chol": True}), trim=0.34)
    # convert.from_jax_state carries U, L_packed and their Adam moments
    assert sorted(tsrv.eta_G) == ["U", "log_sigma", "mu"]
    assert tsrv.eta_G["U"].shape == (5, 2)
    adam_mu = tsrv.state["opt_server"][0].mu
    assert adam_mu["eta_G"]["U"].shape == (5, 2)
    assert tsrv.state["eta_L"]["L_packed"].shape == (J, 8 * 7 // 2)
    assert tsrv.state["opt_local"][0].nu["L_packed"].shape == (J, 8 * 7 // 2)
    jh = jsrv.run(1, local_steps=K)
    th = tsrv.run(1, local_steps=K, draws=draws)
    assert th["bytes_up"] == jh["bytes_up"] and th["n_active"] == jh["n_active"]
    np.testing.assert_allclose(th["elbo_trace"], jh["elbo_trace"], rtol=RTOL)
    _assert_close(tsrv.state, jsrv.state, "round 0", keys=("eta_L",))
    jfam, tfam = jsrv.problem.global_family, tsrv.problem.global_family
    np.testing.assert_allclose(tsrv.eta_G["mu"].numpy(), np.asarray(jsrv.eta_G["mu"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tfam.covariance(tsrv.eta_G).numpy(),
                               np.asarray(jfam.covariance(jsrv.eta_G)), rtol=RTOL, atol=ATOL)


def test_glmm_log_joint_matches_reference():
    rng = np.random.default_rng(1)
    data, _ = make_six_cities(rng, num_children=7)
    z_G = (0.5 * rng.standard_normal(5)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    want = j_log_joint(jnp.asarray(z_G), jnp.asarray(b),
                       {k: jnp.asarray(v) for k, v in data.items()})
    got = t_log_joint(torch.as_tensor(z_G), torch.as_tensor(b),
                      {k: torch.as_tensor(v) for k, v in data.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert data["age"].shape == (7, 4) and data["y"].shape == (7, 4)
    assert set(np.unique(data["y"])) <= {0.0, 1.0} and data["smoke"].dtype == np.float32


def test_sizes_partition_matches_reference():
    parts_t = sizes_partition(np.random.default_rng(3), 10, [4, 6])
    parts_j = j_sizes_partition(np.random.default_rng(3), 10, [4, 6])
    for a, b in zip(parts_t, parts_j, strict=True):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="sum"):
        sizes_partition(np.random.default_rng(3), 10, [4, 5])


def test_toy_data_and_closed_form_match_reference():
    jb = j_get("toy").build(SEED, 4, num_obs=10)
    tb = t_get("toy").build(SEED, 4, device="cpu", num_obs=10)
    for dt, dj in zip(tb.datas, jb.datas, strict=True):
        np.testing.assert_array_equal(dt["y"].numpy(), np.asarray(dj["y"]))
    post_mu = jb.extras["posterior_mu"]
    at = lambda mu: types.SimpleNamespace(eta_G={"mu": torch.tensor([mu])})  # noqa: E731
    assert tb.eval_fn(at(0.0))["abs_error_vs_exact"] == abs(post_mu)
    assert tb.eval_fn(at(post_mu))["abs_error_vs_exact"] < 1e-6  # f32 rounding of mu
    # a short SFVI run moves the posterior mean toward the closed form
    prob = tb.problem
    srv = TServer(prob, tb.datas, {}, prob.global_family.init(torch.Generator()),
                  num_obs=tb.num_obs, server_opt=t_adam(0.1), local_opt=t_adam(0.1),
                  strategy="sfvi", device="cpu")
    srv.run(40, local_steps=2)
    assert tb.eval_fn(srv)["abs_error_vs_exact"] < 0.25 * abs(post_mu)


@pytest.mark.parametrize("cfg", ["cholesky_sfvi", "cholesky_sfvi_avg", "lowrank_trimmed"])
def test_full_width_bytes_match_reference(cfg):
    """The bytes per round chip_smoke.py asserts at full width equal the JAX
    package's (shapes only; nothing runs)."""
    J, children, algo, gspec, lspec, K = {
        "cholesky_sfvi": (2, 536, "sfvi", ("cholesky",), None, 25),
        "cholesky_sfvi_avg": (2, 536, "sfvi_avg", ("cholesky",), None, 25),
        "lowrank_trimmed": (6, 536, "sfvi_avg", ("lowrank", {"rank": 2}),
                            ("conditional", {"use_chol": True}), 25),
    }[cfg]
    jb = j_apply(j_get("glmm").build(SEED, J, num_children=children),
                 global_family=JSpec(*gspec), local_family=None if lspec is None else JSpec(*lspec))
    tb = t_apply(t_get("glmm").build(SEED, J, device="cpu", num_children=children),
                 global_family=TSpec(*gspec), local_family=None if lspec is None else TSpec(*lspec))
    assert tb.problem.model.local_dim == jb.problem.model.local_dim == children // J
    jsrv = JServer(jb.problem, jb.datas, {}, jb.problem.global_family.init(jax.random.PRNGKey(0)),
                   server_opt=j_adam(LR), local_opt=j_adam(LR), strategy=algo)
    tsrv = TServer(tb.problem, tb.datas, {}, tb.problem.global_family.init(torch.Generator()),
                   server_opt=t_adam(LR), local_opt=t_adam(LR), strategy=algo, device="cpu")
    up = tsrv.bytes_up_per_silo() * J * (K if algo == "sfvi" else 1)
    assert up == jsrv.bytes_up_per_silo() * J * (K if algo == "sfvi" else 1)
    assert tsrv.bytes_down_per_silo() == jsrv.bytes_down_per_silo()
    assert up == {"cholesky_sfvi": 4000, "cholesky_sfvi_avg": 160, "lowrank_trimmed": 480}[cfg]
