"""The port's deprecated eager adapters (``repro_torch.core.runtime``) and
``barycenter_params_diag``, against the JAX package.

* The counterparts of ``tests/test_runtime.py``'s ten cases, on the same
  toy problem (numpy-seeded data; the initial η from the reference's
  init, converted), on the CPU route of the fused wire:
  - SFVIServer: the ELBO improves over 200 rounds at participation 1 and
    over 300 at 0.5 (late-window mean above the early window's), and 50
    rounds stay finite (one parametrised case each);
  - the up-link is global-sized only: 2 silos × 16 B a round, the
    reference's figure exactly;
  - a Silo's reply carries no local-dimension leaf;
  - SFVIAvgServer: the ELBO's late window beats the early one by more
    than twice the pooled standard error; with 25 local steps a round it
    uses fewer rounds and bytes than SFVI over the same 100 steps and
    ends above SFVI's first ELBO; its barycenter of identical silos is
    the identity (rtol 1e-5);
  - ``tree_bytes`` counts 48 B for a (3, 4) f32 leaf and 0 for ``{}``.
* The adapters against the port's ``Server`` bit for bit at K = 1 (the
  reference's ``tests/test_api.py:400-440`` claim), with and without local
  latents, the η_L rows written back into the Silos.
* The adapters against the reference's adapters on the reference's draws
  (injected): SFVIServer 3 rounds and SFVIAvgServer 2 rounds of 3 local
  steps, state within rtol 1e-4, atol 1e-6 (the parity tolerance of
  ``tests/test_torch_strategies.py``), bytes equal.
* A Silo's ``sfvi_step`` on an injected ε_L against the reference
  problem's ``silo_grads`` and one Adam step (rtol 1e-5).
* ``barycenter_params_diag`` on ``tests/test_barycenter.py:245``'s case
  (4 members of DiagGaussian(3), mu_scale 1) against the reference's,
  rtol 1e-6; ``_barycenter`` on Cholesky members against
  ``barycenter_params_full`` (rtol 1e-5); SFVIAvgServer refuses a family
  without moments, ``CommLog`` warns and is a ``CommMeter``; ``tree_add``
  / ``tree_scale`` / ``tree_mean`` equal the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core.barycenter import barycenter_params_diag as j_params_diag
from repro.optim import adam as j_adam
from repro_torch.federated.metering import CommMeter
from repro_torch.federated.runtime import Server, stack_silos
from repro_torch.optim import adam as t_adam
from repro_torch.optim.sgd import sgd as t_sgd
from repro_torch.tree import tree_leaves, tree_map
from test_torch_strategies import reference_draws

RTOL, ATOL = 1e-4, 1e-6
CPU = torch.device("cpu")


def _t(tree):
    """A JAX pytree -> the port's (CPU tensors)."""
    return jax.tree_util.tree_map(lambda x: torch.as_tensor(np.array(x)), tree)


def _toy_problems(dG=2, dL=3):
    """The reference's toy problem of tests/test_runtime.py, in both packages."""
    jm = J.StructuredModel(
        global_dim=dG, local_dim=dL,
        log_prior_global=lambda th, zg: -0.5 * jnp.sum(zg**2),
        log_local=lambda th, zg, zl, d: -0.5 * jnp.sum((zl - jnp.mean(zg)) ** 2)
        - 2.0 * jnp.sum((d - zl[None, :]) ** 2))
    tm = T.StructuredModel(
        global_dim=dG, local_dim=dL,
        log_prior_global=lambda th, zg: -0.5 * torch.sum(zg**2),
        log_local=lambda th, zg, zl, d: -0.5 * torch.sum((zl - torch.mean(zg)) ** 2)
        - 2.0 * torch.sum((d - zl[None, :]) ** 2))
    return (J.SFVIProblem(jm, J.DiagGaussian(dG), J.ConditionalGaussian(dL, dG)),
            T.SFVIProblem(tm, T.DiagGaussian(dG), T.ConditionalGaussian(dL, dG)))


def _datas(J_, n, dL, seed=0):
    rng = np.random.default_rng(100 + seed)
    return [rng.standard_normal((n, dL)).astype(np.float32) for _ in range(J_)]


def _etas(jprob, J_, seed=0):
    """η_G and the silos' η_L from the reference's inits (as its tests draw them)."""
    eta_G = jprob.global_family.init(jax.random.PRNGKey(1))
    etas_L = [jprob.local_family.init(jax.random.PRNGKey(seed + j)) for j in range(J_)]
    return eta_G, etas_L


def _port_silos(tprob, datas, etas_L, opt):
    return [T.Silo(j, tprob, torch.as_tensor(datas[j]), _t(etas_L[j]), opt,
                   datas[j].shape[0]) for j in range(len(datas))]


def _sfvi(J_=3, n=5, lr=5e-2, dG=2, dL=3, seed=0):
    jprob, tprob = _toy_problems(dG, dL)
    eta_G, etas_L = _etas(jprob, J_, seed)
    silos = _port_silos(tprob, _datas(J_, n, dL, seed), etas_L, t_adam(lr))
    with pytest.warns(DeprecationWarning, match="deprecated adapter"):
        return T.SFVIServer(tprob, silos, {}, _t(eta_G), t_adam(lr)), silos


# ---------------------------------------------------------------------------
# tests/test_runtime.py's cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rounds,participation", [(200, 1.0), (300, 0.5)],
                         ids=["all_silos", "half_invited"])
def test_sfvi_elbo_improves(rounds, participation):
    srv, _ = _sfvi(J_=3 if participation == 1.0 else 4)
    h = srv.run(rounds, participation=participation)
    assert np.mean(h["elbo"][-20:]) > np.mean(h["elbo"][:20])


def test_sfvi_no_nans():
    srv, _ = _sfvi()
    h = srv.run(50)
    assert np.all(np.isfinite(h["elbo"]))
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(srv.eta_G))


def test_communication_is_global_sized_only():
    """The up-link carries only global-shaped gradients: g_eta (2 · dG f32)
    a silo, 2 silos: 32 B a round, as the reference's adapter meters."""
    srv, _ = _sfvi(J_=2, n=40, dL=50, lr=1e-2)
    h = srv.run(3)
    assert h["bytes_up"][0] == 2 * (2 * 2 * 4)


def test_local_params_never_in_messages():
    jprob, tprob = _toy_problems(2, 17)
    eta_G, etas_L = _etas(jprob, 1)
    silo = _port_silos(tprob, _datas(1, 5, 17), etas_L, t_adam(5e-2))[0]
    reply = silo.sfvi_step({"theta": {}, "eta_G": _t(eta_G), "eps_G": torch.randn(2)})
    for leaf in tree_leaves(reply):
        assert 17 not in leaf.shape


def _avg(J_=3, lr=5e-2, seed=0):
    jprob, tprob = _toy_problems()
    eta_G, etas_L = _etas(jprob, J_, seed)
    silos = _port_silos(tprob, _datas(J_, 5, 3, seed), etas_L, t_adam(lr))
    with pytest.warns(DeprecationWarning, match="deprecated adapter"):
        return T.SFVIAvgServer(tprob, silos, {}, _t(eta_G), lambda: t_adam(lr), seed=seed)


def test_sfvi_avg_elbo_improves():
    srv = _avg(lr=2e-2)
    elbo = np.asarray(srv.run(12, local_steps=3)["elbo"])
    early, late = elbo[:3], elbo[-3:]
    pooled_se = np.sqrt(np.var(early, ddof=1) / early.size + np.var(late, ddof=1) / late.size)
    assert late.mean() - early.mean() > 2.0 * pooled_se, elbo


def test_fewer_rounds_than_sfvi_for_same_steps():
    srv_a, _ = _sfvi()
    h_a = srv_a.run(100)
    srv_b = _avg()
    h_b = srv_b.run(4, local_steps=25)
    assert srv_b.comm.rounds < srv_a.comm.rounds
    assert srv_b.comm.total < srv_a.comm.total
    assert h_b["elbo"][-1] > h_a["elbo"][0]


def test_barycenter_of_identical_silos_is_identity():
    srv = _avg()
    eta = srv.eta_G
    out = srv._barycenter([eta, eta, eta])
    for k in eta:
        torch.testing.assert_close(out[k], eta[k], rtol=1e-5, atol=0)


@pytest.mark.parametrize("tree,want", [({"a": np.zeros((3, 4), np.float32)}, 48), ({}, 0)],
                         ids=["f32", "empty"])
def test_tree_bytes(tree, want):
    assert T.tree_bytes(_t(tree)) == J.tree_bytes(jax.tree_util.tree_map(jnp.asarray, tree)) \
        == want


# ---------------------------------------------------------------------------
# The adapters against the port's Server (bit for bit) and the reference
# ---------------------------------------------------------------------------


def _hier_problems(dG=3, dL=2, local=True):
    """tests/test_api.py's _global_only_problem / _hier_problem in both packages."""
    if local:
        jl = lambda th, zg, zl, d: (-0.5 * jnp.sum((zl - jnp.mean(zg)) ** 2)  # noqa: E731
                                    - 0.5 * jnp.sum((d["y"] - zl[None, :]) ** 2))
        tl = lambda th, zg, zl, d: (-0.5 * torch.sum((zl - torch.mean(zg)) ** 2)  # noqa: E731
                                    - 0.5 * torch.sum((d["y"] - zl[None, :]) ** 2))
    else:
        jl = lambda th, zg, zl, d: -0.5 * jnp.sum((d["y"] - zg[None, :]) ** 2)  # noqa: E731
        tl = lambda th, zg, zl, d: -0.5 * torch.sum((d["y"] - zg[None, :]) ** 2)  # noqa: E731
    dl = dL if local else 0
    jm = J.StructuredModel(global_dim=dG, local_dim=dl,
                           log_prior_global=lambda th, zg: -0.5 * jnp.sum((zg - th["m"]) ** 2),
                           log_local=jl)
    tm = T.StructuredModel(global_dim=dG, local_dim=dl,
                           log_prior_global=lambda th, zg: -0.5 * torch.sum((zg - th["m"]) ** 2),
                           log_local=tl)
    if local:
        return (J.SFVIProblem(jm, J.DiagGaussian(dG), J.ConditionalGaussian(dL, dG)),
                T.SFVIProblem(tm, T.DiagGaussian(dG), T.ConditionalGaussian(dL, dG)))
    return J.SFVIProblem(jm, J.DiagGaussian(dG)), T.SFVIProblem(tm, T.DiagGaussian(dG))


def _bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb, strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("local", [False, True], ids=["global_only", "with_locals"])
def test_sfvi_adapter_matches_server_k1(local):
    """SFVIServer == the port's Server, bit for bit, at K = 1; the adapter
    honours caller-initialized η_{L_j} and writes the rows back."""
    lr, J_, n = 0.05, 3, 4
    jprob, tprob = _hier_problems(local=local)
    dY = 2 if local else 3
    rng = np.random.default_rng(2)
    datas = [{"y": torch.as_tensor(rng.standard_normal((n, dY)).astype(np.float32))}
             for _ in range(J_)]
    theta = {"m": torch.tensor(0.2)}
    eta_G = _t(jprob.global_family.init(jax.random.PRNGKey(1), mu_scale=0.4))
    etas_L = ([_t(jprob.local_family.init(jax.random.fold_in(jax.random.PRNGKey(9), j)))
               for j in range(J_)] if local else [None] * J_)
    silos = [T.Silo(j, tprob, datas[j], etas_L[j], t_sgd(lr) if local else None, n)
             for j in range(J_)]
    with pytest.warns(DeprecationWarning):
        legacy = T.SFVIServer(tprob, silos, theta, eta_G, t_sgd(lr), seed=7)
    direct = Server(tprob, datas, theta, eta_G, num_obs=[n] * J_, server_opt=t_sgd(lr),
                    local_opt=t_sgd(lr) if local else None, eta_mode="param", seed=7,
                    device=CPU)
    if local:
        direct.state["eta_L"] = stack_silos(etas_L)
    h_legacy = legacy.run(3)
    h_direct = direct.run(3, algorithm="sfvi", local_steps=1)
    _bit_equal(legacy.theta, direct.theta)
    _bit_equal(legacy.eta_G, direct.eta_G)
    assert h_legacy["elbo"] == h_direct["elbo"]
    assert h_legacy["bytes_up"] == h_direct["bytes_up"]
    if local:
        _bit_equal(legacy._compiled.eta_L, direct.eta_L)
        for j, silo in enumerate(silos):
            _bit_equal(silo.eta_L, tree_map(lambda x, jj=j: x[jj], direct.eta_L))


def _assert_close(got, want):
    lg, lw = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(lg) == len(lw)
    for a, b in zip(lg, lw, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("algo", ["sfvi", "sfvi_avg"])
def test_adapters_match_the_reference_on_its_draws(algo):
    J_, n, lr, seed = 3, 5, 5e-2, 3
    jprob, tprob = _toy_problems()
    eta_G, etas_L = _etas(jprob, J_)
    datas = _datas(J_, n, 3)
    jsilos = [J.Silo(j, jprob, jnp.asarray(datas[j]), etas_L[j], j_adam(lr), n)
              for j in range(J_)]
    tsilos = _port_silos(tprob, datas, etas_L, t_adam(lr))
    draws = reference_draws(jprob, None, J_, 0, seed=seed)
    with pytest.warns(DeprecationWarning):
        if algo == "sfvi":
            jsrv = J.SFVIServer(jprob, jsilos, {}, eta_G, j_adam(lr), seed=seed)
            tsrv = T.SFVIServer(tprob, tsilos, {}, _t(eta_G), t_adam(lr), seed=seed)
        else:
            jsrv = J.SFVIAvgServer(jprob, jsilos, {}, eta_G, lambda: j_adam(lr), seed=seed)
            tsrv = T.SFVIAvgServer(tprob, tsilos, {}, _t(eta_G), lambda: t_adam(lr), seed=seed)
    if algo == "sfvi":
        jh, th = jsrv.run(3), tsrv.run(3, draws=draws)
    else:
        jh, th = jsrv.run(2, local_steps=3), tsrv.run(2, local_steps=3, draws=draws)
    assert th["bytes_up"] == jh["bytes_up"] and th["bytes_down"] == jh["bytes_down"]
    np.testing.assert_allclose(th["elbo_trace"], jh["elbo_trace"], rtol=RTOL, atol=1e-4)
    _assert_close(tsrv.eta_G, jsrv.eta_G)
    for ts, js in zip(tsilos, jsilos, strict=True):
        _assert_close(ts.eta_L, js.eta_L)


def test_silo_step_matches_the_reference_on_injected_eps():
    jprob, tprob = _toy_problems()
    eta_G, etas_L = _etas(jprob, 1)
    data = _datas(1, 5, 3)[0]
    silo = _port_silos(tprob, [data], etas_L, t_adam(5e-2))[0]
    rng = np.random.default_rng(5)
    eps_G = rng.standard_normal(2).astype(np.float32)
    eps_L = rng.standard_normal(3).astype(np.float32)
    reply = silo.sfvi_step({"theta": {}, "eta_G": _t(eta_G), "eps_G": torch.as_tensor(eps_G)},
                           eps_L=torch.as_tensor(eps_L))
    _, g_eta, g_local, hat = jprob.silo_grads({}, eta_G, etas_L[0], jnp.asarray(eps_G),
                                              jnp.asarray(eps_L), jnp.asarray(data))
    opt = j_adam(5e-2)
    upd, _ = opt.update(jax.tree_util.tree_map(lambda g: -g, g_local),
                        opt.init(etas_L[0]), etas_L[0])
    want_L = jax.tree_util.tree_map(lambda p, u: p + u, etas_L[0], upd)
    for got, want in ((reply["g_eta"], g_eta), (silo.eta_L, want_L)):
        lg, lw = tree_leaves(got), jax.tree_util.tree_leaves(want)
        for a, b in zip(lg, lw, strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(reply["hat_Lj"]), float(hat), rtol=1e-5)


# ---------------------------------------------------------------------------
# barycenter_params_diag and the rest of the module
# ---------------------------------------------------------------------------


def test_barycenter_params_diag_matches_the_reference():
    jfam, tfam = J.DiagGaussian(3), T.DiagGaussian(3)
    ps = [jfam.init(jax.random.PRNGKey(i), mu_scale=1.0) for i in range(4)]
    want = j_params_diag(jfam, ps)
    got = T.barycenter_params_diag(tfam, [_t(p) for p in ps])
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    mus = torch.stack([_t(p)["mu"] for p in ps])
    torch.testing.assert_close(got["mu"], mus.mean(0), rtol=1e-6, atol=0)


def test_full_barycenter_rule_matches_the_reference():
    from repro.core.barycenter import barycenter_params_full as j_full
    from repro.core.families import CholeskyGaussian as JChol

    jfam, tfam = JChol(3), T.CholeskyGaussian(3)
    ps = []
    for i in range(3):
        p = jfam.init(jax.random.PRNGKey(i), mu_scale=1.0)
        p["L_packed"] = jnp.asarray(np.random.default_rng(i).normal(0, 0.3, 3), jnp.float32)
        ps.append(p)
    want = j_full(jfam, ps)
    prob = T.SFVIProblem(T.StructuredModel(3, 0, lambda th, z: -0.5 * torch.sum(z**2),
                                           lambda th, zg, zl, d: torch.sum(d * 0.0)), tfam)
    silos = [T.Silo(j, prob, torch.zeros(2), None, None, 2) for j in range(2)]
    with pytest.warns(DeprecationWarning):
        srv = T.SFVIAvgServer(prob, silos, {}, _t(ps[0]), lambda: t_adam(1e-2))
    got = srv._barycenter([_t(p) for p in ps])
    np.testing.assert_allclose(tfam.covariance(got).numpy(),
                               np.asarray(jfam.covariance(want)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["mu"].numpy(), np.asarray(want["mu"]), rtol=1e-6)


def test_refusals_warnings_and_tree_helpers():
    jprob, tprob = _toy_problems()
    bad = T.SFVIProblem(tprob.model, T.ConditionalGaussian(2, 2), tprob.local_family)
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError, match="to_moments"):
        T.SFVIAvgServer(bad, [], {}, {}, lambda: t_adam(1e-2))
    with pytest.warns(DeprecationWarning, match="CommMeter"):
        log = T.CommLog()
    assert isinstance(log, CommMeter) and log.rounds == 0
    a = {"x": np.arange(3, dtype=np.float32), "y": np.ones((2, 2), np.float32)}
    b = {"x": np.full(3, 2.0, np.float32), "y": np.eye(2, dtype=np.float32)}
    ja, jb = (jax.tree_util.tree_map(jnp.asarray, t) for t in (a, b))
    for got, want in ((T.tree_add(_t(a), _t(b)), J.tree_add(ja, jb)),
                      (T.tree_scale(_t(a), 0.5), J.tree_scale(ja, 0.5)),
                      (T.tree_mean([_t(a), _t(b)]), J.tree_mean([ja, jb]))):
        for k in a:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
