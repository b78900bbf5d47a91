"""PVI and federated EP in the port, and the strategy registry, against the
JAX package.

* Registry and spec plumbing as ``tests/test_strategies.py`` has it: names,
  unknown names, duplicate registration, ``resolve_strategy``, the kwargs
  check of ``StrategySpec``, cadences and ``has_silo_state``.
* ``natural_from_eta`` / ``eta_from_natural`` against the reference.
* 3 rounds of the port's ``Server`` against the reference ``Server`` for
  ``pvi`` and ``fed_ep`` on the flat and the fused wire: the toy model
  (J = 3, local latents; also with int8 + DP) and multinomial (in_dim 16,
  J = 3, θ ≠ ∅). Both start from one state (``convert.from_jax_state``,
  the sites λ_j included) on the reference's data, and the port is fed
  the reference's ε and DP noise. θ, η_G, η_L, λ and the ELBO within rtol
  1e-4 (atol 1e-5 near zero; Adam amplifies float32 reassociation, see
  ``test_torch_runtime.py``); bytes exact.
* The reference's correctness anchors on the port alone: ``damping=0`` is
  a fixed point, the sites sum to nat(q_G) − nat(q_init), the PVI and EP
  trajectories differ, a non-diagonal global family is refused, and
  ``run(algorithm="pvi")`` on an SFVI-Avg server fills the sites.
* The smoke config (multinomial, in_dim 196, J = 4 silos of 60, K = 4):
  PVI and federated EP ship exactly 126,144 B up + down a round (the
  ``strategy_compare`` rows of ``benchmarks/baseline.json``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DiagGaussian as JDiag
from repro.federated.aggregation import Int8Compressor as JInt8
from repro.federated.privacy import PrivacyPolicy as JPolicy
from repro.federated.runtime import Server as JServer
from repro.federated.strategy import (
    eta_from_natural as j_eta_from_natural,
    global_eps,
    natural_from_eta as j_natural_from_eta,
    silo_eps,
    strategy_names as j_strategy_names,
)
from repro.models.paper.registry import get_model as j_get
from repro.optim.adam import adam as j_adam
from repro_torch.convert import from_jax_state
from repro_torch.core import DiagGaussian, SFVIProblem, StructuredModel
from repro_torch.core.family import FamilySpec, build_family
from repro_torch.device import generator
from repro_torch.federated.aggregation import Int8Compressor as TInt8
from repro_torch.federated.privacy import PrivacyPolicy as TPolicy
from repro_torch.federated.runtime import Server as TServer
from repro_torch.federated.strategy import (
    SFVIStrategy,
    StrategySpec,
    eta_from_natural,
    get_strategy,
    natural_from_eta,
    register_strategy,
    resolve_strategy,
    strategy_names,
)
from repro_torch.models.paper.registry import get_model as t_get
from repro_torch.optim.adam import adam as t_adam
from repro_torch.tree import tree_leaves

SEED, K, ROUNDS, LR = 0, 2, 3, 2e-2
RTOL, ATOL = 1e-4, 1e-5
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# The reference's randomness, handed to the port (also used by
# test_torch_experiment.py)
# ---------------------------------------------------------------------------


def reference_draws(jprob, jpolicy, J, P, seed=SEED):
    """draws(r, t) reproducing the reference's ε_G, ε_{L_j} and DP noise."""
    base = jax.random.PRNGKey(seed)

    def draws(r, t):
        rk = jax.random.fold_in(base, r)
        eps_G = torch.as_tensor(np.array(global_eps(jprob, rk, t)))
        eps_L = None
        if jprob.model.has_local:
            eps_L = torch.as_tensor(np.stack(
                [np.array(silo_eps(jprob, rk, t, j)) for j in range(J)]))
        noise = None
        if jpolicy is not None and jpolicy.noise_multiplier > 0:
            noise = torch.as_tensor(np.stack([np.array(jax.random.normal(
                jax.random.fold_in(jpolicy.upload_key(rk, t, j), 0), (P,), jnp.float32))
                for j in range(J)]))
        return eps_G, eps_L, noise

    return draws


def place_as_after_a_round(jsrv):
    """Give the reference's initial state the placement and types its round
    returns (the same values), so its jitted round is traced once."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(spec):
        sh = NamedSharding(jsrv.mesh, spec)
        return lambda x: jax.device_put(jnp.asarray(x, dtype=x.dtype), sh)

    for k, spec in (("theta", P()), ("eta_G", P()), ("opt_server", P()),
                    ("eta_L", P("silo")), ("opt_local", P("silo")), ("strategy", P("silo"))):
        jsrv.state[k] = jax.tree_util.tree_map(put(spec), jsrv.state[k])


def assert_state_close(tstate, jstate, keys, msg=""):
    for key in keys:
        tl = tree_leaves(tstate[key])
        jl = jax.tree_util.tree_leaves(jstate[key])
        assert len(tl) == len(jl), key
        for a, b in zip(tl, jl, strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{msg}: {key}")


# ---------------------------------------------------------------------------
# Registry and spec plumbing
# ---------------------------------------------------------------------------


def test_registry_names_match_the_reference():
    assert strategy_names() == j_strategy_names() == ("fed_ep", "pvi", "sfvi", "sfvi_avg")
    with pytest.raises(KeyError, match="sfvi"):
        get_strategy("nope")
    with pytest.raises(ValueError, match="already registered"):
        register_strategy("sfvi")(SFVIStrategy)


def test_resolve_and_cadences():
    inst = get_strategy("pvi")(damping=0.5)
    assert resolve_strategy(inst) is inst
    assert resolve_strategy("sfvi").name == "sfvi"
    assert type(resolve_strategy(StrategySpec("fed_ep"))) is get_strategy("fed_ep")
    assert get_strategy("sfvi").cadence == "step"
    for name in ("sfvi_avg", "pvi", "fed_ep"):
        assert get_strategy(name).cadence == "round"
    for name in ("pvi", "fed_ep"):
        assert get_strategy(name).has_silo_state
        assert get_strategy(name)().damping == 0.25


def test_strategy_spec_kwargs_validated_and_round_trips():
    assert StrategySpec("pvi", {"damping": 0.1}).build().damping == 0.1
    with pytest.raises(ValueError, match="unknown kwargs"):
        StrategySpec("pvi", {"bogus": 1}).build()
    with pytest.raises(ValueError, match="unknown kwargs"):
        StrategySpec("sfvi", {"damping": 0.1}).build()
    spec = StrategySpec("pvi", {"damping": 0.3})
    assert StrategySpec.from_dict({"name": "pvi", "kwargs": {"damping": 0.3}}) == spec
    assert StrategySpec.from_dict({}) == StrategySpec("sfvi")


def test_natural_parameters_match_the_reference():
    rng = np.random.default_rng(0)
    mu = rng.normal(size=7).astype(np.float32)
    ls = rng.normal(scale=0.5, size=7).astype(np.float32)
    eta = {"mu": torch.as_tensor(mu), "log_sigma": torch.as_tensor(ls)}
    jeta = {"mu": jnp.asarray(mu), "log_sigma": jnp.asarray(ls)}
    nat = natural_from_eta(DiagGaussian(7), eta)
    jnat = j_natural_from_eta(JDiag(7), jeta)
    for k in ("h", "prec"):
        np.testing.assert_allclose(nat[k].numpy(), np.asarray(jnat[k]), rtol=1e-6)
    # A negative precision is floored, as in the reference.
    bad = {"h": nat["h"], "prec": nat["prec"] - 100.0}
    jbad = {"h": jnat["h"], "prec": jnat["prec"] - 100.0}
    back = eta_from_natural(DiagGaussian(7), bad, 1e-3)
    jback = j_eta_from_natural(JDiag(7), jbad, 1e-3)
    for k in ("mu", "log_sigma"):
        np.testing.assert_allclose(back[k].numpy(), np.asarray(jback[k]), rtol=1e-6)
    round_trip = eta_from_natural(DiagGaussian(7), nat)
    for k in ("mu", "log_sigma"):
        np.testing.assert_allclose(round_trip[k].numpy(), eta[k].numpy(), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# Server parity with the reference
# ---------------------------------------------------------------------------

MODELS = {"toy": (3, {}), "multinomial": (3, dict(n_per=10, in_dim=16))}
PARITY = [
    ("toy", "pvi", "flat", {}),
    ("toy", "pvi", "fused", {}),
    ("toy", "fed_ep", "flat", {}),
    ("toy", "fed_ep", "fused", {}),
    ("toy", "pvi", "fused", dict(int8=True, dp=(0.4, 1.0))),
    ("multinomial", "pvi", "fused", {}),
    ("multinomial", "fed_ep", "flat", {}),
]


def port_bundle(name, jb, J, kwargs):
    """The port's bundle on the reference bundle's data (toy draws the same
    numpy data on both sides)."""
    if name == "toy":
        return t_get(name).build(SEED, J, device="cpu", **kwargs)
    tr, te = jb.extras["train_all"], jb.extras["test"]
    return t_get(name).build(
        SEED, J, device="cpu", train=(np.asarray(tr["x"]), np.asarray(tr["y"])),
        test=(np.asarray(te["x"]), np.asarray(te["y"])), **kwargs)


@pytest.mark.parametrize("name,algo,wire,cfg", PARITY,
                         ids=["-".join([n, a, w] + sorted(c)) for n, a, w, c in PARITY])
def test_port_server_matches_reference(name, algo, wire, cfg):
    J, kwargs = MODELS[name]
    jb = j_get(name).build(SEED, J, **kwargs)
    tb = port_bundle(name, jb, J, kwargs)
    jprob = jb.problem
    dp = cfg.get("dp")
    jpol = None if dp is None else JPolicy(clip_norm=dp[1], noise_multiplier=dp[0])
    tpol = None if dp is None else TPolicy(clip_norm=dp[1], noise_multiplier=dp[0])
    local = jprob.model.has_local
    jsrv = JServer(
        jprob, jb.datas, jb.theta0, jprob.global_family.init(jax.random.PRNGKey(SEED)),
        num_obs=jb.num_obs, server_opt=j_adam(LR), local_opt=j_adam(LR) if local else None,
        compressor=JInt8() if cfg.get("int8") else None, wire=wire, privacy=jpol,
        seed=SEED, strategy=algo)
    place_as_after_a_round(jsrv)
    state = from_jax_state(jax.tree_util.tree_map(np.asarray, jsrv.state), "cpu")
    tsrv = TServer(
        tb.problem, tb.datas, state["theta"], state["eta_G"], num_obs=tb.num_obs,
        server_opt=t_adam(LR), local_opt=t_adam(LR) if local else None,
        compressor=TInt8() if cfg.get("int8") else None, wire=wire, privacy=tpol,
        seed=SEED, strategy=algo, device="cpu")
    for key in ("eta_L", "opt_local", "opt_server", "strategy"):
        fresh, ref = tree_leaves(tsrv.state[key]), tree_leaves(state[key])
        assert [t.shape for t in fresh] == [t.shape for t in ref], key
    tsrv.state = state
    draws = reference_draws(jprob, jpol, J, jsrv.wire_spec().dim)
    assert tsrv.wire_spec().dim == jsrv.wire_spec().dim
    for r in range(ROUNDS):
        jh = jsrv.run(1, local_steps=K, start_round=r)
        th = tsrv.run(1, local_steps=K, start_round=r, draws=draws)
        for key in ("bytes_up", "bytes_down", "n_active"):
            assert th[key] == jh[key], (r, key)
        np.testing.assert_allclose(th["elbo_trace"], jh["elbo_trace"], rtol=RTOL,
                                   err_msg=f"round {r}: elbo")
        assert_state_close(tsrv.state, jsrv.state, ("theta", "eta_G", "eta_L", "strategy"),
                           f"round {r}")
    assert any(float(torch.abs(x).max()) > 0 for x in tree_leaves(tsrv.state["strategy"]))
    if dp is not None:
        assert th["epsilon"][0] == pytest.approx(jh["epsilon"][0], abs=1e-6)


# ---------------------------------------------------------------------------
# Correctness anchors on the port alone
# ---------------------------------------------------------------------------


def _hier_problem(dG=3, dL=2):
    from repro_torch.core import ConditionalGaussian

    def log_prior_global(theta, zg):
        return -0.5 * torch.sum((zg - theta["m"]) ** 2)

    def log_local(theta, zg, zl, data):
        lp = -0.5 * torch.sum((zl - torch.mean(zg)) ** 2)
        ll = -0.5 * torch.sum((data["y"] - zl[None, :]) ** 2) * torch.exp(theta["lt"])
        return lp + ll

    model = StructuredModel(global_dim=dG, local_dim=dL,
                            log_prior_global=log_prior_global, log_local=log_local)
    return SFVIProblem(model, DiagGaussian(dG), ConditionalGaussian(dL, dG))


def _hier_setup(J=3):
    prob = _hier_problem()
    rng = np.random.default_rng(2)
    datas = [{"y": torch.as_tensor(rng.normal(size=(6, 2)).astype(np.float32))}
             for _ in range(J)]
    theta = {"m": torch.tensor(0.3), "lt": torch.tensor(-0.5)}
    eta_G = prob.global_family.init(generator(1, CPU), mu_scale=0.5)
    return prob, datas, theta, eta_G


def _conjugate_setup(J=4, n=20, prior_sd=5.0, mu_true=1.5, seed=0):
    """Global-only Gaussian: y_jk ~ N(z_G, 1), flat log-prior; the η_G init
    N(0, prior_sd²) is the implicit PVI prior factor."""
    model = StructuredModel(
        global_dim=1, local_dim=0,
        log_prior_global=lambda th, zg: torch.zeros(()),
        log_local=lambda th, zg, zl, d: -0.5 * torch.sum((d["y"] - zg[0]) ** 2))
    prob = SFVIProblem(model, DiagGaussian(1))
    rng = np.random.default_rng(seed)
    datas = [{"y": torch.as_tensor(rng.normal(mu_true, 1.0, n).astype(np.float32))}
             for _ in range(J)]
    eta0 = {"mu": torch.zeros(1), "log_sigma": torch.full((1,), float(np.log(prior_sd)))}
    return prob, datas, eta0


def _flat(tree):
    leaves = tree_leaves(tree)
    return torch.cat([x.reshape(-1) for x in leaves]) if leaves else torch.zeros(0)


@pytest.mark.parametrize("wire", ["flat", "fused"])
def test_damping_zero_is_a_fixed_point(wire):
    prob, datas, theta, eta_G = _hier_setup()
    srv = TServer(prob, datas, theta, eta_G, server_opt=t_adam(1e-2), local_opt=t_adam(1e-2),
                  seed=0, strategy=get_strategy("pvi")(damping=0.0), wire=wire, device="cpu")
    srv.run(2, local_steps=3)
    assert torch.equal(_flat(srv.state["theta"]), _flat(theta))
    np.testing.assert_allclose(_flat(srv.state["eta_G"]).numpy(), _flat(eta_G).numpy(),
                               rtol=1e-5, atol=1e-6)
    lam = _flat(srv.state["strategy"])
    assert lam.numel() == 2 * 3 * 3 and torch.equal(lam, torch.zeros_like(lam))


def test_sites_sum_to_posterior_minus_prior():
    prob, datas, eta0 = _conjugate_setup()
    srv = TServer(prob, datas, {}, eta0, server_opt=t_adam(5e-2), seed=0, strategy="pvi",
                  device="cpu")
    srv.run(5, local_steps=4)
    fam = prob.global_family
    nat0 = natural_from_eta(fam, eta0)
    natG = natural_from_eta(fam, srv.state["eta_G"])
    lam = srv.state["strategy"]["lam"]
    for k in ("h", "prec"):
        np.testing.assert_allclose(lam[k].sum(0).numpy(), (natG[k] - nat0[k]).numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_pvi_and_fed_ep_trajectories_differ():
    prob, datas, eta0 = _conjugate_setup()
    out = {}
    for algo in ("pvi", "fed_ep"):
        srv = TServer(prob, datas, {}, eta0, server_opt=t_adam(5e-2), seed=0, strategy=algo,
                      device="cpu")
        srv.run(3, local_steps=4)
        out[algo] = _flat(srv.state["eta_G"])
    assert not torch.equal(out["pvi"], out["fed_ep"])


@pytest.mark.parametrize("algo", ["pvi", "fed_ep"])
def test_non_diag_global_family_is_refused(algo):
    prob, datas, theta, _ = _hier_setup()
    prob = SFVIProblem(prob.model, build_family(FamilySpec("cholesky"), dim=3),
                       prob.local_family)
    eta_G = prob.global_family.init(generator(1, CPU))
    with pytest.raises(ValueError, match="diag"):
        TServer(prob, datas, theta, eta_G, server_opt=t_adam(1e-2), local_opt=t_adam(1e-2),
                strategy=algo, device="cpu")


def test_run_time_strategy_switch_fills_state():
    prob, datas, eta0 = _conjugate_setup()
    srv = TServer(prob, datas, {}, eta0, server_opt=t_adam(5e-2), seed=0,
                  strategy="sfvi_avg", device="cpu")
    assert not tree_leaves(srv.state["strategy"])
    srv.run(2, algorithm="pvi", local_steps=2)
    lam = srv.state["strategy"]["lam"]
    assert lam["h"].shape == (4, 1) and float(torch.abs(lam["prec"]).sum()) > 0


# ---------------------------------------------------------------------------
# The smoke config's bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["pvi", "fed_ep"])
def test_smoke_config_ships_126144_bytes_a_round(algo):
    J = 4
    bundle = t_get("multinomial").build(SEED, J, device="cpu", n_per=60, in_dim=196)
    prob = bundle.problem
    srv = TServer(prob, bundle.datas, bundle.theta0, prob.global_family.init(
        generator(SEED, CPU)), num_obs=bundle.num_obs, server_opt=t_adam(2e-2),
        seed=SEED, strategy=algo, device="cpu")
    assert srv.wire_spec().dim == 3942
    h = srv.run(3, local_steps=4)
    totals = [u + d for u, d in zip(h["bytes_up"], h["bytes_down"], strict=True)]
    assert totals == [126_144] * 3
    assert np.all(np.isfinite(h["elbo_trace"]))
