"""The paper's multinomial (S3.2), hetero_mn and ProdLDA (§4.2) federations
in the port's ``Server``, against the JAX package's.

* 3 rounds of the port's ``Server`` (fused wire, whose kernel wrappers take
  their plain versions on the CPU) against the reference
  ``Server(wire="fused")``: multinomial (in_dim 16, J = 3 silos of 10),
  hetero_mn (36 samples, in_dim 16, J = 3: unequal N_j, padded rows) and
  ProdLDA (vocab 30, 4 topics, 6 documents a silo, J = 2), K = 2. Both
  sides start from one state (``convert.from_jax_state``) on the
  reference's data, and the port is fed the reference's ε and DP noise and
  its scheduler's masks. Configs: SFVI, SFVI-Avg (the first θ ≠ ∅ merge:
  the combined wire row is formed as well as the barycenter's moment rows)
  and SFVI-Avg + int8 + trimmed + DP. θ, η_G, η_L and the ELBO within rtol
  1e-4 (atol 1e-5 near zero; Adam amplifies float32 reassociation, see
  ``test_torch_runtime.py``); bytes and active counts exact; ε within 1e-6.
* The smoke config of the repo's benchmark (multinomial, in_dim 196, J =
  4 silos of 60, K = 4, 25 rounds, the reference's data) on the port alone,
  flat wire: bytes up + down a round exactly 504,576 (SFVI), 126,144
  (SFVI-Avg), 78,856 (SFVI-Avg int8) and 126,144 (SFVI-Avg DP), and ε after
  25 rounds within 1e-4 of 289.2907 (``benchmarks/baseline.json``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.data import make_synthetic_mnist as j_mnist
from repro.federated.aggregation import (
    Int8Compressor as JInt8,
    TrimmedMeanAggregator as JTrimmed,
)
from repro.federated.privacy import PrivacyPolicy as JPolicy
from repro.federated.runtime import Server as JServer
from repro.federated.scheduler import RoundScheduler as JScheduler
from repro.federated.strategy import global_eps, silo_eps
from repro.models.paper.registry import get_model as j_get
from repro.optim.adam import adam as j_adam
from repro_torch.convert import from_jax_state
from repro_torch.federated.aggregation import (
    Int8Compressor as TInt8,
    TrimmedMeanAggregator as TTrimmed,
)
from repro_torch.federated.privacy import PrivacyPolicy as TPolicy
from repro_torch.federated.runtime import Server as TServer
from repro_torch.models.paper.registry import get_model as t_get
from repro_torch.optim.adam import adam as t_adam
from repro_torch.tree import tree_leaves

SEED, K, ROUNDS, LR = 0, 2, 3, 2e-2
RTOL, ATOL = 1e-4, 1e-5

# model -> (J, reference builder kwargs)
MODELS = {
    "multinomial": (3, dict(n_per=10, in_dim=16)),
    "hetero_mn": (3, dict(n_total=36, in_dim=16)),
    "prodlda": (2, dict(vocab_size=30, num_topics=4, docs_per_silo=6)),
}
CONFIGS = {
    "sfvi": dict(algo="sfvi"),
    "sfvi_avg": dict(algo="sfvi_avg"),
    "sfvi_avg+int8+trimmed+dp": dict(algo="sfvi_avg", int8=True, trim=0.34, dp=(0.3, 0.3)),
}


def _port_bundle(name, jb, J, kwargs):
    """The port's bundle on the reference bundle's data."""
    if name == "prodlda":
        return t_get(name).build(SEED, J, device="cpu", counts=jb.extras["counts"], **kwargs)
    tr, te = jb.extras["train_all"], jb.extras["test"]
    return t_get(name).build(
        SEED, J, device="cpu", train=(np.asarray(tr["x"]), np.asarray(tr["y"])),
        test=(np.asarray(te["x"]), np.asarray(te["y"])), **kwargs)


# ---------------------------------------------------------------------------
# Server parity
# ---------------------------------------------------------------------------


class ReplayScheduler:
    """Hands the port the reference scheduler's masks."""

    def __init__(self, jsched):
        self._j = jsched
        self.participation = jsched.participation

    def mask(self, i):
        return np.asarray(self._j.mask(i))

    def invited(self, i):
        return np.asarray(self._j.invited(i))


def reference_draws(jprob, jpolicy, J, P):
    """draws(r, t) reproducing the reference's ε and DP noise streams; ε_L is
    None for a model without local latents (multinomial, hetero_mn)."""
    base = jax.random.PRNGKey(SEED)

    def draws(r, t):
        rk = jax.random.fold_in(base, r)
        eps_G = torch.as_tensor(np.array(global_eps(jprob, rk, t)))
        eps_L = None
        if jprob.model.has_local:
            eps_L = torch.as_tensor(np.stack(
                [np.array(silo_eps(jprob, rk, t, j)) for j in range(J)]))
        noise = None
        if jpolicy is not None:
            noise = torch.as_tensor(np.stack([np.array(jax.random.normal(
                jax.random.fold_in(jpolicy.upload_key(rk, t, j), 0), (P,), jnp.float32))
                for j in range(J)]))
        return eps_G, eps_L, noise

    return draws


def _place_as_after_a_round(jsrv):
    """Give the reference's initial state the placement and strong types
    its round returns (the same values), so that its jitted round is traced
    once and not again in round 1."""
    def put(spec):
        sh = NamedSharding(jsrv.mesh, spec)
        return lambda x: jax.device_put(jnp.asarray(x, dtype=x.dtype), sh)

    for k, spec in (("theta", P()), ("eta_G", P()), ("opt_server", P()),
                    ("eta_L", P("silo")), ("opt_local", P("silo")), ("strategy", P("silo"))):
        jsrv.state[k] = jax.tree_util.tree_map(put(spec), jsrv.state[k])


def _build_servers(name, cfg):
    J, kwargs = MODELS[name]
    jb = j_get(name).build(SEED, J, **kwargs)
    tb = _port_bundle(name, jb, J, kwargs)
    jprob = jb.problem
    dp = cfg.get("dp")
    jpol = None if dp is None else JPolicy(clip_norm=dp[1], noise_multiplier=dp[0])
    tpol = None if dp is None else TPolicy(clip_norm=dp[1], noise_multiplier=dp[0])
    jsrv = JServer(
        jprob, jb.datas, jb.theta0, jprob.global_family.init(jax.random.PRNGKey(SEED)),
        num_obs=jb.num_obs, server_opt=j_adam(LR), local_opt=j_adam(LR),
        aggregator=JTrimmed(cfg["trim"]) if "trim" in cfg else None,
        compressor=JInt8() if cfg.get("int8") else None,
        wire="fused", privacy=jpol, seed=SEED, strategy=cfg["algo"])
    _place_as_after_a_round(jsrv)
    state = from_jax_state(jax.tree_util.tree_map(np.asarray, jsrv.state), "cpu")
    tsrv = TServer(
        tb.problem, tb.datas, state["theta"], state["eta_G"], num_obs=tb.num_obs,
        server_opt=t_adam(LR), local_opt=t_adam(LR),
        aggregator=TTrimmed(cfg["trim"]) if "trim" in cfg else None,
        compressor=TInt8() if cfg.get("int8") else None,
        privacy=tpol, seed=SEED, strategy=cfg["algo"], device="cpu")
    assert tsrv.wire == "fused"
    tsrv.state = state
    sched = JScheduler(J, seed=SEED)
    return jsrv, tsrv, sched, reference_draws(jprob, jpol, J, jsrv.wire_spec().dim)


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
@pytest.mark.parametrize("name", list(MODELS))
def test_port_server_matches_reference(name, cfg_name):
    jsrv, tsrv, sched, draws = _build_servers(name, CONFIGS[cfg_name])
    replay = ReplayScheduler(sched)
    assert sorted(tsrv.theta) == sorted(jsrv.theta) and len(tsrv.theta) == 2
    assert tsrv.wire_spec().dim == jsrv.wire_spec().dim
    assert tsrv.bytes_up_per_silo() == jsrv.bytes_up_per_silo()
    assert tsrv.bytes_down_per_silo() == jsrv.bytes_down_per_silo()
    for r in range(ROUNDS):
        jh = jsrv.run(1, local_steps=K, scheduler=sched, start_round=r)
        th = tsrv.run(1, local_steps=K, scheduler=replay, start_round=r, draws=draws)
        for key in ("bytes_up", "bytes_down", "n_active"):
            assert th[key] == jh[key], (r, key)
        np.testing.assert_allclose(th["elbo_trace"], jh["elbo_trace"], rtol=RTOL,
                                   err_msg=f"round {r}: elbo")
        for key in ("theta", "eta_G", "eta_L"):
            tl = tree_leaves(tsrv.state[key])
            jl = jax.tree_util.tree_leaves(jsrv.state[key])
            assert len(tl) == len(jl), key
            for a, b in zip(tl, jl, strict=True):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL,
                                           err_msg=f"round {r}: {key}")
        if "epsilon" in jh:
            assert th["epsilon"][0] == pytest.approx(jh["epsilon"][0], abs=1e-6)
        else:
            assert "epsilon" not in th


# ---------------------------------------------------------------------------
# The benchmark smoke config's exact figures
# ---------------------------------------------------------------------------

SMOKE = dict(J=4, n_per=60, in_dim=196, K=4, rounds=25, lr=2e-2)
SMOKE_ROWS = {
    # row: (Server kwargs, bytes up + down a round)
    "SFVI": (dict(strategy="sfvi"), 504_576),
    "SFVI-Avg": (dict(strategy="sfvi_avg"), 126_144),
    "SFVI-Avg int8": (dict(strategy="sfvi_avg", compressor=TInt8()), 78_856),
    "SFVI-Avg dp(z=0.3,C=0.3)": (
        dict(strategy="sfvi_avg",
             privacy=TPolicy(clip_norm=0.3, noise_multiplier=0.3)), 126_144),
}


def test_smoke_config_exact_bytes_and_epsilon_on_the_port():
    J = SMOKE["J"]
    tr, te = j_mnist(jax.random.PRNGKey(SEED), J * SMOKE["n_per"], max(200, J * 20),
                     dim=SMOKE["in_dim"], prototype_scale=0.6, noise_scale=3.0)
    bundle = t_get("multinomial").build(
        SEED, J, device="cpu", n_per=SMOKE["n_per"], in_dim=SMOKE["in_dim"],
        train=(tr.x, tr.y), test=(te.x, te.y))
    prob = bundle.problem
    for row, (kw, per_round) in SMOKE_ROWS.items():
        srv = TServer(prob, bundle.datas, bundle.theta0,
                      prob.global_family.init(torch.Generator().manual_seed(SEED)),
                      num_obs=bundle.num_obs, server_opt=t_adam(SMOKE["lr"]), wire="flat",
                      seed=SEED, device="cpu", **kw)
        h = srv.run(SMOKE["rounds"], local_steps=SMOKE["K"])
        totals = [u + d for u, d in zip(h["bytes_up"], h["bytes_down"], strict=True)]
        assert totals == [per_round] * SMOKE["rounds"], row
        assert srv.comm.per_round == per_round, row
        assert np.all(np.isfinite(h["elbo_trace"])), row
        if "dp" in row:
            assert h["epsilon"][-1] == pytest.approx(289.2907, abs=1e-4)
        else:
            assert "epsilon" not in h
