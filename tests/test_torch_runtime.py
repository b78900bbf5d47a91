"""The port's ``Server`` against the reference ``Server(wire="fused")``.

hier_bnn (in_dim 16, hidden 8), J = 3 silos of 20, K = 2 local steps,
3 rounds. Both sides start from one state (``convert.from_jax_state``)
on the reference's data, and the port is fed the reference's randomness:
ε_G / ε_{L_j} from ``strategy.global_eps`` / ``silo_eps`` under the round
key ``fold_in(PRNGKey(seed), r)``, the DP noise rows from the per-silo
upload keys, and the participation masks of the reference scheduler.

Tolerances: per-round θ / η_G / η_L and the ELBO within rtol 1e-4 (atol
1e-5 for entries near zero). The gradients agree to float32
reassociation (~1e-6, test_torch_sfvi.py), and Adam's division
m̂ / (√v̂ + ε) amplifies that: a coordinate whose gradient is tiny
moves by a full step whose size depends on the ratio, so the state
drifts by more than the gradients do. Bytes up / down and the active
count are exact; the accountant's ε within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federated.aggregation import (
    Int8Compressor as JInt8,
    TrimmedMeanAggregator as JTrimmed,
)
from repro.federated.privacy import PrivacyPolicy as JPolicy
from repro.federated.runtime import Server as JServer
from repro.federated.scheduler import RoundScheduler as JScheduler
from repro.federated.strategy import global_eps, silo_eps
from repro.models.paper.fixtures import hier_bnn_federation as j_federation
from repro.optim.adam import adam as j_adam
from repro_torch.convert import datas_from_numpy, from_jax_state
from repro_torch.federated.aggregation import (
    Int8Compressor as TInt8,
    TrimmedMeanAggregator as TTrimmed,
)
from repro_torch.federated import runtime as truntime
from repro_torch.federated.privacy import PrivacyPolicy as TPolicy
from repro_torch.federated.runtime import Server as TServer
from repro_torch.models.paper.hier_bnn import build_hier_bnn
from repro_torch.models.paper.registry import get_model
from repro_torch.optim.adam import adam as t_adam
from repro_torch.tree import tree_leaves

J, K, ROUNDS, SEED, LR = 3, 2, 3, 0, 2e-2
RTOL, ATOL = 1e-4, 1e-5

CONFIGS = {
    "sfvi": dict(algo="sfvi"),
    "sfvi+partial": dict(algo="sfvi", participation=0.67),
    "sfvi+int8+trimmed": dict(algo="sfvi", int8=True, trim=0.34),
    "sfvi_avg": dict(algo="sfvi_avg"),
    "sfvi_avg+int8+trimmed+dp+partial": dict(
        algo="sfvi_avg", int8=True, trim=0.34, dp=(0.3, 0.3), participation=0.67),
}


class ReplayScheduler:
    """Hands the port the reference scheduler's masks."""

    def __init__(self, jsched):
        self._j = jsched
        self.participation = jsched.participation

    def mask(self, i):
        return np.asarray(self._j.mask(i))

    def invited(self, i):
        return np.asarray(self._j.invited(i))


def reference_draws(jprob, jpolicy, P):
    """draws(r, t) reproducing the reference's ε and DP noise streams."""
    base = jax.random.PRNGKey(SEED)

    def draws(r, t):
        rk = jax.random.fold_in(base, r)
        eps_G = np.array(global_eps(jprob, rk, t))
        eps_L = np.stack([np.array(silo_eps(jprob, rk, t, j)) for j in range(J)])
        noise = None
        if jpolicy is not None:
            noise = np.stack([np.array(jax.random.normal(
                jax.random.fold_in(jpolicy.upload_key(rk, t, j), 0), (P,), jnp.float32))
                for j in range(J)])
        return (torch.as_tensor(eps_G), torch.as_tensor(eps_L),
                None if noise is None else torch.as_tensor(noise))

    return draws


def _np_state(state):
    return jax.tree_util.tree_map(np.asarray, state)


def _build(cfg, wire="fused"):
    jbnn, train, _ = j_federation(seed=SEED, num_silos=J, in_dim=16, hidden=8,
                                  train_per_silo=20, test_per_silo=4)
    jprob = jbnn.problem
    dp = cfg.get("dp")
    jpol = None if dp is None else JPolicy(clip_norm=dp[1], noise_multiplier=dp[0])
    tpol = None if dp is None else TPolicy(clip_norm=dp[1], noise_multiplier=dp[0])
    jsrv = JServer(
        jprob, train, {}, jprob.global_family.init(jax.random.PRNGKey(SEED)),
        server_opt=j_adam(LR), local_opt=j_adam(LR),
        aggregator=JTrimmed(cfg["trim"]) if "trim" in cfg else None,
        compressor=JInt8() if cfg.get("int8") else None,
        wire="fused", privacy=jpol, seed=SEED, strategy=cfg["algo"])
    tprob = build_hier_bnn(in_dim=16, hidden=8).problem
    state = from_jax_state(_np_state(jsrv.state), "cpu")
    tsrv = TServer(
        tprob, datas_from_numpy([{k: np.asarray(v) for k, v in d.items()} for d in train],
                                "cpu"),
        state["theta"], state["eta_G"], server_opt=t_adam(LR), local_opt=t_adam(LR),
        aggregator=TTrimmed(cfg["trim"]) if "trim" in cfg else None,
        compressor=TInt8() if cfg.get("int8") else None,
        wire=wire, privacy=tpol, seed=SEED, strategy=cfg["algo"], device="cpu")
    tsrv.state = state
    sched = JScheduler(J, participation=cfg.get("participation", 1.0), seed=SEED)
    draws = reference_draws(jprob, jpol, jsrv.wire_spec().dim)
    return jsrv, tsrv, sched, draws


def _assert_state_close(tstate, jstate, what):
    for key in ("theta", "eta_G", "eta_L"):
        tl, jl = tree_leaves(tstate[key]), jax.tree_util.tree_leaves(jstate[key])
        assert len(tl) == len(jl), key
        for a, b in zip(tl, jl, strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}: {key}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_server_matches_reference_fused(name):
    cfg = CONFIGS[name]
    jsrv, tsrv, sched, draws = _build(cfg)
    replay = ReplayScheduler(sched)
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
        _assert_state_close(tsrv.state, jsrv.state, f"round {r}")
        if "epsilon" in jh:
            assert th["epsilon"][0] == pytest.approx(jh["epsilon"][0], abs=1e-6)
        else:
            assert "epsilon" not in th
    if cfg.get("participation"):
        assert min(jsrv.comm.bytes_up, tsrv.comm.bytes_up) > 0
        assert tsrv.comm.bytes_up == jsrv.comm.bytes_up


@pytest.mark.parametrize("name", ["sfvi", "sfvi_avg+int8+trimmed+dp+partial"])
def test_port_flat_and_fused_agree(name):
    """The port's plain-stage wire and its kernel wire on one injected stream."""
    cfg = CONFIGS[name]
    _, fused, sched, draws = _build(cfg, wire="fused")
    _, flat, _, _ = _build(cfg, wire="flat")
    replay = ReplayScheduler(sched)
    hf = fused.run(ROUNDS, local_steps=K, scheduler=replay, draws=draws)
    hp = flat.run(ROUNDS, local_steps=K, scheduler=replay, draws=draws)
    assert hf["bytes_up"] == hp["bytes_up"] and hf["n_active"] == hp["n_active"]
    np.testing.assert_allclose(hf["elbo_trace"], hp["elbo_trace"], rtol=RTOL)
    for key in ("eta_G", "eta_L"):
        for a, b in zip(tree_leaves(fused.state[key]), tree_leaves(flat.state[key]),
                        strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["sfvi+int8+trimmed", "sfvi_avg+int8+trimmed+dp+partial"])
def test_fused_wire_merges_run_as_the_combine_kernel(name, monkeypatch):
    """On the fused wire every merge is one ``fused_combine`` call whose output
    the round reads: step cadence dequantizes int8 inside the kernel; the
    barycenter merges its two moment rows (mean, std) with the kernel and
    no combined wire row is formed (θ = ∅)."""
    cfg = CONFIGS[name]
    calls = []
    kernel = truntime.wire_kernels.fused_combine

    def recording(x, w, *, scales=None, trim_frac=None):
        calls.append((tuple(x.shape), x.dtype, scales is not None, trim_frac))
        return kernel(x, w, scales=scales, trim_frac=trim_frac)

    monkeypatch.setattr(truntime.wire_kernels, "fused_combine", recording)
    bundle = get_model("hier_bnn").build(SEED, J, device="cpu", in_dim=16, hidden=8,
                                         train_per_silo=20)
    prob = bundle.problem
    dp = cfg.get("dp")
    srv = TServer(prob, bundle.datas, {}, prob.global_family.init(torch.Generator()),
                  server_opt=t_adam(LR), local_opt=t_adam(LR),
                  aggregator=TTrimmed(cfg["trim"]), compressor=TInt8(),
                  privacy=None if dp is None else TPolicy(clip_norm=dp[1],
                                                          noise_multiplier=dp[0]),
                  strategy=cfg["algo"], device="cpu")
    gdim, P = prob.model.global_dim, srv.wire_spec().dim
    hist = srv.run(1, local_steps=K)
    assert np.all(np.isfinite(hist["elbo_trace"]))
    if cfg["algo"] == "sfvi":
        assert calls == [((J, P), torch.int8, True, cfg["trim"])] * K
    else:
        assert calls == [((J, gdim), torch.float32, False, cfg["trim"])] * 2
