"""Buffered-async execution in the port (``repro_torch.federated.async_engine``)
against the JAX package's (``repro.federated.async_engine``).

* The numpy streams need no injection: ``latency_draw`` equals the
  reference's bit for bit over a (seed, silo, task) grid for all three
  latency models; 50-flush ``simulate_flush`` schedules (counts, staleness,
  flush times, and the ``BufferState`` after each flush as JSON text) are
  equal with and without an ``active`` mask; ``flush_weights`` are equal.
* ``run_buffered`` on the benchmark smoke config (multinomial, in_dim 196,
  J = 4 silos of 60, K = 4, B = 2, straggler latency; the reference's data,
  state, ε and DP noise) against the reference's: ELBO within rtol 1e-4,
  bytes, active counts, staleness and ``sim_time`` exact, ε within 1e-6,
  over 6 flushes for both rows. η_G and the server moments are held at
  rtol 1e-4 after every flush, up to the first flush where an int8 level
  may flip: one whose upload puts an entry within float32 round-off of a
  rounding boundary (1e-5 of a step). From there η_G is held within one
  int8 step of that flush's dequantized rows, plus one Adam step (lr) for
  each later flush, and the ELBO of the later flushes within rtol 1e-3.
* B = J with constant latency is the port's own synchronous ``Server.run``
  bit for bit.
* The smoke config's two async rows (``benchmarks/baseline.json``), 25
  flushes through the experiment API: exactly 63,072 and 39,428 B a flush,
  ``sim_seconds`` exactly 28.0, and ε within 1e-4 of 254.6345 for the DP row.
* An async int8 + DP run saved mid-run resumes bit for bit, buffer included;
  ``run_buffered`` refuses step-cadence strategies and buffers outside [1, J].
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro.federated.async_engine as jae
import repro.federated.scheduler as jsched
import repro_torch.federated.api as tapi
import repro_torch.federated.async_engine as tae
import repro_torch.federated.scheduler as tsched
from repro.federated.aggregation import Int8Compressor as JInt8
from repro.federated.privacy import PrivacyPolicy as JPolicy
from repro.federated.runtime import Server as JServer
from repro.models.paper.registry import get_model as j_get
from repro.optim.adam import adam as j_adam
from repro_torch.convert import from_jax_state
from repro_torch.federated.aggregation import Int8Compressor as TInt8
from repro_torch.federated.privacy import PrivacyPolicy as TPolicy
from repro_torch.federated.runtime import Server as TServer
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wire as twire
from repro_torch.models.paper.registry import get_model as t_get
from repro_torch.optim.adam import adam as t_adam
from repro_torch.tree import tree_leaves
from test_torch_paper_servers import _place_as_after_a_round, reference_draws

SEED, RTOL, ATOL = 0, 1e-4, 1e-5
STATE_KEYS = ("theta", "eta_G", "eta_L", "opt_server", "opt_local", "strategy")
LATENCIES = ("constant", "lognormal", "straggler")


def _cfgs(latency, buffer_size=2, **kw):
    args = dict(buffer_size=buffer_size, latency=latency, latency_scale=1.5,
                latency_sigma=0.7, **kw)
    return tsched.AsyncConfig(**args), jsched.AsyncConfig(**args)


# ---------------------------------------------------------------------------
# The event loop: numpy streams, equal with no injection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("latency", LATENCIES)
def test_latency_draws_equal_the_reference(latency):
    tcfg, jcfg = _cfgs(latency, straggler_frac=0.3)
    for seed in (0, 3, 12_345):
        for silo in range(5):
            for task in (0, 1, 7, 200):
                assert tae.latency_draw(tcfg, seed, silo, task) == jae.latency_draw(
                    jcfg, seed, silo, task), (seed, silo, task)
    with pytest.raises(ValueError, match="unknown latency"):
        tae.latency_draw(dataclasses.replace(tcfg, latency="pareto"), 0, 0, 0)


@pytest.mark.parametrize("churn", [False, True], ids=["all_active", "active_mask"])
@pytest.mark.parametrize("latency", LATENCIES)
def test_flush_schedules_equal_the_reference(latency, churn):
    J, seed = 5, 7
    tcfg, jcfg = _cfgs(latency, buffer_size=3)
    ts, js = tae.BufferState.init(J, tcfg, seed), jae.BufferState.init(J, jcfg, seed)
    assert json.dumps(ts.state_dict()) == json.dumps(js.state_dict())
    rng = np.random.default_rng(11)
    for f in range(50):
        active = None
        if churn:
            active = [int(a) for a in rng.random(J) < 0.7]
            active[f % J] = 1
        tc, tst, tt = tae.simulate_flush(ts, tcfg, seed, J, active=active)
        jc, jst, jt = jae.simulate_flush(js, jcfg, seed, J, active=active)
        assert np.array_equal(tc, jc) and np.array_equal(tst, jst) and tt == jt, f
        assert tc.dtype == jc.dtype == np.float32
        assert json.dumps(ts.state_dict()) == json.dumps(js.state_dict()), f
        tw = tae.flush_weights(tc, tst, 0.5)
        assert tw.dtype == np.float32
        assert np.array_equal(tw, jae.flush_weights(jc, jst, 0.5)), f
    back = tae.BufferState.from_state(json.loads(json.dumps(ts.state_dict())))
    assert back == ts
    with pytest.raises(ValueError, match="at least one active silo"):
        tae.simulate_flush(ts, tcfg, seed, J, active=[0] * J)


def test_flush_weights_equal_the_reference():
    counts = np.array([2.0, 1.0, 0.0, 1.0, 3.0], np.float32)
    stale = np.array([0.0, 1.0, 5.0, 3.0, 7.0], np.float32)
    for decay in (0.0, 0.5, 1.0, 2.3):
        t = tae.flush_weights(counts, stale, decay)
        assert np.array_equal(t, jae.flush_weights(counts, stale, decay)), decay
    assert np.array_equal(tae.flush_weights(counts, np.zeros(5, np.float32), 0.5), counts)


# ---------------------------------------------------------------------------
# run_buffered against the reference's, on the smoke config
# ---------------------------------------------------------------------------

SMOKE = dict(J=4, n_per=60, in_dim=196, K=4, lr=2e-2)
FLUSHES = 6
ASYNC_ROWS = {
    # row: Server options
    "sfvi_avg": {},
    "sfvi_avg+int8+dp": dict(int8=True, dp=(0.3, 0.3)),
}
TIE = 1e-5  # in int8 steps: an entry this close to a rounding boundary may round either way


def _smoke_servers(row):
    J, kw = SMOKE["J"], ASYNC_ROWS[row]
    jb = j_get("multinomial").build(SEED, J, n_per=SMOKE["n_per"], in_dim=SMOKE["in_dim"])
    tr, te = jb.extras["train_all"], jb.extras["test"]
    tb = t_get("multinomial").build(
        SEED, J, device="cpu", n_per=SMOKE["n_per"], in_dim=SMOKE["in_dim"],
        train=(np.asarray(tr["x"]), np.asarray(tr["y"])),
        test=(np.asarray(te["x"]), np.asarray(te["y"])))
    dp = kw.get("dp")
    jpol = None if dp is None else JPolicy(clip_norm=dp[1], noise_multiplier=dp[0])
    tpol = None if dp is None else TPolicy(clip_norm=dp[1], noise_multiplier=dp[0])
    jprob = jb.problem
    jsrv = JServer(jprob, jb.datas, jb.theta0,
                   jprob.global_family.init(jax.random.PRNGKey(SEED)), num_obs=jb.num_obs,
                   server_opt=j_adam(SMOKE["lr"]), compressor=JInt8() if kw.get("int8") else None,
                   wire="fused", privacy=jpol, seed=SEED, strategy="sfvi_avg")
    _place_as_after_a_round(jsrv)
    state = from_jax_state(jax.tree_util.tree_map(np.asarray, jsrv.state), "cpu")
    tsrv = TServer(tb.problem, tb.datas, state["theta"], state["eta_G"], num_obs=tb.num_obs,
                   server_opt=t_adam(SMOKE["lr"]),
                   compressor=TInt8() if kw.get("int8") else None, privacy=tpol,
                   seed=SEED, strategy="sfvi_avg", device="cpu")
    tsrv.state = state
    return jsrv, tsrv, reference_draws(jprob, jpol, J, jsrv.wire_spec().dim)


def _int8_uploads(monkeypatch):
    """Record each int8 upload of the port: (the largest step of the rows
    sent, how close any sent entry lies to a rounding boundary, in steps)."""
    seen = []
    upload = twire.fused_upload

    def recorded(x, **kw):
        out = upload(x, **kw)
        if kw.get("quantize"):
            y = tref.wire_upload_ref(x, **dict(kw, quantize=False))
            sent = kw["mask"] > 0
            scale = out[1][sent]
            v = (y[sent] / scale[:, None]).abs()
            seen.append((float(scale.max()), float((v - v.floor() - 0.5).abs().min())))
        return out

    monkeypatch.setattr(twire, "fused_upload", recorded)
    return seen


def _server_state(srv, leaves):
    return [[np.asarray(x).copy() for x in leaves(srv.state[k])] for k in ("eta_G", "opt_server")]


@pytest.mark.parametrize("row", list(ASYNC_ROWS))
def test_run_buffered_matches_the_reference(row, monkeypatch):
    jsrv, tsrv, draws = _smoke_servers(row)
    tcfg, jcfg = _cfgs("straggler")
    K = SMOKE["K"]
    uploads = _int8_uploads(monkeypatch)
    j_after, t_after, seen = [], [], []
    jh, jstate = jae.run_buffered(
        jsrv, FLUSHES, jcfg, local_steps=K,
        callback=lambda f, m: j_after.append(_server_state(jsrv, jax.tree_util.tree_leaves)))

    def t_cb(f, m):
        seen.append(m["weights"])
        t_after.append(_server_state(tsrv, lambda t: [x.numpy() for x in tree_leaves(t)]))

    th, tstate = tae.run_buffered(tsrv, FLUSHES, tcfg, local_steps=K, draws=draws,
                                  callback=t_cb)
    assert json.dumps(tstate.state_dict()) == json.dumps(jstate.state_dict())
    for key in ("bytes_up", "bytes_down", "n_active", "staleness", "sim_time"):
        assert th[key] == jh[key], key
    assert any(set(np.unique(w)) - {0.0, 1.0} for w in seen)  # stale weights reached the combine
    assert tsrv.comm.state_dict() == jsrv.comm.state_dict()
    if "dp" in ASYNC_ROWS[row]:
        np.testing.assert_allclose(th["epsilon"], jh["epsilon"], atol=1e-6)

    def close(f):
        return all(np.allclose(a, b, rtol=RTOL, atol=ATOL)
                   for ta, ja in zip(t_after[f], j_after[f], strict=True)
                   for a, b in zip(ta, ja, strict=True))

    # The first flush after which the states part: none for the f32 row;
    # for int8 only one whose upload held a float32 tie.
    split = next((f for f in range(FLUSHES) if not close(f)), FLUSHES)
    if split < FLUSHES:
        assert "int8" in ASYNC_ROWS[row] and uploads[split][1] <= TIE, (split, uploads)
    np.testing.assert_allclose(th["elbo_trace"][:(split + 1) * K],
                               jh["elbo_trace"][:(split + 1) * K], rtol=RTOL)
    np.testing.assert_allclose(th["elbo_trace"], jh["elbo_trace"], rtol=10 * RTOL)
    # After the flip: one int8 step of that flush's rows, and one more
    # server step (Adam moves a coordinate by about lr) each later flush.
    for f in range(split, FLUSHES):
        bound = uploads[split][0] + (f - split) * SMOKE["lr"] + ATOL
        for a, b in zip(t_after[f][0], j_after[f][0], strict=True):
            assert np.all(np.abs(a - b) <= bound), (f, bound, float(np.abs(a - b).max()))


def _toy_server(**kw):
    b = t_get("toy").build(SEED, 4, device="cpu", num_obs=12)
    eta_G = b.problem.global_family.init(torch.Generator().manual_seed(SEED))
    return TServer(b.problem, b.datas, {}, eta_G, num_obs=b.num_obs, server_opt=t_adam(2e-2),
                   local_opt=t_adam(2e-2), seed=SEED, device="cpu", **kw)


@pytest.mark.parametrize("algo", ["sfvi_avg", "pvi"])
def test_full_buffer_constant_latency_is_the_sync_run(algo):
    sync, asyn = _toy_server(strategy=algo), _toy_server(strategy=algo)
    hs = sync.run(5, local_steps=3)
    ha, st = tae.run_buffered(asyn, 5, tsched.AsyncConfig(buffer_size=4, latency="constant"),
                              local_steps=3)
    for k in STATE_KEYS:
        for a, b in zip(tree_leaves(sync.state[k]), tree_leaves(asyn.state[k]), strict=True):
            assert torch.equal(a, b), k
    for k in hs:
        assert ha[k] == hs[k], k
    assert ha["staleness"] == [0.0] * 5 and ha["sim_time"] == [1.0, 2.0, 3.0, 4.0, 5.0]
    assert st.version == 5 and asyn.comm.sim_seconds == 5.0


def test_run_buffered_refusals():
    srv = _toy_server(strategy="sfvi")
    with pytest.raises(ValueError, match="round-cadence"):
        tae.run_buffered(srv, 1, tsched.AsyncConfig(buffer_size=2))
    for b in (0, 5):
        with pytest.raises(ValueError, match=r"buffer_size must be in \[1, J=4\]"):
            tae.run_buffered(srv, 1, tsched.AsyncConfig(buffer_size=b), algorithm="sfvi_avg")
    with pytest.raises(ValueError, match="local_steps"):
        tae.run_buffered(srv, 1, tsched.AsyncConfig(), algorithm="sfvi_avg", local_steps=0)


# ---------------------------------------------------------------------------
# The smoke config's async rows through the experiment API
# ---------------------------------------------------------------------------

BASELINE_ROWS = {
    # row: (scenario kwargs, bytes up + down a flush, epsilon after 25 flushes)
    "SFVI-Avg async(B=2,straggler,d=0.5)": ({}, 63_072, None),
    "SFVI-Avg async(B=2,straggler,d=0.5) int8 dp(z=0.3,C=0.3)": (
        dict(compression="int8", dp_noise=0.3, dp_clip=0.3), 39_428, 254.6345),
}


def _smoke_spec(rounds=25, **scenario):
    return tapi.ExperimentSpec(
        model=tapi.ModelSpec("multinomial", {"n_per": 60, "in_dim": 196}),
        scenario=tsched.Scenario(
            algorithm="sfvi_avg",
            async_cfg=tsched.AsyncConfig(buffer_size=2, latency="straggler"), **scenario),
        num_silos=4, rounds=rounds, local_steps=4,
        server_opt=tapi.OptimizerSpec("adam", 2e-2), seed=0,
        runtime=tapi.RuntimeSpec(wire="fused"))


@pytest.mark.parametrize("row", list(BASELINE_ROWS))
def test_smoke_async_rows_exact_bytes_time_and_epsilon(row):
    scenario, per_flush, eps = BASELINE_ROWS[row]
    spec = _smoke_spec(**scenario)
    assert spec.scenario.name == row
    exp = tapi.build(spec, device="cpu")
    h = exp.run()
    totals = [u + d for u, d in zip(h["bytes_up"], h["bytes_down"], strict=True)]
    assert totals == [per_flush] * 25
    assert exp.comm.sim_seconds == 28.0 and exp.comm.per_round == per_flush
    assert np.all(np.isfinite(h["elbo_trace"]))
    if eps is None:
        assert "epsilon" not in h
    else:
        assert h["epsilon"][-1] == pytest.approx(eps, abs=1e-4)


def test_async_dp_int8_save_resume_is_bit_exact(tmp_path):
    spec = tapi.ExperimentSpec(
        model=tapi.ModelSpec("toy", {"num_obs": 12}),
        scenario=tsched.Scenario(
            algorithm="sfvi_avg", compression="int8", dp_noise=0.3, dp_clip=0.5,
            async_cfg=tsched.AsyncConfig(buffer_size=2, latency="lognormal")),
        num_silos=4, rounds=8, local_steps=2, seed=3, runtime=tapi.RuntimeSpec(wire="fused"))
    full = tapi.build(spec, device="cpu")
    h_full = full.run()
    part = tapi.build(spec, device="cpu")
    h_first = dict(part.run(3))
    part.save(str(tmp_path))
    meta = json.loads((tmp_path / "step_00000003.meta.json").read_text())
    assert meta["async_state"] == part.async_state.state_dict()
    res = tapi.Experiment.resume(str(tmp_path), device="cpu")
    assert res.round == 3 and res.async_state == part.async_state
    h_rest = res.run()
    for k in STATE_KEYS:
        for a, b in zip(tree_leaves(full.server.state[k]), tree_leaves(res.server.state[k]),
                        strict=True):
            assert torch.equal(a, b), k
    for k, v in h_full.items():
        assert v == h_first[k] + h_rest[k], k
    assert res.async_state.state_dict() == full.async_state.state_dict()
    assert res.comm.state_dict() == full.comm.state_dict()
    assert np.array_equal(res.accountant.rdp, full.accountant.rdp)
