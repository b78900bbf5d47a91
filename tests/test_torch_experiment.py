"""The port's ``Experiment``: save → resume, within the port and across
packages (``repro.federated.api``).

* Within the port, on the CPU: a run saved after 3 of 6 rounds and resumed
  into a fresh object replays the uninterrupted run bit for bit (every
  state leaf, the ELBO history, the meter, ε) for SFVI, SFVI-Avg + int8 +
  DP with partial participation, and PVI + int8 + DP (its sites ride the
  silo shards); so does a save made from a mid-run callback. The
  directory holds the reference's layout and retention; a resume with
  more silos than the save keeps the new silo's fresh init.
* A directory saved by the JAX ``Experiment`` after 2 rounds (toy, J = 3,
  SFVI-Avg + int8 + DP on the fused wire, and PVI + DP on the flat wire)
  resumes in the port with every state leaf, ``round``, the meter and the
  RDP ledger exactly equal; 2 more rounds then match the JAX run within
  rtol 1e-4 (atol 1e-5), with the reference's draws injected; bytes
  exact, ε within 1e-6.
* A port directory resumes in the JAX ``Experiment.resume`` with every
  leaf, ``round``, the meter and the ledger equal.
"""
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import repro.federated.api as japi
import repro.federated.scheduler as jsched
import repro.federated.strategy as jstrat
import repro_torch.federated.api as tapi
import repro_torch.federated.scheduler as tsched
import repro_torch.federated.strategy as tstrat
from repro_torch.tree import tree_leaves
from test_torch_strategies import assert_state_close, reference_draws

STATE_KEYS = ("theta", "eta_G", "eta_L", "opt_server", "opt_local", "strategy")

PORT_CASES = {
    "sfvi": dict(algorithm="sfvi"),
    "sfvi_avg+int8+dp+partial": dict(algorithm="sfvi_avg", compression="int8",
                                     dp_noise=0.3, dp_clip=0.5, participation=0.67),
    "pvi+int8+dp": dict(algorithm="pvi", compression="int8", dp_noise=0.4, dp_clip=1.0),
}


def _port_spec(case, wire="fused", **over):
    return tapi.ExperimentSpec(
        model=tapi.ModelSpec("toy", {"num_obs": 12}),
        scenario=tsched.Scenario(**PORT_CASES[case]),
        strategy=(tstrat.StrategySpec("pvi", {"damping": 0.3})
                  if case.startswith("pvi") else None),
        num_silos=3, rounds=6, local_steps=2, seed=3,
        server_opt=tapi.OptimizerSpec("adam", 2e-2),
        runtime=tapi.RuntimeSpec(wire=wire), **over)


def _assert_same_state(a, b):
    for k in STATE_KEYS:
        la, lb = tree_leaves(a.server.state[k]), tree_leaves(b.server.state[k])
        assert len(la) == len(lb), k
        for x, y in zip(la, lb, strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("case", list(PORT_CASES))
def test_resume_is_bit_exact(tmp_path, case):
    spec = _port_spec(case)
    full = tapi.build(spec, device="cpu")
    h_full = full.run()
    first = tapi.build(spec, device="cpu")
    h_first = dict(first.run(3))
    first.save(str(tmp_path))
    assert first.round == 3
    exp = tapi.Experiment.resume(str(tmp_path), device="cpu")
    assert exp.round == 3 and exp.remaining_rounds == 3
    assert exp.comm.state_dict() == first.comm.state_dict()
    h_rest = exp.run()
    assert exp.round == 6
    _assert_same_state(full, exp)
    for k, v in h_full.items():
        assert v == h_first[k] + h_rest[k], k
    assert exp.comm.state_dict() == full.comm.state_dict()
    if "epsilon" in h_full:
        assert exp.accountant.state_dict()["steps"] == full.accountant.state_dict()["steps"]
        assert np.array_equal(exp.accountant.rdp, full.accountant.rdp)
    if case.startswith("pvi"):
        assert os.path.exists(tmp_path / "step_00000003.silo_0002.msgpack")
        assert exp.server.strategy.damping == 0.3


def test_mid_run_callback_save_resumes_bit_exactly(tmp_path):
    spec = _port_spec("sfvi_avg+int8+dp+partial", wire="flat", eval_every=2)
    full = tapi.build(spec, device="cpu")

    def cb(r, metrics):
        if r + 1 == 4:
            full.save(str(tmp_path))

    h_full = full.run(callback=cb)
    assert [e["round"] for e in h_full["eval"]] == [2, 4, 6]
    exp = tapi.Experiment.resume(str(tmp_path), device="cpu")
    assert exp.round == 4 and exp.server.wire == "flat"
    h_rest = exp.run()
    _assert_same_state(full, exp)
    assert h_rest["elbo"] == h_full["elbo"][4:]
    assert h_rest["epsilon"] == h_full["epsilon"][4:]
    assert [e["round"] for e in h_rest["eval"]] == [6]


def test_layout_retention_and_more_silos(tmp_path):
    spec = _port_spec("pvi+int8+dp")
    exp = tapi.build(spec, device="cpu")
    for _ in range(4):
        exp.run(1)
        exp.save(str(tmp_path), keep=2)
    names = sorted(os.listdir(tmp_path))
    assert names == ["spec.json"] + sorted(
        f"step_{s:08d}.{part}" for s in (3, 4)
        for part in ("meta.json", "msgpack", "silo_0000.msgpack", "silo_0001.msgpack",
                     "silo_0002.msgpack"))
    meta = json.loads((tmp_path / "step_00000004.meta.json").read_text())
    assert list(meta) == ["round", "comm", "wire", "acct"] and meta["round"] == 4
    assert meta["wire"] == "fused" and len(meta["acct"]["rdp"]) > 10
    # A resume with one silo more: the saved silos restore, silo 3 keeps
    # its fresh init (zero sites).
    wider = dataclasses.replace(spec, num_silos=4)
    grown = tapi.Experiment.resume(str(tmp_path), spec=wider, device="cpu")
    lam = grown.server.state["strategy"]["lam"]
    assert lam["h"].shape == (4, 1)
    assert torch.equal(lam["h"][:3], exp.server.state["strategy"]["lam"]["h"])
    assert torch.equal(lam["h"][3], torch.zeros(1))
    assert grown.round == 4
    with pytest.raises(FileNotFoundError):
        tapi.Experiment.resume(str(tmp_path / "empty"), spec=spec, device="cpu")


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

CROSS = {
    "sfvi_avg+int8+dp fused": ("fused", dict(algorithm="sfvi_avg", compression="int8",
                                             dp_noise=0.3, dp_clip=0.5), None),
    "pvi+dp flat": ("flat", dict(algorithm="pvi", dp_noise=0.4, dp_clip=1.0),
                    {"damping": 0.3}),
}


def _jax_spec(case):
    wire, scenario, strat = CROSS[case]
    return japi.ExperimentSpec(
        model=japi.ModelSpec("toy", {"num_obs": 12}), scenario=jsched.Scenario(**scenario),
        strategy=None if strat is None else jstrat.StrategySpec(scenario["algorithm"], strat),
        num_silos=3, rounds=4, local_steps=2, seed=3,
        server_opt=japi.OptimizerSpec("adam", 2e-2), runtime=japi.RuntimeSpec(wire=wire))


def _assert_equal_to_jax(texp, jexp):
    for k in STATE_KEYS:
        tl = tree_leaves(texp.server.state[k])
        jl = jax.tree_util.tree_leaves(jexp.server.state[k])
        assert len(tl) == len(jl), k
        for a, b in zip(tl, jl, strict=True):
            b = np.asarray(b)
            assert str(a.dtype).replace("torch.", "") == b.dtype.name, k
            assert np.array_equal(a.numpy(), b), k
    assert texp.round == jexp.round
    assert texp.comm.state_dict() == jexp.comm.state_dict()
    tl, jl = texp.accountant.state_dict(), jexp.accountant.state_dict()
    assert tl["steps"] == jl["steps"] and np.array_equal(tl["rdp"], np.asarray(jl["rdp"]))


@pytest.mark.parametrize("case", list(CROSS))
def test_jax_directory_resumes_in_the_port(tmp_path, case):
    jspec = _jax_spec(case)
    jexp = japi.build(jspec)
    jexp.run(2)
    jexp.save(str(tmp_path))
    texp = tapi.Experiment.resume(str(tmp_path), device="cpu")
    assert texp.spec.to_json() == jspec.to_json()
    assert texp.server.wire == CROSS[case][0]
    _assert_equal_to_jax(texp, jexp)
    # Two more rounds on the reference's draws.
    jprob = jexp.server.problem
    draws = reference_draws(jprob, jexp.server.privacy, 3, jexp.server.wire_spec().dim,
                            seed=jspec.seed)
    th = texp.run(draws=draws)
    jh = jexp.run()
    for key in ("bytes_up", "bytes_down", "n_active"):
        assert th[key] == jh[key][2:], key
    np.testing.assert_allclose(th["elbo_trace"], jh["elbo_trace"][4:], rtol=1e-4)
    np.testing.assert_allclose(th["epsilon"], jh["epsilon"][2:], atol=1e-6)
    assert_state_close(texp.server.state, jexp.server.state,
                       ("theta", "eta_G", "eta_L", "strategy"), "after resume")


@pytest.mark.parametrize("case", list(CROSS))
def test_port_directory_resumes_in_jax(tmp_path, case):
    spec = tapi.ExperimentSpec.from_json(_jax_spec(case).to_json())
    texp = tapi.build(spec, device="cpu")
    texp.run(2)
    texp.save(str(tmp_path))
    shutil.copytree(tmp_path, tmp_path / "copy")
    jexp = japi.Experiment.resume(str(tmp_path / "copy"))
    assert jexp.server.wire == CROSS[case][0]
    _assert_equal_to_jax(texp, jexp)
