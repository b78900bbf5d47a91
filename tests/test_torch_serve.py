"""Posterior serving in the port (``repro_torch.federated.serve``) against the
JAX package's (``repro.federated.serve``).

* ``Query`` validates as the reference's, with its messages.
* From one JAX checkpoint (hier_bnn in_dim 16, J = 2, and the toy), the
  port's ``sample``, ``global_sample`` and ``predict`` given the reference's
  ε (re-derived from ``Posterior._key`` and ``jax.random.split``) equal the
  reference's answers within 1e-6.
* The same seed gives ``torch.equal`` answers on two replicas; a batch's
  answers are slices of one grouped draw, in request order; a population
  checkpoint serves its live silos mid-roster; the CLI prints the
  reference's JSON layout (``python -m repro_torch.federated.serve``).
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.federated.api as japi
import repro.federated.scheduler as jsched
import repro.federated.serve as jserve
import repro_torch.federated.api as tapi
import repro_torch.federated.population as tpop
import repro_torch.federated.scheduler as tsched
import repro_torch.federated.serve as tserve
from repro.core.family import eps_shape

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIER = {"in_dim": 16, "hidden": 4, "train_per_silo": 16, "test_per_silo": 4}


def test_query_validation_matches_the_reference():
    bad = [dict(kind="flarb"), dict(kind="sample"), dict(kind="sample", silo=0, n=0),
           dict(kind="predict", silo=0)]
    for kw in bad:
        with pytest.raises(ValueError) as te:
            tserve.Query(**kw)
        with pytest.raises(ValueError) as je:
            jserve.Query(**kw)
        assert str(te.value) == str(je.value), kw
    q = tserve.Query.from_dict({"kind": "predict", "silo": 2, "n": 3, "x": [[1.0, 2.0]]})
    assert (q.kind, q.silo, q.n) == ("predict", 2, 3)
    assert q.x.dtype == torch.float32 and q.x.shape == (1, 2)
    assert tserve._SERVE_SALT == jserve._SERVE_SALT


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """JAX checkpoints: hier_bnn (J = 2) and the toy (J = 3), 2 rounds each."""
    out = {}
    for name, model, J in (("hier_bnn", japi.ModelSpec("hier_bnn", HIER), 2),
                           ("toy", japi.ModelSpec("toy", {"num_obs": 16}), 3)):
        d = tmp_path_factory.mktemp(name)
        exp = japi.build(japi.ExperimentSpec(model=model,
                                             scenario=jsched.Scenario(algorithm="sfvi"),
                                             num_silos=J, rounds=2, seed=0))
        exp.run()
        exp.save(str(d))
        out[name] = str(d)
    return out


def _reference_eps(jpost, seed, silo, n):
    """The reference's ε for one query: ``split(_key(seed, silo))``."""
    kG, kL = jax.random.split(jpost._key(seed, silo))
    prob = jpost.problem
    eps_G = np.asarray(jax.random.normal(kG, (n,) + eps_shape(prob.global_family)))
    eps_L = (np.asarray(jax.random.normal(kL, (n,) + eps_shape(prob.local_family)))
             if prob.model.has_local else None)
    return torch.as_tensor(eps_G), None if eps_L is None else torch.as_tensor(eps_L)


def _close(a, b):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["hier_bnn", "toy"])
def test_draws_equal_the_reference_given_its_eps(jax_ckpts, name):
    jpost = jserve.Posterior.from_checkpoint(jax_ckpts[name])
    tpost = tserve.Posterior.from_checkpoint(jax_ckpts[name], device="cpu")
    assert (tpost.num_silos, tpost.round) == (jpost.num_silos, jpost.round)
    for silo in range(tpost.num_silos):
        for seed, n in ((0, 3), (5, 1)):
            want = jpost.sample(silo, n=n, seed=seed)
            got = tpost.sample(silo, n=n, seed=seed, eps=_reference_eps(jpost, seed, silo, n))
            _close(got["z_G"], want["z_G"])
            _close(got["z_L"], want["z_L"])
    eps_G, _ = _reference_eps(jpost, 4, -1, 6)
    _close(tpost.global_sample(6, seed=4, eps=(eps_G, None)), jpost.global_sample(6, seed=4))
    if name == "hier_bnn":
        x = np.random.default_rng(0).normal(size=(5, 16)).astype(np.float32)
        want = jpost.predict(1, x, n=4, seed=2)
        got = tpost.predict(1, x, n=4, seed=2, eps=_reference_eps(jpost, 2, 1, 4))
        assert got.shape == (5, 10)
        _close(got, want)
    else:
        with pytest.raises(ValueError, match="predict hook"):
            tpost.predict(0, np.zeros((2, 1), np.float32))


def _toy_exp(tmp_path, **over):
    base = dict(model=tapi.ModelSpec("toy", {"num_obs": 16}),
                scenario=tsched.Scenario(algorithm="sfvi"), num_silos=3, rounds=2, seed=0)
    base.update(over)
    exp = tapi.build(tapi.ExperimentSpec(**base), device="cpu")
    exp.run()
    exp.save(str(tmp_path))
    return exp


def test_replicas_agree_and_batches_are_slices_of_one_draw(tmp_path):
    _toy_exp(tmp_path)
    post = tserve.Posterior.from_checkpoint(str(tmp_path), device="cpu")
    replica = tserve.Posterior.from_checkpoint(str(tmp_path), device="cpu")
    a, b = post.sample(1, n=4, seed=9), replica.sample(1, n=4, seed=9)
    assert a["z_G"].shape == (4, 1) and a["z_L"].shape == (4, 1)
    assert torch.equal(a["z_G"], b["z_G"]) and torch.equal(a["z_L"], b["z_L"])
    assert not torch.equal(a["z_G"], post.sample(1, n=4, seed=10)["z_G"])
    qs = [tserve.Query("sample", silo=1, n=2), tserve.Query("global_sample", n=2),
          tserve.Query("sample", silo=1, n=1), tserve.Query("sample", silo=0, n=1),
          tserve.Query("global_sample", n=3)]
    ans = post.answer_batch(qs, seed=0)
    grouped = post.sample(1, n=3, seed=0)
    for k in ("z_G", "z_L"):
        assert torch.equal(ans[0][k], grouped[k][:2]) and torch.equal(ans[2][k], grouped[k][2:])
    g = post.global_sample(5, seed=0)
    assert torch.equal(ans[1]["z_G"], g[:2]) and torch.equal(ans[4]["z_G"], g[2:])
    assert ans[1]["z_L"] is None and ans[3]["z_G"].shape == (1, 1)
    again = replica.answer_batch(qs, seed=0)
    assert all(torch.equal(x["z_G"], y["z_G"]) for x, y in zip(ans, again, strict=True))
    with pytest.raises(IndexError, match="serves 3 silos"):
        post.eta_row(3)


def test_serves_a_population_checkpoint_mid_roster(tmp_path):
    exp = _toy_exp(tmp_path, num_silos=6, rounds=4, population=tpop.PopulationSpec(
        initial=2, arrival_rate=0.6, departure_rate=0.2, return_rate=0.5, seed=3))
    post = tserve.Posterior.from_checkpoint(str(tmp_path), device="cpu")
    assert post.num_silos == exp.population.state.joined == exp.server.J < 6
    last = post.num_silos - 1
    assert torch.equal(post.eta_row(last)["mu_bar"], exp.server.state["eta_L"]["mu_bar"][last])
    assert post.sample(last, n=2)["z_L"].shape == (2, 1)
    with pytest.raises(IndexError):
        post.sample(post.num_silos)


def test_cli_answers_batched_queries(tmp_path):
    _toy_exp(tmp_path)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    queries = json.dumps([{"kind": "sample", "silo": 0, "n": 2},
                          {"kind": "global_sample", "n": 1}])
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.federated.serve", "--device", "cpu",
         "--ckpt-dir", str(tmp_path), "--queries", queries],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    payload = json.loads(out.stdout)
    assert list(payload) == ["round", "num_silos", "answers"]
    assert payload["num_silos"] == 3 and payload["round"] == 2
    post = tserve.Posterior.from_checkpoint(str(tmp_path), device="cpu")
    want = post.answer_batch([tserve.Query.from_dict(q) for q in json.loads(queries)])
    assert payload["answers"][0]["z_G"] == want[0]["z_G"].tolist()
    assert payload["answers"][0]["z_L"] == want[0]["z_L"].tolist()
    assert payload["answers"][1] == {"z_G": want[1]["z_G"].tolist(), "z_L": None}
    for argv, key in ((["--silo", "1", "--n", "2"], "answer"), (["--global-sample", "2"], "z_G")):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.federated.serve", "--device", "cpu",
             "--ckpt-dir", str(tmp_path), *argv],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        assert list(json.loads(out.stdout)) == ["round", "num_silos", key]
