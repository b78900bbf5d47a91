"""Silo churn in the port (``repro_torch.federated.population``, ``Server.grow_silos``,
``core.amortized``) against the JAX package's.

* The churn stream needs no injection: ``event_draw`` equals the
  reference's over a grid; 12 rounds of ``begin_round`` on live servers give
  equal presence and weights and equal ``PopulationState`` JSON text.
* ``encode``, ``sample_local``, ``log_q_local`` and ``encoder_warm_init`` equal
  the reference's within 1e-6, and ``amortized_warm_start`` given the
  reference's template (toy and hier_bnn) within 1e-6.
* ``grow_silos`` given the reference's new rows equals the reference's grown
  state leaf for leaf (PVI sites included); the cold rows come from
  ``generator((seed + 1, j))`` and every grown tensor is contiguous.
* A sync churn run (toy, J up to 6, SFVI and SFVI-Avg) equals the JAX one
  within rtol 1e-4 given the reference's state, draws and masks; bytes and
  active counts exact.
* Sync and async churn runs resume bit for bit in the port; a churn + async
  directory saved by either package resumes in the other with every state
  leaf, the ``BufferState`` and the ``PopulationState`` equal.
"""
import json

import jax
import numpy as np
import pytest
import torch

import repro.federated.api as japi
import repro.federated.population as jpop
import repro.federated.scheduler as jsched
import repro_torch.federated.api as tapi
import repro_torch.federated.population as tpop
import repro_torch.federated.scheduler as tsched
from repro.core import amortized as jam
from repro.federated.runtime import Server as JServer
from repro.models.paper.registry import get_model as j_get
from repro.optim.adam import adam as j_adam
from repro_torch.convert import from_jax_state
from repro_torch.core import amortized as tam
from repro_torch.device import generator
from repro_torch.federated.runtime import Server as TServer
from repro_torch.models.paper.registry import get_model as t_get
from repro_torch.optim.adam import adam as t_adam
from repro_torch.tree import tree_leaves, tree_map
from test_torch_paper_servers import ReplayScheduler
from test_torch_strategies import reference_draws

STATE_KEYS = ("theta", "eta_G", "eta_L", "opt_server", "opt_local", "strategy")
CHURN = dict(initial=2, arrival_rate=0.6, departure_rate=0.2, return_rate=0.5, seed=3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# The churn stream and the engine's bookkeeping
# ---------------------------------------------------------------------------


def test_event_draws_equal_the_reference():
    for seed in (0, 3, 99):
        for kind in (tpop._ARRIVAL, tpop._DEPART, tpop._RETURN):
            for index in (0, 1, 11, 500):
                for silo in range(4):
                    assert tpop.event_draw(seed, kind, index, silo) == jpop.event_draw(
                        seed, kind, index, silo)
    assert (tpop._POP_SALT, tpop.ACTIVE, tpop.DEPARTED) == (jpop._POP_SALT, jpop.ACTIVE,
                                                            jpop.DEPARTED)


def _toy_pair(J, roster, algo="sfvi"):
    """The reference's toy Server over the first J of ``roster`` silos and the
    port's on its data and state."""
    jb = j_get("toy").build(0, roster, num_obs=12)
    jprob = jb.problem
    jsrv = JServer(jprob, jb.datas[:J], {}, jprob.global_family.init(jax.random.PRNGKey(0)),
                   num_obs=jb.num_obs[:J], server_opt=j_adam(2e-2), local_opt=j_adam(2e-2),
                   seed=0, strategy=algo)
    tb = t_get("toy").build(0, roster, device="cpu", num_obs=12)
    state = from_jax_state(_np(jsrv.state), "cpu")
    tsrv = TServer(tb.problem, tb.datas[:J], {}, state["eta_G"], num_obs=tb.num_obs[:J],
                   server_opt=t_adam(2e-2), local_opt=t_adam(2e-2), seed=0, strategy=algo,
                   device="cpu")
    tsrv.state = state
    return jb, jsrv, tb, tsrv


def test_begin_round_presence_weights_and_state_equal_the_reference():
    spec_kw = dict(CHURN, staleness_decay=0.7)
    jb, jsrv, tb, tsrv = _toy_pair(2, 6)
    jeng = jpop.PopulationEngine(jpop.PopulationSpec(**spec_kw), jb, 6)
    teng = tpop.PopulationEngine(tpop.PopulationSpec(**spec_kw), tb, 6)
    churned = set()
    for r in range(12):
        jp, jw = jeng.begin_round(jsrv, r)
        tp, tw = teng.begin_round(tsrv, r)
        assert np.array_equal(tp, jp) and np.array_equal(tw, jw) and tw.dtype == jw.dtype, r
        assert json.dumps(teng.state.state_dict()) == json.dumps(jeng.state.state_dict()), r
        assert tsrv.J == jsrv.J == teng.state.joined
        churned |= {float(w) for w in tw}
    assert churned - {0.0, 1.0}, "no returning silo was decayed"
    assert tpop.DEPARTED in teng.state.status and teng.state.joined == 6
    back = tpop.PopulationState.from_state(json.loads(json.dumps(teng.state.state_dict())))
    assert back == teng.state
    with pytest.raises(RuntimeError, match="event index 12"):
        teng.begin_round(tsrv, 3)
    with pytest.raises(ValueError, match="exceeds the staged roster"):
        tpop.PopulationEngine(tpop.PopulationSpec(max_silos=7), tb, 6)


# ---------------------------------------------------------------------------
# Amortized pieces and the warm start
# ---------------------------------------------------------------------------


def test_amortized_pieces_equal_the_reference():
    rng = np.random.default_rng(0)
    phi = {"w1": rng.normal(size=(5, 7)), "b1": rng.normal(size=7),
           "w_mu": rng.normal(size=(7, 3)), "b_mu": rng.normal(size=3),
           "w_ls": 0.1 * rng.normal(size=(7, 3)), "b_ls": rng.normal(size=3) - 1.0}
    phi = {k: v.astype(np.float32) for k, v in phi.items()}
    y = rng.normal(size=(11, 5)).astype(np.float32)
    eps = rng.normal(size=(11, 3)).astype(np.float32)
    tphi = tree_map(_t, phi)
    for a, b in zip(tam.encode(tphi, _t(y)), jam.encode(phi, y), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    z = tam.sample_local(tphi, _t(y), _t(eps))
    np.testing.assert_allclose(z.numpy(), np.asarray(jam.sample_local(phi, y, eps)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tam.log_q_local(tphi, _t(y), z)),
                               float(jam.log_q_local(phi, y, z.numpy())), rtol=1e-6)
    warm_t = tam.encoder_warm_init(5, 3, log_sigma=-0.4)
    warm_j = jam.encoder_warm_init(5, 3, log_sigma=-0.4)
    for k in warm_j:
        assert np.array_equal(warm_t[k].numpy(), np.asarray(warm_j[k])), k
    enc = tam.encoder_init(torch.Generator().manual_seed(0), 5, 7, 3)
    assert {k: tuple(v.shape) for k, v in enc.items()} == {
        k: tuple(v.shape) for k, v in jam.encoder_init(jax.random.PRNGKey(0), 5, 7, 3).items()}
    # The STL stop: the gradient reaches phi only through the sample z.
    grads = []
    for stop in (True, False):
        tphi_g = tree_map(lambda x: x.clone().requires_grad_(True), tphi)
        zg = tam.sample_local(tphi_g, _t(y), _t(eps))
        q_phi = tphi_g if stop else tree_map(lambda x: x.detach(), tphi_g)
        tam.log_q_local(q_phi, _t(y), zg, stop_params=stop).backward()
        grads.append({k: v.grad for k, v in tphi_g.items()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


@pytest.mark.parametrize("model,kwargs", [("toy", {"num_obs": 12}),
                                          ("hier_bnn", {"in_dim": 16, "hidden": 4,
                                                        "train_per_silo": 10})])
def test_amortized_warm_start_equals_the_reference(model, kwargs):
    jb = j_get(model).build(0, 3, **kwargs)
    tb = t_get(model).build(0, 3, device="cpu", **kwargs)
    for j in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(1), j)
        want = jpop.amortized_warm_start(jb.problem, jb.datas[j], key)
        template = tree_map(_t, _np(jb.problem.local_family.init(key)))
        data_j = tree_map(_t, _np(jb.datas[j]))
        got = tpop.amortized_warm_start(tb.problem, data_j, template)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    # From a generator: the template is local_family.init(gen).
    gen_row = tpop.amortized_warm_start(tb.problem, tb.datas[0], generator((1, 0), "cpu"))
    cold = tb.problem.local_family.init(generator((1, 0), "cpu"))
    assert sorted(gen_row) == sorted(cold)


# ---------------------------------------------------------------------------
# grow_silos
# ---------------------------------------------------------------------------


def test_grow_silos_given_the_reference_rows_equals_the_reference():
    jb, jsrv, tb, tsrv = _toy_pair(2, 5, algo="pvi")
    jsrv.run(1, local_steps=2)  # sites and moments away from their init
    tsrv.state = from_jax_state(_np(jsrv.state), "cpu")
    jsrv.grow_silos(jb.datas[2:4], num_obs=[12, 12])
    new_rows = [tree_map(_t, _np(jax.tree_util.tree_map(lambda x, j=j: x[j],
                                                         jsrv.state["eta_L"])))
                for j in (2, 3)]
    tsrv.grow_silos(tb.datas[2:4], num_obs=[12, 12], eta_rows=new_rows)
    assert tsrv.J == jsrv.J == 4
    assert np.array_equal(tsrv.num_obs, jsrv.num_obs[:4])
    for k in STATE_KEYS:
        tl, jl = tree_leaves(tsrv.state[k]), jax.tree_util.tree_leaves(jsrv.state[k])
        assert len(tl) == len(jl), k
        for a, b in zip(tl, jl, strict=True):
            assert a.is_contiguous() and np.array_equal(a.numpy(), np.asarray(b)), k
    for a, b in zip(tree_leaves(tsrv.data), jax.tree_util.tree_leaves(jsrv.data),
                    strict=True):
        assert np.array_equal(a.numpy(), np.asarray(b)[:4])
    # Cold rows: a pure function of (seed, roster index).
    tsrv.grow_silos([tb.datas[4]])
    want = tb.problem.local_family.init(generator((1, 4), "cpu"))
    for k, v in want.items():
        assert torch.equal(tsrv.state["eta_L"][k][4], v), k
    assert torch.equal(tsrv.state["strategy"]["lam"]["h"][4],
                       torch.zeros_like(tsrv.state["strategy"]["lam"]["h"][4]))
    with pytest.raises(ValueError, match="eta_rows has 1 entries for 2"):
        tsrv.grow_silos(tb.datas[:2], eta_rows=new_rows[:1])
    assert tsrv.J == 5 and tree_leaves(tsrv.data)[0].shape[0] == 5
    tsrv.run(1, local_steps=2, scheduler=tsched.RoundScheduler(5, seed=0))


# ---------------------------------------------------------------------------
# Churn runs
# ---------------------------------------------------------------------------


def _specs(algo, rounds, async_buf=None, **pop):
    pop = {**CHURN, **pop}
    common = dict(num_silos=6, rounds=rounds, local_steps=2, seed=0)
    jspec = japi.ExperimentSpec(
        model=japi.ModelSpec("toy", {"num_obs": 12}),
        scenario=jsched.Scenario(algorithm=algo, async_cfg=None if async_buf is None
                                 else jsched.AsyncConfig(buffer_size=async_buf)),
        population=jpop.PopulationSpec(**pop), **common)
    tspec = tapi.ExperimentSpec(
        model=tapi.ModelSpec("toy", {"num_obs": 12}),
        scenario=tsched.Scenario(algorithm=algo, async_cfg=None if async_buf is None
                                 else tsched.AsyncConfig(buffer_size=async_buf)),
        population=tpop.PopulationSpec(**pop), **common)
    return jspec, tspec


@pytest.mark.parametrize("algo", ["sfvi", "sfvi_avg"])
def test_sync_churn_run_matches_the_reference(algo):
    jspec, tspec = _specs(algo, 8)
    jexp, texp = japi.build(jspec), tapi.build(tspec, device="cpu")
    assert texp.server.fed_J == jexp.server.fed_J == 6
    assert texp.server.fed_obs == jexp.server.fed_obs == 72.0
    texp.server.state = from_jax_state(_np(jexp.server.state), "cpu")
    texp.scheduler = ReplayScheduler(jexp.scheduler)
    jprob, P = jexp.server.problem, jexp.server.wire_spec().dim

    def draws(r, t):
        return reference_draws(jprob, None, texp.server.J, P, seed=0)(r, t)

    jh, th = jexp.run(), texp.run(draws=draws)
    for key in ("bytes_up", "bytes_down", "n_active"):
        assert th[key] == jh[key], key
    np.testing.assert_allclose(th["elbo_trace"], jh["elbo_trace"], rtol=1e-4)
    assert texp.population.state.state_dict() == jexp.population.state.state_dict()
    assert texp.server.J == jexp.server.J and texp.server.J > 2
    for key in ("eta_G", "eta_L"):
        for a, b in zip(tree_leaves(texp.server.state[key]),
                        jax.tree_util.tree_leaves(jexp.server.state[key]), strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b)[:texp.server.J], rtol=1e-4,
                                       atol=1e-5, err_msg=key)


def _assert_same(a, b):
    for k in STATE_KEYS:
        la, lb = tree_leaves(a.server.state[k]), tree_leaves(b.server.state[k])
        assert len(la) == len(lb), k
        for x, y in zip(la, lb, strict=True):
            assert torch.equal(x, y), k


@pytest.mark.parametrize("async_buf", [None, 2], ids=["sync", "async"])
def test_churn_resume_is_bit_exact(tmp_path, async_buf):
    _, spec = _specs("sfvi_avg", 10, async_buf)
    full = tapi.build(spec, device="cpu")
    h_full = full.run()
    exp = tapi.build(spec, device="cpu")
    exp.run(6, callback=lambda r, m: exp.save(str(tmp_path)) if r + 1 == 4 else None)
    res = tapi.Experiment.resume(str(tmp_path), device="cpu")
    assert res.round == 4 and res.server.J == res.population.state.joined
    h_res = res.run()
    _assert_same(full, res)
    assert h_res["elbo"] == h_full["elbo"][4:]
    assert res.population.state == full.population.state
    assert full.population.state.joined > CHURN["initial"]
    if async_buf:
        assert res.async_state == full.async_state
        meta = json.loads((tmp_path / "step_00000004.meta.json").read_text())
        assert list(meta) == ["round", "comm", "wire", "async_state", "population"]
        assert meta["population"]["round"] == 4
    assert res.comm.state_dict() == full.comm.state_dict()


def _assert_equal_to_jax(texp, jexp):
    for k in STATE_KEYS:
        tl = tree_leaves(texp.server.state[k])
        jl = jax.tree_util.tree_leaves(jexp.server.state[k])
        assert len(tl) == len(jl), k
        for a, b in zip(tl, jl, strict=True):
            assert np.array_equal(a.numpy(), np.asarray(b)), k
    assert texp.round == jexp.round and texp.server.J == jexp.server.J
    assert texp.comm.state_dict() == jexp.comm.state_dict()
    assert json.dumps(texp.async_state.state_dict()) == json.dumps(
        jexp.async_state.state_dict())
    assert json.dumps(texp.population.state.state_dict()) == json.dumps(
        jexp.population.state.state_dict())


def test_jax_churn_async_directory_resumes_in_the_port(tmp_path):
    jspec, _ = _specs("sfvi_avg", 8, async_buf=2)
    jexp = japi.build(jspec)
    jexp.run(4)
    jexp.save(str(tmp_path))
    texp = tapi.Experiment.resume(str(tmp_path), device="cpu")
    assert texp.spec.to_json() == jspec.to_json()
    _assert_equal_to_jax(texp, jexp)
    h = texp.run()
    assert len(h["elbo"]) == 4 and np.all(np.isfinite(h["elbo"]))


def test_port_churn_async_directory_resumes_in_jax(tmp_path):
    _, tspec = _specs("sfvi_avg", 8, async_buf=2)
    texp = tapi.build(tspec, device="cpu")
    texp.run(5)
    texp.save(str(tmp_path))
    jexp = japi.Experiment.resume(str(tmp_path))
    _assert_equal_to_jax(texp, jexp)
