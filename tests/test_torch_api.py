"""The port's experiment spec against the JAX package's (``repro.federated.api``).

* ``ExperimentSpec.to_json()`` is string-equal to the reference's for the
  defaults, every ``Scenario`` knob, a ``StrategySpec`` with kwargs, both
  ``FamilySpec`` slots, ``MeshSpec.parse("silo=1")``, a ``PopulationSpec``
  and an ``AsyncConfig``; each side's JSON loads in the other to an equal
  spec; the file round trip.
* The reference CLI's ``--dump-spec`` output loads in the port unchanged,
  and the port's ``--spec`` runs it.
* Validation errors as the reference's (``tests/test_api.py`` and
  ``tests/test_strategies.py``): the same exception type and message.
* What ``build`` refuses, each with the ROADMAP item that brings it.
* ``Scenario`` pieces, ``scenario_matrix`` and the labels against the
  reference.
"""
import dataclasses
import json

import pytest

import repro.federated.api as japi
import repro.federated.population as jpop
import repro.federated.scheduler as jsched
import repro.federated.strategy as jstrat
import repro.launch.mesh as jmesh
from repro.core.family import FamilySpec as JFamilySpec
from repro.federated import run as jcli
import repro_torch.federated.api as tapi
import repro_torch.federated.population as tpop
import repro_torch.federated.scheduler as tsched
import repro_torch.federated.strategy as tstrat
import repro_torch.launch.mesh as tmesh
from repro_torch.core.family import FamilySpec as TFamilySpec
from repro_torch.federated import run as tcli


@dataclasses.dataclass(frozen=True)
class NS:
    """One package's spec classes, so one recipe builds both specs."""

    api: object
    sched: object
    strat: object
    mesh: object
    pop: object
    family: type


JAX = NS(japi, jsched, jstrat, jmesh, jpop, JFamilySpec)
PORT = NS(tapi, tsched, tstrat, tmesh, tpop, TFamilySpec)


def _spec(ns: NS, case: str):
    api = ns.api
    model = api.ModelSpec("toy")
    if case == "defaults":
        return api.ExperimentSpec(model=model)
    if case == "scenario":
        return api.ExperimentSpec(
            model=api.ModelSpec("toy", {"num_obs": 8}),
            scenario=ns.sched.Scenario(
                algorithm="sfvi", participation=0.75, dropout=0.1, compression="int8",
                dp_noise=0.6, dp_clip=0.8, dp_delta=1e-6, dp_clip_only=True,
                aggregator="trimmed", trim_frac=0.2),
            num_silos=5, rounds=6, local_steps=2,
            server_opt=api.OptimizerSpec("adam", 3e-2, {"b1": 0.85}),
            local_opt=api.OptimizerSpec("sgd", 1e-2), eta_mode="param", eval_every=2,
            seed=5, data_seed=2)
    if case == "strategy":
        return api.ExperimentSpec(
            model=model, scenario=ns.sched.Scenario(algorithm="pvi"),
            strategy=ns.strat.StrategySpec("pvi", {"damping": 0.3, "prec_floor": 1e-5}))
    if case == "families":
        return api.ExperimentSpec(model=api.ModelSpec(
            "toy", {"num_obs": 8}, global_family=ns.family("lowrank", {"rank": 1}),
            local_family=ns.family("conditional", {"use_coupling": False})))
    if case == "mesh":
        return api.ExperimentSpec(model=model, runtime=api.RuntimeSpec(
            wire="fused", mesh=ns.mesh.MeshSpec.parse("silo=1"), sanitize=True))
    if case == "population":
        return api.ExperimentSpec(model=model, population=ns.pop.PopulationSpec(
            initial=3, arrival_rate=0.3, departure_rate=0.1, return_rate=0.5,
            max_silos=6, warm_start=False, staleness_decay=0.25, seed=4))
    if case == "async":
        return api.ExperimentSpec(model=model, scenario=ns.sched.Scenario(
            algorithm="fed_ep", compression="int8", async_cfg=ns.sched.AsyncConfig(
                buffer_size=3, staleness_decay=0.0, latency="straggler",
                latency_scale=2.0, latency_sigma=0.25, straggler_frac=0.2,
                straggler_slowdown=5.0)))
    raise KeyError(case)


CASES = ["defaults", "scenario", "strategy", "families", "mesh", "population", "async"]


@pytest.mark.parametrize("case", CASES)
def test_spec_json_equals_the_reference(case, tmp_path):
    t, j = _spec(PORT, case), _spec(JAX, case)
    assert t.to_json() == j.to_json()
    assert t.to_json(indent=0) == j.to_json(indent=0)
    assert t.to_dict() == j.to_dict()
    assert tapi.ExperimentSpec.from_json(j.to_json()) == t
    assert japi.ExperimentSpec.from_json(t.to_json()) == j
    assert t.name == j.name and t.algorithm == j.algorithm
    t.save(str(tmp_path / "spec.json"))
    j.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "spec.json").read_text() == (tmp_path / "ref.json").read_text()
    assert tapi.ExperimentSpec.load(str(tmp_path / "ref.json")) == t


def test_json_without_runtime_means_the_flat_wire():
    d = json.loads(_spec(JAX, "defaults").to_json())
    del d["runtime"]
    assert tapi.ExperimentSpec.from_dict(d).runtime == tapi.RuntimeSpec(wire="flat")


def test_reference_cli_dump_spec_runs_in_the_port(tmp_path, capsys):
    argv = ["--model", "toy", "--algo", "pvi", "--strategy-kwargs", '{"damping": 0.2}',
            "--silos", "3", "--rounds", "2", "--local-steps", "2", "--compress", "int8",
            "--dp-noise", "0.5", "--eval-every", "1"]
    assert jcli.main([*argv, "--dump-spec"]) == 0
    text = capsys.readouterr().out
    spec = tapi.ExperimentSpec.from_json(text)
    assert spec.to_json() + "\n" == text
    assert tcli.main(["--device", "cpu", *argv, "--wire", "flat", "--dump-spec"]) == 0
    assert capsys.readouterr().out == text
    path = tmp_path / "exp.json"
    path.write_text(text)
    assert tcli.main(["--device", "cpu", "--spec", str(path)]) == 0
    out = capsys.readouterr().out
    assert "== PVI: toy, J=3, 2 rounds x 2 local steps, wire=flat" in out
    assert out.count("abs_error_vs_exact") == 1 and "-DP after 2 exchanges" in out


# ---------------------------------------------------------------------------
# Validation errors, as the reference's
# ---------------------------------------------------------------------------


def _errors():
    yield "unknown_optimizer", lambda ns: ns.api.OptimizerSpec("lbfgs").build()
    yield "strategy_kwargs", lambda ns: ns.strat.StrategySpec("pvi", {"bogus": 1}).build()
    yield "stateless_kwargs", lambda ns: ns.strat.StrategySpec("sfvi", {"damping": 0.1}).build()
    yield "async_step_cadence", lambda ns: ns.sched.Scenario.from_dict(
        {"algorithm": "sfvi", "async_cfg": {"buffer_size": 2}})
    yield "unknown_algorithm", lambda ns: ns.sched.Scenario.from_dict(
        {"algorithm": "sfvi_average"})
    yield "async_partial", lambda ns: ns.sched.Scenario(
        participation=0.5, async_cfg=ns.sched.AsyncConfig()).validate()
    yield "async_buffer", lambda ns: ns.sched.Scenario(
        async_cfg=ns.sched.AsyncConfig(buffer_size=5)).validate(4)
    yield "async_latency", lambda ns: ns.sched.Scenario(
        async_cfg=ns.sched.AsyncConfig(latency="pareto")).validate()
    yield "unknown_wire", lambda ns: ns.api.RuntimeSpec(wire="ring")
    yield "mesh_model", lambda ns: ns.mesh.MeshSpec(model=0)
    yield "mesh_axis", lambda ns: ns.mesh.MeshSpec.parse("silo=2,data=2")
    yield "population_initial", lambda ns: ns.pop.PopulationSpec(initial=0)
    yield "population_rate", lambda ns: ns.pop.PopulationSpec(arrival_rate=1.5)
    yield "population_max", lambda ns: ns.pop.PopulationSpec(initial=3, max_silos=2)
    yield "strategy_mismatch", lambda ns: ns.api.build(ns.api.ExperimentSpec(
        model=ns.api.ModelSpec("toy"), scenario=ns.sched.Scenario(algorithm="sfvi_avg"),
        strategy=ns.strat.StrategySpec("pvi", {"damping": 0.3})))
    yield "compression", lambda ns: ns.sched.Scenario(compression="fp4").compressor()
    yield "aggregator", lambda ns: ns.sched.Scenario(aggregator="median").make_aggregator()


@pytest.mark.parametrize("name,fn", list(_errors()), ids=[n for n, _ in _errors()])
def test_validation_errors_match_the_reference(name, fn):
    with pytest.raises(Exception) as jerr:
        fn(JAX)
    with pytest.raises(Exception) as terr:
        fn(PORT)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# What build refuses
# ---------------------------------------------------------------------------

REFUSED = {
    "legacy_wire": (dict(runtime=tapi.RuntimeSpec(wire="legacy")), ValueError, "item 6"),
    # The reference's one-process mesh over several devices: a torch process
    # drives one card, so the refusal names the process flags.
    "mesh_silo": (dict(runtime=tapi.RuntimeSpec(mesh=tmesh.MeshSpec(silo=2))),
                  ValueError, "--num-processes"),
    "mesh_model": (dict(runtime=tapi.RuntimeSpec(mesh=tmesh.MeshSpec(model=2))),
                   ValueError, "--num-processes"),
    # A mesh of more than one rank without a torch.distributed world.
    "multiprocess": (dict(runtime=tapi.RuntimeSpec(
        mesh=tmesh.MeshSpec.parse("silo=2,multiprocess"))), ValueError, "--num-processes"),
    "sanitize": (dict(runtime=tapi.RuntimeSpec(sanitize=True)), NotImplementedError, "item 6"),
    # Async and populations run since ROADMAP Queue 1 item 4; what build
    # still refuses of them is what the reference refuses too.
    "async": (dict(scenario=tsched.Scenario(async_cfg=tsched.AsyncConfig(buffer_size=4))),
              ValueError, "buffer_size"),
    "population": (dict(population=tpop.PopulationSpec(max_silos=4)), ValueError,
                   "exceeds the staged roster"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_build_refuses_what_the_port_lacks(case):
    over, exc, item = REFUSED[case]
    spec = tapi.ExperimentSpec(model=tapi.ModelSpec("toy"), num_silos=3, **over)
    match = f"ROADMAP Queue 1 {item}" if item.startswith("item") else item
    with pytest.raises(exc, match=match):
        tapi.build(spec, device="cpu")


def test_single_device_meshes_build():
    for mesh in (tmesh.MeshSpec(), tmesh.MeshSpec.parse("silo=1"),
                 tmesh.MeshSpec.parse("silo=1,model=1"), tmesh.MeshSpec.parse("multiprocess")):
        spec = tapi.ExperimentSpec(model=tapi.ModelSpec("toy"), num_silos=2,
                                   runtime=tapi.RuntimeSpec(mesh=mesh))
        exp = tapi.build(spec, device="cpu")
        assert exp.server.wire == "flat" and exp.server.J == 2


@pytest.mark.parametrize("flags", [["--devices", "2"], ["--coordinator", "localhost:1"],
                                   ["--async", "--buffer-size", "3"],
                                   ["--population", '{"initial": 3}'],
                                   ["--mesh", "silo=2"], ["--sanitize"]])
def test_cli_refuses_the_multi_device_async_and_population_flags(flags):
    """--devices and a multi-rank --mesh without a world name the process
    flags (a torch process drives one card), --coordinator alone asks for
    --num-processes, --sanitize names its ROADMAP item; --async and
    --population run (Queue 1 item 4), and the CLI refuses, as the
    reference does, a buffer or an initial population wider than --silos."""
    argv = ["--device", "cpu", "--model", "toy", "--silos", "2", "--rounds", "1",
            "--algo", "sfvi_avg", *flags]
    exc, match = {
        "--devices": (ValueError, "--num-processes 2 --process-id"),
        "--coordinator": (ValueError, "--num-processes"),
        "--async": (ValueError, "buffer_size"),
        "--population": (ValueError, "initial"),
        "--mesh": (ValueError, "--num-processes"),
        "--sanitize": (NotImplementedError, "ROADMAP Queue 1 item 6"),
    }[flags[0]]
    with pytest.raises(exc, match=match):
        tcli.main(argv)


# ---------------------------------------------------------------------------
# Scenario pieces against the reference
# ---------------------------------------------------------------------------


def test_scenario_labels_pieces_and_matrix_match_the_reference():
    kw = dict(algorithms=("sfvi", "sfvi_avg", "pvi", "fed_ep"), participation=(1.0, 0.5),
              dropout=(0.0, 0.2), compression=("none", "int8"), dp_noise=(0.0, 1.0),
              dp_clip=0.5, dp_delta=1e-6)
    tgrid = tsched.scenario_matrix(**kw, async_cfgs=(None, tsched.AsyncConfig()))
    jgrid = jsched.scenario_matrix(**kw, async_cfgs=(None, jsched.AsyncConfig()))
    assert [dataclasses.asdict(s) for s in tgrid] == [dataclasses.asdict(s) for s in jgrid]
    assert [s.name for s in tgrid] == [s.name for s in jgrid]
    for t, j in zip(tgrid, jgrid, strict=True):
        assert type(t.compressor()).__name__ == type(j.compressor()).__name__
        assert type(t.make_aggregator()).__name__ == type(j.make_aggregator()).__name__
        tp, jp = t.privacy(), j.privacy()
        assert (tp is None) == (jp is None)
        if tp is not None:
            assert (tp.clip_norm, tp.noise_multiplier, tp.delta) == (
                jp.clip_norm, jp.noise_multiplier, jp.delta)
        ts, js = t.scheduler(4, seed=3), j.scheduler(4, seed=3)
        assert (ts.participation, ts.dropout, ts.seed) == (js.participation, js.dropout,
                                                            js.seed)
    base = _spec(PORT, "defaults")
    specs = tapi.scenario_specs(base, tgrid[:3])
    assert [s.scenario for s in specs] == tgrid[:3] and specs[0].model == base.model


def test_optimizer_specs_build_the_port_optimizers():
    import torch

    from repro_torch.optim.adam import AdamWState

    params = {"a": torch.ones(3)}
    for name, kwargs in (("adam", {"b1": 0.8}), ("adamw", {"weight_decay": 0.1}),
                         ("sgd", {})):
        opt = tapi.OptimizerSpec(name, 0.1, kwargs).build()
        state = opt.init(params)
        upd, _ = opt.update({"a": torch.ones(3)}, state, params)
        assert upd["a"].shape == (3,) and float(upd["a"][0]) < 0
    assert isinstance(tapi.OptimizerSpec("adamw").build().init(params), AdamWState)
