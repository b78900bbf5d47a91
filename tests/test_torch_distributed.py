"""Multi-process federation in the port: CPU gloo worlds spawned from the test.

Mirrors ``tests/test_multiprocess.py`` (the reference's two-process
``jax.distributed`` test) on ``torch.distributed``. Two worlds are
spawned, one process a rank:

  * 2 ranks, ``MeshSpec(silo=2, multiprocess=True)``:
      - toy J = 8, K = 2, SFVI: the metered bytes equal the bytes the
        ranks gathered; an owner-routed save -> resume -> one more round is
        bit-exact; both ranks' replicated state is bit-identical, and the
        silo rows split 0-3 / 4-7; the full state equals the one-process
        port run bit for bit (only the reported ELBO may differ, by the
        order its two partial sums are added);
      - toy J = 7 pads to J_pad = 8 and equals the one-process J = 7 run;
      - churn J 3 -> 5 grows J_pad 4, 4, 6, 6 (``tests/test_population.py``'s
        walk) and equals the one-process churn run;
      - buffered-async SFVI-Avg, PVI (sites on the silo rows) and a small
        hier_bnn, whose eval hook reads every silo's η_L, equal the
        one-process runs bit for bit, the eval too;
      - the benchmark smoke config's SFVI at 504,576 B a round;
      - the GLMM at J = 2 (one silo row a rank) within rtol 1e-6: a
        batched matrix-vector product of batch 1 rounds otherwise than
        of batch 2 on the CPU;
      - a directory the JAX ``Experiment`` saved resumes on the 2 ranks,
        which run 2 rounds on the reference's injected draws and save; the
        reference's ``Experiment.resume`` reads that directory, and its
        state is within the parity tolerance (rtol 1e-4) of the reference
        run continued on one device;
  * 4 ranks, ``MeshSpec(silo=2, model=2, multiprocess=True)``: the smoke
    config's SFVI equals the ``silo=2`` world bit for bit, ELBO included.

Unit tests beside them hold ``build_mesh``'s validation, ``owned_rows``
and the J_pad arithmetic against the reference's functions.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.federated.api as japi
import repro.federated.scheduler as jsched
import repro_torch.federated.api as tapi
import repro_torch.federated.scheduler as tsched
from repro_torch.core.family import FamilySpec
from repro_torch.federated import distributed
from repro_torch.federated.population import PopulationSpec
from repro_torch.launch.mesh import (
    Mesh,
    MeshSpec,
    build_mesh,
    data_world,
    mesh_process_count,
    model_world,
)
from repro_torch.tree import tree_leaves
from test_torch_strategies import assert_state_close, reference_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_BYTES = 504_576
JAX_J, JAX_K, JAX_SEED = 8, 2, 3

_WORKER = textwrap.dedent("""
    import hashlib, json, os, sys
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from repro_torch.federated import distributed
    distributed.initialize(device="cpu")  # REPRO_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID
    import torch.distributed as dist
    from repro_torch.federated import api
    from repro_torch.tree import tree_leaves

    task = json.loads(sys.argv[1])
    rank = dist.get_rank()
    runtime = {"wire": "fused", "mesh": task["mesh"], "sanitize": False}

    def spec_of(text):
        return api.ExperimentSpec.from_dict({**json.loads(text), "runtime": runtime})

    def dig(leaves):
        h = hashlib.sha256()
        for x in leaves:
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def digests(exp):
        srv = exp.server
        st = srv.state
        silo = tree_leaves([st[k] for k in ("eta_L", "opt_local", "strategy")])
        return {"global": dig(tree_leaves([st["theta"], st["eta_G"], st["opt_server"]])),
                "rows": {j: dig([x[i] for x in silo])
                         for i, j in enumerate(srv.rows) if j < srv.J},
                "elbo": list(exp.history["elbo"])}

    out = {"rank": rank}
    for name, text in task["specs"].items():
        exp = api.build(spec_of(text), device="cpu")
        srv = exp.server
        if name == "toy":
            h = exp.run(2)
            out["toy_meter"] = [list(h["bytes_up"]), srv.comm.bytes_gathered,
                                srv.bytes_up_per_silo(), srv.J_pad, srv.rows]
            exp.save(task["ckpt"])
            res = api.Experiment.resume(task["ckpt"], device="cpu")
            exp.run(1)
            res.run(1)
            a, b = digests(exp), digests(res)
            out["toy_resume"] = [res.round, (a["global"], a["rows"], a["elbo"][-1])
                                 == (b["global"], b["rows"], b["elbo"][-1])]
        elif name == "grow":
            pads = []
            exp.run(callback=lambda r, m: pads.append(srv.J_pad))
            out["grow_pads"] = [pads, srv.J]
        else:
            h = exp.run()
        out[name] = {**digests(exp), "J_pad": srv.J_pad, "rows_held": srv.rows,
                     "eval": exp.evaluate(),
                     "per_round": [u + d for u, d in zip(exp.history["bytes_up"],
                                                         exp.history["bytes_down"])],
                     "shape": srv.mesh.shape}
        if name == "glmm":
            st = srv.state
            torch.save({k: tree_leaves(st[k]) for k in ("theta", "eta_G", "eta_L", "opt_local")},
                       os.path.join(task["dumps"], f"glmm_rank{rank}.pt"))
    if "jax_in" in task:
        arr = np.load(task["draws"])

        def draws(r, t):
            return tuple(torch.as_tensor(arr[f"{k}_{r}_{t}"]) for k in ("eps_G", "eps_L", "noise"))

        with open(os.path.join(task["jax_in"], "spec.json")) as f:
            spec = spec_of(f.read())
        exp = api.Experiment.resume(task["jax_in"], spec=spec, device="cpu")
        h = exp.run(2, draws=draws)
        exp.save(task["jax_out"])
        out["jax"] = {"elbo_trace": h["elbo_trace"], "bytes_up": h["bytes_up"],
                      "epsilon": h["epsilon"]}
    print("RESULT " + json.dumps(out), flush=True)
    distributed.shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_world(n: int, task: dict, timeout: float = 240.0) -> list:
    """``n`` ranks of a gloo world running ``task``; each rank's RESULT."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_COORDINATOR=f"localhost:{port}", REPRO_NUM_PROCESSES=str(n),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, json.dumps(task)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(env, REPRO_PROCESS_ID=str(r)), cwd=REPO)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            p.kill()
    results = []
    for rc, out, err in outs:
        assert rc == 0, out[-2000:] + err[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
        results.append(json.loads(line[len("RESULT "):]))
    return sorted(results, key=lambda d: d["rank"])


# ---------------------------------------------------------------------------
# The runs: on 2 and 4 ranks, on the one-rank mesh, and the JAX reference
# ---------------------------------------------------------------------------


def _spec(model, kwargs, J, rounds, K, algo="sfvi", global_family=None, **over):
    return tapi.ExperimentSpec(
        model=tapi.ModelSpec(model, kwargs, global_family=global_family),
        scenario=over.pop("scenario", tsched.Scenario(algorithm=algo)),
        num_silos=J, rounds=rounds, local_steps=K, seed=0,
        server_opt=tapi.OptimizerSpec("adam", 2e-2), runtime=tapi.RuntimeSpec(wire="fused"),
        **over)


TOY = {"num_obs": 8}
SPECS = {
    # toy J = 8, K = 2: meter, owner-routed save -> resume, rows 0-3 / 4-7
    "toy": _spec("toy", TOY, 8, 3, 2),
    # J = 7 pads to 8
    "pad7": _spec("toy", TOY, 7, 3, 2, algo="sfvi_avg"),
    # churn J 3 -> 5 (tests/test_population.py's walk): J_pad 4, 4, 6, 6
    "grow": _spec("toy", TOY, 5, 4, 1, population=PopulationSpec(
        initial=2, arrival_rate=1.0, seed=0)),
    # buffered-async SFVI-Avg (B = 3 of 8, straggler latencies)
    "async": _spec("toy", TOY, 8, 4, 2, scenario=tsched.Scenario(
        algorithm="sfvi_avg", async_cfg=tsched.AsyncConfig(buffer_size=3,
                                                           latency="straggler"))),
    # PVI: its sites ride the silo rows
    "pvi": _spec("toy", TOY, 8, 3, 2, algo="pvi"),
    # the benchmark smoke config's SFVI (benchmarks/baseline.json's mesh rows)
    "smoke": _spec("multinomial", {"n_per": 60, "in_dim": 196}, 4, 25, 4),
    # hier_bnn at a small width: its eval hook reads every silo's η_L
    "hier": _spec("hier_bnn", {"in_dim": 16, "hidden": 4, "train_per_silo": 16,
                               "test_per_silo": 8}, 4, 2, 2),
    # GLMM + Cholesky SFVI-Avg at J = 2: one silo row a rank
    "glmm": _spec("glmm", {"num_children": 48}, 2, 2, 5, algo="sfvi_avg",
                  global_family=FamilySpec("cholesky")),
}
BIT_EXACT = ["toy", "pad7", "grow", "async", "pvi", "smoke", "hier"]


def _dig(leaves):
    import hashlib

    h = hashlib.sha256()
    for x in leaves:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _digests(exp):
    st = exp.server.state
    silo = tree_leaves([st[k] for k in ("eta_L", "opt_local", "strategy")])
    return {"global": _dig(tree_leaves([st["theta"], st["eta_G"], st["opt_server"]])),
            "rows": {str(j): _dig([x[j] for x in silo]) for j in range(exp.server.J)},
            "elbo": list(exp.history["elbo"]), "state": st}


def _one_process():
    """Every run on the one-rank mesh (one thread, as the ranks)."""
    out = {}
    for name, spec in SPECS.items():
        exp = tapi.build(spec, device="cpu")
        exp.run()
        out[name] = {**_digests(exp), "eval": exp.evaluate()}
    return out


def _jax_spec():
    return japi.ExperimentSpec(
        model=japi.ModelSpec("toy", {"num_obs": 12}),
        scenario=jsched.Scenario(algorithm="sfvi_avg", compression="int8", dp_noise=0.3,
                                 dp_clip=0.5),
        num_silos=JAX_J, rounds=3, local_steps=JAX_K, seed=JAX_SEED,
        server_opt=japi.OptimizerSpec("adam", 2e-2), runtime=japi.RuntimeSpec(wire="fused"))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("worlds")
    # The reference: 1 round on one device, saved for the ranks to resume.
    jexp = japi.build(_jax_spec())
    jexp.run(1)
    jexp.save(str(tmp / "jax_in"))
    jsrv = jexp.server
    draw = reference_draws(jsrv.problem, jsrv.privacy, JAX_J, jsrv.wire_spec().dim,
                           seed=JAX_SEED)
    arrays = {}
    for r in (1, 2):
        for t in range(JAX_K):
            for k, v in zip(("eps_G", "eps_L", "noise"), draw(r, t), strict=True):
                arrays[f"{k}_{r}_{t}"] = v.numpy()
    np.savez(tmp / "draws.npz", **arrays)
    jh = jexp.run(2)
    two = _spawn_world(2, {
        "mesh": MeshSpec(silo=2, multiprocess=True).to_dict(),
        "specs": {k: v.to_json() for k, v in SPECS.items()}, "ckpt": str(tmp / "ckpt"),
        "dumps": str(tmp), "draws": str(tmp / "draws.npz"), "jax_in": str(tmp / "jax_in"),
        "jax_out": str(tmp / "jax_out")})
    four = _spawn_world(4, {"mesh": MeshSpec(silo=2, model=2, multiprocess=True).to_dict(),
                            "specs": {"smoke": SPECS["smoke"].to_json()}})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = _one_process()
    finally:
        torch.set_num_threads(threads)
    return {"two": two, "four": four, "one": one, "jexp": jexp, "jh": jh,
            "jax_out": str(tmp / "jax_out"), "dumps": tmp}


def _whole(ranks, key):
    """The ranks' row digests of run ``key``, joined; every row once."""
    rows = {}
    for res in ranks:
        for j, d in res[key]["rows"].items():
            assert j not in rows
            rows[j] = d
    return rows


def test_metered_bytes_equal_the_gathered_bytes(worlds):
    for res in worlds["two"]:
        bytes_up, gathered, per_silo, j_pad, rows = res["toy_meter"]
        assert j_pad == 8
        assert bytes_up == [2 * 8 * per_silo] * 2
        assert gathered == sum(bytes_up)
    assert [res["toy_meter"][4] for res in worlds["two"]] == [[0, 1, 2, 3], [4, 5, 6, 7]]


def test_ranks_are_bit_identical_and_own_their_rows(worlds):
    r0, r1 = worlds["two"]
    for key in SPECS:
        assert r0[key]["global"] == r1[key]["global"], key
        assert r0[key]["elbo"] == r1[key]["elbo"], key
    assert sorted(r0["toy"]["rows"]) == ["0", "1", "2", "3"]
    assert sorted(r1["toy"]["rows"]) == ["4", "5", "6", "7"]


def test_owner_routed_save_resume_is_bit_exact(worlds):
    for res in worlds["two"]:
        assert res["toy_resume"] == [3, True]


@pytest.mark.parametrize("key", BIT_EXACT)
def test_two_ranks_equal_one_process(worlds, key):
    one, two = worlds["one"][key], worlds["two"]
    assert two[0][key]["global"] == one["global"]
    assert _whole(two, key) == one["rows"]
    # Only the reported ELBO may differ: its partial sums add in rank order.
    np.testing.assert_allclose(two[0][key]["elbo"], one["elbo"], rtol=1e-6)
    # The eval hook sees every silo's η_L, gathered from both ranks.
    assert two[0][key]["eval"] == two[1][key]["eval"] == one["eval"]


def test_one_row_a_rank_is_within_rtol_1e_6(worlds):
    """With one silo row a rank the vmapped batch is 1, and a batched
    matrix-vector product (``vmap`` of ``A @ x``: ``torch.bmm``) of batch 1
    rounds otherwise than the same rows of a batch of 2 on the CPU (the
    probe: (64, 64) @ (64,), and glmm's (n, 5) @ (5,) design products). The
    GLMM + Cholesky SFVI-Avg at J = 2 on 2 ranks is held to the one-process
    run within rtol 1e-6 (atol 1e-6); everything else here is bit for bit."""
    one = worlds["one"]["glmm"]
    dumps = [torch.load(worlds["dumps"] / f"glmm_rank{r}.pt") for r in (0, 1)]
    assert [res["glmm"]["rows_held"] for res in worlds["two"]] == [[0], [1]]
    for key in ("theta", "eta_G"):
        for a, a1, b in zip(dumps[0][key], dumps[1][key], tree_leaves(one["state"][key]),
                            strict=True):
            assert torch.equal(a, a1), key  # the ranks agree bit for bit
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    for key in ("eta_L", "opt_local"):
        for r, dump in enumerate(dumps):
            for a, b in zip(dump[key], tree_leaves(one["state"][key]), strict=True):
                np.testing.assert_allclose(a[0].numpy(), b[r].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(worlds["two"][0]["glmm"]["elbo"], one["elbo"], rtol=1e-6)


def test_padding_and_chunked_growth(worlds):
    for res in worlds["two"]:
        assert res["pad7"]["J_pad"] == 8
        assert res["grow_pads"] == [[4, 4, 6, 6], 5]
    assert sorted(_whole(worlds["two"], "pad7")) == [str(j) for j in range(7)]


def test_model_axis_equals_the_silo_mesh_bit_for_bit(worlds):
    two, four = worlds["two"], worlds["four"]
    assert four[0]["smoke"]["shape"] == {"silo": 2, "model": 2}
    for res in four:
        assert res["smoke"]["elbo"] == two[0]["smoke"]["elbo"]
        assert res["smoke"]["global"] == two[0]["smoke"]["global"]
        assert res["smoke"]["per_round"] == [SMOKE_BYTES] * 25
    assert two[0]["smoke"]["per_round"] == [SMOKE_BYTES] * 25
    for b in (0, 1):  # both model columns of a block hold the block's rows
        assert four[2 * b]["smoke"]["rows"] == four[2 * b + 1]["smoke"]["rows"]
        assert four[2 * b]["smoke"]["rows"] == two[b]["smoke"]["rows"]


def test_two_ranks_match_the_reference_and_write_what_it_resumes(worlds):
    jexp, jh = worlds["jexp"], worlds["jh"]
    res = worlds["two"][0]["jax"]
    assert res["bytes_up"] == jh["bytes_up"][1:]
    np.testing.assert_allclose(res["elbo_trace"], jh["elbo_trace"][JAX_K:], rtol=1e-4)
    np.testing.assert_allclose(res["epsilon"], jh["epsilon"][1:], atol=1e-6)
    # The ranks' spec carries their mesh; the reference resumes it on one device.
    back = japi.Experiment.resume(worlds["jax_out"], spec=_jax_spec())
    assert back.round == 3 and back.spec.num_silos == JAX_J
    assert_state_close({k: _to_torch(back.server.state[k]) for k in back.server.state},
                       jexp.server.state, ("theta", "eta_G", "eta_L", "opt_local"),
                       "2-rank checkpoint vs the reference run")


def _to_torch(tree):
    import jax

    return jax.tree_util.tree_map(lambda x: torch.as_tensor(np.array(x)), tree)


# ---------------------------------------------------------------------------
# Units against the reference's functions
# ---------------------------------------------------------------------------


def test_build_mesh_validation_names_the_process_flags():
    from repro.launch.mesh import MeshSpec as JMeshSpec, build_mesh as j_build_mesh

    for spec in (MeshSpec(silo=2, multiprocess=True), MeshSpec(model=2, multiprocess=True)):
        with pytest.raises(ValueError) as terr:
            build_mesh(spec)
        with pytest.raises(ValueError) as jerr:
            j_build_mesh(JMeshSpec(silo=spec.silo, model=spec.model))
        assert str(terr.value).startswith(str(jerr.value))
        assert "--num-processes" in str(terr.value)
    for spec in (MeshSpec(silo=2), MeshSpec(model=2), MeshSpec(silo=3, model=2)):
        with pytest.raises(ValueError, match="--num-processes"):
            build_mesh(spec)


def test_one_rank_meshes_and_axis_helpers():
    for spec in (MeshSpec(), MeshSpec(silo=1), MeshSpec(multiprocess=True),
                 MeshSpec(silo=1, multiprocess=True)):
        m = build_mesh(spec, num_silos=5)
        assert (m.shape, m.rank, m.distributed) == ({"silo": 1, "model": 1}, 0, False)
        assert (data_world(m), model_world(m), mesh_process_count(m)) == (1, 1, 1)
    assert not distributed.is_multiprocess()


class _Dev:
    def __init__(self, p):
        self.process_index = p


class _JMesh:
    """A stand-in for a jax Mesh: the device grid and its shape."""

    def __init__(self, silo, model, procs_per_block=1):
        grid = [[_Dev((b * model + m) // procs_per_block) for m in range(model)]
                for b in range(silo)]
        self.devices = np.array(grid, dtype=object) if model > 1 else np.array(
            [row[0] for row in grid], dtype=object)
        self.shape = {"silo": silo, "model": model}


@pytest.mark.parametrize("silo,model,J", [(2, 1, 8), (4, 1, 7), (2, 2, 5), (3, 2, 10)])
def test_owned_rows_and_j_pad_match_the_reference(silo, model, J):
    from repro.federated import distributed as jdist

    # The reference's J_pad (src/repro/federated/runtime.py:340-344).
    j_pad = ((J + silo - 1) // silo) * silo
    assert distributed.padded_rows(J, Mesh(silo=silo, model=model, multiprocess=True)) == j_pad
    # Row owners: the reference's process of each row's block (one process
    # a silo block of ``model`` devices) is the port's rank of model column 0
    # divided by model.
    jm = _JMesh(silo, model, procs_per_block=model)
    for row in range(j_pad):
        jp = jdist.row_owner_process(jm, row, j_pad)
        mesh0 = Mesh(silo=silo, model=model, multiprocess=True)
        assert distributed.row_owner_process(mesh0, row, j_pad) == jp * model
    for rank in range(silo * model):
        mesh = Mesh(silo=silo, model=model, multiprocess=True, rank=rank)
        want = [r for r in range(j_pad)
                if jdist.row_owner_process(jm, r, j_pad) == rank // model]
        assert distributed.owned_rows(mesh, j_pad) == want
