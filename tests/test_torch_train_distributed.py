"""Multi-process training in the port: ``repro_torch.launch.train --mesh silo=N,multiprocess``.

CPU gloo worlds of 2 ranks (``silo=2``) and 4 ranks (``silo=4``) are
spawned from the test, one process a rank, on qwen3-4b's reduced config (2
layers, f32), J = 4, B = 8, S 16, 3 steps, SFVI and SFVI-Avg
(``avg_every`` 2: the barycenter at step 2 gathers η_G's rows from every
rank). Each rank dumps its state (``torch.save``) twice:

  * **Against the JAX package.** The JAX train steps (``repro.launch.steps``
    ``make_train_step`` / ``make_train_step_avg``, one process) take 3
    steps from their own initial state on numpy-seeded batches and their
    own draws (``split(fold_in(PRNGKey(i), 0))``, as
    ``tests/test_torch_train.py``). Each rank converts that initial state
    (``train_state_from_jax``), takes its part (``shard_train_state``),
    and runs the port's step with ``mesh=`` on its B / N rows of the same
    batches (``steps.rank_rows``) and the same draws, injected. The ranks'
    replicated leaves (θ, SFVI's η_G, their Adam states) are bit-identical
    to each other's; rank 0's, and the ranks' rows put together (η_L and
    SFVI-Avg's η_G, with their Adam moments), are held to JAX's state
    after the 3 steps: relative Frobenius ≤ 1e-4 a leaf (the largest
    seen is 2.5e-5, an Adam second moment of θ under SFVI-Avg; 1.8e-5 for
    a parameter), and every parameter element within 2·lr·steps (Adam
    turns the sign of a gradient near 0 into a step of lr either way, and
    a rank's 2 or 4 rows round their sums otherwise than 8; the largest
    seen is 2.8e-4). The metrics the ranks return (the federation's,
    summed over the silo group) are JAX's each step within rtol 1e-5.
  * **The CLI's wiring.** Each rank runs the train CLI's ``main`` with the
    process flags: its θ (and SFVI's η_G, and their Adam moments) are
    bit-identical across ranks, and the ranks' state put together is
    within the same limits of the port's own one-process CLI run (the CLI
    draws from torch generators, which the JAX package does not; this
    holds the rank split of the CLI's batches and state, the numbers are
    held to JAX above). Rank 0 prints the one-process CLI's bytes a round,
    the other ranks nothing.
  * ``--dump-spec`` with ``--mesh silo=2,multiprocess`` is the reference
    CLI's JSON; ``--mesh ...,model=2`` is refused before any world starts,
    naming the reference's missing parameter shardings; a MoE config on
    two silo blocks and J not divisible by the blocks are refused by the
    step (``steps.silo_block``) on the CPU without a world.
"""
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _chip_smoke, ref_draws

from repro.configs import get_config as j_get_config
from repro.launch import steps as JS
from repro.launch import train as j_train
from repro.optim.adam import adam as j_adam
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.launch import steps as S
from repro_torch.launch import train as t_train
from repro_torch.launch.mesh import Mesh
from repro_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, STEPS = 1e-3, 3
J, B, SEQ, AVG_EVERY = 4, 8, 16, 2
FROB = 1e-4
METRIC_RTOL = 1e-5
ARGV = ["--arch", "qwen3-4b", "--silos", "4", "--batch", "8", "--seq", "16",
        "--steps", str(STEPS), "--lr", str(LR), "--avg-every", "2", "--log-every", "1",
        "--device", "cpu"]

_WORKER = textwrap.dedent("""
    import contextlib, io, json, sys
    import torch

    torch.set_num_threads(1)
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    task = json.loads(sys.argv[1])
    rank = int(task["rank"])

    # The port's steps with mesh= on the JAX package's initial state, batches and draws.
    from repro_torch.configs import get_config
    from repro_torch.federated import distributed
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import MeshSpec, build_mesh

    ref = torch.load(task["ref"], weights_only=False)
    distributed.initialize(task["coordinators"][0], task["n"], rank, device="cpu")
    mesh = build_mesh(MeshSpec.parse(task["mesh"]), num_silos=task["J"])
    cfg = get_config("qwen3-4b").reduced()
    blk = S.silo_block(cfg, task["J"], mesh)
    for algo in ("sfvi", "avg"):
        state = S.shard_train_state(ref[algo]["state"], blk, silo_eta_G=algo == "avg")
        if algo == "sfvi":
            step = S.make_train_step(cfg, task["J"], lr=task["lr"], remat=False, mesh=mesh)
        else:
            step = S.make_train_step_avg(cfg, task["J"], task["avg_every"], lr=task["lr"],
                                         remat=False, mesh=mesh)
        metrics = []
        for i, (b, d) in enumerate(zip(ref["batches"], ref[algo]["draws"], strict=True)):
            state, m = step(state, {k: S.rank_rows(v, blk) for k, v in b.items()}, i, draws=d)
            metrics.append({k: float(v) for k, v in m.items()})
        torch.save({k: tree_leaves(getattr(state, k)) for k in
                    ("theta", "eta_G", "eta_L", "opt_theta", "opt_eta_G", "opt_eta_L")}
                   | {"metrics": metrics}, f"{task['dir']}/jax_{algo}_rank{rank}.pt")
    distributed.shutdown()

    # The train CLI with the process flags.
    for algo, coordinator in zip(("sfvi", "avg"), task["coordinators"][1:]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            st = train.main(task["argv"] + ["--algo", algo, "--mesh", task["mesh"],
                                            "--coordinator", coordinator])
        torch.save({"theta": tree_leaves(st.theta), "eta_G": tree_leaves(st.eta_G),
                    "eta_L": tree_leaves(st.eta_L), "opt_theta": tree_leaves(st.opt_theta),
                    "opt_eta_G": tree_leaves(st.opt_eta_G), "out": buf.getvalue()},
                   f"{task['dir']}/{algo}_rank{rank}.pt")
    print("RESULT ok", flush=True)
""")


def _free_ports(n: int) -> list:
    """``n`` distinct free ports: each world the ranks start gets its own."""
    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(socket.socket()) for _ in range(n)]
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]


def _spawn(n: int, mesh: str, out_dir: str, ref: str, timeout: float = 240.0) -> None:
    ports = _free_ports(3)  # the steps' world, then one a CLI run
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = []
    for r in range(n):
        argv = ARGV + ["--num-processes", str(n), "--process-id", str(r)]
        task = {"rank": r, "argv": argv, "mesh": mesh, "dir": out_dir, "ref": ref,
                "coordinators": [f"localhost:{p}" for p in ports], "n": n, "J": J,
                "lr": LR, "avg_every": AVG_EVERY}
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER, json.dumps(task)],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, env=env, cwd=REPO))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = [(out or "")[-2000:] + (err or "")[-3000:]
                 for out, err in (p.communicate() for p in procs)]
        pytest.fail(f"a rank did not finish in {timeout} s:\n" + "\n".join(tails))
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs, strict=True):
        assert p.returncode == 0 and "RESULT ok" in out, out[-2000:] + err[-3000:]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's 3 steps of SFVI and SFVI-Avg from its initial
    state: (final numpy state, metrics a step) for each, and a file with
    the initial states (converted), batches and draws for the ranks."""
    jcfg = j_get_config("qwen3-4b").reduced()
    n_G, n_L = S.latent_dims(get_config("qwen3-4b").reduced())
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (STEPS, B, SEQ + 1))
    jbatches = [{"tokens": t[:, :-1].astype(np.int32), "labels": t[:, 1:].astype(np.int32)}
                for t in toks]
    key = jax.random.PRNGKey(0)
    s0, _ = JS.init_train_state(key, jcfg, J, lr=LR)
    eta_G = JS.init_eta_G_silo(key, jcfg, J)
    starts = {"sfvi": s0,
              "avg": JS.TrainState(s0.theta, eta_G, s0.eta_L, s0.opt_theta,
                                   j_adam(LR).init(eta_G), s0.opt_eta_L, s0.step)}
    steps = {"sfvi": jax.jit(JS.make_train_step(jcfg, J, lr=LR, remat=False)),
             "avg": jax.jit(JS.make_train_step_avg(jcfg, J, AVG_EVERY, lr=LR, remat=False))}
    shapes = {"sfvi": [(n_G,), (J, n_L)], "avg": [(J, n_G), (J, n_L)]}
    out, ranks_in = {}, {"batches": [{k: torch.from_numpy(v).long() for k, v in b.items()}
                                     for b in jbatches]}
    for algo in ("sfvi", "avg"):
        draws = [ref_draws(i, shapes[algo]) for i in range(STEPS)]
        ranks_in[algo] = {"state": train_state_from_jax(_np_tree(starts[algo]), "cpu"),
                          "draws": [tuple(torch.from_numpy(e) for e in d) for d in draws]}
        state, metrics = starts[algo], []
        for i, b in enumerate(jbatches):
            state, m = steps[algo](state, b, jnp.int32(i))
            metrics.append({k: float(v) for k, v in m.items()})
        out[algo] = (_np_tree(state), metrics)
    path = tmp_path_factory.mktemp("reference") / "reference.pt"
    torch.save(ranks_in, path)
    return str(path), out


@pytest.fixture(scope="module")
def one_process():
    """The one-process CLI runs (the reference for every world), and their output."""
    out = {}
    for algo in ("sfvi", "avg"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            state = t_train.main(ARGV + ["--algo", algo])
        out[algo] = (state, buf.getvalue())
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["2_ranks", "4_ranks"])
def world(request, tmp_path_factory, reference):
    n = request.param
    d = tmp_path_factory.mktemp(f"world{n}")
    _spawn(n, f"silo={n},multiprocess", str(d), reference[0])
    return n, {name: [torch.load(d / f"{name}_rank{r}.pt") for r in range(n)]
               for name in ("sfvi", "avg", "jax_sfvi", "jax_avg")}


def _bytes_line(text):
    return [ln for ln in text.splitlines() if ln.startswith("done:")][0].split("; ")[1]


def _close(got, want, label, param=True):
    """Relative Frobenius ≤ FROB and, for a parameter, every element within
    2·lr·steps."""
    want = torch.as_tensor(np.asarray(want, np.float32)) if not torch.is_tensor(want) else want
    assert tuple(got.shape) == tuple(want.shape), label
    diff = (got - want).abs()
    rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
    assert rel <= FROB, (label, rel)
    if param:
        assert float(diff.max()) <= 2 * LR * STEPS, (label, float(diff.max()))


def _whole(ranks, k, i):
    """Leaf i of field k put together from the ranks' rows (a 0-d leaf, an
    Adam count, is every rank's own)."""
    if ranks[0][k][i].dim() == 0:
        assert all(torch.equal(r[k][i], ranks[0][k][i]) for r in ranks), (k, i)
        return ranks[0][k][i]
    return torch.cat([r[k][i] for r in ranks])


@pytest.mark.parametrize("algo", ["sfvi", "avg"])
def test_ranks_match_jax_train_step(world, reference, algo):
    n, dumps = world
    ranks = dumps[f"jax_{algo}"]
    want, want_metrics = reference[1][algo]
    replicated = ("theta", "opt_theta") + (("eta_G", "opt_eta_G") if algo == "sfvi" else ())
    for k in replicated:
        for r in ranks[1:]:
            assert all(torch.equal(a, b) for a, b in zip(ranks[0][k], r[k], strict=True)), k
    for k in ("theta", "eta_G", "eta_L", "opt_theta", "opt_eta_G", "opt_eta_L"):
        jleaves = jax.tree_util.tree_leaves(getattr(want, k))
        assert len(jleaves) == len(ranks[0][k]), k
        for i, w in enumerate(jleaves):
            got = ranks[0][k][i] if k in replicated else _whole(ranks, k, i)
            if got.dim() == 0:  # Adam's count
                assert int(got) == int(w) == STEPS, (k, i)
                continue
            _close(got, w, f"{algo} {k} leaf {i}", param=not k.startswith("opt"))
    for r in ranks:
        assert [sorted(m) for m in r["metrics"]] == [sorted(m) for m in want_metrics]
        for i, (got, w) in enumerate(zip(r["metrics"], want_metrics, strict=True)):
            for key in w:
                np.testing.assert_allclose(got[key], w[key], rtol=METRIC_RTOL, atol=1e-6,
                                           err_msg=f"{algo} step {i} {key}")


@pytest.mark.parametrize("algo", ["sfvi", "avg"])
def test_ranks_agree_and_match_one_process(world, one_process, algo):
    n, dumps = world
    ranks = dumps[algo]
    want, out = one_process[algo]
    # Replicated state: bit for bit across ranks.
    keys = ("theta", "opt_theta") + (("eta_G", "opt_eta_G") if algo == "sfvi" else ())
    for k in keys:
        for r in ranks[1:]:
            assert all(torch.equal(a, b) for a, b in zip(ranks[0][k], r[k], strict=True)), k
    # Against one process: θ, then the rows put together.
    for i, (g, w) in enumerate(zip(ranks[0]["theta"], tree_leaves(want.theta), strict=True)):
        _close(g, w, f"theta leaf {i}")
    rows = {"eta_L": want.eta_L}
    if algo == "avg":
        rows["eta_G"] = want.eta_G
    else:
        for g, w in zip(ranks[0]["eta_G"], tree_leaves(want.eta_G), strict=True):
            _close(g, w, "eta_G")
    for k, whole in rows.items():
        for i, w in enumerate(tree_leaves(whole)):
            got = torch.cat([r[k][i] for r in ranks])
            _close(got, w, f"{k} leaf {i}")
    assert n * ranks[0]["eta_L"][0].shape[0] == 4
    # Rank 0 prints the one-process bytes a round; the other ranks print nothing.
    assert _bytes_line(ranks[0]["out"]) == _bytes_line(out)
    assert f"mesh: {n} silo block(s)" in ranks[0]["out"]
    assert all(r["out"] == "" for r in ranks[1:])


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


@pytest.mark.parametrize("mesh", ["silo=2,multiprocess", "silo=4,multiprocess"])
def test_dump_spec_matches_reference(mesh):
    argv = ["--arch", "qwen3-4b", "--algo", "avg", "--mesh", mesh, "--dump-spec"]
    assert _stdout(t_train.main, argv) == _stdout(j_train.main, argv)


def test_model_axis_refused_naming_why():
    with pytest.raises(SystemExit, match="no parameter shardings"):
        t_train.main(["--mesh", "silo=2,model=2,multiprocess", "--device", "cpu",
                      "--steps", "1", "--coordinator", "localhost:1", "--num-processes", "4",
                      "--process-id", "0"])


@pytest.mark.parametrize("arch,silos,match", [("olmoe-1b-7b", 4, "MoE config"),
                                              ("qwen3-4b", 3, "do not split")],
                         ids=["moe", "uneven"])
def test_step_refuses_what_a_split_would_change(arch, silos, match):
    cfg = get_config(arch).reduced()
    mesh = Mesh(silo=2, model=1, multiprocess=True, rank=0, silo_group=object())
    with pytest.raises(ValueError, match=match):
        S.silo_block(cfg, silos, mesh)
    assert S.silo_block(cfg, 4, None) == S.SiloBlock(0, 4, 1, True, None)
    blk = S.silo_block(get_config("qwen3-4b").reduced(), 4,
                       Mesh(silo=2, model=1, multiprocess=True, rank=1, silo_group=object()))
    assert (blk.lo, blk.hi, blk.ranks, blk.lead) == (2, 4, 2, False)
    assert np.array_equal(S.rank_rows(torch.arange(8), blk).numpy(), np.arange(4, 8))


def test_chip_smoke_bf16_parting_counts_elements_past_one_step():
    """Phase 3i's bf16 hold (``chip_smoke._leaf_gaps``, ``_bf16_parting``):
    one bf16 step is 2^-7 at 1.0 and 2^-8 at 0.75; an element parts when it
    is more than one step from the one-process run; the worst element is
    read in units of (2·lr + one step) · steps; the state is counted once
    (rank 0's θ, every rank's η_L rows)."""
    smoke = _chip_smoke()
    one = torch.tensor([1.0, 0.75, 0.0, 0.5], dtype=torch.bfloat16)
    mine = one.clone()
    mine[0] = 1.0 + 2 ** -7  # one step: not parted
    mine[1] = 0.75 + 2 ** -7  # two steps at 0.75: parted
    mine[2] = 1e-3  # a 0 moved by lr: parted
    step = smoke._bf16_step(torch, mine, one)
    assert step[:2].tolist() == [2 ** -7, 2 ** -8]
    eta = torch.zeros(2, 3)
    gaps = smoke._leaf_gaps(torch, [("theta/w", mine), ("eta_L/mu", eta)],
                            [("theta/w", one), ("eta_L/mu", eta)], 3, True)
    assert [g["parted"] for g in gaps] == [2, 0]
    worst = 2 ** -7 / ((2 * smoke.TRAIN_LR + 2 ** -8) * 3)
    assert gaps[0]["worst"] == pytest.approx(worst)
    f32 = smoke._leaf_gaps(torch, [("theta/w", mine)], [("theta/w", one)], 3, False)
    assert "parted" not in f32[0] and f32[0]["rel"] > 0
    out = smoke._bf16_parting([{"leaf_gaps": gaps}, {"leaf_gaps": gaps}])
    assert (out["bf16_elements"], out["bf16_parted"]) == (4 + 6 + 6, 2)
    assert out["bf16_parted_leaves"] == [{"leaf": "theta/w", "numel": 4, "parted": 2,
                                          "rel": gaps[0]["rel"]}]
