"""End-to-end SFVI training driver for the backbone architectures.

The port of ``repro/launch/train.py``, with its flags plus ``--device``
(the card unless ``--device cpu``). Without ``--full`` it trains the
reduced config (2 layers, f32); with it, the full config in bf16:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --steps 6 \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --full \\
        --steps 20                    # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --algo avg \\
        --avg-every 10                # SFVI-Avg schedule

The silos are groups of B / J rows of the batch and the server is the
summed gradient (``launch.steps``). ``--mesh silo=N,multiprocess`` runs
the step over the N ranks of a ``torch.distributed`` world (the
reference's SPMD path: silos are slices of the data axis, the server a
sum over them), one process a device; each process is started with the
same flags and its own ``--process-id``:

    for r in 0 1; do PYTHONPATH=src python -m repro_torch.launch.train \\
        --device cpu --mesh silo=2,multiprocess --coordinator localhost:29512 \\
        --num-processes 2 --process-id $r & done; wait

(or the ``REPRO_COORDINATOR`` / ``_NUM_PROCESSES`` / ``_PROCESS_ID``
environment). Rank r trains the J / N silos ``steps.silo_block`` gives it
on their B / N rows of each batch, and only rank 0 prints. A
model axis and, on several silo blocks, the MoE configs are refused
(``steps.silo_block`` says why). ``--dump-spec`` prints the reference's
JSON. Weights come from seed 0 and the token
stream from seed 1, on torch generators (not the reference's numbers).
A vision config (qwen2-vl-2b) gets f32 stub patch embeddings with each
batch, and an encoder-decoder (whisper-base) f32 stub frame embeddings,
each drawn from seed (1, step).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.synthetic import make_token_stream
from repro_torch.device import generator, resolve_device
from repro_torch.federated import distributed
from repro_torch.federated.aggregation import NoCompression
from repro_torch.federated.api import ExperimentSpec, ModelSpec, OptimizerSpec, RuntimeSpec
from repro_torch.federated.driver import run_rounds
from repro_torch.federated.metering import CommMeter
from repro_torch.federated.scheduler import Scenario
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import Mesh, MeshSpec, build_mesh
from repro_torch.models.backbone import transformer as T
from repro_torch.models.backbone.config import ArchConfig

INIT_SEED, DATA_SEED = 0, 1  # the reference CLI's PRNGKey(0) and PRNGKey(1)


def make_batches(gen: torch.Generator, cfg: ArchConfig, batch: int, seq: int,
                 steps: int) -> np.ndarray:
    """Synthetic token stream (Zipf unigram; no real corpus offline)
    pre-chunked into (steps, batch, seq + 1) int32."""
    toks = make_token_stream(gen, steps * batch * (seq + 1), cfg.vocab_size)
    return toks.reshape(steps, batch, seq + 1)


def vision_inputs(cfg: ArchConfig, batch: int, step: int, device) -> torch.Tensor:
    """The stub vision encoder's patch embeddings of one step's batch:
    (batch, num_vision_tokens, d_model) f32 normals from seed (1, step)."""
    return torch.randn((batch, cfg.num_vision_tokens, cfg.d_model),
                       generator=generator((DATA_SEED, step), device), device=device)


def frame_inputs(cfg: ArchConfig, batch: int, step: int, device) -> torch.Tensor:
    """The stub audio frontend's frame embeddings of one step's batch:
    (batch, encoder_seq_len, d_model) f32 normals from seed (1, step)."""
    return torch.randn((batch, cfg.encoder_seq_len, cfg.d_model),
                       generator=generator((DATA_SEED, step), device), device=device)


def setup(cfg: ArchConfig, algo: str, silos: int, lr: float, avg_every: int, device,
          remat: bool = False, mesh: Optional[Mesh] = None):
    """The whole federation's initial state and the step function of
    ``algo`` ("sfvi" or "avg"), as the CLI builds them (``remat=False``, as
    the reference CLI; ``remat=True`` recomputes each unit in the backward,
    for long sequences). On a ``mesh`` of several ranks the step is the
    rank's; :func:`rank_state` takes the rank's part of the state."""
    state, opt = S.init_train_state(generator(INIT_SEED, device), cfg, silos, lr=lr)
    if algo == "avg":
        eta_G = S.init_eta_G_silo(generator(INIT_SEED, device), cfg, silos)
        state = S.TrainState(state.theta, eta_G, state.eta_L, state.opt_theta,
                             opt.init(eta_G), state.opt_eta_L, state.step)
        return state, S.make_train_step_avg(cfg, silos, avg_every, lr=lr, remat=remat,
                                             mesh=mesh)
    return state, S.make_train_step(cfg, silos, lr=lr, remat=remat, mesh=mesh)


def rank_state(state: S.TrainState, cfg: ArchConfig, algo: str, silos: int,
               mesh: Optional[Mesh]):
    """The step-0 state a rank of ``mesh`` holds (the whole one without a world)."""
    return S.shard_train_state(state, S.silo_block(cfg, silos, mesh),
                               silo_eta_G=algo == "avg")


def gathered_eta_G(state: S.TrainState, algo: str, mesh: Optional[Mesh]) -> dict:
    """η_G as one process holds it: SFVI-Avg's rows gathered from every
    rank (a collective: every rank calls it)."""
    if algo != "avg" or mesh is None or not mesh.distributed:
        return state.eta_G
    return {k: distributed.gather_rows(v, mesh) for k, v in state.eta_G.items()}


def bytes_per_round(state: S.TrainState, algo: str, silos: int, avg_every: int) -> int:
    """Bytes a round (one step): every silo ships its global-shaped
    gradient tree (θ and η_G at their dtypes) to the server each step under
    SFVI, every ``avg_every`` steps under SFVI-Avg, whose silo-stacked η_G
    a silo ships only its row of."""
    theta_bytes = NoCompression().wire_bytes({"theta": state.theta})
    eta_bytes = NoCompression().wire_bytes({"eta_G": state.eta_G})
    per_silo = theta_bytes + (eta_bytes // silos if algo == "avg" else eta_bytes)
    syncs_per_step = 1.0 if algo == "sfvi" else 1.0 / avg_every
    return int(silos * per_silo * syncs_per_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--silos", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--algo", choices=["sfvi", "avg"], default="sfvi")
    ap.add_argument("--avg-every", type=int, default=10)
    ap.add_argument("--full", action="store_true", help="use the FULL config (bf16)")
    ap.add_argument("--dp-noise", type=float, default=0.0,
                    help="account the sync schedule as (eps, delta)-DP with this Gaussian "
                         "noise multiplier (0 = off); the mechanism itself rides "
                         "repro_torch.federated's Server, this run ships raw gradients")
    ap.add_argument("--dp-clip", type=float, default=1.0)
    ap.add_argument("--dp-delta", type=float, default=1e-5)
    ap.add_argument("--mesh", default="", metavar="SPEC",
                    help="'silo=N,multiprocess': the step over the N ranks of a "
                         "torch.distributed world (--num-processes N); recorded on "
                         "--dump-spec's spec")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="torch.distributed rendezvous of a multi-process run "
                         "(or REPRO_COORDINATOR)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="with --coordinator: the world size (or REPRO_NUM_PROCESSES)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="with --coordinator: this process's rank (or REPRO_PROCESS_ID)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--dump-spec", action="store_true",
                    help="print this run's declarative spec as JSON (the reference's) "
                         "and exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    # Declarative record of the run, in repro_torch.federated.api's vocabulary.
    spec = ExperimentSpec(
        model=ModelSpec(f"llm/{args.arch}",
                        kwargs={"batch": args.batch, "seq": args.seq, "full": bool(args.full)}),
        scenario=Scenario(algorithm="sfvi" if args.algo == "sfvi" else "sfvi_avg",
                          dp_noise=args.dp_noise, dp_clip=args.dp_clip,
                          dp_delta=args.dp_delta),
        num_silos=args.silos,
        rounds=args.steps,
        local_steps=1 if args.algo == "sfvi" else args.avg_every,
        server_opt=OptimizerSpec("adam", args.lr),
        seed=0,
        runtime=RuntimeSpec(mesh=MeshSpec.parse(args.mesh)),
    )
    if args.dump_spec:
        print(spec.to_json())
        return None
    if spec.runtime.mesh.model > 1:  # refused before any world is started
        raise SystemExit(f"--mesh {args.mesh!r}: {S.MODEL_AXIS_REFUSAL}")
    try:
        started = distributed.start_from_flags(args.coordinator, args.num_processes,
                                               args.process_id, device=args.device)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh!r}: {e}") from None
    if not started:
        return _main(args, spec)
    import torch.distributed as dist

    try:
        with contextlib.ExitStack() as stack:
            if dist.get_rank() != 0:  # only the lead rank prints
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            return _main(args, spec)
    finally:
        distributed.shutdown()


def _main(args, spec: ExperimentSpec):
    """The CLI's body, once the world (if any) is up."""
    try:
        mesh = build_mesh(spec.runtime.mesh, num_silos=args.silos) if args.mesh else None
        cfg = get_config(args.arch)
        if not args.full:
            cfg = cfg.reduced()
        blk = S.silo_block(cfg, args.silos, mesh)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh!r}: {e}") from None
    device = distributed.rank_device(resolve_device(args.device))
    assert args.batch % args.silos == 0
    state, step_fn = setup(cfg, args.algo, args.silos, args.lr, args.avg_every, device,
                           mesh=mesh)
    per_round = bytes_per_round(state, args.algo, args.silos, args.avg_every)
    state = rank_state(state, cfg, args.algo, args.silos, mesh)
    toks = make_batches(generator(DATA_SEED, torch.device("cpu")), cfg, args.batch, args.seq,
                        args.steps)
    print(f"arch={cfg.name} params={T.param_count(state.theta):,} silos={args.silos} "
          f"algo={args.algo}")
    if mesh is not None:
        print(f"mesh: {mesh.silo} silo block(s) of {args.silos // mesh.silo} silos "
              f"({args.batch // mesh.silo} rows of each batch) a rank")

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    t0 = time.time()

    def batches():
        for i in range(args.steps):
            step = S.rank_rows(torch.from_numpy(toks[i]), blk).to(device=device,
                                                                   dtype=torch.long)
            batch = {"tokens": step[:, :-1], "labels": step[:, 1:]}
            if cfg.is_encoder_decoder:
                batch["frames"] = S.rank_rows(frame_inputs(cfg, args.batch, i, device), blk)
            if cfg.num_vision_tokens:
                batch["vision"] = S.rank_rows(vision_inputs(cfg, args.batch, i, device), blk)
            yield batch

    def on_metrics(i, m, st):
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  + " ".join(f"{k}={float(v):.4f}" for k, v in m.items() if k != "loss")
                  + f" ({time.time()-t0:.1f}s)")
        if ckpt and (i + 1) % 50 == 0:
            # SFVI-Avg's η_G rows come from every rank; rank 0 writes.
            eta_G = gathered_eta_G(st, args.algo, mesh)
            if mesh is None or mesh.lead:
                ckpt.save(i + 1, {"theta": st.theta, "eta_G": eta_G})

    meter = CommMeter()
    # DP accounting for the sync schedule: SFVI ships per step, SFVI-Avg
    # every --avg-every steps (the policy comes from the run's scenario).
    privacy = spec.scenario.privacy()
    exchanges = (1 if args.algo == "sfvi"
                 else (lambda i: 1 if (i + 1) % args.avg_every == 0 else 0))
    state, hist = run_rounds(
        lambda st, batch, i: step_fn(st, batch, i), state, batches(), meter=meter,
        bytes_per_round=(per_round, per_round), privacy=privacy,
        exchanges_per_round=exchanges, on_metrics=on_metrics)
    print(f"done: {args.steps} steps in {time.time()-t0:.1f}s; "
          f"comm {meter.total/2**20:.1f} MiB "
          f"({meter.per_round/2**20:.2f} MiB/step, algo={args.algo})")
    if privacy is not None:
        # Accounting only: this run exchanged raw gradients. Exchanges are
        # counted from the schedule run_rounds composed.
        n_ex = (sum(exchanges(i) for i in range(args.steps))
                if callable(exchanges) else exchanges * args.steps)
        if n_ex == 0:
            print(f"privacy accounting: no silo->server exchange completed "
                  f"(steps={args.steps} < avg-every={args.avg_every}); "
                  f"nothing to account")
        else:
            print(f"privacy accounting (hypothetical — mechanism lives in "
                  f"repro.federated.Server, this run shipped raw gradients): "
                  f"{n_ex} exchanges at z={args.dp_noise:g}, "
                  f"C={args.dp_clip:g} would cost "
                  f"({hist['epsilon'][-1]:.3f}, {args.dp_delta:g})-DP")
    return state


if __name__ == "__main__":
    main()
