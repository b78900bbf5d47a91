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

The silos are groups of B / J rows of one process's batch and the server
is the summed gradient (``launch.steps``). A non-empty ``--mesh`` is
refused: the reference shards this step over a device mesh, and the port
has no multi-process training (its multi-process federation is
``repro_torch.federated.run --mesh ...,multiprocess``). ``--dump-spec``
prints the reference's JSON. Weights come from seed 0 and the token
stream from seed 1, on torch generators (not the reference's numbers).
A vision config (qwen2-vl-2b) gets f32 stub patch embeddings with each
batch, and an encoder-decoder (whisper-base) f32 stub frame embeddings,
each drawn from seed (1, step).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.synthetic import make_token_stream
from repro_torch.device import generator, resolve_device
from repro_torch.federated.aggregation import NoCompression
from repro_torch.federated.api import ExperimentSpec, ModelSpec, OptimizerSpec, RuntimeSpec
from repro_torch.federated.driver import run_rounds
from repro_torch.federated.metering import CommMeter
from repro_torch.federated.scheduler import Scenario
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import MeshSpec
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
          remat: bool = False):
    """The initial state and the step function of ``algo`` ("sfvi" or
    "avg"), as the CLI builds them (``remat=False``, as the reference CLI;
    ``remat=True`` recomputes each unit in the backward, for long
    sequences)."""
    state, opt = S.init_train_state(generator(INIT_SEED, device), cfg, silos, lr=lr)
    if algo == "avg":
        eta_G = S.init_eta_G_silo(generator(INIT_SEED, device), cfg, silos)
        state = S.TrainState(state.theta, eta_G, state.eta_L, state.opt_theta,
                             opt.init(eta_G), state.opt_eta_L, state.step)
        return state, S.make_train_step_avg(cfg, silos, avg_every, lr=lr, remat=remat)
    return state, S.make_train_step(cfg, silos, lr=lr, remat=remat)


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
                    help="recorded on --dump-spec's spec; running with one is refused "
                         "(multi-process training is not ported)")
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
    if args.mesh:
        raise SystemExit(
            f"--mesh {args.mesh!r}: multi-process training is not ported (ROADMAP "
            "Queue 1 item 6); the port trains in one process, its silos groups of the "
            "batch. Drop --mesh.")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    assert args.batch % args.silos == 0
    state, step_fn = setup(cfg, args.algo, args.silos, args.lr, args.avg_every, device)
    toks = make_batches(generator(DATA_SEED, torch.device("cpu")), cfg, args.batch, args.seq,
                        args.steps)
    print(f"arch={cfg.name} params={T.param_count(state.theta):,} silos={args.silos} "
          f"algo={args.algo}")

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    t0 = time.time()

    def batches():
        for i in range(args.steps):
            step = torch.from_numpy(toks[i]).to(device=device, dtype=torch.long)
            batch = {"tokens": step[:, :-1], "labels": step[:, 1:]}
            if cfg.is_encoder_decoder:
                batch["frames"] = frame_inputs(cfg, args.batch, i, device)
            if cfg.num_vision_tokens:
                batch["vision"] = vision_inputs(cfg, args.batch, i, device)
            yield batch

    def on_metrics(i, m, st):
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  + " ".join(f"{k}={float(v):.4f}" for k, v in m.items() if k != "loss")
                  + f" ({time.time()-t0:.1f}s)")
        if ckpt and (i + 1) % 50 == 0:
            ckpt.save(i + 1, {"theta": st.theta, "eta_G": st.eta_G})

    meter = CommMeter()
    per_round = bytes_per_round(state, args.algo, args.silos, args.avg_every)
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
