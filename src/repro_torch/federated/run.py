"""Federated runtime CLI of the port.

    python -m repro_torch.federated.run --model hier_bnn \
        --model-kwargs '{"in_dim":784,"hidden":64}' \
        --silos 10 --rounds 3 --local-steps 4 --algo both --wire fused

    python -m repro_torch.federated.run --model glmm \
        --model-kwargs '{"num_children": 536}' --silos 2 \
        --global-family cholesky --rounds 3 --local-steps 25 --algo both

Runs on ``cuda`` by default (``--device cpu`` for the CPU, where the
fused wire takes the kernels' plain versions). Prints per-round ELBO,
bytes on the wire, active silos and, with DP on, the cumulative ε; with
``--algo both`` it asserts the §3.2 byte ordering (SFVI-Avg ships fewer
bytes per round than SFVI when ``--local-steps > 1``).

``--global-family``/``--local-family`` (with ``--*-family-kwargs``) swap
the model's variational families for registered ones (diag, cholesky,
lowrank, conditional, batched_diag); a full-covariance global family's
SFVI-Avg barycenter takes its square roots from the Newton–Schulz step
kernel on the fused wire. A model without an eval hook prints no eval
line.

The flags are the subset of ``repro.federated.run`` the port supports.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.models.paper.registry import get_model, model_names


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.federated.run", description=__doc__)
    ap.add_argument("--model", default="hier_bnn", choices=model_names())
    ap.add_argument("--model-kwargs", default="", metavar="JSON",
                    help="JSON dict forwarded to the registry builder")
    ap.add_argument("--global-family", default=None, metavar="NAME",
                    help="override the model's q(Z_G) family with a registered one "
                         "(diag, cholesky, lowrank, ...); default: the model's own")
    ap.add_argument("--global-family-kwargs", default="", metavar="JSON",
                    help='JSON kwargs for --global-family (e.g. \'{"rank": 2}\' for lowrank)')
    ap.add_argument("--local-family", default=None, metavar="NAME",
                    help="override the model's q(Z_L | Z_G) family (conditional, "
                         "batched_diag, ...)")
    ap.add_argument("--local-family-kwargs", default="", metavar="JSON",
                    help="JSON kwargs for --local-family")
    ap.add_argument("--silos", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--algo", default="both", choices=["both", "sfvi", "sfvi_avg"])
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--aggregator", default="mean", choices=["mean", "trimmed"])
    ap.add_argument("--trim-frac", type=float, default=0.1)
    ap.add_argument("--compress", default="none", choices=["none", "int8"])
    ap.add_argument("--eta-mode", default="barycenter", choices=["barycenter", "param"])
    ap.add_argument("--dp-noise", type=float, default=0.0,
                    help="Gaussian noise multiplier z (0 = DP off)")
    ap.add_argument("--dp-clip", type=float, default=1.0,
                    help="L2 clip norm C for silo uploads")
    ap.add_argument("--dp-delta", type=float, default=1e-5,
                    help="target delta for (eps, delta) reports")
    ap.add_argument("--wire", default="fused", choices=["fused", "flat"],
                    help="silo->server wire layout (fused = the CUDA kernels)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' for the CPU)")
    return ap


def build_server(args, algorithm: str, bundle, device):
    """One ``Server`` for ``algorithm`` from the CLI flags and a staged bundle."""
    from repro_torch.device import generator
    from repro_torch.federated.aggregation import (
        Int8Compressor,
        MeanAggregator,
        NoCompression,
        TrimmedMeanAggregator,
    )
    from repro_torch.federated.privacy import PrivacyPolicy
    from repro_torch.federated.runtime import Server
    from repro_torch.optim import adam

    problem = bundle.problem
    privacy = (PrivacyPolicy(clip_norm=args.dp_clip, noise_multiplier=args.dp_noise,
                             delta=args.dp_delta) if args.dp_noise > 0.0 else None)
    return Server(
        problem, bundle.datas, bundle.theta0,
        problem.global_family.init(generator(args.seed, device)),
        num_obs=bundle.num_obs,
        server_opt=adam(args.lr),
        local_opt=adam(args.lr) if problem.model.has_local else None,
        aggregator=(TrimmedMeanAggregator(args.trim_frac)
                    if args.aggregator == "trimmed" else MeanAggregator()),
        compressor=Int8Compressor() if args.compress == "int8" else NoCompression(),
        eta_mode=args.eta_mode, wire=args.wire, privacy=privacy, seed=args.seed,
        strategy=algorithm, device=device)


def _family_spec(name, kwargs_json):
    from repro_torch.core.family import FamilySpec

    if name is None:
        return None
    return FamilySpec(name, json.loads(kwargs_json or "{}"))


def _log_round(total_silos: int):
    def log(r, m):
        eps = f"  eps={m['epsilon']:7.3f}" if "epsilon" in m else ""
        print(f"  round {r:3d}  elbo={m['elbo']:14.2f}  "
              f"up={m['bytes_up']:>9d}B  down={m['bytes_down']:>9d}B  "
              f"active={m['n_active']}/{total_silos}{eps}", flush=True)
    return log


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from repro_torch.device import resolve_device
    from repro_torch.federated.scheduler import RoundScheduler, algorithm_label
    from repro_torch.models.paper.registry import apply_family_spec

    device = resolve_device(args.device)
    bundle = get_model(args.model).build(
        args.seed, args.silos, device=device, **json.loads(args.model_kwargs or "{}"))
    bundle = apply_family_spec(
        bundle, global_family=_family_spec(args.global_family, args.global_family_kwargs),
        local_family=_family_spec(args.local_family, args.local_family_kwargs))
    algos = ["sfvi", "sfvi_avg"] if args.algo == "both" else [args.algo]
    per_round = {}
    for algo in algos:
        server = build_server(args, algo, bundle, device)
        print(f"\n== {algorithm_label(algo)}: {args.model}, J={args.silos}, "
              f"{args.rounds} rounds x {args.local_steps} local steps, "
              f"wire={args.wire}, device={device}"
              + (f", DP(z={args.dp_noise:g}, C={args.dp_clip:g})"
                 if args.dp_noise > 0 else "") + " ==", flush=True)
        sched = RoundScheduler(args.silos, participation=args.participation,
                               dropout=args.dropout, seed=args.seed)
        t0 = time.time()
        server.run(args.rounds, local_steps=args.local_steps, scheduler=sched,
                   callback=_log_round(args.silos))
        print(f"  wall time: {time.time() - t0:.1f}s")
        print(f"  total: {server.comm.total:,} B in {server.comm.rounds} rounds "
              f"({server.comm.per_round:,.0f} B/round)")
        if server.accountant is not None:
            eps, order = server.accountant.epsilon(args.dp_delta)
            print(f"  privacy: ({eps:.3f}, {args.dp_delta:g})-DP after "
                  f"{server.accountant.steps} exchanges (RDP order {order})")
        if bundle.eval_fn is not None:
            for k, v in bundle.eval_fn(server).items():
                print(f"  {k}: {v:.3f}")
        per_round[algo] = server.comm.per_round
    if len(per_round) == 2:
        sfvi_pr, avg_pr = per_round["sfvi"], per_round["sfvi_avg"]
        print(f"\nbytes/round: SFVI={sfvi_pr:,.0f}  SFVI-Avg={avg_pr:,.0f}  "
              f"(x{sfvi_pr / max(avg_pr, 1):.1f} reduction)")
        if args.local_steps > 1:
            assert avg_pr < sfvi_pr, "SFVI-Avg must ship strictly fewer bytes/round"
        else:
            assert avg_pr <= sfvi_pr, "SFVI-Avg must never ship more bytes/round than SFVI"
    return 0


if __name__ == "__main__":
    sys.exit(main())
