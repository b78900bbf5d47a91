"""Federated runtime CLI of the port — a thin spec-builder over ``federated.api``.

    python -m repro_torch.federated.run --model hier_bnn \
        --model-kwargs '{"in_dim":784,"hidden":64}' \
        --silos 10 --rounds 3 --local-steps 4 --algo both

    python -m repro_torch.federated.run --model glmm \
        --model-kwargs '{"num_children": 536}' --silos 2 \
        --global-family cholesky --rounds 3 --local-steps 25 --algo both

Flags build an :class:`~repro_torch.federated.api.ExperimentSpec` (the
reference's JSON, key for key), which is the only construction path, so
every run is serializable and resumable:

    ... --dump-spec > exp.json          # print the spec as JSON, exit
    ... --spec exp.json                 # run exactly that spec (the
                                        #   reference's --dump-spec too)
    ... --ckpt-dir runs/a [--ckpt-every N]   # checkpoint the round state
    ... --resume runs/a [--rounds M]    # continue (or extend) a saved run
    ... --list-models                   # registered models + descriptions

``--algo`` picks a registered strategy (``sfvi``, ``sfvi_avg``, ``pvi``,
``fed_ep``) or ``both`` (SFVI and SFVI-Avg, asserting the §3.2 byte
ordering); ``--strategy``/``--strategy-kwargs`` select one with
hyperparameters (``--strategy pvi --strategy-kwargs '{"damping": 0.2}'``).
``--sweep`` walks the scenario matrix (participation × stragglers ×
compression × DP, and with ``--async`` the async axis) and prints an
ELBO/ε/bytes table.

Buffered-async execution (FedBuff-style flushes; SFVI-Avg unless
``--strategy`` names another round-cadence strategy) and silo churn:

    ... --async --buffer-size 2 --staleness-decay 0.5 --latency lognormal
    ... --population '{"initial": 2, "arrival_rate": 0.6, "seed": 3}'

An async flush's line adds its simulated time ``t=`` and its largest
staleness ``stale<=``.

Runs on ``cuda`` by default (``--device cpu`` for the CPU, where the fused
wire takes the kernels' plain versions). ``--wire`` defaults to ``fused``
(the CUDA kernels); a spec's own ``runtime.wire`` (the reference's default
is ``flat``) is kept by ``--spec`` and ``--resume``. ``--global-family`` /
``--local-family`` swap the model's variational families for registered
ones. A model without an eval hook prints no eval line.

Multi-process federation, one process a device (every process runs the
same command with its own ``--process-id``; only rank 0 prints):

    ... --mesh silo=2,multiprocess \
        --coordinator localhost:29500 --num-processes 2 --process-id 0

``--coordinator`` / ``--num-processes`` / ``--process-id`` export the
reference's ``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` /
``REPRO_PROCESS_ID`` and start a ``torch.distributed`` world (NCCL on the
card, gloo with ``--device cpu``); ``--mesh`` lands on
``spec.runtime.mesh``. The reference's ``--devices`` (host devices of one
process) is refused: a torch process drives one card, so N cards are N
processes. ``--sanitize`` is refused with the ROADMAP item that brings it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

from repro_torch.models.paper.registry import get_model, model_names


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.federated.run", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
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
    ap.add_argument("--rounds", type=int, default=None,
                    help="total rounds (default 5; with --resume, the new budget)")
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--algo", default="both",
                    choices=["both", "sfvi", "sfvi_avg", "pvi", "fed_ep"])
    ap.add_argument("--strategy", default=None, metavar="NAME",
                    help="registered ServerStrategy name; overrides --algo")
    ap.add_argument("--strategy-kwargs", default="", metavar="JSON",
                    help='strategy hyperparameters, e.g. \'{"damping": 0.2}\' for pvi')
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--aggregator", default="mean", choices=["mean", "trimmed"])
    ap.add_argument("--trim-frac", type=float, default=0.1)
    ap.add_argument("--compress", default="none", choices=["none", "int8"])
    ap.add_argument("--eta-mode", default="barycenter", choices=["barycenter", "param"])
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="buffered-asynchronous execution (FedBuff-style flushes; "
                         "round-cadence strategies only)")
    ap.add_argument("--buffer-size", type=int, default=2,
                    help="with --async: contributions per server flush")
    ap.add_argument("--staleness-decay", type=float, default=0.5,
                    help="with --async: weight (1+staleness)^-decay")
    ap.add_argument("--latency", default="lognormal",
                    choices=["constant", "lognormal", "straggler"],
                    help="with --async: deterministic per-silo latency model")
    ap.add_argument("--latency-scale", type=float, default=1.0,
                    help="with --async: median simulated seconds per task")
    ap.add_argument("--latency-sigma", type=float, default=0.5,
                    help="with --async: lognormal latency spread")
    ap.add_argument("--dp-noise", type=float, default=0.0,
                    help="Gaussian noise multiplier z (0 = DP off)")
    ap.add_argument("--dp-clip", type=float, default=1.0,
                    help="L2 clip norm C for silo uploads")
    ap.add_argument("--dp-delta", type=float, default=1e-5,
                    help="target delta for (eps, delta) reports")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="run the registry eval hook every N rounds")
    ap.add_argument("--sweep", action="store_true",
                    help="run the scenario matrix instead of one config")
    ap.add_argument("--sweep-participation", default="1.0,0.5")
    ap.add_argument("--sweep-dropout", default="0.0,0.2")
    ap.add_argument("--sweep-compress", default="none,int8")
    ap.add_argument("--sweep-dp-noise", default="0.0,1.0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="", metavar="SPEC",
                    help="federated mesh as 'silo=N,model=N[,multiprocess]'; more than "
                         "one rank needs multiprocess and a world (--num-processes); "
                         "with --resume, overrides the checkpointed topology")
    ap.add_argument("--wire", default="fused", choices=["fused", "flat", "legacy"],
                    help="silo->server wire layout (fused = the CUDA kernels; "
                         "legacy is not ported)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="torch.distributed rendezvous of a multi-process run "
                         "(or REPRO_COORDINATOR)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="with --coordinator: the world size (or REPRO_NUM_PROCESSES)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="with --coordinator: this process's rank (or REPRO_PROCESS_ID)")
    ap.add_argument("--devices", type=int, default=0,
                    help="the reference's host devices of one process: refused (one "
                         "process drives one card; use the process flags)")
    ap.add_argument("--sanitize", action="store_true",
                    help="the reference's JAX sanitizer (not ported)")
    ap.add_argument("--list-models", action="store_true",
                    help="print registered model names + descriptions, exit 0")
    ap.add_argument("--spec", default=None, metavar="FILE",
                    help="run this ExperimentSpec JSON (flags are ignored)")
    ap.add_argument("--dump-spec", action="store_true",
                    help="print the spec the flags build as JSON, exit 0 "
                         "(needs a single algorithm)")
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="save the full round state here at the end (and every "
                         "--ckpt-every rounds)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="with --ckpt-dir: also save every N rounds (0 = end only)")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="resume a checkpointed run (reads DIR/spec.json)")
    ap.add_argument("--population", default="", metavar="JSON",
                    help="population dynamics: a PopulationSpec as JSON, e.g. "
                         '\'{"initial": 2, "arrival_rate": 0.5, "departure_rate": 0.1, '
                         '"return_rate": 0.5, "seed": 0}\'')
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' for the CPU)")
    return ap


def _start_world(args) -> bool:
    """Refuse ``--devices``; with any process flag (or ``REPRO_COORDINATOR``)
    export the env schema and start the world. Returns whether one started."""
    from repro_torch.federated import distributed

    if args.devices:
        raise ValueError(
            f"--devices {args.devices}: a torch process drives one card; span "
            f"{args.devices} devices with {args.devices} processes: --coordinator "
            f"HOST:PORT --num-processes {args.devices} --process-id R and --mesh "
            f"silo={args.devices},multiprocess")
    return distributed.start_from_flags(args.coordinator, args.num_processes,
                                        args.process_id, device=args.device)


def _family_spec(name, kwargs_json):
    from repro_torch.core.family import FamilySpec

    if name is None:
        return None
    return FamilySpec(name, kwargs=json.loads(kwargs_json or "{}"))


def _async_cfg_from_args(args):
    if not args.async_mode:
        return None
    from repro_torch.federated.scheduler import AsyncConfig

    return AsyncConfig(buffer_size=args.buffer_size, staleness_decay=args.staleness_decay,
                       latency=args.latency, latency_scale=args.latency_scale,
                       latency_sigma=args.latency_sigma)


def _spec_from_args(args, algorithm: str):
    """The thin spec-builder: CLI flags -> ExperimentSpec."""
    from repro_torch.federated.api import (
        ExperimentSpec,
        ModelSpec,
        OptimizerSpec,
        RuntimeSpec,
    )
    from repro_torch.federated.population import PopulationSpec
    from repro_torch.federated.scheduler import Scenario
    from repro_torch.federated.strategy import StrategySpec
    from repro_torch.launch.mesh import MeshSpec

    strat_kwargs = json.loads(args.strategy_kwargs or "{}")
    scenario = Scenario(
        algorithm=algorithm, participation=args.participation, dropout=args.dropout,
        compression=args.compress, dp_noise=args.dp_noise, dp_clip=args.dp_clip,
        dp_delta=args.dp_delta, aggregator=args.aggregator, trim_frac=args.trim_frac,
        async_cfg=_async_cfg_from_args(args))
    return ExperimentSpec(
        model=ModelSpec(
            args.model, kwargs=json.loads(args.model_kwargs or "{}"),
            global_family=_family_spec(args.global_family, args.global_family_kwargs),
            local_family=_family_spec(args.local_family, args.local_family_kwargs)),
        scenario=scenario,
        strategy=StrategySpec(algorithm, strat_kwargs) if strat_kwargs else None,
        num_silos=args.silos,
        rounds=args.rounds if args.rounds is not None else 5,
        local_steps=args.local_steps,
        server_opt=OptimizerSpec("adam", args.lr),
        eta_mode=args.eta_mode,
        eval_every=args.eval_every,
        seed=args.seed,
        runtime=RuntimeSpec(wire=args.wire, mesh=MeshSpec.parse(args.mesh),
                            sanitize=args.sanitize),
        population=(PopulationSpec.from_dict(json.loads(args.population))
                    if args.population else None),
    )


def _log_round(total_silos: int):
    def log(r, m):
        eps = f"  eps={m['epsilon']:7.3f}" if "epsilon" in m else ""
        # Async flushes also report their simulated time and staleness.
        sim = (f"  t={m['sim_time']:8.2f}s  stale<={m['staleness']:.0f}"
               if "sim_time" in m else "")
        print(f"  round {r:3d}  elbo={m['elbo']:14.2f}  "
              f"up={m['bytes_up']:>9d}B  down={m['bytes_down']:>9d}B  "
              f"active={m['n_active']}/{total_silos}{sim}{eps}", flush=True)
    return log


def _report(exp) -> None:
    srv, spec = exp.server, exp.spec
    print(f"  total: {srv.comm.total:,} B in {srv.comm.rounds} rounds "
          f"({srv.comm.per_round:,.0f} B/round)")
    if srv.comm.sim_seconds:
        print(f"  simulated wall-clock: {srv.comm.sim_seconds:,.1f}s "
              f"({srv.comm.sim_seconds / max(srv.comm.rounds, 1):.2f}s/flush)")
    if exp.accountant is not None:
        delta = spec.scenario.dp_delta
        eps, order = exp.accountant.epsilon(delta)
        print(f"  privacy: ({eps:.3f}, {delta:g})-DP after "
              f"{exp.accountant.steps} exchanges (RDP order {order})")
    for k, v in exp.evaluate().items():
        print(f"  {k}: {v:.3f}")


def _checkpointing(exp, log, ckpt_dir, ckpt_every: int):
    """The round callback: log, and save every ``ckpt_every`` rounds to
    ``ckpt_dir`` (never at the last round, which the caller saves)."""
    def cb(r, metrics):
        log(r, metrics)
        if ckpt_dir and ckpt_every and (r + 1) % ckpt_every == 0 \
                and (r + 1) < exp.spec.rounds:
            exp.save(ckpt_dir)
    return cb


def _run_one(spec, bundle, device, ckpt_dir=None, ckpt_every: int = 0):
    """Build + run one spec against a pre-staged bundle; print a report."""
    from repro_torch.federated.api import build
    from repro_torch.federated.scheduler import algorithm_label

    exp = build(spec, bundle=bundle, device=device)
    sc = spec.scenario
    print(f"\n== {algorithm_label(spec.algorithm)}: {spec.model.name}, "
          f"J={spec.num_silos}, {spec.rounds} rounds x {spec.local_steps} local steps, "
          f"wire={exp.server.wire}, device={exp.server.device}"
          + (f", {sc.async_cfg.name}" if sc.async_cfg is not None else "")
          + (f", DP(z={sc.dp_noise:g}, C={sc.dp_clip:g})" if sc.dp_noise > 0 else "")
          + " ==", flush=True)
    t0 = time.time()
    exp.run(callback=_checkpointing(exp, _log_round(spec.num_silos), ckpt_dir, ckpt_every))
    print(f"  wall time: {time.time() - t0:.1f}s")
    if ckpt_dir:
        print(f"  checkpoint: {exp.save(ckpt_dir)}")
    _report(exp)
    return exp


def _run_sweep(args, base_spec, bundle, device) -> int:
    """One invocation, the whole scenario grid (ELBO / ε / bytes table)."""
    from repro_torch.federated.api import build, scenario_specs
    from repro_torch.federated.scheduler import scenario_matrix

    def floats(s):
        return tuple(float(x) for x in s.split(","))

    # --async adds the async axis (the sync rows stay for comparison; the
    # matrix drops the invalid async combinations).
    async_cfg = _async_cfg_from_args(args)
    grid = scenario_matrix(
        algorithms=["sfvi", "sfvi_avg"] if args.algo == "both" else [args.algo],
        participation=floats(args.sweep_participation),
        dropout=floats(args.sweep_dropout),
        compression=tuple(args.sweep_compress.split(",")),
        dp_noise=floats(args.sweep_dp_noise),
        dp_clip=args.dp_clip, dp_delta=args.dp_delta,
        async_cfgs=(None,) if async_cfg is None else (None, async_cfg))
    specs = scenario_specs(base_spec, grid)
    print(f"\n== scenario sweep: {base_spec.model.name}, J={base_spec.num_silos}, "
          f"{len(specs)} scenarios x {base_spec.rounds} rounds ==")
    rows = []
    for spec in specs:
        exp = build(spec, bundle=bundle, device=device)
        t0 = time.time()
        h = exp.run()
        dt = time.time() - t0
        eps = h["epsilon"][-1] if "epsilon" in h else float("inf")
        rows.append((spec.scenario.name, h["elbo"][-1], eps,
                     exp.comm.per_round / 1024, dt / spec.rounds))
    w = max(len(r[0]) for r in rows)
    print(f"  {'scenario':<{w}}  {'ELBO':>12}  {'eps':>8}  {'KiB/round':>10}  {'s/round':>8}")
    for name, elbo, eps, kib, spr in rows:
        eps_s = f"{eps:8.3f}" if eps != float("inf") else "     inf"
        print(f"  {name:<{w}}  {elbo:12.2f}  {eps_s}  {kib:10.1f}  {spr:8.2f}")
    return 0


def _resume(args, device) -> int:
    """Continue a checkpointed run from ``--resume DIR``; ``--rounds N``
    sets a new total budget."""
    from repro_torch.federated.api import Experiment, ExperimentSpec
    from repro_torch.launch.mesh import MeshSpec

    spec = ExperimentSpec.load(os.path.join(args.resume, "spec.json"))
    if args.rounds is not None:
        spec = dataclasses.replace(spec, rounds=args.rounds)
    if args.mesh:
        spec = dataclasses.replace(spec, runtime=dataclasses.replace(
            spec.runtime, mesh=MeshSpec.parse(args.mesh)))
    exp = Experiment.resume(args.resume, spec=spec, device=device)
    remaining = exp.remaining_rounds
    print(f"== resume: {spec.name} at round {exp.round}/{spec.rounds} "
          f"({remaining} remaining), wire={exp.server.wire}, "
          f"device={exp.server.device} ==", flush=True)
    if remaining:
        out = args.ckpt_dir or args.resume
        exp.run(callback=_checkpointing(exp, _log_round(spec.num_silos), out,
                                        args.ckpt_every))
        print(f"  checkpoint: {exp.save(out)}")
    _report(exp)
    return 0


def main(argv=None) -> int:
    """Run the requested spec(s) and assert the §3.2 byte ordering."""
    args = build_parser().parse_args(argv)
    if args.list_models:
        from repro_torch.models.paper.registry import list_models

        width = max(len(n) for n, _ in list_models())
        for name, desc in list_models():
            print(f"{name:<{width}}  {desc}")
        return 0
    if not _start_world(args):
        return _main(args)
    import torch.distributed as dist

    from repro_torch.federated import distributed

    try:
        with contextlib.ExitStack() as stack:
            if dist.get_rank() != 0:  # only the lead rank prints
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            return _main(args)
    finally:
        distributed.shutdown()


def _main(args) -> int:
    """The CLI's body, once the world (if any) is up."""
    from repro_torch.device import resolve_device
    from repro_torch.federated import distributed
    from repro_torch.federated.api import ExperimentSpec

    if args.spec:
        specs = [ExperimentSpec.load(args.spec)]
    else:
        if args.strategy:
            algos = [args.strategy]
        elif args.async_mode:
            algos = ["sfvi_avg"]
        elif args.algo == "both":
            algos = ["sfvi", "sfvi_avg"]
        else:
            algos = [args.algo]
        specs = [_spec_from_args(args, a) for a in algos]
    if args.dump_spec:
        if args.resume or len(specs) != 1:
            print("--dump-spec needs a single algorithm; pass --algo or --strategy "
                  "with one registered name", file=sys.stderr)
            return 2
        print(specs[0].to_json())
        return 0

    device = distributed.rank_device(resolve_device(args.device))
    if args.resume:
        return _resume(args, device)
    base = specs[0]
    data_seed = base.data_seed if base.data_seed is not None else base.seed
    bundle = get_model(base.model.name).build(
        data_seed, base.num_silos, device=device, **base.model.kwargs)
    if args.sweep:
        return _run_sweep(args, base, bundle, device)

    def ckpt_dir_for(spec):
        if not args.ckpt_dir:
            return None
        return args.ckpt_dir if len(specs) == 1 else os.path.join(args.ckpt_dir,
                                                                  spec.algorithm)

    exps = {s.algorithm: _run_one(s, bundle, device, ckpt_dir=ckpt_dir_for(s),
                                  ckpt_every=args.ckpt_every) for s in specs}
    if len(exps) == 2:
        sfvi_pr = exps["sfvi"].comm.per_round
        avg_pr = exps["sfvi_avg"].comm.per_round
        print(f"\nbytes/round: SFVI={sfvi_pr:,.0f}  SFVI-Avg={avg_pr:,.0f}  "
              f"(x{sfvi_pr / max(avg_pr, 1):.1f} reduction)")
        if base.local_steps > 1:
            assert avg_pr < sfvi_pr, "SFVI-Avg must ship strictly fewer bytes/round"
        else:
            assert avg_pr <= sfvi_pr, "SFVI-Avg must never ship more bytes/round than SFVI"
    return 0


if __name__ == "__main__":
    sys.exit(main())
