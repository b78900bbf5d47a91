#!/usr/bin/env python3
"""On-card smoke check of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and this checkout; imports nothing of JAX
and nothing of the JAX package. Phases, in order (any failure exits
non-zero):

  1. the card's name and power limit (``nvidia-smi``); build every CUDA
     kernel of the port from ``src/repro_torch/csrc`` with ``nvcc`` and
     print the build seconds;
  2. every kernel against its plain PyTorch version on the card, at the
     main path's shapes (J=10, P=100,354) and at ragged ones, with the
     tolerance printed beside the error; then the whole port on the card
     (fused wire, CUDA kernels) against the port on the CPU (flat wire,
     plain stages) on one injected random stream at a small width;
  3. the main path at full width: hier_bnn (in_dim 784, hidden 64,
     10 classes), J=10 silos of 200, K=4, through ``Server(wire="fused")``
     — SFVI 3 rounds, SFVI-Avg 3 rounds, SFVI-Avg + int8 + trimmed mean +
     DP 2 rounds, SFVI + int8 + trimmed mean 2 rounds — with the kernels'
     launch counters set to 0 just before each run and read just after,
     and the bytes per round checked; then 2 more rounds of each run under
     ``torch.profiler`` for the device's busy and idle share;
  4. timings (CUDA events, median of 20 single launches, each queued
     behind a sleep kernel so host overhead is excluded) of each kernel,
     its plain version and, where one exists, a single PyTorch call
     computing the same function, beside the bytes bound at 3.35 TB/s.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM f32, outside the tensor cores
MAIN_J, MAIN_P = 10, 100_354
SLEEP_CYCLES = 2_000_000
DEVICE = "cuda"  # every tensor of the check lives here


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def sync(torch) -> None:
    torch.cuda.synchronize()


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def upload_cases(torch, J, P, gen):
    x = torch.randn((J, P), generator=gen, device=DEVICE)
    noise = torch.randn((J, P), generator=gen, device=DEVICE)
    ref = 0.1 * torch.randn((P,), generator=gen, device=DEVICE)
    ones = torch.ones((J,), device=DEVICE)
    part = (torch.arange(J, device=DEVICE) % 3 != 1).float()
    # name -> kwargs of fused_upload
    return {
        "passthrough": dict(x=x, mask=ones),
        "mask_only": dict(x=x, mask=part),
        "quantize_only": dict(x=x, mask=part, quantize=True),
        "clip": dict(x=x, mask=ones, clip_norm=50.0),
        "clip_dp": dict(x=x, mask=part, noise=noise, clip_norm=0.3,
                        noise_multiplier=0.3),
        "ref_clip_dp": dict(x=x, mask=part, noise=noise, reference=ref,
                            clip_norm=0.3, noise_multiplier=0.3),
        "ref_passthrough": dict(x=x, mask=part, reference=ref),
        "ref_clip_dp_int8": dict(x=x, mask=part, noise=noise, reference=ref,
                                 clip_norm=0.3, noise_multiplier=0.3, quantize=True),
        "ref_clip_int8": dict(x=x, mask=ones, reference=ref, clip_norm=2.0,
                              quantize=True),
    }


def check_upload(torch, wire, ref, J, P, gen):
    worst = 0.0
    for name, kw in upload_cases(torch, J, P, gen).items():
        x = kw.pop("x")
        got = wire.fused_upload(x, **kw)
        want = ref.wire_upload_ref(x, **kw)
        sync(torch)
        if kw.get("quantize"):
            (q, s), (q0, s0) = got, want
            mism = int((q.int() != q0.int()).sum())
            step = int((q.int() - q0.int()).abs().max())
            s_rel = float(((s - s0).abs() / s0.abs()).max())
            err = float((q.float() * s[:, None] - q0.float() * s0[:, None]).abs().max())
            limit = max(1, (J * P) // 1000)
            print(f"  fused_upload {name:<18} ({J},{P}) int8 mismatches={mism} "
                  f"(<= {limit}, each <= 1: max {step}) scale_rel={s_rel:.2e} "
                  f"(<= 1e-6) dequant_max_abs={err:.3e}", flush=True)
            assert mism <= limit and step <= 1 and s_rel <= 1e-6, name
        else:
            err = float((got - want).abs().max())
            tol = 1e-5 * (1.0 + float(want.abs().max()))
            print(f"  fused_upload {name:<18} ({J},{P}) max_abs={err:.3e} "
                  f"(<= {tol:.1e})", flush=True)
            assert err <= tol, name
        worst = max(worst, err) if (J, P) == (MAIN_J, MAIN_P) else worst
    return worst


def combine_cases(torch, J, P, gen):
    x = torch.randn((J, P), generator=gen, device=DEVICE)
    ties = torch.round(2.0 * torch.randn((J, P), generator=gen, device=DEVICE)) / 2.0
    ones = torch.ones((J,), device=DEVICE)
    part = (torch.arange(J, device=DEVICE) % 3 != 1).float()
    frac = torch.linspace(0.0, 1.0, J, device=DEVICE) * (0.9 / J)
    zeros = torch.zeros((J,), device=DEVICE)
    one_active = torch.zeros((J,), device=DEVICE)
    one_active[J // 2] = 1.0
    two_active = torch.zeros((J,), device=DEVICE)
    two_active[0] = two_active[J - 1] = 1.0
    q = torch.randint(-127, 128, (J, P), generator=gen, device=DEVICE).to(torch.int8)
    s = torch.rand((J,), generator=gen, device=DEVICE) * 0.05 + 1e-3
    return {
        "mean_all": dict(x=x, w=ones),
        "mean_partial": dict(x=x, w=part),
        "mean_frac_below_1": dict(x=x, w=frac),
        "mean_all_zero": dict(x=x, w=zeros),
        "mean_int8": dict(x=q, w=part, scales=s),
        "trim_0.34_partial": dict(x=x, w=part, trim_frac=0.34),
        "trim_ties": dict(x=ties, w=ones, trim_frac=0.2),
        "trim_n0": dict(x=x, w=zeros, trim_frac=0.34),
        "trim_n1": dict(x=x, w=one_active, trim_frac=0.34),
        "trim_n2": dict(x=x, w=two_active, trim_frac=0.34),
        "trim_int8": dict(x=q, w=part, scales=s, trim_frac=0.1),
    }


def check_combine(torch, wire, ref, J, P, gen):
    worst = 0.0
    for name, kw in combine_cases(torch, J, P, gen).items():
        x, w = kw["x"], kw["w"]
        scales, tf = kw.get("scales"), kw.get("trim_frac")
        got = wire.fused_combine(x, w, scales=scales, trim_frac=tf)
        mat = ref.int8_rows_dequant_ref(x, scales) if scales is not None else x
        want = (ref.masked_weighted_mean_ref(mat, w) if tf is None
                else ref.masked_trimmed_mean_ref(mat, w, tf))
        sync(torch)
        err = float((got - want).abs().max())
        tol = 1e-5 * (1.0 + float(want.abs().max()))
        print(f"  fused_combine {name:<18} ({J},{P}) max_abs={err:.3e} (<= {tol:.1e})",
              flush=True)
        assert err <= tol, name
        worst = max(worst, err) if (J, P) == (MAIN_J, MAIN_P) else worst
    return worst


def check_trim_33(torch, wire, ref, gen):
    J, P = 33, 4099
    x = torch.round(torch.randn((J, P), generator=gen, device=DEVICE))
    w = (torch.arange(J, device=DEVICE) % 4 != 0).float()
    got = wire.fused_combine(x, w, trim_frac=0.2)
    want = ref.masked_trimmed_mean_ref(x, w, 0.2)
    sync(torch)
    err = float((got - want).abs().max())
    print(f"  fused_combine trim_J33_ties      ({J},{P}) max_abs={err:.3e} (<= 1e-5)",
          flush=True)
    assert err <= 1e-5


# ---------------------------------------------------------------------------
# Phase 2b: the port on the card (fused) against the port on the CPU (flat)
# ---------------------------------------------------------------------------


def injected_draws(np, torch, problem, J, P, seed):
    """draws(r, t) from numpy: one stream both sides consume."""
    from repro_torch.core.family import eps_shape

    def draws(r, t):
        rng = np.random.default_rng([seed, r, t])
        eps_G = rng.standard_normal(eps_shape(problem.global_family)).astype(np.float32)
        eps_L = rng.standard_normal(
            (J,) + eps_shape(problem.local_family)).astype(np.float32)
        noise = rng.standard_normal((J, P)).astype(np.float32)
        return torch.from_numpy(eps_G), torch.from_numpy(eps_L), torch.from_numpy(noise)

    return draws


def check_port_cuda_vs_cpu(np, torch):
    from repro_torch.device import generator
    from repro_torch.federated.aggregation import Int8Compressor, TrimmedMeanAggregator
    from repro_torch.federated.privacy import PrivacyPolicy
    from repro_torch.federated.runtime import Server
    from repro_torch.models.paper.registry import get_model
    from repro_torch.optim import adam
    from repro_torch.tree import tree_leaves, tree_map

    J, K = 3, 2
    bundle = get_model("hier_bnn").build(0, J, device="cpu", in_dim=16, hidden=8,
                                         train_per_silo=20)
    problem = bundle.problem
    eta_G0 = problem.global_family.init(generator(0, torch.device("cpu")))
    configs = {
        "sfvi": dict(strategy="sfvi"),
        "sfvi+int8+trimmed": dict(
            strategy="sfvi", compressor=Int8Compressor(),
            aggregator=TrimmedMeanAggregator(0.34)),
        "sfvi_avg+trimmed+dp": dict(
            strategy="sfvi_avg", aggregator=TrimmedMeanAggregator(0.34),
            privacy=PrivacyPolicy(clip_norm=0.3, noise_multiplier=0.3)),
    }
    for name, cfg in configs.items():
        servers = {}
        for dev, layout in (("cpu", "flat"), (DEVICE, "fused")):
            datas = [tree_map(lambda x, dev=dev: x.to(dev), d) for d in bundle.datas]
            servers[layout] = Server(problem, datas, {}, eta_G0, server_opt=adam(2e-2),
                                     local_opt=adam(2e-2), wire=layout, device=dev, **cfg)
        servers["fused"].state = tree_map(lambda x: x.to(DEVICE), servers["flat"].state)
        draws = injected_draws(np, torch, problem, J, servers["flat"].wire_spec().dim, 11)
        hist = {k: srv.run(3, local_steps=K, draws=draws) for k, srv in servers.items()}
        e_c = np.asarray(hist["flat"]["elbo_trace"])
        e_g = np.asarray(hist["fused"]["elbo_trace"])
        rel = float(np.max(np.abs(e_c - e_g) / np.abs(e_c)))
        diff = max(float((a.cpu() - b.cpu()).abs().max()) for a, b in zip(
            tree_leaves(servers["flat"].eta_G), tree_leaves(servers["fused"].eta_G),
            strict=True))
        print(f"  port {DEVICE}/fused vs cpu/flat [{name}] 3 rounds: elbo max_rel={rel:.2e} "
              f"(<= 1e-3), eta_G max_abs={diff:.2e} (<= 1e-3)", flush=True)
        assert np.all(np.isfinite(e_g)) and rel <= 1e-3 and diff <= 1e-3, name
        assert hist["flat"]["bytes_up"] == hist["fused"]["bytes_up"], name


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------


def profile_summary(prof, wall_s: float, top: int = 8) -> dict:
    """Device busy share and kernel time by name from a torch.profiler trace.

    Busy time is the union of the device events' intervals; the idle share
    is the rest of the host wall time of the traced rounds.
    """
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end_us, by_name = 0.0, float("-inf"), {}
    for start, end, name in spans:
        busy_us += max(0.0, end - max(start, end_us))
        end_us = max(end_us, end)
        total, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (total + end - start, calls + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "wall_s": wall_s, "device_busy_s": busy_us * 1e-6,
        "idle_share": 1.0 - busy_us * 1e-6 / wall_s,
        "device_events": len(spans),
        "top": [{"name": n[:80], "ms": t * 1e-3, "calls": c} for n, (t, c) in ranked],
    }


def profile_rounds(torch, srv, K, start_round, rounds=2) -> dict:
    """``rounds`` more rounds of ``srv`` under torch.profiler (CPU + CUDA)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.run(rounds, local_steps=K, start_round=start_round)
        sync(torch)
        wall = time.perf_counter() - t0
    return {"rounds": rounds, **profile_summary(prof, wall)}


def main_path(np, torch, wire, in_dim=784, hidden=64):
    from repro_torch.device import generator
    from repro_torch.federated.aggregation import Int8Compressor, TrimmedMeanAggregator
    from repro_torch.federated.privacy import PrivacyPolicy
    from repro_torch.federated.runtime import Server
    from repro_torch.models.paper.registry import get_model
    from repro_torch.optim import adam

    J, K = MAIN_J, 4
    bundle = get_model("hier_bnn").build(
        0, J, device=DEVICE, in_dim=in_dim, hidden=hidden, train_per_silo=200)
    problem = bundle.problem
    gdim, ldim = problem.model.global_dim, problem.model.local_dim
    P = 2 * gdim  # the wire row: eta_G = (mu, log_sigma); theta is empty
    print(f"  hier_bnn: global dim {gdim}, local dim {ldim}, wire P={P}, J={J}, K={K}",
          flush=True)
    assert P == MAIN_P
    # SFVI-Avg merges η_G as a barycenter: its two moment rows (mean, std)
    # go through the combine kernel, and no combined row is formed (θ = ∅).
    runs = [
        # (label, strategy, rounds, Server kwargs, bytes up per round,
        #  launches per round (upload, combine))
        ("sfvi", "sfvi", 3, {}, K * J * 4 * P, (K, K)),
        ("sfvi_avg", "sfvi_avg", 3, {}, J * 4 * P, (1, 2)),
        ("sfvi_avg+int8+trimmed+dp", "sfvi_avg", 2,
         dict(compressor=Int8Compressor(), aggregator=TrimmedMeanAggregator(0.1),
              privacy=PrivacyPolicy(clip_norm=0.3, noise_multiplier=0.3)),
         J * (P + 4), (1, 2)),
        # step cadence: int8 is dequantized inside the trimmed combine kernel
        ("sfvi+int8+trimmed", "sfvi", 2,
         dict(compressor=Int8Compressor(), aggregator=TrimmedMeanAggregator(0.1)),
         K * J * (P + 4), (K, K)),
    ]
    if P == 100_354:
        assert [r[4] for r in runs] == [16_056_640, 4_014_160, 1_003_580, 4_014_320]
    totals = {"fused_upload": 0, "fused_combine": 0}
    seconds, profiles = {}, {}
    for label, algo, rounds, extra, want_up, per_round in runs:
        srv = Server(problem, bundle.datas, bundle.theta0,
                     problem.global_family.init(generator(0, torch.device(DEVICE))),
                     num_obs=bundle.num_obs, server_opt=adam(2e-2),
                     local_opt=adam(2e-2), wire="fused", seed=0, strategy=algo,
                     device=DEVICE, **extra)
        assert srv.wire_spec().dim == MAIN_P
        stamps = []
        sync(torch)
        wire.reset_launches()
        t0 = time.perf_counter()
        h = srv.run(rounds, local_steps=K,
                    callback=lambda r, m: stamps.append(time.perf_counter()))
        sync(torch)
        counts = dict(wire.LAUNCHES)
        round_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
        seconds[label] = round_s
        print(f"  {label}: elbo={['%.2f' % e for e in h['elbo']]} "
              f"bytes_up={h['bytes_up']} launches={counts} "
              f"s/round={['%.4f' % s for s in round_s]}", flush=True)
        if "epsilon" in h:
            print(f"  {label}: epsilon={h['epsilon']}", flush=True)
        assert all(math.isfinite(e) for e in h["elbo_trace"]), label
        if not extra:
            assert h["elbo"][-1] > h["elbo"][0], f"{label}: ELBO did not rise"
        assert h["bytes_up"] == [want_up] * rounds, (label, h["bytes_up"])
        assert counts == {"fused_upload": per_round[0] * rounds,
                          "fused_combine": per_round[1] * rounds}, (label, counts)
        for k in totals:
            totals[k] += counts[k]
        eta = srv.eta_G
        assert eta["mu"].shape == (gdim,) and bool(torch.isfinite(eta["mu"]).all())
        profiles[label] = profile_rounds(torch, srv, K, start_round=rounds)
    return totals, seconds, profiles


# ---------------------------------------------------------------------------
# Phase 4: timings
# ---------------------------------------------------------------------------


def device_ms(torch, fn, reps=20, warmup=3):
    """Median device time of ``fn``'s launches, queued behind a sleep kernel."""
    for _ in range(warmup):
        fn()
    sync(torch)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timings(np, torch, wire, ref, gen):
    J, P = MAIN_J, MAIN_P
    x = torch.randn((J, P), generator=gen, device=DEVICE)
    noise = torch.randn((J, P), generator=gen, device=DEVICE)
    refrow = 0.1 * torch.randn((P,), generator=gen, device=DEVICE)
    ones = torch.ones((J,), device=DEVICE)
    q, s = wire.fused_upload(x, mask=ones, quantize=True)
    f4 = 4
    rows = []
    col = ones[:, None]
    uploads = {
        # mode: (kwargs, bytes moved: inputs read once + outputs written once,
        #        one PyTorch call computing the same function, or None)
        # SFVI: a masked copy (fallback 0) -> x * mask
        "sfvi": (dict(mask=ones), J * P * f4 * 2 + J * f4, lambda: x * col),
        # SFVI-Avg without clip: masked select of the reference -> lerp
        "sfvi_avg": (dict(mask=ones, reference=refrow),
                     J * P * f4 * 2 + P * f4 + J * f4,
                     lambda: torch.lerp(refrow, x, col)),
        # clip + DP + int8: no single PyTorch call
        "sfvi_avg_int8_dp": (dict(mask=ones, reference=refrow, noise=noise,
                                  clip_norm=0.3, noise_multiplier=0.3, quantize=True),
                             J * P * f4 * 2 + P * f4 + J * f4 + J * P + J * f4, None),
    }
    for mode, (kw, nbytes, library) in uploads.items():
        if library is not None:  # the yardstick computes the same function
            assert float((library() - wire.fused_upload(x, **kw)).abs().max()) <= 1e-6, mode
        flops = 12 * J * P
        rows.append(dict(
            name="fused_upload", mode=mode,
            ms=device_ms(torch, lambda kw=kw: wire.fused_upload(x, **kw)),
            plain_ms=device_ms(torch, lambda kw=kw: ref.wire_upload_ref(x, **kw)),
            library_ms=None if library is None else device_ms(torch, library),
            nbytes=nbytes, flops=flops))
    w = ones
    combines = {
        "mean": (dict(), x, J * P * f4 + J * f4 + P * f4, 2 * J * P),
        "trimmed_int8": (dict(scales=s, trim_frac=0.1), q,
                         J * P + 2 * J * f4 + P * f4,
                         int(J * math.ceil(math.log2(J))) * P + 2 * J * P),
    }
    for mode, (kw, mat, nbytes, flops) in combines.items():
        def plain(kw=kw, mat=mat):
            m = ref.int8_rows_dequant_ref(mat, kw["scales"]) if "scales" in kw else mat
            if "trim_frac" in kw:
                return ref.masked_trimmed_mean_ref(m, w, kw["trim_frac"])
            return ref.masked_weighted_mean_ref(m, w)

        library = None
        if mode == "mean":
            denom = torch.sum(w)
            library = device_ms(torch, lambda: torch.mv(x.T, w) / denom)
        rows.append(dict(
            name="fused_combine", mode=mode,
            ms=device_ms(torch, lambda kw=kw, mat=mat: wire.fused_combine(mat, w, **kw)),
            plain_ms=device_ms(torch, plain), library_ms=library,
            nbytes=nbytes, flops=flops))
    for row in rows:
        row["bound_ms"] = max(row["nbytes"] / HBM_BYTES_PER_S, row["flops"] / F32_FLOPS) * 1e3
        row["bound_by"] = ("bytes" if row["nbytes"] / HBM_BYTES_PER_S
                           >= row["flops"] / F32_FLOPS else "operations")
        print(json.dumps({"timing": row, "shape": [J, P]}), flush=True)
    return rows


def kernels_line(rows, launches, errors):
    """The ``kernels`` entries: each kernel's main-path row (its first timing)."""
    first = {r["name"]: r for r in reversed(rows)}
    lines = {"fused_upload": 137, "fused_combine": 242}
    return [{
        "name": name, "route": "cuda", "source": "src/repro_torch/csrc/wire.cu",
        "replaces": f"src/repro/kernels/wire.py:{line}",
        "launches": launches[name], "max_abs_err": errors[name],
        "ms": first[name]["ms"], "plain_ms": first[name]["plain_ms"],
        "bound_ms": first[name]["bound_ms"], "bound_by": first[name]["bound_by"],
        "library_ms": first[name]["library_ms"],
    } for name, line in lines.items()]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    if not (SRC / "repro_torch").is_dir():
        return fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build, ref, wire

    # Phase 1: the card, then the build.
    card = gpu_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    for name in build.SOURCES:
        build.build(name)
    print(f"build: {time.perf_counter() - t0:.1f}s for {sorted(build.SOURCES)}", flush=True)

    # Phase 2: kernels against their plain versions, then the port end to end.
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1234)
    print("phase 2: kernels vs plain versions", flush=True)
    err_up = check_upload(torch, wire, ref, MAIN_J, MAIN_P, gen)
    check_upload(torch, wire, ref, 7, 4099, gen)
    err_co = check_combine(torch, wire, ref, MAIN_J, MAIN_P, gen)
    check_combine(torch, wire, ref, 7, 4099, gen)
    check_trim_33(torch, wire, ref, gen)
    check_port_cuda_vs_cpu(np, torch)

    # Phase 3: the main path at full width.
    print("phase 3: main path, hier_bnn at full width", flush=True)
    totals, seconds, profiles = main_path(np, torch, wire)
    for label, round_s in seconds.items():
        print(json.dumps({"s_per_round": label, "rounds": round_s,
                          "median_after_first": statistics.median(round_s[1:])}),
              flush=True)
        print(json.dumps({"profile": label, **profiles[label]}), flush=True)

    # Phase 4: timings.
    print("phase 4: timings", flush=True)
    rows = timings(np, torch, wire, ref, gen)
    kernels = kernels_line(rows, totals, {"fused_upload": err_up, "fused_combine": err_co})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
