#!/usr/bin/env python3
"""On-card smoke check of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and this checkout; imports nothing of JAX
and nothing of the JAX package. Phases, in order (any failure exits
non-zero):

  1. the card's name and power limit (``nvidia-smi``); build every CUDA
     kernel of the port from ``src/repro_torch/csrc`` (six sources) with
     ``nvcc``, one process per source, all started together, and print the
     build seconds; check that float32 matmuls run in full float32 (no TF32);
  2. every kernel against its plain PyTorch version on the card, with the
     tolerance printed beside the error: the wire kernels at the hier_bnn
     main path's shapes (J=10, P=100,354), at the paper models' (the smoke
     config's (4, 3,942), multinomial's (25, 15,702), ProdLDA's (3, 84,002):
     P % 4 = 2, and J = 25 the combine's passes of 16 rows) and at ragged
     ones (the upload in every mode also at P % 4 != 0, P below one chunk,
     J = 1 and 64, P % 4 == 0 and x off 16-byte alignment); the
     Newton–Schulz step at d from 1 to 1,970; the whole 40-step square
     root (one launch of the root kernel up to the wrapper's limit d, 40
     step calls past it) at d from 1 to the limit + 1, and against the 40
     step calls at the path's (2, 5) and (6, 5). The combine at the main
     path's shapes, the barycenter's (10, 50,177), glmm's (2, 5), (2, 20)
     and (6, 20) with trim 0.2, P % 4 = 1, 2, 3, odd P in int8, J = 33
     and 64 trimmed and x one element off 16 bytes, each case run twice
     (bit-identical), and its shared-memory plan against the source's.
     The reparam + STL forward at N = 1, 7, 4,097, 50,177 and 508,160 in
     f32 and bf16, on aligned inputs (16-byte vectors) and views one
     element off (the scalar route): z and logq against the plain version,
     logq against the float64 sum and bit-identical over two calls back
     to back (the ticket was reset), then calls on two streams at once;
     the backward at the same N. Then the whole port
     on the card (fused wire, CUDA kernels) against the port on the CPU
     (flat wire, plain stages) on one injected random stream: hier_bnn at
     a small width, the GLMM + Cholesky global family at full width,
     multinomial at the smoke config's width (in_dim 196, J = 4) and
     ProdLDA at a small vocab (200 words, 8 topics, J = 3), each SFVI and
     SFVI-Avg (θ and η_G held). Then the
     backbone's kernels against their plain versions in bf16 and f32:
     flash attention (bf16 on the tensor-core kernel with one and with two
     warpgroups a block, each bf16 output also element by element within
     2^-7 of itself + 2^-6 of its row's rms; f32 on the SIMT kernel; the
     launch counters show which ran) at zamba2's (B, S, H/KV, hd) = (8, 64, 32/32, 112) and
     (4, 4,096, 32/32, 112), qwen3's (8, 512, 32/8, 128), a decode shape
     (Sq = 1, q_offset), window 128, non-causal and S = 1,000, and in bf16
     at hd 64, 80, 100, 256, as strided views of a packed tensor (aligned
     and one element off), and with q tiles or rows without a live key;
     the tensor-core kernel's shared-memory plan against the wrapper's; GLA at
     (8, 64) and (4, 4,096) x 112 heads x 64/64 (q, k a stride-0 group as
     mamba2 gives them), S = 1,000 and dv = 65 (bf16 on the tensor-core
     kernel, 64 columns of dv a block, so dv = 65 takes two; each output also
     element by element within 2^-7 of itself + 2^-6 of its row's rms; f32 on the SIMT
     kernel; both routes' final state within 1e-4 / 1e-5 relative
     Frobenius of the plain state; its shared-memory plan against the
     wrapper's); RMSNorm at D = 3,584,
     7,168, 2,560 and 128 with ragged row counts and rows at scales 2^-4
     to 2^4, on 16-byte vectors and, with x one element off 16 bytes, on
     the scalar route, each bf16 output also element by element within
     one bf16 step of the plain value, and on plans where a few blocks
     walk many rows of two to eight warps at scales 2^-12 to 2^12
     (``RMS_WALKS``, 20 launches each). And the backbone on the
     card against the backbone on the CPU in f32: zamba2-7b at full width
     with one hybrid unit (6 layers), B = 2, prompt 32, greedy gen 4;
  3. the main paths at full width, each through ``Server(wire="fused")``
     with the kernels' launch counters set to 0 just before each run and
     read just after, and the bytes per round checked:
       hier_bnn (in_dim 784, hidden 64, 10 classes), J=10 silos of 200,
       K=4 — SFVI 3 rounds, SFVI-Avg 3 rounds, SFVI-Avg + int8 + trimmed
       mean + DP 2 rounds, SFVI + int8 + trimmed mean 2 rounds;
       the paper's GLMM (six cities, 536 children), J=2, K=25, Cholesky
       global family — SFVI 3 rounds, SFVI-Avg 3 rounds (100 launches
       of the square-root kernel a round, no step call); and J=6 (89
       children a silo), rank-2
       low-rank global family, unitriangular conditional local family,
       SFVI-Avg + trimmed mean (0.2) 2 rounds;
       multinomial regression (S3.2) at Table S1's small-silo width
       (in_dim 784, 10 classes, J=25 silos of 200, K=25; θ = (log σ_W,
       log σ_b), so SFVI-Avg forms the combined wire row as well as the
       barycenter's two moment rows: 3 combines a round) — SFVI 3 rounds,
       SFVI-Avg 3 rounds;
       the benchmark smoke config (multinomial, in_dim 196, J=4 silos of
       60, K=4, lr 0.02, 25 rounds) — SFVI, SFVI-Avg, SFVI-Avg + int8,
       SFVI-Avg + DP (z 0.3, C 0.3), with bytes up + down a round of
       504,576, 126,144, 78,856 and 126,144 and the DP row's ε after 25
       rounds within 1e-4 of 289.2907;
       hetero_mn at its registry defaults (240 samples in Dirichlet(0.5)
       silos, in_dim 196, J=4, K=4) — SFVI-Avg + int8 + DP 2 rounds;
       ProdLDA (§4.2: vocab 2,000, 21 topics, J=3 silos of 400 documents)
       — SFVI K=25 3 rounds, SFVI-Avg K=50 2 rounds;
     each model's eval line (accuracy, coherence) after its runs;
     then 2 more rounds of each run under ``torch.profiler`` for the
     device's busy and idle share. Then the backbone's serve path
     (``repro_torch.launch.serve_backbone.serve``) at full width in bf16,
     with the flash-attention, GLA and RMSNorm launch counters set to 0
     just before each run and read just after (every bf16 flash and GLA
     call on the tensor-core kernels, none on the SIMT ones; no prefill
     calls ``gla_final_state``, mamba2's state comes from the GLA kernel):
     zamba2-7b at full depth (81 layers; batch 8, prompt 64, gen 32, 4
     silos: the JAX CLI's defaults),
     zamba2-7b at 12 layers (batch 4, prompt 4,096, gen 8), qwen3-4b at 4
     layers (batch 8, prompt 512, gen 16); prefill and decode times, peak
     memory, then one more prefill and two more decode steps under
     ``torch.profiler``;
  4. timings of each kernel, its plain version and, where one exists,
     PyTorch's own call(s) computing the same function (the upload and
     the mean combine also at multinomial's (25, 15,702) and ProdLDA's
     (3, 84,002)): ``ms`` (CUDA
     events, median of 20 single launches, each queued behind a sleep
     kernel so host overhead is excluded; the inputs stay in L2 between
     launches) and, for the kernel and the library call, ``run_ms`` (one
     event pair around 64 launches back to back over copies of the inputs
     that together exceed the 50 MB L2, divided by 64; none for a single
     launch over 1 ms, nor for the square root's 40-call step route), and
     an empty kernel's two times (``torch.cuda._sleep(0)``), the launch
     floor; beside the bound: the larger of bytes
     at 3.35 TB/s and operations at 67 TFLOP/s for float32 inputs, at
     989 TFLOP/s (bf16 dense tensor cores) for bfloat16 inputs. The
     backbone's kernels at their serve shapes: flash attention (the
     tensor-core kernel with one and two warpgroups a block) against
     ``F.scaled_dot_product_attention``, RMSNorm against ``F.rms_norm``
     and a device copy of x (and, at decode's (8, 3,584), both calls'
     host time), GLA (with and without the final state) against no
     library call; the square root at the
     path's shapes and the wrapper's limit d against the 40 step calls it
     replaced (device and host wall time), and the step route one past the
     limit and at d = 64.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. ``python3 chip_smoke.py --timings``
runs phases 1 and 4 alone (to time two checkouts in turns in one call).

    python3 chip_smoke.py --mutants
    python3 chip_smoke.py --gla-mutants

build broken copies of a kernel, each in a copy of ``src/repro_torch``
under ``build/``, run that kernel's phase-2 check on each and on the
unchanged source (``--check GROUP``, one process each, all started
together), and exit 0 only when every mutant fails its check and every
unchanged source passes. ``--mutants``: the combine (``COMBINE_MUTANTS``:
the tile barrier removed, each row's alignment taken from row 0's address,
``rank < n - k`` as ``rank <= n - k``, every row dequantized with row 0's
scale), the reparam forward (``REPARAM_MUTANTS``: the ticket never reset,
the tail skipped, the last block's own partial left out) and RMSNorm
(``RMS_MUTANTS``: the partials not double-buffered). ``--gla-mutants``:
the GLA tensor-core kernel (``GLA_MUTANTS``: a chunk's state update
skipped, the ``cp.async`` wait removed, the chunk barrier removed, a
wrong dv-slice offset, the S_in copy written into the one being read).
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM f32, outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 dense tensor cores (NVIDIA data sheet)
MAIN_J, MAIN_P = 10, 100_354
GLMM_CHILDREN, GLMM_J, GLMM_K = 536, 2, 25
NS_ROOTS_PER_MERGE = 50 * 2  # fixed-point steps x (root + batched roots), one launch each
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


# (J, P) of the upload checks besides the main path's: ragged P (P % 4 != 0,
# P smaller than one chunk), one row, many rows, P % 4 == 0 (float4 loads).
UPLOAD_SHAPES = [(7, 4099), (3, 5), (10, 1003), (1, MAIN_P), (64, 20_002), (16, 65_536)]
# The paper models' wire rows (θ's 2 floats beside η_G = (mu, log_sigma)):
# the benchmark smoke config's multinomial (in_dim 196), multinomial at
# Table S1's width (in_dim 784, J = 25) and ProdLDA at §4.2's (2 x 21 x 2,000).
PAPER_SHAPES = [(4, 3942), (25, 15_702), (3, 84_002)]


def check_upload(torch, wire, ref, J, P, gen, offset=0):
    """Every upload mode at (J, P) against the plain version; ``offset``
    floats shift x off 16-byte alignment (the kernel then loads scalars)."""
    worst = 0.0
    C, chunk = wire._upload_plan(J, P)
    print(f"  fused_upload plan ({J},{P}): C={C} chunks of {chunk} floats, "
          f"{J * C} blocks", flush=True)
    for name, kw in upload_cases(torch, J, P, gen).items():
        x = kw.pop("x")
        if offset:
            buf = torch.empty((J * P + offset,), device=DEVICE)
            x = buf[offset:].view(J, P).copy_(x)
            assert x.data_ptr() % 16 and x.is_contiguous()
            name = f"{name}+{offset}"
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
        "trim_0.2": dict(x=x, w=ones, trim_frac=0.2),
        "trim_ties": dict(x=ties, w=ones, trim_frac=0.2),
        "trim_n0": dict(x=x, w=zeros, trim_frac=0.34),
        "trim_n1": dict(x=x, w=one_active, trim_frac=0.34),
        "trim_n2": dict(x=x, w=two_active, trim_frac=0.34),
        "trim_int8": dict(x=q, w=part, scales=s, trim_frac=0.1),
    }


def _shifted(torch, x, offset):
    """A contiguous copy of ``x`` that starts ``offset`` elements into a buffer
    (off 16-byte alignment for an offset that is not a multiple of 16 bytes)."""
    buf = torch.empty((x.numel() + offset,), dtype=x.dtype, device=DEVICE)
    out = buf[offset:].view(x.shape).copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


def check_combine(torch, wire, ref, J, P, gen, offset=0):
    """Every combine case at (J, P) against the plain version, each run twice
    (bit-identical); ``offset`` elements shift x (f32 or int8) off 16-byte
    alignment. Returns the largest error at the main path's shape."""
    worst = 0.0
    for name, kw in combine_cases(torch, J, P, gen).items():
        x, w = kw["x"], kw["w"]
        if offset:
            x = _shifted(torch, x, offset)
            name = f"{name}+{offset}"
        scales, tf = kw.get("scales"), kw.get("trim_frac")
        got = wire.fused_combine(x, w, scales=scales, trim_frac=tf)
        again = wire.fused_combine(x, w, scales=scales, trim_frac=tf)
        mat = ref.int8_rows_dequant_ref(x, scales) if scales is not None else x
        want = (ref.masked_weighted_mean_ref(mat, w) if tf is None
                else ref.masked_trimmed_mean_ref(mat, w, tf))
        sync(torch)
        err = float((got - want).abs().max())
        tol = 1e-5 * (1.0 + float(want.abs().max()))
        same = bool(torch.equal(got, again))
        print(f"  fused_combine {name:<20} ({J},{P}) max_abs={err:.3e} (<= {tol:.1e}), "
              f"repeat bit-identical={same}", flush=True)
        assert err <= tol and same, name
        worst = max(worst, err) if (J, P) == (MAIN_J, MAIN_P) and not offset else worst
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


# (J, P) of the combine checks besides the main path's: the barycenter's
# moment rows, glmm's rows (J = 2 and J = 6 with trim 0.2), P % 4 = 1, 2
# and 3 (the rows after the first start 4, 8 or 12 bytes off 16), odd P for
# int8, P below one tile, one row, J = 16 (the largest in registers), and
# J = 20, 33, 64 and 1,024 (the trimmed mean's staged route, 1,024 with
# more than 48 KB of shared memory). At (64, 50,177) a tile is 128
# columns, so warps other than warp 0, which finds n and k, read the tile
# and the scalars: only the tile barrier makes them wait, and the cases
# before leave other n, k and rows in shared memory.
COMBINE_SHAPES = [(7, 4099), (10, 50_177), (2, 5), (2, 20), (6, 20), (5, 4097), (3, 4098),
                  (1, 7), (16, 515), (20, 777), (33, 1001), (64, 50_177),
                  (1024, 48)] + PAPER_SHAPES


def check_combine_plan(torch, wire):
    """The staged trim's shared-memory plan equals the source's and fits, at
    the checked shapes of more than ``DIRECT_ROWS`` rows and the largest J;
    the direct routes use none."""
    lib = wire._lib()
    lib.repro_trim_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.repro_trim_smem_bytes.restype = ctypes.c_longlong
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(MAIN_J, MAIN_P)] + COMBINE_SHAPES + [(32, 5000), (wire.MAX_TRIM_ROWS, 5000)]
    for J, P in shapes:
        for elt in (4, 1):
            plan = wire.combine_plan(J, P, elt, True, sms)
            if J <= wire.DIRECT_ROWS:
                assert plan.smem_bytes == 0, (J, P, plan)
                continue
            got = lib.repro_trim_smem_bytes(J, plan.tile_cols, elt)
            assert got == plan.smem_bytes <= wire.SMEM_LIMIT, (J, P, elt, plan)
    for J, P, elt, trimmed in [(MAIN_J, MAIN_P, 4, False), (MAIN_J, MAIN_P, 1, True),
                               (10, 50_177, 4, False), (64, 999, 4, True)]:
        print(f"  fused_combine plan ({J},{P}) {'int8' if elt == 1 else 'f32'} "
              f"{'trimmed' if trimmed else 'mean'}: {wire.combine_plan(J, P, elt, trimmed, sms)}",
              flush=True)
    print(f"  fused_combine staged-trim smem plan: {len(shapes)} shapes x f32/int8 agree with "
          f"the source (<= {wire.SMEM_LIMIT})", flush=True)


def check_combine_all(torch, wire, ref, gen):
    """The combine kernel's card checks; returns the largest error at the
    main path's shape."""
    check_combine_plan(torch, wire)
    worst = check_combine(torch, wire, ref, MAIN_J, MAIN_P, gen)
    for J, P in COMBINE_SHAPES:
        check_combine(torch, wire, ref, J, P, gen)
    for J, P in [(MAIN_J, MAIN_P), (7, 4099)]:
        check_combine(torch, wire, ref, J, P, gen, offset=1)
    check_trim_33(torch, wire, ref, gen)
    return worst


NS_SHAPES = [(1, 1), (1, 5), (2, 5), (6, 5), (10, 5), (1, 64), (3, 65), (1, 257), (1, 1970)]
REPARAM_NS = [1, 7, 4097, 50_177, 508_160]  # 508,160 = hier_bnn's J x local dim
NS_PATH_SHAPES = [(1, 5), (2, 5), (6, 5)]  # the barycenter's roots: J = 2 and J = 6


def ns_root_shapes(wire):
    """(B, d) of the root checks: the path's, small and ragged ones, and the
    wrapper's limit d (the root kernel) and limit + 1 (the step route)."""
    lim = wire.NS_ROOT_MAX_D
    return sorted({(1, 1), (1, 5), (2, 5), (6, 5), (10, 5), (1, 64), (3, 65), (1, lim),
                   (3, lim + 1)}, key=lambda s: (s[1], s[0]))


def spd_batch(torch, B, d, gen):
    a = torch.randn((B, d, d), generator=gen, device=DEVICE)
    return a @ a.mT / d + 0.1 * torch.eye(d, device=DEVICE)


def check_ns_step(torch, wire, ref, gen):
    """The step kernel and the root kernel against their plain versions;
    returns the largest error of each (the root's at the path's shapes)."""
    worst = {"newton_schulz_step": 0.0, "sqrtm_newton_schulz": 0.0}
    for B, d in NS_SHAPES:
        y = torch.randn((B, d, d), generator=gen, device=DEVICE) / math.sqrt(d)
        z = torch.randn((B, d, d), generator=gen, device=DEVICE) / math.sqrt(d)
        got = wire.newton_schulz_step(y, z)
        want = ref.newton_schulz_step_ref(y, z)
        sync(torch)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want, strict=True))
        tol = 1e-5 * (1.0 + max(float(b.abs().max()) for b in want))
        print(f"  newton_schulz_step ({B},{d},{d}) max_abs={err:.3e} (<= {tol:.1e})",
              flush=True)
        assert err <= tol, (B, d)
        worst["newton_schulz_step"] = max(worst["newton_schulz_step"], err)
    lib = wire._ns_lib()
    lib.repro_ns_root_smem_bytes.argtypes = [ctypes.c_int]
    lib.repro_ns_root_smem_bytes.restype = ctypes.c_longlong
    lim = wire.NS_ROOT_MAX_D
    assert all(lib.repro_ns_root_smem_bytes(d) == wire.ns_root_smem_bytes(d)
               for d in range(1, lim + 2))
    assert wire.ns_root_smem_bytes(lim) <= wire.SMEM_LIMIT
    # The entry itself refuses d past the limit (cudaErrorInvalidValue).
    past = torch.empty((1, lim + 1, lim + 1), device=DEVICE)
    refused = lib.repro_sqrtm_newton_schulz(past.data_ptr(), past.data_ptr(), 1, lim + 1, 1,
                                            torch.cuda.current_stream().cuda_stream)
    assert refused != 0, refused
    print(f"  sqrtm_newton_schulz smem plan: d 1..{lim + 1} agree with the source; "
          f"{wire.ns_root_smem_bytes(lim)} bytes at the wrapper's limit d = {lim} "
          f"(<= {wire.SMEM_LIMIT}); the entry refuses d = {lim + 1} (error {refused})",
          flush=True)
    # The whole 40-step root: one launch of the root kernel up to the
    # wrapper's limit d, 40 step calls past it (the launch counters say which).
    for B, d in ns_root_shapes(wire):
        spd = spd_batch(torch, B, d, gen)
        before = dict(wire.LAUNCHES)
        got = wire.sqrtm_newton_schulz_fused(spd, num_iters=40)
        sync(torch)
        launched = {k: wire.LAUNCHES[k] - before[k] for k in ("sqrtm_newton_schulz",
                                                              "newton_schulz_step")}
        want = ref.newton_schulz_sqrtm_ref(spd, 40)
        rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
        resid = float((got @ got - spd).abs().max())
        root = d <= wire.NS_ROOT_MAX_D
        route = "root kernel, 1 launch" if root else "step route, 40 step calls"
        print(f"  sqrtm_newton_schulz_fused ({B},{d},{d}) 40 steps [{route}]: rel_fro={rel:.3e} "
              f"(<= 1e-4); |root^2 - A|_max={resid:.2e}", flush=True)
        assert launched == ({"sqrtm_newton_schulz": 1, "newton_schulz_step": 0} if root
                            else {"sqrtm_newton_schulz": 0, "newton_schulz_step": 40}), launched
        assert rel <= 1e-4 and bool(torch.isfinite(got).all()), (B, d)
        if (B, d) in NS_PATH_SHAPES:
            worst["sqrtm_newton_schulz"] = max(worst["sqrtm_newton_schulz"],
                                               float((got - want).abs().max()))
    # Against the route the barycenter took before the root kernel: 40 step
    # calls around the plain normalization. Only the norm's rounding differs.
    for B, d in [(2, 5), (6, 5)]:
        spd = spd_batch(torch, B, d, gen)
        got = wire.sqrtm_newton_schulz_fused(spd, num_iters=40)
        steps = ref.newton_schulz_sqrtm_ref(spd, 40, step=wire.newton_schulz_step)
        sync(torch)
        rel = float(torch.linalg.norm(got - steps) / torch.linalg.norm(steps))
        print(f"  sqrtm_newton_schulz_fused ({B},{d},{d}) root kernel vs 40 step calls: "
              f"rel_fro={rel:.3e} (<= 1e-6)", flush=True)
        assert rel <= 1e-6, (B, d)
    return worst


def reparam_inputs(torch, n, dtype, gen, shift=0):
    """mu, ls, eps, dz of ``n`` elements; ``shift`` elements into their
    buffers puts each off 16-byte alignment (the scalar route)."""
    mu, ls, eps, dz = (torch.randn((n,), generator=gen, device=DEVICE) for _ in range(4))
    out = [mu.to(dtype), (0.3 * ls - 1.0).to(dtype), eps.to(dtype), dz.to(dtype)]
    return [_shifted(torch, t, shift) if shift else t for t in out]


def logq_f64(torch, ls, eps):
    """The float64 log q and the float64 sum of its terms' magnitudes, the
    scale of a float32 sum's rounding. A sum near 0 has no relative error
    worth the name (at N = 1 the float32 ½ log 2π alone is 1.6e-8 off), so
    1 % of that scale floors the denominator there; a large sum keeps
    |sum| as its own."""
    e, l = eps.double(), ls.double()
    half_log_2pi = 0.5 * math.log(2.0 * math.pi)
    terms = -0.5 * e * e - l - half_log_2pi
    scale = (0.5 * e * e).sum() + l.abs().sum() + half_log_2pi * e.numel()
    return float(terms.sum()), float(scale)


def check_reparam_fwd(torch, reparam, ref, n, dtype, gen, shift):
    """One forward check: z against the plain version, logq against it and
    the float64 sum, two calls back to back bit-identical (the ticket was
    reset); returns z's error."""
    mu, ls, eps, _ = reparam_inputs(torch, n, dtype, gen, shift)
    plan = reparam.reparam_plan(n, mu.element_size(), shift == 0)
    assert all(t.data_ptr() % 16 == 0 for t in (mu, ls, eps)) == (shift == 0)
    z, lq = reparam.reparam_fwd(mu, ls, eps)
    z2, lq2 = reparam.reparam_fwd(mu, ls, eps)
    z0, lq0 = ref.reparam_stl_ref(mu, ls, eps)
    sync(torch)
    assert z.dtype == dtype and lq.dtype == torch.float32
    err = float((z.float() - z0.float()).abs().max())
    tol = 1e-5 * (1.0 + float(z0.float().abs().max()))
    exact, scale = logq_f64(torch, ls, eps)
    rel = abs(float(lq) - float(lq0)) / abs(float(lq0))
    rel64 = abs(float(lq) - exact) / max(abs(exact), 1e-2 * scale)
    same = bool(torch.equal(lq, lq2) and torch.equal(z, z2))
    route = f"vec {plan.vec}" if plan.vec > 1 else "scalar, 1 elt off"
    print(f"  reparam_stl fwd N={n} {str(dtype)[6:]:<8} [{route}, grid {plan.grid}]: "
          f"z max_abs={err:.3e} (<= {tol:.1e}), logq rel={rel:.2e} vs plain, {rel64:.2e} vs "
          f"f64 (of max(|sum|, 1% of the terms' |sum|), <= 1e-5), two calls bit-identical={same}", flush=True)
    assert err <= tol and rel <= 1e-5 and rel64 <= 1e-5 and same, (n, dtype, shift)
    return err


def check_reparam_streams(torch, reparam, ref, gen):
    """Calls on two streams at once, twice each: each logq right, so neither
    stream's ticket was taken by the other's blocks."""
    sets = [reparam_inputs(torch, n, torch.float32, gen)[:3] for n in (508_160, 50_177)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    sync(torch)
    outs = [[], []]
    for _ in range(2):
        for i, (st, ins) in enumerate(zip(streams, sets, strict=True)):
            with torch.cuda.stream(st):
                outs[i].append(reparam.reparam_fwd(*ins))
    sync(torch)
    for i, ins in enumerate(sets):
        exact, _ = logq_f64(torch, ins[1], ins[2])  # large sums: no cancellation
        _, lq0 = ref.reparam_stl_ref(*ins)
        for z, lq in outs[i]:
            rel = abs(float(lq) - exact) / abs(exact)
            assert rel <= 1e-5 and abs(float(lq) - float(lq0)) <= 1e-5 * abs(float(lq0)), (i, rel)
        assert torch.equal(outs[i][0][1], outs[i][1][1])
    print(f"  reparam_stl fwd on two streams at once, twice each (N = 508,160 and 50,177): "
          f"logq right and repeated bit for bit on each", flush=True)


def check_reparam(torch, reparam, ref, gen):
    """Forward and backward kernels against the plain versions, f32 and bf16;
    returns the largest elementwise error of each."""
    worst = {"reparam_stl_fwd": 0.0, "reparam_stl_bwd": 0.0}
    for n in REPARAM_NS:
        for dtype in (torch.float32, torch.bfloat16):
            for shift in (0, 1):
                err = check_reparam_fwd(torch, reparam, ref, n, dtype, gen, shift)
                worst["reparam_stl_fwd"] = max(worst["reparam_stl_fwd"], err)
            _, ls, eps, dz = reparam_inputs(torch, n, dtype, gen)
            dlq = torch.tensor(0.37, device=DEVICE)
            grads = reparam.reparam_bwd(ls, eps, dz, dlq)
            grads0 = ref.reparam_stl_bwd_ref(ls, eps, dz, dlq)
            sync(torch)
            berr = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(grads, grads0, strict=True))
            btol = 1e-5 * (1.0 + max(float(b.float().abs().max()) for b in grads0))
            print(f"  reparam_stl bwd N={n} {str(dtype)[6:]}: max_abs={berr:.3e} "
                  f"(<= {btol:.1e})", flush=True)
            assert berr <= btol, (n, dtype)
            worst["reparam_stl_bwd"] = max(worst["reparam_stl_bwd"], berr)
    check_reparam_streams(torch, reparam, ref, gen)
    # The autograd.Function launches both kernels on CUDA tensors.
    before = dict(reparam.LAUNCHES)
    mu = torch.randn((4097,), generator=gen, device=DEVICE, requires_grad=True)
    ls = torch.full((4097,), -1.0, device=DEVICE, requires_grad=True)
    eps = torch.randn((4097,), generator=gen, device=DEVICE)
    z, lq = reparam.reparam_stl(mu, ls, eps)
    (z.square().sum() + lq).backward()
    sync(torch)
    assert reparam.LAUNCHES["reparam_stl_fwd"] == before["reparam_stl_fwd"] + 1
    assert reparam.LAUNCHES["reparam_stl_bwd"] == before["reparam_stl_bwd"] + 1
    dls0 = (2.0 * z.detach() * torch.exp(ls.detach()) * eps - 1.0)
    assert float((ls.grad - dls0).abs().max()) <= 1e-4
    print("  reparam_stl autograd.Function on CUDA: forward + backward kernels, "
          "d log_sigma matches the formula", flush=True)
    return worst


# ---------------------------------------------------------------------------
# Phase 2b: the port on the card (fused) against the port on the CPU (flat)
# ---------------------------------------------------------------------------


def injected_draws(np, torch, problem, J, P, seed):
    """draws(r, t) from numpy: one stream both sides consume (no ε_L when
    the model has no local latents)."""
    from repro_torch.core.family import eps_shape

    def draws(r, t):
        rng = np.random.default_rng([seed, r, t])
        eps_G = rng.standard_normal(eps_shape(problem.global_family)).astype(np.float32)
        eps_L = None
        if problem.model.has_local:
            eps_L = torch.from_numpy(rng.standard_normal(
                (J,) + eps_shape(problem.local_family)).astype(np.float32))
        noise = rng.standard_normal((J, P)).astype(np.float32)
        return torch.from_numpy(eps_G), eps_L, torch.from_numpy(noise)

    return draws


def glmm_bundle(J, children, global_family, local_family=None):
    """The GLMM staged on the CPU with the given FamilySpecs applied."""
    from repro_torch.core.family import FamilySpec
    from repro_torch.models.paper.registry import apply_family_spec, get_model

    bundle = get_model("glmm").build(0, J, device="cpu", num_children=children)
    return apply_family_spec(
        bundle, global_family=FamilySpec(*global_family),
        local_family=None if local_family is None else FamilySpec(*local_family))


def compare_cuda_vs_cpu(np, torch, label, bundle, configs, K, seed):
    """Each config 3 rounds on one injected stream: the port on the card
    (fused wire, CUDA kernels) against the port on the CPU (flat wire,
    plain stages). Holds the ELBO to 1e-3 relative and θ and η_G to 1e-3,
    both absolute and relative to each leaf's largest entry."""
    from repro_torch.device import generator
    from repro_torch.federated.runtime import Server
    from repro_torch.optim import adam
    from repro_torch.tree import tree_leaves, tree_map

    problem = bundle.problem
    J = len(bundle.datas)
    eta_G0 = problem.global_family.init(generator(0, torch.device("cpu")))
    for name, cfg in configs.items():
        servers = {}
        for dev, layout in (("cpu", "flat"), (DEVICE, "fused")):
            datas = [tree_map(lambda x, dev=dev: x.to(dev), d) for d in bundle.datas]
            servers[layout] = Server(problem, datas, bundle.theta0, eta_G0,
                                     num_obs=bundle.num_obs,
                                     server_opt=adam(2e-2), local_opt=adam(2e-2),
                                     wire=layout, device=dev, **cfg)
        servers["fused"].state = tree_map(lambda x: x.to(DEVICE), servers["flat"].state)
        draws = injected_draws(np, torch, problem, J, servers["flat"].wire_spec().dim, seed)
        hist = {k: srv.run(3, local_steps=K, draws=draws) for k, srv in servers.items()}
        e_c = np.asarray(hist["flat"]["elbo_trace"])
        e_g = np.asarray(hist["fused"]["elbo_trace"])
        rel = float(np.max(np.abs(e_c - e_g) / np.abs(e_c)))
        pairs = [(a.cpu(), b) for key in ("theta", "eta_G")
                 for a, b in zip(tree_leaves(servers["fused"].state[key]),
                                 tree_leaves(servers["flat"].state[key]), strict=True)]
        diff = max(float((a - b).abs().max()) for a, b in pairs)
        diff_rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in pairs)
        print(f"  port {DEVICE}/fused vs cpu/flat [{label} {name}] 3 rounds: elbo "
              f"max_rel={rel:.2e} (<= 1e-3), theta+eta_G max_abs={diff:.2e} (<= 1e-3), "
              f"max_rel={diff_rel:.2e} (<= 1e-3, per leaf against its largest entry)",
              flush=True)
        assert np.all(np.isfinite(e_g)) and rel <= 1e-3, name
        assert diff <= 1e-3 and diff_rel <= 1e-3, name
        assert hist["flat"]["bytes_up"] == hist["fused"]["bytes_up"], name


def check_port_cuda_vs_cpu(np, torch):
    """hier_bnn at a small width (J=3, K=2), three wire configurations; then
    glmm + Cholesky at full width (536 children, J=2, K=25), SFVI and
    SFVI-Avg (upload, combine and Newton–Schulz kernels); then multinomial
    at the smoke config's width (in_dim 196, J=4 silos of 60, K=4) and
    ProdLDA at a small vocab (200 words, 8 topics, J=3 silos of 40, K=4),
    SFVI and SFVI-Avg (θ ≠ ∅: the combined wire row on the card)."""
    from repro_torch.federated.aggregation import Int8Compressor, TrimmedMeanAggregator
    from repro_torch.federated.privacy import PrivacyPolicy
    from repro_torch.models.paper.registry import get_model

    bundle = get_model("hier_bnn").build(0, 3, device="cpu", in_dim=16, hidden=8,
                                         train_per_silo=20)
    compare_cuda_vs_cpu(np, torch, "hier_bnn", bundle, {
        "sfvi": dict(strategy="sfvi"),
        "sfvi+int8+trimmed": dict(
            strategy="sfvi", compressor=Int8Compressor(),
            aggregator=TrimmedMeanAggregator(0.34)),
        "sfvi_avg+trimmed+dp": dict(
            strategy="sfvi_avg", aggregator=TrimmedMeanAggregator(0.34),
            privacy=PrivacyPolicy(clip_norm=0.3, noise_multiplier=0.3)),
    }, K=2, seed=11)
    compare_cuda_vs_cpu(
        np, torch, f"glmm {GLMM_CHILDREN} children J={GLMM_J} K={GLMM_K} cholesky",
        glmm_bundle(GLMM_J, GLMM_CHILDREN, ("cholesky",)),
        {"sfvi": dict(strategy="sfvi"), "sfvi_avg": dict(strategy="sfvi_avg")},
        K=GLMM_K, seed=12)
    both = {"sfvi": dict(strategy="sfvi"), "sfvi_avg": dict(strategy="sfvi_avg")}
    compare_cuda_vs_cpu(
        np, torch, "multinomial in_dim 196 J=4",
        get_model("multinomial").build(0, 4, device="cpu", n_per=60, in_dim=196),
        both, K=4, seed=13)
    compare_cuda_vs_cpu(
        np, torch, "prodlda vocab 200 J=3",
        get_model("prodlda").build(0, 3, device="cpu", vocab_size=200, num_topics=8,
                                   docs_per_silo=40),
        both, K=4, seed=14)


# ---------------------------------------------------------------------------
# Phase 2c: the backbone's kernels against their plain versions
# ---------------------------------------------------------------------------

DTYPE_TOL = {"float32": 3e-5, "bfloat16": 2e-2}  # x (1 + max|plain|); the CPU tests' tolerances
FLASH_CHECKS = [
    # (label, B, Sq, Skv, H, KV, hd, causal, window, q_offset, on the serve path)
    ("zamba2_prefill_64", 8, 64, 64, 32, 32, 112, True, None, 0, True),
    ("zamba2_prefill_4096", 4, 4096, 4096, 32, 32, 112, True, None, 0, True),
    ("qwen3_prefill_512", 8, 512, 512, 32, 8, 128, True, None, 0, True),
    ("decode_q_offset", 8, 1, 4104, 32, 8, 128, True, None, 4103, False),
    ("window_128", 2, 1000, 1000, 32, 8, 128, True, 128, 0, False),
    ("non_causal", 2, 256, 384, 32, 8, 128, False, None, 0, False),
    ("ragged_1000", 2, 1000, 1000, 32, 32, 112, True, None, 0, False),
]
GLA_CHECKS = [
    # (label, B, S, H, dk, dv, q/k one group broadcast over heads, on the serve path)
    ("zamba2_prefill_64", 8, 64, 112, 64, 64, True, True),
    ("zamba2_prefill_4096", 4, 4096, 112, 64, 64, True, True),
    ("ragged_1000", 2, 1000, 112, 64, 64, True, False),
    ("dv65_mlstm_v_aug", 2, 300, 8, 64, 65, False, False),
]
RMS_CHECKS = [
    # (label, rows, D): ragged row counts at the serve path's widths
    ("zamba2_d_model", 4 * 4096 + 3, 3584),
    ("mamba2_out_norm", 515, 7168),
    ("qwen3_d_model", 4099, 2560),
    ("qwen3_qk_norm", 8 * 512 * 32 + 5, 128),
]


def _check_line(label, err, want):
    tol = DTYPE_TOL[str(want.dtype).replace("torch.", "")] * (1.0 + float(want.float().abs().max()))
    return err <= tol, f"max_abs={err:.3e} (<= {tol:.2e})"


# The tensor-core flash kernel's bf16 output is also held element by
# element: |got - want| <= 2^-7 |want| (one bf16 step of the value) +
# 2^-6 rms(want's row) (P rounded to bf16 before P V), a row being the hd
# values of one (b, s, h). Past a few hundred keys an output row is about
# N(0, e / keys), far under the max-abs limit set by the first rows, so
# only this limit catches a stale or skipped K/V tile.
FLASH_BF16_STEP, FLASH_BF16_ROW_RMS = 2.0 ** -7, 2.0 ** -6


def flash_bf16_ratio(torch, got, want) -> float:
    """Largest |got - want| over its element's limit (<= 1 passes); a row
    with no live key has limit 0 and must be exactly 0."""
    g, w = got.float(), want.float()
    limit = FLASH_BF16_STEP * w.abs() + FLASH_BF16_ROW_RMS * w.pow(2).mean(-1, keepdim=True).sqrt()
    diff = (g - w).abs()
    return float(torch.where(diff == 0, torch.zeros_like(diff), diff / limit).max())


# The tensor-core GLA kernel's bf16 output is also held element by element:
# |got - want| <= 2^-7 |want| (one bf16 step of the value) + 2^-6 rms(want's
# row) (P rounded to bf16 before P v, as flash rounds it), a row being the
# dv values of one (b, t, h). Late in a long walk the state term carries
# most of y, so a stale or skipped chunk state, or a column of another
# slice, moves whole rows by far more than that, where the max-abs limit,
# 2e-2 of the largest |y|, sees only the largest rows. The state after the
# last chunk is held in f32 relative Frobenius: within 1e-5 of the plain
# state on the SIMT (f32) route, and within 1e-4 on the tensor-core route,
# whose two f32 products take their operand as a bf16 hi + lo pair (about
# 2^-17 of each term).
GLA_BF16_STEP, GLA_BF16_ROW_RMS = 2.0 ** -7, 2.0 ** -6
GLA_STATE_TOL = {"float32": 1e-5, "bfloat16": 1e-4}


def gla_bf16_ratio(torch, got, want) -> float:
    """Largest |got - want| over its element's limit (<= 1 passes)."""
    g, w = got.float(), want.float()
    limit = GLA_BF16_STEP * w.abs() + GLA_BF16_ROW_RMS * w.pow(2).mean(-1, keepdim=True).sqrt()
    diff = (g - w).abs()
    return float(torch.where(diff == 0, torch.zeros_like(diff), diff / limit).max())


def check_gla_plan(gla):
    """The wrapper's shared-memory plan for the tensor-core kernel equals the
    source's, and fits."""
    lib = gla._lib()
    lib.repro_gla_tc_smem_bytes.restype = ctypes.c_longlong
    for dk in range(1, gla.MAX_DIM + 1):
        for S in (1, gla.CHUNK, gla.CHUNK + 1):
            got = lib.repro_gla_tc_smem_bytes(dk, S)
            assert got == gla.tc_smem_bytes(dk, S) <= gla.SMEM_LIMIT, (dk, S)
    print(f"  gla tensor-core smem plan: dk 1..{gla.MAX_DIM} x one chunk or more agree "
          f"with the source, largest {gla.tc_smem_bytes(gla.MAX_DIM)} (<= {gla.SMEM_LIMIT})",
          flush=True)


def check_gla(torch, gla, ref, gen) -> float:
    """GLA at ``GLA_CHECKS`` in bf16 (the tensor-core kernel) and f32 (the
    SIMT kernel), against the plain version: y
    within the max-abs limit (and, bf16, element by element), the final
    state within ``GLA_STATE_TOL``, y the same with and without the state,
    and the launch counters showing the route. Returns the largest bf16
    max-abs error at the serve-path shapes."""
    check_gla_plan(gla)
    worst = 0.0
    for label, B, S, H, dk, dv, shared, main in GLA_CHECKS:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, log_a = gla_inputs(torch, B, S, H, dk, dv, shared, gen, dtype)
            want, want_state = ref.gla_plain(q, k, v, log_a, chunk=gla.CHUNK, return_state=True)
            tc = dtype == torch.bfloat16
            before = dict(gla.LAUNCHES)
            got, state = gla.gla(q, k, v, log_a, return_state=True)
            bare = gla.gla(q, k, v, log_a)
            sync(torch)
            route = "gla_tc" if tc else "gla"
            assert gla.LAUNCHES[route] == before[route] + 2, (label, gla.LAUNCHES)
            assert sum(gla.LAUNCHES.values()) == sum(before.values()) + 2, gla.LAUNCHES
            err = float((got.float() - want.float()).abs().max())
            ok, line = _check_line(label, err, want)
            rel = float((state - want_state).norm() / want_state.norm())
            state_tol = GLA_STATE_TOL[str(dtype)[6:]]
            ratio = gla_bf16_ratio(torch, got, want) if tc else 0.0
            print(f"  gla {label:<20} ({B},{S},{H},{dk},{dv}) {str(dtype)[6:]:<8} "
                  f"shared q/k={shared}: {line}"
                  + (f", element ratio={ratio:.3f} (<= 1)" if tc else "")
                  + f", state rel={rel:.2e} (<= {state_tol:.0e})", flush=True)
            assert ok and got.dtype == dtype, (label, dtype)
            assert ratio <= 1.0, (label, ratio)
            assert rel <= state_tol and state.dtype == torch.float32, (label, dtype, rel)
            assert torch.equal(bare, got), (label, dtype)
            if main and tc:
                worst = max(worst, err)
    return worst


# Broken copies of the kernels, each of which its card check must fail
# (``python3 chip_smoke.py --mutants``, ``--gla-mutants``): (name, text in
# the source, its replacement). GLA's dv-slice offset is wrong for the
# second slice only, so dv = 65's last column is never written.
GLA_MUTANTS = [
    ("state update skipped in chunk 1",
     "#pragma unroll\n    for (int kk2 = 0; kk2 < kC / 16; ++kk2) {\n      const int s0 = kk2 * 16",
     "for (int kk2 = 0; kk2 < (c == 1 ? 0 : kC / 16); ++kk2) {\n      const int s0 = kk2 * 16"),
    ("cp.async wait removed",
     "    cp_wait_all();\n    __syncthreads();  // chunk c has landed",
     "    __syncthreads();  // chunk c has landed"),
    ("chunk barrier removed",
     "    cp_wait_all();\n    __syncthreads();  // chunk c has landed",
     "    cp_wait_all();  // chunk c has landed"),
    ("dv-slice offset wrong", "const int j0 = blockIdx.y * NS;",
     "const int j0 = blockIdx.y * (NS + 8);"),
    ("S_in copy written into the copy being read",
     "__nv_bfloat16* sh = m.s_hi(cur ^ 1);\n      __nv_bfloat16* sl = m.s_lo(cur ^ 1);",
     "__nv_bfloat16* sh = m.s_hi(cur);\n      __nv_bfloat16* sl = m.s_lo(cur);"),
]
COMBINE_MUTANTS = [
    ("tile barrier removed", "    cp_async_wait_all();\n    __syncthreads();  // the tile has landed",
     "    cp_async_wait_all();  // the tile has landed"),
    ("each row's alignment taken from row 0's address",
     "reinterpret_cast<uintptr_t>(row_at(x, j, P, c)) % 16",
     "reinterpret_cast<uintptr_t>(row_at(x, 0, P, c)) % 16"),
    ("rank < n - k as rank <= n - k", "rank >= k && rank < n - k", "rank >= k && rank <= n - k"),
    ("every row dequantized with row 0's scale", "  return scales[r];", "  return scales[0];"),
]
REPARAM_MUTANTS = [
    ("ticket never reset", "    *scratch = 0u;  // the ticket counter, ready for the next call\n", ""),
    ("tail skipped", "if (nvec * V + tid < n) lq +=", "if (false) lq +="),
    ("the last block's own partial left out", "b == static_cast<int>(blockIdx.x) ? own",
     "b == static_cast<int>(blockIdx.x) ? 0.0f"),
]
RMS_MUTANTS = [("partials not double-buffered (no buf ^= 1)", "      buf ^= 1;\n", "")]
# group -> (source under csrc, its mutants); the group's name is its check.
MUTANT_GROUPS = {
    "combine": ("wire.cu", COMBINE_MUTANTS),
    "reparam": ("reparam.cu", REPARAM_MUTANTS),
    "rmsnorm": ("rmsnorm.cu", RMS_MUTANTS),
    "gla": ("gla.cu", GLA_MUTANTS),
}
CHECK_SOURCES = {"combine": "wire", "reparam": "reparam", "rmsnorm": "rmsnorm", "gla": "gla"}


def run_check(name, torch, gen):
    """One kernel's card checks from phase 2, by group name."""
    from repro_torch.kernels import gla, ref, reparam, rmsnorm, wire

    checks = {
        "combine": lambda: check_combine_all(torch, wire, ref, gen),
        "reparam": lambda: check_reparam(torch, reparam, ref, gen),
        "rmsnorm": lambda: check_rmsnorm_all(torch, rmsnorm, ref, gen),
        "gla": lambda: check_gla(torch, gla, ref, gen),
    }
    checks[name]()


def check_main(name) -> int:
    """``--check NAME``: build the group's source and run its card checks
    alone; the last line says whether they passed (any error after the
    build fails them)."""
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    if name not in MUTANT_GROUPS:
        return fail(f"unknown check {name!r}; one of {sorted(MUTANT_GROUPS)}")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    build.build(CHECK_SOURCES[name])
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1234)
    try:
        run_check(name, torch, gen)
        sync(torch)
    except Exception as e:  # an assertion, a launch error or a fault of the kernel
        print(json.dumps({"check": name, "result": "fail", "why": f"{type(e).__name__}: {e}"[:300]}))
        return 1
    print(json.dumps({"check": name, "result": "pass"}))
    return 0


def mutants_main(groups) -> int:
    """The unchanged sources and each mutant of ``groups``, each in a copy
    of this script and ``src/repro_torch`` under ``build/`` (each builds into
    its own ``build/kernels``), checked by ``--check GROUP`` in its own
    process, all started together. 0 when every unchanged source passes
    and every mutant fails."""
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    print(gpu_line(), flush=True)
    cases = []
    for group in groups:
        src_name, mutants = MUTANT_GROUPS[group]
        source = (SRC / "repro_torch" / "csrc" / src_name).read_text()
        for name, old, new in [("unchanged", "", "")] + mutants:
            assert not old or source.count(old) == 1, \
                f"mutant {name!r}: its text is not in {src_name} once"
            cases.append((group, src_name, name, source.replace(old, new) if old else None))
    env = {k: v for k, v in os.environ.items() if k != "REPRO_TORCH_BUILD_DIR"}
    (ROOT / "build").mkdir(exist_ok=True)
    results = []
    with tempfile.TemporaryDirectory(prefix="mutants_", dir=ROOT / "build") as tmp:
        procs = []
        for i, (group, src_name, _, text) in enumerate(cases):
            copy = Path(tmp) / str(i)
            shutil.copytree(SRC / "repro_torch", copy / "src" / "repro_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy2(Path(__file__), copy / "chip_smoke.py")
            if text is not None:
                (copy / "src" / "repro_torch" / "csrc" / src_name).write_text(text)
            procs.append(subprocess.Popen(
                [sys.executable, str(copy / "chip_smoke.py"), "--check", group],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
        for (group, _, name, _), proc in zip(cases, procs, strict=True):
            out, _ = proc.communicate()
            print(f"-- {group}: {name}\n{out}", end="", flush=True)
            last = out.strip().splitlines()[-1] if out.strip() else ""
            if not last.startswith('{"check"'):
                raise RuntimeError(f"{group} {name}: the check did not run (exit {proc.returncode})")
            verdict = json.loads(last)
            results.append({"group": group, "mutant": name,
                            "fails_check": verdict["result"] == "fail",
                            "why": verdict.get("why", "")})
    print(json.dumps({"mutants": results}), flush=True)
    ok = all(r["fails_check"] != (r["mutant"] == "unchanged") for r in results)
    return 0 if ok else 1


def gla_inputs(torch, B, S, H, dk, dv, shared, gen, dtype):
    """q, k (a (B, S, dk) group expanded over heads when ``shared``), v, log_a f32."""
    if shared:
        q, k = (0.5 * torch.randn((B, S, 1, dk), generator=gen, device=DEVICE)
                for _ in range(2))
        q, k = q.to(dtype).expand(B, S, H, dk), k.to(dtype).expand(B, S, H, dk)
    else:
        q, k = ((0.5 * torch.randn((B, S, H, dk), generator=gen, device=DEVICE)).to(dtype)
                for _ in range(2))
    v = torch.randn((B, S, H, dv), generator=gen, device=DEVICE).to(dtype)
    log_a = -0.1 * torch.randn((B, S, H), generator=gen, device=DEVICE).abs()
    return q, k, v, log_a


# The tensor-core kernel (bf16) beyond the shapes above: head dims (100 is
# not a multiple of 8: element-by-element staging), and q, k, v as strided
# views of one packed (B, S, 3, H, hd) tensor, aligned or shifted one
# element off 16 bytes.
FLASH_TC_CHECKS = [
    # (label, B, Sq, Skv, H, KV, hd, causal, window, q_offset, layout)
    ("hd64", 2, 300, 300, 8, 8, 64, True, None, 0, "dense"),
    ("hd80", 2, 300, 300, 8, 4, 80, True, None, 0, "dense"),
    ("hd100", 2, 300, 300, 8, 4, 100, True, None, 0, "dense"),
    ("hd256", 2, 300, 300, 8, 2, 256, True, None, 0, "dense"),
    ("hd256_window", 1, 700, 700, 4, 2, 256, True, 128, 0, "dense"),
    ("hd112_packed_view", 2, 1000, 1000, 32, 32, 112, True, None, 0, "packed"),
    ("hd128_shifted_view", 2, 333, 333, 8, 8, 128, True, None, 0, "shifted"),
    ("hd112_noncausal_short", 1, 37, 5, 4, 4, 112, False, None, 0, "dense"),
    # q tiles past the keys' window: items without a live key write zeros
    ("empty_q_tiles", 1, 300, 64, 4, 2, 64, True, 16, 0, "dense"),
    ("no_live_key_rows", 1, 8, 8, 2, 2, 16, False, 2, 8, "dense"),
]


def flash_inputs(torch, attention, B, Sq, Skv, H, KV, hd, gen, dtype, layout="dense"):
    if layout == "dense":
        q = torch.randn((B, Sq, H, hd), generator=gen, device=DEVICE).to(dtype)
        k, v = (torch.randn((B, Skv, KV, hd), generator=gen, device=DEVICE).to(dtype)
                for _ in range(2))
        return q, k, v
    assert Sq == Skv and H == KV
    shift = 1 if layout == "shifted" else 0
    packed = torch.randn((B, Sq, 3, H, hd + shift), generator=gen, device=DEVICE).to(dtype)
    q, k, v = (packed[:, :, i, :, shift:] for i in range(3))
    assert not q.is_contiguous() and q.stride(-1) == 1
    assert attention.tc_vector_loads(q, k, v) == (layout == "packed")
    return q, k, v


def check_flash(torch, attention, ref, label, shape, dtype, gen, layout="dense"):
    """One flash check: the kernel (both q_rows for bf16) against the plain
    version; asserts which kernel launched. Returns the largest error."""
    B, Sq, Skv, H, KV, hd, causal, window, off = shape
    q, k, v = flash_inputs(torch, attention, B, Sq, Skv, H, KV, hd, gen, dtype, layout)
    want = ref.flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=off)
    key = "flash_attention_tc" if dtype == torch.bfloat16 else "flash_attention"
    worst = 0.0
    for q_rows in (attention.TC_Q_ROWS if dtype == torch.bfloat16 else (64,)):
        before = dict(attention.LAUNCHES)
        got = attention.flash_attention(q, k, v, causal=causal, window=window, q_offset=off,
                                        q_rows=q_rows)
        sync(torch)
        assert attention.LAUNCHES[key] == before[key] + 1, (label, attention.LAUNCHES)
        err = float((got.float() - want.float()).abs().max())
        ok, line = _check_line(label, err, want)
        if dtype == torch.bfloat16:
            ratio = flash_bf16_ratio(torch, got, want)
            ok = ok and ratio <= 1.0
            line += f", elementwise {ratio:.3f} of its limit (<= 1)"
        route = f"tc q_rows={q_rows}" if dtype == torch.bfloat16 else "simt"
        print(f"  flash_attention {label:<20} ({B},{Sq},{Skv},{H}/{KV},{hd}) "
              f"{str(dtype)[6:]:<8} causal={causal} window={window} q_offset={off} "
              f"{layout} [{route}]: {line}", flush=True)
        assert ok and got.dtype == dtype and bool(torch.isfinite(got.float()).all()), (label, q_rows)
        worst = max(worst, err)
    return worst


def check_flash_plan(attention):
    """The wrapper's shared-memory plan equals the source's, and fits."""
    lib = attention._lib()
    lib.repro_flash_tc_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.repro_flash_tc_smem_bytes.restype = ctypes.c_longlong
    for hd in range(1, attention.MAX_HEAD_DIM + 1):
        for q_rows in attention.TC_Q_ROWS:
            got = lib.repro_flash_tc_smem_bytes(hd, q_rows)
            assert got == attention.tc_smem_bytes(hd, q_rows) <= attention.SMEM_LIMIT, (hd, q_rows)
    print(f"  flash_attention tensor-core smem plan: hd 1..256 x q_rows {attention.TC_Q_ROWS} "
          f"agree with the source, largest {attention.tc_smem_bytes(256, 128)} "
          f"(<= {attention.SMEM_LIMIT})", flush=True)


# RMSNorm's bf16 output is also held element by element to one bf16 step
# of want (2^-7 |want|; a floor of 2^-16 for want near 0). Row r of x is
# scaled by 2^((r % 9) - 4), so a row whose scale took another row's
# partial sum (a stale slot of the warps' exchange, a missed barrier) is off
# by a factor, not by the 1-2 % that rows of one scale differ by; the
# max-abs limit alone lets a 1 % error through at |want| ~ 4.
RMS_BF16_STEP, RMS_BF16_FLOOR = 2.0 ** -7, 2.0 ** -16


def rms_bf16_ratio(torch, got, want) -> float:
    """Largest |got - want| over its element's limit (<= 1 passes)."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (RMS_BF16_STEP * w.abs() + RMS_BF16_FLOOR)).max())


def check_rmsnorm(torch, rmsnorm, ref, gen) -> float:
    """RMSNorm at the serve path's widths, three type pairs, 16-byte vectors
    on aligned rows and the scalar route on x one element past 16 bytes
    (the plan says which); returns the largest bf16 error on the vector
    route."""
    worst = 0.0
    for label, rows, D in RMS_CHECKS:
        scale = torch.exp2((torch.arange(rows, device=DEVICE) % 9 - 4).float())[:, None]
        for dtype, wdtype in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                              (torch.bfloat16, torch.float32)):
            for shift in (0, 1):
                buf = torch.randn((rows * D + shift,), generator=gen, device=DEVICE).to(dtype)
                x = buf[shift:].view(rows, D)
                x.mul_(scale.to(dtype))  # powers of two: exact in either type
                w = (1.0 + 0.2 * torch.randn((D,), generator=gen, device=DEVICE)).to(wdtype)
                plan = rmsnorm._rmsnorm_plan(rows, D, x, w)
                assert (plan.vec > 1) == (shift == 0), (label, plan)
                got = rmsnorm.rmsnorm(x, w, 1e-6)
                want = ref.rmsnorm_plain(x, w, 1e-6)
                sync(torch)
                err = float((got.float() - want.float()).abs().max())
                ok, line = _check_line(label, err, want)
                if dtype == torch.bfloat16:
                    ratio = rms_bf16_ratio(torch, got, want)
                    line += f", elementwise {ratio:.3f} of 2^-7 |want| (<= 1)"
                    ok = ok and ratio <= 1.0
                route = f"vec {plan.vec}" if shift == 0 else "scalar, x 1 elt off"
                print(f"  rmsnorm {label:<16} ({rows},{D}) x {str(dtype)[6:]:<8} "
                      f"w {str(wdtype)[6:]:<8} [{route}, {plan.lanes} lanes x {plan.vpl}]: "
                      f"{line}", flush=True)
                assert ok and got.dtype == dtype, (label, dtype, shift)
                if dtype == wdtype == torch.bfloat16 and shift == 0:
                    worst = max(worst, err)
    return worst


# Rows a few blocks walk with several warps a row (the rows' warps trade
# partial sums through shared memory): (label, rows, D, x dtype, lanes a row,
# grid). The rows are at scales 2^-12 .. 2^12 in a cycle of 25, so a row step
# that took a partial of the block's previous or next row is off by a
# factor of 2 or more; the row count leaves the last step part empty.
RMS_WALKS = [
    ("d3584_2_warps_a_row", 4 * 1024 + 3, 3584, "bfloat16", 64, 1),
    ("d3584_8_warps_a_row", 2 * 1024 + 1, 3584, "bfloat16", 256, 2),
    ("d4096_f32_8_warps_a_row", 2 * 1024 + 1, 4096, "float32", 256, 132),
    ("d2560_4_warps_a_row", 4 * 1024 + 3, 2560, "bfloat16", 128, 132),
]


def check_rmsnorm_walk(torch, rmsnorm, ref, gen, repeats=20):
    """The kernel on plans with a few blocks, each walking many row steps
    of one or more multi-warp rows, launched ``repeats`` times each: every
    output held element by element as in :func:`check_rmsnorm`."""
    lib = rmsnorm._lib()
    stream = torch.cuda.current_stream().cuda_stream
    for label, rows, D, dt, lanes, grid in RMS_WALKS:
        dtype = getattr(torch, dt)
        scale = torch.exp2((torch.arange(rows, device=DEVICE) % 25 - 12).float())[:, None]
        x = (torch.randn((rows, D), generator=gen, device=DEVICE) * scale).to(dtype)
        w = (1.0 + 0.2 * torch.randn((D,), generator=gen, device=DEVICE)).to(dtype)
        vec = 16 // x.element_size()
        vpl = -(-D // (vec * lanes))
        want = ref.rmsnorm_plain(x, w, 1e-6)
        worst = 0.0
        for _ in range(repeats):
            out = torch.empty_like(x)
            bf16 = int(dtype == torch.bfloat16)
            err = lib.repro_rmsnorm(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, D, 1e-6,
                                    bf16, bf16, 1, lanes, vpl, grid, stream)
            assert err == 0, (label, err)
            sync(torch)
            g, ww = out.float(), want.float()
            worst = max(worst, float(((g - ww).abs() / (RMS_BF16_STEP * ww.abs()
                                                        + RMS_BF16_FLOOR)).max()))
        print(f"  rmsnorm walk {label:<24} ({rows},{D}) {dt:<8} [{lanes} lanes x {vpl}, "
              f"grid {grid}, {repeats} launches]: elementwise {worst:.3f} of 2^-7 |want| "
              f"(<= 1)", flush=True)
        assert worst <= 1.0, (label, worst)


def check_rmsnorm_all(torch, rmsnorm, ref, gen) -> float:
    """RMSNorm's card checks; returns the largest bf16 error on the vector
    route at the serve path's widths."""
    worst = check_rmsnorm(torch, rmsnorm, ref, gen)
    check_rmsnorm_walk(torch, rmsnorm, ref, gen)
    return worst


def check_backbone_kernels(torch, attention, gla, rmsnorm, ref, gen):
    """Each kernel against its plain version, bf16 and f32; returns each
    kernel's largest error over its serve-path shapes in bf16."""
    worst = {"flash_attention": 0.0, "gla": 0.0, "rmsnorm": 0.0}
    check_flash_plan(attention)
    for label, B, Sq, Skv, H, KV, hd, causal, window, off, main in FLASH_CHECKS:
        for dtype in (torch.bfloat16, torch.float32):
            err = check_flash(torch, attention, ref, label,
                              (B, Sq, Skv, H, KV, hd, causal, window, off), dtype, gen)
            if main and dtype == torch.bfloat16:
                worst["flash_attention"] = max(worst["flash_attention"], err)
    for label, B, Sq, Skv, H, KV, hd, causal, window, off, layout in FLASH_TC_CHECKS:
        check_flash(torch, attention, ref, label, (B, Sq, Skv, H, KV, hd, causal, window, off),
                    torch.bfloat16, gen, layout)
    worst["gla"] = check_gla(torch, gla, ref, gen)
    worst["rmsnorm"] = check_rmsnorm_all(torch, rmsnorm, ref, gen)
    return worst


# ---------------------------------------------------------------------------
# Phase 2d: the backbone on the card against the backbone on the CPU
# ---------------------------------------------------------------------------


def greedy(torch, cfg, theta, eta_G, eta_L, tokens, silos, gen_len):
    """Serve prefill + greedy decode; returns (every step's logits, tokens)."""
    from repro_torch.launch import steps as S

    prefill = S.make_serve_prefill(cfg, silos, max_len=tokens.shape[1] + gen_len)
    decode = S.make_serve_decode(cfg, silos)
    with torch.inference_mode():
        logits, cache = prefill(theta, eta_G, eta_L, {"tokens": tokens})
        out_logits, out_tok = [logits.float().cpu()], [torch.argmax(logits[:, -1], -1)]
        for _ in range(gen_len - 1):
            logits, cache = decode(theta, eta_G, eta_L, out_tok[-1][:, None], cache)
            out_logits.append(logits.float().cpu())
            out_tok.append(torch.argmax(logits[:, -1], -1))
    return out_logits, torch.stack([t.cpu() for t in out_tok], 1)


def check_backbone_cuda_vs_cpu(torch):
    """zamba2-7b at full width, one hybrid unit (6 layers: 5 mamba2 + the
    shared attention), f32, B = 2, prompt 32, greedy gen 4: the same
    weights (drawn on the CPU) through the port on the card (kernels) and
    on the CPU (plain versions). Logits within 1e-3 relative (max abs error
    over max |logit|), and the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    from repro_torch.models.backbone import transformer as T
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("zamba2-7b"), num_layers=6, dtype="float32")
    g = torch.Generator().manual_seed(3)
    theta = T.init_params(g, cfg)
    eta_G, eta_L = S.init_eta_G(g, cfg), S.init_eta_L(g, cfg, 2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    t0 = time.perf_counter()
    cpu_logits, cpu_tok = greedy(torch, cfg, theta, eta_G, eta_L, tokens, 2, 4)
    cpu_s = time.perf_counter() - t0
    to_dev = lambda tree: tree_map(lambda a: a.to(DEVICE), tree)  # noqa: E731
    from repro_torch.kernels import attention, gla

    attention.reset_launches()
    gla.reset_launches()
    dev_logits, dev_tok = greedy(torch, cfg, to_dev(theta), to_dev(eta_G), to_dev(eta_L),
                                 tokens.to(DEVICE), 2, 4)
    sync(torch)
    # f32 attention takes the SIMT kernel (the f32 parity route), once a prefill.
    want = backbone_launches_per_pass(cfg)[0]
    assert attention.LAUNCHES == {k: want[k] for k in attention.LAUNCHES}, attention.LAUNCHES
    assert attention.LAUNCHES["flash_attention"] > 0
    # f32 GLA takes the SIMT kernel, once a mamba2 layer in the prefill.
    assert gla.LAUNCHES == {k: want[k] for k in gla.LAUNCHES}, gla.LAUNCHES
    assert gla.LAUNCHES["gla"] > 0
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(dev_logits, cpu_logits, strict=True))
    same = bool(torch.equal(dev_tok, cpu_tok))
    print(f"  backbone {DEVICE} vs cpu [zamba2-7b, 6 layers, f32, B=2, prompt 32, greedy 4]: "
          f"logits max_rel={rel:.2e} (<= 1e-3), tokens equal={same} {dev_tok[0].tolist()} "
          f"(cpu side {cpu_s:.1f} s)", flush=True)
    assert all(bool(torch.isfinite(a).all()) for a in dev_logits)
    assert rel <= 1e-3 and same
    return {"max_rel": rel, "tokens_equal": same}


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------


# The port's kernels by symbol (csrc/*.cu), summed apart in each profile.
PORT_KERNELS = ("upload_norm_kernel", "upload_apply_kernel",
                "upload_quant_kernel", "combine_mean_kernel", "combine_trim_kernel",
                "combine_trim_staged_kernel",
                "ns_t_kernel", "ns_update_kernel",
                "ns_root_small_kernel", "reparam_fwd_kernel",
                "reparam_bwd_kernel", "flash_kernel", "flash_tc_kernel", "gla_kernel",
                "gla_tc_kernel", "rmsnorm_kernel")


def device_spans(prof) -> list:
    """(start, end, name) of each device event of a torch.profiler trace,
    in ns, read from its raw Kineto results: the device events that
    ``prof.events()`` keeps, without the host-side event tree it builds
    first (seconds for a trace of 10,000 events)."""
    from torch.autograd import DeviceType

    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA and not e.is_hidden_event())


def profile_summary(prof, wall_s: float, top: int = 8) -> dict:
    """Device busy share and kernel time by name from a torch.profiler trace.

    Busy time is the union of the device events' intervals; the idle share
    is the rest of the host wall time of the traced rounds. ``port_kernels``
    sums the device time and calls of each of the port's own kernels.
    """
    spans = device_spans(prof)
    busy_ns, end_ns, by_name = 0, 0, {}
    for start, end, name in spans:
        busy_ns += max(0, end - max(start, end_ns))
        end_ns = max(end_ns, end)
        total, calls = by_name.get(name, (0, 0))
        by_name[name] = (total + end - start, calls + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    port = {}
    for n, (t, c) in by_name.items():
        for sym in PORT_KERNELS:
            if re.search(rf"\b{sym}\b", n):
                ms, calls = port.get(sym, (0.0, 0))
                port[sym] = (ms + t * 1e-6, calls + c)
    return {
        "wall_s": wall_s, "device_busy_s": busy_ns * 1e-9,
        "idle_share": 1.0 - busy_ns * 1e-9 / wall_s,
        "device_events": len(spans),
        "top": [{"name": n[:80], "ms": t * 1e-6, "calls": c} for n, (t, c) in ranked],
        "port_kernels": {k: {"ms": ms, "calls": c} for k, (ms, c) in sorted(port.items())},
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


KERNEL_COUNTS = ("fused_upload", "fused_combine", "newton_schulz_step", "sqrtm_newton_schulz")


class Run(NamedTuple):
    """One phase-3 run: ``rounds`` counted rounds of ``strategy`` on ``bundle``.

    ``per_round`` holds the launches a round of each kernel in
    ``KERNEL_COUNTS``; ``want_up`` the bytes up a round; ``want_total``, if
    set, up + down a round; ``want_eps``, if set, ε after the counted
    rounds (within 1e-4); ``rise``: the ELBO must rise over them; ``P``, if
    set, the server's wire row."""

    label: str
    bundle: object
    strategy: str
    rounds: int
    K: int
    extra: dict
    want_up: int
    per_round: tuple
    rise: bool
    want_total: int | None = None
    want_eps: float | None = None
    P: int | None = None


def drive(torch, wire, reparam, srv, run):
    """One main-path run with the launch counters set to 0 just before and
    read just after; asserts bytes, ε and launches per round, then profiles
    two more rounds. The reparam kernels, which no round calls, must stay
    at 0."""
    label, rounds = run.label, run.rounds
    stamps = []
    sync(torch)
    wire.reset_launches()
    reparam.reset_launches()
    t0 = time.perf_counter()
    h = srv.run(rounds, local_steps=run.K,
                callback=lambda r, m: stamps.append(time.perf_counter()))
    sync(torch)
    counts = {k: wire.LAUNCHES[k] for k in KERNEL_COUNTS}
    counts.update(reparam.LAUNCHES)
    round_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    print(f"  {label}: elbo={['%.2f' % e for e in h['elbo']]} "
          f"bytes_up={h['bytes_up']} bytes_down={h['bytes_down']} launches={counts} "
          f"s/round={['%.4f' % s for s in round_s]}", flush=True)
    if "epsilon" in h:
        print(f"  {label}: epsilon={h['epsilon']}", flush=True)
    assert all(math.isfinite(e) for e in h["elbo_trace"]), label
    if run.rise:
        assert h["elbo"][-1] > h["elbo"][0], f"{label}: ELBO did not rise"
    assert h["bytes_up"] == [run.want_up] * rounds, (label, h["bytes_up"])
    if run.want_total is not None:
        totals = [u + d for u, d in zip(h["bytes_up"], h["bytes_down"], strict=True)]
        assert totals == [run.want_total] * rounds, (label, totals)
    if run.want_eps is not None:
        assert abs(h["epsilon"][-1] - run.want_eps) <= 1e-4, (label, h["epsilon"][-1])
    want = {k: n * rounds for k, n in zip(KERNEL_COUNTS, run.per_round, strict=True)}
    want.update({k: 0 for k in reparam.LAUNCHES})
    assert counts == want, (label, counts, want)
    for leaf in srv.eta_G.values():
        assert bool(torch.isfinite(leaf).all()), label
    return counts, round_s, profile_rounds(torch, srv, run.K, start_round=rounds)


def new_server(torch, bundle, algo, **extra):
    from repro_torch.device import generator
    from repro_torch.federated.runtime import Server
    from repro_torch.optim import adam

    problem = bundle.problem
    datas = [{k: v.to(DEVICE) for k, v in d.items()} for d in bundle.datas]
    return Server(problem, datas, bundle.theta0,
                  problem.global_family.init(generator(0, torch.device(DEVICE))),
                  num_obs=bundle.num_obs, server_opt=adam(2e-2), local_opt=adam(2e-2),
                  wire="fused", seed=0, strategy=algo, device=DEVICE, **extra)


def hier_bnn_glmm_runs(in_dim=784, hidden=64):
    """hier_bnn at full width (J=10, K=4) and the GLMM at its benchmark's."""
    from repro_torch.federated.aggregation import Int8Compressor, TrimmedMeanAggregator
    from repro_torch.federated.privacy import PrivacyPolicy
    from repro_torch.models.paper.registry import get_model

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
        Run("sfvi", bundle, "sfvi", 3, K, {}, K * J * 4 * P, (K, K, 0, 0), True, P=P),
        Run("sfvi_avg", bundle, "sfvi_avg", 3, K, {}, J * 4 * P, (1, 2, 0, 0), True, P=P),
        Run("sfvi_avg+int8+trimmed+dp", bundle, "sfvi_avg", 2, K,
            dict(compressor=Int8Compressor(), aggregator=TrimmedMeanAggregator(0.1),
                 privacy=PrivacyPolicy(clip_norm=0.3, noise_multiplier=0.3)),
            J * (P + 4), (1, 2, 0, 0), False, P=P),
        # step cadence: int8 is dequantized inside the trimmed combine kernel
        Run("sfvi+int8+trimmed", bundle, "sfvi", 2, K,
            dict(compressor=Int8Compressor(), aggregator=TrimmedMeanAggregator(0.1)),
            K * J * (P + 4), (K, K, 0, 0), False, P=P),
    ]
    assert [r.want_up for r in runs] == [16_056_640, 4_014_160, 1_003_580, 4_014_320]

    # The paper's GLMM at its benchmark's width (536 children, J=2, K=25)
    # with the Cholesky global family: η_G = (mu, log_sigma, L_packed) is a
    # 5 + 5 + 10 = 20-float wire row. SFVI-Avg's full-covariance barycenter
    # merges the means with the combine kernel and takes 50 x (1 + 1
    # batched) square roots of 40 Newton–Schulz steps each: 100 launches
    # of the root kernel a merge, no step call.
    Jg, Kg = GLMM_J, GLMM_K
    chol = glmm_bundle(Jg, GLMM_CHILDREN, ("cholesky",))
    # J=6 (89 children a silo) with a rank-2 low-rank global family, the
    # unitriangular conditional local family and a trimmed mean dropping
    # one silo at each end (k = floor(0.2 * 6) = 1).
    lowrank = glmm_bundle(6, GLMM_CHILDREN, ("lowrank", {"rank": 2}),
                          ("conditional", {"use_chol": True}))
    print(f"  glmm: global dim 5, local dim {chol.problem.model.local_dim} (J={Jg}) / "
          f"{lowrank.problem.model.local_dim} (J=6), wire P=20, K={Kg}", flush=True)
    glmm = [
        Run("glmm+cholesky sfvi", chol, "sfvi", 3, Kg, {}, Kg * Jg * 4 * 20, (Kg, Kg, 0, 0),
            True),
        Run("glmm+cholesky sfvi_avg", chol, "sfvi_avg", 3, Kg, {}, Jg * 4 * 20,
            (1, 1, 0, NS_ROOTS_PER_MERGE), True),
        Run("glmm+lowrank+chol_local sfvi_avg+trimmed", lowrank, "sfvi_avg", 2, Kg,
            dict(aggregator=TrimmedMeanAggregator(0.2)), 6 * 4 * 20,
            (1, 1, 0, NS_ROOTS_PER_MERGE), False),
    ]
    assert [r.want_up for r in glmm] == [4000, 160, 480]
    return runs + glmm


# The benchmark smoke config (benchmarks/baseline.json "config"): the
# multinomial model, in_dim 196, J=4 silos of 60, K=4, lr 0.02, 25 rounds.
SMOKE_J, SMOKE_N, SMOKE_DIM, SMOKE_K, SMOKE_ROUNDS = 4, 60, 196, 4, 25


def paper_model_runs():
    """The paper's multinomial (S3.2), hetero_mn and ProdLDA (§4.2) at full
    width. θ ≠ ∅ in each (2 floats on the wire row), so an SFVI-Avg merge is
    3 combines: the combined row (for θ) and the barycenter's mean and std
    rows; one upload a round. SFVI: K uploads and K combines a round."""
    from repro_torch.federated.aggregation import Int8Compressor
    from repro_torch.federated.privacy import PrivacyPolicy
    from repro_torch.models.paper.registry import get_model

    # Table S1's small-silo run (benchmarks/bench_multinomial.py:49-51):
    # Z_G = (W, b) in R^7,850, so P = 2 x 7,850 + 2 = 15,702.
    J, K = 25, 25
    mn = get_model("multinomial").build(0, J, device=DEVICE, n_per=200, in_dim=784)
    P = mn.problem.model.global_dim * 2 + 2
    runs = [
        Run(f"multinomial J={J} sfvi", mn, "sfvi", 3, K, {}, K * J * 4 * P, (K, K, 0, 0),
            True, P=P),
        Run(f"multinomial J={J} sfvi_avg", mn, "sfvi_avg", 3, K, {}, J * 4 * P,
            (1, 3, 0, 0), True, P=P),
    ]
    # The smoke config's four synchronous rows, with the baseline's figures.
    Js, Ks = SMOKE_J, SMOKE_K
    smoke = get_model("multinomial").build(0, Js, device=DEVICE, n_per=SMOKE_N,
                                           in_dim=SMOKE_DIM)
    Ps = smoke.problem.model.global_dim * 2 + 2
    dp = PrivacyPolicy(clip_norm=0.3, noise_multiplier=0.3)
    runs += [
        Run("smoke SFVI", smoke, "sfvi", SMOKE_ROUNDS, Ks, {}, Ks * Js * 4 * Ps,
            (Ks, Ks, 0, 0), True, want_total=504_576, P=Ps),
        Run("smoke SFVI-Avg", smoke, "sfvi_avg", SMOKE_ROUNDS, Ks, {}, Js * 4 * Ps,
            (1, 3, 0, 0), True, want_total=126_144, P=Ps),
        Run("smoke SFVI-Avg int8", smoke, "sfvi_avg", SMOKE_ROUNDS, Ks,
            dict(compressor=Int8Compressor()), Js * (Ps + 4), (1, 3, 0, 0), True,
            want_total=78_856, P=Ps),
        Run("smoke SFVI-Avg dp(z=0.3,C=0.3)", smoke, "sfvi_avg", SMOKE_ROUNDS, Ks,
            dict(privacy=dp), Js * 4 * Ps, (1, 3, 0, 0), False, want_total=126_144,
            want_eps=289.2907, P=Ps),
    ]
    # hetero_mn at its registry defaults: ragged Dirichlet(0.5) silos padded
    # to the widest, the true N_j in num_obs.
    het = get_model("hetero_mn").build(0, 4, device=DEVICE)
    runs.append(Run("hetero_mn sfvi_avg+int8+dp", het, "sfvi_avg", 2, 4,
                    dict(compressor=Int8Compressor(),
                         privacy=PrivacyPolicy(clip_norm=0.3, noise_multiplier=0.3)),
                    4 * (Ps + 4), (1, 3, 0, 0), False, P=Ps))
    # ProdLDA at §4.2's width (benchmarks/bench_prodlda.py:37): Z_G = T in
    # R^(21 x 2,000), so P = 2 x 42,000 + 2 = 84,002.
    Jl = 3
    lda = get_model("prodlda").build(0, Jl, device=DEVICE, vocab_size=2000, num_topics=21,
                                     docs_per_silo=400)
    Pl = lda.problem.model.global_dim * 2 + 2
    runs += [
        Run("prodlda sfvi", lda, "sfvi", 3, 25, {}, 25 * Jl * 4 * Pl, (25, 25, 0, 0), True,
            P=Pl),
        Run("prodlda sfvi_avg", lda, "sfvi_avg", 2, 50, {}, Jl * 4 * Pl, (1, 3, 0, 0), True,
            P=Pl),
    ]
    print(f"  multinomial: wire P={P} (J={J}, K={K}); smoke P={Ps} (J={Js}, K={Ks}); "
          f"hetero_mn N_j={het.num_obs}; prodlda: wire P={Pl} (J={Jl})", flush=True)
    assert (P, Ps, Pl) == (15_702, 3942, 84_002)
    assert [r.want_up for r in runs] == [39_255_000, 1_570_200, 252_288, 63_072, 15_784,
                                         63_072, 15_784, 25_200_600, 1_008_024]
    return runs


def main_path(np, torch, wire, reparam):
    """Every phase-3 run in turn; each model's eval line after its last run."""
    totals = {k: 0 for k in KERNEL_COUNTS}
    seconds, profiles = {}, {}
    t0 = time.perf_counter()
    runs = hier_bnn_glmm_runs() + paper_model_runs()
    print(f"  bundles built in {time.perf_counter() - t0:.1f} s", flush=True)
    for i, run in enumerate(runs):
        t0 = time.perf_counter()
        srv = new_server(torch, run.bundle, run.strategy, **run.extra)
        if run.P is not None:
            assert srv.wire_spec().dim == run.P, (run.label, srv.wire_spec().dim)
        counts, seconds[run.label], profiles[run.label] = drive(
            torch, wire, reparam, srv, run)
        for k in totals:
            totals[k] += counts[k]
        last = i + 1 == len(runs) or runs[i + 1].bundle is not run.bundle
        if last and run.bundle.eval_fn is not None:
            print(f"  {run.label}: eval {run.bundle.eval_fn(srv)}", flush=True)
        print(f"  {run.label}: {time.perf_counter() - t0:.1f} s, profile and eval included",
              flush=True)
    return totals, seconds, profiles


# ---------------------------------------------------------------------------
# Phase 3b: the backbone's serve path at full width
# ---------------------------------------------------------------------------

SERVE_RUNS = [
    # (label, arch, layers, batch, prompt, gen, silos)
    ("zamba2-7b 81 layers", "zamba2-7b", 81, 8, 64, 32, 4),
    ("zamba2-7b 12 layers, prompt 4096", "zamba2-7b", 12, 4, 4096, 8, 4),
    ("qwen3-4b 4 layers", "qwen3-4b", 4, 8, 512, 16, 4),
]
BACKBONE_COUNTS = ("flash_attention", "flash_attention_tc", "gla", "gla_tc", "rmsnorm")


def backbone_launches_per_pass(cfg):
    """Kernel launches of one prefill and of one decode step, from the config:
    bf16 attention and GLA take the tensor-core kernels, f32 the SIMT ones."""
    kinds = cfg.block_pattern
    n_attn, n_mamba = kinds.count("attn"), kinds.count("mamba2")
    norms = 2 * n_mamba + n_attn * (2 if cfg.d_ff else 1) + (2 * n_attn if cfg.qk_norm else 0) + 1
    tc = cfg.dtype == "bfloat16"
    prefill = {"flash_attention": 0 if tc else n_attn, "flash_attention_tc": n_attn if tc else 0,
               "gla": 0 if tc else n_mamba, "gla_tc": n_mamba if tc else 0, "rmsnorm": norms}
    decode = {"flash_attention": 0, "flash_attention_tc": 0, "gla": 0, "gla_tc": 0,
              "rmsnorm": norms}
    return prefill, decode


def counters(modules):
    return {k: n for m in modules for k, n in m.LAUNCHES.items()}


def profile_serve(torch, run, steps=2) -> dict:
    """One more prefill of the same prompt, then ``steps`` more decode steps
    of a finished serve run, each under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    st = run.state
    out = {}
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st["prefill"](st["theta"], st["eta_G"], st["eta_L"], st["prompt"])
            sync(torch)
            wall = time.perf_counter() - t0
        out["prefill"] = profile_summary(prof, wall, top=20)
        tok, cache = st["tok"], st["cache"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = st["decode"](st["theta"], st["eta_G"], st["eta_L"], tok[:, None],
                                             cache)
                tok = torch.argmax(logits[:, -1], dim=-1)
            sync(torch)
            wall = time.perf_counter() - t0
        out["decode"] = {"steps": steps, **profile_summary(prof, wall, top=12)}
    return out


def serve_runs(torch, kernel_modules, other_modules):
    """Each serve run with the backbone counters at 0 just before and read
    just after; asserts the launches each kernel owes the run, finite
    logits, that no other kernel launched, and that no prefill called
    ``gla_final_state`` (mamba2's decode state comes from the GLA kernel)."""
    from repro_torch.models.backbone import ssm

    final_state_calls = []
    real_final_state = ssm.gla_final_state

    def counted_final_state(*args, **kw):
        final_state_calls.append(1)
        return real_final_state(*args, **kw)

    ssm.gla_final_state = counted_final_state
    try:
        return _serve_runs(torch, kernel_modules, other_modules, final_state_calls)
    finally:
        ssm.gla_final_state = real_final_state


def _serve_runs(torch, kernel_modules, other_modules, final_state_calls):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_backbone import serve

    totals = {k: 0 for k in BACKBONE_COUNTS}
    results = []
    for label, arch, layers, B, prompt, gen_len, silos in SERVE_RUNS:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sync(torch)
        for m in kernel_modules + other_modules:
            m.reset_launches()
        final_state_calls.clear()
        run = serve(cfg, batch=B, prompt_len=prompt, gen=gen_len, silos=silos,
                    device=torch.device(DEVICE))
        sync(torch)
        counts = counters(kernel_modules)
        others = counters(other_modules)
        peak = torch.cuda.max_memory_allocated()
        per_prefill, per_decode = backbone_launches_per_pass(cfg)
        want = {k: per_prefill[k] + (gen_len - 1) * per_decode[k] for k in BACKBONE_COUNTS}
        from repro_torch.models.backbone.transformer import param_count

        res = {
            "serve": label, "arch": arch, "layers": layers, "batch": B, "prompt": prompt,
            "gen": gen_len, "silos": silos, "params": param_count(run.state["theta"]),
            "prefill_ms": run.prefill_s * 1e3, "prefill_tok_s": B * prompt / run.prefill_s,
            "decode_ms_per_token": run.decode_s * 1e3 / (gen_len - 1),
            "decode_tok_s": B * (gen_len - 1) / run.decode_s,
            "peak_gb": peak / 1e9, "launches": counts,
            "tokens_first_request": run.tokens[0].tolist(),
        }
        print(f"  {label}: prefill {res['prefill_ms']:.1f} ms ({res['prefill_tok_s']:.0f} tok/s), "
              f"decode {res['decode_ms_per_token']:.2f} ms/token ({res['decode_tok_s']:.0f} tok/s), "
              f"peak {res['peak_gb']:.2f} GB, params {res['params']:,}, launches={counts}, "
              f"gla_final_state calls={len(final_state_calls)}", flush=True)
        assert bool(torch.isfinite(run.logits.float()).all()), label
        assert tuple(run.tokens.shape) == (B, gen_len), label
        assert counts == want, (label, counts, want)
        assert not any(others.values()), (label, others)
        assert not final_state_calls, (label, "gla_final_state called", len(final_state_calls))
        for k in totals:
            totals[k] += counts[k]
        res["profile"] = profile_serve(torch, run)
        results.append(res)
        del run
    # bf16 serving: every flash and GLA call took the tensor-core kernel, none the SIMT one.
    assert totals["flash_attention"] == 0 and totals["gla"] == 0, totals
    assert all(totals[k] > 0 for k in BACKBONE_COUNTS if k not in ("flash_attention", "gla")), \
        totals
    return totals, results


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


RUN_LAUNCHES = 64  # launches in one timed run
RUN_BYTES = 64 << 20  # the run's copies of the inputs together: more than the 50 MB L2
RUN_MAX_MS = 1.0  # a row whose single launch takes longer has no run column
SM_HZ = 2.0e9  # at least the card's SM clock: sleep cycles from a host time


def run_ms(torch, fn, args, launches=RUN_LAUNCHES, reps=5):
    """Device ms a call over a run: one event pair around ``launches``
    calls ``fn(*copy)`` back to back, divided by ``launches``, the median of
    ``reps`` runs. Call i takes copy i % c of ``args``, with c copies that
    together hold at least ``RUN_BYTES`` (at most ``launches``; one when
    ``args`` already do), so each call reads its inputs from device memory,
    as the bound assumes; inputs under 1 MB stay in L2 all the same. Each
    run is queued behind a sleep kernel that outlasts the host's issue of
    the run, and the start event must still be pending when the last call
    is issued, so the card runs the calls back to back and the time is the
    device's, not the host's."""
    nbytes = sum(t.untyped_storage().nbytes() for t in args)
    copies = 1 if nbytes == 0 else min(launches, max(1, -(-RUN_BYTES // nbytes)))
    sets = [tuple(args)] + [tuple(t.clone() for t in args) for _ in range(copies - 1)]
    for i in range(copies):
        fn(*sets[i])
    sync(torch)
    t0 = time.perf_counter()
    for i in range(launches):
        fn(*sets[i % copies])
    host_s = time.perf_counter() - t0
    sync(torch)
    cycles = max(SLEEP_CYCLES, int(4 * host_s * SM_HZ))
    times = []
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(launches):
            fn(*sets[i % copies])
        end.record()
        pending = not start.query()
        end.synchronize()
        if pending:
            times.append(start.elapsed_time(end) / launches)
        else:  # the host was still issuing when the run began: sleep longer
            cycles *= 4
            assert cycles < 1e12, "the host cannot stay ahead of the run"
    return statistics.median(times)


def timed(torch, fn, args, run=True, **kw):
    """``(ms, run_ms)`` of ``fn(*args)``: one launch behind a sleep
    (:func:`device_ms`), and a run of launches (:func:`run_ms`), which a
    row whose single launch exceeds ``RUN_MAX_MS`` skips (None), as does a
    call of many launches (``run=False``: a run of them would fill the
    card's launch queue before the sleep ends)."""
    ms = device_ms(torch, lambda: fn(*args), **kw)
    return ms, (run_ms(torch, fn, args) if run and ms <= RUN_MAX_MS else None)


def time_row(torch, name, mode, kernel, plain, library=None, **row):
    """A phase-4 row: the kernel and the library call (``(fn, args)`` each,
    or None) timed both ways, the plain version (a no-argument call) one
    launch at a time."""
    fn, args = kernel
    ms, run = timed(torch, fn, args, run=row.pop("run", True), **row.pop("kernel_kw", {}))
    lib_ms = lib_run = None
    if library is not None:
        lib_ms, lib_run = timed(torch, *library)
    plain_ms = device_ms(torch, plain, **row.pop("plain_kw", {}))
    return dict(name=name, mode=mode, ms=ms, run_ms=run, plain_ms=plain_ms, library_ms=lib_ms,
                library_run_ms=lib_run, **row)


def wire_rows(torch, wire, ref, J, P, gen, suffix="", modes=("sfvi", "sfvi_avg")):
    """The upload in ``modes`` and the mean combine at (J, P); each row's mode
    carries ``suffix``. Returns the rows and the (x, ones) inputs."""
    x = torch.randn((J, P), generator=gen, device=DEVICE)
    noise = torch.randn((J, P), generator=gen, device=DEVICE)
    refrow = 0.1 * torch.randn((P,), generator=gen, device=DEVICE)
    ones = torch.ones((J,), device=DEVICE)
    f4 = 4
    rows = []
    col = ones[:, None]
    uploads = {
        # mode: (kwargs, bytes moved: inputs read once + outputs written once,
        #        one PyTorch call computing the same function, or None)
        # SFVI: a masked copy (fallback 0) -> x * mask
        "sfvi": (dict(mask=ones), J * P * f4 * 2 + J * f4, lambda x: x * col),
        # SFVI-Avg without clip: masked select of the reference -> lerp
        "sfvi_avg": (dict(mask=ones, reference=refrow),
                     J * P * f4 * 2 + P * f4 + J * f4,
                     lambda x: torch.lerp(refrow, x, col)),
        # clip + DP + int8: no single PyTorch call
        "sfvi_avg_int8_dp": (dict(mask=ones, reference=refrow, clip_norm=0.3,
                                  noise_multiplier=0.3, quantize=True),
                             J * P * f4 * 2 + P * f4 + J * f4 + J * P + J * f4, None),
    }
    for mode in modes:
        kw, nbytes, library = uploads[mode]
        dp = "noise_multiplier" in kw
        args = (x, noise) if dp else (x,)

        def upload(x, nz=None, kw=kw, dp=dp):
            return wire.fused_upload(x, **kw, **({"noise": nz} if dp else {}))

        if library is not None:  # the yardstick computes the same function
            assert float((library(x) - upload(x)).abs().max()) <= 1e-6, mode
        rows.append(time_row(
            torch, "fused_upload", mode + suffix, (upload, args),
            lambda kw=kw, dp=dp: ref.wire_upload_ref(x, **kw, **({"noise": noise} if dp else {})),
            None if library is None else (library, (x,)), nbytes=nbytes, flops=12 * J * P,
            shape=[J, P]))
    denom = torch.sum(ones)
    rows.append(time_row(
        torch, "fused_combine", "mean" + suffix,
        (lambda x: wire.fused_combine(x, ones), (x,)),
        lambda: ref.masked_weighted_mean_ref(x, ones),
        (lambda x: torch.mv(x.T, ones) / denom, (x,)),
        nbytes=J * P * f4 + J * f4 + P * f4, flops=2 * J * P, shape=[J, P]))
    return rows, x, ones


def timings(np, torch, wire, ref, reparam, attention, gla, rmsnorm, gen):
    J, P = MAIN_J, MAIN_P
    f4 = 4
    rows = []
    # The launch floor: one launch that does no work (PyTorch's spin kernel
    # asked to spin 0 cycles), timed both ways.
    floor_ms, floor_run = timed(torch, lambda: torch.cuda._sleep(0), ())
    rows.append(dict(name="empty_kernel", mode="launch_floor", ms=floor_ms, run_ms=floor_run,
                     plain_ms=None, library_ms=None, library_run_ms=None, nbytes=0, flops=0,
                     shape=[]))
    main_rows, x, ones = wire_rows(torch, wire, ref, J, P, gen,
                                   modes=("sfvi", "sfvi_avg", "sfvi_avg_int8_dp"))
    rows += main_rows
    q, s = wire.fused_upload(x, mask=ones, quantize=True)
    # The trimmed mean dequantizing int8 in the kernel: no single PyTorch call.
    rows.append(time_row(
        torch, "fused_combine", "trimmed_int8",
        (lambda q: wire.fused_combine(q, ones, scales=s, trim_frac=0.1), (q,)),
        lambda: ref.masked_trimmed_mean_ref(ref.int8_rows_dequant_ref(q, s), ones, 0.1),
        nbytes=J * P + 2 * J * f4 + P * f4,
        flops=int(J * math.ceil(math.log2(J))) * P + 2 * J * P))
    # The upload and the mean at the paper models' full-width rows:
    # multinomial's (25, 15,702) and ProdLDA's (3, 84,002).
    for Jp, Pp in PAPER_SHAPES[1:]:
        rows += wire_rows(torch, wire, ref, Jp, Pp, gen, suffix=f"_{Jp}x{Pp}")[0]
    # The combine kernel at the barycenter's shapes: the glmm means (2, 5)
    # and hier_bnn's moment rows (10, 50,177).
    for Jc, Pc in [(2, 5), (10, 50_177)]:
        xc = torch.randn((Jc, Pc), generator=gen, device=DEVICE)
        wc = torch.ones((Jc,), device=DEVICE)
        denom = torch.sum(wc)
        rows.append(time_row(
            torch, "fused_combine", f"mean_{Jc}x{Pc}",
            (lambda xc, wc=wc: wire.fused_combine(xc, wc), (xc,)),
            lambda xc=xc, wc=wc: ref.masked_weighted_mean_ref(xc, wc),
            (lambda xc, wc=wc, denom=denom: torch.mv(xc.T, wc) / denom, (xc,)),
            nbytes=Jc * Pc * f4 + Jc * f4 + Pc * f4, flops=2 * Jc * Pc, shape=[Jc, Pc]))
    rows += ns_timings(torch, wire, ref, gen) + reparam_timings(torch, reparam, ref, gen)
    rows += backbone_timings(torch, attention, gla, rmsnorm, ref, gen)
    for row in rows:
        peak = row.pop("peak", F32_FLOPS)
        row["bound_ms"] = max(row["nbytes"] / HBM_BYTES_PER_S, row["flops"] / peak) * 1e3
        row["bound_by"] = ("bytes" if row["nbytes"] / HBM_BYTES_PER_S
                           >= row["flops"] / peak else "operations")
        print(json.dumps({"timing": row, "shape": row.pop("shape", [J, P])}), flush=True)
    return rows


def wall_ms(torch, fn, reps=20, warmup=3):
    """Median host time of ``fn`` up to its results on the card (a call and
    a synchronize): what a caller that reads the result right away waits."""
    for _ in range(warmup):
        fn()
    sync(torch)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(torch)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def host_us(torch, fn, calls=200, reps=7):
    """Median host time to issue one call of ``fn``, in µs: ``calls`` calls
    back to back, then a synchronize outside the clock. Only for calls whose
    kernels are shorter than their issue, so the card's queue never fills."""
    fn()
    sync(torch)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        sync(torch)
    return statistics.median(times)


def rmsnorm_host_us(torch, rmsnorm):
    """Host µs a call at decode's (8, 3,584) bf16: the wrapper's and
    ``F.rms_norm``'s. Takes the module, so a second checkout's wrapper can
    be timed by the same code."""
    import torch.nn.functional as F

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(7)
    x = torch.randn((8, 3584), generator=gen, device=DEVICE).to(torch.bfloat16)
    w = torch.ones((3584,), device=DEVICE, dtype=torch.bfloat16)
    return {"host_us": host_us(torch, lambda: rmsnorm.rmsnorm(x, w)),
            "library_host_us": host_us(torch, lambda: F.rms_norm(x, (3584,), weight=w,
                                                                 eps=1e-6))}


def ns_timings(torch, wire, ref, gen):
    """The step at the barycenter's shapes, on each side of the root
    kernel's limit d and at larger d. The library yardstick is PyTorch's own
    batched products for the same step: t = baddbmm(1.5 I, z, y,
    alpha=-0.5), then bmm(y, t) and bmm(t, z). Forty times a step's time is
    the step route's device work at that d.

    Then the 40-step root at the path's shapes and at the wrapper's limit d:
    the root kernel against the route the barycenter took before it (40
    step calls, ``steps_ms``), both also as host wall time per call
    (``wall_ms``, ``steps_wall_ms``); one past the limit and at d = 64, the
    wrapper's step route alone. No single PyTorch call computes the root,
    so it has no library time."""
    rows = []
    lim = wire.NS_ROOT_MAX_D
    for B, d in [(2, 5), (10, 5), (1, lim), (1, lim + 1), (1, 64), (1, 257), (1, 1970)]:
        y = torch.randn((B, d, d), generator=gen, device=DEVICE) / math.sqrt(d)
        z = torch.randn((B, d, d), generator=gen, device=DEVICE) / math.sqrt(d)
        half3 = (1.5 * torch.eye(d, device=DEVICE)).expand(B, d, d)

        def library(y, z, half3):
            t = torch.baddbmm(half3, z, y, alpha=-0.5)
            return torch.bmm(y, t), torch.bmm(t, z)

        got, want = library(y, z, half3), ref.newton_schulz_step_ref(y, z)
        assert max(float((a - b).abs().max()) for a, b in zip(got, want, strict=True)) <= 1e-4
        rows.append(time_row(
            torch, "newton_schulz_step", f"B{B}_d{d}",
            (lambda y, z: wire.newton_schulz_step(y, z), (y, z)),
            lambda y=y, z=z: ref.newton_schulz_step_ref(y, z),
            (library, (y, z, half3)),
            # y, z read once and y t, t z written once; 3 products of 2 d^3
            nbytes=B * 4 * d * d * 4, flops=B * 3 * 2 * d**3, shape=[B, d, d]))
    for B, d in NS_PATH_SHAPES + [(1, lim), (1, lim + 1), (1, 64)]:
        spd = spd_batch(torch, B, d, gen)

        def steps(spd):
            return ref.newton_schulz_sqrtm_ref(spd, 40, step=wire.newton_schulz_step)

        # Up to the limit the root kernel, with the 40-step route beside it;
        # past it the wrapper's own route is the 40 step calls.
        root = (lambda spd: wire._sqrtm_root(spd, 40)) if d <= lim else steps
        slow = {} if d <= lim else dict(reps=5, warmup=1)
        rows.append(time_row(
            torch, "sqrtm_newton_schulz", f"B{B}_d{d}" + ("_step_route" if d > lim else ""),
            (root, (spd,)), lambda spd=spd: ref.newton_schulz_sqrtm_ref(spd, 40),
            kernel_kw=slow, plain_kw=dict(reps=5, warmup=1), run=d <= lim,
            steps_ms=device_ms(torch, lambda spd=spd: steps(spd), reps=5, warmup=1)
            if d <= lim else None,
            wall_ms=wall_ms(torch, lambda spd=spd: root(spd), **slow),
            steps_wall_ms=wall_ms(torch, lambda spd=spd: steps(spd), reps=5, warmup=1)
            if d <= lim else None,
            # the matrices read once and the roots written once; 40 steps of
            # 3 products of 2 d^3 (norm and rescale aside)
            nbytes=2 * B * d * d * 4, flops=B * 40 * 3 * 2 * d**3, shape=[B, d, d]))
    return rows


def reparam_timings(torch, reparam, ref, gen):
    """Forward and backward in f32 at hier_bnn's J x local dim and at its
    global dim. The forward's yardstick is ``torch.addcmul(mu, ls.exp(),
    eps)`` for z; no single PyTorch call computes the backward."""
    rows = []
    for n in (508_160, 50_177):
        mu, ls, eps, dz = (torch.randn((n,), generator=gen, device=DEVICE) for _ in range(4))
        ls = 0.3 * ls - 1.0
        dlq = torch.tensor(0.37, device=DEVICE)
        rows.append(time_row(
            torch, "reparam_stl_fwd", f"f32_N{n}", (reparam.reparam_fwd, (mu, ls, eps)),
            lambda mu=mu, ls=ls, eps=eps: ref.reparam_stl_ref(mu, ls, eps),
            (lambda mu, ls, eps: torch.addcmul(mu, ls.exp(), eps), (mu, ls, eps)),
            nbytes=16 * n + 4, flops=5 * n, shape=[n]))
        rows.append(time_row(
            torch, "reparam_stl_bwd", f"f32_N{n}",
            (lambda ls, eps, dz, dlq=dlq: reparam.reparam_bwd(ls, eps, dz, dlq), (ls, eps, dz)),
            lambda ls=ls, eps=eps, dz=dz, dlq=dlq: ref.reparam_stl_bwd_ref(ls, eps, dz, dlq),
            nbytes=24 * n + 4, flops=6 * n, shape=[n]))
    return rows


def flash_work(B, Sq, Skv, H, KV, hd, elt):
    """Bytes (q, k, v read once, out written once) and flops (4 hd per live
    (query, key) pair, causal with q_offset 0)."""
    live = sum(min(i + 1, Skv) for i in range(Sq))
    return (2 * B * Sq * H * hd + 2 * B * Skv * KV * hd) * elt, 4 * hd * live * B * H


FLASH_TIMES = [("zamba2_prefill_4096_bf16", 4, 4096, 32, 32, 112),
               ("zamba2_prefill_64_bf16", 8, 64, 32, 32, 112),
               ("qwen3_prefill_512_bf16", 8, 512, 32, 8, 128)]
GLA_TIMES = [("zamba2_prefill_4096_bf16", 4, 4096, 112, 64, 64),
             ("zamba2_prefill_64_bf16", 8, 64, 112, 64, 64)]
RMS_TIMES = [("d3584_r16384_bf16", 4 * 4096, 3584), ("d7168_r16384_bf16", 4 * 4096, 7168),
             ("d2560_r4096_bf16", 8 * 512, 2560), ("d128_r131072_bf16", 8 * 512 * 32, 128),
             ("d3584_r8_bf16", 8, 3584)]


def backbone_timings(torch, attention, gla, rmsnorm, ref, gen):
    """The three backbone kernels at their serve shapes, bf16."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    rows = []
    for mode, B, S, H, KV, hd in FLASH_TIMES:
        q = torch.randn((B, S, H, hd), generator=gen, device=DEVICE).to(bf16)
        k, v = (torch.randn((B, S, KV, hd), generator=gen, device=DEVICE).to(bf16)
                for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def library(qt, kt, vt):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

        lib_err = float((library(qt, kt, vt).transpose(1, 2).float()
                         - attention.flash_attention(q, k, v).float()).abs().max())
        assert lib_err <= 2e-2 * (1 + float(v.float().abs().max())), (mode, lib_err)
        nbytes, flops = flash_work(B, S, S, H, KV, hd, 2)
        # The tensor-core kernel with one (64 q rows) and two (128) warpgroups
        # a block; the wrapper's choice carries the plain mode name.
        for q_rows in attention.TC_Q_ROWS:
            rows.append(time_row(
                torch, "flash_attention",
                mode if q_rows == attention.tc_q_rows(S) else f"{mode}_q{q_rows}",
                (lambda q, k, v, r=q_rows: attention.flash_attention(q, k, v, q_rows=r),
                 (q, k, v)),
                lambda q=q, k=k, v=v: ref.flash_attention_plain(q, k, v),
                (library, (qt, kt, vt)), plain_kw=dict(reps=5, warmup=1),
                nbytes=nbytes, flops=flops, peak=BF16_FLOPS, shape=[B, S, H, KV, hd]))
    for mode, B, S, H, N, P in GLA_TIMES:
        q, k, v, log_a = gla_inputs(torch, B, S, H, N, P, True, gen, bf16)
        qg, kg = q[:, :, :1], k[:, :, :1]  # the (B, S, 1, N) groups mamba2 expands
        # The serve path's call (mamba2_prefill: y and the final state) carries
        # the plain mode name; "_nostate" is y alone (mamba2_block).
        for with_state in (True, False):
            rows.append(time_row(
                torch, "gla", mode + ("" if with_state else "_nostate"),
                (lambda qg, kg, v, a, r=with_state, H=H:
                 gla.gla(qg.expand(-1, -1, H, -1), kg.expand(-1, -1, H, -1), v, a,
                         return_state=r), (qg, kg, v, log_a)),
                lambda q=q, k=k, v=v, a=log_a, r=with_state:
                ref.gla_plain(q, k, v, a, chunk=gla.CHUNK, return_state=r),
                plain_kw=dict(reps=5, warmup=1),
                # q, k: one (B, S, N) group each; v and y (B, S, H, P) bf16;
                # log_a f32; the state (B, H, N, P) f32 when asked.
                # Operations: the recurrence's 4 N P a (step, head).
                nbytes=2 * B * S * N * 2 + 2 * B * S * H * P * 2 + B * S * H * 4
                + (B * H * N * P * 4 if with_state else 0),
                flops=4 * N * P * B * S * H, peak=BF16_FLOPS, shape=[B, S, H, N, P]))
    for mode, R, D in RMS_TIMES:
        x = torch.randn((R, D), generator=gen, device=DEVICE).to(bf16)
        w = (1.0 + 0.2 * torch.randn((D,), generator=gen, device=DEVICE)).to(bf16)

        def library(x, w=w, D=D):
            return F.rms_norm(x, (D,), weight=w, eps=1e-6)

        lib_err = float((library(x).float() - rmsnorm.rmsnorm(x, w).float()).abs().max())
        assert lib_err <= 2e-2 * (1 + float(x.float().abs().max())), (mode, lib_err)
        dst = torch.empty_like(x)
        plan = rmsnorm._rmsnorm_plan(R, D, x, w)
        rows.append(time_row(
            torch, "rmsnorm", mode, (lambda x, w=w: rmsnorm.rmsnorm(x, w), (x,)),
            lambda x=x, w=w: ref.rmsnorm_plain(x, w), (library, (x,)),
            # a device copy of x: one read and one write of the same bytes,
            # the practical floor under a single pass
            copy_ms=device_ms(torch, lambda x=x, dst=dst: dst.copy_(x)),
            plan=f"{plan.lanes} lanes x {plan.vpl} vectors",
            nbytes=2 * R * D * 2 + D * 2, flops=4 * R * D, peak=BF16_FLOPS, shape=[R, D],
            **(rmsnorm_host_us(torch, rmsnorm) if (R, D) == (8, 3584) else {})))
    return rows


KERNELS = {
    # name: (source, the TPU kernel it replaces, the timing mode of its line)
    "fused_upload": ("src/repro_torch/csrc/wire.cu", "src/repro/kernels/wire.py:137", "sfvi"),
    "fused_combine": ("src/repro_torch/csrc/wire.cu", "src/repro/kernels/wire.py:242", "mean"),
    "newton_schulz_step": ("src/repro_torch/csrc/newton_schulz.cu",
                           "src/repro/kernels/wire.py:310", "B2_d5"),
    "sqrtm_newton_schulz": ("src/repro_torch/csrc/newton_schulz.cu",
                            "src/repro/kernels/wire.py:335", "B2_d5"),
    "reparam_stl_fwd": ("src/repro_torch/csrc/reparam.cu", "src/repro/kernels/reparam.py:57",
                        "f32_N508160"),
    "reparam_stl_bwd": ("src/repro_torch/csrc/reparam.cu", "src/repro/kernels/reparam.py:128",
                        "f32_N508160"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/attention.py:98", "zamba2_prefill_4096_bf16"),
    "gla": ("src/repro_torch/csrc/gla.cu", "src/repro/kernels/gla.py:73",
            "zamba2_prefill_4096_bf16"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:23",
                "d3584_r16384_bf16"),
}


# The serve path's flash and GLA calls are bf16, so their entries count the
# tensor-core kernels' launches (the SIMT kernels are the f32 parity route).
KERNEL_COUNTER = {"flash_attention": "flash_attention_tc", "gla": "gla_tc"}


def kernels_line(rows, launches, errors):
    """The ``kernels`` entries: each kernel's row at its main-path shape.

    ``launches`` are the main-path runs' counts (the federated rounds for the
    wire kernels, the three serve runs for the backbone's); the reparam
    kernels are on no round's path (as in the JAX package), so theirs is 0,
    and neither is the step kernel: the barycenter's d = 5 roots take the
    square-root kernel, and the step serves only d past its limit.
    """
    by_mode = {(r["name"], r["mode"]): r for r in rows}
    out = []
    for name, (source, replaces, mode) in KERNELS.items():
        row = by_mode[(name, mode)]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches.get(KERNEL_COUNTER.get(name, name), 0),
            "max_abs_err": errors[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "run_ms": row["run_ms"], "library_run_ms": row["library_run_ms"],
        })
    return out


def main(timings_only: bool = False) -> int:
    """The smoke check; ``timings_only`` (``--timings``) runs phases 1 and 4
    alone and prints the timing rows, no ``kernels`` or ``ok`` line."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    if not (SRC / "repro_torch").is_dir():
        return fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The plain Newton–Schulz step (and its cuBLAS yardstick) must be full f32.
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32

    from repro_torch.kernels import attention, build, gla, ref, reparam, rmsnorm, wire

    # Phase 1: the card, then the build (one nvcc per source, in parallel).
    card = gpu_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f}s for {sorted(build.SOURCES)}", flush=True)
    phase_s, mark = {"build": time.perf_counter() - t0}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name], mark[0] = now - mark[0], now

    # Phase 2: kernels against their plain versions, then the port end to end.
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1234)
    if timings_only:
        print("phase 4: timings", flush=True)
        timings(np, torch, wire, ref, reparam, attention, gla, rmsnorm, gen)
        return 0
    print("phase 2: kernels vs plain versions", flush=True)
    err_up = check_upload(torch, wire, ref, MAIN_J, MAIN_P, gen)
    for J, P in UPLOAD_SHAPES + PAPER_SHAPES:
        check_upload(torch, wire, ref, J, P, gen)
    check_upload(torch, wire, ref, MAIN_J, MAIN_P, gen, offset=1)
    err_co = check_combine_all(torch, wire, ref, gen)
    err_ns = check_ns_step(torch, wire, ref, gen)
    err_rp = check_reparam(torch, reparam, ref, gen)
    lap("2 wire, NS, reparam kernels")
    check_port_cuda_vs_cpu(np, torch)
    lap("2b port card vs CPU")
    err_bb = check_backbone_kernels(torch, attention, gla, rmsnorm, ref, gen)
    lap("2c backbone kernels")
    parity = check_backbone_cuda_vs_cpu(torch)
    print(json.dumps({"backbone_cuda_vs_cpu": parity}), flush=True)
    lap("2d backbone card vs CPU")

    # Phase 3: the main paths at full width.
    print("phase 3: main paths at full width (hier_bnn, glmm, multinomial, hetero_mn, "
          "prodlda)", flush=True)
    totals, seconds, profiles = main_path(np, torch, wire, reparam)
    lap("3 main paths")
    for label, round_s in seconds.items():
        print(json.dumps({"s_per_round": label, "rounds": round_s,
                          "median_after_first": statistics.median(round_s[1:])}),
              flush=True)
        print(json.dumps({"profile": label, **profiles[label]}), flush=True)
    print("phase 3b: backbone serve runs at full width (bf16)", flush=True)
    bb_totals, serve_results = serve_runs(torch, [attention, gla, rmsnorm], [wire, reparam])
    for res in serve_results:
        print(json.dumps(res), flush=True)
    lap("3b serve runs")

    # Phase 4: timings.
    print("phase 4: timings", flush=True)
    rows = timings(np, torch, wire, ref, reparam, attention, gla, rmsnorm, gen)
    lap("4 timings")
    print(json.dumps({"phase_s": phase_s}), flush=True)
    kernels = kernels_line(rows, {**totals, **bb_totals},
                           {"fused_upload": err_up, "fused_combine": err_co,
                            **err_ns, **err_rp, **err_bb})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    modes = {"--mutants": lambda: mutants_main(["combine", "reparam", "rmsnorm"]),
             "--gla-mutants": lambda: mutants_main(["gla"]),
             "--timings": lambda: main(timings_only=True)}
    args = sys.argv[1:]
    if args[:1] == ["--check"] and len(args) == 2:
        sys.exit(check_main(args[1]))
    if args and (len(args) > 1 or args[0] not in modes):
        sys.exit(fail(f"unknown arguments {args!r}; takes none, one of {sorted(modes)}, "
                      f"or --check with one of {sorted(MUTANT_GROUPS)}"))
    sys.exit(modes[args[0]]() if args else main())
