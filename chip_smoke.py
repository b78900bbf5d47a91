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
     path's shapes, the barycenter's (10, 50,177) (and the churn's (8, 50,177)
     and (9, 50,177)), glmm's (2, 5), (2, 20)
     and (6, 20) with trim 0.2, P % 4 = 1, 2, 3, odd P in int8, J = 33
     and 64 trimmed and x one element off 16 bytes, each case run twice
     (bit-identical), and its shared-memory plan against the source's; its
     cases include an async flush's weights, count · (1 + staleness)^-0.5
     with one silo counted twice, through the mean and the trimmed mean.
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
     (4, 4,096, 32/32, 112), qwen3's (8, 512, 32/8, 128), the GQA groups
     of 3 and 8 (llama3.2-3b's (8, 64, 24/8, 128), qwen3-32b's (8, 512,
     64/8, 128)), olmoe-1b-7b's (8, 512, 16/16, 128) and qwen2-vl-2b's
     group of 6 (8, 512, 12/2, 128), a decode shape
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
     wrapper's), and the first GLA launch of a zamba2-7b prefill on the
     model's own inputs (6 layers at prompt 64, and phase 3b's 12-layer
     prompt-4,096 cell), where random inputs do not show a P rounded to
     bf16 once; RMSNorm at D = 3,584,
     7,168, 2,560, 3,072, 4,096, 5,120, 2,048, 1,536 and 128 (every width
     of the serve cells) with ragged row counts and rows at scales 2^-4
     to 2^4, on 16-byte vectors and, with x one element off 16 bytes, on
     the scalar route, each bf16 output also element by element within
     one bf16 step of the plain value, and on plans where a few blocks
     walk many rows of two to eight warps at scales 2^-12 to 2^12
     (``RMS_WALKS``, 20 launches each). Flash attention, GLA and RMSNorm
     each refuse a card input that requires grad while grad mode is on
     (the kernels have no backward), before any launch. And the backbone
     on the card against the backbone on the CPU in f32 at full width, B =
     2, prompt 32, greedy gen 4: zamba2-7b with one hybrid unit (6
     layers), olmoe-1b-7b with one MoE layer (the routing compared call by
     call: flipped (token, slot) pairs counted, the smallest top-k margin
     printed, the CPU's experts handed to the card's block where any
     flipped) and qwen2-vl-2b with 2 layers behind its 256 vision tokens;
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
     device's busy and idle share. Then phase 3c, the experiment API
     (``repro_torch.federated.api``, ``runtime.wire = "fused"``), the
     counters set to 0 just before each run and read just after:
       the smoke config's SFVI-Avg + DP (z 0.3, C 0.3) 25 rounds whole,
       and as 12 rounds + ``save`` + ``Experiment.resume`` into a fresh
       object + 13 rounds: every state leaf and the whole history
       bit-identical to the whole run, 126,144 B a round, ε within 1e-4
       of 289.2907; PVI and federated EP on the smoke config, 9 rounds
       each (126,144 B, (1, 1) launches a round of (upload, combine));
       hier_bnn at §4.1 width through the CLI's ``main``: SFVI-Avg +
       int8 + trimmed (0.1), 4 rounds with ``--ckpt-dir`` and
       ``--ckpt-every 2``, then ``--resume`` of the round-2 step in a
       fresh ``main`` call, whose step-4 files must equal the whole
       run's byte for byte; hier_bnn PVI 3 rounds; the GLMM + Cholesky
       SFVI-Avg as 2 rounds + save/resume + 1, bit-identical, 100 root
       launches a round. Each run prints its s/round, save and resume
       ms, bytes and launches a round. Then phase 3d, buffered-async
       flushes (``async_engine.run_buffered``), silo churn
       (``population.PopulationEngine``) and the posterior endpoint
       (``federated.serve``), through the API on the fused wire, counters
       set to 0 just before each run and read just after: the smoke
       config's SFVI-Avg async (B = 2, straggler), 25 flushes, 63,072 B a
       flush, 28.0 simulated seconds; the same + int8 + DP (z 0.3, C 0.3)
       whole and as 12 + save/resume + 13, bit-identical (the
       ``BufferState`` too), 39,428 B a flush, ε within 1e-4 of 254.6345;
       hier_bnn at §4.1 width, B = 3, int8 + trimmed (0.1) + DP, 6 flushes
       of 1,505,322 B, some weight not 0 or 1; the GLMM + Cholesky, B = 2,
       lognormal, 3 flushes of 320 B and 100 root launches (these two
       profiled for 2 more flushes); hier_bnn churn (a roster of 10 from 4,
       warm starts, 8 rounds, whole and 4 + save/resume + 4, the
       ``PopulationState`` too; a line a round with the live J, joins,
       departures and returns) and the smoke config's async churn (2 of
       4, 10 flushes, 5 + save/resume + 5); then ``Posterior`` on the churn
       run's last checkpoint: 48 sample queries of n = 32 over the live
       silos and one global sample, 16 timed repeats (median ms,
       queries/s, samples/s), equal answers from a second replica, each
       answer its slice of its group's draw, ``predict`` on 200 test
       images (n = 8) beside the run's eval, and the serve CLI once. Every
       upload, combine and root launch of these runs (each J the churn
       reaches, each flush's weights) is held against its plain version
       on its own inputs, and the host clock around the event loops
       (``simulate_flush``, ``begin_flush`` / ``begin_round``,
       ``grow_silos``) is printed per flush. Last, the event loops on the
       card against the same spec on the CPU on one injected stream (the
       smoke async + DP row and its async churn, 6 flushes each, and
       hier_bnn churn at phase 2b's small width, 4 rounds, to phase 2b's
       tolerances; hier_bnn churn at §4.1 width, 4 rounds, its ELBO to
       1e-3 and its η_G gap beside the CPU's own from a start one float32
       step away). Then phase 3e, multi-process federation
       (``repro_torch.federated.distributed``): each of ``mp_specs()``
       runs once in this process on the card, then on ranks this script
       spawns (``--mp-worker``; the kernels are built before any starts,
       every rank's exit code is checked and each join has a timeout):
       (a) a 1-rank NCCL world, hier_bnn SFVI-Avg at §4.1 width,
       bit-identical to the run without a world; (b) 2 gloo ranks sharing
       the card, 5 silo rows each: hier_bnn SFVI (16,056,640 B up a
       round) and SFVI-Avg + int8 + trimmed (0.1) + DP (z 0.3, C 0.3)
       (1,003,580 B), the GLMM + Cholesky SFVI-Avg (1 row a rank, 100 root
       launches a round a rank), the smoke config's SFVI (504,576 B up +
       down) and its SFVI-Avg at J = 7 (the silo axis padded to 8), and
       an owner-routed save → resume → 1 round, bit-exact; (c) 4 gloo
       ranks on (silo=2, model=2), the smoke SFVI equal to (b)'s bit for
       bit, ELBO included. The ranks are bit-identical; each run's state
       equals the one-process card run bit for bit, or (a batched op whose
       bits depend on its batch count) within 1e-3 relative, its largest
       gap printed; bytes, ε and each rank's launches equal the
       one-process run's, and every upload, combine and root launch of a
       rank is held to its plain version. An ``mp_run`` line a run and
       world prints s a round and the host ms of the gathers, labelled
       as ranks time-sliced on one card: the machine has one H100, so no
       multi-GPU speed is measured. Then the backbone's serve path
     (``repro_torch.launch.serve_backbone.serve``) at full width in bf16,
     with the flash-attention, GLA and RMSNorm launch counters set to 0
     just before each run and read just after (every bf16 flash and GLA
     call on the tensor-core kernels, none on the SIMT ones; no prefill
     calls ``gla_final_state``, mamba2's state comes from the GLA kernel):
     zamba2-7b at full depth (81 layers; batch 8, prompt 64, gen 32, 4
     silos: the JAX CLI's defaults),
     zamba2-7b at 12 layers (batch 4, prompt 4,096, gen 8), qwen3-4b at 4
     layers (batch 8, prompt 512, gen 16), llama3.2-3b at full depth (28
     layers; batch 8, prompt 64, gen 16), qwen3-8b at full depth (36
     layers; batch 8, prompt 512, gen 16), qwen3-32b at 16 of its 64
     layers (batch 8, prompt 512, gen 16), olmoe-1b-7b at full depth (16
     layers, 64 experts top 8) and phi3.5-moe at 8 of its 32 layers (16
     experts top 2), each batch 8, prompt 512, gen 16 (the capacity route
     once a layer in the prefill, every expert in decode, counted), and
     qwen2-vl-2b at full depth (28 layers; 256 stub vision tokens + a
     256-token prompt, gen 16), the parameter counts asserted (zamba2's and
     qwen3-4b's aside); the first RMSNorm and the first flash launch at
     each of a run's shapes held to its plain version as in phase 2; for
     the MoE cells one more prefill with CUDA events around each MoE block
     (their share of the prefill's device span); prefill and decode times,
     peak memory, then one more
     prefill and two more decode steps under ``torch.profiler``. Then
     phase 3f, the backbone's train path (``repro_torch.launch.train``'s
     ``setup`` and ``bytes_per_round``, the SFVI / SFVI-Avg steps of
     ``launch.steps``, ``federated.driver.run_rounds``) in bf16 at full
     width, J = 4, batch 8, sequence 64, lr 1e-3 (the JAX CLI's defaults),
     every counter set to 0 just before each cell and read just after:
     first one SFVI step and one SFVI-Avg barycenter step of qwen3-4b at
     full width with one layer in f32 (B = 4, S = 16, J = 2, injected ε
     and tokens) on the card and on the CPU (loss within 1e-4 relative,
     every θ, η_G and η_L leaf within 1e-3 relative Frobenius), and one
     SFVI step in bf16 (1e-3 and 1e-2); one SFVI step of olmoe-1b-7b
     (one MoE layer, its routing compared as in phase 2) and of qwen2-vl-2b
     (2 layers, its vision prefix) in f32 as qwen3-4b's; then
     qwen3-4b at 36 layers, SFVI 3 steps (35,330,945,056 B a round) and
     SFVI-Avg with ``avg_every`` 2, 4 steps (17,665,472,528 B), and
     zamba2-7b at 12 layers, SFVI 3 steps (9,726,671,392 B), and
     qwen3-4b at 36 layers at a long sequence: J = 2, batch 2, sequence
     4,096, ``remat=True``, SFVI 3 steps (17,665,472,528 B; 72
     ``chunked_attention`` calls and 36 ``checkpoint`` calls a step, none
     in the other cells), olmoe-1b-7b at 8 of 16 layers, SFVI 3 steps
     (28,522,381,344 B; ``aux_moe`` printed each step), and qwen2-vl-2b
     at 28 layers with the vision prefix, SFVI 3 steps (12,407,418,912 B):
     s/step, peak
     memory (under 80 GB), launches a step (2 reparam forwards and 2
     backwards, 2 combines on a barycenter step, no flash, GLA or
     RMSNorm), the loss each step, two more steps under ``torch.profiler``,
     and every reparam and combine launch held to its plain version on its
     own inputs. Then phase 3g, Figure S1 (``benchmarks/bench_glmm.py``)
     on the card: the GLMM at 536 children in two silos fitted by SFVI
     (K = 25, lr 2e-2, 60 rounds) through the experiment API on the fused
     wire, every upload and combine held to its plain version; the HMC
     oracle (``repro_torch.inference.hmc_sample``) on the pooled data (dim
     541, 400 warmup + 400 samples, 24 leapfrog steps), its first 50 draws
     also in float64 on the card and on the CPU on one injected stream
     (equal accept decisions, samples within 1e-5 of the largest); the
     table of marginal means and sds, the accept rate and the chain's
     seconds. Then phase 3h, the deprecated eager adapters
     (``repro_torch.core.runtime``): ``SFVIServer`` on hier_bnn at §4.1
     width, 3 rounds, bit for bit with the port's ``Server`` on the same
     inputs and its η_L rows written back into the Silos;
     ``SFVIAvgServer`` on the GLMM + Cholesky, 2 rounds of K = 25, 200
     root launches, every launch held. Then phase 3i, the train step over
     the ranks of a world (``launch.train``'s ``--mesh silo=N``; spawned
     ``chip_smoke.py --train-worker``): qwen3-4b at 36 layers, SFVI 3
     steps, in a 1-rank NCCL world; whisper-base at 6 + 6 layers in f32,
     SFVI and SFVI-Avg (``avg_every`` 2) on 2 gloo ranks sharing the card
     and SFVI on 4, and in bf16 SFVI on 2: each rank runs the one-process
     run first, then its silos on the mesh; the ranks bit-identical, each
     step's loss within 1e-4 relative of the one-process run's, each f32
     leaf within 1e-3 relative Frobenius of it (a bf16 run: at most 5 % of
     the state's elements more than one bf16 step from it, none more than
     (2·lr + one bf16 step) a step), bytes a round exact, 2 + 2 reparam
     launches a step a rank (2 combines a barycenter step), each held to
     its plain version; s/step, peak GB and the all-reduce's host ms;
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
     library call; the reparam kernels also at the train path's sizes
     (N = 1,235,969, 1,843,712 and 4,943,876) and the combine at its
     SFVI-Avg rows (4, 1,235,969); flash also at the GQA 3 and 8 shapes,
     olmoe's 16/16 and qwen2-vl's 12/2, every flash row with a run column; the square root at the
     path's shapes and the wrapper's limit d against the 40 step calls it
     replaced (device and host wall time), and the step route one past the
     limit and at d = 64.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. ``python3 chip_smoke.py --timings``
runs phases 1 and 4 alone (to time two checkouts in turns in one call);
``python3 chip_smoke.py --figure-s1`` phases 1 and 3g at Figure S1's full
lengths (240 rounds; 1,500 + 1,500 draws).

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
wrong dv-slice offset, the S_in copy written into the one being read,
the last dk tile's partial dropped from the reduction, P rounded to bf16
once).
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
import types
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
    # An async flush's weights, count · (1 + staleness)^-0.5: one silo
    # counted twice, staleness 0 to 3, a third of the silos absent.
    counts = (torch.arange(J, device=DEVICE) % 3 != 2).float()
    counts[0] = 2.0
    stale = (torch.arange(J, device=DEVICE) % 4).float()
    stale_w = counts * (1.0 + stale) ** -0.5
    return {
        "mean_all": dict(x=x, w=ones),
        "mean_partial": dict(x=x, w=part),
        "mean_frac_below_1": dict(x=x, w=frac),
        "mean_all_zero": dict(x=x, w=zeros),
        "mean_stale_weights": dict(x=x, w=stale_w),
        "mean_int8": dict(x=q, w=part, scales=s),
        "trim_0.34_partial": dict(x=x, w=part, trim_frac=0.34),
        "trim_0.2": dict(x=x, w=ones, trim_frac=0.2),
        "trim_ties": dict(x=ties, w=ones, trim_frac=0.2),
        "trim_n0": dict(x=x, w=zeros, trim_frac=0.34),
        "trim_n1": dict(x=x, w=one_active, trim_frac=0.34),
        "trim_n2": dict(x=x, w=two_active, trim_frac=0.34),
        "trim_int8": dict(x=q, w=part, scales=s, trim_frac=0.1),
        "trim_stale_weights": dict(x=x, w=stale_w, trim_frac=0.2),
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
# before leave other n, k and rows in shared memory. J = 8 and 9 at the
# barycenter's P: instantiations of the combine that only the churn reaches.
COMBINE_SHAPES = [(8, 50_177), (9, 50_177),
                  (7, 4099), (10, 50_177), (2, 5), (2, 20), (6, 20), (5, 4097), (3, 4098),
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
    from repro_torch.tree import tree_map

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
        hold_to_cpu(np, f"{label} {name}, fused vs flat, 3 rounds", hist["flat"], hist["fused"],
                    servers["flat"], servers["fused"])


def hold_to_cpu(np, label, h_cpu, h_card, srv_cpu, srv_card):
    """The port on the card against the port on the CPU after one run on one
    injected stream: the ELBO trace within 1e-3 relative, θ and η_G within
    1e-3, both absolute and relative to each leaf's largest entry, and the
    bytes up equal."""
    from repro_torch.tree import tree_leaves

    e_c = np.asarray(h_cpu["elbo_trace"])
    e_g = np.asarray(h_card["elbo_trace"])
    rel = float(np.max(np.abs(e_c - e_g) / np.abs(e_c)))
    pairs = [(a.cpu(), b) for key in ("theta", "eta_G")
             for a, b in zip(tree_leaves(srv_card.state[key]), tree_leaves(srv_cpu.state[key]),
                             strict=True)]
    diff = max(float((a - b).abs().max()) for a, b in pairs)
    diff_rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in pairs)
    print(f"  port on {DEVICE} vs the CPU [{label}]: elbo max_rel={rel:.2e} (<= 1e-3), "
          f"theta+eta_G max_abs={diff:.2e} (<= 1e-3), max_rel={diff_rel:.2e} (<= 1e-3, per "
          f"leaf against its largest entry)", flush=True)
    assert np.all(np.isfinite(e_g)) and rel <= 1e-3, label
    assert diff <= 1e-3 and diff_rel <= 1e-3, label
    assert h_cpu["bytes_up"] == h_card["bytes_up"], label


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
    ("llama_gqa3_prefill_64", 8, 64, 64, 24, 8, 128, True, None, 0, True),
    ("qwen3_32b_gqa8_prefill_512", 8, 512, 512, 64, 8, 128, True, None, 0, True),
    ("olmoe_prefill_512", 8, 512, 512, 16, 16, 128, True, None, 0, True),
    # qwen2-vl-2b: GQA groups of 6, over 256 vision + 256 text tokens
    ("qwen2_vl_gqa6_prefill_512", 8, 512, 512, 12, 2, 128, True, None, 0, True),
    ("decode_q_offset", 8, 1, 4104, 32, 8, 128, True, None, 4103, False),
    ("window_128", 2, 1000, 1000, 32, 8, 128, True, 128, 0, False),
    ("non_causal", 2, 256, 384, 32, 8, 128, False, None, 0, False),
    ("ragged_1000", 2, 1000, 1000, 32, 32, 112, True, None, 0, False),
    # whisper-base: the encoder over 1,500 frames (23 tiles of 64 and 28),
    # the cross-attention of a 64-token prompt and of a decode step to them,
    # and the decoder's causal self-attention
    ("whisper_encoder_1500", 8, 1500, 1500, 8, 8, 64, False, None, 0, True),
    ("whisper_cross_prefill_64", 8, 64, 1500, 8, 8, 64, False, None, 0, True),
    ("whisper_cross_decode", 8, 1, 1500, 8, 8, 64, False, None, 0, True),
    ("whisper_decoder_self_64", 8, 64, 64, 8, 8, 64, True, None, 0, True),
]
GLA_CHECKS = [
    # (label, B, S, H, dk, dv, q/k one group broadcast over heads, on the serve path)
    ("zamba2_prefill_64", 8, 64, 112, 64, 64, True, True),
    ("zamba2_prefill_4096", 4, 4096, 112, 64, 64, True, True),
    ("ragged_1000", 2, 1000, 112, 64, 64, True, False),
    ("dv65_mlstm_v_aug", 2, 300, 8, 64, 65, False, False),
    # xlstm-1.3b's mLSTM: d_inner 4,096 over 4 heads, plus the ones column:
    # 8 dk tiles of 128 and 17 dv slices (16 x 64 + 1), summed by the reduction
    ("mlstm_prefill_512", 8, 512, 4, 1024, 1025, False, True),
    ("mlstm_ragged_300", 2, 300, 4, 1024, 1025, False, False),
    ("dk129_dv130", 2, 300, 4, 129, 130, False, False),  # a 1-row dk tile, a 2-column slice
    ("dk256_dv64", 2, 300, 4, 256, 64, False, False),  # a dk split only
    ("dk64_dv1025", 2, 300, 4, 64, 1025, False, False),  # a dv split only: no reduction
]
RMS_CHECKS = [
    # (label, rows, D): ragged row counts at the serve path's widths
    ("zamba2_d_model", 4 * 4096 + 3, 3584),
    ("mamba2_out_norm", 515, 7168),
    ("qwen3_d_model", 4099, 2560),
    ("qwen3_qk_norm", 8 * 512 * 32 + 5, 128),
    ("llama3_2_3b_d_model", 8 * 64 + 3, 3072),
    ("qwen3_8b_d_model", 8 * 512 + 3, 4096),
    ("qwen3_32b_d_model", 8 * 512 + 3, 5120),
    ("qwen3_32b_q_norm", 8 * 512 * 64 + 5, 128),
    ("olmoe_d_model", 8 * 512 + 3, 2048),
    ("olmoe_q_norm", 8 * 512 * 16 + 5, 128),
    ("qwen2_vl_d_model", 8 * 512 + 3, 1536),
    ("whisper_d_model", 8 * 1500 + 3, 512),
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
# row), a row being the dv values of one (b, t, h): q, k and v enter the
# kernel as bf16, and P enters P v as a bf16 hi + lo pair. Late in a long walk the state term carries
# most of y, so a stale or skipped chunk state, or a column of another
# slice, moves whole rows by far more than that, where the max-abs limit,
# 2e-2 of the largest |y|, sees only the largest rows. The state after the
# last chunk is held in f32 relative Frobenius: within 1e-5 of the plain
# state on the SIMT (f32) route, and within 1e-4 on the tensor-core route,
# whose two f32 products take their operand as a bf16 hi + lo pair (about
# 2^-17 of each term).
GLA_BF16_STEP, GLA_BF16_ROW_RMS = 2.0 ** -7, 2.0 ** -6
GLA_TILE = 128  # rows of dk a GLA block takes (kernels.gla.MAX_DIM)
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


def check_gla(torch, gla, ref, gen) -> tuple:
    """GLA at ``GLA_CHECKS`` in bf16 (the tensor-core kernel) and f32 (the
    SIMT kernel), against the plain version: y
    within the max-abs limit (and, bf16, element by element), the final
    state within ``GLA_STATE_TOL``, y the same with and without the state,
    and the launch counters showing the route (and one reduction a call
    past dk = 128). Returns the largest bf16 max-abs error at the
    serve-path shapes, and at those past dk = 128 (the reduction's)."""
    check_gla_plan(gla)
    worst, worst_split = 0.0, 0.0
    for label, B, S, H, dk, dv, shared, main in GLA_CHECKS:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, log_a = gla_inputs(torch, B, S, H, dk, dv, shared, gen, dtype)
            want, want_state = ref.gla_plain(q, k, v, log_a, chunk=gla.CHUNK, return_state=True)
            tc = dtype == torch.bfloat16
            plan = gla.gla_plan(B, H, dk, dv, dtype, S)
            before = dict(gla.LAUNCHES)
            got, state = gla.gla(q, k, v, log_a, return_state=True)
            bare = gla.gla(q, k, v, log_a)
            sync(torch)
            route = "gla_tc" if tc else "gla"
            reduce = 2 if plan.dk_tiles > 1 else 0
            assert gla.LAUNCHES[route] == before[route] + 2, (label, gla.LAUNCHES)
            assert gla.LAUNCHES["gla_reduce"] == before["gla_reduce"] + reduce, gla.LAUNCHES
            assert sum(gla.LAUNCHES.values()) == sum(before.values()) + 2 + reduce, gla.LAUNCHES
            err = float((got.float() - want.float()).abs().max())
            ok, line = _check_line(label, err, want)
            rel = float((state - want_state).norm() / want_state.norm())
            state_tol = GLA_STATE_TOL[str(dtype)[6:]]
            ratio = gla_bf16_ratio(torch, got, want) if tc else 0.0
            print(f"  gla {label:<20} ({B},{S},{H},{dk},{dv}) {str(dtype)[6:]:<8} "
                  f"shared q/k={shared} [grid {plan.grid}]: {line}"
                  + (f", element ratio={ratio:.3f} (<= 1)" if tc else "")
                  + f", state rel={rel:.2e} (<= {state_tol:.0e})", flush=True)
            assert ok and got.dtype == dtype, (label, dtype)
            assert ratio <= 1.0, (label, ratio)
            assert rel <= state_tol and state.dtype == torch.float32, (label, dtype, rel)
            assert torch.equal(bare, got), (label, dtype)
            if main and tc:
                worst = max(worst, err)
                if plan.dk_tiles > 1:
                    worst_split = max(worst_split, err)
    worst = max(worst, check_gla_model_inputs(torch, ref))
    return worst, worst_split


# zamba2's own GLA inputs: the first launch of phase 3b's serve runs (the
# 12-layer prompt-4,096 cell exactly; the 64-token prompt at 6 layers, whose
# first mamba2 layer has the 81-layer cell's weights), where random inputs
# do not show a P rounded once (``GLA_MUTANTS``).
GLA_MODEL_CHECKS = [("zamba2-7b 6 layers, prompt 64", 6, 8, 64),
                    ("zamba2-7b 12 layers, prompt 4096", 12, 4, 4096)]


def check_gla_model_inputs(torch, ref) -> float:
    """The first GLA launch of a zamba2 prefill (``GLA_MODEL_CHECKS``), held
    to the plain version by max-abs and element by element (every case
    printed before any is asserted); returns the largest max-abs error."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_backbone import serve

    worst, results = 0.0, []
    for label, layers, B, prompt in GLA_MODEL_CHECKS:
        cfg = dataclasses.replace(get_config("zamba2-7b"), num_layers=layers)
        with FirstLaunches(torch) as first:
            run = serve(cfg, batch=B, prompt_len=prompt, gen=1, silos=4,
                        device=torch.device(DEVICE))
            sync(torch)
        (args, kw, got), = first.kept["gla"].values()  # one shape: the mamba2 layers'
        want = ref.gla_plain(*args, **kw)
        err = float((got.float() - want.float()).abs().max())
        ok, line = _check_line(label, err, want)
        ratio = gla_bf16_ratio(torch, got, want)
        print(f"  gla {label}: its first launch on the model's inputs "
              f"{tuple(args[0].shape)} x {tuple(args[2].shape)} {str(got.dtype)[6:]}: {line}, "
              f"element ratio={ratio:.3f} (<= 1)", flush=True)
        results.append((label, ok and ratio <= 1.0, err, ratio))
        worst = max(worst, err)
        del run, first
        torch.cuda.empty_cache()
    assert all(r[1] for r in results), results
    return worst


# Broken copies of the kernels, each of which its card check must fail
# (``python3 chip_smoke.py --mutants``, ``--gla-mutants``): (name, text in
# the source, its replacement). GLA's dv-slice offset is wrong for the
# second slice only, so dv = 65's last column is never written; the
# reduction that drops the last dk tile's partial is wrong past dk = 128
# only.
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
    ("last dk tile's partial dropped from the sum",
     "for (int z = 1; z < tiles; ++z) acc += ws[z * n + i];",
     "for (int z = 1; z < tiles - 1; ++z) acc += ws[z * n + i];"),
    # The earlier kernel: the lo part of P v only past dk = 128. Random inputs
    # read at most 0.78 of the element limit so; zamba2's own first launch
    # at prompt 4,096 (GLA_MODEL_CHECKS) read 2.057.
    ("P rounded to bf16 once up to dk = 128",
     "        mma(y[2 * np], pl[kk2], vb[0], vb[1]);\n"
     "        mma(y[2 * np + 1], pl[kk2], vb[2], vb[3]);\n",
     "        if constexpr (SPLIT) {\n"
     "          mma(y[2 * np], pl[kk2], vb[0], vb[1]);\n"
     "          mma(y[2 * np + 1], pl[kk2], vb[2], vb[3]);\n"
     "        }\n"),
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
    worst = {"flash_attention": 0.0, "gla": 0.0, "gla_reduce": 0.0, "rmsnorm": 0.0}
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
    worst["gla"], worst["gla_reduce"] = check_gla(torch, gla, ref, gen)
    worst["rmsnorm"] = check_rmsnorm_all(torch, rmsnorm, ref, gen)
    return worst


# ---------------------------------------------------------------------------
# Phase 2d: the backbone on the card against the backbone on the CPU
# ---------------------------------------------------------------------------


def check_grad_guard(torch, attention, gla, rmsnorm, gen):
    """Each backbone wrapper refuses a card input that requires grad while
    grad mode is on (the kernels have no backward), before any launch."""
    q = torch.randn((1, 64, 2, 64), generator=gen, device=DEVICE)
    la = -torch.rand((1, 64, 2), generator=gen, device=DEVICE)
    w = torch.ones((64,), device=DEVICE)
    x = q.clone().requires_grad_(True)
    calls = {"flash_attention": (attention, lambda: attention.flash_attention(x, q, q)),
             "gla": (gla, lambda: gla.gla(x, q, q, la)),
             "rmsnorm": (rmsnorm, lambda: rmsnorm.rmsnorm(x, w))}
    for name, (mod, call) in calls.items():
        before = dict(mod.LAUNCHES)
        try:
            call()
        except RuntimeError as err:
            assert f"{name}: the CUDA kernel has no backward" in str(err), err
        else:
            raise AssertionError(f"{name} took a card input that requires grad")
        assert mod.LAUNCHES == before, (name, mod.LAUNCHES)
        print(f"  {name}: refuses a card input that requires grad, before any launch",
              flush=True)


def greedy(torch, cfg, theta, eta_G, eta_L, batch, silos, gen_len):
    """Serve prefill + greedy decode of ``batch`` (tokens, and the vision
    prefix where the config has one); returns (every step's logits, tokens)."""
    from repro_torch.launch import steps as S

    max_len = batch["tokens"].shape[1] + gen_len + cfg.num_vision_tokens
    prefill = S.make_serve_prefill(cfg, silos, max_len=max_len)
    decode = S.make_serve_decode(cfg, silos)
    with torch.inference_mode():
        logits, cache = prefill(theta, eta_G, eta_L, batch)
        out_logits, out_tok = [logits.float().cpu()], [torch.argmax(logits[:, -1], -1)]
        for _ in range(gen_len - 1):
            logits, cache = decode(theta, eta_G, eta_L, out_tok[-1][:, None], cache)
            out_logits.append(logits.float().cpu())
            out_tok.append(torch.argmax(logits[:, -1], -1))
    return out_logits, torch.stack([t.cpu() for t in out_tok], 1)


class RouteLog:
    """The MoE blocks' routing (``moe._route``) on the CPU and on the card.
    Under ``record`` each call's experts are kept; under ``match`` each card
    call's experts are compared with the CPU's at the same call: the
    (token, slot) pairs that differ are counted, the smallest top-k margin
    on the card (the k-th minus the (k+1)-th router probability) kept, and
    where any pair differs the card's block is handed the CPU's experts
    (``_route(expert_idx=)``), so that its output is held on the same
    routing. A tolerance is never widened for a flip."""

    def __init__(self, torch):
        from repro_torch.models.backbone import moe

        self.torch, self.moe, self.real = torch, moe, moe._route
        self.kept, self.mode, self.i = [], None, 0
        self.flips, self.injected, self.margin = 0, 0, math.inf

    def __call__(self, mode):
        self.mode, self.i = mode, 0
        return self

    def __enter__(self):
        def route(router_w, x, E, k, expert_idx=None):
            assert expert_idx is None
            out = self.real(router_w, x, E, k)
            if self.mode == "record":
                self.kept.append(out[2].cpu())
                return out
            want = self.kept[self.i].to(x.device)
            self.i += 1
            top = self.torch.topk(out[0], k + 1, dim=-1).values
            self.margin = min(self.margin, float((top[..., k - 1] - top[..., k]).min().detach()))
            flips = int((out[2] != want).sum())
            self.flips += flips
            if not flips:
                return out
            self.injected += 1
            return self.real(router_w, x, E, k, expert_idx=want)

        self.moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.real
        if self.mode == "match" and exc[0] is None:
            assert self.i == len(self.kept), (self.i, len(self.kept))

    def line(self) -> str:
        return (f"routing: {len(self.kept)} MoE calls, {self.flips} (token, slot) pairs flipped"
                f" ({self.injected} calls given the CPU's experts), smallest top-k margin "
                f"{self.margin:.3e}")


# The backbone on the card against the CPU (f32, full width): (arch, layers,
# batch, prompt, greedy tokens, other config fields). zamba2-7b: one hybrid
# unit (5 mamba2 + the shared attention); olmoe-1b-7b: one MoE layer (64
# experts, top 8, the capacity route in prefill, every expert in decode);
# qwen2-vl-2b: two layers behind its 256-token vision prefix (M-RoPE, GQA
# 12/2); whisper-base: one encoder layer over 1,500 stub frames and one
# decoder layer (flash without a mask in the encoder and the cross-
# attention, in prefill and decode); xlstm-1.3b: one mLSTM (GLA at dk 1,024,
# dv 1,025 on the SIMT kernel's dk and dv split) and one sLSTM.
BACKBONE_PARITY = [("zamba2-7b", 6, 2, 32, 4, {}), ("olmoe-1b-7b", 1, 2, 32, 4, {}),
                   ("qwen2-vl-2b", 2, 2, 32, 4, {}),
                   ("whisper-base", 1, 2, 32, 4, {"num_encoder_layers": 1}),
                   ("xlstm-1.3b", 2, 2, 32, 4, {"slstm_period": 2})]


def stub_inputs(torch, cfg, B, g, device=None):
    """The stub frontends' inputs of a batch: whisper's frames, qwen2-vl's
    patch embeddings (f32 normals from ``g``)."""
    out = {}
    if cfg.is_encoder_decoder:
        out["frames"] = torch.randn((B, cfg.encoder_seq_len, cfg.d_model), generator=g,
                                    device=device)
    if cfg.num_vision_tokens:
        out["vision"] = torch.randn((B, cfg.num_vision_tokens, cfg.d_model), generator=g,
                                    device=device)
    return out


def check_backbone_cuda_vs_cpu(torch):
    """Each ``BACKBONE_PARITY`` cell at full width in f32: the same weights
    (drawn on the CPU) through the port on the card (kernels) and on the
    CPU (plain versions). Logits within 1e-3 relative (max abs error over
    max |logit|), and the same tokens; an MoE cell's routing compared call
    by call (:class:`RouteLog`)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention, gla
    from repro_torch.launch import steps as S
    from repro_torch.models.backbone import transformer as T
    from repro_torch.tree import tree_map

    out = {}
    for arch, layers, B, prompt, gen_len, extra in BACKBONE_PARITY:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype="float32", **extra)
        g = torch.Generator().manual_seed(3)
        theta = T.init_params(g, cfg)
        eta_G, eta_L = S.init_eta_G(g, cfg), S.init_eta_L(g, cfg, 2)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, prompt), generator=g),
                 **stub_inputs(torch, cfg, B, g)}
        routes = RouteLog(torch)
        t0 = time.perf_counter()
        with routes("record"):
            cpu_logits, cpu_tok = greedy(torch, cfg, theta, eta_G, eta_L, batch, 2, gen_len)
        cpu_s = time.perf_counter() - t0
        to_dev = lambda tree: tree_map(lambda a: a.to(DEVICE), tree)  # noqa: E731
        attention.reset_launches()
        gla.reset_launches()
        with routes("match"):
            dev_logits, dev_tok = greedy(torch, cfg, to_dev(theta), to_dev(eta_G), to_dev(eta_L),
                                         to_dev(batch), 2, gen_len)
        sync(torch)
        # f32 attention and GLA take the SIMT kernels: once a layer in the
        # prefill (and whisper's cross-attention once a layer a decode step).
        pre, dec = backbone_launches_per_pass(cfg)
        want = {k: pre[k] + (gen_len - 1) * dec[k] for k in pre}
        assert attention.LAUNCHES == {k: want[k] for k in attention.LAUNCHES}, attention.LAUNCHES
        assert (attention.LAUNCHES["flash_attention"] > 0) == ("attn" in cfg.block_pattern)
        assert gla.LAUNCHES == {k: want[k] for k in gla.LAUNCHES}, gla.LAUNCHES
        assert (gla.LAUNCHES["gla"] > 0) == bool({"mamba2", "mlstm"} & set(cfg.block_pattern))
        assert bool(routes.kept) == cfg.is_moe
        rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(dev_logits, cpu_logits, strict=True))
        same = bool(torch.equal(dev_tok, cpu_tok))
        route = routes.line() if cfg.is_moe else "no MoE"
        print(f"  backbone {DEVICE} vs cpu [{arch}, {layers} layers {extra}, f32, B={B}, "
              f"prompt {prompt}"
              f"{' + %d vision' % cfg.num_vision_tokens if cfg.num_vision_tokens else ''}"
              f"{' + %d frames' % cfg.encoder_seq_len if cfg.is_encoder_decoder else ''}, "
              f"greedy {gen_len}]: logits max_rel={rel:.2e} (<= 1e-3), tokens equal={same} "
              f"{dev_tok[0].tolist()}; {route} (cpu side {cpu_s:.1f} s)", flush=True)
        assert all(bool(torch.isfinite(a).all()) for a in dev_logits)
        assert rel <= 1e-3 and same, arch
        out[arch] = {"max_rel": rel, "tokens_equal": same}
        if cfg.is_moe:
            out[arch].update(route_calls=len(routes.kept), flipped_pairs=routes.flips,
                             injected_calls=routes.injected, min_topk_margin=routes.margin)
        del theta, eta_G, eta_L, batch
    return out


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
# Phase 3c: the experiment API (spec -> build -> run -> save -> resume)
# ---------------------------------------------------------------------------

STATE_KEYS = ("theta", "eta_G", "eta_L", "opt_server", "opt_local", "strategy")
HIER_KWARGS = {"in_dim": 784, "hidden": 64, "train_per_silo": 200}


def api_spec(model, kwargs, algo, J, rounds, K, global_family=None, **scenario):
    """An ``ExperimentSpec`` on the fused wire (Adam, lr 0.02, seed 0)."""
    from repro_torch.core.family import FamilySpec
    from repro_torch.federated.api import (
        ExperimentSpec,
        ModelSpec,
        OptimizerSpec,
        RuntimeSpec,
    )
    from repro_torch.federated.scheduler import Scenario

    gfam = None if global_family is None else FamilySpec(global_family)
    return ExperimentSpec(
        model=ModelSpec(model, kwargs, global_family=gfam),
        scenario=Scenario(algorithm=algo, **scenario), num_silos=J, rounds=rounds,
        local_steps=K, server_opt=OptimizerSpec("adam", 2e-2), seed=0,
        runtime=RuntimeSpec(wire="fused"))


def counted(torch, wire, reparam, fn):
    """``fn()`` with the launch counters set to 0 just before and read just
    after: (its result, the wire kernels' counts). No round calls the
    reparam kernels."""
    sync(torch)
    wire.reset_launches()
    reparam.reset_launches()
    out = fn()
    sync(torch)
    assert not any(reparam.LAUNCHES.values()), reparam.LAUNCHES
    return out, {k: wire.LAUNCHES[k] for k in KERNEL_COUNTS}


def api_rounds(torch, wire, reparam, exp, rounds, on_round=None):
    """``exp.run(rounds)`` counted: (this call's history, counts, s a round).
    ``on_round(exp, r, metrics)`` runs after each round's time stamp."""
    before = {k: len(v) for k, v in exp.history.items()}
    stamps = []

    def cb(r, m):
        stamps.append(time.perf_counter())
        if on_round is not None:
            on_round(exp, r, m)

    t0 = time.perf_counter()
    h, counts = counted(torch, wire, reparam, lambda: exp.run(rounds, callback=cb))
    chunk = {k: v[before.get(k, 0):] for k, v in h.items()}
    return chunk, counts, [b - a for a, b in zip([t0] + stamps[:-1], stamps)]


def check_launches(label, counts, per_round, rounds):
    want = {k: n * rounds for k, n in zip(KERNEL_COUNTS, per_round, strict=True)}
    assert counts == want, (label, counts, want)


def state_diff(torch, a, b) -> list:
    """The state leaves (group, index, max |a - b|) where two Servers differ
    in value or dtype; empty when they are bit-identical."""
    from repro_torch.tree import tree_leaves

    out = []
    for k in STATE_KEYS:
        la, lb = tree_leaves(a.state[k]), tree_leaves(b.state[k])
        assert len(la) == len(lb), k
        for i, (x, y) in enumerate(zip(la, lb, strict=True)):
            if x.dtype != y.dtype or not torch.equal(x, y):
                out.append((k, i, float((x.double() - y.double()).abs().max())))
    return out


class Patched:
    """Wrap ``owner.name`` while the block runs: each call's wall seconds go
    to ``sink`` (``classmethod`` kept for ``Experiment.resume``)."""

    def __init__(self, owner, name, sink):
        self.owner, self.name, self.sink = owner, name, sink
        self.orig = owner.__dict__[name]

    def __enter__(self):
        orig, sink = self.orig, self.sink
        fn = orig.__func__ if isinstance(orig, classmethod) else orig

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sink.append(time.perf_counter() - t0)
            return out

        setattr(self.owner, self.name, classmethod(timed) if isinstance(orig, classmethod)
                else timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def api_line(label, rounds, round_s, bytes_round, counts, save_s=(), resume_s=(), **extra):
    row = {"api_run": label, "rounds": rounds,
           "s_per_round_median_after_first": statistics.median(round_s[1:]),
           "save_ms": [t * 1e3 for t in save_s], "resume_ms": [t * 1e3 for t in resume_s],
           "bytes_per_round": bytes_round,
           "launches_per_round": {k: v / rounds for k, v in counts.items()}, **extra}
    print(json.dumps(row), flush=True)


def run_facts(exp, h) -> dict:
    """Bytes a round (one number when every round sent the same), the
    simulated seconds and the active silos a round, for :func:`api_line`."""
    totals = [u + d for u, d in zip(h["bytes_up"], h["bytes_down"], strict=True)]
    return {"bytes_round": totals[0] if len(set(totals)) == 1 else totals,
            "sim_seconds": exp.comm.sim_seconds, "n_active": h["n_active"]}


def engine_states(exp):
    """The async event loop's and the population's state as JSON dicts (None
    when the run has none)."""
    return (None if exp.async_state is None else exp.async_state.state_dict(),
            None if exp.population is None else exp.population.state.state_dict())


def bytes_check(label, want_total):
    """The byte check of a run's history: ``want_total`` bytes up + down each
    round, or, when it is a callable, that callable on the history."""
    if callable(want_total):
        return want_total

    def check(h):
        totals = [u + d for u, d in zip(h["bytes_up"], h["bytes_down"], strict=True)]
        assert totals == [want_total] * len(totals), (label, totals)
    return check


def api_save_resume(torch, wire, reparam, label, spec, split, per_round, want_total,
                    work, want_eps=None, on_round=None):
    """``spec`` run whole, and run as ``split`` rounds + save + resume into a
    fresh object + the rest: every state leaf, the whole history, the async
    ``BufferState`` and the ``PopulationState`` must be bit-identical.
    ``want_total`` as :func:`bytes_check`; ``on_round(exp, r, metrics)``
    sees the whole run's rounds. Returns the summed launch counts of the
    three runs."""
    from repro_torch.federated.api import Experiment, build

    R = spec.rounds
    full = build(spec, device=DEVICE)
    h_full, c_full, s_full = api_rounds(torch, wire, reparam, full, R, on_round)
    part = build(spec, device=DEVICE)
    h1, c1, s1 = api_rounds(torch, wire, reparam, part, split)
    t0 = time.perf_counter()
    part.save(str(work))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = Experiment.resume(str(work), device=DEVICE)
    resume_s = time.perf_counter() - t0
    assert res.round == split and res.server.wire == "fused", label
    h2, c2, s2 = api_rounds(torch, wire, reparam, res, R - split)
    bytes_check(label, want_total)(h_full)
    assert all(math.isfinite(e) for e in h_full["elbo_trace"]), label
    if want_eps is not None:
        assert abs(h_full["epsilon"][-1] - want_eps) <= 1e-4, (label, h_full["epsilon"][-1])
    check_launches(label, c_full, per_round, R)
    check_launches(label + " before save", c1, per_round, split)
    check_launches(label + " resumed", c2, per_round, R - split)
    diff = state_diff(torch, full.server, res.server)
    hist = [k for k in h_full if h_full[k] != h1[k] + h2[k]]
    engines = engine_states(res) == engine_states(full)
    print(json.dumps({"api_resume": label, "state_leaves_differing": diff,
                      "history_keys_differing": hist, "engine_states_equal": engines,
                      "rounds_full": h_full.get("elbo"), "rounds_resumed": h2.get("elbo")}),
          flush=True)
    assert not diff and not hist and engines, f"{label}: resumed run is not bit-identical"
    assert res.comm.state_dict() == full.comm.state_dict(), label
    api_line(label, R, s_full, counts=c_full, save_s=[save_s], resume_s=[resume_s],
             split=split, s_per_round_resumed=s2, epsilon=h_full.get("epsilon", [None])[-1],
             **run_facts(full, h_full))
    return {k: c_full[k] + c1[k] + c2[k] for k in KERNEL_COUNTS}


def api_plain(torch, wire, reparam, label, spec, per_round, want_total, on_round=None):
    """``spec`` run whole through the API: bytes (as :func:`bytes_check`), a
    finite ELBO, launches."""
    from repro_torch.federated.api import build

    exp = build(spec, device=DEVICE)
    h, counts, round_s = api_rounds(torch, wire, reparam, exp, spec.rounds, on_round)
    bytes_check(label, want_total)(h)
    assert all(math.isfinite(e) for e in h["elbo_trace"]), label
    check_launches(label, counts, per_round, spec.rounds)
    api_line(label, spec.rounds, round_s, counts=counts, elbo=h["elbo"], **run_facts(exp, h))
    return counts


def hier_bnn_cli_resume(torch, wire, reparam, work):
    """hier_bnn at §4.1 width through the CLI's ``main``: SFVI-Avg + int8 +
    trimmed (0.1), 4 rounds with ``--ckpt-every 2``; then ``--resume`` of
    the round-2 step in a fresh ``main`` call. The resumed run's step-4
    files must equal the uninterrupted run's byte for byte."""
    from repro_torch.federated import api
    from repro_torch.federated import run as cli

    J, K, P = MAIN_J, 4, MAIN_P
    argv = ["--device", DEVICE, "--model", "hier_bnn", "--model-kwargs", json.dumps(HIER_KWARGS),
            "--silos", str(J), "--rounds", "4", "--local-steps", str(K), "--algo",
            "sfvi_avg", "--compress", "int8", "--aggregator", "trimmed", "--trim-frac", "0.1"]
    full, part = work / "full", work / "part"
    stamps, save_s, resume_s = [], [], []
    log_round = cli._log_round

    def stamped(total):
        log = log_round(total)

        def cb(r, m):
            stamps.append(time.perf_counter())
            log(r, m)
        return cb

    cli._log_round = stamped
    try:
        with Patched(api.Experiment, "save", save_s), \
                Patched(api.Experiment, "resume", resume_s):
            t0 = time.perf_counter()
            rc, c_full = counted(torch, wire, reparam, lambda: cli.main(
                [*argv, "--ckpt-dir", str(full), "--ckpt-every", "2"]))
            wall_full = time.perf_counter() - t0
            assert rc == 0
            round_s = [b - a for a, b in zip(stamps[:-1], stamps[1:])]
            part.mkdir()
            for f in full.iterdir():
                if not f.name.startswith("step_00000004"):
                    shutil.copy2(f, part / f.name)
            t0 = time.perf_counter()
            rc, c_res = counted(torch, wire, reparam,
                                lambda: cli.main(["--device", DEVICE, "--resume", str(part)]))
            wall_res = time.perf_counter() - t0
            assert rc == 0
    finally:
        cli._log_round = log_round
    label = "hier_bnn CLI sfvi_avg+int8+trimmed"
    check_launches(label, c_full, (1, 2, 0, 0), 4)
    check_launches(label + " resumed", c_res, (1, 2, 0, 0), 2)
    files = sorted(f.name for f in full.iterdir() if f.name.startswith("step_00000004"))
    assert len(files) == 2 + J, files
    differ = [f for f in files if (full / f).read_bytes() != (part / f).read_bytes()]
    print(json.dumps({"api_resume": label, "step_files": len(files),
                      "files_differing": differ}), flush=True)
    assert not differ, f"{label}: resumed checkpoint differs from the uninterrupted one"
    meta = json.loads((full / "step_00000004.meta.json").read_text())
    bytes_round = (meta["comm"]["bytes_up"] + meta["comm"]["bytes_down"]) / meta["comm"]["rounds"]
    assert bytes_round == J * (P + 4) + J * 4 * P, bytes_round
    api_line(label, 4, [0.0] + round_s[:3], bytes_round, c_full, save_s, resume_s,
             wall_s=wall_full, resume_call_wall_s=wall_res)
    return {k: c_full[k] + c_res[k] for k in KERNEL_COUNTS}


def experiment_api_runs(torch, wire, reparam):
    """Phase 3c: every run through ``repro_torch.federated.api`` on the fused
    wire; returns the summed launch counts."""
    totals = {k: 0 for k in KERNEL_COUNTS}

    def add(counts):
        for k in totals:
            totals[k] += counts[k]

    work = ROOT / "build" / "phase3c"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        smoke = {"n_per": SMOKE_N, "in_dim": SMOKE_DIM}
        Js, Ks = SMOKE_J, SMOKE_K
        add(api_save_resume(
            torch, wire, reparam, "smoke SFVI-Avg dp(z=0.3,C=0.3)",
            api_spec("multinomial", smoke, "sfvi_avg", Js, SMOKE_ROUNDS, Ks,
                     dp_noise=0.3, dp_clip=0.3),
            12, (1, 3, 0, 0), 126_144, work / "smoke", want_eps=289.2907))
        for algo in ("pvi", "fed_ep"):
            add(api_plain(torch, wire, reparam, f"smoke {algo}",
                          api_spec("multinomial", smoke, algo, Js, 9, Ks), (1, 1, 0, 0),
                          126_144))
        add(hier_bnn_cli_resume(torch, wire, reparam, work / "hier_bnn"))
        P = MAIN_P
        add(api_plain(torch, wire, reparam, "hier_bnn pvi",
                      api_spec("hier_bnn", HIER_KWARGS, "pvi", MAIN_J, 3, 4), (1, 1, 0, 0),
                      2 * MAIN_J * 4 * P))
        add(api_save_resume(
            torch, wire, reparam, "glmm+cholesky sfvi_avg",
            api_spec("glmm", {"num_children": GLMM_CHILDREN}, "sfvi_avg", GLMM_J, 3, GLMM_K,
                     global_family="cholesky"),
            2, (1, 1, 0, NS_ROOTS_PER_MERGE), 2 * GLMM_J * 4 * 20, work / "glmm"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return totals


# ---------------------------------------------------------------------------
# Phase 3d: buffered-async flushes, silo churn, the posterior endpoint
# ---------------------------------------------------------------------------

CHURN_RATES = {"arrival_rate": 0.6, "departure_rate": 0.2, "return_rate": 0.5, "seed": 3}
# hier_bnn for the churn run and its endpoint: 50 test images a silo, so
# that the 4 silos present at round 0 already hold the 200 predict serves.
CHURN_HIER = {**HIER_KWARGS, "test_per_silo": 50}
SERVE_QUERIES = 48  # sample queries of n = 32 over the live silos, + 1 global
SERVE_N, SERVE_REPEATS, PREDICT_IMAGES, PREDICT_N = 32, 16, 200, 8


def spec_3d(model, kwargs, J, rounds, K, buffer_size=None, latency="straggler",
            population=None, global_family=None, **scenario):
    """An SFVI-Avg ``ExperimentSpec`` on the fused wire (``api_spec``'s), with
    an async block when ``buffer_size`` is set and a population if given."""
    from repro_torch.federated.population import PopulationSpec
    from repro_torch.federated.scheduler import AsyncConfig

    acfg = None if buffer_size is None else AsyncConfig(buffer_size=buffer_size,
                                                        latency=latency)
    spec = api_spec(model, kwargs, "sfvi_avg", J, rounds, K, global_family=global_family,
                    async_cfg=acfg, **scenario)
    return dataclasses.replace(
        spec, population=None if population is None else PopulationSpec(**population))


class RunLog:
    """``on_round`` of a phase-3d run: one line a flush or round (the live
    J, simulated time, staleness, the combine's weights; with ``initial``,
    the round's joins, departures and returns read from the population
    state's change). Keeps the whole run's Experiment (``exp``) and each
    flush's weights (``weights``)."""

    def __init__(self, label, initial=None):
        from repro_torch.federated.population import ACTIVE

        self.label, self.exp, self.weights = label, None, []
        self.prev = None if initial is None else [ACTIVE] * initial

    def __call__(self, exp, r, m):
        from repro_torch.federated.population import ACTIVE, DEPARTED

        self.exp = exp
        w = None if "weights" not in m else [float(x) for x in m["weights"]]
        if w is not None:
            self.weights.append(w)
        row = {"run": self.label, "index": r, "J": exp.server.J, "n_active": m["n_active"],
               "sim_time": m.get("sim_time"), "staleness_max": m.get("staleness"),
               "weights": w, "bytes": m["bytes_up"] + m["bytes_down"]}
        if self.prev is not None:
            old, st = self.prev, exp.population.state
            moved = list(zip(old, st.status))
            row.update(joins=list(range(len(old), st.joined)),
                       departures=[j for j, ab in enumerate(moved) if ab == (ACTIVE, DEPARTED)],
                       returns=[j for j, ab in enumerate(moved) if ab == (DEPARTED, ACTIVE)])
            self.prev = list(st.status)
        print(json.dumps(row), flush=True)


def contributions_check(label, up1, down1):
    """A :func:`bytes_check`: each round's bytes are its contributions x the
    per-silo bytes."""
    def check(h):
        for u, d in zip(h["bytes_up"], h["bytes_down"], strict=True):
            assert u % up1 == 0 and d == u // up1 * down1 and u > 0, (label, u, d)
    return check


def profile_api(torch, label, exp, rounds=2):
    """``rounds`` more rounds of ``exp`` under torch.profiler: device busy
    time and idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exp.run(rounds)
        sync(torch)
        wall = time.perf_counter() - t0
    print(json.dumps({"profile": label, "rounds": rounds, **profile_summary(prof, wall)}),
          flush=True)


class PathRecorder:
    """While the block runs, every call of a kernel's wrapper on the card
    keeps a copy of its inputs and of what the kernel gave the path, so that
    :meth:`hold` can hold each launch the path made against the plain
    version on its own inputs: every (J, P) and every instantiation the
    event loops reach, at their weights; every reparam draw and backward of
    a train step. The wrappers still count their launches; :meth:`hold`
    launches nothing."""

    NAMES = ("fused_upload", "fused_combine", "sqrtm_newton_schulz_fused")

    def __init__(self, torch, owner, phase="3d", names=NAMES):
        """``owner``: the kernel module whose wrappers ``names`` are recorded
        (``kernels.wire``, or ``kernels.reparam`` with ``reparam_fwd`` and
        ``reparam_bwd``, which its autograd function calls)."""
        self.torch, self.owner, self.calls, self.phase = torch, owner, [], phase
        self.names = names
        self.orig = {n: getattr(owner, n) for n in names}

    def __enter__(self):
        for name, fn in self.orig.items():
            setattr(self.owner, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.owner, name, fn)

    def _wrap(self, name, fn):
        import inspect

        torch, calls, sig = self.torch, self.calls, inspect.signature(fn)

        def keep(v):
            if isinstance(v, tuple):
                return tuple(keep(u) for u in v)
            return v.clone() if isinstance(v, torch.Tensor) else v

        def recorded(*args, **kw):
            out = fn(*args, **kw)
            if args[0].is_cuda:
                bound = sig.bind(*args, **kw)
                bound.apply_defaults()
                calls.append((name, {k: keep(v) for k, v in bound.arguments.items()}, keep(out)))
            return out
        return recorded

    def hold(self, ref) -> dict:
        """Each recorded launch against the plain version, with phase 2's
        tolerances; prints one line per (kernel, shape, mode) and returns
        {kernel: sorted distinct leading sizes J (B for the root)}."""
        torch, groups = self.torch, {}
        for name, kw, out in self.calls:
            if name == "fused_upload":
                x = kw.pop("x")
                want = ref.wire_upload_ref(x, **kw)
                J, P = x.shape
                mode = "+".join(m for m, on in [
                    ("ref", kw["reference"] is not None), ("clip", kw["clip_norm"] is not None),
                    ("dp", kw["noise_multiplier"] > 0), ("int8", kw["quantize"]),
                    ("part", bool((kw["mask"] != 1).any()))] if on) or "plain"
                if kw["quantize"]:
                    (q, s), (q0, s0) = out, want
                    step = int((q.int() - q0.int()).abs().max())
                    mism = int((q != q0).sum())
                    s_rel = float(((s - s0).abs() / s0.abs()).max())
                    ok = mism <= max(1, J * P // 1000) and step <= 1 and s_rel <= 1e-6
                    err = float((q.float() * s[:, None] - q0.float() * s0[:, None]).abs().max())
                else:
                    err = float((out - want).abs().max())
                    ok = err <= 1e-5 * (1.0 + float(want.abs().max()))
                shape = (J, P)
            elif name == "fused_combine":
                x, w, sc, tf = kw["x"], kw["weights"], kw["scales"], kw["trim_frac"]
                mat = ref.int8_rows_dequant_ref(x, sc) if sc is not None else x
                want = (ref.masked_weighted_mean_ref(mat, w) if tf is None
                        else ref.masked_trimmed_mean_ref(mat, w, tf))
                err = float((out - want).abs().max())
                ok = err <= 1e-5 * (1.0 + float(want.abs().max()))
                wl = set(w.tolist())
                mode = "+".join(m for m, on in [
                    ("trim" if tf is not None else "mean", True), ("int8", sc is not None),
                    ("w_not_0_1", bool(wl - {0.0, 1.0})), ("w_above_1", max(wl) > 1.0)] if on)
                shape = tuple(x.shape)
            elif name == "reparam_fwd":
                (z, lq), (z0, lq0) = out, ref.reparam_stl_ref(kw["mu"], kw["log_sigma"], kw["eps"])
                err = float((z.float() - z0.float()).abs().max())
                lq_rel = abs(float(lq) - float(lq0)) / max(abs(float(lq0)), 1e-30)
                ok = err <= 1e-5 * (1.0 + float(z0.float().abs().max())) and lq_rel <= 1e-5
                mode, shape = f"{str(z.dtype)[6:]}, z and logq", tuple(z.shape)
            elif name == "reparam_bwd":
                want = ref.reparam_stl_bwd_ref(kw["log_sigma"], kw["eps"], kw["dz"], kw["dlq"])
                err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(out, want, strict=True))
                ok = err <= 1e-5 * (1.0 + max(float(b.float().abs().max()) for b in want))
                # The train path takes z only: autograd hands the backward a zero dlq.
                mode = "dlq=0" if float(kw["dlq"]) == 0.0 else "dlq!=0"
                shape = tuple(kw["dz"].shape)
            else:
                mat = kw["mat"]
                want = ref.newton_schulz_sqrtm_ref(mat, kw["num_iters"])
                err = float(torch.linalg.norm(out - want) / torch.linalg.norm(want))
                ok = err <= 1e-4 and bool(torch.isfinite(out).all())
                mode, shape = f"{kw['num_iters']} steps, rel_fro", tuple(mat.shape)
            g = groups.setdefault((name, shape, mode), [0, 0.0, True])
            g[0], g[1], g[2] = g[0] + 1, max(g[1], err), g[2] and ok
        for (name, shape, mode), (n, err, ok) in sorted(groups.items()):
            print(f"  phase {self.phase} launch held to its plain version: {name} {shape} {mode}: "
                  f"{n} launches, max err {err:.3e}, within phase 2's tolerance={ok}", flush=True)
            assert ok, (name, shape, mode)
        self.calls.clear()
        return {k: sorted({shape[0] for (n, shape, _) in groups if n == k}) for k in self.names}


class EventLoopClock:
    """While the block runs, the host clock around the event loops' calls:
    ``simulate_flush``, ``PopulationEngine.begin_flush`` / ``begin_round``
    and ``Server.grow_silos`` (which a join calls inside ``begin_*``).
    :meth:`report` prints them per flush or round and starts over."""

    def __init__(self):
        from repro_torch.federated import async_engine
        from repro_torch.federated.population import PopulationEngine
        from repro_torch.federated.runtime import Server

        self.sinks = {"simulate_flush": [], "begin_flush": [], "begin_round": [],
                      "grow_silos": []}
        self.patches = [Patched(async_engine, "simulate_flush", self.sinks["simulate_flush"]),
                        Patched(PopulationEngine, "begin_flush", self.sinks["begin_flush"]),
                        Patched(PopulationEngine, "begin_round", self.sinks["begin_round"]),
                        Patched(Server, "grow_silos", self.sinks["grow_silos"])]

    def __enter__(self):
        for p in self.patches:
            p.__enter__()
        return self

    def __exit__(self, *exc):
        for p in self.patches:
            p.__exit__(*exc)

    def report(self, label):
        sk = self.sinks
        n = len(sk["simulate_flush"]) or len(sk["begin_round"])
        loop = sum(sk["simulate_flush"]) + sum(sk["begin_flush"]) + sum(sk["begin_round"])
        row = {"event_loop": label, "flushes_or_rounds": n,
               "host_us_per_flush_or_round": loop / n * 1e6 if n else None,
               **{f"{k}_us": {"calls": len(v), "median": statistics.median(v) * 1e6,
                              "max": max(v) * 1e6} for k, v in sk.items() if v}}
        print(json.dumps(row), flush=True)
        for v in sk.values():
            v.clear()


def live_draws(np, torch, exp, seed):
    """:func:`injected_draws` at the live J of ``exp``, which a join grows."""
    P = exp.server.wire_spec().dim
    return lambda r, t: injected_draws(np, torch, exp.server.problem, exp.server.J, P,
                                       seed)(r, t)


def eta_G_gap(torch, a, b) -> float:
    """The largest |a - b| over two Servers' η_G leaves."""
    from repro_torch.tree import tree_leaves

    return max(float((x.cpu() - y.cpu()).abs().max())
               for x, y in zip(tree_leaves(a.state["eta_G"]), tree_leaves(b.state["eta_G"]),
                               strict=True))


def event_loops_cuda_vs_cpu(np, torch):
    """Phase 3d (f): the event loops on the card against the same spec on
    the CPU, on one injected stream, the card started from the CPU's
    state: the smoke config's async + DP row and its async churn (6
    flushes each) and hier_bnn's churn at phase 2b's small width (4
    rounds, J 4 -> 7), held to phase 2b's tolerances; bytes, simulated
    times, staleness, active counts and both engine states exactly equal.
    hier_bnn's churn at §4.1 width too, its ELBO held to 1e-3: its η_G
    gap is printed beside the CPU's own gap when η_G starts one float32
    step away (the warm-started joins make that state ill-conditioned)."""
    from repro_torch.federated.api import build
    from repro_torch.tree import tree_leaves, tree_map

    smoke = {"n_per": SMOKE_N, "in_dim": SMOKE_DIM}
    pop = {"initial": 4, **CHURN_RATES}
    small = {"in_dim": 16, "hidden": 8, "train_per_silo": 20}
    runs = [
        ("smoke SFVI-Avg async(B=2) dp(z=0.3,C=0.3)",
         spec_3d("multinomial", smoke, SMOKE_J, 6, SMOKE_K, buffer_size=2, dp_noise=0.3,
                 dp_clip=0.3), 21, True),
        ("smoke SFVI-Avg async(B=2) churn(2 of 4)",
         spec_3d("multinomial", smoke, SMOKE_J, 6, SMOKE_K, buffer_size=2,
                 population={"initial": 2, **CHURN_RATES}), 22, True),
        ("hier_bnn small SFVI-Avg churn(4 of 10)",
         spec_3d("hier_bnn", small, MAIN_J, 4, 4, population=pop), 23, True),
        ("hier_bnn SFVI-Avg churn(4 of 10)",
         spec_3d("hier_bnn", CHURN_HIER, MAIN_J, 4, 4, population=pop), 23, False),
    ]
    for label, spec, seed, strict in runs:
        t0 = time.perf_counter()
        exps = {"cpu": build(spec, device="cpu"), DEVICE: build(spec, device=DEVICE)}
        if not strict:
            exps["cpu+1ulp"] = build(spec, device="cpu")
            exps["cpu+1ulp"].server.state["eta_G"] = tree_map(
                lambda x: x * (1.0 + 2.0 ** -23), exps["cpu"].server.state["eta_G"])
        for a, b in zip(tree_leaves(exps["cpu"].bundle.datas),
                        tree_leaves(exps[DEVICE].bundle.datas), strict=True):
            assert torch.equal(a, b.cpu()), label
        exps[DEVICE].server.state = tree_map(lambda x: x.to(DEVICE), exps["cpu"].server.state)
        hist = {k: e.run(spec.rounds, draws=live_draws(np, torch, e, seed))
                for k, e in exps.items()}
        if strict:
            hold_to_cpu(np, f"{label}, {spec.rounds} rounds", hist["cpu"], hist[DEVICE],
                        exps["cpu"].server, exps[DEVICE].server)
        else:
            e_c, e_g = (np.asarray(hist[k]["elbo_trace"]) for k in ("cpu", DEVICE))
            rel = float(np.max(np.abs(e_c - e_g) / np.abs(e_c)))
            print(json.dumps({"card_vs_cpu": label, "rounds": spec.rounds, "elbo_max_rel": rel,
                              "eta_G_max_abs": eta_G_gap(torch, exps[DEVICE].server,
                                                         exps["cpu"].server),
                              "cpu_eta_G_max_abs_after_1ulp_start": eta_G_gap(
                                  torch, exps["cpu+1ulp"].server, exps["cpu"].server)}),
                  flush=True)
            assert np.all(np.isfinite(e_g)) and rel <= 1e-3, (label, rel)
        for key in ("bytes_up", "bytes_down", "sim_time", "staleness", "n_active"):
            assert hist["cpu"].get(key) == hist[DEVICE].get(key), (label, key)
        assert engine_states(exps["cpu"]) == engine_states(exps[DEVICE]), label
        assert exps["cpu"].server.J == exps[DEVICE].server.J, label
        print(f"  {label}: J {spec.population.initial if spec.population else SMOKE_J} -> "
              f"{exps[DEVICE].server.J}, n_active {hist[DEVICE]['n_active']}, engine states "
              f"equal, {time.perf_counter() - t0:.1f} s", flush=True)


def serve_endpoint(torch, wire, reparam, work, live):
    """Phase 3d (e): the posterior endpoint on the churn run's last checkpoint
    (``work``, mid-roster), through ``Posterior`` and the serve CLI. The
    wire kernels are on no serving path (the sampler is plain, as in JAX)."""
    import contextlib
    import io

    from repro_torch.federated import serve
    from repro_torch.models.paper.fixtures import hier_bnn_federation

    post = serve.Posterior.from_checkpoint(str(work), device=DEVICE)
    J = post.num_silos
    assert J == live.server.J and post.round == live.round, (J, post.round)
    queries = ([serve.Query("sample", silo=j % J, n=SERVE_N) for j in range(SERVE_QUERIES)]
               + [serve.Query("global_sample", n=SERVE_N)])
    samples = sum(q.n for q in queries)

    def batch(p, seed):
        ans = p.answer_batch(queries, seed=seed)
        sync(torch)
        return ans

    (_, counts) = counted(torch, wire, reparam, lambda: batch(post, 0))  # warm-up
    assert not any(counts.values()), counts
    lats = []
    for rep in range(SERVE_REPEATS):
        t0 = time.perf_counter()
        batch(post, rep)
        lats.append(time.perf_counter() - t0)
    lat = statistics.median(lats)
    # The same seed on a second replica of the checkpoint: equal answers.
    a = batch(post, 7)
    b = batch(serve.Posterior.from_checkpoint(str(work), device=DEVICE), 7)
    for x, y in zip(a, b, strict=True):
        assert torch.equal(x["z_G"], y["z_G"])
        assert (x["z_L"] is None) == (y["z_L"] is None)
        assert x["z_L"] is None or torch.equal(x["z_L"], y["z_L"])
    # Each answer is its slice of its group's one draw.
    for s in range(J):
        idx = [i for i, q in enumerate(queries) if q.kind == "sample" and q.silo == s]
        grouped = post.sample(s, n=SERVE_N * len(idx), seed=7)
        for k, i in enumerate(idx):
            for key in ("z_G", "z_L"):
                assert torch.equal(a[i][key], grouped[key][k * SERVE_N:(k + 1) * SERVE_N])
    assert torch.equal(a[-1]["z_G"], post.global_sample(SERVE_N, seed=7)) and a[-1]["z_L"] is None
    # predict on each live silo's own test images: the first 200 in silo
    # order, and each silo's accuracy beside the run's eval (which averages
    # the posterior mean's accuracy over the live silos).
    _, _, test = hier_bnn_federation(seed=0, num_silos=live.spec.num_silos,
                                     device=torch.device(DEVICE), **CHURN_HIER)
    hits = []
    t0 = time.perf_counter()
    for j in range(J):
        logits = post.predict(j, test[j]["x"], n=PREDICT_N, seed=1)
        hits.append((torch.argmax(logits, -1) == test[j]["y"].long()).float())
    sync(torch)
    predict_s = time.perf_counter() - t0
    first = torch.cat(hits)[:PREDICT_IMAGES]
    assert first.numel() == PREDICT_IMAGES, first.numel()
    # The CLI once on the same directory, against the API's answers.
    cli_q = [{"kind": "sample", "silo": J - 1, "n": 2}, {"kind": "global_sample", "n": 2}]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--device", DEVICE, "--ckpt-dir", str(work), "--queries",
                         json.dumps(cli_q)])
    cli_s = time.perf_counter() - t0
    payload = json.loads(out.getvalue())
    want = post.answer_batch([serve.Query.from_dict(q) for q in cli_q])
    assert rc == 0 and payload["num_silos"] == J and payload["round"] == live.round
    assert payload["answers"][0]["z_L"] == want[0]["z_L"].cpu().tolist()
    assert payload["answers"][1] == {"z_G": want[1]["z_G"].cpu().tolist(), "z_L": None}
    row = {"serving": "hier_bnn churn checkpoint", "round": post.round, "live_silos": J,
           "queries": len(queries), "samples": samples, "repeats": SERVE_REPEATS,
           "median_ms": lat * 1e3, "ms": [t * 1e3 for t in lats],
           "queries_per_s": len(queries) / lat, "samples_per_s": samples / lat,
           "predict_images": PREDICT_IMAGES, "predict_n": PREDICT_N,
           "predict_acc": float(first.mean()),
           "predict_acc_per_silo": [float(h.mean()) for h in hits],
           "predict_ms_all_silos": predict_s * 1e3, "run_eval": live.evaluate(),
           "cli_s": cli_s, "cli_answers": len(payload["answers"])}
    print(json.dumps(row), flush=True)
    return row


def async_churn_serve_runs(np, torch, wire, reparam, ref):
    """Phase 3d: buffered-async flushes and silo churn through
    ``repro_torch.federated.api`` on the fused wire, every launch of them
    held against its plain version, the posterior endpoint, then the event
    loops on the card against the CPU; returns the summed launch counts."""
    totals = {k: 0 for k in KERNEL_COUNTS}

    def add(counts):
        for k in totals:
            totals[k] += counts[k]

    work = ROOT / "build" / "phase3d"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    smoke = {"n_per": SMOKE_N, "in_dim": SMOKE_DIM}
    Js, Ks, R = SMOKE_J, SMOKE_K, SMOKE_ROUNDS
    Ps = 2 + 2 * (10 * SMOKE_DIM + 10)  # the smoke wire row: θ and η_G = (mu, log_sigma)
    try:
        with PathRecorder(torch, wire) as rec, EventLoopClock() as clock:
            # (a) the smoke config's two async rows (benchmarks/baseline.json).
            label = "smoke SFVI-Avg async(B=2,straggler,d=0.5)"
            log = RunLog(label)
            add(api_plain(torch, wire, reparam, label,
                          spec_3d("multinomial", smoke, Js, R, Ks, buffer_size=2),
                          (1, 3, 0, 0), 63_072, on_round=log))
            assert log.exp.comm.sim_seconds == 28.0, log.exp.comm.sim_seconds
            clock.report(label)
            label = "smoke SFVI-Avg async int8 dp(z=0.3,C=0.3)"
            log = RunLog(label)
            add(api_save_resume(
                torch, wire, reparam, label,
                spec_3d("multinomial", smoke, Js, R, Ks, buffer_size=2, compression="int8",
                        dp_noise=0.3, dp_clip=0.3),
                12, (1, 3, 0, 0), 39_428, work / "smoke_async", want_eps=254.6345,
                on_round=log))
            assert log.exp.comm.sim_seconds == 28.0, log.exp.comm.sim_seconds
            clock.report(label)
            # (b) hier_bnn at §4.1 width: B = 3, int8 + trimmed + DP, 6 flushes.
            label = "hier_bnn SFVI-Avg async(B=3) int8 trimmed dp"
            log = RunLog(label)
            add(api_plain(
                torch, wire, reparam, label,
                spec_3d("hier_bnn", HIER_KWARGS, MAIN_J, 6, 4, buffer_size=3,
                        compression="int8", aggregator="trimmed", trim_frac=0.1,
                        dp_noise=0.3, dp_clip=0.3),
                (1, 2, 0, 0), 3 * ((MAIN_P + 4) + 4 * MAIN_P), on_round=log))
            assert any(w not in (0.0, 1.0) for ws in log.weights for w in ws), log.weights
            profile_api(torch, label, log.exp)
            clock.report(label)
            # (c) GLMM + Cholesky, B = 2, lognormal: the roots under flush weights.
            label = "glmm+cholesky SFVI-Avg async(B=2,lognormal)"
            log = RunLog(label)
            add(api_plain(
                torch, wire, reparam, label,
                spec_3d("glmm", {"num_children": GLMM_CHILDREN}, GLMM_J, 3, GLMM_K,
                        buffer_size=2, latency="lognormal", global_family="cholesky"),
                (1, 1, 0, NS_ROOTS_PER_MERGE), 2 * 2 * 4 * 20, on_round=log))
            profile_api(torch, label, log.exp)
            clock.report(label)
            # (d) churn at full width: hier_bnn, a roster of 10 from 4, warm starts.
            label = "hier_bnn SFVI-Avg churn(4 of 10)"
            churn = RunLog(label, initial=4)
            add(api_save_resume(
                torch, wire, reparam, label,
                spec_3d("hier_bnn", CHURN_HIER, MAIN_J, 8, 4,
                        population={"initial": 4, **CHURN_RATES}),
                4, (1, 2, 0, 0), contributions_check(label, 4 * MAIN_P, 4 * MAIN_P),
                work / "churn", on_round=churn))
            clock.report(label)
            live = churn.exp
            live.save(str(work / "churn"))
            assert live.population.state.joined > 4, live.population.state
            label = "smoke SFVI-Avg async(B=2) churn(2 of 4)"
            add(api_save_resume(
                torch, wire, reparam, label,
                spec_3d("multinomial", smoke, Js, 10, Ks, buffer_size=2,
                        population={"initial": 2, **CHURN_RATES}),
                5, (1, 3, 0, 0), contributions_check(label, 4 * Ps, 4 * Ps),
                work / "smoke_churn", on_round=RunLog(label, initial=2)))
            clock.report(label)
        # Every launch above against its plain version, on its own inputs.
        sizes = rec.hold(ref)
        print(json.dumps({"phase_3d_kernel_sizes": sizes}), flush=True)
        # (e) the endpoint on (d)'s last step.
        serve_endpoint(torch, wire, reparam, work / "churn", live)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # (f) the event loops on the card against the CPU.
    event_loops_cuda_vs_cpu(np, torch)
    return totals


# ---------------------------------------------------------------------------
# Phase 3e: multi-process federation on one card
# ---------------------------------------------------------------------------

MP_JOIN_S = 480  # a world's join: a hung gloo world fails the phase, not the run
MP_WORLD = "ranks time-sliced on one card, not a multi-GPU speed"


def mp_specs():
    """Phase 3e's runs: label -> (spec, bytes up a round). Each runs in one
    process (no world) and on the ranks of a world, on the fused wire."""
    smoke = {"n_per": SMOKE_N, "in_dim": SMOKE_DIM}
    dp = dict(compression="int8", aggregator="trimmed", trim_frac=0.1, dp_noise=0.3,
              dp_clip=0.3)
    return {
        "hier_bnn sfvi": (api_spec("hier_bnn", HIER_KWARGS, "sfvi", MAIN_J, 3, 4), 16_056_640),
        "hier_bnn sfvi_avg": (api_spec("hier_bnn", HIER_KWARGS, "sfvi_avg", MAIN_J, 3, 4),
                              4_014_160),
        "hier_bnn sfvi_avg+int8+trimmed+dp": (
            api_spec("hier_bnn", HIER_KWARGS, "sfvi_avg", MAIN_J, 3, 4, **dp), 1_003_580),
        "glmm+cholesky sfvi_avg": (
            api_spec("glmm", {"num_children": GLMM_CHILDREN}, "sfvi_avg", GLMM_J, 2, GLMM_K,
                     global_family="cholesky"), GLMM_J * 4 * 20),
        # The baseline's two mesh rows (benchmarks/baseline.json): 504,576 B
        # up + down a round, half of it up.
        "smoke sfvi": (api_spec("multinomial", smoke, "sfvi", SMOKE_J, SMOKE_ROUNDS, SMOKE_K),
                       504_576 // 2),
        # J = 7 on 2 ranks pads the silo axis to 8.
        "smoke sfvi_avg J=7": (api_spec("multinomial", smoke, "sfvi_avg", 7, 3, SMOKE_K),
                               7 * 4 * 3942),
    }


def state_dump(exp) -> dict:
    """The replicated state's leaves and each held real row's leaves, on the
    host: what two runs compare (``state_digests``, ``state_gap``)."""
    from repro_torch.tree import tree_leaves

    srv, st = exp.server, exp.server.state
    silo = tree_leaves([st[k] for k in ("eta_L", "opt_local", "strategy")])
    return {"global": [x.detach().cpu() for x in tree_leaves(
                [st["theta"], st["eta_G"], st["opt_server"]])],
            "rows": {j: [x[i].detach().cpu() for x in silo]
                     for i, j in enumerate(srv.rows) if j < srv.J}}


def _digest(leaves) -> str:
    import hashlib

    h = hashlib.sha256()
    for x in leaves:
        h.update(x.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def state_digests(dump) -> dict:
    return {"global": _digest(dump["global"]),
            "rows": {str(j): _digest(v) for j, v in dump["rows"].items()}}


def state_gap(torch, a, b) -> float:
    """The largest |a - b| / (1 + |b|) over the leaves two dumps share."""
    pairs = list(zip(a["global"], b["global"], strict=True))
    for j, leaves in a["rows"].items():
        pairs += list(zip(leaves, b["rows"][j], strict=True))
    return max((float(((x.double() - y.double()).abs() / (1 + y.double().abs())).max())
                for x, y in pairs if x.numel()), default=0.0)


def mp_run(torch, wire, reparam, ref, spec, label, work):
    """One run through the API on this process's mesh, its launches held to
    their plain versions: its record and its state dump."""
    from repro_torch.federated import distributed
    from repro_torch.federated.api import build

    exp = build(spec, device=DEVICE)
    gather_s = []
    distributed.reset_gathered()
    with PathRecorder(torch, wire, phase="3e") as rec, \
            Patched(distributed, "gather_rows", gather_s), \
            Patched(distributed, "gather_cols", gather_s):
        h, counts, round_s = api_rounds(torch, wire, reparam, exp, spec.rounds)
    rec.hold(ref)
    dump = state_dump(exp)
    torch.save(dump, work / f"{label.replace(' ', '_')}.pt")
    return {"digests": state_digests(dump), "elbo": h["elbo"], "bytes_up": h["bytes_up"],
            "bytes_total": [u + d for u, d in zip(h["bytes_up"], h["bytes_down"], strict=True)],
            "epsilon": h.get("epsilon"), "counts": counts, "s_per_round": round_s,
            "gather_calls_per_round": len(gather_s) / spec.rounds,
            "gather_host_ms_median": statistics.median(gather_s) * 1e3 if gather_s else 0.0,
            "bytes_gathered": exp.comm.bytes_gathered,
            "collective_bytes": dict(distributed.GATHERED), "J_pad": exp.server.J_pad,
            "rows": exp.server.rows}


def batch_count_probe(torch, wire, spec):
    """Where a run's bits part between one process and rank 0 of a 2-block
    mesh: the first aten op of round 0, up to the first upload, whose
    output for rank 0's rows differs between the batch of all J silos and
    rank 0's batch of J / 2 (``vmap`` batches the silos). Rank 0 is built
    without a world (its collectives are not reached before the upload).
    Returns ``(op, input shapes, output shape, max |diff|)``, or None when
    every op up to the upload agrees bit for bit."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.federated import api
    from repro_torch.launch.mesh import Mesh

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = out if isinstance(out, (tuple, list)) else [out]
            self.ops.append((str(func), [tuple(a.shape) for a in args
                                         if isinstance(a, torch.Tensor)],
                             [o.detach().clone() for o in outs if isinstance(o, torch.Tensor)]))
            return out

    def round0(half):
        build_mesh, upload = api.build_mesh, wire.fused_upload
        if half:
            api.build_mesh = lambda *a, **k: Mesh(silo=2, model=1, multiprocess=True)
        try:
            exp = api.build(spec, device=DEVICE)
        finally:
            api.build_mesh = build_mesh
        log = Log()

        def stop(*a, **k):
            raise StopIteration  # the round goes no further than its first upload

        wire.fused_upload = stop
        try:
            with log:
                exp.run(1)
        except StopIteration:
            pass
        finally:
            wire.fused_upload = upload
        return log.ops

    whole, part = round0(False), round0(True)
    for (op, shapes, outs), (_, _, pouts) in zip(whole, part, strict=False):
        for a, b in zip(outs, pouts, strict=False):
            if a.shape != b.shape:
                axes = [d for d in range(a.dim())
                        if a.dim() == b.dim() and a.shape[d] != b.shape[d]]
                if len(axes) != 1:
                    continue
                a = a.narrow(axes[0], 0, b.shape[axes[0]])
            if a.dtype.is_floating_point and not torch.equal(a, b):
                return op, shapes, tuple(b.shape), float((a.double() - b.double()).abs().max())
    return None


def mp_worker(task_json: str) -> int:
    """One rank of a phase-3e world (``--mp-worker``): the world from the
    env schema, the task's runs on its mesh, one ``MPRESULT`` line."""
    import torch

    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.federated import distributed
    from repro_torch.federated.api import Experiment, RuntimeSpec, build
    from repro_torch.kernels import ref, reparam, wire
    from repro_torch.launch.mesh import MeshSpec

    task = json.loads(task_json)
    distributed.initialize(backend=task["backend"], device=DEVICE)
    import torch.distributed as dist

    rank = dist.get_rank()
    runtime = RuntimeSpec(wire="fused", mesh=MeshSpec.from_dict(task["mesh"]))
    specs = {k: (dataclasses.replace(s, runtime=runtime), up) for k, (s, up)
             in mp_specs().items()}
    work = Path(task["work"]) / f"rank{rank}"
    work.mkdir(parents=True, exist_ok=True)
    out = {"rank": rank, "backend": dist.get_backend(), "world": dist.get_world_size(),
           "device": str(distributed.rank_device(DEVICE)), "runs": {}}
    for label in task["runs"]:
        out["runs"][label] = mp_run(torch, wire, reparam, ref, specs[label][0], label, work)
    if task.get("save_resume"):
        # Owner-routed save -> resume -> 1 round, against the same run whole.
        spec = specs[task["save_resume"]][0]
        ckpt = Path(task["work"]) / "ckpt"
        exp = build(spec, device=DEVICE)
        exp.run(spec.rounds - 1)
        t0 = time.perf_counter()
        exp.save(str(ckpt))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = Experiment.resume(str(ckpt), device=DEVICE)
        resume_s = time.perf_counter() - t0
        exp.run(1)
        res.run(1)
        a, b = state_dump(exp), state_dump(res)
        out["resume"] = {"label": task["save_resume"], "round": res.round,
                         "equal": state_digests(a) == state_digests(b)
                         and exp.history["elbo"][-1] == res.history["elbo"][-1],
                         "save_ms": save_s * 1e3, "resume_ms": resume_s * 1e3,
                         "shards": sorted(p.name for p in ckpt.glob("*.silo_*"))}
    print("MPRESULT " + json.dumps(out), flush=True)
    distributed.shutdown()
    return 0


def spawn_world(n, backend, mesh, runs, work, save_resume=None) -> list:
    """``n`` ranks of ``chip_smoke.py --mp-worker``, spawned here (the kernels
    are built); every rank's exit code is checked and each join has a
    timeout. Returns each rank's result, by rank."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    task = json.dumps({"backend": backend, "mesh": mesh.to_dict(), "runs": runs,
                       "work": str(work), "save_resume": save_resume})
    env = dict(os.environ, REPRO_COORDINATOR=f"localhost:{port}",
               REPRO_NUM_PROCESSES=str(n))
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--mp-worker", task],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(env, REPRO_PROCESS_ID=str(r)), cwd=ROOT)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MP_JOIN_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs, strict=True)):
        for line in out.splitlines():
            if line.startswith("  phase 3e"):
                print(f"  [{backend} rank {r}/{n}]{line[1:]}", flush=True)
        assert p.returncode == 0, (f"{backend} rank {r}/{n} exited {p.returncode}",
                                   out[-3000:], err[-6000:])
        line = [ln for ln in out.splitlines() if ln.startswith("MPRESULT ")][-1]
        results.append(json.loads(line[len("MPRESULT "):]))
    assert [res["rank"] for res in results] == list(range(n))
    return results


def multiprocess_runs(np, torch, wire, reparam, ref, card):
    """Phase 3e: each run in one process on the card, then on the ranks of
    three worlds spawned here: (a) a 1-rank NCCL world, (b) 2 gloo ranks
    sharing the card, (c) 4 gloo ranks on (silo=2, model=2). Returns the
    summed launch counts of every rank's runs."""
    from repro_torch.launch.mesh import MeshSpec

    totals = {k: 0 for k in KERNEL_COUNTS}
    work = ROOT / "build" / "phase3e"
    shutil.rmtree(work, ignore_errors=True)
    (work / "one").mkdir(parents=True)
    specs = mp_specs()
    try:
        one = {}
        for label, (spec, want_up) in specs.items():
            one[label] = mp_run(torch, wire, reparam, ref, spec, label, work / "one")
            assert one[label]["bytes_up"] == [want_up] * spec.rounds, (label, one[label])
        assert one["smoke sfvi"]["bytes_total"] == [504_576] * SMOKE_ROUNDS
        worlds = {
            "nccl x1": spawn_world(1, "nccl", MeshSpec(silo=1, multiprocess=True),
                                   ["hier_bnn sfvi_avg"], work / "nccl1"),
            "gloo x2": spawn_world(2, "gloo", MeshSpec(silo=2, multiprocess=True),
                                   [k for k in specs if k != "hier_bnn sfvi_avg"],
                                   work / "gloo2",
                                   save_resume="hier_bnn sfvi_avg+int8+trimmed+dp"),
            "gloo x4": spawn_world(4, "gloo", MeshSpec(silo=2, model=2, multiprocess=True),
                                   ["smoke sfvi"], work / "gloo4"),
        }
        for name, ranks in worlds.items():
            for res in ranks:
                assert res["backend"] == name[:4], res
                assert res["device"] == f"cuda:{res['rank'] % torch.cuda.device_count()}", res
                for label, run in res["runs"].items():
                    base = one[label]
                    # Every rank makes the calls of the one-process run.
                    assert run["counts"] == base["counts"], (name, label, run["counts"])
                    for k in totals:
                        totals[k] += run["counts"][k]
                    assert run["bytes_up"] == base["bytes_up"], (name, label)
                    assert run["epsilon"] == base["epsilon"], (name, label)
            for label in ranks[0]["runs"]:
                runs = [res["runs"][label] for res in ranks]
                base = one[label]
                rows = {}
                for run in runs:
                    rows.update(run["digests"]["rows"])
                ranks_equal = (len({r["digests"]["global"] for r in runs}) == 1
                               and len({tuple(r["elbo"]) for r in runs}) == 1)
                bit = (runs[0]["digests"]["global"] == base["digests"]["global"]
                       and rows == base["digests"]["rows"])
                one_dump = torch.load(work / "one" / f"{label.replace(' ', '_')}.pt")
                gap = 0.0
                for res in ranks:
                    dump = torch.load(work / name.replace(" x", "") / f"rank{res['rank']}"
                                      / f"{label.replace(' ', '_')}.pt")
                    gap = max(gap, state_gap(torch, dump, one_dump))
                elbo_rel = max(abs(a - b) / abs(b) for a, b in
                               zip(runs[0]["elbo"], base["elbo"], strict=True))
                line = {"mp_run": label, "world": f"{name} ({MP_WORLD})", "card": card,
                        "ranks_bit_identical": ranks_equal,
                        "state_bit_identical_to_one_process": bit,
                        "state_max_rel_gap": gap, "elbo_max_rel_gap": elbo_rel,
                        "J_pad": runs[0]["J_pad"], "rows": [r["rows"] for r in runs],
                        "bytes_up_per_round": runs[0]["bytes_up"][0],
                        "bytes_gathered_per_rank": runs[0]["bytes_gathered"],
                        "collective_bytes_per_rank": [r["collective_bytes"] for r in runs],
                        "s_per_round_median_after_first": [
                            statistics.median(r["s_per_round"][1:]) for r in runs],
                        "one_process_s_per_round_median_after_first":
                            statistics.median(base["s_per_round"][1:]),
                        "gather_calls_per_round": runs[0]["gather_calls_per_round"],
                        "gather_host_ms_median_a_call": [r["gather_host_ms_median"]
                                                         for r in runs],
                        "launches_per_round": {k: v / len(base["elbo"])
                                               for k, v in runs[0]["counts"].items()}}
                print(json.dumps(line), flush=True)
                assert ranks_equal, line
                # Bit for bit; else a batched op whose bits depend on the
                # batch count (the probe names the first such op of round 0)
                # and a gap held to phase 2's 1e-3.
                if not bit and name == "gloo x2":
                    op = batch_count_probe(torch, wire, specs[label][0])
                    print(json.dumps({"mp_batch_op": label, "first_op_parting": op,
                                      "card": card}), flush=True)
                    assert op is not None, label
                assert bit or gap <= 1e-3, line
                assert elbo_rel <= 1e-5, line
        # (a) the 1-rank NCCL world is the run without a world, bit for bit.
        nccl = worlds["nccl x1"][0]["runs"]["hier_bnn sfvi_avg"]
        assert nccl["digests"] == one["hier_bnn sfvi_avg"]["digests"]
        assert nccl["elbo"] == one["hier_bnn sfvi_avg"]["elbo"]
        # (b) the gloo ranks: padding, rows, owner-routed resume.
        g2 = worlds["gloo x2"]
        assert [r["runs"]["hier_bnn sfvi"]["rows"] for r in g2] == [[0, 1, 2, 3, 4],
                                                                     [5, 6, 7, 8, 9]]
        assert [r["runs"]["glmm+cholesky sfvi_avg"]["rows"] for r in g2] == [[0], [1]]
        assert g2[0]["runs"]["smoke sfvi_avg J=7"]["J_pad"] == 8
        for r in g2:
            run = r["runs"]["hier_bnn sfvi"]
            assert run["bytes_gathered"] == sum(run["bytes_up"]), run["bytes_gathered"]
            print(json.dumps({"mp_resume": r["resume"], "rank": r["rank"]}), flush=True)
            assert r["resume"]["equal"] and r["resume"]["round"] == 3, r["resume"]
        # (c) the baseline's two mesh rows: silo=2 and silo=2,model=2 agree.
        g4 = worlds["gloo x4"]
        for r in g4:
            a, b = r["runs"]["smoke sfvi"], g2[r["rank"] // 2]["runs"]["smoke sfvi"]
            assert a["elbo"] == b["elbo"] and a["digests"] == b["digests"], r["rank"]
            assert a["bytes_total"] == [504_576] * SMOKE_ROUNDS
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return totals


# ---------------------------------------------------------------------------
# Phase 3b: the backbone's serve path at full width
# ---------------------------------------------------------------------------

SERVE_RUNS = [
    # (label, arch, layers, batch, prompt, gen, silos)
    ("zamba2-7b 81 layers", "zamba2-7b", 81, 8, 64, 32, 4),
    ("zamba2-7b 12 layers, prompt 4096", "zamba2-7b", 12, 4, 4096, 8, 4),
    ("qwen3-4b 4 layers", "qwen3-4b", 4, 8, 512, 16, 4),
    ("llama3.2-3b 28 layers", "llama3.2-3b", 28, 8, 64, 16, 4),
    ("qwen3-8b 36 layers", "qwen3-8b", 36, 8, 512, 16, 4),
    ("qwen3-32b 16 of 64 layers", "qwen3-32b", 16, 8, 512, 16, 4),
    # MoE: the prefill's 4 groups of 1,024 tokens at capacity 160 (64
    # experts top 8, or 16 top 2), drops taken; decode runs every expert
    # on its 8 tokens. phi3.5-moe is 83.7 GB in bf16 whole, and
    # init_params holds the layers twice: 8 of its 32 layers.
    ("olmoe-1b-7b 16 layers", "olmoe-1b-7b", 16, 8, 512, 16, 4),
    ("phi3.5-moe 8 of 32 layers", "phi3.5-moe-42b-a6.6b", 8, 8, 512, 16, 4),
    # 256 stub vision tokens ahead of each 256-token prompt (M-RoPE, GQA 12/2).
    ("qwen2-vl-2b 28 layers", "qwen2-vl-2b", 28, 8, 256, 16, 4),
    # The encoder over 1,500 stub frames in the prefill; each decoder layer's
    # cross-attention to them in the prefill and in every decode step.
    ("whisper-base 6 + 6 layers, 1500 frames", "whisper-base", 6, 8, 64, 32, 4),
    # 42 mLSTM layers: GLA at dk 1,024, dv 1,025 (8 dk tiles, 17 dv slices)
    # and its reduction; 6 sLSTM layers, a loop over the 512 positions.
    ("xlstm-1.3b 48 layers", "xlstm-1.3b", 48, 8, 512, 16, 4),
]
# Parameters of the cells at these depths (the JAX package's init_params on
# each config; tests/test_torch_train.py pins them to jax.eval_shape).
SERVE_PARAMS = {"llama3.2-3b": 3_212_749_824, "qwen3-8b": 8_190_735_360,
                "qwen3-32b": 9_357_403_136, "olmoe-1b-7b": 6_919_100_416,
                "phi3.5-moe-42b-a6.6b": 10_665_136_128, "qwen2-vl-2b": 1_546_016_256,
                "whisper-base": 109_749_248, "xlstm-1.3b": 3_571_571_024}
BACKBONE_COUNTS = ("flash_attention", "flash_attention_tc", "gla", "gla_tc", "gla_reduce",
                   "rmsnorm")


def backbone_launches_per_pass(cfg):
    """Kernel launches of one prefill and of one decode step, from the config:
    bf16 attention and GLA take the tensor-core kernels, f32 the SIMT ones.
    Flash: each self-attention layer in the prefill; whisper's encoder
    layers in the prefill and its cross-attention in every pass. GLA: each
    mamba2 and mLSTM layer in the prefill, and a reduction after each call
    past dk = 128 (mLSTM's dk = 2 d_model / H). RMSNorm: every norm of the
    pass (the encoder's in the prefill)."""
    from repro_torch.kernels.gla import MAX_DIM

    kinds = cfg.block_pattern
    n_attn, n_mamba = kinds.count("attn"), kinds.count("mamba2")
    n_mlstm, n_slstm = kinds.count("mlstm"), kinds.count("slstm")
    n_cross = n_attn if cfg.is_encoder_decoder else 0
    n_enc = cfg.num_encoder_layers if cfg.is_encoder_decoder else 0
    norms = (2 * (n_mamba + n_mlstm + n_slstm) + n_attn * (2 if cfg.d_ff else 1)
             + (2 * n_attn if cfg.qk_norm else 0) + n_cross + 1)
    n_gla = n_mamba + n_mlstm
    n_reduce = n_mlstm if n_mlstm and 2 * cfg.d_model // cfg.num_heads > MAX_DIM else 0
    tc = cfg.dtype == "bfloat16"

    def counts(flash, gla, reduce, rms):
        return {"flash_attention": 0 if tc else flash, "flash_attention_tc": flash if tc else 0,
                "gla": 0 if tc else gla, "gla_tc": gla if tc else 0, "gla_reduce": reduce,
                "rmsnorm": rms}

    return (counts(n_attn + n_cross + n_enc, n_gla, n_reduce, norms + (2 * n_enc + 1 if n_enc
                                                                        else 0)),
            counts(n_cross, 0, 0, norms))


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


def moe_share(torch, run) -> dict:
    """One more prefill of a finished MoE serve run with a CUDA event pair
    around each MoE block and around the whole prefill: the blocks' summed
    device spans (their idle gaps included) and their share of the
    prefill's span."""
    from repro_torch.models.backbone import transformer

    st, pairs, real = run.state, [], transformer.moe_block
    event = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731

    def timed(*a, **kw):
        pairs.append((event(), event()))
        pairs[-1][0].record()
        out = real(*a, **kw)
        pairs[-1][1].record()
        return out

    start, end = event(), event()
    transformer.moe_block = timed
    try:
        with torch.inference_mode():
            sync(torch)
            start.record()
            st["prefill"](st["theta"], st["eta_G"], st["eta_L"], st["prompt"])
            end.record()
            end.synchronize()
    finally:
        transformer.moe_block = real
    moe_ms = sum(a.elapsed_time(b) for a, b in pairs)
    span = start.elapsed_time(end)
    return {"blocks": len(pairs), "moe_ms": moe_ms, "prefill_span_ms": span,
            "moe_share": moe_ms / span}


class FirstLaunches:
    """While the block runs, the first call on the card of the RMSNorm, the
    flash-attention and the GLA wrappers at each shape (RMSNorm: rows, D, x
    dtype, w dtype; flash: q and k shapes, dtype, mask; GLA: q and v
    shapes, dtype) keeps its inputs and output, wherever the backbone's
    modules bound the wrapper: a module's name, or a function's default
    argument (qk-norm's and mamba2's ``norm=``). :meth:`hold` holds each
    against the plain version with phase 2's limits (max-abs, and element
    by element in bf16), and checks that every launch of the run went
    through the recorder. Later calls at a kept shape are not copied; every
    call still counts its launch."""

    def __init__(self, torch):
        from repro_torch.kernels import attention, gla, rmsnorm

        self.torch = torch
        self.origs = {"rmsnorm": rmsnorm.rmsnorm, "flash_attention": attention.flash_attention,
                      "gla": gla.gla}
        self.kept = {name: {} for name in self.origs}
        self.calls = {name: 0 for name in self.origs}
        self.patched = []  # (object, attribute, original value)

    def _recorder(self, name):
        orig, kept = self.origs[name], self.kept[name]

        def rmsnorm(x, weight, eps=1e-6):
            out = orig(x, weight, eps)
            if x.is_cuda and x.numel():
                self.calls[name] += 1
                key = (x.numel() // x.shape[-1], x.shape[-1], x.dtype, weight.dtype)
                if key not in kept:
                    kept[key] = ((x.clone(), weight.clone()), {"eps": eps}, out.clone())
            return out

        def flash_attention(q, k, v, causal=True, window=None, q_offset=0, **kw):
            out = orig(q, k, v, causal, window, q_offset, **kw)
            if q.is_cuda:
                self.calls[name] += 1
                key = (tuple(q.shape), tuple(k.shape), q.dtype, causal, window, q_offset)
                if key not in kept:
                    kept[key] = ((q.clone(), k.clone(), v.clone()),
                                 {"causal": causal, "window": window, "q_offset": q_offset},
                                 out.clone())
            return out

        def gla(q, k, v, log_a, *, return_state=False):
            out = orig(q, k, v, log_a, return_state=return_state)
            if q.is_cuda:
                self.calls[name] += 1
                key = (tuple(q.shape), tuple(v.shape), q.dtype)
                if key not in kept:
                    y = out[0] if return_state else out
                    kept[key] = ((q.clone(), k.clone(), v.clone(), log_a.clone()), {"chunk": 64},
                                 y.clone())
            return out

        return {"rmsnorm": rmsnorm, "flash_attention": flash_attention, "gla": gla}[name]

    def __enter__(self):
        wrapped = {id(orig): self._recorder(name) for name, orig in self.origs.items()}
        for mod_name, m in sorted(sys.modules.items()):
            if not mod_name.startswith("repro_torch.models."):
                continue
            for attr, v in list(vars(m).items()):
                if id(v) in wrapped:
                    self.patched.append((m, attr, v))
                elif isinstance(v, types.FunctionType) and any(
                        id(d) in wrapped for d in v.__defaults__ or ()):
                    self.patched.append((v, "__defaults__", v.__defaults__))
        for obj, attr, v in self.patched:
            setattr(obj, attr, wrapped[id(v)] if attr != "__defaults__"
                    else tuple(wrapped.get(id(d), d) for d in v))
        return self

    def __exit__(self, *exc):
        for obj, attr, v in self.patched:
            setattr(obj, attr, v)

    def hold(self, ref, label, launches) -> int:
        """Each kept launch against its plain version (``ref.rmsnorm_plain``,
        ``ref.flash_attention_plain``, ``ref.gla_plain``); prints one line a shape, asserts that
        the recorder saw all ``launches`` of the run (by wrapper name), and
        returns the number of shapes held."""
        plains = {"rmsnorm": ref.rmsnorm_plain, "flash_attention": ref.flash_attention_plain,
                  "gla": ref.gla_plain}
        ratios = {"rmsnorm": rms_bf16_ratio, "flash_attention": flash_bf16_ratio,
                  "gla": gla_bf16_ratio}
        n = 0
        for name, kept in self.kept.items():
            assert self.calls[name] == launches[name], (label, name, self.calls, launches)
            assert bool(kept) == (launches[name] > 0), (label, name)
            for key, (args, kw, got) in sorted(kept.items(), key=str):
                want = plains[name](*args, **kw)
                err = float((got.float() - want.float()).abs().max())
                ok, line = _check_line(name, err, want)
                if got.dtype == self.torch.bfloat16:
                    ratio = ratios[name](self.torch, got, want)
                    line += f", elementwise {ratio:.3f} of its limit (<= 1)"
                    ok = ok and ratio <= 1.0
                shape = " x ".join("(" + ",".join(map(str, a.shape)) + ")" for a in args)
                print(f"  phase 3b {label}: first {name} launch at {shape} "
                      f"{str(got.dtype)[6:]} {kw} held to its plain version: {line}", flush=True)
                assert ok, (label, name, key)
            n += len(kept)
            kept.clear()
        return n


def serve_runs(torch, kernel_modules, other_modules):
    """Each serve run with the backbone counters at 0 just before and read
    just after; asserts the launches each kernel owes the run, finite
    logits, that no other kernel launched, and that no prefill called
    ``gla_final_state`` (mamba2's decode state comes from the GLA kernel).
    The first RMSNorm and flash launch at each shape of each run is held to
    its plain version (:class:`FirstLaunches`)."""
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
    from repro_torch.kernels import ref
    from repro_torch.launch.serve_backbone import serve
    from repro_torch.models.backbone import transformer

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
        moe_calls = {"moe_block": [], "moe_block_dense": []}
        with FirstLaunches(torch) as first, \
                Patched(transformer, "moe_block", moe_calls["moe_block"]), \
                Patched(transformer, "moe_block_dense", moe_calls["moe_block_dense"]):
            run = serve(cfg, batch=B, prompt_len=prompt, gen=gen_len, silos=silos,
                        device=torch.device(DEVICE))
            sync(torch)
        counts = counters(kernel_modules)
        others = counters(other_modules)
        peak = torch.cuda.max_memory_allocated()
        per_prefill, per_decode = backbone_launches_per_pass(cfg)
        want = {k: per_prefill[k] + (gen_len - 1) * per_decode[k] for k in BACKBONE_COUNTS}
        from repro_torch.models.backbone.transformer import param_count

        nv = cfg.num_vision_tokens
        res = {
            "serve": label, "arch": arch, "layers": layers, "batch": B, "prompt": prompt,
            "vision_tokens": nv, "gen": gen_len, "silos": silos,
            "params": param_count(run.state["theta"]),
            "prefill_ms": run.prefill_s * 1e3, "prefill_tok_s": B * (nv + prompt) / run.prefill_s,
            "decode_ms_per_token": run.decode_s * 1e3 / (gen_len - 1),
            "decode_tok_s": B * (gen_len - 1) / run.decode_s,
            "peak_gb": peak / 1e9, "launches": counts,
            "moe_calls": {k: len(v) for k, v in moe_calls.items()},
            "tokens_first_request": run.tokens[0].tolist(),
        }
        print(f"  {label}: prefill {res['prefill_ms']:.1f} ms ({res['prefill_tok_s']:.0f} tok/s), "
              f"decode {res['decode_ms_per_token']:.2f} ms/token ({res['decode_tok_s']:.0f} tok/s), "
              f"peak {res['peak_gb']:.2f} GB, params {res['params']:,}, launches={counts}, "
              f"gla_final_state calls={len(final_state_calls)}, MoE calls={res['moe_calls']}",
              flush=True)
        assert bool(torch.isfinite(run.logits.float()).all()), label
        assert tuple(run.tokens.shape) == (B, gen_len), label
        assert res["params"] == SERVE_PARAMS.get(arch, res["params"]), (label, res["params"])
        assert counts == want, (label, counts, want)
        assert not any(others.values()), (label, others)
        assert not final_state_calls, (label, "gla_final_state called", len(final_state_calls))
        # The capacity route once a layer in the prefill, every expert in each decode step.
        n_moe = layers if cfg.is_moe else 0
        assert res["moe_calls"] == {"moe_block": n_moe, "moe_block_dense": n_moe * (gen_len - 1)}, \
            (label, res["moe_calls"])
        for k in totals:
            totals[k] += counts[k]
        res["shapes_held"] = first.hold(ref, label, {
            "rmsnorm": counts["rmsnorm"], "flash_attention": counts["flash_attention_tc"],
            "gla": counts["gla_tc"]})
        res["profile"] = profile_serve(torch, run)
        if cfg.is_moe:
            res["moe_prefill"] = moe_share(torch, run)
            print(f"  {label}: MoE blocks {res['moe_prefill']['moe_ms']:.2f} ms of a "
                  f"{res['moe_prefill']['prefill_span_ms']:.2f} ms prefill span (device events)",
                  flush=True)
        results.append(res)
        del run
    # bf16 serving: every flash and GLA call took the tensor-core kernel, none the SIMT one.
    assert totals["flash_attention"] == 0 and totals["gla"] == 0, totals
    assert all(totals[k] > 0 for k in BACKBONE_COUNTS if k not in ("flash_attention", "gla")), \
        totals
    return totals, results


# ---------------------------------------------------------------------------
# Phase 3f: the backbone's train path at full width
# ---------------------------------------------------------------------------

TRAIN_J, TRAIN_B, TRAIN_S, TRAIN_LR = 4, 8, 64, 1e-3  # the JAX CLI's defaults
TRAIN_RUNS = [
    # (label, arch, layers, algo, counted steps, avg_every, parameters, bytes a round,
    #  silos, batch, sequence, remat)
    ("qwen3-4b 36 layers SFVI", "qwen3-4b", 36, "sfvi", 3, 2, 4_411_424_256,
     35_330_945_056, TRAIN_J, TRAIN_B, TRAIN_S, False),
    ("qwen3-4b 36 layers SFVI-Avg", "qwen3-4b", 36, "avg", 4, 2, 4_411_424_256,
     17_665_472_528, TRAIN_J, TRAIN_B, TRAIN_S, False),
    ("zamba2-7b 12 layers SFVI", "zamba2-7b", 12, "sfvi", 3, 2, 1_214_691_872,
     9_726_671_392, TRAIN_J, TRAIN_B, TRAIN_S, False),
    # 8,192 tokens a step at a sequence past CHUNKED_MIN_S: chunked attention
    # and each unit recomputed in the backward (remat), as a long-context
    # run trains; J = 2 keeps the recomputed unit's attention blocks in memory.
    ("qwen3-4b 36 layers SFVI, S 4096, remat", "qwen3-4b", 36, "sfvi", 3, 2, 4_411_424_256,
     17_665_472_528, 2, 2, 4096, True),
    # The MoE block through autograd (one group of 512 tokens, capacity 80;
    # the load-balance loss in the objective): 8 of olmoe's 16 layers, whose
    # state (~14.6 B a parameter) would not fit the card whole.
    ("olmoe-1b-7b 8 layers SFVI", "olmoe-1b-7b", 8, "sfvi", 3, 2, 3_562_573_824,
     28_522_381_344, TRAIN_J, TRAIN_B, TRAIN_S, False),
    # M-RoPE behind the 256-token vision prefix (the loss on the 64 text tokens).
    ("qwen2-vl-2b 28 layers SFVI", "qwen2-vl-2b", 28, "sfvi", 3, 2, 1_546_016_256,
     12_407_418_912, TRAIN_J, TRAIN_B, TRAIN_S, False),
    # The encoder over 1,500 stub frames a sample (full attention without a
    # mask, S <= CHUNKED_MIN_S) and the cross-attention, through autograd.
    ("whisper-base 6 + 6 layers SFVI", "whisper-base", 6, "sfvi", 3, 2, 109_749_248,
     891_402_528, TRAIN_J, TRAIN_B, TRAIN_S, False),
    # 42 mLSTM layers (chunked_gla at dk 1,024, dv 1,025) and 6 sLSTM layers
    # (a loop over the 64 positions) through autograd, at full depth.
    ("xlstm-1.3b 48 layers SFVI", "xlstm-1.3b", 48, "sfvi", 3, 2, 3_571_571_024,
     28_787_692_832, TRAIN_J, TRAIN_B, TRAIN_S, False),
]
TRAIN_COUNTS = ("reparam_stl_fwd", "reparam_stl_bwd", "fused_combine")
CARD_GB = 80e9  # the card's memory


def train_launches(algo, steps, avg_every):
    """Launches a train run owes: two reparam draws (z_G, and the stacked
    z_L) and their two backwards a step; two combines (the barycenter's μ
    and σ rows) on each due SFVI-Avg step; no backbone kernel."""
    due = sum(1 for i in range(steps) if (i + 1) % avg_every == 0) if algo == "avg" else 0
    return {"reparam_stl_fwd": 2 * steps, "reparam_stl_bwd": 2 * steps,
            "fused_combine": 2 * due, **{k: 0 for k in BACKBONE_COUNTS}}


def train_batches(torch, cfg, steps, B, S):
    """The train CLI's batches: its token stream, and its stub frames or
    vision prefix where the config has one."""
    from repro_torch.device import generator
    from repro_torch.launch import train

    toks = train.make_batches(generator(train.DATA_SEED, torch.device("cpu")), cfg, B, S, steps)
    out = []
    for i, t in enumerate(toks):
        t = torch.from_numpy(t).to(device=DEVICE, dtype=torch.long)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
        if cfg.is_encoder_decoder:
            out[-1]["frames"] = train.frame_inputs(cfg, B, i, torch.device(DEVICE))
        if cfg.num_vision_tokens:
            out[-1]["vision"] = train.vision_inputs(cfg, B, i, torch.device(DEVICE))
    return out


def profile_train(torch, step_fn, state, batches, start) -> dict:
    """``len(batches)`` more steps of a train run under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, b in enumerate(batches):
            state, _ = step_fn(state, b, start + i)
        sync(torch)
        wall = time.perf_counter() - t0
    return {"steps": len(batches), **profile_summary(prof, wall, top=12)}


def train_run(torch, modules, label, arch, layers, algo, steps, avg_every, want_params,
              want_bytes, J, B, S, remat):
    """One train cell through the CLI's pieces (``train.setup``, the step,
    ``run_rounds``) with every counter at 0 just before and read just after.
    Asserts the parameters, the bytes a round, each step's launches, finite
    losses, the peak under the card's memory, and the calls of
    ``chunked_attention`` (2 an attention layer a step under ``remat``: the
    forward and the backward's recompute; 1 without; 0 up to
    ``CHUNKED_MIN_S`` tokens) and of ``checkpoint`` (one a unit a step under
    ``remat``, else none); profiles 2 more steps."""
    from repro_torch.configs import get_config
    from repro_torch.federated.driver import run_rounds
    from repro_torch.federated.metering import CommMeter
    from repro_torch.launch import train
    from repro_torch.models.backbone import attention as attn_model
    from repro_torch.models.backbone import transformer
    from repro_torch.models.backbone.transformer import param_count, unit_structure

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, step_fn = train.setup(cfg, algo, J, TRAIN_LR, avg_every, torch.device(DEVICE),
                                 remat=remat)
    sync(torch)
    setup_s = time.perf_counter() - t0
    params = param_count(state.theta)
    per_round = train.bytes_per_round(state, algo, J, avg_every)
    assert params == want_params, (label, params)
    assert per_round == want_bytes, (label, per_round, want_bytes)
    batches = train_batches(torch, cfg, steps + 2, B, S)
    stamps, per_step = [], []
    for m in modules:
        m.reset_launches()
    sync(torch)
    t0 = time.perf_counter()

    def on_metrics(i, metrics, st):
        sync(torch)
        stamps.append(time.perf_counter())
        per_step.append(counters(modules))

    meter = CommMeter()
    calls = {"chunked_attention": [], "checkpoint": []}
    with Patched(attn_model, "chunked_attention", calls["chunked_attention"]), \
            Patched(transformer, "checkpoint", calls["checkpoint"]):
        state, hist = run_rounds(lambda st, b, i: step_fn(st, b, i), state, batches[:steps],
                                 meter=meter, bytes_per_round=(per_round, per_round),
                                 on_metrics=on_metrics)
    counts = counters(modules)
    peak = torch.cuda.max_memory_allocated()
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    launches = [{k: n - prev.get(k, 0) for k, n in now.items() if n - prev.get(k, 0)}
                for prev, now in zip([{}] + per_step[:-1], per_step)]
    want = train_launches(algo, steps, avg_every)
    unit, n_units, tail = unit_structure(cfg)
    n_attn = unit.count("attn") * n_units + tail.count("attn")
    chunked = n_attn * steps * (2 if remat else 1) if S > attn_model.CHUNKED_MIN_S else 0
    called = {k: len(v) for k, v in calls.items()}
    res = {
        "train": label, "arch": arch, "layers": layers, "algo": algo, "params": params,
        "silos": J, "batch": B, "seq": S, "tokens_per_step": B * S, "remat": remat,
        "lr": TRAIN_LR, "avg_every": avg_every if algo == "avg" else None, "setup_s": setup_s,
        "s_per_step": step_s, "median_after_first": statistics.median(step_s[1:]),
        "peak_gb": peak / 1e9, "bytes_per_round": per_round,
        "meter_bytes": meter.total, "loss": hist["loss"], "launches": counts,
        "launches_per_step": launches, "calls": called,
        "vision_tokens": cfg.num_vision_tokens, "aux_moe": hist.get("aux_moe"),
    }
    print(f"  {label}: loss={['%.4f' % v for v in hist['loss']]} "
          f"aux_moe={['%.4f' % v for v in hist.get('aux_moe', [])]} s/step="
          f"{['%.3f' % v for v in step_s]} peak {res['peak_gb']:.2f} GB, params {params:,}, "
          f"bytes/round {per_round:,}, launches={counts}, per step {launches}, "
          f"calls={called}", flush=True)
    assert all(math.isfinite(v) for v in hist["loss"]), label
    if algo == "sfvi":  # the MoE load-balance loss: about 1 when balanced, 0 without MoE
        assert all((v > 0.5) if cfg.is_moe else (v == 0.0) for v in hist["aux_moe"]), label
    assert called == {"chunked_attention": chunked,
                      "checkpoint": n_units * steps if remat else 0}, (label, called)
    assert meter.total == 2 * per_round * steps, (label, meter.total)
    assert {k: counts[k] for k in want} == want, (label, counts, want)
    assert peak < CARD_GB, (label, peak)
    res["profile"] = profile_train(torch, step_fn, state, batches[steps:], steps)
    del state
    return res, counts


# (arch, layers, algorithm, backbone dtype, loss limit, leaf limit, other
# config fields) of the card-against-CPU steps. bf16: θ, its gradients and
# Adam's μ round to 8 bits on both sides, so a leaf may part by a few bf16
# steps where the two sides' sums round otherwise; the limits are stated,
# not derived. olmoe-1b-7b's MoE layer, qwen2-vl-2b's vision prefix,
# whisper-base's encoder (1,500 frames) and cross-attention and
# xlstm-1.3b's mLSTM and sLSTM in f32, as qwen3-4b's.
TRAIN_PARITY = [("qwen3-4b", 1, "sfvi", "float32", 1e-4, 1e-3, {}),
                ("qwen3-4b", 1, "avg", "float32", 1e-4, 1e-3, {}),
                ("qwen3-4b", 1, "sfvi", "bfloat16", 1e-3, 1e-2, {}),
                ("olmoe-1b-7b", 1, "sfvi", "float32", 1e-4, 1e-3, {}),
                ("qwen2-vl-2b", 2, "sfvi", "float32", 1e-4, 1e-3, {}),
                ("whisper-base", 1, "sfvi", "float32", 1e-4, 1e-3, {"num_encoder_layers": 1}),
                ("xlstm-1.3b", 2, "sfvi", "float32", 1e-4, 1e-3, {"slstm_period": 2})]


def check_train_cuda_vs_cpu(torch):
    """Each ``TRAIN_PARITY`` step at full width, B = 4, S = 16, J = 2: the
    same state (drawn on the CPU), tokens (and vision prefix) and ε through
    one step on the CPU and on the card: SFVI and SFVI-Avg with its
    barycenter (``avg_every`` 1) in f32 (loss within 1e-4 relative, every
    θ, η_G and η_L leaf within 1e-3 relative Frobenius), and SFVI in bf16
    (the train cells' dtype: 1e-3 and 1e-2). The largest leaf gap printed;
    an MoE step's routing compared call by call (:class:`RouteLog`)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    from repro_torch.models.backbone.bayes import latent_dims
    from repro_torch.tree import tree_leaves, tree_map

    J, B, T = 2, 4, 16
    out = {}
    for arch, layers, algo, dtype, loss_tol, leaf_tol, extra in TRAIN_PARITY:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype=dtype, **extra)
        n_G, n_L = latent_dims(cfg)
        g = torch.Generator().manual_seed(5)
        state, opt = S.init_train_state(g, cfg, J, lr=TRAIN_LR)
        if algo == "avg":
            eta_G = S.init_eta_G_silo(g, cfg, J)
            state = S.TrainState(state.theta, eta_G, state.eta_L, state.opt_theta,
                                 opt.init(eta_G), state.opt_eta_L, state.step)
            step = S.make_train_step_avg(cfg, J, 1, lr=TRAIN_LR, remat=False)
            draws = (torch.randn((J, n_G), generator=g), torch.randn((J, n_L), generator=g))
        else:
            step = S.make_train_step(cfg, J, lr=TRAIN_LR, remat=False)
            draws = (torch.randn((n_G,), generator=g), torch.randn((J, n_L), generator=g))
        tok = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=g)
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:], **stub_inputs(torch, cfg, B, g)}
        fields = [f.name for f in dataclasses.fields(S.TrainState)]
        # A copy (the step updates its state in place), even where DEVICE is the CPU.
        dev_state = S.TrainState(**{f: tree_map(lambda a: a.to(DEVICE, copy=True),
                                                getattr(state, f))
                                    if f != "step" else state.step for f in fields})
        to_dev = lambda tree: tree_map(lambda a: a.to(DEVICE), tree)  # noqa: E731
        routes = RouteLog(torch)
        t0 = time.perf_counter()
        with routes("record"):
            st_cpu, m_cpu = step(state, batch, 0, draws=draws)
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with routes("match"):
            st_card, m_card = step(dev_state, to_dev(batch), 0, draws=to_dev(draws))
        sync(torch)
        card_s = time.perf_counter() - t0
        loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
        gaps = []
        for name in ("theta", "eta_G", "eta_L"):
            for a, b in zip(tree_leaves(getattr(st_card, name)), tree_leaves(getattr(st_cpu, name)),
                            strict=True):
                a, b = a.cpu().double(), b.double()
                gaps.append(float(torch.linalg.norm((a - b).flatten())
                                  / torch.linalg.norm(b.flatten())))
        aux = (f", aux_moe {float(m_card['aux_moe']):.6f} vs {float(m_cpu['aux_moe']):.6f}; "
               f"{routes.line()}" if cfg.is_moe else "")
        print(f"  train {DEVICE} vs cpu [{arch}, {layers} layer(s) {extra} at full width, "
              f"{dtype}, {algo}, J={J}, B={B}, S={T}"
              f"{' + %d vision' % cfg.num_vision_tokens if cfg.num_vision_tokens else ''}"
              f"{' + %d frames' % cfg.encoder_seq_len if cfg.is_encoder_decoder else ''}]: "
              f"loss {float(m_card['loss']):.6f} vs {float(m_cpu['loss']):.6f} "
              f"rel={loss_rel:.2e} (<= {loss_tol:g}), largest leaf gap {max(gaps):.2e} of "
              f"{len(gaps)} leaves (relative Frobenius, <= {leaf_tol:g}){aux}; card "
              f"{card_s:.1f} s, cpu {cpu_s:.1f} s", flush=True)
        assert loss_rel <= loss_tol and max(gaps) <= leaf_tol, (arch, algo, dtype, loss_rel,
                                                                 max(gaps))
        assert bool(routes.kept) == cfg.is_moe
        if algo == "avg":  # the barycenter ran: the silos' rows coincide
            assert float((st_card.eta_G["mu"][0] - st_card.eta_G["mu"][1]).abs().max()) == 0.0
        key = f"{algo}_{dtype}" if arch == "qwen3-4b" else f"{arch}_{algo}_{dtype}"
        out[key] = {"loss_rel": loss_rel, "max_leaf_gap": max(gaps)}
        if cfg.is_moe:
            out[key].update(flipped_pairs=routes.flips, injected_calls=routes.injected,
                            min_topk_margin=routes.margin)
        del state, st_cpu, st_card, dev_state
    return out


def train_runs(torch, ref, reparam, wire, backbone_modules):
    """Phase 3f: the card-against-CPU steps, then every ``TRAIN_RUNS`` cell;
    every reparam and combine launch of the cells held to its plain version.
    Returns the cells' summed launches and their result lines."""
    modules = [reparam, wire] + backbone_modules
    parity = check_train_cuda_vs_cpu(torch)
    print(json.dumps({"train_cuda_vs_cpu": parity}), flush=True)
    totals, results = {k: 0 for k in TRAIN_COUNTS}, []
    for run in TRAIN_RUNS:
        with PathRecorder(torch, reparam, phase="3f", names=("reparam_fwd", "reparam_bwd")) \
                as rec_r, PathRecorder(torch, wire, phase="3f", names=("fused_combine",)) as rec_w:
            res, counts = train_run(torch, modules, *run)
        held = {**rec_r.hold(ref), **rec_w.hold(ref)}
        res["held_to_plain"] = held
        results.append(res)
        for k in totals:
            totals[k] += counts[k]
        torch.cuda.empty_cache()
    return totals, results


# ---------------------------------------------------------------------------
# Phase 3g: Figure S1 on the card (SFVI against the HMC oracle)
# ---------------------------------------------------------------------------

# benchmarks/bench_glmm.py's run at its full width (536 children, two even
# silos, lr 2e-2, K = 25, 24 leapfrog steps); its quick lengths by default,
# its full ones (240 rounds, 1,500 + 1,500 draws) under --figure-s1.
FIG_S1 = {"children": 536, "silos": 2, "K": 25, "lr": 2e-2, "leapfrog": 24, "seed": 0}
FIG_S1_LENGTHS = {False: (60, 400, 400), True: (240, 1500, 1500)}  # rounds, warmup, samples
FIG_S1_PARAMS = ["beta0", "beta1(smoke)", "beta2(age)", "beta3(smoke*age)", "omega"]
# The card-against-CPU chain: 30 warmup (the mass matrix refreshed at 15)
# + 20 samples in float64 on the same injected draws. Warmup tries step
# sizes past the leapfrog's stability limit, where a rounding difference
# grows by up to ~1e4 in one draw (tests/test_torch_hmc.py), so float64:
# samples within 1e-5 of the largest |sample|, equal accept decisions away
# from a tie (|u - α| under 1e-6).
HMC_PARITY = (30, 20, 1e-5, 1e-6)


def hmc_cuda_vs_cpu(torch, pooled, dim):
    """The first 50 draws of the oracle on the card and on the CPU, float64,
    on one injected stream; returns (largest gap / largest |sample|,
    decisions compared, ties skipped)."""
    from repro_torch.inference import hmc_sample
    from repro_torch.models.paper.glmm import pooled_log_prob

    warm, samp, tol, tie = HMC_PARITY
    g = torch.Generator().manual_seed(7)
    draws = (torch.randn((warm + samp, dim), generator=g, dtype=torch.float64),
             torch.rand((warm + samp,), generator=g, dtype=torch.float64))
    init = 0.1 * torch.randn(dim, generator=g, dtype=torch.float64)
    out = {}
    for dev in ("cpu", DEVICE):
        data = {k: v.to(dev, torch.float64) for k, v in pooled.items()}
        trace = {}
        s, acc = hmc_sample(pooled_log_prob(data), init.to(dev), num_samples=samp,
                            num_warmup=warm, num_leapfrog=FIG_S1["leapfrog"],
                            draws=tuple(d.to(dev) for d in draws), trace=trace)
        out[dev] = (s.cpu(), float(acc), trace["alpha"].cpu(), trace["accept"].cpu())
    (s0, a0, al0, ac0), (s1, a1, al1, ac1) = out["cpu"], out[DEVICE]
    near = (draws[1] - al0).abs() < tie
    first = int(near.nonzero()[0]) if bool(near.any()) else warm + samp
    same = bool((ac0[:first] == ac1[:first]).all())
    held = max(first - warm, 0)
    gap = float((s1[:held] - s0[:held]).abs().max() / s0.abs().max()) if held else 0.0
    print(f"  phase 3g HMC {DEVICE} vs cpu (float64, {warm} warmup + {samp} samples, "
          f"{FIG_S1['leapfrog']} leapfrog, dim {dim}): accept decisions equal over "
          f"{first} draws={same}, largest sample gap {gap:.2e} of the largest |sample| "
          f"(<= {tol:g}), accept rate {a1:.6f} vs {a0:.6f}", flush=True)
    assert same and gap <= tol, (first, same, gap)
    return {"max_rel_gap": gap, "draws_compared": first, "accept_card": a1, "accept_cpu": a0}


def figure_s1(torch, wire, reparam, ref, full: bool):
    """Phase 3g: Figure S1 (``bench_glmm.py``) on the card: the SFVI fit of
    the two-silo GLMM through the experiment API on the fused wire, every
    upload and combine launch held to its plain version; the HMC oracle on
    the pooled data; the table of marginal means and sds. Returns the
    fit's launch counts and the result line."""
    from repro_torch.federated.api import build
    from repro_torch.inference import hmc_sample
    from repro_torch.models.paper.glmm import pooled_log_prob
    from repro_torch.models.paper.registry import get_model

    rounds, warm, samp = FIG_S1_LENGTHS[full]
    c, J, K = FIG_S1["children"], FIG_S1["silos"], FIG_S1["K"]
    bundle = get_model("glmm").build(0, J, device=DEVICE, num_children=c)
    pooled, n = bundle.extras["pooled"], bundle.extras["num_children"]
    spec = api_spec("glmm", {"num_children": c}, "sfvi", J, rounds, K)
    assert spec.server_opt.learning_rate == FIG_S1["lr"], spec.server_opt
    exp = build(spec, bundle=bundle, device=DEVICE)
    with PathRecorder(torch, wire, phase="3g", names=("fused_upload", "fused_combine")) as rec:
        h, counts, round_s = api_rounds(torch, wire, reparam, exp, rounds)
    held = rec.hold(ref)
    assert counts["fused_upload"] == counts["fused_combine"] == rounds * K, counts
    vi_mu = exp.server.eta_G["mu"].cpu()
    vi_sd = torch.exp(exp.server.eta_G["log_sigma"]).cpu()

    dim = 5 + n
    parity = hmc_cuda_vs_cpu(torch, pooled, dim)
    # The start (seed + 99, as bench_glmm.py) and the draws from CPU
    # generators, as the port's chain on the CPU takes them. The reference's
    # sampler has no divergence guard: one proposal whose e^{2ω} b² overflows
    # makes α nan, and nan dual averaging stops the chain (both packages).
    init = 0.1 * torch.randn(dim, generator=torch.Generator().manual_seed(FIG_S1["seed"] + 99))
    g = torch.Generator().manual_seed(FIG_S1["seed"])
    draws = (torch.randn((warm + samp, dim), generator=g), torch.rand((warm + samp,), generator=g))
    sync(torch)
    t0 = time.perf_counter()
    trace = {}
    samples, acc = hmc_sample(pooled_log_prob(pooled), init.to(DEVICE), num_samples=samp,
                              num_warmup=warm, num_leapfrog=FIG_S1["leapfrog"],
                              draws=tuple(d.to(DEVICE) for d in draws), trace=trace)
    sync(torch)
    chain_s = time.perf_counter() - t0
    assert bool(torch.isfinite(samples).all()) and tuple(samples.shape) == (samp, dim)
    mc = samples[:, :5].cpu()
    mc_mu, mc_sd = mc.mean(0), mc.std(0)
    nan_alpha = int(torch.isnan(trace["alpha"]).sum())
    assert bool((mc_sd > 0).all()) and nan_alpha == 0, (mc_sd, nan_alpha, float(acc))
    rows = [{"param": name, "SFVI mean": float(vi_mu[i]), "HMC mean": float(mc_mu[i]),
             "SFVI sd": float(vi_sd[i]), "HMC sd": float(mc_sd[i]),
             "|dmean|/sd": abs(float(vi_mu[i] - mc_mu[i])) / float(mc_sd[i])}
            for i, name in enumerate(FIG_S1_PARAMS)]
    print(f"  Figure S1 (glmm {c} children, {J} silos; SFVI {rounds} rounds x K={K} on the "
          f"fused wire; HMC {warm} + {samp} draws x {FIG_S1['leapfrog']} leapfrog, dim {dim}):",
          flush=True)
    print(f"  {'param':<18}{'SFVI mean':>11}{'HMC mean':>11}{'SFVI sd':>10}{'HMC sd':>10}"
          f"{'|dmean|/sd':>12}", flush=True)
    for r in rows:
        print(f"  {r['param']:<18}{r['SFVI mean']:>11.3f}{r['HMC mean']:>11.3f}"
              f"{r['SFVI sd']:>10.3f}{r['HMC sd']:>10.3f}{r['|dmean|/sd']:>12.2f}", flush=True)
    grads = (warm + samp) * FIG_S1["leapfrog"] + 1
    res = {"figure_s1": rows, "full_lengths": full, "rounds": rounds, "K": K,
           "sfvi_s_per_round_median_after_first": statistics.median(round_s[1:]),
           "sfvi_elbo_last": h["elbo"][-1], "hmc_warmup": warm, "hmc_samples": samp,
           "hmc_accept_rate": float(acc), "hmc_chain_s": chain_s,
           "hmc_ms_per_gradient": chain_s * 1e3 / grads, "hmc_cuda_vs_cpu": parity,
           "launches": counts, "held_to_plain": held}
    print(f"  HMC accept rate {float(acc):.3f}, chain {chain_s:.1f} s "
          f"({res['hmc_ms_per_gradient']:.3f} ms a gradient); SFVI "
          f"{res['sfvi_s_per_round_median_after_first']:.3f} s a round", flush=True)
    assert all(math.isfinite(v) for r in rows for k, v in r.items() if k != "param")
    return counts, res


# ---------------------------------------------------------------------------
# Phase 3h: the deprecated eager adapters on the card
# ---------------------------------------------------------------------------


def eager_adapter_runs(torch, wire, reparam, ref):
    """Phase 3h: ``SFVIServer`` at §4.1 width (hier_bnn, J = 10, 3 rounds)
    bit for bit with the port's ``Server`` on the same inputs, its η_L
    rows written back into the Silos; ``SFVIAvgServer`` on the GLMM +
    Cholesky (536 children, J = 2, K = 25, 2 rounds): 100 root launches a
    round, every launch held to its plain version. Returns the launches."""
    import warnings

    from repro_torch.core import Silo, SFVIAvgServer, SFVIServer
    from repro_torch.core.family import FamilySpec
    from repro_torch.device import generator
    from repro_torch.federated.runtime import Server
    from repro_torch.models.paper.registry import apply_family_spec, get_model
    from repro_torch.optim import adam
    from repro_torch.tree import tree_leaves, tree_map

    totals = {k: 0 for k in KERNEL_COUNTS}
    bundle = get_model("hier_bnn").build(0, MAIN_J, device=DEVICE, **HIER_KWARGS)
    prob = bundle.problem
    eta_G = prob.global_family.init(generator(5, torch.device(DEVICE)))
    silos = [Silo(j, prob, bundle.datas[j], None, adam(2e-2), bundle.num_obs[j])
             for j in range(MAIN_J)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        legacy = SFVIServer(prob, silos, bundle.theta0, eta_G, adam(2e-2), seed=3)
    direct = Server(prob, bundle.datas, bundle.theta0, eta_G, num_obs=bundle.num_obs,
                    server_opt=adam(2e-2), local_opt=adam(2e-2), eta_mode="param", seed=3,
                    device=DEVICE)
    for m in (wire, reparam):
        m.reset_launches()
    with PathRecorder(torch, wire, phase="3h") as rec:
        h_legacy = legacy.run(3)
        sync(torch)
        counts = counters([wire, reparam])
        h_direct = direct.run(3, algorithm="sfvi", local_steps=1)
        sync(torch)
    rec.hold(ref)
    equal = (all(torch.equal(a, b) for a, b in zip(
        tree_leaves([legacy.theta, legacy.eta_G, legacy._compiled.eta_L]),
        tree_leaves([direct.theta, direct.eta_G, direct.eta_L]), strict=True))
        and h_legacy["elbo_trace"] == h_direct["elbo_trace"])
    back = all(torch.equal(a, b) for j, s in enumerate(silos) for a, b in zip(
        tree_leaves(s.eta_L), tree_leaves(tree_map(lambda x, jj=j: x[jj], direct.eta_L)),
        strict=True))
    line = {"adapter": "SFVIServer hier_bnn J=10, 3 rounds", "bit_identical_to_server": equal,
            "eta_L_written_back": back, "launches": counts,
            "bytes_up": h_legacy["bytes_up"]}
    print(json.dumps(line), flush=True)
    assert equal and back, line
    assert counts["fused_upload"] == counts["fused_combine"] == 3, counts
    for k in totals:
        totals[k] += counts[k] * 2  # the adapter's run and the Server's

    gb = apply_family_spec(get_model("glmm").build(0, GLMM_J, device=DEVICE,
                                                   num_children=GLMM_CHILDREN),
                           global_family=FamilySpec("cholesky"))
    gprob = gb.problem
    gsilos = [Silo(j, gprob, gb.datas[j], None, adam(2e-2), gb.num_obs[j])
              for j in range(GLMM_J)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        avg = SFVIAvgServer(gprob, gsilos, {}, gprob.global_family.init(
            generator(6, torch.device(DEVICE))), lambda: adam(2e-2), seed=4)
    for m in (wire, reparam):
        m.reset_launches()
    t0 = time.perf_counter()
    with PathRecorder(torch, wire, phase="3h") as rec:
        h = avg.run(2, local_steps=GLMM_K)
        sync(torch)
    wall = time.perf_counter() - t0
    counts = counters([wire, reparam])
    held = rec.hold(ref)
    line = {"adapter": f"SFVIAvgServer glmm+cholesky J={GLMM_J}, K={GLMM_K}, 2 rounds",
            "launches": counts, "s": wall, "elbo": h["elbo"], "roots_held": held}
    print(json.dumps(line), flush=True)
    assert counts["sqrtm_newton_schulz"] == 2 * NS_ROOTS_PER_MERGE, counts
    assert counts["fused_upload"] == 2 and counts["newton_schulz_step"] == 0, counts
    assert all(math.isfinite(v) for v in h["elbo"]) and all(
        s.eta_L is not None for s in gsilos)
    for k in totals:
        totals[k] += counts[k]
    return totals


# ---------------------------------------------------------------------------
# Phase 3i: the backbone's train step over the ranks of a world
# ---------------------------------------------------------------------------

# (label, arch, layers, dtype, algorithm, steps, avg_every, world, backend,
# bytes a round): J 4, B 8, S 64 as phase 3f. The ranks of a world share
# the one card (gloo stages the gradients' all-reduce through host memory);
# NCCL runs as a 1-rank world. The f32 runs are held to the one-process run
# by each leaf's relative Frobenius gap (``TRAIN_MP_GAP``). A bf16 run is
# held element by element (``TRAIN_MP_BF16``): a rank's 2- or 4-row
# gradient rounds otherwise than one process's 8 rows, so an element may
# part by a bf16 step where Adam's update rounds the other way, and a small
# leaf's Frobenius gap then measures that step, not the split.
TRAIN_MP_RUNS = [
    ("qwen3-4b 36 layers SFVI, 1-rank NCCL world", "qwen3-4b", 36, "bfloat16", "sfvi", 3, 2,
     1, "nccl", 35_330_945_056),
    ("whisper-base 6 + 6 layers SFVI, 2 gloo ranks", "whisper-base", 6, "float32", "sfvi", 3,
     2, 2, "gloo", None),
    ("whisper-base 6 + 6 layers SFVI bf16, 2 gloo ranks", "whisper-base", 6, "bfloat16",
     "sfvi", 3, 2, 2, "gloo", None),
    ("whisper-base 6 + 6 layers SFVI-Avg, 2 gloo ranks", "whisper-base", 6, "float32", "avg",
     3, 2, 2, "gloo", None),
    ("whisper-base 6 + 6 layers SFVI, 4 gloo ranks", "whisper-base", 6, "float32", "sfvi", 3,
     2, 4, "gloo", None),
]
TRAIN_MP_GAP = 1e-3  # largest relative Frobenius gap of a leaf to the one-process run
# A bf16 run: the share of the state's elements that may part from the
# one-process run by more than one bf16 step at their value, and the most
# any element may part: 2·lr a step (Adam's update turned round where a
# gradient's rank partials, each rounded to bf16, change its sign) plus one
# bf16 step at its value a step. On one H100 the whisper-base cell parts
# 2.74 % of its 111.8 M elements (the MLP matrices most: 7.0 % of the
# encoder's w_down, whose Frobenius gap is 4.74e-3) and its worst element
# reads 0.863 of the element limit.
TRAIN_MP_BF16 = {"parted_share": 5e-2}
TRAIN_MP_LOSS = 1e-4  # relative gap of a step's loss (the metrics' reduction)


def _named(tree, prefix):
    """(path, tensor) for each leaf of a dict / list tree, in tree order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _named(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _bf16_step(torch, a, b):
    """One bf16 step at max(|a|, |b|), element by element (f32)."""
    m = torch.maximum(a.abs(), b.abs()).float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def _leaf_gaps(torch, mine, one, steps, bf16):
    """Each leaf's relative Frobenius gap to the one-process run and, in a
    ``bf16`` run (whose f32 leaves, the η, are fed by bf16 arithmetic too),
    its elements that part by more than one bf16 step and the largest part
    in units of (2·lr + one bf16 step) · steps."""
    out = []
    for (name, a), (_, b) in zip(mine, one, strict=True):
        b = b.to(a.device)
        d = (a.double() - b.double())
        row = {"leaf": name, "numel": a.numel(),
               "rel": float(d.norm() / b.double().norm().clamp_min(1e-30))}
        if bf16:
            step = _bf16_step(torch, a, b).double()
            row["parted"] = int((d.abs() > step).sum())
            row["worst"] = float((d.abs() / ((2 * TRAIN_LR + step) * steps)).max())
        out.append(row)
    return out


def _train_steps(torch, cfg, algo, steps, avg_every, mesh, modules):
    """``steps`` train steps through the CLI's pieces on this rank's silos
    (``mesh`` None: one process); returns (state, bytes a round, s a step,
    launches, losses, all-reduce host ms a step)."""
    from repro_torch.federated import distributed
    from repro_torch.launch import steps as S
    from repro_torch.launch import train

    device = torch.device(DEVICE)
    state, step_fn = train.setup(cfg, algo, TRAIN_J, TRAIN_LR, avg_every, device, mesh=mesh)
    per_round = train.bytes_per_round(state, algo, TRAIN_J, avg_every)
    state = train.rank_state(state, cfg, algo, TRAIN_J, mesh)
    batches = train_batches(torch, cfg, steps, TRAIN_B, TRAIN_S)
    blk = S.silo_block(cfg, TRAIN_J, mesh)
    batches = [{k: S.rank_rows(v, blk) for k, v in b.items()} for b in batches]
    for m in modules:
        m.reset_launches()
    distributed.reset_gathered()
    sync(torch)
    step_s, losses = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b, i)
        sync(torch)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    reduce_ms = distributed.REDUCED["seconds"] * 1e3 / steps
    return state, per_round, step_s, counters(modules), losses, reduce_ms


def _train_leaves(state, algo, mesh):
    """θ, η_G (SFVI-Avg's rows gathered: a collective) and η_L's rows, as
    (path, tensor) pairs."""
    from repro_torch.launch import train

    return {"theta": _named(state.theta, "theta"),
            "eta_G": _named(train.gathered_eta_G(state, algo, mesh), "eta_G"),
            "eta_L": _named(state.eta_L, "eta_L")}


def _bf16_parting(runs):
    """A bf16 run's elements that part from one process by more than one
    bf16 step, over the whole state once: rank 0's θ and SFVI's η_G (the
    same on every rank), every rank's η_L rows (and SFVI-Avg's η_G rows,
    gathered: rank 0's hold them all). The eight leaves with the most."""
    held = [g for i, r in enumerate(runs) for g in r["leaf_gaps"]
            if i == 0 or g["leaf"].startswith("eta_L")]
    parted = sum(g["parted"] for g in held)
    numel = sum(g["numel"] for g in held)
    return {"bf16_elements": numel, "bf16_parted": parted, "bf16_parted_share": parted / numel,
            "bf16_parted_leaves": sorted(
                ({k: g[k] for k in ("leaf", "numel", "parted", "rel")}
                 for g in held if g["parted"]), key=lambda g: -g["parted"])[:8],
            "bf16_worst_element": max(g["worst"] for g in held)}


def train_mp_run(torch, run, mesh, modules, ref):
    """One phase-3i run on this rank: the one-process run first (its state
    kept on the host), then the run on the mesh with its launches held to
    their plain versions; the largest relative gap of a leaf between them
    (this rank's η_L rows against the same rows)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    from repro_torch.kernels import reparam, wire

    label, arch, layers, dtype, algo, steps, avg_every, world, backend, want_bytes = run
    cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype=dtype)
    state, one_bytes, one_s, _, one_loss, _ = _train_steps(torch, cfg, algo, steps, avg_every,
                                                           None, modules)
    one = {k: [(n, x.detach().cpu()) for n, x in v]
           for k, v in _train_leaves(state, algo, None).items()}  # kept on the host
    del state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with PathRecorder(torch, reparam, phase="3i", names=("reparam_fwd", "reparam_bwd")) as rr, \
            PathRecorder(torch, wire, phase="3i", names=("fused_combine",)) as rw:
        state, per_round, step_s, counts, losses, reduce_ms = _train_steps(
            torch, cfg, algo, steps, avg_every, mesh, modules)
    peak = torch.cuda.max_memory_allocated()
    held = {**rr.hold(ref), **rw.hold(ref)}
    mine = _train_leaves(state, algo, mesh)
    blk = S.silo_block(cfg, TRAIN_J, mesh)
    one["eta_L"] = [(n, x[blk.lo: blk.hi]) for n, x in one["eta_L"]]
    gaps = [g for k in one  # on the card
            for g in _leaf_gaps(torch, mine[k], one[k], steps, dtype == "bfloat16")]
    digest = _digest([x.detach().cpu().view(torch.uint8) for _, x in
                      mine["theta"] + mine["eta_G"]]) if world > 1 else None
    del mine
    del state
    torch.cuda.empty_cache()
    return {"label": label, "bytes_per_round": per_round, "one_process_bytes": one_bytes,
            "want_bytes": want_bytes, "s_per_step": step_s, "one_process_s_per_step": one_s,
            "peak_gb": peak / 1e9, "launches": counts, "loss": losses,
            "one_process_loss": one_loss, "leaf_gaps": gaps, "digest": digest,
            "allreduce_host_ms_per_step": reduce_ms, "held_to_plain": held,
            "rows": [blk.lo, blk.hi]}


def train_mp_worker(task_json: str) -> int:
    """One rank of a phase-3i world (``--train-worker``): the world from the
    env schema, the task's runs on its mesh, one ``TRRESULT`` line."""
    import torch

    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.federated import distributed
    from repro_torch.kernels import attention, gla, ref, reparam, rmsnorm, wire
    from repro_torch.launch.mesh import MeshSpec, build_mesh

    task = json.loads(task_json)
    distributed.initialize(backend=task["backend"], device=DEVICE)
    import torch.distributed as dist

    mesh = build_mesh(MeshSpec(silo=dist.get_world_size(), multiprocess=True),
                      num_silos=TRAIN_J)
    modules = [reparam, wire, attention, gla, rmsnorm]
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "world": dist.get_world_size(), "runs": []}
    for run in TRAIN_MP_RUNS:
        if run[0] in task["runs"]:
            out["runs"].append(train_mp_run(torch, run, mesh, modules, ref))
    print("TRRESULT " + json.dumps(out), flush=True)
    distributed.shutdown()
    return 0


def train_multiprocess_runs(torch, card):
    """Phase 3i: each world of ``TRAIN_MP_RUNS`` spawned here (the kernels
    are built), every rank's exit code checked. Asserts the ranks
    bit-identical, each run within ``TRAIN_MP_GAP`` of the one-process run,
    the bytes a round exact and 2 + 2 reparam launches a step a rank (2
    combines a barycenter step). Returns the launches of every rank."""
    import socket

    totals = {k: 0 for k in TRAIN_COUNTS}
    worlds = {}
    for run in TRAIN_MP_RUNS:
        worlds.setdefault((run[7], run[8]), []).append(run[0])
    results = []
    for (n, backend), labels in worlds.items():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, REPRO_COORDINATOR=f"localhost:{port}",
                   REPRO_NUM_PROCESSES=str(n))
        task = json.dumps({"backend": backend, "runs": labels})
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--train-worker",
                                   task], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True, env=dict(env, REPRO_PROCESS_ID=str(r)), cwd=ROOT)
                 for r in range(n)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MP_JOIN_S))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        world_s = time.perf_counter() - t0
        ranks = []
        for r, (p, (out, err)) in enumerate(zip(procs, outs, strict=True)):
            for line in out.splitlines():
                if line.startswith("  phase 3i"):
                    print(f"  [{backend} rank {r}/{n}]{line[1:]}", flush=True)
            assert p.returncode == 0, (f"{backend} rank {r}/{n} exited {p.returncode}",
                                       out[-3000:], err[-6000:])
            line = [ln for ln in out.splitlines() if ln.startswith("TRRESULT ")][-1]
            ranks.append(json.loads(line[len("TRRESULT "):]))
        for i, label in enumerate(labels):
            runs = [res["runs"][i] for res in ranks]
            run = next(x for x in TRAIN_MP_RUNS if x[0] == label)
            algo, steps, avg_every = run[4], run[5], run[6]
            want = train_launches(algo, steps, avg_every)
            line = {"train_mp_run": label, "dtype": run[3],
                    "world": f"{backend} x{n} ({MP_WORLD})", "card": card,
                    "world_s": world_s,
                    "ranks_bit_identical": n == 1 or len({r["digest"] for r in runs}) == 1,
                    "max_rel_gap_to_one_process": max(g["rel"] for r in runs
                                                      for g in r["leaf_gaps"]),
                    "worst_leaf": max((dict(g, rank=i) for i, r in enumerate(runs)
                                       for g in r["leaf_gaps"]), key=lambda g: g["rel"]),
                    "bytes_per_round": runs[0]["bytes_per_round"],
                    "s_per_step": [r["s_per_step"] for r in runs],
                    "one_process_s_per_step": runs[0]["one_process_s_per_step"],
                    "peak_gb": [r["peak_gb"] for r in runs],
                    "allreduce_host_ms_per_step": [r["allreduce_host_ms_per_step"]
                                                   for r in runs],
                    "launches_per_rank": runs[0]["launches"], "loss": runs[0]["loss"],
                    "one_process_loss": runs[0]["one_process_loss"],
                    "rows": [r["rows"] for r in runs]}
            if run[3] == "bfloat16":
                line.update(_bf16_parting(runs))
            print(json.dumps(line), flush=True)
            assert line["ranks_bit_identical"], line
            assert all(abs(a - b) <= TRAIN_MP_LOSS * abs(b) for a, b in
                       zip(line["loss"], line["one_process_loss"], strict=True)), line
            if run[3] == "bfloat16" and n > 1:
                assert line["bf16_parted_share"] <= TRAIN_MP_BF16["parted_share"], line
                assert line["bf16_worst_element"] <= 1.0, line
            else:
                assert line["max_rel_gap_to_one_process"] <= TRAIN_MP_GAP, line
            for r in runs:
                assert r["bytes_per_round"] == r["one_process_bytes"], r["label"]
                assert r["want_bytes"] is None or r["bytes_per_round"] == r["want_bytes"]
                assert {k: r["launches"][k] for k in want} == want, (label, r["launches"])
                assert all(math.isfinite(v) for v in r["loss"]), label
                for k in totals:
                    totals[k] += r["launches"][k]
            results.append(line)
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
    row whose single launch exceeds ``RUN_MAX_MS`` skips (None) unless
    ``run="long"`` (a kernel, and its library call, that is one launch
    however long), as does a call of many launches (``run=False``: a run of
    them would fill the card's launch queue before the sleep ends)."""
    ms = device_ms(torch, lambda: fn(*args), **kw)
    return ms, (run_ms(torch, fn, args) if run == "long" or (run and ms <= RUN_MAX_MS)
                else None)


def time_row(torch, name, mode, kernel, plain, library=None, **row):
    """A phase-4 row: the kernel and the library call (``(fn, args)`` each,
    or None) timed both ways, the plain version (a no-argument call) one
    launch at a time."""
    fn, args = kernel
    run_mode = row.pop("run", True)
    ms, run = timed(torch, fn, args, run=run_mode, **row.pop("kernel_kw", {}))
    lib_ms = lib_run = None
    if library is not None:
        lib_ms, lib_run = timed(torch, *library, run="long" if run_mode == "long" else True)
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
    # The combine kernel at the barycenter's shapes: the glmm means (2, 5),
    # hier_bnn's moment rows (10, 50,177) and the train path's SFVI-Avg rows
    # of qwen3-4b (4, 1,235,969).
    for Jc, Pc in [(2, 5), (10, 50_177), (4, 1_235_969)]:
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


# The reparam kernels' f32 sizes: hier_bnn's J x local dim and global dim,
# then the train path's: qwen3-4b's n_G (z_G), J x n_L (z_L) and J x n_G
# (SFVI-Avg's per-silo z_G), J = 4.
REPARAM_TIMES = (508_160, 50_177, 1_235_969, 1_843_712, 4_943_876)


def reparam_timings(torch, reparam, ref, gen):
    """Forward and backward in f32 at ``REPARAM_TIMES``. The forward's
    yardstick is ``torch.addcmul(mu, ls.exp(), eps)`` for z; no single
    PyTorch call computes the backward."""
    rows = []
    for n in REPARAM_TIMES:
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


def flash_work(B, Sq, Skv, H, KV, hd, elt, causal=True):
    """Bytes (q, k, v read once, out written once) and flops (4 hd per live
    (query, key) pair: causal with q_offset 0, or every pair)."""
    live = sum(min(i + 1, Skv) for i in range(Sq)) if causal else Sq * Skv
    return (2 * B * Sq * H * hd + 2 * B * Skv * KV * hd) * elt, 4 * hd * live * B * H


FLASH_TIMES = [
    # (mode, B, Sq, Skv, H, KV, hd, causal)
    ("zamba2_prefill_4096_bf16", 4, 4096, 4096, 32, 32, 112, True),
    ("zamba2_prefill_64_bf16", 8, 64, 64, 32, 32, 112, True),
    ("qwen3_prefill_512_bf16", 8, 512, 512, 32, 8, 128, True),
    ("llama_gqa3_prefill_64_bf16", 8, 64, 64, 24, 8, 128, True),
    ("qwen3_32b_gqa8_prefill_512_bf16", 8, 512, 512, 64, 8, 128, True),
    ("olmoe_prefill_512_bf16", 8, 512, 512, 16, 16, 128, True),
    ("qwen2_vl_gqa6_prefill_512_bf16", 8, 512, 512, 12, 2, 128, True),
    ("whisper_encoder_1500_bf16", 8, 1500, 1500, 8, 8, 64, False),
    ("whisper_cross_prefill_64_bf16", 8, 64, 1500, 8, 8, 64, False),
    ("whisper_cross_decode_bf16", 8, 1, 1500, 8, 8, 64, False),
    ("whisper_decoder_self_64_bf16", 8, 64, 64, 8, 8, 64, True),
]
GLA_TIMES = [
    # (mode, B, S, H, dk, dv, q/k one group broadcast over the heads)
    ("zamba2_prefill_4096_bf16", 4, 4096, 112, 64, 64, True),
    ("zamba2_prefill_64_bf16", 8, 64, 112, 64, 64, True),
    ("mlstm_prefill_512_bf16", 8, 512, 4, 1024, 1025, False),
]
RMS_TIMES = [("d3584_r16384_bf16", 4 * 4096, 3584), ("d7168_r16384_bf16", 4 * 4096, 7168),
             ("d2560_r4096_bf16", 8 * 512, 2560), ("d128_r131072_bf16", 8 * 512 * 32, 128),
             ("d3584_r8_bf16", 8, 3584), ("d512_r12000_bf16", 8 * 1500, 512)]


def backbone_timings(torch, attention, gla, rmsnorm, ref, gen):
    """The three backbone kernels at their serve shapes, bf16."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    rows = []
    for mode, B, Sq, Skv, H, KV, hd, causal in FLASH_TIMES:
        q = torch.randn((B, Sq, H, hd), generator=gen, device=DEVICE).to(bf16)
        k, v = (torch.randn((B, Skv, KV, hd), generator=gen, device=DEVICE).to(bf16)
                for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def library(qt, kt, vt, causal=causal):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)

        lib_err = float((library(qt, kt, vt).transpose(1, 2).float()
                         - attention.flash_attention(q, k, v, causal=causal).float()).abs().max())
        assert lib_err <= 2e-2 * (1 + float(v.float().abs().max())), (mode, lib_err)
        nbytes, flops = flash_work(B, Sq, Skv, H, KV, hd, 2, causal)
        # The tensor-core kernel with one (64 q rows) and two (128) warpgroups
        # a block; the wrapper's choice carries the plain mode name.
        for q_rows in attention.TC_Q_ROWS:
            rows.append(time_row(
                torch, "flash_attention",
                mode if q_rows == attention.tc_q_rows(Sq) else f"{mode}_q{q_rows}",
                (lambda q, k, v, r=q_rows, c=causal:
                 attention.flash_attention(q, k, v, causal=c, q_rows=r), (q, k, v)),
                lambda q=q, k=k, v=v, c=causal: ref.flash_attention_plain(q, k, v, causal=c),
                (library, (qt, kt, vt)), plain_kw=dict(reps=5, warmup=1), run="long",
                nbytes=nbytes, flops=flops, peak=BF16_FLOPS,
                shape=[B, Sq, Skv, H, KV, hd, int(causal)]))
    for mode, B, S, H, N, P, shared in GLA_TIMES:
        if not shared:
            rows += mlstm_gla_rows(torch, gla, ref, gen, mode, B, S, H, N, P)
            continue
        q, k, v, log_a = gla_inputs(torch, B, S, H, N, P, True, gen, bf16)
        qg, kg = q[:, :, :1], k[:, :, :1]  # the (B, S, 1, N) groups mamba2 expands
        # The serve path's call (mamba2_prefill: y and the final state) carries
        # the plain mode name; "_nostate" is y alone.
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


def mlstm_gla_rows(torch, gla, ref, gen, mode, B, S, H, dk, dv):
    """GLA at the mLSTM's shape (dk past 128: 8 dk tiles, the reduction
    after), y and the state as the serve path calls it and y alone, and
    the reduction alone on the workspace of that call. Bytes: q, k, v, y
    bf16 once, log_a f32, the state f32 (the workspace's round trip is the
    split's cost, not the function's); operations: per chunk and (b, h)
    2 C^2 dk + 2 C^2 dv + 4 C dk dv."""
    q, k, v, log_a = gla_inputs(torch, B, S, H, dk, dv, False, gen, torch.bfloat16)
    C = gla.CHUNK
    chunks = -(-S // C)
    flops = (2 * C * C * dk + 2 * C * C * dv + 4 * C * dk * dv) * chunks * B * H
    rows = []
    for with_state in (True, False):
        rows.append(time_row(
            torch, "gla", mode + ("" if with_state else "_nostate"),
            (lambda q, k, v, a, r=with_state: gla.gla(q, k, v, a, return_state=r),
             (q, k, v, log_a)),
            lambda q=q, k=k, v=v, a=log_a, r=with_state:
            ref.gla_plain(q, k, v, a, chunk=C, return_state=r),
            plain_kw=dict(reps=3, warmup=1), launches_per_call=2, run="long",
            nbytes=2 * B * S * H * dk * 2 + 2 * B * S * H * dv * 2 + B * S * H * 4
            + (B * H * dk * dv * 4 if with_state else 0),
            flops=flops, peak=BF16_FLOPS, shape=[B, S, H, dk, dv]))
    plan = gla.gla_plan(B, H, dk, dv, torch.bfloat16, S)
    n = B * S * H * dv
    ws = torch.randn((plan.dk_tiles * n,), generator=gen, device=DEVICE)
    out = torch.empty((B, S, H, dv), dtype=torch.bfloat16, device=DEVICE)
    lib = gla._lib()

    def reduce(ws):
        err = lib.repro_gla_reduce(ws.data_ptr(), out.data_ptr(), n, plan.dk_tiles, 1,
                                   torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out

    want = ws.view(plan.dk_tiles, n).sum(0).to(torch.bfloat16)
    err = float((reduce(ws).flatten().float() - want.float()).abs().max())
    assert err <= DTYPE_TOL["bfloat16"] * (1.0 + float(want.float().abs().max())), (mode, err)
    rows.append(time_row(
        torch, "gla_reduce", mode, (reduce, (ws,)),
        lambda ws=ws: ws.view(plan.dk_tiles, n).sum(0).to(torch.bfloat16),
        # the tiles' f32 partials read once, y written once in bf16
        nbytes=plan.dk_tiles * n * 4 + n * 2, flops=(plan.dk_tiles - 1) * n,
        peak=F32_FLOPS, shape=[plan.dk_tiles, B, S, H, dv]))
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
                        "f32_N1843712"),
    "reparam_stl_bwd": ("src/repro_torch/csrc/reparam.cu", "src/repro/kernels/reparam.py:128",
                        "f32_N1843712"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/attention.py:98", "zamba2_prefill_4096_bf16"),
    "gla": ("src/repro_torch/csrc/gla.cu", "src/repro/kernels/gla.py:73",
            "zamba2_prefill_4096_bf16"),
    # The Pallas kernel keeps y in f32 and casts it once; past dk = 128 the
    # port sums the dk tiles' f32 partials and casts in this second kernel.
    "gla_reduce": ("src/repro_torch/csrc/gla.cu", "src/repro/kernels/gla.py:73",
                   "mlstm_prefill_512_bf16"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:23",
                "d3584_r16384_bf16"),
}


# The serve path's flash and GLA calls are bf16, so their entries count the
# tensor-core kernels' launches (the SIMT kernels are the f32 parity route).
KERNEL_COUNTER = {"flash_attention": "flash_attention_tc", "gla": "gla_tc",
                  "gla_reduce": "gla_reduce"}


def kernels_line(rows, launches, errors):
    """The ``kernels`` entries: each kernel's row at its main-path shape.

    ``launches`` are the main-path runs' counts (the federated rounds and
    the train cells' barycenters for the combine, the serve runs for the
    backbone's, the train cells for the reparam kernels, at qwen3-4b's
    J x n_L); the step kernel is on no path: the barycenter's d = 5 roots
    take the square-root kernel, and the step serves only d past its
    limit.
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


def main(timings_only: bool = False, figure_s1_only: bool = False) -> int:
    """The smoke check; ``timings_only`` (``--timings``) runs phases 1 and 4
    alone and prints the timing rows, ``figure_s1_only`` (``--figure-s1``)
    phases 1 and 3g at Figure S1's full lengths; neither prints a
    ``kernels`` or ``ok`` line."""
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
    if figure_s1_only:
        print("phase 3g: Figure S1 at its full lengths", flush=True)
        _, res = figure_s1(torch, wire, reparam, ref, full=True)
        print(json.dumps(res), flush=True)
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
    check_grad_guard(torch, attention, gla, rmsnorm, gen)
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
    print("phase 3c: the experiment API (spec, build, run, save, resume) on the fused wire",
          flush=True)
    api_totals = experiment_api_runs(torch, wire, reparam)
    for k in totals:
        totals[k] += api_totals[k]
    lap("3c experiment API")
    print("phase 3d: buffered-async flushes, silo churn and the posterior endpoint on the "
          "fused wire", flush=True)
    d_totals = async_churn_serve_runs(np, torch, wire, reparam, ref)
    for k in totals:
        totals[k] += d_totals[k]
    print(json.dumps({"phase_3d_launches": d_totals}), flush=True)
    lap("3d async, churn, serving")
    print("phase 3e: multi-process federation on one card (a 1-rank NCCL world; 2 and 4 "
          f"gloo ranks sharing the card: {MP_WORLD})", flush=True)
    e_totals = multiprocess_runs(np, torch, wire, reparam, ref, card)
    for k in totals:
        totals[k] += e_totals[k]
    print(json.dumps({"phase_3e_launches": e_totals}), flush=True)
    lap("3e multi-process")
    print("phase 3b: backbone serve runs at full width (bf16)", flush=True)
    bb_totals, serve_results = serve_runs(torch, [attention, gla, rmsnorm], [wire, reparam])
    for res in serve_results:
        print(json.dumps(res), flush=True)
    lap("3b serve runs")
    print("phase 3f: backbone train cells at full width (bf16; SFVI and SFVI-Avg)", flush=True)
    tr_totals, train_results = train_runs(torch, ref, reparam, wire, [attention, gla, rmsnorm])
    for res in train_results:
        print(json.dumps(res), flush=True)
    totals["fused_combine"] += tr_totals["fused_combine"]
    print(json.dumps({"phase_3f_launches": tr_totals}), flush=True)
    lap("3f train cells")
    print("phase 3g: Figure S1 on the card (SFVI on the fused wire against the HMC oracle)",
          flush=True)
    g_totals, fig = figure_s1(torch, wire, reparam, ref, full=False)
    print(json.dumps(fig), flush=True)
    lap("3g Figure S1")
    print("phase 3h: the deprecated eager adapters on the fused wire", flush=True)
    h_totals = eager_adapter_runs(torch, wire, reparam, ref)
    for k in totals:
        totals[k] += g_totals[k] + h_totals[k]
    print(json.dumps({"phase_3g_3h_launches": {"3g": g_totals, "3h": h_totals}}), flush=True)
    lap("3h eager adapters")
    print("phase 3i: the train step over the ranks of a world on one card (a 1-rank NCCL "
          f"world; 2 and 4 gloo ranks sharing the card: {MP_WORLD})", flush=True)
    i_totals, _ = train_multiprocess_runs(torch, card)
    for k in tr_totals:
        tr_totals[k] += i_totals[k]
    totals["fused_combine"] += i_totals["fused_combine"]
    print(json.dumps({"phase_3i_launches": i_totals}), flush=True)
    lap("3i multi-process training")

    # Phase 4: timings.
    print("phase 4: timings", flush=True)
    rows = timings(np, torch, wire, ref, reparam, attention, gla, rmsnorm, gen)
    lap("4 timings")
    print(json.dumps({"phase_s": phase_s}), flush=True)
    kernels = kernels_line(rows, {**totals, **bb_totals,
                                  **{k: tr_totals[k] for k in reparam.LAUNCHES}},
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
             "--timings": lambda: main(timings_only=True),
             "--figure-s1": lambda: main(figure_s1_only=True)}
    args = sys.argv[1:]
    if args[:1] == ["--check"] and len(args) == 2:
        sys.exit(check_main(args[1]))
    if args[:1] == ["--mp-worker"] and len(args) == 2:
        sys.exit(mp_worker(args[1]))
    if args[:1] == ["--train-worker"] and len(args) == 2:
        sys.exit(train_mp_worker(args[1]))
    if args and (len(args) > 1 or args[0] not in modes):
        sys.exit(fail(f"unknown arguments {args!r}; takes none, one of {sorted(modes)}, "
                      f"or --check with one of {sorted(MUTANT_GROUPS)}"))
    sys.exit(modes[args[0]]() if args else main())
