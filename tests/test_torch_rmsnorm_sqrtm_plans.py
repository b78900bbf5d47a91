"""The RMSNorm kernel's launch plan and summation order, and the
Newton–Schulz square root's dispatch, checked on the CPU.

* ``rmsnorm._rmsnorm_plan`` covers every element of every row exactly once
  at the shapes ``chip_smoke.py`` checks and times, and at D = 1, 7 and 130;
  it takes 16-byte vectors only when D and both base addresses allow it (a
  view one element off 16 bytes takes the scalar route), keeps a lane's
  vectors within the cap, and launches at least one block an SM at the
  serve shapes even with one resident block an SM; the card's cached plan
  (``_card_plan``) is the same plan, computed once a shape.
* The kernel's order of the sum of squares (each lane's vectors in turn by
  fused multiply-adds, an xor shuffle tree over the row's lanes, then the
  warps' partial sums in order), emulated here in numpy, stays within the
  card check's tolerance (bf16 2e-2, f32 3e-5, x (1 + max|want|)) of JAX's
  ``rmsnorm_rows`` in interpret mode.
* The root kernel's shared memory fits the H100's 232,448 bytes a block at
  ``NS_ROOT_MAX_D``; ``sqrtm_newton_schulz_fused`` on a card tensor makes
  one root launch up to that d and ``num_iters`` step calls above it
  (driven here with the launches replaced by the plain versions).
* The port's ``sqrtm_newton_schulz_fused`` on the CPU stays within rtol
  1e-5, atol 1e-6 of JAX's ``sqrtm_newton_schulz_fused(interpret=True)``,
  vmapped, at (1, 5) and (6, 5) with 40 steps.
"""
import ctypes
import importlib.util
import types
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import wire as jwire
from repro.kernels.rmsnorm import rmsnorm_rows
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trms
from repro_torch.kernels import wire as twire


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_CS = _chip_smoke()
PLAN_SHAPES = sorted({(rows, D) for _, rows, D in _CS.RMS_CHECKS + _CS.RMS_TIMES}
                     | {(5, 1), (9, 7), (33, 130)})
SERVE_SHAPES = [(rows, D) for _, rows, D in _CS.RMS_TIMES if rows >= 4096]
TORCH = {"bf16": torch.bfloat16, "f32": torch.float32}

# ---------------------------------------------------------------------------
# RMSNorm: launch plan
# ---------------------------------------------------------------------------


def _covered(plan, rows, D):
    """How often the plan's launch touches each row and each column: rows
    (b + s * grid) * rows_per_block + g; columns (lane + i * lanes) * vec + e."""
    row_hits = np.zeros(rows, np.int64)
    step = plan.grid * plan.rows_per_block
    for b in range(plan.grid):
        for r0 in range(b * plan.rows_per_block, rows, step):
            row_hits[r0:min(rows, r0 + plan.rows_per_block)] += 1
    nvec = D // plan.vec
    col_hits = np.zeros(D, np.int64)
    for lane in range(plan.lanes):
        for i in range(plan.vpl):
            c = lane + i * plan.lanes
            if c < nvec:
                col_hits[c * plan.vec:(c + 1) * plan.vec] += 1
    return row_hits, col_hits


@pytest.mark.parametrize("dt", sorted(TORCH))
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_rmsnorm_plan_covers_every_element_once(shape, dt):
    rows, D = shape
    x, w = torch.zeros((rows, D), dtype=TORCH[dt]), torch.zeros(D, dtype=TORCH[dt])
    plan = trms._rmsnorm_plan(rows, D, x, w)
    row_hits, col_hits = _covered(plan, rows, D)
    assert np.all(row_hits == 1) and np.all(col_hits == 1)
    assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes * plan.rows_per_block == trms.THREADS
    assert plan.vpl <= trms.MAX_VECS[plan.vec > 1]
    assert plan.vec == (16 // x.element_size() if D % (16 // x.element_size()) == 0 else 1)


def test_rmsnorm_plan_vector_route_needs_d_and_alignment():
    D = 3584
    x, w = torch.zeros((4, D), dtype=torch.bfloat16), torch.zeros(D, dtype=torch.bfloat16)
    assert trms._rmsnorm_plan(4, D, x, w).vec == 8
    off = torch.zeros(4 * D + 1, dtype=torch.bfloat16)[1:].view(4, D)  # 2 bytes off
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    assert trms._rmsnorm_plan(4, D, off, w).vec == 1
    w_off = torch.zeros(D + 1, dtype=torch.bfloat16)[1:]
    assert trms._rmsnorm_plan(4, D, x, w_off).vec == 1
    x_f32, w_f32 = torch.zeros((4, 130)), torch.zeros(130)  # 130 % 4 != 0
    assert trms._rmsnorm_plan(4, 130, x_f32, w_f32).vec == 1
    assert trms._rmsnorm_plan(4, 128, torch.zeros((4, 128)), torch.zeros(128)).vec == 4
    # a mixed weight type keeps the vector route when its address is aligned
    assert trms._rmsnorm_plan(4, D, x, torch.zeros(D)).vec == 8


def _bf16_rows(rows, D, off):
    """(rows, D) bf16, ``off`` elements past a 16-byte boundary."""
    return torch.zeros(rows * D + off, dtype=torch.bfloat16)[off:].view(rows, D)


@pytest.mark.parametrize("vector", [True, False])
def test_rmsnorm_plan_caps_vectors_a_lane(vector):
    vec, off = (8, 0) if vector else (1, 1)
    widest = trms.THREADS * trms.MAX_VECS[vector] * vec
    for D in (vec, 64 * vec, 1000 * vec, widest):
        plan = trms._rmsnorm_plan(2, D, _bf16_rows(2, D, off), torch.zeros(D, dtype=torch.bfloat16))
        assert plan.vec == vec and plan.vpl <= trms.MAX_VECS[vector]
    D = widest + vec
    with pytest.raises(ValueError, match="rows of at most"):
        trms._rmsnorm_plan(2, D, _bf16_rows(2, D, off), torch.zeros(D, dtype=torch.bfloat16))


@pytest.mark.parametrize("shape", SERVE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_rmsnorm_plan_fills_the_card_at_serve_shapes(shape):
    rows, D = shape
    x, w = torch.zeros((rows, D), dtype=torch.bfloat16), torch.zeros(D, dtype=torch.bfloat16)
    one = trms._rmsnorm_plan(rows, D, x, w, blocks_per_sm=lambda vector, vpl: 1)
    assert one.grid >= twire.H100_SMS
    four = trms._rmsnorm_plan(rows, D, x, w, blocks_per_sm=lambda vector, vpl: 4)
    assert four.grid == min(-(-rows // four.rows_per_block), 4 * twire.H100_SMS)


@pytest.mark.parametrize("shape", SERVE_SHAPES[:2] + [(8, 3584)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_rmsnorm_card_plan_is_the_plan_and_cached(shape, monkeypatch):
    rows, D = shape
    asked = []

    def occupancy(x_bf16, w_bf16, vector, vpl, d):
        asked.append((vector, vpl))
        return 3

    monkeypatch.setattr(trms, "_blocks_per_sm", occupancy)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(multi_processor_count=132))
    trms._card_plan.cache_clear()
    try:
        got = trms._card_plan(rows, D, 1, 1, True, 0)
        assert trms._card_plan(rows, D, 1, 1, True, 0) is got and len(asked) == 1
        x, w = torch.zeros((rows, D), dtype=torch.bfloat16), torch.zeros(D, dtype=torch.bfloat16)
        assert got == trms._rmsnorm_plan(rows, D, x, w, 132, lambda vector, vpl: 3)
        # unaligned is its own entry: the scalar route
        assert trms._card_plan(rows, D, 1, 1, False, 0).vec == 1 and len(asked) == 2
    finally:
        trms._card_plan.cache_clear()


# ---------------------------------------------------------------------------
# RMSNorm: the kernel's order of the sum of squares against JAX
# ---------------------------------------------------------------------------


def _fma32(a, b, c):
    """fmaf in f32: the product of two f32 values is exact in f64."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _kernel_rmsnorm(x, w, plan, eps):
    """The kernel's arithmetic in numpy f32 (x, w already rounded to their
    types, as f32): returns the f32 output before the cast to x's type."""
    rows, D = x.shape
    L, V, vec = plan.lanes, plan.vpl, plan.vec
    nvec = D // vec
    lanes = np.arange(L)
    ss = np.zeros((rows, L), np.float32)
    for i in range(V):
        c = lanes + i * L
        for e in range(vec):
            col = np.minimum(c * vec + e, D - 1)
            v = np.where(c[None, :] < nvec, x[:, col], np.float32(0))
            ss = _fma32(v, v, ss)
    width = min(L, 32)
    o = width // 2
    while o:
        ss = (ss + ss[:, lanes ^ o]).astype(np.float32)
        o //= 2
    total = np.zeros(rows, np.float32)
    for k in range(max(1, L // 32)):
        total = (total + ss[:, 32 * k]).astype(np.float32)
    rms = (np.float32(1) / np.sqrt(total / np.float32(D) + np.float32(eps))).astype(np.float32)
    return ((x * rms[:, None]).astype(np.float32) * w[None, :]).astype(np.float32)


ORDER_CASES = {
    # name: (rows, D, x dtype, weight dtype)
    "qk_norm_d128_bf16": (33, 128, "bf16", "bf16"),
    "qwen3_d2560_bf16": (9, 2560, "bf16", "bf16"),
    "zamba2_d3584_bf16": (9, 3584, "bf16", "bf16"),
    "mamba2_d7168_bf16": (5, 7168, "bf16", "bf16"),
    "zamba2_d3584_f32": (9, 3584, "f32", "f32"),
    "d3584_bf16_f32w": (9, 3584, "bf16", "f32"),
    "scalar_d130_f32": (17, 130, "f32", "f32"),
    "scalar_d7_bf16": (17, 7, "bf16", "bf16"),
}
TOL = {"bf16": 2e-2, "f32": 3e-5}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_rmsnorm_kernel_order_matches_jax(case):
    rows, D, dt, wdt = ORDER_CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    x = rng.standard_normal((rows, D)).astype(np.float32)
    w = (1.0 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    tx, tw = torch.from_numpy(x).to(TORCH[dt]), torch.from_numpy(w).to(TORCH[wdt])
    plan = trms._rmsnorm_plan(rows, D, tx, tw)
    got = torch.from_numpy(_kernel_rmsnorm(tx.float().numpy(), tw.float().numpy(), plan, 1e-6))
    got = got.to(TORCH[dt]).float().numpy()
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dt == "bf16" else jnp.float32)
    jw = jnp.asarray(w).astype(jnp.bfloat16 if wdt == "bf16" else jnp.float32)
    want = np.asarray(rmsnorm_rows(jx, jw, 1e-6, interpret=True).astype(jnp.float32))
    tol = TOL[dt] * (1.0 + float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol
    # the wrapper's CPU route, the plain version, agrees as well
    plain = trms.rmsnorm(tx, tw, 1e-6).float().numpy()
    assert float(np.abs(plain - want).max()) <= tol


# ---------------------------------------------------------------------------
# Newton–Schulz square root: shared memory, dispatch, parity with JAX
# ---------------------------------------------------------------------------


def test_ns_root_smem_plan_fits_at_the_limit():
    limit = twire.NS_ROOT_MAX_D
    assert twire.ns_root_smem_bytes(limit) <= twire.SMEM_LIMIT == 232_448
    assert twire.ns_root_smem_bytes(5) == 4 * (5 * 25 + 32)
    # within the 48 KB a block gets without opting in: the source asks for no more
    assert twire.ns_root_smem_bytes(limit) <= 48 * 1024


def _card_route(monkeypatch):
    """Drive the wrapper's card route on CPU tensors: the root launch and
    the step calls are replaced by the plain versions, and counted."""
    calls = {"root": 0, "step": 0}

    def root(mat, out, batch, d, num_iters, stream):
        calls["root"] += 1
        n = batch * d * d
        m = np.ctypeslib.as_array((ctypes.c_float * n).from_address(mat)).reshape(batch, d, d)
        o = np.ctypeslib.as_array((ctypes.c_float * n).from_address(out))
        root = tref.newton_schulz_sqrtm_ref(torch.from_numpy(m.copy()), num_iters)
        o[:] = root.reshape(-1).numpy()
        return 0

    def step(y, z):
        calls["step"] += 1
        return tref.newton_schulz_step_ref(y, z)

    monkeypatch.setattr(twire, "LAUNCHES", dict.fromkeys(twire.LAUNCHES, 0))
    monkeypatch.setattr(twire, "_on_cuda", lambda t: True)
    monkeypatch.setattr(twire, "_ns_lib", lambda: types.SimpleNamespace(
        repro_sqrtm_newton_schulz=root))
    monkeypatch.setattr(twire, "newton_schulz_step", step)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("d", [5, "limit", "limit+1"])
def test_sqrtm_dispatch_by_d(d, monkeypatch):
    limit = twire.NS_ROOT_MAX_D
    d = {"limit": limit, "limit+1": limit + 1}.get(d, d)
    rng = np.random.default_rng(d)
    a = rng.standard_normal((2, d, d)).astype(np.float32) / np.sqrt(d)
    mat = torch.from_numpy((a @ np.swapaxes(a, -1, -2) + 0.2 * np.eye(d)).astype(np.float32))
    calls = _card_route(monkeypatch)
    got = twire.sqrtm_newton_schulz_fused(mat, num_iters=3)
    root = d <= limit
    assert calls == {"root": int(root), "step": 0 if root else 3}
    assert twire.LAUNCHES["sqrtm_newton_schulz"] == int(root)
    np.testing.assert_allclose(got.numpy(), tref.newton_schulz_sqrtm_ref(mat, 3).numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B", [1, 6])
def test_port_sqrtm_fused_matches_jax_fused(B):
    rng = np.random.default_rng(40 + B)
    a = rng.standard_normal((B, 5, 5)).astype(np.float32) / np.sqrt(5)
    mats = (a @ np.swapaxes(a, -1, -2) + 0.2 * np.eye(5, dtype=np.float32)).astype(np.float32)
    want = jax.vmap(lambda m: jwire.sqrtm_newton_schulz_fused(m, num_iters=40, interpret=True))(
        jnp.asarray(mats))
    got = twire.sqrtm_newton_schulz_fused(torch.from_numpy(mats), num_iters=40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
