"""The launch plans of the port's redesigned kernels, and the numerics they
change, checked on the CPU.

* The tensor-core flash kernel's shared memory (``attention.tc_smem_bytes``,
  the plan of ``tc::smem_bytes`` in ``csrc/flash_attention.cu``) fits the
  H100's 232,448 bytes a block for every head dim: a launch refused for too
  much shared memory never runs.
* The tensor-core kernel rounds P to bf16 before P V (the Pallas kernel
  keeps P in f32): plain attention with that rounding, written here, stays
  within 2e-2 x (1 + max|v|) of the Pallas kernel in interpret mode, and
  within the element-by-element limit ``chip_smoke.py`` holds the kernel
  to, which a stale K/V tile (one tile's keys and values replaced by the
  previous tile's) fails.
* The upload's grid plan (``wire._upload_plan``) covers every column once,
  keeps chunk starts 16-byte aligned and fills the card's 132 SMs at the
  main path's (10, 100,354); the kernel's clip norm summed from per-chunk
  partials in its fixed order gives int8 codes within the card check's
  limit of JAX's ``fused_upload`` (codes off by at most 1 at no more than
  0.1 % of entries, scales within 1e-6 relative).
"""
import importlib.util
import math
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels import wire as jwire
from repro_torch.kernels import attention as tattn
from repro_torch.kernels import wire as twire

# ---------------------------------------------------------------------------
# flash attention: shared-memory plan, 16-byte copies, bf16 P
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_rows", tattn.TC_Q_ROWS)
def test_tc_smem_plan_fits_every_head_dim(q_rows):
    sizes = {hd: tattn.tc_smem_bytes(hd, q_rows) for hd in range(1, tattn.MAX_HEAD_DIM + 1)}
    assert max(sizes.values()) <= tattn.SMEM_LIMIT == 232_448
    # 2 bytes x (q rows + D + 1 K stages + D + 2 V stages of 64 keys) x hd
    # rounded up to 16, at prefetch distance D = 2 where that fits
    assert tattn.tc_prefetch(112, q_rows) == 2 and tattn.tc_prefetch(256, q_rows) == 1
    assert sizes[112] == 2 * (q_rows + 7 * 64) * 112
    assert sizes[256] == 2 * (q_rows + 5 * 64) * 256
    assert sizes[100] == sizes[112] and sizes[1] == sizes[16]


def test_tc_vector_loads_needs_aligned_rows_and_hd_multiple_of_8():
    dense = torch.zeros((2, 16, 4, 112), dtype=torch.bfloat16)
    assert tattn.tc_vector_loads(dense, dense, dense)
    packed = torch.zeros((2, 16, 3, 4, 112), dtype=torch.bfloat16)
    assert tattn.tc_vector_loads(*(packed[:, :, i] for i in range(3)))
    shifted = torch.zeros((2, 16, 4, 113), dtype=torch.bfloat16)[..., 1:]
    assert not tattn.tc_vector_loads(shifted, dense, dense)
    hd100 = torch.zeros((2, 16, 4, 100), dtype=torch.bfloat16)
    assert not tattn.tc_vector_loads(hd100, hd100, hd100)


def _attention_bf16_p(q, k, v, causal, window):
    """Plain attention (f32 scores, max, normalizer) with P rounded to bf16
    before P V, as the tensor-core kernel computes it."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qf = q.float().reshape(B, S, k.shape[2], G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / math.sqrt(hd)
    pos = torch.arange(S)
    mask = torch.ones((S, S), dtype=torch.bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bkgqd", p.bfloat16().float(), v.float()) / l
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


BF16_P_CASES = {
    # name: (B, S, H, KV, hd, causal, window)
    "causal_hd112": (1, 96, 4, 4, 112, True, None),
    "gqa_hd112": (1, 128, 4, 2, 112, True, None),
    "window_hd112": (1, 160, 4, 2, 112, True, 48),
    "noncausal_hd112": (2, 64, 2, 2, 112, False, None),
}


@pytest.mark.parametrize("case", sorted(BF16_P_CASES))
def test_bf16_p_attention_matches_pallas(case):
    B, S, H, KV, hd, causal, window = BF16_P_CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    want = ops.flash_attention(jq, jk, jv, causal=causal, window=window, interpret=True)
    got = _attention_bf16_p(tq, tk, tv, causal, window)
    want = np.asarray(want.astype(jnp.float32))
    tol = 2e-2 * (1.0 + float(np.abs(v).max()))
    assert float(np.abs(got.numpy() - want).max()) <= tol
    # The CPU route of the wrapper is the f32-P plain version; both agree.
    plain = tattn.flash_attention(tq, tk, tv, causal=causal, window=window).float().numpy()
    assert float(np.abs(got.numpy() - plain).max()) <= tol


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


LIMIT_CASES = {
    # name: (B, S, H, KV, hd, causal, window)
    "causal_gqa_hd112": (1, 512, 4, 2, 112, True, None),
    "window_hd128": (1, 640, 4, 2, 128, True, 128),
    "noncausal_hd128": (2, 256, 4, 4, 128, False, None),
}


@pytest.mark.parametrize("case", sorted(LIMIT_CASES))
def test_bf16_p_attention_within_card_limit_and_stale_tile_outside(case):
    B, S, H, KV, hd, causal, window = LIMIT_CASES[case]
    ratio = _chip_smoke().flash_bf16_ratio
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
               for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    want = tattn.flash_attention(q, k, v, causal=causal, window=window)  # plain on the CPU
    got = _attention_bf16_p(q, k, v, causal, window).bfloat16()
    assert ratio(torch, got, want) <= 1.0
    n = tattn.TC_KEY_ROWS
    for start in (n, S - 2 * n):
        ks, vs = k.clone(), v.clone()
        ks[:, start:start + n], vs[:, start:start + n] = k[:, start - n:start], v[:, start - n:start]
        stale = _attention_bf16_p(q, ks, vs, causal, window).bfloat16()
        assert ratio(torch, stale, want) > 1.0, start


# ---------------------------------------------------------------------------
# upload: grid plan and the chunked clip norm
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(10, 100_354), (1, 100_354), (64, 20_002), (16, 65_536), (7, 4099), (3, 5),
               (10, 1003), (1, 1)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_upload_plan_covers_every_column_once(shape):
    J, P = shape
    C, chunk = twire._upload_plan(J, P)
    assert chunk % 4 == 0 and (chunk * 4) % 16 == 0  # starts keep 16-byte alignment
    starts = [c * chunk for c in range(C)]
    covered = np.zeros(P, np.int64)
    for c0 in starts:
        covered[c0:min(P, c0 + chunk)] += 1
    assert np.all(covered == 1) and starts[-1] < P  # no empty chunk
    if (J, P) == (10, 100_354):
        assert J * C >= twire.H100_SMS


def test_upload_vec_width_follows_P_and_alignment():
    x = torch.zeros((2, 8))
    assert twire._upload_vec(8, [x]) == 4
    assert twire._upload_vec(100_354, [torch.zeros((2, 100_354))]) == 2
    assert twire._upload_vec(7, [torch.zeros((2, 7))]) == 1
    off = torch.zeros(17)[1:].view(2, 8)  # 4 bytes past a 16-byte boundary
    assert twire._upload_vec(8, [x, off]) == 1


def _xor_tree(v):
    """The warp shuffle sum (xor 16, 8, 4, 2, 1) of 32 f32 lanes; lane 0's value."""
    v = v.astype(np.float32).copy()
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
    return v[0]


def _kernel_clip_norms(d, mask):
    """Each row's ||d||_2 as the kernels sum it: per chunk, thread t of 256
    takes groups of V columns t V, t V + 256 V, ... in turn; a warp sums its
    lanes by an xor tree, warp 0 its 8 warps' sums; then the row's chunk
    partials: lane l of warp 0 takes partials l, l + 32, ..., then an xor tree."""
    J, P = d.shape
    C, chunk = twire._upload_plan(J, P)
    V = 4 if P % 4 == 0 else 2 if P % 2 == 0 else 1
    T = twire.UPLOAD_THREADS
    norms = np.zeros(J, np.float32)
    for j in range(J):
        if mask[j] <= 0.5:
            continue
        parts = np.zeros(C, np.float32)
        for c in range(C):
            seg = d[j, c * chunk:min(P, (c + 1) * chunk)]
            acc = np.zeros(T, np.float32)
            for g0 in range(0, len(seg), V * T):
                block = np.zeros(V * T, np.float32)
                piece = seg[g0:g0 + V * T]
                block[:len(piece)] = piece
                for e in range(V):  # the V floats of a load, in order
                    acc = (acc + block[e::V] * block[e::V]).astype(np.float32)
            warps = np.array([_xor_tree(acc[w * 32:(w + 1) * 32]) for w in range(T // 32)])
            lanes = np.zeros(32, np.float32)
            lanes[:len(warps)] = warps
            parts[c] = _xor_tree(lanes)
        lanes = np.zeros(32, np.float32)
        for i in range(C):
            lanes[i % 32] = np.float32(lanes[i % 32] + parts[i])
        norms[j] = np.sqrt(_xor_tree(lanes), dtype=np.float32)
    return norms


def _kernel_upload_int8(x, mask, noise, ref, clip_norm, z):
    """The kernels' arithmetic (kernels/wire.cu) in f32 numpy: the chunked
    norm, then y and the int8 codes with one scale a row."""
    d = (x - ref[None, :]).astype(np.float32)
    norms = _kernel_clip_norms(d, mask)
    factor = np.minimum(np.float32(1), np.float32(clip_norm) / np.maximum(norms, np.float32(1e-12)))
    y = (d * factor[:, None]).astype(np.float32)
    y = (y + np.float32(z * clip_norm) * noise).astype(np.float32)
    y = (ref[None, :] + y).astype(np.float32)
    y = np.where(mask[:, None] > 0.5, y, ref[None, :]).astype(np.float32)
    scale = (np.abs(y).max(axis=1) / np.float32(127) + np.float32(1e-12)).astype(np.float32)
    q = np.clip(np.rint(y / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


@pytest.mark.parametrize("shape", [(4, 20_002), (3, 4099), (2, 8192)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_chunked_clip_norm_int8_codes_match_jax(shape):
    J, P = shape
    rng = np.random.default_rng(zlib.crc32(repr(shape).encode()))
    x = rng.standard_normal((J, P)).astype(np.float32)
    ref = (0.1 * rng.standard_normal(P)).astype(np.float32)
    mask = np.ones(J, np.float32)
    mask[-1] = 0.0
    keys = jax.vmap(lambda j: jax.random.fold_in(jax.random.PRNGKey(3), j))(jnp.arange(J))
    noise = np.array(jax.vmap(lambda k: jax.random.normal(k, (P,), jnp.float32))(keys))
    clip_norm, z = 0.3, 0.3
    assert twire._upload_plan(J, P)[0] > 1  # several chunks a row
    want_q, want_s = jwire.fused_upload(
        jnp.asarray(x), mask=jnp.asarray(mask), keys=keys, reference=jnp.asarray(ref),
        clip_norm=clip_norm, noise_multiplier=z, quantize=True, interpret=True)
    q, s = _kernel_upload_int8(x, mask, noise, ref, clip_norm, z)
    np.testing.assert_allclose(s, np.asarray(want_s), rtol=1e-6)
    diff = np.abs(q.astype(np.int32) - np.asarray(want_q).astype(np.int32))
    assert diff.max() <= 1 and np.count_nonzero(diff) <= max(1, diff.size // 1000)
