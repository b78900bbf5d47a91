"""The port's backbone kernels, plain versions, against the JAX package.

``repro_torch.kernels.{attention,gla,rmsnorm}`` on CPU tensors take their
plain versions (``repro_torch.kernels.ref``); each is held against the
JAX Pallas kernel in interpret mode (``repro.kernels.ops.flash_attention``,
``ops.gla``, ``ops.rmsnorm``) and against the JAX oracle
(``ref.flash_attention_ref`` with expanded KV heads, the exact recurrence
``ref.gla_chunk_ref``, ``ref.rmsnorm_ref``), on the same numpy-seeded
inputs. Tolerances are ``tests/test_kernels.py``'s: f32 atol = rtol =
3e-5, bf16 2e-2 (GLA's atol is relative to max|y|, as
``tests/test_gla_kernel.py`` holds it: its outputs grow with S). The
chunk length differs (the port's 64, the Pallas kernel's 128, the jnp
path's 256); the chunked form is exact up to rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels import ref as jref
from repro.models.backbone.ssm import chunked_gla
from repro_torch.kernels import attention as tattn
from repro_torch.kernels import gla as tgla
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trms

F32 = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, F32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, BF16)}


def _pair(a, name):
    """numpy f32 -> (jax array, torch tensor) of dtype ``name``, same values."""
    _, jd, td, _ = DTYPES[name]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32),
                      dtype=np.float32)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = {
    # name: (B, Sq, Skv, H, KV, hd, causal, window, q_offset, dtype)
    "gqa_causal": (1, 128, 128, 4, 2, 32, True, None, 0, "f32"),
    "padding_gqa4": (1, 96, 96, 4, 1, 32, True, None, 0, "f32"),
    "decode_q_offset": (2, 1, 160, 4, 2, 32, True, None, 159, "f32"),
    "window": (1, 200, 200, 4, 2, 16, True, 48, 0, "f32"),
    "non_causal": (2, 40, 72, 4, 4, 16, False, None, 0, "f32"),
    "gqa_causal_bf16": (1, 128, 128, 4, 2, 32, True, None, 0, "bf16"),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas_and_oracle(case):
    B, Sq, Skv, H, KV, hd, causal, window, off, dt = FLASH_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    got = tattn.flash_attention(tq, tk, tv, causal=causal, window=window, q_offset=off)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, Sq, H, hd)
    kernel = ops.flash_attention(jq, jk, jv, causal=causal, window=window, q_offset=off,
                                 interpret=True)
    oracle = jref.flash_attention_ref(jq, jnp.repeat(jk, H // KV, axis=2),
                                      jnp.repeat(jv, H // KV, axis=2), causal=causal,
                                      sliding_window=window, q_offset=off)
    tol = DTYPES[dt][3]
    np.testing.assert_allclose(_np(got), _np(kernel), **tol)
    np.testing.assert_allclose(_np(got), _np(oracle), **tol)
    assert tattn.LAUNCHES == {"flash_attention": 0, "flash_attention_tc": 0}


def test_flash_plain_rows_with_no_live_key_are_zero():
    """Window 2 with q_offset 8 over 8 keys: query i (position 8 + i) sees
    keys j > 6 + i, so rows 1..7 have no live key; the Pallas kernel ends
    such rows at 0 (attention.py:84)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 8, 2, 16)).astype(np.float32)
    k = rng.standard_normal((1, 8, 2, 16)).astype(np.float32)
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
                                causal=False, window=2, q_offset=8)
    kernel = ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                                 causal=False, window=2, q_offset=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **F32)
    assert np.all(got.numpy()[:, 1:] == 0.0) and np.any(got.numpy()[:, 0] != 0.0)


def test_flash_plain_q_chunking_is_exact():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 50, 4, 8)).astype(np.float32))
               for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    whole = tref.flash_attention_plain(q, k, v, q_chunk=1024)
    split = tref.flash_attention_plain(q, k, v, q_chunk=7)
    torch.testing.assert_close(split, whole, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# gated linear attention
# ---------------------------------------------------------------------------

GLA_CASES = {
    # name: (B, S, H, dk, dv, dtype, shared_qk)
    "one_chunk": (2, 64, 3, 16, 16, "f32", False),
    "ragged_S": (1, 150, 2, 16, 32, "f32", False),
    "dv65": (1, 70, 2, 16, 65, "f32", False),
    "mamba2_shared_qk": (2, 100, 3, 16, 32, "f32", True),
    "bf16": (1, 96, 2, 16, 16, "bf16", False),
}


def _gla_inputs(B, S, H, dk, dv, shared_qk, seed):
    rng = np.random.default_rng(seed)
    shape_qk = (B, S, 1, dk) if shared_qk else (B, S, H, dk)
    q = 0.5 * rng.standard_normal(shape_qk).astype(np.float32)
    k = 0.5 * rng.standard_normal(shape_qk).astype(np.float32)
    if shared_qk:  # one group broadcast over the heads, as mamba2's B/C
        q, k = np.broadcast_to(q, (B, S, H, dk)).copy(), np.broadcast_to(k, (B, S, H, dk)).copy()
    v = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    a = -np.abs(0.3 * rng.standard_normal((B, S, H))).astype(np.float32)
    return q, k, v, a


@pytest.mark.parametrize("case", sorted(GLA_CASES))
def test_gla_plain_matches_pallas_and_oracle(case):
    B, S, H, dk, dv, dt, shared = GLA_CASES[case]
    q, k, v, a = _gla_inputs(B, S, H, dk, dv, shared, seed=len(case))
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    ta = torch.from_numpy(a)
    if shared:  # the port takes mamba2's q/k as stride-0 head views
        tq, tk = tq[:, :, :1].expand(B, S, H, dk), tk[:, :, :1].expand(B, S, H, dk)
        assert tq.stride(2) == 0
    got = tgla.gla(tq, tk, tv, ta)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, S, H, dv)
    kernel = ops.gla(jq, jk, jv, jnp.asarray(a), interpret=True)
    tol = DTYPES[dt][3]
    scale = float(np.abs(_np(kernel)).max())
    np.testing.assert_allclose(_np(got), _np(kernel), rtol=tol["rtol"],
                               atol=tol["atol"] * scale)
    if dt == "f32":
        for b in range(B):
            exact, _ = jref.gla_chunk_ref(jq[b], jk[b], jv[b], jnp.asarray(a[b]))
            np.testing.assert_allclose(_np(got)[b], _np(exact), rtol=tol["rtol"],
                                       atol=tol["atol"] * scale)
        jnp_path = chunked_gla(jq, jk, jv, jnp.asarray(a))
        np.testing.assert_allclose(_np(got), _np(jnp_path), rtol=tol["rtol"],
                                   atol=tol["atol"] * scale)
    assert tgla.LAUNCHES == {"gla": 0, "gla_tc": 0}


def test_gla_plain_padded_steps_are_identity():
    """S = 65 pads 63 identity steps: the result equals the S = 65 prefix
    of a longer run (the extra steps read nothing back)."""
    q, k, v, a = (torch.from_numpy(x) for x in _gla_inputs(1, 128, 2, 8, 8, False, seed=9))
    long = tref.gla_plain(q, k, v, a)
    short = tref.gla_plain(q[:, :65], k[:, :65], v[:, :65], a[:, :65])
    torch.testing.assert_close(short, long[:, :65], atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

RMS_CASES = {
    # name: (shape, dtype, weight dtype)
    "rows_d128": ((33, 128), "f32", "f32"),
    "leading_dims": ((2, 3, 5, 64), "f32", "f32"),
    "wide_row": ((3, 1100), "f32", "f32"),
    "bf16_x_f32_w": ((17, 256), "bf16", "f32"),
    "bf16_both": ((2, 7, 128), "bf16", "bf16"),
}


@pytest.mark.parametrize("case", sorted(RMS_CASES))
def test_rmsnorm_plain_matches_pallas_and_oracle(case):
    shape, dt, wdt = RMS_CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1.0 + 0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    (jx, tx), (jw, tw) = _pair(x, dt), _pair(w, wdt)
    got = trms.rmsnorm(tx, tw, 1e-6)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    kernel = ops.rmsnorm(jx, jw, 1e-6, interpret=True)
    oracle = jref.rmsnorm_ref(jx, jw, 1e-6)
    tol = DTYPES[dt][3]
    np.testing.assert_allclose(_np(got), _np(kernel), **tol)
    np.testing.assert_allclose(_np(got), _np(oracle), **tol)
    assert trms.LAUNCHES == {"rmsnorm": 0}
