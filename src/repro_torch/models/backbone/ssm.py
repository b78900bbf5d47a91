"""Mamba2 (SSD) blocks over the gated-linear-attention recurrence.

Counterpart of ``repro/models/backbone/ssm.py``:

    S_t = exp(a_t) S_{t-1} + k_t v_t^T          (state: (H, dk, dv))
    y_t = q_t . S_t

The JAX package runs the full-sequence recurrence with its jnp
``chunked_gla`` or, under ``cfg.use_pallas``, the Pallas GLA kernel — its
TPU hot path (``_gla_dispatch``, ``ssm.py:207-213``). The port has one
path: :func:`mamba2_block` and :func:`mamba2_prefill` call the GLA wrapper
(:mod:`repro_torch.kernels.gla`: the CUDA kernels on the card, its plain
chunked version on the CPU). :func:`mamba2_prefill` takes its decode
state from that same call (``return_state=True``: the kernel writes the
state it holds after the last chunk), where the JAX package runs a second
jnp pass over k and v (``gla_final_state``); the two differ in rounding
only. :func:`gla_final_state`, the counterpart of that pass, and
:func:`gla_decode_step` are plain torch, as they are jnp in the JAX package.

mamba2's q and k are one (B, S, N) group broadcast over the heads; they
reach the kernel as ``expand``-ed views (head stride 0), never copied.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.gla import gla
from repro_torch.models.backbone.config import check_port_supported
from repro_torch.models.backbone.layers import (
    dense_init,
    dtype_of,
    normal,
    rmsnorm,
    rmsnorm_init,
)


def gla_final_state(k, v, log_a, chunk: int = 256) -> torch.Tensor:
    """The recurrent state after the last position (prefill -> decode).

    k: (B, S, H, dk), v: (B, S, H, dv), log_a: (B, S, H); returns
    (B, H, dk, dv) f32. Padded steps are identity (decay 1, kv 0).
    """
    B, S, H, dk = k.shape
    dv = v.shape[-1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    kf, vf, af = k.float(), v.float(), log_a.float()
    if pad:
        kf, vf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (kf, vf))
        af = F.pad(af, (0, 0, 0, pad))
    n = (S + pad) // chunk
    kc = kf.reshape(B, n, chunk, H, dk)
    vc = vf.reshape(B, n, chunk, H, dv)
    cum = torch.cumsum(af.reshape(B, n, chunk, H), dim=2)
    total = cum[:, :, -1]
    k_dec = kc * torch.exp(total[:, :, None] - cum)[..., None]
    chunk_kv = torch.einsum("bnshd,bnshv->bnhdv", k_dec, vc)
    state = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=k.device)
    for i in range(n):
        state = state * torch.exp(total[:, i])[..., None, None] + chunk_kv[:, i]
    return state


def gla_decode_step(state, q, k, v, log_a):
    """One recurrent step. state: (B,H,dk,dv) f32; q/k/v: (B,H,d*); log_a: (B,H)."""
    state = state * torch.exp(log_a.float())[..., None, None] + torch.einsum(
        "bhd,bhv->bhdv", k.float(), v.float())
    y = torch.einsum("bhd,bhdv->bhv", q.float(), state)
    return state, y


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state
    H = d_inner // cfg.ssm_head_dim
    return d_inner, N, H


def mamba2_init(gen: torch.Generator, cfg):
    """in_proj emits [z (gate), x, B, C, dt]; single B/C group (G=1),
    per-head scalar A, depthwise conv of width ssm_conv over x/B/C, dt bias,
    and a gated RMSNorm before out_proj (the JAX package's layout)."""
    d = cfg.d_model
    d_inner, N, H = _dims(cfg)
    conv_dim = d_inner + 2 * N
    dtype, dev = dtype_of(cfg), gen.device
    return {
        "in_proj": dense_init(gen, d, 2 * d_inner + 2 * N + H, dtype),
        "conv_w": normal(gen, (cfg.ssm_conv, conv_dim), 0.1, dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),  # A = -exp(A_log)
        "dt_bias": torch.log(torch.expm1(torch.full((H,), 1e-2, device=dev))),
        "D": torch.ones((H,), device=dev),  # skip connection
        "out_norm": rmsnorm_init(d_inner, dtype, dev),
        "out_proj": dense_init(gen, d_inner, d, dtype),
    }


def _mamba2_split(params, cfg, u):
    """Shared projection. u: (B, S, D). Returns z, xBC, dt and the dims."""
    d_inner, N, H = _dims(cfg)
    proj = u @ params["in_proj"]  # (B, S, 2 d_inner + 2N + H)
    z, xBC, dt = torch.split(proj, [d_inner, d_inner + 2 * N, H], dim=-1)
    return z, xBC, dt, d_inner, N, H


def _causal_conv(xBC, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv of width K. xBC: (B, S, C); conv_state: (B, K-1, C)."""
    K = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xBC.shape[0], K - 1, xBC.shape[-1]), dtype=xBC.dtype,
                          device=xBC.device)
    else:
        pad = conv_state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)  # (B, S+K-1, C)
    S = xBC.shape[1]
    out = sum(xp[:, i:i + S] * conv_w[i] for i in range(K))
    new_state = xp[:, xp.shape[1] - (K - 1):].clone()
    return F.silu(out + conv_b), new_state


def _mamba2_qkva(params, cfg, x_conv, dt_raw, d_inner, N, H):
    """Map conv output + dt to the GLA (q, k, v, log_a) views."""
    P = cfg.ssm_head_dim
    x, Bm, Cm = torch.split(x_conv, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # (..., H)
    A = -torch.exp(params["A_log"])  # (H,) negative
    log_a = dt * A
    shape = x.shape[:-1]
    xh = x.reshape(*shape, H, P)
    v = xh * dt[..., None].to(x.dtype)  # dt folds into v (SSD form)
    # One B/C group broadcast across heads: views with head stride 0.
    k = Bm[..., None, :].expand(*shape, H, N)
    q = Cm[..., None, :].expand(*shape, H, N)
    return q, k, v, log_a, xh


def _mamba2_out(params, cfg, y, xh, z, lead, d_inner):
    y = y + xh * params["D"][:, None].to(xh.dtype)
    y = y.reshape(*lead, d_inner)
    y = rmsnorm(y * F.silu(z), params["out_norm"], cfg.norm_eps)
    return y @ params["out_proj"]


def mamba2_block(params, cfg, u):
    """Full-sequence Mamba2. u: (B, S, D) -> (B, S, D)."""
    check_port_supported(cfg)
    z, xBC, dt_raw, d_inner, N, H = _mamba2_split(params, cfg, u)
    x_conv, _ = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    q, k, v, log_a, xh = _mamba2_qkva(params, cfg, x_conv, dt_raw, d_inner, N, H)
    y = gla(q, k, v, log_a)
    return _mamba2_out(params, cfg, y, xh, z, u.shape[:2], d_inner)


def mamba2_init_cache(params, cfg, batch: int, dtype: torch.dtype):
    d_inner, N, H = _dims(cfg)
    dev = params["in_proj"].device
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * N), dtype=dtype, device=dev),
        "ssm": torch.zeros((batch, H, N, cfg.ssm_head_dim), dtype=torch.float32, device=dev),
    }


def mamba2_prefill(params, cfg, u):
    """Like :func:`mamba2_block` but also returns the decode cache."""
    check_port_supported(cfg)
    z, xBC, dt_raw, d_inner, N, H = _mamba2_split(params, cfg, u)
    x_conv, conv_state = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    q, k, v, log_a, xh = _mamba2_qkva(params, cfg, x_conv, dt_raw, d_inner, N, H)
    y, ssm_state = gla(q, k, v, log_a, return_state=True)
    out = _mamba2_out(params, cfg, y, xh, z, u.shape[:2], d_inner)
    return out, {"conv": conv_state, "ssm": ssm_state}


def mamba2_decode(params, cfg, u, cache):
    """One-token step. u: (B, 1, D); O(1) state."""
    check_port_supported(cfg)
    z, xBC, dt_raw, d_inner, N, H = _mamba2_split(params, cfg, u)
    x_conv, conv_state = _causal_conv(xBC, params["conv_w"], params["conv_b"],
                                      conv_state=cache["conv"])
    q, k, v, log_a, xh = _mamba2_qkva(params, cfg, x_conv, dt_raw, d_inner, N, H)
    state, y = gla_decode_step(cache["ssm"], q[:, 0], k[:, 0], v[:, 0], log_a[:, 0])
    out = _mamba2_out(params, cfg, y[:, None].to(u.dtype), xh, z, (u.shape[0], 1), d_inner)
    return out, {"conv": conv_state, "ssm": state}
