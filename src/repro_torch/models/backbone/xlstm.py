"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, true recurrence).

Counterpart of ``repro/models/backbone/xlstm.py``. mLSTM is a gated linear
attention: with forget gate f_t and input gate i_t,

    C_t = sigmoid_f(f_t) C_{t-1} + exp(i_t - m) k_t v_t^T
    y_t = q_t C_t / max(|q_t n_t|, exp(-m))

The input gate folds into k and the normalizer n_t comes from a ones
column appended to v (one extra dv column, no second scan); m is the
per-(batch, head) maximum of the log input gates over the prompt, and
decode keeps the prefill's m. The port chooses the GLA by mode:
:func:`mlstm_block` (training) runs :func:`~repro_torch.models.backbone.ssm.chunked_gla`
(differentiable); :func:`mlstm_prefill` calls the GLA kernel wrapper
(:mod:`repro_torch.kernels.gla`: dk = d_inner / H, dv = dk + 1, so
xlstm-1.3b's (1,024, 1,025) state is split across blocks along dk and dv)
with ``return_state=True``, where the reference runs ``chunked_gla`` and
a second pass ``gla_final_state``; the two differ in rounding only.
:func:`mlstm_decode` is one ``gla_decode_step``.

sLSTM has hidden-to-hidden recurrence (block-diagonal per head), so it
has no parallel form: a Python loop over time here, a ``lax.scan`` in
the reference; the JAX package has no kernel for it. Its feed-forward
takes GELU's tanh approximation (``jax.nn.gelu``'s default).

Dtypes as the reference: the gates are a model-dtype matmul cast to f32;
``r``, ``b``, ``f_bias`` and ``i_bias`` are f32 leaves; ``k / sqrt(P)``,
``k exp(log_i - m)`` and the ones column are in the model dtype. Norms
take the RMSNorm kernel wrapper in the serve modes and ``rmsnorm_train``
in training.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.gla import gla
from repro_torch.models.backbone.config import check_port_supported
from repro_torch.models.backbone.layers import (
    dense_init,
    dtype_of,
    rmsnorm,
    rmsnorm_init,
    rmsnorm_train,
)
from repro_torch.models.backbone.ssm import chunked_gla, gla_decode_step


# ---------------------------------------------------------------------------
# mLSTM block (projection factor 2, conv-free variant)
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg):
    d = cfg.d_model
    d_inner = 2 * d
    H = cfg.num_heads
    dtype, dev = dtype_of(cfg), gen.device
    return {
        "w_up": dense_init(gen, d, 2 * d_inner, dtype),  # [x_inner, z_gate]
        "wq": dense_init(gen, d_inner, d_inner, dtype),
        "wk": dense_init(gen, d_inner, d_inner, dtype),
        "wv": dense_init(gen, d_inner, d_inner, dtype),
        "w_gates": dense_init(gen, d_inner, 2 * H, dtype, scale=0.01),
        "f_bias": torch.linspace(3.0, 6.0, H, device=dev),  # open forget gates
        "i_bias": torch.zeros((H,), device=dev),
        "out_norm": rmsnorm_init(d_inner, dtype, dev),
        "w_down": dense_init(gen, d_inner, d, dtype),
    }


def _mlstm_qkva(params, cfg, u):
    """u: (B, S, D) -> q, k, v, log_f, log_i, the gate branch z, and the dims."""
    B, S, _ = u.shape
    d_inner = 2 * cfg.d_model
    H = cfg.num_heads
    P = d_inner // H
    x, z = torch.chunk(u @ params["w_up"], 2, dim=-1)
    q = (x @ params["wq"]).reshape(B, S, H, P)
    k = (x @ params["wk"]).reshape(B, S, H, P) / math.sqrt(P)
    v = (x @ params["wv"]).reshape(B, S, H, P)
    gates = (x @ params["w_gates"]).float().reshape(B, S, H, 2)
    log_f = F.logsigmoid(gates[..., 0] + params["f_bias"])  # (B, S, H)
    log_i = gates[..., 1] + params["i_bias"]
    return q, k, v, log_f, log_i, z, d_inner, H, P


def _mlstm_gla_inputs(k, v, log_i, m):
    """k with the input gate folded in (stabilized by m), v with the ones
    column whose output is the normalizer q·n; both in the model dtype."""
    k_g = k * torch.exp(log_i - m)[..., None].to(k.dtype)
    ones = torch.ones((*v.shape[:-1], 1), dtype=v.dtype, device=v.device)
    return k_g, torch.cat([v, ones], dim=-1)


def _mlstm_combine(params, cfg, y, nrm, z, B, S, d_inner, m, norm=rmsnorm):
    """Normalize, gate, down-project. The denominator max(|q·n|, exp(-m))
    equals the unstabilized max(|q·n|, 1) with exp(i - m) folded into k, so
    the result does not depend on m."""
    y = y / torch.maximum(nrm.abs(), torch.exp(-m)[..., None])
    y = y.reshape(B, S, d_inner).to(z.dtype)
    y = norm(y, params["out_norm"], cfg.norm_eps) * F.silu(z)
    return y @ params["w_down"]


def mlstm_block(params, cfg, u):
    """Full-sequence mLSTM, differentiable (the train mode)."""
    check_port_supported(cfg)
    B, S, _ = u.shape
    q, k, v, log_f, log_i, z, d_inner, H, P = _mlstm_qkva(params, cfg, u)
    m = torch.amax(log_i, dim=1, keepdim=True)  # (B, 1, H)
    k_g, v_aug = _mlstm_gla_inputs(k, v, log_i, m)
    y_aug = chunked_gla(q, k_g, v_aug, log_f)
    y, nrm = y_aug[..., :P], y_aug[..., P:]
    return _mlstm_combine(params, cfg, y, nrm, z, B, S, d_inner, m, norm=rmsnorm_train)


def mlstm_init_cache(params, cfg, batch: int, dtype: torch.dtype):
    d_inner = 2 * cfg.d_model
    H = cfg.num_heads
    P = d_inner // H
    dev = params["w_up"].device
    return {
        "state": torch.zeros((batch, H, P, P + 1), dtype=torch.float32, device=dev),
        "m": torch.zeros((batch, 1, H), dtype=torch.float32, device=dev),
    }


def mlstm_prefill(params, cfg, u):
    """Full-sequence mLSTM through the GLA kernel, also returning the decode
    cache: the state after the last step and the stabilizer m."""
    check_port_supported(cfg)
    B, S, _ = u.shape
    q, k, v, log_f, log_i, z, d_inner, H, P = _mlstm_qkva(params, cfg, u)
    m = torch.amax(log_i, dim=1, keepdim=True)
    k_g, v_aug = _mlstm_gla_inputs(k, v, log_i, m)
    y_aug, state = gla(q, k_g, v_aug, log_f, return_state=True)
    y, nrm = y_aug[..., :P], y_aug[..., P:]
    out = _mlstm_combine(params, cfg, y, nrm, z, B, S, d_inner, m)
    return out, {"state": state, "m": m}


def mlstm_decode(params, cfg, u, cache):
    """One-token step. u: (B, 1, D). The prefill's m stays (a running
    maximum would rescale the state)."""
    check_port_supported(cfg)
    B = u.shape[0]
    q, k, v, log_f, log_i, z, d_inner, H, P = _mlstm_qkva(params, cfg, u)
    m = cache["m"]
    k_g, v_aug = _mlstm_gla_inputs(k, v, log_i, m)
    state, y_aug = gla_decode_step(cache["state"], q[:, 0], k_g[:, 0], v_aug[:, 0],
                                   log_f[:, 0])
    y_aug = y_aug[:, None]
    y, nrm = y_aug[..., :P], y_aug[..., P:]
    out = _mlstm_combine(params, cfg, y.to(u.dtype), nrm, z, B, 1, d_inner, m)
    return out, {"state": state, "m": m}


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg):
    d = cfg.d_model
    H = cfg.num_heads
    P = d // H
    dtype, dev = dtype_of(cfg), gen.device
    return {
        # 4 gates (i, f, z, o) from the input
        "w_in": dense_init(gen, d, 4 * d, dtype),
        # block-diagonal recurrence: per head (P, 4P), f32
        "r": torch.randn((H, P, 4 * P), generator=gen, device=dev) / math.sqrt(P),
        "b": torch.cat([torch.zeros((d,), device=dev), torch.linspace(3.0, 6.0, d, device=dev),
                        torch.zeros((2 * d,), device=dev)]),
        "out_norm": rmsnorm_init(d, dtype, dev),
        "w_ff1": dense_init(gen, d, 4 * d // 3, dtype),
        "w_ff2": dense_init(gen, 4 * d // 3, d, dtype),
    }


def slstm_init_cache(params, cfg, batch: int, dtype: torch.dtype):
    H = cfg.num_heads
    P = cfg.d_model // H
    dev = params["w_in"].device
    return {name: torch.zeros((batch, H, P), dtype=torch.float32, device=dev)
            for name in ("c", "n", "h", "m")}


def _slstm_cell(params, cfg, x_t, state):
    """x_t: (B, 4d) pre-projected gate inputs; state: c, n, h, m of (B, H, P) f32."""
    H = cfg.num_heads
    P = cfg.d_model // H
    B = x_t.shape[0]
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    rec = torch.einsum("bhp,hpk->bhk", h, params["r"])  # (B, H, 4P)
    # Gate-major layout: x_t (B, 4d) -> (B, 4, H, P); the recurrence likewise.
    xg = x_t.float().reshape(B, 4, H, P)
    rg = rec.reshape(B, H, 4, P).permute(0, 2, 1, 3)
    z_in = xg + rg + params["b"].reshape(4, H, P)[None]
    i_t, f_t, z_t, o_t = z_in.unbind(1)
    # Stabilized exponential gating (xLSTM paper eqs. 15-17).
    log_f = F.logsigmoid(f_t)
    m_new = torch.maximum(log_f + m, i_t)
    i_s = torch.exp(i_t - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(z_t)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(o_t) * c_new / torch.clamp(n_new, min=1.0)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _slstm_scan(params, cfg, u, norm):
    """The recurrence over u's positions from a zero state; returns the
    block's output and the state after the last position."""
    B, S, d = u.shape
    x_all = u @ params["w_in"]  # (B, S, 4d)
    state = slstm_init_cache(params, cfg, B, u.dtype)
    hs = []
    for t in range(S):
        state = _slstm_cell(params, cfg, x_all[:, t], state)
        hs.append(state["h"])
    y = torch.stack(hs, dim=1).reshape(B, S, d).to(u.dtype)
    y = norm(y, params["out_norm"], cfg.norm_eps)
    return F.gelu(y @ params["w_ff1"], approximate="tanh") @ params["w_ff2"], state


def slstm_block(params, cfg, u):
    """Full-sequence sLSTM, differentiable (the train mode). u: (B, S, D)."""
    check_port_supported(cfg)
    return _slstm_scan(params, cfg, u, rmsnorm_train)[0]


def slstm_prefill(params, cfg, u):
    check_port_supported(cfg)
    return _slstm_scan(params, cfg, u, rmsnorm)


def slstm_decode(params, cfg, u, cache):
    check_port_supported(cfg)
    B, _, d = u.shape
    new = _slstm_cell(params, cfg, (u @ params["w_in"])[:, 0], cache)
    y = new["h"].reshape(B, 1, d).to(u.dtype)
    y = rmsnorm(y, params["out_norm"], cfg.norm_eps)
    return F.gelu(y @ params["w_ff1"], approximate="tanh") @ params["w_ff2"], new
