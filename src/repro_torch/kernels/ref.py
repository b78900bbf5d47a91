"""Plain PyTorch versions of the port's kernels (the correctness contract).

Torch twins of ``repro/kernels/ref.py:47-164``: the wire kernels, the
Newton–Schulz step and the reparam + STL log q forward and backward; and
of the backbone's three kernels: flash attention (the semantics of
``repro/models/backbone/attention.py`` ``chunked_attention`` and of the
Pallas kernel ``repro/kernels/attention.py:28``), chunked gated linear
attention (``repro/models/backbone/ssm.py:29 chunked_gla``) and RMSNorm.
Each is the mathematical definition, written for clarity, not speed: the
kernel wrappers (:mod:`repro_torch.kernels.wire`,
:mod:`repro_torch.kernels.reparam`, :mod:`repro_torch.kernels.attention`,
:mod:`repro_torch.kernels.gla`, :mod:`repro_torch.kernels.rmsnorm`) take
them for CPU tensors, the CPU tests hold them against the reference's
Pallas kernels, and ``chip_smoke.py`` holds each CUDA kernel against them
on the card.

One deliberate difference from the reference: the DP noise of
:func:`wire_upload_ref` is an input (``noise``, a ``(J, P)`` N(0, I)
tensor) instead of a threefry draw from per-row keys.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def wire_upload_ref(
    x: torch.Tensor,  # (J, P) stacked wire matrix
    *,
    mask: torch.Tensor,  # (J,) participation mask
    noise: Optional[torch.Tensor] = None,  # (J, P) N(0, I) draws
    reference: Optional[torch.Tensor] = None,  # (P,) public broadcast row
    clip_norm: Optional[float] = None,
    noise_multiplier: float = 0.0,
    quantize: bool = False,
):
    """Per row: (delta from reference →) L2 clip → + z·C·noise → add the
    reference back → mask select (reference or zeros) → optional int8
    quantization with one scale per row. Returns the float matrix, or
    ``(q, scales)`` when ``quantize``.
    """
    x = x.float()
    y = x
    if clip_norm is not None:
        d = x - reference[None, :] if reference is not None else x
        norm = torch.sqrt(torch.sum(torch.square(d), dim=1, keepdim=True))
        factor = torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
        d = d * factor
        if noise_multiplier > 0.0:
            d = d + (noise_multiplier * clip_norm) * noise
        y = reference[None, :] + d if reference is not None else d
    fallback = (reference[None, :].expand_as(y) if reference is not None
                else torch.zeros_like(y))
    y = torch.where(mask[:, None] > 0.5, y, fallback)
    if not quantize:
        return y
    scale = torch.amax(torch.abs(y), dim=1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(y / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale.float()


def masked_weighted_mean_ref(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Mean mode: Σ_j w_j x_j / Σ_j w_j, guarding ONLY an exactly-zero total."""
    w = weights.float()
    total = torch.sum(w)
    denom = torch.where(total > 0.0, total, torch.ones_like(total))
    return torch.sum(w[:, None] * x.float(), dim=0) / denom


def masked_trimmed_mean_ref(x: torch.Tensor, weights: torch.Tensor,
                            trim_frac: float) -> torch.Tensor:
    """Trimmed mode: rows with w > 0 are active; per column, sort actives
    (inactives as +inf), drop k = min(⌊tf·n⌋, ⌊(n−1)/2⌋) at each end,
    average the rest; zero active rows give zeros.
    """
    x = x.float()
    w = weights.float()
    active = (w > 0.0).float()
    any_active = torch.sum(active) > 0.0
    n_active = torch.clamp(torch.sum(active), min=1.0)
    k = torch.floor(trim_frac * n_active)
    k = torch.minimum(k, torch.floor((n_active - 1.0) / 2.0))
    order = torch.sort(torch.where(w[:, None] > 0.0, x, torch.full_like(x, float("inf"))),
                       dim=0).values
    rank = torch.arange(x.shape[0], device=x.device).reshape(-1, 1)
    keep = (rank >= k) & (rank < n_active - k)
    total = torch.sum(torch.where(keep, order, torch.zeros_like(order)), dim=0)
    mean = total / torch.clamp(torch.sum(keep, dim=0), min=1)
    return torch.where(any_active, mean, torch.zeros_like(mean))


def int8_rows_dequant_ref(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The in-kernel dequantize: q·scale per row, in f32."""
    return q.float() * scales.float()[:, None]


def newton_schulz_step_ref(y: torch.Tensor, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Newton–Schulz step on (..., d, d): t = ½(3I − zy); (y t, t z)."""
    eye3 = 3.0 * torch.eye(y.shape[-1], dtype=y.dtype, device=y.device)
    t = 0.5 * (eye3 - z @ y)
    return y @ t, t @ z


def newton_schulz_sqrtm_ref(mat: torch.Tensor, num_iters: int = 25,
                            step=newton_schulz_step_ref) -> torch.Tensor:
    """PSD square root of each (d, d) matrix of ``mat`` (leading axes kept):
    Frobenius-normalize per matrix, start from z = I, run ``num_iters``
    steps on one contiguous (B, d, d) batch, rescale by √norm.

    ``step`` is the step function: this plain one, or the CUDA kernel's
    wrapper (:func:`repro_torch.kernels.wire.sqrtm_newton_schulz_fused`).
    """
    shape, d = mat.shape, mat.shape[-1]
    m = mat.reshape(-1, d, d)
    norm = torch.sqrt(torch.sum(m * m, dim=(-2, -1), keepdim=True)) + 1e-12
    y = (m / norm).contiguous()
    z = torch.eye(d, dtype=m.dtype, device=m.device).expand_as(m).contiguous()
    for _ in range(num_iters):
        y, z = step(y, z)
    return (y * torch.sqrt(norm)).reshape(shape)


def reparam_stl_ref(mu: torch.Tensor, log_sigma: torch.Tensor,
                    eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """z = μ + e^{log σ}·ε in μ's dtype; logq = Σ(−½ε² − log σ − ½log 2π) in f32."""
    ls = log_sigma.float()
    e = eps.float()
    z = (mu.float() + torch.exp(ls) * e).to(mu.dtype)
    logq = torch.sum(-0.5 * e * e - ls - _HALF_LOG_2PI)
    return z, logq


def reparam_stl_bwd_ref(log_sigma: torch.Tensor, eps: torch.Tensor, dz: torch.Tensor,
                        dlq: torch.Tensor):
    """The STL VJP (``repro/kernels/reparam.py:39-54``):
    dμ = dz; d log σ = dz·σ·ε − dlq; dε = dz·σ − dlq·ε (f32 math)."""
    ls = log_sigma.float()
    e = eps.float()
    g = dz.float()
    lq = dlq.float()
    sig = torch.exp(ls)
    return (g.to(log_sigma.dtype), (g * sig * e - lq).to(log_sigma.dtype),
            (g * sig - lq * e).to(eps.dtype))


NEG_INF = -1e30  # the flash kernel's mask value (repro/kernels/attention.py:25)


def flash_attention_plain(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, hd)
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Softmax attention with GQA (query head h reads kv head h // (H/KV)),
    causal and sliding-window masks and ``q_offset`` (the position of q[0]
    relative to k[0]). Scores, max, normalizer and the weighted sum are
    f32; masked scores are −1e30 and masked weights 0, so a row with no
    live key ends at 0 (the Pallas kernel's rule); the normalizer is
    clamped at 1e-30. Queries are taken ``q_chunk`` rows at a time so the
    (Sq, Skv) scores never exist whole. Returns (B, Sq, H, hd) in q's dtype.
    """
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    kv_pos = torch.arange(Skv, device=q.device)
    outs = []
    for s0 in range(0, Sq, q_chunk):
        qc = q[:, s0:s0 + q_chunk].float()
        c = qc.shape[1]
        s = torch.einsum("bqkgd,bskd->bkgqs", qc.reshape(B, c, KV, G, hd), kf) * scale
        q_pos = torch.arange(s0, s0 + c, device=q.device) + q_offset
        mask = torch.ones((c, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        s = s.masked_fill(~mask, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        o = torch.einsum("bkgqs,bskd->bkgqd", p, vf) / l  # (B, KV, G, c, hd)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, c, H, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def gla_plain(
    q: torch.Tensor,  # (B, S, H, dk)
    k: torch.Tensor,  # (B, S, H, dk)
    v: torch.Tensor,  # (B, S, H, dv)
    log_a: torch.Tensor,  # (B, S, H) per-step log decay (<= 0)
    chunk: int = 64,
    return_state: bool = False,
):
    """y_t = q_t^T (Σ_{s<=t} Π_{r=s+1..t} e^{log_a_r} k_s v_s^T), chunked.

    Within a chunk (q kᵀ ∘ D) v with D_ts = e^{L_t − L_s} masked to s <= t
    before the exp; across chunks (q·e^L) S_in, with S_out = e^{L_C} S_in
    + (k·e^{L_C − L})ᵀ v carried in f32. S is padded to a chunk multiple
    with identity steps (log_a 0, k = v = 0). All arithmetic in f32;
    returns (B, S, H, dv) in q's dtype and, with ``return_state``, the
    state after the last step, (B, H, dk, dv) f32.
    """
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    qf, kf, vf, af = q.float(), k.float(), v.float(), log_a.float()
    if pad:
        qf, kf, vf = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (qf, kf, vf))
        af = torch.nn.functional.pad(af, (0, 0, 0, pad))
    n = (S + pad) // chunk
    qc = qf.reshape(B, n, chunk, H, dk)
    kc = kf.reshape(B, n, chunk, H, dk)
    vc = vf.reshape(B, n, chunk, H, dv)
    cum = torch.cumsum(af.reshape(B, n, chunk, H), dim=2)  # L_t within each chunk
    total = cum[:, :, -1]  # (B, n, H)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, n, C_t, C_s, H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    D = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                              torch.full_like(diff, -math.inf)))
    scores = torch.einsum("bnthd,bnshd->bntsh", qc, kc) * D
    y_intra = torch.einsum("bntsh,bnshv->bnthv", scores, vc)
    k_dec = kc * torch.exp(total[:, :, None] - cum)[..., None]
    chunk_kv = torch.einsum("bnshd,bnshv->bnhdv", k_dec, vc)  # (B, n, H, dk, dv)
    state = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
    states = []
    for i in range(n):  # the state entering each chunk
        states.append(state)
        state = state * torch.exp(total[:, i])[..., None, None] + chunk_kv[:, i]
    q_dec = qc * torch.exp(cum)[..., None]
    y_inter = torch.einsum("bnthd,bnhdv->bnthv", q_dec, torch.stack(states, dim=1))
    y = (y_intra + y_inter).reshape(B, n * chunk, H, dv)[:, :S].to(q.dtype)
    return (y, state) if return_state else y


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x·rsqrt(mean(x²) + eps)·w over the last axis, in f32, cast to x's dtype."""
    x32 = x.float()
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return ((x32 * rms) * weight.float()).to(x.dtype)
