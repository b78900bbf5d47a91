"""Plain PyTorch versions of the port's kernels (the correctness contract).

Torch twins of ``repro/kernels/ref.py:47-164``: the wire kernels, the
Newton–Schulz step and the reparam + STL log q forward and backward.
Each is the mathematical definition, written for clarity, not speed: the
kernel wrappers (:mod:`repro_torch.kernels.wire`,
:mod:`repro_torch.kernels.reparam`) take them for CPU tensors, the CPU tests
hold them against the reference's Pallas kernels, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.

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
