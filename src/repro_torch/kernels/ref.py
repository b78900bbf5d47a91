"""Plain PyTorch versions of the wire kernels (the correctness contract).

Torch twins of ``repro/kernels/ref.py:62-146``. Each is the mathematical
definition, written for clarity, not speed: the kernel wrappers in
:mod:`repro_torch.kernels.wire` take them for CPU tensors, the CPU tests
hold them against the reference's Pallas kernels, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.

One deliberate difference from the reference: the DP noise of
:func:`wire_upload_ref` is an input (``noise``, a ``(J, P)`` N(0, I)
tensor) instead of a threefry draw from per-row keys.
"""
from __future__ import annotations

from typing import Optional

import torch


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
