"""Primitive layers of the backbone (pure functions over param dicts).

Counterparts of ``repro/models/backbone/layers.py``: params are nested
dicts of tensors, weights laid out (in, out), activations in
``cfg.dtype``; norms accumulate in f32. :func:`rmsnorm` is the kernel
wrapper (:mod:`repro_torch.kernels.rmsnorm`): the CUDA kernel for a
tensor on the card, its plain version for one on the CPU. It has no
backward, so the train mode normalizes with :func:`rmsnorm_train`, the
counterpart of the JAX package's jnp ``rmsnorm`` (``layers.py:35``), which
is what the reference differentiates.

Initializers draw from an explicit ``torch.Generator`` (on the device the
tensors live on) with the JAX package's shapes and scales; the numbers
differ from ``jax.random``'s.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: F401  (re-exported)


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``scale · N(0, 1)`` drawn in f32 on the generator's device, cast to dtype."""
    return (scale * torch.randn(shape, generator=gen, device=gen.device)).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype: torch.dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return normal(gen, (in_dim, out_dim), scale, dtype)


def rmsnorm_init(dim: int, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.ones((dim,), dtype=dtype, device=device)


def rmsnorm_train(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x · rsqrt(mean x² + eps) · w in f32, back in x's dtype; differentiable."""
    x32 = x.float()
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return ((x32 * rms) * weight.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / SwiGLU MLP
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype: torch.dtype):
    return {"tok": normal(gen, (vocab, d_model), 0.02, dtype)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens]


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype):
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype),
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ params["w_gate"])
    return (gate * (x @ params["w_up"])) @ params["w_down"]
