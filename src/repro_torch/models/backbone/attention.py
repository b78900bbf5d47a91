"""Attention: GQA with optional qk-norm, causal / sliding-window masks, and
KV-cache decode with a ring buffer for sliding windows.

Counterpart of ``repro/models/backbone/attention.py``. The JAX package
computes full-sequence attention with ``chunked_attention`` /
``full_attention`` (jnp), or with the Pallas flash kernel under
``cfg.use_pallas`` — its TPU hot path (``attention.py:5-7``). The port has
one path: :func:`attention_block` and :func:`attention_prefill` call the
flash-attention wrapper (:mod:`repro_torch.kernels.attention`: the CUDA
kernel on the card, its plain version on the CPU) with the UNEXPANDED KV
heads. Decode attends one query over the cache with two ``torch`` matmuls
(einsum), as the JAX package computes it outside any kernel; GQA is a
reshape of the query heads, so the cache is never repeated.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.attention import flash_attention
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.backbone.config import check_port_supported
from repro_torch.models.backbone.layers import (
    apply_rope,
    dense_init,
    dtype_of,
    rmsnorm,
    rmsnorm_init,
)


def attn_init(gen: torch.Generator, cfg):
    hd = cfg.head_dim_
    dtype = dtype_of(cfg)
    params = {
        "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd, dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype),
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype),
    }
    if cfg.qk_norm:
        params["q_norm"] = rmsnorm_init(hd, dtype, gen.device)
        params["k_norm"] = rmsnorm_init(hd, dtype, gen.device)
    return params


def _project_qkv(params, cfg, x, positions):
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q = (x @ params["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = (x @ params["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = (x @ params["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    if positions is not None:
        if cfg.mrope:
            raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet")
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(params, cfg, x, positions, causal=True):
    """Self-attention over a full sequence. x: (B, S, D) -> (B, S, D)."""
    check_port_supported(cfg)
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = flash_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    return out.reshape(B, S, cfg.num_heads * cfg.head_dim_) @ params["wo"]


def attention_prefill(params, cfg, x, positions):
    """Like :func:`attention_block` (causal), also returning the KV cache
    ``{"k", "v": (B, S, KV, hd), "pos": S}`` for decode."""
    check_port_supported(cfg)
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    y = out.reshape(B, S, cfg.num_heads * cfg.head_dim_) @ params["wo"]
    return y, {"k": k, "v": v, "pos": torch.tensor(S, dtype=torch.int32, device=x.device)}


def init_kv_cache(cfg, batch: int, max_len: int, dtype: torch.dtype, device) -> dict:
    hd = cfg.head_dim_
    window = cfg.sliding_window
    cache_len = min(window, max_len) if window else max_len
    shape = (batch, cache_len, cfg.num_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),  # next token's position
    }


def attention_decode(params, cfg, x, cache, positions=None):
    """One-token decode against the KV cache. x: (B, 1, D).

    Sliding-window configs keep a ring buffer of ``window`` entries; the
    new key goes to slot pos % cache_len. The cache position stays a
    device tensor, so a decode step never waits on the host.
    """
    check_port_supported(cfg)
    B = x.shape[0]
    hd, H, KV = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    pos = cache["pos"]
    if positions is None:
        positions = pos.expand(B, 1)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)

    cache_len = cache["k"].shape[1]
    slot = torch.remainder(pos, cache_len).long().reshape(1)  # == pos with no window
    k = cache["k"].index_copy(1, slot, k_new)
    v = cache["v"].index_copy(1, slot, v_new)

    qg = q.reshape(B, 1, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() / math.sqrt(hd)
    # Valid entries: every slot written so far.
    written = torch.where(pos + 1 >= cache_len, torch.full_like(pos, cache_len), pos + 1)
    valid = torch.arange(cache_len, device=x.device) < written
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    y = out.reshape(B, 1, H * hd) @ params["wo"]
    return y, {"k": k, "v": v, "pos": pos + 1}
