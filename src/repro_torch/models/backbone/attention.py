"""Attention: GQA with optional qk-norm, causal / sliding-window masks, and
KV-cache decode with a ring buffer for sliding windows.

Counterpart of ``repro/models/backbone/attention.py``. The JAX package
computes full-sequence attention with ``chunked_attention`` /
``full_attention`` (jnp), or with the Pallas flash kernel under
``cfg.use_pallas`` — its TPU hot path (``attention.py:5-7``). The port
chooses by mode, never on a failure:

* serving: :func:`attention_prefill` calls the flash-attention wrapper
  (:mod:`repro_torch.kernels.attention`: the CUDA kernel on the card, its
  plain version on the CPU) with the UNEXPANDED KV heads. The kernel has
  no backward.
* training: :func:`attention_block` runs the counterparts of the jnp
  functions the reference differentiates (``use_pallas`` is False by
  default): :func:`_repeat_kv`, then :func:`full_attention`, or
  :func:`chunked_attention` past ``CHUNKED_MIN_S`` tokens, with the
  qk-norm in :func:`~repro_torch.models.backbone.layers.rmsnorm_train`.

Decode attends one query over the cache with two ``torch`` matmuls
(einsum), as the JAX package computes it outside any kernel; GQA is a
reshape of the query heads, so the cache is never repeated.
"""
from __future__ import annotations

import math
from typing import Optional

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
    rmsnorm_train,
)

CHUNKED_MIN_S = 2048  # the train mode's attention is chunked past this many tokens


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


def _project_qkv(params, cfg, x, positions, norm=rmsnorm):
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q = (x @ params["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = (x @ params["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = (x @ params["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = norm(q, params["q_norm"], cfg.norm_eps)
        k = norm(k, params["k_norm"], cfg.norm_eps)
    if positions is not None:
        if cfg.mrope:
            raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet")
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating each KV group."""
    return torch.repeat_interleave(k, num_heads // k.shape[2], dim=2)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                      sliding_window: Optional[int] = None, q_chunk: int = 512,
                      kv_chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over (q_chunk, kv_chunk) blocks, O(S·W) memory.

    q: (B, Sq, H, hd); k, v: (B, Skv, H, hd) (already GQA-expanded).
    ``q_offset`` is the absolute position of q[0] relative to k[0]. The
    JAX package loops with ``lax.map`` / ``lax.scan``; here Python loops.
    """
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Skv)
    nq, nkv = -(-Sq // q_chunk), -(-Skv // kv_chunk)
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, nq * q_chunk - Sq))
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, nkv * kv_chunk - Skv))
              for t in (k, v))
    dev = q.device
    outs = []
    for qi in range(nq):
        q_blk = qp[:, qi * q_chunk:(qi + 1) * q_chunk]
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev) + q_offset
        acc = torch.zeros((B, H, q_chunk, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        for ki in range(nkv):
            k_blk = kp[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            v_blk = vp[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            kv_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", q_blk, k_blk).float() * scale
            mask = (kv_pos[None, :] < Skv).expand(q_chunk, kv_chunk)  # kv padding
            if causal:
                mask = mask & (kv_pos[None, :] <= q_pos[:, None])
            if sliding_window is not None:
                mask = mask & (kv_pos[None, :] > q_pos[:, None] - sliding_window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + torch.sum(p, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(v_blk.dtype), v_blk).float()
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, nq * q_chunk, H, hd)
    return out[:, :Sq].to(q.dtype)


def full_attention(q, k, v, causal=True, sliding_window=None, q_offset=0):
    """Softmax attention over the whole (Sq, Skv) score matrix; k, v already
    GQA-expanded. The train mode's attention up to ``CHUNKED_MIN_S`` tokens."""
    Sq, Skv, hd = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    kv_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    if sliding_window is not None:
        mask = mask & (kv_pos[None, :] > q_pos[:, None] - sliding_window)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def attention_block(params, cfg, x, positions, causal=True):
    """Self-attention over a full sequence, differentiable: the JAX package's
    jnp route (``attention.py:174-212`` without ``use_pallas``). x: (B, S, D)."""
    check_port_supported(cfg)
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions, norm=rmsnorm_train)
    k, v = _repeat_kv(k, cfg.num_heads), _repeat_kv(v, cfg.num_heads)
    attend = chunked_attention if S > CHUNKED_MIN_S else full_attention
    out = attend(q, k, v, causal=causal, sliding_window=cfg.sliding_window)
    return out.reshape(B, S, cfg.num_heads * cfg.head_dim_) @ params["wo"]


def attention_prefill(params, cfg, x, positions):
    """Causal self-attention over a full sequence through the flash kernel,
    also returning the KV cache ``{"k", "v": (B, S, KV, hd), "pos": S}`` for
    decode."""
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
