"""Backbone assembly for the port's two architectures.

Counterpart of ``repro/models/backbone/transformer.py``, for the block
kinds the slice serves: ``attn`` (per layer, or zamba2's ONE shared
attention + MLP block applied every ``hybrid_attn_period``-th layer) and
``mamba2``. Other kinds (mLSTM, sLSTM, MoE, enc-dec, vision) raise.

Parameters keep the JAX layout, so a JAX parameter tree converts leaf by
leaf (:func:`repro_torch.convert.backbone_params_from_jax`): the layer list
is grouped into its repeating unit (dense: [attn]; zamba2: [mamba2 x5,
attn]), each unit slot's parameters are stacked on a leading ``n_units``
axis (``units/slotS``), and the layers left over form ``tail``. The JAX
package scans over the units; the port walks them in a Python loop.

Three entry modes share the block code:
  * :func:`forward`     — full-sequence logits (JAX mode ``"train"``);
  * :func:`prefill`     — full sequence, returns last-position logits + cache;
  * :func:`decode_step` — one token against the cache.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.backbone.attention import (
    attention_block,
    attention_decode,
    attention_prefill,
    attn_init,
)
from repro_torch.models.backbone.config import ArchConfig, check_port_supported
from repro_torch.models.backbone.layers import (
    dense_init,
    dtype_of,
    embed,
    embed_init,
    mlp,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
)
from repro_torch.models.backbone.ssm import (
    mamba2_block,
    mamba2_decode,
    mamba2_init,
    mamba2_prefill,
)
from repro_torch.tree import tree_map

PyTree = Any

PORTED_KINDS = ("attn", "mamba2")


def _check_arch(cfg: ArchConfig) -> None:
    check_port_supported(cfg)
    missing = [k for k in set(cfg.block_pattern) if k not in PORTED_KINDS]
    if missing or cfg.is_moe or cfg.is_encoder_decoder or cfg.num_vision_tokens or cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name}: the port's backbone has only dense/GQA attention and mamba2 "
            f"blocks (no MoE, mLSTM/sLSTM, enc-dec or vision yet)")


# ---------------------------------------------------------------------------
# Stacking structure
# ---------------------------------------------------------------------------

def unit_structure(cfg: ArchConfig) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """(unit_pattern, n_units, tail_pattern)."""
    pattern = cfg.block_pattern
    period = cfg.hybrid_attn_period or cfg.slstm_period or 1
    if period <= 1:
        return (pattern[0],), len(pattern), ()
    n_units = len(pattern) // period
    return pattern[:period], n_units, pattern[n_units * period:]


def _block_init(gen: torch.Generator, cfg: ArchConfig, kind: str) -> PyTree:
    dtype, dev = dtype_of(cfg), gen.device
    if kind == "attn":
        if cfg.arch_type == "hybrid" and cfg.shared_attn:
            # Weights live in params["shared_attn"]; the block carries its norm.
            return {"norm1": rmsnorm_init(cfg.d_model, dtype, dev)}
        p = {
            "norm1": rmsnorm_init(cfg.d_model, dtype, dev),
            "attn": attn_init(gen, cfg),
            "norm2": rmsnorm_init(cfg.d_model, dtype, dev),
        }
        if cfg.d_ff:
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
        return p
    if kind == "mamba2":
        return {"norm1": rmsnorm_init(cfg.d_model, dtype, dev), "mixer": mamba2_init(gen, cfg)}
    raise NotImplementedError(f"block kind {kind!r} is not ported yet")


def init_params(gen: torch.Generator, cfg: ArchConfig) -> PyTree:
    """Random parameters on ``gen.device`` with the JAX init's shapes and
    scales (normal draws from ``gen``; not the JAX numbers)."""
    _check_arch(cfg)
    unit, n_units, tail = unit_structure(cfg)
    dtype, dev = dtype_of(cfg), gen.device
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    params["units"] = {}
    for s, kind in enumerate(unit):
        blocks = [_block_init(gen, cfg, kind) for _ in range(n_units)]
        params["units"][f"slot{s}"] = tree_map(lambda *xs: torch.stack(xs), *blocks)
        del blocks
    params["tail"] = {f"layer{i}": _block_init(gen, cfg, kind) for i, kind in enumerate(tail)}
    if cfg.arch_type == "hybrid" and cfg.shared_attn:
        shared = {"attn": attn_init(gen, cfg), "norm2": rmsnorm_init(cfg.d_model, dtype, dev)}
        if cfg.d_ff:
            shared["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
        params["shared_attn"] = shared
    return params


def param_count(params: PyTree) -> int:
    from repro_torch.tree import tree_leaves

    return sum(int(x.numel()) for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# Block application (shared across modes)
# ---------------------------------------------------------------------------

def _apply_block(p, shared, cfg, kind, x, positions, mode, cache):
    """Returns (x, new_cache)."""
    new_cache = cache
    if kind == "attn":
        attn_p = shared if shared is not None else p
        h = rmsnorm(x, p["norm1"], cfg.norm_eps)
        if mode == "train":
            y = attention_block(attn_p["attn"], cfg, h, positions)
        elif mode == "prefill":
            y, new_attn_cache = attention_prefill(attn_p["attn"], cfg, h, positions)
        else:
            y, new_attn_cache = attention_decode(attn_p["attn"], cfg, h, cache["attn"],
                                                 positions)
        x = x + y
        if mode != "train":
            new_cache = dict(cache) if cache is not None else {}
            new_cache["attn"] = new_attn_cache
        if "mlp" in attn_p:
            h2 = rmsnorm(x, attn_p["norm2"], cfg.norm_eps)
            x = x + mlp(attn_p["mlp"], h2)
        return x, new_cache
    if kind != "mamba2":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if mode == "train":
        return x + mamba2_block(p["mixer"], cfg, h), new_cache
    if mode == "prefill":
        y, new_cache = mamba2_prefill(p["mixer"], cfg, h)
    else:
        y, new_cache = mamba2_decode(p["mixer"], cfg, h, cache)
    return x + y, new_cache


# ---------------------------------------------------------------------------
# Stack application: a loop over units + the tail
# ---------------------------------------------------------------------------

def _apply_stack(params, cfg, x, positions, mode, caches):
    """caches: {"units": {slotS: stacked cache}, "tail": {layerI: cache}} or None.

    Returns (x, new caches); the unit caches are stacked on a leading axis
    again, as the JAX scan emits them.
    """
    unit, n_units, tail = unit_structure(cfg)
    shared = params.get("shared_attn")
    unit_caches = (caches or {}).get("units")
    outs = []
    for i in range(n_units):
        out_c = {}
        for s, kind in enumerate(unit):
            p = tree_map(lambda a: a[i], params["units"][f"slot{s}"])
            c = tree_map(lambda a: a[i], unit_caches[f"slot{s}"]) if unit_caches else None
            sh = shared if (kind == "attn" and shared is not None) else None
            x, nc = _apply_block(p, sh, cfg, kind, x, positions, mode, c)
            if nc is not None:
                out_c[f"slot{s}"] = nc
        outs.append(out_c)
    new_caches: Dict[str, Any] = {"units": {}, "tail": {}}
    if mode != "train":
        new_caches["units"] = tree_map(lambda *xs: torch.stack(xs), *outs)
    for i, kind in enumerate(tail):
        c = (caches or {}).get("tail", {}).get(f"layer{i}") if caches else None
        sh = shared if (kind == "attn" and shared is not None) else None
        x, nc = _apply_block(params["tail"][f"layer{i}"], sh, cfg, kind, x, positions, mode, c)
        if nc is not None:
            new_caches["tail"][f"layer{i}"] = nc
    return x, new_caches


# ---------------------------------------------------------------------------
# Inputs and outputs
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg, batch, pos_offset: int = 0):
    """batch: {"tokens": (B, S)} (text only). Returns (x, positions (B, S))."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"], tokens)
    positions = (pos_offset + torch.arange(S, device=tokens.device))[None].expand(B, S)
    return x, positions


def _logits(params, cfg, h):
    return (h @ params["embed"]["tok"].T) if cfg.tie_embeddings else (h @ params["lm_head"])


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def forward(params, cfg: ArchConfig, batch):
    """Full-sequence logits. Returns (logits (B, S, V), aux_loss 0, h_final)."""
    _check_arch(cfg)
    x, positions = _embed_inputs(params, cfg, batch)
    x, _ = _apply_stack(params, cfg, x, positions, "train", None)
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, h), torch.zeros((), device=h.device), h


def prefill(params, cfg: ArchConfig, batch, max_len: int):
    """Full-sequence prefill. Returns (last-position logits, cache, h)."""
    _check_arch(cfg)
    x, positions = _embed_inputs(params, cfg, batch)
    x, caches = _apply_stack(params, cfg, x, positions, "prefill", None)
    h = rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    caches = _resize_attn_caches(params, cfg, caches, max_len)
    caches["t"] = torch.tensor(x.shape[1], dtype=torch.int32, device=x.device)
    return _logits(params, cfg, h), caches, h


def _is_attn_cache(c) -> bool:
    return isinstance(c, dict) and set(c) >= {"k", "v", "pos"}


def _resize_attn_caches(params, cfg, caches, max_len):
    """Pad prefill KV caches out to the serving ring-buffer length."""
    def pad_to(a, target):
        cur = a.shape[-3]
        if cur >= target:
            # Keep the last ``target`` keys with absolute position p at ring
            # slot p % target, so decode (slot = pos % target) overwrites the oldest.
            kept = a[..., cur - target:, :, :]
            shift = (cur - target) % target if target else 0
            return torch.roll(kept, shifts=shift, dims=-3)
        return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, target - cur))  # axis -3

    def fix(c):
        window = cfg.sliding_window
        cur_len = c["k"].shape[-3]
        # Non-windowed caches never truncate.
        target = min(window, max_len) if window else max(max_len, cur_len)
        return {"k": pad_to(c["k"], target), "v": pad_to(c["v"], target), "pos": c["pos"]}

    def walk(tree):
        if isinstance(tree, dict):
            if _is_attn_cache(tree):
                return fix(tree)
            return {k: walk(v) for k, v in tree.items()}
        return tree

    return walk(caches)


def decode_step(params, cfg: ArchConfig, tokens, caches):
    """One decode step. tokens: (B, 1). Returns (logits (B,1,V), new caches, h)."""
    _check_arch(cfg)
    x = embed(params["embed"], tokens)
    # attention_decode derives the rope position from its cache's "pos".
    x, new_caches = _apply_stack(params, cfg, x, None, "decode", caches)
    new_caches["t"] = caches["t"] + 1
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, h), new_caches, h
