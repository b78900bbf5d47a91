"""Backbone assembly: counterpart of ``repro/models/backbone/transformer.py``.

Block kinds: ``attn`` (per layer, or zamba2's ONE shared attention + MLP
block applied every ``hybrid_attn_period``-th layer), its feed-forward a
SwiGLU MLP or the MoE block (:mod:`~repro_torch.models.backbone.moe`:
capacity routing in prefill and training, every expert in decode), and
``mamba2``. Qwen2-VL prepends projected stub patch embeddings
(``batch["vision"]``) and rotates with M-RoPE positions. mLSTM, sLSTM and
enc-dec (whisper) raise.

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

The mode chooses the ops, never a failure. Prefill and decode serve
through the kernels (flash attention, GLA, RMSNorm: CUDA on the card),
which have no backward. Mode ``"train"`` is differentiable: it runs the
counterparts of the jnp functions the JAX package trains through
(``use_pallas`` is False by default there) — ``attention_block``
(``full_attention`` / ``chunked_attention``), ``mamba2_block``
(``chunked_gla``) and ``rmsnorm_train`` for every norm — and launches no
backbone kernel. Every mode sums the MoE blocks' load-balance losses;
:func:`forward` returns the sum (0 without MoE), the others drop it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

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
    mrope_positions,
    mrope_text_start,
    rmsnorm,
    rmsnorm_init,
    rmsnorm_train,
)
from repro_torch.models.backbone.moe import moe_block, moe_block_dense, moe_init
from repro_torch.models.backbone.ssm import (
    mamba2_block,
    mamba2_decode,
    mamba2_init,
    mamba2_prefill,
)
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

PyTree = Any

PORTED_KINDS = ("attn", "mamba2")


def _check_arch(cfg: ArchConfig) -> None:
    check_port_supported(cfg)
    missing = [k for k in set(cfg.block_pattern) if k not in PORTED_KINDS]
    if missing or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the port's backbone has attention (dense, GQA, MoE, M-RoPE "
            f"with a vision prefix) and mamba2 blocks (no mLSTM/sLSTM or enc-dec yet)")


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
        if cfg.is_moe:
            p["moe"] = moe_init(gen, cfg)
        elif cfg.d_ff:
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
    if cfg.num_vision_tokens:
        # Projector from the (stubbed) vision encoder's embedding space.
        params["vision_proj"] = dense_init(gen, cfg.d_model, cfg.d_model, dtype)
    return params


def param_count(params: PyTree) -> int:
    from repro_torch.tree import tree_leaves

    return sum(int(x.numel()) for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# Block application (shared across modes)
# ---------------------------------------------------------------------------

def _apply_block(p, shared, cfg, kind, x, positions, mode, cache):
    """Returns (x, new_cache, aux_loss); the aux loss is the float 0.0 for a
    block without MoE (no device op)."""
    aux = 0.0
    new_cache = cache
    norm = rmsnorm_train if mode == "train" else rmsnorm
    if kind == "attn":
        attn_p = shared if shared is not None else p
        h = norm(x, p["norm1"], cfg.norm_eps)
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
        if "moe" in attn_p or "mlp" in attn_p:
            h2 = norm(x, attn_p["norm2"], cfg.norm_eps)
            if "moe" in attn_p:  # every expert in decode, the capacity route otherwise
                moe = moe_block_dense if mode == "decode" else moe_block
                y2, aux = moe(attn_p["moe"], cfg, h2)
            else:
                y2 = mlp(attn_p["mlp"], h2)
            x = x + y2
        return x, new_cache, aux
    if kind != "mamba2":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    h = norm(x, p["norm1"], cfg.norm_eps)
    if mode == "train":
        return x + mamba2_block(p["mixer"], cfg, h), new_cache, aux
    if mode == "prefill":
        y, new_cache = mamba2_prefill(p["mixer"], cfg, h)
    else:
        y, new_cache = mamba2_decode(p["mixer"], cfg, h, cache)
    return x + y, new_cache, aux


# ---------------------------------------------------------------------------
# Stack application: a loop over units + the tail
# ---------------------------------------------------------------------------

def _unstack(tree: PyTree, n: int) -> List[PyTree]:
    """A tree of (n, ...) leaves -> n trees of their slices. One ``unbind`` a
    leaf, so the backward stacks each leaf's gradient once (indexing each
    unit would write a full-size zero gradient a unit)."""
    leaves, treedef = tree_flatten(tree)
    parts = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [p[i] for p in parts]) for i in range(n)]


def _apply_stack(params, cfg, x, positions, mode, caches, remat=False):
    """caches: {"units": {slotS: stacked cache}, "tail": {layerI: cache}} or None.

    Returns (x, new caches, summed aux loss); the unit caches are stacked
    on a leading axis again, as the JAX scan emits them. ``remat``
    recomputes each unit in the backward (``torch.utils.checkpoint``), as
    ``jax.checkpoint`` of the unit does in the JAX package; the tail is
    applied without it, as there.
    """
    unit, n_units, tail = unit_structure(cfg)
    shared = params.get("shared_attn")
    unit_caches = (caches or {}).get("units")
    slot_params = {s: _unstack(params["units"][f"slot{s}"], n_units) for s in range(len(unit))}

    def unit_fn(x, i):
        out_c, aux = {}, 0.0
        for s, kind in enumerate(unit):
            c = tree_map(lambda a: a[i], unit_caches[f"slot{s}"]) if unit_caches else None
            sh = shared if (kind == "attn" and shared is not None) else None
            x, nc, a = _apply_block(slot_params[s][i], sh, cfg, kind, x, positions, mode, c)
            aux = aux + a
            if nc is not None:
                out_c[f"slot{s}"] = nc
        return x, out_c, aux

    outs, aux_total = [], 0.0
    for i in range(n_units):
        if remat:
            x, out_c, aux = checkpoint(unit_fn, x, i, use_reentrant=False)
        else:
            x, out_c, aux = unit_fn(x, i)
        aux_total = aux_total + aux
        outs.append(out_c)
    new_caches: Dict[str, Any] = {"units": {}, "tail": {}}
    if mode != "train":
        new_caches["units"] = tree_map(lambda *xs: torch.stack(xs), *outs)
    for i, kind in enumerate(tail):
        c = (caches or {}).get("tail", {}).get(f"layer{i}") if caches else None
        sh = shared if (kind == "attn" and shared is not None) else None
        x, nc, aux = _apply_block(params["tail"][f"layer{i}"], sh, cfg, kind, x, positions,
                                  mode, c)
        aux_total = aux_total + aux
        if nc is not None:
            new_caches["tail"][f"layer{i}"] = nc
    return x, new_caches, aux_total


# ---------------------------------------------------------------------------
# Inputs and outputs
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg, batch):
    """batch: {"tokens": (B, S), optional "vision": (B, nv, D)}.

    Returns (x, positions): the projected vision embeddings ahead of the
    token embeddings, and M-RoPE's (3, B, S_total) positions where
    ``cfg.mrope``, else (B, S_total)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"], tokens)
    nv = 0
    if cfg.num_vision_tokens and "vision" in batch:
        vis = batch["vision"].to(x.dtype) @ params["vision_proj"]
        x = torch.cat([vis, x], dim=1)
        nv = cfg.num_vision_tokens
    S_total = x.shape[1]
    if cfg.mrope:
        return x, mrope_positions(B, S_total, nv, device=tokens.device)
    return x, torch.arange(S_total, device=tokens.device)[None].expand(B, S_total)


def _logits(params, cfg, h):
    return (h @ params["embed"]["tok"].T) if cfg.tie_embeddings else (h @ params["lm_head"])


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def forward(params, cfg: ArchConfig, batch, remat: bool = True):
    """Full-sequence logits, differentiable (mode ``"train"``: no backbone
    kernel). Returns (logits (B, S, V), aux_loss, h_final); with a vision
    prefix, logits and h cover the text positions only."""
    _check_arch(cfg)
    x, positions = _embed_inputs(params, cfg, batch)
    x, _, aux = _apply_stack(params, cfg, x, positions, "train", None, remat=remat)
    h = rmsnorm_train(x, params["final_norm"], cfg.norm_eps)
    if cfg.num_vision_tokens and "vision" in batch:
        h = h[:, cfg.num_vision_tokens:]  # loss only over text positions
    aux = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
    return _logits(params, cfg, h), aux, h


def prefill(params, cfg: ArchConfig, batch, max_len: int):
    """Full-sequence prefill. Returns (last-position logits, cache, h)."""
    _check_arch(cfg)
    x, positions = _embed_inputs(params, cfg, batch)
    x, caches, _ = _apply_stack(params, cfg, x, positions, "prefill", None)
    h = rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    caches = _resize_attn_caches(params, cfg, caches, max_len)
    caches["t"] = torch.tensor(x.shape[1], dtype=torch.int32, device=x.device)  # incl. vision
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
        # Non-windowed caches never truncate (e.g. the vision prefix).
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
    positions = None  # attention_decode derives the rope position from its cache's "pos"
    if cfg.mrope:
        # Text M-RoPE position: start + (t - num_vision) on all 3 channels.
        nv = cfg.num_vision_tokens
        p = (mrope_text_start(nv) + caches["t"] - nv).to(torch.int32)
        positions = p.expand(3, tokens.shape[0], 1)
    x, new_caches, _ = _apply_stack(params, cfg, x, positions, "decode", caches)
    new_caches["t"] = caches["t"] + 1
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, h), new_caches, h
