"""Backbone assembly: counterpart of ``repro/models/backbone/transformer.py``.

Block kinds: ``attn`` (per layer, or zamba2's ONE shared attention + MLP
block applied every ``hybrid_attn_period``-th layer), its feed-forward a
SwiGLU MLP or the MoE block (:mod:`~repro_torch.models.backbone.moe`:
capacity routing in prefill and training, every expert in decode),
``mamba2``, and xLSTM's ``mlstm`` and ``slstm``
(:mod:`~repro_torch.models.backbone.xlstm`; the unit [mLSTM x 7, sLSTM]).
Qwen2-VL prepends projected stub patch embeddings (``batch["vision"]``)
and rotates with M-RoPE positions. Whisper (enc-dec) runs a bidirectional
encoder over stub frame embeddings (``batch["frames"]``, :func:`encode`)
and cross-attention to its output in each decoder block; prefill keeps
the encoder output as ``caches["memory"]`` and every decode step projects
the cross K/V from it again, as the reference does.

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
which have no backward; the encoder runs in prefill (flash with
``causal=False``). Mode ``"train"`` is differentiable: it runs the
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
    attention_encode,
    attention_prefill,
    attn_init,
    cross_attention,
    cross_attn_init,
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
from repro_torch.models.backbone.xlstm import (
    mlstm_block,
    mlstm_decode,
    mlstm_init,
    mlstm_prefill,
    slstm_block,
    slstm_decode,
    slstm_init,
    slstm_prefill,
)
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

PyTree = Any

PORTED_KINDS = ("attn", "mamba2", "mlstm", "slstm")
# (init, train, prefill, decode) of each recurrent block kind
_MIXERS = {"mamba2": (mamba2_init, mamba2_block, mamba2_prefill, mamba2_decode),
           "mlstm": (mlstm_init, mlstm_block, mlstm_prefill, mlstm_decode),
           "slstm": (slstm_init, slstm_block, slstm_prefill, slstm_decode)}


def _check_arch(cfg: ArchConfig) -> None:
    check_port_supported(cfg)
    missing = sorted(k for k in set(cfg.block_pattern) if k not in PORTED_KINDS)
    if missing:
        raise NotImplementedError(f"{cfg.name}: block kinds {missing} are not in the port")


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


def _block_init(gen: torch.Generator, cfg: ArchConfig, kind: str,
                decoder: bool = False) -> PyTree:
    """One block's parameters; a whisper decoder block (``decoder``) adds
    the cross-attention and its norm."""
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
        if decoder and cfg.is_encoder_decoder:
            p["norm_x"] = rmsnorm_init(cfg.d_model, dtype, dev)
            p["xattn"] = cross_attn_init(gen, cfg)
        return p
    if kind in _MIXERS:
        return {"norm1": rmsnorm_init(cfg.d_model, dtype, dev), "mixer": _MIXERS[kind][0](gen, cfg)}
    raise NotImplementedError(f"block kind {kind!r} is not in the port")


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
    decoder = cfg.is_encoder_decoder
    params["units"] = {}
    for s, kind in enumerate(unit):
        params["units"][f"slot{s}"] = _stacked_init(gen, cfg, kind, n_units, decoder)
    params["tail"] = {f"layer{i}": _block_init(gen, cfg, kind, decoder)
                      for i, kind in enumerate(tail)}
    if cfg.arch_type == "hybrid" and cfg.shared_attn:
        shared = {"attn": attn_init(gen, cfg), "norm2": rmsnorm_init(cfg.d_model, dtype, dev)}
        if cfg.d_ff:
            shared["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
        params["shared_attn"] = shared
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "blocks": _stacked_init(gen, cfg, "attn", cfg.num_encoder_layers, False),
            "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        }
    if cfg.num_vision_tokens:
        # Projector from the (stubbed) vision encoder's embedding space.
        params["vision_proj"] = dense_init(gen, cfg.d_model, cfg.d_model, dtype)
    return params


def _stacked_init(gen, cfg, kind, n, decoder):
    """``n`` blocks of ``kind``, each leaf stacked on a leading axis."""
    blocks = [_block_init(gen, cfg, kind, decoder) for _ in range(n)]
    return tree_map(lambda *xs: torch.stack(xs), *blocks)


def param_count(params: PyTree) -> int:
    from repro_torch.tree import tree_leaves

    return sum(int(x.numel()) for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# Block application (shared across modes)
# ---------------------------------------------------------------------------

def _apply_block(p, shared, cfg, kind, x, positions, mode, cache, memory=None, causal=True):
    """Returns (x, new_cache, aux_loss); the aux loss is the float 0.0 for a
    block without MoE (no device op). ``memory`` (whisper's encoder output)
    adds the cross-attention after the self-attention; ``causal=False``
    (the encoder) attends both ways and keeps no cache."""
    aux = 0.0
    new_cache = cache
    norm = rmsnorm_train if mode == "train" else rmsnorm
    if kind == "attn":
        attn_p = shared if shared is not None else p
        h = norm(x, p["norm1"], cfg.norm_eps)
        if mode == "train":
            y = attention_block(attn_p["attn"], cfg, h, positions, causal=causal)
        elif not causal:
            y = attention_encode(attn_p["attn"], cfg, h, positions)
        elif mode == "prefill":
            y, new_attn_cache = attention_prefill(attn_p["attn"], cfg, h, positions)
        else:
            y, new_attn_cache = attention_decode(attn_p["attn"], cfg, h, cache["attn"],
                                                 positions)
        x = x + y
        if mode != "train" and causal:
            new_cache = dict(cache) if cache is not None else {}
            new_cache["attn"] = new_attn_cache
        if cfg.is_encoder_decoder and memory is not None:
            hx = norm(x, p["norm_x"], cfg.norm_eps)
            x = x + cross_attention(p["xattn"], cfg, hx, memory, mode)
        if "moe" in attn_p or "mlp" in attn_p:
            h2 = norm(x, attn_p["norm2"], cfg.norm_eps)
            if "moe" in attn_p:  # every expert in decode, the capacity route otherwise
                moe = moe_block_dense if mode == "decode" else moe_block
                y2, aux = moe(attn_p["moe"], cfg, h2)
            else:
                y2 = mlp(attn_p["mlp"], h2)
            x = x + y2
        return x, new_cache, aux
    if kind not in _MIXERS:
        raise NotImplementedError(f"block kind {kind!r} is not in the port")
    _, train_fn, prefill_fn, decode_fn = _MIXERS[kind]
    h = norm(x, p["norm1"], cfg.norm_eps)
    if mode == "train":
        return x + train_fn(p["mixer"], cfg, h), new_cache, aux
    if mode == "prefill":
        y, new_cache = prefill_fn(p["mixer"], cfg, h)
    else:
        y, new_cache = decode_fn(p["mixer"], cfg, h, cache)
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


def _apply_stack(params, cfg, x, positions, mode, caches, memory=None, remat=False):
    """caches: {"units": {slotS: stacked cache}, "tail": {layerI: cache}} or None;
    ``memory``: whisper's encoder output, which every decoder block attends to.

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
            x, nc, a = _apply_block(slot_params[s][i], sh, cfg, kind, x, positions, mode, c,
                                    memory)
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
                                  mode, c, memory)
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


def encode(params, cfg: ArchConfig, frames, mode: str = "train"):
    """Whisper's encoder over stub frame embeddings (B, S_enc, D): the frames
    in the model dtype, rope positions 0 .. S_enc - 1, the encoder blocks
    without a mask, then its final norm. ``mode`` "train" (from
    :func:`forward`) runs the differentiable ops, "prefill" the kernels."""
    x = frames.to(dtype_of(cfg))
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for p in _unstack(params["encoder"]["blocks"], cfg.num_encoder_layers):
        x, _, _ = _apply_block(p, None, cfg, "attn", x, positions, mode, None, causal=False)
    norm = rmsnorm_train if mode == "train" else rmsnorm
    return norm(x, params["encoder"]["final_norm"], cfg.norm_eps)


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
    memory = encode(params, cfg, batch["frames"], "train") if cfg.is_encoder_decoder else None
    x, positions = _embed_inputs(params, cfg, batch)
    x, _, aux = _apply_stack(params, cfg, x, positions, "train", None, memory, remat=remat)
    h = rmsnorm_train(x, params["final_norm"], cfg.norm_eps)
    if cfg.num_vision_tokens and "vision" in batch:
        h = h[:, cfg.num_vision_tokens:]  # loss only over text positions
    aux = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
    return _logits(params, cfg, h), aux, h


def prefill(params, cfg: ArchConfig, batch, max_len: int):
    """Full-sequence prefill. Returns (last-position logits, cache, h); an
    enc-dec cache keeps the encoder output as ``"memory"``."""
    _check_arch(cfg)
    memory = encode(params, cfg, batch["frames"], "prefill") if cfg.is_encoder_decoder else None
    x, positions = _embed_inputs(params, cfg, batch)
    x, caches, _ = _apply_stack(params, cfg, x, positions, "prefill", None, memory)
    h = rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    if memory is not None:
        caches["memory"] = memory
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
    memory = caches["memory"] if cfg.is_encoder_decoder else None
    x, new_caches, _ = _apply_stack(params, cfg, x, positions, "decode", caches, memory)
    if memory is not None:
        new_caches["memory"] = memory
    new_caches["t"] = caches["t"] + 1
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, h), new_caches, h
