"""Mixture-of-Experts feed-forward: top-k routing with capacity-based
dispatch (GShard / Switch), the counterpart of
``repro/models/backbone/moe.py``.

Tokens are split into groups of ``group_size``. Within a group each
(token, slot) pair takes its place in its expert's queue in the order of
the flattened (token, slot) list; an expert holds at most ``capacity =
group_size · top_k / E · capacity_factor`` of them, and the pairs past it
are dropped (the residual carries them).

The reference multiplies out (G, gs, E, C) one-hot dispatch and combine
tensors and contracts them with einsums; at olmoe's prefill (4 groups of
1,024 tokens, E 64, k 8, C 160) each would be ~1.3 GB in f32 before the
sum over slots. The port computes the same queue positions and moves rows
by index instead: each (expert, group, slot) row of the experts' input is
the token that holds it (or zero), and each token's output is the
gate-weighted sum of the rows its kept slots produced. The values equal
the einsums' (each dispatch sum has one non-zero term; the gates are
rounded to the model dtype first, as the reference casts ``comb``), and
the gradient reaches the gates. The expert products are batched matmuls
over E (cuBLAS on the card); MoE has no kernel of its own, as the
reference has none.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.backbone.layers import dense_init, dtype_of, normal


def moe_init(gen: torch.Generator, cfg):
    d, E = cfg.d_model, cfg.num_experts
    dff = cfg.d_expert if cfg.d_expert else cfg.d_ff
    dtype = dtype_of(cfg)
    s = 1.0 / math.sqrt(d)
    return {
        "router": dense_init(gen, d, E, torch.float32, scale=0.02),
        "w_gate": normal(gen, (E, d, dff), s, dtype),
        "w_up": normal(gen, (E, d, dff), s, dtype),
        "w_down": normal(gen, (E, dff, d), 1.0 / math.sqrt(dff), dtype),
    }


def _route(router_w: torch.Tensor, x_flat: torch.Tensor, E: int, top_k: int,
           expert_idx: Optional[torch.Tensor] = None):
    """Router probabilities + top-k assignment, in f32. x_flat: (..., T, D).

    ``expert_idx`` (..., T, k), for parity checks only, replaces the top-k
    choice (the gates are then the router's probabilities at those
    experts), so that two devices can be held on the same routing."""
    logits = x_flat.float() @ router_w  # (..., T, E)
    probs = torch.softmax(logits, dim=-1)
    if expert_idx is None:
        gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
    else:
        gate_vals = torch.gather(probs, -1, expert_idx)
    # Renormalize the selected gates (standard for top-k > 1).
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def load_balance_loss(probs: torch.Tensor, expert_idx: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style auxiliary loss E · <fraction routed to e> · <router prob
    e>, one a group: probs (..., T, E), expert_idx (..., T, k) -> (...).
    The counts are a scatter-add that carries no gradient."""
    flat = expert_idx.flatten(-2)
    counts = torch.zeros(probs.shape[:-2] + (E,), device=probs.device).scatter_add_(
        -1, flat, torch.ones(flat.shape, device=probs.device))
    frac = counts / max(flat.shape[-1], 1)
    return E * torch.sum(frac * probs.mean(dim=-2), dim=-1)


def _queue_positions(expert_idx: torch.Tensor, E: int) -> torch.Tensor:
    """Each (token, slot) pair's place in its expert's queue: how many
    earlier pairs of its group, in flattened (token, slot) order, chose the
    same expert. (..., T, k) -> (..., T·k)."""
    flat = expert_idx.flatten(-2)
    # (..., E, T·k): the count runs along the innermost axis. On the card a
    # scan along the outer axis was the slowest kernel of olmoe's prefill
    # (PERF.md §5).
    onehot = F.one_hot(flat, E).transpose(-1, -2).contiguous()
    before = torch.cumsum(onehot, dim=-1) - onehot
    return torch.gather(before, -2, flat[..., None, :])[..., 0, :]


def _dispatch_masks(expert_idx: torch.Tensor, gate_vals: torch.Tensor, E: int, capacity: int):
    """The reference's (T, E, C) dispatch (0/1) and combine (gated) tensors
    of one group, built by index scatter from the queue positions.
    :func:`moe_block` never builds them: they state its routing and drops
    in the reference's terms, for the parity tests."""
    T, k = expert_idx.shape
    pos = _queue_positions(expert_idx, E)
    keep = pos < capacity
    tok = torch.arange(T, device=expert_idx.device).repeat_interleave(k)
    col = torch.where(keep, expert_idx.reshape(-1) * capacity + pos, E * capacity)  # spill
    disp = torch.zeros((T, E * capacity + 1), device=gate_vals.device).index_put(
        (tok, col), keep.float(), accumulate=True)
    comb = torch.zeros((T, E * capacity + 1), dtype=gate_vals.dtype,
                       device=gate_vals.device).index_put(
        (tok, col), gate_vals.reshape(-1) * keep, accumulate=True)
    return (disp[:, :-1].reshape(T, E, capacity), comb[:, :-1].reshape(T, E, capacity))


class _GatherRows(torch.autograd.Function):
    """``cat([src, 0])[index]``: rows of ``src`` by index, the index
    ``len(src)`` a zero row. Its backward is a gather too: each source
    row's gradient is the sum of the ``group`` output rows that
    ``back_index`` lists for it (in f32, rounded once), so no scatter-add
    runs. Dispatch gathers each (expert, slot) row's token and its
    backward sums a token's k slots; the combine gathers each (token,
    slot)'s expert row and its backward takes the one pair that held it."""

    @staticmethod
    def forward(ctx, src, index, back_index, group):
        ctx.save_for_backward(back_index)
        ctx.group = group
        return torch.cat([src, src.new_zeros((1, src.shape[1]))])[index]

    @staticmethod
    def backward(ctx, grad):
        (back_index,) = ctx.saved_tensors
        g = torch.cat([grad, grad.new_zeros((1, grad.shape[1]))])[back_index]
        if ctx.group > 1:
            g = g.view(-1, ctx.group, g.shape[1]).float().sum(1).to(grad.dtype)
        return g, None, None, None


def moe_block(params, cfg, x: torch.Tensor,
              group_size: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss). Grouped capacity-based top-k MoE."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    gs = min(group_size, T)
    assert T % gs == 0, f"tokens {T} not divisible by group {gs}"
    G = T // gs
    capacity = max(int(gs * k / E * cfg.capacity_factor), 1)
    dev = x.device

    probs, gate_vals, expert_idx = _route(params["router"], x.reshape(G, gs, D), E, k)
    aux = load_balance_loss(probs, expert_idx, E).mean()

    # The expert input is (E, G, C) rows; a kept pair fills row (e, g, pos),
    # a dropped one the spill row E·G·C, which no expert reads. ``holder``
    # is each row's pair (T·k where none holds it).
    pos = _queue_positions(expert_idx, E)  # (G, gs·k)
    keep = pos < capacity
    group = torch.arange(G, device=dev)[:, None]
    n_rows = E * G * capacity
    row = torch.where(keep, (expert_idx.reshape(G, -1) * G + group) * capacity + pos,
                      n_rows).reshape(-1)  # in (token, slot) order
    pair = torch.arange(T * k, device=dev)
    holder = torch.full((n_rows + 1,), T * k, dtype=torch.long, device=dev).scatter_(
        0, row, pair)[:n_rows]
    token = torch.where(holder < T * k, holder // k, T)
    xe = _GatherRows.apply(x.reshape(T, D), token, row, k).reshape(E, G * capacity, D)

    h = torch.bmm(xe, params["w_gate"])
    u = torch.bmm(xe, params["w_up"])
    y_e = torch.bmm(F.silu(h) * u, params["w_down"]).reshape(n_rows, D)

    # Combine: each token's kept slots' rows, weighted by its gates (rounded
    # to the model dtype, as the reference's ``comb``), summed in f32.
    picked = _GatherRows.apply(y_e, row, holder, 1).reshape(T, k, D)
    gates = (gate_vals.reshape(T, k) * keep.reshape(T, k)).to(x.dtype)
    y = (gates.float()[..., None] * picked.float()).sum(1).to(x.dtype)
    return y.reshape(B, S, D), aux


def moe_block_dense(params, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode path: every expert on every token, the gate-weighted sum
    restricted to the top-k (no capacity drops). It reads all E experts'
    weights for the few tokens of a decode step, as the reference does."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    xf = x.reshape(-1, D)
    probs, gate_vals, expert_idx = _route(params["router"], xf, E, k)
    aux = load_balance_loss(probs, expert_idx, E)
    gates = torch.zeros_like(probs).scatter(1, expert_idx, gate_vals)  # (T, E)
    h = torch.matmul(xf, params["w_gate"])  # (E, T, dff)
    u = torch.matmul(xf, params["w_up"])
    y_e = torch.matmul(F.silu(h) * u, params["w_down"])  # (E, T, D)
    y = torch.einsum("te,etd->td", gates.to(x.dtype), y_e)
    return y.reshape(B, S, D), aux
