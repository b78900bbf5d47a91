"""Chunkwise gated linear attention: CUDA on the card, plain on the CPU.

Replaces ``repro/kernels/gla.py:73 gla_bhsd`` (body ``_gla_kernel``
``:30``; wrapper ``repro/kernels/ops.py:132 gla``) with hand-written
CUDA kernels for Hopper (``repro_torch/csrc/gla.cu``): the Mamba2-SSD /
mLSTM recurrence S_t = e^{a_t} S_{t−1} + k_t v_tᵀ, y_t = q_t·S_t,
computed 64 steps a chunk with the (dk, dv) state in f32. bfloat16
inputs take the tensor-core kernel (``mma.sync`` chunk products, the
state in registers, dv split across blocks, ``cp.async`` double
buffering; P fed to P v as a bf16 hi + lo pair); float32 inputs take the SIMT
kernel, the f32 parity route. Either can write the state after the last
chunk (``return_state=True``), which ``mamba2_prefill`` and
``mlstm_prefill`` keep as their decode caches.

Past dk = 128 (mLSTM: dk 1,024, dv 1,025) the state is split along dk as
well (:func:`gla_plan`): each block's y is a partial over its 128 rows
of dk, written in f32 to a workspace the wrapper allocates, and a second
kernel sums the partials in tile order and casts once
(``LAUNCHES["gla_reduce"]``). Up to dk = 128 it is one launch, as before.

The kernels read (B, S, H, ·) tensors through their strides, so mamba2's
q and k (one group expanded over the heads, head stride 0) are never
materialized, and mask the ragged tail as identity steps. A CPU tensor
takes the plain version (:func:`repro_torch.kernels.ref.gla_plain`); a
CUDA tensor launches a kernel or raises. ``LAUNCHES["gla_tc"]`` counts
the tensor-core kernel's launches, ``LAUNCHES["gla"]`` the SIMT
kernel's and ``LAUNCHES["gla_reduce"]`` the reduction's, on the CUDA route.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.wire import (
    _on_cuda,
    _ptr,
    _raise_on,
    _unit_last,
    refuse_grad,
    tc_vector_loads,
)

LAUNCHES: Dict[str, int] = {"gla": 0, "gla_tc": 0, "gla_reduce": 0}

CHUNK = 64  # the kernels' chunk length (csrc/gla.cu kC)
MAX_DIM = 128  # rows of dk a block (both kernels), columns of dv a SIMT block (kMaxD)
MAX_GRID_YZ = 65_535  # grid y (dv slices) and z (dk tiles)
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on the H100
TC_COLS = 64  # columns of dv a tensor-core block takes (csrc/gla.cu tc::NS)
TC_WARPS = 4
_c_void_p, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_gla": [_c_void_p] * 7 + [_c_int] * 5 + [_c_ll] * 12 + [_c_int] * 3 + [_c_void_p],
    "repro_gla_reduce": [_c_void_p, _c_void_p, _c_ll, _c_int, _c_int, _c_void_p],
    "repro_gla_tc_smem_bytes": [_c_int, _c_int],
}
DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from repro_torch.kernels import build

    return build.load("gla", _SIGNATURES)


def tc_dk_pad(dk: int) -> int:
    """dk as the tensor-core kernel lays it out in shared memory (``tc::pad_dk``)."""
    return 64 if dk <= 64 else 128


def tc_smem_bytes(dk: int, S: Optional[int] = None) -> int:
    """Dynamic shared memory of the tensor-core kernel (``tc::smem_bytes``):
    log_a of two stages and four warps' cumsums (C f32 each); two stages of
    q, k (C x (dkp + 8) bf16) and the v slice (C x (TC_COLS + 8)); two bf16
    hi/lo copies of S_in (dkp x (TC_COLS + 8)). A one-chunk walk (S <= C)
    asks for log_a, the cumsums and one stage only."""
    dkp = tc_dk_pad(dk)
    one_chunk = S is not None and S <= CHUNK
    stage = 2 * CHUNK * (dkp + 8) * 2 + CHUNK * (TC_COLS + 8) * 2
    return ((2 + TC_WARPS) * CHUNK * 4 + (1 if one_chunk else 2) * stage
            + (0 if one_chunk else 2 * 2 * dkp * (TC_COLS + 8) * 2))


class Plan(NamedTuple):
    route: str  # "tc" (bf16, tensor cores) or "simt" (f32)
    dk_rows: int  # rows of dk a block (the last tile may hold fewer)
    dk_tiles: int  # blocks along dk
    dv_cols: int  # columns of dv a block (the last slice may hold fewer)
    slices: int  # blocks along dv
    grid: tuple  # (B * H, slices, dk_tiles)
    smem: int  # dynamic shared memory, bytes (tc)
    workspace: int  # bytes of the f32 partial-y workspace (0: one dk tile, no reduction)


def gla_plan(B: int, H: int, dk: int, dv: int, dtype: torch.dtype,
             S: Optional[int] = None) -> Plan:
    """The launch: bf16 takes the tensor-core kernel, ``TC_COLS`` columns of
    dv a block (one block a (batch, head) for dv <= 64, two past it); f32
    the SIMT kernel, up to ``MAX_DIM`` columns a block. Splitting mamba2's
    dv of 64 into two blocks lost on the card (PERF.md): each slice repeats
    q kᵀ, P and the copies of q and k. Either takes ``MAX_DIM`` rows of dk
    a block: past that, ``dk_tiles`` blocks each write an f32 partial of y
    to a (dk_tiles, B, S, H, dv) workspace that the reduction sums (S
    rows of it; 0 when S is not given). Raises for a grid the card cannot
    launch."""
    dk_rows = min(dk, MAX_DIM)
    dk_tiles = -(-dk // MAX_DIM)
    if dtype == torch.float32:
        dv_cols, smem = min(dv, MAX_DIM), 0
    else:
        dv_cols, smem = TC_COLS, tc_smem_bytes(dk, S)
    slices = -(-dv // dv_cols)
    if B * H >= 2 ** 31 or slices > MAX_GRID_YZ or dk_tiles > MAX_GRID_YZ:
        raise ValueError(f"gla: no launch for B * H = {B * H}, dk = {dk}, dv = {dv} (grid "
                         f"({B * H}, {slices}, {dk_tiles}) past the card's limits)")
    workspace = dk_tiles * B * (S or 0) * H * dv * 4 if dk_tiles > 1 else 0
    route = "simt" if dtype == torch.float32 else "tc"
    return Plan(route, dk_rows, dk_tiles, dv_cols, slices, (B * H, slices, dk_tiles), smem,
                workspace)


def gla(
    q: torch.Tensor,  # (B, S, H, dk)
    k: torch.Tensor,  # (B, S, H, dk)
    v: torch.Tensor,  # (B, S, H, dv)
    log_a: torch.Tensor,  # (B, S, H) per-step log decay (<= 0)
    *,
    return_state: bool = False,
):
    """Gated linear attention; returns (B, S, H, dv) in q's dtype, and with
    ``return_state`` also the state after the last step, (B, H, dk, dv) f32.

    On the card q, k, v are f32 or bf16 of one dtype; log_a is taken in
    f32 (converted if it is not). Any of them may be a strided view.
    """
    if not _on_cuda(q):
        return _ref.gla_plain(q, k, v, log_a, chunk=CHUNK, return_state=return_state)
    refuse_grad("gla", q, k, v, log_a)
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or v.shape[:3] != q.shape[:3] \
            or tuple(log_a.shape) != tuple(q.shape[:3]):
        raise ValueError(f"gla takes q = k (B,S,H,dk), v (B,S,H,dv), log_a (B,S,H); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(log_a.shape)}")
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"gla takes float32 or bfloat16 q, k, v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not log_a.is_floating_point():
        raise ValueError(f"log_a must be a float tensor, got {log_a.dtype}")
    if any(t.device != q.device for t in (k, v, log_a)):
        raise ValueError("q, k, v and log_a must be on one device")
    if dk < 1 or dv < 1:
        raise ValueError(f"gla takes dk, dv >= 1, got {dk}, {dv}")
    plan = gla_plan(B, H, dk, dv, q.dtype, S)
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    a = log_a.float()
    out = torch.empty((B, S, H, dv), dtype=q.dtype, device=q.device)
    state = (torch.zeros if S == 0 else torch.empty)(
        (B, H, dk, dv), dtype=torch.float32, device=q.device) if return_state else None
    if out.numel():
        tc = plan.route == "tc"
        ws = (torch.empty((plan.workspace // 4,), dtype=torch.float32, device=q.device)
              if plan.workspace else None)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().repro_gla(
            _ptr(q), _ptr(k), _ptr(v), _ptr(a), _ptr(out), _ptr(state), _ptr(ws), B, S, H,
            dk, dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *a.stride(),
            int(tc), int(tc and tc_vector_loads(q, k)), int(tc and tc_vector_loads(v)), stream)
        _raise_on(err, "gla (tensor cores)" if tc else "gla")
        LAUNCHES["gla_tc" if tc else "gla"] += 1
        if ws is not None:
            err = _lib().repro_gla_reduce(_ptr(ws), _ptr(out), out.numel(), plan.dk_tiles,
                                          int(tc), stream)
            _raise_on(err, "gla_reduce")
            LAUNCHES["gla_reduce"] += 1
    return (out, state) if return_state else out
