"""Flash attention: CUDA on the card, plain on the CPU.

Replaces ``repro/kernels/attention.py:98 flash_attention_bhsd`` (body
``_flash_kernel`` ``:28``; wrapper ``repro/kernels/ops.py:41
flash_attention``) with hand-written CUDA kernels for Hopper
(``repro_torch/csrc/flash_attention.cu``): online-softmax attention with
GQA by indexing (kv head = h // (H/KV)), causal and sliding-window masks
with dead-tile skip, ``q_offset``, and f32 scores, running max,
normalizer and accumulator. bfloat16 inputs take the tensor-core kernel
(``wgmma`` products, ``cp.async`` K/V ring; P rounded to bf16 before
P V); float32 inputs take the SIMT kernel, the f32 parity route.

The kernels read the model's (B, S, H, hd) layout through strides and
mask ragged ends themselves, so this wrapper makes no transposed or
padded copies (a copy only when a last axis is not contiguous). A CPU
tensor takes the plain version
(:func:`repro_torch.kernels.ref.flash_attention_plain`); a CUDA tensor
launches a kernel or raises. ``LAUNCHES["flash_attention_tc"]`` counts
the tensor-core kernel's launches, ``LAUNCHES["flash_attention"]`` the
SIMT kernel's, on the CUDA route.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

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

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_tc": 0}

MAX_HEAD_DIM = 256
MAX_GRID_YZ = 65535  # H and B ride grid y and z
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on the H100
TC_KEY_ROWS = 64  # key rows of a K / V tile of the tensor-core kernel
TC_Q_ROWS = (64, 128)  # one or two consumer warpgroups a block
_c_void_p, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_c_void_p] * 4 + [_c_int] * 6 + [_c_ll] * 9 + [_c_int, _c_int, _c_ll, ctypes.c_float]
_SIGNATURES = {
    "repro_flash_attention": _ARGS + [_c_void_p],
    "repro_flash_attention_tc": _ARGS + [_c_int, _c_int, _c_void_p],
}
DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from repro_torch.kernels import build

    return build.load("flash_attention", _SIGNATURES)


def tc_q_rows(Sq: int) -> int:
    """The tensor-core kernel's query rows a block: one warpgroup (64) when
    the query fits one tile, else two (128), which read each K/V tile once
    for twice the rows."""
    return 64 if Sq <= 64 else 128


def tc_prefetch(hd: int, q_rows: int) -> int:
    """Key tiles the tensor-core kernel's copies run ahead of its products
    (``tc::prefetch``): 2 where that fits a block's shared memory, else 1."""
    return 2 if _tc_smem(hd, q_rows, 2) <= SMEM_LIMIT else 1


def tc_smem_bytes(hd: int, q_rows: int) -> int:
    """Dynamic shared memory of the tensor-core kernel (``tc::smem_bytes``):
    the bf16 Q tile (q_rows x hdp), D + 1 stages of K tiles and D + 2 of V
    tiles (64 x hdp each) at prefetch distance D, hdp = hd rounded up to 16."""
    return _tc_smem(hd, q_rows, tc_prefetch(hd, q_rows))


def _tc_smem(hd: int, q_rows: int, d: int) -> int:
    hdp = -(-hd // 16) * 16
    return 2 * (q_rows + (2 * d + 3) * TC_KEY_ROWS) * hdp


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, hd)
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    *,
    q_rows: Optional[int] = None,
) -> torch.Tensor:
    """Softmax attention of ``q`` over ``k``/``v`` with unexpanded KV heads.

    ``window`` enables sliding-window masking (key j is live for query i
    when j > i + q_offset − window); ``q_offset`` is q[0]'s position
    relative to k[0]. ``q_rows`` (64 or 128) is the tensor-core kernel's
    query rows a block, by default :func:`tc_q_rows`. Returns (B, Sq, H, hd)
    in q's dtype.
    """
    if not _on_cuda(q):
        return _ref.flash_attention_plain(q, k, v, causal=causal, window=window,
                                          q_offset=q_offset)
    refuse_grad("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B,Sq,H,hd), k = v (B,Skv,KV,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV < 1 or H % KV:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q, k, v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if not 1 <= hd <= MAX_HEAD_DIM or B > MAX_GRID_YZ or H > MAX_GRID_YZ:
        raise ValueError(f"flash_attention takes hd <= {MAX_HEAD_DIM} and B, H <= "
                         f"{MAX_GRID_YZ}, got hd={hd}, B={B}, H={H}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    q_rows = tc_q_rows(Sq) if q_rows is None else q_rows
    if q_rows not in TC_Q_ROWS:
        raise ValueError(f"q_rows must be one of {TC_Q_ROWS}, got {q_rows}")
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if not out.numel():
        return out
    args = (_ptr(q), _ptr(k), _ptr(v), _ptr(out), B, H, KV, Sq, Skv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), 0 if window is None else int(window), int(q_offset),
            1.0 / math.sqrt(hd))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16:
        err = _lib().repro_flash_attention_tc(
            *args, q_rows, int(tc_vector_loads(q, k, v)), stream)
        _raise_on(err, "flash_attention (tensor cores)")
        LAUNCHES["flash_attention_tc"] += 1
    else:
        err = _lib().repro_flash_attention(*args, stream)
        _raise_on(err, "flash_attention")
        LAUNCHES["flash_attention"] += 1
    return out
