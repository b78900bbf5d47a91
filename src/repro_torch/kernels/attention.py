"""Flash attention: CUDA on the card, plain on the CPU.

Replaces ``repro/kernels/attention.py:98 flash_attention_bhsd`` (body
``_flash_kernel`` ``:28``; wrapper ``repro/kernels/ops.py:41
flash_attention``) with a hand-written CUDA kernel for Hopper
(``repro_torch/csrc/flash_attention.cu``): online-softmax attention with
GQA by indexing (kv head = h // (H/KV)), causal and sliding-window masks
with dead-tile skip, ``q_offset``, and f32 scores, running max,
normalizer and accumulator.

The kernel reads the model's (B, S, H, hd) layout through strides and
masks ragged ends itself, so this wrapper makes no transposed or padded
copies (a copy only when a last axis is not contiguous). A CPU tensor
takes the plain version (:func:`repro_torch.kernels.ref.flash_attention_plain`);
a CUDA tensor launches the kernel or raises. ``LAUNCHES["flash_attention"]``
counts kernel launches on the CUDA route.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.wire import _on_cuda, _ptr, _raise_on, _unit_last

LAUNCHES: Dict[str, int] = {"flash_attention": 0}

MAX_HEAD_DIM = 256
MAX_GRID_YZ = 65535  # H and B ride grid y and z
_c_void_p, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_flash_attention": [_c_void_p] * 4 + [_c_int] * 6 + [_c_ll] * 9
    + [_c_int, _c_int, _c_ll, ctypes.c_float, _c_int, _c_void_p],
}
DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from repro_torch.kernels import build

    return build.load("flash_attention", _SIGNATURES)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, hd)
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Softmax attention of ``q`` over ``k``/``v`` with unexpanded KV heads.

    ``window`` enables sliding-window masking (key j is live for query i
    when j > i + q_offset − window); ``q_offset`` is q[0]'s position
    relative to k[0]. Returns (B, Sq, H, hd) in q's dtype.
    """
    if not _on_cuda(q):
        return _ref.flash_attention_plain(q, k, v, causal=causal, window=window,
                                          q_offset=q_offset)
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
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if out.numel():
        err = _lib().repro_flash_attention(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), B, H, KV, Sq, Skv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), 0 if window is None else int(window), int(q_offset),
            1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
        _raise_on(err, "flash_attention")
        LAUNCHES["flash_attention"] += 1
    return out
