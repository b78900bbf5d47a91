"""Chunkwise gated linear attention: CUDA on the card, plain on the CPU.

Replaces ``repro/kernels/gla.py:73 gla_bhsd`` (body ``_gla_kernel``
``:30``; wrapper ``repro/kernels/ops.py:132 gla``) with a hand-written
CUDA kernel for Hopper (``repro_torch/csrc/gla.cu``): the Mamba2-SSD /
mLSTM recurrence S_t = e^{a_t} S_{t−1} + k_t v_tᵀ, y_t = q_t·S_t,
computed 64 steps a chunk with the (dk, dv) state in f32.

The kernel reads (B, S, H, ·) tensors through their strides, so mamba2's
q and k (one group expanded over the heads, head stride 0) are never
materialized, and masks the ragged tail as identity steps. A CPU tensor
takes the plain version (:func:`repro_torch.kernels.ref.gla_plain`); a
CUDA tensor launches the kernel or raises. ``LAUNCHES["gla"]`` counts
kernel launches on the CUDA route.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.wire import _on_cuda, _ptr, _raise_on, _unit_last

LAUNCHES: Dict[str, int] = {"gla": 0}

CHUNK = 64  # the kernel's chunk length (csrc/gla.cu kC)
MAX_DIM = 128  # dk and dv
_c_void_p, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_gla": [_c_void_p] * 5 + [_c_int] * 5 + [_c_ll] * 12 + [_c_int, _c_void_p],
}
DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from repro_torch.kernels import build

    return build.load("gla", _SIGNATURES)


def gla(
    q: torch.Tensor,  # (B, S, H, dk)
    k: torch.Tensor,  # (B, S, H, dk)
    v: torch.Tensor,  # (B, S, H, dv)
    log_a: torch.Tensor,  # (B, S, H) per-step log decay (<= 0)
) -> torch.Tensor:
    """Gated linear attention; returns (B, S, H, dv) in q's dtype.

    On the card q, k, v are f32 or bf16 of one dtype; log_a is taken in
    f32 (converted if it is not). Any of them may be a strided view.
    """
    if not _on_cuda(q):
        return _ref.gla_plain(q, k, v, log_a, chunk=CHUNK)
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
    if not (1 <= dk <= MAX_DIM and 1 <= dv <= MAX_DIM):
        raise ValueError(f"gla takes dk, dv <= {MAX_DIM}, got {dk}, {dv}")
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    a = log_a.float()
    out = torch.empty((B, S, H, dv), dtype=q.dtype, device=q.device)
    if out.numel():
        err = _lib().repro_gla(
            _ptr(q), _ptr(k), _ptr(v), _ptr(a), _ptr(out), B, S, H, dk, dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *a.stride(),
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
        _raise_on(err, "gla")
        LAUNCHES["gla"] += 1
    return out
