"""RMSNorm over the last axis: CUDA on the card, plain on the CPU.

Replaces ``repro/kernels/rmsnorm.py:23 rmsnorm_rows`` (body ``:17``;
wrapper ``repro/kernels/ops.py:91 rmsnorm``) with a hand-written CUDA
kernel for Hopper (``repro_torch/csrc/rmsnorm.cu``):

    out = ((x32 · rsqrt(mean(x32²) + eps)) · w32)  in x's dtype

Every RMSNorm of the port's backbone goes through :func:`rmsnorm`: the
blocks' pre-norms, the final norm, mamba2's gated ``out_norm`` and
qwen3's qk-norm. A CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.rmsnorm_plain`); a CUDA tensor launches
the kernel or raises. ``LAUNCHES["rmsnorm"]`` counts kernel launches on
the CUDA route.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.wire import _on_cuda, _ptr, _raise_on

LAUNCHES: Dict[str, int] = {"rmsnorm": 0}

_SIGNATURES = {
    "repro_rmsnorm": [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                              ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from repro_torch.kernels import build

    return build.load("rmsnorm", _SIGNATURES)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of ``x`` (..., D) with ``weight`` (D,); returns x's shape and dtype.

    On the card x and weight are f32 or bf16 (independently); the leading
    axes are flattened to rows (a copy only if x's rows are not contiguous).
    """
    if not _on_cuda(x):
        return _ref.rmsnorm_plain(x, weight, eps)
    D = x.shape[-1]
    if x.dtype not in DTYPES or weight.dtype not in DTYPES:
        raise ValueError(f"rmsnorm takes float32 or bfloat16, got {x.dtype} and {weight.dtype}")
    if weight.device != x.device or tuple(weight.shape) != (D,):
        raise ValueError(f"weight must be ({D},) on {x.device}, got {tuple(weight.shape)} "
                         f"on {weight.device}")
    rows = x.reshape(-1, D).contiguous()
    w = weight.contiguous()
    out = torch.empty_like(rows)
    if rows.numel():
        err = _lib().repro_rmsnorm(
            _ptr(rows), _ptr(w), _ptr(out), rows.shape[0], D, float(eps),
            int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
        _raise_on(err, "rmsnorm")
        LAUNCHES["rmsnorm"] += 1
    return out.reshape(x.shape)
