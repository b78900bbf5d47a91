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

The launch plan (:func:`_rmsnorm_plan`) is computed here: 16-byte vectors
or single elements, the lanes that own a row and the vectors each holds in
registers, the rows a 256-thread block takes a step, and a grid of the
card's SMs times the blocks an SM keeps resident (each block holds the
weight in its shared memory). The card's plan is cached by shape, types,
alignment and device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.wire import H100_SMS, _on_cuda, _ptr, _raise_on

LAUNCHES: Dict[str, int] = {"rmsnorm": 0}

_c_int = ctypes.c_int
_SIGNATURES = {
    "repro_rmsnorm": [ctypes.c_void_p] * 3 + [ctypes.c_longlong, _c_int, ctypes.c_float]
                     + [_c_int] * 6 + [ctypes.c_void_p],
    "repro_rmsnorm_blocks_per_sm": [_c_int] * 5 + [ctypes.POINTER(_c_int)],
}
DTYPES = (torch.float32, torch.bfloat16)

THREADS = 256  # every block of the kernel
NARROW_VECS = 64  # rows of at most this many vectors: about 4 vectors a lane
LANE_VECS = {True: 4, False: 8}  # vectors a lane aims at: narrow rows, wider rows
MAX_VECS = {True: 16, False: 32}  # register slots a lane: 16-byte vectors, scalars
BLOCKS_PER_SM = 2  # the plan's default; on the card, the kernel's occupancy


class RmsPlan(NamedTuple):
    vec: int  # elements of x a load moves: 16 bytes' worth, or 1 (scalar route)
    lanes: int  # lanes owning a row (a power of two <= THREADS)
    vpl: int  # vectors a lane holds: lanes * vpl * vec >= D
    rows_per_block: int  # rows a block takes each step: THREADS // lanes
    grid: int  # blocks striding over the rows


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _rmsnorm_plan(rows: int, D: int, x: torch.Tensor, w: torch.Tensor, sms: int = H100_SMS,
                  blocks_per_sm: Optional[Callable[[bool, int], int]] = None) -> RmsPlan:
    """The launch plan for ``rows`` rows of ``D`` of ``x`` (rows, D) and ``w`` (D,).

    16-byte vectors when D is a multiple of 16 bytes of x and both base
    addresses are 16-byte aligned (the output comes from ``torch.empty``,
    which is), else the scalar route: an explicit choice by shape and
    alignment. A row takes the power of two of lanes (at most the block)
    that gives each lane about ``LANE_VECS`` vectors: 4 for rows of at most
    ``NARROW_VECS`` vectors (qk-norm's D = 128 in bf16: 4 lanes, 8 rows a
    warp), so that a warp keeps several loads a lane in flight, 8 for wider
    rows (zamba2's D = 3,584 in bf16: 64 lanes, two warps). Raises when a
    lane would hold more than ``MAX_VECS``. The
    grid is at most ``sms`` times the resident blocks an SM of the kernel
    chosen, ``blocks_per_sm(vector route, vpl)`` (``BLOCKS_PER_SM`` if None).
    """
    aligned = not (x.data_ptr() % 16 or w.data_ptr() % 16)
    return _plan(rows, D, x.element_size(), aligned, sms, blocks_per_sm)


def _plan(rows: int, D: int, elt: int, aligned: bool, sms: int,
          blocks_per_sm: Optional[Callable[[bool, int], int]]) -> RmsPlan:
    vec = 16 // elt
    if D % vec or not aligned:
        vec = 1
    nvec = D // vec
    per_lane = LANE_VECS[nvec <= NARROW_VECS]
    lanes = min(THREADS, _pow2_at_least(-(-nvec // per_lane)))
    vpl = -(-nvec // lanes)
    if vpl > MAX_VECS[vec > 1]:
        raise ValueError(f"rmsnorm takes rows of at most {THREADS * MAX_VECS[vec > 1] * vec} "
                         f"elements on this route, got D={D}")
    rows_per_block = THREADS // lanes
    per_sm = BLOCKS_PER_SM if blocks_per_sm is None else blocks_per_sm(vec > 1, vpl)
    grid = max(1, min(-(-rows // rows_per_block), sms * per_sm))
    return RmsPlan(vec, lanes, vpl, rows_per_block, grid)


@functools.lru_cache(maxsize=1024)
def _card_plan(rows: int, D: int, x_bf16: int, w_bf16: int, aligned: bool,
               device: int) -> RmsPlan:
    """The plan on card ``device``: its SM count and the kernel's occupancy
    there. Cached, since the serve path asks for the same few shapes at
    every layer of every step."""
    return _plan(rows, D, 2 if x_bf16 else 4, aligned,
                 torch.cuda.get_device_properties(device).multi_processor_count,
                 lambda vector, vpl: _blocks_per_sm(x_bf16, w_bf16, vector, vpl, D))


def _blocks_per_sm(x_bf16: int, w_bf16: int, vector: bool, vpl: int, D: int) -> int:
    """Resident blocks an SM of the kernel that serves this route, with the
    weight's D elements in its shared memory."""
    n = _c_int(0)
    _raise_on(_lib().repro_rmsnorm_blocks_per_sm(x_bf16, w_bf16, int(vector), vpl, D,
                                                 ctypes.byref(n)), "rmsnorm occupancy")
    return max(1, n.value)


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
        x_bf16, w_bf16 = int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16)
        plan = _card_plan(rows.shape[0], D, x_bf16, w_bf16,
                          not (rows.data_ptr() % 16 or w.data_ptr() % 16), rows.device.index)
        err = _lib().repro_rmsnorm(
            _ptr(rows), _ptr(w), _ptr(out), rows.shape[0], D, float(eps), x_bf16, w_bf16,
            int(plan.vec > 1), plan.lanes, plan.vpl, plan.grid,
            torch.cuda.current_stream(x.device).cuda_stream)
        _raise_on(err, "rmsnorm")
        LAUNCHES["rmsnorm"] += 1
    return out.reshape(x.shape)
