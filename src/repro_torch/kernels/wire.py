"""Fused wire kernels of the federated round: CUDA on the card, plain on the CPU.

The three kernels of the ``wire="fused"`` path, hand-written in CUDA C++
for Hopper (``repro_torch/csrc/wire.cu``, ``csrc/newton_schulz.cu``),
replacing the Pallas kernels of ``repro/kernels/wire.py``:

  * :func:`fused_upload` (replaces ``wire.py:137 fused_upload``) — per
    silo row: delta from the reference, L2 clip, DP noise, reference
    added back, participation-mask select, optional int8 quantization
    with one scale per row.
  * :func:`fused_combine` (replaces ``wire.py:242 fused_combine``) —
    weighted mean or trimmed mean over the silo axis, with an optional
    in-kernel int8 dequantize.
  * :func:`newton_schulz_step` (replaces ``wire.py:310
    newton_schulz_step``) — one Newton–Schulz iteration on a batch of
    (d, d) pairs.
  * :func:`sqrtm_newton_schulz_fused` (replaces ``wire.py:335``) — the
    full-covariance barycenter's square roots: the whole ``num_iters``-step
    root of each matrix in one launch for d up to ``NS_ROOT_MAX_D``, the
    step kernel ``num_iters`` times above it.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes
the plain version in :mod:`repro_torch.kernels.ref`; a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts wrapper calls that
launch, on the CUDA route only (one per upload, whose one to three
launches are one call; one per Newton–Schulz step, whose two launches
are one call), so a run can show that its main path went through the
kernels.

The DP noise is an input: a ``(J, P)`` float32 N(0, I) tensor (the
reference draws threefry noise in-kernel from per-row keys).
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ref as _ref

LAUNCHES: Dict[str, int] = {"fused_upload": 0, "fused_combine": 0, "newton_schulz_step": 0,
                            "sqrtm_newton_schulz": 0}

MAX_TRIM_ROWS = 1024  # the staged trim's rank count is O(J^2) a column
COMBINE_THREADS = 256  # threads a combine block: a column each
DIRECT_ROWS = 16  # J up to this: the trim in registers (the mean takes passes of it)
COMBINE_TILES_PER_SM = 3  # the staged trim aims at this many tiles an SM
COMBINE_SMEM_BUDGET = 96 * 1024  # a staged block's shared memory: two fit an SM
SM_SMEM = 233_472  # shared memory of one H100 SM (228 KB), bytes
SM_THREADS = 2048  # resident threads of one H100 SM
MAX_UPLOAD_ROWS = 65535  # the upload's rows ride grid y
UPLOAD_THREADS = 256  # threads a block of the upload kernels
UPLOAD_BLOCKS_PER_SM = 4  # the plan aims at this many blocks an SM
H100_SMS = 132

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "repro_fused_upload": [_c_void_p] * 9 + [_c_int] * 6 + [_c_float, _c_float, _c_int,
                                                             _c_void_p],
    "repro_fused_combine_f32": [_c_void_p] * 3 + [_c_int] * 3 + [_c_float] + [_c_int] * 2
                               + [_c_void_p],
    "repro_fused_combine_i8": [_c_void_p] * 4 + [_c_int] * 3 + [_c_float] + [_c_int] * 2
                              + [_c_void_p],
}
_NS_SIGNATURES = {"repro_newton_schulz_step": [_c_void_p] * 5 + [_c_int, _c_int, _c_void_p],
                  "repro_sqrtm_newton_schulz": [_c_void_p] * 2 + [_c_int] * 3 + [_c_void_p]}
MAX_NS_BATCH = 32767  # grid z of the step's second launch is 2B <= 65535
SMEM_LIMIT = 232_448  # shared memory a block of the H100 can use, in bytes
# The largest d whose square root is one launch of the root kernel (one
# block a matrix, one thread an output). Past it one SM a matrix takes
# longer on the card than the step route's num_iters multi-block launches
# (PERF.md, kernel table), and no path of the port has such a d.
NS_ROOT_MAX_D = 32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from repro_torch.kernels import build

    return build.load("wire", _SIGNATURES)


def _ns_lib():
    from repro_torch.kernels import build

    return build.load("newton_schulz", _NS_SIGNATURES)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed to launch: cudaError_t {err}")


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last axis is contiguous, else a contiguous copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def tc_vector_loads(*tensors: torch.Tensor) -> bool:
    """True when a tensor-core kernel may copy 16-byte pieces of these bf16
    (B, S, H, d) tensors: d % 8 == 0 and every (batch, seq, head) row start
    16-byte aligned."""
    for t in tensors:
        if t.shape[-1] % 8 or t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            return False
    return True


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"the port's kernels run on cuda or cpu, got {x.device}")
    return True


def _upload_plan(J: int, P: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """``(C, chunk)``: the upload kernel's grid splits each of the J rows into
    C column chunks of ``chunk`` floats (the last one ragged).

    ``chunk`` is a multiple of 4 floats (so chunk starts keep the row's
    16-byte alignment) and at least one float4 a thread; C aims at
    ``UPLOAD_BLOCKS_PER_SM`` blocks on each of the card's ``sms`` SMs. The
    kernel's partial-sum scratch is ``(J, C)`` f32.
    """
    per_row = max(1, -(-UPLOAD_BLOCKS_PER_SM * sms // max(J, 1)))
    chunk = -(-P // per_row)
    chunk = max(4 * UPLOAD_THREADS, -(-chunk // 4) * 4)
    return max(1, -(-P // chunk)), chunk


def _upload_vec(P: int, tensors) -> int:
    """Floats a load of the upload kernel moves: 4 when P % 4 == 0, 2 when
    P % 2 == 0, else 1, cut to what every tensor's address allows."""
    for vec in (4, 2):
        if P % vec == 0 and all(t.data_ptr() % (4 * vec) == 0 for t in tensors):
            return vec
    return 1


class CombinePlan(NamedTuple):
    tile_cols: int  # columns a block takes a step: a column a thread
    tiles: int  # ceil(P / tile_cols)
    grid: int  # blocks, striding over the tiles
    smem_bytes: int  # the staged trim's shared memory a block; 0 for the direct routes


def trim_smem_bytes(J: int, tile_cols: int, elt: int) -> int:
    """The staged trim's shared memory (``trim_smem`` in the source): n and
    k in 16 bytes, the J scales and active-row indices, 16-byte aligned;
    then J staged rows of ``tile_cols + 16 / elt`` elements (a row sits at
    its address's offset within 16 bytes)."""
    return -(-(16 + 8 * J) // 16) * 16 + J * (tile_cols + 16 // elt) * elt


def combine_plan(J: int, P: int, elt: int, trimmed: bool, sms: int = H100_SMS) -> CombinePlan:
    """The combine kernels' launch plan for a (J, P) matrix of ``elt``-byte
    elements (4: f32, 1: int8).

    The direct routes (the mean, and the trim for J up to
    ``DIRECT_ROWS``): ``COMBINE_THREADS``-thread blocks, a column a thread,
    no shared memory. The staged trim (larger J): tiles of a multiple of 16
    columns, at most one a thread, aiming at ``COMBINE_TILES_PER_SM`` tiles
    on each of the card's ``sms`` SMs and narrowed until the block's shared
    memory fits ``COMBINE_SMEM_BUDGET``. Either grid is the tiles, capped at
    the blocks the SMs hold at once (by threads and shared memory).
    """
    if not trimmed or J <= DIRECT_ROWS:
        tiles = -(-P // COMBINE_THREADS)
        return CombinePlan(COMBINE_THREADS, tiles,
                           max(1, min(tiles, sms * (SM_THREADS // COMBINE_THREADS))), 0)
    aim = -(-P // (sms * COMBINE_TILES_PER_SM))
    tile_cols = min(COMBINE_THREADS, max(16, -(-aim // 16) * 16))
    while tile_cols > 16 and trim_smem_bytes(J, tile_cols, elt) > COMBINE_SMEM_BUDGET:
        tile_cols -= 16
    smem = trim_smem_bytes(J, tile_cols, elt)
    tiles = -(-P // tile_cols)
    per_sm = min(SM_THREADS // COMBINE_THREADS, SM_SMEM // (smem + 1024))
    return CombinePlan(tile_cols, tiles, max(1, min(tiles, sms * per_sm)), smem)


def fused_upload(
    x: torch.Tensor,  # (J, P) stacked wire matrix, one row per silo
    *,
    mask: torch.Tensor,  # (J,) participation mask (0/1)
    noise: Optional[torch.Tensor] = None,  # (J, P) N(0, I) draws
    reference: Optional[torch.Tensor] = None,  # (P,) broadcast row (SFVI-Avg)
    clip_norm: Optional[float] = None,
    noise_multiplier: float = 0.0,
    quantize: bool = False,
):
    """Fused clip + noise + mask + int8 quantize over the wire matrix.

    Returns the privatized (J, P) float32 matrix, or ``(q, scales)``
    ((J, P) int8 + (J,) float32) when ``quantize``. On the card one call
    is one launch (SFVI, SFVI-Avg), two (clip, or int8 alone) or three
    (clip + int8) of the row-split kernels; ``LAUNCHES["fused_upload"]``
    counts calls, as ``newton_schulz_step`` counts step calls.
    """
    if noise_multiplier > 0.0 and clip_norm is None:
        raise ValueError("noise_multiplier > 0 requires clip_norm")
    if noise_multiplier > 0.0 and noise is None:
        raise ValueError("noise_multiplier > 0 requires the (J, P) noise draw")
    if not _on_cuda(x):
        return _ref.wire_upload_ref(
            x, mask=mask, noise=noise, reference=reference, clip_norm=clip_norm,
            noise_multiplier=noise_multiplier, quantize=quantize)

    J, P = x.shape
    dev = x.device
    _check(x, "x", torch.float32, (J, P), dev)
    _check(mask, "mask", torch.float32, (J,), dev)
    has_noise = noise_multiplier > 0.0
    if has_noise:
        _check(noise, "noise", torch.float32, (J, P), dev)
    if reference is not None:
        _check(reference, "reference", torch.float32, (P,), dev)
    if J > MAX_UPLOAD_ROWS:
        raise ValueError(f"the upload kernel takes J <= {MAX_UPLOAD_ROWS}, got {J}")
    y = torch.empty((J, P), dtype=torch.float32, device=dev)
    q = torch.empty((J, P), dtype=torch.int8, device=dev) if quantize else None
    scales = torch.empty((J,), dtype=torch.float32, device=dev) if quantize else None
    if J and P:
        clip = clip_norm is not None
        C, chunk = _upload_plan(J, P, torch.cuda.get_device_properties(dev).multi_processor_count)
        norm_parts = torch.empty((J, C), dtype=torch.float32, device=dev) if clip else None
        max_parts = torch.empty((J, C), dtype=torch.float32, device=dev) if quantize else None
        vec = _upload_vec(P, [t for t in (x, noise if has_noise else None, reference, y, q)
                              if t is not None])
        err = _lib().repro_fused_upload(
            _ptr(x), _ptr(mask), _ptr(noise) if has_noise else None, _ptr(reference),
            _ptr(y), _ptr(q), _ptr(scales), _ptr(norm_parts), _ptr(max_parts),
            J, P, C, chunk, vec, int(clip),
            float(clip_norm) if clip else 0.0,
            float(noise_multiplier) * float(clip_norm) if has_noise else 0.0,
            int(quantize), torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "fused_upload")
        LAUNCHES["fused_upload"] += 1
    return (q, scales) if quantize else y


def fused_combine(
    x: torch.Tensor,  # (J, P) gathered wire matrix (f32, or int8 with scales)
    weights: torch.Tensor,  # (J,) aggregation weights (0/1 or fractional)
    *,
    scales: Optional[torch.Tensor] = None,  # (J,) int8 scales -> fused dequant
    trim_frac: Optional[float] = None,
) -> torch.Tensor:
    """Fused masked/weighted (trimmed-)mean over the silo axis -> (P,) f32.

    On the card one launch of the combine kernel, planned by
    :func:`combine_plan`; any P and any element offset of ``x``."""
    dequant = scales is not None
    if dequant and x.dtype != torch.int8:
        raise ValueError(f"scales given but payload dtype is {x.dtype}")
    if not _on_cuda(x):
        mat = _ref.int8_rows_dequant_ref(x, scales) if dequant else x
        if trim_frac is None:
            return _ref.masked_weighted_mean_ref(mat, weights)
        return _ref.masked_trimmed_mean_ref(mat, weights, trim_frac)

    J, P = x.shape
    dev = x.device
    _check(x, "x", torch.int8 if dequant else torch.float32, (J, P), dev)
    _check(weights, "weights", torch.float32, (J,), dev)
    if dequant:
        _check(scales, "scales", torch.float32, (J,), dev)
    trimmed = trim_frac is not None
    if trimmed and J > MAX_TRIM_ROWS:
        raise ValueError(
            f"the trimmed combine kernel supports J <= {MAX_TRIM_ROWS}, got {J}")
    out = torch.empty((P,), dtype=torch.float32, device=dev)
    if J and P:
        stream = torch.cuda.current_stream(dev).cuda_stream
        tf = float(trim_frac) if trimmed else 0.0
        plan = combine_plan(J, P, x.element_size(), trimmed,
                            torch.cuda.get_device_properties(dev).multi_processor_count)
        tail = (J, P, int(trimmed), tf, plan.tile_cols, plan.grid, stream)
        if dequant:
            err = _lib().repro_fused_combine_i8(_ptr(x), _ptr(scales), _ptr(weights), _ptr(out),
                                                *tail)
        else:
            err = _lib().repro_fused_combine_f32(_ptr(x), _ptr(weights), _ptr(out), *tail)
        _raise_on(err, "fused_combine")
        LAUNCHES["fused_combine"] += 1
    return out


def newton_schulz_step(y: torch.Tensor, z: torch.Tensor):
    """One fused Newton–Schulz step on (B, d, d) float32 pairs:
    ``t = 0.5 (3I − z y)``; returns ``(y t, t z)`` as new tensors."""
    if not _on_cuda(y):
        return _ref.newton_schulz_step_ref(y, z)
    if y.dim() != 3:
        raise ValueError(f"y must be (B, d, d), got shape {tuple(y.shape)}")
    B, d, _ = y.shape
    dev = y.device
    _check(y, "y", torch.float32, (B, d, d), dev)
    _check(z, "z", torch.float32, (B, d, d), dev)
    if B > MAX_NS_BATCH:
        raise ValueError(f"the Newton–Schulz kernel takes B <= {MAX_NS_BATCH}, got {B}")
    t, yo, zo = (torch.empty((B, d, d), dtype=torch.float32, device=dev) for _ in range(3))
    if B and d:
        err = _ns_lib().repro_newton_schulz_step(
            _ptr(y), _ptr(z), _ptr(t), _ptr(yo), _ptr(zo), B, d,
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "newton_schulz_step")
        LAUNCHES["newton_schulz_step"] += 1
    return yo, zo


def ns_root_smem_bytes(d: int) -> int:
    """The root kernel's shared memory at d: y, z (two buffers each) and t,
    plus 32 floats for the norm (``root_smem_bytes`` in the source)."""
    return 4 * (5 * d * d + 32)


def sqrtm_newton_schulz_fused(mat: torch.Tensor, num_iters: int = 25) -> torch.Tensor:
    """PSD square root of each (d, d) matrix of ``mat`` by Newton–Schulz.

    Drop-in for :func:`repro_torch.core.barycenter.sqrtm_newton_schulz`
    (``wire.py:335``): per matrix, Frobenius-normalize, start from
    ``z = I``, run ``num_iters`` steps, rescale by √norm. ``mat`` is
    (d, d) or carries leading batch axes (the reference vmaps its kernel).

    A CPU tensor takes the plain version around :func:`newton_schulz_step`.
    On the card, d up to ``NS_ROOT_MAX_D`` is one launch of the root kernel
    for the whole batch (:func:`_sqrtm_root`); a larger d takes
    ``num_iters`` calls of the step kernel in plain torch: an explicit
    choice by shape.
    """
    if not _on_cuda(mat) or mat.shape[-1] > NS_ROOT_MAX_D:
        return _ref.newton_schulz_sqrtm_ref(mat, num_iters, step=newton_schulz_step)
    return _sqrtm_root(mat, num_iters)


def _sqrtm_root(mat: torch.Tensor, num_iters: int) -> torch.Tensor:
    """One launch of the root kernel on a CUDA (..., d, d) float32 ``mat``,
    d <= ``NS_ROOT_MAX_D``; counted under ``LAUNCHES["sqrtm_newton_schulz"]``."""
    if mat.dim() < 2 or mat.shape[-2] != mat.shape[-1]:
        raise ValueError(f"mat must be (..., d, d), got shape {tuple(mat.shape)}")
    if mat.dtype != torch.float32:
        raise ValueError(f"the Newton–Schulz root takes float32, got {mat.dtype}")
    if num_iters < 0:
        raise ValueError(f"num_iters must be >= 0, got {num_iters}")
    d = mat.shape[-1]
    if d > NS_ROOT_MAX_D:
        raise ValueError(f"the root kernel takes d <= {NS_ROOT_MAX_D}, got {d}")
    m = mat.reshape(-1, d, d).contiguous()
    out = torch.empty_like(m)
    if m.numel():
        err = _ns_lib().repro_sqrtm_newton_schulz(
            _ptr(m), _ptr(out), m.shape[0], d, int(num_iters),
            torch.cuda.current_stream(mat.device).cuda_stream)
        _raise_on(err, "sqrtm_newton_schulz")
        LAUNCHES["sqrtm_newton_schulz"] += 1
    return out.reshape(mat.shape)
