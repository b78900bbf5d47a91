"""Fused Gaussian reparametrization + STL log q: CUDA on the card, plain on the CPU.

Replaces ``repro/kernels/reparam.py:57 reparam_stl`` (forward kernel
``:30``, backward kernel ``:39``, custom VJP ``:81``) with hand-written
CUDA kernels for Hopper (``repro_torch/csrc/reparam.cu``):

    z    = mu + exp(log_sigma) * eps                 (mu's dtype)
    logq = Σ_i (−½ eps_i² − log_sigma_i − ½ log 2π)  (f32 scalar)

:func:`reparam_stl` is a ``torch.autograd.Function`` (``setup_context``
form, so ``torch.func.grad`` and ``vmap`` accept it on the CPU) whose
backward is the fused STL VJP

    dmu = dz;  dlog_sigma = dz·σ·eps − dlq;  deps = dz·σ − dlq·eps.

Forward and backward each dispatch by device: a CPU tensor takes the
plain version (:mod:`repro_torch.kernels.ref`), a CUDA tensor launches
the kernel or raises. ``LAUNCHES`` counts kernel calls on the CUDA
route (``reparam_stl_fwd``: one per forward, one launch that writes z and
logq; ``reparam_stl_bwd``: one per backward). The forward's launch is
planned by :func:`reparam_plan`; its block partials and the ticket that
finds the last block live in a scratch kept per (device, stream)
(:func:`_scratch`).

As in the JAX package, no round calls it: ``DiagGaussian.sample`` is
plain tensor code.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.wire import H100_SMS, _check, _on_cuda, _ptr, _raise_on

LAUNCHES: Dict[str, int] = {"reparam_stl_fwd": 0, "reparam_stl_bwd": 0}

_c_void_p, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_reparam_fwd": [_c_void_p] * 5 + [_c_int, _c_void_p, _c_ll] + [_c_int] * 3
                         + [_c_void_p],
    "repro_reparam_bwd": [_c_void_p] * 7 + [_c_ll, _c_int, _c_void_p],
}
_DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256  # threads a block of the forward kernel
BLOCKS_PER_SM = 2048 // THREADS  # resident blocks of an SM: the forward's largest grid a card
# The forward's scratch, per (device index, stream): word 0 the ticket
# counter (zero between calls), then one f32 partial a block.
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


class ReparamPlan(NamedTuple):
    vec: int  # elements a load moves: 16 bytes' worth, or 1 (the scalar route)
    grid: int  # blocks; each writes one partial


def reparam_plan(n: int, elt: int, aligned: bool, sms: int = H100_SMS) -> ReparamPlan:
    """The forward's launch plan for ``n`` elements of ``elt`` bytes.

    16-byte vectors when every pointer is 16-byte aligned (``aligned``),
    else one element a load: an explicit choice by alignment. One vector a
    thread of ``THREADS``-thread blocks, at most ``BLOCKS_PER_SM`` blocks
    on each of the ``sms`` SMs (a grid-stride loop past that); the
    ``n % vec`` elements after the last vector go one a thread to the
    first threads of the grid.
    """
    vec = 16 // elt if aligned else 1
    return ReparamPlan(vec, max(1, min(-(-(n // vec) // THREADS), sms * BLOCKS_PER_SM)))


def _aligned16(*tensors: torch.Tensor) -> bool:
    """True when every tensor's first element is 16-byte aligned."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _scratch(device: torch.device, stream: torch.cuda.Stream, sms: int) -> torch.Tensor:
    """The forward's scratch for calls on ``stream``: made and zeroed on its
    first call there, then reused (the kernel leaves the counter at zero).
    Calls on one stream run in turn; two streams never share a counter."""
    key = (device.index, stream.cuda_stream)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.zeros((1 + sms * BLOCKS_PER_SM,), dtype=torch.int32,
                                    device=device)
    return _SCRATCH[key]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from repro_torch.kernels import build

    return build.load("reparam", _SIGNATURES)


def _check_vectors(tensors: Dict[str, torch.Tensor]) -> tuple:
    """All (N,) contiguous, of one dtype (f32 or bf16), on one CUDA device."""
    first = next(iter(tensors.values()))
    if first.dim() != 1:
        raise ValueError(f"reparam_stl takes (N,) vectors, got shape {tuple(first.shape)}")
    if first.dtype not in _DTYPES:
        raise ValueError(f"reparam_stl takes float32 or bfloat16, got {first.dtype}")
    for name, t in tensors.items():
        _check(t, name, first.dtype, first.shape, first.device)
    return first.shape[0], first.dtype, first.device


def reparam_fwd(mu: torch.Tensor, log_sigma: torch.Tensor, eps: torch.Tensor,
                block: int = 4096):
    """The forward alone: ``(z, logq)``, no autograd. ``block`` is the JAX
    API's argument and must be >= 1; the CUDA route plans its own partials
    (:func:`reparam_plan`) and the CPU route ignores it."""
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    if not _on_cuda(mu):
        return _ref.reparam_stl_ref(mu, log_sigma, eps)
    n, dtype, dev = _check_vectors({"mu": mu, "log_sigma": log_sigma, "eps": eps})
    z = torch.empty((n,), dtype=dtype, device=dev)
    if not n:
        return z, torch.zeros((), dtype=torch.float32, device=dev)
    logq = torch.empty((), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = reparam_plan(n, mu.element_size(), _aligned16(mu, log_sigma, eps, z), sms)
    scratch = _scratch(dev, stream, sms)
    err = _lib().repro_reparam_fwd(
        _ptr(mu), _ptr(log_sigma), _ptr(eps), _ptr(z), _ptr(scratch), scratch.numel() - 1,
        _ptr(logq), n, plan.vec, plan.grid, int(dtype == torch.bfloat16), stream.cuda_stream)
    _raise_on(err, "reparam_stl forward")
    LAUNCHES["reparam_stl_fwd"] += 1
    return z, logq


def reparam_bwd(log_sigma: torch.Tensor, eps: torch.Tensor, dz: torch.Tensor,
                dlq: torch.Tensor):
    """The fused VJP alone: ``(dmu, dlog_sigma, deps)``."""
    if not _on_cuda(log_sigma):
        return _ref.reparam_stl_bwd_ref(log_sigma, eps, dz, dlq)
    n, dtype, dev = _check_vectors({"log_sigma": log_sigma, "eps": eps, "dz": dz})
    dlq = dlq.to(device=dev, dtype=torch.float32).reshape(()).contiguous()
    dmu, dls, deps = (torch.empty((n,), dtype=dtype, device=dev) for _ in range(3))
    if n:
        err = _lib().repro_reparam_bwd(
            _ptr(log_sigma), _ptr(eps), _ptr(dz), _ptr(dlq), _ptr(dmu), _ptr(dls),
            _ptr(deps), n, int(dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "reparam_stl backward")
        LAUNCHES["reparam_stl_bwd"] += 1
    return dmu, dls, deps


class _ReparamSTL(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(mu, log_sigma, eps, block):
        return reparam_fwd(mu, log_sigma, eps, block)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, log_sigma, eps, _ = inputs
        ctx.save_for_backward(log_sigma, eps)

    @staticmethod
    def backward(ctx, dz, dlq):
        log_sigma, eps = ctx.saved_tensors
        dmu, dls, deps = reparam_bwd(log_sigma, eps, dz.contiguous(), dlq)
        return dmu, dls, deps, None


def reparam_stl(mu: torch.Tensor, log_sigma: torch.Tensor, eps: torch.Tensor,
                block: int = 4096):
    """Fused z = μ + e^{log σ}·ε and STL log q, differentiable in all three.

    ``mu``, ``log_sigma``, ``eps``: (N,) vectors; returns ``(z, logq)`` with
    z (N,) in μ's dtype and logq an f32 scalar. ``block`` is the JAX
    kernel's block, checked to be >= 1: the CUDA route plans its own
    partials (:func:`reparam_plan`), and the CPU route ignores it.
    """
    return _ReparamSTL.apply(mu, log_sigma, eps, block)
