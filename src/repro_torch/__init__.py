"""PyTorch/CUDA port of ``repro``: the hierarchical-BNN federation on an H100.

A second package beside the JAX reference (``src/repro``). It imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of ``repro`` —
and mirrors the reference layout module for module. The fused wire's
two kernels are hand-written CUDA (``csrc/wire.cu``), built with
``nvcc`` at their first launch; on a CPU tensor each wrapper takes its
plain PyTorch version (``kernels/ref.py``).

Entry points (``federated.runtime.Server``, ``federated.run``, the
registry builders) run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
__all__ = ["__version__"]

__version__ = "0.1.0"
