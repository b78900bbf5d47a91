"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``wire`` holds the fused wire kernels' wrappers (upload, combine, the
Newton–Schulz step), ``reparam`` the reparam + STL forward/backward
``autograd.Function``, ``ref`` their plain versions, ``build`` the
nvcc/ctypes loader. Nothing is compiled at import time.
"""
