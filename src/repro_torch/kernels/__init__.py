"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``wire`` holds the fused wire kernels' wrappers, ``ref`` their plain
versions, ``build`` the nvcc/ctypes loader. Nothing is compiled at
import time.
"""
