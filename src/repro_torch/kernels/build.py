"""Build and load the port's CUDA kernels (``nvcc`` + ``ctypes``).

Each source in ``repro_torch/csrc`` compiles on its own into a shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build>/lib<name>-<hash>.so csrc/<name>.cu

The build directory is ``build/kernels`` at the root of the checkout
(``REPRO_TORCH_BUILD_DIR`` overrides it); the library name carries a
hash of its source, so an edited source never loads a stale build.
Nothing is built when the package is imported: :func:`load` builds at
the first launch; :func:`build_all` compiles every source at once, one
``nvcc`` process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = {"wire": "wire.cu", "newton_schulz": "newton_schulz.cu", "reparam": "reparam.cu",
           "rmsnorm": "rmsnorm.cu", "flash_attention": "flash_attention.cu", "gla": "gla.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start compiling ``SOURCES[name]``: ``(out, tmp, proc)``, or None if built."""
    out = library_path(name)
    if out.exists():
        return None
    build_dir().mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, job) -> Path:
    out, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return out


def build(name: str) -> Path:
    """Compile ``SOURCES[name]`` unless its library is built already."""
    job = _start(name)
    return library_path(name) if job is None else _finish(name, job)


def build_all() -> Dict[str, Path]:
    """Compile every source in parallel; waits for all and raises on any failure."""
    jobs = {name: _start(name) for name in SOURCES}
    try:
        return {name: library_path(name) if job is None else _finish(name, job)
                for name, job in jobs.items()}
    finally:
        for job in jobs.values():
            if job is not None and job[2].poll() is None:
                job[2].kill()
                job[2].wait()


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed, with each
    entry of ``signatures`` (C function -> ctypes argtypes) declared to
    return an ``int`` error code."""
    if name not in _LOADED:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return _LOADED[name]
