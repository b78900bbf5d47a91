"""Device resolution and seeded generators for the port's entry points.

Entry points (``Server``, the CLI, the registry builders) run on the card
unless the caller asks for the CPU: ``resolve_device(None)`` is
``cuda``, and it raises when CUDA is absent instead of carrying on on the
CPU.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises if a CUDA device is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run the port on the CPU")
    return dev


def mix_seed(parts: Sequence[int]) -> int:
    """One 63-bit seed from a tuple of ints (e.g. (seed, round, step))."""
    state = np.random.SeedSequence([int(p) for p in parts]).generate_state(2)
    return int((int(state[0]) << 31) ^ int(state[1])) & ((1 << 63) - 1)


def generator(seed: Union[int, Sequence[int]], device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``seed``."""
    parts = [seed] if isinstance(seed, int) else list(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(mix_seed(parts))
    return gen
