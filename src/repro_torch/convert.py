"""Carry reference state and data across to the port.

``from_jax_state`` takes the JAX ``Server.state`` pulled to numpy
(``theta``, ``eta_G``, stacked ``eta_L``, ``opt_server``,
``opt_local``; optionally ``strategy``) and rebuilds it as the port's
state on ``device``: dicts keep their keys, tuples stay tuples, and a
reference optimizer NamedTuple becomes the port's class of the same
name (``ScaleByAdamState``, ...). The two packages keep one state
layout, so this is a leaf-by-leaf copy. ``datas_from_numpy`` does the
same for silo data dicts.

Nothing here imports the reference: the input is plain numpy.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.optim.adam import AdamWState, ScaleByAdamState
from repro_torch.optim.sgd import MomentumState

_STATE_CLASSES = {cls.__name__: cls
                  for cls in (ScaleByAdamState, AdamWState, MomentumState)}

STATE_KEYS = ("theta", "eta_G", "eta_L", "opt_server", "opt_local")


def _convert(x: Any, device: torch.device) -> Any:
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _convert(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and getattr(type(x), "_fields", None) is not None:
        name = type(x).__name__
        if name not in _STATE_CLASSES:
            raise TypeError(f"no port counterpart for optimizer state {name!r}")
        return _STATE_CLASSES[name](*[_convert(v, device) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_convert(v, device) for v in x)
    return torch.as_tensor(np.array(x, copy=True), device=device)


def from_jax_state(state_np: Dict[str, Any], device) -> Dict[str, Any]:
    """The reference ``Server.state`` (as numpy) -> the port's state dict."""
    device = torch.device(device)
    out = {k: _convert(state_np[k], device) for k in STATE_KEYS}
    out["strategy"] = _convert(state_np.get("strategy", {}), device)
    return out


def datas_from_numpy(datas: Sequence[dict], device) -> List[dict]:
    """Numpy silo dicts (``x``, ``y``) -> tensors on ``device``.

    Labels become int64, the index type ``torch.gather`` takes.
    """
    device = torch.device(device)
    return [{
        "x": torch.as_tensor(np.array(d["x"], dtype=np.float32), device=device),
        "y": torch.as_tensor(np.array(d["y"], dtype=np.int64), device=device),
    } for d in datas]
