"""Carry reference state and data across to the port.

``from_jax_state`` takes the JAX ``Server.state`` pulled to numpy
(``theta``, ``eta_G``, stacked ``eta_L``, ``opt_server``,
``opt_local``; optionally ``strategy``) and rebuilds it as the port's
state on ``device``: dicts keep their keys, tuples stay tuples, and a
reference optimizer NamedTuple becomes the port's class of the same
name (``ScaleByAdamState``, ...). The two packages keep one state
layout, so this is a leaf-by-leaf copy. ``datas_from_numpy`` does the
same for silo data dicts. ``backbone_params_from_jax`` copies a JAX
backbone parameter tree (pulled to numpy) into the port's layout, which
is the same nested dict.

Nothing here imports the reference: the input is plain numpy.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.optim.adam import AdamWState, ScaleByAdamState
from repro_torch.optim.base import ScaleByScheduleState
from repro_torch.optim.sgd import MomentumState

_STATE_CLASSES = {cls.__name__: cls for cls in (
    ScaleByAdamState, AdamWState, MomentumState, ScaleByScheduleState)}

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
    """Numpy silo dicts -> tensors on ``device``, every key converted.

    The label key ``y`` becomes int64, the index type ``torch.gather``
    takes; every other key (``x``, hetero_mn's 0/1 row weights ``w``,
    ProdLDA's word ``counts``) becomes float32. Counts below 2^24 are exact
    in float32, and the reference casts them to the log-prob dtype anyway.
    """
    device = torch.device(device)
    return [{
        k: torch.as_tensor(np.array(v, dtype=np.int64 if k == "y" else np.float32),
                           device=device)
        for k, v in d.items()
    } for d in datas]


def _leaf_to_torch(x: Any, device: torch.device) -> torch.Tensor:
    """One numpy leaf -> a tensor, bit for bit. JAX's bf16 arrives as the
    ``ml_dtypes`` bfloat16 numpy dtype, which torch does not take: it is
    viewed as int16 and then as ``torch.bfloat16``."""
    arr = np.array(x, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.as_tensor(arr, device=device)


def backbone_params_from_jax(params_np: Dict[str, Any], device) -> Dict[str, Any]:
    """A JAX backbone parameter tree (nested dicts of numpy arrays: stacked
    ``units/slotS``, ``tail``, ``shared_attn``, ``embed``, ``final_norm``,
    ``lm_head``) -> the same tree of tensors on ``device``."""
    device = torch.device(device)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return _leaf_to_torch(x, device)

    return walk(params_np)
