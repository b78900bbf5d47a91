"""Pytree checkpoints in the reference's file format (``repro.checkpoint.io``).

A file is one msgpack map ``{b"treedef": <bin>, b"leaves": [leaf, ...]}``
with each leaf ``{b"k": 0, b"d": <dtype name>, b"s": [shape], b"b":
<raw bytes>}``, leaves in ``jax.tree_util``'s order (sorted dict keys, as
:mod:`repro_torch.tree` flattens). Every leaf record is byte for byte the
reference's; only the ``treedef`` text differs, and neither loader reads
it: both restore into the caller's template. So a checkpoint written by
either package loads in the other.

The port carries its own encoder and decoder for the msgpack subset this
format uses (maps, arrays, non-negative ints, str and bin) instead of
importing ``msgpack``. bfloat16 leaves travel as their 16-bit patterns.

Silo-private state (η_{L_j}, local optimizer moments, strategy sites) is
saved per silo into separate shard files, so the server checkpoint never
holds local variational parameters.
"""
from __future__ import annotations

import os
import struct
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_unflatten

PyTree = Any

_KIND_ARRAY = 0


# ---------------------------------------------------------------------------
# The msgpack subset
# ---------------------------------------------------------------------------


def _pack_header(out: bytearray, n: int, fix: Optional[Tuple[int, int]],
                 wide: Tuple[Tuple[int, int, str], ...]) -> None:
    """A length header: the fix form (``base``, limit) if it fits, else the
    first of ``wide`` ((marker, limit, struct format)) that does."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for marker, limit, fmt in wide:
        if n < limit:
            out.append(marker)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} too large for msgpack")


def _pack(obj: Any, out: bytearray) -> None:
    if isinstance(obj, dict):
        _pack_header(out, len(obj), (0x80, 16), ((0xDE, 1 << 16, ">H"), (0xDF, 1 << 32, ">I")))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_header(out, len(obj), (0x90, 16), ((0xDC, 1 << 16, ">H"), (0xDD, 1 << 32, ">I")))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, bool):
        raise TypeError("bool is not in the checkpoint format")
    elif isinstance(obj, int):
        if obj < 0:
            raise ValueError("negative ints are not in the checkpoint format")
        _pack_header(out, obj, (0x00, 128), ((0xCC, 1 << 8, ">B"), (0xCD, 1 << 16, ">H"),
                                             (0xCE, 1 << 32, ">I"), (0xCF, 1 << 64, ">Q")))
    elif isinstance(obj, str):
        raw = obj.encode()
        _pack_header(out, len(raw), (0xA0, 32), ((0xD9, 1 << 8, ">B"), (0xDA, 1 << 16, ">H"),
                                                 (0xDB, 1 << 32, ">I")))
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _pack_header(out, len(obj), None, ((0xC4, 1 << 8, ">B"), (0xC5, 1 << 16, ">H"),
                                           (0xC6, 1 << 32, ">I")))
        out += obj
    else:
        raise TypeError(f"{type(obj).__name__} is not in the checkpoint format")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj)`` for the subset the checkpoint format uses."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# (marker, struct format) of the sized forms, by kind.
_SIZED = {
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"), 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xCC: ("int", ">B"), 0xCD: ("int", ">H"), 0xCE: ("int", ">I"), 0xCF: ("int", ">Q"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
}


def _unpack(buf: bytes, pos: int) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b < 0x90:
        kind, n = "map", b & 0x0F
    elif b < 0xA0:
        kind, n = "array", b & 0x0F
    elif b < 0xC0:
        kind, n = "str", b & 0x1F
    elif b in _SIZED:
        kind, fmt = _SIZED[b]
        size = struct.calcsize(fmt)
        (n,) = struct.unpack_from(fmt, buf, pos)
        pos += size
    else:
        raise ValueError(f"msgpack marker 0x{b:02x} is not in the checkpoint format")
    if kind == "int":
        return n, pos
    if kind == "str":
        return buf[pos:pos + n].decode(), pos + n
    if kind == "bin":
        return bytes(buf[pos:pos + n]), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            item, pos = _unpack(buf, pos)
            items.append(item)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        out[k], pos = _unpack(buf, pos)
    return out, pos


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data)`` for the subset the checkpoint format uses."""
    obj, pos = _unpack(data, 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes after the msgpack object")
    return obj


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------


def _leaf_array(x: Any) -> Tuple[str, np.ndarray]:
    """(dtype name, host array of the leaf's bytes)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy()
        arr = t.numpy()
    else:
        arr = np.asarray(x)
    return arr.dtype.name, arr


def _encode_leaf(x: Any) -> dict:
    name, arr = _leaf_array(x)
    return {b"k": _KIND_ARRAY, b"d": name, b"s": [int(n) for n in arr.shape],
            b"b": np.ascontiguousarray(arr).tobytes()}


def _decode_leaf(obj: dict, device) -> torch.Tensor:
    name = obj[b"d"].decode() if isinstance(obj[b"d"], bytes) else obj[b"d"]
    shape = tuple(obj[b"s"])
    if name == "bfloat16":
        arr = np.frombuffer(obj[b"b"], dtype=np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16).to(device)
    arr = np.frombuffer(obj[b"b"], dtype=np.dtype(name)).reshape(shape)
    return torch.from_numpy(arr.copy()).to(device)


def _describe(treedef: Any) -> str:
    """A readable outline of the tree (informational: no loader reads it)."""
    kind = treedef[0]
    if kind == "leaf":
        return "*"
    if kind == "none":
        return "None"
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {_describe(c)}"
                               for k, c in zip(treedef[1], treedef[2], strict=True)) + "}"
    name = treedef[1].__name__ if kind == "namedtuple" else kind.__name__
    return f"{name}(" + ", ".join(_describe(c) for c in treedef[2]) + ")"


def save_pytree(path: str, tree: PyTree) -> None:
    """Write ``tree`` to ``path`` (atomically) in the reference's format."""
    leaves, treedef = tree_flatten(tree)
    payload = {b"treedef": _describe(treedef).encode(),
               b"leaves": [_encode_leaf(x) for x in leaves]}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packb(payload))
    os.replace(tmp, path)


def load_pytree(path: str, like: PyTree, device=None) -> PyTree:
    """Restore into the structure of ``like``; each leaf keeps the file's
    dtype and lands on ``device``, or else on the device of ``like``'s leaf
    in its place (the CPU for a non-tensor leaf)."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    records: List[dict] = payload[b"leaves"]
    like_leaves, treedef = tree_flatten(like)
    if len(records) != len(like_leaves):
        raise ValueError(
            f"checkpoint has {len(records)} leaves, template has {len(like_leaves)}")
    leaves = [
        _decode_leaf(rec, device if device is not None else
                     (t.device if isinstance(t, torch.Tensor) else "cpu"))
        for rec, t in zip(records, like_leaves, strict=True)]
    return tree_unflatten(treedef, leaves)


class CheckpointManager:
    """Step-indexed checkpoints with retention, plus per-silo private shards.

    Files are ``step_NNNNNNNN[.SHARD].msgpack``; each ``save`` keeps the
    ``keep`` newest steps of its shard.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int, shard: Optional[str] = None) -> str:
        name = f"step_{step:08d}" + (f".{shard}" if shard else "") + ".msgpack"
        return os.path.join(self.directory, name)

    def save(self, step: int, tree: PyTree, shard: Optional[str] = None) -> str:
        path = self._path(step, shard)
        save_pytree(path, tree)
        self._gc(shard)
        return path

    def restore(self, step: int, like: PyTree, shard: Optional[str] = None,
                device=None) -> PyTree:
        return load_pytree(self._path(step, shard), like, device=device)

    def has(self, step: int, shard: Optional[str] = None) -> bool:
        """Whether ``step`` (optionally one shard of it) is on disk."""
        return os.path.exists(self._path(step, shard))

    def latest_step(self, shard: Optional[str] = None) -> Optional[int]:
        steps = self.steps(shard)
        return steps[-1] if steps else None

    def steps(self, shard: Optional[str] = None) -> list:
        """Sorted step indices currently retained."""
        suffix = (f".{shard}" if shard else "") + ".msgpack"
        steps = []
        for fn in os.listdir(self.directory):
            if fn.startswith("step_") and fn.endswith(suffix):
                core = fn[len("step_"):][:-len(suffix)]
                if core.isdigit():
                    steps.append(int(core))
        return sorted(steps)

    def _gc(self, shard: Optional[str]) -> None:
        for s in self.steps(shard)[:-self.keep]:
            os.remove(self._path(s, shard))
