"""The port's checkpoint I/O against the JAX package's (``repro.checkpoint``).

* The port's msgpack encoder gives ``msgpack.packb``'s bytes, byte for
  byte, for the subset the format uses (every size class of map, array,
  int, str and bin), and its decoder gives ``msgpack.unpackb``'s objects.
  The tests import the sandbox's ``msgpack``; the port does not.
* A file from the port and a file from the reference hold the same leaf
  records byte for byte (only the ``treedef`` text differs), and each
  package loads the other's files: float32, int32, bool, scalars, empty
  arrays and bfloat16.
* ``tests/test_checkpoint.py`` repeated against the port: round trip,
  bf16, retention and the latest step, per-silo shards, a structure
  mismatch; plus ``has`` and restoring onto the caller's device.
"""
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as j_load, save_pytree as j_save
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.checkpoint.io import packb, unpackb
from repro_torch.optim.adam import ScaleByAdamState
from repro_torch.tree import tree_leaves


def _payloads():
    small = {b"k": 0, b"d": "float32", b"s": [3, 4], b"b": b"\x00" * 48}
    yield "leaf", small
    yield "fix_limits", [0, 1, 127, 128, 255, 256, 65_535, 65_536, 2**32 - 1, 2**32, 2**63]
    for n in (0, 1, 31, 32, 255, 256, 65_535, 65_536):
        yield f"str{n}", "s" * n
        yield f"bin{n}", b"b" * n
    for n in (0, 15, 16, 65_535, 65_536):
        yield f"array{n}", list(range(n))
        yield f"map{n}", {f"k{i}".encode(): i for i in range(n)}
    yield "nested", {b"treedef": b"{'a': *}", b"leaves": [small, small]}


@pytest.mark.parametrize("name,obj", list(_payloads()), ids=[n for n, _ in _payloads()])
def test_codec_matches_msgpack_byte_for_byte(name, obj):
    raw = packb(obj)
    assert raw == msgpack.packb(obj)
    assert unpackb(raw) == msgpack.unpackb(raw)


def test_codec_refuses_what_the_format_lacks():
    for bad in (-1, 1.5, True, None):
        with pytest.raises((TypeError, ValueError)):
            packb(bad)
    with pytest.raises(ValueError, match="trailing"):
        unpackb(packb(1) + b"\x00")
    with pytest.raises(ValueError, match="not in the checkpoint format"):
        unpackb(msgpack.packb(1.5))


def _trees():
    rng = np.random.default_rng(0)
    arrays = {
        "w": rng.normal(size=(3, 4)).astype(np.float32),
        "nested": {"b": np.array([1, 2, 3], np.int32), "s": np.array(2.5, np.float32)},
        "count": np.array(7, np.int32),
        "empty": np.zeros((0, 5), np.float32),
        "mask": np.array([True, False, True]),
        "big": rng.normal(size=(70, 1000)).astype(np.float32),
    }
    port = jax.tree_util.tree_map(torch.as_tensor, arrays)
    ref = jax.tree_util.tree_map(jnp.asarray, arrays)
    return port, ref


def _bf16_pair():
    x = np.linspace(-3, 3, 11).astype(np.float32)
    return {"w": torch.as_tensor(x).to(torch.bfloat16)}, {"w": jnp.asarray(x, jnp.bfloat16)}


@pytest.mark.parametrize("case", ["mixed", "bf16"])
def test_leaf_records_equal_the_reference(tmp_path, case):
    port, ref = _trees() if case == "mixed" else _bf16_pair()
    save_pytree(str(tmp_path / "t.msgpack"), port)
    j_save(str(tmp_path / "j.msgpack"), ref)
    t_raw = (tmp_path / "t.msgpack").read_bytes()
    j_raw = (tmp_path / "j.msgpack").read_bytes()
    t_obj, j_obj = msgpack.unpackb(t_raw), msgpack.unpackb(j_raw)
    assert list(t_obj) == list(j_obj) == [b"treedef", b"leaves"]
    assert t_obj[b"leaves"] == j_obj[b"leaves"]
    # With the reference's treedef text, the port's file is the reference's.
    assert packb({b"treedef": j_obj[b"treedef"], b"leaves": t_obj[b"leaves"]}) == j_raw


@pytest.mark.parametrize("case", ["mixed", "bf16"])
def test_each_package_loads_the_others_files(tmp_path, case):
    port, ref = _trees() if case == "mixed" else _bf16_pair()
    j_save(str(tmp_path / "j.msgpack"), ref)
    got = load_pytree(str(tmp_path / "j.msgpack"), port)
    for a, b in zip(tree_leaves(got), tree_leaves(port), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    save_pytree(str(tmp_path / "t.msgpack"), port)
    back = j_load(str(tmp_path / "t.msgpack"), ref)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref),
                    strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_optimizer_state_round_trips(tmp_path):
    tree = {"opt": (ScaleByAdamState(count=torch.tensor(3, dtype=torch.int32),
                                     mu={"a": torch.ones(2)}, nu={"a": torch.full((2,), 4.0)}),
                    ()), "x": None}
    save_pytree(str(tmp_path / "o.msgpack"), tree)
    got = load_pytree(str(tmp_path / "o.msgpack"), tree)
    assert isinstance(got["opt"][0], ScaleByAdamState) and got["opt"][1] == ()
    assert got["x"] is None and got["opt"][0].count.dtype == torch.int32
    for a, b in zip(tree_leaves(got), tree_leaves(tree), strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py against the port
# ---------------------------------------------------------------------------


def test_roundtrip(tmp_path):
    tree = {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.tensor([1, 2, 3], dtype=torch.int32), "s": torch.tensor(2.5)},
    }
    path = str(tmp_path / "ckpt.msgpack")
    save_pytree(path, tree)
    restored = load_pytree(path, tree)
    for a, b in zip(tree_leaves(tree), tree_leaves(restored), strict=True):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_bf16_roundtrip(tmp_path):
    tree = {"w": torch.ones(4, dtype=torch.bfloat16) * 1.5}
    path = str(tmp_path / "c.msgpack")
    save_pytree(path, tree)
    restored = load_pytree(path, tree)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].float(), torch.full((4,), 1.5))


def test_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.zeros(3)}
    for step in [1, 2, 3, 4]:
        mgr.save(step, tree)
    assert mgr.latest_step() == 4
    assert mgr.steps() == [3, 4]
    assert mgr.has(4) and not mgr.has(1)


def test_manager_per_silo_shards(tmp_path):
    """Server and silo checkpoints live in separate files (privacy boundary)."""
    mgr = CheckpointManager(str(tmp_path))
    server_tree = {"eta_G": torch.ones(2)}
    silo_tree = {"eta_L": torch.full((5,), 3.0)}
    mgr.save(1, server_tree)
    mgr.save(1, silo_tree, shard="silo_0")
    assert torch.equal(mgr.restore(1, server_tree)["eta_G"], torch.ones(2))
    assert torch.equal(mgr.restore(1, silo_tree, shard="silo_0")["eta_L"],
                       torch.full((5,), 3.0))
    assert mgr.latest_step(shard="silo_0") == 1 and mgr.has(1, shard="silo_0")
    assert not mgr.has(1, shard="silo_1")


def test_structure_mismatch_raises(tmp_path):
    path = str(tmp_path / "c.msgpack")
    save_pytree(path, {"a": torch.zeros(2)})
    with pytest.raises(ValueError):
        load_pytree(path, {"a": torch.zeros(2), "b": torch.zeros(2)})


def test_restores_onto_the_callers_device(tmp_path):
    path = str(tmp_path / "c.msgpack")
    save_pytree(path, {"a": torch.arange(3.0)})
    got = load_pytree(path, {"a": torch.zeros(3, device="meta")})
    assert got["a"].device.type == "meta" and got["a"].shape == (3,)
    got = load_pytree(path, {"a": np.zeros(3)}, device="cpu")
    assert torch.equal(got["a"], torch.arange(3.0))
