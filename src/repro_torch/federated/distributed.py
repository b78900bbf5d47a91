"""Multi-process federation over ``torch.distributed`` (the port of ``repro.federated.distributed``).

One federated run can span several processes, one per device. The mesh
is the grid of ranks of the world (:func:`repro_torch.launch.mesh.build_mesh`):
every rank runs the same host loop, but each rank holds the silo rows of
its silo block only:

  * silo state (η_{L_j}, optimizer moments, strategy state) and the
    stacked data exist only on the ranks of the row's block;
  * host I/O is routed through the owner: checkpoint shards for silo j
    are written by j's owner (:func:`row_owner_process`) and read by the
    ranks that hold it (:func:`owned_rows`, :func:`host_rows`);
  * control values every rank must agree on (scheduler masks, async
    schedules, churn events, the draws of a round, metering) are pure
    functions of (seed, absolute round), so each rank recomputes them:
    no control traffic, the determinism contract bit-exact resume rests
    on already.

The round's two collectives are here: :func:`gather_rows` (the silo
blocks' rows into the whole padded silo axis, over the silo group) and
:func:`gather_cols` (the column blocks of each row rejoined, over the
model group). Both count the bytes they return (``GATHERED``). The
backbone's multi-process train step sums its θ and η_G gradients over the
silo group with :func:`sum_leaves_over_silos` (``REDUCED`` adds up the
host seconds around its all-reduces: with NCCL, which returns before the
collective ends, that is the enqueue, not the collective). With gloo, a CUDA tensor is staged
through host memory explicitly (gloo's own collectives are CPU ones); the
backend is always the one the caller named.
"""
from __future__ import annotations

import datetime
import os
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Mesh
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

PyTree = Any

# Environment schema for CLI-driven multi-process launches (the reference's).
ENV_COORD = "REPRO_COORDINATOR"
ENV_NUM_PROCS = "REPRO_NUM_PROCESSES"
ENV_PROC_ID = "REPRO_PROCESS_ID"

# Bytes each collective returned to this rank, by axis.
GATHERED: Dict[str, int] = {"silo": 0, "model": 0}
# Host seconds around this rank's gradient all-reduces (not synchronized).
REDUCED: Dict[str, float] = {"seconds": 0.0}
REDUCE_BUCKET = 1 << 26  # elements of one all-reduce bucket (256 MB in f32)


def reset_gathered() -> None:
    for k in GATHERED:
        GATHERED[k] = 0
    for k in REDUCED:
        REDUCED[k] = 0


def _init_method(coordinator: str) -> str:
    """``host:port`` (the reference's form) or a full URL -> an init URL."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None, *,
               device=None, timeout_s: float = 600.0) -> None:
    """``torch.distributed.init_process_group`` from the reference's schema.

    Arguments default to ``REPRO_COORDINATOR`` (``host:port``) /
    ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` (what the CLI's
    ``--coordinator``/... flags export). ``backend`` defaults to
    ``"nccl"`` for a CUDA ``device`` (the default) and ``"gloo"`` for the
    CPU. NCCL cannot put two ranks on one device, so a world of more
    ranks than this machine's cards is refused for it; gloo is never
    chosen in its place.
    """
    coordinator = coordinator or os.environ.get(ENV_COORD)
    if num_processes is None and os.environ.get(ENV_NUM_PROCS):
        num_processes = int(os.environ[ENV_NUM_PROCS])
    if process_id is None and os.environ.get(ENV_PROC_ID):
        process_id = int(os.environ[ENV_PROC_ID])
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process federation needs --coordinator HOST:PORT, --num-processes "
            f"and --process-id (or {ENV_COORD} / {ENV_NUM_PROCS} / {ENV_PROC_ID}); got "
            f"{coordinator!r}, {num_processes!r}, {process_id!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is outside [0, {num_processes})")
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if num_processes > cards:
            raise ValueError(
                f"backend 'nccl' cannot put {num_processes} ranks on {cards} CUDA "
                "device(s): NCCL takes one device a rank; pass backend='gloo' to share one")
    dist.init_process_group(backend, init_method=_init_method(coordinator),
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def start_from_flags(coordinator: Optional[str], num_processes: Optional[int],
                     process_id: Optional[int], device=None) -> bool:
    """A CLI's world: with any process flag (or ``REPRO_COORDINATOR`` set)
    and no world yet, :func:`initialize` one and export the flags into the
    env schema. Returns whether it started one (a caller's world is left
    to the caller)."""
    flags = {ENV_COORD: coordinator, ENV_NUM_PROCS: num_processes, ENV_PROC_ID: process_id}
    if dist.is_available() and dist.is_initialized():
        return False
    if all(v is None for v in flags.values()) and not os.environ.get(ENV_COORD):
        return False
    initialize(coordinator, num_processes, process_id, device=device)
    for env, value in flags.items():
        if value is not None:
            os.environ[env] = str(value)
    return True


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def rank_device(device) -> torch.device:
    """The device of this rank of an initialized world: ``cuda:{rank %
    cards}`` for a CUDA device named without an index; else ``device``."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or not (
            dist.is_available() and dist.is_initialized()):
        return dev
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def shutdown() -> None:
    """Destroy the default process group (a no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Row ownership: contiguous silo blocks
# ---------------------------------------------------------------------------


def padded_rows(J: int, mesh: Mesh) -> int:
    """J_pad: J rounded up to a multiple of the mesh's silo blocks."""
    return -(-J // mesh.silo) * mesh.silo


def block_rows(mesh: Mesh, rows_total: int) -> int:
    """Rows a silo block holds: ``rows_total`` (J_pad) over the blocks."""
    if rows_total % mesh.silo:
        raise ValueError(f"{rows_total} rows do not split into {mesh.silo} silo blocks")
    return rows_total // mesh.silo


def row_owner_process(mesh: Mesh, row: int, rows_total: int) -> int:
    """Rank owning padded silo row ``row`` of ``rows_total``: the model
    column 0 of the row's silo block (the one that writes its shard)."""
    return (row // block_rows(mesh, rows_total)) * mesh.model


def owned_rows(mesh: Mesh, rows_total: int) -> List[int]:
    """Padded-row indices this rank holds (its silo block's contiguous rows)."""
    n = block_rows(mesh, rows_total)
    return list(range(mesh.silo_index * n, (mesh.silo_index + 1) * n))


def own(tree: PyTree, mesh: Mesh, rows_total: int) -> PyTree:
    """This rank's block of a (rows_total, ...) stacked tree (a view)."""
    rows = owned_rows(mesh, rows_total)
    return tree_map(lambda x: x[rows[0]: rows[-1] + 1], tree)


def host_rows(x: torch.Tensor, mesh: Mesh, rows: List[int], rows_total: int
              ) -> Dict[int, torch.Tensor]:
    """{row: its slice} for rows of this rank's block of a stacked tensor
    ``x`` (the block, leading axis ``rows_total // silo``). Reads only
    what the rank holds: no collective."""
    lo = owned_rows(mesh, rows_total)[0]
    n = x.shape[0]
    return {r: x[r - lo] for r in rows if 0 <= r - lo < n}


def rows_to_block(block: PyTree, mesh: Mesh, rows: Dict[int, PyTree], rows_total: int
                  ) -> PyTree:
    """Owner-held row trees -> this rank's stacked block (the port of
    ``silo_sharded_from_rows``). ``block`` gives structure and the rows
    no entry replaces (padded rows, silos without a shard on disk keep
    their fresh init); ``rows`` maps padded-row index -> that row's tree."""
    lo = owned_rows(mesh, rows_total)[0]
    leaves, treedef = tree_flatten(block)
    out = [x.clone() for x in leaves]
    for r, tree in rows.items():
        for o, v in zip(out, tree_flatten(tree)[0], strict=True):
            o[r - lo] = v.to(o.device)
    return tree_unflatten(treedef, out)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _backend_device(group, x: torch.Tensor) -> torch.device:
    """Where the collective's buffers live: the host for gloo, x's device else."""
    return torch.device("cpu") if dist.get_backend(group) == "gloo" else x.device


def _all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Each rank's ``x`` (one shape on every rank), in group-rank order."""
    buf = x.contiguous().to(_backend_device(group, x))
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return [p.to(x.device) for p in parts]


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The silo blocks' (n, ...) rows -> the whole (silo · n, ...) axis,
    over the silo group (identity on a mesh without a world)."""
    if not mesh.distributed:
        return x
    out = torch.cat(_all_gather(x, mesh.silo_group))
    GATHERED["silo"] += out.numel() * out.element_size()
    return out


def gather_cols(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Each model rank's (R, c) column block -> (R, model · c), over the
    model group (identity on a mesh without a world)."""
    if not mesh.distributed:
        return x
    out = torch.cat(_all_gather(x, mesh.model_group), dim=1)
    GATHERED["model"] += out.numel() * out.element_size()
    return out


def sum_over_silos(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The silo blocks' partial sums of ``x``, added in rank order (a fixed
    order on every rank, so every rank's sum is the same float)."""
    if not mesh.distributed:
        return x
    parts = _all_gather(x.reshape(-1), mesh.silo_group)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total.reshape(x.shape)


def sum_leaves_over_silos(leaves: List[torch.Tensor], mesh: Mesh) -> None:
    """In place: each tensor of ``leaves`` <- its sum over the silo group
    (a no-op on a mesh without a world). Consecutive leaves are flattened
    into f32 buckets of at most ``REDUCE_BUCKET`` elements (a larger leaf
    is a bucket of its own), each bucket is one ``all_reduce`` (sum), and
    the sums are written back in the leaves' dtypes: a bf16 gradient's
    partials are added in f32 and rounded once. ``all_reduce`` hands every
    rank the same reduced buffer, so the ranks' sums are bit-identical."""
    if not mesh.distributed:
        return
    group = mesh.silo_group
    i = 0
    while i < len(leaves):
        j, n = i, 0
        while j < len(leaves) and (j == i or n + leaves[j].numel() <= REDUCE_BUCKET):
            n += leaves[j].numel()
            j += 1
        t0 = time.perf_counter()
        flat = torch.cat([x.reshape(-1).float() for x in leaves[i:j]])
        buf = flat.to(_backend_device(group, flat))
        dist.all_reduce(buf, group=group)
        flat = buf.to(flat.device)
        off = 0
        for x in leaves[i:j]:
            x.copy_(flat[off: off + x.numel()].view(x.shape))
            off += x.numel()
        REDUCED["seconds"] += time.perf_counter() - t0
        del flat, buf
        i = j


def gather_tree_rows(tree: PyTree, mesh: Mesh) -> PyTree:
    """Every stacked leaf's silo blocks gathered in ONE collective: the
    leaves' rows are packed as bytes into one (n, bytes) buffer, gathered,
    and unpacked (the hand-over of rows when ownership moves)."""
    leaves, treedef = tree_flatten(tree)
    if not mesh.distributed or not leaves:
        return tree
    n = leaves[0].shape[0]
    # A fresh (n, size) copy: a broadcast leaf (an optimizer count) may
    # have stride 0, which a byte view cannot take.
    flat = [torch.empty((n, x[0].numel() if n else 0), dtype=x.dtype, device=x.device)
            .copy_(x.reshape(n, -1)).view(torch.uint8) for x in leaves]
    widths = [f.shape[1] for f in flat]
    packed = gather_rows(torch.cat(flat, dim=1), mesh)
    out, off = [], 0
    for x, w in zip(leaves, widths, strict=True):
        piece = packed[:, off: off + w].contiguous().view(x.dtype)
        out.append(piece.reshape((-1,) + tuple(x.shape[1:])))
        off += w
    return tree_unflatten(treedef, out)


def barrier(mesh: Mesh, device) -> None:
    """Every rank of the world reaches this point before any goes on (a
    one-float gather on ``device``, this rank's device)."""
    if mesh.distributed:
        _all_gather(torch.zeros(1, device=device), dist.group.WORLD)
