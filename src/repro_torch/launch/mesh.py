"""The federated mesh: ``MeshSpec`` (the reference's) and ``build_mesh`` over ranks.

``MeshSpec`` is what ``ExperimentSpec.runtime.mesh`` carries: the ``silo``
axis, the ``model`` axis each silo row's P wire parameters split across,
and whether the mesh spans the processes of a distributed run. Its JSON
is the reference's, key for key.

One process drives one device. The port's mesh is therefore the grid of
ranks of a ``torch.distributed`` world: ``silo`` rank blocks × ``model``
ranks a block, ``silo · model == world_size``, rank ``r`` at silo block
``r // model`` and model column ``r % model``. :func:`build_mesh` builds
it (and its two process groups) from a spec; without a world it builds
the one-rank mesh of a single process. The reference's one-process mesh
over several devices (``multiprocess=False`` with ``silo > 1`` or
``model > 1``) has no counterpart: a torch process drives one card, so
it is refused, naming the process flags.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative federated mesh topology (JSON-native, spec-carried).

    Attributes:
      silo: ranks on the ``silo`` axis; ``None`` is the reference's auto
        rule (``min(num_silos, world // model)``).
      model: ranks each silo row's wire parameters split across.
      multiprocess: the mesh spans every rank of a ``torch.distributed``
        world (:func:`repro_torch.federated.distributed.initialize`).
    """

    silo: Optional[int] = None
    model: int = 1
    multiprocess: bool = False

    def __post_init__(self):
        if self.model < 1:
            raise ValueError(f"MeshSpec.model must be >= 1, got {self.model}")
        if self.silo is not None and self.silo < 1:
            raise ValueError(f"MeshSpec.silo must be >= 1, got {self.silo}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> MeshSpec:
        return cls(silo=d.get("silo"), model=d.get("model", 1),
                   multiprocess=d.get("multiprocess", False))

    @classmethod
    def parse(cls, text: str) -> MeshSpec:
        """CLI form: ``"silo=8,model=2[,multiprocess]"`` (any subset)."""
        kwargs: Dict[str, Any] = {}
        for part in filter(None, (p.strip() for p in text.split(","))):
            if part == "multiprocess":
                kwargs["multiprocess"] = True
                continue
            key, _, value = part.partition("=")
            if key not in ("silo", "model", "multiprocess"):
                raise ValueError(
                    f"unknown mesh axis {key!r} in {text!r} "
                    "(silo=N,model=N,multiprocess)")
            kwargs[key] = (value.lower() in ("1", "true", "yes")
                           if key == "multiprocess" else int(value))
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A built mesh: the (silo, model) grid of ranks and this rank's place.

    ``silo_group`` holds the ranks of this rank's model column (one a silo
    block: the row gather runs over it); ``model_group`` the ranks of its
    silo block (the column rejoin). Both are None on a mesh without a
    world, where every collective is the identity.
    """

    silo: int
    model: int
    multiprocess: bool
    rank: int = 0
    silo_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"silo": self.silo, "model": self.model}

    @property
    def size(self) -> int:
        return self.silo * self.model

    @property
    def silo_index(self) -> int:
        """This rank's silo block."""
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        """This rank's column block of each wire row."""
        return self.rank % self.model

    @property
    def distributed(self) -> bool:
        """Whether the mesh runs its collectives over a world."""
        return self.silo_group is not None

    @property
    def lead(self) -> bool:
        """The rank that writes what every rank holds alike (rank 0)."""
        return self.rank == 0


def _world() -> Tuple[int, int]:
    """(world size, rank): (1, 0) without an initialized world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def build_mesh(spec: Optional[MeshSpec] = None, *, num_silos: Optional[int] = None) -> Mesh:
    """The single federated-mesh factory: ``MeshSpec`` → :class:`Mesh`.

    ``multiprocess=False`` is one rank in one process (``silo`` None or 1,
    ``model`` 1; anything larger is refused). ``multiprocess=True`` spans
    the initialized world (one rank without one): ``silo`` is pinned or,
    when None, ``max(min(num_silos, world // model), 1)`` (the reference's
    auto rule), and ``silo · model`` must equal the world size. Every rank
    of the world calls this with the same spec: building the groups is a
    collective.
    """
    spec = spec or MeshSpec()
    mw = spec.model
    if not spec.multiprocess:
        n = (spec.silo or 1) * mw
        if n > 1:
            raise ValueError(
                f"MeshSpec(silo={spec.silo}, model={mw}, multiprocess=False) is the "
                f"reference's one-process mesh over {n} devices; a torch process drives "
                f"one card: start {n} processes with --coordinator, --num-processes {n} "
                "and --process-id (repro_torch.federated.distributed.initialize) and set "
                "multiprocess")
        return Mesh(silo=1, model=1, multiprocess=False)
    world, rank = _world()
    if mw > world:
        raise ValueError(
            f"MeshSpec.model={mw} needs at least {mw} devices, have {world}"
            + ("" if dist.is_initialized() else
               f" (no torch.distributed world: start one with --num-processes {mw})"))
    if spec.silo is not None:
        n = spec.silo
        if n * mw > world:
            raise ValueError(
                f"MeshSpec(silo={n}, model={mw}) needs {n * mw} devices, have {world}"
                + ("" if dist.is_initialized() else
                   f" (no torch.distributed world: start one with --num-processes "
                   f"{n * mw})"))
    else:
        n = max(min(world // mw, num_silos if num_silos is not None else world), 1)
    if n * mw != world:
        raise ValueError(
            f"the mesh (silo={n}, model={mw}) must span the world's {world} ranks: "
            "one process drives one device")
    if not dist.is_initialized():
        return Mesh(silo=1, model=1, multiprocess=True)
    # Every rank creates every group, in one order (new_group is collective).
    silo_groups = [dist.new_group([b * mw + m for b in range(n)]) for m in range(mw)]
    model_groups = [dist.new_group([b * mw + m for m in range(mw)]) for b in range(n)]
    b, m = rank // mw, rank % mw
    return Mesh(silo=n, model=mw, multiprocess=True, rank=rank,
                silo_group=silo_groups[m], model_group=model_groups[b])


def data_world(mesh: Mesh) -> int:
    """Silo blocks of the mesh (the ranks the stacked silo axis splits over)."""
    return mesh.silo


def model_world(mesh: Mesh) -> int:
    """Ranks each wire row's columns split across (1 without a model axis)."""
    return mesh.model


def mesh_process_count(mesh: Mesh) -> int:
    """Processes the mesh spans (1 = single-process)."""
    return mesh.size
