"""The federated mesh topology as data: ``MeshSpec`` (the reference's).

``MeshSpec`` is what ``ExperimentSpec.runtime.mesh`` carries: devices on
the ``silo`` axis, devices each silo row's P wire parameters shard
across (``model``), and whether the mesh spans the processes of a
multi-process run. The port runs one device in one process: the
experiment API accepts ``silo`` of None or 1 and ``model`` 1 and refuses
the rest (``federated.api.build``). Building a mesh of several cards is
ROADMAP Queue 1 item 5.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative federated mesh topology (JSON-native, spec-carried).

    Attributes:
      silo: devices on the ``silo`` axis; ``None`` is the reference's
        auto rule (as many as the silos and devices allow: one here).
      model: devices each silo row's wire parameters shard across.
      multiprocess: the mesh spans every process of a distributed run.
    """

    silo: Optional[int] = None
    model: int = 1
    multiprocess: bool = False

    def __post_init__(self):
        if self.model < 1:
            raise ValueError(f"MeshSpec.model must be >= 1, got {self.model}")
        if self.silo is not None and self.silo < 1:
            raise ValueError(f"MeshSpec.silo must be >= 1, got {self.silo}")

    @property
    def single_device(self) -> bool:
        """Whether the mesh is one device in one process."""
        return self.silo in (None, 1) and self.model == 1 and not self.multiprocess

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
