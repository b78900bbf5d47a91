"""Dynamic silo populations as data: ``PopulationSpec`` (the reference's).

The spec rides on ``ExperimentSpec.population`` and round-trips through
its JSON. The churn engine (joins, departures, stale returns) is ROADMAP
Queue 1 item 4; until it lands, ``federated.api.build`` refuses a spec
that sets a population.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class PopulationSpec:
    """Declarative population dynamics — a node on ``ExperimentSpec``.

    Attributes:
      initial: silos present at round 0.
      arrival_rate: per-round probability that the next cold silo joins.
      departure_rate: per-round, per-active-silo probability of leaving.
      return_rate: per-round, per-departed-silo probability of returning.
      max_silos: roster cap; ``None`` means ``spec.num_silos``.
      warm_start: warm-start a joining silo's η_L through the amortized
        encoder (``False``: the cold family init).
      staleness_decay: a returning silo's first round aggregates with
        weight ``(1 + rounds_absent)^-staleness_decay``.
      seed: seed of the population's event stream.
    """

    initial: int = 2
    arrival_rate: float = 0.0
    departure_rate: float = 0.0
    return_rate: float = 0.0
    max_silos: Optional[int] = None
    warm_start: bool = True
    staleness_decay: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.initial < 1:
            raise ValueError(f"initial must be >= 1, got {self.initial}")
        for name in ("arrival_rate", "departure_rate", "return_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.max_silos is not None and self.max_silos < self.initial:
            raise ValueError(
                f"max_silos ({self.max_silos}) < initial ({self.initial})")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> PopulationSpec:
        return cls(
            initial=d.get("initial", 2),
            arrival_rate=d.get("arrival_rate", 0.0),
            departure_rate=d.get("departure_rate", 0.0),
            return_rate=d.get("return_rate", 0.0),
            max_silos=d.get("max_silos"),
            warm_start=d.get("warm_start", True),
            staleness_decay=d.get("staleness_decay", 0.5),
            seed=d.get("seed", 0),
        )
