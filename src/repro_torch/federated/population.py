"""Dynamic silo populations: arrivals, departures, stale returns.

The port of ``repro.federated.population``. A deterministic population
process runs over the round engine
(:class:`~repro_torch.federated.runtime.Server`) and the buffered-async
event loop (:mod:`~repro_torch.federated.async_engine`):

  * **join**: the next roster silo enters; its shard is appended to the
    stacked silo axis (``Server.grow_silos``) and its η_L is warm-started
    through the amortized encoder of :mod:`repro_torch.core.amortized`
    (the silo encodes its own observations into an initial mean and
    scale). Per-silo strategy state starts at the strategy's init (PVI's
    zero site: the new silo's cavity is the current global posterior).
  * **depart**: the silo's participation goes to zero; its η_L, optimizer
    moments and sites stay in place, frozen by the mask.
  * **return**: the silo re-enters with a staleness (rounds absent on the
    sync path, server versions since its pull on the async path) that
    feeds the FedBuff weight ``(1 + staleness)^-decay``.

Every event is a pure function of ``(population seed, kind, index,
silo)``, drawn from numpy exactly as the reference draws it, and the
mutable remainder (:class:`PopulationState`) round-trips through JSON,
so a churn run resumes bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import amortized
from repro_torch.device import generator
from repro_torch.tree import tree_leaves

PyTree = Any

# Salt of the population's event stream (the reference's), apart from the
# latency stream (0x5AF0) and the run seed's streams.
_POP_SALT = 0x9D07

# Sub-stream codes per event kind (part of the SeedSequence entropy).
_ARRIVAL, _DEPART, _RETURN = 0, 1, 2

# Silo lifecycle codes (PopulationState.status).
ACTIVE, DEPARTED = 1, 2


def event_draw(pop_seed: int, kind: int, index: int, silo: int) -> float:
    """U(0, 1) draw for one (event kind, round/flush index, silo) cell."""
    rng = np.random.default_rng([_POP_SALT, pop_seed, kind, index, silo])
    return float(rng.random())


@dataclasses.dataclass(frozen=True)
class PopulationSpec:
    """Declarative population dynamics — a node on ``ExperimentSpec``.

    Attributes:
      initial: silos present at round 0.
      arrival_rate: per-round probability that the next cold silo joins
        (at most one a round, in roster order).
      departure_rate: per-round, per-active-silo probability of leaving
        (the last active silo never leaves).
      return_rate: per-round, per-departed-silo probability of returning.
      max_silos: roster cap; ``None`` means ``spec.num_silos``.
      warm_start: warm-start a joining silo's η_L through the amortized
        encoder (``False``: the cold family init).
      staleness_decay: a returning silo's first round aggregates with
        weight ``(1 + rounds_absent)^-staleness_decay`` (sync path).
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


@dataclasses.dataclass
class PopulationState:
    """The mutable remainder of the population process (the reference's).

    ``round``: the next event index to process; ``joined``: silos that
    ever joined (the Server's J); ``status``: ACTIVE / DEPARTED per joined
    silo; ``last_present``: the last round each was active.
    """

    round: int
    joined: int
    status: List[int]
    last_present: List[int]

    @classmethod
    def init(cls, initial: int) -> PopulationState:
        return cls(round=0, joined=initial, status=[ACTIVE] * initial,
                   last_present=[-1] * initial)

    def state_dict(self) -> Dict[str, Any]:
        """JSON-native snapshot (checkpointed by ``federated.api``)."""
        return {"round": self.round, "joined": self.joined,
                "status": list(self.status), "last_present": list(self.last_present)}

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> PopulationState:
        return cls(round=int(state["round"]), joined=int(state["joined"]),
                   status=[int(x) for x in state["status"]],
                   last_present=[int(x) for x in state["last_present"]])

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.status if s == ACTIVE)


def amortized_warm_start(problem, data_j: PyTree,
                         init: Union[torch.Generator, PyTree]) -> PyTree:
    """Encode a joining silo's data into its initial η_L.

    ``init`` is the generator the cold path draws ``local_family.init``
    from, or that template itself. The template is kept, and its mean
    (``mu`` / ``mu_bar``) and ``log_sigma`` leaves are overwritten with
    the per-observation (μ, log σ) of the deterministic encoder
    (:func:`~repro_torch.core.amortized.encoder_warm_init`, log σ at the
    contraction scale n^-1/2) averaged over the silo's observations.
    Families without a mean leaf keep the cold init.
    """
    template = (problem.local_family.init(init) if isinstance(init, torch.Generator)
                else init)
    if not isinstance(template, dict):
        return template
    mu_leaf = "mu" if "mu" in template else ("mu_bar" if "mu_bar" in template else None)
    if mu_leaf is None:
        return template
    leaves = tree_leaves(data_j)
    if not leaves:
        return template
    y = data_j["y"] if isinstance(data_j, dict) and "y" in data_j else leaves[0]
    n = int(y.shape[0]) if y.ndim else 1
    y2 = y.float().reshape(n, -1)
    latent_dim = int(np.prod(template[mu_leaf].shape)) or 1
    phi = amortized.encoder_warm_init(int(y2.shape[1]), latent_dim,
                                      log_sigma=float(-0.5 * math.log(max(n, 1))),
                                      device=y2.device)
    mu_k, ls_k = amortized.encode(phi, y2)
    out = dict(template)
    out[mu_leaf] = torch.mean(mu_k, dim=0).reshape(template[mu_leaf].shape)
    if "log_sigma" in template:
        out["log_sigma"] = torch.mean(ls_k, dim=0).reshape(template["log_sigma"].shape)
    return out


class PopulationEngine:
    """Drives churn events against a live Server, one round at a time.

    Owns the spec, the :class:`PopulationState` and the staged roster
    (``bundle`` stages all ``max_silos`` shards up front). The sync path
    calls :meth:`begin_round` before each round, the async path
    :meth:`begin_flush` before each flush; both process the index's events
    once, in a fixed order (returns, then one arrival, then departures).
    """

    def __init__(self, pop: PopulationSpec, bundle, num_silos: int,
                 state: Optional[PopulationState] = None):
        self.pop = pop
        self.bundle = bundle
        self.max_silos = pop.max_silos if pop.max_silos is not None else num_silos
        if self.max_silos > num_silos:
            raise ValueError(
                f"population.max_silos ({self.max_silos}) exceeds the staged roster "
                f"(num_silos={num_silos})")
        if pop.initial > self.max_silos:
            raise ValueError(
                f"population.initial ({pop.initial}) exceeds max_silos ({self.max_silos})")
        self.state = state if state is not None else PopulationState.init(pop.initial)

    # -- event processing ----------------------------------------------------

    def _bundle_row(self, j: int):
        data_j = self.bundle.datas[j]
        if self.bundle.num_obs is not None:
            return data_j, int(self.bundle.num_obs[j])
        return data_j, int(tree_leaves(data_j)[0].shape[0])

    def _join(self, server, j: int) -> None:
        """Append roster silo ``j`` to the live federation."""
        data_j, n_j = self._bundle_row(j)
        eta_row = None
        if self.pop.warm_start and server._has_local:
            # The cold growth path's per-silo generator: warm and cold
            # differ only in the encoder-informed leaves.
            gen = generator((server.seed + 1, j), server.device)
            eta_row = amortized_warm_start(server.problem, data_j, gen)
        server.grow_silos([data_j], num_obs=[n_j],
                          eta_rows=None if eta_row is None else [eta_row])

    def _advance(self, server, index: int) -> Tuple[List[int], List[int]]:
        """Process event index ``index``; returns (joins, returns)."""
        st = self.state
        if st.round != index:
            raise RuntimeError(
                f"population state is at event index {st.round}, but the run loop asked "
                f"for index {index}; population runs must advance one round/flush at a "
                f"time (resume restores the saved index)")
        pop = self.pop
        returns: List[int] = []
        for j in range(st.joined):
            if st.status[j] == DEPARTED and event_draw(
                    pop.seed, _RETURN, index, j) < pop.return_rate:
                st.status[j] = ACTIVE
                returns.append(j)
        joins: List[int] = []
        if st.joined < self.max_silos and event_draw(
                pop.seed, _ARRIVAL, index, st.joined) < pop.arrival_rate:
            j = st.joined
            self._join(server, j)
            st.status.append(ACTIVE)
            st.last_present.append(-1)
            st.joined += 1
            joins.append(j)
        for j in range(st.joined):
            if st.status[j] != ACTIVE or j in returns or j in joins:
                continue
            if st.n_active <= 1:
                break  # the last active silo never departs
            if event_draw(pop.seed, _DEPART, index, j) < pop.departure_rate:
                st.status[j] = DEPARTED
        st.round = index + 1
        return joins, returns

    # -- sync path -----------------------------------------------------------

    def begin_round(self, server, r: int) -> Tuple[np.ndarray, np.ndarray]:
        """Process round ``r``'s events; returns (presence, weights) over the
        server's post-growth J: the 0/1 membership, and the weights that
        decay a returning silo's first round back by
        ``(1 + rounds_absent)^-staleness_decay``."""
        st = self.state
        _, returns = self._advance(server, r)
        present = np.array([1.0 if s == ACTIVE else 0.0 for s in st.status], np.float32)
        weights = present.copy()
        for j in returns:
            absent = max(r - st.last_present[j], 0) if st.last_present[j] >= 0 else 0
            weights[j] = (1.0 + absent) ** (-self.pop.staleness_decay)
        for j in range(st.joined):
            if st.status[j] == ACTIVE:
                st.last_present[j] = r
        return present, weights

    # -- async path ----------------------------------------------------------

    def begin_flush(self, server, buf, cfg, f: int) -> List[int]:
        """Process flush ``f``'s events against the async ``BufferState``.

        A join starts its first task at the current simulated clock; a
        return restarts the interrupted task from the return instant but
        keeps its pulled version, so its contribution arrives with the
        staleness the gap implies. Returns the 0/1 activity mask the flush
        simulation pops arrivals under.
        """
        from repro_torch.federated.async_engine import latency_draw

        st = self.state
        joins, returns = self._advance(server, f)
        for j in joins:
            buf.task_idx.append(0)
            buf.start_version.append(buf.version)
            buf.start_time.append(buf.clock)
            buf.finish_time.append(buf.clock + latency_draw(cfg, server.seed, j, 0))
        for j in returns:
            buf.finish_time[j] = buf.clock + latency_draw(cfg, server.seed, j, buf.task_idx[j])
        for j in range(st.joined):
            if st.status[j] == ACTIVE:
                st.last_present[j] = f
        return [1 if s == ACTIVE else 0 for s in st.status]
