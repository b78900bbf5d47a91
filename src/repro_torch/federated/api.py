"""One declarative experiment API: spec → build → run → save → resume.

The port of ``repro.federated.api``:

  * :class:`ExperimentSpec` — a frozen dataclass tree (model reference +
    kwargs, silos, rounds × local steps, optimizers, a
    :class:`~repro_torch.federated.scheduler.Scenario`, an optional
    :class:`~repro_torch.federated.strategy.StrategySpec`, eval cadence,
    seeds, the runtime topology, an optional population). Its
    ``to_dict()`` is the reference's key for key, so the two packages
    read and write the same spec JSON.
  * :func:`build` — resolves the model through the port's registry and
    assembles the :class:`~repro_torch.federated.runtime.Server`,
    scheduler and privacy policy into an :class:`Experiment`.
  * :class:`Experiment` — runs rounds, evaluates, and checkpoints in the
    reference's layout through :class:`~repro_torch.checkpoint.CheckpointManager`:
    ``spec.json``; ``step_NNNNNNNN.msgpack`` with θ, η_G and the server
    optimizer; one ``step_NNNNNNNN.silo_JJJJ.msgpack`` per silo with
    η_{L_j} and its optimizer (when Z_L ≠ ∅) and the strategy's site
    state (PVI, federated EP); ``step_NNNNNNNN.meta.json`` with the round,
    the communication meter, the wire layout, the float64 RDP ledger and,
    when they run, the async event loop's ``BufferState`` and the
    ``PopulationState``. Every random stream of the runtime (the draws, the
    participation masks, the DP noise, the latency and churn events) is a
    function of (seed, absolute round), so a resumed run replays the
    uninterrupted run's rounds bit for bit, and a directory saved by either
    package resumes in the other.

A scenario with an ``async_cfg`` runs its rounds as buffered-async flushes
(:func:`~repro_torch.federated.async_engine.run_buffered`); a ``population``
churns the silos (:class:`~repro_torch.federated.population.PopulationEngine`).

``runtime.mesh`` with ``multiprocess`` spans the ranks of a
``torch.distributed`` world (:func:`repro_torch.federated.distributed.initialize`,
one process a device): every rank calls :func:`build`, ``run``, ``save``
and ``resume`` alike. I/O is routed through the owners, as in the
reference: the lead rank writes the spec, the server state and the meta
sidecar, each silo block's owner writes that block's ``silo_JJJJ`` shards,
and a resume reads the shards of the rank's own rows. What the port does
not run is refused at :func:`build`, naming the ROADMAP item:
``runtime.sanitize`` (JAX trace machinery, Queue 1 item 6) and
``runtime.wire == "legacy"`` (the reference's per-leaf wire, Queue 1
item 6); the reference's one-process mesh over several devices
(``launch.mesh.build_mesh``) names the process flags instead.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.family import FamilySpec
from repro_torch.federated import distributed
from repro_torch.federated.async_engine import BufferState, run_buffered
from repro_torch.federated.population import (
    PopulationEngine,
    PopulationSpec,
    PopulationState,
)
from repro_torch.federated.scheduler import RoundScheduler, Scenario
from repro_torch.federated.strategy import StrategySpec
from repro_torch.launch.mesh import MeshSpec, build_mesh
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

_SPEC_FILE = "spec.json"
_SERVER_KEYS = ("theta", "eta_G", "opt_server")


# ---------------------------------------------------------------------------
# Spec tree
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """Declarative optimizer: ``"adam"``, ``"adamw"`` or ``"sgd"`` with its
    learning rate and JSON-native extra kwargs (betas, weight decay, ...)."""

    name: str = "adam"
    learning_rate: float = 1e-2
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def build(self):
        """The :class:`~repro_torch.optim.base.GradientTransformation`."""
        from repro_torch import optim

        factories = {"adam": optim.adam, "adamw": optim.adamw, "sgd": optim.sgd}
        if self.name not in factories:
            raise ValueError(f"unknown optimizer {self.name!r} (adam/adamw/sgd)")
        return factories[self.name](self.learning_rate, **self.kwargs)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> OptimizerSpec:
        return cls(name=d.get("name", "adam"), learning_rate=d.get("learning_rate", 1e-2),
                   kwargs=dict(d.get("kwargs", {})))


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A registered model's name, its JSON-native build kwargs, and optional
    :class:`~repro_torch.core.family.FamilySpec` overrides of its global and
    local variational families (``None`` keeps the model's own)."""

    name: str
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    global_family: Optional[FamilySpec] = None
    local_family: Optional[FamilySpec] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> ModelSpec:
        return cls(
            name=d["name"],
            kwargs=dict(d.get("kwargs", {})),
            global_family=(FamilySpec.from_dict(d["global_family"])
                           if d.get("global_family") is not None else None),
            local_family=(FamilySpec.from_dict(d["local_family"])
                          if d.get("local_family") is not None else None),
        )


@dataclasses.dataclass(frozen=True)
class RuntimeSpec:
    """Execution topology: the wire layout (``"flat"``, the default as in the
    reference; ``"fused"``, the CUDA kernels; ``"legacy"``, not ported), the
    federated mesh (:class:`~repro_torch.launch.mesh.MeshSpec`) and the
    reference's sanitizer default."""

    wire: str = "flat"
    mesh: MeshSpec = MeshSpec()
    sanitize: bool = False

    def __post_init__(self):
        if self.wire not in ("flat", "fused", "legacy"):
            raise ValueError(f"unknown wire layout {self.wire!r} (flat/fused/legacy)")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> RuntimeSpec:
        return cls(wire=d.get("wire", "flat"), mesh=MeshSpec.from_dict(d.get("mesh") or {}),
                   sanitize=d.get("sanitize", False))


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """The complete, serializable description of one federated run.

    Fields as the reference's: ``model``; ``scenario`` (algorithm,
    participation, stragglers, compression, aggregation, DP); ``strategy``
    (hyperparameters; its name must match ``scenario.algorithm``);
    ``num_silos``; ``rounds`` (the budget :meth:`Experiment.run` runs by
    default); ``local_steps``; ``server_opt``; ``local_opt`` (None mirrors
    ``server_opt``); ``eta_mode`` (``"barycenter"`` or ``"param"``);
    ``eval_every`` (0: no cadence); ``seed``; ``data_seed`` (None mirrors
    ``seed``); ``runtime``; ``population``.
    """

    model: ModelSpec
    scenario: Scenario = Scenario()
    strategy: Optional[StrategySpec] = None
    num_silos: int = 4
    rounds: int = 10
    local_steps: int = 1
    server_opt: OptimizerSpec = OptimizerSpec()
    local_opt: Optional[OptimizerSpec] = None
    eta_mode: str = "barycenter"
    eval_every: int = 0
    seed: int = 0
    data_seed: Optional[int] = None
    runtime: RuntimeSpec = RuntimeSpec()
    population: Optional[PopulationSpec] = None

    @property
    def algorithm(self) -> str:
        """The sync cadence, carried by the scenario."""
        return self.scenario.algorithm

    @property
    def name(self) -> str:
        """Human-readable label: model + the scenario's knob summary."""
        return f"{self.model.name} {self.scenario.name}"

    def to_dict(self) -> Dict[str, Any]:
        """Plain-dict form, JSON-ready (nested dataclasses flattened)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> ExperimentSpec:
        """Inverse of :meth:`to_dict`: ``from_dict(to_dict(s)) == s``."""
        return cls(
            model=ModelSpec.from_dict(d["model"]),
            scenario=Scenario.from_dict(d.get("scenario", {})),
            strategy=(StrategySpec.from_dict(d["strategy"])
                      if d.get("strategy") is not None else None),
            num_silos=d.get("num_silos", 4),
            rounds=d.get("rounds", 10),
            local_steps=d.get("local_steps", 1),
            server_opt=OptimizerSpec.from_dict(d.get("server_opt", {})),
            local_opt=(OptimizerSpec.from_dict(d["local_opt"])
                       if d.get("local_opt") is not None else None),
            eta_mode=d.get("eta_mode", "barycenter"),
            eval_every=d.get("eval_every", 0),
            seed=d.get("seed", 0),
            data_seed=d.get("data_seed"),
            runtime=RuntimeSpec.from_dict(d.get("runtime") or {}),
            population=(PopulationSpec.from_dict(d["population"])
                        if d.get("population") is not None else None),
        )

    def to_json(self, indent: int = 2) -> str:
        """JSON text of :meth:`to_dict` (what ``--dump-spec`` prints)."""
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> ExperimentSpec:
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        """Write the spec as JSON (atomically) to ``path``."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json() + "\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> ExperimentSpec:
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# build: spec -> Experiment
# ---------------------------------------------------------------------------


def _refuse_unported(spec: ExperimentSpec, wire: str) -> None:
    """Raise for what the port does not run, naming its ROADMAP item."""
    if wire == "legacy":
        raise ValueError(
            "runtime.wire='legacy' (the reference's per-leaf wire) is not ported "
            "(ROADMAP Queue 1 item 6); use 'flat' or 'fused'")
    if spec.runtime.sanitize:
        raise NotImplementedError(
            "runtime.sanitize is the reference's JAX trace machinery, left "
            "unported (ROADMAP Queue 1 item 6)")


def build(spec: ExperimentSpec, bundle=None, *, device=None) -> Experiment:
    """Assemble the runtime for ``spec`` on ``device`` (default ``cuda``).

    Resolves the model through the registry unless a pre-staged ``bundle``
    is given (the CLI and the parity tests stage one and share it), applies
    the spec's family overrides, and builds optimizers, aggregation,
    compression and the privacy policy from the spec.
    """
    return _build(spec, bundle, spec.runtime.wire, device)


def _bundle_num_obs(bundle) -> List[int]:
    """Per-silo N_j of the whole staged roster."""
    if bundle.num_obs is not None:
        return [int(n) for n in bundle.num_obs]
    return [int(tree_leaves(d)[0].shape[0]) for d in bundle.datas]


def _build(spec: ExperimentSpec, bundle, wire: str, device,
           joined: Optional[int] = None) -> Experiment:
    """The core of :func:`build`. Under a population the Server holds the
    silos joined so far: ``spec.population.initial``, or ``joined`` (the
    checkpoint's head-count) on resume."""
    from repro_torch.device import generator, resolve_device
    from repro_torch.federated.runtime import Server
    from repro_torch.models.paper.registry import apply_family_spec, get_model

    spec.scenario.validate(spec.num_silos)
    strat_spec = (spec.strategy if spec.strategy is not None
                  else StrategySpec(spec.scenario.algorithm))
    if strat_spec.name != spec.scenario.algorithm:
        raise ValueError(
            f"spec.strategy names {strat_spec.name!r} but scenario.algorithm is "
            f"{spec.scenario.algorithm!r}; they must agree (the scenario label "
            "drives scheduling/validation, the StrategySpec only adds "
            "hyperparameters)")
    strategy = strat_spec.build()
    _refuse_unported(spec, wire)
    device = distributed.rank_device(resolve_device(device))
    if bundle is None:
        data_seed = spec.data_seed if spec.data_seed is not None else spec.seed
        bundle = get_model(spec.model.name).build(
            data_seed, spec.num_silos, device=device, **spec.model.kwargs)
    if len(bundle.datas) != spec.num_silos:
        raise ValueError(
            f"bundle stages {len(bundle.datas)} silos, spec.num_silos is {spec.num_silos}")
    bundle = apply_family_spec(bundle, spec.model.global_family, spec.model.local_family)
    problem = bundle.problem
    has_local = problem.model.has_local
    local_spec = spec.local_opt if spec.local_opt is not None else spec.server_opt
    pop = spec.population
    j_live = spec.num_silos
    if pop is not None:
        j_live = int(joined) if joined is not None else min(pop.initial, spec.num_silos)
    num_obs_full = _bundle_num_obs(bundle)
    mesh = build_mesh(spec.runtime.mesh, num_silos=j_live)
    server = Server(
        problem, bundle.datas[:j_live], bundle.theta0,
        problem.global_family.init(generator(spec.seed, device)),
        num_obs=num_obs_full[:j_live],
        server_opt=spec.server_opt.build(),
        local_opt=local_spec.build() if has_local else None,
        aggregator=spec.scenario.make_aggregator(),
        compressor=spec.scenario.compressor(),
        eta_mode=spec.eta_mode,
        wire=wire,
        privacy=spec.scenario.privacy(),
        seed=spec.seed,
        strategy=strategy,
        # The estimators scale by the roster's width and total N: absent
        # silos are non-participants of the whole federation.
        federation_size=spec.num_silos,
        federation_obs=float(sum(num_obs_full)),
        mesh=mesh,
        device=device,
    )
    population = None if pop is None else PopulationEngine(pop, bundle, spec.num_silos)
    return Experiment(spec, bundle, server,
                      spec.scenario.scheduler(spec.num_silos, seed=spec.seed),
                      population=population)


# ---------------------------------------------------------------------------
# Experiment: run / evaluate / save / resume
# ---------------------------------------------------------------------------


class Experiment:
    """A built federated run: owns the Server, scheduler and round index.

    Construct through :func:`build` (or :meth:`resume`); drive with
    :meth:`run`. ``history`` accumulates across calls; ``round`` is the
    absolute number of rounds (async: flushes) completed so far.
    ``population`` churns the silos between rounds (None: a fixed
    federation); ``async_state`` is the async event loop's state (None
    until the first flush, or restored by :meth:`resume`).
    """

    def __init__(self, spec: ExperimentSpec, bundle, server, scheduler: RoundScheduler,
                 population: Optional[PopulationEngine] = None):
        self.spec = spec
        self.bundle = bundle
        self.server = server
        self.scheduler = scheduler
        self.population = population
        self.round = 0
        self.history: Dict[str, list] = {}
        self.async_state: Optional[BufferState] = None

    @property
    def theta(self) -> PyTree:
        return self.server.theta

    @property
    def eta_G(self) -> PyTree:
        return self.server.eta_G

    @property
    def eta_L(self) -> PyTree:
        return self.server.eta_L

    @property
    def comm(self):
        return self.server.comm

    @property
    def accountant(self):
        return self.server.accountant

    @property
    def remaining_rounds(self) -> int:
        return max(self.spec.rounds - self.round, 0)

    def warm_start(self, theta: Optional[PyTree] = None,
                   eta_G: Optional[PyTree] = None) -> Experiment:
        """Override the initial (θ, η_G), e.g. from a previous fit; the
        optimizer moments keep their fresh init."""
        if theta is not None:
            self.server.state["theta"] = theta
        if eta_G is not None:
            self.server.state["eta_G"] = eta_G
        return self

    def run(self, rounds: Optional[int] = None,
            callback: Optional[Callable[[int, dict], None]] = None,
            draws=None) -> Dict[str, list]:
        """Advance ``rounds`` rounds (default: the spec's remaining budget).

        ``callback(r, metrics)`` fires each round with the absolute round
        index, after ``self.round`` is brought up to date (so a callback may
        :meth:`save` mid-run); with ``eval_every`` the registry's eval
        metrics join the round's metrics and ``history["eval"]``. ``draws``
        injects the randomness (``Server.run``). With an async block the
        rounds are flushes of :func:`~repro_torch.federated.async_engine.run_buffered`,
        whose state lives on ``self.async_state``.
        """
        n = self.remaining_rounds if rounds is None else rounds
        if n <= 0:
            return self.history
        spec = self.spec
        start = self.round

        def cb(r: int, metrics: dict) -> None:
            self.round = r + 1
            if (spec.eval_every and self.bundle.eval_fn is not None
                    and (r + 1) % spec.eval_every == 0):
                scores = self.evaluate()
                metrics = dict(metrics, **scores)
                self.history.setdefault("eval", []).append({"round": r + 1, **scores})
            if callback is not None:
                callback(r, metrics)

        acfg = spec.scenario.async_cfg
        if acfg is not None:
            # Made before the loop, which mutates it in place: a callback
            # that saves mid-run checkpoints the live event loop.
            if self.async_state is None:
                self.async_state = BufferState.init(self.server.J, acfg, self.server.seed)
            chunk, self.async_state = run_buffered(
                self.server, n, acfg, local_steps=spec.local_steps, start_flush=start,
                state=self.async_state, callback=cb, population=self.population,
                draws=draws)
        else:
            chunk = self.server.run(n, local_steps=spec.local_steps,
                                    scheduler=self.scheduler, callback=cb,
                                    start_round=start, draws=draws,
                                    population=self.population)
        for k, v in chunk.items():
            self.history.setdefault(k, []).extend(v)
        self.round = start + n
        return self.history

    def evaluate(self) -> Dict[str, float]:
        """The registry's eval hook on the current state ({} if none). On a
        mesh of several ranks the hook sees the whole roster's η_L, gathered
        from every rank (so every rank must call this)."""
        if self.bundle.eval_fn is None:
            return {}
        srv = self.server
        if srv.mesh.distributed and tree_leaves(srv.state["eta_L"]):
            srv = _WholeRoster(srv.theta, srv.eta_G, srv.whole_silo_state("eta_L"))
        return dict(self.bundle.eval_fn(srv))

    # -- checkpointing ------------------------------------------------------

    def _meta_dict(self) -> Dict[str, Any]:
        meta: Dict[str, Any] = {
            "round": self.round,
            "comm": self.comm.state_dict(),
            # DP noise and int8 scales depend on the layout: a resume
            # rebuilds with the saved one.
            "wire": self.server.wire,
        }
        if self.accountant is not None:
            acct = self.accountant.state_dict()
            # JSON floats round-trip the float64 ledger exactly.
            meta["acct"] = {"rdp": [float(x) for x in np.asarray(acct["rdp"])],
                            "steps": int(acct["steps"])}
        if self.async_state is not None:
            meta["async_state"] = self.async_state.state_dict()
        if self.population is not None:
            meta["population"] = self.population.state.state_dict()
        return meta

    @staticmethod
    def _meta_path(directory: str, step: int) -> str:
        return os.path.join(directory, f"step_{step:08d}.meta.json")

    @staticmethod
    def _silo_state_tree(state: Dict[str, Any]) -> Dict[str, Any]:
        """Every stacked (J, ...) state group with leaves: η_{L_j} and its
        optimizer when Z_L ≠ ∅, the strategy's per-silo state when it
        keeps one."""
        silo_state: Dict[str, Any] = {}
        if tree_leaves(state["eta_L"]):
            silo_state["eta_L"] = state["eta_L"]
            silo_state["opt_local"] = state["opt_local"]
        if tree_leaves(state.get("strategy", {})):
            silo_state["strategy"] = state["strategy"]
        return silo_state

    def save(self, directory: str, keep: int = 3) -> str:
        """Persist the full round state under ``directory`` (the module
        docstring's layout; the ``keep`` newest steps are retained).

        On a mesh of several ranks every rank calls ``save`` on a directory
        they all see: the lead rank writes the spec, the server state and
        the meta sidecar, each rank writes the shards of the real silos it
        owns (:func:`~repro_torch.federated.distributed.row_owner_process`),
        and a barrier follows, so no rank goes on before the step is whole.
        Returns the directory."""
        srv = self.server
        mesh = srv.mesh
        os.makedirs(directory, exist_ok=True)
        mgr = CheckpointManager(directory, keep=keep)
        state = srv.state
        if mesh.lead:
            self.spec.save(os.path.join(directory, _SPEC_FILE))
            mgr.save(self.round, {k: state[k] for k in _SERVER_KEYS})
        silo_state = self._silo_state_tree(state)
        if silo_state:
            for j in srv.rows:
                if j < srv.J and distributed.row_owner_process(mesh, j, srv.J_pad) == mesh.rank:
                    row = tree_map(lambda x, jj=j: distributed.host_rows(
                        x, mesh, [jj], srv.J_pad)[jj], silo_state)
                    mgr.save(self.round, row, shard=f"silo_{j:04d}")
        if mesh.lead:
            path = self._meta_path(directory, self.round)
            with open(path + ".tmp", "w") as f:
                json.dump(self._meta_dict(), f)
            os.replace(path + ".tmp", path)
            # The JSON sidecars keep the msgpack files' retention.
            live = set(mgr.steps())
            for fn in os.listdir(directory):
                if fn.startswith("step_") and fn.endswith(".meta.json"):
                    s = fn[len("step_"):-len(".meta.json")]
                    if s.isdigit() and int(s) not in live:
                        os.remove(os.path.join(directory, fn))
        distributed.barrier(mesh, srv.device)
        return directory

    @classmethod
    def resume(cls, directory: str, spec: Optional[ExperimentSpec] = None,
               step: Optional[int] = None, bundle=None, *, device=None) -> Experiment:
        """Rebuild from ``directory`` and restore the saved round state.

        Reads ``spec.json`` (unless ``spec`` overrides it), rebuilds with the
        checkpoint's wire layout (the registry re-stages the data from the
        spec's seed, unless a ``bundle`` is given), then restores θ, η_G,
        the stacked silo state, both optimizers, the communication meter,
        the RDP ledger, the round index and, where saved, the async event
        loop and the population of the latest (or ``step``) checkpoint. A
        population run is rebuilt at the saved head-count. A silo with no
        shard on disk keeps its fresh init.
        """
        if spec is None:
            spec = ExperimentSpec.load(os.path.join(directory, _SPEC_FILE))
        mgr = CheckpointManager(directory)
        if step is None:
            step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory!r}")
        with open(cls._meta_path(directory, step)) as f:
            meta = json.load(f)
        pop_meta = meta.get("population")
        exp = _build(spec, bundle, meta.get("wire", spec.runtime.wire), device,
                     joined=None if pop_meta is None else int(pop_meta["joined"]))
        if exp.population is not None and pop_meta is not None:
            exp.population.state = PopulationState.from_state(pop_meta)
        state = exp.server.state
        restored = mgr.restore(step, {k: state[k] for k in _SERVER_KEYS})
        state.update(restored)
        silo_like = cls._silo_state_tree(state)
        if silo_like:
            # Each rank reads the shards of the real silos it holds; a silo
            # with no shard, and the padded rows, keep their fresh init.
            srv = exp.server
            loaded = {}
            for j in srv.rows:
                if j < srv.J and mgr.has(step, shard=f"silo_{j:04d}"):
                    like = tree_map(lambda x, jj=j: distributed.host_rows(
                        x, srv.mesh, [jj], srv.J_pad)[jj], silo_like)
                    loaded[j] = mgr.restore(step, like, shard=f"silo_{j:04d}")
            state.update(distributed.rows_to_block(silo_like, srv.mesh, loaded, srv.J_pad))
        exp.round = int(meta["round"])
        exp.comm.load_state(meta["comm"])
        if exp.accountant is not None and "acct" in meta:
            exp.accountant.load_state({"rdp": np.asarray(meta["acct"]["rdp"], np.float64),
                                       "steps": int(meta["acct"]["steps"])})
        if "async_state" in meta:
            exp.async_state = BufferState.from_state(meta["async_state"])
        return exp


@dataclasses.dataclass(frozen=True)
class _WholeRoster:
    """What an eval hook reads of a Server, with η_L of every silo."""

    theta: PyTree
    eta_G: PyTree
    eta_L: PyTree


def run_spec(spec: ExperimentSpec,
             callback: Optional[Callable[[int, dict], None]] = None, *,
             device=None) -> Experiment:
    """One-shot convenience: ``build(spec)`` then run the full budget."""
    exp = build(spec, device=device)
    exp.run(callback=callback)
    return exp


def scenario_specs(base: ExperimentSpec, scenarios: List[Scenario]) -> List[ExperimentSpec]:
    """Cross one base spec with a scenario list (the ``--sweep`` expansion)."""
    return [dataclasses.replace(base, scenario=sc) for sc in scenarios]
