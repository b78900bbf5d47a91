"""Buffered-asynchronous federated execution (FedBuff-style flushes).

The port of ``repro.federated.async_engine``. Every silo loops: pull the
current (θ, η_G), run ``local_steps`` local VI steps, upload, repeat. The
server buffers arriving contributions and applies one aggregate, a
**flush**, as soon as ``buffer_size`` of them wait, weighting each by
``(1 + staleness)^-staleness_decay``, where staleness counts the flushes
applied since that silo last pulled. Task latencies come from a
deterministic model keyed on ``(seed, silo, task)``, drawn from numpy
exactly as the reference draws them, so a run, a resumed run and the
reference's run see the same arrival schedule.

The event loop runs on the host (a tiny simulation) and yields per-flush
participation **counts** and **staleness**; each flush then runs the
round-cadence round of :class:`~repro_torch.federated.runtime.Server`
with the flush's mask (which silos ran and may update η_{L_j}) and its
staleness-decayed weights (the aggregation). On the fused wire those go
through the upload and combine CUDA kernels, so DP, int8 and the trimmed
mean apply to async flushes unchanged. With ``buffer_size == J`` and
constant latency every flush holds every silo at staleness 0 with weight
1, which is the synchronous round bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.federated.scheduler import AsyncConfig

# Salt of the latency stream (the reference's): it never collides with the
# round or DP-noise streams of the same user seed.
_LATENCY_SALT = 0x5AF0


def latency_draw(cfg: AsyncConfig, seed: int, silo: int, task: int) -> float:
    """Simulated seconds silo ``silo`` spends on its ``task``-th task.

    A pure function of ``(seed, silo, task)`` through numpy's
    ``SeedSequence``, equal bit for bit to the reference's draw.
    """
    if cfg.latency == "constant":
        return float(cfg.latency_scale)
    rng = np.random.default_rng([_LATENCY_SALT, seed, silo, task])
    if cfg.latency == "lognormal":
        return float(cfg.latency_scale * math.exp(cfg.latency_sigma * rng.standard_normal()))
    if cfg.latency == "straggler":
        slow = rng.random() < cfg.straggler_frac
        return float(cfg.latency_scale * (cfg.straggler_slowdown if slow else 1.0))
    raise ValueError(f"unknown latency model {cfg.latency!r} (constant/lognormal/straggler)")


@dataclasses.dataclass
class BufferState:
    """The server's event-loop state between flushes (the reference's).

    ``version`` (flushes applied), ``clock`` and ``last_flush`` (simulated
    seconds), per silo the in-flight task's index, pulled version, start
    and finish time, and ``buffer``: the pending (silo, staleness)
    contributions in arrival order. :meth:`state_dict` is JSON whose
    floats round-trip exactly (``repr``), so a resume continues the
    arrival schedule bit for bit mid-buffer.
    """

    version: int
    clock: float
    last_flush: float
    task_idx: List[int]
    start_version: List[int]
    start_time: List[float]
    finish_time: List[float]
    buffer: List[Tuple[int, int]]

    @classmethod
    def init(cls, num_silos: int, cfg: AsyncConfig, seed: int) -> BufferState:
        """All silos pull version 0 at t = 0 and start their first task."""
        return cls(version=0, clock=0.0, last_flush=0.0, task_idx=[0] * num_silos,
                   start_version=[0] * num_silos, start_time=[0.0] * num_silos,
                   finish_time=[latency_draw(cfg, seed, j, 0) for j in range(num_silos)],
                   buffer=[])

    def state_dict(self) -> Dict[str, Any]:
        """JSON-native snapshot (checkpointed by ``federated.api``)."""
        return {
            "version": self.version,
            "clock": self.clock,
            "last_flush": self.last_flush,
            "task_idx": list(self.task_idx),
            "start_version": list(self.start_version),
            "start_time": list(self.start_time),
            "finish_time": list(self.finish_time),
            "buffer": [[int(j), int(s)] for j, s in self.buffer],
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> BufferState:
        """Inverse of :meth:`state_dict`."""
        return cls(
            version=int(state["version"]),
            clock=float(state["clock"]),
            last_flush=float(state["last_flush"]),
            task_idx=[int(x) for x in state["task_idx"]],
            start_version=[int(x) for x in state["start_version"]],
            start_time=[float(x) for x in state["start_time"]],
            finish_time=[float(x) for x in state["finish_time"]],
            buffer=[(int(j), int(s)) for j, s in state["buffer"]],
        )


def simulate_flush(state: BufferState, cfg: AsyncConfig, seed: int, num_silos: int,
                   active: Optional[List[int]] = None) -> Tuple[np.ndarray, np.ndarray, float]:
    """Advance the event loop to the next flush; mutates ``state``.

    Pops arrivals in (finish time, silo) order, buffers each with its
    staleness (versions since that silo's pull, taken at buffering time)
    and restarts the silo on a fresh task at the current version. When
    ``buffer_size`` contributions wait (at most the active head-count),
    returns the per-silo counts (a fast silo can land twice), the
    staleness vector (a duplicate keeps its latest) and the flush time,
    bumps the version and clears the buffer. A silo restarted in this
    drain at the flush instant pulls the post-flush model. ``active``
    (population churn) restricts the pops to present silos: a departed
    silo's in-flight task is frozen until it returns.
    """
    J = num_silos
    pool = list(range(J)) if active is None else [i for i in range(J) if active[i]]
    if not pool:
        raise ValueError("simulate_flush needs at least one active silo")
    target = min(cfg.buffer_size, len(pool))
    restarted = set()
    while len(state.buffer) < target:
        j = min(pool, key=lambda i: (state.finish_time[i], i))
        state.clock = state.finish_time[j]
        state.buffer.append((j, state.version - state.start_version[j]))
        state.task_idx[j] += 1
        state.start_version[j] = state.version
        state.start_time[j] = state.clock
        state.finish_time[j] = state.clock + latency_draw(cfg, seed, j, state.task_idx[j])
        restarted.add(j)
    counts = np.zeros((J,), np.float32)
    staleness = np.zeros((J,), np.float32)
    for j, s in state.buffer:
        counts[j] += 1.0
        staleness[j] = float(s)
    flush_time = state.clock
    state.version += 1
    state.buffer = []
    for j in restarted:
        # Only this drain's restarts at the flush instant see the new
        # version; an earlier flush at the same timestamp keeps its pull.
        if state.start_time[j] == flush_time:
            state.start_version[j] = state.version
    return counts, staleness, flush_time


def flush_weights(counts: np.ndarray, staleness: np.ndarray, decay: float) -> np.ndarray:
    """Aggregation weights ``count · (1 + staleness)^-decay`` per silo.

    Staleness 0 gives exactly ``count``; the combine normalizes by the
    realized Σw, so the weights act relative to the buffer's others.
    """
    return (counts * (1.0 + staleness) ** (-decay)).astype(np.float32)


def run_buffered(
    server,
    num_flushes: int,
    cfg: AsyncConfig,
    *,
    algorithm=None,
    local_steps: int = 1,
    start_flush: int = 0,
    state: Optional[BufferState] = None,
    callback: Optional[Callable[[int, dict], None]] = None,
    population=None,
    draws=None,
) -> Tuple[Dict[str, list], BufferState]:
    """Drive a :class:`~repro_torch.federated.runtime.Server` asynchronously.

    Each flush runs the server's round-cadence round (``algorithm``, the
    server's own strategy when None) with the flush's mask and its
    staleness-decayed weights; step-cadence strategies are refused.
    ``start_flush`` is the absolute flush index, which plays the round
    index of the draws (``draws(f, t)``, as ``Server.run``'s hook), so a
    resume given the saved :class:`BufferState` replays bit for bit.

    Billing: ``counts.sum()`` contributions up and as many broadcast pulls
    down, and the simulated seconds since the previous flush on the meter
    (``history["sim_time"]`` holds the absolute flush times). Under DP
    each flush is one Gaussian mechanism, composed at q = buffer_size / J.
    ``population`` (a :class:`~repro_torch.federated.population.PopulationEngine`)
    processes churn before each flush and gives the active pool.

    Returns ``(history, state)``; pass ``state`` back in to continue.
    """
    if local_steps < 1:
        raise ValueError(f"local_steps must be >= 1, got {local_steps}")
    J = server.J
    if not 1 <= cfg.buffer_size <= J:
        raise ValueError(f"buffer_size must be in [1, J={J}], got {cfg.buffer_size}")
    strat = server._resolve(algorithm)
    if strat.cadence != "round":
        raise ValueError(
            f"buffered-async execution needs a round-cadence strategy; "
            f"{strat.name!r} synchronizes every local step")
    strat.validate(server)
    server._ensure_strategy_state(strat)
    if state is None:
        state = BufferState.init(J, cfg, server.seed)
    up1 = server.bytes_up_per_silo(strat)
    down1 = server.bytes_down_per_silo()
    history: Dict[str, list] = {
        "elbo": [], "elbo_trace": [], "bytes_up": [], "bytes_down": [],
        "n_active": [], "staleness": [], "sim_time": [],
    }
    if server.accountant is not None:
        history["epsilon"] = []
        q = cfg.buffer_size / J
    dev = server.device
    for f in range(start_flush, start_flush + num_flushes):
        active = None
        if population is not None:
            # Churn first: a join grows the silo axis and the event loop's
            # per-silo task lists at the current clock.
            active = population.begin_flush(server, state, cfg, f)
            J = server.J
        counts, staleness, t_flush = simulate_flush(state, cfg, server.seed, J, active=active)
        mask = (counts > 0.0).astype(np.float32)
        weights = flush_weights(counts, staleness, cfg.staleness_decay)
        elbos = server._round_round(strat, local_steps, torch.as_tensor(mask, device=dev),
                                    torch.as_tensor(weights, device=dev), f, draws)
        elbos = elbos.detach().cpu().numpy()
        n_contrib = int(counts.sum())
        n_active = int((counts > 0).sum())
        up, down = n_contrib * up1, n_contrib * down1
        sim_dt = t_flush - state.last_flush
        state.last_flush = t_flush
        server.comm.record(up, down, sim_seconds=sim_dt)
        stale_max = float(staleness.max(initial=0.0, where=counts > 0))
        history["elbo"].append(float(elbos[-1]))
        history["elbo_trace"].extend(float(e) for e in elbos)
        history["bytes_up"].append(up)
        history["bytes_down"].append(down)
        history["n_active"].append(n_active)
        history["staleness"].append(stale_max)
        history["sim_time"].append(t_flush)
        metrics = {"elbo": history["elbo"][-1], "bytes_up": up, "bytes_down": down,
                   "n_active": n_active, "staleness": stale_max, "sim_time": t_flush,
                   "weights": weights}
        if server.accountant is not None:
            server.accountant.step(noise_multiplier=server.privacy.noise_multiplier,
                                   sampling_rate=q, steps=1)
            eps = server.accountant.epsilon(server.privacy.delta)[0]
            history["epsilon"].append(eps)
            metrics["epsilon"] = eps
        if callback:
            callback(f, metrics)
    return history, state
