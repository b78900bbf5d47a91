"""Round scheduling: per-round participation masks over J silos.

Mirrors ``repro.federated.scheduler.RoundScheduler`` on the port's own
stream: masks are deterministic functions of (seed, round index) drawn
from a numpy ``Generator``, so a schedule replays exactly. The reference
draws from ``jax.random``; the two schedules differ for one seed, but
they follow the same rules — ``int(p·J + 0.5)`` invitations (half-up,
never banker's rounding) and, when stragglers would empty a round, the
lowest-index invited silo is kept.

Any object with ``mask(i)`` (and optionally ``invited(i)`` and
``participation``) can stand in for a scheduler, e.g. one that replays
another run's masks.

:class:`Scenario` bundles the orthogonal knobs of a run (algorithm,
participation, stragglers, wire compression, aggregation, differential
privacy, the async block) as in the reference, and
:func:`scenario_matrix` crosses them into the ``--sweep`` grid.
:class:`AsyncConfig` is the async block's data class only: the port
has no async engine yet, and ``federated.api.build`` refuses it.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence

import numpy as np

from repro_torch.federated.aggregation import (
    Int8Compressor,
    MeanAggregator,
    NoCompression,
    TrimmedMeanAggregator,
)
from repro_torch.federated.privacy import PrivacyPolicy
from repro_torch.federated.strategy import get_strategy, strategy_names

_ALGO_LABELS = {"sfvi": "SFVI", "sfvi_avg": "SFVI-Avg", "pvi": "PVI", "fed_ep": "FedEP"}


def algorithm_label(algorithm: str) -> str:
    """Human-readable label for a registry strategy name."""
    return _ALGO_LABELS.get(algorithm, algorithm.upper())


@dataclasses.dataclass(frozen=True)
class RoundScheduler:
    """Samples a per-round participation mask over J silos.

    Attributes:
      num_silos: J, the federation width.
      participation: fraction of silos invited each round (at least one).
      dropout: probability that an invited silo straggles after receiving
        the broadcast (its upload never arrives).
      seed: seed of the schedule.
    """

    num_silos: int
    participation: float = 1.0
    dropout: float = 0.0
    seed: int = 0

    def _rngs(self, round_idx: int):
        invite, drop = np.random.SeedSequence([self.seed, round_idx]).spawn(2)
        return np.random.default_rng(invite), np.random.default_rng(drop)

    def invited(self, round_idx: int) -> np.ndarray:
        """(J,) float32 mask of silos the server broadcasts to this round."""
        rng_inv, _ = self._rngs(round_idx)
        J = self.num_silos
        mask = np.ones((J,), np.float32)
        if self.participation < 1.0:
            n_inv = max(1, int(self.participation * J + 0.5))
            chosen = rng_inv.choice(J, size=n_inv, replace=False)
            mask = np.zeros((J,), np.float32)
            mask[chosen] = 1.0
        return mask

    def mask(self, round_idx: int) -> np.ndarray:
        """(J,) float32 mask: 1.0 = silo reports this round, 0.0 = absent."""
        _, rng_drop = self._rngs(round_idx)
        mask = self.invited(round_idx).copy()
        if self.dropout > 0.0:
            survive = (rng_drop.random(self.num_silos) < 1.0 - self.dropout)
            dropped = mask * survive.astype(np.float32)
            # Never lose the whole round: keep the lowest-index invited silo.
            mask = dropped if dropped.any() else _first_invited(mask)
        return mask


def _first_invited(mask: np.ndarray) -> np.ndarray:
    out = np.zeros_like(mask)
    out[int(np.argmax(mask))] = 1.0
    return out


# ---------------------------------------------------------------------------
# The async block and the scenario matrix (the reference's spec surface)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Knobs of buffered-asynchronous execution, as the reference's.

    JSON-native, so the block round-trips inside :class:`Scenario`:
    ``buffer_size`` contributions a flush, the staleness weight
    ``(1 + s)^-staleness_decay``, and the latency model (``"constant"``,
    ``"lognormal"`` or ``"straggler"``) with its scale, spread and
    straggler fraction and slowdown.
    """

    buffer_size: int = 2
    staleness_decay: float = 0.5
    latency: str = "lognormal"
    latency_scale: float = 1.0
    latency_sigma: float = 0.5
    straggler_frac: float = 0.1
    straggler_slowdown: float = 10.0

    @property
    def name(self) -> str:
        """Compact label fragment for scenario tables."""
        bits = [f"B={self.buffer_size}", self.latency]
        if self.staleness_decay:
            bits.append(f"d={self.staleness_decay:g}")
        return f"async({','.join(bits)})"


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named point in the runtime's scenario space (the reference's).

    Attributes: ``algorithm`` (a registered strategy name),
    ``participation``, ``dropout``, ``compression`` (``"none"`` or
    ``"int8"``), ``dp_noise`` (z; 0 disables DP), ``dp_clip`` (C),
    ``dp_delta``, ``dp_clip_only`` (clip without noise), ``aggregator``
    (``"mean"`` or ``"trimmed"``), ``trim_frac`` and ``async_cfg``.
    :meth:`scheduler`, :meth:`compressor`, :meth:`make_aggregator` and
    :meth:`privacy` build the port's runtime pieces.
    """

    algorithm: str = "sfvi_avg"
    participation: float = 1.0
    dropout: float = 0.0
    compression: str = "none"
    dp_noise: float = 0.0
    dp_clip: float = 1.0
    dp_delta: float = 1e-5
    dp_clip_only: bool = False
    aggregator: str = "mean"
    trim_frac: float = 0.1
    async_cfg: Optional[AsyncConfig] = None

    @property
    def name(self) -> str:
        """Compact human-readable label for tables and logs."""
        bits = [algorithm_label(self.algorithm)]
        if self.async_cfg is not None:
            bits.append(self.async_cfg.name)
        if self.participation < 1.0:
            bits.append(f"part={self.participation:g}")
        if self.dropout > 0.0:
            bits.append(f"drop={self.dropout:g}")
        if self.compression != "none":
            bits.append(self.compression)
        if self.dp_noise > 0.0:
            bits.append(f"dp(z={self.dp_noise:g},C={self.dp_clip:g})")
        elif self.dp_clip_only:
            bits.append(f"clip(C={self.dp_clip:g})")
        if self.aggregator != "mean":
            bits.append(f"{self.aggregator}({self.trim_frac:g})")
        return " ".join(bits)

    def validate(self, num_silos: Optional[int] = None) -> Scenario:
        """Reject meaningless knob combinations (returns self), as the
        reference does: an unknown algorithm, and an async block with a
        step-cadence strategy, partial participation or dropout, a buffer
        outside [1, J] or an unknown latency model."""
        try:
            strategy_cls = get_strategy(self.algorithm)
        except KeyError:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}; registered "
                f"strategies: {list(strategy_names())}") from None
        if self.async_cfg is None:
            return self
        if strategy_cls.cadence != "round":
            raise ValueError(
                f"async execution requires a round-cadence strategy "
                f"(sfvi_avg, pvi, fed_ep, ...); {self.algorithm!r} "
                "synchronizes every local step and has no round-granular "
                "contribution to buffer")
        if self.participation < 1.0 or self.dropout > 0.0:
            raise ValueError(
                "async scenarios model arrival dynamics with the latency "
                "model; set participation=1.0 and dropout=0.0 (got "
                f"participation={self.participation}, dropout={self.dropout})")
        if self.async_cfg.buffer_size < 1:
            raise ValueError("async buffer_size must be >= 1")
        if num_silos is not None and self.async_cfg.buffer_size > num_silos:
            raise ValueError(
                f"async buffer_size={self.async_cfg.buffer_size} exceeds "
                f"the federation width J={num_silos}")
        if self.async_cfg.latency not in ("constant", "lognormal", "straggler"):
            raise ValueError(
                f"unknown latency model {self.async_cfg.latency!r} "
                "(constant/lognormal/straggler)")
        return self

    @classmethod
    def from_dict(cls, d: dict) -> Scenario:
        """Inverse of ``dataclasses.asdict``; validates, so a hand-edited
        spec fails at load (the J-dependent checks run again at build)."""
        d = dict(d)
        if d.get("async_cfg") is not None:
            d["async_cfg"] = AsyncConfig(**d["async_cfg"])
        return cls(**d).validate()

    def scheduler(self, num_silos: int, seed: int = 0) -> RoundScheduler:
        """The participation/straggler schedule for this scenario."""
        return RoundScheduler(num_silos, participation=self.participation,
                              dropout=self.dropout, seed=seed)

    def compressor(self):
        """The wire codec for this scenario."""
        if self.compression == "int8":
            return Int8Compressor()
        if self.compression == "none":
            return NoCompression()
        raise ValueError(f"unknown compression {self.compression!r}")

    def make_aggregator(self):
        """The server combine rule for this scenario."""
        if self.aggregator == "trimmed":
            return TrimmedMeanAggregator(self.trim_frac)
        if self.aggregator == "mean":
            return MeanAggregator()
        raise ValueError(f"unknown aggregator {self.aggregator!r}")

    def privacy(self) -> Optional[PrivacyPolicy]:
        """The DP policy, or None when this scenario is non-private."""
        if self.dp_noise > 0.0 or self.dp_clip_only:
            return PrivacyPolicy(clip_norm=self.dp_clip, noise_multiplier=self.dp_noise,
                                 delta=self.dp_delta)
        return None


def scenario_matrix(
    *,
    algorithms: Sequence[str] = ("sfvi", "sfvi_avg"),
    participation: Sequence[float] = (1.0, 0.5),
    dropout: Sequence[float] = (0.0, 0.2),
    compression: Sequence[str] = ("none", "int8"),
    dp_noise: Sequence[float] = (0.0, 1.0),
    dp_clip: float = 1.0,
    dp_delta: float = 1e-5,
    async_cfgs: Sequence[Optional[AsyncConfig]] = (None,),
) -> list:
    """Cross participation × stragglers × compression × DP × async, minus
    the async rows of step-cadence algorithms or partial participation."""
    grid = []
    for algo, part, drop, comp, z, acfg in itertools.product(
            algorithms, participation, dropout, compression, dp_noise, async_cfgs):
        if acfg is not None and (
                get_strategy(algo).cadence != "round" or part < 1.0 or drop > 0.0):
            continue
        grid.append(Scenario(
            algorithm=algo, participation=part, dropout=drop, compression=comp,
            dp_noise=z, dp_clip=dp_clip, dp_delta=dp_delta, async_cfg=acfg))
    return grid
