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
"""
from __future__ import annotations

import dataclasses

import numpy as np

_ALGO_LABELS = {"sfvi": "SFVI", "sfvi_avg": "SFVI-Avg"}


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
