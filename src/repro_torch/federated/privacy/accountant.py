"""RDP (moments) accountant for the federated Gaussian mechanism.

A numpy copy of ``repro.federated.privacy.accountant`` (the reference is
pure numpy too); the port keeps its own copy so it imports nothing of
the reference package.

Tracks the cumulative Rényi differential privacy of a sequence of
(sub)sampled-Gaussian-mechanism invocations — one per silo→server
exchange of the DP round — and converts to (ε, δ) on demand. Pure
numpy/host-side: accounting runs *outside* the compiled round (the
mechanism itself lives in :mod:`repro_torch.federated.privacy.policy`), so it
adds zero graph cost.

Formulas (all standard):

  * Gaussian mechanism, no subsampling (q = 1), Mironov (2017) Prop. 7:
        RDP(α) = α / (2 σ²)            for any order α > 1.
  * Poisson-subsampled Gaussian at integer orders α, the exact
    expression of Mironov, Talwar & Zhang (2019), Thm. 5 — identical to
    tensorflow-privacy's ``_compute_log_a_int``:
        RDP(α) = 1/(α−1) · log Σ_{k=0..α} C(α,k) (1−q)^{α−k} q^k
                                          · exp(k(k−1) / (2σ²)).
  * Composition is additive per order (RDP's raison d'être).
  * Conversion, Mironov (2017) Prop. 3:
        ε(δ) = min_α [ RDP(α) + log(1/δ) / (α−1) ].

The default order grid is integers (exact at q < 1; fractional orders
would need the quadrature bound of Mironov et al. §3.3, which never
changes the minimum by much on this grid). The subsampling bound assumes
Poisson sampling; the :class:`~repro_torch.federated.scheduler.RoundScheduler`
invites a fixed-size uniform subset, for which the Poisson-q bound is
the standard (slightly optimistic in δ, standard-practice) surrogate —
see docs/privacy.md for the threat model and this caveat.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import numpy as np

# Integer orders: dense where the optimum usually lands, sparse tail for
# very private / very subsampled regimes.
DEFAULT_ORDERS: Tuple[int, ...] = tuple(range(2, 65)) + (
    72, 80, 96, 128, 160, 192, 256, 384, 512,
)


def _log_comb(n: int, k: int) -> float:
    return (
        math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)
    )


def _logsumexp(xs: Sequence[float]) -> float:
    m = max(xs)
    if m == -math.inf:
        return -math.inf
    return m + math.log(sum(math.exp(x - m) for x in xs))


def rdp_sampled_gaussian(
    q: float, noise_multiplier: float, orders: Sequence[int]
) -> np.ndarray:
    """Per-order RDP of ONE sampled-Gaussian invocation.

    Args:
      q: sampling rate in (0, 1]; 1 means every silo participates.
      noise_multiplier: σ, the noise std in units of the clip norm.
      orders: integer RDP orders (α ≥ 2).

    Returns ``float64`` array of RDP values, one per order (``inf`` when
    σ = 0: no noise means no RDP guarantee).
    """
    if not (0.0 < q <= 1.0):
        raise ValueError(f"sampling rate must be in (0, 1], got {q}")
    if noise_multiplier < 0:
        raise ValueError(f"noise_multiplier must be >= 0, got {noise_multiplier}")
    out = np.empty(len(orders), np.float64)
    if noise_multiplier == 0.0:
        out.fill(math.inf)
        return out
    s2 = float(noise_multiplier) ** 2
    for i, alpha in enumerate(orders):
        a = int(alpha)
        if a != alpha or a < 2:
            raise ValueError(f"orders must be integers >= 2, got {alpha}")
        if q == 1.0:
            out[i] = a / (2.0 * s2)
            continue
        terms = [
            _log_comb(a, k)
            + (a - k) * math.log1p(-q)
            + (k * math.log(q) if k else 0.0)
            + k * (k - 1) / (2.0 * s2)
            for k in range(a + 1)
        ]
        out[i] = _logsumexp(terms) / (a - 1)
    return out


def rdp_to_epsilon(
    rdp: np.ndarray, orders: Sequence[int], delta: float
) -> Tuple[float, int]:
    """(ε, best order) from a per-order RDP curve at target δ."""
    if not (0.0 < delta < 1.0):
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    orders = np.asarray(orders, np.float64)
    eps = np.asarray(rdp, np.float64) + math.log(1.0 / delta) / (orders - 1.0)
    i = int(np.argmin(eps))
    return float(eps[i]), int(orders[i])


@dataclasses.dataclass
class RdpAccountant:
    """Composes sampled-Gaussian rounds; reports cumulative (ε, δ).

    One accountant instance rides one federation (the ``Server`` owns
    it): every DP exchange calls :meth:`step`, and :meth:`epsilon` can
    be read at any time — per round for the history trace, once at the
    end for the headline number.
    """

    orders: Sequence[int] = DEFAULT_ORDERS

    def __post_init__(self):
        self._rdp = np.zeros(len(self.orders), np.float64)
        self._steps = 0

    @property
    def steps(self) -> int:
        """Number of mechanism invocations composed so far."""
        return self._steps

    @property
    def rdp(self) -> np.ndarray:
        """Cumulative per-order RDP curve (copy)."""
        return self._rdp.copy()

    def step(
        self,
        *,
        noise_multiplier: float,
        sampling_rate: float = 1.0,
        steps: int = 1,
    ) -> None:
        """Compose ``steps`` invocations at (σ, q) into the running total."""
        if steps < 0:
            raise ValueError(f"steps must be >= 0, got {steps}")
        if steps == 0:
            return
        self._rdp += steps * rdp_sampled_gaussian(
            sampling_rate, noise_multiplier, self.orders
        )
        self._steps += steps

    def state_dict(self) -> Dict[str, object]:
        """Serializable ledger: cumulative per-order RDP + step count.

        Checkpointed by ``federated.api.Experiment.save`` so a resumed
        run keeps composing on top of the pre-interruption privacy loss
        instead of restarting the ledger at ε = 0.
        """
        return {"rdp": self._rdp.copy(), "steps": self._steps}

    def load_state(self, state: Dict[str, object]) -> None:
        """Restore a ledger saved by :meth:`state_dict`."""
        rdp = np.asarray(state["rdp"], np.float64)
        if rdp.shape != self._rdp.shape:
            raise ValueError(
                f"ledger has {rdp.shape[0]} orders, accountant expects "
                f"{self._rdp.shape[0]} — order grids must match"
            )
        self._rdp = rdp.copy()
        self._steps = int(state["steps"])

    def epsilon(self, delta: float) -> Tuple[float, int]:
        """Cumulative (ε, optimal order) at target ``delta``."""
        if self._steps == 0:
            return 0.0, int(self.orders[0])
        return rdp_to_epsilon(self._rdp, self.orders, delta)

    def summary(self, delta: float) -> Dict[str, float]:
        """Flat dict for logs/benchmarks: ε, δ, steps, argmin order."""
        eps, order = self.epsilon(delta)
        return {
            "epsilon": eps,
            "delta": delta,
            "mechanism_steps": float(self._steps),
            "rdp_order": float(order),
        }
