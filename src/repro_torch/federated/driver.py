"""Generic metered round loop for step-function federations.

The port of ``repro/federated/driver.py``. The LLM train path
(``launch/train.py``) runs its server as a sum of gradients inside one
step function, so it cannot use :class:`~repro_torch.federated.runtime.
Server` (which owns the round itself) — but it wants the same per-round
communication accounting and logging hooks. ``run_rounds`` is that loop:
advance a step over a batch stream, bill a fixed (up, down) cost per round
into a :class:`CommMeter`, compose DP exchanges into an
:class:`~repro_torch.federated.privacy.RdpAccountant`, collect metrics.
``Server.run`` keeps its own loop because its billing depends on the
realized participation mask.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

from repro_torch.federated.metering import CommMeter
from repro_torch.federated.privacy import PrivacyPolicy, RdpAccountant

PyTree = Any
StepFn = Callable[[PyTree, Any, int], Tuple[PyTree, Dict[str, Any]]]
MetricsHook = Callable[[int, Dict[str, Any], PyTree], None]


def run_rounds(
    step_fn: StepFn,
    state: PyTree,
    batches: Iterable[Any],
    *,
    meter: Optional[CommMeter] = None,
    bytes_per_round: Tuple[int, int] = (0, 0),
    privacy: Optional[PrivacyPolicy] = None,
    accountant: Optional[RdpAccountant] = None,
    sampling_rate: float = 1.0,
    exchanges_per_round=1,
    on_metrics: Optional[MetricsHook] = None,
) -> Tuple[PyTree, Dict[str, list]]:
    """Drive ``state`` through ``step_fn`` once per batch.

    Args:
      step_fn: ``(state, batch, round_idx) -> (state, metrics)``; metrics
        values must be scalar-convertible.
      state: initial state, threaded through every step.
      batches: one element per round (list, generator, ...).
      meter: optional :class:`CommMeter`; ``bytes_per_round`` is the
        (up, down) cost recorded per round.
      privacy: optional DP policy. The loop does NOT apply the mechanism
        (that belongs inside ``step_fn``); it accounts it: each round
        composes ``exchanges_per_round`` sampled-Gaussian invocations at
        the policy's noise multiplier into ``accountant`` (one is created
        if None) and appends the cumulative ε at the policy's δ to
        ``history["epsilon"]`` and the round's metrics.
      accountant: accountant to compose into (shared across phases);
        ignored when ``privacy`` is None.
      sampling_rate: per-round silo sampling rate q for the accountant.
      exchanges_per_round: mechanism invocations per round — an int, or
        a callable ``round_idx -> int`` for cadenced schedules (SFVI
        pays one per step; SFVI-Avg one every ``avg_every`` steps, zero
        on the steps in between).
      on_metrics: per-round hook ``(round_idx, metrics, state)`` for
        logging or checkpointing; ``state`` is the post-step state.
        Metrics arrive as the step's raw (possibly still-on-device)
        scalars so the hook decides when to wait — formatting a value
        synchronizes; ignoring it keeps the card's queue full.

    Returns the final state and a dict of per-round metric lists (floats,
    read once after the loop so the loop itself never waits on the card).
    """
    raw_history: list = []
    up1, down1 = bytes_per_round
    if privacy is not None and accountant is None:
        accountant = RdpAccountant()
    for i, batch in enumerate(batches):
        state, metrics = step_fn(state, batch, i)
        if meter is not None:
            meter.record(up1, down1)
        if privacy is not None:
            n_ex = (exchanges_per_round(i) if callable(exchanges_per_round)
                    else exchanges_per_round)
            accountant.step(
                noise_multiplier=privacy.noise_multiplier,
                sampling_rate=sampling_rate,
                steps=n_ex,
            )
            metrics = dict(
                metrics, epsilon=accountant.epsilon(privacy.delta)[0]
            )
        raw_history.append(metrics)
        if on_metrics:
            on_metrics(i, metrics, state)
    history: Dict[str, list] = {}
    for metrics in raw_history:
        for k, v in metrics.items():
            history.setdefault(k, []).append(float(v))
    return state, history
