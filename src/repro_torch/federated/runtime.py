"""The federated round on one device: ``Server`` (the port of ``repro.federated.runtime``).

All J silos advance together: silo state (η_{L_j}, its optimizer state)
and data are stacked along a leading silo axis, and the per-silo
strategy hooks run under ``torch.func.vmap`` over that axis. On one
device the cross-silo gather is the identity, so the reference's mesh
padding, ``shard_map`` and graph cache have no counterpart (J_pad == J).

Each upload is packed into ONE float32 row (the flat wire,
:class:`~repro_torch.core.flatten.TreeSpec`), so the stacked uploads are
one ``(J, P)`` matrix. Two wire layouts:

  * ``wire="fused"`` (default) — the upload pipeline (clip + DP noise +
    mask + int8 quantize) and the server reduction run as the CUDA
    kernels of :mod:`repro_torch.kernels.wire` on the stacked matrix;
    their plain versions on a CPU device.
  * ``wire="flat"`` — the plain per-silo stages of
    :mod:`~repro_torch.federated.privacy.policy` and
    :mod:`~repro_torch.federated.aggregation`, as in the reference.

The fused dispatch follows the reference: the step cadence dequantizes
int8 inside the combine kernel; the round cadence materializes the
dequantized matrix (the barycenter needs every upload) and then
combines; an aggregator without ``fused_reduction`` falls back to its
``combine``. On the fused wire the strategies' merges (the combined
row, and the barycenter's moments) run as the combine kernel too
(:class:`FusedReduction`); a merge nobody reads is not computed.

Randomness. ``Server.run`` takes an optional ``draws(r, t)`` hook that
returns ``(eps_G, eps_L, noise)`` for local step ``t`` of round ``r``:
ε_G shared by all silos, the stacked (J, ...) ε_{L_j} (None when
Z_L = ∅), and the (J, P) N(0, I) DP noise (None without DP noise).
Without a hook the port draws them from a ``torch.Generator`` on the
device, seeded from (seed, r, t); the DP noise is one ``(J, P)``
``randn`` that the flat and fused wires consume alike. The round
cadence uploads once, with the noise of step 0.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core.family import supports_moments
from repro_torch.core.flatten import TreeSpec
from repro_torch.device import generator, resolve_device
from repro_torch.federated.aggregation import MeanAggregator, NoCompression
from repro_torch.federated.metering import CommMeter
from repro_torch.federated.privacy import PrivacyPolicy, RdpAccountant
from repro_torch.federated.scheduler import RoundScheduler
from repro_torch.federated.strategy import (
    DEFAULT_STRATEGY,
    ServerStrategy,
    StrategyContext,
    global_eps,
    resolve_strategy,
    silo_eps,
)
from repro_torch.kernels import wire as wire_kernels
from repro_torch.optim.base import GradientTransformation
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["FusedReduction", "Server", "stack_silos"]

PyTree = Any
Draws = Callable[[int, int], tuple]


def stack_silos(datas: Sequence[PyTree]) -> PyTree:
    """Stack J per-silo data pytrees along a new leading silo axis."""
    return tree_map(lambda *xs: torch.stack(xs), *datas)


@dataclasses.dataclass(frozen=True)
class FusedReduction:
    """An aggregator's reduction run as the ``fused_combine`` kernel.

    ``combine(stacked, weights)`` takes one (J, ...) tensor, such as the
    wire matrix or the barycenter's stacked moments, and returns the
    weighted mean (``trim_frac`` None) or the trimmed mean over axis 0.
    """

    trim_frac: Optional[float] = None

    def combine(self, stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        rows = stacked.reshape(stacked.shape[0], -1).contiguous()
        out = wire_kernels.fused_combine(rows, weights, trim_frac=self.trim_frac)
        return out.reshape(stacked.shape[1:])


def _wire_codec(comp) -> str:
    """The compressor's fused-wire capability (``"custom"`` if undeclared)."""
    return getattr(comp, "wire_codec", "custom")


class Server:
    """Round-based federation driver over J stacked silos on one device.

    Args mirror the reference ``Server`` (see its docstring), minus the
    mesh: ``problem``, ``datas`` (J per-silo dicts of tensors with equal
    shapes), ``theta``, ``eta_G``, ``num_obs``, ``server_opt``,
    ``local_opt``, ``aggregator``, ``compressor``, ``eta_mode``
    (``"barycenter"``/``"param"``), ``privacy``, ``seed``, ``strategy``,
    ``federation_size``, ``federation_obs``; plus

      wire: ``"fused"`` (default; the CUDA kernels) or ``"flat"``.
      device: where the federation lives; default ``cuda`` (raises when
        CUDA is absent — pass ``"cpu"`` to run on the CPU).
    """

    def __init__(
        self,
        problem,
        datas: Sequence[PyTree],
        theta: PyTree,
        eta_G: PyTree,
        *,
        num_obs: Optional[Sequence[int]] = None,
        server_opt: GradientTransformation,
        local_opt: Optional[GradientTransformation] = None,
        aggregator=None,
        compressor=None,
        eta_mode: str = "barycenter",
        wire: str = "fused",
        privacy: Optional[PrivacyPolicy] = None,
        seed: int = 0,
        strategy=None,
        federation_size: Optional[int] = None,
        federation_obs: Optional[float] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        dev = self.device
        self.problem = problem
        self.J = len(datas)
        self.aggregator = aggregator or MeanAggregator()
        self.compressor = compressor or NoCompression()
        self.privacy = privacy
        self.accountant = RdpAccountant() if privacy is not None else None
        self.data = tree_map(lambda x: x.to(dev), stack_silos(list(datas)))
        self.seed = seed
        self._server_opt = server_opt
        self._local_opt = local_opt
        self._has_local = problem.model.has_local
        if eta_mode not in ("barycenter", "param"):
            raise ValueError(f"unknown eta_mode {eta_mode!r}")
        if eta_mode == "barycenter" and not supports_moments(problem.global_family):
            raise ValueError(
                "eta_mode='barycenter' needs a global family exposing "
                "to_moments/from_moments; pass eta_mode='param' for "
                f"{type(problem.global_family).__name__}")
        self.eta_mode = eta_mode
        if wire not in ("flat", "fused"):
            raise ValueError(f"unknown wire layout {wire!r} (flat/fused)")
        self.wire = wire
        if num_obs is None:
            num_obs = [int(tree_leaves(d)[0].shape[0]) for d in datas]
        self.num_obs = np.asarray(list(num_obs), np.float32)
        self.fed_J = self.J if federation_size is None else int(federation_size)
        self.fed_obs = (float(np.sum(self.num_obs)) if federation_obs is None
                        else float(federation_obs))

        theta = tree_map(lambda x: x.to(dev), theta)
        eta_G = tree_map(lambda x: x.to(dev), eta_G)
        if self._has_local:
            if local_opt is None:
                raise ValueError("local_opt is required when the model has Z_L")
            gen = generator(seed + 1, dev)
            eta_L = stack_silos([problem.local_family.init(gen) for _ in range(self.J)])
            opt_L = vmap(local_opt.init)(eta_L)
        else:
            eta_L, opt_L = {}, {}
        self._strategy = resolve_strategy(
            strategy if strategy is not None else DEFAULT_STRATEGY)
        self._strategy.validate(self)
        self.state: Dict[str, PyTree] = {
            "theta": theta,
            "eta_G": eta_G,
            "eta_L": eta_L,
            "opt_server": server_opt.init({"theta": theta, "eta_G": eta_G}),
            "opt_local": opt_L,
            "strategy": {},
        }
        self.comm = CommMeter()

    # -- accessors ------------------------------------------------------------

    @property
    def theta(self) -> PyTree:
        return self.state["theta"]

    @property
    def eta_G(self) -> PyTree:
        return self.state["eta_G"]

    @property
    def eta_L(self) -> PyTree:
        """Stacked per-silo variational parameters η_{L_j} (leading axis J)."""
        return self.state["eta_L"]

    @property
    def strategy(self) -> ServerStrategy:
        return self._strategy

    def _resolve(self, algorithm) -> ServerStrategy:
        return self._strategy if algorithm is None else resolve_strategy(algorithm)

    # -- wire accounting ------------------------------------------------------

    def ship_template(self, algorithm=None) -> PyTree:
        """Shape-only pytree of one silo's upload (pre-compression)."""
        return self._resolve(algorithm).ship_template(self)

    def wire_spec(self, algorithm=None) -> TreeSpec:
        """The flat wire bijection of one upload (P = its dim)."""
        return TreeSpec.of(self.ship_template(algorithm))

    def bytes_up_per_silo(self, algorithm=None) -> int:
        """Post-compression upload bytes for one silo, one exchange."""
        return self.compressor.wire_bytes(self.ship_template(algorithm), wire=self.wire)

    def bytes_down_per_silo(self) -> int:
        """Broadcast bytes: (θ, η_G) raw; the round seed is ~0 and elided."""
        return NoCompression().wire_bytes(
            {"theta": self.state["theta"], "eta_G": self.state["eta_G"]})

    # -- one round's pieces ---------------------------------------------------

    def _reduction(self):
        """The merge of stacked uploads: the fused kernel where one applies."""
        fused = getattr(self.aggregator, "fused_reduction", None)
        if self.wire != "fused" or fused not in ("mean", "trimmed"):
            return self.aggregator
        return FusedReduction(
            float(self.aggregator.trim_frac) if fused == "trimmed" else None)

    def _ctx(self, K: int, wire: TreeSpec) -> StrategyContext:
        return StrategyContext(
            problem=self.problem, J=self.fed_J, K=K,
            server_opt=self._server_opt, local_opt=self._local_opt,
            has_local=self._has_local, eta_mode=self.eta_mode,
            aggregator=self._reduction(), wire=wire,
            fused=self.wire == "fused", total_obs=self.fed_obs)

    def _packed_reference(self, strat, ctx, wire, theta, eta_G):
        ref = strat.reference_tree(ctx, theta, eta_G)
        return None if ref is None else wire.pack(ref)

    def _noise_on(self) -> bool:
        return self.privacy is not None and self.privacy.noise_multiplier > 0.0

    def _upload(self, mat, mask, noise, ref):
        """The stacked (J, P) uploads -> what crosses the wire (encoded)."""
        comp, privacy = self.compressor, self.privacy
        codec = _wire_codec(comp)
        if self.wire == "fused":
            out = wire_kernels.fused_upload(
                mat, mask=mask, noise=noise if self._noise_on() else None,
                reference=ref,
                clip_norm=None if privacy is None else privacy.clip_norm,
                noise_multiplier=0.0 if privacy is None else privacy.noise_multiplier,
                quantize=codec == "int8")
            if codec == "int8":
                return {"q": out[0], "scale": out[1]}
            if codec == "identity":
                return out
            return [comp.encode(row) for row in out]
        # Flat wire: each silo privatizes against the reference, ships the
        # data-independent fallback if it did not participate, and encodes.
        encs = []
        for j in range(mat.shape[0]):
            ship = mat[j]
            if privacy is not None:
                draw = noise[j] if self._noise_on() else torch.zeros_like(ship)
                ship = privacy.privatize(ship, draw, reference=ref)
            idle = ref if ref is not None else torch.zeros_like(ship)
            ship = torch.where(mask[j] > 0.5, ship, idle)
            encs.append(comp.encode(ship))
        return encs

    def _decode(self, enc) -> torch.Tensor:
        """What crossed the wire -> the dequantized (J, P) float32 matrix."""
        if self.wire == "fused":
            codec = _wire_codec(self.compressor)
            if codec == "int8":
                return enc["q"].float() * enc["scale"][:, None]
            if codec == "identity":
                return enc
        return torch.stack([self.compressor.decode(e) for e in enc])

    def _draw(self, draws: Optional[Draws], r: int, t: int, P: int) -> tuple:
        if draws is not None:
            eps_G, eps_L, noise = draws(r, t)
            dev = self.device
            return (eps_G.to(dev), None if eps_L is None else eps_L.to(dev),
                    None if noise is None else noise.to(dev))
        gen = generator((self.seed, r, t), self.device)
        eps_G = global_eps(self.problem, gen)
        eps_L = silo_eps(self.problem, gen, self.J)
        noise = (torch.randn((self.J, P), generator=gen, device=self.device)
                 if self._noise_on() else None)
        return eps_G, eps_L, noise

    def _silo_in_dims(self, eps_L_dim: Optional[int]):
        # eta_L, opt_L, data, mask, n_obs, per-silo eps
        return (0, 0, 0, 0, 0, None if not self._has_local else eps_L_dim)

    def _step_round(self, strat, K, masks, weights, r, draws) -> torch.Tensor:
        """Round = K synchronized steps: upload + combine + server update each."""
        wire = self.wire_spec(strat)
        ctx = self._ctx(K, wire)
        merge = ctx.aggregator
        int8 = _wire_codec(self.compressor) == "int8"
        s = self.state
        theta, eta_G, opt_server = s["theta"], s["eta_G"], s["opt_server"]
        eta_L, opt_L = s["eta_L"], s["opt_local"]
        n_j = torch.as_tensor(self.num_obs, device=self.device)
        elbos = []
        for t in range(K):
            m, w = masks[t], weights[t]
            n_active = torch.clamp(torch.sum(m), min=1.0)
            eps_G, eps_L, noise = self._draw(draws, r, t, wire.dim)
            ref = self._packed_reference(strat, ctx, wire, theta, eta_G)

            def per_silo(eta_Lj, opt_Lj, data_j, m_j, n_obs_j, eps_Lj,
                         theta=theta, eta_G=eta_G, eps_G=eps_G):
                eta_Lj, opt_Lj, ship, hatLj = strat.silo_step(
                    ctx, theta, eta_G, eta_Lj, opt_Lj, data_j, m_j, n_obs_j,
                    eps_G, eps_Lj)
                return eta_Lj, opt_Lj, ship, hatLj * m_j

            eta_L, opt_L, ship, hatL = vmap(per_silo, in_dims=self._silo_in_dims(0))(
                eta_L, opt_L, self.data, m, n_j, eps_L)
            enc = self._upload(wire.pack(ship, batch_ndim=1), m, noise, ref)
            hatL_sum = torch.sum(hatL)
            if int8 and isinstance(merge, FusedReduction):
                # Dequantize inside the reduction kernel: the server never
                # materializes the dequantized (J, P) matrix.
                mean_g = wire_kernels.fused_combine(
                    enc["q"], w, scales=enc["scale"], trim_frac=merge.trim_frac)
            else:
                mean_g = merge.combine(self._decode(enc), w)
            theta, eta_G, opt_server, elbo = strat.server_step(
                ctx, theta, eta_G, opt_server, wire.unpack(mean_g), hatL_sum,
                n_active, eps_G)
            elbos.append(elbo)
        s.update(theta=theta, eta_G=eta_G, opt_server=opt_server,
                 eta_L=eta_L, opt_local=opt_L)
        return torch.stack(elbos)

    def _round_round(self, strat, K, mask, w, r, draws) -> torch.Tensor:
        """Round = K local steps per silo, ONE upload + one server merge."""
        wire = self.wire_spec(strat)
        ctx = self._ctx(K, wire)
        s = self.state
        theta, eta_G = s["theta"], s["eta_G"]
        n_j = torch.as_tensor(self.num_obs, device=self.device)
        n_active = torch.clamp(torch.sum(mask), min=1.0)
        ref = self._packed_reference(strat, ctx, wire, theta, eta_G)
        steps = [self._draw(draws, r, t, wire.dim) for t in range(K)]
        eps_G_seq = torch.stack([d[0] for d in steps])
        eps_L_seq = torch.stack([d[1] for d in steps]) if self._has_local else None
        noise = steps[0][2]

        def per_silo(eta_Lj, opt_Lj, data_j, m_j, n_obs_j, eps_Lj):
            eta_Lj, opt_Lj, ship, elbos = strat.local_run(
                ctx, theta, eta_G, eta_Lj, opt_Lj, data_j, m_j, n_obs_j,
                eps_G_seq, eps_Lj)
            return eta_Lj, opt_Lj, ship, elbos * m_j

        # eps_L_seq is (K, J, ...): its silo axis is 1.
        eta_L, opt_L, ship, elbos = vmap(per_silo, in_dims=self._silo_in_dims(1))(
            s["eta_L"], s["opt_local"], self.data, mask, n_j, eps_L_seq)
        enc = self._upload(wire.pack(ship, batch_ndim=1), mask, noise, ref)
        elbo_t = torch.sum(elbos, dim=0) / n_active
        # Round-cadence merges may need every silo's upload (the
        # barycenter), so the dequantized matrix is materialized here; the
        # reductions still run as the fused kernel. The combined row is
        # skipped when the strategy reads none of it (barycenter η_G, θ = ∅).
        shipped = self._decode(enc)
        combined = (wire.unpack(ctx.aggregator.combine(shipped, w))
                    if strat.needs_combined(ctx, theta) else None)
        theta, eta_G, opt_server = strat.server_update(
            ctx, theta, eta_G, s["opt_server"], combined, shipped, w, n_active)
        s.update(theta=theta, eta_G=eta_G, opt_server=opt_server,
                 eta_L=eta_L, opt_local=opt_L)
        return elbo_t

    # -- driver ---------------------------------------------------------------

    def run(
        self,
        num_rounds: int,
        *,
        algorithm=None,
        local_steps: int = 1,
        scheduler=None,
        callback: Optional[Callable[[int, dict], None]] = None,
        start_round: int = 0,
        draws: Optional[Draws] = None,
    ) -> Dict[str, list]:
        """Advance the federation ``num_rounds`` rounds; returns history.

        As the reference's ``run``: a step-cadence strategy pays one
        exchange per local step and draws a fresh participation mask for
        each (schedule index ``r * local_steps + t``); a round-cadence
        strategy exchanges once per round (index ``r``). Uploads are
        billed per active silo, downloads per invited silo; with
        ``privacy`` the accountant composes one subsampled Gaussian
        mechanism per exchange and ``history["epsilon"]`` traces ε.
        ``draws`` injects the randomness (module docstring).
        """
        if local_steps < 1:
            raise ValueError(f"local_steps must be >= 1, got {local_steps}")
        strat = self._resolve(algorithm)
        strat.validate(self)
        up1 = self.bytes_up_per_silo(strat)
        down1 = self.bytes_down_per_silo()
        sched = scheduler or RoundScheduler(self.fed_J, seed=self.seed)
        step_cadence = strat.cadence == "step"
        if strat.cadence not in ("step", "round"):
            raise ValueError(f"strategy {strat.name!r} has unknown cadence {strat.cadence!r}")
        exchanges = local_steps if step_cadence else 1
        history: Dict[str, list] = {
            "elbo": [], "elbo_trace": [], "bytes_up": [], "bytes_down": [],
            "n_active": [],
        }
        if self.accountant is not None:
            history["epsilon"] = []
            q = float(getattr(sched, "participation", 1.0))
        invited_fn = getattr(sched, "invited", None)
        for r in range(start_round, start_round + num_rounds):
            ex_idx = ([r * local_steps + t for t in range(local_steps)]
                      if step_cadence else [r])
            ex_masks = [np.asarray(sched.mask(i), np.float32) for i in ex_idx]
            inv_masks = [np.asarray(invited_fn(i), np.float32) if invited_fn is not None
                         else ex_masks[k] for k, i in enumerate(ex_idx)]
            active = [int(np.sum(m)) for m in ex_masks]
            invited = [max(int(np.sum(m)), active[k]) for k, m in enumerate(inv_masks)]
            masks = torch.as_tensor(np.stack(ex_masks), device=self.device)
            if step_cadence:
                elbos = self._step_round(strat, local_steps, masks, masks, r, draws)
            else:
                elbos = self._round_round(strat, local_steps, masks[0], masks[0], r, draws)
            elbos = elbos.detach().cpu().numpy()
            up = sum(active) * up1
            down = sum(invited) * down1
            n_active = active[-1]
            self.comm.record(up, down)
            history["elbo"].append(float(elbos[-1]))
            history["elbo_trace"].extend(float(e) for e in elbos)
            history["bytes_up"].append(up)
            history["bytes_down"].append(down)
            history["n_active"].append(n_active)
            metrics = {"elbo": history["elbo"][-1], "bytes_up": up,
                       "bytes_down": down, "n_active": n_active}
            if self.accountant is not None:
                self.accountant.step(noise_multiplier=self.privacy.noise_multiplier,
                                     sampling_rate=q, steps=exchanges)
                eps = self.accountant.epsilon(self.privacy.delta)[0]
                history["epsilon"].append(eps)
                metrics["epsilon"] = eps
            if callback:
                callback(r, metrics)
        return history
