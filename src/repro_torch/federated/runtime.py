"""The federated round over a mesh of ranks: ``Server`` (the port of ``repro.federated.runtime``).

All J silos advance together: silo state (η_{L_j}, its optimizer state,
and per-silo strategy state such as PVI's sites λ_j) and data are
stacked along a leading silo axis, and the per-silo strategy hooks run
under ``torch.func.vmap`` over that axis.

The mesh (:func:`repro_torch.launch.mesh.build_mesh`) is one rank, or the
(silo, model) grid of ranks of a ``torch.distributed`` world, one process
a device. The stacked silo axis is padded to ``J_pad = ceil(J / silo) ·
silo`` with copies of row 0 whose masks and weights are 0, and each rank
holds the contiguous block of ``J_pad / silo`` rows of its silo block
(:mod:`repro_torch.federated.distributed`): data, η_L, optimizer and
strategy rows. Every rank runs the same host loop on its block, uploads
its rows, gathers the encoded rows of every block (``gather_rows`` over
the silo group), drops the padded tail, and then decodes, combines and
updates the replicated server state from the same ``(J, P)`` matrix as
one process.
On a ``model`` axis each rank of a block uploads the block's full rows
(the DP noise and the int8 row scales are those of the silo mesh), ships
its ``ceil(P / model)`` column block over the silo group and rejoins the
columns over the model group before the decode; the int8 scales ride the
silo gather only. The ELBO sums are added over the silo blocks in rank
order. With one rank every collective is the identity and J_pad == J.
The reference's ``shard_map`` and graph cache have no counterpart.

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
cadence uploads once, with the noise of step 0. Every rank draws the
whole (J, ...) ε_L and (J, P) noise and takes its rows, so the draws do
not depend on the rank count; the upload's launch plan is pinned to
J_pad (``fused_upload(plan_rows=)``) for the same reason.
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
from repro_torch.federated import distributed
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
from repro_torch.launch.mesh import Mesh, build_mesh, model_world
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
    """Round-based federation driver over J stacked silos on a mesh of ranks.

    Args mirror the reference ``Server`` (see its docstring): ``problem``,
    ``datas`` (J per-silo dicts of tensors with equal shapes), ``theta``,
    ``eta_G``, ``num_obs``, ``server_opt``, ``local_opt``, ``aggregator``,
    ``compressor``, ``eta_mode`` (``"barycenter"``/``"param"``),
    ``privacy``, ``seed``, ``strategy``, ``federation_size``,
    ``federation_obs``, and ``mesh`` (a built
    :class:`~repro_torch.launch.mesh.Mesh`; default the one-rank mesh);
    plus

      wire: ``"fused"`` (default; the CUDA kernels) or ``"flat"``.
      device: where this rank's part of the federation lives; default
        ``cuda`` (raises when CUDA is absent — pass ``"cpu"`` to run on
        the CPU).

    On a mesh of several ranks every rank constructs the Server with the
    same arguments (they are pure functions of the spec) and keeps the
    rows of its silo block: ``state["eta_L"]``, ``"opt_local"``,
    ``"strategy"`` and ``data`` have ``J_pad / silo`` rows; θ, η_G and the
    server optimizer are replicated.
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
        mesh: Optional[Mesh] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        dev = self.device
        self.problem = problem
        self.J = len(datas)
        self.mesh = mesh if mesh is not None else build_mesh()
        self.model_world = model_world(self.mesh)
        self.J_pad = distributed.padded_rows(self.J, self.mesh)
        self.aggregator = aggregator or MeanAggregator()
        self.compressor = compressor or NoCompression()
        self.privacy = privacy
        self.accountant = RdpAccountant() if privacy is not None else None
        # The roster's shards as given (each a pure function of the spec on
        # every rank); the stacked data holds this rank's rows.
        self._datas = list(datas)
        self.data = self._held_data()
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
        if self.model_world > 1 and _wire_codec(self.compressor) == "custom":
            raise ValueError(
                f"compressor {type(self.compressor).__name__} has no wire_codec "
                "capability; model-axis sharding supports identity/int8 codecs only "
                "(or set model=1)")
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
            # Every rank draws the whole roster's init from one stream and
            # keeps its rows: the rows do not depend on the rank count.
            gen = generator(seed + 1, dev)
            eta_L = self._held(stack_silos(
                [problem.local_family.init(gen) for _ in range(self.J)]))
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
        }
        self.state["strategy"] = self._held(self._strategy.init_silo_state(self))
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
        """Stacked per-silo variational parameters η_{L_j}: this rank's rows
        of the padded axis (all J rows on a one-rank mesh)."""
        return self.state["eta_L"]

    @property
    def strategy(self) -> ServerStrategy:
        return self._strategy

    @property
    def rows(self) -> list:
        """Padded-row indices this rank holds."""
        return distributed.owned_rows(self.mesh, self.J_pad)

    def _resolve(self, algorithm) -> ServerStrategy:
        return self._strategy if algorithm is None else resolve_strategy(algorithm)

    # -- the padded, rank-split silo axis -------------------------------------


    def _held(self, tree: PyTree) -> PyTree:
        """A (J, ...) stacked tree -> this rank's rows of its padded axis; the
        padded tail repeats row 0 (masked out of every round)."""
        pad = self.J_pad - self.J
        if pad:
            tree = tree_map(lambda x: torch.cat(
                [x, x[:1].expand((pad,) + tuple(x.shape[1:]))]), tree)
        return distributed.own(tree, self.mesh, self.J_pad)

    def _held_data(self) -> PyTree:
        rows = [self._datas[j] if j < self.J else self._datas[0] for j in self.rows]
        return tree_map(lambda x: x.to(self.device), stack_silos(rows))

    def _held_mask(self, m: torch.Tensor) -> torch.Tensor:
        """This rank's entries of a (..., J) mask; padded rows get 0."""
        pad = self.J_pad - m.shape[-1]
        if pad:
            m = torch.cat([m, m.new_zeros(m.shape[:-1] + (pad,))], dim=-1)
        rows = self.rows
        return m[..., rows[0]: rows[-1] + 1]

    def _held_obs(self) -> torch.Tensor:
        """N_j of this rank's rows (padded rows repeat N_0)."""
        n = [self.num_obs[j] if j < self.J else self.num_obs[0] for j in self.rows]
        return torch.as_tensor(np.asarray(n, np.float32), device=self.device)

    def _silo_groups(self) -> list:
        """The stacked state groups with leaves."""
        return [k for k in ("eta_L", "opt_local", "strategy") if tree_leaves(self.state[k])]

    def whole_silo_state(self, key: str) -> PyTree:
        """The J real rows of a stacked state group from every rank (one
        collective on a mesh of several ranks; every rank must call it)."""
        whole = distributed.gather_tree_rows(self.state[key], self.mesh)
        return tree_map(lambda x: x[: self.J], whole)

    # -- dynamic population growth --------------------------------------------

    def grow_silos(self, datas: Sequence[PyTree], num_obs: Optional[Sequence[int]] = None,
                   eta_rows: Optional[Sequence[PyTree]] = None) -> None:
        """Append joining silos to the stacked silo axis, in place.

        The population engine's join path: the new silos' data shards
        (leaf shapes equal to the federation's) are appended, J and the
        mesh-chunked ``J_pad`` are recomputed, and every stacked tree is
        rebuilt into new contiguous tensors, the existing rows copied bit
        for bit. On a mesh of several ranks every group's held rows are
        first handed over in one collective (a step of ``J_pad`` moves rows
        between ranks) and each rank keeps its new block. ``eta_rows``
        gives each new silo's initial η_L (the amortized warm start);
        without it the cold family init is drawn from ``generator((seed +
        1, j))``, a pure function of (seed, roster index), so a resume
        re-grows bit for bit. New optimizer moments are fresh; per-silo
        strategy state keeps its old rows and takes the strategy's init for
        the new ones (PVI's zero sites).
        """
        if not datas:
            return
        if eta_rows is not None and len(eta_rows) != len(datas):
            raise ValueError(
                f"eta_rows has {len(eta_rows)} entries for {len(datas)} joining silos")
        dev = self.device
        old_J = self.J
        new = list(datas)
        if num_obs is None:
            num_obs = [int(tree_leaves(d)[0].shape[0]) for d in new]
        groups = self._silo_groups()
        whole = distributed.gather_tree_rows({k: self.state[k] for k in groups}, self.mesh)
        whole = tree_map(lambda x: x[:old_J], whole)
        self._datas.extend(new)
        self.J = old_J + len(new)
        self.J_pad = distributed.padded_rows(self.J, self.mesh)
        self.num_obs = np.concatenate([self.num_obs, np.asarray(list(num_obs), np.float32)])
        if self._has_local:
            rows = (list(eta_rows) if eta_rows is not None else
                    [self.problem.local_family.init(generator((self.seed + 1, j), dev))
                     for j in range(old_J, self.J)])
            new_eta = tree_map(lambda x: x.to(dev), stack_silos(rows))
            whole["eta_L"] = tree_map(lambda a, b: torch.cat([a, b]), whole["eta_L"], new_eta)
            whole["opt_local"] = tree_map(lambda a, b: torch.cat([a, b]), whole["opt_local"],
                                          vmap(self._local_opt.init)(new_eta))
        if "strategy" in whole:
            fresh = self._strategy.init_silo_state(self)
            whole["strategy"] = tree_map(
                lambda f, o: torch.cat([o, f[old_J:]]), fresh, whole["strategy"])
        for k, v in whole.items():
            self.state[k] = self._held(v)
        self.data = self._held_data()

    def _ensure_strategy_state(self, strat: ServerStrategy) -> None:
        """Create per-silo strategy state when ``run`` switches to a stateful
        strategy the Server was not built with (restored state is kept)."""
        if strat.has_silo_state and not tree_leaves(self.state["strategy"]):
            self.state["strategy"] = self._held(strat.init_silo_state(self))

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
        """This rank's stacked (rows, P) uploads -> what crosses the wire:
        the (rows, P) matrix (identity codec), ``{"q", "scale"}`` (int8), or
        a list of per-silo encodings (a custom codec)."""
        comp, privacy = self.compressor, self.privacy
        codec = _wire_codec(comp)
        if self.wire == "fused":
            out = wire_kernels.fused_upload(
                mat, mask=mask, noise=noise if self._noise_on() else None,
                reference=ref,
                clip_norm=None if privacy is None else privacy.clip_norm,
                noise_multiplier=0.0 if privacy is None else privacy.noise_multiplier,
                quantize=codec == "int8", plan_rows=self.J_pad)
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
        if codec == "identity":
            return torch.stack(encs)
        if codec == "int8":
            # One flat leaf a silo: its (q, scale) rows, as the fused wire's.
            return {"q": torch.stack([e["leaves"][0]["q"] for e in encs]),
                    "scale": torch.stack([e["leaves"][0]["scale"] for e in encs])}
        return encs

    def _gather(self, enc, P: int):
        """Every silo block's encoded rows -> the J real rows of the wire.

        On a mesh of several ranks the blocks' rows are gathered into the
        whole padded (J_pad, ...) wire (its bytes are counted) and the
        padded tail, whose weights are 0, is dropped: the decode and the
        combine then see the one-process (J, P) matrix, so padding moves
        no bit. On a one-rank mesh this is the identity.
        """
        mesh = self.mesh
        if not mesh.distributed:
            return enc
        J = self.J
        if isinstance(enc, list):  # a custom codec's per-silo encodings
            whole = distributed.gather_tree_rows(stack_silos(enc), mesh)
            out = [tree_map(lambda x, j=j: x[j], whole) for j in range(J)]
            leaves = tree_leaves(whole)
        else:
            if isinstance(enc, dict):
                whole = {"q": self._gather_wire(enc["q"], P),
                         "scale": distributed.gather_rows(enc["scale"], mesh)}
            else:
                whole = self._gather_wire(enc, P)
            leaves = tree_leaves(whole)
            out = tree_map(lambda x: x[:J], whole)
        self.comm.bytes_gathered += sum(x.numel() * x.element_size() for x in leaves)
        return out

    def _gather_wire(self, x: torch.Tensor, P: int) -> torch.Tensor:
        """(rows, P) -> (J_pad, P): on a model axis this rank ships its
        zero-padded column block of ``ceil(P / model)`` over the silo group,
        and the blocks are rejoined over the model group."""
        mesh = self.mesh
        if mesh.model == 1:
            return distributed.gather_rows(x, mesh)
        Pb = -(-P // mesh.model)
        xp = torch.nn.functional.pad(x, (0, Pb * mesh.model - P))
        block = xp[:, mesh.model_index * Pb:(mesh.model_index + 1) * Pb].contiguous()
        full = distributed.gather_cols(distributed.gather_rows(block, mesh), mesh)
        return full[:, :P].contiguous()

    def _decode(self, enc) -> torch.Tensor:
        """What crossed the wire -> the dequantized (J, P) float32 matrix."""
        codec = _wire_codec(self.compressor)
        if codec == "int8":
            return enc["q"].float() * enc["scale"][:, None]
        if codec == "identity":
            return enc
        return torch.stack([self.compressor.decode(e) for e in enc])

    def _draw(self, draws: Optional[Draws], r: int, t: int, P: int) -> tuple:
        """(ε_G, this rank's ε_L rows, this rank's noise rows): the whole
        (J, ...) draws are made (or injected) on every rank, then held."""
        if draws is not None:
            eps_G, eps_L, noise = draws(r, t)
            dev = self.device
            eps_G, eps_L, noise = (eps_G.to(dev), None if eps_L is None else eps_L.to(dev),
                                   None if noise is None else noise.to(dev))
        else:
            gen = generator((self.seed, r, t), self.device)
            eps_G = global_eps(self.problem, gen)
            eps_L = silo_eps(self.problem, gen, self.J)
            noise = (torch.randn((self.J, P), generator=gen, device=self.device)
                     if self._noise_on() else None)
        return (eps_G, None if eps_L is None else self._held(eps_L),
                None if noise is None else self._held(noise))

    def _silo_in_dims(self, eps_L_dim: Optional[int]):
        # eta_L, opt_L, data, mask, n_obs, per-silo eps
        return (0, 0, 0, 0, 0, None if not self._has_local else eps_L_dim)

    def _step_round(self, strat, K, masks, weights, r, draws) -> torch.Tensor:
        """Round = K synchronized steps: upload + combine + server update each.
        ``masks`` and ``weights`` are (K, J) over the real silos."""
        wire = self.wire_spec(strat)
        ctx = self._ctx(K, wire)
        merge = ctx.aggregator
        int8 = _wire_codec(self.compressor) == "int8"
        s = self.state
        theta, eta_G, opt_server = s["theta"], s["eta_G"], s["opt_server"]
        eta_L, opt_L = s["eta_L"], s["opt_local"]
        held = self._held_mask(masks)
        n_j = self._held_obs()
        elbos = []
        for t in range(K):
            m, w, m_own = masks[t], weights[t], held[t]
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
                eta_L, opt_L, self.data, m_own, n_j, eps_L)
            enc = self._gather(self._upload(wire.pack(ship, batch_ndim=1), m_own, noise, ref),
                               wire.dim)
            hatL_sum = distributed.sum_over_silos(torch.sum(hatL), self.mesh)
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
        """Round = K local steps per silo, ONE upload + one server merge.
        ``mask`` and ``w`` are (J,) over the real silos."""
        wire = self.wire_spec(strat)
        ctx = self._ctx(K, wire)
        s = self.state
        theta, eta_G = s["theta"], s["eta_G"]
        n_j = self._held_obs()
        n_active = torch.clamp(torch.sum(mask), min=1.0)
        ref = self._packed_reference(strat, ctx, wire, theta, eta_G)
        steps = [self._draw(draws, r, t, wire.dim) for t in range(K)]
        eps_G_seq = torch.stack([d[0] for d in steps])
        eps_L_seq = torch.stack([d[1] for d in steps]) if self._has_local else None
        noise = steps[0][2]
        m_own = self._held_mask(mask)

        def per_silo(eta_Lj, opt_Lj, st_j, data_j, m_j, n_obs_j, eps_Lj):
            eta_Lj, opt_Lj, st_j, ship, elbos = strat.local_run(
                ctx, theta, eta_G, eta_Lj, opt_Lj, st_j, data_j, m_j, n_obs_j,
                eps_G_seq, eps_Lj)
            return eta_Lj, opt_Lj, st_j, ship, elbos * m_j

        # The strategy state rides the silo axis beside eta_L; eps_L_seq is
        # (K, rows, ...): its silo axis is 1.
        in_dims = (0,) + self._silo_in_dims(1)  # every silo argument at 0 but eps
        eta_L, opt_L, strat_state, ship, elbos = vmap(per_silo, in_dims=in_dims)(
            s["eta_L"], s["opt_local"], s["strategy"], self.data, m_own, n_j, eps_L_seq)
        enc = self._gather(self._upload(wire.pack(ship, batch_ndim=1), m_own, noise, ref),
                           wire.dim)
        elbo_t = distributed.sum_over_silos(torch.sum(elbos, dim=0), self.mesh) / n_active
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
                 eta_L=eta_L, opt_local=opt_L, strategy=strat_state)
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
        population=None,
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

        ``population`` (a :class:`~repro_torch.federated.population.PopulationEngine`)
        processes each round's churn first (a join grows J); its presence
        multiplies the roster-wide scheduler masks sliced to the live J, and
        its staleness-decayed weights (a returning silo's first round back)
        become the round's aggregation weights.
        """
        if local_steps < 1:
            raise ValueError(f"local_steps must be >= 1, got {local_steps}")
        strat = self._resolve(algorithm)
        strat.validate(self)
        self._ensure_strategy_state(strat)
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
            present = stale_w = None
            if population is not None:
                present, stale_w = population.begin_round(self, r)
            raw = [np.asarray(sched.mask(i), np.float32) for i in ex_idx]
            ex_masks, wt_masks = raw, raw
            inv_masks = [np.asarray(invited_fn(i), np.float32) if invited_fn is not None
                         else ex_masks[k] for k, i in enumerate(ex_idx)]
            if present is not None:
                # The scheduler stays roster-wide: its masks are sliced to the
                # joined J, so participation is independent of churn.
                ex_masks = [m[: self.J] * present for m in raw]
                wt_masks = [m[: self.J] * stale_w for m in raw]
                inv_masks = [m[: self.J] * present for m in inv_masks]
            active = [int(np.sum(m)) for m in ex_masks]
            invited = [max(int(np.sum(m)), active[k]) for k, m in enumerate(inv_masks)]
            masks = torch.as_tensor(np.stack(ex_masks), device=self.device)
            weights = torch.as_tensor(np.stack(wt_masks), device=self.device)
            if step_cadence:
                elbos = self._step_round(strat, local_steps, masks, weights, r, draws)
            else:
                elbos = self._round_round(strat, local_steps, masks[0], weights[0], r, draws)
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
