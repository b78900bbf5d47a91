"""Pluggable server-side update rules: the ``ServerStrategy`` protocol.

Mirrors ``repro.federated.strategy`` for the paper's two algorithms:

  * ``sfvi`` (``cadence == "step"``, paper Algorithm 1) — silos ship
    (g_j^θ, g_j^η) every local step; hooks :meth:`silo_step` +
    :meth:`server_step`.
  * ``sfvi_avg`` (``cadence == "round"``, §3.2) — K local VI steps on
    the N/N_j-rescaled objective, ONE upload of the locally-updated
    (θ^(j), η_G^(j)), FedAvg of θ and a moment barycenter of η_G; hooks
    :meth:`local_run` + :meth:`server_update`.

The runtime vmaps the per-silo hooks over the leading silo axis
(``torch.func.vmap``) and hands every hook its randomness: ε_G is shared
by all silos at a step (common random numbers), ε_{L_j} is per silo.
Unlike the reference, whose hooks derive ε from the round key, the port's
hooks receive the draws (the runtime's ``draws`` hook or its own
generator), so a parity test can inject the reference's draws.

``pvi``/``fed_ep`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, Dict, Optional, Tuple

import torch
from torch.func import grad_and_value

from repro_torch.core.barycenter import family_barycenter, sqrtm_newton_schulz
from repro_torch.core.family import eps_shape as family_eps_shape
from repro_torch.kernels import wire as wire_kernels
from repro_torch.optim.base import apply_updates
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

DEFAULT_STRATEGY = "sfvi"


# ---------------------------------------------------------------------------
# The port's own draws (the reference folds threefry keys instead)
# ---------------------------------------------------------------------------


def global_eps(problem, gen: torch.Generator) -> torch.Tensor:
    """ε_G for one local step — shared by every silo."""
    return torch.randn(family_eps_shape(problem.global_family), generator=gen,
                       device=gen.device)


def silo_eps(problem, gen: torch.Generator, num_silos: int) -> Optional[torch.Tensor]:
    """Stacked (J, ...) ε_{L_j} for one local step (None if Z_L = ∅)."""
    if not problem.model.has_local:
        return None
    return torch.randn((num_silos,) + family_eps_shape(problem.local_family),
                       generator=gen, device=gen.device)


def _neg(tree: PyTree) -> PyTree:
    return tree_map(lambda x: -x, tree)


def _add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


def _select(keep, new: PyTree, old: PyTree) -> PyTree:
    """Per-leaf ``where`` that preserves dtypes (masked silo-state update)."""
    return tree_map(lambda n, o: torch.where(keep, n, o), new, old)


# ---------------------------------------------------------------------------
# The protocol
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StrategyContext:
    """Static per-round facts the runtime hands every strategy hook.

    ``wire`` is the flat :class:`~repro_torch.core.flatten.TreeSpec` of
    one upload; ``shipped`` values passed to :meth:`server_update` are
    ``(J, P)`` matrices. ``aggregator`` is the merge of stacked uploads:
    on the fused wire the combine kernel
    (:class:`~repro_torch.federated.runtime.FusedReduction`), else the
    server's aggregator.
    """

    problem: Any
    J: int
    K: int
    server_opt: Any
    local_opt: Any
    has_local: bool
    eta_mode: str
    aggregator: Any
    wire: Any
    fused: bool
    total_obs: float


class ServerStrategy:
    """Base class for pluggable server-side update rules (see module doc).

    ``wire_reference``: ``"zero"`` — ships an absolute quantity; DP
    privatizes the raw upload and non-participants ship zeros.
    ``"broadcast"`` — ships parameters; DP privatizes the delta from the
    round's public broadcast and non-participants ship the broadcast.
    """

    name: ClassVar[str] = ""
    cadence: ClassVar[str] = "round"
    has_silo_state: ClassVar[bool] = False
    wire_reference: ClassVar[str] = "zero"

    def validate(self, server) -> None:
        """Raise if the server's configuration cannot host this strategy."""

    def ship_template(self, server) -> PyTree:
        raise NotImplementedError

    def reference_tree(self, ctx: StrategyContext, theta, eta_G):
        if self.wire_reference == "broadcast":
            return {"theta": theta, "eta_G": eta_G}
        return None

    # cadence == "step"
    def silo_step(self, ctx, theta, eta_G, eta_Lj, opt_Lj, data_j, m_j,
                  n_obs_j, eps_G, eps_Lj) -> Tuple[PyTree, PyTree, PyTree, torch.Tensor]:
        """One silo's work for one step -> (eta_Lj, opt_Lj, ship_tree, hatLj)."""
        raise NotImplementedError

    def server_step(self, ctx, theta, eta_G, opt_server, mean_tree, hatL_sum,
                    n_active, eps_G) -> Tuple[PyTree, PyTree, PyTree, torch.Tensor]:
        """Fold one aggregate into the server -> (theta, eta_G, opt_server, elbo)."""
        raise NotImplementedError

    # cadence == "round"
    def local_run(self, ctx, theta, eta_G, eta_Lj, opt_Lj, data_j, m_j, n_obs_j,
                  eps_G_seq, eps_L_seq) -> Tuple[PyTree, PyTree, PyTree, torch.Tensor]:
        """One silo's K local steps -> (eta_Lj, opt_Lj, ship_tree, elbos (K,))."""
        raise NotImplementedError

    def needs_combined(self, ctx, theta) -> bool:
        """Whether :meth:`server_update` reads ``combined`` (else it gets None)."""
        return True

    def server_update(self, ctx, theta, eta_G, opt_server, combined, shipped,
                      w_full, n_active) -> Tuple[PyTree, PyTree, PyTree]:
        """Merge the round's uploads -> (theta, eta_G, opt_server)."""
        raise NotImplementedError


STRATEGIES: Dict[str, type] = {}


def register_strategy(name: str) -> Callable[[type], type]:
    """Class decorator: register a ServerStrategy subclass under ``name``."""

    def wrap(cls: type) -> type:
        if name in STRATEGIES:
            raise ValueError(f"strategy {name!r} already registered")
        cls.name = name
        STRATEGIES[name] = cls
        return cls

    return wrap


def get_strategy(name: str) -> type:
    try:
        return STRATEGIES[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; registered: {sorted(STRATEGIES)}") from None


def resolve_strategy(algorithm) -> ServerStrategy:
    """Registry name -> instance; an instance passes through."""
    if isinstance(algorithm, str):
        return get_strategy(algorithm)()
    return algorithm


# ---------------------------------------------------------------------------
# The paper's two algorithms
# ---------------------------------------------------------------------------


@register_strategy("sfvi")
@dataclasses.dataclass(frozen=True)
class SFVIStrategy(ServerStrategy):
    """Paper Algorithm 1: synchronize (g_j^θ, g_j^η) every local step."""

    cadence: ClassVar[str] = "step"
    wire_reference: ClassVar[str] = "zero"

    def ship_template(self, server) -> PyTree:
        return {"g_theta": server.state["theta"], "g_eta": server.state["eta_G"]}

    def silo_step(self, ctx, theta, eta_G, eta_Lj, opt_Lj, data_j, m_j,
                  n_obs_j, eps_G, eps_Lj):
        el = eta_Lj if ctx.has_local else None
        g_th, g_eta, g_loc, hatLj = ctx.problem.silo_grads(
            theta, eta_G, el, eps_G, eps_Lj, data_j)
        if ctx.has_local:
            upd, new_opt = ctx.local_opt.update(_neg(g_loc), opt_Lj, el)
            eta_Lj = _select(m_j > 0.5, apply_updates(el, upd), el)
            opt_Lj = _select(m_j > 0.5, new_opt, opt_Lj)
        return eta_Lj, opt_Lj, {"g_theta": g_th, "g_eta": g_eta}, hatLj

    def server_step(self, ctx, theta, eta_G, opt_server, mean_tree, hatL_sum,
                    n_active, eps_G):
        # J × mean over active = (J/|A|) Σ_active — the unbiased
        # partial-participation estimator of Σ_j (§3 Remark).
        J = float(ctx.J)
        g_sum = tree_map(lambda x: x * J, mean_tree)
        g_th0, g_eta0, hatL0 = ctx.problem.server_grads(theta, eta_G, eps_G)
        g = {
            "theta": _add(g_sum["g_theta"], g_th0),
            "eta_G": _add(g_sum["g_eta"], g_eta0),
        }
        params = {"theta": theta, "eta_G": eta_G}
        updates, opt_server = ctx.server_opt.update(_neg(g), opt_server, params)
        merged = apply_updates(params, updates)
        elbo = hatL0 + (J / n_active) * hatL_sum
        return merged["theta"], merged["eta_G"], opt_server, elbo


@register_strategy("sfvi_avg")
@dataclasses.dataclass(frozen=True)
class SFVIAvgStrategy(ServerStrategy):
    """§3.2: K local VI steps on the N/N_j-rescaled objective, one merge.

    The server optimizer state is re-initialized inside every
    ``local_run``; inactive silos keep their old η_L and optimizer state.
    """

    cadence: ClassVar[str] = "round"
    wire_reference: ClassVar[str] = "broadcast"

    def ship_template(self, server) -> PyTree:
        return {"theta": server.state["theta"], "eta_G": server.state["eta_G"]}

    def local_run(self, ctx, theta, eta_G, eta_Lj, opt_Lj, data_j, m_j, n_obs_j,
                  eps_G_seq, eps_L_seq):
        problem = ctx.problem
        scale = ctx.total_obs / n_obs_j  # §3.2 point 2: N / N_j
        el0 = eta_Lj if ctx.has_local else None
        th, eg, el = theta, eta_G, el0
        s_st = ctx.server_opt.init({"theta": theta, "eta_G": eta_G})
        l_st = opt_Lj
        vals = []
        for t in range(ctx.K):
            eps_G = eps_G_seq[t]
            eps_L = eps_L_seq[t] if ctx.has_local else None

            def objective(th_, eg_, el_):
                val = problem.hat_L0(th_, eg_, eps_G)
                return val + problem.hat_Lj(th_, eg_, el_, eps_G, eps_L, data_j, scale)

            if ctx.has_local:
                (g_th, g_eg, g_el), val = grad_and_value(
                    objective, argnums=(0, 1, 2))(th, eg, el)
                upd_l, l_st = ctx.local_opt.update(_neg(g_el), l_st, el)
                el = apply_updates(el, upd_l)
            else:
                (g_th, g_eg), val = grad_and_value(
                    lambda a, b: objective(a, b, None), argnums=(0, 1))(th, eg)
            params = {"theta": th, "eta_G": eg}
            upd_s, s_st = ctx.server_opt.update(
                _neg({"theta": g_th, "eta_G": g_eg}), s_st, params)
            merged = apply_updates(params, upd_s)
            th, eg = merged["theta"], merged["eta_G"]
            vals.append(val)
        if ctx.has_local:
            eta_Lj = _select(m_j > 0.5, el, el0)
            opt_Lj = _select(m_j > 0.5, l_st, opt_Lj)
        return eta_Lj, opt_Lj, {"theta": th, "eta_G": eg}, torch.stack(vals)

    def needs_combined(self, ctx, theta) -> bool:
        # The barycenter merges η_G from ``shipped``; only θ would remain.
        return ctx.eta_mode == "param" or bool(tree_leaves(theta))

    def server_update(self, ctx, theta, eta_G, opt_server, combined, shipped,
                      w_full, n_active):
        theta_new = theta if combined is None else combined["theta"]
        if ctx.eta_mode == "param":
            eta_new = combined["eta_G"]
        else:
            # W2 barycenter in moment space through the family's bridge; on
            # the fused wire a full-covariance merge takes its square roots
            # from the Newton–Schulz step kernel.
            eta_shipped = ctx.wire.unpack(shipped)["eta_G"]
            sqrtm = (wire_kernels.sqrtm_newton_schulz_fused if ctx.fused
                     else sqrtm_newton_schulz)
            eta_new = family_barycenter(
                ctx.problem.global_family, eta_shipped, w_full, ctx.aggregator,
                sqrtm=sqrtm)
        return theta_new, eta_new, opt_server
