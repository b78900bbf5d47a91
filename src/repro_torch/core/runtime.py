"""Legacy hub-and-spoke API: deprecated eager adapters over the port's ``Server``.

The port of ``repro.core.runtime``. The eager loop of Algorithms 1 and 2
(a Python loop over J :class:`Silo` objects exchanging message pytrees
with a server object) is retired in both packages: one runtime,
:class:`repro_torch.federated.runtime.Server`, serves every workload, and
the classes here only keep the old constructor and ``run`` signatures:

  * :class:`SFVIServer` / :class:`SFVIAvgServer` turn the eager API (a
    list of Silos, an optimizer, ``run(iters, participation)``) into a
    ``Server`` run on the fused wire (the card's upload and combine
    kernels; the square-root kernel for a full-covariance barycenter),
    then write the updated η_{L_j} and their optimizer states back into
    the Silo objects. New code should use
    :mod:`repro_torch.federated.api` or ``Server`` directly.
  * :class:`Silo` is the per-silo state container (data, η_{L_j}, local
    optimizer) plus the single-silo transcription of one exchange of the
    paper's protocol (:meth:`Silo.sfvi_step`), for tests of the message
    structure. Its ε_L stream is a torch generator seeded ``seed · 7919 +
    silo_id`` (the reference's threefry key from the same integer cannot
    be reproduced); ``sfvi_step(msg, eps_L=)`` injects one.
  * ``CommLog`` is a deprecated alias of
    :class:`~repro_torch.federated.metering.CommMeter`; ``tree_bytes`` is
    re-exported from the same module.

The adapters run where the silos' data live (the card, or the CPU for CPU
tensors) and take ``draws=`` in ``run`` as ``Server.run`` does.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core.barycenter import barycenter_params_diag, barycenter_params_full
from repro_torch.core.family import eps_shape, supports_moments
from repro_torch.core.sfvi import SFVIProblem
from repro_torch.device import generator
# A leaf module: safe while repro_torch.federated's modules (which import
# repro_torch.core) are mid-import. The Server and the scheduler are
# imported inside the adapters for the same reason.
from repro_torch.federated.metering import CommMeter, tree_bytes
from repro_torch.optim.base import GradientTransformation, apply_updates
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = [
    "CommLog",
    "SFVIAvgServer",
    "SFVIServer",
    "Silo",
    "tree_add",
    "tree_bytes",
    "tree_mean",
    "tree_scale",
]


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


def tree_scale(a: PyTree, s: float) -> PyTree:
    return tree_map(lambda x: x * s, a)


def tree_mean(trees: Sequence[PyTree]) -> PyTree:
    return tree_map(lambda *xs: sum(xs) / len(xs), *trees)


class CommLog(CommMeter):
    """Deprecated alias of :class:`repro_torch.federated.metering.CommMeter`."""

    def __init__(self, *args, **kwargs):
        warnings.warn(
            "repro_torch.core.runtime.CommLog is deprecated; use "
            "repro_torch.federated.metering.CommMeter",
            DeprecationWarning,
            stacklevel=2,
        )
        super().__init__(*args, **kwargs)


def _device_of(*trees) -> torch.device:
    leaves = [x for t in trees for x in tree_leaves(t) if isinstance(x, torch.Tensor)]
    return leaves[0].device if leaves else torch.device("cpu")


class Silo:
    """One data owner. Holds y_j, η_{L_j} and its local optimizer privately.

    A state container for the adapters (they stack ``silo.eta_L`` across
    the federation, run the ``Server``, and write the updated rows back);
    :meth:`sfvi_step` is the literal transcription of one exchange of
    Algorithm 1's silo body.
    """

    def __init__(
        self,
        silo_id: int,
        problem: SFVIProblem,
        data: Any,
        eta_L: Optional[PyTree],
        local_optimizer: Optional[GradientTransformation],
        num_obs: int,
        seed: int = 0,
    ):
        self.silo_id = silo_id
        self.problem = problem
        self.data = data
        self.eta_L = eta_L
        self.num_obs = num_obs
        self.device = _device_of(data, eta_L)
        self._gen = generator(seed * 7919 + silo_id, self.device)
        self._local_opt = local_optimizer
        self._local_opt_state = (
            local_optimizer.init(eta_L) if (local_optimizer and eta_L is not None) else None)

    def sfvi_step(self, msg: Dict[str, Any], eps_L: Optional[torch.Tensor] = None
                  ) -> Dict[str, Any]:
        """Receive (θ, η_G, ε_G); update η_{L_j} in place; reply (g_j^θ, g_j^η).

        ``eps_L`` injects the silo's ε_L (else the silo's own stream draws it).
        """
        if self.problem.model.has_local and eps_L is None:
            eps_L = torch.randn(eps_shape(self.problem.local_family), generator=self._gen,
                                device=self.device)
        g_theta, g_eta, g_local, hat_Lj = self.problem.silo_grads(
            msg["theta"], msg["eta_G"], self.eta_L, msg["eps_G"], eps_L, self.data)
        if g_local is not None and self._local_opt is not None:
            # Optimizers are descent-convention; we ascend the ELBO.
            updates, self._local_opt_state = self._local_opt.update(
                tree_scale(g_local, -1.0), self._local_opt_state, self.eta_L)
            self.eta_L = apply_updates(self.eta_L, updates)
        return {"g_theta": g_theta, "g_eta": g_eta, "hat_Lj": hat_Lj}


def _adapter_server(problem: SFVIProblem, silos: List[Silo], theta: PyTree, eta_G: PyTree,
                    server_opt: GradientTransformation, eta_mode: str, seed: int):
    """The ``Server`` behind an eager-API adapter, on the silos' device.

    Silo data share leaf shapes across the federation; caller-initialized
    η_{L_j} replace the Server's own init.
    """
    from repro_torch.federated.runtime import Server, stack_silos

    local_opt = next((s._local_opt for s in silos if s._local_opt is not None), None)
    device = silos[0].device
    srv = Server(
        problem, [s.data for s in silos], theta, eta_G,
        num_obs=[s.num_obs for s in silos], server_opt=server_opt,
        local_opt=local_opt if problem.model.has_local else None,
        eta_mode=eta_mode, seed=seed, device=device)
    if problem.model.has_local and all(s.eta_L is not None for s in silos):
        srv.state["eta_L"] = tree_map(lambda x: x.to(device),
                                      stack_silos([s.eta_L for s in silos]))
    return srv


class _AdapterBase:
    """Shared plumbing of the two deprecated eager-API adapters."""

    _compiled: Any  # repro_torch.federated.runtime.Server
    silos: List[Silo]

    @property
    def theta(self) -> PyTree:
        return self._compiled.theta

    @theta.setter
    def theta(self, value: PyTree) -> None:
        self._compiled.state["theta"] = value

    @property
    def eta_G(self) -> PyTree:
        return self._compiled.eta_G

    @eta_G.setter
    def eta_G(self, value: PyTree) -> None:
        self._compiled.state["eta_G"] = value

    @property
    def comm(self) -> CommMeter:
        return self._compiled.comm

    def _writeback(self) -> None:
        """Propagate the updated η_{L_j} rows back into the Silo objects."""
        if not self.problem.model.has_local:
            return
        eta_L = self._compiled.eta_L
        opt_L = self._compiled.state["opt_local"]
        for j, silo in enumerate(self.silos):
            silo.eta_L = tree_map(lambda x, jj=j: x[jj], eta_L)
            silo._local_opt_state = tree_map(lambda x, jj=j: x[jj], opt_L)

    def _run(self, rounds: int, algorithm: str, local_steps: int, participation: float,
             callback, draws) -> Dict[str, list]:
        from repro_torch.federated.scheduler import RoundScheduler

        sched = RoundScheduler(len(self.silos), participation=participation, seed=self.seed)
        history = self._compiled.run(
            rounds, algorithm=algorithm, local_steps=local_steps, scheduler=sched,
            callback=callback, start_round=self._round, draws=draws)
        self._round += rounds
        self._writeback()
        return history


class SFVIServer(_AdapterBase):
    """DEPRECATED eager-API adapter: Algorithm 1 on the port's ``Server``
    (algorithm ``"sfvi"``, one local step a round). After ``run`` the
    updated η_{L_j} are written back into the Silo objects."""

    def __init__(self, problem: SFVIProblem, silos: List[Silo], theta: PyTree,
                 eta_G: PyTree, optimizer: GradientTransformation, seed: int = 0):
        warnings.warn(
            "SFVIServer is a deprecated adapter over repro_torch.federated.runtime.Server; "
            "build runs through repro_torch.federated.api instead",
            DeprecationWarning,
            stacklevel=2,
        )
        self.problem = problem
        self.silos = silos
        self.optimizer = optimizer
        self.seed = seed
        # eta_mode is unused by the SFVI round; "param" skips the
        # barycenter's moment-bridge validation.
        self._compiled = _adapter_server(problem, silos, theta, eta_G, optimizer, "param", seed)
        self._round = 0

    def run(self, num_iters: int, participation: float = 1.0,
            callback: Optional[Callable[[int, dict], None]] = None,
            draws=None) -> Dict[str, list]:
        """Run Algorithm 1 for ``num_iters`` rounds (one sync a round).

        ``participation`` < 1 invites a random subset a round; consecutive
        calls continue the same round stream. ``draws`` as ``Server.run``.
        """
        return self._run(num_iters, "sfvi", 1, participation, callback, draws)


class SFVIAvgServer(_AdapterBase):
    """DEPRECATED eager-API adapter: Algorithm 2 on the port's ``Server``.

    ``run(num_rounds, local_steps)`` takes ``local_steps`` local VI steps a
    silo and one merge a round (algorithm ``"sfvi_avg"``): FedAvg for θ
    and the W2 barycenter for η_G, analytic for ``moment_form == "diag"``
    families and the Newton–Schulz fixed point for ``"full"`` ones. A
    family without the moment bridge is refused at construction.
    :meth:`_barycenter` keeps the eager host-side rule.
    """

    def __init__(self, problem: SFVIProblem, silos: List[Silo], theta: PyTree,
                 eta_G: PyTree,
                 local_optimizer_factory: Callable[[], GradientTransformation],
                 seed: int = 0):
        warnings.warn(
            "SFVIAvgServer is a deprecated adapter over "
            "repro_torch.federated.runtime.Server; build runs through "
            "repro_torch.federated.api instead",
            DeprecationWarning,
            stacklevel=2,
        )
        self.problem = problem
        self.silos = silos
        self.local_optimizer_factory = local_optimizer_factory
        self.seed = seed
        if not supports_moments(problem.global_family):
            raise ValueError(
                f"SFVIAvgServer: {type(problem.global_family).__name__} exposes no "
                "to_moments/from_moments — the W2 barycenter merge is undefined for it. "
                "Use repro_torch.federated.runtime.Server with eta_mode='param' for "
                "parameter-space averaging.")
        # The factory's optimizer drives each silo's local (θ, η_G) steps;
        # the silos' own optimizer drives η_{L_j}.
        self._compiled = _adapter_server(problem, silos, theta, eta_G,
                                         local_optimizer_factory(), "barycenter", seed)
        self._round = 0

    def _barycenter(self, eta_G_list: List[PyTree]) -> PyTree:
        """The eager server's host-side η_G merge rule (kept for tests)."""
        fam = self.problem.global_family
        form = getattr(fam, "moment_form", None)
        if form == "diag":
            return barycenter_params_diag(fam, eta_G_list)
        if form == "full":
            return barycenter_params_full(fam, eta_G_list)
        raise TypeError(f"No barycenter rule for family {type(fam).__name__}")

    def run(self, num_rounds: int, local_steps: int, participation: float = 1.0,
            callback: Optional[Callable[[int, dict], None]] = None,
            draws=None) -> Dict[str, list]:
        """Run Algorithm 2: ``local_steps`` local VI steps, one merge a round."""
        return self._run(num_rounds, "sfvi_avg", local_steps, participation, callback, draws)
