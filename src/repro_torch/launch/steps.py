"""Train and serve steps of the backbone: the paper's SFVI on an LLM.

Counterpart of ``repro/launch/steps.py``. θ is the backbone, η_G the
global rank-r LM-head adapter (a diagonal Gaussian), η_L the per-silo
adapters and logit biases (stacked on a leading silo axis).

Training (:func:`make_train_step`, SFVI; :func:`make_train_step_avg`,
SFVI-Avg) is Algorithm 1 with the server as a sum: every silo j (one group
of B / J rows of the batch) adds L̂_j = log p(y_j, Z_Lj | Z_G, θ) − log
q(Z_Lj) on its rows with its η_Lj, the server term L̂_0 = log p(Z_G) −
log q(Z_G) is added once, and one backward gives every gradient; Adam
updates θ, η_G and η_L. Deliberate differences from the reference:

* The Gaussian draws z = μ + e^{log σ}·ε go through the reparam kernel
  (:func:`_diag_sample`: ``kernels.reparam.reparam_stl`` and its backward,
  one launch each for z_G and for the (J, n) silo stack flattened). Only
  its z is used: its log q's gradient is the total derivative (−1 to log
  σ), while the STL estimator's (:func:`_diag_logq_stl`) goes through z
  with μ and log σ detached, as the reference computes it.
* The backbone runs ``transformer.forward``'s train mode: the jnp
  counterparts, no flash / GLA / RMSNorm kernel (they have no backward).
* The draws come from a torch generator seeded by the step's seed, not
  the reference's threefry stream; ``draws=(eps_G, eps_L)`` injects them.
* The step updates the state it is given in place, one leaf at a time
  (as ``jax.jit(..., donate_argnums=0)`` reuses the buffers), and returns
  a state that holds the same tensors: at full width θ, Adam's μ and ν
  and the gradients fill most of one card, so a second copy of the state
  does not fit. Pass a copy to keep the old state.
* SFVI-Avg's barycenter runs only on due steps (the step count is a host
  int), as two launches of the combine kernel; the reference computes it
  every step and selects with ``jnp.where``.
* ``cfg.perf.microbatch`` (the reference's ``_grads_microbatched``) and the
  other ``PerfConfig`` levers raise.

Serving (:func:`make_serve_prefill`, :func:`make_serve_decode`) runs the
posterior-mean model (θ, E[Z_G], E[Z_Lj]) through the backbone's kernels.
Every silo keeps its personal head adapter, so one batch serves requests
of several silos: the batch axis is grouped by silo (J groups of B / J
requests), and each group's logits get its silo's adapter.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.func import vmap

from repro_torch.device import generator
from repro_torch.kernels import wire as wire_kernels
from repro_torch.kernels.reparam import reparam_stl
from repro_torch.models.backbone import transformer as T
from repro_torch.models.backbone.bayes import (
    bayes_logits,
    latent_dims,
    log_prior_global,
    log_prior_local,
    silo_log_lik,
)
from repro_torch.models.backbone.config import ArchConfig, check_port_supported
from repro_torch.optim.adam import ScaleByAdamState, adam
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

PyTree = Any

_LOG_2PI = 1.8378770664093453

AUX_LOSS_WEIGHT = 0.01  # MoE load-balance coefficient


# ---------------------------------------------------------------------------
# Variational state (diagonal Gaussians)
# ---------------------------------------------------------------------------

def init_eta_G(gen: torch.Generator, cfg: ArchConfig):
    n_G, _ = latent_dims(cfg)
    dev = gen.device
    return {"mu": 0.01 * torch.randn((n_G,), generator=gen, device=dev),
            "log_sigma": torch.full((n_G,), -3.0, device=dev)}


def init_eta_L(gen: torch.Generator, cfg: ArchConfig, num_silos: int):
    _, n_L = latent_dims(cfg)
    dev = gen.device
    return {"mu": 0.01 * torch.randn((num_silos, n_L), generator=gen, device=dev),
            "log_sigma": torch.full((num_silos, n_L), -3.0, device=dev)}


def init_eta_G_silo(gen: torch.Generator, cfg: ArchConfig, num_silos: int):
    """SFVI-Avg's η_G: one row per silo."""
    n_G, _ = latent_dims(cfg)
    dev = gen.device
    return {"mu": 0.01 * torch.randn((num_silos, n_G), generator=gen, device=dev),
            "log_sigma": torch.full((num_silos, n_G), -3.0, device=dev)}


def _diag_sample(eta, eps):
    """z = μ + e^{log σ}·ε, any shape, as ONE call of the reparam kernel over
    the flattened vector (a (J, n) silo stack is one (J·n,) launch; its
    backward one more). The kernel's log q is not used (module docstring)."""
    mu = eta["mu"]
    z, _ = reparam_stl(mu.reshape(-1), eta["log_sigma"].reshape(-1), eps.reshape(-1))
    return z.reshape(mu.shape)


def _diag_logq_stl(eta, z):
    """log q(z) with the variational parameters detached (STL estimator)."""
    mu, ls = eta["mu"].detach(), eta["log_sigma"].detach()
    e = (z - mu) * torch.exp(-ls)
    return -0.5 * torch.sum(e * e) - torch.sum(ls) - 0.5 * z.numel() * _LOG_2PI


def _rows(eta) -> List[Dict[str, torch.Tensor]]:
    """A stacked (J, n) diagonal Gaussian -> its J rows."""
    return [{"mu": m, "log_sigma": s}
            for m, s in zip(eta["mu"].unbind(0), eta["log_sigma"].unbind(0), strict=True)]


@dataclasses.dataclass(frozen=True)
class TrainState:
    theta: PyTree
    eta_G: PyTree
    eta_L: PyTree
    opt_theta: PyTree
    opt_eta_G: PyTree
    opt_eta_L: PyTree
    step: int  # steps taken (a host int: the barycenter's schedule reads it)


def init_train_state(gen: torch.Generator, cfg: ArchConfig, num_silos: int,
                     lr: float = 3e-4):
    """Random θ, η_G and η_L from ``gen`` (on its device) and Adam's state."""
    theta = T.init_params(gen, cfg)
    eta_G = init_eta_G(gen, cfg)
    eta_L = init_eta_L(gen, cfg, num_silos)
    opt = adam(lr)
    return TrainState(theta=theta, eta_G=eta_G, eta_L=eta_L, opt_theta=opt.init(theta),
                      opt_eta_G=opt.init(eta_G), opt_eta_L=opt.init(eta_L), step=0), opt


def _draws(seed: int, shapes: Sequence[Tuple[int, ...]], device) -> Tuple[torch.Tensor, ...]:
    """The step's N(0, I) draws, from a generator seeded by (seed, 0)."""
    gen = generator((seed, 0), device)
    return tuple(torch.randn(shape, generator=gen, device=device) for shape in shapes)


def _value_and_grads(objective: Callable, trees: Sequence[PyTree]):
    """``objective(*trees) -> (loss, metrics)`` and d loss / d each tree's
    leaves (a list of leaf gradients per tree). The metrics come back
    detached."""
    flat = [tree_flatten(t) for t in trees]
    leaves = [[leaf.detach().requires_grad_(True) for leaf in ls] for ls, _ in flat]
    with torch.enable_grad():
        loss, metrics = objective(*[tree_unflatten(td, ls)
                                    for (_, td), ls in zip(flat, leaves, strict=True)])
        grads = list(torch.autograd.grad(loss, [leaf for ls in leaves for leaf in ls]))
    out, start = [], 0
    for ls in leaves:
        out.append(grads[start:start + len(ls)])
        start += len(ls)
    del grads
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), out


def _adam_in_place(opt, grads: List[torch.Tensor], params: PyTree, opt_state):
    """``opt.update`` then ``apply_updates``, one leaf at a time, written into
    ``params``' and ``opt_state``'s own tensors; each gradient is dropped
    from ``grads`` once used, so at most one leaf's temporaries are alive.
    Returns the optimizer state with its count advanced."""
    adam_state, rest = opt_state
    count = adam_state.count
    trios = zip(tree_leaves(params), tree_leaves(adam_state.mu), tree_leaves(adam_state.nu),
                strict=True)
    for i, (p, m, v) in enumerate(trios):
        g, grads[i] = grads[i], None
        upd, (new, _) = opt.update(g, (ScaleByAdamState(count, m, v), ()), None)
        m.copy_(new.mu)
        v.copy_(new.nu)
        p.add_(upd.to(p.dtype))
    return (ScaleByAdamState(count + 1, adam_state.mu, adam_state.nu), rest)


def _update(opt, state: TrainState, grads) -> TrainState:
    g_theta, g_eta_G, g_eta_L = grads
    return TrainState(
        theta=state.theta, eta_G=state.eta_G, eta_L=state.eta_L,
        opt_theta=_adam_in_place(opt, g_theta, state.theta, state.opt_theta),
        opt_eta_G=_adam_in_place(opt, g_eta_G, state.eta_G, state.opt_eta_G),
        opt_eta_L=_adam_in_place(opt, g_eta_L, state.eta_L, state.opt_eta_L),
        step=state.step + 1)


def _sorted(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Metrics in key order, as a jitted JAX step returns its dict (the CLI's
    lines print them in this order)."""
    return dict(sorted(metrics.items()))


def _silo_split(num_silos, base_logits, h, labels):
    """(B, S, ...) -> each silo's (B / J, S, ...) rows, as three tuples."""
    B, S, V = base_logits.shape
    Bj = B // num_silos
    return (base_logits.reshape(num_silos, Bj, S, V).unbind(0),
            h.reshape(num_silos, Bj, S, -1).unbind(0),
            labels.reshape(num_silos, Bj, S).unbind(0))


# ---------------------------------------------------------------------------
# The SFVI train step
# ---------------------------------------------------------------------------

def make_train_step(cfg: ArchConfig, num_silos: int, lr: float = 3e-4, remat: bool = True):
    """``train_step(state, batch, seed, silo_mask=None, draws=None) ->
    (state, metrics)``; metrics ``elbo``, ``nll_per_tok``, ``aux_moe``,
    ``loss`` (0-d tensors, not read on the host). ``batch``: ``tokens`` and
    ``labels`` (B, S) with B a multiple of ``num_silos``. ``silo_mask`` (J,)
    keeps the active silos' terms, rescaled by J / |active|."""
    check_port_supported(cfg)
    n_G, n_L = latent_dims(cfg)
    J = num_silos
    opt = adam(lr)

    def objective(theta, eta_G, eta_L, batch, eps_G, eps_L, silo_mask):
        z_G = _diag_sample(eta_G, eps_G)
        # Server term L̂_0, added once.
        L0 = log_prior_global(cfg, z_G) - _diag_logq_stl(eta_G, z_G)
        base_logits, aux_moe, h = T.forward(theta, cfg, batch, remat=remat)
        B, S, _ = base_logits.shape
        z_L = _diag_sample(eta_L, eps_L)
        parts = zip(*_silo_split(J, base_logits, h, batch["labels"]), z_L.unbind(0),
                    _rows(eta_L), strict=True)
        Lj = torch.stack([
            silo_log_lik(cfg, base, hh, z_G, zl, lbl) + log_prior_local(cfg, z_G, zl)
            - _diag_logq_stl(eta_Lj, zl)
            for base, hh, lbl, zl, eta_Lj in parts])
        if silo_mask is not None:
            # Partial participation: only active silos contribute; the
            # J / |active| rescale keeps the estimator unbiased.
            m = silo_mask.float()
            Lj = Lj * m * (J / torch.clamp(torch.sum(m), min=1.0))
        elbo = L0 + torch.sum(Lj)
        ntok = B * S
        loss = -elbo / ntok + AUX_LOSS_WEIGHT * aux_moe
        return loss, {"elbo": elbo, "nll_per_tok": -torch.sum(Lj) / ntok, "aux_moe": aux_moe}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int,
                   silo_mask: Optional[torch.Tensor] = None, draws=None):
        dev = state.eta_G["mu"].device
        eps_G, eps_L = draws if draws is not None else _draws(seed, ((n_G,), (J, n_L)), dev)
        (loss, metrics), grads = _value_and_grads(
            lambda th, eg, el: objective(th, eg, el, batch, eps_G, eps_L, silo_mask),
            (state.theta, state.eta_G, state.eta_L))
        return _update(opt, state, grads), _sorted(dict(metrics, loss=loss))

    return train_step


# ---------------------------------------------------------------------------
# SFVI-Avg (the communication-avoiding schedule for the latent head)
# ---------------------------------------------------------------------------

def make_train_step_avg(cfg: ArchConfig, num_silos: int, avg_every: int, lr: float = 3e-4,
                        remat: bool = True):
    """SFVI-Avg: η_G carried per silo ((J, n_G), :func:`init_eta_G_silo`);
    silos take local VI steps with their own ε_G and the N/N_j = J
    likelihood rescale, and every ``avg_every`` steps η_G becomes the
    diagonal-Gaussian Wasserstein barycenter of the silos' rows (μ* = mean
    μ_j, σ* = mean σ_j), computed by the combine kernel with equal weights
    (two launches: the μ rows and the σ rows), on due steps only. θ takes
    the summed gradient every step. (The reference's static
    ``include_barycenter`` switch, which only its comm benchmark sets, has
    no counterpart.)
    ``train_step(state, batch, seed, draws=None)``; metrics
    ``elbo_local_mean`` and ``loss``."""
    check_port_supported(cfg)
    n_G, n_L = latent_dims(cfg)
    J = num_silos
    opt = adam(lr)

    def objective(theta, eta_G, eta_L, batch, eps_G, eps_L):
        base_logits, aux_moe, h = T.forward(theta, cfg, batch, remat=remat)
        B, S, _ = base_logits.shape
        scale = float(J)  # N/N_j likelihood rescale (§3.2 point 2)
        z_G = _diag_sample(eta_G, eps_G)
        z_L = _diag_sample(eta_L, eps_L)
        parts = zip(*_silo_split(J, base_logits, h, batch["labels"]), z_G.unbind(0),
                    z_L.unbind(0), _rows(eta_G), _rows(eta_L), strict=True)
        Lj = torch.stack([
            log_prior_global(cfg, zg) - _diag_logq_stl(eta_Gj, zg)
            + scale * (silo_log_lik(cfg, base, hh, zg, zl, lbl) + log_prior_local(cfg, zg, zl))
            - _diag_logq_stl(eta_Lj, zl)
            for base, hh, lbl, zg, zl, eta_Gj, eta_Lj in parts])
        # Local objectives are independent; summing just runs them jointly.
        loss = -torch.sum(Lj) / (B * S * scale) + AUX_LOSS_WEIGHT * aux_moe
        return loss, {"elbo_local_mean": torch.mean(Lj)}

    def barycenter(eta_G) -> None:
        """η_G's rows <- their diagonal W2 barycenter, in place."""
        ones = torch.ones((J,), dtype=torch.float32, device=eta_G["mu"].device)
        mu = wire_kernels.fused_combine(eta_G["mu"], ones)
        sigma = wire_kernels.fused_combine(torch.exp(eta_G["log_sigma"]), ones)
        eta_G["mu"].copy_(mu.expand(J, -1))
        eta_G["log_sigma"].copy_(torch.log(sigma).expand(J, -1))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int, draws=None):
        dev = state.eta_G["mu"].device
        eps_G, eps_L = draws if draws is not None else _draws(
            seed, ((J, n_G), (J, n_L)), dev)
        (loss, metrics), grads = _value_and_grads(
            lambda th, eg, el: objective(th, eg, el, batch, eps_G, eps_L),
            (state.theta, state.eta_G, state.eta_L))
        new_state = _update(opt, state, grads)
        if (state.step + 1) % avg_every == 0:  # the ONLY cross-silo exchange of η_G
            barycenter(new_state.eta_G)
        return new_state, _sorted(dict(metrics, loss=loss))

    return train_step


# ---------------------------------------------------------------------------
# Serve steps (posterior-mean model)
# ---------------------------------------------------------------------------

def _silo_heads(cfg, num_silos, logits, h, eta_G, eta_L):
    """(B, 1, V) base logits -> each silo group's Bayesian-head logits."""
    B = logits.shape[0]
    Bj = B // num_silos
    z_G = eta_G["mu"]
    lj = logits.reshape(num_silos, Bj, 1, -1)
    hj = h.reshape(num_silos, Bj, 1, -1)
    out = vmap(lambda b, hh, zl: bayes_logits(cfg, b, hh, z_G, zl))(lj, hj, eta_L["mu"])
    return out.reshape(B, 1, -1)


def make_serve_prefill(cfg: ArchConfig, num_silos: int, max_len: int):
    def serve_step_prefill(theta, eta_G, eta_L, batch):
        logits, cache, h = T.prefill(theta, cfg, batch, max_len=max_len)
        return _silo_heads(cfg, num_silos, logits, h, eta_G, eta_L), cache

    return serve_step_prefill


def make_serve_decode(cfg: ArchConfig, num_silos: int):
    def serve_step_decode(theta, eta_G, eta_L, tokens, cache):
        logits, new_cache, h = T.decode_step(theta, cfg, tokens, cache)
        return _silo_heads(cfg, num_silos, logits, h, eta_G, eta_L), new_cache

    return serve_step_decode
