"""Hamiltonian Monte Carlo: the paper's MCMC oracle (the port of ``repro.inference.hmc``).

The paper compares SFVI's GLMM posterior with NUTS; the reference stands
in HMC with dual-averaging step-size adaptation (Hoffman & Gelman 2014,
§3.2) and a diagonal mass matrix from a Welford variance, and so does the
port, step for step:

  * leapfrog with half steps of the momentum, ``num_leapfrog`` a draw;
  * dual averaging during warmup: γ 0.05, t0 10, κ 0.75, μ = log 1, ε
    starting at 0.1, and after warmup the averaged ε;
  * the Welford variance of the warmup positions, which becomes the
    inverse mass (clipped to [1e-4, 1e4]) once, when the warmup count
    reaches ``num_warmup // 2``;
  * log α clipped to [−1e3, 0], a draw accepted when u < α.

The chain is a host loop of small launches (no kernel of its own): each
gradient is ``torch.func.grad_and_value`` of ``log_prob_fn``, and the
accept decision and the adaptation stay on the device (no host read until
the end). A leapfrog step's closing gradient is its successor's opening
one, so it is computed once (the same value: the reference's two calls
at one position agree bit for bit).

Randomness: ``gen`` (a ``torch.Generator`` on the chain's device) draws
the momenta and the uniforms, or ``draws=(normals (total, dim), uniforms
(total,))`` injects them; the reference's threefry draws are made by
``split(key, total)``, then ``split`` of each key into (k1, k2),
``normal(k1, (dim,))`` and ``uniform(k2)``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch.func import grad_and_value

DA_GAMMA, DA_T0, DA_KAPPA = 0.05, 10.0, 0.75
DA_MU = math.log(10.0 * 0.1)
EPS_INIT = 0.1
INV_MASS_CLIP = (1e-4, 1e4)
LOG_ALPHA_MIN = -1e3


def hmc_sample(
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    init_position: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    num_leapfrog: int = 32,
    target_accept: float = 0.8,
    *,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    trace: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (samples (num_samples, dim), the mean accept probability α
    over the sampling phase), both on ``init_position``'s device.

    ``gen`` or ``draws`` gives the randomness (module docstring). ``trace``,
    when given, receives the per-draw α (``"alpha"``, (total,)) and accept
    decisions (``"accept"``) and the warmup's final step size
    (``"step_size"``), for parity checks.
    """
    dev, dtype = init_position.device, init_position.dtype
    dim = init_position.shape[0]
    total = num_warmup + num_samples
    if draws is None:
        if gen is None:
            raise ValueError("hmc_sample needs a torch.Generator or injected draws")
        normals = torch.randn((total, dim), generator=gen, device=dev, dtype=dtype)
        uniforms = torch.rand((total,), generator=gen, device=dev, dtype=dtype)
    else:
        normals, uniforms = (d.to(device=dev, dtype=dtype) for d in draws)
        if tuple(normals.shape) != (total, dim) or tuple(uniforms.shape) != (total,):
            raise ValueError(
                f"draws of shapes {tuple(normals.shape)}, {tuple(uniforms.shape)}; want "
                f"({total}, {dim}) and ({total},)")
    value_grad = grad_and_value(log_prob_fn)

    def scalar(x):
        return torch.tensor(x, device=dev, dtype=dtype)

    q = init_position.detach().clone()
    g, lp = value_grad(q)
    log_eps = log_eps_bar = scalar(math.log(EPS_INIT))
    h_bar, warm_i = scalar(0.0), scalar(0.0)
    inv_mass = torch.ones(dim, device=dev, dtype=dtype)
    count, mean, m2 = scalar(0.0), torch.zeros(dim, device=dev, dtype=dtype), \
        torch.zeros(dim, device=dev, dtype=dtype)
    n_warm = 0  # warm_i on the host: the refresh is decided without a device read
    samples, alphas, accepts = [], [], []
    for i in range(total):
        warm = i < num_warmup
        eps = torch.exp(log_eps)
        p0 = normals[i] / torch.sqrt(inv_mass)
        # Leapfrog from (q, p0); g is ∇ log p at the current position.
        qn, p, gn, lpn = q, p0, g, lp
        for _ in range(num_leapfrog):
            p = p + 0.5 * eps * gn
            qn = qn + eps * inv_mass * p
            gn, lpn = value_grad(qn)
            p = p + 0.5 * eps * gn
        h0 = -lp + 0.5 * torch.sum(p0 * p0 * inv_mass)
        h1 = -lpn + 0.5 * torch.sum(p * p * inv_mass)
        alpha = torch.exp(torch.clamp(h0 - h1, LOG_ALPHA_MIN, 0.0))
        accept = uniforms[i] < alpha
        q = torch.where(accept, qn, q)
        g = torch.where(accept, gn, g)
        lp = torch.where(accept, lpn, lp)
        if warm:
            # Dual averaging.
            n_warm += 1
            warm_i = warm_i + 1.0
            eta = 1.0 / (warm_i + DA_T0)
            h_bar = (1.0 - eta) * h_bar + eta * (target_accept - alpha)
            log_eps = DA_MU - torch.sqrt(warm_i) / DA_GAMMA * h_bar
            pow_ = warm_i ** (-DA_KAPPA)
            log_eps_bar = pow_ * log_eps + (1.0 - pow_) * log_eps_bar
            # Welford variance of the warmup positions.
            count = count + 1.0
            delta = q - mean
            mean = mean + delta / torch.clamp(count, min=1.0)
            m2 = m2 + delta * (q - mean)
        else:
            log_eps = log_eps_bar
        if n_warm == num_warmup // 2:
            var = m2 / torch.clamp(count - 1.0, min=1.0)
            inv_mass = torch.clamp(var, *INV_MASS_CLIP)
        if not warm:
            samples.append(q)
        alphas.append(alpha)
        accepts.append(accept)
    if trace is not None:
        trace.update(alpha=torch.stack(alphas), accept=torch.stack(accepts),
                     step_size=torch.exp(log_eps_bar))
    alpha_s = torch.stack(alphas[num_warmup:]) if num_samples else torch.zeros(0, device=dev)
    return (torch.stack(samples) if samples else torch.zeros((0, dim), device=dev, dtype=dtype),
            torch.mean(alpha_s))
