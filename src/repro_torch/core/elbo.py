"""ELBO and the sticking-the-landing (STL) gradient estimator (paper §2, eq. (6)).

The PyTorch twin of ``repro.core.elbo``. The STL estimator is the path
derivative of

    L̂ = log p_θ(Z, y) − log q_η̃(Z),     Z = f_η(ε),  η̃ = stop_gradient(η),

so ``torch.func.grad`` of :func:`stl_objective` w.r.t. the variational
parameters is (6): the parameters are ``.detach()``-ed inside log q only.
Sample axes run under ``torch.func.vmap``, as in ``core/sfvi.py``.

The reference's ``*_value`` functions take a JAX key; here they take the
ε tensor itself, or a ``torch.Generator`` that draws it.
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch
from torch.func import vmap

from repro_torch.core.family import eps_shape
from repro_torch.core.sfvi import _stop

LogJoint = Callable[[torch.Tensor], torch.Tensor]
EpsSource = Union[torch.Tensor, torch.Generator]


def _draw(source: EpsSource, shape) -> torch.Tensor:
    """ε of ``shape`` from a generator, or the injected tensor as it is."""
    if isinstance(source, torch.Generator):
        return torch.randn(shape, generator=source, device=source.device)
    return source


def stl_objective(log_joint: LogJoint, family, params, eps: torch.Tensor) -> torch.Tensor:
    """Single-sample STL surrogate: its gradient w.r.t. ``params`` is the STL gradient."""
    z = family.sample(params, eps)
    return log_joint(z) - family.log_prob(_stop(params), z)


def elbo_objective(log_joint: LogJoint, family, params, eps: torch.Tensor) -> torch.Tensor:
    """Plain (total-derivative) single-sample ELBO estimator, for comparison."""
    z = family.sample(params, eps)
    return log_joint(z) - family.log_prob(params, z)


def elbo_value(log_joint: LogJoint, family, params, eps: EpsSource,
               num_samples: int = 32) -> torch.Tensor:
    """Monte-Carlo ELBO value (no gradient tricks) for monitoring.

    ``eps`` is the (num_samples, *eps_shape) draw, or a generator that
    draws it.
    """
    eps = _draw(eps, (num_samples,) + eps_shape(family))

    def one(e):
        z = family.sample(params, e)
        return log_joint(z) - family.log_prob(params, z)

    return torch.mean(vmap(one)(eps))


def iwae_objective(log_joint: LogJoint, family, params, eps: torch.Tensor) -> torch.Tensor:
    """K-sample importance-weighted bound (Burda et al., 2016) with the
    doubly-reparametrized gradient estimator (DReG; Tan et al., 2020).

    ``eps`` is (K, dim). The normalized weights are detached, so the
    gradient of ``Σ_k ŵ_k log w_k`` is the DReG estimator; a detached
    correction makes the VALUE the IWAE bound logsumexp(log w) − log K.
    """
    params_stop = _stop(params)

    def log_w(e):
        z = family.sample(params, e)
        return log_joint(z) - family.log_prob(params_stop, z)

    lw = vmap(log_w)(eps)  # (K,)
    w_norm = torch.softmax(lw, dim=0).detach()
    surrogate = torch.sum(w_norm * lw)
    bound = (torch.logsumexp(lw, dim=0) - math.log(lw.shape[0]) - surrogate).detach()
    return surrogate + bound


def iwae_value(log_joint: LogJoint, family, params, eps: EpsSource,
               num_samples: int = 32) -> torch.Tensor:
    """Monte-Carlo IWAE bound value (monitoring; >= ELBO in expectation).

    ``eps`` is the (num_samples, family.dim) draw, or a generator that
    draws it.
    """
    eps = _draw(eps, (num_samples, family.dim))

    def log_w(e):
        z = family.sample(params, e)
        return log_joint(z) - family.log_prob(params, z)

    lw = vmap(log_w)(eps)
    return torch.logsumexp(lw, dim=0) - math.log(float(eps.shape[0]))
