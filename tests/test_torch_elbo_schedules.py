"""The port's ELBO estimators, learning-rate schedules and ``scale_by_schedule``
against the JAX package.

* ``core/elbo.py``: the same ε in, each objective (STL, plain ELBO, the
  DReG IWAE surrogate) gives the reference's value and, through
  ``torch.func.grad``, the reference's ``jax.grad`` within rtol 1e-5
  (atol 1e-6 for entries near zero): float32 reassociation only. The
  monitoring values (``elbo_value``, ``iwae_value``) take the ε tensor, or
  a generator that draws it, and equal the reference's on that ε.
* ``optim/schedules.py``: the four schedules at counts 0..200 within rtol
  1e-6 (float32 rounding of the same expressions); ``scale_by_schedule``
  over 200 updates gives the reference's updates and its int32 count, and
  its state converts with ``convert.from_jax_state``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from repro.core import CholeskyGaussian as JChol
from repro.core import DiagGaussian as JDiag
from repro.core import elbo as jelbo
from repro.optim import base as jbase
from repro.optim import schedules as jsched
from repro_torch.convert import from_jax_state
from repro_torch.core import CholeskyGaussian as TChol
from repro_torch.core import DiagGaussian as TDiag
from repro_torch.core import elbo as telbo
from repro_torch.optim import base as tbase
from repro_torch.optim import schedules as tsched

DIM, K = 4, 6
RTOL, ATOL = 1e-5, 1e-6

FAMILIES = {"diag": (JDiag, TDiag), "cholesky": (JChol, TChol)}


def _j_log_joint(z):
    return -0.5 * jnp.sum((z - 0.3) ** 2) + jnp.sum(jnp.log1p(jnp.exp(0.5 * z)))


def _t_log_joint(z):
    return -0.5 * torch.sum((z - 0.3) ** 2) + torch.sum(torch.log1p(torch.exp(0.5 * z)))


def _params(fam_name):
    rng = np.random.default_rng(11)
    jfam = FAMILIES[fam_name][0](DIM)
    init = jfam.init(jax.random.PRNGKey(3), mu_scale=0.5)
    # A spread of log σ and, for the Cholesky family, a non-trivial factor.
    return {k: (np.asarray(v) + 0.2 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in init.items()}


def _assert_tree_close(t_tree, j_tree):
    assert sorted(t_tree) == sorted(j_tree)
    for k in t_tree:
        np.testing.assert_allclose(t_tree[k].numpy(), np.asarray(j_tree[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("objective", ["stl_objective", "elbo_objective"])
@pytest.mark.parametrize("fam_name", list(FAMILIES))
def test_single_sample_objectives_match_reference(objective, fam_name):
    jcls, tcls = FAMILIES[fam_name]
    jfam, tfam = jcls(DIM), tcls(DIM)
    p = _params(fam_name)
    eps = np.random.default_rng(5).standard_normal(DIM).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jfn = getattr(jelbo, objective)
    tfn = getattr(telbo, objective)
    jv, jg = jax.value_and_grad(lambda q: jfn(_j_log_joint, jfam, q, jnp.asarray(eps)))(jp)
    tv = tfn(_t_log_joint, tfam, tp, torch.as_tensor(eps))
    tg = grad(lambda q: tfn(_t_log_joint, tfam, q, torch.as_tensor(eps)))(tp)
    np.testing.assert_allclose(float(tv), float(jv), rtol=RTOL)
    _assert_tree_close(tg, jg)


@pytest.mark.parametrize("fam_name", list(FAMILIES))
def test_iwae_dreg_surrogate_matches_reference(fam_name):
    jcls, tcls = FAMILIES[fam_name]
    jfam, tfam = jcls(DIM), tcls(DIM)
    p = _params(fam_name)
    eps = np.random.default_rng(6).standard_normal((K, DIM)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jv, jg = jax.value_and_grad(
        lambda q: jelbo.iwae_objective(_j_log_joint, jfam, q, jnp.asarray(eps)))(jp)
    tv = telbo.iwae_objective(_t_log_joint, tfam, tp, torch.as_tensor(eps))
    tg = grad(lambda q: telbo.iwae_objective(_t_log_joint, tfam, q, torch.as_tensor(eps)))(tp)
    np.testing.assert_allclose(float(tv), float(jv), rtol=RTOL)
    _assert_tree_close(tg, jg)
    # The value is the IWAE bound on these ε.
    bound = telbo.iwae_value(_t_log_joint, tfam, tp, torch.as_tensor(eps))
    np.testing.assert_allclose(float(tv), float(bound), rtol=RTOL)


@pytest.mark.parametrize("fn", ["elbo_value", "iwae_value"])
def test_monitoring_values_match_reference_on_the_same_eps(fn):
    jfam, tfam = JDiag(DIM), TDiag(DIM)
    p = _params("diag")
    key = jax.random.PRNGKey(9)
    n = 16
    # The reference draws ε = normal(key, (n, dim)); hand that draw to the port.
    eps = np.array(jax.random.normal(key, (n, DIM)))
    jv = getattr(jelbo, fn)(_j_log_joint, jfam, {k: jnp.asarray(v) for k, v in p.items()},
                            key, num_samples=n)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    tv = getattr(telbo, fn)(_t_log_joint, tfam, tp, torch.as_tensor(eps), num_samples=n)
    np.testing.assert_allclose(float(tv), float(jv), rtol=RTOL)
    # A generator draws the same ε as torch.randn on a generator in the same state.
    gen = torch.Generator().manual_seed(4)
    drawn = torch.randn((n, DIM), generator=torch.Generator().manual_seed(4))
    np.testing.assert_allclose(
        float(getattr(telbo, fn)(_t_log_joint, tfam, tp, gen, num_samples=n)),
        float(getattr(telbo, fn)(_t_log_joint, tfam, tp, drawn, num_samples=n)), rtol=0)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

SCHEDULES = {
    "constant": (lambda m: m.constant_schedule(0.3)),
    "warmup": (lambda m: m.warmup_schedule(0.1, 25)),
    "warmup_0": (lambda m: m.warmup_schedule(0.1, 0)),
    "cosine": (lambda m: m.cosine_decay_schedule(0.2, 150, alpha=0.1)),
    "warmup_cosine": (lambda m: m.linear_warmup_cosine_decay(0.05, 20, 180, alpha=0.05)),
    "warmup_cosine_short": (lambda m: m.linear_warmup_cosine_decay(1.0, 10, 5)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_reference_over_200_counts(name):
    js, ts = SCHEDULES[name](jsched), SCHEDULES[name](tsched)
    counts = np.arange(201, dtype=np.int32)
    want = np.array([float(js(jnp.asarray(c))) for c in counts], np.float32)
    got = np.array([float(ts(torch.tensor(c, dtype=torch.int32))) for c in counts],
                   np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)
    out = ts(torch.tensor(7, dtype=torch.int32))
    assert out.dtype == torch.float32 and out.shape == ()


@pytest.mark.parametrize("name", ["warmup", "warmup_cosine"])
def test_scale_by_schedule_matches_reference(name):
    jt = jbase.scale_by_schedule(SCHEDULES[name](jsched))
    tt = tbase.scale_by_schedule(SCHEDULES[name](tsched))
    rng = np.random.default_rng(2)
    params = {"a": np.zeros((3,), np.float32), "b": np.zeros((), np.float32)}
    js = jt.init({k: jnp.asarray(v) for k, v in params.items()})
    ts = tt.init({k: torch.as_tensor(v) for k, v in params.items()})
    assert ts.count.dtype == torch.int32 and int(ts.count) == 0
    for _ in range(200):
        g = {k: rng.standard_normal(np.shape(v)).astype(np.float32) for k, v in params.items()}
        ju, js = jt.update({k: jnp.asarray(v) for k, v in g.items()}, js)
        tu, ts = tt.update({k: torch.as_tensor(v) for k, v in g.items()}, ts)
        _assert_tree_close(tu, ju)
    assert int(ts.count) == int(js.count) == 200
    # The reference state converts leaf by leaf to the port's class.
    state = from_jax_state({"theta": {}, "eta_G": {}, "eta_L": {}, "opt_local": {},
                            "opt_server": jax.tree_util.tree_map(np.asarray, js)},
                           "cpu")["opt_server"]
    assert isinstance(state, tbase.ScaleByScheduleState)
    assert state.count.dtype == torch.int32 and int(state.count) == 200
