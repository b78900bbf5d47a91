"""The port's HMC oracle (``repro_torch.inference.hmc_sample``) against the JAX package's.

The reference's draws are rebuilt in JAX exactly as ``src/repro/inference/
hmc.py:86-100`` makes them (``split(key, total)``, each key split into
(k1, k2), ``normal(k1, (dim,))``, ``uniform(k2)``) and injected into the
port (``draws=``); both chains start from the same numpy-seeded position.

* A Gaussian target (dim 3, scales 0.5 / 1 / 2) and the pooled GLMM of
  ``benchmarks/bench_glmm.py:37-45`` at 10 children (dim 15, the port's
  ``models.paper.glmm.pooled_log_prob`` against the reference's
  ``glmm_log_joint_local`` on the same arrays), 24 leapfrog steps, up to
  the first draw whose u lies within 1e-5 of the port's α (a decision the
  two could take apart; the test says which draw that is, if any, and
  holds the samples before it):
  - in float64 (both packages; JAX under ``enable_x64``), 20 warmup + 30
    samples: samples within rtol 1e-5 and atol 1e-5 of the largest
    |sample|, accept rates within 1e-5 and the same accept decisions.
    Without warmup the float64 chains agree to 2e-16; with it, dual
    averaging tries step sizes past the leapfrog's stability limit (ε 1.44
    at the first draw against 2·0.5 for the Gaussian), and 24 unstable
    steps multiply a rounding difference by ~1e4 in one draw (the sixth:
    1.7e-16 -> 2.2e-12), so over 50 draws the float64 chains part by up
    to 5e-6 of the largest |sample| and float32 chains by 1e-3 after six
    draws;
  - in float32, 4 warmup + 4 samples (before that regime): rtol 1e-4,
    atol 1e-5 of the largest |sample|. On the GLMM a float32 chain's
    third draw overflows (α nan) and the adaptation stays nan after, in
    both packages alike.
* The mass-matrix refresh at ``num_warmup // 2`` and the final step size:
  a chain of 20 warmup draws refreshes once (the samples move), and one of
  0 warmup draws keeps ε at 0.1.
* The moments of a known Gaussian (dim 2, mean (1, −2), sd (0.5, 2)) from
  the port's own generator: 300 warmup + 1,200 samples; means within 0.15
  sd and sds within 15 %.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.inference import hmc_sample as j_hmc
from repro.models.paper.glmm import glmm_log_joint_local as j_glmm_local
from repro.models.paper.registry import get_model as j_get_model
from repro_torch.inference import hmc_sample as t_hmc
from repro_torch.models.paper.glmm import pooled_log_prob
from repro_torch.models.paper.registry import get_model as t_get_model

TIE = 1e-5  # |u - α| under which the two packages may decide a draw apart
LEAPFROG = 24
RUNS = {  # dtype: (warmup, samples, rtol, atol)
    "float64": (20, 30, 1e-5, 1e-5),
    "float32": (4, 4, 1e-4, 1e-5),
}  # atol: of the largest |sample|
RTOL, ATOL = RUNS["float32"][2:]
SCALES = np.array([0.5, 1.0, 2.0], np.float32)
CENTER = np.array([0.3, -1.0, 2.0], np.float32)


def reference_draws(key, total, dim):
    """The reference's per-draw (normal (dim,), uniform) from ``key``."""
    keys = jax.random.split(key, total)

    def one(k):
        k1, k2 = jax.random.split(k)
        return jax.random.normal(k1, (dim,)), jax.random.uniform(k2)

    normals, uniforms = jax.vmap(one)(keys)
    return torch.as_tensor(np.asarray(normals)), torch.as_tensor(np.asarray(uniforms))


def _gauss_j(q):
    return -0.5 * jnp.sum(((q - CENTER) / SCALES) ** 2)


def _gauss_t(q):
    c, s = torch.as_tensor(CENTER), torch.as_tensor(SCALES)
    return -0.5 * torch.sum(((q - c) / s) ** 2)


def _glmm_targets(dtype=np.float32):
    bundle = j_get_model("glmm").build(0, 2, num_children=10)
    pooled = {k: np.asarray(v, dtype) for k, v in bundle.extras["pooled"].items()}

    def j_lp(q):
        z_G, b = q[:5], q[5:]
        return jnp.sum(-0.5 * z_G**2 / 100.0) + j_glmm_local(z_G, b, pooled)

    t_data = {k: torch.as_tensor(v) for k, v in pooled.items()}
    return j_lp, pooled_log_prob(t_data), 5 + int(pooled["y"].shape[0])


def _targets(name, dtype):
    if name == "gaussian":
        return _gauss_j, _gauss_t, 3
    return _glmm_targets(dtype)


def _run_both(name, dtype, warmup, samples, seed=4):
    """Both chains from one position on the reference's draws; the JAX one
    in ``dtype`` (x64 on for float64), the port's on the same draws."""
    np_dtype = np.dtype(dtype)
    with jax.enable_x64(np_dtype == np.float64):
        j_lp, t_lp, dim = _targets(name, np_dtype)
        init = (0.1 * np.random.default_rng(seed).standard_normal(dim)).astype(np_dtype)
        key = jax.random.PRNGKey(seed)
        j_s, j_acc = j_hmc(j_lp, jnp.asarray(init), key, num_samples=samples,
                           num_warmup=warmup, num_leapfrog=LEAPFROG)
        draws = reference_draws(key, warmup + samples, dim)
        j_s, j_acc = np.asarray(j_s), float(j_acc)
    assert j_s.dtype == np_dtype and draws[0].dtype == getattr(torch, dtype)
    trace = {}
    t_s, t_acc = t_hmc(t_lp, torch.as_tensor(init), num_samples=samples, num_warmup=warmup,
                       num_leapfrog=LEAPFROG, draws=draws, trace=trace)
    return j_s, j_acc, t_s.numpy(), float(t_acc), trace, draws[1].numpy()


@pytest.mark.parametrize("dtype", sorted(RUNS))
@pytest.mark.parametrize("name", ["gaussian", "glmm_10_children"])
def test_chain_matches_the_reference(name, dtype):
    warmup, samples, rtol, atol = RUNS[dtype]
    j_s, j_acc, t_s, t_acc, trace, u = _run_both(name, dtype, warmup, samples)
    assert t_s.shape == j_s.shape == (samples, j_s.shape[1]) and t_s.dtype == j_s.dtype
    assert np.isfinite(t_s).all()
    scale = float(np.abs(j_s).max())
    ties = np.flatnonzero(np.abs(u - trace["alpha"].numpy()) < TIE)
    if ties.size:
        first = int(ties[0])
        print(f"{name} {dtype}: draw {first} has u within {TIE} of alpha; held up to it")
        held = max(first - warmup, 0)
        np.testing.assert_allclose(t_s[:held], j_s[:held], rtol=rtol, atol=atol * scale)
        return
    np.testing.assert_allclose(t_s, j_s, rtol=rtol, atol=atol * scale)
    # A proposal that overflows (e^{2ω} b² at an early, too large ε) has α
    # nan in both packages and is rejected; the mean is then nan in both.
    np.testing.assert_allclose(t_acc, j_acc, rtol=0, atol=max(rtol, TIE), equal_nan=True)
    # The accept decisions: a sampling-phase draw moved the chain iff accepted.
    acc = trace["accept"].numpy()[warmup:]
    assert np.array_equal(acc[1:], np.any(j_s[1:] != j_s[:-1], axis=1))


def test_refresh_and_step_size():
    """The inverse mass refreshes at warm count num_warmup // 2 (the chain
    with a refresh parts from one whose clip range holds it at 1), and with
    no warmup ε stays at its start of 0.1 (then the refresh is every draw,
    from a zero variance: 1e-4, as the reference's formula gives)."""
    draws = reference_draws(jax.random.PRNGKey(2), 50, 3)
    init = torch.as_tensor(CENTER + 0.1)
    trace = {}
    t_hmc(_gauss_t, init, num_samples=30, num_warmup=20, num_leapfrog=8, draws=draws,
          trace=trace)
    assert float(trace["step_size"]) != pytest.approx(0.1)
    j_s, _ = j_hmc(_gauss_j, jnp.asarray(init.numpy()), jax.random.PRNGKey(2), num_samples=50,
                   num_warmup=0, num_leapfrog=8)
    trace0 = {}
    t_s, _ = t_hmc(_gauss_t, init, num_samples=50, num_warmup=0, num_leapfrog=8, draws=draws,
                   trace=trace0)
    assert float(trace0["step_size"]) == pytest.approx(0.1, rel=1e-6)
    # ε 0.1 is far inside the stability limit: float32 chains stay together.
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=RTOL, atol=ATOL)


def test_moments_of_a_known_gaussian():
    mean, sd = np.array([1.0, -2.0]), np.array([0.5, 2.0])

    def lp(q):
        return -0.5 * torch.sum(((q - torch.as_tensor(mean, dtype=q.dtype))
                                 / torch.as_tensor(sd, dtype=q.dtype)) ** 2)

    gen = torch.Generator().manual_seed(0)
    s, acc = t_hmc(lp, torch.zeros(2), gen, num_samples=1200, num_warmup=300, num_leapfrog=10)
    s = s.numpy()
    assert np.all(np.abs(s.mean(0) - mean) < 0.15 * sd), s.mean(0)
    assert np.all(np.abs(s.std(0) / sd - 1.0) < 0.15), s.std(0)
    assert 0.5 < float(acc) <= 1.0


def test_draws_are_checked_and_a_stream_is_needed():
    with pytest.raises(ValueError, match="want"):
        t_hmc(_gauss_t, torch.zeros(3), num_samples=2, num_warmup=2,
              draws=(torch.zeros(4, 2), torch.zeros(4)))
    with pytest.raises(ValueError, match="Generator"):
        t_hmc(_gauss_t, torch.zeros(3), num_samples=2, num_warmup=2)


def test_glmm_bundle_pooled_target_matches_the_reference():
    """The port's glmm bundle stages ``pooled`` as the silos' children
    before the split; on the reference's arrays the pooled target's value
    and gradient equal the reference's within 1e-5 relative."""
    j_lp, t_lp, dim = _glmm_targets()
    q = (0.3 * np.random.default_rng(1).standard_normal(dim)).astype(np.float32)
    jv, jg = jax.value_and_grad(j_lp)(jnp.asarray(q))
    tq = torch.as_tensor(q).requires_grad_(True)
    tv = t_lp(tq)
    (tg,) = torch.autograd.grad(tv, tq)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)
    bundle = t_get_model("glmm").build(0, 2, device="cpu", num_children=10)
    pooled = bundle.extras["pooled"]
    assert bundle.extras["num_children"] == 10 == pooled["y"].shape[0]
    torch.testing.assert_close(
        torch.cat([d["y"] for d in bundle.datas]).sort(0).values, pooled["y"].sort(0).values)
