"""The full-covariance W2 barycenter and its Newton–Schulz square root
against the JAX package.

* the plain Newton–Schulz step (``kernels/ref.py``; what the CUDA kernel's
  wrapper runs for a CPU tensor) against the JAX Pallas step in interpret
  mode, batched with ``jax.vmap``: rtol 1e-5;
* ``sqrtm_newton_schulz``, ``sqrtm_eigh``, ``gaussian_barycenter_cov``,
  ``wasserstein2_gaussian`` and the ``"full"`` branch of
  ``family_barycenter`` (plain and fused backends) at J = 3,
  d in {1, 3, 5}: rtol 1e-5, atol 1e-6. Fifty fixed-point steps of forty
  square roots each compound float32 rounding, yet both sides run the same
  matmul sequence in f32 and stay within a few ulps;
* ``family_barycenter`` forwards ``sqrtm_iters`` (40) to the backend on
  both wires: one SFVI-Avg merge takes exactly 50 × 2 × 40 = 4,000 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import barycenter as jb
from repro.core import families as jfam
from repro.federated import aggregation as jagg
from repro.kernels import wire as jwire
from repro_torch.core import barycenter as tb
from repro_torch.core import families as tfam
from repro_torch.federated import aggregation as tagg
from repro_torch.federated.runtime import FusedReduction
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wire as twire

RTOL, ATOL = 1e-5, 1e-6


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _spd(rng, J, d, jitter=0.2):
    a = rng.standard_normal((J, d, d)).astype(np.float32) / np.sqrt(d)
    return (a @ np.swapaxes(a, -1, -2) + jitter * np.eye(d, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("B,d", [(1, 1), (3, 5), (2, 17)])
def test_plain_ns_step_matches_pallas_step(B, d):
    rng = np.random.default_rng(B * 100 + d)
    y = (rng.standard_normal((B, d, d)) / np.sqrt(d)).astype(np.float32)
    z = (rng.standard_normal((B, d, d)) / np.sqrt(d)).astype(np.float32)
    jy, jz = jax.vmap(lambda a, b: jwire.newton_schulz_step(a, b, interpret=True))(
        jnp.asarray(y), jnp.asarray(z))
    ty, tz = tref.newton_schulz_step_ref(torch.as_tensor(y), torch.as_tensor(z))
    _close(ty, jy)
    _close(tz, jz)
    # the wrapper takes the plain version for CPU tensors, and counts nothing
    before = dict(twire.LAUNCHES)
    wy, wz = twire.newton_schulz_step(torch.as_tensor(y), torch.as_tensor(z))
    np.testing.assert_array_equal(wy.numpy(), ty.numpy())
    np.testing.assert_array_equal(wz.numpy(), tz.numpy())
    assert twire.LAUNCHES == before


@pytest.mark.parametrize("d", [1, 3, 5])
def test_sqrtm_backends_match_reference(d):
    rng = np.random.default_rng(d)
    mats = _spd(rng, 3, d)
    want_ns = jax.vmap(lambda m: jb.sqrtm_newton_schulz(m, num_iters=40))(jnp.asarray(mats))
    t = torch.as_tensor(mats)
    _close(tb.sqrtm_newton_schulz(t, num_iters=40), want_ns)
    _close(twire.sqrtm_newton_schulz_fused(t, num_iters=40), want_ns)
    _close(tref.newton_schulz_sqrtm_ref(t, 40), want_ns)
    _close(tb.sqrtm_eigh(t), jax.vmap(jb.sqrtm_eigh)(jnp.asarray(mats)), rtol=1e-4, atol=1e-5)
    # one unbatched (d, d) matrix through the fused square root
    _close(twire.sqrtm_newton_schulz_fused(t[0], num_iters=40), want_ns[0])


@pytest.mark.parametrize("d", [1, 3, 5])
def test_gaussian_barycenter_cov_matches_reference(d):
    rng = np.random.default_rng(30 + d)
    covs = _spd(rng, 3, d)
    w = np.asarray([0.5, 0.2, 0.3], np.float32)
    root_j = lambda m: jb.sqrtm_newton_schulz(m, num_iters=40)  # noqa: E731
    root_t = lambda m: tb.sqrtm_newton_schulz(m, num_iters=40)  # noqa: E731
    want = jb.gaussian_barycenter_cov(jnp.asarray(covs), weights=jnp.asarray(w),
                                      num_fp_iters=50, sqrtm=root_j)
    got = tb.gaussian_barycenter_cov(torch.as_tensor(covs), weights=torch.as_tensor(w),
                                     num_fp_iters=50, sqrtm=root_t)
    _close(got, want)
    mus = rng.standard_normal((3, d)).astype(np.float32)
    jm, jc = jb.gaussian_barycenter(jnp.asarray(mus), jnp.asarray(covs), num_fp_iters=10)
    tm, tc = tb.gaussian_barycenter(torch.as_tensor(mus), torch.as_tensor(covs),
                                    num_fp_iters=10)
    _close(tm, jm)
    _close(tc, jc, rtol=1e-4, atol=1e-5)  # eigh backend
    w2_j = jb.wasserstein2_gaussian(jnp.asarray(mus[0]), jnp.asarray(covs[0]),
                                    jnp.asarray(mus[1]), jnp.asarray(covs[1]))
    w2_t = tb.wasserstein2_gaussian(torch.as_tensor(mus[0]), torch.as_tensor(covs[0]),
                                    torch.as_tensor(mus[1]), torch.as_tensor(covs[1]))
    _close(w2_t, w2_j, rtol=1e-4, atol=1e-5)


def _stacked_cholesky(rng, J, d):
    fam_t = tfam.CholeskyGaussian(d)
    p = {k: (0.3 * rng.standard_normal((J,) + s)).astype(np.float32)
         for k, s in fam_t.param_shapes().items()}
    return p


@pytest.mark.parametrize("d", [1, 3, 5])
@pytest.mark.parametrize("backend", ["plain", "fused", "fused+trimmed"])
def test_full_family_barycenter_matches_reference(d, backend):
    rng = np.random.default_rng(50 + d)
    J = 3
    p = _stacked_cholesky(rng, J, d)
    w = np.asarray([1.0, 0.0, 1.0] if backend == "fused+trimmed" else [1.0, 1.0, 1.0],
                   np.float32)
    jaggr = jagg.TrimmedMeanAggregator(0.34) if backend == "fused+trimmed" else None
    want = jb.family_barycenter(jfam.CholeskyGaussian(d),
                                {k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(w), jaggr)
    taggr = {"plain": None, "fused": FusedReduction(),
             "fused+trimmed": FusedReduction(0.34)}[backend]
    sqrtm = tb.sqrtm_newton_schulz if backend == "plain" else twire.sqrtm_newton_schulz_fused
    got = tb.family_barycenter(tfam.CholeskyGaussian(d),
                               {k: torch.as_tensor(v) for k, v in p.items()},
                               torch.as_tensor(w), taggr, sqrtm=sqrtm)
    for k in want:
        _close(got[k], want[k])


def test_lowrank_family_barycenter_matches_reference_covariance():
    rng = np.random.default_rng(9)
    J, d, r = 3, 4, 2
    jf, tf = jfam.LowRankGaussian(d, r), tfam.LowRankGaussian(d, r)
    p = {k: (0.4 * rng.standard_normal((J,) + s)).astype(np.float32)
         for k, s in tf.param_shapes().items()}
    w = np.ones(J, np.float32)
    want = jb.family_barycenter(jf, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(w),
                                jagg.MeanAggregator())
    got = tb.family_barycenter(tf, {k: torch.as_tensor(v) for k, v in p.items()},
                               torch.as_tensor(w), tagg.MeanAggregator())
    _close(got["mu"], want["mu"])
    _close(tf.covariance(got), jf.covariance(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend", ["plain", "fused"])
def test_family_barycenter_forwards_40_sqrtm_iterations(backend, monkeypatch):
    """``sqrtm_iters`` (40), not the backend's default of 25, reaches the
    square root: one merge is 50 fixed-point steps × (1 + 1 batched) roots
    × 40 Newton–Schulz steps."""
    calls = []
    if backend == "fused":
        step = twire.newton_schulz_step

        def counting(y, z):
            calls.append(y.shape)
            return step(y, z)

        monkeypatch.setattr(twire, "newton_schulz_step", counting)
        sqrtm = twire.sqrtm_newton_schulz_fused
    else:
        def sqrtm(mat, num_iters=25):
            calls.extend([mat.shape] * num_iters)
            return tb.sqrtm_newton_schulz(mat, num_iters=num_iters)

    rng = np.random.default_rng(4)
    p = {k: torch.as_tensor(v) for k, v in _stacked_cholesky(rng, 3, 5).items()}
    tb.family_barycenter(tfam.CholeskyGaussian(5), p, torch.ones(3), sqrtm=sqrtm)
    assert len(calls) == 50 * 2 * 40
    assert calls.count((1, 5, 5) if backend == "fused" else (5, 5)) == 50 * 40
    assert calls.count((3, 5, 5)) == 50 * 40


def test_family_barycenter_refuses_families_without_moments():
    fam = tfam.ConditionalGaussian(2, 1)
    with pytest.raises(ValueError, match="eta_mode='param'"):
        tb.family_barycenter(fam, {}, torch.ones(2))
