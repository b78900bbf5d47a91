"""The port's structured families against the JAX package.

``CholeskyGaussian``, ``LowRankGaussian``, ``BatchedDiagGaussian`` and
``ConditionalGaussian(use_chol=True)``: sample, log_prob, entropy,
covariance and the moment bridge, plus ``vmap(grad)`` of log_prob, on the
same numpy inputs through ``repro`` and ``repro_torch``; and the family
registry / ``FamilySpec`` / ``build_family``.

Tolerance: rtol 1e-5 (atol 1e-6 for entries near zero). Both sides
compute float32; triangular solves, Cholesky factors and eigh differ in
their summation order between LAPACK builds, which costs a few ulps more
than the elementwise families' 1e-6. ``LowRankGaussian.from_moments``
runs eigh 200 times and eigenvector signs are not unique, so U U^T and
log_sigma are compared, not U.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.core import families as jfam
from repro.core import family as jfamily
from repro_torch.core import families as tfam
from repro_torch.core import family as tfamily

RTOL, ATOL = 1e-5, 1e-6


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _params(shapes, rng, lead=()):
    out = {}
    for k, shape in shapes.items():
        scale = 0.5 if k == "log_sigma" else 0.3
        out[k] = (scale * rng.standard_normal(lead + tuple(shape))).astype(np.float32)
    return out


def _both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.as_tensor(v) for k, v in params.items()})


def test_tril_order_matches_reference():
    """``torch.tril_indices(d, d, -1)`` is ``jnp.tril_indices(d, k=-1)``: same
    row-major order, so ``L_packed`` has one layout in both packages."""
    for d in (1, 2, 5, 9):
        rows, cols = tfam._tril_indices(d)
        jr, jc = jnp.tril_indices(d, k=-1)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(cols.numpy(), np.asarray(jc))
        packed = np.arange(d * (d - 1) // 2, dtype=np.float32) + 1.0
        np.testing.assert_array_equal(
            tfam._unpack_unitriangular(torch.as_tensor(packed), d).numpy(),
            np.asarray(jfam._unpack_unitriangular(jnp.asarray(packed), d)))


def _unconditional(name):
    return {
        "cholesky_d1": (jfam.CholeskyGaussian(1), tfam.CholeskyGaussian(1)),
        "cholesky_d6": (jfam.CholeskyGaussian(6), tfam.CholeskyGaussian(6)),
        "lowrank_r1": (jfam.LowRankGaussian(6, 1), tfam.LowRankGaussian(6, 1)),
        "lowrank_r3": (jfam.LowRankGaussian(6, 3), tfam.LowRankGaussian(6, 3)),
        "batched_diag": (jfam.BatchedDiagGaussian(3, 4), tfam.BatchedDiagGaussian(3, 4)),
    }[name]


@pytest.mark.parametrize("name", ["cholesky_d1", "cholesky_d6", "lowrank_r1",
                                  "lowrank_r3", "batched_diag"])
def test_family_densities_match_reference(name):
    jf, tf = _unconditional(name)
    assert tf.param_shapes() == jf.param_shapes()
    assert tf.eps_shape == jf.eps_shape and tf.num_params == jf.num_params
    assert (tf.has_moments, tf.moment_form) == (jf.has_moments, jf.moment_form)
    rng = np.random.default_rng(sum(map(ord, name)))
    jp, tp = _both(_params(tf.param_shapes(), rng))
    eps = rng.standard_normal(tf.eps_shape).astype(np.float32)
    z_j = jf.sample(jp, jnp.asarray(eps))
    z_t = tf.sample(tp, torch.as_tensor(eps))
    _close(z_t, z_j)
    _close(tf.log_prob(tp, z_t), jf.log_prob(jp, z_j))
    _close(tf.entropy(tp), jf.entropy(jp))
    for a, b in zip(tf.to_moments(tp), jf.to_moments(jp), strict=True):
        _close(a, b)
    if name.startswith(("cholesky", "lowrank")):
        _close(tf.covariance(tp), jf.covariance(jp))
    _close(tf.pack(tp), jf.pack(jp))


@pytest.mark.parametrize("name", ["cholesky_d6", "lowrank_r3", "batched_diag"])
def test_vmap_grad_log_prob_matches_reference(name):
    """The per-silo gradient the round takes: ``vmap(grad(log_prob))``."""
    jf, tf = _unconditional(name)
    rng = np.random.default_rng(7)
    J = 3
    params = _params(tf.param_shapes(), rng, lead=(J,))
    z = (rng.standard_normal((J,) + tuple(tf.eps_shape[:1] if name.startswith("lowrank")
                                          else tf.eps_shape))).astype(np.float32)
    if name.startswith("lowrank"):
        z = z[:, : tf.dim]
    jp, tp = _both(params)
    jg = jax.vmap(jax.grad(jf.log_prob))(jp, jnp.asarray(z))
    tg = vmap(grad(tf.log_prob))(tp, torch.as_tensor(z))
    for k in jg:
        _close(tg[k], jg[k])


@pytest.mark.parametrize("d", [1, 2, 6])
def test_cholesky_moment_bridge_matches_reference(d):
    rng = np.random.default_rng(10 + d)
    jf, tf = jfam.CholeskyGaussian(d), tfam.CholeskyGaussian(d)
    jp, tp = _both(_params(tf.param_shapes(), rng))
    mu, cov = tf.to_moments(tp)
    back = tf.from_moments(mu, cov)
    want = jf.from_moments(*jf.to_moments(jp))
    for k in want:
        _close(back[k], want[k])
        _close(back[k], tp[k], rtol=1e-4, atol=1e-5)  # a round trip


def test_lowrank_from_moments_matches_reference_up_to_signs():
    rng = np.random.default_rng(3)
    d, r = 5, 2
    jf, tf = jfam.LowRankGaussian(d, r), tfam.LowRankGaussian(d, r)
    jp, tp = _both(_params(tf.param_shapes(), rng))
    tp["U"] = tp["U"] * 3.0
    jp["U"] = jp["U"] * 3.0
    _, cov = tf.to_moments(tp)
    got = tf.from_moments(tp["mu"], cov)
    want = jf.from_moments(jp["mu"], jnp.asarray(cov.numpy()))
    _close(got["log_sigma"], want["log_sigma"], rtol=1e-4, atol=1e-5)
    _close(got["U"] @ got["U"].T, np.asarray(want["U"] @ want["U"].T), rtol=1e-4, atol=1e-5)
    _close(tf.covariance(got), jf.covariance(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family", ["cholesky", "lowrank"])
def test_from_moments_of_non_pd_matrix_returns_nan(family):
    """``jnp.linalg.cholesky`` returns NaN for a matrix that is not PD;
    ``torch.linalg.cholesky`` would raise mid-round. The port fills NaN."""
    cov = torch.tensor([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    mu = torch.zeros(3)
    if family == "cholesky":
        out = tfam.CholeskyGaussian(3).from_moments(mu, cov)
        ref = jfam.CholeskyGaussian(3).from_moments(jnp.zeros(3), jnp.asarray(cov.numpy()))
        assert bool(torch.isnan(out["log_sigma"]).any())
        assert bool(jnp.isnan(ref["log_sigma"]).any())
        assert torch.isnan(out["L_packed"]).all()
    else:
        out = tfam.LowRankGaussian(3, 1).from_moments(mu, cov, num_iters=5)
        assert out["U"].shape == (3, 1)  # projected, never raised


@pytest.mark.parametrize("use_coupling", [False, True])
def test_conditional_chol_matches_reference(use_coupling):
    rng = np.random.default_rng(20 + use_coupling)
    d, dg = 6, 3
    jf = jfam.ConditionalGaussian(d, dg, use_coupling=use_coupling, use_chol=True)
    tf = tfam.ConditionalGaussian(d, dg, use_coupling=use_coupling, use_chol=True)
    assert tf.param_shapes() == jf.param_shapes()
    J = 3
    params = _params(tf.param_shapes(), rng, lead=(J,))
    z_G = rng.standard_normal(dg).astype(np.float32)
    mu_G = rng.standard_normal(dg).astype(np.float32)
    eps = rng.standard_normal((J, d)).astype(np.float32)
    jp, tp = _both(params)
    one_j = {k: v[0] for k, v in jp.items()}
    one_t = {k: v[0] for k, v in tp.items()}
    zg_j, mg_j, zg_t, mg_t = (jnp.asarray(z_G), jnp.asarray(mu_G), torch.as_tensor(z_G),
                              torch.as_tensor(mu_G))
    z_j = jf.sample(one_j, zg_j, mg_j, jnp.asarray(eps[0]))
    z_t = tf.sample(one_t, zg_t, mg_t, torch.as_tensor(eps[0]))
    _close(z_t, z_j)
    _close(tf.log_prob(one_t, z_t, zg_t, mg_t), jf.log_prob(one_j, z_j, zg_j, mg_j))
    _close(tf.entropy(one_t), jf.entropy(one_j))
    # vmap(grad) over the silo axis, as the round takes it
    z_all = np.array(jax.vmap(lambda p, e: jf.sample(p, zg_j, mg_j, e))(jp, jnp.asarray(eps)))
    jg = jax.vmap(jax.grad(jf.log_prob), in_axes=(0, 0, None, None))(
        jp, jnp.asarray(z_all), zg_j, mg_j)
    tg = vmap(grad(tf.log_prob), in_dims=(0, 0, None, None))(
        tp, torch.as_tensor(z_all), zg_t, mg_t)
    for k in jg:
        _close(tg[k], jg[k])


def test_family_registry_and_spec_match_reference():
    assert tfamily.family_names() == jfamily.family_names()
    for name in tfamily.family_names():
        assert tfamily.get_family(name).__name__ == jfamily.get_family(name).__name__
    with pytest.raises(KeyError, match="registered families"):
        tfamily.get_family("nope")
    spec = tfamily.FamilySpec.from_dict({"name": "lowrank", "kwargs": {"rank": 2}})
    assert tfamily.FamilySpec.from_dict(spec.to_dict()) == spec
    fam = tfamily.build_family(spec, dim=5)
    assert fam == tfam.LowRankGaussian(5, 2)
    cond = tfamily.build_family(tfamily.FamilySpec("conditional", {"use_chol": True}),
                                dim=4, global_dim=5)
    assert cond == tfam.ConditionalGaussian(4, 5, use_chol=True)
    with pytest.raises(ValueError, match="explicit kwargs"):
        tfamily.build_family(tfamily.FamilySpec("batched_diag"), dim=3)
