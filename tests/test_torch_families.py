"""Port families, wire packing and optimizers against the JAX reference.

Same inputs (numpy, from a seed) through ``repro`` and ``repro_torch``;
both run float32 on the CPU. Tolerance: rtol 1e-6 (plus atol 1e-6 for
entries near zero) — the two sides compute the same float32 expressions,
and only summation order and libm differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import families as jfam
from repro.core.flatten import TreeSpec as JTreeSpec
from repro.optim.adam import adam as j_adam
from repro.optim.base import apply_updates as j_apply
from repro_torch.core import families as tfam
from repro_torch.core.flatten import TreeSpec as TTreeSpec
from repro_torch.optim.adam import adam as t_adam
from repro_torch.optim.base import apply_updates as t_apply
from repro_torch.tree import tree_leaves

RTOL, ATOL = 1e-6, 1e-6


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _params(family_shapes, rng):
    out = {}
    for k, shape in family_shapes.items():
        scale = 0.3 if k != "log_sigma" else 0.5
        out[k] = (scale * rng.standard_normal(shape)).astype(np.float32)
    return out


def _both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.as_tensor(v) for k, v in params.items()})


def test_diag_gaussian_matches_reference():
    rng = np.random.default_rng(0)
    d = 7
    jf, tf = jfam.DiagGaussian(d), tfam.DiagGaussian(d)
    assert jf.param_shapes() == tf.param_shapes()
    jp, tp = _both(_params(tf.param_shapes(), rng))
    eps = rng.standard_normal(d).astype(np.float32)
    z_j = jf.sample(jp, jnp.asarray(eps))
    z_t = tf.sample(tp, torch.as_tensor(eps))
    _close(z_t, z_j)
    _close(tf.log_prob(tp, z_t), jf.log_prob(jp, z_j))
    _close(tf.entropy(tp), jf.entropy(jp))
    for a, b in zip(tf.to_moments(tp), jf.to_moments(jp), strict=True):
        _close(a, b)
    mu, sigma = tf.to_moments(tp)
    back = tf.from_moments(mu, sigma)
    _close(back["log_sigma"], tp["log_sigma"])
    _close(tf.pack(tp), jf.pack(jp))


@pytest.mark.parametrize("use_coupling", [False, True])
def test_conditional_gaussian_matches_reference(use_coupling):
    rng = np.random.default_rng(1 + use_coupling)
    d, dg = 5, 4
    jf = jfam.ConditionalGaussian(d, dg, use_coupling=use_coupling)
    tf = tfam.ConditionalGaussian(d, dg, use_coupling=use_coupling)
    assert jf.param_shapes() == tf.param_shapes()
    jp, tp = _both(_params(tf.param_shapes(), rng))
    z_G = rng.standard_normal(dg).astype(np.float32)
    mu_G = rng.standard_normal(dg).astype(np.float32)
    eps = rng.standard_normal(d).astype(np.float32)
    z_j = jf.sample(jp, jnp.asarray(z_G), jnp.asarray(mu_G), jnp.asarray(eps))
    z_t = tf.sample(tp, torch.as_tensor(z_G), torch.as_tensor(mu_G), torch.as_tensor(eps))
    _close(z_t, z_j)
    _close(tf.log_prob(tp, z_t, torch.as_tensor(z_G), torch.as_tensor(mu_G)),
           jf.log_prob(jp, z_j, jnp.asarray(z_G), jnp.asarray(mu_G)))
    _close(tf.entropy(tp), jf.entropy(jp))
    _close(tf.mean(tp), jf.mean(jp))


def test_conditional_gaussian_chol_is_not_ported():
    """Named in the first slice, where ``use_chol=True`` raised. It is ported
    now: the family builds and carries the reference's unitriangular block
    (densities: ``test_torch_families_full.py``)."""
    fam = tfam.ConditionalGaussian(3, 2, use_chol=True)
    assert fam.param_shapes() == jfam.ConditionalGaussian(3, 2, use_chol=True).param_shapes()
    p = fam.init(torch.Generator())
    assert p["L_packed"].shape == (3,) and p["L_packed"].dtype == torch.float32


def test_treespec_pack_column_order_matches_reference():
    rng = np.random.default_rng(2)
    tree = {
        "theta": {"b": rng.standard_normal((2, 3)), "a": rng.standard_normal(4)},
        "eta_G": {"mu": rng.standard_normal(5), "log_sigma": rng.standard_normal(5)},
        "g": rng.standard_normal(()),
    }
    tree = {k: ({kk: vv.astype(np.float32) for kk, vv in v.items()}
                if isinstance(v, dict) else v.astype(np.float32))
            for k, v in tree.items()}
    jtree = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
                 else jnp.asarray(v)) for k, v in tree.items()}
    ttree = {k: ({kk: torch.as_tensor(vv) for kk, vv in v.items()} if isinstance(v, dict)
                 else torch.as_tensor(v)) for k, v in tree.items()}
    jspec, tspec = JTreeSpec.of(jtree), TTreeSpec.of(ttree)
    assert jspec.dim == tspec.dim == 2 * 3 + 4 + 5 + 5 + 1
    row_j = np.asarray(jspec.pack(jtree))
    row_t = tspec.pack(ttree).numpy()
    np.testing.assert_array_equal(row_t, row_j)
    back = tspec.unpack(torch.as_tensor(row_j.copy()))
    for a, b in zip(tree_leaves(back), tree_leaves(ttree), strict=True):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # Stacked rows: (J, ...) leaves pack to the (J, P) wire matrix.
    stacked = {"eta_G": {k: torch.stack([v, 2 * v]) for k, v in ttree["eta_G"].items()}}
    mat = TTreeSpec.of(ttree_eta := {"eta_G": ttree["eta_G"]}).pack(stacked, batch_ndim=1)
    assert mat.shape == (2, 10)
    np.testing.assert_array_equal(mat[1].numpy(), 2 * TTreeSpec.of(ttree_eta).pack(
        ttree_eta).numpy())


@pytest.mark.parametrize("maximize", [False, True])
def test_adam_update_sequence_matches_reference(maximize):
    rng = np.random.default_rng(3)
    params = {"mu": rng.standard_normal(6).astype(np.float32),
              "w": {"a": rng.standard_normal((2, 3)).astype(np.float32)}}
    grads = [{"mu": rng.standard_normal(6).astype(np.float32),
              "w": {"a": rng.standard_normal((2, 3)).astype(np.float32)}}
             for _ in range(5)]
    jopt, topt = j_adam(2e-2, maximize=maximize), t_adam(2e-2, maximize=maximize)
    jp = {"mu": jnp.asarray(params["mu"]), "w": {"a": jnp.asarray(params["w"]["a"])}}
    tp = {"mu": torch.as_tensor(params["mu"]), "w": {"a": torch.as_tensor(params["w"]["a"])}}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jg = {"mu": jnp.asarray(g["mu"]), "w": {"a": jnp.asarray(g["w"]["a"])}}
        tg = {"mu": torch.as_tensor(g["mu"]), "w": {"a": torch.as_tensor(g["w"]["a"])}}
        ju, js = jopt.update(jg, js, jp)
        tu, ts = topt.update(tg, ts, tp)
        jp, tp = j_apply(jp, ju), t_apply(tp, tu)
        for a, b in zip(tree_leaves(tu), jax_leaves(ju), strict=True):
            _close(a, b)
    for a, b in zip(tree_leaves(tp), jax_leaves(jp), strict=True):
        _close(a, b)
    # Same state layout: (ScaleByAdamState(count, mu, nu), ()), count int32.
    assert type(ts[0]).__name__ == type(js[0]).__name__ == "ScaleByAdamState"
    assert ts[1] == () and js[1] == ()
    assert int(ts[0].count) == int(js[0].count) == 5
    assert ts[0].count.dtype == torch.int32
    for a, b in zip(tree_leaves(ts), jax_leaves(js), strict=True):
        _close(a, b)


def jax_leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _optimizer(lib, name):
    """The same optimizer from ``repro.optim`` or ``repro_torch.optim``."""
    return {
        "sgd": lambda: lib.sgd(5e-2),
        "sgd_max": lambda: lib.sgd(5e-2, maximize=True),
        "momentum": lambda: lib.momentum(5e-2, beta=0.8),
        "adamw": lambda: lib.adamw(2e-2, weight_decay=0.1),
        "clip_then_adam": lambda: lib.chain(lib.clip_by_global_norm(0.5),
                                            lib.adam(2e-2)),
    }[name]()


@pytest.mark.parametrize("name", ["sgd", "sgd_max", "momentum", "adamw", "clip_then_adam"])
def test_optimizer_update_sequence_matches_reference(name):
    import repro.optim as joptim
    import repro_torch.optim as toptim

    rng = np.random.default_rng(4)
    params = {"mu": rng.standard_normal(6).astype(np.float32),
              "w": rng.standard_normal((2, 3)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    jopt, topt = _optimizer(joptim, name), _optimizer(toptim, name)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = topt.update({k: torch.as_tensor(v) for k, v in g.items()}, ts, tp)
        jp, tp = j_apply(jp, ju), t_apply(tp, tu)
    for a, b in zip(tree_leaves(tp), jax_leaves(jp), strict=True):
        _close(a, b)
    # One state layout, so a reference state converts leaf by leaf.
    assert len(tree_leaves(ts)) == len(jax_leaves(js))
    for a, b in zip(tree_leaves(ts), jax_leaves(js), strict=True):
        _close(a, b)
