"""The port's wire kernels (CPU route: their plain versions) against the
reference's Pallas kernels run in interpret mode.

Inputs from a numpy seed. The reference draws DP noise in-kernel from
per-row threefry keys; the test draws the same matrix with
``vmap(normal)(keys)`` and hands it to the port. Tolerances:

  * float outputs: rtol 1e-5, atol 1e-6 (the row norm and the column
    sums reduce in another order);
  * int8 outputs: scales within rtol 1e-6, codes equal except ±1 at no
    more than 0.1 % of entries (a value on a rounding boundary can land
    on either side after a 1-ulp difference in the scale or the clip).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import wire as jwire
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wire as twire

RTOL, ATOL = 1e-5, 1e-6
SHAPES = [(1, 5), (3, 64), (7, 129)]

# The reference kernels under jit: cases that differ only in the mask or
# weight values share one interpret-mode compile.
J_UPLOAD = jax.jit(jwire.fused_upload, static_argnames=(
    "clip_norm", "noise_multiplier", "quantize", "block_rows", "interpret"))
J_COMBINE = jax.jit(jwire.fused_combine,
                    static_argnames=("trim_frac", "block_cols", "interpret"))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


def _int8_close(q_t, s_t, q_j, s_j):
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)
    diff = np.abs(q_t.numpy().astype(np.int32) - np.asarray(q_j).astype(np.int32))
    assert diff.max(initial=0) <= 1
    assert np.count_nonzero(diff) <= max(1, diff.size // 1000)


def _mask(J, pattern, rng):
    if pattern == "all":
        return np.ones(J, np.float32)
    m = (rng.random(J) < 0.6).astype(np.float32)
    m[0] = 1.0
    if J > 1:
        m[-1] = 0.0
    return m


UPLOAD_CONFIGS = [
    # (clip_norm, noise_multiplier, quantize, use_reference)
    (None, 0.0, False, False),
    (None, 0.0, True, False),
    (None, 0.0, False, True),
    (0.5, 0.0, False, False),
    (0.5, 1.1, False, False),
    (0.5, 1.1, False, True),
    (0.5, 1.1, True, True),
    (2.0, 0.0, True, True),
    (1e4, 0.0, False, True),  # norm below C: factor 1
]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cfg", UPLOAD_CONFIGS, ids=lambda c: "clip{}_z{}_q{}_ref{}".format(*c))
@pytest.mark.parametrize("pattern", ["all", "partial"])
def test_fused_upload_matches_reference(shape, cfg, pattern):
    clip, z, quant, use_ref = cfg
    J, P = shape
    rng = np.random.default_rng(zlib.crc32(repr((shape, cfg, pattern)).encode()))
    x = rng.standard_normal((J, P)).astype(np.float32)
    mask = _mask(J, pattern, rng)
    reference = (0.3 * rng.standard_normal(P)).astype(np.float32) if use_ref else None
    keys = jax.vmap(lambda j: jax.random.fold_in(jax.random.PRNGKey(7), j))(jnp.arange(J))
    noise = np.array(jax.vmap(lambda k: jax.random.normal(k, (P,), jnp.float32))(keys))
    want = J_UPLOAD(
        jnp.asarray(x), mask=jnp.asarray(mask), keys=keys if z > 0 else None,
        reference=None if reference is None else jnp.asarray(reference),
        clip_norm=clip, noise_multiplier=z, quantize=quant, interpret=True)
    got = twire.fused_upload(
        torch.as_tensor(x), mask=torch.as_tensor(mask),
        noise=torch.as_tensor(noise) if z > 0 else None,
        reference=None if reference is None else torch.as_tensor(reference),
        clip_norm=clip, noise_multiplier=z, quantize=quant)
    if quant:
        _int8_close(got[0], got[1], want[0], want[1])
        assert got[0].dtype == torch.int8 and got[1].shape == (J,)
    else:
        _close(got, want)
    assert twire.LAUNCHES == {"fused_upload": 0, "fused_combine": 0,  # CPU: no launch
                              "newton_schulz_step": 0, "sqrtm_newton_schulz": 0}


def test_fused_upload_inactive_zero_row_quantizes_to_zero():
    x = torch.ones((2, 4))
    q, s = twire.fused_upload(x, mask=torch.tensor([1.0, 0.0]), quantize=True)
    assert q[1].abs().sum() == 0 and float(s[1]) == pytest.approx(1e-12)


def test_fused_upload_rounds_half_to_even():
    """Codes on exact .5 boundaries follow jnp.round (half to even)."""
    row = np.asarray([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5]], np.float32)
    want_q, want_s = jwire.fused_upload(jnp.asarray(row), mask=jnp.ones(1), quantize=True,
                                        interpret=True)
    q, s = twire.fused_upload(torch.as_tensor(row), mask=torch.ones(1), quantize=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(q.numpy()[0], [127, 0, 2, 2, 0, -2, 4, -126])
    _close(s, want_s)


def test_fused_upload_argument_checks():
    x = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="requires clip_norm"):
        twire.fused_upload(x, mask=torch.ones(2), noise_multiplier=1.0)
    with pytest.raises(ValueError, match="noise draw"):
        twire.fused_upload(x, mask=torch.ones(2), clip_norm=1.0, noise_multiplier=1.0)
    with pytest.raises(ValueError, match="scales given"):
        twire.fused_combine(x, torch.ones(2), scales=torch.ones(2))


def _weights(J, kind, rng):
    if kind == "ones":
        return np.ones(J, np.float32)
    if kind == "partial":
        return _mask(J, "partial", rng)
    if kind == "frac_below_1":
        return (rng.random(J) * 0.9 / J).astype(np.float32)
    if kind == "zeros":
        return np.zeros(J, np.float32)
    w = np.zeros(J, np.float32)  # "n1", "n2": one or two active rows
    w[: int(kind[1])] = 1.0
    return w


COMBINE_CASES = [
    # (trim_frac, weights, ties, int8)
    (None, "ones", False, False),
    (None, "partial", False, False),
    (None, "frac_below_1", False, False),
    (None, "zeros", False, False),
    (None, "partial", False, True),
    (0.34, "partial", False, False),
    (0.2, "ones", True, False),
    (0.34, "zeros", False, False),
    (0.34, "n1", False, False),
    (0.34, "n2", False, False),
    (0.1, "partial", False, True),
    (0.34, "ones", True, True),
    (0.5, "n2", False, False),  # floor(tf*n) = 1 > floor((n-1)/2) = 0
    (0.5, "ones", False, False),
]


@pytest.mark.parametrize("shape", [(3, 64), (7, 129), (12, 33)])
@pytest.mark.parametrize("case", COMBINE_CASES, ids=lambda c: "tf{}_{}_ties{}_i8{}".format(*c))
def test_fused_combine_matches_reference(shape, case):
    tf, wkind, ties, int8 = case
    J, P = shape
    rng = np.random.default_rng(zlib.crc32(repr((shape, case)).encode()))
    w = _weights(J, wkind, rng)
    if int8:
        x = rng.integers(-127, 128, (J, P)).astype(np.int8)
        if ties:
            x = (x // 64).astype(np.int8)
        scales = (rng.random(J) * 0.05 + 1e-3).astype(np.float32)
    else:
        x = rng.standard_normal((J, P)).astype(np.float32)
        if ties:
            x = np.round(2 * x) / 2
        scales = None
    want = J_COMBINE(
        jnp.asarray(x), jnp.asarray(w),
        scales=None if scales is None else jnp.asarray(scales),
        trim_frac=tf, interpret=True)
    got = twire.fused_combine(
        torch.as_tensor(x), torch.as_tensor(w),
        scales=None if scales is None else torch.as_tensor(scales), trim_frac=tf)
    assert got.shape == (P,) and got.dtype == torch.float32
    _close(got, want)


def test_int8_dequant_ref_matches_reference():
    from repro.kernels import ref as jref

    rng = np.random.default_rng(9)
    q = rng.integers(-127, 128, (4, 10)).astype(np.int8)
    s = rng.random(4).astype(np.float32)
    _close(tref.int8_rows_dequant_ref(torch.as_tensor(q), torch.as_tensor(s)),
           jref.int8_rows_dequant_ref(jnp.asarray(q), jnp.asarray(s)))
