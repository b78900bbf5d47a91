"""The port's plain wire stages against the reference: aggregation,
compression and byte metering, the DP policy (injected noise), the
accountant, the diag barycenter and the scheduler's rules.

Inputs from a numpy seed. Tolerance: rtol 1e-6, atol 1e-6 for float32
arithmetic (sums reduce in another order); byte counts, codes, invite
counts and ε (float64 numpy on both sides, within 1e-6) are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.barycenter import family_barycenter as j_bary
from repro.core.families import DiagGaussian as JDiag
from repro.federated import aggregation as jagg
from repro.federated.privacy import PrivacyPolicy as JPolicy
from repro.federated.privacy import RdpAccountant as JAccountant
from repro_torch.core.barycenter import family_barycenter as t_bary
from repro_torch.core.families import DiagGaussian as TDiag
from repro_torch.federated import aggregation as tagg
from repro_torch.federated.metering import CommMeter, tree_bytes
from repro_torch.federated.privacy import PrivacyPolicy as TPolicy
from repro_torch.federated.privacy import RdpAccountant as TAccountant
from repro_torch.federated.scheduler import RoundScheduler

RTOL, ATOL = 1e-6, 1e-6


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


def _stack(rng, J=5):
    x = {"a": rng.standard_normal((J, 4, 3)).astype(np.float32),
         "b": rng.standard_normal((J, 6)).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.as_tensor(v) for k, v in x.items()})


@pytest.mark.parametrize("weights", [[1, 0, 1, 1, 0], [0.3, 0.1, 0, 0.2, 0.05],
                                     [0, 0, 0, 0, 0], [1, 1, 1, 1, 1]])
@pytest.mark.parametrize("agg", ["mean", "trimmed"])
def test_aggregators_match_reference(weights, agg):
    rng = np.random.default_rng(0)
    jx, tx = _stack(rng)
    w = np.asarray(weights, np.float32)
    ja = jagg.MeanAggregator() if agg == "mean" else jagg.TrimmedMeanAggregator(0.34)
    ta = tagg.MeanAggregator() if agg == "mean" else tagg.TrimmedMeanAggregator(0.34)
    assert ta.fused_reduction == ja.fused_reduction
    jout, tout = ja.combine(jx, jnp.asarray(w)), ta.combine(tx, torch.as_tensor(w))
    for k in jout:
        _close(tout[k], jout[k])


def test_int8_compressor_and_wire_bytes_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(37).astype(np.float32)
    jenc = jagg.Int8Compressor().encode(jnp.asarray(x))
    tenc = tagg.Int8Compressor().encode(torch.as_tensor(x))
    np.testing.assert_array_equal(tenc["leaves"][0]["q"].numpy(),
                                  np.asarray(jenc["leaves"][0]["q"]))
    _close(tenc["leaves"][0]["scale"], jenc["leaves"][0]["scale"])
    _close(tagg.Int8Compressor().decode(tenc), jagg.Int8Compressor().decode(jenc))
    tree = {"theta": {"w": np.zeros((3, 2), np.float32)},
            "eta_G": {"mu": np.zeros(5, np.float32), "log_sigma": np.zeros(5, np.float32)}}
    ttree = jax.tree_util.tree_map(torch.as_tensor, tree)
    for wire in ("flat", "fused", "legacy"):
        for jc, tc in ((jagg.NoCompression(), tagg.NoCompression()),
                       (jagg.Int8Compressor(), tagg.Int8Compressor())):
            assert tc.wire_bytes(ttree, wire=wire) == jc.wire_bytes(tree, wire=wire)
            assert tc.wire_codec == jc.wire_codec
    with pytest.raises(ValueError, match="wire layout"):
        tagg.NoCompression().wire_bytes(ttree, wire="ring")
    assert tree_bytes(ttree) == 4 * 16
    meter = CommMeter()
    meter.record(10, 4)
    meter.record(6, 4)
    assert (meter.total, meter.per_round) == (24, 12.0)


@pytest.mark.parametrize("use_ref", [False, True])
@pytest.mark.parametrize("clip", [0.05, 100.0])
def test_privacy_policy_matches_reference_on_injected_noise(use_ref, clip):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(50).astype(np.float32)
    ref = (0.2 * rng.standard_normal(50)).astype(np.float32) if use_ref else None
    jpol, tpol = JPolicy(clip, 0.7), TPolicy(clip, 0.7)
    key = jax.random.PRNGKey(3)
    want = jpol.privatize(jnp.asarray(x), key,
                          reference=None if ref is None else jnp.asarray(ref))
    draw = np.array(jax.random.normal(jax.random.fold_in(key, 0), (50,), jnp.float32))
    got = tpol.privatize(torch.as_tensor(x), torch.as_tensor(draw),
                         reference=None if ref is None else torch.as_tensor(ref))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        TPolicy(clip_norm=0.0)


@pytest.mark.parametrize("q,z,steps", [(1.0, 1.1, 3), (0.67, 0.3, 2), (0.1, 2.0, 50)])
def test_accountant_matches_reference(q, z, steps):
    ja, ta = JAccountant(), TAccountant()
    for _ in range(steps):
        ja.step(noise_multiplier=z, sampling_rate=q)
        ta.step(noise_multiplier=z, sampling_rate=q)
    je, jo = ja.epsilon(1e-5)
    te, to = ta.epsilon(1e-5)
    assert te == pytest.approx(je, abs=1e-6) and to == jo


@pytest.mark.parametrize("agg", [None, "mean", "trimmed"])
def test_diag_barycenter_matches_reference(agg):
    rng = np.random.default_rng(4)
    J, d = 4, 9
    mu = rng.standard_normal((J, d)).astype(np.float32)
    ls = (-1.0 + 0.3 * rng.standard_normal((J, d))).astype(np.float32)
    w = np.asarray([1, 0, 1, 1], np.float32)
    jaggr = {None: None, "mean": jagg.MeanAggregator(),
             "trimmed": jagg.TrimmedMeanAggregator(0.34)}[agg]
    taggr = {None: None, "mean": tagg.MeanAggregator(),
             "trimmed": tagg.TrimmedMeanAggregator(0.34)}[agg]
    want = j_bary(JDiag(d), {"mu": jnp.asarray(mu), "log_sigma": jnp.asarray(ls)},
                  jnp.asarray(w), jaggr)
    got = t_bary(TDiag(d), {"mu": torch.as_tensor(mu), "log_sigma": torch.as_tensor(ls)},
                 torch.as_tensor(w), taggr)
    for k in ("mu", "log_sigma"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-6)


def test_scheduler_rules():
    # int(p*J + 0.5) invitations: J=5, p=0.5 invites 3 (not banker's 2).
    s = RoundScheduler(5, participation=0.5, seed=3)
    for r in range(20):
        assert int(s.invited(r).sum()) == 3
        assert np.array_equal(s.mask(r), s.invited(r))  # no dropout
        assert np.array_equal(s.mask(r), RoundScheduler(5, 0.5, seed=3).mask(r))
    # Stragglers never empty a round: the lowest-index invited silo stays.
    s = RoundScheduler(6, participation=0.5, dropout=1.0, seed=1)
    for r in range(20):
        m, inv = s.mask(r), s.invited(r)
        assert m.sum() == 1 and int(np.argmax(m)) == int(np.argmax(inv))
    full = RoundScheduler(4)
    assert np.array_equal(full.mask(7), np.ones(4, np.float32))
