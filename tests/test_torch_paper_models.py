"""The paper's multinomial (S3.2), hetero_mn and ProdLDA (§4.2) models in the
port, against the JAX package.

* Partitions: ``iid_partition``, ``dirichlet_label_partition`` (several α,
  J and ``min_per_silo``, and its ``ValueError``) and ``pad_ragged_silos``
  are numpy copies, so one ``np.random.default_rng(seed)`` gives the
  reference's arrays bit for bit (exact equality).
* Builders: ``multinomial`` and ``hetero_mn`` given the reference's
  ``(x, y)`` splits, and ``prodlda`` given its counts, stage the reference
  bundle's silos and N_j exactly.
* Model pieces: ``umass_coherence`` equals the reference's exactly; the
  log prior and ``log_local`` of multinomial (with and without padded
  rows) and ProdLDA agree within rtol 1e-5 (float32 reassociation).

The federations' rounds against the reference ``Server`` are in
``test_torch_paper_servers.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import (
    dirichlet_label_partition as j_dirichlet,
    iid_partition as j_iid,
    pad_ragged_silos as j_pad,
)
from repro.models.paper.multinomial import build_multinomial as j_build_mn
from repro.models.paper.prodlda import build_prodlda as j_build_lda
from repro.models.paper.prodlda import umass_coherence as j_umass
from repro.models.paper.registry import get_model as j_get
from repro_torch.convert import datas_from_numpy
from repro_torch.data import (
    dirichlet_label_partition,
    iid_partition,
    make_lda_corpus,
    pad_ragged_silos,
)
from repro_torch.models.paper.multinomial import build_multinomial as t_build_mn
from repro_torch.models.paper.prodlda import build_prodlda as t_build_lda
from repro_torch.models.paper.prodlda import umass_coherence as t_umass
from repro_torch.models.paper.registry import get_model as t_get
from repro_torch.models.paper.registry import model_names

SEED = 0

# model -> (J, reference builder kwargs)
MODELS = {
    "multinomial": (3, dict(n_per=10, in_dim=16)),
    "hetero_mn": (3, dict(n_total=36, in_dim=16)),
    "prodlda": (2, dict(vocab_size=30, num_topics=4, docs_per_silo=6)),
}


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Partitions and data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,J,seed", [(10, 3, 0), (240, 4, 1), (7, 7, 2), (1000, 25, 3)])
def test_iid_partition_is_the_reference_bit_for_bit(n, J, seed):
    got = iid_partition(np.random.default_rng(seed), n, J)
    want = j_iid(np.random.default_rng(seed), n, J)
    assert len(got) == len(want) == J
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("alpha,J,min_per,seed", [
    (0.5, 4, 2, 0), (0.1, 3, 1, 1), (5.0, 5, 1, 2), (0.05, 6, 3, 3), (1.0, 2, 10, 4)])
def test_dirichlet_partition_is_the_reference_bit_for_bit(alpha, J, min_per, seed):
    labels = np.random.default_rng(100 + seed).integers(0, 10, size=120)
    got = dirichlet_label_partition(np.random.default_rng(seed), labels, J, alpha=alpha,
                                    min_per_silo=min_per)
    want = j_dirichlet(np.random.default_rng(seed), labels, J, alpha=alpha,
                       min_per_silo=min_per)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert min(len(a) for a in got) >= min_per
    assert np.array_equal(np.sort(np.concatenate(got)), np.arange(120))


def test_dirichlet_partition_raises_as_the_reference():
    labels = np.arange(6) % 3
    for fn in (dirichlet_label_partition, j_dirichlet):
        with pytest.raises(ValueError, match="cannot give every silo 3 samples"):
            fn(np.random.default_rng(0), labels, 4, alpha=0.5, min_per_silo=3)


def test_pad_ragged_silos_is_the_reference():
    rng = np.random.default_rng(5)
    datas = [{"x": rng.standard_normal((n, 3)).astype(np.float32),
              "y": rng.integers(0, 4, size=n)} for n in (5, 2, 7)]
    got, want = pad_ragged_silos(datas), j_pad(datas)
    for a, b in zip(got, want, strict=True):
        assert sorted(a) == sorted(b) == ["w", "x", "y"]
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert [float(d["w"].sum()) for d in got] == [5.0, 2.0, 7.0]
    with pytest.raises(ValueError, match="already has a 'w' key"):
        pad_ragged_silos(got)


def test_lda_corpus_shapes_and_lengths():
    counts, topics = make_lda_corpus(np.random.default_rng(0), num_docs=50, vocab_size=40,
                                     num_topics=5, doc_length_mean=30)
    assert counts.shape == (50, 40) and counts.dtype == np.int32
    assert topics.shape == (5, 40) and topics.dtype == np.float32
    assert counts.min() >= 0 and counts.sum(1).min() >= 10
    np.testing.assert_allclose(topics.sum(1), 1.0, rtol=1e-5)


def test_datas_from_numpy_converts_every_key():
    d = {"x": np.ones((2, 3), np.float64), "y": np.array([1, 2], np.int32),
         "w": np.array([1.0, 0.0], np.float32), "counts": np.array([[3, 0]], np.int32)}
    (out,) = datas_from_numpy([d], "cpu")
    assert sorted(out) == sorted(d)
    assert out["y"].dtype == torch.int64
    assert {out[k].dtype for k in ("x", "w", "counts")} == {torch.float32}
    assert out["counts"].tolist() == [[3.0, 0.0]]


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def _splits(jb):
    tr, te = jb.extras["train_all"], jb.extras["test"]
    return (_np(tr["x"]), _np(tr["y"])), (_np(te["x"]), _np(te["y"]))


def _port_bundle(name, jb, J, kwargs):
    if name == "prodlda":
        return t_get(name).build(SEED, J, device="cpu", counts=jb.extras["counts"], **kwargs)
    train, test = _splits(jb)
    return t_get(name).build(SEED, J, device="cpu", train=train, test=test, **kwargs)


def test_registry_has_the_paper_models_and_builds_on_cuda_by_default():
    assert {"multinomial", "hetero_mn", "prodlda"} <= set(model_names())
    if not torch.cuda.is_available():
        for name in ("multinomial", "hetero_mn", "prodlda"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                t_get(name).build(SEED, 2)


@pytest.mark.parametrize("name", list(MODELS))
def test_builder_stages_the_reference_silos(name):
    J, kwargs = MODELS[name]
    jb = j_get(name).build(SEED, J, **kwargs)
    tb = _port_bundle(name, jb, J, kwargs)
    assert tb.num_obs == list(jb.num_obs)
    assert len(tb.datas) == len(jb.datas) == J
    for td, jd in zip(tb.datas, jb.datas, strict=True):
        assert sorted(td) == sorted(jd)
        for k in td:
            want = _np(jd[k])
            assert td[k].shape == want.shape, k
            assert np.array_equal(td[k].numpy(), want.astype(td[k].numpy().dtype)), k
    assert {k: float(v) for k, v in tb.theta0.items()} == {
        k: float(v) for k, v in jb.theta0.items()}
    if name == "hetero_mn":
        assert len(set(tb.num_obs)) > 1  # unequal N_j
        for d, n in zip(tb.datas, tb.num_obs, strict=True):
            assert float(d["w"].sum()) == n


@pytest.mark.parametrize("name", list(MODELS))
def test_builder_draws_its_own_data(name):
    J, kwargs = MODELS[name]
    bundle = t_get(name).build(SEED, J, device="cpu", **kwargs)
    assert len(bundle.datas) == J and sum(bundle.num_obs) > 0
    assert all(torch.isfinite(leaf).all() for d in bundle.datas for leaf in d.values())


def test_builder_refuses_half_the_splits():
    with pytest.raises(ValueError, match="both train= and test="):
        t_get("multinomial").build(SEED, 2, device="cpu", in_dim=16,
                                   train=(np.zeros((4, 16), np.float32), np.zeros(4)))


# ---------------------------------------------------------------------------
# Model pieces
# ---------------------------------------------------------------------------


def test_umass_coherence_is_the_reference():
    rng = np.random.default_rng(3)
    counts = rng.poisson(0.4, size=(40, 25)).astype(np.int32)
    topics = rng.dirichlet(np.full(25, 0.3), size=6).astype(np.float32)
    for top_n in (5, 8):
        got, want = t_umass(topics, counts, top_n=top_n), j_umass(topics, counts, top_n=top_n)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _close(t, j, rtol=1e-5):
    np.testing.assert_allclose(float(t), float(j), rtol=rtol)


@pytest.mark.parametrize("padded", [False, True])
def test_multinomial_log_densities_match_reference(padded):
    rng = np.random.default_rng(7)
    in_dim, n = 16, 12
    jm, tm = j_build_mn(in_dim=in_dim), t_build_mn(in_dim=in_dim)
    z = rng.standard_normal(jm.spec.dim).astype(np.float32) * 0.3
    theta = {"log_sigma_w": np.float32(-0.4), "log_sigma_b": np.float32(0.2)}
    data = {"x": rng.standard_normal((n, in_dim)).astype(np.float32),
            "y": rng.integers(0, 10, size=n)}
    if padded:  # 7 real rows padded to 12 (w = 0 on the last 5)
        data = pad_ragged_silos([{k: v[:7] for k, v in data.items()}, data])[0]
    jth = {k: jnp.asarray(v) for k, v in theta.items()}
    tth = {k: torch.tensor(v) for k, v in theta.items()}
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    (td,) = datas_from_numpy([data], "cpu")
    zt = torch.as_tensor(z)
    _close(tm.problem.model.log_prior_global(tth, zt),
           jm.problem.model.log_prior_global(jth, jnp.asarray(z)))
    got = tm.problem.model.log_local(tth, zt, None, td)
    _close(got, jm.problem.model.log_local(jth, jnp.asarray(z), None, jd))
    if padded:
        # Padded rows add exactly nothing: the first 7 rows alone give the same sum.
        real = {k: v[:7] for k, v in td.items() if k != "w"}
        assert float(got) == pytest.approx(
            float(tm.problem.model.log_local(tth, zt, None, real)), rel=1e-6)
    np.testing.assert_allclose(tm.accuracy(zt, td["x"], td["y"]).item(),
                               float(jm.accuracy(jnp.asarray(z), jd["x"], jd["y"])))


def test_prodlda_log_densities_match_reference():
    rng = np.random.default_rng(8)
    V, T, D = 30, 4, 6
    jl, tl = j_build_lda(vocab_size=V, num_topics=T, docs_per_silo=D), t_build_lda(
        vocab_size=V, num_topics=T, docs_per_silo=D)
    z = rng.standard_normal(V * T).astype(np.float32)
    w = rng.standard_normal((D, T)).astype(np.float32)
    counts = rng.poisson(1.5, size=(D, V)).astype(np.int32)
    theta = {"alpha": np.float32(0.3), "log_beta": np.float32(np.log(0.05))}
    jth = {k: jnp.asarray(v) for k, v in theta.items()}
    tth = {k: torch.tensor(v) for k, v in theta.items()}
    (td,) = datas_from_numpy([{"counts": counts}], "cpu")
    zt, wt = torch.as_tensor(z), torch.as_tensor(w)
    _close(tl.problem.model.log_prior_global(tth, zt),
           jl.problem.model.log_prior_global(jth, jnp.asarray(z)))
    _close(tl.problem.model.log_local(tth, zt, wt, td),
           jl.problem.model.log_local(jth, jnp.asarray(z), jnp.asarray(w),
                                      {"counts": jnp.asarray(counts)}))
    np.testing.assert_allclose(tl.topics(zt).numpy(), _np(jl.topics(jnp.asarray(z))),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tl.doc_word_probs(zt, wt).numpy(),
                               _np(jl.doc_word_probs(jnp.asarray(z), jnp.asarray(w))),
                               rtol=1e-5, atol=1e-7)
