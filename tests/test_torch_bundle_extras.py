"""``ModelBundle.extras`` of the port's registry against the reference registry's.

Every registered model is built small in both packages; the port's
builders take the reference's arrays where they accept them (glmm's
``datas``, the BNN's ``datas`` / ``test``, multinomial's and hetero_mn's
``train`` / ``test``, ProdLDA's ``counts``), so the extras can be held to
the reference's values:

* the keys are the reference's, for every model;
* toy's closed-form posterior (numpy data in both packages): within 1e-6;
* glmm: ``pooled`` holds the silos' children (the same multiset of rows
  as the reference's pooled data restricted to them), ``truth`` and
  ``num_children`` equal;
* hetero_mn's ``partitions``, ``alpha`` and ``size_skew`` equal;
  multinomial's and hetero_mn's ``train_all`` / ``test`` equal the
  reference's arrays; their ``model`` is the port's own (a
  ``MultinomialRegression`` of the same width);
* the BNN's ``test`` shards equal the given ones and ``bnn`` is the
  port's ``HierBNN``; ProdLDA's ``counts`` is the matrix and ``lda`` the
  port's ``ProdLDA`` of the same vocabulary and topics.
"""
import numpy as np
import pytest
import torch

from repro.models.paper.registry import get_model as j_get
from repro.models.paper.registry import model_names as j_names
from repro_torch.models.paper.hier_bnn import HierBNN
from repro_torch.models.paper.multinomial import MultinomialRegression
from repro_torch.models.paper.prodlda import ProdLDA
from repro_torch.models.paper.registry import get_model as t_get
from repro_torch.models.paper.registry import model_names as t_names

SEED = 0
BNN = {"in_dim": 16, "hidden": 4, "train_per_silo": 6, "test_per_silo": 4}
MODELS = {  # name: (J, kwargs both packages take)
    "toy": (3, {"num_obs": 5}),
    "glmm": (2, {"num_children": 10}),
    "hier_bnn": (2, BNN),
    "fedpop_bnn": (2, BNN),
    "multinomial": (2, {"n_per": 10, "in_dim": 16}),
    "hetero_mn": (3, {"n_total": 40, "in_dim": 16}),
    "prodlda": (2, {"vocab_size": 30, "num_topics": 3, "docs_per_silo": 4}),
}


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _numpy_dicts(ds):
    return [{k: _np(v) for k, v in d.items()} for d in ds]


def _port_bundle(name, jb, J, kwargs):
    ex = jb.extras
    if name == "glmm":
        extra = {"datas": _numpy_dicts(jb.datas)}
    elif name in ("hier_bnn", "fedpop_bnn"):
        extra = {"datas": _numpy_dicts(jb.datas), "test": _numpy_dicts(ex["test"])}
    elif name in ("multinomial", "hetero_mn"):
        extra = {"train": (_np(ex["train_all"]["x"]), _np(ex["train_all"]["y"])),
                 "test": (_np(ex["test"]["x"]), _np(ex["test"]["y"]))}
    elif name == "prodlda":
        extra = {"counts": _np(ex["counts"])}
    else:
        extra = {}
    return t_get(name).build(SEED, J, device="cpu", **kwargs, **extra)


def test_every_reference_model_is_registered():
    assert t_names() == j_names() == sorted(MODELS)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_extras_keys_and_values_match_the_reference(name):
    J, kwargs = MODELS[name]
    jb = j_get(name).build(SEED, J, **kwargs)
    tb = _port_bundle(name, jb, J, kwargs)
    je, te = jb.extras, tb.extras
    assert sorted(te) == sorted(je), name
    if name == "toy":
        for k in je:
            assert te[k] == pytest.approx(je[k], rel=1e-6, abs=1e-7), k
    elif name == "glmm":
        assert te["num_children"] == je["num_children"] == 10
        assert np.array_equal(te["truth"]["beta"], np.asarray(je["truth"]["beta"]))
        assert te["truth"]["omega"] == je["truth"]["omega"]
        for k, v in je["pooled"].items():
            got, want = _np(te["pooled"][k]), _np(v)
            assert got.shape == want.shape and got.dtype == np.float32, k
            # The same children: the silos' rows in silo order.
            assert np.array_equal(got, np.concatenate([_np(d[k]) for d in jb.datas])), k
            key = (lambda a: np.sort(a.reshape(len(a), -1), axis=0))
            assert np.array_equal(key(got), key(want.astype(np.float32))), k
    elif name in ("hier_bnn", "fedpop_bnn"):
        assert isinstance(te["bnn"], HierBNN)
        for td, jd in zip(te["test"], je["test"], strict=True):
            for k in jd:
                assert np.array_equal(_np(td[k]), _np(jd[k]).astype(_np(td[k]).dtype)), k
    elif name in ("multinomial", "hetero_mn"):
        assert isinstance(te["model"], MultinomialRegression)
        for part in ("train_all", "test"):
            for k in ("x", "y"):
                want = _np(je[part][k])
                assert np.array_equal(_np(te[part][k]), want.astype(_np(te[part][k]).dtype))
        if name == "hetero_mn":
            assert te["alpha"] == je["alpha"]
            assert te["size_skew"] == pytest.approx(je["size_skew"], rel=1e-12)
            for a, b in zip(te["partitions"], je["partitions"], strict=True):
                assert np.array_equal(a, b)
    else:
        assert isinstance(te["lda"], ProdLDA)
        assert np.array_equal(_np(te["counts"]), _np(je["counts"]))
        assert (te["lda"].vocab_size, te["lda"].num_topics) == (30, 3)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_extras_on_the_bundles_device_when_drawn_by_the_port(name):
    """Without the reference's arrays the port's builders fill the same keys,
    tensors on the bundle's device."""
    J, kwargs = MODELS[name]
    tb = t_get(name).build(SEED, J, device="cpu", **kwargs)
    assert sorted(tb.extras) == sorted(j_get(name).build(SEED, J, **kwargs).extras)
    tensors = [x for v in tb.extras.values()
               for x in (v.values() if isinstance(v, dict) else [v])
               if isinstance(x, torch.Tensor)]
    assert all(x.device.type == "cpu" for x in tensors)
