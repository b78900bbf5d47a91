"""The port's dense configs (qwen3-8b, qwen3-32b, llama3.2-3b) and their new
GQA groups against the JAX package, on the CPU.

* each config equals the reference's field for field (and its full-size
  unit structure and latent sizes);
* the groups these configs bring to attention, 3 (llama3.2-3b, 24/8) and 8
  (qwen3-32b, 64/8), which ``reduced()`` folds to 4/1: small configs built
  by hand with H/KV = 6/2 and 8/1 (2 layers, d_model 96, head_dim 16, f32)
  through ``forward`` (the train route), ``prefill`` (the flash wrapper's
  plain version) and four ``decode_step``s against the JAX package, with
  the reference's own parameters; atol 5e-4, rtol 1e-3, as
  ``tests/test_torch_backbone.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.backbone import transformer as JT
from repro.models.backbone.bayes import latent_dims as j_latent_dims
from repro_torch.configs import ARCH_NAMES, get_config as t_get_config
from repro_torch.convert import backbone_params_from_jax
from repro_torch.models.backbone import transformer as TT
from repro_torch.models.backbone.bayes import latent_dims as t_latent_dims

DENSE = ["qwen3-8b", "qwen3-32b", "llama3.2-3b"]
TOL = dict(atol=5e-4, rtol=1e-3)
B, S, GEN = 2, 20, 4


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("arch", DENSE)
def test_config_matches_reference_field_for_field(arch):
    assert arch in ARCH_NAMES
    j, t = j_get_config(arch), t_get_config(arch)
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("bayes", "perf"):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name
    assert TT.unit_structure(t) == JT.unit_structure(j)
    assert t_latent_dims(t) == j_latent_dims(j)
    assert dataclasses.asdict(t.reduced()) == {
        k: v for k, v in dataclasses.asdict(j.reduced()).items() if k != "use_pallas"}


def test_llama_ties_embeddings():
    cfg = t_get_config("llama3.2-3b")
    assert cfg.tie_embeddings and cfg.rope_theta == 5e5 and cfg.num_heads // cfg.num_kv_heads == 3
    params = TT.init_params(torch.Generator().manual_seed(0), cfg.reduced())
    assert "lm_head" not in params


GROUPS = {"gqa_6_2": ("llama3.2-3b", 6, 2), "gqa_8_1": ("qwen3-32b", 8, 1)}


@pytest.fixture(scope="module", params=sorted(GROUPS))
def grouped(request):
    arch, H, KV = GROUPS[request.param]
    edit = dict(num_heads=H, num_kv_heads=KV, head_dim=16, d_model=96)
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), **edit)
    tcfg = dataclasses.replace(t_get_config(arch).reduced(), **edit)
    jparams = JT.init_params(jax.random.PRNGKey(11), jcfg)
    tparams = backbone_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, S + GEN)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


def test_grouped_forward_matches_jax(grouped):
    jcfg, tcfg, jparams, tparams, tokens = grouped
    assert tcfg.num_heads // tcfg.num_kv_heads in (3, 8)
    want, _, jh = JT.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens[:, :S])}, remat=False)
    got, _, th = TT.forward(tparams, tcfg, {"tokens": torch.from_numpy(tokens[:, :S]).long()},
                            remat=False)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)


def test_grouped_prefill_and_decode_match_jax(grouped):
    jcfg, tcfg, jparams, tparams, tokens = grouped
    max_len = S + GEN
    jl, jc, _ = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens[:, :S])}, max_len)
    tl, tc, _ = TT.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens[:, :S]).long()},
                           max_len)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for step in range(GEN):
        tok = tokens[:, S + step:S + step + 1]
        jl, jc, _ = JT.decode_step(jparams, jcfg, jnp.asarray(tok), jc)
        tl, tc, _ = TT.decode_step(tparams, tcfg, torch.from_numpy(tok).long(), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=f"decode step {step}", **TOL)
