"""The port's Bayesian LM head and serve steps against the JAX package.

* ``bayes``: latent sizes and splits, ``bayes_logits``, the two priors and
  ``token_nll`` (against both JAX gold-logit modes) on numpy-seeded
  inputs, f32 rtol 1e-5;
* ``launch.steps``: ``make_serve_prefill`` / ``make_serve_decode`` of both
  packages on the reduced zamba2 and qwen3 (f32) with the JAX parameters
  and the same η (JAX ``init_eta_G``/``init_eta_L`` carried over): the
  logits at atol 5e-4, rtol 1e-3 (as ``test_pallas_model_path_matches_jnp``),
  and six greedy decode steps produce the same tokens;
* the CLI ``python -m repro_torch.launch.serve_backbone --device cpu`` on
  both reduced configs, which prints the prefill, decode and token lines,
  and refuses to start on the default device without CUDA.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import steps as JS
from repro.models.backbone import bayes as JB
from repro.models.backbone import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import backbone_params_from_jax
from repro_torch.launch import serve_backbone
from repro_torch.launch import steps as TS
from repro_torch.models.backbone import bayes as TB

TOL = dict(atol=5e-4, rtol=1e-3)
HEAD_TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ["zamba2-7b", "qwen3-4b"]


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _tree_to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------------------
# Bayesian head
# ---------------------------------------------------------------------------

def test_bayes_head_matches_jax():
    jcfg = j_get_config("qwen3-4b").reduced()
    tcfg = t_get_config("qwen3-4b").reduced()
    assert TB.latent_dims(tcfg) == JB.latent_dims(jcfg)
    n_G, n_L = TB.latent_dims(tcfg)
    rng = np.random.default_rng(0)
    z_G = rng.standard_normal(n_G).astype(np.float32) * 0.3
    z_L = rng.standard_normal(n_L).astype(np.float32) * 0.3
    h = rng.standard_normal((3, 5, tcfg.d_model)).astype(np.float32)
    base = rng.standard_normal((3, 5, tcfg.vocab_size)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, (3, 5))
    for jx, tx in zip(JB.split_global(jcfg, jnp.asarray(z_G)),
                      TB.split_global(tcfg, torch.from_numpy(z_G)), strict=True):
        np.testing.assert_array_equal(_np(tx), np.asarray(jx))
    zl2 = np.stack([z_L, -z_L])
    for jx, tx in zip(JB.split_local(jcfg, jnp.asarray(zl2)),
                      TB.split_local(tcfg, torch.from_numpy(zl2)), strict=True):
        np.testing.assert_array_equal(_np(tx), np.asarray(jx))
    want = JB.bayes_logits(jcfg, jnp.asarray(base), jnp.asarray(h), jnp.asarray(z_G),
                           jnp.asarray(z_L))
    got = TB.bayes_logits(tcfg, torch.from_numpy(base), torch.from_numpy(h),
                          torch.from_numpy(z_G), torch.from_numpy(z_L))
    np.testing.assert_allclose(_np(got), np.asarray(want), **HEAD_TOL)
    tn = TB.token_nll(got, torch.from_numpy(labels))
    for masked in (False, True):  # the JAX lever gives the same number
        jn = JB.token_nll(want, jnp.asarray(labels), masked_gather=masked)
        np.testing.assert_allclose(float(tn), float(jn), **HEAD_TOL)
    np.testing.assert_allclose(float(TB.log_prior_global(tcfg, torch.from_numpy(z_G))),
                               float(JB.log_prior_global(jcfg, jnp.asarray(z_G))), **HEAD_TOL)
    np.testing.assert_allclose(
        float(TB.log_prior_local(tcfg, torch.from_numpy(z_G), torch.from_numpy(z_L))),
        float(JB.log_prior_local(jcfg, jnp.asarray(z_G), jnp.asarray(z_L))), **HEAD_TOL)


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_jax_and_greedy_tokens_agree(arch):
    silos, batch, prompt, gen = 2, 4, 16, 6
    jcfg = j_get_config(arch).reduced()
    tcfg = t_get_config(arch).reduced()
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1), 3)
    jtheta = JT.init_params(k1, jcfg)
    jeta_G = JS.init_eta_G(k2, jcfg)
    jeta_L = JS.init_eta_L(k3, jcfg, silos)
    ttheta = backbone_params_from_jax(jax.tree_util.tree_map(np.asarray, jtheta), "cpu")
    teta_G, teta_L = _tree_to_torch(jeta_G), _tree_to_torch(jeta_L)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (batch, prompt))
    max_len = prompt + gen

    jpre = jax.jit(JS.make_serve_prefill(jcfg, silos, max_len=max_len))
    jdec = jax.jit(JS.make_serve_decode(jcfg, silos))
    tpre = TS.make_serve_prefill(tcfg, silos, max_len=max_len)
    tdec = TS.make_serve_decode(tcfg, silos)
    jl, jc = jpre(jtheta, jeta_G, jeta_L, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tl, tc = tpre(ttheta, teta_G, teta_L, {"tokens": torch.from_numpy(tokens)})
    assert tl.shape == (batch, 1, tcfg.vocab_size)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    jtok = jnp.argmax(jl[:, -1], axis=-1)
    ttok = torch.argmax(tl[:, -1], dim=-1)
    jout, tout = [np.asarray(jtok)], [ttok.numpy()]
    for step in range(gen - 1):
        jl, jc = jdec(jtheta, jeta_G, jeta_L, jtok[:, None], jc)
        tl, tc = tdec(ttheta, teta_G, teta_L, ttok[:, None], tc)
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=f"step {step}", **TOL)
        jtok = jnp.argmax(jl[:, -1], axis=-1)
        ttok = torch.argmax(tl[:, -1], dim=-1)
        jout.append(np.asarray(jtok))
        tout.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(tout, 1), np.stack(jout, 1))


def test_eta_init_shapes_match_jax():
    jcfg = j_get_config("zamba2-7b").reduced()
    tcfg = t_get_config("zamba2-7b").reduced()
    gen = torch.Generator().manual_seed(0)
    for jeta, teta in ((JS.init_eta_G(jax.random.PRNGKey(0), jcfg), TS.init_eta_G(gen, tcfg)),
                       (JS.init_eta_L(jax.random.PRNGKey(0), jcfg, 3),
                        TS.init_eta_L(gen, tcfg, 3))):
        assert set(teta) == set(jeta) == {"mu", "log_sigma"}
        for k in jeta:
            assert tuple(teta[k].shape) == jeta[k].shape and teta[k].dtype == torch.float32
        assert bool((teta["log_sigma"] == -3.0).all())


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_reduced_config_on_cpu(arch, capsys):
    ids = serve_backbone.main(["--device", "cpu", "--arch", arch, "--batch", "4",
                               "--prompt-len", "12", "--gen", "5", "--silos", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={arch}-smoke batch=4 prompt=12: prefill ")
    assert out[0].endswith("tok/s)")
    assert out[1].startswith("decode 4 steps: ") and out[1].endswith("tok/s)")
    assert out[2].startswith("generated token ids (first request): [")
    assert tuple(ids.shape) == (4, 5)
    assert int(ids.min()) >= 0 and int(ids.max()) < t_get_config(arch).reduced().vocab_size
    again = serve_backbone.main(["--device", "cpu", "--arch", arch, "--batch", "4",
                                 "--prompt-len", "12", "--gen", "5", "--silos", "2"])
    assert torch.equal(ids, again)  # greedy from one seed is deterministic


def test_cli_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_backbone.main(["--arch", "qwen3-4b", "--gen", "2"])
