"""The port's qwen2-vl pieces (M-RoPE, the vision prefix) against the JAX
package, on the CPU.

* the config equals the reference's field for field; its full-size
  parameter count (and the depth ``chip_smoke.py`` checks on the card)
  equals ``jax.eval_shape(init_params)``'s;
* ``mrope_grid``, ``mrope_text_start`` and ``mrope_positions`` exactly,
  for vision blocks of 0, 7, 16 and 256 tokens;
* ``apply_mrope`` at head_dim 128 (sections of 32 / 48 / 48 dims, each
  with its own width's frequencies) and 32: atol 1e-5, rtol 1e-4 (f32);
* ``forward`` (text logits only), ``prefill`` (logits, every cache, ``t``
  = vision + text) and four ``decode_step``s of the reduced qwen2-vl
  (2 layers, 16 vision tokens) with the reference's parameters, with and
  without a vision prefix: atol 5e-4, rtol 1e-3, as
  ``tests/test_torch_backbone.py``;
* one SFVI step with the vision input and the reference's draws injected,
  held as ``tests/test_torch_train.py`` holds one;
* the serve CLI sizes its cache for the prefix; the train CLI feeds it.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as j_get_config
from repro.launch import steps as JS
from repro.models.backbone import layers as JL
from repro.models.backbone import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import backbone_params_from_jax, train_state_from_jax
from repro_torch.launch import serve_backbone as t_serve
from repro_torch.launch import steps as TS
from repro_torch.launch import train as t_train
from repro_torch.models.backbone import layers as TL
from repro_torch.models.backbone import transformer as TT
from test_torch_backbone import _caches_close
from test_torch_train import (
    LR,
    assert_metrics_close,
    assert_states_close,
    ill_elements,
    ref_draws,
    to_torch_batch,
)

ARCH = "qwen2-vl-2b"
TOL = dict(atol=5e-4, rtol=1e-3)
B, S, GEN = 2, 20, 4


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def test_config_matches_reference_field_for_field():
    j, t = j_get_config(ARCH), t_get_config(ARCH)
    for f in dataclasses.fields(t):
        if f.name in ("bayes", "perf"):
            assert dataclasses.asdict(getattr(t, f.name)) == dataclasses.asdict(getattr(j, f.name))
        else:
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.mrope and t.num_vision_tokens == 256 and TT.unit_structure(t) == JT.unit_structure(j)
    assert dataclasses.asdict(t.reduced()) == {
        k: v for k, v in dataclasses.asdict(j.reduced()).items() if k != "use_pallas"}


@pytest.mark.parametrize("layers", [None, 2])
def test_parameter_count_matches_reference(layers):
    j, t = j_get_config(ARCH), t_get_config(ARCH)
    if layers:
        j, t = (dataclasses.replace(c, num_layers=layers) for c in (j, t))
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), j))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    with FakeTensorMode():
        got = TT.param_count(TT.init_params(torch.Generator(), t))
    assert got == want == {None: 1_546_016_256, 2: 329_326_080}[layers]


@pytest.mark.parametrize("nv", [0, 7, 16, 256])
def test_mrope_positions_match_jax(nv):
    assert TL.mrope_grid(nv) == JL.mrope_grid(nv)
    assert TL.mrope_text_start(nv) == JL.mrope_text_start(nv)
    for seq in (nv + 1, nv + 9):
        got = TL.mrope_positions(3, seq, nv)
        want = np.asarray(JL.mrope_positions(3, seq, nv))
        assert got.dtype == torch.int32 and tuple(got.shape) == (3, 3, seq)
        assert np.array_equal(got.numpy(), want), (nv, seq)
    grid = (4, 2)  # an explicit grid
    assert np.array_equal(TL.mrope_positions(1, 12, 8, grid).numpy(),
                          np.asarray(JL.mrope_positions(1, 12, 8, grid)))


@pytest.mark.parametrize("hd", [128, 32])
def test_apply_mrope_matches_jax(hd):
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 30, 3, hd)).astype(np.float32)
    pos = TL.mrope_positions(2, 30, 16)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos.numpy()), 1e6)
    got = TL.apply_mrope(torch.from_numpy(x), pos, 1e6)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-4)
    if hd == 128:  # the quirk: each section rotates with its own width's frequencies
        parts, start = [], 0
        for i, w in enumerate((32, 48, 48)):
            parts.append(TL.apply_rope(torch.from_numpy(x[..., start:start + w]), pos[i], 1e6))
            start += w
        assert torch.equal(got, torch.cat(parts, -1))


@pytest.fixture(scope="module")
def vlm():
    jcfg, tcfg = j_get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    assert tcfg.num_vision_tokens == 16
    jparams = JT.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = backbone_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S + GEN)).astype(np.int32)
    vision = rng.normal(size=(B, jcfg.num_vision_tokens, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, tokens, vision


def _batches(tokens, vision):
    jb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens).long()}
    if vision is not None:
        jb["vision"], tb["vision"] = jnp.asarray(vision), torch.from_numpy(vision)
    return jb, tb


@pytest.mark.parametrize("with_vision", [True, False], ids=["vision", "text_only"])
def test_vlm_forward_matches_jax(vlm, with_vision):
    jcfg, tcfg, jparams, tparams, tokens, vision = vlm
    jb, tb = _batches(tokens[:, :S], vision if with_vision else None)
    want, jaux, jh = JT.forward(jparams, jcfg, jb, remat=False)
    got, taux, th = TT.forward(tparams, tcfg, tb, remat=False)
    assert tuple(got.shape) == (B, S, tcfg.vocab_size)  # text positions only
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("with_vision", [True, False], ids=["vision", "text_only"])
def test_vlm_prefill_and_decode_match_jax(vlm, with_vision):
    jcfg, tcfg, jparams, tparams, tokens, vision = vlm
    nv = tcfg.num_vision_tokens if with_vision else 0
    max_len = S + GEN + nv
    jb, tb = _batches(tokens[:, :S], vision if with_vision else None)
    jl, jc, _ = JT.prefill(jparams, jcfg, jb, max_len)
    tl, tc, _ = TT.prefill(tparams, tcfg, tb, max_len)
    assert int(tc["t"]) == int(jc["t"]) == S + nv
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _caches_close(tc, jc)
    for step in range(GEN):
        tok = tokens[:, S + step:S + step + 1]
        jl, jc, _ = JT.decode_step(jparams, jcfg, jnp.asarray(tok), jc)
        tl, tc, _ = TT.decode_step(tparams, tcfg, torch.from_numpy(tok).long(), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=f"decode step {step}", **TOL)
    _caches_close(tc, jc)
    assert tc["units"]["slot0"]["attn"]["k"].shape[2] == max_len  # the prefix never cut


def test_sfvi_step_with_vision_matches_jax():
    jcfg, tcfg = j_get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    J, TB, T = 2, 4, 16
    n_G, n_L = TS.latent_dims(tcfg)
    jstate, _ = JS.init_train_state(jax.random.PRNGKey(0), jcfg, J, lr=LR)
    jold = jax.tree_util.tree_map(np.asarray, jstate)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, jcfg.vocab_size, (TB, T + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
         "vision": rng.normal(size=(TB, jcfg.num_vision_tokens, jcfg.d_model)).astype(np.float32)}
    jstate, jm = jax.jit(JS.make_train_step(jcfg, J, lr=LR, remat=False))(jold, b, jnp.int32(0))
    eps = [torch.from_numpy(e) for e in ref_draws(0, [(n_G,), (J, n_L)])]
    tb = {**to_torch_batch({k: b[k] for k in ("tokens", "labels")}),
          "vision": torch.from_numpy(b["vision"])}
    tstate, tm = TS.make_train_step(tcfg, J, lr=LR, remat=True)(
        train_state_from_jax(jold, "cpu"), tb, 0, draws=eps)
    assert_metrics_close(tm, jm, "qwen2-vl sfvi")
    assert_states_close(tstate, jstate, "qwen2-vl sfvi", ill_elements(jold, jstate))
    assert tstate.theta["vision_proj"].shape == (tcfg.d_model, tcfg.d_model)


def test_serve_cli_sizes_the_cache_for_the_vision_prefix():
    cfg = t_get_config(ARCH).reduced()
    run = t_serve.serve(cfg, batch=4, prompt_len=10, gen=3, silos=2, device=torch.device("cpu"))
    nv = cfg.num_vision_tokens
    assert tuple(run.state["prompt"]["vision"].shape) == (4, nv, cfg.d_model)
    cache = run.state["cache"]
    assert cache["units"]["slot0"]["attn"]["k"].shape[2] == 10 + 3 + nv
    assert int(cache["t"]) == nv + 10 + 2 and tuple(run.tokens.shape) == (4, 3)
    assert bool(torch.isfinite(run.logits).all())


def test_train_cli_feeds_the_vision_prefix():
    seen = []
    real = TT.forward

    def spy(params, cfg, batch, remat=True):
        seen.append(tuple(batch["vision"].shape))
        return real(params, cfg, batch, remat)

    out = io.StringIO()
    TT.forward = spy
    try:
        with contextlib.redirect_stdout(out):
            state = t_train.main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--batch",
                                  "4", "--silos", "2", "--seq", "8", "--log-every", "1"])
    finally:
        TT.forward = real
    cfg = t_get_config(ARCH).reduced()
    assert seen == [(4, cfg.num_vision_tokens, cfg.d_model)] * 2 and state.step == 2
    assert out.getvalue().count("loss=") == 2
    v0, v1 = (t_train.vision_inputs(cfg, 4, i, torch.device("cpu")) for i in (0, 1))
    assert v0.dtype == torch.float32 and not torch.equal(v0, v1)
