"""The port's whisper-base (bidirectional encoder, cross-attention) against
the JAX package, on the CPU.

* the config equals the reference's field for field; its full-size
  parameter count (109,749,248) and the depth ``chip_smoke.py`` checks on
  the card equal ``jax.eval_shape(init_params)``'s;
* ``whisper-base.reduced()`` (2 encoder + 2 decoder layers, d_model 128,
  64 stub frames, f32) with the reference's parameters and numpy-seeded
  frames and tokens: ``encode`` (the port's train mode, and its serve mode
  through the flash wrapper's plain version), ``cross_attention`` (both
  modes), ``forward`` on both JAX routes (jnp and the Pallas kernels in
  interpret mode), ``prefill`` (logits and every cache, ``memory``
  included) and greedy decode (four steps, the same tokens): atol 5e-4,
  rtol 1e-3, as ``tests/test_torch_backbone.py``;
* one SFVI and one SFVI-Avg step (a barycenter) with the reference's draws
  injected, held as ``tests/test_torch_train.py`` holds them, with
  ``tests/test_torch_moe.py``'s threshold for Adam's ill-conditioned
  elements (1e-6): the encoder's θ gradients part between the packages by
  up to ~6e-8 absolute (about 1e-6 of each leaf's largest), as the MoE
  models' do, and Adam's first step g / (|g| + 1e-8) turns that into up to
  ~lr where |g| is under 1e-6 (at most 4 + 2 % of a leaf's elements); an
  element whose gradient is an exact 0 on one side and under 1e-6 on the
  other (one such in the encoder's wk: 0 against 1.2e-9) is held alike;
* the serve and train CLIs feed the stub frames; the train CLI's bytes a
  round equal the reference CLI's formula.
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
from repro.models.backbone import attention as JA
from repro.models.backbone import transformer as JT
from repro.optim.adam import adam as j_adam
from repro_torch.configs import ARCH_NAMES, get_config as t_get_config
from repro_torch.convert import backbone_params_from_jax, train_state_from_jax
from repro_torch.launch import serve_backbone as t_serve
from repro_torch.launch import steps as TS
from repro_torch.launch import train as t_train
from repro_torch.models.backbone import attention as TA
from repro_torch.models.backbone import transformer as TT
from repro_torch.tree import tree_leaves
from test_torch_backbone import _caches_close, _flat, _np
from test_torch_moe import MOE_ILL_GRAD, ill_elements
from test_torch_train import (
    LR,
    _moments,
    _ref_bytes,
    assert_metrics_close,
    assert_states_close,
    ref_draws,
    to_torch_batch,
)

ARCH = "whisper-base"
TOL = dict(atol=5e-4, rtol=1e-3)
B, S, GEN = 2, 20, 4
J, TB, T = 2, 4, 16  # the train steps' silos, batch, sequence


def test_config_matches_reference_field_for_field():
    assert ARCH in ARCH_NAMES
    j, t = j_get_config(ARCH), t_get_config(ARCH)
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("bayes", "perf"):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name
    assert t.is_encoder_decoder and TT.unit_structure(t) == JT.unit_structure(j)
    assert dataclasses.asdict(t.reduced()) == {
        k: v for k, v in dataclasses.asdict(j.reduced()).items() if k != "use_pallas"}


@pytest.mark.parametrize("layers", [None, 1])
def test_parameter_count_matches_reference(layers):
    """Full depth (6 + 6 layers), and chip_smoke's 1 + 1 layer parity cell."""
    j, t = j_get_config(ARCH), t_get_config(ARCH)
    if layers:
        j, t = (dataclasses.replace(c, num_layers=layers, num_encoder_layers=layers)
                for c in (j, t))
    with FakeTensorMode():
        got = TT.param_count(TT.init_params(torch.Generator(), t))
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), j))
    assert got == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    if layers is None:
        assert got == 109_749_248


@pytest.fixture(scope="module")
def whisper():
    jcfg, tcfg = j_get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    assert (tcfg.num_layers, tcfg.num_encoder_layers, tcfg.encoder_seq_len) == (2, 2, 64)
    jparams = JT.init_params(jax.random.PRNGKey(11), jcfg)
    tparams = backbone_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(21)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S + GEN)).astype(np.int32)
    frames = rng.normal(size=(B, jcfg.encoder_seq_len, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, tokens, frames


def test_params_carry_the_encoder_and_cross_attention(whisper):
    _, tcfg, jparams, tparams, *_ = whisper
    assert set(tparams["encoder"]) == {"blocks", "final_norm"}
    assert tparams["encoder"]["blocks"]["attn"]["wq"].shape[0] == tcfg.num_encoder_layers
    assert "xattn" not in tparams["encoder"]["blocks"]
    assert {"norm_x", "xattn"} <= set(tparams["units"]["slot0"])
    flat_t, flat_j = _flat(tparams), _flat(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(flat_t) == set(flat_j)
    assert all(np.array_equal(flat_t[p].numpy(), flat_j[p]) for p in flat_j)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_encode_matches_jax(whisper, mode):
    """The encoder: differentiable ops (train) and the flash / RMSNorm
    wrappers (prefill; their plain versions here), against the reference's
    ``encode``."""
    jcfg, tcfg, jparams, tparams, _, frames = whisper
    want = JT.encode(jparams, jcfg, jnp.asarray(frames))
    got = TT.encode(tparams, tcfg, torch.from_numpy(frames), mode)
    assert got.shape == (B, tcfg.encoder_seq_len, tcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_cross_attention_matches_jax(whisper, mode):
    jcfg, tcfg, jparams, tparams, _, frames = whisper
    sq = 1 if mode == "decode" else S
    x = np.random.default_rng(4).normal(size=(B, sq, jcfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["units"]["slot0"]["xattn"])
    tp = {k: v[0] for k, v in tparams["units"]["slot0"]["xattn"].items()}
    want = JA.cross_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(frames))
    got = TA.cross_attention(tp, tcfg, torch.from_numpy(x), torch.from_numpy(frames), mode)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-4)


def _batches(tokens, frames):
    jb = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    tb = {"tokens": torch.from_numpy(tokens).long(), "frames": torch.from_numpy(frames)}
    return jb, tb


@pytest.mark.parametrize("route", ["jnp", "pallas"])
def test_forward_matches_jax(whisper, route):
    jcfg, tcfg, jparams, tparams, tokens, frames = whisper
    jcfg = dataclasses.replace(jcfg, use_pallas=route == "pallas")
    jb, tb = _batches(tokens[:, :S], frames)
    want, _, jh = JT.forward(jparams, jcfg, jb, remat=False)
    got, aux, th = TT.forward(tparams, tcfg, tb)
    assert got.shape == (B, S, tcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)


def test_prefill_and_greedy_decode_match_jax(whisper):
    """Prefill's logits and caches (self-attention K/V and the encoder's
    ``memory``), then four greedy steps: each step's logits, the same
    argmax tokens, and the caches after them."""
    jcfg, tcfg, jparams, tparams, tokens, frames = whisper
    max_len = S + GEN
    jb, tb = _batches(tokens[:, :S], frames)
    jl, jc, jh = JT.prefill(jparams, jcfg, jb, max_len)
    tl, tc, th = TT.prefill(tparams, tcfg, tb, max_len)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    assert tuple(tc["memory"].shape) == (B, tcfg.encoder_seq_len, tcfg.d_model)
    _caches_close(tc, jc)
    decode = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    jtok = jnp.argmax(jl[:, -1], -1)
    ttok = torch.argmax(tl[:, -1], -1)
    for step in range(GEN):
        assert np.array_equal(np.asarray(jtok), ttok.numpy()), step
        jl, jc, _ = decode(jparams, jtok[:, None].astype(jnp.int32), jc)
        tl, tc, _ = TT.decode_step(tparams, tcfg, ttok[:, None], tc)
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=f"decode step {step}", **TOL)
        jtok, ttok = jnp.argmax(jl[:, -1], -1), torch.argmax(tl[:, -1], -1)
    _caches_close(tc, jc)
    assert tc["memory"] is not None and int(tc["t"]) == S + GEN


def _train_batch(jcfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (TB, T + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
         "frames": rng.normal(size=(TB, jcfg.encoder_seq_len, jcfg.d_model)).astype(np.float32)}
    tb = {**to_torch_batch({k: b[k] for k in ("tokens", "labels")}),
          "frames": torch.from_numpy(b["frames"])}
    return b, tb


def ill_both_sides(jold, jnew, tnew):
    """``ill_elements`` of the step, and the elements whose gradient one
    package left an exact 0 and the other under ``MOE_ILL_GRAD``."""
    ill = ill_elements(jold, jnew)
    g_ref = [(np.asarray(m1) - 0.9 * np.asarray(m0)) / 0.1
             for m0, m1 in zip(_moments(jold), _moments(jnew))]
    g_port = [(m1.numpy() - 0.9 * np.asarray(m0)) / 0.1 for m0, m1 in zip(
        _moments(jold), tree_leaves((tnew.opt_theta[0].mu, tnew.opt_eta_G[0].mu,
                                     tnew.opt_eta_L[0].mu)))]
    for m, a, b in zip(ill, g_ref, g_port, strict=True):
        m |= ((a == 0) != (b == 0)) & (np.maximum(np.abs(a), np.abs(b)) < MOE_ILL_GRAD)
    return ill


def test_sfvi_step_matches_jax():
    jcfg, tcfg = j_get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    n_G, n_L = TS.latent_dims(tcfg)
    jstate, _ = JS.init_train_state(jax.random.PRNGKey(0), jcfg, J, lr=LR)
    jold = jax.tree_util.tree_map(np.asarray, jstate)
    b, tb = _train_batch(jcfg, 12)
    jstate, jm = jax.jit(JS.make_train_step(jcfg, J, lr=LR, remat=False))(jold, b, jnp.int32(0))
    eps = [torch.from_numpy(e) for e in ref_draws(0, [(n_G,), (J, n_L)])]
    tstate, tm = TS.make_train_step(tcfg, J, lr=LR, remat=True)(
        train_state_from_jax(jold, "cpu"), tb, 0, draws=eps)
    assert_metrics_close(tm, jm, "whisper sfvi")
    assert_states_close(tstate, jstate, "whisper sfvi", ill_both_sides(jold, jstate, tstate))


def test_sfvi_avg_step_matches_jax():
    """SFVI-Avg with ``avg_every`` 1: the step and its barycenter."""
    jcfg, tcfg = j_get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    n_G, n_L = TS.latent_dims(tcfg)
    key = jax.random.PRNGKey(0)
    s0, _ = JS.init_train_state(key, jcfg, J, lr=LR)
    eta_G = JS.init_eta_G_silo(key, jcfg, J)
    jold = jax.tree_util.tree_map(np.asarray, JS.TrainState(
        s0.theta, eta_G, s0.eta_L, s0.opt_theta, j_adam(LR).init(eta_G), s0.opt_eta_L, s0.step))
    b, tb = _train_batch(jcfg, 13)
    jstate, jm = jax.jit(JS.make_train_step_avg(jcfg, J, 1, lr=LR, remat=False))(
        jold, b, jnp.int32(0))
    eps = [torch.from_numpy(e) for e in ref_draws(0, [(J, n_G), (J, n_L)])]
    tstate, tm = TS.make_train_step_avg(tcfg, J, 1, lr=LR, remat=True)(
        train_state_from_jax(jold, "cpu"), tb, 0, draws=eps)
    assert_metrics_close(tm, jm, "whisper avg")
    assert_states_close(tstate, jstate, "whisper avg", ill_both_sides(jold, jstate, tstate))
    assert float((tstate.eta_G["mu"][0] - tstate.eta_G["mu"][1]).abs().max()) < 1e-6


def test_serve_cli_feeds_the_frames():
    cfg = t_get_config(ARCH).reduced()
    run = t_serve.serve(cfg, batch=4, prompt_len=10, gen=3, silos=2, device=torch.device("cpu"))
    assert tuple(run.state["prompt"]["frames"].shape) == (4, cfg.encoder_seq_len, cfg.d_model)
    cache = run.state["cache"]
    assert tuple(cache["memory"].shape) == (4, cfg.encoder_seq_len, cfg.d_model)
    assert int(cache["t"]) == 10 + 2 and tuple(run.tokens.shape) == (4, 3)
    assert bool(torch.isfinite(run.logits).all())


@pytest.mark.parametrize("algo", ["sfvi", "avg"])
def test_train_cli_feeds_the_frames_and_meters_the_reference_bytes(algo):
    cfg = t_get_config(ARCH).reduced()
    state, _ = t_train.setup(cfg, algo, 4, 1e-3, 2, torch.device("cpu"))
    assert t_train.bytes_per_round(state, algo, 4, 2) == _ref_bytes(algo, ARCH, 4, 2)
    seen = []
    real = TT.forward

    def spy(params, cfg, batch, remat=True):
        seen.append(tuple(batch["frames"].shape))
        return real(params, cfg, batch, remat)

    out = io.StringIO()
    TT.forward = spy
    try:
        with contextlib.redirect_stdout(out):
            state = t_train.main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--batch",
                                  "4", "--silos", "2", "--seq", "8", "--log-every", "1",
                                  "--algo", algo, "--avg-every", "2"])
    finally:
        TT.forward = real
    assert seen == [(4, cfg.encoder_seq_len, cfg.d_model)] * 2 and state.step == 2
    assert out.getvalue().count("loss=") == 2
    f0, f1 = (t_train.frame_inputs(cfg, 4, i, torch.device("cpu")) for i in (0, 1))
    assert f0.dtype == torch.float32 and not torch.equal(f0, f1)
