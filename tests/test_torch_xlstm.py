"""The port's xlstm-1.3b (mLSTM, sLSTM) against the JAX package, on the CPU.

* the config equals the reference's field for field; its full-size
  parameter count (3,571,571,024) and the depths ``chip_smoke.py`` runs
  equal ``jax.eval_shape(init_params)``'s (the port's counted on fake
  tensors);
* ``xlstm-1.3b.reduced()`` (one mLSTM and one sLSTM, d_model 128, f32) with
  the reference's parameters and numpy-seeded inputs: the sLSTM cell from a
  random state, ``mlstm_prefill`` (output, the final state, the stabilizer
  m) and the decode steps that keep m, ``slstm_block`` / ``slstm_prefill``
  / ``slstm_decode``, ``forward`` on both JAX routes (jnp and the Pallas
  GLA kernel in interpret mode), ``prefill`` (logits, every cache) and
  greedy decode (four steps, the same tokens): atol 5e-4, rtol 1e-3, as
  ``tests/test_torch_backbone.py``;
* a hand-built config of d_model 256 over 2 heads, so that the mLSTM's GLA
  runs at dk 256, dv 257 (past the kernels' 128-row dk tile): the plain
  GLA (the wrapper's CPU route) on the block's own inputs against the
  Pallas kernel in interpret mode and ``chunked_gla`` (atol = rtol = 3e-5
  of the largest |y|, as ``tests/test_torch_gla_state.py``), and the
  model's forward, prefill and decode against the reference;
* one SFVI and one SFVI-Avg step (a barycenter) with the reference's draws
  injected, held as ``tests/test_torch_train.py`` holds them, Adam's
  ill-conditioned elements as ``tests/test_torch_whisper.py`` takes them
  (a gradient under 1e-6, or an exact 0 on one side only: without that,
  one element of one 65,536-element leaf parts by 2e-6 in the SFVI step
  and by 8e-6 in the SFVI-Avg step);
* the serve and train CLIs run it; the train CLI's bytes a round equal the
  reference CLI's formula.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as j_get_config
from repro.kernels import ops
from repro.launch import steps as JS
from repro.models.backbone import ssm as JSSM
from repro.models.backbone import transformer as JT
from repro.models.backbone import xlstm as JX
from repro.optim.adam import adam as j_adam
from repro_torch.configs import ARCH_NAMES, get_config as t_get_config
from repro_torch.convert import backbone_params_from_jax, train_state_from_jax
from repro_torch.kernels import gla as k_gla
from repro_torch.launch import serve_backbone as t_serve
from repro_torch.launch import steps as TS
from repro_torch.launch import train as t_train
from repro_torch.models.backbone import transformer as TT
from repro_torch.models.backbone import xlstm as TX
from test_torch_backbone import _caches_close, _flat, _np
from test_torch_train import (
    LR,
    _ref_bytes,
    assert_metrics_close,
    assert_states_close,
    ref_draws,
    to_torch_batch,
)
from test_torch_whisper import ill_both_sides

ARCH = "xlstm-1.3b"
TOL = dict(atol=5e-4, rtol=1e-3)
B, S, GEN = 2, 20, 4
J, TB, T = 2, 4, 16  # the train steps' silos, batch, sequence


def _wide(cfg):
    """d_model 256 over 2 heads: the mLSTM's GLA at dk 256, dv 257."""
    return dataclasses.replace(cfg, d_model=256, num_heads=2, num_kv_heads=2, head_dim=128)


def test_config_matches_reference_field_for_field():
    assert ARCH in ARCH_NAMES
    j, t = j_get_config(ARCH), t_get_config(ARCH)
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("bayes", "perf"):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name
    assert TT.unit_structure(t) == JT.unit_structure(j) == (("mlstm",) * 7 + ("slstm",), 6, ())
    assert dataclasses.asdict(t.reduced()) == {
        k: v for k, v in dataclasses.asdict(j.reduced()).items() if k != "use_pallas"}


@pytest.mark.parametrize("layers", [None, 16, 2])
def test_parameter_count_matches_reference(layers):
    """Full depth (48 layers), the depth chip_smoke's train cell takes, and
    its card-against-CPU cell (one mLSTM and one sLSTM at full width)."""
    j, t = j_get_config(ARCH), t_get_config(ARCH)
    if layers == 2:
        j, t = (dataclasses.replace(c, num_layers=2, slstm_period=2) for c in (j, t))
    elif layers:
        j, t = (dataclasses.replace(c, num_layers=layers) for c in (j, t))
    with FakeTensorMode():
        got = TT.param_count(TT.init_params(torch.Generator(), t))
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), j))
    assert got == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    if layers is None:
        assert got == 3_571_571_024


def _setup(cfg_fn, seed):
    jcfg, tcfg = cfg_fn(j_get_config(ARCH).reduced()), cfg_fn(t_get_config(ARCH).reduced())
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = backbone_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab_size,
                                                  (B, S + GEN)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


@pytest.fixture(scope="module", params=["reduced", "dk256"])
def xlstm(request):
    return _setup(_wide if request.param == "dk256" else (lambda c: c), 13)


def test_params_carry_the_f32_leaves(xlstm):
    jcfg, tcfg, jparams, tparams, _ = xlstm
    assert TT.unit_structure(tcfg) == (("mlstm", "slstm"), 1, ())
    m, s = tparams["units"]["slot0"]["mixer"], tparams["units"]["slot1"]["mixer"]
    assert {k for k, v in {**m, **s}.items() if v.dtype == torch.float32} >= {
        "f_bias", "i_bias", "r", "b"}
    flat_t, flat_j = _flat(tparams), _flat(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(flat_t) == set(flat_j)
    assert all(np.array_equal(flat_t[p].numpy(), flat_j[p]) for p in flat_j)


def _mixer(jparams, tparams, slot):
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["units"][slot]["mixer"])
    return jp, {k: v[0] for k, v in tparams["units"][slot]["mixer"].items()}


def test_slstm_cell_matches_jax(xlstm):
    jcfg, tcfg, jparams, tparams, _ = xlstm
    jp, tp = _mixer(jparams, tparams, "slot1")
    H, P = tcfg.num_heads, tcfg.d_model // tcfg.num_heads
    rng = np.random.default_rng(3)
    x_t = rng.normal(size=(B, 4 * tcfg.d_model)).astype(np.float32)
    state = {k: rng.normal(size=(B, H, P)).astype(np.float32) for k in ("c", "n", "h", "m")}
    state["n"] = np.abs(state["n"]) + 0.5
    want = JX._slstm_cell(jp, jcfg, jnp.asarray(x_t), {k: jnp.asarray(v) for k, v in state.items()})
    got = TX._slstm_cell(tp, tcfg, torch.from_numpy(x_t),
                         {k: torch.from_numpy(v) for k, v in state.items()})
    _caches_close(got, want)


def test_slstm_block_prefill_decode_match_jax(xlstm):
    jcfg, tcfg, jparams, tparams, _ = xlstm
    jp, tp = _mixer(jparams, tparams, "slot1")
    u = np.random.default_rng(4).normal(size=(B, S + 1, tcfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(_np(TX.slstm_block(tp, tcfg, torch.from_numpy(u[:, :S]))),
                               _np(JX.slstm_block(jp, jcfg, jnp.asarray(u[:, :S]))), **TOL)
    jy, jc = JX.slstm_prefill(jp, jcfg, jnp.asarray(u[:, :S]))
    ty, tc = TX.slstm_prefill(tp, tcfg, torch.from_numpy(u[:, :S]))
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    _caches_close(tc, jc)
    jy, jc = JX.slstm_decode(jp, jcfg, jnp.asarray(u[:, S:]), jc)
    ty, tc = TX.slstm_decode(tp, tcfg, torch.from_numpy(u[:, S:]), tc)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    _caches_close(tc, jc)


def test_mlstm_prefill_keeps_its_stabilizer_into_decode(xlstm):
    """``mlstm_prefill``'s output, final state and m, then three decode
    steps: m stays the prefill's (not a running max), and each step's
    output and state match the reference's."""
    jcfg, tcfg, jparams, tparams, _ = xlstm
    jp, tp = _mixer(jparams, tparams, "slot0")
    u = np.random.default_rng(5).normal(size=(B, S + 3, tcfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(_np(TX.mlstm_block(tp, tcfg, torch.from_numpy(u[:, :S]))),
                               _np(JX.mlstm_block(jp, jcfg, jnp.asarray(u[:, :S]))), **TOL)
    jy, jc = JX.mlstm_prefill(jp, jcfg, jnp.asarray(u[:, :S]))
    ty, tc = TX.mlstm_prefill(tp, tcfg, torch.from_numpy(u[:, :S]))
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    _caches_close(tc, jc)
    P = 2 * tcfg.d_model // tcfg.num_heads
    assert tuple(tc["state"].shape) == (B, tcfg.num_heads, P, P + 1)
    m0 = tc["m"].clone()
    for i in range(3):
        jy, jc = JX.mlstm_decode(jp, jcfg, jnp.asarray(u[:, S + i:S + i + 1]), jc)
        ty, tc = TX.mlstm_decode(tp, tcfg, torch.from_numpy(u[:, S + i:S + i + 1]), tc)
        np.testing.assert_allclose(_np(ty), _np(jy), err_msg=f"decode {i}", **TOL)
        _caches_close(tc, jc)
        assert torch.equal(tc["m"], m0)


def test_mlstm_gla_plain_matches_pallas_and_chunked(xlstm):
    """The GLA the mLSTM prefill hands the kernel wrapper (its CPU route is
    the plain version), on the block's own q, k e^{i - m} and [v, 1]: at
    the reduced config dk 64, dv 65; at the wide one dk 256, dv 257, two
    of the kernels' dk tiles."""
    _, tcfg, jparams, tparams, _ = xlstm
    _, tp = _mixer(jparams, tparams, "slot0")
    u = torch.from_numpy(np.random.default_rng(6).normal(
        size=(B, 70, tcfg.d_model)).astype(np.float32))
    q, k, v, log_f, log_i, *_ = TX._mlstm_qkva(tp, tcfg, u)
    k_g, v_aug = TX._mlstm_gla_inputs(k, v, log_i, torch.amax(log_i, 1, keepdim=True))
    dk, dv = q.shape[-1], v_aug.shape[-1]
    assert (dk, dv) == ((256, 257) if tcfg.d_model == 256 else (64, 65))
    assert k_gla.gla_plan(B, tcfg.num_heads, dk, dv, torch.bfloat16, 70).dk_tiles == -(-dk // 128)
    got = k_gla.gla(q, k_g, v_aug, log_f)
    jin = [jnp.asarray(t.numpy()) for t in (q, k_g, v_aug, log_f)]
    scale = float(np.abs(_np(got)).max())
    for want in (ops.gla(*jin, interpret=True), JSSM.chunked_gla(*jin)):
        np.testing.assert_allclose(_np(got), _np(want), atol=3e-5 * scale, rtol=3e-5)


@pytest.mark.parametrize("route", ["jnp", "pallas"])
def test_forward_matches_jax(xlstm, route):
    jcfg, tcfg, jparams, tparams, tokens = xlstm
    jcfg = dataclasses.replace(jcfg, use_pallas=route == "pallas")
    want, _, jh = JT.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens[:, :S])}, remat=False)
    got, aux, th = TT.forward(tparams, tcfg, {"tokens": torch.from_numpy(tokens[:, :S]).long()})
    assert got.shape == (B, S, tcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)


def test_prefill_and_greedy_decode_match_jax(xlstm):
    jcfg, tcfg, jparams, tparams, tokens = xlstm
    jl, jc, jh = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens[:, :S])}, S + GEN)
    tl, tc, th = TT.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens[:, :S]).long()},
                            S + GEN)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    _caches_close(tc, jc)
    assert {"state", "m"} <= set(tc["units"]["slot0"]) and {"c", "n", "h", "m"} <= set(
        tc["units"]["slot1"])
    decode = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    jtok, ttok = jnp.argmax(jl[:, -1], -1), torch.argmax(tl[:, -1], -1)
    for step in range(GEN):
        assert np.array_equal(np.asarray(jtok), ttok.numpy()), step
        jl, jc, _ = decode(jparams, jtok[:, None].astype(jnp.int32), jc)
        tl, tc, _ = TT.decode_step(tparams, tcfg, ttok[:, None], tc)
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=f"decode step {step}", **TOL)
        jtok, ttok = jnp.argmax(jl[:, -1], -1), torch.argmax(tl[:, -1], -1)
    _caches_close(tc, jc)


def _train_batch(jcfg, seed):
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (TB, T + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return b, to_torch_batch(b)


def test_sfvi_step_matches_jax():
    jcfg, tcfg = j_get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    n_G, n_L = TS.latent_dims(tcfg)
    jstate, _ = JS.init_train_state(jax.random.PRNGKey(0), jcfg, J, lr=LR)
    jold = jax.tree_util.tree_map(np.asarray, jstate)
    b, tb = _train_batch(jcfg, 14)
    jstate, jm = jax.jit(JS.make_train_step(jcfg, J, lr=LR, remat=False))(jold, b, jnp.int32(0))
    eps = [torch.from_numpy(e) for e in ref_draws(0, [(n_G,), (J, n_L)])]
    tstate, tm = TS.make_train_step(tcfg, J, lr=LR, remat=True)(
        train_state_from_jax(jold, "cpu"), tb, 0, draws=eps)
    assert_metrics_close(tm, jm, "xlstm sfvi")
    assert_states_close(tstate, jstate, "xlstm sfvi", ill_both_sides(jold, jstate, tstate))


def test_sfvi_avg_step_matches_jax():
    """SFVI-Avg with ``avg_every`` 1: the step and its barycenter."""
    jcfg, tcfg = j_get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    n_G, n_L = TS.latent_dims(tcfg)
    key = jax.random.PRNGKey(0)
    s0, _ = JS.init_train_state(key, jcfg, J, lr=LR)
    eta_G = JS.init_eta_G_silo(key, jcfg, J)
    jold = jax.tree_util.tree_map(np.asarray, JS.TrainState(
        s0.theta, eta_G, s0.eta_L, s0.opt_theta, j_adam(LR).init(eta_G), s0.opt_eta_L, s0.step))
    b, tb = _train_batch(jcfg, 15)
    jstate, jm = jax.jit(JS.make_train_step_avg(jcfg, J, 1, lr=LR, remat=False))(
        jold, b, jnp.int32(0))
    eps = [torch.from_numpy(e) for e in ref_draws(0, [(J, n_G), (J, n_L)])]
    tstate, tm = TS.make_train_step_avg(tcfg, J, 1, lr=LR, remat=True)(
        train_state_from_jax(jold, "cpu"), tb, 0, draws=eps)
    assert_metrics_close(tm, jm, "xlstm avg")
    assert_states_close(tstate, jstate, "xlstm avg", ill_both_sides(jold, jstate, tstate))
    assert float((tstate.eta_G["mu"][0] - tstate.eta_G["mu"][1]).abs().max()) < 1e-6


def test_serve_cli_runs():
    cfg = t_get_config(ARCH).reduced()
    run = t_serve.serve(cfg, batch=4, prompt_len=10, gen=3, silos=2, device=torch.device("cpu"))
    cache = run.state["cache"]
    assert tuple(cache["units"]["slot0"]["state"].shape) == (1, 4, cfg.num_heads, 64, 65)
    assert int(cache["t"]) == 12 and tuple(run.tokens.shape) == (4, 3)
    assert bool(torch.isfinite(run.logits).all())


@pytest.mark.parametrize("algo", ["sfvi", "avg"])
def test_train_cli_bytes_per_round_match_reference(algo):
    cfg = t_get_config(ARCH).reduced()
    state, _ = t_train.setup(cfg, algo, 4, 1e-3, 2, torch.device("cpu"))
    assert t_train.bytes_per_round(state, algo, 4, 2) == _ref_bytes(algo, ARCH, 4, 2)
