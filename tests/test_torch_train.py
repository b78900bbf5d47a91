"""The port's backbone train path against the JAX package, on the CPU.

Reduced configs (2 layers, d_model 128, f32; J = 2 silos, B = 4, S = 16,
lr 1e-3) from the JAX package's own initial state, carried over with
``repro_torch.convert.train_state_from_jax``, on one numpy-seeded token
batch. The Gaussian draws are the reference's: ``split(fold_in(
PRNGKey(seed), 0))`` then ``normal`` (``src/repro/launch/steps.py:136-138``,
``:267-270``), injected into the port with ``draws=``. Tolerances:

* ``make_train_step`` (qwen3-4b, zamba2-7b; 1 and 3 steps; with and without
  ``silo_mask``; each step of the port from the reference's state before
  it, so that step 2 and 3 hold Adam's bias correction at counts 2 and 3
  and no rounding carries over): loss and metrics rtol 1e-5; every θ / η
  / Adam leaf rtol
  1e-4, atol 1e-6, except the parameter elements whose reference gradient
  was under ``ILL_GRAD`` (1e-7) but not 0 at that step: there Adam's step
  g / (|g| + 1e-8) turns the two packages' summation-order difference in g
  (up to ~1e-8 absolute at these sizes) into up to lr, so those elements
  (0 to 14 of a leaf's 1e4-1e5 here) are held to 2·lr instead. Chained
  without the reset, such an element's gap of ~1e-5 moves other
  elements' gradients by ~1e-4 relative at the next step;
* the η gradients (Adam's first moment after one step from zero is
  (1 − b1)·g): rtol 1e-4, atol 1e-7;
* ``make_train_step_avg`` (llama3.2-3b, ``avg_every`` 2, 4 steps): the
  silos' η_G rows within 1e-6 of each other after each barycenter, as
  ``tests/test_integration_train.py``; the state as above;
* ``forward(remat=True/False)``: logits atol 5e-4, rtol 1e-3 (as
  ``tests/test_torch_backbone.py``); gradients of a fixed projection of the
  logits rtol 1e-3, atol 1e-5 of the largest;
* ``chunked_attention``, ``full_attention``, ``chunked_gla``: atol 1e-5,
  rtol 1e-4; ``chunked_gla``'s gradient rtol 1e-4, atol 1e-6 of its
  largest element;
* the driver loop and the CLI: bytes exact, ε within 1e-9, spec JSON
  string-equal;
* Adam on bfloat16 leaves: θ and μ bit for bit.
"""
import contextlib
import dataclasses
import importlib.util
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.synthetic import make_token_stream as j_token_stream
from repro.federated import NoCompression as JNoCompression
from repro.federated import Scenario as JScenario
from repro.federated.driver import run_rounds as j_run_rounds
from repro.federated.metering import CommMeter as JCommMeter
from repro.launch import steps as JS
from repro.launch import train as j_train
from repro.models.backbone import attention as JA
from repro.models.backbone import ssm as JSSM
from repro.models.backbone import transformer as JT
from repro.optim.adam import adam as j_adam
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import backbone_params_from_jax, train_state_from_jax
from repro_torch.data.synthetic import make_token_stream, zipf_probs
from repro_torch.federated.driver import run_rounds
from repro_torch.federated.metering import CommMeter
from repro_torch.federated.scheduler import Scenario
from repro_torch.kernels import attention as k_attention
from repro_torch.kernels import gla as k_gla
from repro_torch.kernels import reparam as k_reparam
from repro_torch.kernels import rmsnorm as k_rmsnorm
from repro_torch.kernels import wire as k_wire
from repro_torch.launch import steps as TS
from repro_torch.launch import train as t_train
from repro_torch.models.backbone import attention as TA
from repro_torch.models.backbone import ssm as TSSM
from repro_torch.models.backbone import transformer as TT
from repro_torch.optim.adam import adam as t_adam
from repro_torch.tree import tree_leaves

J, B, S, LR = 2, 4, 16, 1e-3
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
METRIC_RTOL = 1e-5
ILL_GRAD = 1e-7  # |g| under which Adam's step amplifies rounding in g to O(lr)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def ref_draws(seed, shapes):
    """The reference step's ε_G, ε_L for ``seed``."""
    kG, kL = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 0))
    return [np.asarray(jax.random.normal(k, s, jnp.float32)) for k, s in zip((kG, kL), shapes)]


def batches(cfg, n, seed=3):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (n, B, S + 1)).astype(np.int32)
    return [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]


def to_torch_batch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def state_leaves(st):
    fields = (st.theta, st.eta_G, st.eta_L, st.opt_theta, st.opt_eta_G, st.opt_eta_L)
    if isinstance(st, TS.TrainState):
        return tree_leaves(fields)
    return jax.tree_util.tree_leaves(fields)


def _moments(st):
    return jax.tree_util.tree_leaves((st.opt_theta[0].mu, st.opt_eta_G[0].mu, st.opt_eta_L[0].mu))


def ill_elements(jold, jnew):
    """The parameter elements whose reference gradient at this step, read
    from Adam's first moment (g = (μ_t − b1 μ_{t−1}) / (1 − b1)), was
    under ``ILL_GRAD`` but not 0 (an exact 0 moves nothing)."""
    grads = [(_np(m1) - 0.9 * _np(m0)) / 0.1 for m0, m1 in zip(_moments(jold), _moments(jnew))]
    return [(np.abs(g) < ILL_GRAD) & (g != 0) for g in grads]


def assert_states_close(tstate, jstate, label, ill):
    got, want = state_leaves(tstate), state_leaves(jstate)
    assert len(got) == len(want) > 10
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert tuple(g.shape) == tuple(w.shape), (label, i)
        g, w = _np(g), _np(w)
        if i < len(ill):  # a parameter leaf: its ill-conditioned elements apart
            assert np.all(np.abs(g - w)[ill[i]] <= 2 * LR), (label, i)
            g, w = g[~ill[i]], w[~ill[i]]
        np.testing.assert_allclose(g, w, err_msg=f"{label} leaf {i}", **STEP_TOL)
    assert tstate.step == int(jstate.step)


def assert_metrics_close(tm, jm, label):
    assert list(tm) == sorted(jm), (list(tm), sorted(jm))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=METRIC_RTOL, atol=1e-6,
                                   err_msg=f"{label} {k}")


@pytest.fixture(scope="module", params=["qwen3-4b", "zamba2-7b"])
def sfvi(request):
    arch = request.param
    jcfg, tcfg = j_get_config(arch).reduced(), t_get_config(arch).reduced()
    jstate0, _ = JS.init_train_state(jax.random.PRNGKey(0), jcfg, J, lr=LR)
    jstep = jax.jit(JS.make_train_step(jcfg, J, lr=LR, remat=False))
    return arch, jcfg, tcfg, jax.tree_util.tree_map(np.asarray, jstate0), jstep


@pytest.mark.parametrize("masked", [False, True], ids=["all_silos", "silo_mask"])
@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_matches_jax(sfvi, steps, masked):
    arch, jcfg, tcfg, jstate, jstep = sfvi
    n_G, n_L = TS.latent_dims(tcfg)
    tstep = TS.make_train_step(tcfg, J, lr=LR, remat=True)
    mask = np.array([1.0, 0.0], np.float32) if masked else None
    for i, b in enumerate(batches(jcfg, steps)):
        eps_G, eps_L = ref_draws(i, [(n_G,), (J, n_L)])
        jold = jax.tree_util.tree_map(np.asarray, jstate)
        if masked:
            jstate, jm = jstep(jstate, b, jnp.int32(i), jnp.asarray(mask))
        else:
            jstate, jm = jstep(jstate, b, jnp.int32(i))
        ill = ill_elements(jold, jstate)
        tstate, tm = tstep(train_state_from_jax(jold, "cpu"), to_torch_batch(b), i,
                           silo_mask=None if mask is None else torch.from_numpy(mask),
                           draws=(torch.from_numpy(eps_G), torch.from_numpy(eps_L)))
        assert_metrics_close(tm, jm, f"{arch} step {i}")
        assert_states_close(tstate, jstate, f"{arch} step {i}", ill)
        assert all(bool(torch.isfinite(v)) for v in tm.values())


def test_eta_gradients_match_jax(sfvi):
    """After one step from a zero first moment, Adam's μ is (1 − b1)·g: the
    η_G and η_L gradients of the two packages, compared directly. The
    reparam kernel's own log q (d/d log σ = −1, d/dμ = 0) would give
    another gradient than the STL estimator's through z; this holds the
    port to the reference's."""
    arch, jcfg, tcfg, jstate0, jstep = sfvi
    n_G, n_L = TS.latent_dims(tcfg)
    b = batches(jcfg, 1, seed=9)[0]
    eps_G, eps_L = ref_draws(5, [(n_G,), (J, n_L)])
    jstate, _ = jstep(jstate0, b, jnp.int32(5))
    tstate, _ = TS.make_train_step(tcfg, J, lr=LR, remat=False)(
        train_state_from_jax(jstate0, "cpu"), to_torch_batch(b), 5,
        draws=(torch.from_numpy(eps_G), torch.from_numpy(eps_L)))
    for name in ("opt_eta_G", "opt_eta_L"):
        jmu, tmu = getattr(jstate, name)[0].mu, getattr(tstate, name)[0].mu
        for key in ("mu", "log_sigma"):
            want, got = _np(jmu[key]) / 0.1, _np(tmu[key]) / 0.1
            scale = float(np.abs(want).max())
            assert scale > 0
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7 * scale,
                                       err_msg=f"{arch} d loss / d {name[4:]}.{key}")


def test_train_step_updates_the_state_in_place(sfvi):
    _, jcfg, tcfg, jstate0, _ = sfvi
    n_G, n_L = TS.latent_dims(tcfg)
    state = train_state_from_jax(jstate0, "cpu")
    before = [t.clone() for t in state_leaves(state)]
    eps = [torch.from_numpy(e) for e in ref_draws(0, [(n_G,), (J, n_L)])]
    new, _ = TS.make_train_step(tcfg, J, lr=LR)(
        state, to_torch_batch(batches(jcfg, 1)[0]), 0, draws=eps)
    for a, c in zip(state_leaves(state), state_leaves(new), strict=True):
        assert a is c or a.dim() == 0  # every leaf but Adam's counts
    assert any(not torch.equal(a, b0) for a, b0 in zip(state_leaves(new), before))
    assert new.step == 1 and state.step == 0


def test_train_step_avg_matches_jax():
    """SFVI-Avg on reduced llama3.2-3b (tied embeddings), avg_every 2, 4
    steps (each from the reference's state before it): the barycenter (the
    combine's plain version on the CPU) on steps 2 and 4 only, the silos'
    η_G rows equal after it, the state as JAX's."""
    jcfg, tcfg = j_get_config("llama3.2-3b").reduced(), t_get_config("llama3.2-3b").reduced()
    n_G, n_L = TS.latent_dims(tcfg)
    key = jax.random.PRNGKey(0)
    s0, _ = JS.init_train_state(key, jcfg, J, lr=LR)
    eta_G = JS.init_eta_G_silo(key, jcfg, J)
    jstate = JS.TrainState(s0.theta, eta_G, s0.eta_L, s0.opt_theta, j_adam(LR).init(eta_G),
                           s0.opt_eta_L, s0.step)
    jstep = jax.jit(JS.make_train_step_avg(jcfg, J, 2, lr=LR, remat=False))
    tstep = TS.make_train_step_avg(tcfg, J, 2, lr=LR, remat=True)
    calls = []
    real = k_wire.fused_combine
    k_wire.fused_combine = lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw)
    try:
        for i, b in enumerate(batches(jcfg, 4)):
            eps_G, eps_L = ref_draws(i, [(J, n_G), (J, n_L)])
            jold = jax.tree_util.tree_map(np.asarray, jstate)
            jstate, jm = jstep(jstate, b, jnp.int32(i))
            ill = ill_elements(jold, jstate)
            n_before = len(calls)
            tstate, tm = tstep(train_state_from_jax(jold, "cpu"), to_torch_batch(b), i,
                               draws=(torch.from_numpy(eps_G), torch.from_numpy(eps_L)))
            due = (i + 1) % 2 == 0
            assert len(calls) - n_before == (2 if due else 0), (i, calls)
            assert_metrics_close(tm, jm, f"avg step {i}")
            assert_states_close(tstate, jstate, f"avg step {i}", ill)
            for k in ("mu", "log_sigma"):
                gap = float((tstate.eta_G[k][0] - tstate.eta_G[k][1]).abs().max())
                assert (gap < 1e-6) if due else (gap > 1e-6), (i, k, gap)
    finally:
        k_wire.fused_combine = real
    assert calls == [(J, n_G)] * 4


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-7b"])
def test_forward_remat_matches_jax(arch):
    """Logits and the gradient of a fixed projection of them, both remat
    settings against JAX's forward (remat=True, ``jax.checkpoint``)."""
    jcfg, tcfg = j_get_config(arch).reduced(), t_get_config(arch).reduced()
    jparams = JT.init_params(jax.random.PRNGKey(2), jcfg)
    tokens = batches(jcfg, 1, seed=1)[0]["tokens"]
    w = np.random.default_rng(0).normal(size=(B, S, jcfg.vocab_size)).astype(np.float32)

    def jloss(p):
        logits, _, h = JT.forward(p, jcfg, {"tokens": jnp.asarray(tokens)}, remat=True)
        return jnp.sum(logits * w) + jnp.sum(h), logits

    (_, jlogits), jgrad = jax.value_and_grad(jloss, has_aux=True)(jparams)
    jgrad = jax.tree_util.tree_leaves(jgrad)
    for remat in (True, False):
        tparams = backbone_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        leaves = tree_leaves(tparams)
        for leaf in leaves:
            leaf.requires_grad_(True)
        logits, _, h = TT.forward(tparams, tcfg, {"tokens": torch.from_numpy(tokens).long()},
                                  remat=remat)
        np.testing.assert_allclose(_np(logits), _np(jlogits), atol=5e-4, rtol=1e-3)
        (torch.sum(logits * torch.from_numpy(w)) + torch.sum(h)).backward()
        for i, (leaf, g) in enumerate(zip(leaves, jgrad, strict=True)):
            want = _np(g)
            np.testing.assert_allclose(_np(leaf.grad), want, rtol=1e-3,
                                       atol=1e-5 * float(np.abs(want).max() + 1e-30),
                                       err_msg=f"{arch} remat={remat} grad leaf {i}")


ATTN_CASES = {
    "causal": dict(causal=True),
    "window_5": dict(causal=True, sliding_window=5),
    "bidirectional": dict(causal=False),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention_matches_jax(case):
    """Several q and kv chunks with padding on both (Sq 37 in chunks of 16,
    Skv 37 in chunks of 8), against the JAX package's chunked and the
    port's full attention; and a q_offset slice against the full rows."""
    kw = ATTN_CASES[case]
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(2, 37, 4, 16)).astype(np.float32) for _ in range(3))
    want = JA.chunked_attention(*map(jnp.asarray, (q, k, v)), q_chunk=16, kv_chunk=8, **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = TA.chunked_attention(tq, tk, tv, q_chunk=16, kv_chunk=8, **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(TA.full_attention(tq, tk, tv, **kw)), _np(want),
                               atol=1e-5, rtol=1e-4)
    tail = TA.chunked_attention(tq[:, 30:], tk, tv, q_chunk=4, kv_chunk=8, q_offset=30, **kw)
    jtail = JA.full_attention(*map(jnp.asarray, (q[:, 30:], k, v)), q_offset=30, **kw)
    np.testing.assert_allclose(_np(tail), _np(jtail), atol=1e-5, rtol=1e-4)


def test_attention_block_takes_chunked_past_its_threshold(monkeypatch):
    """The train mode's attention is chunked past ``CHUNKED_MIN_S`` tokens
    (2,048, as the reference): with the threshold lowered, a 24-token block
    equals the reference's ``attention_block(use_chunked=True)``."""
    jcfg, tcfg = j_get_config("qwen3-4b").reduced(), t_get_config("qwen3-4b").reduced()
    assert TA.CHUNKED_MIN_S == 2048
    jp = JA.attn_init(jax.random.PRNGKey(4), jcfg)
    tp = backbone_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = np.random.default_rng(2).normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24))
    want = JA.attention_block(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), use_chunked=True)
    calls = []
    real = TA.chunked_attention
    monkeypatch.setattr(TA, "CHUNKED_MIN_S", 8)
    monkeypatch.setattr(TA, "chunked_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = TA.attention_block(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos.copy()))
    assert calls == [1]
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-4)


def test_chunked_gla_matches_jax():
    """y and the gradient of a fixed projection of y (q, k, v, log_a) for
    S = 50 in chunks of 16 (padded), against the JAX package's."""
    rng = np.random.default_rng(6)
    q, k = (rng.normal(size=(2, 50, 3, 8)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(2, 50, 3, 6)).astype(np.float32)
    log_a = -rng.uniform(0.01, 0.5, size=(2, 50, 3)).astype(np.float32)
    w = rng.normal(size=(2, 50, 3, 6)).astype(np.float32)
    args = (q, k, v, log_a)
    jy, jgrads = jax.value_and_grad(
        lambda *a: jnp.sum(JSSM.chunked_gla(*a, chunk=16) * w), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, args))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = TSSM.chunked_gla(*targs, chunk=16)
    np.testing.assert_allclose(_np(y), _np(JSSM.chunked_gla(*map(jnp.asarray, args), chunk=16)),
                               atol=1e-5, rtol=1e-4)
    torch.sum(y * torch.from_numpy(w)).backward()
    for t, g in zip(targs, jgrads, strict=True):
        assert bool(torch.isfinite(t.grad).all())
        want = _np(g)
        np.testing.assert_allclose(_np(t.grad), want, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want).max()))


def test_train_step_launches_no_backbone_kernel_and_reparam_with_grad(monkeypatch):
    """The CUDA route of the flash, GLA and RMSNorm wrappers forced on CPU
    tensors (as ``tests/test_torch_backbone_kernels.py``), their library a
    recorder: an SFVI step of zamba2 (attention + mamba2) and of qwen3
    (qk-norm) calls none of them, and calls ``reparam_stl`` twice with grad
    on and its backward twice."""
    launched = []

    class Lib:
        def __getattr__(self, name):
            launched.append(name)
            raise AssertionError(f"backbone kernel {name} launched in training")

    for mod in (k_attention, k_gla, k_rmsnorm):
        monkeypatch.setattr(mod, "_on_cuda", lambda x: True)
        monkeypatch.setattr(mod, "_lib", lambda *a, **kw: Lib())
    fwd, bwd = [], []
    real_fwd, real_bwd = TS.reparam_stl, k_reparam.reparam_bwd

    def spy_fwd(mu, ls, eps, *a):
        fwd.append((torch.is_grad_enabled(), mu.requires_grad, ls.requires_grad, mu.shape))
        return real_fwd(mu, ls, eps, *a)

    monkeypatch.setattr(TS, "reparam_stl", spy_fwd)
    monkeypatch.setattr(k_reparam, "reparam_bwd", lambda *a: bwd.append(1) or real_bwd(*a))
    for arch in ("zamba2-7b", "qwen3-4b"):
        cfg = t_get_config(arch).reduced()
        n_G, n_L = TS.latent_dims(cfg)
        fwd.clear()
        bwd.clear()
        state, _ = TS.init_train_state(torch.Generator().manual_seed(0), cfg, J)
        tok = torch.randint(0, cfg.vocab_size, (B, S + 1),
                            generator=torch.Generator().manual_seed(1))
        _, m = TS.make_train_step(cfg, J)(state, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}, 0)
        assert bool(torch.isfinite(m["loss"]))
        assert fwd == [(True, True, True, (n_G,)), (True, True, True, (J * n_L,))], fwd
        assert len(bwd) == 2
    assert launched == []


def test_run_rounds_matches_reference():
    """Bytes, ε and history of the two loops on one schedule: SFVI-Avg's
    cadence (an exchange every 3rd round) under z 1.1, C 1, δ 1e-5."""
    hist = {}
    for name, loop, meter, scen in (("jax", j_run_rounds, JCommMeter(), JScenario),
                                    ("port", run_rounds, CommMeter(), Scenario)):
        privacy = scen(algorithm="sfvi_avg", dp_noise=1.1, dp_clip=1.0).privacy()
        seen = []
        state, h = loop(lambda st, b, i: (st + b, {"loss": float(st + b)}), 0, range(7),
                        meter=meter, bytes_per_round=(1234, 567), privacy=privacy,
                        exchanges_per_round=lambda i: int((i + 1) % 3 == 0),
                        on_metrics=lambda i, m, st: seen.append((i, st)))
        hist[name] = (state, h, meter.total, meter.rounds, seen)
    (js, jh, jt, jr, jseen), (ts, th, tt, tr, tseen) = hist["jax"], hist["port"]
    assert (ts, tt, tr, tseen) == (js, jt, jr, jseen) == (21, 7 * 1801, 7, tseen)
    assert list(th) == list(jh) == ["loss", "epsilon"]
    assert th["loss"] == jh["loss"]
    np.testing.assert_allclose(th["epsilon"], jh["epsilon"], rtol=1e-9, atol=1e-9)
    assert th["epsilon"][0] == 0.0 and th["epsilon"][-1] > 0


DUMP_ARGS = [
    [],
    ["--arch", "zamba2-7b", "--algo", "avg", "--avg-every", "3", "--dp-noise", "0.7"],
    ["--arch", "llama3.2-3b", "--full", "--silos", "2", "--batch", "4", "--lr", "3e-4",
     "--mesh", "silo=2,model=2"],
]


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


@pytest.mark.parametrize("argv", DUMP_ARGS, ids=["defaults", "avg_dp", "full_mesh"])
def test_cli_dump_spec_matches_reference(argv):
    assert _stdout(t_train.main, argv + ["--dump-spec"]) == _stdout(j_train.main,
                                                                    argv + ["--dump-spec"])


def _ref_bytes(algo, arch, silos, avg_every):
    """The reference CLI's formula (``src/repro/launch/train.py:180-187``)
    on the reference's initial state."""
    cfg = j_get_config(arch).reduced()
    key = jax.random.PRNGKey(0)
    state, _ = JS.init_train_state(key, cfg, silos)
    eta_G = JS.init_eta_G_silo(key, cfg, silos) if algo == "avg" else state.eta_G
    theta_bytes = JNoCompression().wire_bytes({"theta": state.theta})
    eta_bytes = JNoCompression().wire_bytes({"eta_G": eta_G})
    per_silo = theta_bytes + (eta_bytes // silos if algo == "avg" else eta_bytes)
    return int(silos * per_silo * (1.0 if algo == "sfvi" else 1.0 / avg_every))


@pytest.mark.parametrize("algo", ["sfvi", "avg"])
def test_cli_bytes_per_round_match_reference(algo):
    """A reduced 3-step CPU run of the port's CLI: its bytes a round equal
    the reference formula's exactly, and its printed comm line the
    reference CLI's; the losses are finite."""
    argv = ["--arch", "qwen3-4b", "--steps", "3", "--algo", algo, "--avg-every", "2",
            "--log-every", "1"]
    cfg = t_get_config("qwen3-4b").reduced()
    state, _ = t_train.setup(cfg, algo, 4, 1e-3, 2, torch.device("cpu"))
    assert t_train.bytes_per_round(state, algo, 4, 2) == _ref_bytes(algo, "qwen3-4b", 4, 2)
    out = _stdout(t_train.main, argv + ["--device", "cpu"])
    ref = _stdout(j_train.main, argv)
    done = [ln for ln in out.splitlines() if ln.startswith("done:")]
    ref_done = [ln for ln in ref.splitlines() if ln.startswith("done:")]
    assert len(done) == len(ref_done) == 1
    assert done[0].split("; ")[1] == ref_done[0].split("; ")[1]
    assert out.splitlines()[0] == ref.splitlines()[0]  # arch, params, silos, algo
    steps = [ln for ln in out.splitlines() if ln.startswith("step")]
    ref_steps = [ln for ln in ref.splitlines() if ln.startswith("step")]
    def keys(lines):
        return [[kv.split("=")[0] for kv in ln.split()[2:-1]] for ln in lines]

    assert keys(steps) == keys(ref_steps) and len(steps) == 3
    assert all(np.isfinite(float(ln.split("loss=")[1].split()[0])) for ln in steps)


def test_cli_refuses_a_mesh():
    """A mesh of several devices in one process (the reference's form) is
    refused, naming the process flags that span it."""
    with pytest.raises(SystemExit, match="--num-processes 2"):
        t_train.main(["--mesh", "silo=2", "--device", "cpu", "--steps", "1"])


def test_token_stream_probabilities_and_range():
    """The Zipf(1.2) probabilities are the reference's (float64, normalized,
    then float32); the stream is int32 in range, seeded, and its counts of
    the commonest ids agree with the reference's stream's within sampling
    error (the streams themselves differ: torch's generator, not threefry)."""
    V, n = 512, 200_000
    ranks = np.arange(1, V + 1, dtype=np.float64)
    want = ranks ** -1.2
    want /= want.sum()
    assert np.array_equal(zipf_probs(V), want.astype(np.float32))
    toks = make_token_stream(torch.Generator().manual_seed(1), n, V)
    again = make_token_stream(torch.Generator().manual_seed(1), n, V)
    assert toks.dtype == np.int32 and toks.shape == (n,) and np.array_equal(toks, again)
    assert toks.min() >= 0 and toks.max() < V
    ref = j_token_stream(jax.random.PRNGKey(1), n, V)
    got_f, ref_f = (np.bincount(t, minlength=V)[:20] / n for t in (toks, ref))
    np.testing.assert_allclose(got_f, ref_f, atol=5 * np.sqrt(want[0] / n))
    np.testing.assert_allclose(got_f, want[:20], atol=5 * np.sqrt(want[0] / n))


def test_bf16_adam_matches_jax():
    """Adam on a bfloat16 leaf (μ kept in bfloat16, ν in float32): three
    updates leave θ and μ bit-equal to the reference's, ν within 1e-6."""
    rng = np.random.default_rng(0)
    jp = jnp.asarray(rng.normal(size=(4096,)), jnp.bfloat16)
    tp = backbone_params_from_jax({"w": np.asarray(jp)}, "cpu")["w"]
    jo, to = j_adam(1e-3), t_adam(1e-3)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(3):
        g = jnp.asarray(rng.normal(size=(4096,)) * 10.0 ** rng.uniform(-8, 0, 4096), jnp.bfloat16)
        tg = backbone_params_from_jax({"g": np.asarray(g)}, "cpu")["g"]
        ju, js = jo.update(g, js)
        tu, ts = to.update(tg, ts)
        jp, tp = jp + ju.astype(jp.dtype), tp + tu.to(tp.dtype)
        assert tu.dtype == torch.float32
        assert np.array_equal(tp.view(torch.int16).numpy(), np.asarray(jp).view(np.int16))
        assert np.array_equal(ts[0].mu.view(torch.int16).numpy(),
                              np.asarray(js[0].mu).view(np.int16))
        np.testing.assert_allclose(ts[0].nu.numpy(), np.asarray(js[0].nu), rtol=1e-6)


def test_train_state_from_jax_bit_exact():
    jcfg = dataclasses.replace(j_get_config("zamba2-7b").reduced(), dtype="bfloat16")
    jstate, _ = JS.init_train_state(jax.random.PRNGKey(1), jcfg, 3)
    jnp_state = jax.tree_util.tree_map(np.asarray, jstate)
    tstate = train_state_from_jax(jnp_state, "cpu")
    n_bf16 = 0
    for t, j in zip(state_leaves(tstate), state_leaves(jnp_state), strict=True):
        if j.dtype.name == "bfloat16":
            n_bf16 += 1
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(), j.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), j)
    assert n_bf16 > 10 and tstate.step == 0
    assert tstate.opt_theta[0].count.dtype == torch.int32


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _shape_bytes(tree):
    return sum(int(np.prod(x.shape)) * jnp.dtype(x.dtype).itemsize
               for x in jax.tree_util.tree_leaves(tree))


def test_chip_smoke_cells_match_reference_sizes():
    """``chip_smoke.py``'s train cells (parameters, bytes a round) and dense
    serve cells (parameters) against the reference's ``init_train_state`` /
    ``init_params`` on each config at full width (``jax.eval_shape``: shapes
    only) and its CLI's bytes formula."""
    smoke = _chip_smoke()
    key = jax.random.PRNGKey(0)
    for (label, arch, layers, algo, _, avg_every, want_params, want_bytes, J, *_) \
            in smoke.TRAIN_RUNS:
        cfg = dataclasses.replace(j_get_config(arch), num_layers=layers)
        st = jax.eval_shape(lambda: JS.init_train_state(key, cfg, J)[0])
        eta_G = (jax.eval_shape(lambda: JS.init_eta_G_silo(key, cfg, J))
                 if algo == "avg" else st.eta_G)
        params = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(st.theta))
        theta_b, eta_b = _shape_bytes(st.theta), _shape_bytes(eta_G)
        per_silo = theta_b + (eta_b // J if algo == "avg" else eta_b)
        assert (params, int(J * per_silo * (1.0 if algo == "sfvi" else 1.0 / avg_every))) \
            == (want_params, want_bytes), label
    layers = {arch: n for _, arch, n, *_ in smoke.SERVE_RUNS}
    for arch, want in smoke.SERVE_PARAMS.items():
        cfg = dataclasses.replace(j_get_config(arch), num_layers=layers[arch])
        shapes = jax.eval_shape(lambda: JT.init_params(key, cfg))
        assert sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes)) == want, arch
