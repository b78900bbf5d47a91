"""The port's MoE block (olmoe-1b-7b, phi3.5-moe) against the JAX package,
on the CPU.

* the configs equal the reference's field for field; their full-size
  parameter counts equal ``jax.eval_shape(init_params)``'s (the port's
  counted on fake tensors, nothing allocated);
* ``moe_block`` (3 groups of 32 tokens; capacity factor 0.5, where tokens
  are dropped, and 8.0, where none is) and ``moe_block_dense`` on the
  reduced configs (E 4, k 2, f32) with the reference's parameters: the
  routing (``expert_idx``) equal first, then the dispatch and combine
  masks equal, ``y`` within atol 1e-5 / rtol 1e-4, ``aux`` within 1e-6,
  and the gradients of a fixed projection of ``y`` plus ``aux`` (router,
  experts, input) within rtol 1e-4, atol 1e-6 of the largest;
* ``forward``, ``prefill`` and four ``decode_step``s of the 2-layer
  reduced models with the reference's parameters (atol 5e-4, rtol 1e-3,
  as ``tests/test_torch_dense_configs.py``), each MoE call's routing equal
  to the reference's on its own input (the reference run eagerly under
  ``jax.disable_jit`` so that its block inputs are concrete);
* one SFVI step (olmoe) and two SFVI-Avg steps (phi3.5-moe, a barycenter
  on the second) with the reference's draws injected, held as
  ``tests/test_torch_train.py`` holds them: loss, ``aux_moe`` (non-zero
  here) and metrics rtol 1e-5, every θ / η / Adam leaf rtol 1e-4, atol
  1e-6, except parameter elements whose gradient was under
  ``MOE_ILL_GRAD`` (1e-6, where that file's is 1e-7: see there), held to
  2·lr; the port's loss is the reference's objective at ``l0_weight`` 1;
* bf16 parameters and train states carry the ``moe`` leaves across bit
  for bit (router f32, experts bf16);
* the serve and train CLIs on the reduced olmoe.
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
from repro.models.backbone import moe as JM
from repro.models.backbone import transformer as JT
from repro.models.backbone.bayes import latent_dims as j_latent_dims
from repro.optim.adam import adam as j_adam
from repro_torch.configs import ARCH_NAMES, get_config as t_get_config
from repro_torch.convert import backbone_params_from_jax, train_state_from_jax
from repro_torch.launch import serve_backbone as t_serve
from repro_torch.launch import steps as TS
from repro_torch.launch import train as t_train
from repro_torch.models.backbone import moe as TM
from repro_torch.models.backbone import transformer as TT
from repro_torch.models.backbone.bayes import latent_dims as t_latent_dims
from repro_torch.tree import tree_leaves
from test_torch_train import (
    LR,
    _moments,
    assert_metrics_close,
    assert_states_close,
    ref_draws,
    to_torch_batch,
)

MOE = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]
TOL = dict(atol=5e-4, rtol=1e-3)
BLOCK_TOL = dict(atol=1e-5, rtol=1e-4)
B, S, GEN = 2, 20, 4
J, TB, TS_LEN = 2, 4, 16  # the train steps' silos, batch, sequence
# The MoE models' θ gradients part between the packages by up to ~7e-8
# absolute (about 1e-6 of each leaf's largest; the dense models' ~1e-8),
# so Adam's first step g / (|g| + 1e-8) turns that gap into up to ~lr for
# |g| under 1e-6 (``tests/test_torch_train.py``'s rule, at this gap).
MOE_ILL_GRAD = 1e-6


def ill_elements(jold, jnew):
    """Parameter elements whose reference gradient this step was under
    ``MOE_ILL_GRAD`` but not 0; held to 2·lr by ``assert_states_close``
    (their gradients, in Adam's μ, keep the full tolerance). At most 4 +
    2 % of a leaf's elements (here up to 60 of lm_head's 65,536 and 33 of
    the silo-stacked η_G's 2,562)."""
    grads = [(np.asarray(m1, np.float32) - 0.9 * np.asarray(m0, np.float32)) / 0.1
             for m0, m1 in zip(_moments(jold), _moments(jnew))]
    ill = [(np.abs(g) < MOE_ILL_GRAD) & (g != 0) for g in grads]
    assert all(m.sum() <= 4 + m.size // 50 for m in ill), str([(int(m.sum()), m.size) for m in ill])
    return ill


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _tp(jparams):
    return backbone_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("arch", MOE)
def test_config_matches_reference_field_for_field(arch):
    assert arch in ARCH_NAMES
    j, t = j_get_config(arch), t_get_config(arch)
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("bayes", "perf"):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name
    assert t.is_moe and TT.unit_structure(t) == JT.unit_structure(j)
    assert t_latent_dims(t) == j_latent_dims(j)
    assert dataclasses.asdict(t.reduced()) == {
        k: v for k, v in dataclasses.asdict(j.reduced()).items() if k != "use_pallas"}


def _port_param_count(cfg) -> int:
    with FakeTensorMode():
        return TT.param_count(TT.init_params(torch.Generator(), cfg))


def _ref_param_count(cfg) -> int:
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), cfg))
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))


@pytest.mark.parametrize("arch", MOE)
def test_full_size_parameter_counts_match_reference(arch):
    """At full width and depth, and at the depths ``chip_smoke.py`` cuts to."""
    for layers in (None, 1, 8):
        j, t = j_get_config(arch), t_get_config(arch)
        if layers:
            j, t = (dataclasses.replace(c, num_layers=layers) for c in (j, t))
        assert _port_param_count(t) == _ref_param_count(j), (arch, layers)
    assert _port_param_count(t_get_config(arch)) == {
        "olmoe-1b-7b": 6_919_100_416, "phi3.5-moe-42b-a6.6b": 41_872_527_360}[arch]


def _block_setup(arch, cf, seed=1):
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), capacity_factor=cf)
    tcfg = dataclasses.replace(t_get_config(arch).reduced(), capacity_factor=cf)
    jp = JM.moe_init(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).normal(size=(2, 48, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, _tp(jp), x


def _grads(tp, tcfg, x, w, fn):
    leaves = [tp["router"], tp["w_down"], tp["w_gate"], tp["w_up"], torch.from_numpy(x)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    y, aux = fn(tp, tcfg, leaves[-1])
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    return y, aux, [leaf.grad for leaf in leaves]


def _assert_grads_close(got, want, label):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        w = _np(w)
        assert float(np.abs(w).max()) > 0, (label, i)
        np.testing.assert_allclose(_np(g), w, rtol=1e-4, atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=f"{label} grad {i}")


@pytest.mark.parametrize("cf", [0.5, 8.0], ids=["drops", "no_drops"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_jax(arch, cf):
    jcfg, tcfg, jp, tp, x = _block_setup(arch, cf)
    gs = 32
    G, E, k = x.shape[0] * x.shape[1] // gs, jcfg.num_experts, jcfg.num_experts_per_tok
    capacity = max(int(gs * k / E * cf), 1)
    xg = x.reshape(G, gs, -1)
    _, jgates, jidx = jax.vmap(lambda a: JM._route(jp["router"], a, E, k))(jnp.asarray(xg))
    _, tgates, tidx = TM._route(tp["router"], torch.from_numpy(xg), E, k)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))  # the routing first
    np.testing.assert_allclose(_np(tgates), _np(jgates), atol=1e-6, rtol=1e-5)
    kept = 0
    for g in range(G):
        jd, jc = JM._dispatch_masks(jidx[g], jgates[g], E, capacity)
        td, tc = TM._dispatch_masks(tidx[g], torch.from_numpy(np.asarray(jgates[g])), E,
                                    capacity)  # the reference's gates: masks exactly equal
        assert np.array_equal(td.numpy(), np.asarray(jd))
        assert np.array_equal(tc.numpy(), np.asarray(jc))
        kept += int(td.sum())
    assert (kept < G * gs * k) if cf < 1 else (kept == G * gs * k), (cf, kept)

    w = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = JM.moe_block(p, jcfg, xx, group_size=gs)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    ty, taux, tgrads = _grads(tp, tcfg, x, w, lambda p, c, xx: TM.moe_block(p, c, xx, gs))
    np.testing.assert_allclose(_np(ty), _np(jy), **BLOCK_TOL)
    assert abs(float(taux.detach()) - float(jaux)) <= 1e-6
    _assert_grads_close(tgrads, [jgp[n] for n in ("router", "w_down", "w_gate", "w_up")] + [jgx],
                        f"{arch} cf={cf}")
    if cf > 1:  # no drops: the capacity route equals every expert's dense route
        yd, _ = TM.moe_block_dense(tp, tcfg, torch.from_numpy(x))
        np.testing.assert_allclose(_np(ty), _np(yd), **BLOCK_TOL)


@pytest.mark.parametrize("arch", MOE)
def test_moe_block_dense_matches_jax(arch):
    jcfg, tcfg, jp, tp, x = _block_setup(arch, 1.25, seed=3)
    E, k = jcfg.num_experts, jcfg.num_experts_per_tok
    xf = x.reshape(-1, x.shape[-1])
    _, _, jidx = JM._route(jp["router"], jnp.asarray(xf), E, k)
    _, _, tidx = TM._route(tp["router"], torch.from_numpy(xf), E, k)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    w = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = JM.moe_block_dense(p, jcfg, xx)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    ty, taux, tgrads = _grads(tp, tcfg, x, w, TM.moe_block_dense)
    np.testing.assert_allclose(_np(ty), _np(jy), **BLOCK_TOL)
    assert abs(float(taux.detach()) - float(jaux)) <= 1e-6
    _assert_grads_close(tgrads, [jgp[n] for n in ("router", "w_down", "w_gate", "w_up")] + [jgx],
                        f"{arch} dense")


def test_route_takes_injected_experts():
    """``_route(expert_idx=)`` (the card checks' injection) keeps the given
    experts and gates them with the router's renormalized probabilities."""
    _, tcfg, _, tp, x = _block_setup("olmoe-1b-7b", 1.25)
    xf = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    E, k = tcfg.num_experts, tcfg.num_experts_per_tok
    probs, gates, idx = TM._route(tp["router"], xf, E, k)
    flipped = idx.flip(-1).roll(1, 0)
    _, g2, i2 = TM._route(tp["router"], xf, E, k, expert_idx=flipped)
    assert torch.equal(i2, flipped)
    want = probs.gather(-1, flipped)
    torch.testing.assert_close(g2, want / want.sum(-1, keepdim=True))
    assert torch.equal(TM._route(tp["router"], xf, E, k, expert_idx=idx)[1], gates)


class RouteRecorder:
    """Each MoE call's routing in one package: the port's through its
    transformer's ``moe_block`` / ``moe_block_dense`` names, the
    reference's likewise (run under ``jax.disable_jit``, its inputs are
    concrete arrays), each routed here by that package's ``_route`` per
    group as its block does."""

    def __init__(self, monkeypatch, module, route, to_np):
        self.calls = []
        for name in ("moe_block", "moe_block_dense"):
            real = getattr(module, name)

            def wrapped(p, cfg, x, *a, _real=real, _dense=name.endswith("dense"), **kw):
                T, D = x.shape[0] * x.shape[1], x.shape[2]
                gs = T if _dense else min(1024, T)
                xs = x.reshape(T // gs, gs, D)
                self.calls.append(np.stack([to_np(route(p["router"], xs[g], cfg.num_experts,
                                                        cfg.num_experts_per_tok)[2])
                                            for g in range(T // gs)]))
                return _real(p, cfg, x, *a, **kw)

            monkeypatch.setattr(module, name, wrapped)


@pytest.fixture(scope="module", params=MOE)
def model(request):
    arch = request.param
    jcfg, tcfg = j_get_config(arch).reduced(), t_get_config(arch).reduced()
    jparams = JT.init_params(jax.random.PRNGKey(11), jcfg)
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, S + GEN)).astype(np.int32)
    return arch, jcfg, tcfg, jparams, _tp(jparams), tokens


def _recorders(monkeypatch):
    port = RouteRecorder(monkeypatch, TT, TM._route, lambda a: a.numpy())
    ref = RouteRecorder(monkeypatch, JT, JM._route, np.asarray)
    return port, ref


def _same_routing(port, ref, n):
    assert len(port.calls) == len(ref.calls) == n, (len(port.calls), len(ref.calls), n)
    for i, (a, b) in enumerate(zip(port.calls, ref.calls)):
        assert np.array_equal(a, b), f"MoE call {i}: routing differs"


def test_moe_forward_matches_jax(model, monkeypatch):
    arch, jcfg, tcfg, jparams, tparams, tokens = model
    port, ref = _recorders(monkeypatch)
    with jax.disable_jit():
        want, jaux, jh = JT.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens[:, :S])},
                                    remat=False)
    got, taux, th = TT.forward(tparams, tcfg, {"tokens": torch.from_numpy(tokens[:, :S]).long()},
                               remat=False)
    _same_routing(port, ref, tcfg.num_layers)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    assert float(taux) > 0 and abs(float(taux) - float(jaux)) <= 1e-6 * float(jaux)


def test_moe_prefill_and_decode_match_jax(model, monkeypatch):
    arch, jcfg, tcfg, jparams, tparams, tokens = model
    port, ref = _recorders(monkeypatch)
    max_len = S + GEN
    with jax.disable_jit():
        jl, jc, _ = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens[:, :S])}, max_len)
    tl, tc, _ = TT.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens[:, :S]).long()},
                           max_len)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for step in range(GEN):
        tok = tokens[:, S + step:S + step + 1]
        with jax.disable_jit():
            jl, jc, _ = JT.decode_step(jparams, jcfg, jnp.asarray(tok), jc)
        tl, tc, _ = TT.decode_step(tparams, tcfg, torch.from_numpy(tok).long(), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=f"decode step {step}", **TOL)
    _same_routing(port, ref, tcfg.num_layers * (1 + GEN))
    assert int(tc["t"]) == S + GEN


def _train_batches(cfg, n, seed=3):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (n, TB, TS_LEN + 1)).astype(np.int32)
    return [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]


def test_sfvi_step_with_moe_matches_jax():
    """One SFVI step of the reduced olmoe (remat on the port's side, so the
    aux loss crosses ``torch.utils.checkpoint``): the reference's objective
    at ``l0_weight`` 1, with a non-zero load-balance term."""
    jcfg, tcfg = j_get_config("olmoe-1b-7b").reduced(), t_get_config("olmoe-1b-7b").reduced()
    assert TS.AUX_LOSS_WEIGHT == JS.AUX_LOSS_WEIGHT
    n_G, n_L = TS.latent_dims(tcfg)
    jstate, _ = JS.init_train_state(jax.random.PRNGKey(0), jcfg, J, lr=LR)
    jold = jax.tree_util.tree_map(np.asarray, jstate)
    b = _train_batches(jcfg, 1)[0]
    jstate, jm = jax.jit(JS.make_train_step(jcfg, J, lr=LR, remat=False))(jold, b, jnp.int32(0))
    eps = [torch.from_numpy(e) for e in ref_draws(0, [(n_G,), (J, n_L)])]
    tstate, tm = TS.make_train_step(tcfg, J, lr=LR, remat=True)(
        train_state_from_jax(jold, "cpu"), to_torch_batch(b), 0, draws=eps)
    assert float(jm["aux_moe"]) > 0.5
    assert_metrics_close(tm, jm, "olmoe sfvi")
    assert_states_close(tstate, jstate, "olmoe sfvi", ill_elements(jold, jstate))
    want = -float(tm["elbo"]) / (TB * TS_LEN) + TS.AUX_LOSS_WEIGHT * float(tm["aux_moe"])
    assert abs(float(tm["loss"]) - want) <= 1e-6 * abs(want)


def test_sfvi_avg_steps_with_moe_match_jax():
    """SFVI-Avg on the reduced phi3.5-moe, ``avg_every`` 2, 2 steps (each
    from the reference's state before it): the aux term in the local
    objective, the barycenter on step 2, the state as JAX's."""
    arch = "phi3.5-moe-42b-a6.6b"
    jcfg, tcfg = j_get_config(arch).reduced(), t_get_config(arch).reduced()
    n_G, n_L = TS.latent_dims(tcfg)
    key = jax.random.PRNGKey(0)
    s0, _ = JS.init_train_state(key, jcfg, J, lr=LR)
    eta_G = JS.init_eta_G_silo(key, jcfg, J)
    jstate = JS.TrainState(s0.theta, eta_G, s0.eta_L, s0.opt_theta, j_adam(LR).init(eta_G),
                           s0.opt_eta_L, s0.step)
    jstep = jax.jit(JS.make_train_step_avg(jcfg, J, 2, lr=LR, remat=False))
    tstep = TS.make_train_step_avg(tcfg, J, 2, lr=LR, remat=False)
    for i, b in enumerate(_train_batches(jcfg, 2, seed=6)):
        eps_G, eps_L = ref_draws(i, [(J, n_G), (J, n_L)])
        jold = jax.tree_util.tree_map(np.asarray, jstate)
        jstate, jm = jstep(jstate, b, jnp.int32(i))
        tstate, tm = tstep(train_state_from_jax(jold, "cpu"), to_torch_batch(b), i,
                           draws=(torch.from_numpy(eps_G), torch.from_numpy(eps_L)))
        assert_metrics_close(tm, jm, f"phi3.5 avg step {i}")
        assert_states_close(tstate, jstate, f"phi3.5 avg step {i}", ill_elements(jold, jstate))
    assert float((tstate.eta_G["mu"][0] - tstate.eta_G["mu"][1]).abs().max()) < 1e-6


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-vl-2b"])
def test_bf16_params_and_train_state_convert_bit_for_bit(arch):
    """The ``moe`` leaves (router f32, experts bf16) and ``vision_proj``
    cross ``backbone_params_from_jax`` and ``train_state_from_jax``."""
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), dtype="bfloat16")
    jstate, _ = JS.init_train_state(jax.random.PRNGKey(0), jcfg, J, lr=LR)
    jnp_state = jax.tree_util.tree_map(np.asarray, jstate)
    tparams = backbone_params_from_jax(jnp_state.theta, "cpu")
    tstate = train_state_from_jax(jnp_state, "cpu")
    moe = tparams["units"]["slot0"].get("moe")
    if jcfg.is_moe:
        assert moe["router"].dtype == torch.float32
        assert {moe[k].dtype for k in ("w_gate", "w_up", "w_down")} == {torch.bfloat16}
    else:
        assert moe is None and tparams["vision_proj"].dtype == torch.bfloat16
    trees = [(tparams, jnp_state.theta), (tstate.theta, jnp_state.theta),
             (tstate.opt_theta[0].mu, jnp_state.opt_theta[0].mu),
             (tstate.opt_theta[0].nu, jnp_state.opt_theta[0].nu)]
    for got, want in trees:
        for t, j in zip(tree_leaves(got), jax.tree_util.tree_leaves(want), strict=True):
            if j.dtype.name == "bfloat16":
                assert t.dtype == torch.bfloat16
                assert np.array_equal(t.view(torch.int16).numpy(), j.view(np.int16))
            else:
                assert np.array_equal(t.numpy(), j)
    # And the port's own init has the reference's tree of shapes and dtypes.
    ours = TT.init_params(torch.Generator().manual_seed(0),
                          dataclasses.replace(t_get_config(arch).reduced(), dtype="bfloat16"))
    assert [(tuple(a.shape), str(a.dtype)[6:]) for a in tree_leaves(ours)] == [
        (tuple(a.shape), a.dtype.name) for a in jax.tree_util.tree_leaves(jnp_state.theta)]


def test_serve_and_train_clis_run_olmoe_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        toks = t_serve.main(["--arch", "olmoe-1b-7b", "--device", "cpu", "--batch", "4",
                             "--prompt-len", "12", "--gen", "3", "--silos", "2"])
        state = t_train.main(["--arch", "olmoe-1b-7b", "--device", "cpu", "--steps", "2",
                              "--log-every", "1", "--batch", "4", "--silos", "2", "--seq", "16"])
    text = out.getvalue()
    assert tuple(toks.shape) == (4, 3) and "prefill" in text
    assert text.count("aux_moe=") == 2 and state.step == 2
