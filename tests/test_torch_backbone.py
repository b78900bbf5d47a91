"""The port's backbone (zamba2, qwen3) against the JAX package, on the CPU.

Reduced configs (``reduced()``: 2 layers, d_model 128, f32) with the JAX
package's own initial parameters, carried over leaf by leaf with
``repro_torch.convert.backbone_params_from_jax``, and one numpy-seeded
token batch. The port (kernel wrappers on their plain versions) against:

* ``transformer.forward`` on both JAX routes: jnp (``use_pallas=False``)
  and the Pallas kernels in interpret mode (``use_pallas=True``);
* ``transformer.prefill``: the last-position logits and the caches
  (attention ``k``, ``v``, ``pos``; mamba2 ``conv``, ``ssm``);
* four ``decode_step``s fed the same tokens.

Tolerance atol 5e-4, rtol 1e-3, as ``test_pallas_model_path_matches_jnp``.
Also: JAX bf16 parameters become bit-equal port tensors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.backbone import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import backbone_params_from_jax
from repro_torch.models.backbone import transformer as TT
from repro_torch.tree import tree_leaves

ARCHS = ["zamba2-7b", "qwen3-4b"]
TOL = dict(atol=5e-4, rtol=1e-3)
B, S, GEN = 2, 24, 4


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg = j_get_config(arch).reduced()
    tcfg = t_get_config(arch).reduced()
    jparams = JT.init_params(jax.random.PRNGKey(7), jcfg)
    tparams = backbone_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S + GEN)).astype(np.int32)
    return arch, jcfg, tcfg, jparams, tparams, tokens


def test_port_config_matches_reference(setup):
    _, jcfg, tcfg, *_ = setup
    for f in dataclasses.fields(tcfg):
        if f.name in ("bayes", "perf"):
            assert dataclasses.asdict(getattr(tcfg, f.name)) == dataclasses.asdict(
                getattr(jcfg, f.name))
        else:
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.block_pattern == jcfg.block_pattern
    assert TT.unit_structure(tcfg) == JT.unit_structure(jcfg)
    for full in (t_get_config(tcfg.name.replace("-smoke", "")),):
        assert TT.unit_structure(full) == JT.unit_structure(j_get_config(full.name))


@pytest.mark.parametrize("route", ["jnp", "pallas"])
def test_forward_matches_jax(setup, route):
    _, jcfg, tcfg, jparams, tparams, tokens = setup
    jcfg = dataclasses.replace(jcfg, use_pallas=route == "pallas")
    want, _, jh = JT.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens[:, :S])}, remat=False)
    got, aux, th = TT.forward(tparams, tcfg, {"tokens": torch.from_numpy(tokens[:, :S]).long()})
    assert got.shape == (B, S, tcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)


def _caches_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _caches_close(got[k], want[k], f"{path}/{k}")
        return
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    np.testing.assert_allclose(got, want, err_msg=path, **TOL)


def test_prefill_and_decode_match_jax(setup):
    _, jcfg, tcfg, jparams, tparams, tokens = setup
    max_len = S + GEN
    jl, jc, jh = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens[:, :S])}, max_len)
    tl, tc, th = TT.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens[:, :S]).long()},
                            max_len)
    assert tl.shape == (B, 1, tcfg.vocab_size)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    _caches_close(tc, jc)
    kinds = {k for k in tcfg.block_pattern}
    leaves = {p.rsplit("/", 1)[-1] for p in _paths(tc)}
    assert {"k", "v", "pos", "t"} <= leaves
    assert ("mamba2" in kinds) == ({"conv", "ssm"} <= leaves)

    decode = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    for step in range(GEN):
        tok = tokens[:, S + step:S + step + 1]
        jl, jc, _ = decode(jparams, jnp.asarray(tok), jc)
        tl, tc, _ = TT.decode_step(tparams, tcfg, torch.from_numpy(tok).long(), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=f"decode step {step}", **TOL)
    _caches_close(tc, jc)


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict (tuples are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _paths(tree):
    return list(_flat(tree))


def test_bf16_params_convert_bit_equal():
    jcfg = dataclasses.replace(j_get_config("zamba2-7b").reduced(), dtype="bfloat16")
    jparams = jax.tree_util.tree_map(np.asarray, JT.init_params(jax.random.PRNGKey(3), jcfg))
    tparams = backbone_params_from_jax(jparams, "cpu")
    jleaves = jax.tree_util.tree_leaves(jparams)
    tleaves = tree_leaves(tparams)
    assert len(jleaves) == len(tleaves) > 10
    n_bf16 = 0
    for j, t in zip(jleaves, tleaves, strict=True):
        assert tuple(t.shape) == j.shape
        if j.dtype.name == "bfloat16":
            n_bf16 += 1
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(), j.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), j)
    assert n_bf16 >= 10


def test_init_params_shapes_match_jax():
    for arch in ARCHS:
        jcfg = j_get_config(arch).reduced()
        tcfg = t_get_config(arch).reduced()
        jshapes = jax.tree_util.tree_map(lambda a: a.shape, jax.eval_shape(
            lambda k: JT.init_params(k, jcfg), jax.random.PRNGKey(0)))
        gen = torch.Generator().manual_seed(0)
        tparams = TT.init_params(gen, tcfg)
        flat_t = {p: tuple(t.shape) for p, t in _flat(tparams).items()}
        flat_j = {p: tuple(sh) for p, sh in _flat(jshapes).items()}
        assert flat_t == flat_j
        assert TT.param_count(tparams) == sum(int(np.prod(s)) for s in flat_j.values())


def test_empty_cache_inits_match_jax():
    from repro.models.backbone import attention as JA
    from repro.models.backbone import ssm as JS
    from repro_torch.models.backbone import attention as TA
    from repro_torch.models.backbone import ssm as TS

    for window in (None, 8):
        jcfg = dataclasses.replace(j_get_config("qwen3-4b").reduced(), sliding_window=window)
        tcfg = dataclasses.replace(t_get_config("qwen3-4b").reduced(), sliding_window=window)
        jc = JA.init_kv_cache(jcfg, 3, 20, jnp.float32)
        tc = TA.init_kv_cache(tcfg, 3, 20, torch.float32, "cpu")
        assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in jc.items()}
        assert all(not bool(v.any()) for v in tc.values()) and tc["pos"].dtype == torch.int32
    jcfg = j_get_config("zamba2-7b").reduced()
    tcfg = t_get_config("zamba2-7b").reduced()
    jp = JS.mamba2_init(jax.random.PRNGKey(0), jcfg)
    tp = TS.mamba2_init(torch.Generator().manual_seed(0), tcfg)
    jc = JS.mamba2_init_cache(jp, jcfg, 3, jnp.float32)
    tc = TS.mamba2_init_cache(tp, tcfg, 3, torch.float32)
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in jc.items()}
    assert tc["ssm"].dtype == torch.float32 and not bool(tc["conv"].any())


def test_unported_configs_raise():
    """Every registry name of the reference is registered in the port (the
    last two, whisper-base and xlstm-1.3b, equal to the reference's field
    for field); an unknown name, ``analysis_mode`` and the ``PerfConfig``
    levers raise."""
    from repro.configs import ARCH_NAMES as J_ARCH_NAMES
    from repro_torch.configs import ARCH_NAMES as T_ARCH_NAMES

    assert set(T_ARCH_NAMES) == set(J_ARCH_NAMES)
    for arch in ("whisper-base", "xlstm-1.3b"):
        j, t = j_get_config(arch), t_get_config(arch)
        assert dataclasses.asdict(t) == {
            k: v for k, v in dataclasses.asdict(j).items() if k != "use_pallas"}, arch
    with pytest.raises(KeyError, match="unknown"):
        t_get_config("gpt-9")
    cfg = t_get_config("qwen3-4b").reduced()
    gen = torch.Generator().manual_seed(0)
    params = TT.init_params(gen, cfg)
    tokens = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    with pytest.raises(NotImplementedError, match="analysis_mode"):
        TT.forward(params, dataclasses.replace(cfg, analysis_mode=True), tokens)
    perf = dataclasses.replace(cfg.perf, pad_heads=16)
    with pytest.raises(NotImplementedError, match="PerfConfig"):
        TT.prefill(params, dataclasses.replace(cfg, perf=perf), tokens, 8)


def test_sliding_window_ring_buffer_matches_jax():
    """qwen3 reduced with a window of 8 under a 24-token prompt: the flash
    window mask in prefill, the prefill cache cut and rolled to an 8-slot
    ring, and decode writing slot pos % 8 — against the JAX package."""
    jcfg = dataclasses.replace(j_get_config("qwen3-4b").reduced(), sliding_window=8)
    tcfg = dataclasses.replace(t_get_config("qwen3-4b").reduced(), sliding_window=8)
    jparams = JT.init_params(jax.random.PRNGKey(9), jcfg)
    tparams = backbone_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size, (B, S + 3)).astype(np.int32)
    jl, jc, _ = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens[:, :S])}, S + 3)
    tl, tc, _ = TT.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens[:, :S]).long()},
                           S + 3)
    assert tc["units"]["slot0"]["attn"]["k"].shape[2] == 8
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _caches_close(tc, jc)
    for step in range(3):
        tok = tokens[:, S + step:S + step + 1]
        jl, jc, _ = JT.decode_step(jparams, jcfg, jnp.asarray(tok), jc)
        tl, tc, _ = TT.decode_step(tparams, tcfg, torch.from_numpy(tok).long(), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=f"decode step {step}", **TOL)
    _caches_close(tc, jc)
