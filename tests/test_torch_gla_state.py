"""The GLA wrapper's final state and its launch plan, against the JAX package.

``repro_torch.kernels.gla.gla(..., return_state=True)`` on CPU tensors
takes the plain version (``ref.gla_plain``), whose chunk loop already
holds the state; on the card the kernels write the state they hold after
the last chunk. Here, on numpy-seeded inputs:

* the state against the JAX ``gla_final_state`` (a second jnp pass over k
  and v, chunk 256) and the port's own ``gla_final_state``, and y against
  ``chunked_gla`` and the Pallas kernel in interpret mode, at ragged S
  (1, 63, 65, 1,000), S shorter than one chunk, stride-0 q/k and dv = 65;
  f32 atol = rtol = 3e-5 relative to the largest |value| (as
  ``tests/test_torch_backbone_kernels.py`` holds y: outputs and states grow
  with S), and bf16 inputs against the same functions within 2e-2;
* ``mamba2_prefill``'s ``ssm`` cache against the JAX ``mamba2_prefill``'s
  (the JAX layer computes it with ``gla_final_state``), atol 5e-4 and rtol
  1e-3 as ``tests/test_torch_backbone.py`` holds the caches;
* the tensor-core kernel's launch plan (pure Python): the dv slices cover
  every column once, shared memory fits the H100's 227 KB and equals the
  source's formula, and the route follows the dtype;
* the mutants ``chip_smoke.py --gla-mutants`` builds: each one's text
  stands in ``csrc/gla.cu`` exactly once and its replacement changes it.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import ops
from repro.models.backbone import ssm as JS
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import gla as tgla
from repro_torch.kernels import ref as tref
from repro_torch.models.backbone import ssm as TS

F32 = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)

STATE_CASES = {
    # name: (B, S, H, dk, dv, q/k one group broadcast over the heads, dtype)
    "S1": (2, 1, 3, 16, 16, False, "f32"),
    "S63_under_one_chunk": (1, 63, 2, 16, 24, False, "f32"),
    "S65_ragged": (2, 65, 2, 16, 16, False, "f32"),
    "S1000_ragged": (1, 1000, 2, 16, 16, False, "f32"),
    "stride0_qk": (2, 150, 3, 16, 32, True, "f32"),
    "dv65": (1, 130, 2, 16, 65, False, "f32"),
    "bf16_stride0_qk": (2, 150, 3, 16, 32, True, "bf16"),
}


def _inputs(B, S, H, dk, dv, shared, seed):
    rng = np.random.default_rng(seed)
    shape_qk = (B, S, 1, dk) if shared else (B, S, H, dk)
    q = 0.5 * rng.standard_normal(shape_qk).astype(np.float32)
    k = 0.5 * rng.standard_normal(shape_qk).astype(np.float32)
    v = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    a = -np.abs(0.1 * rng.standard_normal((B, S, H))).astype(np.float32)
    return q, k, v, a


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32),
                      dtype=np.float32)


def _close(got, want, tol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=tol["atol"] * scale)


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_gla_state_matches_jax(case):
    B, S, H, dk, dv, shared, dt = STATE_CASES[case]
    q, k, v, a = _inputs(B, S, H, dk, dv, shared, seed=len(case) + S)
    jd, td = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    tol = F32 if dt == "f32" else BF16
    tq, tk = torch.from_numpy(q).to(td), torch.from_numpy(k).to(td)
    if shared:  # the port takes mamba2's q/k as stride-0 head views
        tq, tk = tq.expand(B, S, H, dk), tk.expand(B, S, H, dk)
        assert tq.stride(2) == 0 and tk.stride(2) == 0
        q, k = np.broadcast_to(q, (B, S, H, dk)), np.broadcast_to(k, (B, S, H, dk))
    tv, ta = torch.from_numpy(v).to(td), torch.from_numpy(a)
    jq, jk, jv = (jnp.asarray(np.ascontiguousarray(x)).astype(jd) for x in (q, k, v))
    ja = jnp.asarray(a)

    y, state = tgla.gla(tq, tk, tv, ta, return_state=True)
    assert y.dtype == td and tuple(y.shape) == (B, S, H, dv)
    assert state.dtype == torch.float32 and tuple(state.shape) == (B, H, dk, dv)
    # The state: JAX's second pass, and the port's counterpart of it.
    _close(_np(state), _np(JS.gla_final_state(jk, jv, ja)), tol)
    _close(_np(state), _np(TS.gla_final_state(tk, tv, ta)), tol)
    # y: as without return_state (to rounding: CPU einsums need not repeat
    # bit for bit), and equal to the JAX paths.
    _close(_np(y), _np(tgla.gla(tq, tk, tv, ta)), tol)
    _close(_np(y), _np(JS.chunked_gla(jq, jk, jv, ja)), tol)
    _close(_np(y), _np(ops.gla(jq, jk, jv, ja, interpret=True)), tol)
    assert tgla.LAUNCHES == {"gla": 0, "gla_tc": 0}


def test_gla_state_continues_the_recurrence():
    """The state after S steps, carried through gla_decode_step for the
    next steps, gives the same outputs and state as a run over all of them."""
    B, S, H, dk, dv, extra = 1, 100, 2, 8, 8, 3
    q, k, v, a = (torch.from_numpy(x) for x in _inputs(B, S + extra, H, dk, dv, False, seed=4))
    y_all, s_all = tref.gla_plain(q, k, v, a, return_state=True)
    _, state = tgla.gla(q[:, :S], k[:, :S], v[:, :S], a[:, :S], return_state=True)
    for t in range(S, S + extra):
        state, y = TS.gla_decode_step(state, q[:, t], k[:, t], v[:, t], a[:, t])
        torch.testing.assert_close(y, y_all[:, t], atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(state, s_all, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S", [40, 150])
def test_mamba2_prefill_ssm_cache_matches_jax(S):
    jcfg = j_get_config("zamba2-7b").reduced()
    tcfg = t_get_config("zamba2-7b").reduced()
    jp = JS.mamba2_init(jax.random.PRNGKey(3), jcfg)
    tp = jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x, np.float32)), jp)
    u = np.random.default_rng(S).standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jout, jcache = JS.mamba2_prefill(jp, jcfg, jnp.asarray(u))
    tout, tcache = TS.mamba2_prefill(tp, tcfg, torch.from_numpy(u))
    assert tcache["ssm"].dtype == torch.float32
    assert tuple(tcache["ssm"].shape) == tuple(jcache["ssm"].shape)
    np.testing.assert_allclose(_np(tcache["ssm"]), _np(jcache["ssm"]), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(_np(tcache["conv"]), _np(jcache["conv"]), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(_np(tout), _np(jout), atol=5e-4, rtol=1e-3)


def test_mamba2_prefill_takes_the_state_from_gla(monkeypatch):
    """mamba2_prefill makes one GLA call, with return_state, and no second
    pass over k and v (gla_final_state is not called)."""
    cfg = t_get_config("zamba2-7b").reduced()
    params = TS.mamba2_init(torch.Generator().manual_seed(0), cfg)
    calls = []
    real = TS.gla

    def counting_gla(*args, **kw):
        calls.append(kw.get("return_state", False))
        return real(*args, **kw)

    def no_second_pass(*args, **kw):
        raise AssertionError("mamba2_prefill called gla_final_state")

    monkeypatch.setattr(TS, "gla", counting_gla)
    monkeypatch.setattr(TS, "gla_final_state", no_second_pass)
    u = torch.randn((2, 70, cfg.d_model), generator=torch.Generator().manual_seed(1))
    _, cache = TS.mamba2_prefill(params, cfg, u)
    assert calls == [True]
    assert bool(torch.isfinite(cache["ssm"]).all())


# ---------------------------------------------------------------------------
# The tensor-core kernel's launch plan
# ---------------------------------------------------------------------------

PLAN_SHAPES = [  # (B, H, dk, dv)
    (4, 112, 64, 64), (8, 112, 64, 64), (2, 8, 64, 65), (1, 2, 16, 16), (1, 1, 128, 128),
    (3, 5, 100, 1), (2, 3, 65, 127),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("S", [1, 64, 4096])
def test_tc_plan_slices_cover_dv_once_and_fit(shape, S):
    B, H, dk, dv = shape
    plan = tgla.gla_plan(B, H, dk, dv, torch.bfloat16, S=S)
    assert plan.route == "tc" and plan.dv_cols == tgla.TC_COLS == 64
    assert plan.grid == (B * H, plan.slices) and plan.slices == (1 if dv <= 64 else 2)
    cover = np.zeros(dv, dtype=int)
    for s in range(plan.slices):  # block y takes columns s * 64 + [0, 64)
        cols = np.arange(s * plan.dv_cols, (s + 1) * plan.dv_cols)
        cover[cols[cols < dv]] += 1
        assert (cols < dv).any(), "a slice with no live column"
    assert (cover == 1).all()
    assert plan.smem == tgla.tc_smem_bytes(dk, S) <= tgla.SMEM_LIMIT


def test_tc_smem_formula():
    """The source's tc::smem_bytes, spelled out: log_a of two stages and
    four warps' cumsums, two stages of q, k, v, two hi/lo state copies; a
    one-chunk walk asks for the first stage alone."""
    for dk, dkp in ((1, 64), (64, 64), (65, 128), (128, 128)):
        assert tgla.tc_dk_pad(dk) == dkp
        warps = tgla.TC_WARPS
        stage = 2 * 64 * (dkp + 8) * 2 + 64 * (64 + 8) * 2
        want = (2 + warps) * 64 * 4 + 2 * stage + 4 * dkp * (64 + 8) * 2
        assert tgla.tc_smem_bytes(dk) == tgla.tc_smem_bytes(dk, 65) == want
        assert tgla.tc_smem_bytes(dk, 64) == tgla.tc_smem_bytes(dk, 1) \
            == (2 + warps) * 64 * 4 + stage
    # mamba2's serve shapes: one block a (batch, head) over all 64 columns;
    # two blocks an SM by memory for the walk, three for a one-chunk prompt.
    plan = tgla.gla_plan(4, 112, 64, 64, torch.bfloat16, S=4096)
    assert (plan.dv_cols, plan.slices, plan.grid) == (64, 1, (448, 1))
    assert 2 * (plan.smem + 1024) <= 228 * 1024 < 3 * (plan.smem + 1024)
    plan = tgla.gla_plan(8, 112, 64, 64, torch.bfloat16, S=64)
    assert 3 * (plan.smem + 1024) <= 228 * 1024


def test_plan_route_follows_dtype():
    assert tgla.gla_plan(2, 3, 64, 64, torch.float32).route == "simt"
    assert tgla.gla_plan(2, 3, 64, 64, torch.float32).grid == (6, 1)
    assert tgla.gla_plan(2, 3, 64, 64, torch.bfloat16).route == "tc"
    assert [tgla.gla_plan(2, 3, 64, dv, torch.bfloat16).grid
            for dv in (1, 32, 64, 65, 128)] == [(6, 1)] * 3 + [(6, 2)] * 2
    assert tgla.gla_plan(2, 3, 64, 65, torch.float32).grid == (6, 1)


# ---------------------------------------------------------------------------
# The card check's mutants
# ---------------------------------------------------------------------------


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


GLA_MUTANTS = _chip_smoke().GLA_MUTANTS


@pytest.mark.parametrize("mutant", GLA_MUTANTS, ids=[m[0] for m in GLA_MUTANTS])
def test_gla_mutant_text_is_in_the_kernel_once(mutant):
    """Each mutant breaks ``gla.cu`` at one place: were its text gone from
    the source, ``--gla-mutants`` would check the unchanged kernel."""
    name, old, new = mutant
    source = (Path(tgla.__file__).resolve().parents[1] / "csrc" / "gla.cu").read_text()
    assert source.count(old) == 1, name
    assert source.replace(old, new) != source, name
