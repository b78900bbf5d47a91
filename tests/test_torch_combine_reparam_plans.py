"""The launch plans of the redesigned combine and reparam forward kernels,
their arithmetic emulated in numpy, and the edge cases they change, checked
on the CPU.

* ``wire.combine_plan`` covers every column exactly once (blocks striding
  over the tiles, a column a thread), takes the direct routes (no shared
  memory) for the mean and for a trim of up to ``DIRECT_ROWS`` rows, and
  for larger J keeps the staged tiles a multiple of 16 columns and fits
  their shared memory under the H100's 232,448 bytes a block, for P in
  {1, 3, 5, 20, 50,177, 100,354} and J in {1, 2, 6, 10, 32, 33, 64,
  1,024}, f32 and int8.
* The staged route's copy of a row segment (``stage_tile`` in
  ``csrc/wire.cu``), emulated here, copies each element once, at the
  segment's own offset within 16 bytes, with every 16-byte piece aligned
  in device and shared memory, for rows at every offset P and x's base
  give (P % 4 = 1, 2, 3; x one element off).
* The kernel's sorting network (``sort_rows``: J rounds of odd-even
  transposition) sorts every J up to 16 with +inf rows;
  the trimmed mean's two routes, emulated (that network over the J values,
  inactive rows +inf; the rank count with ties broken by row index), and
  the plain versions the wrapper takes on the CPU agree with JAX's
  ``fused_combine`` in interpret mode at the edge cases (fractional
  weights below 1, all weights zero, one and two active rows, ties, J = 33,
  int8 at odd P), within rtol 1e-5, atol 1e-6 (another order of the
  column sums).
* ``reparam.reparam_plan`` covers every element once (16-byte vectors
  grid-strided, the tail one a thread), takes vectors
  only when every pointer is 16-byte aligned (``_aligned16``: a view one
  element off takes the scalar route), and never asks for more blocks
  than the per-stream scratch holds partials; ``_scratch`` is one zeroed
  tensor per (device, stream). The reparam forward in bf16 at N = 7
  against JAX's ``reparam_stl`` in interpret mode: z bit for bit, logq
  within 1e-5 relative.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import wire as jwire
from repro.kernels.reparam import reparam_stl as j_reparam
from repro_torch.kernels import reparam as trep
from repro_torch.kernels import wire as twire

RTOL, ATOL = 1e-5, 1e-6
PLAN_P = [1, 3, 5, 20, 50_177, 100_354]
PLAN_J = [1, 2, 6, 10, 32, 33, 64, 1024]
PLAN_N = [1, 7, 4097, 50_177, 508_160]
J_COMBINE = jax.jit(jwire.fused_combine,
                    static_argnames=("trim_frac", "block_cols", "interpret"))

# ---------------------------------------------------------------------------
# combine: the launch plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("elt", [4, 1], ids=["f32", "int8"])
@pytest.mark.parametrize("trimmed", [False, True], ids=["mean", "trimmed"])
@pytest.mark.parametrize("J", PLAN_J)
@pytest.mark.parametrize("P", PLAN_P)
def test_combine_plan_covers_every_column_once(P, J, trimmed, elt):
    plan = twire.combine_plan(J, P, elt, trimmed)
    tc = plan.tile_cols
    assert plan.tiles == -(-P // tc) and 1 <= plan.grid <= plan.tiles
    assert tc % 16 == 0 and 16 <= tc <= twire.COMBINE_THREADS  # at most a column a thread
    assert plan.grid <= twire.H100_SMS * (twire.SM_THREADS // twire.COMBINE_THREADS)
    if trimmed and J > twire.DIRECT_ROWS:
        assert plan.smem_bytes == twire.trim_smem_bytes(J, tc, elt)
        assert plan.smem_bytes <= twire.COMBINE_SMEM_BUDGET <= twire.SMEM_LIMIT
    else:
        assert tc == twire.COMBINE_THREADS and plan.smem_bytes == 0
    cols = np.zeros(P, np.int64)
    for b in range(plan.grid):  # blocks stride over the tiles; thread i takes column i
        for tile in range(b, plan.tiles, plan.grid):
            cols[tile * tc:min(P, (tile + 1) * tc)] += 1
    np.testing.assert_array_equal(cols, 1)


def test_combine_plan_at_the_main_path_fills_the_card():
    """(10, 100,354): 393 blocks of 256 columns, three an SM, all resident."""
    for elt, trimmed in ((4, False), (1, True)):
        plan = twire.combine_plan(10, 100_354, elt, trimmed)
        assert plan.grid == plan.tiles == 393 and plan.smem_bytes == 0, plan


def test_staged_trim_plan_narrows_tiles_to_fit_the_widest_j():
    plan = twire.combine_plan(twire.MAX_TRIM_ROWS, 100, 4, True)
    assert plan.tile_cols == 16 and plan.smem_bytes <= twire.COMBINE_SMEM_BUDGET
    assert twire.combine_plan(twire.DIRECT_ROWS + 1, 100_354, 4, True).smem_bytes > 0


# ---------------------------------------------------------------------------
# combine: the staged route's copy of a row segment (stage_tile), emulated
# ---------------------------------------------------------------------------


def _stage(addr, width, elt, tc):
    """Emulate ``stage_tile`` for one row segment at byte address ``addr``:
    returns how often each element lands in the row's shared memory, and
    asserts that each 16-byte piece is aligned on both sides and inside
    the row's ``tc + 16 / elt`` elements."""
    V = 16 // elt
    stride = tc + V
    lead = (addr % 16) // elt
    head = min((V - lead) % V, width)
    hits = np.zeros(stride, np.int64)
    src = np.zeros(width, np.int64)
    per_row = width // V + 1
    for i in range(per_row):
        if i < (width - head) // V:
            g = addr + (head + i * V) * elt
            s = (lead + head + i * V) * elt
            assert g % 16 == 0 and s % 16 == 0, (addr, width, i)
            hits[lead + head + i * V:lead + head + (i + 1) * V] += 1
            src[head + i * V:head + (i + 1) * V] += 1
    body = (width - head) // V * V
    for e in range(2 * V):
        i = e if e < V else head + body + e - V
        if (e < head) if e < V else (i < width):
            hits[lead + i] += 1
            src[i] += 1
    np.testing.assert_array_equal(src, 1)
    np.testing.assert_array_equal(hits[lead:lead + width], 1)
    assert hits.sum() == width and lead + width <= stride
    return lead


@pytest.mark.parametrize("elt", [4, 1], ids=["f32", "int8"])
@pytest.mark.parametrize("base_off", [0, 1], ids=["aligned", "one_elt_off"])
@pytest.mark.parametrize("P", [1, 5, 20, 4097, 4098, 4099, 50_177, 100_354])
def test_trim_staging_copies_each_element_once_aligned(P, base_off, elt):
    J = 17  # rows past the first 16 repeat every alignment a row can have
    plan = twire.combine_plan(J, P, elt, True)
    base = 1 << 20  # a 16-byte aligned allocation
    tiles = sorted({0, 1, plan.tiles // 2, plan.tiles - 1} & set(range(plan.tiles)))
    leads = set()
    for tile in tiles:
        c0 = tile * plan.tile_cols
        width = min(plan.tile_cols, P - c0)
        for j in range(J):
            leads.add(_stage(base + (base_off + j * P + c0) * elt, width, elt, plan.tile_cols))
    if P == 100_354 and elt == 4 and base_off == 0:
        assert leads == {0, 2}  # the main path: every other row 8 bytes off


# ---------------------------------------------------------------------------
# combine: the trimmed routes emulated, and the edge cases vs JAX
# ---------------------------------------------------------------------------


def _sort_rows(v):
    """The kernel's network (``sort_rows``) on the columns of v (J, cols):
    J rounds of odd-even transposition, round r ordering the pairs
    (i, i + 1) with i of r's parity."""
    v = v.copy()
    J = v.shape[0]
    for r in range(J):
        for i in range(r & 1, J - 1, 2):
            v[i], v[i + 1] = np.fmin(v[i], v[i + 1]), np.fmax(v[i], v[i + 1])
    return v


@pytest.mark.parametrize("J", range(1, 17))
def test_sorting_network_sorts_every_j_with_inf(J):
    rng = np.random.default_rng(J)
    v = np.round(rng.standard_normal((J, 256)) * 2).astype(np.float32)
    v[J // 2:, ::3] = np.inf  # inactive rows
    np.testing.assert_array_equal(_sort_rows(v), np.sort(v, axis=0))


def _k(tf, n):
    nf = np.float32(n)
    return int(min(np.floor(np.float32(tf) * nf), np.floor((nf - 1) / 2))) if n else 0


def _trim_registers(x, w, tf):
    """The direct route: inactive rows set to +inf, the J values sorted by
    the kernel's network, ranks k .. n-k-1 summed in ascending order (f32)."""
    on = w > 0
    n = int(on.sum())
    k = _k(tf, n)
    v = _sort_rows(np.where(on[:, None], x, np.inf).astype(np.float32))
    s = np.zeros(x.shape[1], np.float32)
    for rank in range(x.shape[0]):
        if k <= rank < n - k:
            s = (s + v[rank]).astype(np.float32)
    return np.zeros_like(s) if n == 0 else (s / np.float32(n - 2 * k)).astype(np.float32)


def _trim_rank_count(x, w, tf):
    """The shared-memory route: ranks with ties broken by row index, the
    kept values summed in row order (f32)."""
    act = np.flatnonzero(w > 0)
    n, k = len(act), _k(tf, len(act))
    s = np.zeros(x.shape[1], np.float32)
    for p in range(n):
        xp = x[act[p]]
        rank = sum(((x[act[q]] < xp) | ((x[act[q]] == xp) & (q < p))).astype(np.int64)
                   for q in range(n))
        s = np.where((rank >= k) & (rank < n - k), s + xp, s).astype(np.float32)
    return np.zeros_like(s) if n == 0 else (s / np.float32(n - 2 * k)).astype(np.float32)


def _weights(J, kind, rng):
    if kind == "frac_below_1":
        return (rng.random(J) * 0.9 / J).astype(np.float32)
    if kind == "zeros":
        return np.zeros(J, np.float32)
    if kind == "partial":
        w = (rng.random(J) < 0.7).astype(np.float32)
        w[0] = 1.0
        return w
    w = np.zeros(J, np.float32)
    if kind in ("n1", "n2"):
        w[J // 3] = 1.0
        if kind == "n2":
            w[-1] = 1.0
        return w
    return np.ones(J, np.float32)


EDGE_CASES = [
    # (J, P, trim_frac or None, weights, ties, int8)
    (33, 37, None, "frac_below_1", False, False),
    (33, 37, None, "zeros", False, False),
    (33, 37, 0.2, "ones", True, False),
    (33, 37, 0.2, "partial", False, False),
    (33, 37, 0.34, "zeros", False, False),
    (33, 37, 0.34, "n1", False, False),
    (33, 37, 0.34, "n2", False, False),
    (33, 37, 0.1, "partial", False, True),
    (33, 37, 0.2, "ones", True, True),
    (10, 101, 0.1, "ones", False, True),
    (10, 101, 0.1, "partial", True, True),
    (6, 21, 0.2, "ones", True, False),
    (6, 21, 0.2, "n2", False, False),
    (10, 101, 0.5, "frac_below_1", False, False),
    (2, 5, None, "frac_below_1", False, False),
    (1, 7, 0.34, "n1", False, True),
]


@pytest.mark.parametrize("case", EDGE_CASES, ids=lambda c: "J{}_P{}_tf{}_{}_ties{}_i8{}".format(*c))
def test_combine_edge_cases_match_pallas(case):
    J, P, tf, kind, ties, int8 = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    w = _weights(J, kind, rng)
    if int8:
        x = rng.integers(-127, 128, (J, P)).astype(np.int8)
        if ties:
            x = (x // 64).astype(np.int8)
        scales = (rng.random(J) * 0.05 + 1e-3).astype(np.float32)
        mat = (x.astype(np.float32) * scales[:, None]).astype(np.float32)
    else:
        x = rng.standard_normal((J, P)).astype(np.float32)
        if ties:
            x = np.round(2 * x) / 2
        scales, mat = None, x
    want = np.asarray(J_COMBINE(jnp.asarray(x), jnp.asarray(w),
                                scales=None if scales is None else jnp.asarray(scales),
                                trim_frac=tf, interpret=True))
    got = twire.fused_combine(torch.as_tensor(x), torch.as_tensor(w),
                              scales=None if scales is None else torch.as_tensor(scales),
                              trim_frac=tf)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if tf is None:
        return
    if J <= twire.DIRECT_ROWS:
        np.testing.assert_allclose(_trim_registers(mat, w, tf), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_trim_rank_count(mat, w, tf), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# reparam forward: the launch plan, the scratch, bf16 at N = 7
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aligned", [True, False], ids=["vector", "scalar"])
@pytest.mark.parametrize("elt", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", PLAN_N)
def test_reparam_plan_covers_every_element_once(n, elt, aligned):
    plan = trep.reparam_plan(n, elt, aligned)
    assert plan.vec == (16 // elt if aligned else 1)
    capacity = twire.H100_SMS * trep.BLOCKS_PER_SM
    assert 1 <= plan.grid <= capacity
    threads = plan.grid * trep.THREADS
    nvec = n // plan.vec
    hits = np.zeros(n, np.int64)
    for t0 in range(0, max(nvec, 1), threads):  # the grid-stride loop, a pass at a time
        v = np.arange(t0, min(nvec, t0 + threads))
        for e in range(plan.vec):
            np.add.at(hits, v * plan.vec + e, 1)
    tail = n - nvec * plan.vec
    assert tail < plan.vec and tail <= threads
    hits[nvec * plan.vec:] += 1  # thread t takes element nvec * vec + t
    np.testing.assert_array_equal(hits, 1)
    if nvec >= twire.H100_SMS * trep.THREADS:
        assert plan.grid >= twire.H100_SMS  # every SM has blocks


def test_reparam_route_follows_the_pointers_alignment():
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.zeros(64, dtype=dtype)
        assert trep._aligned16(buf, buf, buf)
        off = buf[1:]
        assert not trep._aligned16(buf, off, buf)
        assert trep.reparam_plan(7, off.element_size(), trep._aligned16(off)).vec == 1


def test_reparam_scratch_is_one_zeroed_tensor_per_device_and_stream():
    class _Stream:
        def __init__(self, handle):
            self.cuda_stream = handle

    dev = torch.device("cpu")
    saved = dict(trep._SCRATCH)
    trep._SCRATCH.clear()
    try:
        a, b = _Stream(11), _Stream(12)
        sa = trep._scratch(dev, a, 4)
        assert trep._scratch(dev, a, 4) is sa
        sb = trep._scratch(dev, b, 4)
        assert sb is not sa and sb.data_ptr() != sa.data_ptr()
        assert sa.numel() == 1 + 4 * trep.BLOCKS_PER_SM and sa.dtype == torch.int32
        assert int(sa.abs().sum()) == 0
    finally:
        trep._SCRATCH.clear()
        trep._SCRATCH.update(saved)


def test_reparam_forward_bf16_at_n7_matches_pallas():
    rng = np.random.default_rng(7)
    mu, eps = (rng.standard_normal(7).astype(np.float32) for _ in range(2))
    ls = (-1.0 + 0.3 * rng.standard_normal(7)).astype(np.float32)
    jz, jlq = j_reparam(*(jnp.asarray(a, jnp.bfloat16) for a in (mu, ls, eps)), interpret=True)
    tz, tlq = trep.reparam_fwd(*(torch.as_tensor(a).to(torch.bfloat16) for a in (mu, ls, eps)))
    assert tz.dtype == torch.bfloat16 and tlq.dtype == torch.float32
    np.testing.assert_array_equal(tz.float().numpy(), np.asarray(jz, np.float32))
    np.testing.assert_allclose(float(tlq), float(jlq), rtol=1e-5)
    assert trep.LAUNCHES["reparam_stl_fwd"] == 0  # the CPU route launches nothing
