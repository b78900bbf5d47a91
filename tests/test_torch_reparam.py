"""``repro_torch.kernels.reparam.reparam_stl`` against the JAX Pallas kernel.

The forward (z and the STL log q) and the fused backward, on CPU tensors
(the plain versions the wrapper dispatches to there), against
``repro.kernels.reparam.reparam_stl(interpret=True)`` and its custom VJP
through ``jax.vjp``. N = 4,097 is not a multiple of the 4,096 block, so
the reference pads and corrects while the port masks. Tolerance rtol 1e-6
(atol 1e-6): the elementwise outputs are the same f32 expressions. Log q
is held to 1e-6 relative of the float64 sum. Against the reference it is
held to 1e-6 relative of what the reference summed: the padded block adds
pad·½log 2π in f32 and the correction subtracts it again, which costs the
reference that much (at N = 4,097: 0.0029 of −1,812.8154, 1.6e-6 relative,
while the port is exact to f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.kernels.reparam import reparam_stl as j_reparam
from repro_torch.kernels import ref as tref
from repro_torch.kernels import reparam as treparam

RTOL, ATOL = 1e-6, 1e-6


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal(n).astype(np.float32)
    ls = (-1.0 + 0.3 * rng.standard_normal(n)).astype(np.float32)
    eps = rng.standard_normal(n).astype(np.float32)
    dz = rng.standard_normal(n).astype(np.float32)
    return mu, ls, eps, dz


@pytest.mark.parametrize("n,block", [(4097, 4096), (1, 4096), (300, 128)])
def test_forward_and_vjp_match_pallas_kernel(n, block):
    mu, ls, eps, dz = _inputs(n, seed=n)
    dlq = np.float32(0.37)
    (jz, jlq), vjp = jax.vjp(
        lambda a, b, c: j_reparam(a, b, c, block=block, interpret=True),
        jnp.asarray(mu), jnp.asarray(ls), jnp.asarray(eps))
    jd = vjp((jnp.asarray(dz), jnp.asarray(dlq)))
    tmu, tls, teps = (torch.tensor(a, requires_grad=True) for a in (mu, ls, eps))
    tz, tlq = treparam.reparam_stl(tmu, tls, teps, block=block)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz), rtol=RTOL, atol=ATOL)
    exact = np.sum(-0.5 * eps.astype(np.float64) ** 2 - ls - 0.5 * np.log(2 * np.pi))
    np.testing.assert_allclose(float(tlq.detach()), exact, rtol=RTOL)
    pad = (-n) % min(block, n)
    summed = abs(exact) + pad * 0.5 * np.log(2 * np.pi)
    assert abs(float(tlq.detach()) - float(jlq)) <= RTOL * summed
    assert tz.dtype == torch.float32 and tlq.dtype == torch.float32 and tlq.shape == ()
    torch.autograd.backward((tz, tlq), (torch.as_tensor(dz), torch.tensor(dlq)))
    for got, want in zip((tmu.grad, tls.grad, teps.grad), jd, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert treparam.LAUNCHES == {"reparam_stl_fwd": 0, "reparam_stl_bwd": 0}


def test_plain_versions_match_pallas_in_bf16():
    """bf16 inputs: z in bf16, log q and the f32 math as in the JAX kernel."""
    mu, ls, eps, dz = _inputs(1000, seed=5)
    to_b = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    (jz, jlq), vjp = jax.vjp(lambda a, b, c: j_reparam(a, b, c, interpret=True),
                             jb(mu), jb(ls), jb(eps))
    tz, tlq = tref.reparam_stl_ref(to_b(mu), to_b(ls), to_b(eps))
    assert tz.dtype == torch.bfloat16
    np.testing.assert_array_equal(tz.float().numpy(), np.asarray(jz, np.float32))
    np.testing.assert_allclose(float(tlq), float(jlq), rtol=1e-5)
    jd = vjp((jb(dz), jnp.asarray(0.5, jnp.float32)))
    td = tref.reparam_stl_bwd_ref(to_b(ls), to_b(eps), to_b(dz), torch.tensor(0.5))
    for got, want in zip(td, jd, strict=True):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_torch_func_grad_and_vmap_accept_the_function():
    mu, ls, eps, _ = _inputs(64, seed=2)

    def loss(m, s, e):
        z, lq = treparam.reparam_stl(m, s, e)
        return torch.sum(z * z) + lq

    tm, ts, te = (torch.as_tensor(a) for a in (mu, ls, eps))
    g = grad(loss, argnums=(0, 1))(tm, ts, te)
    want = jax.grad(lambda m, s: jnp.sum(j_reparam(m, s, jnp.asarray(eps), interpret=True)[0]
                                         ** 2) + j_reparam(m, s, jnp.asarray(eps),
                                                           interpret=True)[1],
                    argnums=(0, 1))(jnp.asarray(mu), jnp.asarray(ls))
    for a, b in zip(g, want, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    batched = vmap(lambda m, s, e: treparam.reparam_stl(m, s, e)[1])(
        tm.reshape(4, 16), ts.reshape(4, 16), te.reshape(4, 16))
    rows = [float(treparam.reparam_stl(m, s, e)[1]) for m, s, e in
            zip(tm.reshape(4, 16), ts.reshape(4, 16), te.reshape(4, 16), strict=True)]
    np.testing.assert_allclose(batched.numpy(), rows, rtol=1e-6)


def test_wrappers_refuse_other_devices_and_bad_blocks():
    x = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        treparam.reparam_fwd(x, x, x)
    with pytest.raises(ValueError, match="cuda or cpu"):
        treparam.reparam_bwd(x, x, x, torch.zeros((), device="meta"))
    with pytest.raises(ValueError, match="block"):
        treparam.reparam_fwd(torch.zeros(4), torch.zeros(4), torch.zeros(4), block=0)
