"""The PyTorch port's fused LayerNorm, bias-GeLU and scaled softmax against
the JAX package's.

The JAX side runs ``fused_layer_norm`` / ``_ln_fwd`` and
``fused_bias_gelu``, whose Pallas kernels run in interpret mode on the
CPU, and their ``custom_vjp`` backwards through ``jax.vjp``; the port's
side runs its plain versions, which its wrappers and autograd
``Function``s take on CPU tensors. Inputs come from a numpy seed.
Tolerances: fp32 rtol = atol = 1e-5 (the same fp32 formulas, summed in
another order); bf16 inputs rtol = atol = 2e-2 (both sides compute in fp32
and round the outputs to bf16, so they differ by at most one bf16 ulp,
0.0156 at magnitudes in [2, 4), where the fp32 results straddle a
rounding boundary). The softmax: fp32 atol 1e-6 (the same fp32 formula,
``exp`` and the row sum in another order, on outputs in [0, 1]); bf16 one
bf16 ulp of the output, at most 2^-7 relative (both sides round the fp32
result once). The CUDA kernels are held against the plain versions in
tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import fused as jax_fused
from deepspeed_tpu_torch.ops.transformer import fused

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(n, h, seed, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal((n, h))).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    b = (0.1 * rng.standard_normal(h)).astype(np.float32)
    dy = rng.standard_normal((n, h)).astype(np.float32)
    jx = [jnp.asarray(a, JDT[dtype]) for a in (x, g, b, dy)]
    tx = [torch.from_numpy(a).to(TDT[dtype]) for a in (x, g, b, dy)]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h", [(37, 20), (16, 64), (37, 1024), (5, 1000)])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm_forward_matches_jax(dtype, n, h, eps):
    (jx, jg, jb, _), (x, g, b, _) = _inputs(n, h, seed=h + n, dtype=dtype)
    y_want, (_, _, mu_want, rstd_want, _) = jax_fused._ln_fwd(jx, jg, jb,
                                                              eps)
    y, mu, rstd = fused.layer_norm_fwd(x, g, b, eps)
    assert y.dtype == x.dtype and mu.shape == rstd.shape == (n,)
    assert mu.dtype == rstd.dtype == torch.float32
    _close(y, y_want.astype(jnp.float32), TOL[dtype])
    _close(mu, mu_want[:, 0], TOL["float32"])
    _close(rstd, rstd_want[:, 0], TOL["float32"])


def test_layer_norm_near_constant_rows_keep_the_two_pass_variance():
    """eps 1e-12 on rows that vary by 1e-4 around 1000: E[x²] − mu² would
    lose every digit of the variance; the two-pass form keeps it."""
    rng = np.random.default_rng(1)
    x = (1000.0 + 1e-4 * rng.standard_normal((8, 64))).astype(np.float32)
    g, b = np.ones(64, np.float32), np.zeros(64, np.float32)
    want, (_, _, _, rstd_want, _) = jax_fused._ln_fwd(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-12)
    y, _, rstd = fused.layer_norm_fwd(torch.from_numpy(x),
                                      torch.from_numpy(g),
                                      torch.from_numpy(b), 1e-12)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rstd_want[:, 0]),
                               rtol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(37, 20), (2, 8, 64), (3, 1000)])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm_grads_match_jax_vjp(dtype, shape, eps):
    n, h = int(np.prod(shape[:-1])), shape[-1]
    (jx, jg, jb, jdy), (x, g, b, dy) = _inputs(n, h, seed=7 * h, dtype=dtype)
    jx, jdy = jx.reshape(shape), jdy.reshape(shape)
    x, dy = x.reshape(shape), dy.reshape(shape)
    y_want, vjp = jax.vjp(
        lambda a, c, d: jax_fused.fused_layer_norm(a, c, d, eps), jx, jg, jb)
    want = vjp(jdy)
    x, g, b = (t.clone().requires_grad_() for t in (x, g, b))
    y = fused.fused_layer_norm(x, g, b, eps)
    got = torch.autograd.grad(y, (x, g, b), dy)
    _close(y, y_want.astype(jnp.float32), TOL[dtype])
    # dgamma/dbeta sum over up to 37 rows before the bf16 rounding
    for name, a, w in zip(("dx", "dgamma", "dbeta"), got, want):
        assert a.dtype == TDT[dtype] and a.shape == w.shape, name
        _close(a, w.astype(jnp.float32), TOL[dtype])


def test_layer_norm_backward_plain_matches_jax_kernel():
    """``layer_norm_bwd`` (the kernel's plain version) against the Pallas
    ``_ln_bwd`` given the same saved mu and rstd."""
    (jx, jg, jb, jdy), (x, g, b, dy) = _inputs(40, 96, seed=5,
                                               dtype="float32")
    _, res = jax_fused._ln_fwd(jx, jg, jb, 1e-5)
    dx_want, _, _ = jax_fused._ln_bwd(1e-5, res, jdy)
    mu = torch.tensor(np.asarray(res[2][:, 0]))
    rstd = torch.tensor(np.asarray(res[3][:, 0]))
    _close(fused.layer_norm_bwd(x, g, mu, rstd, dy), dx_want,
           TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(37, 20), (2, 8, 256), (3, 1000)])
def test_bias_gelu_forward_and_grads_match_jax_vjp(dtype, shape):
    n, h = int(np.prod(shape[:-1])), shape[-1]
    (jx, _, jb, jdy), (x, _, b, dy) = _inputs(n, h, seed=h, dtype=dtype,
                                              scale=2.0)
    jx, jdy = jx.reshape(shape), jdy.reshape(shape)
    x, dy = x.reshape(shape), dy.reshape(shape)
    y_want, vjp = jax.vjp(jax_fused.fused_bias_gelu, jx, jb)
    dx_want, db_want = vjp(jdy)
    assert fused.bias_gelu(x, b).dtype == x.dtype
    x, b = x.clone().requires_grad_(), b.clone().requires_grad_()
    y = fused.fused_bias_gelu(x, b)
    dx, db = torch.autograd.grad(y, (x, b), dy)
    _close(y, y_want.astype(jnp.float32), TOL[dtype])
    _close(dx, dx_want.astype(jnp.float32), TOL[dtype])
    # dbias sums up to 37 · 1 rows of products of size ~1 before rounding
    assert db.dtype == b.dtype
    _close(db, db_want.astype(jnp.float32), TOL[dtype])


def test_small_fused_ops_match_jax():
    rng = np.random.default_rng(4)
    x, r, a = (rng.standard_normal((3, 5, 8)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal(8).astype(np.float32)
    coef = rng.standard_normal((3, 5, 2)).astype(np.float32)
    J, T = jnp.asarray, torch.from_numpy
    _close(fused.bias_residual_add(T(x), T(bias), T(r)),
           jax_fused.bias_residual_add(J(x), J(bias), J(r)), TOL["float32"])
    _close(fused.residual_add(T(x), T(r)),
           jax_fused.residual_add(J(x), J(r)), TOL["float32"])
    _close(fused.residual_add(T(x), T(r), T(a), mp_size=2),
           jax_fused.residual_add(J(x), J(r), J(a), mp_size=2),
           TOL["float32"])
    _close(fused.moe_res_matmul(T(r), T(coef), T(x)),
           jax_fused.moe_res_matmul(J(r), J(coef), J(x)), TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(37, 20), (2, 8, 128), (8, 1000), (5, 7),
                                   (3, 4096)])
@pytest.mark.parametrize("scale", [1.0, 0.125])
def test_fused_softmax_matches_jax_kernel(dtype, shape, scale):
    """The plain version (the CPU route of ``fused_softmax``) against the
    Pallas ``_softmax_kernel`` in interpret mode."""
    x = (3 * np.random.default_rng(shape[-1]).standard_normal(shape)).astype(
        np.float32)
    want = jax_fused.fused_softmax(jnp.asarray(x, JDT[dtype]), scale)
    got = fused.fused_softmax(torch.from_numpy(x).to(TDT[dtype]), scale)
    assert got.dtype == TDT[dtype] and got.shape == shape
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=0)
    np.testing.assert_allclose(got.float().sum(-1).numpy(), 1.0,
                               rtol=0, atol=2e-2 if dtype == "bfloat16"
                               else 1e-5)
