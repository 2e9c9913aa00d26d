"""The PyTorch port's flash-attention backward against the JAX package.

The JAX side is ``jax.vjp`` of ``deepspeed_tpu.ops.transformer.flash
.flash_attention``, whose Pallas backward kernels run in interpret mode
on the CPU. The port's side is its plain backward (the explicit formulas,
not an autograd of the forward) and the autograd ``Function`` that wraps
the kernels, whose CPU route runs the same plain versions. Inputs come
from a numpy seed; fp32 tolerance rtol = atol = 2e-5 (the two sum in a
different order). The CUDA kernels are held against the plain version in
tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import flash as jax_flash
from deepspeed_tpu_torch.ops.transformer import attention, flash

TOL = dict(rtol=2e-5, atol=2e-5)

CASES = [
    # (B, H, Sq, Sk, D, causal): the forward's cases (test_torch_flash.py)
    (2, 2, 64, 64, 16, True),
    (2, 2, 64, 64, 16, False),
    (1, 2, 24, 96, 32, True),     # Sq < Sk: offset causal mask
    (1, 2, 100, 100, 16, True),   # S not a power of two
    (1, 3, 100, 100, 16, False),
    (1, 1, 40, 72, 64, False),
]


def _inputs(B, H, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    do = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, sm_scale=None):
    _, vjp = jax.vjp(lambda a, b, c: jax_flash.flash_attention(
        a, b, c, causal, sm_scale), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", CASES)
def test_plain_backward_matches_jax_vjp(B, H, Sq, Sk, D, causal):
    q, k, v, do = _inputs(B, H, Sq, Sk, D, seed=Sq + Sk + D + causal)
    want = _jax_grads(q, k, v, do, causal)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash.flash_attention_fwd(tq, tk, tv, causal)
    got = flash.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal)
    for name, g, w in zip("dq dk dv".split(), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", CASES)
def test_autograd_function_matches_jax_vjp(B, H, Sq, Sk, D, causal):
    q, k, v, do = _inputs(B, H, Sq, Sk, D, seed=3 * Sq + D)
    want = _jax_grads(q, k, v, do, causal, 0.3)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash.flash_attention(tq, tk, tv, causal, 0.3)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip("dq dk dv".split(), got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


def test_plain_backward_is_not_the_forward_autograd_in_bf16():
    """In bf16 the explicit formulas round p and ds where the JAX kernels
    do; the result stays within bf16 reach of the fp32 gradients."""
    q, k, v, do = _inputs(1, 2, 48, 48, 32, seed=11)
    want = _jax_grads(q, k, v, do, True)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, k, v, do))
    o, lse = flash.flash_attention_fwd(tq, tk, tv, True)
    got = flash.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0.05,
                                   atol=0.05)


def test_attention_cpu_gradients_match_jax():
    """The model-level dispatcher is differentiable on the CPU (the plain
    dense route), with the same gradients as the JAX flash vjp."""
    q, k, v, do = _inputs(2, 2, 30, 30, 16, seed=5)
    want = _jax_grads(q, k, v, do, True)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention.attention(tq, tk, tv, causal=True)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_flash_attention_with_lse_stays_forward_only():
    q, k, v, _ = _inputs(1, 1, 8, 8, 16, seed=2)
    tq = torch.from_numpy(q).requires_grad_()
    o, lse = flash.flash_attention_with_lse(tq, torch.from_numpy(k),
                                            torch.from_numpy(v))
    assert not o.requires_grad and not lse.requires_grad
