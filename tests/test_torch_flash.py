"""The PyTorch port's flash-attention forward and attention dispatcher
against the JAX package (Pallas kernels in interpret mode on the CPU).

Inputs come from a numpy seed and go through both. On the CPU the port's
wrappers run their plain versions; fp32 tolerance rtol = atol = 2e-5 (the
two sum in a different order). The CUDA kernel itself is held against the
plain version in tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import attention as jax_attention
from deepspeed_tpu.ops.transformer import flash as jax_flash
from deepspeed_tpu_torch.ops.transformer import attention, flash

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(B, H, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D)).astype(np.float32),
            rng.standard_normal((B, H, Sk, D)).astype(np.float32),
            rng.standard_normal((B, H, Sk, D)).astype(np.float32))


CASES = [
    # (B, H, Sq, Sk, D, causal)
    (2, 2, 64, 64, 16, True),
    (2, 2, 64, 64, 16, False),
    (1, 2, 24, 96, 32, True),     # Sq < Sk: offset causal mask
    (1, 2, 100, 100, 16, True),   # S not a power of two
    (1, 3, 100, 100, 16, False),
    (1, 1, 40, 72, 64, False),
]


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", CASES)
def test_flash_fwd_matches_jax_flash_with_lse(B, H, Sq, Sk, D, causal):
    q, k, v = _qkv(B, H, Sq, Sk, D, seed=Sq + Sk + D)
    want_o, want_lse = jax_flash.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    got_o, got_lse = flash.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal)
    assert got_o.shape == (B, H, Sq, D) and got_lse.shape == (B, H, Sq)
    assert got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_flash_attention(causal):
    q, k, v = _qkv(2, 3, 48, 48, 32, seed=7)
    want = jax_flash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, 0.3)
    got = flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    o, lse = flash.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, 0.3)
    torch.testing.assert_close(o, got, rtol=0, atol=0)
    assert lse.shape == (2, 3, 48)


@pytest.mark.parametrize("with_bias,with_mask,causal", [
    (False, False, True), (True, False, True), (False, True, False),
    (True, True, True)])
def test_mha_reference_matches_jax(with_bias, with_mask, causal):
    q, k, v = _qkv(1, 2, 20, 36, 16, seed=3)
    rng = np.random.default_rng(5)
    bias = rng.standard_normal((1, 2, 20, 36)).astype(np.float32) \
        if with_bias else None
    mask = (rng.random((1, 1, 20, 36)) > 0.3) if with_mask else None
    want = jax_attention.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bias=None if bias is None else jnp.asarray(bias),
        mask=None if mask is None else jnp.asarray(mask))
    got = attention.mha_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, bias=None if bias is None else torch.from_numpy(bias),
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_dispatch_on_cpu_runs_plain_version(monkeypatch):
    """CPU tensors never build or launch a kernel, with or without mask."""
    from deepspeed_tpu_torch.ops import op_builder

    def no_build(*a, **k):
        raise AssertionError("a CPU call must not build the kernels")
    monkeypatch.setattr(op_builder, "load_kernels", no_build)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 30, 30, 16, seed=1))
    want = jax_attention.attention(jnp.asarray(q.numpy()),
                                   jnp.asarray(k.numpy()),
                                   jnp.asarray(v.numpy()), causal=True,
                                   use_flash=True)
    got = attention.attention(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    mask = torch.ones(1, 1, 30, 30, dtype=torch.bool)
    torch.testing.assert_close(attention.attention(q, k, v, mask=mask), got,
                               rtol=2e-5, atol=2e-5)
