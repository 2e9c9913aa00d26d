"""The PyTorch port's decode attention (fp and int8 KV cache) against the
JAX package (its Pallas decode kernel in interpret mode on the CPU).

Inputs come from a numpy seed and go through both. fp32 tolerance
rtol = atol = 2e-5 (summation order). The JAX int8 kernel rounds p·v_scale
to bf16 before P·V, which the port does not: against it the tolerance is
rtol = atol = 1e-2 (bf16 keeps 8 bits), and against the JAX dequantize-
first path, which the port's plain version follows, it is 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import decode as jax_decode
from deepspeed_tpu_torch.ops.transformer import attention, decode

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(B, H, T, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, 1, D)).astype(np.float32),
            rng.standard_normal((B, H, T, D)).astype(np.float32),
            rng.standard_normal((B, H, T, D)).astype(np.float32))


def _lens(kind, length, B):
    if kind == "scalar":
        return length
    return np.array([max(1, length - 2 * b) for b in range(B)], np.int32)


@pytest.mark.parametrize("T", [64, 63, 100])
@pytest.mark.parametrize("kind", ["scalar", "per_seq"])
def test_decode_attention_matches_jax(T, kind):
    B, H, D = 2, 3, 16
    q, k, v = _inputs(B, H, T, D, seed=T)
    for length in (1, 7, T):
        lens = _lens(kind, length, B)
        want = jax_decode.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lens, jnp.int32), use_flash=True)
        got = decode.decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.as_tensor(lens))
        assert got.shape == (B, H, 1, D)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_attention_matches_masked_dense():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 2, 40, 32, seed=9))
    for length in (1, 13, 40):
        mask = (torch.arange(40) < length)[None, None, None, :]
        want = attention.mha_reference(q, k, v, causal=False, mask=mask)
        torch.testing.assert_close(decode.decode_attention(q, k, v, length),
                                   want, rtol=2e-5, atol=2e-5)


def test_decode_attention_rejects_bad_lengths():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 2, 16, 16, seed=0))
    with pytest.raises(ValueError, match="entries for batch"):
        decode.decode_attention(q, k, v, torch.tensor([3, 4, 5]))
    with pytest.raises(ValueError, match="one query token"):
        decode.decode_attention(k, k, v, 3)


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_kv_bit_exact(seed):
    rng = np.random.default_rng(seed)
    kv = (rng.standard_normal((2, 3, 17, 16)) * 3).astype(np.float32)
    kv[0, 0, 0] = 0.0                 # zero row: the zero-scale guard
    kv[1, 2, 5, :4] = [127.0, 0.5, -0.5, 1.5]  # ties round half to even
    want_q, want_s = jax_decode.quantize_kv(jnp.asarray(kv))
    got_q, got_s = decode.quantize_kv(torch.from_numpy(kv))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("kind", ["scalar", "per_seq"])
def test_decode_attention_quantized_matches_jax(kind):
    B, H, T, D = 2, 2, 64, 32
    q, k, v = _inputs(B, H, T, D, seed=6)
    jq = jnp.asarray(q)
    jkq, jks = jax_decode.quantize_kv(jnp.asarray(k))
    jvq, jvs = jax_decode.quantize_kv(jnp.asarray(v))
    kq, ks = decode.quantize_kv(torch.from_numpy(k))
    vq, vs = decode.quantize_kv(torch.from_numpy(v))
    for length in (5, 64):
        lens = _lens(kind, length, B)
        got = decode.decode_attention_quantized(
            torch.from_numpy(q), kq, ks, vq, vs, torch.as_tensor(lens))
        jl = jnp.asarray(lens, jnp.int32)
        dense = jax_decode.decode_attention_quantized(
            jq, jkq, jks, jvq, jvs, jl, use_flash=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(dense), **TOL)
        kernel = jax_decode.decode_attention_quantized(
            jq, jkq, jks, jvq, jvs, jl, use_flash=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(kernel),
                                   rtol=1e-2, atol=1e-2)
        # within int8 quantization error of the fp cache
        fp = decode.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     torch.as_tensor(lens))
        np.testing.assert_allclose(got.numpy(), fp.numpy(), rtol=0.06,
                                   atol=0.03)


@pytest.mark.parametrize("n", [1, 16, 100, 128, 512, 513, 1024, 2000])
def test_aligned_cache_len_matches_jax(n):
    assert decode.aligned_cache_len(n) == jax_decode.aligned_cache_len(n)
