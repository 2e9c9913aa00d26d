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
from tests.torch_threads import one_torch_thread  # noqa: F401

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


# ---------------------------------------------------- the kernel's split walk
LOG2E = 1.4426950408889634


def _emulate_split_decode(q, k, v, lens, *, k_scale=None, v_scale=None,
                          sms=132):
    """The CUDA kernel's arithmetic in torch fp32, split by split: the
    (splits, chunk) the wrapper picks (``decode.split_plan`` on ``sms``
    SMs), each live split's (m, l, acc) over its chunk in the log2 domain
    (scores times sm_scale · log2 e, the k-scale folded into the score and
    the v-scale into p), splits past the live length skipped, then the
    merge in split order: o = Σ acc·2^(m − M) / Σ l·2^(m − M), zeros when
    no key is live."""
    B, H, _, D = q.shape
    T = k.shape[2]
    splits, chunk = decode.split_plan(B * H, T, sms)
    lens = torch.as_tensor(lens, dtype=torch.int32)
    lens = lens.expand(B) if lens.dim() == 0 else lens
    scale2 = np.float32(D ** -0.5 * LOG2E)
    out = torch.zeros(B, H, 1, D)
    for b in range(B):
        n = int(min(max(int(lens[b]), 0), T))
        n_live = 1 if splits == 1 else max(1, -(-n // chunk))
        for h in range(H):
            parts = []
            for s in range(n_live):
                lo, hi = s * chunk, min(n, (s + 1) * chunk)
                if lo >= hi:          # no live key: l = 0, acc = 0
                    parts.append((-1e30, 0.0, torch.zeros(D)))
                    continue
                kk = k[b, h, lo:hi].float()
                sc = (kk @ q[b, h, 0].float()) * scale2
                vv = v[b, h, lo:hi].float()
                if k_scale is not None:
                    sc = sc * k_scale[b, h, lo:hi]
                m = sc.max()
                p = torch.exp2(sc - m)
                pv = p * v_scale[b, h, lo:hi] if v_scale is not None else p
                parts.append((float(m), float(p.sum()), pv @ vv))
            M = max(m for m, _, _ in parts)
            L = sum(l * 2.0 ** (m - M) for m, l, _ in parts)
            A = sum(a * float(2.0 ** (m - M)) for m, _, a in parts)
            out[b, h, 0] = A / L if L > 0 else 0.0
    return out


def _split_lengths(B, H, T, sms):
    splits, chunk = decode.split_plan(B * H, T, sms)
    edges = {1, T}
    for s in range(1, splits):
        edges |= {s * chunk - 1, s * chunk, s * chunk + 1}
    return splits, chunk, sorted(x for x in edges if 1 <= x <= T)


# (B, H, T, D, sms, splits): 4 splits of 64 keys (B·H 4 on 132 SMs); 3
# of 384 on 12 SMs (T 1000: the last chunk ragged, 232 keys); one split
# (B·H 80 fills half of 132 SMs)
SPLIT_CASES = [(2, 2, 256, 16, 132, 4), (2, 2, 1000, 16, 12, 3),
               (2, 40, 128, 16, 132, 1)]


@pytest.mark.parametrize("B,H,T,D,sms,splits", SPLIT_CASES)
@pytest.mark.parametrize("kind", ["scalar", "per_seq"])
def test_split_decode_emulation_matches_jax_and_plain(B, H, T, D, sms,
                                                      splits, kind):
    """fp32: the split walk against the JAX Pallas kernel (interpret mode)
    and the plain version at rtol = atol = 2e-5 (the same softmax summed
    in another order and in the log2 domain). Lengths at 1, each chunk
    boundary ± 1 and T; per-sequence vectors pair each with a one-key
    sequence, whose later chunks are all dead."""
    q, k, v = _inputs(B, H, T, D, seed=T + H)
    assert _split_lengths(B, H, T, sms)[0] == splits
    _, _, lengths = _split_lengths(B, H, T, sms)
    for length in lengths:
        lens = (length if kind == "scalar" else
                np.array([length] + [1] * (B - 1), np.int32))
        got = _emulate_split_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                                    lens, sms=sms)
        want = jax_decode.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lens, jnp.int32), use_flash=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        plain = decode.decode_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), torch.as_tensor(lens))
        torch.testing.assert_close(got, plain, **TOL)


@pytest.mark.parametrize("B,H,T,D,sms,splits", SPLIT_CASES[:2])
@pytest.mark.parametrize("kind", ["scalar", "per_seq"])
def test_split_decode_emulation_int8_matches_jax(B, H, T, D, sms, splits,
                                                 kind):
    """int8 KV: the split walk against the JAX dequantize-first path at
    2e-5 and its int8 Pallas kernel at 1e-2 (that kernel rounds p·v_scale
    to bf16, the CUDA kernel does not); the plain version at 2e-5."""
    q, k, v = _inputs(B, H, T, D, seed=3 * T)
    jkq, jks = jax_decode.quantize_kv(jnp.asarray(k))
    jvq, jvs = jax_decode.quantize_kv(jnp.asarray(v))
    kq, ks = decode.quantize_kv(torch.from_numpy(k))
    vq, vs = decode.quantize_kv(torch.from_numpy(v))
    assert _split_lengths(B, H, T, sms)[0] == splits
    _, _, lengths = _split_lengths(B, H, T, sms)
    for length in lengths:
        lens = (length if kind == "scalar" else
                np.array([length] + [1] * (B - 1), np.int32))
        got = _emulate_split_decode(torch.from_numpy(q), kq, vq, lens,
                                    k_scale=ks, v_scale=vs, sms=sms)
        jl = jnp.asarray(lens, jnp.int32)
        dense = jax_decode.decode_attention_quantized(
            jnp.asarray(q), jkq, jks, jvq, jvs, jl, use_flash=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(dense), **TOL)
        kernel = jax_decode.decode_attention_quantized(
            jnp.asarray(q), jkq, jks, jvq, jvs, jl, use_flash=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(kernel),
                                   rtol=1e-2, atol=1e-2)
        plain = decode.decode_attention_quantized(
            torch.from_numpy(q), kq, ks, vq, vs, torch.as_tensor(lens))
        torch.testing.assert_close(got, plain, **TOL)


def test_split_decode_emulation_len_zero_writes_zeros():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 2, 256, 16, seed=4))
    got = _emulate_split_decode(q, k, v, np.array([0, 9], np.int32))
    assert bool((got[0] == 0).all())
    torch.testing.assert_close(
        got[1:], decode.decode_attention(q, k, v, 9)[1:], **TOL)


@pytest.mark.parametrize("bh,T,sms,want", [
    (128, 1024, 132, (1, 1024)),   # B 8 × H 16: one CTA a row
    (16, 1024, 132, (8, 128)),     # B 1: 8 splits of 128 keys
    (1, 1024, 132, (16, 64)),      # capped at 64-key chunks
    (32, 1024, 132, (4, 256)),
    (1024, 1024, 132, (1, 1024)),
    (6, 700, 132, (11, 64)),       # the last chunk ragged (60 keys)
    (1, 63, 132, (1, 63)),         # one chunk's worth
])
def test_split_plan_reads_the_allocation_only(bh, T, sms, want):
    splits, chunk = decode.split_plan(bh, T, sms)
    assert (splits, chunk) == want
    assert splits == 1 or (chunk % 64 == 0 and (splits - 1) * chunk < T
                           <= splits * chunk)
