"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here carries the ``cuda`` marker and skips without a
card. This file imports no JAX, so it runs on a machine that has only
PyTorch::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: fp32 rtol = atol = 2e-5 (summation order); bf16 rtol = atol =
2e-2 (the plain versions round the softmax weights to bf16 before P·V,
the kernels keep them in fp32).
"""

import pytest
import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.transformer import decode, flash

pytestmark = pytest.mark.cuda

TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", [
    (2, 4, 896, 896, 64, True), (2, 4, 1024, 1024, 64, False),
    (1, 3, 37, 300, 64, True), (2, 2, 100, 100, 16, True),
    (1, 2, 130, 130, 128, False), (1, 2, 65, 65, 20, True)])
def test_flash_kernel_matches_plain(gen, dtype, B, H, Sq, Sk, D, causal):
    q = _rand(gen, B, H, Sq, D, dtype=dtype)
    k, v = _rand(gen, B, H, Sk, D, dtype=dtype), _rand(gen, B, H, Sk, D,
                                                       dtype=dtype)
    before = op_builder.LAUNCHES["flash_fwd"]
    o, lse = flash.flash_attention_fwd(q, k, v, causal)
    assert op_builder.LAUNCHES["flash_fwd"] == before + 1
    o_ref, lse_ref = flash.flash_attention_fwd_plain(q, k, v, causal)
    tol = TOLS[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=2e-5, atol=2e-5)


def test_flash_kernel_reads_strided_views(gen):
    """q/k/v as head-split views of one fused [B, S, 3, H, D] projection."""
    qkv = _rand(gen, 2, 50, 3, 4, 32, dtype=torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    o, _ = flash.flash_attention_fwd(q, k, v, True)
    o_ref, _ = flash.flash_attention_fwd_plain(q, k, v, True)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("T,D", [(1024, 64), (100, 16), (63, 20), (64, 128)])
def test_decode_kernel_matches_plain(gen, dtype, quantized, T, D):
    B, H = 3, 4
    q = _rand(gen, B, H, 1, D, dtype=dtype)
    k, v = _rand(gen, B, H, T, D, dtype=dtype), _rand(gen, B, H, T, D,
                                                      dtype=dtype)
    scales = {}
    if quantized:
        k, scales["k_scale"] = decode.quantize_kv(k)
        v, scales["v_scale"] = decode.quantize_kv(v)
    tol = TOLS[dtype]
    for length in (1, 7, T // 2 + 1, T):
        for lens in (length, torch.tensor([length, max(1, length - 5), 1],
                                          dtype=torch.int32, device="cuda")):
            got = decode.decode_attention(q, k, v, lens, **scales)
            want = decode.decode_attention_plain(
                q, k, v, decode._lengths(lens, B, "cuda"), **scales)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)


def test_kernels_raise_on_bad_input(gen):
    q = _rand(gen, 1, 2, 8, 16, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash.flash_attention_fwd(q, q, q)
    kc = _rand(gen, 1, 2, 32, 16, dtype=torch.float32)
    with pytest.raises(ValueError):
        decode.decode_attention(kc[:, :, :1], kc.transpose(2, 3), kc, 4)
