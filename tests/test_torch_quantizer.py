"""The PyTorch port's grouped quantizer (``ops/quantizer/quantizer.py``)
against the JAX package's.

On the CPU the JAX ``quantize`` takes its fallback path, ``_quantize_rows``
over ``[groups, row]``: the same math as its Pallas kernel body
(quantizer.py:76). The port's wrapper runs its plain version on CPU
tensors. Inputs come from a numpy seed. Tolerances: atol 0 everywhere —
both sides compute in fp32 with IEEE divisions, round half to even (or
floor(q + noise)), and round the result once to the input dtype, so they
agree bit for bit. Stochastic rounding is compared with the same noise
injected into both ``_quantize_rows`` (the TPU kernel draws from the TPU
generator, the port from Philox); the port's own Philox draw is held to a
reference implementation in Python integers. The CUDA kernel is held
against the plain version in tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.quantizer import quantizer as jax_quantizer
from deepspeed_tpu_torch.ops.quantizer import quantizer

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _x(shape, seed, zero_row=True):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10)).astype(
        np.float32)
    if zero_row:
        x.reshape(8, -1)[3] = 0.0   # a zero group when groups = 8
    return x


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("groups", [1, 8])
@pytest.mark.parametrize("bits", [2, 3, 4, 8, 12, 16])
def test_quantize_matches_jax(dtype, symmetric, groups, bits):
    x = _x((16, 24), seed=bits * 10 + groups)
    want = jax_quantizer.quantize(jnp.asarray(x, JDT[dtype]), bits, groups,
                                  symmetric, False)
    got = quantizer.quantize(torch.from_numpy(x).to(TDT[dtype]), bits,
                             groups, symmetric)
    assert got.dtype == TDT[dtype] and got.shape == (16, 24)
    np.testing.assert_array_equal(_np(got), _np(want.astype(jnp.float32)))


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("groups", [1, 8, 16])
def test_transposed_layout_groups_the_reference_layout(symmetric, groups):
    """An [out, in] tensor quantized with ``transposed=True`` equals the
    JAX quantizer over the flax [in, out] layout, transposed back (with
    groups 16 a group ends inside a flax row of 40)."""
    x = _x((24, 40), seed=groups, zero_row=False)    # flax [in, out]
    want = jax_quantizer.quantize(jnp.asarray(x), 4, groups, symmetric,
                                  False)
    got = quantizer.quantize(torch.from_numpy(x.T.copy()), 4, groups,
                             symmetric, transposed=True)
    np.testing.assert_array_equal(_np(got).T, _np(want))
    if groups > 1:   # grouping the buffer as it lies gives other scales
        naive = quantizer.quantize(torch.from_numpy(x.T.copy()), 4, groups,
                                   symmetric)
        assert not np.array_equal(_np(naive).T, _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_stochastic_rows_match_jax_with_injected_noise(dtype, symmetric,
                                                       bits):
    x = _x((8, 96), seed=bits)
    noise = np.random.default_rng(bits + 1).random((8, 96)).astype(
        np.float32)
    want = jax_quantizer._quantize_rows(jnp.asarray(x, JDT[dtype]), bits,
                                        symmetric, True, jnp.asarray(noise))
    got = quantizer._quantize_rows(torch.from_numpy(x).to(TDT[dtype]), bits,
                                   symmetric, True, torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), _np(want))


def _philox_reference(seed, index):
    """Philox4x32-10, first word, in Python integers."""
    m0, m1, w0, w1, mask = (0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85,
                            0xFFFFFFFF)
    c = [index & mask, index >> 32, 0, 0]
    k = [seed & mask, (seed >> 32) & mask]
    for r in range(10):
        if r:
            k = [(k[0] + w0) & mask, (k[1] + w1) & mask]
        p0, p1 = m0 * c[0], m1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & mask, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & mask]
    return c[0]


@pytest.mark.parametrize("seed", [0, 1, 2 ** 40 + 12345])
def test_philox_matches_reference(seed):
    index = [0, 1, 2, 255, 123456789, 2 ** 32 - 1, 2 ** 32 + 7, 2 ** 45 + 3]
    want = np.array([(_philox_reference(seed, i) >> 8) / 2 ** 24
                     for i in index])
    got = quantizer.philox_uniform(seed, torch.tensor(index)).double()
    np.testing.assert_array_equal(got.numpy(), want)
    # Random123's known answer for a zero counter and key
    assert _philox_reference(0, 0) == 0x6627E8D5


def test_stochastic_quantize_is_deterministic_per_seed():
    x = torch.from_numpy(_x((8, 64), seed=3))
    a = quantizer.quantize(x, 4, 8, stochastic=True, seed=7)
    b = quantizer.quantize(x, 4, 8, stochastic=True, seed=7)
    c = quantizer.quantize(x, 4, 8, stochastic=True, seed=8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="seed"):
        quantizer.quantize(x, 4, 8, stochastic=True)


# -- the cases of tests/unit/test_quantizer.py ------------------------------

def test_symmetric_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 256)).astype(np.float32))
    y = quantizer.quantize(x, num_bits=8, groups=4)
    step = x.reshape(4, -1).abs().amax(-1, keepdim=True) / 127
    assert ((y - x).reshape(4, -1).abs() <= step / 2 + 1e-6).all()


def test_asymmetric_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(1).random(
        (2, 512)).astype(np.float32))
    y = quantizer.quantize(x, num_bits=8, groups=2, symmetric=False)
    xg = x.reshape(2, -1)
    step = (xg.amax(-1, keepdim=True) - xg.amin(-1, keepdim=True)) / 255
    assert ((y - x).reshape(2, -1).abs() <= step / 2 + 1e-6).all()


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_levels(bits):
    x = torch.linspace(-1, 1, 1024)
    y = quantizer.quantize(x, num_bits=bits, groups=1)
    assert torch.unique(y).numel() <= 2 ** bits


def test_stochastic_rounding_unbiased():
    x = torch.full((1, 8192), 0.3)
    x[0, 0] = 1.0                         # scale 1/7 at 4 bits
    ys = torch.stack([quantizer.quantize(x, 4, 1, stochastic=True, seed=s)
                      for s in range(64)])
    # 64 · 8191 draws of a value 2.1 steps above a level: the mean of the
    # rounding lands within 1e-3 of 0.3
    assert abs(ys[:, 0, 1:].mean().item() - 0.3) < 1e-3


def test_zero_input_stable():
    for symmetric in (True, False):
        y = quantizer.quantize(torch.zeros(4, 32), 8, 4, symmetric)
        assert torch.equal(y, torch.zeros(4, 32))


def test_out_writes_in_place_and_shell_owns_its_seed():
    x = torch.from_numpy(_x((8, 32), seed=5))
    want = quantizer.quantize(x, 8, 8)
    y = x.clone()
    assert quantizer.quantize(y, 8, 8, out=y) is y
    assert torch.equal(y, want)
    shell = quantizer.Quantizer()
    assert shell.num_bits == 8 and quantizer.Quantizer(False).num_bits == 16
    a = shell.quantize(x, 8, stochastic=True)
    b = shell.quantize(x, 8, stochastic=True)
    assert shell._seed == 2 and not torch.equal(a, b)


def test_quantize_rejects_bad_arguments():
    x = torch.zeros(6, 5)
    with pytest.raises(ValueError, match="divisible"):
        quantizer.quantize(x, 8, 4)
    with pytest.raises(ValueError, match="num_bits"):
        quantizer.quantize(x, 0, 1)
    with pytest.raises(ValueError, match="2-D"):
        quantizer.quantize(torch.zeros(2, 3, 4), 8, 1, transposed=True)
