"""Grouped fake-quantization for MoQ: the Hopper kernel of
``csrc/quantizer.cu``, its plain PyTorch version, and the ``Quantizer``
shell (counterpart of ``deepspeed_tpu/ops/quantizer/quantizer.py``).

The tensor is viewed as ``groups`` equal rows in the reference layout;
each row is quantized to ``num_bits`` symmetrically (scale = absmax /
qmax) or asymmetrically (min/max affine), rounded to nearest even or
stochastically, and at once dequantized into the input's dtype.

``transposed=True`` says that ``x`` (2-D) is stored as the transpose of
the reference layout: the port keeps dense weights ``[out, in]`` where
flax keeps ``[in, out]``, and MoQ groups blocks of the flax tensor's
rows, so the groups are taken over ``x.t()``. The kernel walks that
layout in place; nothing is copied unless the column count is not a
multiple of ``groups`` (a group then ends inside a reference row), where
the wrapper quantizes a transposed copy.

Stochastic rounding draws its noise from Philox4x32-10, keyed by
``seed`` with each element's index in the reference layout as the
counter: the kernel and :func:`philox_uniform` (int64 PyTorch, 16-bit
limbs) give the same bits, so the two routes agree exactly on the card
and the CPU route is deterministic per seed. The TPU kernel draws from
the TPU's own generator, so parity with the JAX package holds only for
noise injected into :func:`_quantize_rows` on both sides. There is no
module-level seed counter: a caller that wants fresh noise on every call
passes a new ``seed`` (the MoQ schedule and :class:`Quantizer` own one).

CUDA tensors (fp32 or bf16) launch ``ds_quantize``; CPU tensors run
:func:`quantize_plain`.
"""

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops._platform import use_kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC_ELEMS = {torch.float32: 4, torch.bfloat16: 8}   # one 16-byte vector
CHUNK = 8192   # elements of one row a block of the kernel takes

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _qrange(num_bits, symmetric):
    if symmetric:
        return float(2 ** (num_bits - 1) - 1)
    return float(2 ** num_bits - 1)


def _quantize_rows(x, num_bits, symmetric, stochastic, noise):
    """The shared math (JAX quantizer.py:40-65) over rows: x is
    [groups, row]; noise in [0, 1) of the same shape, or None. Returns
    fp32. The divisions by qmax take a tensor divisor: PyTorch's CUDA
    division by a host scalar multiplies by its reciprocal, which is not
    the IEEE quotient."""
    xf = x.float()
    if symmetric:
        qmax = _qrange(num_bits, True)
        absmax = xf.abs().amax(-1, keepdim=True)
        scale = absmax / torch.full_like(absmax, qmax)
        scale = torch.where(scale == 0.0, 1.0, scale)
        q = xf / scale
        q = torch.floor(q + noise) if stochastic else torch.round(q)
        return torch.clamp(q, -qmax - 1, qmax) * scale
    qmax = _qrange(num_bits, False)
    lo = xf.amin(-1, keepdim=True)
    hi = xf.amax(-1, keepdim=True)
    scale = (hi - lo) / torch.full_like(lo, qmax)
    scale = torch.where(scale == 0.0, 1.0, scale)
    q = (xf - lo) / scale
    q = torch.floor(q + noise) if stochastic else torch.round(q)
    return torch.clamp(q, 0, qmax) * scale + lo


def _mulhilo(a, m):
    """(hi, lo) 32-bit words of a * m for int64 ``a`` < 2^32 and a 32-bit
    constant ``m``, without overflowing int64: m is split into 16-bit
    limbs, so each partial product is below 2^48."""
    t = a * (m & 0xFFFF)
    u = a * (m >> 16)
    lo = (((u & 0xFFFF) << 16) + t) & _MASK32
    hi = (u + (t >> 16)) >> 16
    return hi, lo


def philox_uniform(seed, index):
    """Uniforms in [0, 1) with 24 random bits: Philox4x32-10 keyed by the
    64-bit ``seed``, counter (index_lo, index_hi, 0, 0) for each int64
    element of ``index``, first output word ``>> 8`` times 2^-24 (the TPU
    kernel's construction, quantizer.py:72). Bit-equal to the kernel's
    draw."""
    c0, c1 = index & _MASK32, index >> 32
    c2 = c3 = torch.zeros_like(index)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return (c0 >> 8).float() * (1.0 / (1 << 24))


def _check(x, num_bits, groups, stochastic, seed, transposed):
    if not (isinstance(num_bits, int) and 1 <= num_bits <= 16):
        raise ValueError(f"num_bits must be an int in 1..16, got {num_bits}")
    if groups < 1 or x.numel() % groups:
        raise ValueError(f"numel {x.numel()} not divisible by groups "
                         f"{groups}")
    if stochastic and seed is None:
        raise ValueError("stochastic rounding needs a seed (the caller owns "
                         "the counter that makes it fresh)")
    if transposed and x.dim() != 2:
        raise ValueError(f"transposed=True takes a 2-D tensor, got shape "
                         f"{tuple(x.shape)}")


def quantize_plain(x, num_bits=8, groups=1, symmetric=True, stochastic=False,
                   seed=None, transposed=False):
    """The plain version of :func:`quantize`: a new tensor of x's shape
    and dtype."""
    _check(x, num_bits, groups, stochastic, seed, transposed)
    ref = x.t() if transposed else x
    xg = ref.reshape(groups, -1)
    noise = None
    if stochastic:
        index = torch.arange(x.numel(), device=x.device).view(xg.shape)
        noise = philox_uniform(int(seed), index)
    y = _quantize_rows(xg, num_bits, symmetric, stochastic,
                       noise).to(x.dtype).view(ref.shape)
    return y.t() if transposed else y


def quantize(x, num_bits=8, groups=1, symmetric=True, stochastic=False,
             seed=None, *, transposed=False, out=None):
    """Fake-quantize ``x`` (the reference's ``quantize``): returns a
    tensor of x's shape and dtype, ``out`` when given (``out=x``
    quantizes in place). ``ds_quantize`` on CUDA tensors (two launches:
    the per-block stats, then the scale and the rounding),
    :func:`quantize_plain` on CPU tensors."""
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if not use_kernel(x, out):
        y = quantize_plain(x, num_bits, groups, symmetric, stochastic, seed,
                           transposed)
        return y if out is None else out.copy_(y)
    _check(x, num_bits, groups, stochastic, seed, transposed)
    if x.dtype not in _DTYPES:
        raise TypeError(f"quantize kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if out is not None and not out.is_contiguous():
        raise ValueError("quantize kernel writes a contiguous out")
    if transposed and x.shape[1] % groups:
        # a group ends inside a reference row: quantize the reference
        # layout itself
        y = quantize(x.t().contiguous(), num_bits, groups, symmetric,
                     stochastic, seed).t()
        return y if out is None else out.copy_(y)
    x = x.contiguous()
    y = torch.empty_like(x) if out is None else out
    n = x.numel()
    if n == 0:
        return y
    group_len = n // groups
    blocks = groups * -(-group_len // CHUNK)
    partial = torch.empty(2 * blocks, dtype=torch.float32, device=x.device)
    rows, cols = x.shape if transposed else (n, 1)
    width = cols // groups if transposed else group_len
    vec = int(width % _VEC_ELEMS[x.dtype] == 0 and x.data_ptr() % 16 == 0
              and y.data_ptr() % 16 == 0)
    err = op_builder.load_kernels().ds_quantize(
        x.data_ptr(), y.data_ptr(), partial.data_ptr(), partial.numel(), n,
        groups, int(transposed), rows, cols, num_bits, int(symmetric),
        int(stochastic), 0 if seed is None else int(seed) & (2 ** 64 - 1),
        _DTYPES[x.dtype], vec, torch.cuda.current_stream(x.device).cuda_stream)
    op_builder.check_launch(err, "quantize")
    return y


class Quantizer:
    """API shell of the reference ``Quantizer`` (JAX quantizer.py:125).
    Owns the seed counter that keeps stochastic rounding fresh from call
    to call when no seed is given."""

    def __init__(self, q_int8=True):
        self.num_bits = 8 if q_int8 else 16
        self._seed = 0

    def quantize(self, x, groups=1, symmetric=True, stochastic=False,
                 seed=None):
        if seed is None:
            self._seed += 1
            seed = self._seed
        return quantize(x, num_bits=self.num_bits, groups=groups,
                        symmetric=symmetric, stochastic=stochastic, seed=seed)
