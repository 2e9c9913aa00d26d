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

:func:`quantize_multi` fake-quantizes a list of tensors (a MoQ step's
masters) in one call of ``ds_quantize_multi``: the table of tensors
travels by value in the kernels' parameters (up to ``MAX_TENSORS`` a
call), and two launches take every chunk's statistics, then round every
chunk. The table's scratch and counters are cached per tensor signature,
device and stream. :func:`quantize` is the call with one tensor.

Stochastic rounding draws its noise from Philox4x32-10, keyed by
``seed`` with each element's index in the reference layout as the
counter: the kernel and :func:`philox_uniform` (int64 PyTorch, 16-bit
limbs) give the same bits, so the two routes agree exactly on the card
and the CPU route is deterministic per seed. The TPU kernel draws from
the TPU's own generator, so parity with the JAX package holds only for
noise injected into :func:`_quantize_rows` on both sides. There is no
module-level seed counter: a caller that wants fresh noise on every call
passes a new ``seed`` (the MoQ schedule and :class:`Quantizer` own one).

CUDA tensors (fp32 or bf16) launch the kernel; CPU tensors run
:func:`quantize_plain`.
"""

import ctypes

import numpy as np
import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops._platform import use_kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC_ELEMS = {torch.float32: 4, torch.bfloat16: 8}   # one 16-byte vector
# csrc/quantizer.cu: elements of one group a chunk (kChunk) and tensors a
# call (kMaxTensors)
CHUNK = 16384
MAX_TENSORS = 320
_BF16, _TRANSPOSED, _VEC = 1, 2, 4   # the table's flags

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


def _each(value, n, name):
    """A per-tensor list from a scalar or a sequence of n values."""
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"{name}: {len(value)} values for {n} tensors")
        return list(value)
    return [value] * n


def quantize_multi_plain(tensors, num_bits=8, groups=1, symmetric=True,
                         stochastic=False, seeds=None, *, transposed=False,
                         out=None):
    """The plain version of :func:`quantize_multi`: :func:`quantize_plain`
    on each tensor (copied into ``out[i]`` when ``out`` is given)."""
    n = len(tensors)
    bits, groups = _each(num_bits, n, "num_bits"), _each(groups, n, "groups")
    seeds = _each(seeds, n, "seeds")
    transposed = _each(transposed, n, "transposed")
    ys = [quantize_plain(x, b, g, symmetric, stochastic, sd, tr)
          for x, b, g, sd, tr in zip(tensors, bits, groups, seeds,
                                     transposed)]
    if out is None:
        return ys
    return [o.copy_(y) for o, y in zip(out, ys)]


def plan_calls(specs, max_tensors=MAX_TENSORS):
    """The kernel calls of one multi-tensor call. ``specs``: (numel,
    groups) of each tensor, in order. Returns a list of (first, stop,
    chunks, groups): the call takes tensors [first, stop) (at most
    ``max_tensors``), whose groups are cut into ``chunks`` chunks of
    ``CHUNK`` elements, numbered tensor by tensor as the kernel numbers
    them."""
    calls = []
    for first in range(0, len(specs), max_tensors):
        stop = min(first + max_tensors, len(specs))
        chunks = sum(g * -(-(n // g) // CHUNK) for n, g in specs[first:stop])
        groups = sum(g for _, g in specs[first:stop])
        calls.append((first, stop, chunks, groups))
    return calls


class _MultiPlan:
    """The kernel calls of one tensor signature on one device and stream:
    the table rows (host int64 [n, 9]: x, y, numel, groups, R, C, bits,
    flags, seed; pointers, bits and seeds are filled in on every call),
    and each call's partials, scales and arrival counters on the device
    (the counters start at 0 and every call leaves them at 0)."""

    def __init__(self, signature, device):
        n = len(signature)
        self.rows = np.zeros((n, 9), np.int64)
        for i, (numel, groups, dtype, tr, rows, cols, vec) in \
                enumerate(signature):
            self.rows[i, 2:6] = (numel, groups, rows, cols)
            self.rows[i, 7] = (_BF16 if dtype == torch.bfloat16 else 0) | \
                (_TRANSPOSED if tr else 0) | (_VEC if vec else 0)
        self.calls = [(
            first, stop,
            torch.empty(2 * chunks, dtype=torch.float32, device=device),
            torch.empty(2 * groups, dtype=torch.float32, device=device),
            torch.zeros(groups, dtype=torch.int32, device=device),
            chunks, groups)
            for first, stop, chunks, groups in plan_calls(
                [sig[:2] for sig in signature])]


_multi_cache = {}


def quantize_multi(tensors, num_bits=8, groups=1, symmetric=True,
                   stochastic=False, seeds=None, *, transposed=False,
                   out=None):
    """Fake-quantize every tensor of ``tensors`` (the reference's
    ``quantize`` on each): ``num_bits``, ``groups``, ``seeds`` and
    ``transposed`` are one value for all or one a tensor. Returns the list
    of results, ``out`` when given (``out=tensors`` quantizes in place).
    CUDA tensors: one call of ``ds_quantize_multi`` for up to
    ``MAX_TENSORS`` tensors; CPU tensors: :func:`quantize_multi_plain`.
    The tensors must not overlap."""
    tensors = list(tensors)
    n = len(tensors)
    bits, groups = _each(num_bits, n, "num_bits"), _each(groups, n, "groups")
    seeds = _each(seeds, n, "seeds")
    transposed = _each(transposed, n, "transposed")
    if out is not None:
        out = list(out)
        if len(out) != n:
            raise ValueError(f"out: {len(out)} tensors for {n}")
        for x, o in zip(tensors, out):
            if o.shape != x.shape or o.dtype != x.dtype:
                raise ValueError(f"out {tuple(o.shape)} {o.dtype} must match "
                                 f"x {tuple(x.shape)} {x.dtype}")
    if not n or not use_kernel(*tensors, *(out or ())):
        return quantize_multi_plain(tensors, bits, groups, symmetric,
                                    stochastic, seeds, transposed=transposed,
                                    out=out)
    results, srcs, dsts, sig, copies, keep = [], [], [], [], [], []
    for i, x in enumerate(tensors):
        g, tr = groups[i], transposed[i]
        _check(x, bits[i], g, stochastic, seeds[i], tr)
        if x.dtype not in _DTYPES:
            raise TypeError(f"quantize kernel takes float32 or bfloat16, got "
                            f"{x.dtype}")
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device) \
            if out is None else out[i]
        if not y.is_contiguous():
            raise ValueError("quantize kernel writes a contiguous out")
        results.append(y)
        if x.numel() == 0:
            continue
        if tr and x.shape[1] % g:
            # a group ends inside a reference row: quantize the reference
            # layout itself
            src = x.t().contiguous()
            dst = torch.empty_like(src)
            copies.append((y, dst))
            tr = False
        else:
            src, dst = x.contiguous(), y
        rows, cols = src.shape if tr else (0, 0)
        width = cols // g if tr else src.numel() // g
        vec = width % _VEC_ELEMS[x.dtype] == 0 and \
            src.data_ptr() % 16 == 0 and dst.data_ptr() % 16 == 0
        srcs.append(src)
        dsts.append(dst)
        sig.append((src.numel(), g, x.dtype, tr, rows, cols, vec))
        keep.append(i)
    if srcs:
        _launch_multi(srcs, dsts, tuple(sig), [bits[i] for i in keep],
                      [seeds[i] for i in keep], symmetric, stochastic)
    for y, dst in copies:
        y.copy_(dst.t())
    return results


def _launch_multi(srcs, dsts, signature, bits, seeds, symmetric, stochastic):
    """The calls of ``ds_quantize_multi`` for contiguous ``srcs`` into
    ``dsts`` (``signature``: the plan's key, one entry a tensor)."""
    device = srcs[0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (signature, str(device), stream)
    plan = _multi_cache.get(key)
    if plan is None:
        plan = _multi_cache[key] = _MultiPlan(signature, device)
    rows = plan.rows
    rows[:, 0] = [t.data_ptr() for t in srcs]
    rows[:, 1] = [t.data_ptr() for t in dsts]
    rows[:, 6] = bits
    # the 64-bit seed's bits in an int64 cell
    rows[:, 8] = [0 if sd is None else (int(sd) + 2 ** 63) % 2 ** 64 - 2 ** 63
                  for sd in seeds] if stochastic else 0
    lib = op_builder.load_kernels()
    for first, stop, partial, scale, count, chunks, groups in plan.calls:
        err = lib.ds_quantize_multi(
            rows[first:stop].ctypes.data_as(ctypes.c_void_p), stop - first,
            partial.data_ptr(), scale.data_ptr(), count.data_ptr(), chunks,
            groups, int(symmetric), int(stochastic), stream)
        op_builder.check_launch(err, "quantize")


def quantize(x, num_bits=8, groups=1, symmetric=True, stochastic=False,
             seed=None, *, transposed=False, out=None):
    """Fake-quantize ``x`` (the reference's ``quantize``): returns a
    tensor of x's shape and dtype, ``out`` when given (``out=x``
    quantizes in place). :func:`quantize_multi` with one tensor."""
    return quantize_multi([x], num_bits, groups, symmetric, stochastic,
                          [seed], transposed=transposed,
                          out=None if out is None else [out])[0]


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
