"""Decode attention over a KV cache: the Hopper kernel
``csrc/decode_attention.cu`` (fp and int8-KV forms) and its plain PyTorch
version.

Counterpart of ``deepspeed_tpu/ops/transformer/decode.py``: one query
token per sequence attends to a linear [B, H, T, D] cache of live length
``cache_len`` (a scalar, or a [B] vector of per-sequence lengths). The
kernel reads the single query row as one row (no 8-row replication) and
masks the cache tail (no pad copy), so any allocated T works. It splits
each row's cache walk over ``splits`` CTAs (:func:`split_plan`) and
merges their partials in the same launch, in split order.

The wrapper runs once per layer and token on a path whose device work is
a few microseconds, so its host cost counts: a device int32 ``cache_len``
is used as it is, each tensor gets one shape/dtype/contiguity test, the
scratch and counter buffers are cached per device and stream, and the
launch's arguments go to the C entry packed in one struct.
"""

import math
import struct

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops._platform import use_kernel
from deepspeed_tpu_torch.ops.transformer.attention import mha_reference

BLOCK_K = 512  # the JAX package's kv tile; kept for the cache sizing rule
CHUNK_ALIGN = 64  # a split's chunk of keys is a multiple of this
# split a row's walk only while B·H < SPLIT_BELOW · SMs, into enough
# splits for about SPLIT_CTAS_PER_SM CTAs an SM (tests/perf/
# torch_decode_softmax_variants.py: at B 8 × H 16 one CTA a row beats 2 or
# 3 splits, at B 1 8 splits of 128 keys beat 16 of 64 or 4 of 256)
SPLIT_BELOW = 0.5
SPLIT_CTAS_PER_SM = 1
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/decode_attention.cu DecodeArgs: q, k, v, k_scale, v_scale, lens, o,
# part, counters; q_sb, q_sh, o_sb, o_sh; B, H, T, D, chunk, splits,
# per_seq, dtype, quantized, vec; sm_scale; pad
_ARGS = struct.Struct("<9Q4q10ifi")
_SM_COUNT = {}  # device index -> SMs
_PLANS = {}     # (B * H, T, SMs) -> (splits, chunk)
_SCRATCH = {}   # (device index, stream) -> (part, counters, their pointers)


def aligned_cache_len(n_positions: int) -> int:
    """Cache allocation size, as in the JAX package: a BLOCK_K multiple
    when larger than one block, else a 16-multiple."""
    if n_positions > BLOCK_K:
        return -(-n_positions // BLOCK_K) * BLOCK_K
    return -(-n_positions // 16) * 16


def split_plan(bh: int, T: int, sms: int):
    """(splits, chunk) of the kernel's walk over a [.., T, D] cache with
    ``bh`` (batch, head) rows on a card of ``sms`` SMs: one split once
    ``bh`` fills SPLIT_BELOW of the SMs, else enough splits for about
    SPLIT_CTAS_PER_SM CTAs an SM, each a chunk of a multiple of 64 keys.
    From the allocation alone, never the live length: no host sync, and
    the launch can be graph-captured."""
    if bh >= SPLIT_BELOW * sms or T <= CHUNK_ALIGN:
        return 1, max(T, 1)
    splits = min(math.ceil(SPLIT_CTAS_PER_SM * sms / bh),
                 -(-T // CHUNK_ALIGN))
    if splits <= 1:
        return 1, max(T, 1)
    chunk = -(-T // splits)
    chunk = -(-chunk // CHUNK_ALIGN) * CHUNK_ALIGN
    return -(-T // chunk), chunk


def _lengths(cache_len, B, device):
    """cache_len (int, 0-d or [B] tensor) -> int32 tensor on ``device``;
    an int32 tensor already there is returned as it is."""
    if (type(cache_len) is torch.Tensor and cache_len.dtype == torch.int32
            and cache_len.device == device):
        lens = cache_len
    else:
        lens = torch.as_tensor(cache_len, dtype=torch.int32)
    if lens.dim() not in (0, 1):
        raise ValueError(
            f"cache_len must be a scalar or a [B] vector, got {lens.shape}")
    if lens.dim() == 1 and lens.shape[0] != B:
        raise ValueError(f"per-sequence cache_len has {lens.shape[0]} "
                         f"entries for batch {B}")
    return lens if lens is cache_len else lens.to(device, non_blocking=True)


def decode_attention_plain(q, k_cache, v_cache, lens, *, k_scale=None,
                           v_scale=None, sm_scale=None):
    """Masked dense attention over the cache (the JAX package's non-kernel
    branch): int8 caches are dequantized first, then
    :func:`mha_reference` runs with the live-length mask."""
    T = k_cache.shape[2]
    k, v = k_cache, v_cache
    if k_scale is not None:
        k = (k.float() * k_scale[..., None]).to(q.dtype)
        v = (v.float() * v_scale[..., None]).to(q.dtype)
    cols = torch.arange(T, device=q.device)
    if lens.dim() == 1:
        mask = cols[None, None, None, :] < lens[:, None, None, None]
    else:
        mask = (cols < lens)[None, None, None, :]
    return mha_reference(q, k, v, causal=False, sm_scale=sm_scale, mask=mask)


def _plan(device, bh, T):
    """split_plan on ``device``'s SM count, cached."""
    idx = device.index
    sms = _SM_COUNT.get(idx)
    if sms is None:
        sms = _SM_COUNT[idx] = torch.cuda.get_device_properties(
            device).multi_processor_count
    key = (bh, T, sms)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = split_plan(bh, T, sms)
    return plan


def _scratch(device, stream, n_part, n_rows):
    """Pointers of the fp32 partials (>= n_part floats) and the int32
    per-row counters (>= n_rows, zero between launches: the kernel resets
    what it counts) for launches on ``stream``, grown when too small."""
    key = (device.index, stream)
    s = _SCRATCH.get(key)
    if s is None or s[0].numel() < n_part or s[1].numel() < n_rows:
        part = torch.empty(max(n_part, 0 if s is None else s[0].numel()),
                           dtype=torch.float32, device=device)
        counters = torch.zeros(max(n_rows, 0 if s is None else
                                   s[1].numel()),
                               dtype=torch.int32, device=device)
        s = _SCRATCH[key] = (part, counters, part.data_ptr(),
                             counters.data_ptr())
    return s[2], s[3]


def _stream(device):
    """The current stream's handle on ``device``: PyTorch's raw query, as
    its own kernel launchers use, without building a ``torch.cuda.Stream``
    (3-5 µs a call on the card's host, tests/perf/
    torch_decode_softmax_variants.py)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def decode_attention(q, k_cache, v_cache, cache_len, *, k_scale=None,
                     v_scale=None, sm_scale=None):
    """softmax(q·K[:len]ᵀ)·V[:len] for one decode step.

    q: [B, H, 1, D] (a strided view is fine: the head dim contiguous);
    k_cache/v_cache: contiguous [B, H, T, D]; cache_len: int32 scalar or
    [B] vector (an int, or a tensor, preferably already on the device as
    int32). The current token's K/V must already be written. With
    ``k_scale``/``v_scale`` ([B, H, T] fp32 per-row scales) the caches
    are int8. Returns [B, H, 1, D] in q.dtype.

    CUDA tensors launch the kernel; CPU tensors run
    :func:`decode_attention_plain`."""
    B, H, Sq, D = q.shape
    if Sq != 1:
        raise ValueError(f"decode_attention takes one query token, got {Sq}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if sm_scale is None:
        sm_scale = D ** -0.5
    device = q.device
    lens = _lengths(cache_len, B, device)
    if not use_kernel(q, k_cache, v_cache, k_scale, v_scale):
        with torch.no_grad():
            return decode_attention_plain(q, k_cache, v_cache, lens,
                                          k_scale=k_scale, v_scale=v_scale,
                                          sm_scale=sm_scale)
    dtype = _DTYPES.get(q.dtype)
    if dtype is None:
        raise TypeError(f"decode kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if not 1 <= D <= 128:
        raise ValueError(f"decode kernel takes head dims up to 128, got {D}")
    T = k_cache.shape[2]
    shape = (B, H, T, D)
    cache_dtype = torch.int8 if quantized else q.dtype
    for c in (k_cache, v_cache):
        if c.shape != shape or c.dtype != cache_dtype \
                or not c.is_contiguous():
            raise ValueError(f"cache must be a contiguous [B, H, T, D] "
                             f"{cache_dtype} tensor, got {tuple(c.shape)} "
                             f"{c.dtype}")
    if quantized:
        for s in (k_scale, v_scale):
            if s.shape != shape[:3] or s.dtype != torch.float32 \
                    or not s.is_contiguous():
                raise ValueError("scales must be contiguous fp32 [B, H, T]")
    if q.stride(3) != 1:
        raise ValueError("decode kernel needs a contiguous head dim")
    o = torch.empty_strided((B, H, 1, D), (H * D, D, H * D, 1),
                            dtype=q.dtype, device=device)
    if o.numel() == 0:
        return o
    args, stream = _launch_args(q, k_cache, v_cache, k_scale, v_scale, lens,
                                o, dtype, sm_scale)
    err = op_builder.load_kernels().ds_decode_attention(args, stream)
    op_builder.check_launch(
        err, "decode_attention_int8" if quantized else "decode_attention")
    return o


def _launch_args(q, k_cache, v_cache, k_scale, v_scale, lens, o, dtype,
                 sm_scale):
    """(the packed DecodeArgs, the current stream) of one launch on
    checked inputs: the split plan, the cached scratch and counters, and
    vector loads where the cache rows are whole aligned 16-byte vectors."""
    B, H, _, D = q.shape
    T = k_cache.shape[2]
    device = q.device
    bh = B * H
    splits, chunk = _plan(device, bh, T)
    stream = _stream(device)
    part = counters = 0
    if splits > 1:
        part, counters = _scratch(device, stream, bh * splits * (2 + D), bh)
    k_ptr, v_ptr = k_cache.data_ptr(), v_cache.data_ptr()
    vec = int(D * k_cache.element_size() % 16 == 0
              and (k_ptr | v_ptr) % 16 == 0)
    quantized = k_scale is not None
    return _ARGS.pack(
        q.data_ptr(), k_ptr, v_ptr,
        k_scale.data_ptr() if quantized else 0,
        v_scale.data_ptr() if quantized else 0,
        lens.data_ptr(), o.data_ptr(), part, counters,
        q.stride(0), q.stride(1), o.stride(0), o.stride(1),
        B, H, T, D, chunk, splits, int(lens.dim() == 1), dtype,
        int(quantized), vec, float(sm_scale), 0), stream


# ------------------------------------------------------- int8 KV cache path
def quantize_kv(kv):
    """Per-row absmax int8 quantization of new K/V entries: [B, H, S, D]
    -> (int8 values, fp32 scales [B, H, S]). Rounds half to even and
    clips to ±127, with a zero-scale guard, as the JAX package does."""
    x = kv.float()
    scale = x.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale == 0.0, 1.0, scale)
    q = torch.clamp(torch.round(x / safe[..., None]), -127, 127)
    return q.to(torch.int8), torch.where(scale == 0.0, 0.0, safe)


def decode_attention_quantized(q, k_int, k_scale, v_int, v_scale, cache_len,
                               *, sm_scale=None):
    """softmax(q·dequant(K)[:len]ᵀ)·dequant(V)[:len] over an int8 cache —
    the named entry point for the int8 form of :func:`decode_attention`."""
    return decode_attention(q, k_int, v_int, cache_len, k_scale=k_scale,
                            v_scale=v_scale, sm_scale=sm_scale)
