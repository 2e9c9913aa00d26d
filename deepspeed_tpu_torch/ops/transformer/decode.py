"""Decode attention over a KV cache: the Hopper kernel
``csrc/decode_attention.cu`` (fp and int8-KV forms) and its plain PyTorch
version.

Counterpart of ``deepspeed_tpu/ops/transformer/decode.py``: one query
token per sequence attends to a linear [B, H, T, D] cache of live length
``cache_len`` (a scalar, or a [B] vector of per-sequence lengths). The
kernel reads the single query row as one row (no 8-row replication) and
masks the cache tail (no pad copy), so any allocated T works.
"""

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops._platform import use_kernel
from deepspeed_tpu_torch.ops.transformer.attention import mha_reference

BLOCK_K = 512  # the JAX package's kv tile; kept for the cache sizing rule
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def aligned_cache_len(n_positions: int) -> int:
    """Cache allocation size, as in the JAX package: a BLOCK_K multiple
    when larger than one block, else a 16-multiple."""
    if n_positions > BLOCK_K:
        return -(-n_positions // BLOCK_K) * BLOCK_K
    return -(-n_positions // 16) * 16


def _lengths(cache_len, B, device):
    """cache_len (int, 0-d or [B] tensor) -> int32 tensor on ``device``."""
    lens = torch.as_tensor(cache_len, dtype=torch.int32)
    if lens.dim() not in (0, 1):
        raise ValueError(
            f"cache_len must be a scalar or a [B] vector, got {lens.shape}")
    if lens.dim() == 1 and lens.shape[0] != B:
        raise ValueError(f"per-sequence cache_len has {lens.shape[0]} "
                         f"entries for batch {B}")
    return lens.to(device, non_blocking=True)


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


@torch.no_grad()
def decode_attention(q, k_cache, v_cache, cache_len, *, k_scale=None,
                     v_scale=None, sm_scale=None):
    """softmax(q·K[:len]ᵀ)·V[:len] for one decode step.

    q: [B, H, 1, D] (a strided view is fine: the head dim contiguous);
    k_cache/v_cache: contiguous [B, H, T, D]; cache_len: int32 scalar or
    [B] vector (an int, or a tensor, preferably already on the device).
    The current token's K/V must already be written. With
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
    lens = _lengths(cache_len, B, q.device)
    if not use_kernel(q, k_cache, v_cache, k_scale, v_scale):
        return decode_attention_plain(q, k_cache, v_cache, lens,
                                      k_scale=k_scale, v_scale=v_scale,
                                      sm_scale=sm_scale)
    T = k_cache.shape[2]
    cache_dtype = torch.int8 if quantized else q.dtype
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if not 1 <= D <= 128:
        raise ValueError(f"decode kernel takes head dims up to 128, got {D}")
    for c in (k_cache, v_cache):
        if c.shape != (B, H, T, D) or c.dtype != cache_dtype \
                or not c.is_contiguous():
            raise ValueError(f"cache must be a contiguous [B, H, T, D] "
                             f"{cache_dtype} tensor, got {tuple(c.shape)} "
                             f"{c.dtype}")
    if quantized:
        for s in (k_scale, v_scale):
            if s.shape != (B, H, T) or s.dtype != torch.float32 \
                    or not s.is_contiguous():
                raise ValueError("scales must be contiguous fp32 [B, H, T]")
    if q.stride(3) != 1:
        raise ValueError("decode kernel needs a contiguous head dim")
    o = torch.empty((B, 1, H, D), dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    if o.numel() == 0:
        return o
    # vector loads need whole, aligned 8-element rows
    vec = int(D % 8 == 0 and k_cache.data_ptr() % 16 == 0
              and v_cache.data_ptr() % 16 == 0)
    lib = op_builder.load_kernels()
    err = lib.ds_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        lens.data_ptr(), int(lens.dim() == 1), o.data_ptr(),
        _DTYPES[q.dtype], int(quantized), B, H, T, D,
        q.stride(0), q.stride(1), o.stride(0), o.stride(1),
        float(sm_scale), vec,
        torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check_launch(
        err, "decode_attention_int8" if quantized else "decode_attention")
    return o


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
