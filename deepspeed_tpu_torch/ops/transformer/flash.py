"""Flash attention forward: the Hopper kernel ``csrc/flash_fwd.cu`` and its
plain PyTorch version.

Counterpart of the forward half of
``deepspeed_tpu/ops/transformer/flash.py`` (``_flash_fwd``, both the
resident and the streaming Pallas kernels): softmax(q kᵀ · sm_scale) v
with an online softmax, returning the output and the fp32 log-sum-exp of
each query row. Layout ``[batch, heads, seq, head_dim]``. The lse is
``[B, H, Sq]``; the TPU kernels' lane-replicated ``[B·H, Sq, 8]`` layout
is not carried over. The backward comes with the training path; these
functions are forward-only and run under ``torch.no_grad``.
"""

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops._platform import use_kernel

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_fwd_plain(q, k, v, causal=True, sm_scale=None):
    """Masked dense attention with the same outputs as the kernel:
    (o in q.dtype, lse fp32 [B, H, Sq])."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        keep = (torch.arange(sk, device=q.device)[None, :] <=
                torch.arange(sq, device=q.device)[:, None] + (sk - sq))
        s = torch.where(keep, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.matmul(p.to(v.dtype), v).to(q.dtype)
    return o, lse


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, H, S, D] tensors")
    B, H, _, D = q.shape
    if k.shape[:2] != (B, H) or k.shape != v.shape or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= D <= 128:
        raise ValueError(f"flash kernel takes head dims up to 128, got {D}")
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError("flash kernel needs a contiguous head dim")


@torch.no_grad()
def flash_attention_fwd(q, k, v, causal=True, sm_scale=None):
    """(o [B, H, Sq, D] in q.dtype, lse [B, H, Sq] fp32).

    CUDA tensors launch the flash kernel; CPU tensors run
    :func:`flash_attention_fwd_plain`. q, k, v may be strided views (the
    head dim contiguous): the kernel reads them in place. ``o`` is a
    [B, H, Sq, D] view of a [B, Sq, H, D] buffer, so merging the heads
    afterwards costs no copy."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if not use_kernel(q, k, v):
        return flash_attention_fwd_plain(q, k, v, causal, sm_scale)
    _check(q, k, v)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    o = torch.empty((B, Sq, H, D), dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    # bf16 K/V rows load as whole 16-byte vectors when aligned
    vec = int(D % 8 == 0 and all(
        t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3])
        for t in (k, v)))
    lib = op_builder.load_kernels()
    err = lib.ds_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), _DTYPES[q.dtype], B, H, Sq, Sk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        float(sm_scale), int(bool(causal)), vec,
        torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check_launch(err, "flash_fwd")
    return o, lse


def flash_attention(q, k, v, causal=True, sm_scale=None):
    """Attention output only (no gradient)."""
    return flash_attention_fwd(q, k, v, causal, sm_scale)[0]


def flash_attention_with_lse(q, k, v, causal=True, sm_scale=None):
    """``(out, lse)`` with lse [B, H, Sq] fp32 (no gradient)."""
    return flash_attention_fwd(q, k, v, causal, sm_scale)
