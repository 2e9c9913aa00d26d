"""Multi-head attention: dispatcher between the flash kernel and the plain
masked dense attention.

Counterpart of ``deepspeed_tpu/ops/transformer/attention.py``. Layout
``[batch, heads, seq, head_dim]`` throughout.
"""

import torch

from deepspeed_tpu_torch.ops._platform import use_kernel

NEG_INF = -1e30


def mha_reference(q, k, v, *, causal=True, sm_scale=None, bias=None,
                  mask=None):
    """Plain masked dense attention: the parity oracle and the CPU path.

    q, k, v: [B, H, S, D]; bias broadcastable to [B, H, Sq, Sk]; mask is a
    boolean tensor broadcastable to the same (True = keep). Masked scores
    are -1e30 (not -inf), as in the JAX package, and the causal mask is
    offset by Sk - Sq so a query block may be the suffix of the keys."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        causal_mask = (torch.arange(sk, device=q.device)[None, :] <=
                       torch.arange(sq, device=q.device)[:, None] + (sk - sq))
        logits = torch.where(causal_mask, logits, NEG_INF)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(v.dtype), v)


def attention(q, k, v, *, causal=True, sm_scale=None, bias=None, mask=None):
    """Attention on q, k, v [B, H, S, D].

    On CUDA tensors, attention with no bias and no mask always runs the
    flash kernels through :class:`flash.FlashAttentionFunction`, so
    gradients flow to q, k and v; the JAX package's TPU-measured 512-token
    crossover is not carried over (the crossover on the H100 is still to
    be measured). Biased or masked attention, and every CPU call, runs
    :func:`mha_reference`."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if bias is None and mask is None and use_kernel(q, k, v):
        from deepspeed_tpu_torch.ops.transformer import flash
        return flash.flash_attention(q, k, v, causal=causal,
                                     sm_scale=sm_scale)
    return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                         bias=bias, mask=mask)
