"""Flash attention: the Hopper kernels ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``, their plain PyTorch versions, and the autograd
``Function`` that joins them.

Counterpart of ``deepspeed_tpu/ops/transformer/flash.py``: the forward
(``_flash_fwd``, resident and streaming Pallas kernels) computes
softmax(q kᵀ · sm_scale) v with an online softmax and returns the fp32
log-sum-exp of each query row; the backward (``_flash_bwd``) recomputes
the scores from q, k and the lse and writes dq, dk, dv. Layout
``[batch, heads, seq, head_dim]``, head dims 1..256 (the TPU kernels take
the whole head dim as one block; GPT-J's is 256). The lse is
``[B, H, Sq]``; the TPU kernels' lane-replicated ``[B·H, Sq, 8]`` layout
is not carried over.
"""

import ctypes

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops._platform import use_kernel

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _scores(q, k, causal, sm_scale):
    """fp32 q kᵀ · sm_scale with the causal mask offset by Sk − Sq (the
    query block is the suffix of the keys), masked to -1e30."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        keep = (torch.arange(sk, device=q.device)[None, :] <=
                torch.arange(sq, device=q.device)[:, None] + (sk - sq))
        s = torch.where(keep, s, NEG_INF)
    return s


def flash_attention_fwd_plain(q, k, v, causal=True, sm_scale=None):
    """Masked dense attention with the same outputs as the kernel:
    (o in q.dtype, lse fp32 [B, H, Sq]). A row that sees no key (Sq > Sk,
    causal) has no softmax: it gets o = 0 and lse = -1e30, the masking
    value (the JAX kernels give it the mean of v)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = _scores(q, k, causal, sm_scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    sq, sk = q.shape[2], k.shape[2]
    if causal and sq > sk:
        sees = torch.arange(sq, device=q.device) >= sq - sk
        lse = torch.where(sees, lse, NEG_INF)
        p = torch.where(sees[:, None], p, 0.0)
    o = torch.matmul(p.to(v.dtype), v).to(q.dtype)
    return o, lse


def _heads_view(B, S, H, D, like):
    """A [B, H, S, D] view of a fresh [B, S, H, D] buffer."""
    return torch.empty((B, S, H, D), dtype=like.dtype,
                       device=like.device).permute(0, 2, 1, 3)


def _aligned16(*tensors):
    return all(t.data_ptr() % 16 == 0 and
               all(st % 8 == 0 for st in t.stride()[:3]) for t in tensors)


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
    if not 1 <= D <= 256:
        raise ValueError(f"flash kernel takes head dims up to 256, got {D}")
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError("flash kernel needs a contiguous head dim")


def flash_attention_fwd(q, k, v, causal=True, sm_scale=None):
    """(o [B, H, Sq, D] in q.dtype, lse [B, H, Sq] fp32). No gradient
    flows through the kernel; :class:`FlashAttentionFunction` is the
    differentiable form.

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
    o = _heads_view(B, Sq, H, D, q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    # the q, k and v rows the kernel stages in shared memory load as
    # 16-byte vectors when aligned
    vec = int(D % 8 == 0 and _aligned16(q, k, v))
    lib = op_builder.load_kernels()
    err = lib.ds_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), _DTYPES[q.dtype], B, H, Sq, Sk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        float(sm_scale), int(bool(causal)), vec,
        torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check_launch(err, "flash_fwd")
    return o, lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                              sm_scale=None, return_delta=False, g_lse=None):
    """(dq, dk, dv) in the input dtypes: the formulas of the JAX backward
    (``_flash_bwd``, flash.py:444-574) on dense matrices, not the autograd
    of :func:`flash_attention_fwd_plain`. delta = rowsum(do·o) in fp32,
    minus ``g_lse`` (the lse cotangent [B, H, Sq], when given: since
    ∂lse_i/∂s_ij = p_ij, it folds into ds = p·(dp − delta) exactly);
    p = exp(s − lse) with the offset causal mask, and p = 0 on a row with
    no visible key (Sq > Sk, causal: its lse is the -1e30 masking value);
    dp = do·vᵀ; ds = p·(dp − delta)·sm_scale; dv = pᵀ·do with p rounded to
    the input dtype first; dq = ds·k and dk = dsᵀ·q with ds rounded first.
    The products accumulate in fp32, as the kernels' do. ``return_delta``
    appends delta [B, H, Sq] fp32."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    dt = q.dtype
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    lse = lse.float()[..., None]
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse)
    p = torch.where(lse <= NEG_INF / 2, 0.0, p)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * sm_scale
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dof)
    ds = ds.to(dt).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    grads = (dq.to(dt), dk.to(k.dtype), dv.to(v.dtype))
    return grads + (delta,) if return_delta else grads


def flash_attention_bwd(q, k, v, o, lse, do, causal=True, sm_scale=None,
                        return_delta=False, g_lse=None):
    """(dq, dk, dv) of flash attention, given the forward's o and lse, and
    ``g_lse``, the cotangent of the lse output (fp32 [B, H, Sq]; None:
    there is none).

    CUDA tensors launch the two kernels of ``csrc/flash_bwd.cu``: dq,
    which also computes delta = rowsum(do·o) − g_lse for its rows and
    writes it to an fp32 [B, H, Sq] buffer, then dk/dv, which reads it
    (``g_lse`` None passes a null pointer); CPU tensors run
    :func:`flash_attention_bwd_plain`. q, k, v and o may be strided views
    with a contiguous head dim; ``do`` is made contiguous only when its
    head dim is not. ``return_delta`` appends that delta."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if not use_kernel(q, k, v, o, lse, do, g_lse):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                         sm_scale, return_delta, g_lse)
    _check(q, k, v)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if o.stride(3) != 1:
        raise ValueError("flash backward needs o with a contiguous head dim")
    if do.stride(3) != 1:
        do = do.contiguous()
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 {(B, H, Sq)}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    lse = lse.contiguous()
    if g_lse is not None:
        if g_lse.shape != (B, H, Sq):
            raise ValueError(f"g_lse must be {(B, H, Sq)}, got "
                             f"{tuple(g_lse.shape)}")
        g_lse = g_lse.float().contiguous()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq = _heads_view(B, Sq, H, D, q)
    dk = _heads_view(B, Sk, H, D, k)
    dv = _heads_view(B, Sk, H, D, v)
    if dq.numel() == 0 or dk.numel() == 0:
        grads = (dq.zero_(), dk.zero_(), dv.zero_())
        return grads + (delta.zero_(),) if return_delta else grads
    strides = (ctypes.c_longlong * 24)(*(
        st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]))
    # every row the kernels stage in shared memory loads as 16-byte
    # vectors when aligned
    vec = int(D % 8 == 0 and _aligned16(q, k, v, o, do))
    lib = op_builder.load_kernels()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    for name, fn in (("flash_bwd_dq", lib.ds_flash_bwd_dq),
                     ("flash_bwd_dkv", lib.ds_flash_bwd_dkv)):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(),
                 None if g_lse is None else g_lse.data_ptr(),
                 delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 _DTYPES[q.dtype], B, H, Sq, Sk, D, strides,
                 float(sm_scale), int(bool(causal)), vec, stream)
        op_builder.check_launch(err, name)
    grads = (dq, dk, dv)
    return grads + (delta,) if return_delta else grads


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel, then the
    backward kernels on the saved q, k, v, o and lse (the ``custom_vjp``
    of the JAX ``flash_attention``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, sm_scale=None):
        if sm_scale is None:
            sm_scale = q.shape[-1] ** -0.5
        o, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True, sm_scale=None):
    """Attention output [B, H, Sq, D], differentiable in q, k and v."""
    return FlashAttentionFunction.apply(q, k, v, causal, sm_scale)


class FlashAttentionLseFunction(torch.autograd.Function):
    """Flash attention with ``(out, lse)`` outputs, differentiable in both
    (the ``custom_vjp`` of the JAX ``flash_attention_with_lse``,
    flash.py:578-596): the backward kernels take the lse cotangent as
    ``g_lse``. An output the loss does not reach gets no cotangent: no
    lse gradient passes the null pointer, so the gradients are
    :class:`FlashAttentionFunction`'s bit for bit."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, sm_scale=None):
        if sm_scale is None:
            sm_scale = q.shape[-1] ** -0.5
        o, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.sm_scale, g_lse=g_lse)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal=True, sm_scale=None):
    """``(out, lse)`` with lse [B, H, Sq] fp32, differentiable in q, k and
    v through both outputs (the building block of ring attention's
    lse-weighted merge, ``ops/transformer/ring.py``)."""
    return FlashAttentionLseFunction.apply(q, k, v, causal, sm_scale)
