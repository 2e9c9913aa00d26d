"""Fused LayerNorm, bias-GeLU and the scaled softmax: the Hopper kernels of
``csrc/fused.cu``, their plain PyTorch versions, and the autograd
``Function``s that join them (counterpart of
``deepspeed_tpu/ops/transformer/fused.py``).

* :func:`fused_layer_norm`: the forward kernel returns y, mu and rstd; the
  backward kernel returns dx from the saved x, mu and rstd; dgamma and
  dbeta are plain fp32 sums, as the JAX ``_ln_bwd`` leaves them to XLA.
* :func:`fused_bias_gelu`: the forward kernel computes the tanh GeLU of
  x + bias; the backward is the explicit formula of the JAX
  ``_bias_gelu_bwd`` in plain torch (the JAX package has no kernel for
  it either).
* :func:`fused_softmax`: softmax(x * scale) over the last dim in fp32,
  out in x's dtype; forward only, as in JAX (the training path runs
  flash attention instead).

CUDA tensors launch the kernels; CPU tensors run the plain versions. The
kernels take fp32 or bf16 (the softmax also fp16), with gamma, beta and
the bias in x's dtype, and compute in fp32; LayerNorm rows are at most
2048 wide. mu and rstd are fp32 ``x.shape[:-1]``; the TPU kernel's
lane-replicated ``[n, 8]`` layout is not carried over.
"""

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops._platform import use_kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC_ELEMS = {torch.float32: 4, torch.bfloat16: 8}   # one 16-byte vector
MAX_LN_WIDTH = 2048
_GELU_C = 0.7978845608028654   # sqrt(2 / pi)


def layer_norm_fwd_plain(x, gamma, beta, eps):
    """(y in x.dtype, mu fp32, rstd fp32) over the last dim, in fp32: the
    mean, then the mean of the squared deviations (fused.py:45-47)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mu).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mu) * rstd * gamma.float() + beta.float()
    return y.to(x.dtype), mu[..., 0], rstd[..., 0]


def layer_norm_bwd_plain(x, gamma, mu, rstd, dy):
    """dx (x.dtype) from x, gamma, the forward's mu and rstd, and dy
    (fused.py:55-65)."""
    xf, dyf = x.float(), dy.float()
    mu, rstd = mu[..., None], rstd[..., None]
    xhat = (xf - mu) * rstd
    wdy = dyf * gamma.float()
    c1 = (xhat * wdy).mean(-1, keepdim=True)
    c2 = wdy.mean(-1, keepdim=True)
    return ((wdy - c1 * xhat - c2) * rstd).to(x.dtype)


def bias_gelu_plain(x, bias):
    """tanh GeLU of x + bias in fp32, in x's dtype (fused.py:147-152)."""
    t = x.float() + bias.float()
    y = 0.5 * t * (1.0 + torch.tanh(_GELU_C * (t + 0.044715 * t * t * t)))
    return y.to(x.dtype)


def softmax_plain(x, scale=1.0):
    """softmax(x * scale) over the last dim in fp32, in x's dtype
    (fused.py:226-230): the row max, exp, then a division by the sum."""
    xf = x.float() * scale
    e = torch.exp(xf - xf.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True)).to(x.dtype)


def _check_rows(x, params, what):
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    h = x.shape[-1]
    for name, t in params.items():
        if t.dtype != x.dtype:
            raise TypeError(f"{what} kernel takes {name} in x's dtype "
                            f"{x.dtype}, got {t.dtype}")
        if t.shape != (h,):
            raise ValueError(f"{what} kernel takes {name} of shape ({h},), "
                             f"got {tuple(t.shape)}")


def _vec(h, dtype, *tensors):
    """1 when rows load as whole 16-byte vectors."""
    return int(h % _VEC_ELEMS[dtype] == 0 and
               all(t.data_ptr() % 16 == 0 for t in tensors))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_ln_width(h):
    if not 1 <= h <= MAX_LN_WIDTH:
        raise ValueError(f"layer norm kernel takes rows of 1..{MAX_LN_WIDTH} "
                         f"elements, got {h}")


def layer_norm_fwd(x, gamma, beta, eps):
    """(y, mu, rstd) of LayerNorm over the last dim: ``ds_ln_fwd`` on CUDA
    tensors, :func:`layer_norm_fwd_plain` on CPU tensors."""
    if not use_kernel(x, gamma, beta):
        return layer_norm_fwd_plain(x, gamma, beta, eps)
    _check_rows(x, {"gamma": gamma, "beta": beta}, "layer norm")
    h = x.shape[-1]
    _check_ln_width(h)
    x, gamma, beta = x.contiguous(), gamma.contiguous(), beta.contiguous()
    y = torch.empty_like(x)
    mu = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    n = mu.numel()
    if n == 0:
        return y, mu, rstd
    err = op_builder.load_kernels().ds_ln_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        mu.data_ptr(), rstd.data_ptr(), n, h, float(eps), _DTYPES[x.dtype],
        _vec(h, x.dtype, x, gamma, beta, y), _stream(x))
    op_builder.check_launch(err, "ln_fwd")
    return y, mu, rstd


def layer_norm_bwd(x, gamma, mu, rstd, dy):
    """dx of LayerNorm: ``ds_ln_bwd`` on CUDA tensors,
    :func:`layer_norm_bwd_plain` on CPU tensors."""
    if not use_kernel(x, gamma, mu, rstd, dy):
        return layer_norm_bwd_plain(x, gamma, mu, rstd, dy)
    _check_rows(x, {"gamma": gamma}, "layer norm backward")
    h = x.shape[-1]
    _check_ln_width(h)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if mu.shape != x.shape[:-1] or rstd.shape != mu.shape or \
            mu.dtype != torch.float32 or rstd.dtype != torch.float32:
        raise ValueError(f"mu and rstd must be fp32 {tuple(x.shape[:-1])}")
    x, gamma, dy = x.contiguous(), gamma.contiguous(), dy.contiguous()
    mu, rstd = mu.contiguous(), rstd.contiguous()
    dx = torch.empty_like(x)
    n = mu.numel()
    if n == 0:
        return dx
    err = op_builder.load_kernels().ds_ln_bwd(
        x.data_ptr(), gamma.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), n, h, _DTYPES[x.dtype],
        _vec(h, x.dtype, x, gamma, dy, dx), _stream(x))
    op_builder.check_launch(err, "ln_bwd")
    return dx


def bias_gelu(x, bias):
    """tanh GeLU of x + bias (bias over the last dim): ``ds_bias_gelu`` on
    CUDA tensors, :func:`bias_gelu_plain` on CPU tensors."""
    if not use_kernel(x, bias):
        return bias_gelu_plain(x, bias)
    _check_rows(x, {"bias": bias}, "bias-GeLU")
    x, bias = x.contiguous(), bias.contiguous()
    y = torch.empty_like(x)
    h = x.shape[-1]
    if x.numel() == 0:
        return y
    err = op_builder.load_kernels().ds_bias_gelu(
        x.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel(), h,
        _DTYPES[x.dtype], _vec(h, x.dtype, x, bias, y), _stream(x))
    op_builder.check_launch(err, "bias_gelu")
    return y


_SOFTMAX_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def fused_softmax(x, scale=1.0):
    """Scaled softmax over the last dim (JAX fused.py:233): ``ds_softmax``
    on CUDA tensors, :func:`softmax_plain` on CPU tensors."""
    if not use_kernel(x):
        return softmax_plain(x, scale)
    if x.dtype not in _SOFTMAX_DTYPES:
        raise TypeError(f"softmax kernel takes float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    h = x.shape[-1]
    err = op_builder.load_kernels().ds_softmax(
        x.data_ptr(), y.data_ptr(), x.numel() // h, h, float(scale),
        _SOFTMAX_DTYPES[x.dtype], _stream(x))
    op_builder.check_launch(err, "softmax")
    return y


class FusedLayerNormFunction(torch.autograd.Function):
    """LayerNorm with the kernels on both sides (the ``custom_vjp`` of the
    JAX ``fused_layer_norm``): saves x, gamma, mu and rstd."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mu, rstd = layer_norm_fwd(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mu, rstd = ctx.saved_tensors
        dx = layer_norm_bwd(x, gamma, mu, rstd, dy)
        # dgamma, dbeta: plain fp32 reductions (fused.py:133-139)
        h = x.shape[-1]
        xhat = (x.float() - mu[..., None]) * rstd[..., None]
        dyf = dy.float()
        dgamma = (dyf * xhat).reshape(-1, h).sum(0).to(gamma.dtype)
        dbeta = dyf.reshape(-1, h).sum(0).to(gamma.dtype)
        return dx, dgamma, dbeta, None


def fused_layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last dim, differentiable in x, gamma and beta."""
    return FusedLayerNormFunction.apply(x, gamma, beta, eps)


def bias_gelu_bwd(x, bias, dy):
    """(dx, dbias) of gelu_tanh(x + bias): the JAX ``_bias_gelu_bwd``
    (fused.py:185-195) term by term, in fp32."""
    xb = x.float() + bias.float()
    t = torch.tanh(_GELU_C * (xb + 0.044715 * (xb * xb * xb)))
    dg = 0.5 * (1.0 + t) + 0.5 * xb * (1.0 - t * t) * \
        _GELU_C * (1.0 + 3 * 0.044715 * xb * xb)
    g = dy.float() * dg
    dbias = g.reshape(-1, x.shape[-1]).sum(0).to(bias.dtype)
    return g.to(x.dtype), dbias


class FusedBiasGeluFunction(torch.autograd.Function):
    """gelu_tanh(x + bias): the kernel forward, the explicit backward."""

    @staticmethod
    def forward(ctx, x, bias):
        ctx.save_for_backward(x, bias)
        return bias_gelu(x, bias)

    @staticmethod
    def backward(ctx, dy):
        x, bias = ctx.saved_tensors
        return bias_gelu_bwd(x, bias, dy)


def fused_bias_gelu(x, bias):
    """gelu_tanh(x + bias), differentiable in x and bias."""
    return FusedBiasGeluFunction.apply(x, bias)


def bias_residual_add(x, bias, residual):
    """x + bias + residual (fused.py:202)."""
    return x + bias + residual


def residual_add(hidden, residual, attention_output=None, mp_size=1):
    """hidden + residual (+ attention_output / mp_size) (fused.py:209)."""
    out = hidden + residual
    if attention_output is not None:
        out = out + attention_output / mp_size
    return out


def moe_res_matmul(residual, coef, output):
    """output · coef[..., 1] + residual · coef[..., 0] (fused.py:219)."""
    return output * coef[..., 1:2] + residual * coef[..., 0:1]
