"""``QuantDense`` and int8 weight storage (counterpart of
``deepspeed_tpu/ops/quantizer/int8_linear.py``).

The weight is stored ``[out, in]``, as ``nn.Linear`` does (the flax kernel
is ``[in, out]``; see ``deepspeed_tpu_torch.bridge``). Int8 storage keeps
one fp32 scale per output unit: a row of the ``[out, in]`` weight, which
is an output column of the flax kernel, so the scale applies after the
contraction. ``module_inject.quantize_transformer_layer`` swaps a float
weight for int8 and puts the scales in a ``weight_scale`` buffer beside
it; :meth:`QuantDense.forward` then runs :func:`int8_matmul`.

The product is a plain ``torch.matmul`` over the int8 weight upcast to
the activation dtype (int8 magnitudes are exact in bf16), as the JAX
package leaves it to XLA; a dequant-in-GEMM kernel is later work.
"""

import torch
from torch import nn
from torch.nn import functional as F


def quantize_weight_int8(w):
    """[out, in] float weight -> (int8 [out, in], fp32 [out] scales):
    row o is round(w[o] / scale_o), scale_o = absmax_o / 127 (1 where the
    row is zero), clipped to ±127 (JAX int8_linear.py:21-31 over the flax
    kernel's columns)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=1)
    # a tensor divisor: PyTorch's CUDA division by a host scalar multiplies
    # by its reciprocal, which is not the IEEE quotient JAX computes
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        1.0)
    wq = torch.clamp(torch.round(wf / scale[:, None]), -127, 127)
    return wq.to(torch.int8), scale


def dequantize_weight_int8(wq, scale, dtype=torch.float32):
    """The float weight the int8 one stands for, in ``dtype``."""
    return (wq.float() * scale[:, None]).to(dtype)


def int8_matmul(x, w_int8, scale, bias=None):
    """x @ dequant(w_int8)ᵀ for an [out, in] int8 weight, with the dequant
    after the contraction (JAX int8_linear.py:38-44): the product in x's
    dtype, then ``scale`` and the bias rounded to that dtype."""
    y = torch.matmul(x, w_int8.to(x.dtype).t())
    y = y * scale.to(y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


class QuantDense(nn.Module):
    """y = x Wᵀ + b, with x cast to the weight's dtype; an int8 weight
    (with its ``weight_scale`` buffer) runs :func:`int8_matmul`."""

    def __init__(self, in_features, out_features, bias=True, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            (out_features, in_features), device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(
            out_features, device=device, dtype=dtype)) if bias else None

    def forward(self, x):
        if self.weight.dtype == torch.int8:
            scale = getattr(self, "weight_scale", None)
            if scale is None:
                raise ValueError(
                    "QuantDense: int8 weight but no 'weight_scale' buffer — "
                    "quantize with module_inject.quantize_transformer_layer")
            return int8_matmul(x, self.weight, scale, self.bias)
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)
