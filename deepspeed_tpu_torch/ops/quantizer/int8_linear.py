"""``QuantDense``: the float path of the JAX package's int8-capable dense
layer (``deepspeed_tpu/ops/quantizer/int8_linear.py``).

Only float weights are ported: int8 weight storage with per-column scales
comes with the quantization work. The weight is stored ``[out, in]``, as
``nn.Linear`` does (the flax kernel is ``[in, out]``; see
``deepspeed_tpu_torch.bridge``).
"""

import torch
from torch import nn
from torch.nn import functional as F


class QuantDense(nn.Module):
    """y = x Wᵀ + b, with x cast to the weight's dtype."""

    def __init__(self, in_features, out_features, bias=True, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            (out_features, in_features), device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(
            out_features, device=device, dtype=dtype)) if bias else None

    def forward(self, x):
        if self.weight.dtype == torch.int8:
            raise NotImplementedError(
                "int8 weight storage is not ported yet")
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)
