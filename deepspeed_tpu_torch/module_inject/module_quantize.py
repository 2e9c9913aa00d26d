"""Module-level int8 weight quantization for inference (counterpart of
``deepspeed_tpu/module_inject/module_quantize.py``).

:func:`quantize_transformer_layer` walks a model's parameters and swaps
each matched transformer weight (qkv, attention out, MLP in, MLP out) for
int8 in place, with its fp32 scales in a ``{name}_scale`` buffer beside
it on the same module; ``QuantDense`` and the fused encoder layer read
them. The JAX function walks the params pytree and returns a parallel
``quant_scales`` collection instead; the values are the same.

Scales are per output unit. For the ``[out, in]`` dense weights
(``QuantDense``, ``nn.Linear``) that is one per row, the transpose of the
flax ``[in, out]`` kernel's per-column scale; ``inter_w`` keeps the flax
``[in, out]`` layout, so its scale is per column, as in JAX.
"""

import re

import torch
from torch import nn

from deepspeed_tpu_torch.ops.quantizer.int8_linear import (
    QuantDense, dequantize_weight_int8, quantize_weight_int8)

# the four transformer matmuls in the port's state_dict names: GPT-2 blocks
# and the fused encoder layer (JAX DEFAULT_PATTERNS)
DEFAULT_PATTERNS = (
    r"(^|\.)h\.\d+\.(attn\.(qkv|proj)|mlp\.(fc|proj))\.weight$",
    r"(^|\.)(attn_qkv|attn_out)\.weight$",
    r"(^|\.)(inter_w|output_w\.weight)$",
)


def _owner(model, name):
    """(module, attribute) of the parameter called ``name``."""
    path, _, attr = name.rpartition(".")
    return (model.get_submodule(path) if path else model), attr


def _is_out_in(module, attr):
    """True for a weight stored [out, in] (the transpose of flax's)."""
    return attr == "weight" and isinstance(module, (QuantDense, nn.Linear))


@torch.no_grad()
def quantize_transformer_layer(model, patterns=DEFAULT_PATTERNS, bits=8):
    """Swap the matched 2-D weights of ``model`` for int8, in place.

    Returns ``{scale buffer name: fp32 scales}``; each buffer lies beside
    its weight (``h.0.attn.qkv.weight_scale``,
    ``layer.0.layer.inter_w_scale``)."""
    if bits != 8:
        raise ValueError(
            f"module-level weight quantization stores int8 (got bits="
            f"{bits}); sub-8-bit training schedules are runtime/quantize.py")
    regexes = [re.compile(p) for p in patterns]
    scales = {}
    for name, w in list(model.named_parameters()):
        if w.dim() != 2 or not any(r.search(name) for r in regexes):
            continue
        module, attr = _owner(model, name)
        if _is_out_in(module, attr):
            wq, scale = quantize_weight_int8(w)
        else:   # flax layout [in, out]: per-column scales
            wq, scale = quantize_weight_int8(w.t())
            wq = wq.t().contiguous()
        module._parameters[attr] = nn.Parameter(wq, requires_grad=False)
        module.register_buffer(f"{attr}_scale", scale)
        scales[f"{name}_scale"] = scale
    if not scales:
        raise ValueError(
            "quantize_transformer_layer matched no weights; pass patterns "
            "for this model's layer naming (the default matches GPT-2 "
            "blocks and DeepSpeedTransformerLayer)")
    return scales


@torch.no_grad()
def dequantize_transformer_layer(model, dtype=None):
    """Revert: int8 weights back to float ``dtype`` (default fp32) from
    their scale buffers, which are removed. Returns ``model``."""
    dtype = dtype or torch.float32
    for name, w in list(model.named_parameters()):
        if w.dtype != torch.int8:
            continue
        module, attr = _owner(model, name)
        scale = module._buffers.pop(f"{attr}_scale", None)
        if scale is None:
            continue
        if _is_out_in(module, attr):
            wf = dequantize_weight_int8(w, scale, dtype)
        else:
            wf = dequantize_weight_int8(w.t(), scale, dtype).t().contiguous()
        module._parameters[attr] = nn.Parameter(wf)
    return model
