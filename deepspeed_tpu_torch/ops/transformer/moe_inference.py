"""The MoE inference layer (counterpart of
``deepspeed_tpu/ops/transformer/moe_inference.py``).

One decoder layer whose MLP is a mixture of experts, usable with a KV
cache: ln -> causal attention (the flash kernels for a prefill, the decode
kernel for a one-token step, through ``models.gpt2.CausalSelfAttention``)
-> ln -> ``moe.layer.MoE`` (``moe_type="residual"``: MoS), with
residuals. In eval mode (inference) the MoE gates each call's tokens with
``eval_capacity_factor``, as the JAX layer with ``deterministic=True``
does. Its parameter names are those of MoE-GPT's blocks, so a stack of
them loads the same trees (``bridge.MOE_INFERENCE_LAYOUT``).
"""

import dataclasses
from typing import Optional

import torch
from torch import nn

from deepspeed_tpu_torch.models.gpt2 import (CausalSelfAttention, GPT2Config,
                                             KVCache)
from deepspeed_tpu_torch.moe.layer import MoE


@dataclasses.dataclass(frozen=True)
class DeepSpeedMoEInferenceConfig:
    """The JAX config surface (the knobs the port has; fp16/q_int8 are
    the engine's dtype)."""
    hidden_size: int
    heads: int
    num_experts: int = 1
    k: int = 1
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    noisy_gate_policy: Optional[str] = None
    drop_tokens: bool = True
    use_rts: bool = True
    moe_type: str = "standard"     # "residual" = MoS residual MoE
    max_out_tokens: int = 2048     # KV-cache ceiling
    epsilon: float = 1e-5
    n_layer_for_init: int = 12     # proj init scale denominator
    kv_cache_dtype: str = "auto"
    use_flash: bool = True         # JAX's switch; the device picks here


class DeepSpeedMoEInference(nn.Module):
    """ln -> (KV-cache) causal attention -> ln -> MoE FFN, with residuals;
    ``forward(x, cache, layer)`` as a GPT-2 block's (run a stack through
    :func:`run_layers`)."""

    def __init__(self, config: DeepSpeedMoEInferenceConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        if config.moe_type not in ("standard", "residual"):
            raise ValueError(f"moe_type must be 'standard' or 'residual', "
                             f"got {config.moe_type!r}")
        self.config = config
        self.attn_config = GPT2Config(
            vocab_size=1, n_positions=config.max_out_tokens,
            n_embd=config.hidden_size, n_layer=config.n_layer_for_init,
            n_head=config.heads, kv_cache_dtype=config.kv_cache_dtype)
        E = config.hidden_size
        self.ln_1 = nn.LayerNorm(E, eps=config.epsilon, device=device,
                                 dtype=dtype)
        self.attn = CausalSelfAttention(self.attn_config, device, dtype)
        self.ln_2 = nn.LayerNorm(E, eps=config.epsilon, device=device,
                                 dtype=dtype)
        self.moe = MoE(E, num_experts=config.num_experts, k=config.k,
                       capacity_factor=config.capacity_factor,
                       eval_capacity_factor=config.eval_capacity_factor,
                       min_capacity=config.min_capacity,
                       use_residual=config.moe_type == "residual",
                       noisy_gate_policy=config.noisy_gate_policy,
                       drop_tokens=config.drop_tokens,
                       use_rts=config.use_rts, device=device, dtype=dtype)

    def new_cache(self, batch_size: int, num_layers: int = 1) -> KVCache:
        """An empty KV cache for a stack of ``num_layers`` such layers."""
        p = self.ln_1.weight
        return KVCache(dataclasses.replace(self.attn_config,
                                           n_layer=num_layers),
                       batch_size, p.dtype, p.device)

    def forward(self, x, cache: KVCache = None, layer: int = 0):
        x = x + self.attn(self.ln_1(x), cache, layer)
        h = self.ln_2(x)
        B, S, E = h.shape
        out, _, _ = self.moe(h.reshape(B * S, E))
        return x + out.reshape(B, S, E)


def run_layers(layers, x, cache: KVCache = None):
    """``x`` [B, S, E] through ``layers`` in order, writing their K/V into
    ``cache`` at its position (a prefill when it is empty, else one-token
    steps) and advancing it."""
    if cache is not None:
        if cache.pos > 0 and x.shape[1] != 1:
            raise ValueError(f"decode steps take one token, got "
                             f"{x.shape[1]}")
        cache.lens = torch.full((), cache.pos + x.shape[1],
                                dtype=torch.int32, device=x.device)
    for i, layer in enumerate(layers):
        x = layer(x, cache, i)
    if cache is not None:
        cache.pos += x.shape[1]
    return x
