"""``DeepSpeedTransformerLayer``: the fused BERT-style encoder layer
(counterpart of ``deepspeed_tpu/ops/transformer/transformer.py``).

Self-attention and an MLP with pre- or post-LayerNorm. The elementwise hot
spots go through the port's kernels: :func:`fused_layer_norm` (twice a
layer) and :func:`fused_bias_gelu` (once); unmasked attention runs the
flash kernels (non-causal), masked attention the plain dense version
(:func:`attention`). ``inter_w`` is a raw ``[hidden, intermediate]``
parameter, as in the flax layer; the other three projections are
:class:`QuantDense`. Parameter names are the flax layer's. An int8
``inter_w`` (from ``module_inject.quantize_transformer_layer``, with its
per-column scales in the ``inter_w_scale`` buffer) runs
:func:`int8_matmul` (JAX transformer.py:120-133).

``attn_dropout_ratio`` masks ``attn_out`` after its projection (the JAX
layer's attention dropout, transformer.py:106-107, not dropout on the
probabilities) and ``hidden_dropout_ratio`` the MLP output (:137-138),
with :class:`~deepspeed_tpu_torch.runtime.dropout.Dropout`: no kernel
takes a mask, as no Pallas kernel does. Any of the memory knobs
(``normalize_invertible``, ``gelu_checkpoint``,
``attn_dropout_checkpoint``) recomputes the whole layer in the backward
(the JAX ``nn.remat`` over the layer, :145). Not ported yet:
``transformer_tp_rules`` (tensor parallelism).
"""

import dataclasses

import torch
from torch import nn

from deepspeed_tpu_torch.ops.quantizer.int8_linear import (QuantDense,
                                                           int8_matmul)
from deepspeed_tpu_torch.ops.transformer.attention import attention
from deepspeed_tpu_torch.ops.transformer.fused import (fused_bias_gelu,
                                                       fused_layer_norm)
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing \
    import remat
from deepspeed_tpu_torch.runtime.dropout import Dropout


@dataclasses.dataclass(frozen=True)
class DeepSpeedTransformerConfig:
    """The reference config surface (transformer.py:33-65)."""
    batch_size: int = -1
    hidden_size: int = 768
    intermediate_size: int = -1          # -1 -> 4 * hidden
    heads: int = 12
    attn_dropout_ratio: float = 0.0
    hidden_dropout_ratio: float = 0.0
    num_hidden_layers: int = -1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    local_rank: int = -1
    seed: int = -1
    fp16: bool = False
    pre_layer_norm: bool = True
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    adjust_init_range: bool = True
    attn_dropout_checkpoint: bool = False
    stochastic_mode: bool = False
    return_tuple: bool = False
    training: bool = True

    @property
    def intermediate(self):
        return (self.intermediate_size if self.intermediate_size > 0
                else 4 * self.hidden_size)

    @property
    def wants_remat(self):
        return (self.normalize_invertible or self.gelu_checkpoint or
                self.attn_dropout_checkpoint)


class DeepSpeedTransformerLayer(nn.Module):
    """One encoder layer; ``forward(hidden_states, attention_mask=None)``
    on [B, S, hidden]. A [B, S] ``attention_mask`` (nonzero = keep) becomes
    a [B, 1, 1, S] boolean mask."""

    def __init__(self, config: DeepSpeedTransformerConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        H, inter = config.hidden_size, config.intermediate
        kw = dict(device=device, dtype=dtype)
        self.attn_ln_gamma = nn.Parameter(torch.ones(H, **kw))
        self.attn_ln_beta = nn.Parameter(torch.zeros(H, **kw))
        self.ln_gamma = nn.Parameter(torch.ones(H, **kw))
        self.ln_beta = nn.Parameter(torch.zeros(H, **kw))
        self.attn_qkv = QuantDense(H, 3 * H, **kw)
        self.attn_out = QuantDense(H, H, **kw)
        self.inter_w = nn.Parameter(torch.empty((H, inter), **kw))
        self.inter_b = nn.Parameter(torch.zeros(inter, **kw))
        self.output_w = QuantDense(inter, H, **kw)
        self.attn_drop = Dropout(config.attn_dropout_ratio)
        self.out_drop = Dropout(config.hidden_dropout_ratio)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The flax init: the kernels normal(initializer_range), zero
        biases, unit LayerNorm scales."""
        std = self.config.initializer_range
        for w in (self.attn_qkv.weight, self.attn_out.weight, self.inter_w,
                  self.output_w.weight):
            nn.init.normal_(w, 0.0, std, generator=generator)
        for b in (self.attn_qkv.bias, self.attn_out.bias, self.inter_b,
                  self.output_w.bias, self.attn_ln_beta, self.ln_beta):
            nn.init.zeros_(b)
        nn.init.ones_(self.attn_ln_gamma)
        nn.init.ones_(self.ln_gamma)

    def forward(self, hidden_states, attention_mask=None):
        mask = attention_mask
        if mask is not None and mask.dim() == 2:
            mask = mask[:, None, None, :].bool()
        if self.config.wants_remat and torch.is_grad_enabled():
            return remat(self, hidden_states, mask, method="layer")
        return self.layer(hidden_states, mask)

    def layer(self, x, mask):
        """The layer on [B, S, hidden] with a boolean mask or None."""
        cfg = self.config
        B, S, H = x.shape
        nh = cfg.heads
        eps = cfg.layer_norm_eps

        attn_in = (fused_layer_norm(x, self.attn_ln_gamma, self.attn_ln_beta,
                                    eps) if cfg.pre_layer_norm else x)
        # [q | k | v] along the last dim, each split into heads
        qkv = self.attn_qkv(attn_in).view(B, S, 3, nh, H // nh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        ctx = attention(q, k, v, causal=False, mask=mask)
        ctx = ctx.transpose(1, 2).reshape(B, S, H)
        x = x + self.attn_drop(self.attn_out(ctx))
        if not cfg.pre_layer_norm:
            x = fused_layer_norm(x, self.attn_ln_gamma, self.attn_ln_beta,
                                 eps)

        mlp_in = (fused_layer_norm(x, self.ln_gamma, self.ln_beta, eps)
                  if cfg.pre_layer_norm else x)
        if self.inter_w.dtype == torch.int8:
            scale = getattr(self, "inter_w_scale", None)
            if scale is None:
                raise ValueError(
                    "DeepSpeedTransformerLayer: int8 inter_w but no "
                    "'inter_w_scale' buffer — quantize with "
                    "module_inject.quantize_transformer_layer")
            h = fused_bias_gelu(
                int8_matmul(mlp_in, self.inter_w.t(), scale), self.inter_b)
        else:
            h = fused_bias_gelu(mlp_in @ self.inter_w, self.inter_b)
        x = x + self.out_drop(self.output_w(h))
        if not cfg.pre_layer_norm:
            x = fused_layer_norm(x, self.ln_gamma, self.ln_beta, eps)
        return x


def transformer_tp_rules(prefix=r".*"):
    """Megatron tensor-parallel rules for this layer (transformer.py:153):
    not ported yet."""
    raise NotImplementedError("transformer_tp_rules (tensor parallelism) is "
                              "not ported yet")
