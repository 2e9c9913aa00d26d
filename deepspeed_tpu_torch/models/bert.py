"""BERT for MLM pretraining in PyTorch (counterpart of
``deepspeed_tpu/models/bert.py``).

Embeddings, a stack of fused encoder layers
(:class:`~deepspeed_tpu_torch.ops.transformer.transformer.DeepSpeedTransformerLayer`:
the LayerNorm and bias-GeLU kernels, flash attention) or, with
``sparse_attention_mode``, of :class:`BertSparseLayer` (block-sparse
attention on the sparse kernels; plain ``nn.LayerNorm``, ``nn.Linear``
and tanh-GeLU, as the flax layer's), and the MLM head tied to the word
embeddings. ``emb_ln`` and ``mlm_ln`` are plain
LayerNorm, as the flax model's ``nn.LayerNorm`` is; the head's logits are
fp32. Batches are dicts with ``input_ids`` [B, S] and either ``labels``
(-100 = ignore) or ``masked_positions`` + ``masked_labels`` (the head then
runs on those positions only), optionally ``attention_mask`` [B, S]; or a
tuple ``(input_ids, labels)``. ``forward`` returns the MLM cross-entropy,
or the logits when the batch has no labels.

``hidden_dropout_prob`` masks the embeddings (after ``emb_ln``) and each
layer's attention and MLP outputs; ``attention_probs_dropout_prob`` is
the fused layer's attention dropout, on ``attn_out`` after its
projection (the JAX sites, bert.py:139-148, 183-184; transformer.py:106,
137). Sparse mode refuses attention dropout, as JAX does. ``remat``
recomputes each layer in the backward (bert.py:194-195, 210-211).
"""

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from deepspeed_tpu_torch.models.common import (lecun_normal_,
                                               masked_next_token_ce)
from deepspeed_tpu_torch.ops._platform import resolve_device
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import \
    BertSparseSelfAttention
from deepspeed_tpu_torch.ops.transformer.transformer import (
    DeepSpeedTransformerConfig, DeepSpeedTransformerLayer)
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing \
    import remat
from deepspeed_tpu_torch.runtime.dropout import Dropout


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    layer_norm_eps: float = 1e-12
    pre_layer_norm: bool = False       # classic BERT is post-LN
    remat: bool = False
    # block-sparse attention: None = the dense fused layer; else one of
    # fixed|variable|bigbird|bslongformer|dense with the block geometry
    sparse_attention_mode: Optional[str] = None
    sparse_block: int = 16
    sparse_num_local_blocks: int = 4
    sparse_num_global_blocks: int = 1

    @property
    def padded_vocab(self):
        return ((self.vocab_size + 127) // 128) * 128


PRESETS = {
    "bert-base": BertConfig(),
    "bert-large": BertConfig(hidden_size=1024, num_hidden_layers=24,
                             num_attention_heads=16, intermediate_size=4096),
    "tiny": BertConfig(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=256,
                       max_position_embeddings=128),
}


def _check_config(cfg: BertConfig):
    """The JAX model's sparse-mode asserts (bert.py:186-192)."""
    if cfg.sparse_attention_mode is None:
        return
    if cfg.attention_probs_dropout_prob != 0:
        raise ValueError("the block-sparse kernel has no attention-dropout "
                         "input; set attention_probs_dropout_prob=0 for "
                         "sparse mode")
    if cfg.pre_layer_norm:
        raise ValueError("BertSparseLayer is post-LN (classic BERT); "
                         "pre_layer_norm is not implemented for sparse mode")


class BertLayer(nn.Module):
    """The flax ``BertLayer``: a named holder of one fused layer."""

    def __init__(self, hidden_size, num_heads, intermediate_size,
                 pre_layer_norm=False, dropout=0.0, attn_dropout=0.0,
                 layer_norm_eps=1e-12, *, device=None, dtype=torch.float32):
        super().__init__()
        cfg = DeepSpeedTransformerConfig(
            hidden_size=hidden_size, heads=num_heads,
            intermediate_size=intermediate_size,
            pre_layer_norm=pre_layer_norm, hidden_dropout_ratio=dropout,
            attn_dropout_ratio=attn_dropout, layer_norm_eps=layer_norm_eps)
        self.layer = DeepSpeedTransformerLayer(cfg, device=device,
                                               dtype=dtype)

    def forward(self, x, mask=None):
        return self.layer(x, mask)


def sparsity_config(mode, num_heads, block, num_local_blocks=4,
                    num_global_blocks=1):
    """The SparsityConfig a ``sparse_attention_mode`` names (the JAX
    ``BertSparseLayer._sparsity_config``)."""
    if mode == "fixed":
        return sc.FixedSparsityConfig(
            num_heads=num_heads, block=block,
            num_local_blocks=num_local_blocks,
            num_global_blocks=num_global_blocks)
    classes = {"bigbird": sc.BigBirdSparsityConfig,
               "bslongformer": sc.BSLongformerSparsityConfig,
               "variable": sc.VariableSparsityConfig,
               "dense": sc.DenseSparsityConfig}
    if mode not in classes:
        raise ValueError(f"unknown sparse attention mode {mode!r}")
    return classes[mode](num_heads=num_heads, block=block)


class BertSparseLayer(nn.Module):
    """Post-LN encoder layer whose self-attention is block-sparse (the JAX
    ``BertSparseLayer``, bert.py:87-170): ``attention`` (qkv + sparse
    attention), ``attn_out``, ``attn_ln``, ``fc``, tanh-GeLU, ``out``,
    ``out_ln``; ``dropout`` masks the attention and MLP outputs."""

    def __init__(self, hidden_size, num_heads, intermediate_size,
                 sparsity_mode="fixed", block=16, num_local_blocks=4,
                 num_global_blocks=1, layer_norm_eps=1e-12, dropout=0.0, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attention = BertSparseSelfAttention(
            hidden_size, num_heads,
            sparsity_config(sparsity_mode, num_heads, block,
                            num_local_blocks, num_global_blocks), **kw)
        self.attn_out = nn.Linear(hidden_size, hidden_size, **kw)
        self.attn_ln = nn.LayerNorm(hidden_size, eps=layer_norm_eps, **kw)
        self.fc = nn.Linear(hidden_size, intermediate_size, **kw)
        self.out = nn.Linear(intermediate_size, hidden_size, **kw)
        self.out_ln = nn.LayerNorm(hidden_size, eps=layer_norm_eps, **kw)
        self.attn_drop = Dropout(dropout)
        self.out_drop = Dropout(dropout)

    @torch.no_grad()
    def reset_parameters(self, gen):
        """The flax init: ``qkv`` LeCun-normal (nn.Dense's default), the
        other denses normal(0.02), zero biases, unit LayerNorm scales."""
        lecun_normal_(self.attention.qkv.weight, gen)
        for dense in (self.attn_out, self.fc, self.out):
            nn.init.normal_(dense.weight, 0.0, 0.02, generator=gen)
        for dense in (self.attention.qkv, self.attn_out, self.fc, self.out):
            nn.init.zeros_(dense.bias)
        for ln in (self.attn_ln, self.out_ln):
            nn.init.ones_(ln.weight)
            nn.init.zeros_(ln.bias)

    def forward(self, x, mask=None):
        ctx = self.attention(x, mask)
        x = self.attn_ln(x + self.attn_drop(self.attn_out(ctx)))
        h = F.gelu(self.fc(x), approximate="tanh")
        return self.out_ln(x + self.out_drop(self.out(h)))


def _unpack(batch):
    """(input_ids, labels, attention_mask, masked_positions)."""
    if isinstance(batch, (tuple, list)):
        return batch[0], (batch[1] if len(batch) > 1 else None), None, None
    positions = batch.get("masked_positions")
    labels = batch["masked_labels"] if positions is not None \
        else batch.get("labels")
    return batch["input_ids"], labels, batch.get("attention_mask"), positions


class BertForPreTraining(nn.Module):
    """Embeddings + fused encoder stack + tied MLM head (no next-sentence
    head, as in the JAX model).

    ``device=None`` means CUDA (raises without a card); weights are drawn
    from ``seed`` as the flax init draws them: embeddings and the layers'
    kernels normal(0.02), ``mlm_dense`` LeCun-normal, zero biases, unit
    LayerNorm scales."""

    def __init__(self, config: BertConfig, *, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        _check_config(config)
        dev = resolve_device(device)
        self.config = config
        H = config.hidden_size
        kw = dict(device=dev, dtype=dtype)
        self.word_embeddings = nn.Parameter(
            torch.empty((config.padded_vocab, H), **kw))
        self.position_embeddings = nn.Parameter(
            torch.empty((config.max_position_embeddings, H), **kw))
        self.token_type_embeddings = nn.Parameter(
            torch.empty((config.type_vocab_size, H), **kw))
        self.emb_ln = nn.LayerNorm(H, eps=config.layer_norm_eps, **kw)
        if config.sparse_attention_mode is not None:
            self.layer = nn.ModuleList(
                BertSparseLayer(
                    H, config.num_attention_heads, config.intermediate_size,
                    config.sparse_attention_mode, config.sparse_block,
                    config.sparse_num_local_blocks,
                    config.sparse_num_global_blocks, config.layer_norm_eps,
                    config.hidden_dropout_prob, **kw)
                for _ in range(config.num_hidden_layers))
        else:
            self.layer = nn.ModuleList(
                BertLayer(H, config.num_attention_heads,
                          config.intermediate_size, config.pre_layer_norm,
                          config.hidden_dropout_prob,
                          config.attention_probs_dropout_prob,
                          config.layer_norm_eps, **kw)
                for _ in range(config.num_hidden_layers))
        self.mlm_dense = nn.Linear(H, H, **kw)
        self.mlm_ln = nn.LayerNorm(H, eps=config.layer_norm_eps, **kw)
        self.mlm_bias = nn.Parameter(torch.zeros(config.padded_vocab, **kw))
        self.emb_drop = Dropout(config.hidden_dropout_prob)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        gen = torch.Generator(device=self.word_embeddings.device)
        gen.manual_seed(seed)
        for emb in (self.word_embeddings, self.position_embeddings,
                    self.token_type_embeddings):
            nn.init.normal_(emb, 0.0, 0.02, generator=gen)
        for blk in self.layer:
            if isinstance(blk, BertSparseLayer):
                blk.reset_parameters(gen)
            else:
                blk.layer.reset_parameters(gen)
        lecun_normal_(self.mlm_dense.weight, gen)
        nn.init.zeros_(self.mlm_dense.bias)
        nn.init.zeros_(self.mlm_bias)
        for ln in (self.emb_ln, self.mlm_ln):
            nn.init.ones_(ln.weight)
            nn.init.zeros_(ln.bias)

    def forward(self, batch):
        cfg = self.config
        input_ids, labels, mask, positions = _unpack(batch)
        B, S = input_ids.shape
        if S > cfg.max_position_embeddings:
            raise ValueError(f"sequence length {S} exceeds "
                             f"max_position_embeddings "
                             f"({cfg.max_position_embeddings})")
        x = (F.embedding(input_ids, self.word_embeddings)
             + self.position_embeddings[:S] + self.token_type_embeddings[0])
        x = self.emb_drop(self.emb_ln(x))
        # remat: each layer's activations are recomputed in the backward
        recompute = cfg.remat and torch.is_grad_enabled()
        for blk in self.layer:
            x = remat(blk, x, mask) if recompute else blk(x, mask)

        # MLM transform + tied decoder; with masked_positions only those
        # positions reach the head
        if positions is not None:
            idx = positions.long()[..., None].expand(-1, -1, x.shape[-1])
            x = torch.gather(x, 1, idx)
        h = F.gelu(self.mlm_dense(x), approximate="tanh")
        h = self.mlm_ln(h)
        # fp32 logits, exact for bf16 operands (the JAX einsum's
        # preferred_element_type=float32)
        logits = F.linear(h.float(), self.word_embeddings.float()) \
            + self.mlm_bias
        if labels is None:
            return logits
        return masked_next_token_ce(logits, labels)

    def loss_count(self, batch):
        """The number of masked positions the MLM loss of ``batch``
        averages (labels ≥ 0); the engine weights a rank's loss by it."""
        return (_unpack(batch)[1] >= 0).sum()


def synthetic_mlm_batch(batch_size, seq_len, vocab_size, mask_prob=0.15,
                        seed=0, masked_positions_format=False, device=None):
    """MLM batch from ``seed``: the numpy draws of the JAX function, as
    int64 tensors on ``device`` (None means CUDA). 15% of positions become
    [MASK] (103) with their ids as labels (-100 elsewhere), or, in the
    masked-positions format, a fixed round(S · mask_prob) sorted positions
    a sequence."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab_size, (batch_size, seq_len), dtype=np.int32)
    if masked_positions_format:
        P = max(1, int(round(seq_len * mask_prob)))
        positions = np.stack([
            np.sort(rng.choice(seq_len, size=P, replace=False))
            for _ in range(batch_size)]).astype(np.int32)
        labels = np.take_along_axis(ids, positions, axis=1)
        np.put_along_axis(ids, positions, 103, axis=1)  # [MASK]
        out = {"input_ids": ids, "masked_positions": positions,
               "masked_labels": labels}
    else:
        labels = np.full_like(ids, -100)
        mask = rng.random((batch_size, seq_len)) < mask_prob
        labels[mask] = ids[mask]
        ids[mask] = 103  # [MASK]
        out = {"input_ids": ids, "labels": labels}
    return {k: torch.from_numpy(v).long().to(dev) for k, v in out.items()}
