"""Sparse self-attention modules (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``).

:class:`SparseSelfAttention` applies block-sparse attention under a
``SparsityConfig``; layouts are built once per (config, sequence length)
and cached by content. ``DS_SPARSE_IMPL`` picks the form, read on every
call: ``fused`` (the default; the tile-list kernels with global columns
packed, ``fused_kernels.py``), ``gathered`` (plain torch) or
``predicated`` (the same kernels over the raw layout, ``kernels.py``).
"""

import logging
import os

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.ops.sparse_attention.fused_kernels import \
    block_sparse_attention_fused
from deepspeed_tpu_torch.ops.sparse_attention.kernels import (
    block_sparse_attention, block_sparse_attention_gathered)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    FixedSparsityConfig, SparsityConfig)

logger = logging.getLogger(__name__)

_layout_cache = {}
_density_warned = set()


def _config_key(cfg: SparsityConfig):
    """Content-based cache key: a config built per call may reuse the id
    of a different, freed one. List-valued geometry takes part as
    tuples."""
    def norm(v):
        if isinstance(v, (list, tuple)):
            return tuple(norm(x) for x in v)
        if isinstance(v, (int, float, str, bool)) or v is None:
            return v
        return repr(v)
    return (type(cfg).__name__,
            tuple(sorted((k, norm(v)) for k, v in vars(cfg).items())))


def get_layout(sparsity_config: SparsityConfig, seq_len: int):
    key = (_config_key(sparsity_config), seq_len)
    if key not in _layout_cache:
        _layout_cache[key] = sparsity_config.make_layout(seq_len)
    return _layout_cache[key]


class SparseSelfAttention(nn.Module):
    """q, k, v [B, H, S, D] -> context [B, H, S, D] under the sparse
    layout. Holds no parameters."""

    def __init__(self, sparsity_config: SparsityConfig = None,
                 key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul", max_seq_length: int = 2048):
        super().__init__()
        self.sparsity_config = sparsity_config or FixedSparsityConfig(
            num_heads=4)
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.max_seq_length = max_seq_length

    def forward(self, query, key, value, rpe=None, key_padding_mask=None,
                attn_mask=None):
        if not query.dtype == key.dtype == value.dtype:
            raise TypeError("query, key and value must share a dtype")
        if attn_mask is not None:
            raise NotImplementedError(
                "SparseSelfAttention: a full [S, S] attn_mask is not "
                "supported by the block-sparse kernels; use "
                "key_padding_mask (per key) or a causal sparsity config")
        S = query.shape[2]
        kpb = None
        if key_padding_mask is not None:
            kpm = torch.as_tensor(key_padding_mask, device=query.device)
            if kpm.is_floating_point():
                # 'add': the float mask is the additive score bias
                # (callers with 1.0/0.0 validity masks convert to bool
                # first, as BertSparseSelfAttention does)
                if self.key_padding_mask_mode != "add":
                    raise NotImplementedError(
                        f"key_padding_mask_mode="
                        f"{self.key_padding_mask_mode!r}; only 'add' is "
                        "implemented for float masks")
                kpb = kpm.float()
            else:
                # bool/int: True/1 = attend, False/0 = padding
                kpb = torch.where(kpm.bool(), 0.0, -1e9).float()
        cfg = self.sparsity_config
        layout = get_layout(cfg, S)
        causal = getattr(cfg, "attention",
                         "bidirectional") == "unidirectional"
        impl = os.environ.get("DS_SPARSE_IMPL", "fused")
        if impl not in ("fused", "gathered", "predicated"):
            raise ValueError(
                f"DS_SPARSE_IMPL must be 'fused', 'gathered' or "
                f"'predicated', got {impl!r}")
        if impl == "fused":
            return block_sparse_attention_fused(
                query, key, value, layout, key_padding_bias=kpb,
                block=cfg.block, causal=causal)
        if impl == "gathered":
            # the gathered form packs max_live key blocks a query block:
            # for dense-ish layouts that is near-O(S^2) memory; say so once
            # per layout
            wkey = (_config_key(cfg), S)
            if wkey not in _density_warned:
                _density_warned.add(wkey)
                lay = np.asarray(layout)
                max_live = int(lay.sum(axis=-1).max())
                nk = max(1, lay.shape[-1])
                if max_live >= 0.75 * nk:
                    logger.warning(
                        "SparseSelfAttention: layout density %.2f (max %d "
                        "live of %d key blocks): the gathered impl packs "
                        "near-full K/V copies at this density; "
                        "DS_SPARSE_IMPL=fused or predicated use less "
                        "memory", max_live / nk, max_live, nk)
            return block_sparse_attention_gathered(
                query, key, value, layout, key_padding_bias=kpb,
                block=cfg.block, causal=causal)
        return block_sparse_attention(
            query, key, value, layout, key_padding_bias=kpb,
            block=cfg.block, causal=causal)


class BertSparseSelfAttention(nn.Module):
    """BERT-shaped wrapper: the fused ``qkv`` projection [H -> 3H], then
    sparse attention over the heads. ``attention_mask`` [B, S] is a
    validity mask (1/True = attend), read as boolean."""

    def __init__(self, hidden_size, num_attention_heads,
                 sparsity_config: SparsityConfig = None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_attention_heads = num_attention_heads
        self.qkv = nn.Linear(hidden_size, 3 * hidden_size, device=device,
                             dtype=dtype)
        self.sparse_attn = SparseSelfAttention(
            sparsity_config or FixedSparsityConfig(
                num_heads=num_attention_heads))

    def forward(self, hidden_states, attention_mask=None):
        B, S, E = hidden_states.shape
        nh = self.num_attention_heads
        hd = E // nh
        q, k, v = (t.reshape(B, S, nh, hd).transpose(1, 2) for t in
                   self.qkv(hidden_states).split(E, dim=-1))
        if attention_mask is not None:
            # a float 1.0/0.0 validity mask must not be read as a bias
            attention_mask = torch.as_tensor(attention_mask).bool()
        ctx = self.sparse_attn(q, k, v, key_padding_mask=attention_mask)
        return ctx.transpose(1, 2).reshape(B, S, E)
