"""The ``"sparse_attention"`` config block and the model-side helpers
(counterpart of
``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``).

As in the JAX package, the substitution of sparse self-attention happens
at the model-config level: :meth:`SparseAttentionUtils.apply_to_bert_config`
maps the JSON block onto the ``BertConfig`` fields that select
``models.bert.BertSparseLayer``.
"""

import dataclasses

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, VariableSparsityConfig)

_MODES = {
    "dense": DenseSparsityConfig,
    "fixed": FixedSparsityConfig,
    "variable": VariableSparsityConfig,
    "bigbird": BigBirdSparsityConfig,
    "bslongformer": BSLongformerSparsityConfig,
}


def get_sparse_attention_config(ds_config_dict, num_heads):
    """The JSON ``sparse_attention`` block -> a SparsityConfig. None when
    the block is absent; an empty block gives the fixed-mode defaults;
    unknown keys raise from the sparsity config's constructor."""
    block_cfg = (ds_config_dict or {}).get("sparse_attention")
    if block_cfg is None:
        return None
    if not isinstance(block_cfg, dict):
        raise ValueError(
            f"'sparse_attention' must be a dict block, got "
            f"{block_cfg!r} (use {{}} for fixed-mode defaults)")
    mode = block_cfg.get("mode", "fixed")
    if mode not in _MODES:
        raise NotImplementedError(
            f"Given sparsity mode, {mode}, has not been implemented yet!")
    kwargs = {k: v for k, v in block_cfg.items() if k != "mode"}
    return _MODES[mode](num_heads=num_heads, **kwargs)


class SparseAttentionUtils:
    """The reference's class surface."""

    # the JSON keys BertConfig can represent, per mode (beyond "mode")
    _BERT_FIELDS = {
        "fixed": {"block", "num_local_blocks", "num_global_blocks"},
        "dense": {"block"},
        "bigbird": {"block"},
        "bslongformer": {"block"},
        "variable": {"block"},
    }

    @staticmethod
    def apply_to_bert_config(bert_config, ds_config_dict):
        """A BertConfig whose layers use block-sparse attention as the
        ``sparse_attention`` block says. The whole block is validated
        first (a mistyped key raises); keys BertConfig cannot carry raise
        rather than train another pattern than configured."""
        sc = get_sparse_attention_config(
            ds_config_dict, bert_config.num_attention_heads)
        if sc is None:
            return bert_config
        block_cfg = ds_config_dict["sparse_attention"]
        mode = block_cfg.get("mode", "fixed")
        extra = (set(block_cfg) - {"mode"}
                 - SparseAttentionUtils._BERT_FIELDS[mode])
        if extra:
            raise ValueError(
                f"sparse_attention keys {sorted(extra)} are valid for "
                f"mode {mode!r} but not representable in BertConfig; "
                "construct BertSparseLayer with a custom SparsityConfig "
                "instead")
        updates = {"sparse_attention_mode": mode, "sparse_block": sc.block}
        if mode == "fixed":
            updates["sparse_num_local_blocks"] = sc.num_local_blocks
            updates["sparse_num_global_blocks"] = sc.num_global_blocks
        return dataclasses.replace(bert_config, **updates)

    @staticmethod
    def pad_to_block_size(block_size, input_ids, attention_mask=None,
                          pad_token_id=0):
        """Pad the sequence dim up to a multiple of the sparsity block;
        returns (pad_len, input_ids, attention_mask). A mask is always
        returned."""
        S = input_ids.shape[1]
        pad_len = (-S) % block_size
        if attention_mask is None:
            attention_mask = torch.ones(input_ids.shape, dtype=torch.int32,
                                        device=input_ids.device)
        if pad_len == 0:
            return 0, input_ids, attention_mask
        ids = F.pad(input_ids, (0, pad_len), value=pad_token_id)
        mask = F.pad(attention_mask, (0, pad_len), value=0)
        return pad_len, ids, mask

    @staticmethod
    def unpad_sequence_output(pad_len, sequence_output):
        """Strip the block padding again."""
        if pad_len == 0:
            return sequence_output
        return sequence_output[:, :-pad_len]
