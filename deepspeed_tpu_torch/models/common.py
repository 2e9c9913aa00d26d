"""Shared model-family helpers (counterpart of
``deepspeed_tpu/models/common.py``)."""

import torch
from torch import nn


def masked_next_token_ce(shift_logits, shift_labels):
    """Next-token cross-entropy as logsumexp minus the gold logit, with the
    ignore_index=-100 convention (any negative label is ignored). Inputs
    are already shifted: ``shift_logits[b, s]`` predicts
    ``shift_labels[b, s]``."""
    shift_logits = shift_logits.float()
    lse = torch.logsumexp(shift_logits, dim=-1)
    gold = torch.gather(shift_logits, -1,
                        shift_labels.clamp(min=0).long()[..., None])[..., 0]
    valid = (shift_labels >= 0).float()
    return ((lse - gold) * valid).sum() / valid.sum().clamp(min=1.0)


def lecun_normal_(weight, gen):
    """flax ``lecun_normal`` (``nn.Dense``'s and ``nn.Conv``'s kernel
    init, and ``nn.Embed``'s on a [vocab, dim] table): a normal truncated
    at 2 std, rescaled so the variance is 1 / fan_in, fan_in = the
    elements of one output row (``weight[0]``)."""
    std = weight[0].numel() ** -0.5 / .87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=gen)
