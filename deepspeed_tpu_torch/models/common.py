"""Shared model-family helpers (counterpart of
``deepspeed_tpu/models/common.py``)."""

import torch


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
