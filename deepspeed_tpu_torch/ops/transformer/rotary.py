"""Rotary position embeddings (RoPE), counterpart of
``deepspeed_tpu/ops/transformer/rotary.py``.

Rotates each (even, odd) feature pair of q and k by an angle that grows
with the position: the interleaved-pair convention of the original RoPE
and of GPT-J. With ``rotary_dim`` only the leading features rotate
(partial rotary); the rest pass through. The tables are fp32 and the
outputs keep the inputs' dtype.

Plain PyTorch: the work is elementwise over q and k and a small trig
table, which the JAX package also leaves to XLA (no Pallas kernel), so
there is no kernel to port.

Layout ``[B, H, S, D]``. ``offset`` places the block inside a longer
sequence: an int, a 0-d tensor (the decode step's cache length) or a
``[B]`` tensor, one offset a row.
"""

import torch


def rotary_tables(seq_len, dim, base=10000.0, offset=0, device=None):
    """fp32 (cos, sin) tables for positions ``offset .. offset + S - 1``:
    ``[S, dim / 2]`` for a scalar offset, ``[B, S, dim / 2]`` for a
    ``[B]`` tensor of offsets."""
    inv_freq = 1.0 / (base ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=device) / dim))
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    if isinstance(offset, torch.Tensor):
        off = offset.to(device=device, dtype=torch.float32)
        pos = pos + (off[:, None] if off.dim() == 1 else off)
    else:
        pos = pos + float(offset)
    ang = pos[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rotary_pos_emb(q, k, offset=0, base=10000.0, rotary_dim=None):
    """(q_rot, k_rot): the leading ``rotary_dim`` features (default all)
    of q and k rotated pair by pair, in the inputs' dtypes."""
    B, H, S, D = q.shape
    rd = rotary_dim or D
    if rd % 2:
        raise ValueError(f"rotary dim must be even, got {rd}")
    cos, sin = rotary_tables(S, rd, base=base, offset=offset,
                             device=q.device)
    # [S, rd/2] -> broadcast over B, H; [B, S, rd/2] -> over H
    cos = cos[:, None] if cos.dim() == 3 else cos
    sin = sin[:, None] if sin.dim() == 3 else sin

    def rot(x):
        xr = x[..., :rd]
        x1 = xr[..., 0::2].float()
        x2 = xr[..., 1::2].float()
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).flatten(-2).to(x.dtype)
        return torch.cat([out, x[..., rd:]], dim=-1) if rd < D else out

    return rot(q), rot(k)
