"""Block-sparse attention, the predicated and gathered forms (counterpart of
``deepspeed_tpu/ops/sparse_attention/kernels.py``).

:func:`block_sparse_attention` is the predicated form. On the TPU it
sweeps every key block and predicates each on ``layout[h, qi, j]``; on
Hopper it runs the same three kernels as the fused form
(``csrc/sparse_attention.cu``) over the tile lists of the raw layout, with
no decomposition and no packing. As the JAX ``_bs_bwd`` does, it returns
no gradient for the key-padding bias. Its forward clamps the weights of a
row whose live keys so far are all causally masked (the fused form's
rule); the JAX predicated kernel does not, which changes nothing unless a
row's live blocks hold no key it may attend, where the JAX output is the
mean of masked values.

:func:`block_sparse_attention_gathered` is plain torch in both packages
(jnp in JAX): it gathers each query block's live key blocks and runs
dense products over them, recomputed in the backward
(``torch.utils.checkpoint``, where JAX uses ``jax.checkpoint``).
"""

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.ops.sparse_attention.fused_kernels import (
    NEG_INF, SparseAttentionFunction, _get_strategy)


def _concrete(layout):
    if isinstance(layout, torch.Tensor):
        return layout.cpu().numpy()
    return np.asarray(layout)


def block_sparse_attention(q, k, v, layout, key_padding_bias=None,
                           block=None, causal=False, sm_scale=None):
    """Attention restricted to the block layout.

    q, k, v: [B, H, S, D]; layout: [H, S // block, S // block] int;
    key_padding_bias: optional [B, S] additive fp32 score bias (0 = attend,
    about -1e9 = masked key). Differentiable in q, k and v."""
    B, H, S, D = q.shape
    lay = _concrete(layout) != 0
    if block is None:
        block = S // lay.shape[-1]
    if lay.shape[-1] * block != S:
        raise ValueError(f"layout {lay.shape} with block {block} does not "
                         f"cover the sequence {S}")
    if sm_scale is None:
        sm_scale = D ** -0.5
    if key_padding_bias is not None and \
            tuple(key_padding_bias.shape) != (B, S):
        raise ValueError(f"key_padding_bias must be [B, S] = {(B, S)}, got "
                         f"{tuple(key_padding_bias.shape)}")
    strat = _get_strategy(lay, block, causal, sm_scale, device=q.device)
    return SparseAttentionFunction.apply(q, k, v, key_padding_bias, strat,
                                         False, False)


def block_sparse_attention_gathered(q, k, v, layout, key_padding_bias=None,
                                    block=None, causal=False, sm_scale=None):
    """Gather-then-dense block-sparse attention: the semantics of
    :func:`block_sparse_attention`, in plain torch. Each query block's
    live key blocks are packed into ``[nq, max_live, block, D]`` (padded to
    the longest row) and dense products run over them; the backward
    recomputes them."""
    B, H, S, D = q.shape
    lay = _concrete(layout) != 0
    if block is None:
        block = S // lay.shape[-1]
    if sm_scale is None:
        sm_scale = D ** -0.5
    Hh, nq, nk = lay.shape
    if nq * block != S:
        raise ValueError(f"layout {lay.shape} with block {block} does not "
                         f"cover the sequence {S}")
    max_live = max(int(lay.sum(axis=-1).max()), 1)
    # idx[h, i, t] = t-th live key block of query block i
    idx = np.zeros((Hh, nq, max_live), np.int64)
    valid = np.zeros((Hh, nq, max_live), bool)
    for h in range(Hh):
        for i in range(nq):
            live = np.nonzero(lay[h, i])[0]
            idx[h, i, :len(live)] = live
            valid[h, i, :len(live)] = True
    cols = idx[..., None] * block + np.arange(block)    # [H, nq, L, blk]
    dev = q.device
    mask = torch.as_tensor(np.repeat(valid[..., None], block, -1),
                           device=dev)[:, :, None]       # [H, nq, 1, L, blk]
    if causal:
        rows = np.arange(nq)[:, None] * block + np.arange(block)[None, :]
        cmask = cols[:, :, None, :, :] <= rows[None, :, :, None, None]
        mask = mask & torch.as_tensor(cmask, device=dev)
    idx_t = torch.as_tensor(idx, device=dev)
    cols_t = torch.as_tensor(cols.reshape(Hh, -1), device=dev)

    def attend(q, k, v, kpb):
        kb = k.reshape(B, H, nk, block, D)
        vb = v.reshape(B, H, nk, block, D)
        heads = torch.arange(H, device=dev)[:, None, None]
        kg = kb[:, heads, idx_t]                         # [B,H,nq,L,blk,D]
        vg = vb[:, heads, idx_t]
        qb = q.reshape(B, H, nq, block, D)
        s = torch.einsum("bhipd,bhilcd->bhiplc", qb.float(),
                         kg.float()) * sm_scale
        s = torch.where(mask[None], s, NEG_INF)
        if kpb is not None:
            kpb_g = kpb.float()[:, cols_t].reshape(B, Hh, nq, max_live,
                                                   block)
            s = s + kpb_g[:, :, :, None]
        sf = s.reshape(B, H, nq, block, max_live * block)
        m = sf.amax(-1, keepdim=True)
        # rows with no live key (fully masked) give zeros, not NaN
        p = torch.exp(sf - torch.clamp(m, min=NEG_INF / 2))
        l = p.sum(-1, keepdim=True)
        p = p / torch.where(l == 0.0, 1.0, l)
        out = torch.einsum(
            "bhiplc,bhilcd->bhipd",
            p.reshape(B, H, nq, block, max_live, block).to(v.dtype).float(),
            vg.float())
        return out.reshape(B, H, S, D).to(q.dtype)

    return checkpoint(attend, q, k, v, key_padding_bias, use_reentrant=False)


def layout_to_dense_mask(layout, block, seq):
    """Expand a block layout to an element mask [H, S, S] (the oracle)."""
    lay = _concrete(layout)
    return np.kron(lay, np.ones((block, block), dtype=bool))
