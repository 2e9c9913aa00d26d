"""Paged attention over the LIVE KV blocks (counterpart of
``deepspeed_tpu/serving/paged_attention.py``).

The runner's ``gather`` impl materialises each slot's whole allocated
window for the decode kernel; these functions read only the blocks that
hold tokens. JAX walks them with a ``fori_loop`` of online-softmax steps
whose trip count ``ceil(max(past_lens) / BS)`` is a traced scalar. Here
the trip count is a host integer (``n_blocks``): the server knows every
slot's position, so no device value is read back to size the work.

Design: each call gathers the ``n_blocks`` live blocks once (one indexed
read per pool) and runs ONE masked softmax over the past columns and the
current token or chunk, where JAX runs one online-softmax step a block
and merges the chunk's causal piece. It is the same function over the
same blocks (the normalised weights agree to fp32 rounding; the tests
hold it to JAX at 1e-5), with a fixed handful of device ops a layer in
place of several per block, which is what the card's launch-bound
decode step pays for.

The current token or chunk is attended from its registers at full
precision, before its pool write; the int8 layout dequantises the past
blocks from the per-row scale pools (the runner passes the current K/V
already int8-round-tripped, as JAX does).
"""

import torch

NEG_INF = -1e30


def _live_past(pool, scale_pool, layer, ids):
    """``pool[layer][ids]`` -> fp32 ``[B, H, n*BS, D]`` (dequantised with
    the row scales for the int8 layout); ids ``[B, n]``."""
    B, n = ids.shape
    x = pool[layer][ids]                          # [B, n, H, BS, D]
    _, _, H, BS, D = x.shape
    x = x.transpose(1, 2).reshape(B, H, n * BS, D).float()
    if scale_pool is not None:
        s = scale_pool[layer][ids].transpose(1, 2).reshape(B, H, n * BS)
        x = x * s[..., None]
    return x


def _attend(s, v_past, v_new):
    """softmax over the last axis of ``s`` = [past columns | new
    columns], then the weighted sum of ``v_past`` and ``v_new``."""
    T = v_past.shape[-2]
    p = torch.softmax(s, dim=-1)
    return p[..., :T] @ v_past + p[..., T:] @ v_new


def paged_decode_attention(q, k_cur, v_cur, layer, k_pool, v_pool,
                           block_tables, past_lens, *, n_blocks,
                           k_scale_pool=None, v_scale_pool=None,
                           sm_scale=None):
    """One decode token per slot over the paged pools.

    q/k_cur/v_cur: ``[B, H, D]`` (the current token's K/V, not yet
    written); pools: layer-stacked ``[L, N, H, BS, D]``; block_tables:
    ``[B, MB]``; past_lens: ``[B]`` tokens ALREADY in the pool; n_blocks:
    host int >= ``ceil(max(past_lens) / BS)``. Returns ``[B, H, D]``
    fp32."""
    D = q.shape[-1]
    if sm_scale is None:
        sm_scale = D ** -0.5
    qf = q.float()[:, :, None, :]                         # [B, H, 1, D]
    ids = block_tables[:, :n_blocks]
    kb = _live_past(k_pool, k_scale_pool, layer, ids)
    vb = _live_past(v_pool, v_scale_pool, layer, ids)
    s_past = (qf @ kb.transpose(-1, -2)) * sm_scale      # [B, H, 1, T]
    col = torch.arange(kb.shape[2], device=q.device)
    s_past = torch.where(col < past_lens[:, None, None, None], s_past,
                         NEG_INF)
    kc = k_cur.float()[:, :, None, :]
    s_cur = (qf @ kc.transpose(-1, -2)) * sm_scale       # [B, H, 1, 1]
    out = _attend(torch.cat([s_past, s_cur], dim=-1), vb,
                  v_cur.float()[:, :, None, :])
    return out[:, :, 0]


def paged_verify_attention(q, k_chunk, v_chunk, layer, k_pool, v_pool,
                           block_tables, past_lens, *, n_blocks,
                           k_scale_pool=None, v_scale_pool=None,
                           sm_scale=None):
    """Speculative verify: ``C = K+1`` queries PER SLOT over each slot's
    past pages plus the candidate chunk itself (causal).

    q/k_chunk/v_chunk: ``[B, H, C, D]`` (query c at absolute position
    ``past_lens[b] + c``); block_tables ``[B, MB]``; past_lens ``[B]``;
    n_blocks as for :func:`paged_decode_attention`. Returns
    ``[B, H, C, D]`` fp32."""
    C, D = q.shape[-2:]
    if sm_scale is None:
        sm_scale = D ** -0.5
    qf = q.float()
    ids = block_tables[:, :n_blocks]
    kb = _live_past(k_pool, k_scale_pool, layer, ids)
    vb = _live_past(v_pool, v_scale_pool, layer, ids)
    s_past = (qf @ kb.transpose(-1, -2)) * sm_scale      # [B, H, C, T]
    col = torch.arange(kb.shape[2], device=q.device)
    s_past = torch.where(col < past_lens[:, None, None, None], s_past,
                         NEG_INF)
    s_in = (qf @ k_chunk.float().transpose(-1, -2)) * sm_scale
    idx = torch.arange(C, device=q.device)
    s_in = torch.where(idx[:, None] >= idx[None, :], s_in, NEG_INF)
    return _attend(torch.cat([s_past, s_in], dim=-1), vb, v_chunk.float())


def paged_prefill_attention(q, k_chunk, v_chunk, layer, k_pool, v_pool,
                            bt_row, start, *, k_scale_pool=None,
                            v_scale_pool=None, sm_scale=None):
    """Chunk attention for ONE slot: ``C`` queries at positions
    ``start + 0..C-1`` over the slot's past pages plus the chunk itself
    (causal; the chunk's pool write comes after).

    q/k_chunk/v_chunk: ``[H, C, D]``; bt_row: ``[MB]``; start: host int,
    tokens already in the pool. Returns ``[H, C, D]`` fp32."""
    BS = k_pool.shape[3]
    n_blocks = -(-int(start) // BS)
    out = paged_verify_attention(
        q[None], k_chunk[None], v_chunk[None], layer, k_pool, v_pool,
        bt_row[None], torch.full((1,), int(start), device=q.device),
        n_blocks=n_blocks, k_scale_pool=k_scale_pool,
        v_scale_pool=v_scale_pool, sm_scale=sm_scale)
    return out[0]
