"""Sequence parallelism over ``torch.distributed``: ring attention and
Ulysses (counterpart of ``deepspeed_tpu/ops/transformer/ring.py``).

Each rank holds its contiguous chunk of the sequence, ``[B, H, S/n, D]``
(rank r the r-th chunk), and gets back its chunk of the output. Both
functions are differentiable: autograd runs through the composition of
the flash kernels (``flash_attention_with_lse``, whose lse gradient the
merge needs) and the collectives below.

* :func:`ring_attention` keeps q resident and passes the K/V chunks
  around the ring (to rank + 1, from rank − 1, ``batch_isend_irecv``),
  merging each chunk's partial output by its log-sum-exp (``_merge``, the
  online-softmax rule), which makes the result exactly full attention.
  Under ``causal`` the host decides what each chunk needs, where JAX
  computes both the causal and the full attention of every chunk and
  selects (ring.py:84-93): the rank's own chunk takes the causal
  diagonal, an earlier rank's the full attention, and a later rank's no
  launch at all (its lse would be −inf, its weight 0). The first chunk's
  merge with nothing is skipped: it is the identity, so at world size 1
  the output and gradients are ``flash_attention``'s bit for bit.
* :func:`ulysses_attention` (DeepSpeed-Ulysses): an all-to-all swaps the
  sharded dimension from sequence to heads, flash attention runs on the
  whole sequence for the rank's heads, and a second all-to-all swaps
  back. Its backward is the inverse all-to-all. Heads must divide by the
  world size.

The ring's passes are one ``autograd.Function`` (:class:`_RingPass`): its
forward makes the n − 1 rotations and returns every chunk the rank sees;
its backward sends the cotangents back the other way (to rank − 1, what
JAX's ``ppermute`` transposes to) and sums them. As one node it runs on
every rank, in one order, even where a causal rank leaves chunks unused
(their cotangents are zeros), so no rank waits on a send that never
comes. It holds all n chunks at once; a hand-fused ring backward that
streams them is perf work.
"""

import torch

from deepspeed_tpu_torch.ops.transformer.flash import (
    flash_attention, flash_attention_with_lse)


def _world(group):
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _global(group, rank):
    if group is None:
        return rank
    return torch.distributed.get_global_rank(group, rank)


def _shift(tensors, group, world, rank, step):
    """Each tensor sent to rank + ``step`` and replaced by the one from
    rank − ``step`` (ranks mod ``world``)."""
    dist = torch.distributed
    dst = _global(group, (rank + step) % world)
    src = _global(group, (rank - step) % world)
    outs = [torch.empty_like(t, memory_format=torch.contiguous_format)
            for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), dst, group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, src, group) for o in outs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _RingPass(torch.autograd.Function):
    """(k, v) -> every chunk the ring brings: k_0, v_0, ..., k_{n-1},
    v_{n-1}, chunk s being rank − s's. The backward rotates the summed
    cotangents back, chunk by chunk."""

    @staticmethod
    def forward(ctx, k, v, group, world, rank):
        ctx.group, ctx.world, ctx.rank = group, world, rank
        outs = [k, v]
        for _ in range(world - 1):
            outs += _shift(outs[-2:], group, world, rank, 1)
        # the first pair is the input itself: hand autograd views
        return tuple([k.view_as(k), v.view_as(v)] + outs[2:])

    @staticmethod
    def backward(ctx, *grads):
        world = ctx.world
        gk, gv = grads[-2], grads[-1]
        for s in range(world - 2, -1, -1):
            gk, gv = _shift([gk, gv], ctx.group, world, ctx.rank, -1)
            gk = gk + grads[2 * s]
            gv = gv + grads[2 * s + 1]
        return gk, gv, None, None, None


def _merge(o1, lse1, o2, lse2):
    """Online-softmax merge of two partial attention results (JAX
    ``_merge``, ring.py:56-66)."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = w1 + w2
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = (o1.float() * w1[..., None] + o2.float() * w2[..., None]) / \
        denom[..., None]
    return out.to(o1.dtype), m + torch.log(denom)


def ring_attention(q, k, v, group=None, causal=True, sm_scale=None):
    """Exact attention over a sequence split into contiguous chunks, one a
    rank of ``group`` (None: the world): q, k, v are this rank's
    ``[B, H, S/n, D]`` chunk; returns this rank's output chunk."""
    world, rank = _world(group)
    if world > 1:
        chunks = _RingPass.apply(k, v, group, world, rank)
    else:
        chunks = (k, v)
    o_acc = lse_acc = None
    for s in range(world):
        src = (rank - s) % world          # the owner of chunk s
        if causal and src > rank:
            continue                      # entirely above the diagonal
        o_s, lse_s = flash_attention_with_lse(
            q, chunks[2 * s], chunks[2 * s + 1], causal and src == rank,
            sm_scale)
        if o_acc is None:
            o_acc, lse_acc = o_s, lse_s
        else:
            o_acc, lse_acc = _merge(o_acc, lse_acc, o_s, lse_s)
    return o_acc


class _SeqToHeads(torch.autograd.Function):
    """[B, H, S/n, D] (this rank's sequence chunk, all heads) ->
    [B, H/n, S, D] (every chunk, this rank's heads); the backward is the
    inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, world):
        ctx.group, ctx.world = group, world
        return _seq_to_heads(x, group, world)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.group, ctx.world), None, None


class _HeadsToSeq(torch.autograd.Function):
    """The inverse of :class:`_SeqToHeads`."""

    @staticmethod
    def forward(ctx, x, group, world):
        ctx.group, ctx.world = group, world
        return _heads_to_seq(x, group, world)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.group, ctx.world), None, None


def _seq_to_heads(x, group, world):
    B, H, S, D = x.shape
    send = x.reshape(B, world, H // world, S, D).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    torch.distributed.all_to_all_single(recv, send, group=group)
    # recv[j]: rank j's sequence chunk of this rank's heads
    return recv.permute(1, 2, 0, 3, 4).reshape(B, H // world, world * S, D)


def _heads_to_seq(x, group, world):
    B, h, S, D = x.shape
    send = x.reshape(B, h, world, S // world, D).permute(2, 0, 1, 3, 4) \
        .contiguous()
    recv = torch.empty_like(send)
    torch.distributed.all_to_all_single(recv, send, group=group)
    # recv[j]: rank j's heads of this rank's sequence chunk
    return recv.transpose(0, 1).reshape(B, world * h, S // world, D)


def ulysses_attention(q, k, v, group=None, causal=True, sm_scale=None):
    """DeepSpeed-Ulysses over ``group`` (None: the world): q, k, v are this
    rank's ``[B, H, S/n, D]`` chunk; returns this rank's output chunk.
    Raises when the heads do not divide by the world size (JAX asserts,
    ring.py:153-155)."""
    world, _ = _world(group)
    H = q.shape[1]
    if H % world:
        raise ValueError(f"ulysses needs heads ({H}) divisible by the "
                         f"world size ({world})")
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return flash_attention(q, k, v, causal, sm_scale)
    qh, kh, vh = (_SeqToHeads.apply(t, group, world) for t in (q, k, v))
    out = flash_attention(qh, kh, vh, causal, sm_scale)
    return _HeadsToSeq.apply(out, group, world)
