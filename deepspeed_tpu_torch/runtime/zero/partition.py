"""ZeRO-1's partition rule over ``torch.distributed`` (counterpart of
``deepspeed_tpu/runtime/zero/partition.py``).

The JAX package shards optimizer state by sharding annotations: each
param-shaped leaf takes the data axes on the largest dimension that the
data-parallel world divides (``choose_zero_spec``), and XLA runs the
update on each device's shard and gathers the updated params after it.
The port does that by hand, one process a rank:

* **The rule.** Each tensor is cut on its *leading* dimension when the
  world divides it, so every rank's slice is one contiguous run of the
  tensor: the kernels read it in place, with no copy. Otherwise on the
  largest other dimension the world divides (JAX's choice; the slice is
  strided and the optimizer works on a contiguous copy). A tensor that no
  dimension of fits, and every scalar, stays replicated, as in JAX
  (``partition.py:73-75``): every rank keeps and updates it whole. A
  slice is an n-d box, so the checkpoint's shards-v1 records key it by
  its index ranges as JAX's do, and a load reassembles any set of boxes,
  whichever rule wrote them. (JAX cuts a flax ``[1024, 4096]`` kernel on
  dimension 1, a strided slice in PyTorch; the port cuts the same
  weight, ``[4096, 1024]`` in torch's layout, on dimension 0.)
* **The sweep** (``optimizer.params.sweep``) keeps one padded flat
  vector a moment. It is padded to a multiple of ``sweep_pad() × world``
  and cut into ``world`` equal contiguous chunks, each a multiple of the
  kernel's block.
* **The epilogue.** Each rank updates its slices; one
  ``all_gather_into_tensor`` over a flat buffer of all slices then gives
  every rank the whole update, which it adds to its fp32 masters: the
  same bits as gathering the updated masters (one fp32 add, the same on
  every rank).

At world size 1 with a process group every tensor is "cut" into one
slice, the whole tensor, so the single-card run goes through the same
collectives as a larger world.
"""

import torch


def choose_dim(shape, world):
    """The dimension each rank's slice is cut on, or None (replicated):
    the leading dimension when ``world`` divides it, else the largest
    other dimension it divides."""
    if len(shape) == 0 or 0 in shape:
        return None
    if shape[0] % world == 0:
        return 0
    best, best_len = None, 0
    for d in range(1, len(shape)):
        if shape[d] % world == 0 and shape[d] > best_len:
            best, best_len = d, shape[d]
    return best


class ZeroPartition:
    """The slices of one rank: ``shapes`` maps each parameter name to its
    (torch) shape. ``group`` is the data-parallel process group (None:
    the world)."""

    def __init__(self, shapes, world, rank, group=None):
        self.world, self.rank, self.group = int(world), int(rank), group
        self.shapes = {n: tuple(s) for n, s in shapes.items()}
        self.dims = {n: choose_dim(s, self.world)
                     for n, s in self.shapes.items()}
        self._masks = {}

    def sharded(self, name):
        return self.dims[name] is not None

    def local(self, name, t):
        """This rank's slice of ``t`` (shaped like parameter ``name``): a
        view, contiguous when cut on dimension 0; ``t`` itself when the
        tensor is replicated."""
        d = self.dims[name]
        if d is None:
            return t
        n = t.shape[d] // self.world
        return t.narrow(d, self.rank * n, n)

    def box(self, name):
        """The index ranges ``((start, stop), ...)`` of this rank's slice of
        parameter ``name``, in its torch layout (the whole range on every
        dimension of a replicated tensor)."""
        shape, d = self.shapes[name], self.dims[name]
        key = [(0, s) for s in shape]
        if d is not None:
            n = shape[d] // self.world
            key[d] = (self.rank * n, (self.rank + 1) * n)
        return tuple(key)

    def all_gather(self, local):
        """The whole tensors from every rank's slices: ``local`` maps names
        to this rank's slices (replicated tensors whole, passed through).
        One collective over a flat buffer of all the slices."""
        names = [n for n in local if self.dims[n] is not None]
        out = dict(local)
        if not names:
            return out
        send = torch.cat([local[n].reshape(-1) for n in names])
        recv = torch.empty(self.world * send.numel(), dtype=send.dtype,
                           device=send.device)
        torch.distributed.all_gather_into_tensor(recv, send,
                                                 group=self.group)
        recv = recv.view(self.world, send.numel())
        off = 0
        for n in names:
            t = local[n]
            size = t.numel()
            out[n] = torch.cat([recv[r, off:off + size].view(t.shape)
                                for r in range(self.world)],
                               dim=self.dims[n])
            off += size
        return out

    def sum_over_ranks(self, names, values):
        """Per-tensor sums (``values[..., i]`` belongs to ``names[i]``: a
        squared norm of this rank's slice) summed over the ranks, each
        replicated tensor counted once (rank 0's): one all-reduce."""
        key = tuple(names)
        mask = self._masks.get(key)
        if mask is None or mask.device != values.device:
            mask = torch.tensor(
                [1.0 if self.dims[n] is not None or self.rank == 0 else 0.0
                 for n in names], dtype=values.dtype, device=values.device)
            self._masks[key] = mask
        values = values * mask
        torch.distributed.all_reduce(values, group=self.group)
        return values

    # -------------------------------------------------- the sweep's vector
    def chunk(self, vec):
        """This rank's contiguous chunk of a flat vector."""
        n = vec.numel() // self.world
        return vec.narrow(0, self.rank * n, n)

    def gather_flat(self, chunk):
        """The whole flat vector from every rank's chunk."""
        out = torch.empty(self.world * chunk.numel(), dtype=chunk.dtype,
                          device=chunk.device)
        torch.distributed.all_gather_into_tensor(out, chunk.contiguous(),
                                                 group=self.group)
        return out
