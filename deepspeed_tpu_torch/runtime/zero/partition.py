"""ZeRO's partition rule over ``torch.distributed`` (counterpart of
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

**Stages 2 and 3.** The gradients take the same slices
(:meth:`ZeroPartition.reduce_scatter`: one ``reduce_scatter_tensor`` a
group over a rank-major packed fp32 buffer, then × 1/world, as the
reference's reduce-scatter of its IPG buckets; a replicated tensor is
all-reduced whole). At stage 3 the fp32 masters are cut too, except a
tensor below ``param_persistence_threshold`` elements, which stays whole
on every rank (the reference's ``ds_persist``, JAX ``partition.py:66-68``:
the partition's ``min_numel``); the optimizer's and the gradients'
partition cuts every tensor it can (``min_numel`` 0, JAX
``engine.py:1116-1129``).

**Experts** (JAX ``partition.py:119-209``, ``_default_expert_filter``
:205). At an expert-parallel size ep > 1 the expert parameters (this
rank's E / ep experts of each layer) are cut over the expert-data group
(the world / ep ranks that hold the same experts) and the dense ones
over the world; the updates are gathered over the same groups, one
collective each. The boxes of an expert tensor are in its local
coordinates: the engine offsets them to the global expert range. LAMB's
per-tensor norms are the whole leaf's, all experts of a layer, as JAX's
are: :meth:`ZeroPartition.sum_over_ranks` counts each expert slice once
over the world. The sweep keeps two flat vectors back to back a moment,
the dense leaves' (cut over the world) and the experts' (cut over the
expert-data group): ``ops/adam/fused_adam.sweep_flatten``.
"""

import torch


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


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
    the world). ``expert_names`` are cut over ``expert_group`` instead,
    of ``expert_world`` ranks, this one ``expert_rank`` (ep > 1).
    ``cut=False`` cuts nothing (a ZeRO-0 engine's LAMB at ep > 1 sums its
    norms through it); a tensor of fewer than ``min_numel`` elements
    stays whole (stage 3's persistence threshold)."""

    def __init__(self, shapes, world, rank, group=None, expert_names=(),
                 expert_world=None, expert_rank=None, expert_group=None,
                 cut=True, min_numel=0):
        self.world, self.rank, self.group = int(world), int(rank), group
        self.expert = frozenset(expert_names)
        self.expert_world = self.world if expert_world is None \
            else int(expert_world)
        self.expert_rank = self.rank if expert_rank is None \
            else int(expert_rank)
        self.expert_group = expert_group
        self.shapes = {n: tuple(s) for n, s in shapes.items()}
        self.dims = {n: (choose_dim(s, self._world(n))
                         if cut and _numel(s) >= max(int(min_numel), 1)
                         else None)
                     for n, s in self.shapes.items()}
        self._masks = {}

    def _world(self, name):
        return self.expert_world if name in self.expert else self.world

    def _rank(self, name):
        return self.expert_rank if name in self.expert else self.rank

    def sharded(self, name):
        return self.dims[name] is not None

    def local(self, name, t):
        """This rank's slice of ``t`` (shaped like parameter ``name``): a
        view, contiguous when cut on dimension 0; ``t`` itself when the
        tensor is replicated."""
        d = self.dims[name]
        if d is None:
            return t
        n = t.shape[d] // self._world(name)
        return t.narrow(d, self._rank(name) * n, n)

    def local_shape(self, name):
        """The shape of this rank's slice of parameter ``name``."""
        shape, d = list(self.shapes[name]), self.dims[name]
        if d is not None:
            shape[d] //= self._world(name)
        return tuple(shape)

    def box(self, name):
        """The index ranges ``((start, stop), ...)`` of this rank's slice of
        parameter ``name``, in its torch layout (the whole range on every
        dimension of a replicated tensor)."""
        shape, d = self.shapes[name], self.dims[name]
        key = [(0, s) for s in shape]
        if d is not None:
            n = shape[d] // self._world(name)
            r = self._rank(name)
            key[d] = (r * n, (r + 1) * n)
        return tuple(key)

    def all_gather(self, local):
        """The whole tensors from every rank's slices: ``local`` maps names
        to this rank's slices (replicated tensors whole, passed through).
        One collective over a flat buffer of all the slices of each group
        (the world's; the expert-data group's)."""
        out = dict(local)
        for expert, world, group in ((False, self.world, self.group),
                                     (True, self.expert_world,
                                      self.expert_group)):
            names = [n for n in local if self.dims[n] is not None
                     and (n in self.expert) == expert]
            if not names:
                continue
            send = torch.cat([local[n].reshape(-1) for n in names])
            recv = torch.empty(world * send.numel(), dtype=send.dtype,
                               device=send.device)
            torch.distributed.all_gather_into_tensor(recv, send, group=group)
            recv = recv.view(world, send.numel())
            off = 0
            for n in names:
                t = local[n]
                size = t.numel()
                out[n] = torch.cat([recv[r, off:off + size].view(t.shape)
                                    for r in range(world)], dim=self.dims[n])
                off += size
        return out

    def _rank_major(self, name, t):
        """``t`` (shaped like parameter ``name``) as ``[world, slice
        numel]``, row r rank r's slice: a view when it is cut on
        dimension 0, else a copy."""
        d, world = self.dims[name], self._world(name)
        if d == 0:
            return t.reshape(world, -1)
        return t.unflatten(d, (world, t.shape[d] // world)).movedim(
            d, 0).reshape(world, -1)

    def reduce_scatter(self, grads):
        """This rank's slices of the gradients averaged over the ranks:
        ``grads`` maps names to whole fp32 gradients. Over each group (the
        world's; the expert-data group's) one ``reduce_scatter_tensor`` of
        a rank-major packed buffer of the cut tensors, and one all-reduce
        of the replicated ones, then × 1/world: the expert gradients are
        divided by the data world too, as each already sums its
        expert-parallel group's tokens (the engine's ``_average`` rule).
        Returns ``{name: slice}`` (a replicated tensor whole), views of
        the reduced buffers."""
        out = {}
        for expert, world, group in ((False, self.world, self.group),
                                     (True, self.expert_world,
                                      self.expert_group)):
            names = [n for n in grads if (n in self.expert) == expert]
            cut = [n for n in names if self.dims[n] is not None]
            if cut:
                send = torch.cat([self._rank_major(n, grads[n])
                                  for n in cut], dim=1)
                recv = torch.empty(send.shape[1], dtype=send.dtype,
                                   device=send.device)
                torch.distributed.reduce_scatter_tensor(
                    recv, send.reshape(-1), group=group)
                recv.mul_(1.0 / self.world)
                off = 0
                for n in cut:
                    shape = self.local_shape(n)
                    size = _numel(shape)
                    out[n] = recv[off:off + size].view(shape)
                    off += size
            whole = [n for n in names if self.dims[n] is None]
            if whole:
                flat = torch.cat([grads[n].reshape(-1) for n in whole])
                torch.distributed.all_reduce(flat, group=group)
                flat.mul_(1.0 / self.world)
                off = 0
                for n in whole:
                    g = grads[n]
                    out[n] = flat[off:off + g.numel()].view(g.shape)
                    off += g.numel()
        return {n: out[n] for n in grads}

    def reduce_scatter_flat(self, vec, expert=False):
        """This rank's chunk (:meth:`chunk`) of the flat vector ``vec``
        averaged over the ranks: one ``reduce_scatter_tensor`` over its
        group, then × 1/world (the sweep's padded gradient vector)."""
        world = self.group_world(expert)
        out = torch.empty(vec.numel() // world, dtype=vec.dtype,
                          device=vec.device)
        torch.distributed.reduce_scatter_tensor(
            out, vec, group=self.expert_group if expert else self.group)
        return out.mul_(1.0 / self.world)

    def sum_over_ranks(self, names, values):
        """Per-tensor sums (``values[..., i]`` belongs to ``names[i]``: a
        squared norm of this rank's slice) summed over the ranks, each
        replicated tensor counted once (rank 0's; an expert tensor's once
        per expert, its expert-data rank 0's): one all-reduce over the
        world. An expert tensor's sum spans all the layer's experts."""
        key = tuple(names)
        mask = self._masks.get(key)
        if mask is None or mask.device != values.device:
            mask = torch.tensor(
                [1.0 if self.dims[n] is not None or self._rank(n) == 0
                 else 0.0 for n in names], dtype=values.dtype,
                device=values.device)
            self._masks[key] = mask
        values = values * mask
        torch.distributed.all_reduce(values, group=self.group)
        return values

    # -------------------------------------------------- the sweep's vector
    def group_world(self, expert=False):
        """The ranks a flat vector of dense (or expert) leaves is cut
        over."""
        return self.expert_world if expert else self.world

    def chunk(self, vec, expert=False):
        """This rank's contiguous chunk of a flat vector (of expert leaves:
        its chunk over the expert-data group)."""
        world = self.group_world(expert)
        rank = self.expert_rank if expert else self.rank
        n = vec.numel() // world
        return vec.narrow(0, rank * n, n)

    def gather_flat(self, chunk, expert=False):
        """The whole flat vector from every rank's chunk (of its group)."""
        out = torch.empty(self.group_world(expert) * chunk.numel(),
                          dtype=chunk.dtype, device=chunk.device)
        torch.distributed.all_gather_into_tensor(
            out, chunk.contiguous(),
            group=self.expert_group if expert else self.group)
        return out


def estimate_zero_mem(num_params: int, dp_world: int, stage: int,
                      bytes_per_param_fp32=4, bytes_per_param_bf16=2,
                      optimizer_mult=2):
    """Bytes a rank holds for the model states at a ZeRO ``stage`` (the
    JAX package's model, after the reference's
    ``estimate_zero{2,3}_model_states_mem_needs``): the compute-dtype
    params, fp32 gradients, fp32 masters and ``optimizer_mult`` fp32
    moments, each divided by ``dp_world`` from the stage that cuts it."""
    p = num_params
    opt_bytes = optimizer_mult * bytes_per_param_fp32 * p  # m+v fp32
    master_bytes = bytes_per_param_fp32 * p
    grad_bytes = bytes_per_param_fp32 * p
    model_bytes = bytes_per_param_bf16 * p
    if stage == 0:
        return model_bytes + grad_bytes + master_bytes + opt_bytes
    if stage == 1:
        return model_bytes + grad_bytes + (master_bytes + opt_bytes) / dp_world
    if stage == 2:
        return model_bytes + (grad_bytes + master_bytes + opt_bytes) / dp_world
    return (model_bytes + grad_bytes + master_bytes + opt_bytes) / dp_world
