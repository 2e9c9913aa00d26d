"""The process-group layer (counterpart of ``deepspeed_tpu/utils/groups.py``).

The JAX package builds one named mesh ``("pipe", "data", "expert",
"model")`` whose axes are the groups. The port runs one process a rank
over ``torch.distributed``, and keeps the mesh's order for the ranks:
with ``ep_size`` experts a group, rank = d · ep + e (``d`` the expert-data
index, ``e`` the expert-parallel index; JAX ``groups.py:55-75`` carves
the expert axis out of the data axis the same way). So

* the **data-parallel** group is the whole world (``torch.distributed``'s
  default group): dense gradients are averaged over it;
* the **expert-parallel** group of a rank is the ``ep`` consecutive ranks
  ``d · ep .. d · ep + ep - 1``: the MoE all-to-all runs over it, and
  each of its ranks holds ``E / ep`` of a layer's experts;
* the **expert-data** group of a rank is the ranks with the same ``e``
  (``world / ep`` of them): expert gradients are summed over it and the
  ZeRO-1 slices of expert parameters are cut over it.

``pipe`` and ``model`` have size 1; any other size raises
``NotImplementedError`` naming the ROADMAP Queue A item that ports it.

:func:`axis_group` gives a sequence-parallel attention mode
(``"ring:<axis>"`` / ``"ulysses:<axis>"``) the process group of a mesh
axis name: ``data`` the expert-data group (the world at ``ep_size`` 1),
``expert`` the expert-parallel group, ``model`` and ``pipe`` a group of
one rank.

With no process group initialised the world is one rank: every getter
answers 1 (sizes) or 0 (ranks), ``ep_size`` must be 1, and the engine
runs no collective. With one (``deepspeed_tpu_torch.init_distributed``),
the engine runs its collectives over it, at world size 1 too.
"""

import torch

# the JAX package's axis names, kept here (the port imports nothing of it)
PIPE_AXIS = "pipe"
DATA_AXIS = "data"
EXPERT_AXIS = "expert"
MODEL_AXIS = "model"
MESH_AXES = (PIPE_AXIS, DATA_AXIS, EXPERT_AXIS, MODEL_AXIS)

_UNPORTED = {"pp_size": "pipeline parallelism (ROADMAP Queue A item 9)",
             "mp_size": "model parallelism (ROADMAP Queue A item 11)"}

_INITIALIZED = False
_EP_SIZE = 1
_EP_GROUP = None        # this rank's expert-parallel group (ep > 1)
_EDP_GROUP = None       # this rank's expert-data group (ep > 1)


def dist_active():
    """True when a ``torch.distributed`` process group is initialised:
    the engine's collectives run over it, whatever its size."""
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def initialize(ep_size=1, mp_size=1, pp_size=1):
    """Set up the groups (JAX ``groups.initialize``): the data group is
    the world; ``ep_size`` must divide it (an expert size above 1 needs a
    process group); a model or pipe size other than 1 raises.

    At ``ep_size`` > 1 every rank creates every expert-parallel and
    expert-data group (``torch.distributed.new_group`` is collective), so
    every rank must call this with the same ``ep_size``."""
    global _INITIALIZED, _EP_SIZE, _EP_GROUP, _EDP_GROUP
    for name, size in (("mp_size", mp_size), ("pp_size", pp_size)):
        if size != 1:
            raise NotImplementedError(
                f"groups.initialize({name}={size}): {_UNPORTED[name]} is "
                f"not ported yet; the data-parallel group is the world")
    ep_size = int(ep_size)
    world = get_data_parallel_world_size()
    if ep_size < 1 or world % ep_size:
        raise ValueError(f"data-parallel world {world} not divisible by "
                         f"expert-parallel size {ep_size}")
    ep_group = edp_group = None
    if ep_size > 1:
        dist = torch.distributed
        rank = dist.get_rank()
        for d in range(world // ep_size):
            ranks = list(range(d * ep_size, (d + 1) * ep_size))
            g = dist.new_group(ranks)
            if rank in ranks:
                ep_group = g
        for e in range(ep_size):
            ranks = list(range(e, world, ep_size))
            g = dist.new_group(ranks)
            if rank in ranks:
                edp_group = g
    _EP_SIZE, _EP_GROUP, _EDP_GROUP = ep_size, ep_group, edp_group
    _INITIALIZED = True


def initialize_expert_parallel(expert_parallel_size):
    """JAX ``groups.initialize_expert_parallel``."""
    return initialize(ep_size=expert_parallel_size)


def mesh_is_initialized():
    return _INITIALIZED


def destroy():
    global _INITIALIZED, _EP_SIZE, _EP_GROUP, _EDP_GROUP
    _INITIALIZED = False
    _EP_SIZE, _EP_GROUP, _EDP_GROUP = 1, None, None


def check_axis(axis):
    """Raise ``ValueError`` for a name that is not an axis of the mesh
    (JAX's ``shard_map`` refuses such an axis too)."""
    if axis not in MESH_AXES:
        raise ValueError(f"mesh axis {axis!r} is not one of {MESH_AXES}")


def axis_group(axis):
    """``(group, size)`` of the ranks that share this rank's place on
    every mesh axis but ``axis``: the group a ``ring:``/``ulysses:``
    attention mode exchanges sequence chunks over (JAX's ``shard_map``
    over that axis). ``data``: the expert-data group (the world at
    ``ep_size`` 1; ``torch.distributed``'s world group then, so the
    exchange runs over NCCL or gloo at world size 1 too); ``expert``: the
    expert-parallel group; ``model`` and ``pipe``, and any axis without a
    process group: ``(None, 1)``, a group of one rank, so nothing is
    exchanged. JAX also replicates the batch's rows over the axes it does
    not name; attention is row by row, so a rank needs only its own
    group's rows."""
    check_axis(axis)
    if not dist_active():
        return None, 1
    if axis == DATA_AXIS:
        if _EP_SIZE > 1:
            return _EDP_GROUP, get_expert_data_parallel_world_size()
        return torch.distributed.group.WORLD, get_data_parallel_world_size()
    if axis == EXPERT_AXIS and _EP_SIZE > 1:
        return _EP_GROUP, _EP_SIZE
    return None, 1


def get_data_parallel_group():
    """The data-parallel process group: ``None``, the default (world)
    group, as ``torch.distributed`` collectives take it."""
    return None


def get_data_parallel_world_size():
    return torch.distributed.get_world_size() if dist_active() else 1


def get_data_parallel_rank():
    return torch.distributed.get_rank() if dist_active() else 0


def get_world_size():
    return get_data_parallel_world_size()


def get_model_parallel_world_size():
    return 1


def get_expert_parallel_world_size():
    """The experts of a layer are spread over this many ranks."""
    return _EP_SIZE


def get_expert_parallel_rank():
    """This rank's index ``e`` in its expert-parallel group: it holds
    experts ``e · E/ep .. (e + 1) · E/ep - 1`` of each layer."""
    return get_data_parallel_rank() % _EP_SIZE


def get_expert_parallel_group():
    """The process group of the MoE all-to-all (None at ep 1: no
    exchange)."""
    return _EP_GROUP


def get_expert_data_parallel_world_size():
    """The ranks that hold the same experts (JAX
    ``get_expert_data_parallel_world_size``)."""
    return get_data_parallel_world_size() // _EP_SIZE


def get_expert_data_parallel_rank():
    return get_data_parallel_rank() // _EP_SIZE


def get_expert_data_parallel_group():
    """The process group expert gradients are summed over: the world
    (``None``) at ep 1."""
    return _EDP_GROUP


def expert_data_parallel_src():
    """The global rank of this rank's expert-data rank 0 (``e``), the
    source of a broadcast over the expert-data group."""
    return get_expert_parallel_rank()
