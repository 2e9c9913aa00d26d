"""The process-group layer (counterpart of ``deepspeed_tpu/utils/groups.py``).

The JAX package builds one named mesh ``("pipe", "data", "expert",
"model")`` whose axes are the groups. The port runs one process a rank
over ``torch.distributed``: the data-parallel group is the whole world
(``torch.distributed``'s default group), and ``pipe``, ``expert`` and
``model`` have size 1. Any other size raises ``NotImplementedError``
naming the ROADMAP Queue A item that ports it.

With no process group initialised the world is one rank: every getter
answers 1 (sizes) or 0 (ranks), and the engine runs no collective.
With one (``deepspeed_tpu_torch.init_distributed``), the engine runs its
collectives over it, at world size 1 too.
"""

import torch

# the JAX package's axis names, kept here (the port imports nothing of it)
PIPE_AXIS = "pipe"
DATA_AXIS = "data"
EXPERT_AXIS = "expert"
MODEL_AXIS = "model"
MESH_AXES = (PIPE_AXIS, DATA_AXIS, EXPERT_AXIS, MODEL_AXIS)

_UNPORTED = {"pp_size": "pipeline parallelism (ROADMAP Queue A item 9)",
             "ep_size": "expert parallelism (ROADMAP Queue A item 8, MoE)",
             "mp_size": "model parallelism (ROADMAP Queue A item 11)"}

_INITIALIZED = False


def dist_active():
    """True when a ``torch.distributed`` process group is initialised:
    the engine's collectives run over it, whatever its size."""
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def initialize(ep_size=1, mp_size=1, pp_size=1):
    """Set up the groups (JAX ``groups.initialize``): the data group is
    the world; an expert, model or pipe size other than 1 raises."""
    global _INITIALIZED
    for name, size in (("ep_size", ep_size), ("mp_size", mp_size),
                       ("pp_size", pp_size)):
        if size != 1:
            raise NotImplementedError(
                f"groups.initialize({name}={size}): {_UNPORTED[name]} is "
                f"not ported yet; the data-parallel group is the world")
    _INITIALIZED = True


def mesh_is_initialized():
    return _INITIALIZED


def destroy():
    global _INITIALIZED
    _INITIALIZED = False


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
