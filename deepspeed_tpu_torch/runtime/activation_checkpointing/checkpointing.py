"""Activation checkpointing (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``).

:func:`checkpoint` runs ``function(*args)`` under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: only the
segment's inputs are kept for the backward, which recomputes the rest.
:func:`remat` is the same for a module (the models' ``remat`` and the
fused layer's memory knobs use it, as the JAX models use ``nn.remat``).
Two things a recompute must see as the forward saw them are carried
across explicitly:

* the dropout key (``runtime/dropout.py``): the forward's key is saved
  and re-entered in the recompute, so every mask is drawn again equal;
* a module's parameter tensors: the engine runs the model through
  ``torch.func.functional_call`` with compute-dtype casts of the fp32
  masters, which is undone before the backward. :func:`remat` saves the
  tensors the module holds at the forward and binds them again for the
  recompute, so the cast stays outside the checkpointed segment and its
  gradient reaches the masters.

:func:`checkpoint` saves and restores the global RNG states around the
recompute, as ``torch.utils.checkpoint`` does by default; the models'
:func:`remat` does not (their masks come from keyed generators).

The knobs of :func:`configure` (read from the config's
``activation_checkpointing`` block, ``activation_checkpointing_config``):

* ``cpu_checkpointing`` / ``checkpoint_in_cpu``: the segment's saved
  inputs live on the host (``torch.autograd.graph.save_on_cpu``, pinned
  on a CUDA machine) until the backward;
* ``partition_activations``: the identity, as in the JAX package at
  model-parallel size 1 (the port has no model parallelism);
* ``contiguous_memory_optimization``, ``number_checkpoints``,
  ``synchronize_checkpoint_boundary``, ``profile``: stored, unused, as
  there.

The dropout masks are keyed by (seed, micro-step, site) rather than by a
tracked CUDA RNG state, so the reference's ``CudaRNGStatesTracker`` has
no counterpart: :func:`get_cuda_rng_tracker` raises, as the JAX one does.
"""

import contextlib
import functools
import weakref

import torch
from torch import nn

from deepspeed_tpu_torch.runtime import dropout as dropout_lib

_DEFAULTS = {
    "partition_activations": False,
    "contiguous_memory_optimization": False,
    "cpu_checkpointing": False,
    "checkpoint_in_cpu": False,
    "synchronize_checkpoint_boundary": False,
    "profile": False,
    "num_checkpoints": None,
}
_CONFIG = dict(_DEFAULTS)

_mpu = None
_configured = False


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None):
    """Store the knobs (JAX checkpointing.py:43): those of
    ``deepspeed_config.activation_checkpointing_config``, then the
    keywords that are not None."""
    global _mpu, _configured
    _mpu = mpu_
    _configured = True
    if deepspeed_config is not None:
        acfg = getattr(deepspeed_config, "activation_checkpointing_config",
                       None)
        if acfg is not None:
            _CONFIG.update({
                "partition_activations": acfg.partition_activations,
                "contiguous_memory_optimization":
                    acfg.contiguous_memory_optimization,
                "cpu_checkpointing": acfg.cpu_checkpointing,
                "num_checkpoints": acfg.number_checkpoints,
                "synchronize_checkpoint_boundary":
                    acfg.synchronize_checkpoint_boundary,
                "profile": acfg.profile,
            })
    for key, val in [("partition_activations", partition_activations),
                     ("contiguous_memory_optimization",
                      contiguous_checkpointing),
                     ("num_checkpoints", num_checkpoints),
                     ("checkpoint_in_cpu", checkpoint_in_cpu),
                     ("synchronize_checkpoint_boundary", synchronize),
                     ("profile", profile)]:
        if val is not None:
            _CONFIG[key] = val


def is_configured():
    """True once :func:`configure` has run."""
    return _configured


def _checkpointed(function, args, preserve_rng_state=True):
    """``function(*args)`` with recompute in the backward, the dropout key
    of this forward replayed in the recompute."""
    key = dropout_lib.current_key()

    def replay(*a):
        with dropout_lib.key_scope(key):
            return function(*a)

    return torch.utils.checkpoint.checkpoint(
        replay, *args, use_reentrant=False,
        preserve_rng_state=preserve_rng_state)


_SLOTS = weakref.WeakKeyDictionary()   # module -> its tensor slots


def _slots(module):
    """(dict, name) of every parameter and buffer slot under ``module``:
    the ``_parameters`` / ``_buffers`` entries ``functional_call`` swaps."""
    slots = _SLOTS.get(module)
    if slots is None:
        slots = _SLOTS[module] = tuple(
            (table, name) for mod in module.modules()
            for table in (mod._parameters, mod._buffers)
            for name, t in table.items() if t is not None)
    return slots


def _bind(bound):
    """Put each (dict, name, tensor) in place; returns what was there."""
    saved = []
    for table, name, t in bound:
        saved.append((table, name, table[name]))
        table[name] = t
    return saved


def remat(module: nn.Module, *args, method: str = "forward",
          preserve_rng_state: bool = False):
    """``module.<method>(*args)`` with recompute in the backward; the
    recompute sees the parameter and buffer tensors the module holds now
    (see the module docstring). They are put back into the module's own
    slots for the recompute, as ``functional_call`` puts them, at the cost
    of a few dict writes (``functional_call`` itself costs ~0.4 ms of host
    time a block). The port's models draw no number from the global RNG
    inside a block, so its state is not saved unless asked for."""
    now = tuple((table, name, table[name])
                for table, name in _slots(module))
    call = getattr(module, method)

    def run(*a):
        saved = _bind(now)
        try:
            return call(*a)
        finally:
            _bind(saved)

    return _checkpointed(run, args, preserve_rng_state)


def checkpoint(function, *args):
    """``function(*args)`` with recompute in the backward (JAX
    checkpointing.py:128); an ``nn.Module`` goes through :func:`remat`.
    With ``cpu_checkpointing`` the saved inputs wait on the host."""
    offload = _CONFIG["cpu_checkpointing"] or _CONFIG["checkpoint_in_cpu"]
    with (torch.autograd.graph.save_on_cpu(pin_memory=True) if offload
          else contextlib.nullcontext()):
        if isinstance(function, nn.Module):
            return remat(function, *args, preserve_rng_state=True)
        return _checkpointed(function, args)


def checkpoint_wrapper(function):
    """Decorator form of :func:`checkpoint`."""

    @functools.wraps(function)
    def wrapped(*args):
        return checkpoint(function, *args)
    return wrapped


def get_cuda_rng_tracker():
    """The reference's model-parallel RNG tracker has no counterpart: the
    dropout masks are keyed by (seed, micro-step, site)
    (``runtime/dropout.py``)."""
    raise NotImplementedError(
        "dropout masks are keyed by (seed, micro-step, site); pass "
        "seed= to initialize instead of tracking CUDA RNG states")


def model_parallel_cuda_manual_seed(seed):
    """A no-op, as in the JAX package (no model-parallel RNG streams)."""
    return None


def reset():
    """Restore the unconfigured default state."""
    global _mpu, _configured
    _CONFIG.clear()
    _CONFIG.update(_DEFAULTS)
    _mpu = None
    _configured = False
