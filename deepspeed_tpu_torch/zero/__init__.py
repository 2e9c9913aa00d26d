"""The public ``deepspeed_tpu_torch.zero`` (counterpart of
``deepspeed_tpu/zero/__init__.py``; the reference's ``deepspeed.zero``:
``Init`` at ``runtime/zero/partition_parameters.py:548``,
``GatheredParameters`` :1522, and the config and estimator helpers).

The engine cuts the fp32 masters at stage 3 when it is built
(``runtime/engine.py``), so ``Init`` has nothing to patch at module
construction: it is a no-op context, as the JAX one is. ``GatheredParameters`` yields whole detached copies: a
stage-3 slice (a parameter carrying ``ds_shape``) is gathered from every
rank's (a collective: every rank of the group enters the context), any
other tensor is copied; nothing is written back, as in JAX.
"""

import contextlib
import enum

import torch

from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig  # noqa: F401
from deepspeed_tpu_torch.runtime.zero.partition import estimate_zero_mem  # noqa: F401
from deepspeed_tpu_torch.runtime.zero.tiling import (  # noqa: F401
    TiledLinear, TiledLinearReturnBias)
from deepspeed_tpu_torch.utils.logging import logger


class ZeroParamType(enum.Enum):
    """The reference's partition_parameters.py:182 (informational: the
    engine's partition records what each tensor is)."""
    NORMAL = 1
    PARTITIONED = 2
    REMOTE = 3


class ZeroParamStatus(enum.Enum):
    """The reference's partition_parameters.py:195."""
    AVAILABLE = 1
    NOT_AVAILABLE = 2
    INFLIGHT = 3


def register_external_parameter(module, parameter):
    """The reference's partition_parameters.py:108, which tells its
    ZeRO-3 hooks to gather ``parameter`` around another module's forward.
    The engine gathers every cut master before the forward, whichever
    module reads it, so there is nothing to register: a no-op, so that
    the reference's training code runs unchanged."""
    del module, parameter


def unregister_external_parameter(module, parameter):
    """The reverse of :func:`register_external_parameter`, equally a
    no-op."""
    del module, parameter


class Init:
    """The reference's ``zero.Init`` context: the engine cuts the masters
    when it is built, so entering it does nothing. A cpu/nvme
    ``remote_device`` is parameter offload, the layered engine, which is
    not ported (``zero_optimization.offload_param`` raises)."""

    def __init__(self, module=None, data_parallel_group=None,
                 mem_efficient_linear=True, remote_device=None,
                 pin_memory=False, config=None, enabled=True,
                 dtype=None, mpu=None):
        self.remote_device = remote_device
        self.enabled = enabled
        if enabled and remote_device in ("cpu", "nvme"):
            logger.info(
                f"zero.Init(remote_device={remote_device!r}): parameter "
                f"offload is zero_optimization.offload_param, the layered "
                f"engine, which is not ported yet")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _gathered(t):
    """A whole detached copy of ``t``: gathered when it is a stage-3
    slice."""
    part = getattr(t, "ds_partition", None)
    if part is None:
        return t.detach().clone()
    name = t.ds_name
    return part.all_gather({name: t.detach()})[name].clone()


@contextlib.contextmanager
def GatheredParameters(params, modifier_rank=None, fwd_module=None,
                       enabled=True):
    """Yield whole detached copies of ``params`` (a tensor, a list or
    tuple of them, or a dict of them). Mutations are NOT written back
    (the reference writes back from ``modifier_rank`` on exit; updates
    go through the engine here, as in JAX)."""
    if not enabled:
        yield params
        return
    if modifier_rank is not None:
        logger.warning(
            "GatheredParameters(modifier_rank=...): the yielded tensors "
            "are detached copies; mutations are NOT written back (update "
            "weights through the engine instead)")
    if isinstance(params, torch.Tensor):
        yield _gathered(params)
    elif isinstance(params, dict):
        yield {k: _gathered(v) for k, v in params.items()}
    else:
        yield type(params)(_gathered(t) for t in params)
