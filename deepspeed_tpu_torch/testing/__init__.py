"""Deterministic fault-injection harness (counterpart of
``deepspeed_tpu/testing``). Test support only: nothing in the runtime
imports this package."""

from deepspeed_tpu_torch.testing.chaos import (  # noqa: F401
    ChaosFault, FaultSchedule, Injector, PoolStarvationChaos)
