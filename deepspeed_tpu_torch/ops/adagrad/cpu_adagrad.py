"""The reference's module path ``ops/adagrad/cpu_adagrad.py``."""

from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdagrad  # noqa: F401
