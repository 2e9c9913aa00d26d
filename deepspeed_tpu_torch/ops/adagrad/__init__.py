"""``ops.adagrad``: the host CPU-Adagrad shares CPU-Adam's library
(``csrc/cpu_adam.cpp``), so the class lives beside it."""

from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdagrad  # noqa: F401
