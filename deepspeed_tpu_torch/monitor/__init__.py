"""The training monitor (counterpart of ``deepspeed_tpu/monitor``):
``MonitorMaster`` over the TensorBoard/CSV and telemetry sink backends."""
