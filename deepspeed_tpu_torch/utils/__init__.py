"""Host utilities of the port (counterpart of ``deepspeed_tpu/utils``)."""
