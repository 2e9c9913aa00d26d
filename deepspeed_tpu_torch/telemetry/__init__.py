"""Host-only telemetry of the port: metrics, spans, signature watch
(counterpart of ``deepspeed_tpu/telemetry``)."""
