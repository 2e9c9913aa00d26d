"""Host-only telemetry of the port (counterpart of
``deepspeed_tpu/telemetry``): metrics, spans and lanes, signature watch,
the shared clock, the run chronicle, the escalation protocol and the
serving observatory.

* ``tracer`` — ``trace_span`` contexts and synthetic lanes -> Chrome
  trace JSON;
* ``metrics`` — counters / gauges / histograms;
* ``compile_watch`` — signature and CUDA-graph capture counting;
* ``clock`` — the monotonic integer-µs axis every stream joins on;
* ``chronicle`` — the run chronicle: one ordered event timeline, per-rank
  atomic JSONL streams (``python -m deepspeed_tpu_torch.telemetry.
  chronicle --render``);
* ``escalation`` — the warn-once / count / snapshot / chronicle protocol
  a monitor's rule firing runs;
* ``health`` — ``json_safe`` (strict JSON for forensics files);
* ``serving_observatory`` — per-request timelines, the slot-step ledger
  and the windowed SLO rules -> SERVING_HEALTH.json
  (``python -m deepspeed_tpu_torch.telemetry.serving_observatory
  --render``).
"""

import importlib

from deepspeed_tpu_torch.telemetry.metrics import (  # noqa: F401
    MetricsRegistry, get_registry, set_registry)
from deepspeed_tpu_torch.telemetry.tracer import (  # noqa: F401
    Tracer, get_tracer, set_tracer, trace_span)

# loaded on first use (PEP 562), so ``python -m`` runs their CLIs without
# the package having imported them first
_LAZY = {
    "RunChronicle": "chronicle", "get_chronicle": "chronicle",
    "set_chronicle": "chronicle", "reset_chronicle": "chronicle",
    "RequestTimeline": "serving_observatory",
    "ServingObservatory": "serving_observatory",
    "SlotStepLedger": "serving_observatory",
}


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(
            f"deepspeed_tpu_torch.telemetry.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
