"""Host-only telemetry of the port (counterpart of
``deepspeed_tpu/telemetry``): metrics, spans and lanes, signature watch,
the shared clock, the run chronicle, the escalation protocol, the
serving observatory and the mission-control plane.

* ``tracer`` — ``trace_span`` contexts and synthetic lanes -> Chrome
  trace JSON;
* ``metrics`` — counters / gauges / histograms, and the card's (or the
  host's) memory stats;
* ``sinks`` — the JSONL event writer and the Prometheus text exporter
  (``MonitorMaster`` backends, and ``/metrics``);
* ``manager`` — ``TelemetryManager``, the per-run owner of the tracer,
  the registry and the compile watch (the ``telemetry`` config block);
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
  --render``);
* ``slo`` — the multi-window error-budget burn monitor over declarative
  objectives -> SLO_REPORT.json (``python -m
  deepspeed_tpu_torch.telemetry.slo --render``);
* ``obs_server`` — the HTTP scrape/status endpoint: ``/metrics``,
  ``/healthz``, ``/readyz``, ``/api/report/<name>``, ``/api/events``.
"""

import importlib

from deepspeed_tpu_torch.telemetry.manager import (  # noqa: F401
    TelemetryManager, get_manager, reset_manager, set_manager)
from deepspeed_tpu_torch.telemetry.metrics import (  # noqa: F401
    MetricsRegistry, device_memory_stats, get_registry, set_registry)
from deepspeed_tpu_torch.telemetry.sinks import (  # noqa: F401
    JSONLMonitor, JSONLSink, PrometheusMonitor, PrometheusSink,
    render_prometheus)
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
    "SloMonitor": "slo", "normalize_objective": "slo",
    "ObsServer": "obs_server", "get_obs_server": "obs_server",
    "set_obs_server": "obs_server", "reset_obs_server": "obs_server",
}


def __getattr__(name):
    if name in ("slo", "obs_server"):
        return importlib.import_module(f"deepspeed_tpu_torch.telemetry.{name}")
    if name in _LAZY:
        module = importlib.import_module(
            f"deepspeed_tpu_torch.telemetry.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
