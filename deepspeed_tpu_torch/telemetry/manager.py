"""TelemetryManager — one object owning the per-run telemetry state
(counterpart of ``deepspeed_tpu/telemetry/manager.py``).

Built by the engine from the parsed ``telemetry`` config block. Rank-0
only (like ``MonitorMaster``): other ranks get the disabled manager,
whose every surface is a no-op, so engine call sites need no rank
checks. When enabled it:

* installs its ``Tracer`` / ``MetricsRegistry`` as the process globals,
  so library code (``checkpoint_io``, the timers, the server) reaches
  them through ``trace_span`` / ``metrics.get_registry``; ``close()``
  puts back the globals it replaced (when they are still its own);
* arms the compile watch (``wrap_compiled``: the signature watch of the
  engine's entry points; the port compiles nothing, so there is no
  backend-compile listener);
* exports the Chrome trace on ``flush()`` (the engine calls it at
  ``steps_per_print`` cadence, at most once every 5 s) and once more at
  close or at interpreter exit.

``jax_annotations`` opens a ``torch.profiler.record_function`` range for
every span (the tracer's ``torch_annotations``). The training monitors
of the JAX manager (``health``, ``goodput``, ``memory``) are not ported:
the config refuses their sub-blocks, and the attributes stay ``None``.

Files under ``<output_path>/``: ``<job>.trace.json`` (Chrome trace),
``<job>.jsonl`` + ``<job>.prom`` (the MonitorMaster sinks, which share
this manager's registry).
"""

import atexit
import os
import time

from deepspeed_tpu_torch.telemetry import compile_watch as _cw
from deepspeed_tpu_torch.telemetry import metrics as _metrics
from deepspeed_tpu_torch.telemetry import tracer as _tracer_mod
from deepspeed_tpu_torch.telemetry.metrics import device_memory_stats


class TelemetryManager:
    # re-serialising the whole trace buffer is O(events): periodic flushes
    # are throttled (skipped when nothing is new, at most one export per
    # interval); close() and atexit force the final complete export
    EXPORT_MIN_INTERVAL_S = 5.0

    def __init__(self, config=None, rank=0, device=None):
        self.config = config
        self.enabled = bool(config is not None
                            and getattr(config, "enabled", False)
                            and rank == 0)
        self.health = self.goodput = self.memory = None
        if not self.enabled:
            self.tracer = _tracer_mod.Tracer(enabled=False)
            self.registry = None
            self.compile_watch = None
            self.trace_path = None
            return
        out = config.output_path or "telemetry/"
        job = config.job_name or "DeepSpeedJobName"
        os.makedirs(out, exist_ok=True)
        self.output_path = out
        self.job_name = job
        self.trace_path = os.path.join(out, f"{job}.trace.json")
        self.device = device
        self.registry = _metrics.MetricsRegistry()
        self._old_registry = _metrics.set_registry(self.registry)
        self.tracer = _tracer_mod.Tracer(
            enabled=bool(config.trace),
            torch_annotations=bool(config.jax_annotations),
            max_events=int(config.max_trace_events))
        self._old_tracer = _tracer_mod.set_tracer(self.tracer)
        self.compile_watch = (_cw.CompileWatch(self.registry)
                              if config.compile_watch else None)
        self._closed = False
        self._last_export_t = float("-inf")
        self._last_export_n = -1
        # process-global handle: code without an engine reference (the
        # serving observatory's trace-flush escalation) reaches it here
        set_manager(self)
        atexit.register(self.close)

    # ---------------------------------------------------------------- spans
    def span(self, name, **args):
        return self.tracer.span(name, **args)

    def instant(self, name, **args):
        self.tracer.instant(name, **args)

    # -------------------------------------------------------------- compile
    def wrap_compiled(self, fn, name):
        """Signature watch of an entry point; identity when disabled (or
        ``fn`` is None)."""
        if fn is None or self.compile_watch is None:
            return fn
        return self.compile_watch.wrap(fn, name)

    # -------------------------------------------------------------- metrics
    def publish_device_memory(self):
        """Gauge the card's allocator (or the host's resident set)
        memory stats, labelled ``source`` "cuda" or "host"."""
        if not self.enabled or not getattr(self.config, "memory_metrics",
                                           True):
            return
        stats = device_memory_stats(self.device)
        src = stats.pop("source", "none")
        for k, v in stats.items():
            self.registry.gauge(f"device_memory_{k}", f"memory stat '{k}'",
                                labels={"source": src}).set(v)

    # ---------------------------------------------------------------- sinks
    def flush(self, force=False):
        if not (self.enabled and self.config.trace):
            return
        n = self.tracer.event_count()
        if not force:
            if n == self._last_export_n:
                return
            if time.monotonic() - self._last_export_t < \
                    self.EXPORT_MIN_INTERVAL_S:
                return
        self._last_export_n = n
        self._last_export_t = time.monotonic()
        self.tracer.export(self.trace_path)

    def _force_trace_export(self):
        """Anomaly-escalation hook: flush the trace now (the 5 s floor
        between exports still applies)."""
        self.flush()

    def close(self):
        if not self.enabled or self._closed:
            return
        self._closed = True
        self.flush(force=True)
        if _tracer_mod.get_tracer() is self.tracer:
            _tracer_mod.set_tracer(self._old_tracer)
        if _metrics.get_registry() is self.registry:
            _metrics.set_registry(self._old_registry)
        reset_manager(if_current=self)
        atexit.unregister(self.close)


# Process-global manager handle: None until an enabled TelemetryManager
# installs itself; close() restores None (only if it is still the
# installed one, so a newer engine's manager is not clobbered).
_GLOBAL = None


def get_manager():
    return _GLOBAL


def set_manager(manager):
    """Install *manager* as the process-global handle; returns the old."""
    global _GLOBAL
    old, _GLOBAL = _GLOBAL, manager
    return old


def reset_manager(if_current=None):
    global _GLOBAL
    if if_current is None or _GLOBAL is if_current:
        _GLOBAL = None
