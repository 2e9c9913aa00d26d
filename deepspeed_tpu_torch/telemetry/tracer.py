"""Span tracer — nested ``with trace_span("serving_step")`` contexts
(counterpart of ``deepspeed_tpu/telemetry/tracer.py``).

Collects Chrome-trace "X" events (microseconds) and, with
``torch_annotations``, also opens a ``torch.profiler.record_function``
of the same name, so the host spans line up with the device kernels in
a ``torch.profiler`` trace (the JAX form annotates ``jax.profiler``).

The disabled tracer is the hot path: ``trace_span`` returns one shared
no-op context manager, with no allocation and no clock read.
"""

import json
import os
import threading
import time


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "_ann")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._ann = None

    def __enter__(self):
        if self._tracer._annotate:
            from torch.profiler import record_function
            self._ann = record_function(self.name)
            self._ann.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer._record(self.name, self._t0, t1, self.args)
        return False


class Tracer:
    """Collects spans into a bounded in-memory buffer; ``export`` writes
    the Chrome-trace JSON."""

    def __init__(self, enabled=False, torch_annotations=False,
                 max_events=100_000):
        self.enabled = enabled
        self._annotate = torch_annotations
        self.max_events = max_events
        self.dropped = 0
        self._events = []
        self._lock = threading.Lock()
        self._pid = os.getpid()

    def span(self, name, **args):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args or None)

    def _record(self, name, t0_ns, t1_ns, args):
        ev = {"name": name, "ph": "X", "ts": t0_ns // 1000,
              "dur": max(0, (t1_ns - t0_ns) // 1000),
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    def events(self):
        with self._lock:
            return list(self._events)

    def clear(self):
        with self._lock:
            self._events.clear()
        self.dropped = 0

    def export(self, path):
        """Write the Chrome-trace JSON object format; returns the path."""
        doc = {"traceEvents": self.events(), "displayTimeUnit": "ms"}
        if self.dropped:
            doc["metadata"] = {"dropped_events": self.dropped}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


# disabled until a caller installs an enabled tracer (set_tracer)
_GLOBAL = Tracer(enabled=False)


def get_tracer():
    return _GLOBAL


def set_tracer(tracer):
    """Install *tracer* as the process-global default; returns the old."""
    global _GLOBAL
    old, _GLOBAL = _GLOBAL, tracer
    return old


def trace_span(name, **args):
    return _GLOBAL.span(name, **args)
