"""Span tracer — nested ``with trace_span("serving_step")`` contexts
(counterpart of ``deepspeed_tpu/telemetry/tracer.py``).

Collects Chrome-trace "X" events (microseconds) and, with
``torch_annotations``, also opens a ``torch.profiler.record_function``
of the same name, so the host spans line up with the device kernels in
a ``torch.profiler`` trace (the JAX form annotates ``jax.profiler``).

The disabled tracer is the hot path: ``trace_span`` returns one shared
no-op context manager, with no allocation and no clock read.

Synthetic lanes (the serving observatory's per-slot lanes) go in through
``emit`` with a tid from :func:`allocate_lane_tid`, and name themselves
with "M" thread-name events; ``set_process_label`` tags the export with
process metadata.
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
        self._process_label = None
        self._process_sort = None

    def set_process_label(self, name, sort_index=None):
        """Tag this process's trace: ``export`` prepends
        ``process_name`` / ``process_sort_index`` metadata, so per-rank
        trace files carry their identity when concatenated."""
        self._process_label = str(name)
        self._process_sort = sort_index

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

    def emit(self, event):
        """Append a pre-built Chrome-trace event dict verbatim (lane
        events carry their own pid/tid and cannot go through ``span`` /
        ``instant``, which stamp the current thread)."""
        if not self.enabled:
            return
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(event)

    def instant(self, name, **args):
        """Zero-duration marker event (ph="i")."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": time.perf_counter_ns() // 1000,
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

    def event_count(self):
        return len(self._events)   # len() is atomic; no copy needed

    def clear(self):
        with self._lock:
            self._events.clear()
        self.dropped = 0

    def export(self, path):
        """Write the Chrome-trace JSON object format; returns the path."""
        events = self.events()
        if self._process_label is not None:
            meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                     "args": {"name": self._process_label}}]
            if self._process_sort is not None:
                meta.append({"name": "process_sort_index", "ph": "M",
                             "pid": self._pid,
                             "args": {"sort_index":
                                      int(self._process_sort)}})
            events = meta + events
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
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


# ---------------------------------------------------------------- lane tids
#
# Synthetic trace lanes need tids that cannot collide with real thread
# idents or with each other: one process-scoped registry hands out a
# stable tid per lane key (the same key always maps to the same tid,
# distinct keys never share one).

_LANE_TID_BASE = 1_000_000
_LANE_LOCK = threading.Lock()
_LANE_TIDS = {}
_LANE_NEXT = [_LANE_TID_BASE]


def allocate_lane_tid(key):
    """Return the process-unique synthetic tid for lane *key* (any
    hashable; repeated calls with the same key return the same tid)."""
    with _LANE_LOCK:
        tid = _LANE_TIDS.get(key)
        if tid is None:
            tid = _LANE_NEXT[0]
            _LANE_NEXT[0] += 1
            _LANE_TIDS[key] = tid
        return tid


def _reset_lane_tids():
    """Test hook: forget all lane-tid assignments."""
    with _LANE_LOCK:
        _LANE_TIDS.clear()
        _LANE_NEXT[0] = _LANE_TID_BASE


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
