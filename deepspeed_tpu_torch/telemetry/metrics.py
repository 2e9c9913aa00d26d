"""Metrics registry — counters, gauges, histograms (counterpart of
``deepspeed_tpu/telemetry/metrics.py``).

Prometheus-shaped (a counter only goes up; a histogram is cumulative
buckets + sum + count) and host-only: Python floats updated at step
cadence, one lock per metric.
"""

import threading

# milliseconds: 0.1 ms .. 100 s
DEFAULT_BUCKETS = (0.1, 0.5, 1, 5, 10, 50, 100, 500, 1000, 5000, 10000,
                   50000, 100000)


def _label_key(labels):
    return tuple(sorted((labels or {}).items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name, help="", labels=None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self.value = 0.0

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self.value += amount


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self.value = 0.0

    def set(self, value):
        with self._lock:
            self.value = float(value)

    def inc(self, amount=1.0):
        with self._lock:
            self.value += amount

    def dec(self, amount=1.0):
        self.inc(-amount)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", labels=None, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value):
        value = float(value)
        with self._lock:
            self.sum += value
            self.count += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.counts[i] += 1
                    break
            else:
                self.counts[-1] += 1

    def cumulative_counts(self):
        """Prometheus buckets are cumulative: count of observations <= le."""
        out, acc = [], 0
        with self._lock:
            for c in self.counts:
                acc += c
                out.append(acc)
        return out

    def quantile(self, q):
        """Prometheus-style estimate: linear interpolation inside the
        bucket the rank falls into (the +Inf bucket clamps to the last
        finite edge). ``None`` while the histogram is empty."""
        cum = self.cumulative_counts()
        total = self.count
        if total == 0:
            return None
        rank = q * total
        edges = [0.0] + [float(b) for b in self.buckets]
        for i, c in enumerate(cum):
            if c >= rank:
                if i >= len(self.buckets):          # +Inf bucket
                    return edges[-1]
                lo = edges[i]
                hi = float(self.buckets[i])
                prev = cum[i - 1] if i else 0
                frac = (rank - prev) / max(1, c - prev)
                return lo + (hi - lo) * frac
        return edges[-1]


class MetricsRegistry:
    """Name+labels -> metric, get-or-create (``reg.counter("x").inc()``);
    a kind clash on an existing name raises."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help, labels, **kw):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help, labels, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name, help="", labels=None):
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", labels=None):
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=None, buckets=DEFAULT_BUCKETS):
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def collect(self):
        """All metrics, grouped by family name."""
        with self._lock:
            metrics = list(self._metrics.values())
        families = {}
        for m in metrics:
            families.setdefault(m.name, []).append(m)
        return families

    def snapshot(self):
        """Plain-dict dump (JSON-friendly)."""
        out = {}
        for name, ms in self.collect().items():
            rows = []
            for m in ms:
                row = {"labels": m.labels, "kind": m.kind}
                if isinstance(m, Histogram):
                    row.update(sum=m.sum, count=m.count,
                               buckets=dict(zip(
                                   [str(b) for b in m.buckets] + ["+Inf"],
                                   m.cumulative_counts())))
                else:
                    row["value"] = m.value
                rows.append(row)
            out[name] = rows
        return out

    def clear(self):
        with self._lock:
            self._metrics.clear()


# Process-global registry: library code records into whichever registry
# is installed
_GLOBAL = MetricsRegistry()


def get_registry():
    return _GLOBAL


def set_registry(registry):
    global _GLOBAL
    old, _GLOBAL = _GLOBAL, registry
    return old


def device_memory_stats(device=None):
    """Memory stats of ``device`` (JAX ``device_memory_stats``' split):
    on a card the caching allocator's counters and the driver's free and
    total bytes, ``source`` "cuda"; otherwise the process's resident set,
    ``source`` "host". Host reads only (no stream is synchronized);
    never raises, an empty dict at worst."""
    import torch
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type == "cuda":
        try:
            s = torch.cuda.memory_stats(dev)
            free, total = torch.cuda.mem_get_info(dev)
            return {"bytes_in_use": s.get("allocated_bytes.all.current", 0),
                    "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
                    "bytes_reserved": s.get("reserved_bytes.all.current", 0),
                    "bytes_free": free, "bytes_limit": total,
                    "source": "cuda"}
        except Exception:
            return {}
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        import os
        return {"host_rss_bytes": pages * os.sysconf("SC_PAGE_SIZE"),
                "source": "host"}
    except Exception:
        pass
    try:
        import resource
        # ru_maxrss is KiB on Linux
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        return {"host_peak_rss_bytes": peak, "source": "host"}
    except Exception:
        return {}
