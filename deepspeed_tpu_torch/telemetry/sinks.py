"""Telemetry sinks — the JSONL event writer and the Prometheus text
exporter (counterpart of ``deepspeed_tpu/telemetry/sinks.py``).

``JSONLMonitor`` / ``PrometheusMonitor`` speak the monitor-backend
protocol (``write_scalar(name, value, step)`` + ``flush()`` + ``close()``)
so ``MonitorMaster`` fans the engine's ``write_events`` out to them.

Prometheus side: scalars keep their slash-y reference names
("Train/Samples/train_loss") by living as ONE family
``deepspeed_scalar{name="..."}``; registry metrics render under their
own sanitised names. The ``.prom`` file is the textfile-collector
pattern (node_exporter picks it up); :mod:`telemetry.obs_server` serves
the same :func:`render_prometheus` text at ``GET /metrics``, byte for
byte the JAX package's for the same registry contents.
"""

import json
import os
import re
import time
import zlib

from deepspeed_tpu_torch.telemetry.metrics import Histogram, MetricsRegistry
from deepspeed_tpu_torch.utils.logging import logger

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")

# sanitized names whose collision has already been warned about — the
# render runs at scrape/flush cadence, the warning is once per process
_COLLISION_WARNED = set()


def sanitize_metric_name(name):
    """Coerce to the Prometheus metric-name charset
    ``[a-zA-Z_:][a-zA-Z0-9_:]*``. Lossy: distinct registry families can
    sanitize to the same name (``a/b`` and ``a.b`` both become
    ``a_b``) — :func:`render_prometheus` detects that at render time
    and de-collides deterministically rather than silently merging two
    families' samples into one."""
    name = _NAME_OK.sub("_", str(name))
    if not name or not (name[0].isalpha() or name[0] in "_:"):
        name = "_" + name
    return name


def _sanitized_family_names(families):
    """``{raw family -> rendered name}`` with collision repair: when two
    registry families sanitize to the same Prometheus name, the first in
    sorted order keeps the base name and every other collider gets a
    deterministic ``_<crc32-of-raw-name>`` suffix (stable across renders
    and processes — dashboards keep working). Warned once per base."""
    by_base = {}
    for fam in sorted(families):
        by_base.setdefault(sanitize_metric_name(fam), []).append(fam)
    out = {}
    for base, fams in by_base.items():
        out[fams[0]] = base
        for fam in fams[1:]:
            out[fam] = f"{base}_{zlib.crc32(fam.encode()):08x}"
        if len(fams) > 1 and base not in _COLLISION_WARNED:
            _COLLISION_WARNED.add(base)
            logger.warning(
                "[sinks] %d metric families sanitize to %r (%s); "
                "keeping %r as %r and suffixing the rest — rename the "
                "families to distinct sanitized names",
                len(fams), base, ", ".join(map(repr, fams)), fams[0],
                base)
    return out


def escape_label_value(value):
    r"""Label-value escaping per the exposition format: ``\`` -> ``\\``,
    ``"`` -> ``\"``, newline -> ``\n``."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def escape_help(text):
    r"""HELP-line escaping: ``\`` -> ``\\``, newline -> ``\n``."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v):
    if v != v:                      # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _labels_str(labels, extra=None):
    items = dict(labels or {})
    if extra:
        items.update(extra)
    if not items:
        return ""
    inner = ",".join(
        f'{sanitize_metric_name(k)}="{escape_label_value(v)}"'
        for k, v in sorted(items.items()))
    return "{" + inner + "}"


SUMMARY_QUANTILES = (0.5, 0.9, 0.99)


def render_prometheus(registry, extra_labels=None):
    """Render *registry* in the Prometheus text exposition format v0.0.4.

    Histograms additionally render a sibling ``<name>_summary`` family of
    TYPE summary carrying p50/p90/p99 estimates
    (:meth:`~deepspeed_tpu_torch.telemetry.metrics.Histogram.quantile`:
    linear interpolation inside the bucket), so TTFT / step-time percentiles
    reach scrape sinks directly instead of living only in the JSON
    artifacts. Empty histograms render no summary (a quantile of nothing
    is a lie, not a zero).

    Family names that sanitize to the same Prometheus name are
    de-collided (:func:`_sanitized_family_names`) — the exposition
    format forbids a duplicate TYPE line, and merging two families'
    samples under one name corrupts both series.

    ``extra_labels`` stamps constant labels (e.g. ``{"rank": 3}``) onto
    EVERY sample line at render time — the fleet-federation identity
    injection: a peer renders its own exposition already labelled, so
    the aggregator's merge never re-parses sample text. A metric's own
    label wins a key collision (per-sample truth beats the const
    stamp)."""
    lines = []
    collected = registry.collect()
    names = _sanitized_family_names(collected)
    if extra_labels:
        # metric-level labels override the const stamp on key collision:
        # _labels_str applies `extra` (the metric's labels) LAST
        def _ls(labels, extra=None):
            merged = dict(extra_labels)
            merged.update(labels or {})
            if extra:
                merged.update(extra)
            return _labels_str(merged)
    else:
        _ls = _labels_str
    for family, ms in sorted(collected.items()):
        name = names[family]
        help_text = next((m.help for m in ms if m.help), "")
        if help_text:
            lines.append(f"# HELP {name} {escape_help(help_text)}")
        lines.append(f"# TYPE {name} {ms[0].kind}")
        summaries = []
        for m in ms:
            if isinstance(m, Histogram):
                cum = m.cumulative_counts()
                for le, c in zip([*m.buckets, float("inf")], cum):
                    lines.append(
                        f"{name}_bucket"
                        f"{_ls(m.labels, {'le': _fmt_value(float(le))})}"
                        f" {c}")
                lines.append(
                    f"{name}_sum{_ls(m.labels)} {_fmt_value(m.sum)}")
                lines.append(
                    f"{name}_count{_ls(m.labels)} {m.count}")
                if m.count:
                    summaries.append(m)
            else:
                lines.append(
                    f"{name}{_ls(m.labels)} {_fmt_value(m.value)}")
        if summaries:
            sname = f"{name}_summary"
            lines.append(f"# TYPE {sname} summary")
            for m in summaries:
                for q in SUMMARY_QUANTILES:
                    v = m.quantile(q)
                    lines.append(
                        f"{sname}"
                        f"{_ls(m.labels, {'quantile': _fmt_value(q)})}"
                        f" {_fmt_value(v)}")
                lines.append(
                    f"{sname}_sum{_ls(m.labels)} "
                    f"{_fmt_value(m.sum)}")
                lines.append(f"{sname}_count{_ls(m.labels)} "
                             f"{m.count}")
    return "\n".join(lines) + "\n"


class JSONLSink:
    """Append-only structured event log; one JSON object per line."""

    def __init__(self, path):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.path = path
        self._file = open(path, "a")

    def write(self, event_type, **fields):
        rec = {"ts": round(time.time(), 6), "event": event_type}
        rec.update(fields)
        self._file.write(json.dumps(rec, default=repr) + "\n")

    def flush(self):
        if not self._file.closed:
            self._file.flush()

    def close(self):
        if not self._file.closed:
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class PrometheusSink:
    """Atomically (re)writes a .prom text file from a registry.

    This is the *textfile-collector* half of the Prometheus story: a
    node_exporter (or any textfile-directory scraper) on the host picks
    the file up — no port, no server, works on locked-down hosts.
    The *direct-scrape* half is :class:`telemetry.obs_server.ObsServer`,
    whose ``GET /metrics`` renders the same registry live over HTTP;
    arm it with the ``telemetry.server`` config block when Prometheus
    can reach the trainer. Both render through
    :func:`render_prometheus`, so the two views never disagree."""

    def __init__(self, path, registry):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.path = path
        self.registry = registry

    def write(self):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(render_prometheus(self.registry))
        os.replace(tmp, self.path)  # scrapers never see a partial file
        return self.path

    def close(self):
        self.write()


# ------------------------------------------------------------ monitor glue

class JSONLMonitor:
    """MonitorMaster backend: scalars as JSONL events."""

    def __init__(self, output_path="runs/", job_name="DeepSpeedJobName"):
        self.sink = JSONLSink(os.path.join(output_path,
                                           f"{job_name}.jsonl"))
        self.path = self.sink.path

    def write_scalar(self, name, value, step):
        self.sink.write("scalar", name=name, value=float(value),
                        step=int(step))

    def flush(self):
        self.sink.flush()

    def close(self):
        self.sink.close()


class PrometheusMonitor:
    """MonitorMaster backend: scalars as one labelled gauge family,
    flushed to a text-format file the registry's other metrics share.

    File-based by design (see :class:`PrometheusSink` for when to prefer
    the live ``/metrics`` endpoint instead): when the obs server is
    armed on the same registry, the scalars written here are ALSO
    visible on the scrape route for free — the monitor writes into the
    registry first and flushes the file second."""

    SCALAR_FAMILY = "deepspeed_scalar"

    def __init__(self, output_path="runs/", job_name="DeepSpeedJobName",
                 registry=None, path=None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.sink = PrometheusSink(
            path or os.path.join(output_path, f"{job_name}.prom"),
            self.registry)
        self.path = self.sink.path

    def write_scalar(self, name, value, step):
        self.registry.gauge(self.SCALAR_FAMILY,
                            "monitor scalars (reference names as labels)",
                            labels={"name": str(name)}).set(value)
        self.registry.gauge("deepspeed_scalar_step",
                            "last step at which the scalar was written",
                            labels={"name": str(name)}).set(step)

    def flush(self):
        self.sink.write()

    def close(self):
        self.sink.write()
