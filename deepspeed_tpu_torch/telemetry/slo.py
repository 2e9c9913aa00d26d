"""SLO burn-rate monitor — multi-window error-budget alerting
(counterpart of ``deepspeed_tpu/telemetry/slo.py``).

The observatories classify *point* anomalies (a TTFT breach window); an
operator pages on **error-budget burn rate**, evaluated over TWO windows
(SRE multi-window multi-burn alerting):

* ``burn = bad_fraction / (1 - target)`` — 1.0x spends the budget
  exactly as fast as the SLO allows;
* a **fast** window (~5 min) catches the onset, a **slow** window (~1 h)
  proves it is sustained. Both burning -> page-tier anomaly
  (``slo_burn_page``, critical — a guardian admission-pause rule);
  fast-only -> ``slo_burn_fast`` (warning).

Objectives are declarative dicts: ``{"name": "serving_ttft", "kind":
"latency", "metric": "serving_ttft_ms", "threshold_ms": 500, "target":
0.99}`` (good = observations at or under the threshold, read from the
registry histogram's cumulative buckets; the effective threshold snaps
to the smallest bucket edge >= the asked one, and is reported), or
``{"name": "training_goodput", "kind": "goodput", "target": 0.9}``
(good = a goodput ledger's :data:`GOOD_CATEGORIES` seconds). The port
has no goodput ledger yet, so a goodput objective samples ``None`` (an
inactive objective), as the JAX monitor does while no ledger is armed.

Samples are cumulative ``(t_us, bad, total)`` tuples on the shared
integer-µs axis (:func:`clock.monotonic_us`); a window's burn is the
delta between its newest sample and the last sample at/before the window
start, and a window may burn only once samples span
:data:`MIN_SPAN_FRAC` of it. Escalation rides the shared
:func:`escalation.escalate` protocol (warn-once -> throttled
``SLO_REPORT.json`` -> ``slo_anomalies_total`` -> chronicle event ->
guardian ``on_anomaly``), plus ``slo_burn_total{objective,window}``
counters and live ``slo_burn_rate`` gauges. Host-side only: a tick never
touches a tensor. The report carries the JAX package's schema string.

CLI: ``python -m deepspeed_tpu_torch.telemetry.slo --render
SLO_REPORT.json``.
"""

import argparse
import json
import os
import threading
from collections import deque

from deepspeed_tpu_torch.telemetry import chronicle as _chronicle
from deepspeed_tpu_torch.telemetry import clock as _clk
from deepspeed_tpu_torch.telemetry import escalation as _escalation
from deepspeed_tpu_torch.utils.logging import logger

SLO_SCHEMA = "deepspeed_tpu.slo/1"

WINDOWS = ("fast", "slow")
RULE_PAGE = "slo_burn_page"
RULE_FAST = "slo_burn_fast"
# a window must span at least this fraction of itself before it may
# burn — the guard that keeps run-start noise from paging
MIN_SPAN_FRAC = 0.5
# the goodput ledger's good wall-clock categories (JAX telemetry/ledger.py
# GOOD_CATEGORIES): the good share of a goodput objective
GOOD_CATEGORIES = frozenset({"device_compute", "host_dispatch"})


def normalize_objective(obj):
    """Validate one declarative objective dict; returns a normalized
    copy. Raises ``ValueError`` with the offending field named."""
    if not isinstance(obj, dict):
        raise ValueError(f"objective must be a dict, got {type(obj)}")
    name = obj.get("name")
    if not name or not isinstance(name, str):
        raise ValueError("objective needs a non-empty string 'name'")
    kind = obj.get("kind")
    if kind not in ("latency", "goodput"):
        raise ValueError(f"objective {name!r}: kind must be 'latency' or "
                         f"'goodput', got {kind!r}")
    target = obj.get("target")
    if not isinstance(target, (int, float)) or not 0.0 < target < 1.0:
        raise ValueError(f"objective {name!r}: target must be in (0, 1), "
                         f"got {target!r}")
    out = {"name": name, "kind": kind, "target": float(target)}
    if kind == "latency":
        metric = obj.get("metric")
        if not metric or not isinstance(metric, str):
            raise ValueError(f"objective {name!r}: latency objectives "
                             f"need a 'metric' histogram family")
        thresh = obj.get("threshold_ms")
        if not isinstance(thresh, (int, float)) or thresh <= 0:
            raise ValueError(f"objective {name!r}: threshold_ms must be "
                             f"> 0, got {thresh!r}")
        out["metric"] = metric
        out["threshold_ms"] = float(thresh)
    return out


class SloMonitor:
    """Burn-rate evaluation over declarative objectives. See the module
    docstring. ``tick()`` is the only hot entry point — call it at step
    cadence; it self-throttles to ``eval_interval_s``."""

    MAX_ANOMALY_HISTORY = 256
    SNAPSHOT_MIN_INTERVAL_S = 5.0

    def __init__(self, objectives=(), enabled=True, fast_window_s=300.0,
                 slow_window_s=3600.0, burn_threshold=1.0,
                 eval_interval_s=10.0, snapshot_path=None, registry=None,
                 ledger=None, job_name="", on_escalate=None,
                 on_anomaly=None, log_fn=None, now_us=None):
        self.enabled = bool(enabled)
        if not self.enabled:
            return
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.eval_interval_s = float(eval_interval_s)
        self.snapshot_path = snapshot_path
        self.registry = registry
        self.ledger = ledger
        self.job_name = job_name
        self.on_escalate = on_escalate
        self.on_anomaly = on_anomaly
        self._log = log_fn or logger.warning
        self._now_us = now_us or _clk.monotonic_us
        self._lock = threading.Lock()
        self._closed = False
        self.evals = 0
        self.rule_counts = {}
        self.anomalies = []
        self._last_eval_us = None
        self._last_snapshot_s = None
        # enough cumulative samples to anchor the slow window at eval
        # cadence, bounded so a test-tiny interval can't grow unbounded
        depth = min(65536, max(16, int(
            self.slow_window_s / max(self.eval_interval_s, 1e-3)) + 8))
        self.objectives = []
        self.serving_defaults = ()   # from_config fills from tcfg knobs
        self._samples = {}           # name -> deque[(t_us, bad, total)]
        self._state = {}             # name -> last evaluation dict
        for obj in objectives:
            self.add_objective(obj, _depth=depth)

    @classmethod
    def from_config(cls, tcfg, output_path="telemetry/", job_name="",
                    registry=None, ledger=None, on_escalate=None):
        """Build from a parsed :class:`DeepSpeedTelemetryConfig`
        (``telemetry.slo`` block). With no explicit objectives, a
        training-goodput objective is armed when the ledger is; the
        ServingEngine adds the serving latency objectives when it arms.
        The snapshot lands under the telemetry output dir unless the
        configured name is absolute (never a bare CWD default — the
        committed-artifact clobber lesson)."""
        snap = tcfg.slo_snapshot_file or "SLO_REPORT.json"
        if not os.path.isabs(snap):
            snap = os.path.join(output_path or "telemetry/", snap)
        objectives = [normalize_objective(o) for o in tcfg.slo_objectives]
        if not objectives and ledger is not None and ledger.enabled:
            objectives = [{"name": "training_goodput", "kind": "goodput",
                           "target": tcfg.slo_goodput_target}]
        mon = cls(objectives=objectives,
                  fast_window_s=tcfg.slo_fast_window_s,
                  slow_window_s=tcfg.slo_slow_window_s,
                  burn_threshold=tcfg.slo_burn_threshold,
                  eval_interval_s=tcfg.slo_eval_interval_s,
                  snapshot_path=snap, registry=registry, ledger=ledger,
                  job_name=job_name, on_escalate=on_escalate)
        # the ServingEngine arms these via add_objective() when it comes
        # up — it holds no telemetry config, so the knobs ride here
        mon.serving_defaults = (
            {"name": "serving_ttft", "kind": "latency",
             "metric": "serving_ttft_ms",
             "threshold_ms": tcfg.slo_ttft_threshold_ms,
             "target": tcfg.slo_ttft_target},
            {"name": "serving_e2e", "kind": "latency",
             "metric": "serving_e2e_latency_ms",
             "threshold_ms": tcfg.slo_e2e_threshold_ms,
             "target": tcfg.slo_e2e_target},
        )
        return mon

    # -------------------------------------------------------- objectives
    def add_objective(self, obj, _depth=None):
        """Arm one more objective (the ServingEngine's path for the
        ttft/e2e latency objectives). Duplicate names replace."""
        obj = normalize_objective(obj)
        if _depth is None:
            _depth = min(65536, max(16, int(
                self.slow_window_s / max(self.eval_interval_s, 1e-3)) + 8))
        with self._lock:
            self.objectives = [o for o in self.objectives
                               if o["name"] != obj["name"]] + [obj]
            self._samples[obj["name"]] = deque(maxlen=_depth)
            self._state[obj["name"]] = {"tier": "ok"}
        return obj

    # ---------------------------------------------------------- sampling
    def _sample(self, obj):
        """Cumulative ``(bad, total)`` for one objective, or None while
        its source is not armed. Host-side only."""
        if obj["kind"] == "goodput":
            led = self.ledger
            if led is None or not led.enabled:
                return None
            elapsed = led.elapsed()
            totals = led.totals()
            good = sum(totals.get(c, 0.0)
                       for c in GOOD_CATEGORIES)
            return (max(0.0, elapsed - good), elapsed)
        if self.registry is None:
            return None
        fams = self.registry.collect().get(obj["metric"])
        if not fams:
            return None
        bad = total = 0
        eff = None
        for h in fams:
            if getattr(h, "kind", None) != "histogram":
                return None
            cum = h.cumulative_counts()
            # the effective threshold snaps to the smallest bucket edge
            # that covers the asked one (+Inf when none does)
            idx = next((i for i, b in enumerate(h.buckets)
                        if b >= obj["threshold_ms"]), len(h.buckets))
            if eff is None and idx < len(h.buckets):
                eff = float(h.buckets[idx])
            total += h.count
            bad += h.count - cum[idx]
        obj["effective_threshold_ms"] = eff
        return (bad, total)

    def _burn(self, dq, now_us, window_s):
        """Burn over one window from the cumulative sample deque."""
        window_us = int(window_s * 1e6)
        start = now_us - window_us
        newest = dq[-1]
        # the anchor is the last sample at/before the window start — the
        # delta then covers the whole window, not a ragged suffix
        anchor = dq[0]
        for s in dq:
            if s[0] <= start:
                anchor = s
            else:
                break
        span_us = newest[0] - anchor[0]
        d_bad = newest[1] - anchor[1]
        d_total = newest[2] - anchor[2]
        eligible = (span_us >= MIN_SPAN_FRAC * window_us and d_total > 0)
        # cumulative bad can DIP between samples (goodput attribution
        # catches up asynchronously with elapsed), so the delta is
        # clamped — a negative burn rate is meaningless
        bad_frac = (max(0, d_bad) / d_total) if d_total > 0 else None
        return {
            "window_s": window_s,
            "window_us": window_us,
            "t_newest_us": newest[0],
            "t_anchor_us": anchor[0],
            "span_us": span_us,
            "samples": len(dq),
            "delta_bad": d_bad,
            "delta_total": d_total,
            "bad_frac": bad_frac,
            "eligible": eligible,
        }

    # -------------------------------------------------------------- tick
    def tick(self, step=None, force=False):
        """Evaluate every objective; escalate tier *transitions* (a
        sustained burn pages once, not every eval). Self-throttled."""
        if not self.enabled or self._closed:
            return
        now = self._now_us()
        if not force and self._last_eval_us is not None and \
                now - self._last_eval_us < self.eval_interval_s * 1e6:
            return
        self._last_eval_us = now
        anoms = []
        with self._lock:
            objectives = list(self.objectives)
        for obj in objectives:
            name = obj["name"]
            sample = self._sample(obj)
            if sample is None:
                self._state[name] = {"tier": "ok", "active": False}
                continue
            dq = self._samples[name]
            dq.append((now, sample[0], sample[1]))
            budget = 1.0 - obj["target"]
            windows = {}
            for wname, w_s in (("fast", self.fast_window_s),
                               ("slow", self.slow_window_s)):
                w = self._burn(dq, now, w_s)
                burn = (w["bad_frac"] / budget
                        if w["bad_frac"] is not None else None)
                w["burn"] = burn
                w["burning"] = bool(w["eligible"] and burn is not None
                                    and burn >= self.burn_threshold)
                windows[wname] = w
                if self.registry is not None:
                    self.registry.gauge(
                        "slo_burn_rate",
                        "error-budget burn rate (1.0 = spending exactly "
                        "the budget)",
                        labels={"objective": name, "window": wname}).set(
                            burn if burn is not None else 0.0)
                    if w["burning"]:
                        self.registry.counter(
                            "slo_burn_total",
                            "evaluations where a window burned over "
                            "threshold",
                            labels={"objective": name,
                                    "window": wname}).inc()
            tier = ("page" if windows["fast"]["burning"]
                    and windows["slow"]["burning"]
                    else "fast" if windows["fast"]["burning"] else "ok")
            prev = self._state.get(name, {}).get("tier", "ok")
            st = {"tier": tier, "active": True, "windows": windows,
                  "totals": {"bad": sample[0], "total": sample[1]}}
            st["pages"] = self._state.get(name, {}).get("pages", 0)
            st["warns"] = self._state.get(name, {}).get("warns", 0)
            rank = {"ok": 0, "fast": 1, "page": 2}
            if rank[tier] > rank[prev]:       # escalate on the edge only
                bf = windows["fast"]["burn"]
                bs = windows["slow"]["burn"]
                if tier == "page":
                    st["pages"] += 1
                    anoms.append({
                        "rule": RULE_PAGE, "severity": "critical",
                        "step": step, "objective": name, "t_us": now,
                        "burn_fast": bf, "burn_slow": bs,
                        "detail": f"SLO {name!r} burning fast+slow "
                                  f"windows: {bf:.2f}x / "
                                  f"{bs:.2f}x of error budget "
                                  f"(target {obj['target']:g})"})
                else:
                    st["warns"] += 1
                    anoms.append({
                        "rule": RULE_FAST, "severity": "warning",
                        "step": step, "objective": name, "t_us": now,
                        "burn_fast": bf, "burn_slow": bs,
                        "detail": f"SLO {name!r} burning the fast "
                                  f"window at {bf:.2f}x of error "
                                  f"budget (target {obj['target']:g})"})
            self._state[name] = st
        self.evals += 1
        if anoms:
            self._escalate(anoms, step)

    def last_eval_age_s(self):
        """Seconds since the last evaluation (the obs server's /healthz
        last-tick age probe); None before the first tick."""
        if not self.enabled or self._last_eval_us is None:
            return None
        return round((self._now_us() - self._last_eval_us) / 1e6, 3)

    def _escalate(self, anoms, step):
        _escalation.escalate(
            self, anoms, tag="slo", counter="slo_anomalies_total",
            counter_help="slo burn-rate anomaly firings", step=step)

    # ------------------------------------------------------------ output
    def report(self):
        if not self.enabled:
            return {"schema": SLO_SCHEMA, "enabled": False}
        with self._lock:
            objectives = list(self.objectives)
            state = {k: dict(v) for k, v in self._state.items()}
        objs = {}
        for obj in objectives:
            st = state.get(obj["name"], {"tier": "ok", "active": False})
            entry = {"kind": obj["kind"], "target": obj["target"],
                     "error_budget": round(1.0 - obj["target"], 10)}
            for k in ("metric", "threshold_ms", "effective_threshold_ms"):
                if k in obj:
                    entry[k] = obj[k]
            entry.update(st)
            objs[obj["name"]] = entry
        return {
            "schema": SLO_SCHEMA,
            "enabled": True,
            "closed": self._closed,
            "job_name": self.job_name,
            "clock": "monotonic_us",
            "params": {
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "burn_threshold": self.burn_threshold,
                "eval_interval_s": self.eval_interval_s,
                "min_span_frac": MIN_SPAN_FRAC,
            },
            "evals": self.evals,
            "objectives": objs,
            "rule_counts": dict(self.rule_counts),
            "anomalies": list(self.anomalies),
        }

    def write_snapshot(self, path=None, force=False, report=None):
        """Throttled JSON snapshot (the monitors' shared discipline);
        forced on first firings by the escalation protocol."""
        if not self.enabled:
            return None
        path = path or self.snapshot_path
        if path is None:
            return None
        now_s = _clk.monotonic_s()
        if not force and self._last_snapshot_s is not None and \
                now_s - self._last_snapshot_s < self.SNAPSHOT_MIN_INTERVAL_S:
            return None
        self._last_snapshot_s = now_s
        doc = report if report is not None else self.report()
        try:
            _chronicle._atomic_write_bytes(
                path, json.dumps(doc, indent=1, default=repr,
                                 allow_nan=False).encode())
        except OSError as e:    # forensics must never kill a step
            self._log("[slo] snapshot write failed: %s", e)
            return None
        return path

    def close(self):
        """Final snapshot when there is something to explain. Idempotent;
        ``report()`` keeps working after."""
        if not self.enabled or self._closed:
            return
        self._closed = True
        if self.evals and (self.rule_counts or self.anomalies):
            self.write_snapshot(force=True)


# --------------------------------------------------------------------- CLI

def render(report):
    """Human-readable rendering of an SLO_REPORT.json dict."""
    if not report.get("enabled", True):
        return "slo: disabled"
    lines = [f"slo: {len(report.get('objectives', {}))} objective(s), "
             f"{report.get('evals', 0)} eval(s)"]
    for name, o in sorted(report.get("objectives", {}).items()):
        tier = o.get("tier", "ok")
        lines.append(f"  {name} [{o.get('kind')}] target "
                     f"{o.get('target'):g} -> {tier.upper()}")
        for wname in WINDOWS:
            w = (o.get("windows") or {}).get(wname)
            if not w:
                continue
            burn = w.get("burn")
            lines.append(
                f"    {wname:>4} {w['window_s']:g}s: burn "
                f"{'-' if burn is None else f'{burn:.2f}x'}"
                f"{' BURNING' if w.get('burning') else ''} "
                f"({w['samples']} sample(s) over "
                f"{w['span_us'] / 1e6:.1f}s)")
    for a in report.get("anomalies", []):
        lines.append(f"  {a.get('severity')}: {a.get('detail')}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="SLO burn-rate monitor reporting CLI")
    ap.add_argument("--render", metavar="PATH", required=True,
                    help="render an existing SLO_REPORT.json")
    args = ap.parse_args(argv)
    with open(args.render) as f:
        print(render(json.load(f)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
