"""Serving observatory — per-request timelines, slot-step ledger, SLO
rules (counterpart of ``deepspeed_tpu/telemetry/serving_observatory.py``).

* **Per-request lifecycle timelines** (:class:`RequestTimeline`): every
  request accumulates a timestamped event list — ``queued`` ->
  ``admitted`` -> ``prefill_chunk`` x N -> ``decode_begin`` ->
  ``first_token`` -> ``preempted``/``requeued`` (a recompute resume loops
  back to ``admitted``) -> ``finished``/``failed`` — returned from
  ``ServingEngine.serving_report()`` and, when the tracer is enabled,
  exported as per-slot lanes in the Chrome trace (synthetic tids: one
  lane per batch slot plus a queue-wait lane).

* **Slot-step ledger** (:class:`SlotStepLedger`): each scheduler step
  runs ``max_batch`` slots for ``decode_steps`` micro-steps; the ledger
  books every one of those ``max_batch x K`` integer units into exactly
  one category of :data:`SLOT_CATEGORIES` (``decode_useful``,
  ``cached_prefill``, ``prefill``, ``recompute``, ``frozen``, ``idle``,
  ``drafted_rejected``), so the categories sum to
  ``steps x max_batch x K`` by construction, and
  ``wasted = recompute + frozen + idle + drafted_rejected``.

* **SLO monitor**: windowed rules over the ledger and per-window series
  (queue depth, KV occupancy and fragmentation, TTFT) —
  ``ttft_slo_breach``, ``queue_growth``, ``preemption_thrash``,
  ``decode_stall``, ``speculation_waste`` and the exact per-step
  ``no_progress`` streak — escalating warn-once -> throttled
  ``SERVING_HEALTH.json`` snapshot -> the run chronicle
  (telemetry/escalation.py), plus ``serving_anomalies_total{rule=...}``
  in the metrics registry.

Everything here is host bookkeeping: the observatory never touches a
tensor. Its inputs are host ints and floats the server already holds
after the decode dispatch's one token read, so it adds no device
synchronization and leaves the gather impl's CUDA-graph replay as it is.
The report and the snapshot carry the JAX package's schema string, so
one reader takes either package's file.

The escalation hook ``on_escalate`` defaults to :func:`_flush_trace`,
which exports the live telemetry manager's Chrome trace (as the JAX
package's does); closed windows are not shipped to a fleet recorder.

CLI: ``python -m deepspeed_tpu_torch.telemetry.serving_observatory
--render SERVING_HEALTH.json`` pretty-prints a snapshot.
"""

import json
import os
import time
from collections import deque

from deepspeed_tpu_torch.telemetry import escalation
from deepspeed_tpu_torch.telemetry import tracer as _tracer_mod
from deepspeed_tpu_torch.telemetry.health import json_safe
from deepspeed_tpu_torch.utils.logging import logger

SERVING_HEALTH_SCHEMA = "deepspeed_tpu.serving_health/3"

# cached_prefill: prompt tokens a chunk advanced for a request whose
# prefix was partly served read-only from the prefix cache — useful
# work, split out so hit-rate shows up in the ledger, not just counters
# drafted_rejected: speculative draft positions the verify pass refused —
# the booked price of speculation (distinct from frozen: the slot DID
# run those positions through the target, they just didn't advance it)
SLOT_CATEGORIES = ("decode_useful", "cached_prefill", "prefill",
                   "recompute", "frozen", "idle", "drafted_rejected")
# wasted = everything that burned a slot without advancing a request
WASTE_CATEGORIES = ("recompute", "frozen", "idle", "drafted_rejected")

RULE_SEVERITY = {
    "ttft_slo_breach": "warning",
    "queue_growth": "warning",
    "preemption_thrash": "warning",
    "decode_stall": "critical",
    "no_progress": "critical",
    "speculation_waste": "warning",
}
_SEVERITY_ORDER = ("critical", "warning", "watch")


def _flush_trace():
    """Default escalation hook: export the telemetry manager's Chrome
    trace now (its throttle still applies), so the forensics file and the
    trace cover the same incident. A no-op without a live manager."""
    from deepspeed_tpu_torch.telemetry import manager as _mgr
    m = _mgr.get_manager()
    if m is not None:
        m.flush()

# synthetic Chrome-trace lane tids come from the tracer's process-scoped
# registry (tracer.allocate_lane_tid), so slot lanes never collide with
# other lanes in a merged trace


class RequestTimeline:
    """Ordered, timestamped lifecycle events for one request.

    ``events`` is a list of ``{"t_ms", "event", ...detail}`` dicts with
    ``t_ms`` relative to the observatory's start — append-only, bounded
    (a pathological request cannot grow the report without bound)."""

    MAX_EVENTS = 512
    __slots__ = ("req_id", "events", "dropped", "decoding", "wait_start")

    def __init__(self, req_id):
        self.req_id = req_id
        self.events = []
        self.dropped = 0
        self.decoding = False     # has this admission seen a decode yet?
        self.wait_start = None    # perf_counter at last queue entry
        # (submit OR requeue) — what the queue-wait lane measures

    def add(self, t_ms, event, **detail):
        if len(self.events) >= self.MAX_EVENTS:
            self.dropped += 1
            return
        ev = {"t_ms": round(t_ms, 3), "event": event}
        if detail:
            ev.update(detail)
        self.events.append(ev)

    def as_dict(self):
        d = {"req_id": self.req_id, "events": list(self.events)}
        if self.dropped:
            d["dropped_events"] = self.dropped
        return d


class SlotStepLedger:
    """Integer micro-unit slot-step accounting.

    One scheduler step books exactly ``max_batch × decode_steps`` units
    (each slot: K units), so ``sum(units) == steps × max_batch × K``
    holds by construction — there is no residual to drift."""

    def __init__(self, max_batch, decode_steps):
        self.max_batch = int(max_batch)
        self.K = int(decode_steps)
        self.units = {c: 0 for c in SLOT_CATEGORIES}
        self.steps = 0

    def account(self, acts, occupied):
        """Book one scheduler step. ``acts`` maps slot →
        ``("prefill"|"cached_prefill"|"recompute", n_valid)`` or
        ``("decode", delivered)`` or — with speculation on —
        ``("decode", delivered, drafted_rejected)``;
        ``occupied`` is the set of slots still holding a request (a slot
        neither acted nor occupied is idle; occupied-but-unscheduled is
        frozen — an invariant breach worth seeing, not hiding)."""
        K = self.K
        u = self.units
        for i in range(self.max_batch):
            a = acts.get(i)
            if a is None:
                u["frozen" if i in occupied else "idle"] += K
            elif a[0] == "decode":
                d = min(max(int(a[1]), 0), K)
                # 3-tuple: the speculative engine splits the non-useful
                # remainder into verify-rejected drafts vs frozen budget
                r = min(max(int(a[2]), 0), K - d) if len(a) > 2 else 0
                u["decode_useful"] += d
                u["drafted_rejected"] += r
                u["frozen"] += K - d - r
            else:
                u[a[0]] += K
        self.steps += 1

    def totals(self):
        """``(units_by_category, steps)`` — units are cumulative ints."""
        return dict(self.units), self.steps

    def total_units(self):
        return sum(self.units.values())

    def wasted_fraction(self):
        total = self.total_units()
        if not total:
            return 0.0
        return sum(self.units[c] for c in WASTE_CATEGORIES) / total

    def as_dict(self):
        total = self.total_units()
        K = self.K
        return {
            "steps": self.steps,
            "max_batch": self.max_batch,
            "decode_steps": K,
            "units": dict(self.units),
            "total_units": total,
            "slot_steps": {c: self.units[c] / K for c in SLOT_CATEGORIES},
            "total_slot_steps": total / K,   # == steps * max_batch
            "wasted_frac": round(self.wasted_fraction(), 6),
        }


class ServingObservatory:
    """Host-side serving observability: timelines + ledger + SLO rules.

    The server drives it synchronously from its step loop (record_* /
    ``end_step``) and the scheduler through the observer hooks
    (``on_admit`` / ``on_preempt`` / ``on_admission_fail``); everything
    it consumes is already host data, so it adds zero device syncs."""

    SNAPSHOT_MIN_INTERVAL_S = 5.0
    MAX_ANOMALY_HISTORY = 100

    def __init__(self, max_batch, decode_steps=1, job_name="",
                 snapshot_path="SERVING_HEALTH.json", window=32,
                 warmup_windows=1, ttft_slo_ms=1000.0, ttft_breach_frac=0.5,
                 queue_growth_windows=3, preemption_thrash=8,
                 no_progress_steps=200, timeline_ring=64, window_ring=128,
                 trace_lanes=True, spec_acceptance_floor=None,
                 registry=None, on_escalate=None,
                 on_anomaly=None, engine_state_fn=None, log_fn=None):
        self.max_batch = int(max_batch)
        self.job_name = job_name
        self.snapshot_path = snapshot_path
        self.window = max(1, int(window))
        self.warmup_windows = int(warmup_windows)
        self.ttft_slo_ms = float(ttft_slo_ms)
        self.ttft_breach_frac = float(ttft_breach_frac)
        self.queue_growth_windows = int(queue_growth_windows)
        self.preemption_thrash = int(preemption_thrash)
        self.no_progress_steps = int(no_progress_steps)
        self.trace_lanes = bool(trace_lanes)
        # None = speculation off (or unguarded): the speculation_waste
        # rule only arms when the server hands over a floor
        self.spec_acceptance_floor = (None if spec_acceptance_floor is None
                                      else float(spec_acceptance_floor))
        self.registry = registry
        self.on_escalate = on_escalate if on_escalate is not None \
            else _flush_trace
        self.on_anomaly = on_anomaly
        self.engine_state_fn = engine_state_fn
        self._log = log_fn or logger.warning

        self.ledger = SlotStepLedger(max_batch, decode_steps)
        self._t0 = time.perf_counter()
        self.active = {}                       # req_id -> RequestTimeline
        self.recent = deque(maxlen=max(1, int(timeline_ring)))
        self.windows = deque(maxlen=max(1, int(window_ring)))
        self.anomalies = []
        self.rule_counts = {}
        self.windows_closed = 0      # cadence (unforced) windows only
        self._window_seq = 0         # every window, forced included
        self.steps_seen = 0
        self.requests_submitted = 0
        self.requests_finished = {}            # reason -> count
        self.preemptions_by_reason = {}
        self.recompute_tokens = 0
        self.tokens_delivered = 0
        self.first_tokens = 0
        self.no_progress_streak = 0
        self.max_no_progress_streak = 0
        self._snapshots_written = 0
        self._last_snapshot_t = float("-inf")
        self._lanes_named = False
        self._queue_means = deque(
            maxlen=max(2, self.queue_growth_windows + 1))
        # last engine samples (end_step feeds these; report() reads them)
        self._last_queue_depth = 0
        self._last_active = 0
        self._last_kv_occupancy = 0.0
        self._last_kv_frag = 0.0
        self._reset_window()

    @classmethod
    def from_config(cls, obs_config, max_batch, decode_steps=1,
                    job_name="", spec_acceptance_floor=None,
                    registry=None, on_escalate=None,
                    on_anomaly=None, engine_state_fn=None):
        """Build from a parsed ``serving.observability`` block
        (:class:`~deepspeed_tpu_torch.runtime.config.
        DeepSpeedServingObservabilityConfig`)."""
        return cls(
            max_batch=max_batch, decode_steps=decode_steps,
            job_name=job_name,
            snapshot_path=obs_config.snapshot_file,
            window=obs_config.window,
            warmup_windows=obs_config.warmup_windows,
            ttft_slo_ms=obs_config.ttft_slo_ms,
            ttft_breach_frac=obs_config.ttft_breach_frac,
            queue_growth_windows=obs_config.queue_growth_windows,
            preemption_thrash=obs_config.preemption_thrash,
            no_progress_steps=obs_config.no_progress_steps,
            timeline_ring=obs_config.timeline_ring,
            window_ring=obs_config.window_ring,
            trace_lanes=obs_config.trace_lanes,
            spec_acceptance_floor=spec_acceptance_floor,
            registry=registry, on_escalate=on_escalate,
            on_anomaly=on_anomaly, engine_state_fn=engine_state_fn)

    # ------------------------------------------------------------- clock
    def _now_ms(self):
        return (time.perf_counter() - self._t0) * 1e3

    def _timeline(self, req_id):
        tl = self.active.get(req_id)
        if tl is None:
            tl = self.active[req_id] = RequestTimeline(req_id)
        return tl

    # ----------------------------------------------------- Chrome lanes
    def _lane_tid(self, slot):
        # slot lanes 0..max_batch-1; the queue-wait lane sits after them
        return _tracer_mod.allocate_lane_tid(
            ("serving", "queue" if slot is None else int(slot)))

    def _name_lanes(self, tracer):
        """One-time thread_name metadata so the lanes read as
        'serving slot N' / 'serving queue' in chrome://tracing."""
        pid = os.getpid()
        for slot in range(self.max_batch):
            tracer.emit({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": self._lane_tid(slot),
                         "args": {"name": f"serving slot {slot}"}})
        tracer.emit({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": self._lane_tid(None),
                     "args": {"name": "serving queue"}})
        self._lanes_named = True

    def _lane_span(self, slot, name, t0_ns, t1_ns, **args):
        if not self.trace_lanes:
            return
        tracer = _tracer_mod.get_tracer()
        if not tracer.enabled:
            return
        if not self._lanes_named:
            self._name_lanes(tracer)
        ev = {"name": name, "ph": "X", "ts": t0_ns // 1000,
              "dur": max(0, (t1_ns - t0_ns) // 1000),
              "pid": os.getpid(), "tid": self._lane_tid(slot)}
        if args:
            ev["args"] = args
        tracer.emit(ev)

    def _lane_instant(self, slot, name, **args):
        if not self.trace_lanes:
            return
        tracer = _tracer_mod.get_tracer()
        if not tracer.enabled:
            return
        if not self._lanes_named:
            self._name_lanes(tracer)
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": time.perf_counter_ns() // 1000,
              "pid": os.getpid(), "tid": self._lane_tid(slot)}
        if args:
            ev["args"] = args
        tracer.emit(ev)

    # -------------------------------------------------- lifecycle hooks
    def record_submit(self, req):
        self.requests_submitted += 1
        tl = self._timeline(req.req_id)
        tl.wait_start = time.perf_counter()
        tl.add(self._now_ms(), "queued", prompt_len=len(req.prompt),
               max_new_tokens=req.max_new_tokens)

    # scheduler observer protocol -------------------------------------
    def on_admit(self, req):
        tl = self._timeline(req.req_id)
        tl.decoding = False
        tl.add(self._now_ms(), "admitted", slot=req.slot,
               blocks=len(req.block_table))
        # queue-wait lane span: submit (or re-queue) -> admission — a
        # re-admitted request's wait starts at its REQUEUE, not zero
        # (preemption churn is exactly what this lane exists to show)
        if self.trace_lanes:
            now_ns = time.perf_counter_ns()
            start = (tl.wait_start if tl.wait_start is not None
                     else req.submit_t)
            wait_ns = int(max(0.0, time.perf_counter() - start) * 1e9)
            self._lane_span(None, f"req{req.req_id} queued",
                            now_ns - wait_ns, now_ns)

    def on_preempt(self, req, reason, evicted_tokens):
        self.preemptions_by_reason[reason] = \
            self.preemptions_by_reason.get(reason, 0) + 1
        self._win["preemptions"] += 1
        t = self._now_ms()
        tl = self._timeline(req.req_id)
        tl.add(t, "preempted", reason=reason,
               evicted_tokens=int(evicted_tokens), slot=req.slot)
        tl.add(t, "requeued")
        tl.wait_start = time.perf_counter()
        self._lane_instant(req.slot, f"req{req.req_id} preempted",
                           reason=reason,
                           evicted_tokens=int(evicted_tokens))

    def on_admission_fail(self, req):
        # an admission failure IS a finish (the server drains it into its
        # finished queue with reason "capacity") — book it, or the report
        # counters diverge from serving_requests_finished_total
        self.requests_finished["capacity"] = \
            self.requests_finished.get("capacity", 0) + 1
        tl = self._timeline(req.req_id)
        tl.add(self._now_ms(), "failed", reason="capacity")
        self._finish_timeline(req.req_id, "capacity")

    # server step hooks -----------------------------------------------
    def record_prefill(self, req, slot, start, n_valid, n_recompute,
                       t0_ns, t1_ns, done):
        self.recompute_tokens += int(n_recompute)
        self._win["recompute_tokens"] += int(n_recompute)
        self._timeline(req.req_id).add(
            self._now_ms(), "prefill_chunk", slot=slot, start=int(start),
            n_valid=int(n_valid), recompute=int(n_recompute),
            done=bool(done))
        kind = ("recompute" if n_recompute else
                ("cached_prefill" if getattr(req, "prefix_hit_blocks", 0)
                 else "prefill"))
        self._lane_span(slot, kind, t0_ns, t1_ns, tokens=int(n_valid),
                        recompute=int(n_recompute))

    def record_decode(self, dispatch_by_slot, t0_ns, t1_ns):
        """One decode dispatch, BEFORE token delivery (so each
        timeline's ``decode_begin`` precedes its ``first_token``).
        ``dispatch_by_slot`` maps slot → ``(req, budget)``; the kept
        token counts arrive with ``end_step``'s acts."""
        t = self._now_ms()
        for slot, (req, budget) in dispatch_by_slot.items():
            tl = self._timeline(req.req_id)
            if not tl.decoding:
                tl.decoding = True
                tl.add(t, "decode_begin", slot=slot)
            self._lane_span(slot, "decode", t0_ns, t1_ns,
                            budget=int(budget))

    def record_first_token(self, req, ttft_ms):
        self.first_tokens += 1
        self._win["ttft_ms"].append(float(ttft_ms))
        self._timeline(req.req_id).add(self._now_ms(), "first_token",
                                       ttft_ms=round(float(ttft_ms), 3))
        self._lane_instant(req.slot, f"req{req.req_id} first_token",
                           ttft_ms=round(float(ttft_ms), 3))

    def record_finish(self, req, reason, slot):
        self.requests_finished[reason] = \
            self.requests_finished.get(reason, 0) + 1
        tl = self._timeline(req.req_id)
        tl.add(self._now_ms(), "finished", reason=reason,
               tokens=len(req.output_tokens),
               preemptions=req.preemptions)
        self._lane_instant(slot, f"req{req.req_id} finished",
                           reason=reason)
        self._finish_timeline(req.req_id, reason)

    def _finish_timeline(self, req_id, reason):
        tl = self.active.pop(req_id, None)
        if tl is None:
            return
        d = tl.as_dict()
        d["finish_reason"] = reason
        self.recent.append(d)

    # ------------------------------------------------------------ steps
    def _reset_window(self):
        self._win = {
            "steps": 0,
            "units0": dict(self.ledger.units),
            "queue_sum": 0.0, "queue_max": 0, "queue_first": None,
            "active_sum": 0.0, "active_max": 0,
            "occ_sum": 0.0, "occ_peak": 0.0, "frag_sum": 0.0,
            "preemptions": 0, "recompute_tokens": 0,
            "tokens": 0, "ttft_ms": [],
        }

    def end_step(self, acts, occupied, queue_depth, active, kv_occupancy,
                 kv_fragmentation, progress):
        """Close one scheduler step: book the slot units, sample the
        window series, track the exact no-progress streak, and close the
        window every ``window`` steps."""
        self.ledger.account(acts, occupied)
        self.steps_seen += 1
        w = self._win
        w["steps"] += 1
        for a in acts.values():
            if a[0] == "decode":
                self.tokens_delivered += int(a[1])
                w["tokens"] += int(a[1])
        if w["queue_first"] is None:
            w["queue_first"] = int(queue_depth)
        w["queue_sum"] += queue_depth
        w["queue_max"] = max(w["queue_max"], int(queue_depth))
        w["active_sum"] += active
        w["active_max"] = max(w["active_max"], int(active))
        w["occ_sum"] += kv_occupancy
        w["occ_peak"] = max(w["occ_peak"], float(kv_occupancy))
        w["frag_sum"] += kv_fragmentation
        self._last_queue_depth = int(queue_depth)
        self._last_active = int(active)
        self._last_kv_occupancy = float(kv_occupancy)
        self._last_kv_frag = float(kv_fragmentation)
        if progress:
            self.no_progress_streak = 0
        else:
            self.no_progress_streak += 1
            self.max_no_progress_streak = max(self.max_no_progress_streak,
                                              self.no_progress_streak)
        # cadence close BEFORE any no-progress escalation: the
        # escalation's snapshot re-enters report(), which force-closes
        # the in-flight window — a boundary-step escalation would turn
        # this cadence window into a forced (rule-skipped, unpublished)
        # one out from under the stale local accumulator reference
        if w["steps"] >= self.window:
            self._close_window(forced=False)
        if not progress and \
                self.no_progress_streak == self.no_progress_steps:
            self._escalate([{
                "rule": "no_progress", "step": self.steps_seen,
                "severity": RULE_SEVERITY["no_progress"],
                "detail": f"{self.no_progress_streak} consecutive "
                          f"scheduler steps made no progress "
                          f"(waiting={queue_depth} active={active}) — "
                          f"livelock-adjacent; the serve_forever hard "
                          f"guard raises at 1000"}])

    def _close_window(self, forced):
        w = self._win
        steps = w["steps"]
        if steps <= 0:
            return None
        units = {c: self.ledger.units[c] - w["units0"][c]
                 for c in SLOT_CATEGORIES}
        total = sum(units.values())
        K = self.ledger.K
        ttfts = w["ttft_ms"]
        window = {
            "index": self._window_seq,
            "end_step": self.steps_seen,
            "steps": steps,
            "slot_units": units,
            "total_units": total,
            "wasted_frac": round(
                sum(units[c] for c in WASTE_CATEGORIES) / total, 6)
            if total else 0.0,
            "queue_depth": {
                "first": w["queue_first"], "last": self._last_queue_depth,
                "mean": round(w["queue_sum"] / steps, 3),
                "max": w["queue_max"]},
            "active": {"mean": round(w["active_sum"] / steps, 3),
                       "max": w["active_max"]},
            "kv": {"occupancy_mean": round(w["occ_sum"] / steps, 4),
                   "occupancy_peak": round(w["occ_peak"], 4),
                   "fragmentation_mean": round(w["frag_sum"] / steps, 4)},
            "preemptions": w["preemptions"],
            "recompute_tokens": w["recompute_tokens"],
            "tokens": w["tokens"],
            "first_tokens": len(ttfts),
            "ttft_ms": {
                "count": len(ttfts),
                "max": round(max(ttfts), 3) if ttfts else None,
                "over_slo": sum(t > self.ttft_slo_ms for t in ttfts)},
        }
        self._window_seq += 1
        if forced:
            # report-path partial window: ring only, no rules, not
            # counted toward warmup
            window["forced"] = True
            self.windows.append(window)
            return window
        self.windows.append(window)
        self.windows_closed += 1
        self._queue_means.append(window["queue_depth"]["mean"])
        self._publish(window)
        # reset BEFORE the rules run: escalation re-enters report() (the
        # snapshot), and report() force-closes any partial window — with
        # the accumulators still live it would ring-append the window
        # just closed a second time as a forced duplicate
        self._reset_window()
        if self.windows_closed > self.warmup_windows:
            self._check_rules(window)
        return window

    def _publish(self, window):
        reg = self.registry
        if reg is None:
            return
        for c in SLOT_CATEGORIES:
            n = window["slot_units"][c]
            if n > 0:
                reg.counter(
                    "serving_slot_units_total",
                    "slot-step micro-units by category (decode_steps "
                    "units per slot per scheduler step)",
                    labels={"category": c}).inc(n)
        reg.gauge("serving_window_wasted_frac",
                  "wasted (idle+frozen+recompute) fraction of the last "
                  "closed slot-step window").set(window["wasted_frac"])
        reg.gauge("serving_kv_fragmentation",
                  "allocated-but-unwritten fraction of live KV blocks "
                  "(window mean)").set(
                      window["kv"]["fragmentation_mean"])

    # ------------------------------------------------------------- rules
    def _check_rules(self, window):
        anoms = []
        tt = window["ttft_ms"]
        if tt["count"]:
            frac = tt["over_slo"] / tt["count"]
            # >= so the boundary is reachable: breach_frac=1.0 means
            # "fire when EVERY first token breaches", not a dead rule
            if frac >= self.ttft_breach_frac:
                anoms.append({
                    "rule": "ttft_slo_breach", "step": window["end_step"],
                    "severity": RULE_SEVERITY["ttft_slo_breach"],
                    "fraction": round(frac, 4),
                    "detail": f"{tt['over_slo']}/{tt['count']} first "
                              f"tokens in the window exceeded the "
                              f"{self.ttft_slo_ms:g} ms TTFT SLO "
                              f"(threshold "
                              f"{self.ttft_breach_frac:.0%}; worst "
                              f"{tt['max']:g} ms)"})
        qm = self._queue_means
        if (len(qm) == qm.maxlen and qm[-1] >= 1
                and all(b > a for a, b in zip(qm, list(qm)[1:]))):
            anoms.append({
                "rule": "queue_growth", "step": window["end_step"],
                "severity": RULE_SEVERITY["queue_growth"],
                "detail": f"mean queue depth grew monotonically across "
                          f"the last {len(qm)} windows "
                          f"({', '.join(f'{q:.1f}' for q in qm)}) — "
                          f"arrivals outpace service"})
        if window["preemptions"] >= self.preemption_thrash:
            anoms.append({
                "rule": "preemption_thrash", "step": window["end_step"],
                "severity": RULE_SEVERITY["preemption_thrash"],
                "detail": f"{window['preemptions']} preemptions in one "
                          f"{window['steps']}-step window (threshold "
                          f"{self.preemption_thrash}) burned "
                          f"{window['recompute_tokens']} recompute "
                          f"tokens — the KV pool is too small for the "
                          f"admitted load"})
        useful = (window["slot_units"]["decode_useful"]
                  + window["slot_units"]["cached_prefill"]
                  + window["slot_units"]["prefill"]
                  + window["slot_units"]["recompute"])
        if window["active"]["max"] > 0 and useful == 0:
            anoms.append({
                "rule": "decode_stall", "step": window["end_step"],
                "severity": RULE_SEVERITY["decode_stall"],
                "detail": f"slots were occupied (peak "
                          f"{window['active']['max']}) for a whole "
                          f"{window['steps']}-step window but zero "
                          f"slot-units advanced any request — the "
                          f"scheduler's forward-progress invariant "
                          f"broke"})
        # speculation_waste: the window's decode work split badly between
        # kept tokens and verify-rejected drafts. Only armed when the
        # server configured a floor (speculation on), and only judged on
        # windows that actually speculated (rejections booked — an
        # all-accepted window has nothing to complain about).
        if self.spec_acceptance_floor is not None:
            kept = window["slot_units"]["decode_useful"]
            rej = window["slot_units"]["drafted_rejected"]
            if rej > 0:
                acc = kept / (kept + rej)
                if acc < self.spec_acceptance_floor:
                    anoms.append({
                        "rule": "speculation_waste",
                        "step": window["end_step"],
                        "severity": RULE_SEVERITY["speculation_waste"],
                        "acceptance": round(acc, 4),
                        "detail": f"windowed speculative acceptance "
                                  f"{acc:.1%} fell below the "
                                  f"{self.spec_acceptance_floor:.0%} "
                                  f"floor ({kept} kept vs {rej} "
                                  f"rejected draft units) — draft work "
                                  f"is costing more than it saves; the "
                                  f"guardian can disable speculation"})
        if anoms:
            self._escalate(anoms)

    # -------------------------------------------------------- escalation
    def _escalate(self, anoms):
        # the shared protocol (telemetry/escalation.py)
        escalation.escalate(self, anoms, tag="serving",
                            counter="serving_anomalies_total",
                            counter_help="serving SLO/health rule "
                                         "firings")

    # ----------------------------------------------------------- outputs
    def verdict(self):
        if not self.steps_seen:
            return "unknown"
        seen = {RULE_SEVERITY.get(r, "warning") for r in self.rule_counts}
        for tier in _SEVERITY_ORDER:
            if tier in seen:
                return tier
        return "healthy"

    def report(self):
        """The full forensics dict (what ``SERVING_HEALTH.json`` holds).
        Closes the in-flight partial window as a ``forced`` ring entry
        (no rules run on it) so the report is current."""
        if self._win["steps"] > 0:
            self._close_window(forced=True)
            # forced close keeps the accumulators: restart the window
            # from the current ledger state so cadence windows stay
            # contiguous with what was just reported
            self._reset_window()
        engine_state = None
        if self.engine_state_fn is not None:
            try:
                engine_state = self.engine_state_fn()
            except Exception:
                engine_state = None
        return {
            "schema": SERVING_HEALTH_SCHEMA,
            "enabled": True,
            "job_name": self.job_name,
            "verdict": self.verdict(),
            "rules": {
                "window": self.window,
                "warmup_windows": self.warmup_windows,
                "ttft_slo_ms": self.ttft_slo_ms,
                "ttft_breach_frac": self.ttft_breach_frac,
                "queue_growth_windows": self.queue_growth_windows,
                "preemption_thrash": self.preemption_thrash,
                "no_progress_steps": self.no_progress_steps,
                "spec_acceptance_floor": self.spec_acceptance_floor,
            },
            "slot_ledger": self.ledger.as_dict(),
            "counters": {
                "steps_seen": self.steps_seen,
                "requests_submitted": self.requests_submitted,
                "requests_finished": dict(self.requests_finished),
                "preemptions_by_reason": dict(self.preemptions_by_reason),
                "recompute_tokens": self.recompute_tokens,
                "tokens_delivered": self.tokens_delivered,
                "first_tokens": self.first_tokens,
                "max_no_progress_streak": self.max_no_progress_streak,
                "anomaly_counts": dict(self.rule_counts),
            },
            "queue": {"depth": self._last_queue_depth,
                      "active": self._last_active},
            "kv": {"occupancy": round(self._last_kv_occupancy, 4),
                   "fragmentation": round(self._last_kv_frag, 4)},
            "anomalies": list(self.anomalies),
            "windows": list(self.windows),
            "timelines": {
                "active": [tl.as_dict() for tl in self.active.values()],
                "recent": list(self.recent),
            },
            "engine_state": engine_state,
        }

    def write_snapshot(self, path=None, force=False, report=None):
        """Write ``SERVING_HEALTH.json`` (throttled like the health/
        goodput snapshots — re-serialising timelines on every anomaly of
        a thrash storm must not stall the serving loop)."""
        if not force and (time.monotonic() - self._last_snapshot_t
                          < self.SNAPSHOT_MIN_INTERVAL_S):
            return None
        self._last_snapshot_t = time.monotonic()
        path = path or self.snapshot_path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(json_safe(report if report is not None
                                else self.report()),
                      f, indent=1, default=repr, allow_nan=False)
        self._snapshots_written += 1
        return path

    def close(self):
        """Final snapshot — only when there is something to explain."""
        if self.anomalies:
            self.write_snapshot(force=True)


# --------------------------------------------------------------------- CLI

def render(report):
    """Human-readable rendering of a SERVING_HEALTH.json report dict."""
    lines = []
    lines.append(f"serving verdict: {report.get('verdict', '?').upper()}"
                 + (f"  (job {report['job_name']})"
                    if report.get("job_name") else ""))
    led = report.get("slot_ledger") or {}
    total = led.get("total_units") or 0
    lines.append(f"  slot-step ledger: {led.get('steps', 0)} steps x "
                 f"{led.get('max_batch', '?')} slots x "
                 f"K={led.get('decode_steps', '?')} = {total} units "
                 f"(wasted {led.get('wasted_frac', 0):.1%})")
    for c in SLOT_CATEGORIES:
        n = (led.get("units") or {}).get(c, 0)
        if total:
            bar = "#" * int(round(n / total * 40))
            lines.append(f"  {c:14s} {n:8d}  {n / total:6.1%}  {bar}")
    c = report.get("counters", {})
    fin = c.get("requests_finished", {})
    lines.append(f"  requests: {c.get('requests_submitted', 0)} submitted"
                 f", finished {sum(fin.values())} "
                 f"({', '.join(f'{k}={v}' for k, v in fin.items())})")
    pre = c.get("preemptions_by_reason", {})
    if pre:
        lines.append(f"  preemptions: "
                     f"{', '.join(f'{k}={v}' for k, v in pre.items())} "
                     f"(recompute tokens burned "
                     f"{c.get('recompute_tokens', 0)})")
    for a in report.get("anomalies", []):
        lines.append(f"  [{a.get('severity', '?'):8s}] step "
                     f"{a.get('step')}: {a.get('rule')} — "
                     f"{a.get('detail')}")
    if not report.get("anomalies"):
        lines.append("  no serving anomalies recorded")
    kv = report.get("kv") or {}
    lines.append(f"  kv: occupancy {kv.get('occupancy', 0):.1%}, "
                 f"fragmentation {kv.get('fragmentation', 0):.1%}; "
                 f"queue depth {report.get('queue', {}).get('depth', 0)}")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.telemetry.serving_observatory",
        description="Render a SERVING_HEALTH.json snapshot")
    p.add_argument("--render", metavar="SERVING_HEALTH.json",
                   help="pretty-print an existing snapshot and exit")
    args = p.parse_args(argv)
    if args.render:
        with open(args.render) as f:
            print(render(json.load(f)))
        return 0
    p.print_help()
    return 2


if __name__ == "__main__":
    import sys
    sys.exit(main())
