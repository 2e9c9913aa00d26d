"""Run chronicle — one causally ordered event timeline for the whole run
(counterpart of ``deepspeed_tpu/telemetry/chronicle.py``).

* :class:`RunChronicle` — an append-only structured event log. Every
  event carries a monotone per-rank sequence number and an integer
  microsecond stamp on the shared monotonic axis
  (:func:`deepspeed_tpu_torch.telemetry.clock.monotonic_us`), so a
  merged timeline is strictly ordered. Emitters reach it through the
  process-global :func:`get_chronicle`. The port's emitters so far:

  ========== ============================================================
  kind        emitted by
  ========== ============================================================
  anomaly     a monitor's rule firing, at ``escalation.escalate`` time
              (the serving observatory)
  serving     the serving engine's preemptions, livelock last rites and
              refused submits; the router's placement of each request
              (source ``router``)
  ========== ============================================================

  The schema string is the JAX package's, so one reader takes either
  package's streams and summaries.

* Persistence: one JSONL stream per rank under a run dir
  (``<run_dir>/events_rank_00000.jsonl``), rewritten atomically
  (tmp + fsync + rename: a reader sees a complete prefix of the log or
  nothing) by a background writer thread that holds only a
  :class:`_WriterState`, so an abandoned chronicle is reclaimed through
  ``weakref.finalize``.

* The in-memory log is bounded (``max_events``): past the cap new events
  drop from the ring and are counted (``dropped``); with a stream armed
  they are still appended to the JSONL (``overflow_shipped``), so
  :meth:`RunChronicle.events_since` never loses the tail. A rank that
  reopens its run dir continues its sequence numbering from the stream.

* :meth:`RunChronicle.report` -> the CHRONICLE.json summary.

Disabled is near free: ``emit`` on the shared disabled instance is one
attribute check. The caller arms a chronicle with
``set_chronicle(RunChronicle(run_dir=...))`` and closes it with
``close()``; no engine arms one from its config yet.

CLI: ``python -m deepspeed_tpu_torch.telemetry.chronicle --render
CHRONICLE.json`` (or a run dir, or a rank stream) prints the merged
timeline; an INCIDENTS.json document prints as incident chains.
"""

import argparse
import json
import math
import os
import threading
import weakref
from collections import deque

from deepspeed_tpu_torch.telemetry import clock as _clk
from deepspeed_tpu_torch.utils.logging import logger

CHRONICLE_SCHEMA = "deepspeed_tpu.chronicle/1"

_TMP_MARK = ".tmp."          # the checkpoint_io sibling-marker convention
_STREAM_FMT = "events_rank_{:05d}.jsonl"

SEVERITY_ORDER = ("critical", "warning", "watch", "info")


def _severity_rank(sev):
    try:
        return SEVERITY_ORDER.index(sev)
    except ValueError:
        return len(SEVERITY_ORDER)


def _fsync_dir(dirname):
    """Durability for the rename (best effort)."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write_bytes(path, payload):
    """tmp sibling + fsync + atomic rename (+ dir fsync)."""
    tmp = f"{path}{_TMP_MARK}{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    _fsync_dir(os.path.dirname(path))


def _append_bytes(path, payload):
    """Durable append (overflow lines past the ring cap). Not a rename —
    the committed prefix is already on disk whole; a torn final line is
    tolerated by every stream reader."""
    with open(path, "ab") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())


def _read_stream(path):
    """Parse a rank JSONL stream, tolerating a torn final line (an
    append interrupted by SIGKILL)."""
    events = []
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return events
    for line in raw.decode(errors="replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            events.append(json.loads(line))
        except ValueError:
            continue            # torn tail — the committed prefix stands
    return events


def _json_sane(obj):
    """Make *obj* strictly-JSON-serialisable: non-finite floats become
    strings (the health.json_safe contract, local copy to keep the
    import graph acyclic), unknown objects their repr."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else str(obj)
    if isinstance(obj, dict):
        return {str(k): _json_sane(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_sane(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    return repr(obj)


class _WriterState:
    """Everything the background writer thread may touch — the thread
    holds ONLY this (never the chronicle), so an abandoned chronicle is
    reclaimed via weakref.finalize. ``busy`` spans dequeue-to-written,
    so ``drain`` means durably on disk."""
    __slots__ = ("queue", "cond", "stopped", "busy", "errors", "warned")

    def __init__(self):
        self.queue = deque()
        self.cond = threading.Condition()
        self.stopped = False
        self.busy = False
        self.errors = 0
        self.warned = False


def _writer_loop(state):
    while True:
        with state.cond:
            state.busy = False
            state.cond.notify_all()
            while not state.queue and not state.stopped:
                state.cond.wait(timeout=0.5)
            if not state.queue and state.stopped:
                return
            mode, path, payload = state.queue.popleft()
            state.busy = True
        try:
            if mode == "append":
                _append_bytes(path, payload)
            else:
                _atomic_write_bytes(path, payload)
        except Exception as e:   # forensics must never kill a run
            state.errors += 1
            if not state.warned:
                state.warned = True
                logger.warning("[chronicle] background write failed: %s",
                               e)


def _finalize_writer(state, thread):
    with state.cond:
        state.stopped = True
        state.cond.notify_all()
    if thread.is_alive():
        thread.join(timeout=5.0)


class RunChronicle:
    """The per-process run chronicle. See the module docstring.

    ``emit`` is thread-safe (monitors escalate on the train thread, the
    serving scheduler and prefetch workers on theirs); each emit appends
    one event and enqueues a full-log rewrite for the background writer
    (coalesced: at most one pending rewrite rides the queue per stream).
    """

    def __init__(self, run_dir=None, rank=0, job_name="", enabled=True,
                 max_events=16384, background=True, log_fn=None):
        self.enabled = bool(enabled)
        self.rank = int(rank)
        self.job_name = job_name
        self.dropped = 0
        self.overflow_shipped = 0
        self.resumed_seq = None
        if not self.enabled:
            return
        self.run_dir = run_dir
        self.max_events = max(1, int(max_events))
        self._log = log_fn or logger.warning
        self._lock = threading.Lock()
        self._seq = 0
        self.events = []
        self._closed = False
        self.stream_path = None
        self._wstate = None
        self._wthread = None
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self.stream_path = os.path.join(
                run_dir, _STREAM_FMT.format(self.rank))
            if os.path.isfile(self.stream_path):
                # resume: continue the sequence numbering behind the
                # earlier stream — a restarted-at-zero rank would collide
                # seqs and break a merged timeline's strict
                # (t_us, seq, rank) order. Prior events reload into the
                # ring (up to the cap) so rewrites keep the whole record;
                # past the cap the old file stays the committed prefix
                # and new events ride the overflow-append path.
                prior = _read_stream(self.stream_path)
                if prior:
                    self.resumed_seq = max(e.get("seq", -1) for e in prior)
                    self._seq = self.resumed_seq + 1
                    self.events = prior[:self.max_events]
            if background:
                self._wstate = _WriterState()
                self._wthread = threading.Thread(
                    target=_writer_loop, args=(self._wstate,),
                    name=f"ds-chronicle-r{self.rank}", daemon=True)
                self._wthread.start()
                self._finalizer = weakref.finalize(
                    self, _finalize_writer, self._wstate, self._wthread)

    # -------------------------------------------------------------- emitting
    def emit(self, kind, source, step=None, severity=None, detail=None,
             **data):
        """Append one event. Returns the event dict (None when disabled
        or dropped). The stamp is taken INSIDE the lock so (t_us, seq)
        is monotone even under concurrent emitters."""
        if not self.enabled or self._closed:
            # post-close emits drop (the writer is gone; an enqueue
            # nobody drains would just dangle)
            return None
        with self._lock:
            overflow = len(self.events) >= self.max_events
            if overflow and self.stream_path is None:
                # append-only: past the cap the committed prefix wins
                # and NEW events drop (counted — a summary with
                # dropped>0 says "timeline truncated", never "rewritten")
                self.dropped += 1
                return None
            t_us = _clk.monotonic_us()
            event = {"seq": self._seq, "t_us": t_us,
                     "unix_us": _clk.to_unix_us(t_us),
                     "kind": kind, "source": source, "rank": self.rank}
            if step is not None:
                event["step"] = int(step)
            if severity is not None:
                event["severity"] = severity
            if detail is not None:
                event["detail"] = str(detail)
            for k, v in data.items():
                if v is not None:
                    event[k] = _json_sane(v)
            self._seq += 1
            if overflow:
                # the ring bounds MEMORY, not the record: the event drops
                # from the in-memory log (counted) but still APPENDS to
                # the committed stream, so events_since / the obs
                # server's disk fallback can serve it to a resumed
                # consumer. Shipped under the lock so the writer queue
                # preserves seq order against the ring-fill rewrite.
                self.dropped += 1
                self.overflow_shipped += 1
                self._ship_locked("append", self._payload([event]))
            else:
                self.events.append(event)
                if self.stream_path:
                    self._ship_locked("rewrite",
                                      self._payload(self.events))
        return event

    def _payload(self, events):
        return ("\n".join(json.dumps(e, sort_keys=True, allow_nan=False)
                          for e in events) + "\n").encode()

    def _ship_locked(self, mode, payload):
        """Enqueue (or perform) one stream write. Called with ``_lock``
        held so the writer queue preserves seq order — the ring-fill
        rewrite always precedes the overflow appends that follow it."""
        if self._wstate is not None:
            with self._wstate.cond:
                if mode == "rewrite":
                    # coalesce: a newer full-log rewrite supersedes any
                    # queued one — the stream is always written whole.
                    # Appends are never discarded (each carries an event
                    # that lives nowhere else).
                    self._wstate.queue = deque(
                        op for op in self._wstate.queue
                        if op[0] != "rewrite")
                self._wstate.queue.append((mode, self.stream_path,
                                           payload))
                self._wstate.cond.notify_all()
        else:
            try:
                if mode == "append":
                    _append_bytes(self.stream_path, payload)
                else:
                    _atomic_write_bytes(self.stream_path, payload)
            except OSError as e:
                self._log("[chronicle] stream write failed: %s", e)

    # --------------------------------------------------------------- reading
    def snapshot_events(self):
        """A consistent copy of the event log (ordered by (t_us, seq))."""
        if not self.enabled:
            return []
        with self._lock:
            return list(self.events)

    def events_since(self, since_seq, limit=None):
        """Events with ``seq > since_seq`` — the resumable-consumer read.

        Serves from the in-memory ring when it still holds the requested
        range; once events have overflowed past the cap (or a resume
        preloaded only a prefix), falls back to the on-disk JSONL stream
        so a consumer that paused across the drop horizon still gets the
        FULL tail instead of a silent gap plus a ``dropped`` counter.
        Returned events are seq-ordered; ``limit`` (when set) keeps the
        NEWEST events (a tail)."""
        if not self.enabled:
            return []
        since = int(since_seq)
        with self._lock:
            ring = list(self.events)
            # _seq counts every RECORDED event (drop-without-stream never
            # increments it), so the ring is the whole record iff it
            # holds _seq events — overflow and resume-truncation both
            # break that equality.
            ring_complete = len(ring) == self._seq
            stream = self.stream_path
        if not ring_complete and stream:
            # the ring dropped (or never held) part of the range — the
            # committed stream is the whole record. Drain first so every
            # queued append is readable.
            self.drain(timeout=2.0)
            disk = _read_stream(stream)
            if disk:
                ring = disk
        out = [e for e in ring if e.get("seq", -1) > since]
        out.sort(key=lambda e: e.get("seq", 0))
        if limit is not None and len(out) > int(limit):
            out = out[-int(limit):]
        return out

    def drain(self, timeout=10.0):
        """Block until every queued stream write is durably on disk."""
        if not self.enabled or self._wstate is None:
            return
        deadline = _clk.monotonic_s() + timeout
        with self._wstate.cond:
            while ((self._wstate.queue or self._wstate.busy)
                   and _clk.monotonic_s() < deadline):
                self._wstate.cond.wait(timeout=0.2)

    def report(self):
        """The CHRONICLE.json summary dict."""
        if not self.enabled:
            return {"schema": CHRONICLE_SCHEMA, "enabled": False}
        events = self.snapshot_events()
        by_kind, by_source = {}, {}
        for e in events:
            by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
            by_source[e["source"]] = by_source.get(e["source"], 0) + 1
        return {
            "schema": CHRONICLE_SCHEMA,
            "job_name": self.job_name,
            "rank": self.rank,
            "run_dir": self.run_dir,
            "n_events": len(events),
            "dropped": self.dropped,
            "overflow_shipped": self.overflow_shipped,
            "resumed_seq": self.resumed_seq,
            "counts_by_kind": by_kind,
            "counts_by_source": by_source,
            "first_t_us": events[0]["t_us"] if events else None,
            "last_t_us": events[-1]["t_us"] if events else None,
            "events": events,
        }

    def write_summary(self, path):
        doc = self.report()
        payload = json.dumps(doc, indent=1, default=repr,
                             allow_nan=False).encode()
        _atomic_write_bytes(path, payload)
        return path

    def close(self):
        """Final stream write + writer join. Idempotent."""
        if not self.enabled or self._closed:
            return
        self._closed = True
        if self.stream_path is not None and self.overflow_shipped == 0:
            # belt-and-braces final rewrite — but ONLY while the stream
            # is ring-shaped: once overflow appends ride behind the last
            # ring rewrite, a full rewrite of the ring would truncate
            # them off the committed record.
            with self._lock:
                self._ship_locked("rewrite", self._payload(self.events))
        self.drain()
        if self._wstate is not None:
            _finalize_writer(self._wstate, self._wthread)


# Process-global chronicle. The shared disabled instance (never None)
# keeps every emit site a plain attribute check.
_DISABLED = RunChronicle(enabled=False)
_GLOBAL = _DISABLED


def get_chronicle():
    return _GLOBAL


def set_chronicle(chronicle):
    """Install *chronicle* as the process global; returns the old one."""
    global _GLOBAL
    old, _GLOBAL = _GLOBAL, (chronicle if chronicle is not None
                             else _DISABLED)
    return old


def reset_chronicle(if_current=None):
    global _GLOBAL
    if if_current is None or _GLOBAL is if_current:
        _GLOBAL = _DISABLED


# --------------------------------------------------------------------- CLI

def load_events(path):
    """Events from a CHRONICLE.json summary, a rank JSONL stream, or a
    run dir of streams (merged, ordered on the shared µs axis)."""
    if os.path.isdir(path):
        events = []
        for f in sorted(os.listdir(path)):
            if f.startswith("events_rank_") and f.endswith(".jsonl") \
                    and _TMP_MARK not in f:
                events.extend(load_events(os.path.join(path, f)))
        events.sort(key=lambda e: (e["t_us"], e.get("rank", 0),
                                   e["seq"]))
        return events
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [json.loads(line) for line in f if line.strip()]
        return json.load(f).get("events", [])


def render(events):
    """Human-readable merged timeline."""
    if not events:
        return "chronicle: no events"
    t0 = events[0]["t_us"]
    lines = [f"chronicle: {len(events)} event(s) across "
             f"{len({e.get('rank', 0) for e in events})} rank(s)"]
    for e in events:
        dt_ms = (e["t_us"] - t0) / 1e3
        step = f"step {e['step']}" if "step" in e else "-"
        what = e.get("rule") or e.get("phase") \
            or e.get("event") or e.get("chaos") or ""
        if e.get("action"):
            # the rule->action causal edge, rendered as one
            what = (f"{what}->{e['action']}" if what else e["action"])
        sev = f" [{e['severity']}]" if "severity" in e else ""
        detail = e.get("detail", "")
        if len(detail) > 72:
            detail = detail[:69] + "..."
        lines.append(f"  +{dt_ms:10.1f}ms r{e.get('rank', 0)} "
                     f"{e['kind']:>14}/{e['source']:<10} {step:>9} "
                     f"{what}{sev} {detail}".rstrip())
    return "\n".join(lines)


def render_incidents(doc):
    """Human-readable incident chains (an INCIDENTS.json document)."""
    incs = doc.get("incidents", [])
    lines = [f"incidents: {len(incs)} over {doc.get('n_events', 0)} "
             f"event(s) (job {doc.get('job_name') or '-'})"]
    for inc in incs:
        dur_ms = inc["duration_us"] / 1e3
        lines.append(
            f"  #{inc['id']} [{inc['severity']}] steps "
            f"{inc['start_step']}-{inc['end_step']} over {dur_ms:.1f}ms "
            f"badput {inc['goodput_cost']['badput_total_us'] / 1e3:.1f}ms")
        rc = inc["root_cause"]
        if rc:
            what = rc.get("rule") or rc.get("chaos") or rc.get("kind")
            lines.append(f"     root cause: {rc['kind']}/{what} at step "
                         f"{rc.get('step', '-')} — {rc['why']}")
        if inc["rules"]:
            lines.append(f"     rules:   {', '.join(inc['rules'])}")
        if inc["actions"]:
            lines.append(f"     actions: {', '.join(inc['actions'])}")
        for a in inc["artifacts"]:
            lines.append(f"     artifact: {a}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="run-chronicle timeline CLI")
    ap.add_argument("--render", metavar="PATH",
                    help="CHRONICLE.json, INCIDENTS.json, a rank .jsonl "
                         "stream, or a run dir — print the merged "
                         "timeline (or the incident chains)")
    args = ap.parse_args(argv)
    if args.render:
        if os.path.isfile(args.render) and args.render.endswith(".json"):
            with open(args.render) as f:
                doc = json.load(f)
            if isinstance(doc, dict) and \
                    str(doc.get("schema", "")).startswith(
                        "deepspeed_tpu.incidents/"):
                print(render_incidents(doc))
                return 0
        print(render(load_events(args.render)))
        return 0
    ap.error("--render is required")


if __name__ == "__main__":
    raise SystemExit(main())
