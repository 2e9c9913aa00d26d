"""Self-healing guardian: the anomaly->action policy engine
(counterpart of ``deepspeed_tpu/runtime/guardian.py``).

The monitors classify anomalies and escalate; the guardian subscribes to
their ``on_anomaly`` hooks and maps fired rules to BOUNDED,
rate-limited actions:

* ``emergency_checkpoint`` — the first firing of a warning-tier rule
  takes an extra checkpoint through the normal save path; its tag is
  prefixed (``guardian_emergency_...``) and a rollback prefers user tags.
* ``rollback`` — confirmed divergence (a ``loss_spike`` and a streak of
  ``nonfinite_grads`` firings inside one window) restores the newest
  intact tag (masters, optimizer state, loss scale, data position), then
  re-arms after a cooldown, so a bad run degrades to bounded rollbacks.
* ``fp16_rescue`` — ``loss_scale_collapse`` resets the dynamic scaler
  to an escape scale; bounded by ``max_fp16_rescues``.
* ``serving_pause`` / ``serving_resume`` — overload rules
  (``queue_growth``, ``ttft_slo_breach``, the SLO monitor's
  ``slo_burn_page``) pause admission; it resumes after the rules stay
  quiet for ``resume_clear_steps`` serving steps.
* ``serving_spec_disable`` — ``speculation_waste`` turns speculative
  decoding off, once.

Pure host bookkeeping: the guardian never touches a tensor, and a tick
with nothing pending is one attribute read. Actions are callbacks the
owning engine wires (``rollback_fn``...); an action that throws is
journaled as failed and never kills the step. Everything it does is
journaled to ``GUARDIAN.json`` (atomic, strict JSON, the JAX package's
schema string).

The port's training monitors that feed the training rules (health,
goodput, memory, fleet) are not ported yet: those rules arrive through
:meth:`Guardian.notify`, and through the SLO monitor's hook.

CLI: ``python -m deepspeed_tpu_torch.runtime.guardian show
GUARDIAN.json``.
"""

import argparse
import json
import os
import threading

from deepspeed_tpu_torch.telemetry import chronicle as _chronicle
from deepspeed_tpu_torch.telemetry import clock as _clk
from deepspeed_tpu_torch.utils.logging import logger

GUARDIAN_SCHEMA = "deepspeed_tpu.guardian/1"
# rollback prefers user tags; tags with this prefix are the guardian's
# own emergency saves (state of UNKNOWN health — fallback targets only)
EMERGENCY_TAG_PREFIX = "guardian_emergency"

# first-warning rules that trigger an emergency checkpoint: trouble
# signals whose trigger state is still worth persisting. The divergence
# rules (loss_spike, nonfinite_grads, loss_scale_collapse) are EXCLUDED
# on purpose — a checkpoint taken mid-divergence would persist exactly
# the state rollback exists to escape.
DEFAULT_EMERGENCY_RULES = (
    "overflow_streak", "loss_stall", "grad_norm_spike",
    "input_bound", "goodput_regression", "checkpoint_stall",
    "step_time_skew", "input_wait_skew", "checkpoint_skew", "param_desync",
)
DEFAULT_PAUSE_RULES = ("queue_growth", "ttft_slo_breach",
                       "slo_burn_page")


def _atomic_json(path, doc):
    """tmp + rename so a reader never sees a torn journal (the same
    durability idiom as checkpoint_io, minus the checkpoint telemetry)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, default=repr, allow_nan=False)
    os.replace(tmp, path)


class Guardian:
    """Anomaly->action policy engine (one instance per process; the
    training engine and its serving engine share it — serving actions
    ride the same journal).

    Monitors deliver anomalies through ``hook(source)`` callbacks (safe
    to call from any thread; delivery only queues). Policies are
    evaluated and actions performed at step boundaries on the owner's
    thread: the engine calls ``tick(step)`` from its post-apply hook,
    the serving engine calls ``serving_tick(step)`` from its step loop.
    """

    def __init__(self, enabled=True, job_name="", journal_path=None,
                 action_cooldown_steps=25,
                 emergency_checkpoint=True,
                 emergency_rules=DEFAULT_EMERGENCY_RULES,
                 max_emergency_checkpoints=4,
                 rollback=True, divergence_window=50, divergence_streak=2,
                 rollback_cooldown_steps=200, max_rollbacks=2,
                 fp16_rescue=True, max_fp16_rescues=2,
                 serving_degrade=True, pause_rules=DEFAULT_PAUSE_RULES,
                 resume_clear_steps=64,
                 registry=None, log_fn=None):
        self.enabled = bool(enabled)
        self.job_name = job_name
        # None journal_path = in-memory only (unit-test construction);
        # from_config always resolves a real path under the telemetry
        # output dir — NEVER a bare CWD-relative default (the PR-4/PR-11
        # committed-artifact clobber lesson)
        self.journal_path = journal_path
        self.action_cooldown_steps = int(action_cooldown_steps)
        self.emergency_checkpoint = bool(emergency_checkpoint)
        self.emergency_rules = frozenset(emergency_rules)
        self.max_emergency_checkpoints = int(max_emergency_checkpoints)
        self.rollback = bool(rollback)
        self.divergence_window = int(divergence_window)
        self.divergence_streak = max(1, int(divergence_streak))
        self.rollback_cooldown_steps = int(rollback_cooldown_steps)
        self.max_rollbacks = int(max_rollbacks)
        self.fp16_rescue = bool(fp16_rescue)
        self.max_fp16_rescues = int(max_fp16_rescues)
        self.serving_degrade = bool(serving_degrade)
        self.pause_rules = frozenset(pause_rules)
        self.resume_clear_steps = int(resume_clear_steps)
        self.registry = registry
        self._log = log_fn or logger.warning

        # action callbacks — wired by the owning engine(s); an unwired
        # action is journaled as skipped, never an error
        self.emergency_save_fn = None   # (step) -> tag or None
        self.rollback_fn = None         # () -> restored tag or None
        self.fp16_rescue_fn = None      # () -> detail str
        self.pause_fn = None            # (reason) -> None
        self.resume_fn = None           # () -> None
        self.spec_disable_fn = None     # (reason) -> detail str

        self._lock = threading.Lock()
        self._queue = []                # (source, anomaly-dict) pending
        self.rules_seen = {}            # rule -> firings delivered
        self.sources_seen = {}          # source -> firings delivered
        self.actions = []               # journal entries, oldest first
        self.action_counts = {}         # action -> times performed (ok)
        # divergence evidence (training side)
        self._nonfinite_steps = []      # distinct steps nonfinite fired
        self._loss_spike_step = None
        self._rollback_rearm_step = -1  # no rollback before this step
        self._last_action_step = {}     # action -> step last performed
        # serving degradation state
        self.admission_paused = False
        self._pause_rule = None
        self._last_overload_step = -1
        self.last_step = -1

    @classmethod
    def from_config(cls, gconfig, output_path="telemetry/", job_name="",
                    registry=None):
        """Build from a parsed :class:`DeepSpeedGuardianConfig`. The
        journal lands under the telemetry output dir unless the
        configured name is absolute."""
        journal = gconfig.journal_file or "GUARDIAN.json"
        if not os.path.isabs(journal):
            journal = os.path.join(output_path or "telemetry/", journal)
        return cls(
            enabled=gconfig.enabled,
            job_name=job_name,
            journal_path=journal,
            action_cooldown_steps=gconfig.action_cooldown_steps,
            emergency_checkpoint=gconfig.emergency_checkpoint,
            emergency_rules=gconfig.emergency_rules,
            max_emergency_checkpoints=gconfig.max_emergency_checkpoints,
            rollback=gconfig.rollback,
            divergence_window=gconfig.divergence_window,
            divergence_streak=gconfig.divergence_streak,
            rollback_cooldown_steps=gconfig.rollback_cooldown_steps,
            max_rollbacks=gconfig.max_rollbacks,
            fp16_rescue=gconfig.fp16_rescue,
            max_fp16_rescues=gconfig.max_fp16_rescues,
            serving_degrade=gconfig.serving_degrade,
            pause_rules=gconfig.pause_rules,
            resume_clear_steps=gconfig.resume_clear_steps,
            registry=registry)

    # ------------------------------------------------------------- delivery
    def hook(self, source):
        """The ``on_anomaly`` callback to hand a monitor: delivery only
        queues (any thread); policies run at the next tick."""
        def _deliver(anoms):
            self.notify(source, anoms)
        return _deliver

    def notify(self, source, anoms):
        if not self.enabled or not anoms:
            return
        with self._lock:
            for a in anoms:
                self._queue.append((source, a))
                rule = a.get("rule", "?")
                self.rules_seen[rule] = self.rules_seen.get(rule, 0) + 1
                self.sources_seen[source] = \
                    self.sources_seen.get(source, 0) + 1

    def _drain(self):
        with self._lock:
            pending, self._queue = self._queue, []
        return pending

    # -------------------------------------------------------------- actions
    def _cooldown_ok(self, action, step, cooldown=None):
        last = self._last_action_step.get(action)
        if last is None:
            return True
        return step - last >= (self.action_cooldown_steps
                               if cooldown is None else cooldown)

    def _act(self, action, rule, step, fn, *args, detail=""):
        """Perform one action through its callback, journal the outcome,
        count it. A throwing action is a journaled failure — the policy
        engine must never kill the step that triggered it."""
        entry = {"action": action, "rule": rule, "step": int(step),
                 "t_us": _clk.monotonic_us(),
                 "unix_time": round(_clk.unix_us() / 1e6, 3),
                 "detail": detail}
        if fn is None:
            entry["outcome"] = "skipped:no_handler"
        else:
            try:
                result = fn(*args)
                entry["outcome"] = "ok"
                if result is not None:
                    entry["result"] = str(result)
                self.action_counts[action] = \
                    self.action_counts.get(action, 0) + 1
                self._last_action_step[action] = int(step)
            except Exception as e:
                entry["outcome"] = f"failed:{e}"
        self.actions.append(entry)
        self._log("[guardian] %s (rule %s, step %s): %s %s",
                  action, rule, step, entry["outcome"], detail)
        if self.registry is not None:
            self.registry.counter(
                "guardian_actions_total",
                "guardian anomaly->action policy firings",
                labels={"action": action,
                        "outcome": entry["outcome"].split(":")[0]}).inc()
        chron = _chronicle.get_chronicle()
        if chron.enabled:
            # the rule->action edge is the correlator's causal join
            chron.emit("action", source="guardian", step=int(step),
                       severity="warning", action=action, rule=rule,
                       outcome=entry["outcome"], detail=detail or None,
                       artifact=self.journal_path)
        self.write_journal()
        return entry["outcome"] == "ok"

    # ------------------------------------------------------- training tick
    def tick(self, step):
        """Evaluate the training-side policies. Called from the engine's
        post-apply hook on the main thread — the only place a rollback
        (which swaps the live train state) is safe. O(1) when nothing is
        pending."""
        if not self.enabled or not self._queue:
            return
        step = int(step)
        self.last_step = max(self.last_step, step)
        pending = self._drain()
        first_warning_rule = None
        saw_collapse = False
        for source, a in pending:
            rule = a.get("rule", "?")
            astep = int(a.get("step") or step)
            if rule == "nonfinite_grads":
                if not self._nonfinite_steps \
                        or self._nonfinite_steps[-1] != astep:
                    self._nonfinite_steps.append(astep)
            elif rule == "loss_spike":
                self._loss_spike_step = astep
            elif rule == "loss_scale_collapse":
                saw_collapse = True
            if (rule in self.emergency_rules
                    and self.rules_seen.get(rule, 0) == 1
                    and first_warning_rule is None):
                first_warning_rule = rule
        # expire divergence evidence that slid out of the window
        lo = step - self.divergence_window
        self._nonfinite_steps = [s for s in self._nonfinite_steps
                                 if s >= lo]
        if self._loss_spike_step is not None and self._loss_spike_step < lo:
            self._loss_spike_step = None

        # (c) fp16 collapse: reset the scaler before anything else — no
        # other policy can make progress while every step overflows
        if (saw_collapse and self.fp16_rescue
                and self.action_counts.get("fp16_rescue", 0)
                < self.max_fp16_rescues
                and self._cooldown_ok("fp16_rescue", step)):
            self._act("fp16_rescue", "loss_scale_collapse", step,
                      self.fp16_rescue_fn,
                      detail="dynamic loss scale reset to escape scale")

        # (b) confirmed divergence -> rollback, with cooldown re-arm
        if (self.rollback
                and len(self._nonfinite_steps) >= self.divergence_streak
                and self._loss_spike_step is not None
                and step >= self._rollback_rearm_step
                and self.action_counts.get("rollback", 0)
                < self.max_rollbacks):
            ok = self._act(
                "rollback", "loss_spike+nonfinite_grads", step,
                self.rollback_fn,
                detail=f"nonfinite on steps {self._nonfinite_steps}, "
                       f"loss_spike at {self._loss_spike_step}")
            # evidence referred to the pre-rollback trajectory either
            # way; the cooldown only arms after a rollback actually ran
            self._nonfinite_steps = []
            self._loss_spike_step = None
            if ok:
                self._rollback_rearm_step = \
                    step + self.rollback_cooldown_steps
            return   # the restored state makes other pending policies moot

        # (a) first-warning emergency checkpoint
        if (first_warning_rule is not None and self.emergency_checkpoint
                and self.action_counts.get("emergency_checkpoint", 0)
                < self.max_emergency_checkpoints
                and self._cooldown_ok("emergency_checkpoint", step)):
            self._act("emergency_checkpoint", first_warning_rule, step,
                      self.emergency_save_fn, step,
                      detail="first firing of a warning-tier rule")

    # ------------------------------------------------------- serving tick
    def serving_tick(self, step):
        """Evaluate the serving-side degradation policy. Called from the
        serving engine's step loop; ``step`` is the SERVING step
        counter (a different clock from training steps)."""
        if not self.enabled or not self.serving_degrade:
            return
        step = int(step)
        overload_rule = None
        waste_rule = None
        if self._queue:
            for source, a in self._drain():
                rule = a.get("rule", "?")
                if rule in self.pause_rules:
                    overload_rule = rule
                elif rule == "speculation_waste":
                    waste_rule = rule
        # sustained speculation waste -> turn speculation off. One-way by
        # design: the fallback retraces once, and flapping back on would
        # retrace again every flip — the owning engine only re-enables on
        # restart. Cooldown still applies so a burst of windowed firings
        # books a single action.
        if (waste_rule is not None
                and self.action_counts.get("serving_spec_disable", 0) == 0
                and self._cooldown_ok("serving_spec_disable", step)):
            self._act("serving_spec_disable", waste_rule, step,
                      self.spec_disable_fn, waste_rule,
                      detail="windowed acceptance below floor: draft work "
                             "is being rejected faster than it pays off")
        if overload_rule is not None:
            self._last_overload_step = step
            if not self.admission_paused:
                if self._act("serving_pause", overload_rule, step,
                             self.pause_fn, overload_rule,
                             detail="overload: admission paused, new "
                                    "submits fail fast"):
                    self.admission_paused = True
                    self._pause_rule = overload_rule
        elif (self.admission_paused
                and self._last_overload_step >= 0
                and step - self._last_overload_step
                >= self.resume_clear_steps):
            if self._act("serving_resume", self._pause_rule or "recovered",
                         step, self.resume_fn,
                         detail=f"overload rules quiet for "
                                f"{step - self._last_overload_step} "
                                f"serving steps"):
                self.admission_paused = False
                self._pause_rule = None

    # -------------------------------------------------------------- output
    def report(self):
        with self._lock:
            return {
                "schema": GUARDIAN_SCHEMA,
                "job_name": self.job_name,
                "armed": self.enabled,
                "policies": {
                    "emergency_checkpoint": self.emergency_checkpoint,
                    "emergency_rules": sorted(self.emergency_rules),
                    "max_emergency_checkpoints":
                        self.max_emergency_checkpoints,
                    "rollback": self.rollback,
                    "divergence_window": self.divergence_window,
                    "divergence_streak": self.divergence_streak,
                    "rollback_cooldown_steps": self.rollback_cooldown_steps,
                    "max_rollbacks": self.max_rollbacks,
                    "fp16_rescue": self.fp16_rescue,
                    "max_fp16_rescues": self.max_fp16_rescues,
                    "serving_degrade": self.serving_degrade,
                    "pause_rules": sorted(self.pause_rules),
                    "resume_clear_steps": self.resume_clear_steps,
                    "action_cooldown_steps": self.action_cooldown_steps,
                },
                "rules_seen": dict(self.rules_seen),
                "sources_seen": dict(self.sources_seen),
                "actions": list(self.actions),
                "action_counts": dict(self.action_counts),
                "admission_paused": self.admission_paused,
                "last_step": self.last_step,
            }

    def write_journal(self, path=None):
        path = path or self.journal_path
        if path is None:
            return None
        try:
            _atomic_json(path, self.report())
        except OSError as e:   # journaling must never kill an action
            self._log("[guardian] journal write failed: %s", e)
            return None
        return path

    def close(self):
        """Final journal — only when there is something to explain."""
        if self.actions or self.rules_seen:
            self.write_journal()


# --------------------------------------------------------------------- CLI

def render(report):
    """Human-readable rendering of a GUARDIAN.json report dict."""
    lines = [f"guardian: {'ARMED' if report.get('armed') else 'off'}, "
             f"{len(report.get('actions', []))} action(s)"]
    for k, v in sorted(report.get("rules_seen", {}).items()):
        lines.append(f"  rule {k}: {v} firing(s)")
    for a in report.get("actions", []):
        lines.append(f"  step {a.get('step')}: {a.get('action')} "
                     f"[{a.get('outcome')}] <- {a.get('rule')} "
                     f"({a.get('detail')})")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="self-healing guardian reporting CLI")
    sub = ap.add_subparsers(dest="cmd", required=True)
    show = sub.add_parser("show", help="render an existing GUARDIAN.json")
    show.add_argument("path")
    args = ap.parse_args(argv)
    with open(args.path) as f:
        print(render(json.load(f)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
