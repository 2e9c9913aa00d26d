"""Shared monitor escalation protocol (counterpart of
``deepspeed_tpu/telemetry/escalation.py``).

A monitor escalates firing rules the same way every time:

1. warn once per rule (the first firing logs; repeats stay quiet),
2. count the firing (``owner.rule_counts`` + the registry counter),
3. append to the bounded ``owner.anomalies`` forensics list,
4. emit each anomaly into the process-global run chronicle
   (:mod:`deepspeed_tpu_torch.telemetry.chronicle`; a skipped dict build
   when none is armed),
5. a throttled snapshot, forced when any rule fired for the first time,
6. ``after_snapshot(any_first)``, a per-monitor follow-up,
7. the ``on_escalate`` / ``on_anomaly`` hooks, each fenced so a throwing
   hook can never kill the step that surfaced the anomaly.

The owner's ``rule_counts`` / ``anomalies`` objects are mutated in place
(``del list[:-N]``, not reassignment): reports hold references to them.
"""

from deepspeed_tpu_torch.telemetry import chronicle as _chronicle
from deepspeed_tpu_torch.utils.logging import logger


def escalate(owner, anoms, *, tag, counter, counter_help, step=None,
             after_snapshot=None):
    """Run the escalation protocol for *owner* over *anoms*.

    *owner* supplies ``rule_counts``, ``anomalies``,
    ``MAX_ANOMALY_HISTORY``, ``registry``, ``_log``, ``snapshot_path``,
    ``write_snapshot(force=)``, ``on_escalate`` and ``on_anomaly``. *tag*
    is the log prefix, *counter*/*counter_help* the registry counter.
    *step*, when given, overrides each anomaly's own step."""
    chron = _chronicle.get_chronicle()
    any_first = False
    for a in anoms:
        rule = a["rule"]
        first = rule not in owner.rule_counts
        any_first = any_first or first
        owner.rule_counts[rule] = owner.rule_counts.get(rule, 0) + 1
        owner.anomalies.append(a)
        if first:
            owner._log("[%s] %s (%s) at step %s: %s — snapshot -> %s",
                       tag, rule, a["severity"],
                       step if step is not None else a.get("step"),
                       a["detail"], owner.snapshot_path)
        if owner.registry is not None:
            owner.registry.counter(counter, counter_help,
                                   labels={"rule": rule}).inc()
        if chron.enabled:
            chron.emit("anomaly", source=tag,
                       step=step if step is not None else a.get("step"),
                       severity=a.get("severity"), rule=rule,
                       detail=a.get("detail"),
                       artifact=owner.snapshot_path)
    del owner.anomalies[:-owner.MAX_ANOMALY_HISTORY]
    owner.write_snapshot(force=any_first)
    if after_snapshot is not None:
        after_snapshot(any_first)
    if owner.on_escalate is not None:
        try:
            owner.on_escalate()
        except Exception as e:   # forensics must never kill a step
            logger.warning("[%s] on_escalate hook failed: %s", tag, e)
    if owner.on_anomaly is not None:
        try:
            owner.on_anomaly(anoms)
        except Exception as e:   # a policy engine must not either
            logger.warning("[%s] on_anomaly hook failed: %s", tag, e)
