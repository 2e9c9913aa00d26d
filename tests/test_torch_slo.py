"""The port's SLO burn-rate monitor against the JAX package's, on the CPU.

The same objectives and the same histogram observations go into both
packages' ``MetricsRegistry`` and ``SloMonitor``, on one fake integer-µs
clock (the monitors' ``now_us`` hook, ``telemetry/clock.py``'s axis).
Each case drives a script of ticks (observations, then the clock moved,
then ``tick``). Reports (burn rates, tiers, anomalies, ``rule_counts``,
``effective_threshold_ms``, the window spans), the registry's SLO
families, the chronicle's anomaly events and the final snapshot files
must be equal; exact equality, since both sides do the same float
arithmetic on the same integers. ``from_config`` gets the same
``telemetry`` dicts through both packages' config classes. No JAX
program runs here: the monitor is host bookkeeping in both packages.
"""

import json
import os

import pytest

from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.guardian import Guardian as JaxGuardian
from deepspeed_tpu.telemetry import chronicle as jchron
from deepspeed_tpu.telemetry import slo as jslo
from deepspeed_tpu.telemetry.metrics import MetricsRegistry as JaxRegistry
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.guardian import Guardian
from deepspeed_tpu_torch.telemetry import chronicle as tchron
from deepspeed_tpu_torch.telemetry import slo as tslo
from deepspeed_tpu_torch.telemetry.metrics import MetricsRegistry
from tests.torch_threads import one_torch_thread  # noqa: F401

SIDES = {"jax": (jslo, JaxRegistry, jchron, JaxGuardian),
         "port": (tslo, MetricsRegistry, tchron, Guardian)}

TTFT = {"name": "ttft", "kind": "latency", "metric": "ttft_ms",
        "threshold_ms": 100.0, "target": 0.9}          # budget 0.1
E2E = {"name": "e2e", "kind": "latency", "metric": "e2e_ms",
       "threshold_ms": 75.0, "target": 0.95}           # snaps to 100
GOODPUT = {"name": "goodput", "kind": "goodput", "target": 0.9}


class Clock:
    def __init__(self, start_us=10_000_000):
        self.us = start_us

    def __call__(self):
        return self.us


# a script is a list of (ticks, {metric: [latencies]}, seconds a tick)
CASES = {
    "healthy": ([TTFT], [(70, {"ttft_ms": [20, 40, 80]}, 1.0)]),
    "fast_only_warns": ([TTFT], [(60, {"ttft_ms": [20] * 20}, 1.0),
                                 (4, {"ttft_ms": [500] * 5}, 1.0),
                                 (10, {"ttft_ms": [20] * 20}, 1.0)]),
    "page_recover_repage": ([TTFT], [
        (65, {"ttft_ms": [20, 30]}, 1.0),
        (40, {"ttft_ms": [900, 900, 20]}, 1.0),
        (90, {"ttft_ms": [20] * 30}, 1.0),
        (70, {"ttft_ms": [900, 40]}, 1.0)]),
    "ineligible_early_burst": ([TTFT], [(8, {"ttft_ms": [900] * 4}, 1.0)]),
    "throttled_half_ticks": ([TTFT, E2E], [
        (80, {"ttft_ms": [20], "e2e_ms": [60]}, 0.5),
        (90, {"ttft_ms": [500], "e2e_ms": [150, 60]}, 0.5)]),
    "two_objectives_and_unarmed_goodput": ([TTFT, E2E, GOODPUT], [
        (60, {"ttft_ms": [20], "e2e_ms": [50]}, 1.0),
        (50, {"ttft_ms": [20], "e2e_ms": [300, 300, 50]}, 1.0)]),
}


def _drive(side, objectives, script, tmp_path):
    mod, Registry, chron_mod, G = SIDES[side]
    clock = Clock()
    reg = Registry()
    os.makedirs(tmp_path / side, exist_ok=True)
    snap = str(tmp_path / side / "SLO_REPORT.json")
    guardian = G(journal_path=None, action_cooldown_steps=0)
    pauses = []
    guardian.pause_fn = pauses.append
    mon = mod.SloMonitor(objectives=[dict(o) for o in objectives],
                         fast_window_s=10.0, slow_window_s=60.0,
                         eval_interval_s=1.0, snapshot_path=snap,
                         registry=reg, job_name="slo", now_us=clock,
                         log_fn=lambda *a: None)
    mon.on_anomaly = guardian.hook("slo")
    ch = chron_mod.RunChronicle(background=False)
    old = chron_mod.set_chronicle(ch)
    step = 0
    try:
        for ticks, obs, dt in script:
            for _ in range(ticks):
                for metric, values in obs.items():
                    h = reg.histogram(metric, "latency")
                    for v in values:
                        h.observe(v)
                clock.us += int(dt * 1e6)
                step += 1
                mon.tick(step=step)
                guardian.serving_tick(step)
        report = mon.report()
        mon.close()
    finally:
        chron_mod.set_chronicle(old)
    events = [{k: v for k, v in e.items()
               if k not in ("t_us", "unix_us", "artifact")}
              for e in ch.snapshot_events()]
    ch.close()
    snapshot = None
    if os.path.exists(snap):
        with open(snap) as f:
            snapshot = json.load(f, parse_constant=lambda tok: pytest.fail(
                f"the snapshot carries a bare {tok}"))
    families = {k: v for k, v in reg.snapshot().items()
                if k.startswith("slo_")}
    return {"report": report, "snapshot": snapshot, "families": families,
            "events": events, "pauses": pauses,
            "age": mon.last_eval_age_s(), "closed_report": mon.report(),
            "guardian_actions": [a["action"] for a in guardian.actions]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_monitor_equals_jax(case, tmp_path):
    objectives, script = CASES[case]
    got = {side: _drive(side, objectives, script, tmp_path)
           for side in SIDES}
    for key in got["jax"]:
        assert got["port"][key] == got["jax"][key], key
    rep = got["port"]["report"]
    assert rep["schema"] == "deepspeed_tpu.slo/1"
    assert rep["params"]["min_span_frac"] == tslo.MIN_SPAN_FRAC == 0.5
    counts = rep["rule_counts"]
    if case == "healthy":
        assert not counts and rep["objectives"]["ttft"]["tier"] == "ok"
        assert got["port"]["snapshot"] is None      # nothing to explain
    if case == "fast_only_warns":
        assert counts == {tslo.RULE_FAST: 1}
    if case == "page_recover_repage":
        assert counts[tslo.RULE_PAGE] == 2
        assert got["port"]["pauses"] == [tslo.RULE_PAGE]
        assert got["port"]["snapshot"]["rule_counts"] == counts
    if case == "ineligible_early_burst":
        w = rep["objectives"]["ttft"]["windows"]
        # the fast window may burn; the slow one is not yet eligible, so
        # an early burst warns and never pages
        assert not w["slow"]["eligible"] and counts == {tslo.RULE_FAST: 1}
    if case == "two_objectives_and_unarmed_goodput":
        assert rep["objectives"]["goodput"]["active"] is False
        assert rep["objectives"]["e2e"]["effective_threshold_ms"] == 100.0
    for name, o in rep["objectives"].items():
        for w in (o.get("windows") or {}).values():
            assert w["span_us"] == w["t_newest_us"] - w["t_anchor_us"]


@pytest.mark.parametrize("block", [
    {"enabled": True},
    {"enabled": True, "output_path": "out", "job_name": "job",
     "slo": {"enabled": True, "fast_window_s": 30, "slow_window_s": 600,
             "burn_threshold": 2.0, "eval_interval_s": 0.5,
             "ttft_threshold_ms": 250, "ttft_target": 0.95,
             "e2e_target": 0.9, "snapshot_file": "slo.json",
             "objectives": [dict(TTFT), dict(GOODPUT)]}},
    {"enabled": True, "slo": {"enabled": True,
                              "snapshot_file": "/abs/slo.json"}},
], ids=["defaults", "every_key", "absolute_snapshot"])
def test_from_config_equals_jax(block, tmp_path):
    cfg = {"train_batch_size": 8, "telemetry": block}
    jt = JaxConfig(json.loads(json.dumps(cfg)),
                   data_parallel_size=1).telemetry
    tt = DeepSpeedConfig(json.loads(json.dumps(cfg))).telemetry
    out = str(tmp_path)
    mons = {"jax": jslo.SloMonitor.from_config(jt, output_path=out),
            "port": tslo.SloMonitor.from_config(tt, output_path=out)}
    for mon in mons.values():
        for o in mon.serving_defaults:
            mon.add_objective(o)
    got = {s: (m.report(), m.snapshot_path, m.serving_defaults)
           for s, m in mons.items()}
    assert got["port"] == got["jax"]


def test_objective_validation_names_the_field():
    for obj, match in [("nope", "must be a dict"),
                       ({"kind": "latency"}, "non-empty string 'name'"),
                       ({"name": "x", "kind": "availability"}, "kind must"),
                       ({"name": "x", "kind": "goodput", "target": 1.0},
                        "target"),
                       ({"name": "x", "kind": "latency", "target": 0.9},
                        "'metric' histogram family"),
                       ({"name": "x", "kind": "latency", "target": 0.9,
                         "metric": "m", "threshold_ms": 0}, "threshold_ms")]:
        for mod in (jslo, tslo):
            with pytest.raises(ValueError, match=match):
                mod.normalize_objective(obj)
    bad = {"train_batch_size": 8, "telemetry": {"slo": {
        "objectives": [{"name": "x", "kind": "goodput", "target": 2}]}}}
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError
    with pytest.raises(DeepSpeedConfigError, match="objectives"):
        DeepSpeedConfig(bad)


def test_render_equals_jax(tmp_path):
    objectives, script = CASES["page_recover_repage"]
    rep = _drive("port", objectives, script, tmp_path)["report"]
    assert tslo.render(rep) == jslo.render(rep)
    assert "PAGE" in tslo.render(rep) or "FAST" in tslo.render(rep) \
        or "OK" in tslo.render(rep)
    assert tslo.render({"enabled": False}) == "slo: disabled"


def test_disabled_monitor_is_a_stub():
    mon = tslo.SloMonitor(enabled=False)
    mon.tick(step=1)
    mon.close()
    assert mon.report() == {"schema": tslo.SLO_SCHEMA, "enabled": False}
    assert mon.last_eval_age_s() is None
    assert mon.write_snapshot(force=True) is None
