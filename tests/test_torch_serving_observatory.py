"""The port's serving observatory against the JAX package's, on the CPU.

Units: the same act sequences (the cases of JAX's
tests/unit/test_serving_observatory.py:67-355, plus the speculation
rule, the lanes and the chronicle emission) go to both packages'
``SlotStepLedger`` and ``ServingObservatory``, with one fake clock
patched into each module's ``time``, so the TTFT and throttle rules and
every timestamp agree. Reports, snapshots (loaded back), warn-once logs,
snapshot counts, registry counters, lane events and chronicle events
must be equal (the chronicle's wall stamps dropped).

End to end: JAX's ``obs_serving`` model (vocab 256, 2 layers, n_embd 32,
fp32, seeded flax weights bridged to the port) serves the same requests
through both packages' ``ServingEngine`` with observability on. Tokens,
ledger units, timeline events (names, order, details; times dropped),
preemption reasons, recompute counters, the count-based rules' firings,
the lane events' names and lanes, and the serving chronicle events must
be equal; the snapshot's key set and schema, ``close()``, the livelock
report and the disabled path are checked on the port.

Every file goes under ``tmp_path``; an autouse fixture also makes
``tmp_path`` the working directory, so a default ``SERVING_HEALTH.json``
that slips through never reaches the repo root.
"""

import json
import os
import types

import numpy as np
import pytest

from deepspeed_tpu.serving.server import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving.server import \
    ServingLivelockError as JaxLivelockError
from deepspeed_tpu.telemetry import chronicle as jchron
from deepspeed_tpu.telemetry import serving_observatory as jso
from deepspeed_tpu.telemetry import tracer as jtracer
from deepspeed_tpu.telemetry.metrics import MetricsRegistry as JaxRegistry
from deepspeed_tpu_torch.runtime.config import DeepSpeedServingConfig
from deepspeed_tpu_torch.serving.server import (ServingEngine,
                                                ServingLivelockError)
from deepspeed_tpu_torch.telemetry import chronicle as tchron
from deepspeed_tpu_torch.telemetry import serving_observatory as tso
from deepspeed_tpu_torch.telemetry import tracer as ttracer
from deepspeed_tpu_torch.telemetry.metrics import MetricsRegistry
from tests.test_torch_serving_parity import tiny_pair
from tests.torch_threads import one_torch_thread  # noqa: F401

# JAX's obs_serving fixture model (tests/unit/test_serving_observatory.py)
OBS_MODEL = dict(vocab_size=256, n_positions=64, n_embd=32, n_head=2)
SIDES = ("jax", "port")
PKG = {"jax": types.SimpleNamespace(M=jso, tracer=jtracer, chron=jchron,
                                    Registry=JaxRegistry),
       "port": types.SimpleNamespace(M=tso, tracer=ttracer, chron=tchron,
                                     Registry=MetricsRegistry)}


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


@pytest.fixture(autouse=True)
def _fresh_lanes():
    jtracer._reset_lane_tids()
    ttracer._reset_lane_tids()
    yield
    jtracer._reset_lane_tids()
    ttracer._reset_lane_tids()


class FakeTime:
    """A manual clock for a module's ``time``: reads return the current
    stamp; ``sleep`` / ``advance_ms`` move it."""

    def __init__(self):
        self.ns = 10 ** 12

    def perf_counter(self):
        return self.ns / 1e9

    def perf_counter_ns(self):
        return self.ns

    monotonic, monotonic_ns = perf_counter, perf_counter_ns

    def sleep(self, s):
        self.ns += int(round(s * 1e9))

    def advance_ms(self, ms):
        self.ns += int(round(ms * 1e6))


def _normalize(obj, side_dir):
    """The side's directory in strings becomes ``<dir>``; a NaN becomes
    the string "nan" (so that equal reports compare equal)."""
    if isinstance(obj, str):
        return obj.replace(side_dir, "<dir>")
    if isinstance(obj, float) and obj != obj:
        return "nan"
    if isinstance(obj, dict):
        return {k: _normalize(v, side_dir) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_normalize(v, side_dir) for v in obj]
    return obj


def _req(req_id=1, slot=0):
    return types.SimpleNamespace(
        req_id=req_id, slot=slot, prompt=[1, 2, 3], max_new_tokens=8,
        preemptions=0, output_tokens=[], block_table=[], submit_t=0.0,
        prefix_hit_blocks=0)


class Env:
    """One package's side of a unit case: its module, a fake clock in
    its ``time``, and a factory of observatories under its own dir."""

    def __init__(self, side, root, monkeypatch):
        self.pkg = PKG[side]
        self.M = self.pkg.M
        self.clock = FakeTime()
        monkeypatch.setattr(self.M, "time", self.clock)
        self.dir = str(root / side)
        os.makedirs(self.dir, exist_ok=True)
        self.made = []

    def obs(self, max_batch=2, decode_steps=1, name="SERVING_HEALTH.json",
            **kw):
        logs = []
        kw.setdefault("window", 4)
        kw.setdefault("warmup_windows", 1)
        ob = self.M.ServingObservatory(
            max_batch=max_batch, decode_steps=decode_steps,
            snapshot_path=os.path.join(self.dir, name),
            registry=self.pkg.Registry(), on_escalate=lambda: None,
            log_fn=lambda msg, *a: logs.append(msg % a), **kw)
        ob.test_logs = logs
        self.made.append(ob)
        return ob


def _step(ob, acts=None, occupied=(), queue=0, active=0, occ=0.0,
          frag=0.0, progress=True):
    ob.end_step(acts or {}, set(occupied), queue_depth=queue,
                active=active, kv_occupancy=occ, kv_fragmentation=frag,
                progress=progress)


# ------------------------------------------------------------ unit cases
# each takes an Env and returns extra observables (the observatories the
# env made are compared by the test)

def case_ledger_sums(env):
    led = env.M.SlotStepLedger(max_batch=3, decode_steps=4)
    led.account({0: ("decode", 3), 1: ("prefill", 16)}, occupied={0, 1})
    led.account({0: ("decode", 4)}, occupied={0, 2})
    led.account({}, occupied=set())
    return {"totals": led.totals(), "wasted": led.wasted_fraction(),
            "dict": led.as_dict()}


def case_ledger_speculative(env):
    led = env.M.SlotStepLedger(max_batch=2, decode_steps=4)
    led.account({0: ("decode", 2, 1), 1: ("decode", 4, 0)},
                occupied={0, 1})
    led.account({0: ("decode", 1, 3)}, occupied={0})
    led2 = env.M.SlotStepLedger(max_batch=1, decode_steps=3)
    led2.account({0: ("decode", 2, 9)}, occupied={0})
    return {"a": led.as_dict(), "b": led2.as_dict()}


def case_ledger_recompute_clamps(env):
    led = env.M.SlotStepLedger(max_batch=1, decode_steps=2)
    led.account({0: ("recompute", 8)}, occupied={0})
    led.account({0: ("decode", 99)}, occupied={0})
    led.account({0: ("cached_prefill", 3)}, occupied={0})
    return {"dict": led.as_dict()}


def case_ttft_armed_after_warmup(env):
    ob = env.obs(window=2, warmup_windows=1, ttft_slo_ms=10.0,
                 ttft_breach_frac=0.5)
    r = _req()
    ob.record_first_token(r, 50.0)
    _step(ob)
    _step(ob)
    warm = (ob.windows_closed, dict(ob.rule_counts))
    ob.record_first_token(r, 60.0)
    _step(ob)
    _step(ob)
    return {"warm": warm, "verdict": ob.verdict()}


def case_ttft_breach_fraction(env):
    ob = env.obs(window=1, warmup_windows=0, ttft_slo_ms=10.0,
                 ttft_breach_frac=0.5)
    for ttft in (5.0, 6.0, 50.0):
        ob.record_first_token(_req(), ttft)
    _step(ob)
    ob2 = env.obs(name="b.json", window=1, warmup_windows=0,
                  ttft_slo_ms=10.0, ttft_breach_frac=1.0)
    ob2.record_first_token(_req(), 50.0)
    _step(ob2)
    return {}


def case_admission_fail(env):
    ob = env.obs()
    r = _req()
    ob.record_submit(r)
    env.clock.advance_ms(3)
    ob.on_admission_fail(r)
    return {"finished": dict(ob.requests_finished)}


def case_queue_growth(env):
    ob = env.obs(window=1, warmup_windows=0, queue_growth_windows=3)
    for q in (1, 2, 3, 5, 2, 3):
        _step(ob, queue=q)
    return {}


def case_preemption_thrash(env):
    ob = env.obs(window=2, warmup_windows=0, preemption_thrash=2)
    r = _req()
    ob.record_submit(r)
    ob.on_admit(r)
    ob.on_preempt(r, "capacity_growth", evicted_tokens=12)
    env.clock.advance_ms(1)
    ob.on_preempt(r, "capacity_growth", evicted_tokens=4)
    ob.record_prefill(r, 0, 0, 8, 8, env.clock.ns, env.clock.ns + 5, False)
    _step(ob, acts={0: ("recompute", 8)}, occupied={0}, active=1)
    _step(ob)
    return {}


def case_decode_stall(env):
    ob = env.obs(window=2, warmup_windows=0)
    _step(ob, occupied={0, 1}, active=2)
    _step(ob, occupied={0, 1}, active=2)
    ob2 = env.obs(name="b.json", window=2, warmup_windows=0)
    _step(ob2)
    _step(ob2)
    return {"verdicts": [ob.verdict(), ob2.verdict()]}


def case_no_progress_exact(env):
    ob = env.obs(window=10 ** 6, no_progress_steps=3)
    seen = []
    for p in (False, False, False, False, True):
        _step(ob, progress=p)
        seen.append(dict(ob.rule_counts))
    return {"seen": seen, "streaks": (ob.no_progress_streak,
                                      ob.max_no_progress_streak)}


def case_warn_once_and_throttle(env):
    ob = env.obs(window=1, warmup_windows=0, ttft_slo_ms=1.0,
                 ttft_breach_frac=0.1)
    counts = []
    for _ in range(4):
        ob.record_first_token(_req(), 99.0)
        _step(ob)
        env.clock.advance_ms(1000)
        counts.append(ob._snapshots_written)
    _step(ob, occupied={0}, active=1)          # a new rule forces a write
    env.clock.advance_ms(6000)                 # past the 5 s throttle
    ob.record_first_token(_req(), 99.0)
    _step(ob)
    counts.append(ob._snapshots_written)
    return {"counts": counts}


def case_no_duplicate_window(env):
    ob = env.obs(window=2, warmup_windows=0, ttft_slo_ms=1.0,
                 ttft_breach_frac=0.1)
    ob.record_first_token(_req(), 99.0)
    _step(ob, acts={0: ("decode", 1)}, occupied={0}, active=1)
    _step(ob, acts={0: ("decode", 1)}, occupied={0}, active=1)
    return {"indices": [w["index"] for w in ob.windows]}


def case_no_progress_on_boundary(env):
    ob = env.obs(window=4, warmup_windows=0, no_progress_steps=4,
                 ttft_slo_ms=1.0, ttft_breach_frac=0.1)
    ob.record_first_token(_req(), 99.0)
    for _ in range(4):
        _step(ob, progress=False)
    return {"closed": ob.windows_closed}


def case_close_flushes(env):
    ob = env.obs(window=1, warmup_windows=0, ttft_slo_ms=1.0,
                 ttft_breach_frac=0.1)
    ob.record_first_token(_req(), 99.0)
    _step(ob)
    ob.record_first_token(_req(), 99.0)
    _step(ob)
    before = ob._snapshots_written
    ob.close()
    ob2 = env.obs(name="clean.json")
    _step(ob2)
    ob2.close()
    return {"before": before, "clean_exists": os.path.exists(
        ob2.snapshot_path)}


def case_requeue_wait_lane(env):
    ob = env.obs()
    r = _req()
    ob.record_submit(r)
    env.clock.sleep(0.1)
    ob.on_admit(r)
    ob.on_preempt(r, "capacity_growth", evicted_tokens=3)
    env.clock.sleep(0.005)
    r.preemptions = 1
    ob.on_admit(r)
    ob.record_decode({0: (r, 1)}, env.clock.ns, env.clock.ns + 2000)
    ob.record_first_token(r, 105.0)
    ob.record_finish(r, "max_tokens", 0)
    return {}


def case_partial_window_forced(env):
    ob = env.obs(window=8, warmup_windows=0)
    _step(ob, acts={0: ("decode", 1)}, occupied={0}, active=1)
    rep = ob.report()
    _step(ob, acts={0: ("prefill", 4)}, occupied={0}, active=1)
    return {"closed": ob.windows_closed, "first": rep}


def case_strict_json(env):
    ob = env.obs(window=1, warmup_windows=0, ttft_slo_ms=1.0,
                 ttft_breach_frac=0.1)
    ob.record_first_token(_req(), 99.0)
    _step(ob, occ=float("nan"), frag=float("inf"))
    return {}


def case_speculation_waste(env):
    ob = env.obs(max_batch=2, decode_steps=4, window=2, warmup_windows=0,
                 spec_acceptance_floor=0.5)
    _step(ob, acts={0: ("decode", 1, 3), 1: ("decode", 2, 2)},
          occupied={0, 1}, active=2)
    _step(ob, acts={0: ("decode", 1, 2)}, occupied={0}, active=1)
    _step(ob, acts={0: ("decode", 4, 0)}, occupied={0}, active=1)
    _step(ob, acts={0: ("decode", 4, 0)}, occupied={0}, active=1)
    return {}


def case_full_lifecycle(env):
    """Two requests through every hook, with a prefix hit, a recompute
    resume and a capacity failure."""
    ob = env.obs(max_batch=2, window=3, warmup_windows=0,
                 preemption_thrash=1, timeline_ring=2)
    a, b, c = _req(1, 0), _req(2, 1), _req(3, None)
    b.prefix_hit_blocks = 2
    for r in (a, b, c):
        ob.record_submit(r)
        env.clock.advance_ms(0.5)
    ob.on_admit(a)
    ob.on_admit(b)
    ob.on_admission_fail(c)
    t = env.clock.ns
    ob.record_prefill(a, 0, 0, 8, 0, t, t + 1000, True)
    ob.record_prefill(b, 1, 16, 4, 0, t, t + 2000, True)
    _step(ob, acts={0: ("prefill", 8), 1: ("cached_prefill", 4)},
          occupied={0, 1}, queue=0, active=2, occ=0.5, frag=0.25)
    for k in range(4):
        env.clock.advance_ms(2)
        t = env.clock.ns
        ob.record_decode({0: (a, 1), 1: (b, 1)}, t, t + 500)
        if k == 0:
            ob.record_first_token(a, 7.0)
            ob.record_first_token(b, 6.5)
        _step(ob, acts={0: ("decode", 1), 1: ("decode", 1)},
              occupied={0, 1}, active=2, occ=0.75, frag=0.1)
    ob.on_preempt(b, "capacity_growth", evicted_tokens=21)
    _step(ob, acts={0: ("decode", 1)}, occupied={0}, queue=1, active=1)
    b.preemptions = 1
    ob.on_admit(b)
    ob.record_prefill(b, 1, 0, 8, 8, env.clock.ns, env.clock.ns + 9, False)
    _step(ob, acts={0: ("decode", 1), 1: ("recompute", 8)},
          occupied={0, 1}, active=2)
    a.output_tokens = [1, 2, 3, 4, 5, 6]
    ob.record_finish(a, "max_tokens", 0)
    ob.record_finish(b, "eos", 1)
    _step(ob, progress=False)
    return {"render": env.M.render(ob.report())}


UNIT_CASES = {name[5:]: fn for name, fn in sorted(globals().items())
              if name.startswith("case_")}


def _observables(env, extra):
    out = {"extra": extra, "obs": []}
    for ob in env.made:
        snap = None
        if os.path.exists(ob.snapshot_path):
            with open(ob.snapshot_path) as f:
                snap = json.load(f, parse_constant=lambda tok: pytest.fail(
                    f"snapshot carries bare {tok!r}"))
        reg = ob.registry.snapshot()
        out["obs"].append({
            "report": ob.report(), "snapshot": snap,
            "logs": list(ob.test_logs),
            "snapshots_written": ob._snapshots_written,
            "windows_closed": ob.windows_closed,
            "rule_counts": dict(ob.rule_counts),
            "registry": {k: [(r["labels"], r.get("value"))
                             for r in rows] for k, rows in reg.items()}})
    return _normalize(out, env.dir)


def _run_case(name, tmp_path, monkeypatch, chronicle=False):
    got = {}
    for side in SIDES:
        env = Env(side, tmp_path, monkeypatch)
        tracer = env.pkg.tracer.Tracer(enabled=True)
        old_tracer = env.pkg.tracer.set_tracer(tracer)
        chron = env.pkg.chron.RunChronicle(background=False) \
            if chronicle else None
        old_chron = env.pkg.chron.set_chronicle(chron)
        try:
            extra = UNIT_CASES[name](env)
        finally:
            env.pkg.tracer.set_tracer(old_tracer)
            env.pkg.chron.set_chronicle(old_chron)
        obs = _observables(env, extra)
        obs["lanes"] = tracer.events()
        if chron is not None:
            obs["chronicle"] = _normalize(
                [{k: v for k, v in e.items()
                  if k not in ("t_us", "unix_us")}
                 for e in chron.snapshot_events()], env.dir)
            chron.close()
        got[side] = obs
    return got


@pytest.mark.parametrize("name", sorted(UNIT_CASES))
def test_unit_case_equals_jax(name, tmp_path, monkeypatch):
    got = _run_case(name, tmp_path, monkeypatch)
    assert got["port"] == got["jax"]


def test_unit_literals(tmp_path, monkeypatch):
    """A few of JAX's literal expectations, on the port alone."""
    env = Env("port", tmp_path, monkeypatch)
    led = case_ledger_sums(env)
    assert led["totals"] == ({"decode_useful": 7, "cached_prefill": 0,
                              "prefill": 4, "recompute": 0, "frozen": 5,
                              "idle": 20, "drafted_rejected": 0}, 3)
    assert led["wasted"] == (5 + 20) / 36
    case_warn_once_and_throttle(env)
    ob = env.made[-1]
    assert ob.rule_counts == {"ttft_slo_breach": 5, "decode_stall": 1}
    assert len(ob.test_logs) == 2 and ob._snapshots_written == 3
    with open(ob.snapshot_path) as f:
        assert json.load(f)["schema"] == "deepspeed_tpu.serving_health/3"


@pytest.mark.parametrize("name", ["preemption_thrash", "full_lifecycle",
                                  "speculation_waste"])
def test_escalation_chronicle_events_equal_jax(name, tmp_path, monkeypatch):
    got = _run_case(name, tmp_path, monkeypatch, chronicle=True)
    assert got["port"]["chronicle"], "the rules must have fired"
    assert {e["kind"] for e in got["port"]["chronicle"]} == {"anomaly"}
    assert got["port"] == got["jax"]


def test_lane_tids_and_export_metadata_equal_jax(tmp_path):
    keys = [("serving", 0), ("serving", "queue"), ("fleet", 3),
            ("serving", 0), "x"]
    assert [ttracer.allocate_lane_tid(k) for k in keys] == \
        [jtracer.allocate_lane_tid(k) for k in keys]
    docs = {}
    for side, mod in (("jax", jtracer), ("port", ttracer)):
        t = mod.Tracer(enabled=True)
        t.set_process_label("rank 1", sort_index=1)
        t.emit({"name": "thread_name", "ph": "M", "pid": 7,
                "tid": mod.allocate_lane_tid(("serving", 1)),
                "args": {"name": "serving slot 1"}})
        n = t.event_count()
        path = t.export(str(tmp_path / side / "trace.json"))
        with open(path) as f:
            docs[side] = (n, json.load(f))
        off = mod.Tracer(enabled=False)
        off.emit({"name": "x"})
        off.instant("y")
        assert off.event_count() == 0
    assert docs["port"] == docs["jax"]


# ------------------------------------------------------------ config
def test_observability_config_parse_equal_jax(monkeypatch):
    from deepspeed_tpu.runtime.config import \
        DeepSpeedServingConfig as JaxServingConfig
    block = {"serving": {"observability": {
        "enabled": True, "window": 16, "ttft_slo_ms": 250,
        "preemption_thrash": 4, "trace_lanes": False,
        "snapshot_file": "x.json"}}}
    assert vars(DeepSpeedServingConfig(block).observability) == \
        vars(JaxServingConfig(block).observability)
    monkeypatch.setenv("DS_SERVING_OBS", "1")
    assert DeepSpeedServingConfig({}).observability.enabled is True
    monkeypatch.setenv("DS_SERVING_OBS", "0")
    assert DeepSpeedServingConfig(block).observability.enabled is False


# ------------------------------------------------------------ end to end
@pytest.fixture(scope="module")
def obs_pair():
    jeng, teng, _ = tiny_pair(**OBS_MODEL)
    return jeng, teng


def _obs_block(side_dir, **over):
    o = {"enabled": True, "window": 4, "warmup_windows": 0,
         "preemption_thrash": 1, "ttft_slo_ms": 1e9,
         "snapshot_file": os.path.join(side_dir, "SERVING_HEALTH.json")}
    o.update(over)
    return o


def _servers(obs_pair, tmp_path, obs_over=None, **serving):
    jeng, teng = obs_pair
    out = {}
    for side, Engine, eng, Reg in (
            ("jax", JaxServingEngine, jeng, JaxRegistry),
            ("port", ServingEngine, teng, MetricsRegistry)):
        d = str(tmp_path / side)
        os.makedirs(d, exist_ok=True)
        conf = dict({"max_batch": 2, "block_size": 8}, **serving)
        conf["observability"] = _obs_block(d, **(obs_over or {}))
        out[side] = Engine(eng, config=conf, registry=Reg())
    return out


def _trace(seed, n, plen, gen):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (int(rng.integers(*plen)),)).astype(
        np.int32), int(rng.integers(*gen))) for _ in range(n)]


def _drop_times(events):
    return [{k: v for k, v in e.items() if k not in ("t_ms", "ttft_ms")}
            for e in events]


def _comparable(srv, rids, outs):
    rep = srv.serving_report()
    tls = {t["req_id"]: t for t in rep["timelines"]["recent"]}
    windows = []
    for w in rep["windows"]:
        w = dict(w)
        w["ttft_ms"] = {k: v for k, v in w["ttft_ms"].items()
                        if k != "max"}
        windows.append(w)
    return {
        "tokens": [(outs[r].tokens, outs[r].finish_reason,
                    outs[r].preemptions) for r in rids],
        "ledger": rep["slot_ledger"],
        "timelines": [(tls[r]["finish_reason"],
                       _drop_times(tls[r]["events"])) for r in rids],
        "counters": rep["counters"],
        "anomalies": rep["anomalies"], "windows": windows,
        "verdict": rep["verdict"], "queue": rep["queue"], "kv": rep["kv"],
        "engine_state": rep["engine_state"],
        "recompute_total": srv.registry.counter(
            "serving_recompute_tokens_total").value,
    }


E2E = {
    # 6 usable blocks of 8 for two 15-token prompts of 20 new: preempts
    "preempt": ({"num_blocks": 7}, (5, 2, (15, 16), (20, 21))),
    "gather_preempt_mixed": ({"num_blocks": 9, "max_batch": 3,
                              "prefill_chunk": 6,
                              "attention_impl": "gather"},
                             (7, 6, (1, 31), (2, 14))),
    "decode_steps_3": ({"decode_steps": 3, "prefill_chunk": 6},
                       (9, 4, (4, 20), (3, 9))),
    "speculative_prefix": ({"speculative": {"enabled": True, "k": 3},
                            "prefix_cache": {"enabled": True},
                            "num_blocks": 7}, (11, 4, (9, 20), (4, 12))),
}


@pytest.mark.parametrize("case", sorted(E2E))
def test_e2e_observatory_equals_jax(obs_pair, tmp_path, case):
    serving, (seed, n, plen, gen) = E2E[case]
    trace = _trace(seed, n, plen, gen)
    if case == "speculative_prefix":   # a shared 16-token prefix
        head = trace[0][0][:16]
        trace = [(np.concatenate([head, p]), g) for p, g in trace]
    srvs = _servers(obs_pair, tmp_path, **serving)
    got, lanes, chron = {}, {}, {}
    for side, srv in srvs.items():
        pkg = PKG[side]
        tracer = pkg.tracer.Tracer(enabled=True)
        old_t = pkg.tracer.set_tracer(tracer)
        ch = pkg.chron.RunChronicle(background=False)
        old_c = pkg.chron.set_chronicle(ch)
        try:
            rids = [srv.submit(p, max_new_tokens=g) for p, g in trace]
            outs = {o.req_id: o for o in srv.serve_forever()}
        finally:
            pkg.tracer.set_tracer(old_t)
            pkg.chron.set_chronicle(old_c)
        got[side] = _normalize(_comparable(srv, rids, outs),
                               str(tmp_path / side))
        lanes[side] = [(e["name"], e["ph"], e.get("tid"),
                        e.get("args", {}).get("name"))
                       for e in tracer.events()
                       if 0 <= e.get("tid", 0) - ttracer._LANE_TID_BASE
                       < 1000]
        chron[side] = _normalize([{k: v for k, v in e.items()
                                   if k not in ("t_us", "unix_us")}
                                  for e in ch.snapshot_events()],
                                 str(tmp_path / side))
        ch.close()
    for key in got["jax"]:
        assert got["port"][key] == got["jax"][key], key
    assert lanes["port"] == lanes["jax"]
    assert chron["port"] == chron["jax"]
    led = got["port"]["ledger"]
    assert led["total_units"] == \
        led["steps"] * led["max_batch"] * led["decode_steps"]
    if case == "preempt":
        assert got["port"]["recompute_total"] > 0
    if "num_blocks" in serving:
        assert srvs["port"].scheduler.preemptions_total > 0
        assert got["port"]["counters"]["preemptions_by_reason"]
        assert got["port"]["counters"]["recompute_tokens"] == \
            got["port"]["recompute_total"]
        assert "preemption_thrash" in got["port"]["counters"][
            "anomaly_counts"]
        assert any(e["event"] == "preemption" for e in chron["port"])
    if "speculative" in serving:
        assert led["units"]["drafted_rejected"] + \
            led["units"]["decode_useful"] > 0
    assert {"serving slot 0", "serving slot 1", "serving queue"} <= {
        label for _, ph, _, label in lanes["port"] if ph == "M"}
    assert {"decode", "prefill"} & {n for n, *_ in lanes["port"]}


def test_e2e_snapshot_keys_schema_and_close(obs_pair, tmp_path):
    srvs = _servers(obs_pair, tmp_path, num_blocks=7,
                    obs_over={"window": 2})
    docs, written = {}, {}
    for side, srv in srvs.items():
        for p, g in _trace(5, 2, (15, 16), (20, 21)):
            srv.submit(p, max_new_tokens=g)
        srv.serve_forever()
        assert srv.observatory.anomalies, "the undersized pool must thrash"
        before = srv.observatory._snapshots_written
        srv.close()
        written[side] = srv.observatory._snapshots_written - before
        with open(srv.observatory.snapshot_path) as f:
            docs[side] = json.load(f, parse_constant=lambda tok: pytest.fail(
                f"snapshot carries bare {tok!r}"))
    assert written == {"jax": 1, "port": 1}
    assert docs["port"]["schema"] == docs["jax"]["schema"] == \
        "deepspeed_tpu.serving_health/3"
    assert set(docs["port"]) == set(docs["jax"])
    for key in ("slot_ledger", "counters", "rules"):
        assert set(docs["port"][key]) == set(docs["jax"][key])
    assert os.listdir(".") == [] or set(os.listdir(".")) <= set(SIDES), \
        "nothing may land in the working directory"


def test_e2e_livelock_error_carries_report(obs_pair, tmp_path):
    srvs = _servers(obs_pair, tmp_path)
    reports = {}
    for side, srv in srvs.items():
        srv.submit(np.arange(1, 6), max_new_tokens=2)
        srv.step = lambda: False          # break the progress invariant
        err = JaxLivelockError if side == "jax" else ServingLivelockError
        with pytest.raises(err) as ei:
            srv.serve_forever()
        assert "no progress" in str(ei.value)
        rep = ei.value.report
        assert os.path.exists(srv.observatory.snapshot_path)
        reports[side] = (rep["schema"], rep["counters"]["requests_finished"],
                         rep["engine_state"]["scheduler"]["waiting"],
                         _drop_times(rep["timelines"]["active"][0]["events"]))
    assert reports["port"] == reports["jax"]
    assert reports["port"][3][-1]["event"] == "queued"


def test_e2e_disabled_path_is_inert(obs_pair, tmp_path):
    _, teng = obs_pair
    srv = ServingEngine(teng, config={"max_batch": 2, "block_size": 8},
                        registry=MetricsRegistry())
    assert srv.observatory is None and srv.scheduler.observer is None
    srv.submit(np.arange(1, 9), max_new_tokens=3)
    srv.serve_forever()
    rep = srv.serving_report(write=True)
    assert rep["enabled"] is False and "engine_state" in rep
    assert srv.chronicle_report() == {"enabled": False}
    srv.close()
    assert os.listdir(tmp_path) == [], "the disabled path wrote a file"


def test_e2e_paused_admission_refuses_and_chronicles(obs_pair, tmp_path):
    """A submit while admission is paused raises with the rule, counts
    into ``serving_requests_rejected_total`` and chronicles a
    ``submit_refused`` event, as in the JAX server."""
    from deepspeed_tpu.serving.server import \
        ServingAdmissionPausedError as JaxPausedError
    from deepspeed_tpu_torch.serving import ServingAdmissionPausedError
    got = {}
    for side, srv in _servers(obs_pair, tmp_path).items():
        pkg = PKG[side]
        srv._admission_pause_rule = "queue_growth"
        ch = pkg.chron.RunChronicle(background=False)
        old = pkg.chron.set_chronicle(ch)
        err = JaxPausedError if side == "jax" else \
            ServingAdmissionPausedError
        try:
            with pytest.raises(err) as ei:
                srv.submit(np.arange(1, 6), max_new_tokens=2)
        finally:
            pkg.chron.set_chronicle(old)
        got[side] = (ei.value.rule, srv.registry.counter(
            "serving_requests_rejected_total",
            labels={"reason": "admission_paused"}).value,
            [{k: v for k, v in e.items() if k not in ("t_us", "unix_us")}
             for e in ch.snapshot_events()], srv.scheduler.num_waiting)
        ch.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] == "queue_growth" and got["port"][1] == 1
    assert got["port"][2][0]["event"] == "submit_refused"
