"""The port's run chronicle, clock and ``json_safe`` against the JAX
package's, on the CPU.

The same ``emit`` sequences go to both packages' ``RunChronicle``, with
one fake monotonic clock patched into each package's ``clock`` module,
so the stamps agree. The stream lines, ``report()``, the ``max_events``
ring (with and without a stream: drops and overflow appends),
``events_since``, a resumed stream's sequence numbers, ``load_events``
over a run dir, ``render``, ``render_incidents`` and the ``--render``
CLI must be equal (``unix_us``, the wall rendering, and the run dir
dropped). Every chronicle a test opens is closed, its writer thread
joined, and the process-global chronicle restored.

An autouse fixture makes ``tmp_path`` the working directory.
"""

import json
import os
import threading

import pytest

from deepspeed_tpu.telemetry import chronicle as jchron
from deepspeed_tpu.telemetry import clock as jclock
from deepspeed_tpu.telemetry.health import json_safe as jax_json_safe
from deepspeed_tpu_torch.telemetry import chronicle as tchron
from deepspeed_tpu_torch.telemetry import clock as tclock
from deepspeed_tpu_torch.telemetry.health import json_safe

MODS = {"jax": (jchron, jclock), "port": (tchron, tclock)}


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


@pytest.fixture(autouse=True)
def _fake_clocks(monkeypatch):
    """Both packages' ``monotonic_us`` step 1000 µs a read from the same
    origin."""
    for _, clock in MODS.values():
        state = {"t": 5_000_000}

        def tick(state=state):
            state["t"] += 1000
            return state["t"]
        monkeypatch.setattr(clock, "monotonic_us", tick)


@pytest.fixture(autouse=True)
def _restore_globals():
    yield
    jchron.reset_chronicle()
    tchron.reset_chronicle()


def _emits(ch, n=6):
    ch.emit("anomaly", source="serving", step=3, severity="warning",
            rule="ttft_slo_breach", detail="x" * 90,
            artifact="SERVING_HEALTH.json", fraction=float("inf"))
    ch.emit("serving", "router", request_id=0, replica=1, score=3.25,
            affinity_blocks=2)
    ch.emit("serving", source="serving", step=0, severity="watch",
            event="preemption", reason="capacity_growth", count=2)
    ch.emit("action", source="guardian", step=4, action="rollback",
            rule="nonfinite_grads", outcome={"ok": True, "tag": (1, 2)})
    ch.emit("lifecycle", source="engine", phase="close", ignored=None,
            obj=object)
    for i in range(n - 5):
        ch.emit("serving", "router", request_id=i + 1, replica=i % 2)


def _strip(events):
    return [{k: v for k, v in e.items() if k != "unix_us"}
            for e in events]


def _strip_report(rep):
    rep = dict(rep)
    rep.pop("run_dir", None)
    rep["events"] = _strip(rep["events"])
    return rep


def _both(tmp_path, **kw):
    out = {}
    for side, (mod, _) in MODS.items():
        run_dir = kw.get("run_dir")
        ch = mod.RunChronicle(
            **dict(kw, run_dir=None if run_dir is None
                   else str(tmp_path / side / run_dir)))
        out[side] = ch
    return out


@pytest.mark.parametrize("stream,background", [(False, False),
                                               (True, False),
                                               (True, True)])
def test_emit_stream_and_report_equal_jax(tmp_path, stream, background):
    chs = _both(tmp_path, run_dir="run" if stream else None,
                background=background, job_name="job", rank=2)
    got = {}
    for side, ch in chs.items():
        _emits(ch)
        ch.drain()
        ev = ch.snapshot_events()
        lines = None
        if stream:
            with open(ch.stream_path) as f:
                lines = _strip([json.loads(x) for x in f])
        got[side] = (_strip(ev), _strip_report(ch.report()), lines,
                     _strip(ch.events_since(2)),
                     _strip(ch.events_since(-1, limit=2)))
        ch.close()
        if ch._wthread is not None:
            assert not ch._wthread.is_alive()
    assert got["port"] == got["jax"]
    rep = got["port"][1]
    assert rep["schema"] == "deepspeed_tpu.chronicle/1"
    assert rep["counts_by_source"]["router"] == 2
    json.dumps(rep, allow_nan=False)


@pytest.mark.parametrize("stream", [False, True])
def test_max_events_ring_equal_jax(tmp_path, stream):
    chs = _both(tmp_path, run_dir="run" if stream else None,
                background=False, max_events=4)
    got = {}
    for side, ch in chs.items():
        _emits(ch, n=9)
        disk = None
        if stream:
            with open(ch.stream_path) as f:
                disk = _strip([json.loads(x) for x in f])
        got[side] = (_strip_report(ch.report()), disk,
                     _strip(ch.events_since(1)),
                     _strip(ch.events_since(6, limit=1)))
        ch.close()
    assert got["port"] == got["jax"]
    rep = got["port"][0]
    assert rep["n_events"] == 4
    assert rep["dropped"] == 5
    assert rep["overflow_shipped"] == (5 if stream else 0)
    if stream:
        assert [e["seq"] for e in got["port"][2]] == list(range(2, 9))


def test_resume_continues_sequence_equal_jax(tmp_path):
    got = {}
    for side, (mod, _) in MODS.items():
        d = str(tmp_path / side / "run")
        first = mod.RunChronicle(run_dir=d, background=False)
        _emits(first)
        first.close()
        again = mod.RunChronicle(run_dir=d, background=True)
        again.emit("lifecycle", "engine", phase="init")
        again.close()
        got[side] = (again.resumed_seq, _strip(again.snapshot_events()),
                     _strip(mod.load_events(d)),
                     mod.render(mod.load_events(d)))
    assert got["port"] == got["jax"]
    assert got["port"][0] == 5
    assert got["port"][1][-1]["seq"] == 6


def test_global_arming_and_close_leave_nothing_running(tmp_path):
    before = {t.name for t in threading.enumerate()}
    ch = tchron.RunChronicle(run_dir=str(tmp_path / "run"))
    assert tchron.get_chronicle().enabled is False
    old = tchron.set_chronicle(ch)
    try:
        assert tchron.get_chronicle() is ch
        tchron.get_chronicle().emit("serving", "router", request_id=0)
    finally:
        tchron.set_chronicle(old)
        ch.close()
    assert tchron.get_chronicle() is old and not old.enabled
    assert old.emit("serving", "router") is None
    assert ch.emit("serving", "router") is None       # closed: drops
    assert not ch._wthread.is_alive()
    assert {t.name for t in threading.enumerate()} <= before
    tchron.set_chronicle(ch)
    tchron.reset_chronicle(if_current=object())
    assert tchron.get_chronicle() is ch
    tchron.reset_chronicle(if_current=ch)
    assert tchron.get_chronicle().enabled is False


def test_render_and_cli_equal_jax(tmp_path, capsys):
    incidents = {"schema": "deepspeed_tpu.incidents/1", "job_name": "j",
                 "n_events": 3, "incidents": [{
                     "id": 0, "severity": "critical", "start_step": 3,
                     "end_step": 5, "duration_us": 12500,
                     "goodput_cost": {"badput_total_us": 4000},
                     "root_cause": {"kind": "chaos", "chaos": "poison",
                                    "step": 3, "why": "first"},
                     "rules": ["loss_spike"], "actions": ["rollback"],
                     "artifacts": ["HEALTH.json"]}]}
    got = {}
    for side, (mod, _) in MODS.items():
        d = tmp_path / side
        ch = mod.RunChronicle(run_dir=str(d / "run"), background=False,
                              job_name="j")
        _emits(ch)
        ch.close()
        summary = ch.write_summary(str(d / "CHRONICLE.json"))
        with open(d / "INCIDENTS.json", "w") as f:
            json.dump(incidents, f)
        outs = []
        for target in (summary, str(d / "run"), ch.stream_path,
                       str(d / "INCIDENTS.json")):
            assert mod.main(["--render", target]) == 0
            outs.append(capsys.readouterr().out)
        got[side] = (outs, mod.render(ch.snapshot_events()),
                     mod.render([]), mod.render_incidents(incidents))
    assert got["port"] == got["jax"]
    assert "root cause: chaos/poison" in got["port"][3]


def test_clock_and_json_safe_equal_jax():
    for fn in ("monotonic_s",):
        assert abs(getattr(tclock, fn)() - getattr(jclock, fn)()) < 1.0
    stamp = 123_456_789
    assert abs(tclock.to_unix_us(stamp) - jclock.to_unix_us(stamp)) < 10 ** 6
    assert tclock.from_unix_us(tclock.to_unix_us(stamp)) == stamp
    assert abs(tclock.unix_us() - jclock.unix_us()) < 10 ** 6
    doc = {"a": [1.0, float("nan"), float("inf"), -float("inf")],
           "b": ({"c": float("-inf")}, "s", None, 3)}
    assert json_safe(doc) == jax_json_safe(doc)
    json.dumps(json_safe(doc), allow_nan=False)
    assert os.listdir(".") == []
