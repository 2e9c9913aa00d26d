"""The serving side of the mission-control plane against the JAX
package's, on the CPU: both packages' ``ServingEngine`` with a
``Guardian``, an ``SloMonitor`` and an ``ObsServer``.

The model is the JAX test's (tests/unit/test_guardian.py
``test_e2e_overload_pause_recovery``: vocab 256, 2 layers, n_embd 32,
2 heads, fp32, ``PRNGKey(0)`` flax weights, bridged to the port), served
with that test's settings (max_batch 2, block_size 8, observability with
windows of 2 steps, queue growth over 1 window, the TTFT rule parked).

* The overload cycle: ``PoolStarvationChaos(hold_frac=1.0)`` grows the
  queue until admission pauses on ``queue_growth``; a submit is refused
  with that rule; the chaos is lifted, the backlog drains without the
  livelock guard; admission resumes after 3 quiet serving steps. Pause
  and resume come at the same serving steps in both packages, with the
  same refused submits, the same journal actions and the same tokens.
* A page-tier SLO burn (``slo_burn_page``, from the TTFT objective the
  server adds, its histogram fed late first tokens, on a fake clock of
  one second an evaluation) pauses admission through the guardian, at
  the same serving step in both packages.
* ``speculation_waste`` (an acceptance floor of 1.0) disables
  speculation once; decoding goes on with the plain program and the
  greedy tokens stay the plain server's.
* ``/api/report/serving`` serves the server's report, and ``close``
  unregisters it.
"""

import json
import os
import urllib.request

import numpy as np
import pytest

from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.guardian import Guardian as JaxGuardian
from deepspeed_tpu.serving.server import \
    ServingAdmissionPausedError as JaxPausedError
from deepspeed_tpu.serving.server import ServingEngine as JaxServingEngine
from deepspeed_tpu.telemetry import obs_server as jobs
from deepspeed_tpu.telemetry import slo as jslo
from deepspeed_tpu.telemetry.metrics import MetricsRegistry as JaxRegistry
from deepspeed_tpu.testing.chaos import \
    PoolStarvationChaos as JaxStarvation
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.guardian import Guardian
from deepspeed_tpu_torch.serving.server import (ServingAdmissionPausedError,
                                                ServingEngine)
from deepspeed_tpu_torch.telemetry import obs_server as tobs
from deepspeed_tpu_torch.telemetry import slo as tslo
from deepspeed_tpu_torch.telemetry.metrics import MetricsRegistry
from deepspeed_tpu_torch.testing.chaos import PoolStarvationChaos
from tests.test_torch_serving_parity import tiny_pair
from tests.torch_threads import one_torch_thread  # noqa: F401

OBS_MODEL = dict(vocab_size=256, n_positions=64, n_embd=32, n_head=2)
SIDES = {
    "jax": dict(Engine=JaxServingEngine, Guardian=JaxGuardian,
                Registry=JaxRegistry, Paused=JaxPausedError,
                Starvation=JaxStarvation, slo=jslo, obs=jobs,
                Config=JaxConfig),
    "port": dict(Engine=ServingEngine, Guardian=Guardian,
                 Registry=MetricsRegistry, Paused=ServingAdmissionPausedError,
                 Starvation=PoolStarvationChaos, slo=tslo, obs=tobs,
                 Config=DeepSpeedConfig)}


@pytest.fixture(scope="module")
def engines():
    jeng, teng, _ = tiny_pair(**OBS_MODEL)
    return {"jax": jeng, "port": teng}


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def _server(side, eng, tmp, guardian=None, slo=None, obs_server=None,
            **over):
    d = os.path.join(tmp, side)
    os.makedirs(d, exist_ok=True)
    obs = {"enabled": True, "window": 2, "warmup_windows": 0,
           "queue_growth_windows": 1, "ttft_slo_ms": 1e9,
           "snapshot_file": os.path.join(d, "SERVING.json")}
    obs.update(over.pop("observability", {}))
    conf = dict({"max_batch": 2, "block_size": 8, "observability": obs},
                **over)
    S = SIDES[side]
    return S["Engine"](eng, config=conf, registry=S["Registry"](),
                       guardian=guardian, slo=slo, obs_server=obs_server)


def _guardian(side, tmp, **kw):
    kw.setdefault("action_cooldown_steps", 0)
    return SIDES[side]["Guardian"](
        enabled=True, journal_path=os.path.join(tmp, side, "GUARDIAN.json"),
        log_fn=lambda *a: None, **kw)


def _actions(g):
    return [(a["action"], a["rule"], a["step"], a["outcome"])
            for a in g.actions]


def _overload_cycle(side, eng, tmp):
    S = SIDES[side]
    g = _guardian(side, tmp, resume_clear_steps=3)
    srv = _server(side, eng, tmp, guardian=g)
    rng = np.random.default_rng(2)

    def submit():
        return srv.submit(rng.integers(0, 256, (6,)), max_new_tokens=2)

    chaos = S["Starvation"](srv.cache.allocator, hold_frac=1.0)
    chaos.install()
    accepted, refused = [], []
    try:
        for _ in range(16):
            if srv._admission_pause_rule is not None:
                break
            accepted.append(submit())
            srv.step()
        pause_step = srv._serving_steps
        gauge_paused = srv.registry.gauge("serving_admission_paused").value
        with pytest.raises(S["Paused"]) as ei:
            submit()
        refused.append(ei.value.rule)
    finally:
        chaos.uninstall()
    outs = {o.req_id: o for o in srv.serve_forever()}
    assert set(outs) == set(accepted)
    for _ in range(20):
        if srv._admission_pause_rule is None:
            break
        srv.step()
    quiet_step = srv._serving_steps
    rid = submit()
    after = srv.serve_forever()
    srv.close()
    return {"pause_step": pause_step, "quiet_step": quiet_step,
            "refused": refused, "accepted": accepted,
            "gauges": (gauge_paused, srv.registry.gauge(
                "serving_admission_paused").value),
            "actions": _actions(g), "paused": g.admission_paused,
            "tokens": {r: (outs[r].tokens, outs[r].finish_reason)
                       for r in accepted},
            "after": [(o.req_id == rid, o.tokens) for o in after],
            "rejected": srv.registry.counter(
                "serving_requests_rejected_total",
                labels={"reason": "admission_paused"}).value}


def test_overload_cycle_equals_jax(engines, tmp_path):
    got = {side: _overload_cycle(side, eng, str(tmp_path))
           for side, eng in engines.items()}
    assert got["port"] == got["jax"]
    run = got["port"]
    assert run["refused"] == ["queue_growth"] and run["rejected"] == 1
    assert run["gauges"] == (1, 0) and not run["paused"]
    assert [a[0] for a in run["actions"]] == ["serving_pause",
                                              "serving_resume"]
    # paused at the step that saw the growth; resumed 3 quiet steps
    # after the last overload firing, while the backlog drained
    assert run["pause_step"] == run["actions"][0][2]
    assert run["pause_step"] < run["actions"][1][2] <= run["quiet_step"]
    with open(tmp_path / "port" / "GUARDIAN.json") as f:
        assert json.load(f)["action_counts"] == {"serving_pause": 1,
                                                 "serving_resume": 1}


def _slo_page(side, eng, tmp):
    S = SIDES[side]
    tcfg = S["Config"]({"train_batch_size": 8, "telemetry": {
        "enabled": True, "slo": {"enabled": True, "fast_window_s": 5,
                                 "slow_window_s": 20,
                                 "eval_interval_s": 1.0,
                                 "ttft_threshold_ms": 100}}}).telemetry
    reg = S["Registry"]()
    mon = S["slo"].SloMonitor.from_config(
        tcfg, output_path=os.path.join(tmp, side), registry=reg)
    ticks = iter(range(10 ** 6))
    mon._now_us = lambda: 10_000_000 + next(ticks) * 1_000_000
    g = _guardian(side, tmp)
    mon.on_anomaly = g.hook("slo")
    srv = S["Engine"](eng, config={"max_batch": 2, "block_size": 8},
                      registry=reg, guardian=g, slo=mon)
    objectives = sorted(o["name"] for o in mon.objectives)
    rng = np.random.default_rng(5)
    hist = reg.histogram("serving_ttft_ms", "submit -> first token")
    for _ in range(40):
        if srv._admission_pause_rule is not None:
            break
        hist.observe(5000.0)            # a late first token every step
        srv.submit(rng.integers(0, 256, (4,)), max_new_tokens=1)
        srv.step()
    srv.serve_forever()
    srv.close()
    return {"objectives": objectives, "rule": srv._admission_pause_rule,
            "actions": _actions(g), "rule_counts": dict(mon.rule_counts),
            "step": srv._serving_steps}


def test_slo_page_pauses_admission_like_jax(engines, tmp_path):
    got = {side: _slo_page(side, eng, str(tmp_path))
           for side, eng in engines.items()}
    assert got["port"] == got["jax"]
    assert got["port"]["objectives"] == ["serving_e2e", "serving_ttft"]
    assert got["port"]["rule"] == "slo_burn_page"
    assert got["port"]["actions"][0][:2] == ("serving_pause",
                                              "slo_burn_page")


def _spec_waste(side, eng, tmp):
    g = _guardian(side, tmp)
    srv = _server(side, eng, tmp, guardian=g,
                  speculative={"enabled": True, "k": 3, "draft_layers": 1,
                               "acceptance_floor": 1.0})
    plain = _server(side, eng, tmp)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, (int(n),)) for n in (5, 9, 3, 12)]
    toks = {}
    for name, s in (("spec", srv), ("plain", plain)):
        rids = [s.submit(p, max_new_tokens=12) for p in prompts]
        outs = {o.req_id: o.tokens for o in s.serve_forever()}
        toks[name] = [outs[r] for r in rids]
        s.close()
    return {"actions": _actions(g), "tokens": toks,
            "disabled": srv._spec_disabled_rule,
            "gauge": srv.registry.gauge(
                "serving_speculation_disabled").value}


def test_speculation_waste_disables_once_like_jax(engines, tmp_path):
    got = {side: _spec_waste(side, eng, str(tmp_path))
           for side, eng in engines.items()}
    assert got["port"] == got["jax"]
    run = got["port"]
    assert [a[:2] for a in run["actions"]] == [
        ("serving_spec_disable", "speculation_waste")]
    assert run["disabled"] == "speculation_waste" and run["gauge"] == 1
    assert run["tokens"]["spec"] == run["tokens"]["plain"]


def test_obs_server_serves_the_serving_report(engines, tmp_path):
    srv_http = tobs.ObsServer(registry=MetricsRegistry())
    try:
        srv = _server("port", engines["port"], str(tmp_path),
                      obs_server=srv_http)
        srv.submit(np.arange(1, 6), max_new_tokens=2)
        srv.serve_forever()
        with urllib.request.urlopen(srv_http.url + "/api/report/serving",
                                    timeout=10) as r:
            doc = json.loads(r.read())
        assert doc["schema"] == "deepspeed_tpu.serving_health/3"
        assert doc["counters"]["requests_finished"] == {"max_tokens": 1}
        assert srv_http.providers() == ["serving"]
        srv.close()
        assert srv_http.providers() == []
    finally:
        srv_http.close()
