"""The port's HTTP obs server against the JAX package's, on the CPU.

Both packages' ``ObsServer`` run on 127.0.0.1 (port 0) over registries
filled with the same contents (counters, labelled gauges whose values
need escaping, histograms with and without observations, two families
that sanitize to one name). ``/metrics`` must be byte-equal to the JAX
server's and to the JAX ``render_prometheus``; the JSON routes
(``/healthz`` and ``/readyz`` with the uptime dropped, the report routes,
a non-finite report, the 404 inventories, ``/api/events`` over chronicles
holding the same events) equal; a token refused and accepted route by
route as in JAX; the identity labels and ``add_route`` as in JAX; and
after ``close`` the serving thread is gone and the port released. A
port engine armed from the config serves its ``guardian`` and ``slo``
reports and its training metrics.
"""

import json
import socket
import threading
import urllib.error
import urllib.request

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.telemetry import chronicle as jchron
from deepspeed_tpu.telemetry import obs_server as jobs
from deepspeed_tpu.telemetry.metrics import MetricsRegistry as JaxRegistry
from deepspeed_tpu.telemetry.sinks import render_prometheus as jax_render
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.telemetry import chronicle as tchron
from deepspeed_tpu_torch.telemetry import obs_server as tobs
from deepspeed_tpu_torch.telemetry.metrics import MetricsRegistry
from deepspeed_tpu_torch.telemetry.sinks import render_prometheus
from tests.torch_threads import one_torch_thread  # noqa: F401

SIDES = {"jax": (jobs, JaxRegistry, jchron), "port": (tobs, MetricsRegistry,
                                                       tchron)}
TOKEN = "s3cret"


def _get(url, token=None):
    req = urllib.request.Request(url)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type", "")


def _json(url, token=None):
    status, body, _ = _get(url, token)
    doc = json.loads(body, parse_constant=lambda tok: pytest.fail(
        f"{url} answered a bare {tok}"))
    for key in ("uptime_s",):
        doc.pop(key, None)
    return status, doc


def _assert_port_free(port):
    """Nothing listens on ``port`` (a closed connection's TIME_WAIT does
    not count: SO_REUSEADDR binds past it, never past a listener)."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))


def _fill(reg):
    reg.counter("requests_total", "served requests",
                labels={"route": 'a"b\\c\nd'}).inc(3)
    reg.gauge("queue_depth", "waiting\nrequests").set(2.5)
    reg.gauge("x/y", "sanitizes to x_y").set(1)
    reg.gauge("x.y", "collides with x/y").set(2)
    reg.gauge("special", "non-finite").set(float("inf"))
    h = reg.histogram("ttft_ms", "first token", buckets=(1, 10, 100))
    for v in (0.5, 3, 3, 40, 400):
        h.observe(v)
    reg.histogram("empty_ms", "no observations")
    return reg


@pytest.fixture
def servers():
    out = {}
    for side, (mod, Registry, _) in SIDES.items():
        out[side] = mod.ObsServer(registry=_fill(Registry()))
    yield out
    for srv in out.values():
        srv.close()


def test_metrics_byte_equal_to_jax(servers):
    bodies = {}
    for side, srv in servers.items():
        status, body, ctype = _get(srv.url + "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        bodies[side] = body
    assert bodies["port"] == bodies["jax"]
    assert bodies["port"].decode() == jax_render(_fill(JaxRegistry())) \
        == render_prometheus(_fill(MetricsRegistry()))
    text = bodies["port"].decode()
    assert 'requests_total{route="a\\"b\\\\c\\nd"} 3' in text
    assert "ttft_ms_summary" in text and "empty_ms_summary" not in text


def test_identity_labels_equal_to_jax():
    texts = {}
    for side, (mod, Registry, _) in SIDES.items():
        srv = mod.ObsServer(registry=_fill(Registry()),
                            identity={"rank": "3"})
        try:
            texts[side] = _get(srv.url + "/metrics")[1]
        finally:
            srv.close()
    assert texts["port"] == texts["jax"]
    assert b'rank="3"' in texts["port"]


def test_json_routes_equal_to_jax(servers):
    got = {}
    for side, srv in servers.items():
        seen = [_json(srv.url + "/healthz"), _json(srv.url + "/readyz")]
        srv.register("slo", lambda: {"schema": "x", "tier": "ok"},
                     age_s_fn=lambda: 1.25)
        srv.register("memory", lambda: {"drift": float("nan"),
                                        "peak": float("inf")})
        srv.register("broken", lambda: 1 / 0)
        srv.add_route("/extra", lambda path, q: {"path": path,
                                                 "q": q.get("a")})
        srv.add_route("/pre/", lambda path, q: (202, b"raw", "text/plain"),
                      prefix=True)
        for route in ("/healthz", "/readyz", "/api/report/slo",
                      "/api/report/memory", "/api/report/nope", "/bogus",
                      "/extra?a=1", "/api/report/broken"):
            seen.append(_json(srv.url + route))
        seen.append(_get(srv.url + "/pre/x")[:2])
        srv.unregister("slo")
        seen.append(_json(srv.url + "/api/report/slo"))
        rep = srv.report()
        for key in ("url", "port", "uptime_s"):
            rep.pop(key)
        seen.append(rep)
        got[side] = seen
    assert got["port"] == got["jax"]
    assert got["port"][0][1]["ready"] is False and got["port"][1][0] == 503
    assert got["port"][3][0] == 200
    assert got["port"][5][1] == {"drift": "nan", "peak": "inf"}
    assert got["port"][9][0] == 500


def test_events_route_equals_jax(servers):
    got = {}
    for side, srv in servers.items():
        chron_mod = SIDES[side][2]
        ch = chron_mod.RunChronicle(background=False)
        old = chron_mod.set_chronicle(ch)
        try:
            seen = []
            for i in range(6):
                ch.emit("serving", source="serving", step=i, event="e",
                        severity="info")
            for q in ("", "?since_seq=2", "?since_seq=1&limit=2",
                      "?since_seq=0&limit=2&oldest=1", "?since_seq=x"):
                status, doc = _json(srv.url + "/api/events" + q)
                for e in doc.get("events", []):
                    e.pop("t_us")
                    e.pop("unix_us")
                seen.append((status, doc))
        finally:
            chron_mod.set_chronicle(old)
            ch.close()
        seen.append(_json(srv.url + "/api/events"))
        got[side] = seen
    assert got["port"] == got["jax"]
    assert got["port"][1][1]["n"] == 3
    assert got["port"][-1][1] == {"enabled": False, "events": [],
                                  "last_seq": -1}


def test_token_refused_and_accepted_as_in_jax():
    got = {}
    for side, (mod, Registry, _) in SIDES.items():
        srv = mod.ObsServer(registry=_fill(Registry()), token=TOKEN)
        srv.register("slo", lambda: {"ok": True})
        try:
            got[side] = [(route, tok, _get(srv.url + route, tok)[0])
                         for route in ("/metrics", "/healthz", "/readyz",
                                       "/api/report/slo", "/api/events")
                         for tok in (None, "wrong", TOKEN)]
        finally:
            srv.close()
    assert got["port"] == got["jax"]
    status = {(r, t): s for r, t, s in got["port"]}
    assert status[("/metrics", None)] == status[("/metrics", "wrong")] \
        == 401 and status[("/metrics", TOKEN)] == 200
    assert status[("/healthz", None)] == 200


def test_close_leaves_no_thread_and_frees_the_port():
    srv = tobs.ObsServer(registry=MetricsRegistry())
    name = f"ds-obs-server-{srv.port}"
    assert any(t.name == name for t in threading.enumerate())
    assert _get(srv.url + "/healthz")[0] == 200
    srv.close()
    srv.close()                                  # idempotent
    assert not any(t.name == name for t in threading.enumerate())
    _assert_port_free(srv.port)
    assert srv.report()["closed"] is True
    # a failed bind raises
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        with pytest.raises(OSError):
            tobs.ObsServer(port=s.getsockname()[1])


def test_global_handle_and_announce(tmp_path):
    srv = tobs.ObsServer(registry=MetricsRegistry())
    try:
        assert tobs.set_obs_server(srv) is None
        assert tobs.get_obs_server() is srv
        tobs.reset_obs_server(if_current=object())
        assert tobs.get_obs_server() is srv
        tobs.reset_obs_server(if_current=srv)
        assert tobs.get_obs_server() is None
        path = srv.announce(str(tmp_path), rank=2, job_name="j")
        with open(path) as f:
            doc = json.load(f)
        assert doc["url"] == srv.url and doc["rank"] == 2
        assert path.endswith("peers/peer_rank_00002.json")
    finally:
        srv.close()


def test_engine_serves_its_reports(tmp_path):
    """A port engine armed from the config: the server's providers are
    the guardian's and the SLO monitor's reports, /metrics carries the
    training metrics, and close() stops the server."""
    cfg = {"train_batch_size": 8, "steps_per_print": 2,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "telemetry": {"enabled": True, "output_path": str(tmp_path),
                         "trace": False, "jsonl": False,
                         "prometheus": False,
                         "server": {"enabled": True, "token": TOKEN},
                         "slo": {"enabled": True}},
           "guardian": {"enabled": True}}
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu"),
        config=cfg, device="cpu")
    srv = eng._obs_server
    try:
        assert tobs.get_obs_server() is srv
        assert srv.providers() == ["guardian", "slo"]
        batch = gpt2.synthetic_batch(8, 16, 512, seed=0, device="cpu")
        for _ in range(2):
            eng.train_batch(batch=batch)
        status, body, _ = _get(srv.url + "/metrics", TOKEN)
        assert status == 200
        assert "train_steps_total 2" in body.decode()
        assert "train_loss " in body.decode()
        status, doc = _json(srv.url + "/api/report/guardian", TOKEN)
        assert status == 200 and doc["schema"] == "deepspeed_tpu.guardian/1"
        status, doc = _json(srv.url + "/healthz")
        assert set(doc["monitors"]) == {"guardian", "slo"}
    finally:
        eng.close()
    assert tobs.get_obs_server() is None
    _assert_port_free(srv.port)
    assert torch.get_num_threads() == 1
