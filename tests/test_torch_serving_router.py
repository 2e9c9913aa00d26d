"""The port's ``ServingRouter`` against the JAX package's, on the CPU.

JAX's ``tiny_engine`` model (vocab 256, 2 layers, n_embd 32, fp32,
seeded flax weights bridged to the port). Replicas are ``ServingEngine``
instances of one inference engine with the prefix cache on, each with
its own KV pool. The same request streams — three 16-token system
prompts with seeded tails, one warm-up request per prompt served to
completion, then the rest submitted in bursts between steps — go to 2
and 3 replicas in each package. Every ``RouteDecision`` (replica,
affinity blocks, scores to 1e-9), the re-stamped outputs, ``stats()``
and the chronicle's ``router`` events must be equal. JAX's affinity and
failover cases (tests/unit/test_prefix_cache.py:494-546) run on both
packages, their snapshot files under ``tmp_path``.

An autouse fixture makes ``tmp_path`` the working directory.
"""

import os

import numpy as np
import pytest

from deepspeed_tpu.runtime.config import \
    DeepSpeedServingConfig as JaxServingConfig
from deepspeed_tpu.serving.router import ServingRouter as JaxRouter
from deepspeed_tpu.serving.server import ServingEngine as JaxServingEngine
from deepspeed_tpu.telemetry import chronicle as jchron
from deepspeed_tpu.telemetry.metrics import MetricsRegistry as JaxRegistry
from deepspeed_tpu_torch.runtime.config import DeepSpeedServingConfig
from deepspeed_tpu_torch.serving import RouteDecision, ServingRouter
from deepspeed_tpu_torch.serving.server import ServingEngine
from deepspeed_tpu_torch.telemetry import chronicle as tchron
from deepspeed_tpu_torch.telemetry.metrics import MetricsRegistry
from tests.test_torch_serving_parity import tiny_pair
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY_ENGINE = dict(vocab_size=256, n_positions=64, n_embd=32, n_head=2)
SIDES = {"jax": (JaxServingEngine, JaxRegistry, JaxRouter, jchron),
         "port": (ServingEngine, MetricsRegistry, ServingRouter, tchron)}


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


@pytest.fixture(scope="module")
def engines():
    jeng, teng, _ = tiny_pair(**TINY_ENGINE)
    return {"jax": jeng, "port": teng}


def _replica(side, eng, **over):
    Engine, Registry, _, _ = SIDES[side]
    cfg = {"max_batch": 2, "block_size": 8, "prefill_chunk": 6,
           "prefix_cache": {"enabled": True}, **over}
    return Engine(eng, config=cfg, registry=Registry())


def _stream(seed, n_prefix=3, per_prefix=4):
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, 256, 16) for _ in range(n_prefix)]
    reqs = []
    for i in range(per_prefix):
        for h in heads:
            tail = rng.integers(0, 256, int(rng.integers(1, 12)))
            reqs.append((np.concatenate([h, tail]).astype(np.int32),
                         int(rng.integers(2, 8))))
    return reqs, n_prefix


def _decision(d):
    if d.__class__.__module__.startswith("deepspeed_tpu_torch"):
        assert isinstance(d, RouteDecision)
    return (d.replica, d.affinity_blocks, d.score, list(d.scores))


def _drive(router, reqs, warm):
    """Warm-up: one request per prefix, served to completion; then the
    rest in bursts of three submits between two steps."""
    decisions, outs = [], []
    for p, g in reqs[:warm]:
        router.submit(p, max_new_tokens=g)
        decisions.append(_decision(router.last_decision))
    outs += router.serve_forever()
    rest = reqs[warm:]
    for i in range(0, len(rest), 3):
        for p, g in rest[i:i + 3]:
            router.submit(p, max_new_tokens=g)
            decisions.append(_decision(router.last_decision))
        router.step()
        router.step()
        outs += router.collect()
    outs += router.serve_forever()
    return decisions, [(o.req_id, o.tokens, o.finish_reason, o.preemptions)
                       for o in outs]


def _close_scores(a, b):
    assert [x[:2] for x in a] == [x[:2] for x in b]
    for (_, _, sa, la), (_, _, sb, lb) in zip(a, b):
        assert sa == pytest.approx(sb, abs=1e-9)
        assert la == pytest.approx(lb, abs=1e-9)


@pytest.mark.parametrize("n_replicas,obs", [(2, False), (3, False),
                                            (2, True)])
def test_router_stream_equals_jax(engines, tmp_path, n_replicas, obs):
    reqs, warm = _stream(seed=n_replicas)
    got = {}
    for side, (_, _, Router, chron_mod) in SIDES.items():
        over = {}
        if obs:
            over["observability"] = {
                "enabled": True, "window": 4, "warmup_windows": 0,
                "ttft_slo_ms": 1e9, "trace_lanes": False}
        reps = []
        for i in range(n_replicas):
            if obs:
                over["observability"]["snapshot_file"] = str(
                    tmp_path / side / f"replica{i}.json")
            reps.append(_replica(side, engines[side], **over))
        router = Router(reps)
        ch = chron_mod.RunChronicle(background=False)
        old = chron_mod.set_chronicle(ch)
        try:
            decisions, outs = _drive(router, reqs, warm)
        finally:
            chron_mod.set_chronicle(old)
        events = [{k: v for k, v in e.items()
                   if k not in ("t_us", "unix_us")}
                  for e in ch.snapshot_events()]
        ch.close()
        got[side] = (decisions, outs, router.stats(),
                     list(router.routed_by_replica), events)
        router.close()
    (jd, jo, js, jr, je), (td, to, ts, tr, te) = got["jax"], got["port"]
    _close_scores(td, jd)
    assert to == jo
    assert ts == js
    assert tr == jr
    assert [e for e in te if e["source"] == "router"] == \
        [e for e in je if e["source"] == "router"]
    assert te == je
    # the stream exercised both terms: affinity placed the later
    # requests of a prefix, and more than one replica served
    assert max(a for _, a, _, _ in td) == 2
    assert sum(1 for n in tr if n) > 1
    assert sorted(r for r, *_ in to) == list(range(len(reqs)))
    assert ts["pending"] == 0


def test_router_prefers_prefix_affinity(engines):
    got = {}
    for side, (_, _, Router, _) in SIDES.items():
        replicas = [_replica(side, engines[side]),
                    _replica(side, engines[side])]
        router = Router(replicas)
        rng = np.random.default_rng(13)
        prefix = rng.integers(0, 256, (16,)).astype(np.int32)
        replicas[1].submit(np.concatenate(
            [prefix, rng.integers(0, 256, (4,)).astype(np.int32)]),
            max_new_tokens=2)
        while replicas[1].scheduler.has_work():
            replicas[1].step()
        replicas[1].collect()
        d = router.explain(list(np.concatenate([prefix, [1, 2, 3]])))
        rid = router.submit(np.concatenate(
            [prefix, rng.integers(0, 256, (5,)).astype(np.int32)]),
            max_new_tokens=3)
        outs = {o.req_id: o for o in router.serve_forever()}
        got[side] = (_decision(d), rid, outs[rid].tokens,
                     list(router.routed_by_replica))
    assert got["port"][0][:2] == (1, 2)
    assert got["port"][3] == [0, 1]
    _close_scores([got["port"][0]], [got["jax"][0]])
    assert got["port"][1:] == got["jax"][1:]


def test_router_fails_over_on_ttft_slo_breach(engines, tmp_path):
    """A replica whose observatory fired ttft_slo_breach recently loses
    the routing even with the whole prefix — unless every replica
    breaches (failover, not a blacklist)."""
    got = {}
    for side, (_, _, Router, _) in SIDES.items():
        breaching = _replica(side, engines[side], observability={
            "enabled": True, "window": 2, "warmup_windows": 0,
            "ttft_slo_ms": 1e-6, "ttft_breach_frac": 0.5,
            "trace_lanes": False,
            "snapshot_file": str(tmp_path / side / "breach.json")})
        healthy = _replica(side, engines[side])
        router = Router([breaching, healthy])
        rng = np.random.default_rng(17)
        prefix = rng.integers(0, 256, (16,)).astype(np.int32)
        breaching.submit(np.concatenate(
            [prefix, rng.integers(0, 256, (4,)).astype(np.int32)]),
            max_new_tokens=4)
        while breaching.scheduler.has_work():
            breaching.step()
        breaching.collect()
        sig = (breaching.router_signals()["ttft_slo_breach"],
               healthy.router_signals()["ttft_slo_breach"])
        d = router.explain(list(np.concatenate([prefix, [1, 2]])))
        all_bad = router.explain(list(prefix))
        breaching.close()
        assert os.path.exists(tmp_path / side / "breach.json")
        got[side] = (sig, _decision(d), _decision(all_bad))
    assert got["port"][0] == (True, False)
    assert got["port"][1][0] == 1
    assert got["port"][2][3][0] < 0
    assert got["port"][0] == got["jax"][0]
    _close_scores([got["port"][1], got["port"][2]],
                  [got["jax"][1], got["jax"][2]])


def test_router_config_parse_equals_jax():
    block = {"serving": {"router": {"replicas": 3, "affinity_weight": 2,
                                    "queue_weight": 0.5,
                                    "breach_penalty": 50}}}
    assert vars(DeepSpeedServingConfig(block).router) == \
        vars(JaxServingConfig(block).router)
    with pytest.raises(ValueError):
        ServingRouter([])
