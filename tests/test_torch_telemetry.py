"""The port's telemetry plane (the telemetry manager and its sinks, the
monitor and the breakdown and throughput timers) against the JAX
package's, on the CPU.

Both engines train the oracle's tiny GPT-2 (bridged flax init, AdamW
with a clip that fires) for 4 steps at ``steps_per_print`` 2 with
``telemetry`` (trace, JSONL, Prometheus, compile watch), ``tensorboard``
and ``wall_clock_breakdown`` on. The TensorBoard writer is made to fail
in both packages, so both fall back to CSV as the JAX monitor does. The
JSONL files must hold the same event names at the same steps, the loss,
lr, loss-scale and skipped-step values within the engine parity
tolerance (rtol = atol = 1e-5) and the breakdown timings positive; the
``.prom`` files the same families (the compile watch's
``xla_compiles_total`` is the port's ``program_signatures_total``; the
JAX backend-compile listener's ``xla_*`` counters have no counterpart,
the port compiles nothing); the CSV files the same
names and rows. The timers and the manager are held to JAX on their
own too.
"""

import csv
import json
import os

import jax
import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.monitor import monitor as jmonitor
from deepspeed_tpu.telemetry import metrics as jmetrics
from deepspeed_tpu.telemetry import tracer as jtracer
from deepspeed_tpu.utils import groups
from deepspeed_tpu.utils import timer as jtimer
from deepspeed_tpu_torch.bridge import flax_to_state_dict
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.monitor import monitor as tmonitor
from deepspeed_tpu_torch.telemetry import manager as tmanager
from deepspeed_tpu_torch.telemetry import metrics as tmetrics
from deepspeed_tpu_torch.telemetry import tracer as ttracer
from deepspeed_tpu_torch.utils import timer as ttimer
from tests.model import oracle
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
STEPS = 4
TIMING = ("Train/Samples/elapsed_time_ms_forward",
          "Train/Samples/elapsed_time_ms_backward",
          "Train/Samples/elapsed_time_ms_step")


def _config(root):
    return {"train_batch_size": oracle.BATCH_SIZE, "steps_per_print": 2,
            "optimizer": {"type": "AdamW", "params": {
                "lr": 2e-3, "weight_decay": 0.01}},
            "gradient_clipping": 0.5,
            "telemetry": {"enabled": True, "output_path": root,
                          "job_name": "run"},
            "tensorboard": {"enabled": True, "output_path": root,
                            "job_name": "tb"},
            "wall_clock_breakdown": True}


def _no_tensorboard(*a, **k):
    raise ImportError("no tensorboard")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both engines' files after 4 steps: {side: (root, losses)}."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jmonitor.TensorBoardMonitor, "__init__", _no_tensorboard)
    mp.setattr(tmonitor.TensorBoardMonitor, "__init__", _no_tensorboard)
    root = tmp_path_factory.mktemp("telemetry")
    batches = [{"input_ids": np.array(b["input_ids"])}
               for b in oracle.make_batches(STEPS)]
    out = {}
    # the JAX manager leaves its registry and tracer installed after close
    saved = (jmetrics.get_registry(), jtracer.get_tracer())
    try:
        groups.destroy()
        groups.initialize(devices=jax.devices()[:1])
        jdir = str(root / "jax")
        jeng, *_ = deepspeed_tpu.initialize(
            model=jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(
                **oracle.TINY)), config=_config(jdir),
            sample_batch=batches[0], seed=oracle.SEED)
        init = flax_to_state_dict(jax.tree.map(np.asarray,
                                               jeng.state.params))
        out["jax"] = (jdir, [float(jeng.train_batch(batch=b))
                             for b in batches])
        jeng.close()
        jeng.monitor.close()
        tdir = str(root / "port")
        teng, *_ = deepspeed_tpu_torch.initialize(
            model=gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu"),
            config=_config(tdir), model_parameters=init, device="cpu")
        assert teng.telemetry.enabled and teng.wall_clock_breakdown()
        assert [type(m).__name__ for m in teng.monitor.monitors] == [
            "CSVMonitor", "JSONLMonitor", "PrometheusMonitor"]
        out["port"] = (tdir, [float(teng.train_batch(batch=b))
                              for b in batches])
        assert tmanager.get_manager() is teng.telemetry
        teng.close()
        assert tmanager.get_manager() is None
        assert not ttracer.get_tracer().enabled
    finally:
        mp.undo()
        jmetrics.set_registry(saved[0])
        jtracer.set_tracer(saved[1])
    return out


def _jsonl(root):
    with open(os.path.join(root, "run.jsonl")) as f:
        return [json.loads(line) for line in f]


def _prom_families(root):
    with open(os.path.join(root, "run.prom")) as f:
        return {line.split()[2] for line in f if line.startswith("# TYPE")}


def test_losses_match(runs):
    np.testing.assert_allclose(runs["port"][1], runs["jax"][1], **TOL)


def test_jsonl_events_match_jax(runs):
    ev = {side: _jsonl(root) for side, (root, _) in runs.items()}
    keys = {side: [(e["event"], e["name"], e["step"]) for e in evs]
            for side, evs in ev.items()}
    assert keys["port"] == keys["jax"]
    assert {n for _, n, _ in keys["port"]} >= set(TIMING) | {
        "Train/Samples/train_loss", "Train/Samples/lr",
        "Train/Samples/loss_scale", "Train/Samples/skipped_steps"}
    assert sorted({s for *_, s in keys["port"]}) == [
        2 * oracle.BATCH_SIZE, 4 * oracle.BATCH_SIZE]
    for a, b in zip(ev["port"], ev["jax"]):
        if a["name"] in TIMING:
            assert a["value"] > 0 and b["value"] > 0
        else:
            np.testing.assert_allclose(a["value"], b["value"],
                                       err_msg=a["name"], **TOL)


def test_prometheus_families_match_jax(runs):
    fams = {side: _prom_families(root) for side, (root, _) in runs.items()}
    # the compile watch counts program signatures in the port (its
    # xla_compiles_total); the backend-compile listener has no counterpart
    renamed = {"xla_compiles_total": "program_signatures_total"}
    want = {renamed.get(f, f) for f in fams["jax"]
            if not f.startswith("xla_") or f in renamed}
    assert fams["port"] == want
    assert {"train_steps_total", "train_loss", "train_grad_norm",
            "deepspeed_scalar", "timer_forward_ms",
            "program_signatures_total"} <= fams["port"]


def test_csv_and_files_match_jax(runs):
    names = {side: sorted(os.listdir(root)) for side, (root, _) in
             runs.items()}
    assert names["port"] == names["jax"] == [
        "run.jsonl", "run.prom", "run.trace.json", "tb.csv"]
    rows = {}
    for side, (root, _) in runs.items():
        with open(os.path.join(root, "tb.csv")) as f:
            rows[side] = list(csv.reader(f))
    assert [r[:2] for r in rows["port"]] == [r[:2] for r in rows["jax"]]
    assert rows["port"][0] == ["step", "name", "value"]
    with open(os.path.join(runs["port"][0], "run.trace.json")) as f:
        trace = json.load(f)
    spans = {e["name"] for e in trace["traceEvents"]}
    assert {"train_batch", "forward", "backward", "step"} <= spans


def test_timers_match_jax(monkeypatch):
    logged = {}
    for side, mod in (("jax", jtimer), ("port", ttimer)):
        lines = []
        t = mod.ThroughputTimer(batch_size=8, start_step=2,
                                steps_per_output=2, logging_fn=lines.append)
        assert t.avg_samples_per_sec() == 0.0
        for _ in range(6):
            t.start()
            t.stop(global_step=True)
        timers = mod.SynchronizedWallClockTimer()
        timers("a").start()
        timers("a").stop(record=True)
        means = timers.get_mean(["a", "missing"], normalizer=2)
        logged[side] = (len(lines), t.global_step_count, t.micro_step_count,
                        sorted(means), timers.has_timer("a"))
    assert logged["port"] == logged["jax"]
    assert tmetrics.get_registry().histogram(
        "timer_a_ms", "SynchronizedWallClockTimer recorded intervals").count


def test_manager_disabled_and_rank_gating(tmp_path):
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    cfg = DeepSpeedConfig({"train_batch_size": 8, "telemetry": {
        "enabled": True, "output_path": str(tmp_path / "t")}}).telemetry
    off = tmanager.TelemetryManager(cfg, rank=1)
    assert not off.enabled and off.registry is None
    assert off.wrap_compiled(len, "x") is len
    off.flush()
    off.close()
    assert not os.path.exists(tmp_path / "t")
    on = tmanager.TelemetryManager(cfg, rank=0, device="cpu")
    try:
        assert tmanager.get_manager() is on
        assert tmetrics.get_registry() is on.registry
        with on.span("s", k=1):
            pass
        on.publish_device_memory()
        fams = on.registry.snapshot()
        assert fams["device_memory_host_rss_bytes"][0]["labels"] == {
            "source": "host"}
        on.flush()
        assert os.path.exists(on.trace_path)
        mtime = os.path.getmtime(on.trace_path)
        with on.span("t"):
            pass
        on.flush()           # throttled: within 5 s of the last export
        assert os.path.getmtime(on.trace_path) == mtime
    finally:
        on.close()
    assert tmanager.get_manager() is None
    assert tmetrics.get_registry() is not on.registry
    with open(on.trace_path) as f:
        assert {e["name"] for e in json.load(f)["traceEvents"]} == {"s",
                                                                    "t"}
