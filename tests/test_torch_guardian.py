"""The port's guardian against the JAX package's, on the CPU.

Units: the JAX unit tests' scenarios (tests/unit/test_guardian.py) feed
the same anomaly sequences to both packages' ``Guardian`` with stub
actions; the journals (``report()``, the actions' clock stamps dropped),
the written ``GUARDIAN.json`` files and the stubs' calls must be
identical.

Engines: ``SimpleModel`` (hidden 32, 2 layers) under fp16 with a dynamic
loss scale, the port's engine and the JAX engine from the same bridged
flax init, each with the guardian armed: 3 steps, a user tag, 3 steps
recorded, the ``loss_spike`` + ``nonfinite_grads`` streak notified, one
step (which rolls back to the user tag, its data position included),
then the 3 steps replayed. The port's replay is bit-equal to its
recorded steps; its losses agree with the JAX engine's at rtol = atol =
1e-3 (fp16 compute: the forward and the gradients round to half
precision at different points in XLA and in torch). The fp16 rescue
sets the same loss scale in both engines, and an emergency tag the port
writes loads into the JAX engine (masters within fp32 round-off).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import simple as jax_simple
from deepspeed_tpu.runtime import guardian as jguardian
from deepspeed_tpu.runtime.dataloader import RepeatingLoader as JaxLoader
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.bridge import simple_flax_to_state_dict
from deepspeed_tpu_torch.models import simple
from deepspeed_tpu_torch.runtime import guardian as tguardian
from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
from tests.torch_threads import one_torch_thread  # noqa: F401

HIDDEN = 32
LOSS_TOL = dict(rtol=1e-3, atol=1e-3)
MODS = {"jax": jguardian, "port": tguardian}


def _anom(rule, step, **kw):
    return dict({"rule": rule, "step": step, "severity": "warning"}, **kw)


def _diverge(g, step):
    g.notify("health", [_anom("nonfinite_grads", step),
                        _anom("loss_spike", step)])
    g.tick(step)


def _s_rollback_requires_streak_and_spike(g, calls):
    g.rollback_fn = lambda: calls.append("rollback") or "tag"
    g.notify("health", [_anom("loss_spike", 10)])
    g.tick(10)
    g.notify("health", [_anom("nonfinite_grads", 11)])
    g.tick(11)
    g.notify("health", [_anom("nonfinite_grads", 12),
                        _anom("loss_spike", 12)])
    g.tick(12)


def _s_evidence_expires(g, calls):
    g.divergence_window = 5
    g.rollback_fn = lambda: calls.append("rollback") or "tag"
    _diverge(g, 10)
    g.notify("health", [_anom("nonfinite_grads", 30)])
    g.tick(30)


def _s_cooldown_rearm(g, calls):
    g.divergence_streak, g.rollback_cooldown_steps, g.max_rollbacks = \
        1, 100, 5
    g.rollback_fn = lambda: calls.append("rollback") or "tag"
    for step in (10, 50, 111):
        _diverge(g, step)


def _s_bounded_by_max(g, calls):
    g.divergence_streak, g.rollback_cooldown_steps, g.max_rollbacks = \
        1, 1, 2
    g.rollback_fn = lambda: calls.append("rollback") or "tag"
    for step in (10, 20, 30, 40):
        _diverge(g, step)


def _s_emergency_first_firing(g, calls):
    g.emergency_rules = frozenset(("overflow_streak",))
    g.emergency_save_fn = lambda step: calls.append(step) or f"em_{step}"
    for src, rule, step in (("health", "overflow_streak", 5),
                            ("health", "overflow_streak", 9),
                            ("goodput", "goodput_regression", 12)):
        g.notify(src, [_anom(rule, step)])
        g.tick(step)


def _s_emergency_max_and_cooldown(g, calls):
    g.emergency_rules = frozenset(("r1", "r2", "r3"))
    g.max_emergency_checkpoints, g.action_cooldown_steps = 2, 10
    g.emergency_save_fn = lambda step: calls.append(step) or "t"
    for rule, step in (("r1", 5), ("r2", 7), ("r2", 20), ("r3", 30),
                       ("loss_stall", 50)):
        g.notify("health", [_anom(rule, step)])
        g.tick(step)


def _s_fp16_rescue_bounded(g, calls):
    g.max_fp16_rescues = 1
    g.fp16_rescue_fn = lambda: calls.append("rescue") or "scale reset"
    for step in (5, 6):
        g.notify("health", [_anom("loss_scale_collapse", step)])
        g.tick(step)


def _s_unwired_action_skipped(g, calls):
    g.divergence_streak = 1
    _diverge(g, 3)


def _s_throwing_action_fails(g, calls):
    g.divergence_streak = 1

    def bad():
        raise RuntimeError("no intact tag")
    g.rollback_fn = bad
    _diverge(g, 3)


def _s_serving_pause_resume(g, calls):
    g.resume_clear_steps = 3
    g.pause_fn = lambda rule: calls.append(("pause", rule))
    g.resume_fn = lambda: calls.append(("resume",))
    g.notify("serving", [_anom("queue_growth", 4)])
    g.serving_tick(4)
    g.notify("serving", [_anom("ttft_slo_breach", 5)])
    for step in (5, 6, 7, 8):
        g.serving_tick(step)
    g.notify("slo", [_anom("slo_burn_page", 9, severity="critical")])
    for step in range(9, 14):
        g.serving_tick(step)


def _s_speculation_disabled_once(g, calls):
    g.spec_disable_fn = lambda rule: calls.append(("spec", rule)) or "off"
    for step in (3, 4, 9):
        g.notify("serving", [_anom("speculation_waste", step)])
        g.serving_tick(step)


def _s_disabled_is_inert(g, calls):
    g.enabled = False
    g.rollback_fn = lambda: calls.append("rollback") or "tag"
    g.divergence_streak = 1
    _diverge(g, 3)
    g.serving_tick(3)


SCENARIOS = {f.__name__[3:]: f for f in (
    _s_rollback_requires_streak_and_spike, _s_evidence_expires,
    _s_cooldown_rearm, _s_bounded_by_max, _s_emergency_first_firing,
    _s_emergency_max_and_cooldown, _s_fp16_rescue_bounded,
    _s_unwired_action_skipped, _s_throwing_action_fails,
    _s_serving_pause_resume, _s_speculation_disabled_once,
    _s_disabled_is_inert)}


def _journal(doc):
    doc = json.loads(json.dumps(doc))
    for a in doc.get("actions", []):
        a.pop("t_us", None)
        a.pop("unix_time", None)
    return doc


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_journal_equals_jax(name, tmp_path):
    got = {}
    for side, mod in MODS.items():
        path = str(tmp_path / side / "GUARDIAN.json")
        g = mod.Guardian(action_cooldown_steps=0, journal_path=path,
                         log_fn=lambda *a: None)
        calls = []
        SCENARIOS[name](g, calls)
        g.close()
        written = None
        if os.path.exists(path):
            with open(path) as f:
                written = _journal(json.load(
                    f, parse_constant=lambda tok: pytest.fail(
                        f"bare {tok} in the journal")))
            assert sorted(os.listdir(tmp_path / side)) == ["GUARDIAN.json"]
        got[side] = (_journal(g.report()), written, calls,
                     g.admission_paused, mod.render(g.report()))
    assert got["port"] == got["jax"]
    report = got["port"][0]
    assert report["schema"] == tguardian.GUARDIAN_SCHEMA == \
        "deepspeed_tpu.guardian/1"
    counts = report["action_counts"]
    if name == "rollback_requires_streak_and_spike":
        assert counts == {"rollback": 1} and got["port"][2] == ["rollback"]
    if name == "cooldown_rearm":
        assert counts == {"rollback": 2}
    if name == "serving_pause_resume":
        assert counts == {"serving_pause": 2, "serving_resume": 2}
    if name == "speculation_disabled_once":
        assert counts == {"serving_spec_disable": 1}
    if name == "throwing_action_fails":
        assert report["actions"][-1]["outcome"].startswith("failed:")
    if name == "disabled_is_inert":
        assert got["port"][1] is None and not report["actions"]


def test_from_config_equals_jax(tmp_path):
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    for block in ({"enabled": True},
                  {"enabled": True, "journal_file": "/abs/G.json",
                   "emergency_rules": ["loss_stall"], "pause_rules": [],
                   "max_rollbacks": 0, "resume_clear_steps": 5}):
        cfg = {"train_batch_size": 8, "guardian": block}
        reports = []
        for Config, mod in ((JaxConfig, jguardian),
                            (DeepSpeedConfig, tguardian)):
            c = Config(json.loads(json.dumps(cfg)))
            g = mod.Guardian.from_config(c.guardian, output_path=str(
                tmp_path), job_name="j")
            reports.append((g.report(), g.journal_path))
        assert reports[0] == reports[1]


# ------------------------------------------------------------ engines
CONFIG = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
          "fp16": {"enabled": True, "loss_scale": 0,
                   "initial_scale_power": 8},
          "guardian": {"enabled": True, "action_cooldown_steps": 0,
                       "divergence_streak": 2,
                       "emergency_rules": ["overflow_streak"]}}


@pytest.fixture(scope="module")
def batches():
    """Ten seeded numpy batches."""
    # fp16 batches, the compute dtype's (fp32 batches train in both too:
    # tests/test_torch_simple_models.py holds the promotion)
    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((8, HIDDEN)).astype(np.float16),
                rng.standard_normal((8, HIDDEN)).astype(np.float16))
               for _ in range(10)]
    return batches


def _config(tmp, side):
    cfg = json.loads(json.dumps(CONFIG))
    cfg["guardian"]["journal_file"] = os.path.join(tmp, side, "G.json")
    return cfg


def _engines(tmp, batches):
    """The JAX engine, and the port's from the JAX engine's initial
    masters (bridged)."""
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(
        model=jax_simple.SimpleModel(hidden_dim=HIDDEN, nlayers=2),
        config=_config(tmp, "jax"), sample_batch=batches[0])
    init = simple_flax_to_state_dict(jax.tree.map(np.asarray,
                                                  jeng.state.params))
    peng, *_ = deepspeed_tpu_torch.initialize(
        model=simple.SimpleModel(HIDDEN, 2, device="cpu"),
        config=_config(tmp, "port"), model_parameters=init, device="cpu")
    return jeng, peng


def _torch_batches(batches):
    return [tuple(torch.from_numpy(a) for a in b) for b in batches]


def _rollback_run(eng, loader, ckpt):
    """3 steps, a user tag, 3 recorded steps, the streak, the step that
    rolls back, the 3 replayed steps. Returns (recorded, replayed, the
    step after the rollback, the guardian's report)."""
    for _ in range(3):
        eng.train_batch(data_iter=loader)
    eng.save_checkpoint(ckpt, tag="user", data_iter=loader)
    recorded = [float(eng.train_batch(data_iter=loader)) for _ in range(3)]
    s = eng.global_steps
    eng._guardian.notify("health", [
        {"rule": "nonfinite_grads", "step": s - 1, "severity": "critical"},
        {"rule": "nonfinite_grads", "step": s, "severity": "critical"},
        {"rule": "loss_spike", "step": s, "severity": "critical"}])
    eng.train_batch(data_iter=loader)
    after = eng.global_steps
    replayed = [float(eng.train_batch(data_iter=loader)) for _ in range(3)]
    return recorded, replayed, after, eng.guardian_report()


def test_rollback_replays_like_jax(batches, tmp_path):
    tmp = str(tmp_path)
    jeng, peng = _engines(tmp, batches)
    want = _rollback_run(jeng, JaxLoader(batches),
                         os.path.join(tmp, "jax_ckpt"))
    jeng.close()
    got = _rollback_run(peng, RepeatingLoader(_torch_batches(batches)),
                        os.path.join(tmp, "port_ckpt"))
    peng.close()
    recorded, replayed, after, report = got
    assert after == want[2] == 3
    assert replayed == recorded, "the port's replay is not bit-equal"
    np.testing.assert_allclose(recorded, want[0], **LOSS_TOL)
    np.testing.assert_allclose(replayed, want[1], **LOSS_TOL)
    roll = [a for a in report["actions"] if a["action"] == "rollback"]
    assert [(a["outcome"], a["result"]) for a in roll] == [("ok", "user")]
    assert _journal(report)["action_counts"] == \
        _journal(want[3])["action_counts"]
    with open(os.path.join(tmp, "port", "G.json")) as f:
        assert json.load(f)["action_counts"] == {"rollback": 1}


def test_fp16_rescue_sets_the_jax_scale(batches, tmp_path):
    tmp = str(tmp_path)
    engines = dict(zip(("jax", "port"), _engines(tmp, batches)))
    feed = {"jax": batches[0], "port": _torch_batches(batches)[0]}
    scales = {}
    for side, eng in engines.items():
        eng.train_batch(batch=feed[side])
        eng._guardian.notify("health", [_anom("loss_scale_collapse", 1)])
        eng.train_batch(batch=feed[side])
        rep = eng.guardian_report()
        scales[side] = (float(eng.loss_scale), rep["action_counts"],
                        [a["result"] for a in rep["actions"]])
        eng.close()
    assert scales["port"] == scales["jax"]
    assert scales["port"][0] == 2 ** 8 * 16


def test_emergency_tag_loads_into_the_jax_engine(batches, tmp_path):
    tmp = str(tmp_path)
    ckpt = os.path.join(tmp, "ckpt")
    jeng, peng = _engines(tmp, batches)
    tb = _torch_batches(batches)
    peng.train_batch(batch=tb[0])
    peng.save_checkpoint(ckpt, tag="user")
    peng.train_batch(batch=tb[1])
    peng._guardian.notify("health", [_anom("overflow_streak", 2)])
    peng.train_batch(batch=tb[2])
    em = f"{tguardian.EMERGENCY_TAG_PREFIX}_step3"
    assert [a["result"] for a in peng.guardian_report()["actions"]] == [em]
    masters = {k: p.detach().numpy().copy()
               for k, p in peng.module.state_dict().items()}
    peng.close()
    path, _ = jeng.load_checkpoint(ckpt, tag=em)
    assert path is not None and jeng.global_steps == 3
    got = simple_flax_to_state_dict(jax.tree.map(np.asarray,
                                                 jeng.state.params))
    for k, w in masters.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    jeng.close()
