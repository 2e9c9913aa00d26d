"""The PyTorch port's optimizer rules, loss-scale state machine and LR
schedules against the JAX package's, on the same numpy-seeded inputs.

Tolerances: Adam updates and norms rtol 1e-6, atol 1e-7 (the same fp32
operations; the bias corrections are taken in fp32 as in JAX); LR
schedules rtol 1e-6 (the port computes them in double on the host, JAX
in fp32); the flat layout and the loss-scale machine exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime import optim as jax_optim
from deepspeed_tpu.runtime.fp16 import loss_scaler as jax_scaler
from deepspeed_tpu_torch.runtime import lr_schedules, optim
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"a_kernel": (17, 9), "b_bias": (9,), "c_scale": (3, 4, 5)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()})


@pytest.mark.parametrize("weight_decay,adam_w_mode,bias_correction", [
    (0.0, True, True), (0.01, True, True), (0.01, False, True),
    (0.0, True, False)])
def test_adam_matches_jax_over_steps(weight_decay, adam_w_mode,
                                     bias_correction):
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction)
    jopt, topt = jax_optim.adam(**kw), optim.adam(**kw)
    jp, tp = _both(_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        jg, tg = _both(_tree(10 + step))
        lr = np.float32(1e-3 * (step + 1))
        ju, js = jopt.update(jg, js, jp, lr)
        tu, ts = topt.update(tg, ts, tp, float(lr))
        for k in SHAPES:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       **TOL)
            np.testing.assert_allclose(ts.mu[k].numpy(),
                                       np.asarray(js.mu[k]), **TOL)
            np.testing.assert_allclose(ts.nu[k].numpy(),
                                       np.asarray(js.nu[k]), **TOL)
        jp = {k: jp[k] + ju[k] for k in jp}
        tp = {k: tp[k] + tu[k] for k in tp}
    assert ts.step == int(js.step) == 5


def _run_both(jopt, topt, steps=5):
    """``steps`` updates of the same random grads through both rules,
    params advanced by the updates; updates and states compared at TOL."""
    jp, tp = _both(_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(steps):
        jg, tg = _both(_tree(20 + step))
        lr = np.float32(1e-2 * (step + 1))
        ju, js = jopt.update(jg, js, jp, lr)
        tu, ts = topt.update(tg, ts, tp, float(lr))
        for k in SHAPES:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       **TOL)
        jp = {k: jp[k] + ju[k] for k in jp}
        tp = {k: tp[k] + tu[k] for k in tp}
    return js, ts


@pytest.mark.parametrize("momentum,weight_decay,nesterov", [
    (0.0, 0.0, False), (0.0, 0.01, False), (0.9, 0.0, False),
    (0.9, 0.01, False), (0.9, 0.01, True)])
def test_sgd_matches_jax_over_steps(momentum, weight_decay, nesterov):
    kw = dict(momentum=momentum, weight_decay=weight_decay,
              nesterov=nesterov)
    js, ts = _run_both(jax_optim.sgd(**kw), optim.sgd(**kw))
    if momentum == 0.0:
        assert ts.momentum == () == js.momentum
    else:
        for k in SHAPES:
            np.testing.assert_allclose(ts.momentum[k].numpy(),
                                       np.asarray(js.momentum[k]), **TOL)


@pytest.mark.parametrize("eps,weight_decay,initial", [
    (1e-8, 0.0, 0.0), (1e-6, 0.01, 0.0), (1e-8, 0.0, 0.1)])
def test_adagrad_matches_jax_over_steps(eps, weight_decay, initial):
    kw = dict(eps=eps, weight_decay=weight_decay,
              initial_accumulator_value=initial)
    js, ts = _run_both(jax_optim.adagrad(**kw), optim.adagrad(**kw))
    for k in SHAPES:
        np.testing.assert_allclose(ts.accum[k].numpy(),
                                   np.asarray(js.accum[k]), **TOL)


def test_bias_corrections_match_jax_fp32():
    for step in (1, 2, 10, 999, 5000):
        st = jnp.int32(step).astype(jnp.float32)
        want = (float(1.0 - 0.9 ** st), float(1.0 - 0.999 ** st))
        assert optim.bias_corrections(0.9, 0.999, step) == want
    assert optim.bias_corrections(0.9, 0.999, 3, False) == (1.0, 1.0)


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_global_norm_and_clip_match_jax(max_norm):
    jg, tg = _both(_tree(4, scale=0.3))
    np.testing.assert_allclose(float(optim.global_norm(tg)),
                               float(jax_optim.global_norm(jg)), **TOL)
    jc, jn = jax_optim.clip_by_global_norm(jg, max_norm)
    tc, tn = optim.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    for k in SHAPES:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
    if max_norm > 1e5:   # no clip: coefficient exactly 1
        assert all(torch.equal(tc[k], tg[k]) for k in SHAPES)


@pytest.mark.parametrize("pad_to", [1, 64])
def test_flatten_tree_matches_jax(pad_to):
    # keys in sorted order: the JAX pytree flattens a dict by sorted key,
    # the port in the dict's own order
    jt, tt = _both(_tree(6))
    jvec, jspec = jax_optim.flatten_tree(jt, pad_to=pad_to)
    tvec, tspec = optim.flatten_tree(tt, pad_to=pad_to)
    np.testing.assert_array_equal(tvec.numpy(), np.asarray(jvec))
    assert (tspec.n, tspec.n_pad) == (jspec.n, jspec.n_pad)
    assert tspec.shapes == jspec.shapes
    back = optim.unflatten_tree(tvec, tspec)
    assert list(back) == list(tt)
    assert all(torch.equal(back[k], tt[k]) for k in tt)
    with pytest.raises(ValueError):
        optim.unflatten_tree(tvec[:-1], tspec)


def test_flatten_tree_casts_and_restores_dtype():
    tree = {"w": torch.ones(3, 2, dtype=torch.bfloat16), "b": torch.zeros(4)}
    vec, spec = optim.flatten_tree(tree, pad_to=8)
    assert vec.dtype == torch.float32 and vec.shape == (16,)
    back = optim.unflatten_tree(vec, spec)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"],
                                                              tree["w"])


@pytest.mark.parametrize("hysteresis,window", [(1, 1000), (2, 1000),
                                               (2, 3), (3, 2)])
def test_update_scale_matches_jax(hysteresis, window):
    flags = [True, False, True, True, False, False, False, True, True, True,
             False, False, False, False, True]
    kw = dict(scale_window=window, min_scale=1.0, delayed_shift=hysteresis)
    js = jax_scaler.make_scale_state(2 ** 8, delayed_shift=hysteresis)
    ts = loss_scaler.make_scale_state(2 ** 8, delayed_shift=hysteresis)
    for overflow in flags:
        js = jax_scaler.update_scale(js, overflow, **kw)
        ts = loss_scaler.update_scale(ts, overflow, **kw)
        assert (ts.loss_scale, ts.good_steps, ts.hysteresis) == (
            float(js.loss_scale), int(js.good_steps), int(js.hysteresis))


def test_first_overflow_keeps_scale_under_hysteresis_two():
    """test_engine.py::test_hysteresis_first_overflow_keeps_scale's
    semantics: the first overflow is absorbed, the second halves."""
    s = loss_scaler.make_scale_state(16.0, delayed_shift=2)
    s = loss_scaler.update_scale(s, True, delayed_shift=2)
    assert s.loss_scale == 16.0
    s = loss_scaler.update_scale(s, True, delayed_shift=2)
    assert s.loss_scale == 8.0
    s = loss_scaler.update_scale(s, False, delayed_shift=2)
    s = loss_scaler.update_scale(s, True, delayed_shift=2)
    assert s.loss_scale == 8.0
    assert loss_scaler.update_scale(s, True, dynamic=False) is s


SCHEDULES = [
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 20}),
    ("WarmupLR", {"warmup_min_lr": 0.0, "warmup_max_lr": 2e-3,
                  "warmup_num_steps": 30, "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 45, "warmup_min_lr": 0.0,
                       "warmup_max_lr": 1e-3, "warmup_num_steps": 10}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3,
                  "cycle_first_step_size": 10, "cycle_second_step_size": 15,
                  "decay_lr_rate": 0.1, "decay_step_size": 4}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3,
                  "cycle_first_step_size": 12}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 7,
                     "lr_range_test_step_rate": 2.0}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 7,
                     "lr_range_test_staircase": True}),
]


@pytest.mark.parametrize("name,params", SCHEDULES)
def test_lr_schedules_match_jax(name, params):
    want = jax_lr.get_lr_schedule(name, params)
    got = lr_schedules.get_lr_schedule(name, params)
    for step in range(51):
        np.testing.assert_allclose(got.lr_at(step), float(want.lr_at(step)),
                                   rtol=1e-6, err_msg=f"step {step}")
    for _ in range(5):
        got.step()
        want.step()
    np.testing.assert_allclose(got.get_lr(), want.get_lr(), rtol=1e-6)
    assert got.last_batch_iteration == want.last_batch_iteration == 4


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown lr schedule"):
        lr_schedules.get_lr_schedule("Cosine", {})
