"""The PyTorch port's training path (``initialize`` -> ``train_batch``) on
the CPU against the JAX package.

The port's tiny GPT-2 starts from the flax init of ``tests/model/oracle``
(``PRNGKey(0)`` on the oracle's first batch) bridged by
``flax_to_state_dict``, and trains on the oracle's batches (bs 8, seq 32,
20 steps). Tolerances:

* fp32 configs reproduce ``tests/model/baselines/gpt2_tiny_fp32_adam.json``
  at rtol = atol = 1e-4, the bound ``tests/model/test_loss_parity.py``
  holds the JAX engine to;
* bf16 at rtol 0.03 / atol 0.12 and fp16 with a dynamic scale at rtol 0.03
  / atol 0.08, the same file's reduced-precision envelopes;
* against the JAX engine itself (AdamW with decay, a clip that fires,
  WarmupLR, the sweep on and off): per-step losses and final params at
  rtol = atol = 1e-5.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.bridge import flax_to_state_dict
from deepspeed_tpu_torch.models import gpt2
from tests.model import oracle

BASELINE = os.path.join(os.path.dirname(__file__), "model", "baselines",
                        "gpt2_tiny_fp32_adam.json")
STEPS = 20


@pytest.fixture(scope="module")
def setup():
    """(golden losses, oracle batches as numpy, bridged initial state)."""
    with open(BASELINE) as f:
        golden = json.load(f)["losses"]
    batches = [{"input_ids": np.array(b["input_ids"])}
               for b in oracle.make_batches(STEPS)]
    model = jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(**oracle.TINY))
    params = model.init(jax.random.PRNGKey(oracle.SEED), batches[0])
    init = flax_to_state_dict(jax.tree.map(np.asarray, params["params"]))
    return golden, batches, init


def _config(**over):
    cfg = {"train_batch_size": oracle.BATCH_SIZE,
           "train_micro_batch_size_per_gpu": oracle.BATCH_SIZE,
           "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": oracle.LR}},
           "zero_optimization": {"stage": 0}}
    cfg.update(over)
    return cfg


def _run_port(setup, cfg):
    _, batches, init = setup
    model = gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    engine, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=model, config=cfg, model_parameters=init, device="cpu")
    assert loader is None and opt is engine.optimizer
    gas = engine.gradient_accumulation_steps()
    losses = []
    for batch in batches:
        if gas > 1:
            mb = oracle.BATCH_SIZE // gas
            it = iter({"input_ids": batch["input_ids"][i * mb:(i + 1) * mb]}
                      for i in range(gas))
            loss = engine.train_batch(data_iter=it)
        else:
            loss = engine.train_batch(batch=batch)
        assert isinstance(loss, torch.Tensor) and loss.dtype == torch.float32
        losses.append(float(loss))
    return engine, losses


@pytest.mark.parametrize("name,over", [
    ("zero0", {}),
    ("zero1", {"zero_optimization": {"stage": 1}}),
    ("gas2", {"train_micro_batch_size_per_gpu": oracle.BATCH_SIZE // 2}),
    ("fused", {"optimizer": {"type": "Adam", "params": {
        "lr": oracle.LR, "fused": True}}}),
    ("sweep", {"optimizer": {"type": "Adam", "params": {
        "lr": oracle.LR, "sweep": True}}}),
])
def test_fp32_reproduces_golden_curve(setup, name, over):
    engine, losses = _run_port(setup, _config(**over))
    np.testing.assert_allclose(losses, setup[0], rtol=1e-4, atol=1e-4)
    assert engine.global_steps == engine.step_count == STEPS
    assert engine.micro_steps == STEPS * engine.gradient_accumulation_steps()
    assert engine.skipped_steps == 0 and engine.global_grad_norm is None


def test_bf16_tracks_golden_curve(setup):
    engine, losses = _run_port(setup, _config(bf16={"enabled": True}))
    assert engine.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in engine.params.values())
    np.testing.assert_allclose(losses, setup[0], rtol=0.03, atol=0.12)


def test_fp16_dynamic_scale_tracks_golden_curve(setup):
    engine, losses = _run_port(setup, _config(fp16={
        "enabled": True, "loss_scale": 0, "initial_scale_power": 8}))
    np.testing.assert_allclose(losses, setup[0], rtol=0.03, atol=0.08)
    assert engine.global_grad_norm is not None


def test_fp16_overflow_skips_step_and_keeps_scale_once(setup):
    """An overflow skips the update; with hysteresis 2 the first one
    leaves the scale, the second halves it (loss_scaler semantics)."""
    _, batches, init = setup
    model = gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=_config(fp16={"enabled": True, "loss_scale": 0,
                                          "initial_scale_power": 8}),
        model_parameters=init, device="cpu")
    with torch.no_grad():
        engine.params["wte"][0, 0] = float("inf")
    before = {k: p.detach().clone() for k, p in engine.params.items()}
    for n in (1, 2):
        engine.train_batch(batch=batches[0])
        assert engine.skipped_steps == n and engine.step_count == 0
    assert engine.loss_scale == 2 ** 7
    assert all(torch.equal(p, before[k]) for k, p in engine.params.items())


def _jax_engine(cfg, batches, gas=1):
    """The JAX engine's losses and final params; at gas > 1 each batch is
    fed as ``gas`` micro-batches, the split ``_run_port`` makes."""
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    engine, *_ = deepspeed_tpu.initialize(
        model=jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(**oracle.TINY)),
        config=cfg, sample_batch=batches[0], seed=oracle.SEED)
    mb = oracle.BATCH_SIZE // gas
    losses = [float(engine.train_batch(data_iter=iter(
        {"input_ids": b["input_ids"][i * mb:(i + 1) * mb]}
        for i in range(gas)))) for b in batches]
    params = flax_to_state_dict(jax.tree.map(np.asarray,
                                             engine.state.params))
    return losses, params


@pytest.mark.parametrize("sweep,scheduler", [
    (False, {"type": "WarmupLR", "params": {
        "warmup_min_lr": 1e-4, "warmup_max_lr": 2e-3,
        "warmup_num_steps": 8}}),
    (True, {"type": "WarmupLR", "params": {
        "warmup_min_lr": 1e-4, "warmup_max_lr": 2e-3,
        "warmup_num_steps": 8, "warmup_type": "linear"}}),
])
def test_matches_jax_engine(setup, sweep, scheduler):
    """AdamW with weight decay 0.01, a global-norm clip of 0.5 that fires
    on every step, WarmupLR; sweep on and off."""
    cfg = _config(optimizer={"type": "AdamW", "params": {
        "lr": 2e-3, "weight_decay": 0.01, "sweep": sweep}},
        gradient_clipping=0.5, scheduler=scheduler)
    batches = setup[1][:10]
    want_losses, want_params = _jax_engine(dict(cfg), batches)
    engine, losses = _run_port((setup[0], batches, setup[2]), dict(cfg))
    assert float(engine.global_grad_norm) > 0.5     # the clip fired
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-5)
    got = engine.module.state_dict()
    for k, w in want_params.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert engine.lr_scheduler.last_batch_iteration == len(batches) - 1


def test_bf16_accumulator_matches_jax_engine(setup):
    """gas 2 with ``gradient_accumulation_dtype: "bf16"``: both engines
    cast each micro-batch's fp32 gradients into a bf16 buffer and add
    there (JAX engine.py:1144-1150, 1532-1535). Losses and params against
    the JAX engine: losses at 1e-5, params at atol 1e-4 (a gradient
    element whose two fp32 sums differ in the last bit can round to
    neighbouring bf16 values, and Adam's normalised update carries that
    into a few elements). An fp32 accumulator lands well apart, so the
    buffer's dtype is what the comparison sees."""
    cfg = _config(train_micro_batch_size_per_gpu=oracle.BATCH_SIZE // 2,
                  gradient_accumulation_dtype="bf16",
                  optimizer={"type": "Adam", "params": {"lr": 2e-3}})
    batches = setup[1][:8]
    want_losses, want_params = _jax_engine(dict(cfg), batches, gas=2)
    engine, losses = _run_port((setup[0], batches, setup[2]), dict(cfg))
    assert engine.gradient_accumulation_steps() == 2
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-5)
    got = engine.module.state_dict()
    for k, w in want_params.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
    cfg.pop("gradient_accumulation_dtype")
    fp32_engine, _ = _run_port((setup[0], batches, setup[2]), cfg)
    apart = max(float((fp32_engine.module.state_dict()[k] - w).abs().max())
                for k, w in want_params.items())
    assert apart > 1e-3


def test_initialize_contract_and_unported_arguments(setup):
    model = gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    engine, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=model, config=_config(), device="cpu")
    assert isinstance(engine, deepspeed_tpu_torch.DeepSpeedEngine)
    assert loader is None and sched is None
    assert engine.get_lr() == [oracle.LR]
    for kw in ({"training_data": [1]}, {"optimizer": object()},
               {"lr_scheduler": object()}, {"mpu": object()}):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            deepspeed_tpu_torch.initialize(model=model, config=_config(),
                                           device="cpu", **kw)
    with pytest.raises(ValueError, match="data_iter or batch"):
        engine.train_batch()



def test_world_size_above_one_raises(monkeypatch):
    """ZeRO over several ranks is not ported: an engine built inside an
    initialised process group of more than one rank raises."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    model = gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        deepspeed_tpu_torch.initialize(model=model, config=_config(),
                                       device="cpu")
