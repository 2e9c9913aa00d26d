"""BERT MLM pretraining with LAMB through the PyTorch port's training path
(``initialize`` -> ``train_batch``) on the CPU, against the JAX package.

The port's tiny BERT starts from the flax init of the JAX engine
(``PRNGKey(0)`` on the oracle's first batch) bridged by
``bert_flax_to_state_dict``, and trains on the oracle's MLM batches (bs 8,
seq 32, 20 steps). Tolerances:

* fp32 reproduces ``tests/model/baselines/bert_tiny_fp32_lamb.json`` at
  rtol = atol = 1e-4, the bound ``tests/model/test_loss_parity.py`` holds
  the JAX engine to (``TestBertLamb``), for LAMB, fused LAMB and ZeRO 1;
* bf16 with fused LAMB at rtol 0.03 / atol 0.12, the reduced-precision
  envelope of ``tests/test_torch_engine.py``;
* against the JAX engine itself (LAMB with weight decay, a clip that
  fires, WarmupLR, fused on and off): per-step losses and final params at
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
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.bridge import bert_flax_to_state_dict
from deepspeed_tpu_torch.models import bert
from tests.model import oracle

BASELINE = os.path.join(os.path.dirname(__file__), "model", "baselines",
                        "bert_tiny_fp32_lamb.json")
STEPS = 20


@pytest.fixture(scope="module")
def setup():
    """(golden losses, oracle MLM batches as numpy, bridged init)."""
    with open(BASELINE) as f:
        golden = json.load(f)["losses"]
    batches = [{k: np.array(v) for k, v in b.items()}
               for b in oracle.make_bert_batches(STEPS)]
    model = jax_bert.BertForPreTraining(
        jax_bert.BertConfig(**oracle.TINY_BERT))
    params = model.init(jax.random.PRNGKey(oracle.SEED), batches[0])
    init = bert_flax_to_state_dict(jax.tree.map(np.asarray,
                                                params["params"]))
    return golden, batches, init


def _config(fused=False, **over):
    cfg = {"train_batch_size": oracle.BATCH_SIZE,
           "train_micro_batch_size_per_gpu": oracle.BATCH_SIZE,
           "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Lamb", "params": {
               "lr": oracle.LAMB_LR, "fused": fused}}}
    cfg.update(over)
    return cfg


def _run_port(init, batches, cfg):
    model = bert.BertForPreTraining(bert.BertConfig(**oracle.TINY_BERT),
                                    device="cpu")
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=cfg, model_parameters=init, device="cpu")
    return engine, [float(engine.train_batch(batch=b)) for b in batches]


@pytest.mark.parametrize("name,cfg", [
    ("lamb", _config()),
    ("fused_lamb", _config(fused=True)),
    ("lamb_zero1", _config(zero_optimization={"stage": 1})),
])
def test_fp32_reproduces_golden_curve(setup, name, cfg):
    golden, batches, init = setup
    engine, losses = _run_port(init, batches, cfg)
    np.testing.assert_allclose(losses, golden, rtol=1e-4, atol=1e-4)
    assert engine.global_steps == engine.step_count == STEPS


def test_bf16_fused_lamb_tracks_golden_curve(setup):
    golden, batches, init = setup
    engine, losses = _run_port(init, batches, _config(
        fused=True, bf16={"enabled": True}))
    assert engine.compute_dtype == torch.bfloat16
    np.testing.assert_allclose(losses, golden, rtol=0.03, atol=0.12)


def _jax_engine(cfg, batches):
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    engine, *_ = deepspeed_tpu.initialize(
        model=jax_bert.BertForPreTraining(
            jax_bert.BertConfig(**oracle.TINY_BERT)),
        config=cfg, sample_batch=batches[0], seed=oracle.SEED)
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    params = bert_flax_to_state_dict(jax.tree.map(np.asarray,
                                                  engine.state.params))
    return losses, params


@pytest.mark.parametrize("fused", [False, True])
def test_matches_jax_engine(setup, fused):
    """LAMB with weight decay 0.01 and a trust-ratio range of [0.05, 5], a
    global-norm clip of 0.5 that fires on every step, WarmupLR."""
    cfg = _config(gradient_clipping=0.5, scheduler={
        "type": "WarmupLR", "params": {"warmup_min_lr": 1e-4,
                                       "warmup_max_lr": 2e-3,
                                       "warmup_num_steps": 6}})
    cfg["optimizer"]["params"].update(fused=fused, weight_decay=0.01,
                                      min_coeff=0.05, max_coeff=5.0)
    batches = setup[1][:8]
    want_losses, want_params = _jax_engine(json.loads(json.dumps(cfg)),
                                           batches)
    engine, losses = _run_port(setup[2], batches, cfg)
    assert float(engine.global_grad_norm) > 0.5     # the clip fired
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-5)
    got = engine.module.state_dict()
    for k, w in want_params.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
