"""MoQ quantize-aware training in the PyTorch port against the JAX package:
the schedule (``runtime/quantize.py``) and the engine's hook
(``quantize_training`` through ``initialize`` -> ``train_batch``).

* The schedule against the JAX ``Quantizer`` over 20 steps: bits,
  periods, ``qsteps``, the mixed-fp16 ratio, the overflow skip, and the
  quantized values (atol 0: the same fp32 operations; the blend
  ``ratio * x + (1 - ratio) * qx`` rounds three times on both sides).
* The engine against the JAX engine on tiny GPT-2 (Adam, the sweep) and
  tiny BERT (LAMB, fused LAMB) with ``quantize_groups`` 8, fp32, 5 steps:
  losses and final params at rtol = atol = 1e-5. The schedule runs 6 → 4
  bits (5 bits at step 1, 4 from step 2). At 4-5 bits a quantization step
  is ~1e-2 of a weight's range, so a grouping over the wrong layout is
  far outside 1e-5 (a test shows it), while a master that differs
  between the two engines by an fp32 ulp (their gradients are summed in
  another order) lands on the other side of a rounding boundary with a
  probability ~qmax · 1e-7 per element; at 10 bits (qmax 511) some 0.1%
  of the tiny GPT-2's weights flip by one step under Adam at lr 1e-3.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.runtime import quantize as jax_quantize
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.bridge import (bert_flax_to_state_dict,
                                        flax_to_state_dict)
from deepspeed_tpu_torch.models import bert, gpt2
from deepspeed_tpu_torch.runtime import quantize
from tests.model import oracle

STEPS = 5


@pytest.mark.parametrize("mixed,qtype,period", [
    (False, 0, 2), (True, 0, 3), (True, 1, 1), (False, 1, 4)])
def test_schedule_matches_jax(mixed, qtype, period):
    """20 steps, every fifth one an fp16 overflow (skipped)."""
    rng = np.random.default_rng(period)
    tree = {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "b": rng.standard_normal(8).astype(np.float32),
            "odd": rng.standard_normal((3, 5)).astype(np.float32)}
    kw = dict(q_groups=4, q_mixed_fp16=mixed, q_change_ratio=0.05,
              q_type=qtype, q_start_bits=12, q_target_bits=6,
              q_period=period)
    want_q = jax_quantize.Quantizer(**kw)
    got_q = quantize.Quantizer(**kw)
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    params = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    for step in range(20):
        overflow = step % 5 == 4
        assert got_q.any_precision_switch() == want_q.any_precision_switch()
        jtree = want_q.quantize(jtree, overflow=overflow)
        got_q.quantize(params, overflow=overflow)
        assert got_q.q_start_bits == want_q.q_start_bits, step
        assert got_q.q_period == want_q.q_period, step
        assert got_q.qsteps == want_q.qsteps, step
        assert got_q.quantize_real_ratio == want_q.quantize_real_ratio
        for k in tree:
            np.testing.assert_array_equal(params[k].numpy(),
                                          np.asarray(jtree[k]), err_msg=k)
    assert got_q.qsteps == 16 and got_q.current_bits() == want_q.current_bits()
    np.testing.assert_array_equal(params["odd"].numpy(), tree["odd"])
    np.testing.assert_array_equal(params["b"].numpy(), tree["b"])


def test_schedule_passes_16_bits_through_and_counts_seeds():
    q = quantize.Quantizer(q_groups=2, q_rounding=1, q_start_bits=16,
                           q_target_bits=8, q_period=2)
    x = torch.randn(4, 6)
    params = {"x": x.clone()}
    q.quantize(params)                 # 16 bits: untouched, no seed drawn
    assert torch.equal(params["x"], x) and q.seed == 0
    q.quantize(params)                 # step 2: 15 bits, stochastic
    assert q.current_bits() == 15 and q.seed == 1
    assert not torch.equal(params["x"], x)
    assert quantize.path_str("h.0.attn.qkv.weight") == "h/0/attn/qkv/weight"


def _moq(qtype="symmetric"):
    return {"enabled": True,
            "quantize_bits": {"start_bits": 6, "target_bits": 4},
            "quantize_schedule": {"quantize_period": 1},
            "quantize_groups": 8, "quantize_type": qtype}


def _models(kind):
    """(numpy batches, flax model, bridge, port model factory)."""
    if kind == "gpt2":
        batches = [{"input_ids": np.array(b["input_ids"])}
                   for b in oracle.make_batches(STEPS)]
        return (batches, jax_gpt2.GPT2LMHeadModel(
            jax_gpt2.GPT2Config(**oracle.TINY)), flax_to_state_dict,
            lambda: gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu"))
    batches = [{k: np.array(v) for k, v in b.items()}
               for b in oracle.make_bert_batches(STEPS)]
    return (batches, jax_bert.BertForPreTraining(
        jax_bert.BertConfig(**oracle.TINY_BERT)), bert_flax_to_state_dict,
        lambda: bert.BertForPreTraining(bert.BertConfig(**oracle.TINY_BERT),
                                        device="cpu"))


def _config(opt, params, qtype="symmetric"):
    return {"train_batch_size": oracle.BATCH_SIZE,
            "train_micro_batch_size_per_gpu": oracle.BATCH_SIZE,
            "steps_per_print": 10 ** 9,
            "optimizer": {"type": opt, "params": {"lr": oracle.LR,
                                                  **params}},
            "quantize_training": _moq(qtype)}


def _jax_run(jmodel, conv, batches, cfg):
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    engine, *_ = deepspeed_tpu.initialize(
        model=jmodel, config=json.loads(json.dumps(cfg)),
        sample_batch=batches[0], seed=oracle.SEED)
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    return losses, conv(jax.tree.map(np.asarray, engine.state.params)), \
        engine.quantizer


def _port_run(make, init, batches, cfg, naive_layout=False):
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=make(), config=cfg, model_parameters=init, device="cpu")
    if naive_layout:
        engine._transposed = set()
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    return engine, losses


def _init(jmodel, conv, batches):
    params = jmodel.init(jax.random.PRNGKey(oracle.SEED), batches[0])
    return conv(jax.tree.map(np.asarray, params["params"]))


@pytest.mark.parametrize("kind,opt,params,qtype", [
    ("gpt2", "Adam", {}, "symmetric"),
    ("gpt2", "Adam", {"sweep": True}, "symmetric"),
    ("gpt2", "Adam", {}, "asymmetric"),
    ("bert", "Lamb", {}, "symmetric"),
    ("bert", "Lamb", {"fused": True}, "symmetric"),
    ("bert", "Lamb", {}, "asymmetric"),
])
def test_moq_engine_matches_jax(kind, opt, params, qtype):
    batches, jmodel, conv, make = _models(kind)
    cfg = _config(opt, params, qtype)
    want_losses, want_params, want_q = _jax_run(jmodel, conv, batches, cfg)
    engine, losses = _port_run(make, _init(jmodel, conv, batches), batches,
                               cfg)
    q = engine.quantizer
    assert (q.q_start_bits, q.q_period, q.qsteps) == \
        (want_q.q_start_bits, want_q.q_period, want_q.qsteps) == \
        ([4], [4], STEPS)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-5)
    got = engine.module.state_dict()
    for k, w in want_params.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["gpt2", "bert"])
def test_grouping_the_port_layout_as_it_lies_diverges(kind):
    """The [out, in] trap: with the dense weights grouped as stored (not
    over their transpose) the params leave the JAX engine's by far more
    than 1e-5."""
    batches, jmodel, conv, make = _models(kind)
    cfg = _config("Adam" if kind == "gpt2" else "Lamb", {})
    batches = batches[:2]
    _, want_params, _ = _jax_run(jmodel, conv, batches, cfg)
    engine, _ = _port_run(make, _init(jmodel, conv, batches), batches, cfg,
                          naive_layout=True)
    got = engine.module.state_dict()
    worst = {k: np.abs(got[k].numpy() - w.numpy()).max()
             for k, w in want_params.items()}
    dense = [k for k in worst if k.endswith(
        ("qkv.weight", "attn_qkv.weight", "fc.weight"))]
    assert dense and min(worst[k] for k in dense) > 1e-3


def test_quantize_training_builds_the_quantizer_and_moves_the_masters():
    """The config fault: ``quantize_training.enabled`` used to be ignored,
    training unquantized. Now the masters are fake-quantized after the
    step: every group of a 2-D weight holds at most 2^bits levels."""
    batches, jmodel, conv, make = _models("gpt2")
    cfg = _config("Adam", {})
    cfg["quantize_training"]["quantize_bits"] = {"start_bits": 4,
                                                 "target_bits": 4}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=make(), config=cfg, model_parameters=_init(jmodel, conv,
                                                         batches),
        device="cpu")
    assert isinstance(engine.quantizer, quantize.Quantizer)
    engine.train_batch(batch=batches[0])
    for name, p in engine.params.items():
        if p.dim() < 2:
            continue
        ref = p.detach().t() if name in engine._transposed else p.detach()
        for grp in ref.reshape(8, -1):
            assert torch.unique(grp).numel() <= 16, name
    assert "h.0.attn.qkv.weight" in engine._transposed
    assert "wte" not in engine._transposed


def test_fp16_overflow_skips_the_quantizer():
    """An fp16 step that overflows (loss scale 2^32 at the start) applies
    no update and takes no MoQ step, as in JAX."""
    batches, jmodel, conv, make = _models("gpt2")
    cfg = _config("Adam", {})
    cfg["fp16"] = {"enabled": True, "initial_scale_power": 32}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=make(), config=cfg, model_parameters=_init(jmodel, conv,
                                                         batches),
        device="cpu")
    before = {k: p.detach().clone() for k, p in engine.params.items()}
    engine.train_batch(batch=batches[0])
    assert engine.skipped_steps == 1 and engine.quantizer.qsteps == 0
    for k, p in engine.params.items():
        assert torch.equal(p.detach(), before[k]), k
