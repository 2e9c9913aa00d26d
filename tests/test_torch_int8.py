"""Int8 inference weights in the PyTorch port against the JAX package:
``quantize_weight_int8``, ``module_inject.quantize_transformer_layer``,
the int8 ``QuantDense`` and ``inter_w`` forwards, and
``init_inference(dtype=torch.int8)`` -> ``generate``.

Weights come from the flax init (``PRNGKey(0)``), bridged to the port's
state_dict. Tolerances:

* the int8 values and the fp32 scales: atol 0 (both sides divide by
  absmax / 127 in fp32 and round half to even); the port's [out, in]
  weights are compared with the transpose of the flax [in, out] kernels;
* forwards in bf16: rtol = atol = 2e-2 on values of size ~1, plus 0.05 on
  logits (bf16 products summed in another order, then rounded to bf16 at
  every layer on both sides; the tiny models' logits stay below ~1);
* greedy generation on tiny GPT-2: at least 90% of the generated tokens
  equal to the JAX engine's (a near-tie between bf16 logits may flip a
  token and the sequence then continues from another prefix); measured:
  all of them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.module_inject import module_quantize as jax_mq
from deepspeed_tpu.ops.quantizer import int8_linear as jax_int8
import deepspeed_tpu_torch
from deepspeed_tpu_torch.bridge import (bert_flax_to_state_dict,
                                        flax_to_state_dict)
from deepspeed_tpu_torch.models import bert, gpt2
from deepspeed_tpu_torch.module_inject import module_quantize
from deepspeed_tpu_torch.ops.quantizer import int8_linear
from tests.torch_threads import one_torch_thread  # noqa: F401

BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _np(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _bf16_tree(params):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)),
                        params)


@pytest.fixture(scope="module")
def gpt2_weights():
    cfg = jax_gpt2.PRESETS["tiny"]
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16),
                                            dtype=np.int32)
    params = jax_gpt2.GPT2LMHeadModel(cfg).init(
        jax.random.PRNGKey(0), {"input_ids": jnp.asarray(ids)})["params"]
    return jax.tree.map(np.asarray, params), ids


@pytest.fixture(scope="module")
def bert_weights():
    cfg = jax_bert.PRESETS["tiny"]
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16),
                                            dtype=np.int32)
    params = jax_bert.BertForPreTraining(cfg).init(
        jax.random.PRNGKey(0), {"input_ids": jnp.asarray(ids)})["params"]
    return jax.tree.map(np.asarray, params), ids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_int8_matches_jax_transposed(dtype):
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((48, 40)) * 0.05).astype(np.float32)  # [in, out]
    w[:, 7] = 0.0                                      # a zero column
    jw = jnp.asarray(w, getattr(jnp, dtype))
    want_q, want_s = jax_int8.quantize_weight_int8(jw)
    got_q, got_s = int8_linear.quantize_weight_int8(
        torch.from_numpy(w.T.copy()).to(getattr(torch, dtype)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy().T, np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[7] == 1.0
    np.testing.assert_array_equal(
        int8_linear.dequantize_weight_int8(got_q, got_s).numpy().T,
        np.asarray(jax_int8.dequantize_weight_int8(want_q, want_s)))


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _check_against_jax(model, sd_fn, params):
    """quantize_transformer_layer on the port model == the JAX function on
    the flax params: every int8 weight (bridged) and every scale."""
    qparams, qscales = jax_mq.quantize_transformer_layer(params)
    want = sd_fn(jax.tree.map(np.asarray, qparams))
    scales = module_quantize.quantize_transformer_layer(model)
    got = model.state_dict()
    n_int8 = 0
    for k, w in want.items():
        if w.dtype == torch.int8:
            n_int8 += 1
            assert got[k].dtype == torch.int8, k
            np.testing.assert_array_equal(got[k].numpy(), w.numpy(),
                                          err_msg=k)
        else:
            assert got[k].dtype != torch.int8, k
    want_scales = {"/".join(p): np.asarray(v) for p, v in _flatten(qscales)}
    assert len(scales) == len(want_scales) == n_int8 > 0
    return scales, want_scales


def test_quantize_transformer_layer_matches_jax_on_gpt2(gpt2_weights):
    params, _ = gpt2_weights
    model = gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    model.load_state_dict(flax_to_state_dict(params))
    scales, want = _check_against_jax(model, flax_to_state_dict, params)
    for name, s in scales.items():
        # h.0.attn.qkv.weight_scale <- h_0/attn/qkv/kernel_scale
        blk, rest = name.split(".", 2)[1], name.split(".", 2)[2]
        key = f"h_{blk}/" + rest.replace(".weight_scale", "/kernel_scale") \
            .replace(".", "/")
        np.testing.assert_array_equal(s.numpy(), want[key], err_msg=name)
    assert model.h[0].attn.qkv.weight.dtype == torch.int8
    assert model.wte.dtype == torch.float32       # the head stays float


def test_quantize_transformer_layer_matches_jax_on_bert(bert_weights):
    params, _ = bert_weights
    model = bert.BertForPreTraining(bert.PRESETS["tiny"], device="cpu")
    model.load_state_dict(bert_flax_to_state_dict(params))
    scales, want = _check_against_jax(model, bert_flax_to_state_dict, params)
    for name, s in scales.items():
        i = name.split(".")[1]
        if name.endswith("inter_w_scale"):
            key = f"layer_{i}/layer/kernel_scale"   # raw param: layer scope
        else:
            dense = name.split(".")[3]
            key = f"layer_{i}/layer/{dense}/kernel_scale"
        np.testing.assert_array_equal(s.numpy(), want[key], err_msg=name)
    layer = model.layer[0].layer
    assert layer.inter_w.dtype == torch.int8
    assert layer.inter_w_scale.shape == (bert.PRESETS["tiny"].intermediate_size,)
    assert model.mlm_dense.weight.dtype == torch.float32


def test_dequantize_transformer_layer_matches_jax(bert_weights):
    params, _ = bert_weights
    qparams, qscales = jax_mq.quantize_transformer_layer(params)
    want = bert_flax_to_state_dict(jax.tree.map(
        np.asarray, jax_mq.dequantize_transformer_layer(qparams, qscales)))
    model = bert.BertForPreTraining(bert.PRESETS["tiny"], device="cpu")
    model.load_state_dict(bert_flax_to_state_dict(params))
    module_quantize.quantize_transformer_layer(model)
    module_quantize.dequantize_transformer_layer(model)
    got = model.state_dict()
    assert set(got) == set(want)                 # the scale buffers went
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w.numpy(), err_msg=k)


def test_int8_quant_dense_matches_jax():
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((64, 96)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(96) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jw = jnp.asarray(w, jnp.bfloat16)
    wq, scale = jax_int8.quantize_weight_int8(jw)
    want = jax_int8.QuantDense(96).apply(
        {"params": {"kernel": wq, "bias": jnp.asarray(b, jnp.bfloat16)},
         "quant_scales": {"kernel_scale": scale}},
        jnp.asarray(x, jnp.bfloat16))
    layer = int8_linear.QuantDense(64, 96, dtype=torch.bfloat16)
    layer.load_state_dict({"weight": torch.from_numpy(w.T.copy()).bfloat16(),
                           "bias": torch.from_numpy(b).bfloat16()})
    module_quantize.quantize_transformer_layer(layer,
                                               patterns=(r"^weight$",))
    got = layer(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    del layer.weight_scale
    with pytest.raises(ValueError, match="weight_scale"):
        layer(torch.from_numpy(x).bfloat16())


def test_int8_bert_forward_matches_jax(bert_weights):
    """The int8 attn_qkv, attn_out, output_w (QuantDense) and inter_w
    (the fused layer) through the whole BERT forward in bf16."""
    params, ids = bert_weights
    bparams = _bf16_tree(params)
    qparams, qscales = jax_mq.quantize_transformer_layer(
        jax.tree.map(jnp.asarray, bparams))
    cfg = jax_bert.PRESETS["tiny"]
    want = jax_bert.BertForPreTraining(cfg).apply(
        {"params": qparams, "quant_scales": qscales},
        {"input_ids": jnp.asarray(ids)})
    model = bert.BertForPreTraining(bert.PRESETS["tiny"], device="cpu")
    model.load_state_dict(bert_flax_to_state_dict(params))
    model = model.to(torch.bfloat16)
    module_quantize.quantize_transformer_layer(model)
    got = model({"input_ids": torch.from_numpy(ids).long()})
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=5e-2)


def test_init_inference_int8_generate_matches_jax(gpt2_weights):
    params, ids = gpt2_weights
    jcfg = dataclasses.replace(jax_gpt2.PRESETS["tiny"], use_flash=True)
    jeng = JaxEngine(jax_gpt2.GPT2LMHeadModel(jcfg), params=params,
                     dtype=jnp.int8)
    want = np.asarray(jeng.generate(jnp.asarray(ids), max_new_tokens=12,
                                    use_cache=True))
    model = gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    eng = deepspeed_tpu_torch.init_inference(
        model, params=flax_to_state_dict(params), dtype=torch.int8,
        device="cpu")
    assert eng.dtype == torch.bfloat16
    assert eng.module.h[0].mlp.fc.weight.dtype == torch.int8
    assert eng.module.h[0].ln_1.weight.dtype == torch.bfloat16
    got = eng.generate(torch.from_numpy(ids), max_new_tokens=12).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :16], ids)
    assert (got[:, 16:] == want[:, 16:]).mean() >= 0.9
    # prefill logits of the last prompt position against the JAX model
    jlogits = jax_gpt2.GPT2LMHeadModel(jcfg).apply(
        jeng._wrap(jeng.params), {"input_ids": jnp.asarray(ids)},
        return_logits=True)[:, -1]
    with torch.no_grad():
        logits = eng.module({"input_ids": torch.from_numpy(ids).long()},
                            return_logits=True)[:, -1]
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=2e-2,
                               atol=5e-2)


def test_int8_bytes_saved_match_jax(gpt2_weights):
    params, _ = gpt2_weights
    from deepspeed_tpu.telemetry.metrics import get_registry
    counter = get_registry().counter("inference_int8_bytes_saved_total", "")
    before = counter.value
    JaxEngine(jax_gpt2.GPT2LMHeadModel(jax_gpt2.PRESETS["tiny"]),
              params=params, dtype=jnp.int8)
    want = counter.value - before
    eng = deepspeed_tpu_torch.init_inference(
        gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu"),
        params=flax_to_state_dict(params), dtype=torch.int8, device="cpu")
    assert eng.int8_bytes_saved == want > 0


def test_int8_engine_refuses_a_custom_apply_fn():
    model = gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    with pytest.raises(ValueError, match="apply_fn"):
        deepspeed_tpu_torch.init_inference(model, dtype=torch.int8,
                                           device="cpu",
                                           apply_fn=lambda p, b: b)
    with pytest.raises(ValueError, match="bits"):
        module_quantize.quantize_transformer_layer(model, bits=4)
    with pytest.raises(ValueError, match="matched no"):
        module_quantize.quantize_transformer_layer(model,
                                                   patterns=(r"^nothing$",))
