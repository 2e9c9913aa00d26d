"""MoE generation in the PyTorch port (``init_inference(moe=True)``, the
``DeepSpeedMoEInference`` layer) against the JAX package on the CPU
(JAX's ``tests/unit/test_moe_inference.py`` is the model).

fp32 greedy decoding of tiny MoE-GPT (``oracle.TINY_MOE``: 4 experts,
top-1, eval capacity 1.25) must give the JAX ``InferenceEngine``'s tokens
exactly, from ``params=`` and from a tag of either engine. 8 prompts: a
decode step routes 8 tokens with capacity max(⌈8/4 · 1.25⌉, 4) = 4 an
expert, so a step can drop tokens, as in JAX. A stack of two
``DeepSpeedMoEInference`` layers (standard and residual MoE) matches the
flax stack's prefill and one-token steps at 1e-5.
"""

import dataclasses
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.ops.transformer import moe_inference as jax_moe_inf
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.ops.transformer import moe_inference
from tests.model import oracle
from tests.torch_threads import one_torch_thread  # noqa: F401

NEW = 6


@pytest.fixture(scope="module")
def weights():
    """(jax config, port config, numpy flax params, prompts [8, 12])."""
    jcfg = jax_gpt2.GPT2Config(**oracle.TINY_MOE)
    pcfg = dataclasses.replace(gpt2.PRESETS["tiny"], moe_num_experts=4)
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, (8, 12),
                                            dtype=np.int32)
    params = jax_gpt2.GPT2LMHeadModel(jcfg).init(
        jax.random.PRNGKey(0), {"input_ids": jnp.asarray(ids)})["params"]
    return jcfg, pcfg, jax.tree.map(np.asarray, params), ids


def _jax_tokens(jcfg, ids, **kw):
    groups.destroy()
    eng = JaxEngine(jax_gpt2.GPT2LMHeadModel(jcfg), dtype=jnp.float32,
                    moe=True, **kw)
    out = np.asarray(eng.generate(jnp.asarray(ids), max_new_tokens=NEW,
                                  use_cache=True))
    groups.destroy()
    return out


def _port_engine(pcfg, **kw):
    return deepspeed_tpu_torch.init_inference(
        gpt2.GPT2LMHeadModel(pcfg, device="cpu"), dtype=torch.float32,
        device="cpu", moe=True, moe_experts=4, **kw)


def test_moe_gpt2_greedy_tokens_match_jax(weights):
    jcfg, pcfg, params, ids = weights
    want = _jax_tokens(jcfg, ids, params=params)
    eng = _port_engine(pcfg, params=bridge.flax_to_state_dict(params))
    assert eng.moe and eng.moe_experts == 4
    got = eng.generate(torch.from_numpy(ids), max_new_tokens=NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    recompute = eng.generate(torch.from_numpy(ids), max_new_tokens=NEW,
                             use_cache=False)
    # recompute routes a whole sequence a call (other capacities): it is
    # only held to the cached run's shape and prompt
    assert recompute.shape == got.shape
    assert torch.equal(recompute[:, :12], got[:, :12])


def test_moe_tags_generate_from_either_engine(weights, tmp_path):
    """A MoE tag (expert files beside the model states) written by the JAX
    engine and one written by the port: ``init_inference(checkpoint=)``
    generates the JAX engine's tokens for the JAX tag, and the port's
    params= tokens for its own."""
    jcfg, pcfg, params, ids = weights
    batch = {"input_ids": ids[:, :8]}
    cfg = {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {
        "lr": 1e-3}}}
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(
        model=jax_gpt2.GPT2LMHeadModel(jcfg), config=dict(cfg),
        sample_batch=batch)
    jeng.train_batch(batch=batch)
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="t")
    groups.destroy()
    jpath = str(tmp_path / "jax" / "t" / "mp_rank_00_model_states.pt")
    assert os.path.isfile(os.path.join(os.path.dirname(jpath),
                                       "layer_0_expert_3_mp_rank_00_"
                                       "model_states.pt"))
    want = _jax_tokens(jcfg, ids, checkpoint=jpath)
    got = _port_engine(pcfg, checkpoint=jpath).generate(
        torch.from_numpy(ids), max_new_tokens=NEW)
    np.testing.assert_array_equal(got.numpy(), want)

    engine, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2.GPT2LMHeadModel(pcfg, device="cpu"), config=dict(cfg),
        model_parameters=bridge.flax_to_state_dict(params), device="cpu")
    engine.train_batch(batch={"input_ids": torch.from_numpy(ids[:, :8])})
    engine.save_checkpoint(str(tmp_path / "port"), tag="t")
    ppath = str(tmp_path / "port" / "t" / "mp_rank_00_model_states.pt")
    sd = {k: p.detach().clone() for k, p in engine.params.items()}
    want = _port_engine(pcfg, params=sd).generate(torch.from_numpy(ids),
                                                  max_new_tokens=NEW)
    got = _port_engine(pcfg, checkpoint=ppath).generate(
        torch.from_numpy(ids), max_new_tokens=NEW)
    assert torch.equal(got, want)
    # and the JAX engine generates from the port's tag
    np.testing.assert_array_equal(_jax_tokens(jcfg, ids, checkpoint=ppath),
                                  want.numpy())


class _JaxStack(nn.Module):
    config: jax_moe_inf.DeepSpeedMoEInferenceConfig
    n: int = 2

    @nn.compact
    def __call__(self, x, decode=False):
        for i in range(self.n):
            x = jax_moe_inf.DeepSpeedMoEInference(
                self.config, name=f"layers_{i}")(x, True, decode)
        return x


@pytest.mark.parametrize("moe_type", ["standard", "residual"])
def test_moe_inference_layer_stack_matches_jax(moe_type):
    """Two ``DeepSpeedMoEInference`` layers: a prefill of 4 positions and
    two one-token steps through the KV cache, against the flax stack's
    cache protocol (drops included: eval capacity 0.5, min capacity 1)."""
    cfg = dict(hidden_size=32, heads=4, num_experts=4, moe_type=moe_type,
               eval_capacity_factor=0.5, min_capacity=1, max_out_tokens=64)
    jstack = _JaxStack(jax_moe_inf.DeepSpeedMoEInferenceConfig(
        **cfg, use_flash=False))
    x = np.random.default_rng(1).standard_normal((3, 6, 32)).astype(
        np.float32)
    params = jstack.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    out, state = jstack.apply({"params": params}, jnp.asarray(x[:, :4]),
                              decode=True, mutable=["cache"])
    want = [np.asarray(out)]
    for t in (4, 5):
        out, state = jstack.apply({"params": params, "cache":
                                   state["cache"]},
                                  jnp.asarray(x[:, t:t + 1]), decode=True,
                                  mutable=["cache"])
        want.append(np.asarray(out))
    want_full = np.asarray(jstack.apply({"params": params}, jnp.asarray(x)))

    pcfg = moe_inference.DeepSpeedMoEInferenceConfig(**cfg)
    layers = torch.nn.ModuleList(
        moe_inference.DeepSpeedMoEInference(pcfg) for _ in range(2)).eval()
    wrapper = torch.nn.Module()
    wrapper.layers = layers
    wrapper.load_state_dict(bridge.moe_inference_flax_to_state_dict(params))
    cache = layers[0].new_cache(3, num_layers=2)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = [moe_inference.run_layers(layers, xt[:, :4], cache)]
        for t in (4, 5):
            got.append(moe_inference.run_layers(layers, xt[:, t:t + 1],
                                                cache))
        full = moe_inference.run_layers(layers, xt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(full.numpy(), want_full, rtol=1e-5,
                               atol=1e-5)


def test_one_layer_loads_the_flax_layer():
    cfg = dict(hidden_size=32, heads=4, num_experts=4, moe_type="residual")
    jlayer = jax_moe_inf.DeepSpeedMoEInference(
        jax_moe_inf.DeepSpeedMoEInferenceConfig(**cfg, use_flash=False))
    x = np.random.default_rng(2).standard_normal((2, 5, 32)).astype(
        np.float32)
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    layer = moe_inference.DeepSpeedMoEInference(
        moe_inference.DeepSpeedMoEInferenceConfig(**cfg)).eval()
    layer.load_state_dict(bridge.moe_inference_flax_to_state_dict(params))
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jlayer.apply({"params": params},
                                             jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


def test_moe_refusals(weights):
    """Expert parallelism at inference and MoE serving raise (JAX's
    runner asserts too, serving/runner.py:100-101); so does a bad
    moe_type."""
    _, pcfg, _, _ = weights
    with pytest.raises(NotImplementedError, match="ep_size"):
        _port_engine(pcfg, ep_size=2)
    with pytest.raises(NotImplementedError, match="MoE"):
        deepspeed_tpu_torch.init_serving(
            model=gpt2.GPT2LMHeadModel(pcfg, device="cpu"),
            dtype=torch.float32, device="cpu",
            config={"serving": {"max_batch": 2, "block_size": 8,
                                "attention_impl": "gather"}})
    with pytest.raises(ValueError, match="moe_type"):
        moe_inference.DeepSpeedMoEInference(
            moe_inference.DeepSpeedMoEInferenceConfig(
                hidden_size=32, heads=4, moe_type="dense"))
