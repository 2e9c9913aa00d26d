"""The PyTorch port's ``init_inference`` -> ``generate`` against the JAX
package's ``InferenceEngine.generate`` on bridged weights.

Greedy decoding in fp32 on the CPU must give the same tokens as the JAX
engine: its model runs the Pallas flash and decode kernels in interpret
mode (``use_flash=True``). The int8 KV cache is compared with the JAX
engine on its dequantize-first path, which the port's plain version
follows (the JAX int8 kernel rounds p·v_scale to bf16; see
tests/test_torch_decode.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.models import gpt2 as jax_gpt2
import deepspeed_tpu_torch
from deepspeed_tpu_torch.bridge import flax_to_state_dict
from deepspeed_tpu_torch.models import gpt2


@pytest.fixture(scope="module")
def weights():
    """(numpy flax params, ids [2, 16]) of PRESETS["tiny"]."""
    cfg = jax_gpt2.PRESETS["tiny"]
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16),
                                            dtype=np.int32)
    params = jax_gpt2.GPT2LMHeadModel(cfg).init(
        jax.random.PRNGKey(0), {"input_ids": jnp.asarray(ids)})["params"]
    return jax.tree.map(np.asarray, params), ids


def _port(params, kv="auto"):
    cfg = dataclasses.replace(gpt2.PRESETS["tiny"], kv_cache_dtype=kv)
    model = gpt2.GPT2LMHeadModel(cfg, device="cpu")
    return deepspeed_tpu_torch.init_inference(
        model, params=flax_to_state_dict(params), dtype=torch.float32,
        device="cpu")


@pytest.mark.parametrize("kv,use_flash", [("auto", True), ("int8", None)])
def test_cached_greedy_token_exact_vs_jax(weights, kv, use_flash):
    params, ids = weights
    jcfg = dataclasses.replace(jax_gpt2.PRESETS["tiny"], use_flash=use_flash,
                               kv_cache_dtype=kv)
    jeng = JaxEngine(jax_gpt2.GPT2LMHeadModel(jcfg), params=params,
                     dtype=jnp.float32)
    want = np.asarray(jeng.generate(jnp.asarray(ids), max_new_tokens=12,
                                    use_cache=True))
    got = _port(params, kv).generate(torch.from_numpy(ids),
                                     max_new_tokens=12)
    assert got.shape == (2, 28)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cached_matches_recompute(weights):
    params, ids = weights
    eng = _port(params)
    tids = torch.from_numpy(ids)
    cached = eng.generate(tids, max_new_tokens=12, use_cache=True)
    recompute = eng.generate(tids, max_new_tokens=12, use_cache=False)
    torch.testing.assert_close(cached, recompute, rtol=0, atol=0)
    # a custom logits_fn takes the recompute path
    custom = eng.generate(tids, max_new_tokens=12, logits_fn=lambda x: eng(
        {"input_ids": x}, return_logits=True))
    torch.testing.assert_close(custom, cached, rtol=0, atol=0)


@pytest.mark.parametrize("use_cache", [True, False])
def test_generate_eos_freezes_sequence(weights, use_cache):
    params, ids = weights
    eng = _port(params)
    tids = torch.from_numpy(ids)
    out = eng.generate(tids, max_new_tokens=10, use_cache=use_cache)
    eos = int(out[0, 18])  # the third generated token of sequence 0
    out_eos = eng.generate(tids, max_new_tokens=10, eos_token_id=eos,
                           use_cache=use_cache)
    gen = out_eos[0, 16:].numpy()
    hit = np.flatnonzero(gen == eos)
    assert hit.size and hit[0] <= 2
    assert (gen[hit[0]:] == eos).all()
    torch.testing.assert_close(out_eos[:, :19], out[:, :19], rtol=0, atol=0)


def test_eos_freeze_matches_jax(weights):
    params, ids = weights
    jeng = JaxEngine(jax_gpt2.GPT2LMHeadModel(jax_gpt2.PRESETS["tiny"]),
                     params=params, dtype=jnp.float32)
    eng = _port(params)
    eos = int(eng.generate(torch.from_numpy(ids), max_new_tokens=4)[1, 17])
    want = np.asarray(jeng.generate(jnp.asarray(ids), max_new_tokens=8,
                                    eos_token_id=eos, use_cache=True))
    got = eng.generate(torch.from_numpy(ids), max_new_tokens=8,
                       eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_rejects_cache_overflow(weights):
    params, ids = weights
    eng = _port(params)   # n_positions 128, prompt 16
    with pytest.raises(ValueError, match="n_positions"):
        eng.generate(torch.from_numpy(ids), max_new_tokens=128)


def test_sampling_uses_generator_and_real_vocab(weights):
    params, ids = weights
    eng = _port(params)
    tids = torch.from_numpy(ids)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return eng.generate(tids, max_new_tokens=8, temperature=1.0,
                            generator=g)
    a, b = run(1), run(1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(a.max()) < gpt2.PRESETS["tiny"].vocab_size
    # greedy never picks a padded vocab row, even when it scores highest
    eng.module.wte.data[gpt2.PRESETS["tiny"].vocab_size:] = 0.0
    last = torch.zeros(2, eng.module.config.padded_vocab)
    last[:, -1] = 10.0
    assert (eng._sample(last, None, 0.0) < 512).all()


def test_engine_casts_dtype_and_forward(weights):
    params, ids = weights
    model = gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    eng = deepspeed_tpu_torch.init_inference(
        model, params=flax_to_state_dict(params), device="cpu")
    assert eng.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in eng.module.parameters())
    loss = eng({"input_ids": torch.from_numpy(ids)})
    assert torch.isfinite(loss)
    out = eng.generate(torch.from_numpy(ids), max_new_tokens=3)
    assert out.shape == (2, 19)


@pytest.mark.parametrize("kwargs", [
    {"mp_size": 2}, {"moe": True}, {"quantization_setting": 8},
    {"checkpoint": "ckpt.json"}])
def test_unported_engine_options_raise(kwargs):
    model = gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        deepspeed_tpu_torch.init_inference(model, device="cpu", **kwargs)


def test_int8_weights_engine(weights):
    """``dtype=torch.int8``, refused before this slice, now stores the
    transformer weights in int8 under bf16 activations and generates
    (tests/test_torch_int8.py holds it to the JAX engine)."""
    params, ids = weights
    model = gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    eng = deepspeed_tpu_torch.init_inference(
        model, params=flax_to_state_dict(params), dtype=torch.int8,
        device="cpu")
    assert eng.dtype == torch.bfloat16 and eng.int8_bytes_saved > 0
    assert eng.module.h[1].attn.proj.weight.dtype == torch.int8
    assert eng.module.h[1].attn.proj.weight_scale.dtype == torch.float32
    out = eng.generate(torch.from_numpy(ids), max_new_tokens=3)
    assert out.shape == (2, 19)
