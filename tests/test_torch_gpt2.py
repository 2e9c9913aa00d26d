"""The PyTorch port's GPT-2 against the flax model on bridged weights.

The flax model is initialised from a seed, its params go through
``deepspeed_tpu_torch.bridge`` as numpy arrays, and both models run the
same numpy-seeded ids on the CPU in fp32. Tolerance rtol = atol = 1e-4:
flax LayerNorm takes the variance as mean(x²) − mean(x)², PyTorch in two
passes, and matmuls sum in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import common as jax_common
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.ops.quantizer.int8_linear import QuantDense as JaxDense
from deepspeed_tpu_torch.bridge import flax_to_state_dict
from deepspeed_tpu_torch.models import common, gpt2
from deepspeed_tpu_torch.ops.quantizer.int8_linear import QuantDense
from deepspeed_tpu_torch.runtime import dropout

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def tiny():
    """(flax model, numpy params, port model, ids [2, 16])."""
    cfg = jax_gpt2.PRESETS["tiny"]
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16),
                                            dtype=np.int32)
    jm = jax_gpt2.GPT2LMHeadModel(cfg)
    params = jm.init(jax.random.PRNGKey(0), {"input_ids": jnp.asarray(ids)})
    params = jax.tree.map(np.asarray, params["params"])
    tm = gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    tm.load_state_dict(flax_to_state_dict(params))
    return jm, params, tm.eval(), ids


def test_presets_match_jax():
    for name, cfg in jax_gpt2.PRESETS.items():
        port = gpt2.PRESETS[name]
        for f in ("vocab_size", "n_positions", "n_embd", "n_layer",
                  "n_head"):
            assert getattr(port, f) == getattr(cfg, f), (name, f)
        assert port.padded_vocab == cfg.padded_vocab
        assert port.num_params() == cfg.num_params()
    assert gpt2.PRESETS["gpt2-medium"].padded_vocab == 50304


def test_bridge_layout(tiny):
    _, params, tm, _ = tiny
    sd = flax_to_state_dict(params)
    assert set(sd) == set(tm.state_dict())
    for key, t in tm.state_dict().items():
        assert sd[key].shape == t.shape, key
    qkv = params["h_1"]["attn"]["qkv"]["kernel"]            # [in, 3E]
    np.testing.assert_array_equal(sd["h.1.attn.qkv.weight"].numpy(), qkv.T)
    np.testing.assert_array_equal(sd["ln_f.weight"].numpy(),
                                  params["ln_f"]["scale"])
    assert sd["wte"].shape == (512, 64)                     # padded vocab
    # a {"params": ...} wrapper is accepted too
    sd2 = flax_to_state_dict({"params": params})
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)


def test_logits_match_flax(tiny):
    jm, params, tm, ids = tiny
    want = jm.apply({"params": params}, {"input_ids": ids},
                    return_logits=True)
    with torch.no_grad():
        got = tm({"input_ids": torch.from_numpy(ids).long()},
                 return_logits=True)
    assert got.dtype == torch.float32 and got.shape == (2, 16, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_labels", [False, True])
def test_loss_matches_flax(tiny, with_labels):
    jm, params, tm, ids = tiny
    labels = ids.copy()
    labels[:, ::3] = -100
    batch = {"input_ids": ids, **({"labels": labels} if with_labels else {})}
    want = float(jm.apply({"params": params}, batch))
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    with torch.no_grad():
        got = float(tm(tbatch))
        got_tuple = float(tm(tuple(tbatch.values())))
    np.testing.assert_allclose(got, want, **TOL)
    assert got_tuple == got


def _cached_logits(model, ids, split):
    """Prefill on ids[:, :split], then one-token steps: [B, S, V]."""
    with torch.no_grad():
        cache = model.new_cache(ids.shape[0])
        out = [model({"input_ids": ids[:, :split]}, cache=cache)]
        for t in range(split, ids.shape[1]):
            out.append(model({"input_ids": ids[:, t:t + 1]}, cache=cache))
    assert cache.pos == ids.shape[1]
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_prefill_then_steps_match_full_forward(tiny, kv):
    jm, params, tm, ids = tiny
    tids = torch.from_numpy(ids).long()
    with torch.no_grad():
        full = tm({"input_ids": tids}, return_logits=True)
    if kv == "int8":
        qm = gpt2.GPT2LMHeadModel(
            dataclasses.replace(gpt2.PRESETS["tiny"], kv_cache_dtype="int8"),
            device="cpu")
        qm.load_state_dict(tm.state_dict())
        got = _cached_logits(qm, tids, 8)
        # prefill attends over the fresh fp K/V; the steps over int8
        torch.testing.assert_close(got[:, :8], full[:, :8], **TOL)
        torch.testing.assert_close(got, full, rtol=0.05, atol=0.05)
        assert qm.new_cache(2).k[0].dtype == torch.int8
        return
    got = _cached_logits(tm, tids, 8)
    torch.testing.assert_close(got, full, **TOL)
    # and the flax model's own cached decode
    logits, variables = jm.apply({"params": params},
                                 {"input_ids": ids[:, :8]}, decode=True,
                                 mutable=["cache"])
    np.testing.assert_allclose(got[:, :8].numpy(), np.asarray(logits), **TOL)
    for t in range(8, 16):
        logits, variables = jm.apply(
            {"params": params, "cache": variables["cache"]},
            {"input_ids": ids[:, t:t + 1]}, decode=True, mutable=["cache"])
        np.testing.assert_allclose(got[:, t].numpy(),
                                   np.asarray(logits[:, 0]), **TOL)


def test_last_only_logits(tiny):
    _, _, tm, ids = tiny
    tids = torch.from_numpy(ids).long()
    with torch.no_grad():
        full = tm({"input_ids": tids}, return_logits=True)
        last = tm({"input_ids": tids}, cache=tm.new_cache(2), last_only=True)
    torch.testing.assert_close(last[:, 0], full[:, -1], **TOL)


def test_cache_overflow_raises(tiny):
    _, _, tm, ids = tiny
    cache = tm.new_cache(2)
    cache.pos = 120
    with pytest.raises(ValueError, match="n_positions"):
        tm({"input_ids": torch.zeros(2, 16, dtype=torch.long)}, cache=cache)


@pytest.mark.parametrize("field,value", [
    ("pp_stages", 2), ("attention_mode", "ring:seq"),
    ("attention_mode", "sparse"), ("moe_num_experts", 4),
    ("position_embedding", "rope"), ("dropout", 0.1), ("remat", True)])
def test_unported_options_raise(field, value):
    """Pipeline stages, ring attention and rope still raise. Sparse
    attention, dropout, remat and MoE are ported: the model builds (sparse
    with remat too) and the option acts: dropout draws masks under a key,
    remat leaves the loss as it is, MoE's loss carries the aux term."""
    cfg = dataclasses.replace(gpt2.PRESETS["tiny"], **{field: value})
    if field == "moe_num_experts":
        batch = gpt2.synthetic_batch(2, 32, 512, seed=0, device="cpu")
        loss = gpt2.GPT2LMHeadModel(cfg, device="cpu")(batch)
        ce = gpt2.GPT2LMHeadModel(dataclasses.replace(
            cfg, moe_aux_loss_coef=0.0), device="cpu")(batch)
        l_aux = (loss - ce).item() / cfg.moe_aux_loss_coef
        assert torch.isfinite(loss) and 0.5 < l_aux <= value
        return
    if value == "sparse":
        gpt2.GPT2LMHeadModel(cfg, device="cpu")
        cfg = dataclasses.replace(cfg, remat=True)
    if value == "sparse" or field in ("dropout", "remat"):
        model = dropout.number_sites(gpt2.GPT2LMHeadModel(cfg, device="cpu"))
        seq = 128 if value == "sparse" else 32     # the default block
        batch = gpt2.synthetic_batch(2, seq, 512, seed=0, device="cpu")
        plain = model(batch)
        with dropout.key_scope((0, 0)):
            keyed = model(batch)
        assert torch.equal(keyed, plain) == (field != "dropout")
        return
    with pytest.raises(NotImplementedError, match="not ported yet"):
        gpt2.GPT2LMHeadModel(cfg, device="cpu")


def test_seeded_init_statistics():
    cfg = gpt2.PRESETS["tiny"]
    a = gpt2.GPT2LMHeadModel(cfg, device="cpu", seed=3)
    b = gpt2.GPT2LMHeadModel(cfg, device="cpu", seed=3)
    assert all(torch.equal(x, y) for x, y in
               zip(a.state_dict().values(), b.state_dict().values()))
    assert abs(a.wte.std().item() - 0.02) < 2e-3
    assert abs(a.wpe.std().item() - 0.01) < 1e-3
    proj = a.h[0].attn.proj.weight.std().item()
    assert abs(proj - 0.02 / np.sqrt(2 * cfg.n_layer)) < 2e-3
    assert torch.equal(a.h[0].ln_1.weight, torch.ones(cfg.n_embd))


def test_masked_next_token_ce_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -100
    want = jax_common.masked_next_token_ce(jnp.asarray(logits),
                                           jnp.asarray(labels))
    got = common.masked_next_token_ce(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    allmasked = torch.full((3, 7), -100)
    assert float(common.masked_next_token_ce(torch.from_numpy(logits),
                                             allmasked)) == 0.0


def test_quant_dense_float_path_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 24)).astype(np.float32)
    layer = JaxDense(40)
    p = jax.tree.map(np.asarray,
                     layer.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    p["params"]["bias"] = rng.standard_normal(40).astype(np.float32)
    want = layer.apply(p, jnp.asarray(x))
    dense = QuantDense(24, 40)
    with torch.no_grad():
        dense.weight.copy_(torch.tensor(p["params"]["kernel"].T))
        dense.bias.copy_(torch.tensor(p["params"]["bias"]))
        got = dense(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_synthetic_batch_matches_jax():
    want = jax_gpt2.synthetic_batch(3, 9, 100, seed=5)["input_ids"]
    got = gpt2.synthetic_batch(3, 9, 100, seed=5, device="cpu")["input_ids"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
