"""Block-sparse BERT and GPT-2 in the PyTorch port against the JAX
package, on the CPU.

* The tiny sparse BERT (``tests/model/oracle.py``'s ``TINY_BERT_SPARSE``:
  Fixed block 8, 2 local blocks, 1 global, density 0.75) bridged from the
  flax init: the loss and every gradient at rtol = atol = 1e-5, with and
  without an ``attention_mask``.
* Trained through ``initialize`` with Adam, it reproduces
  ``tests/model/baselines/bert_sparse_tiny_fp32_adam.json`` at 1e-4, the
  bound ``tests/model/test_loss_parity.py`` holds the JAX engine to.
* With fused LAMB it matches the JAX engine's losses and params at 1e-5.
* The tiny GPT-2 with ``attention_mode="sparse:16/8"`` at seq 64 (a
  decomposition with both global rows and global columns): the loss and
  every gradient at 1e-5.
* ``SparseAttentionUtils`` and ``get_sparse_attention_config`` mirror
  ``tests/unit/test_sparse_attention_utils.py``.

The JAX side runs its Pallas kernels in interpret mode, its inits and
gradients jitted; the port the plain versions of its kernels.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.ops.sparse_attention import fused_kernels as jfk
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.bridge import (bert_flax_to_state_dict,
                                        flax_to_state_dict)
from deepspeed_tpu_torch.models import bert, gpt2
from deepspeed_tpu_torch.ops.sparse_attention import fused_kernels as fk
from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils import (
    SparseAttentionUtils, get_sparse_attention_config)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import \
    FixedSparsityConfig
from tests.model import oracle
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
BASELINE = os.path.join(os.path.dirname(__file__), "model", "baselines",
                        "bert_sparse_tiny_fp32_adam.json")
STEPS = 20


@pytest.fixture(scope="module")
def setup():
    """(flax model, flax params, oracle MLM batches as numpy)."""
    batches = [{k: np.array(v) for k, v in b.items()}
               for b in oracle.make_bert_batches(STEPS)]
    jm = jax_bert.BertForPreTraining(
        jax_bert.BertConfig(**oracle.TINY_BERT_SPARSE))
    params = jax.jit(jm.init)(jax.random.PRNGKey(oracle.SEED),
                              batches[0])["params"]
    return jm, jax.tree.map(np.asarray, params), batches


def _port_model(params):
    model = bert.BertForPreTraining(
        bert.BertConfig(**oracle.TINY_BERT_SPARSE), device="cpu")
    model.load_state_dict(bert_flax_to_state_dict(params))
    return model


def test_sparse_bridge_covers_every_parameter(setup):
    _, params, _ = setup
    model = _port_model(params)
    assert isinstance(model.layer[0], bert.BertSparseLayer)
    sd = bert_flax_to_state_dict(params)
    assert set(sd) == set(model.state_dict())
    np.testing.assert_array_equal(
        sd["layer.1.attention.qkv.weight"].numpy(),
        params["layer_1"]["attention"]["qkv"]["kernel"].T)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_gradients_match_jax(setup, masked):
    jm, params, batches = setup
    batch = dict(batches[3])
    if masked:
        mask = np.ones_like(batch["input_ids"])
        mask[0, -9:] = 0
        mask[3, -3:] = 0
        batch["attention_mask"] = mask
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.apply({"params": p}, b)))(
            jax.tree.map(jnp.asarray, params), jb)
    model = _port_model(params)
    loss = model({k: torch.from_numpy(v).long() for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    want = bert_flax_to_state_dict(jax.tree.map(np.asarray, want_grads))
    grads = dict(model.named_parameters())
    assert set(want) == set(grads)
    for k, w in want.items():
        np.testing.assert_allclose(grads[k].grad.numpy(), w.numpy(),
                                   err_msg=k, **TOL)


def _config(opt="Adam", **params):
    return {"train_batch_size": oracle.BATCH_SIZE,
            "train_micro_batch_size_per_gpu": oracle.BATCH_SIZE,
            "steps_per_print": 10 ** 9,
            "optimizer": {"type": opt, "params": params}}


def _run_port(params, batches, cfg):
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=bert.BertForPreTraining(
            bert.BertConfig(**oracle.TINY_BERT_SPARSE), device="cpu"),
        config=cfg, model_parameters=bert_flax_to_state_dict(params),
        device="cpu")
    return engine, [float(engine.train_batch(batch=b)) for b in batches]


def test_adam_reproduces_the_sparse_golden_curve(setup):
    _, params, batches = setup
    with open(BASELINE) as f:
        golden = json.load(f)["losses"]
    mc = oracle.TINY_BERT_SPARSE
    lay = FixedSparsityConfig(
        num_heads=mc["num_attention_heads"], block=mc["sparse_block"],
        num_local_blocks=mc["sparse_num_local_blocks"],
        num_global_blocks=mc["sparse_num_global_blocks"]
    ).make_layout(oracle.SEQ_LEN)
    assert lay.mean() < 1.0, "the golden layout degenerated to dense"
    engine, losses = _run_port(params, batches, _config(lr=oracle.LR))
    np.testing.assert_allclose(losses, golden, rtol=1e-4, atol=1e-4)
    assert engine.global_steps == STEPS


def test_fused_lamb_matches_jax_engine(setup):
    _, params, batches = setup
    cfg = _config("Lamb", lr=oracle.LAMB_LR, fused=True, weight_decay=0.01)
    batches = batches[:8]
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    jengine, *_ = deepspeed_tpu.initialize(
        model=jax_bert.BertForPreTraining(
            jax_bert.BertConfig(**oracle.TINY_BERT_SPARSE)),
        config=json.loads(json.dumps(cfg)), sample_batch=batches[0],
        seed=oracle.SEED)
    want_losses = [float(jengine.train_batch(batch=b)) for b in batches]
    want = bert_flax_to_state_dict(jax.tree.map(np.asarray,
                                                jengine.state.params))
    engine, losses = _run_port(params, batches, cfg)
    np.testing.assert_allclose(losses, want_losses, **TOL)
    got = engine.module.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k,
                                   **TOL)


def test_sparse_gpt2_matches_jax():
    """Causal sparse GPT-2 whose layout decomposes into dense global rows
    and packed global columns."""
    mode, seq = "sparse:16/8", 64
    jcfg = dataclasses.replace(jax_gpt2.PRESETS["tiny"], attention_mode=mode)
    lay, blk = jfk.sparse_mode_layout(mode, jcfg.n_head, seq)
    gr, gc, _ = fk._decompose_layout(lay != 0, True)
    assert len(gr) and len(gc)
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, seq),
                                            dtype=np.int32)
    jm = jax_gpt2.GPT2LMHeadModel(jcfg)
    jb = {"input_ids": jnp.asarray(ids)}
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jb)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.apply(p, b)))(params, jb)
    tm = gpt2.GPT2LMHeadModel(dataclasses.replace(
        gpt2.PRESETS["tiny"], attention_mode=mode), device="cpu")
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray,
                                                       params["params"])))
    loss = tm({"input_ids": torch.from_numpy(ids).long()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    want = flax_to_state_dict(jax.tree.map(np.asarray,
                                           want_grads["params"]))
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   err_msg=k, **TOL)


def test_sparse_gpt2_refuses_cached_decode():
    cfg = dataclasses.replace(gpt2.PRESETS["tiny"], attention_mode="sparse")
    model = gpt2.GPT2LMHeadModel(cfg, device="cpu")
    with pytest.raises(ValueError, match="KV-cache decode"):
        model({"input_ids": torch.zeros(1, 8, dtype=torch.long)},
              cache=model.new_cache(1))
    with pytest.raises(ValueError, match="sparse attention mode"):
        gpt2.GPT2LMHeadModel(dataclasses.replace(
            cfg, attention_mode="sparse:12/8"), device="cpu")


def test_sparse_bert_keeps_the_jax_asserts():
    cfg = bert.BertConfig(**oracle.TINY_BERT_SPARSE)
    with pytest.raises(ValueError, match="post-LN"):
        bert.BertForPreTraining(dataclasses.replace(
            cfg, pre_layer_norm=True), device="cpu")
    with pytest.raises(ValueError, match="attention-dropout"):
        bert.BertForPreTraining(dataclasses.replace(
            cfg, attention_probs_dropout_prob=0.1), device="cpu")
    # hidden dropout and remat are ported in sparse mode too
    for over in ({"hidden_dropout_prob": 0.1}, {"remat": True}):
        model = bert.BertForPreTraining(dataclasses.replace(cfg, **over),
                                        device="cpu")
        assert model.config.remat == ("remat" in over)
        assert model.layer[0].out_drop.p == over.get("hidden_dropout_prob",
                                                      0.0)
    for mode in ("bigbird", "bslongformer", "variable", "dense"):
        model = bert.BertForPreTraining(dataclasses.replace(
            cfg, sparse_attention_mode=mode), device="cpu")
        assert type(model.layer[0].attention.sparse_attn.sparsity_config
                    ).__name__.lower().startswith(mode[:4])
    with pytest.raises(ValueError, match="unknown sparse attention mode"):
        bert.BertForPreTraining(dataclasses.replace(
            cfg, sparse_attention_mode="nope"), device="cpu")


def test_sparse_attention_utils_config_wiring():
    ds = {"sparse_attention": {"mode": "fixed", "block": 8,
                               "num_local_blocks": 2}}
    sc = get_sparse_attention_config(ds, num_heads=4)
    assert isinstance(sc, FixedSparsityConfig)
    assert sc.block == 8 and sc.num_local_blocks == 2
    base = bert.BertConfig(vocab_size=512, hidden_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=256)
    cfg = SparseAttentionUtils.apply_to_bert_config(base, ds)
    assert cfg.sparse_attention_mode == "fixed"
    assert cfg.sparse_block == 8 and cfg.sparse_num_local_blocks == 2
    assert SparseAttentionUtils.apply_to_bert_config(base, {}) is base
    assert get_sparse_attention_config({}, 4) is None
    assert isinstance(get_sparse_attention_config({"sparse_attention": {}},
                                                  4), FixedSparsityConfig)
    with pytest.raises(NotImplementedError):
        get_sparse_attention_config({"sparse_attention": {"mode": "nope"}},
                                    4)
    with pytest.raises(ValueError):
        get_sparse_attention_config({"sparse_attention": True}, 4)
    with pytest.raises(ValueError, match="not representable"):
        SparseAttentionUtils.apply_to_bert_config(
            base, {"sparse_attention": {"mode": "fixed",
                                        "attention": "unidirectional"}})
    # the engine config keeps the raw block, as the JAX config does
    raw = deepspeed_tpu_torch.DeepSpeedConfig(dict(
        _config(lr=1e-3), **ds)).sparse_attention
    assert raw == ds["sparse_attention"]


def test_pad_to_block_size_roundtrip():
    ids = torch.ones((2, 30), dtype=torch.long)
    pad, pids, pmask = SparseAttentionUtils.pad_to_block_size(16, ids)
    assert pad == 2 and pids.shape == (2, 32) and pmask.shape == (2, 32)
    assert int(pmask[:, -2:].sum()) == 0
    out = torch.zeros((2, 32, 8))
    assert SparseAttentionUtils.unpad_sequence_output(pad, out).shape == \
        (2, 30, 8)
    pad0, ids0, mask0 = SparseAttentionUtils.pad_to_block_size(16, pids,
                                                               pmask)
    assert pad0 == 0 and ids0 is pids and mask0 is pmask
    pad1, _, mask1 = SparseAttentionUtils.pad_to_block_size(16, pids)
    assert pad1 == 0 and mask1 is not None and mask1.shape == (2, 32)


def test_padded_sparse_bert_trains_through_the_utils():
    """pad_to_block_size, then the sparse model with the padding mask:
    the loss equals the JAX model's on the same padded batch."""
    ids = np.random.default_rng(9).integers(0, 512, (2, 27))
    labels = np.where(np.random.default_rng(10).random((2, 27)) < 0.2, ids,
                      -100)
    pad, pids, pmask = SparseAttentionUtils.pad_to_block_size(
        8, torch.from_numpy(ids))
    plabels = torch.nn.functional.pad(torch.from_numpy(labels), (0, pad),
                                      value=-100)
    jm = jax_bert.BertForPreTraining(
        jax_bert.BertConfig(**oracle.TINY_BERT_SPARSE))
    jb = {"input_ids": jnp.asarray(pids.numpy()),
          "attention_mask": jnp.asarray(pmask.numpy()),
          "labels": jnp.asarray(plabels.numpy())}
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), jb)["params"]
    want = float(jax.jit(jm.apply)({"params": params}, jb))
    model = _port_model(jax.tree.map(np.asarray, params))
    got = model({"input_ids": pids, "attention_mask": pmask,
                 "labels": plabels})
    np.testing.assert_allclose(got.item(), want, **TOL)
