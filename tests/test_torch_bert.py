"""The PyTorch port's BERT (``models/bert.py``, the fused
``DeepSpeedTransformerLayer`` and ``bert_flax_to_state_dict``) against
the JAX package's ``BertForPreTraining``.

The flax model is initialised from ``PRNGKey(0)``, its params are bridged
into the port, and both run the same numpy batches in fp32: the JAX side
on its Pallas LayerNorm and bias-GeLU kernels in interpret mode, the port
on the plain versions its wrappers take on CPU tensors. Tolerance: loss,
logits and every parameter's gradient at rtol = atol = 1e-5 (the same fp32
formulas, summed in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu_torch.bridge import bert_flax_to_state_dict
from deepspeed_tpu_torch.models import bert
from deepspeed_tpu_torch.ops.transformer import transformer
from deepspeed_tpu_torch.runtime import dropout

TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 4, 24


def _batch(kind):
    """A numpy MLM batch: ``labels``, ``masked_positions`` or ``labels``
    with a [B, S] ``attention_mask`` that pads the tails."""
    cfg = jax_bert.PRESETS["tiny"]
    fmt = kind == "masked_positions"
    b = {k: np.array(v) for k, v in jax_bert.synthetic_mlm_batch(
        B, S, cfg.vocab_size, seed=11, masked_positions_format=fmt).items()}
    if kind == "attention_mask":
        mask = np.ones((B, S), np.int32)
        for i in range(B):
            mask[i, S - 3 * i:] = 0
        b["attention_mask"] = mask
    return b


def _models(pre_ln):
    jcfg = dataclasses.replace(jax_bert.PRESETS["tiny"],
                               pre_layer_norm=pre_ln)
    jmodel = jax_bert.BertForPreTraining(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         {k: jnp.asarray(v)
                          for k, v in _batch("labels").items()})["params"]
    tcfg = dataclasses.replace(bert.PRESETS["tiny"], pre_layer_norm=pre_ln)
    tmodel = bert.BertForPreTraining(tcfg, device="cpu")
    tmodel.load_state_dict(bert_flax_to_state_dict(
        jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def test_presets_match_jax():
    for name, cfg in bert.PRESETS.items():
        want = dataclasses.asdict(jax_bert.PRESETS[name])
        assert dataclasses.asdict(cfg) == want, name
        assert cfg.padded_vocab == jax_bert.PRESETS[name].padded_vocab
    assert bert.PRESETS["bert-large"].padded_vocab == 30592


def test_bridge_layout():
    _, params, tmodel = _models(pre_ln=False)
    sd = bert_flax_to_state_dict(jax.tree.map(np.asarray, params))
    assert sd.keys() == tmodel.state_dict().keys()
    lay = params["layer_1"]["layer"]
    np.testing.assert_array_equal(sd["layer.1.layer.attn_qkv.weight"].numpy(),
                                  np.asarray(lay["attn_qkv"]["kernel"]).T)
    np.testing.assert_array_equal(sd["layer.1.layer.inter_w"].numpy(),
                                  np.asarray(lay["inter_w"]))
    np.testing.assert_array_equal(sd["mlm_ln.weight"].numpy(),
                                  np.asarray(params["mlm_ln"]["scale"]))


@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("kind", ["labels", "masked_positions",
                                  "attention_mask"])
def test_loss_and_grads_match_flax(pre_ln, kind):
    jmodel, params, tmodel = _models(pre_ln)
    nb = _batch(kind)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jb))(params)
    loss = tmodel({k: torch.from_numpy(v) for k, v in nb.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    want = bert_flax_to_state_dict(jax.tree.map(np.asarray, want_grads))
    got = dict(tmodel.named_parameters())
    assert want.keys() == got.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].grad.numpy(), w.numpy(),
                                   err_msg=k, **TOL)


def test_logits_without_labels_match_flax():
    jmodel, params, tmodel = _models(pre_ln=False)
    ids = _batch("labels")["input_ids"]
    want = jmodel.apply({"params": params}, {"input_ids": jnp.asarray(ids)})
    with torch.no_grad():
        got = tmodel({"input_ids": torch.from_numpy(ids)})
    assert got.dtype == torch.float32
    assert got.shape == (B, S, bert.PRESETS["tiny"].padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fmt", [False, True])
def test_synthetic_mlm_batch_matches_jax(fmt):
    want = jax_bert.synthetic_mlm_batch(8, 128, 30522, seed=4,
                                        masked_positions_format=fmt)
    got = bert.synthetic_mlm_batch(8, 128, 30522, seed=4,
                                   masked_positions_format=fmt, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if not fmt:
        masked = (got["labels"] >= 0).float().mean().item()
        assert 0.1 < masked < 0.2


def test_seeded_init_statistics():
    model = bert.BertForPreTraining(bert.PRESETS["tiny"], device="cpu",
                                    seed=3)
    lay = model.layer[0].layer
    assert abs(lay.inter_w.std().item() - 0.02) < 0.002
    assert abs(model.word_embeddings.std().item() - 0.02) < 0.002
    assert torch.all(lay.attn_ln_gamma == 1) and torch.all(lay.inter_b == 0)
    assert torch.all(model.mlm_bias == 0)
    again = bert.BertForPreTraining(bert.PRESETS["tiny"], device="cpu",
                                    seed=3)
    assert torch.equal(again.layer[1].layer.attn_qkv.weight,
                       model.layer[1].layer.attn_qkv.weight)


@pytest.mark.parametrize("field,value", [
    ("sparse_attention_mode", "fixed"), ("hidden_dropout_prob", 0.1),
    ("attention_probs_dropout_prob", 0.1), ("remat", True)])
def test_unported_options_raise(field, value):
    """Each of these options is ported now (sparse attention, dropout,
    remat): the model builds and the option acts. Sparse mode with hidden
    dropout builds; with attention dropout it raises, as JAX asserts."""
    cfg = dataclasses.replace(bert.PRESETS["tiny"], **{field: value})
    if field == "sparse_attention_mode":
        model = bert.BertForPreTraining(cfg, device="cpu")
        assert isinstance(model.layer[0], bert.BertSparseLayer)
        cfg = dataclasses.replace(cfg, hidden_dropout_prob=0.1)
        with pytest.raises(ValueError, match="attention-dropout"):
            bert.BertForPreTraining(dataclasses.replace(
                cfg, attention_probs_dropout_prob=0.1), device="cpu")
    model = dropout.number_sites(bert.BertForPreTraining(cfg, device="cpu"))
    batch = bert.synthetic_mlm_batch(2, 16, 512, seed=0, device="cpu")
    plain = model(batch)
    with dropout.key_scope((0, 0)):
        keyed = model(batch)
    if field == "remat":
        assert torch.equal(keyed, plain)          # no dropout configured
    else:
        assert not torch.equal(keyed, plain)      # masks drawn


def test_layer_unported_options_and_long_sequences_raise():
    """Dropout and the remat knobs are ported: the layer builds and, with a
    key in scope, draws masks (dropout) or gives the plain layer's output
    (remat); tensor-parallel rules and over-long sequences still raise."""
    x = torch.randn(2, 8, 32)
    base = transformer.DeepSpeedTransformerLayer(
        transformer.DeepSpeedTransformerConfig(hidden_size=32, heads=2),
        device="cpu")
    for over in ({"hidden_dropout_ratio": 0.1}, {"attn_dropout_ratio": 0.1},
                 {"normalize_invertible": True}, {"gelu_checkpoint": True}):
        cfg = transformer.DeepSpeedTransformerConfig(hidden_size=32, heads=2,
                                                     **over)
        layer = dropout.number_sites(
            transformer.DeepSpeedTransformerLayer(cfg, device="cpu"))
        layer.load_state_dict(base.state_dict())
        with dropout.key_scope((1, 0)):
            out = layer(x)
        assert torch.equal(out, base(x)) == cfg.wants_remat
    with pytest.raises(NotImplementedError, match="not ported yet"):
        transformer.transformer_tp_rules()
    model = bert.BertForPreTraining(bert.PRESETS["tiny"], device="cpu")
    ids = torch.zeros((1, 129), dtype=torch.long)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model({"input_ids": ids})
