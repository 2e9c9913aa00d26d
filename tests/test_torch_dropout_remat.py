"""Dropout and activation checkpointing (remat) on the PyTorch port, on
the CPU.

Dropout (``runtime/dropout.py``): the masks are keyed by (seed,
micro-step, site) and are not JAX's threefry draws, so the port is held
to its own mask semantics (keep share, the 1 / (1 - p) scale,
determinism, distinct masks across sites, steps and seeds, none in eval
or without a key) and to JAX where no mask is drawn: eval mode and
dropout 0. Remat (``checkpointing.remat``): with dropout 0.1, gradients
with remat on are bit-equal to remat off (the recompute draws the same
masks), for tiny GPT-2, the fused encoder layer under each of its three
memory knobs, and the sparse BERT layer; at dropout 0 the port's remat
matches the JAX models' ``nn.remat`` (loss and every gradient at
rtol = atol = 1e-5, the bound of ``tests/test_torch_bert.py``).
``checkpointing.checkpoint`` matches the JAX function on a small
function (values and gradients at atol 1e-6, the JAX package's own
test's bound), with ``cpu_checkpointing`` on too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.runtime import config as jax_config
from deepspeed_tpu.runtime.activation_checkpointing import \
    checkpointing as jax_ckpt
from deepspeed_tpu_torch.bridge import (bert_flax_to_state_dict,
                                        flax_to_state_dict)
from deepspeed_tpu_torch.models import bert, gpt2
from deepspeed_tpu_torch.ops.transformer import transformer
from deepspeed_tpu_torch.runtime import dropout
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from tests.model import oracle
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _fresh_checkpointing():
    checkpointing.reset()
    yield
    checkpointing.reset()


# ------------------------------------------------------------ dropout


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_share_and_scale(p):
    x = torch.ones(64, 1024)
    with dropout.key_scope((42, 0)):
        y = dropout.dropout(x, p, site=3)
    kept = y != 0
    share = kept.float().mean().item()
    # 65536 draws: the share's std is at most 0.002
    assert abs(share - (1 - p)) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / (1 - p)))


def test_masks_are_keyed_by_seed_step_and_site():
    x = torch.randn(8, 256)

    def draw(seed, step, site):
        with dropout.key_scope((seed, step)):
            return dropout.dropout(x, 0.1, site)

    base = draw(42, 7, 1)
    assert torch.equal(base, draw(42, 7, 1))            # a rerun
    for other in (draw(42, 8, 1), draw(42, 7, 2), draw(43, 7, 1)):
        assert not torch.equal((other != 0), (base != 0))
    assert len({dropout.mask_seed(s, t, i) for s in range(3)
                for t in range(3) for i in range(3)}) == 27


def test_no_mask_without_a_key_in_eval_or_at_zero():
    x = torch.randn(4, 32)
    assert dropout.dropout(x, 0.1, 0) is x               # no key
    mod = dropout.number_sites(dropout.Dropout(0.1))
    with dropout.key_scope((0, 0)):
        assert not torch.equal(mod(x), x)
        assert dropout.Dropout(0.0)(x) is x
        mod.eval()
        assert mod(x) is x
    assert dropout.current_key() is None
    for bad in (-0.1, 1.0):
        with pytest.raises(ValueError, match="dropout rate"):
            dropout.Dropout(bad)


def test_engine_numbers_the_sites():
    g = gpt2.GPT2LMHeadModel(gpt2.GPT2Config(**oracle.TINY, dropout=0.1),
                             device="cpu")
    b = bert.BertForPreTraining(bert.BertConfig(
        **oracle.TINY_BERT, hidden_dropout_prob=0.1,
        attention_probs_dropout_prob=0.1), device="cpu")
    for model, n in ((g, 2 * oracle.TINY["n_layer"] + 1),
                     (b, 2 * oracle.TINY_BERT["num_hidden_layers"] + 1)):
        assert all(m.site is None for m in model.modules()
                   if isinstance(m, dropout.Dropout))
        deepspeed_tpu_torch.initialize(
            model=model, config={"train_batch_size": 8}, device="cpu")
        sites = [m.site for m in model.modules()
                 if isinstance(m, dropout.Dropout)]
        assert sites == list(range(n))


class _TwoLayers(torch.nn.Module):
    """A user's model: two fused encoder layers, stacked."""

    def __init__(self, cfg):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            [transformer.DeepSpeedTransformerLayer(cfg, device="cpu")
             for _ in range(2)])

    def forward(self, batch):
        x = batch["x"]
        for layer in self.layers:
            x = layer(x)
        return (x ** 2).mean()


def test_stacked_layers_draw_distinct_masks_through_the_engine():
    """Layers a user stacks in a module of their own draw a mask of their
    own at each site, as flax's make_rng folds in the module path."""
    torch.manual_seed(0)
    cfg = transformer.DeepSpeedTransformerConfig(
        hidden_size=32, heads=2, attn_dropout_ratio=0.1,
        hidden_dropout_ratio=0.1)
    model = _TwoLayers(cfg)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config={"train_batch_size": 4,
                             "steps_per_print": 10 ** 9},
        device="cpu")
    masks = {}
    for name, mod in model.named_modules():
        if isinstance(mod, dropout.Dropout):
            mod.register_forward_hook(
                lambda m, i, o, name=name: masks.__setitem__(name, o == 0))
    x = torch.randn(4, 16, 32, generator=torch.Generator().manual_seed(1))
    engine.forward({"x": x})
    assert sorted(m.site for m in model.modules()
                  if isinstance(m, dropout.Dropout)) == [0, 1, 2, 3]
    for site in ("attn_drop", "out_drop"):
        a, b = masks[f"layers.0.{site}"], masks[f"layers.1.{site}"]
        assert a.any() and b.any()
        assert not torch.equal(a, b), site


def test_unnumbered_site_raises_under_a_key():
    """Outside the engine an unnumbered site refuses to draw a mask (it
    would share one with every other unnumbered site)."""
    layer = transformer.DeepSpeedTransformerLayer(
        transformer.DeepSpeedTransformerConfig(
            hidden_size=32, heads=2, hidden_dropout_ratio=0.1),
        device="cpu")
    x = torch.randn(2, 8, 32)
    layer(x)                                     # no key: no mask
    with dropout.key_scope((0, 0)), \
            pytest.raises(RuntimeError, match="not numbered"):
        layer(x)
    with dropout.key_scope((0, 0)):
        dropout.number_sites(layer)(x)


def _gpt2_engine(remat=False, p=0.1, **cfg_over):
    cfg = dataclasses.replace(gpt2.GPT2Config(**oracle.TINY), dropout=p,
                              remat=remat)
    model = gpt2.GPT2LMHeadModel(cfg, device="cpu", seed=1)
    config = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    config.update(cfg_over)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                device="cpu", seed=5)
    return engine


def test_engine_forward_is_keyed_by_seed_and_micro_step():
    engine = _gpt2_engine()
    batch = gpt2.synthetic_batch(8, 32, 512, seed=0, device="cpu")
    a = engine.forward(batch).detach()
    b = engine.forward(batch).detach()
    assert torch.equal(a, b)               # same (seed, micro-step)
    engine.backward(engine.forward(batch))
    c = engine.forward(batch).detach()     # the next micro-step
    assert not torch.equal(a, c)
    ev = engine.eval_batch(batch)
    assert not torch.equal(ev, a) and engine.module.training
    other = _gpt2_engine()
    other._seed = 6
    assert not torch.equal(other.forward(batch).detach(), a)


# -------------------------------------------------------------- remat


def _grads(model, loss_fn):
    for p in model.parameters():
        p.grad = None
    loss = loss_fn()
    loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in model.named_parameters()}


def _assert_bit_equal(a, b):
    assert torch.equal(a[0], b[0])
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_gpt2_remat_gradients_bit_equal_with_dropout(precision):
    """Through the engine (masters cast to the compute dtype outside the
    recomputed blocks): the loss and every master gradient of one
    micro-batch at dropout 0.1, remat on and off."""
    over = {"bf16": {"enabled": True}} if precision == "bf16" else {}
    batch = gpt2.synthetic_batch(8, 32, 512, seed=2, device="cpu")
    out = []
    for remat in (False, True):
        engine = _gpt2_engine(remat=remat, **over)
        loss = engine.forward(batch)
        engine.backward(loss)
        out.append((loss.detach(), {k: p.grad.clone()
                                    for k, p in engine.params.items()}))
    _assert_bit_equal(*out)


@pytest.mark.parametrize("knob", ["normalize_invertible", "gelu_checkpoint",
                                  "attn_dropout_checkpoint"])
@pytest.mark.parametrize("pre_ln", [False, True])
def test_fused_layer_remat_bit_equal_with_dropout(knob, pre_ln):
    base = transformer.DeepSpeedTransformerConfig(
        hidden_size=64, heads=4, intermediate_size=256,
        attn_dropout_ratio=0.1, hidden_dropout_ratio=0.1,
        pre_layer_norm=pre_ln)
    x = torch.randn(4, 16, 64, generator=torch.Generator().manual_seed(0))
    mask = torch.ones(4, 16)
    mask[1, 12:] = 0
    out = []
    for cfg in (base, dataclasses.replace(base, **{knob: True})):
        layer = dropout.number_sites(
            transformer.DeepSpeedTransformerLayer(cfg, device="cpu"))
        layer.reset_parameters(torch.Generator().manual_seed(1))
        xs = x.clone().requires_grad_(True)

        def loss_fn():
            with dropout.key_scope((3, 4)):
                return (layer(xs, mask) ** 2).mean()
        loss, grads = _grads(layer, loss_fn)
        out.append((loss, dict(grads, x=xs.grad.clone())))
    _assert_bit_equal(*out)
    assert not torch.equal(out[0][1]["x"], torch.zeros_like(x))


def test_bert_remat_bit_equal_with_dropout_dense_and_sparse():
    batch = bert.synthetic_mlm_batch(8, 32, 512, seed=1000, device="cpu")
    for mode_over in ({"attention_probs_dropout_prob": 0.1},
                      oracle.TINY_BERT_SPARSE):
        out = []
        for remat in (False, True):
            cfg = bert.BertConfig(**dict(oracle.TINY_BERT, **mode_over,
                                         hidden_dropout_prob=0.1,
                                         remat=remat))
            model = dropout.number_sites(
                bert.BertForPreTraining(cfg, device="cpu"))

            def loss_fn():
                with dropout.key_scope((9, 2)):
                    return model(batch)
            out.append(_grads(model, loss_fn))
        _assert_bit_equal(*out)
        if "sparse_attention_mode" in mode_over:
            assert isinstance(model.layer[0], bert.BertSparseLayer)


def test_remat_keeps_fewer_tensors_for_the_backward():
    """The memory claim: with remat only each block's inputs (and the
    ends of the model) are saved for the backward."""
    batch = gpt2.synthetic_batch(8, 32, 512, seed=3, device="cpu")
    saved = {}
    for remat in (False, True):
        model = gpt2.GPT2LMHeadModel(dataclasses.replace(
            gpt2.GPT2Config(**oracle.TINY), remat=remat), device="cpu")
        n = [0]

        def pack(t):
            n[0] += t.numel()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model(batch)
        saved[remat] = n[0]
    assert saved[True] < 0.5 * saved[False]


def _jax_grads(model, params, batch):
    def loss(p):
        return model.apply({"params": p}, batch)
    value, grads = jax.value_and_grad(loss)(params)
    return float(value), grads


@pytest.mark.parametrize("family", ["gpt2", "bert", "bert_sparse"])
def test_port_remat_matches_jax_remat_at_dropout_zero(family):
    if family == "gpt2":
        batch = {"input_ids": np.array(
            oracle.make_batches(1)[0]["input_ids"])}
        jmodel = jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(
            **oracle.TINY, remat=True))
        to_sd = flax_to_state_dict
        pmodel = gpt2.GPT2LMHeadModel(gpt2.GPT2Config(
            **oracle.TINY, remat=True), device="cpu")
    else:
        over = oracle.TINY_BERT_SPARSE if family == "bert_sparse" \
            else oracle.TINY_BERT
        batch = {k: np.array(v) for k, v in
                 oracle.make_bert_batches(1)[0].items()}
        jmodel = jax_bert.BertForPreTraining(jax_bert.BertConfig(
            **over, remat=True))
        to_sd = bert_flax_to_state_dict
        pmodel = bert.BertForPreTraining(bert.BertConfig(
            **over, remat=True), device="cpu")
    params = jmodel.init(jax.random.PRNGKey(0), batch)["params"]
    want_loss, want = _jax_grads(jmodel, params, batch)
    pmodel.load_state_dict(to_sd(jax.tree.map(np.asarray, params)))
    tbatch = {k: torch.from_numpy(np.asarray(v)).long()
              for k, v in batch.items()}
    loss, grads = _grads(pmodel, lambda: pmodel(tbatch))
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    want = to_sd(jax.tree.map(np.asarray, want))
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k,
                                   **TOL)


def test_sparse_bert_refuses_attention_dropout_as_jax_does():
    cfg = bert.BertConfig(**oracle.TINY_BERT_SPARSE,
                          attention_probs_dropout_prob=0.1)
    with pytest.raises(ValueError, match="attention-dropout"):
        bert.BertForPreTraining(cfg, device="cpu")
    batch = {k: np.array(v) for k, v in
             oracle.make_bert_batches(1)[0].items()}
    with pytest.raises(AssertionError, match="attention-dropout"):
        jax_bert.BertForPreTraining(jax_bert.BertConfig(
            **oracle.TINY_BERT_SPARSE, attention_probs_dropout_prob=0.1)
        ).init(jax.random.PRNGKey(0), batch)


# ------------------------------------------------------ checkpointing


def _fn_pair():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    w = (rng.standard_normal((8, 8)) / 3).astype(np.float32)

    def jfn(x):
        for _ in range(3):
            x = jnp.tanh(x @ w)
        return x

    def tfn(x):
        wt = torch.from_numpy(w)
        for _ in range(3):
            x = torch.tanh(x @ wt)
        return x
    return x, jfn, tfn


@pytest.mark.parametrize("cpu", [False, True])
@pytest.mark.parametrize("form", ["checkpoint", "wrapper"])
def test_checkpoint_matches_jax(cpu, form, monkeypatch):
    x, jfn, tfn = _fn_pair()
    want = jfn(jnp.asarray(x))
    want_g = jax.grad(lambda v: jnp.sum(jax_ckpt.checkpoint(jfn, v) ** 2))(
        jnp.asarray(x))
    used = []
    real = torch.autograd.graph.save_on_cpu

    def recording(pin_memory=False, **kw):
        used.append(pin_memory)
        return real(pin_memory=pin_memory, **kw)
    monkeypatch.setattr(torch.autograd.graph, "save_on_cpu", recording)
    if cpu:
        checkpointing.configure(checkpoint_in_cpu=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    fn = checkpointing.checkpoint_wrapper(tfn) if form == "wrapper" \
        else (lambda v: checkpointing.checkpoint(tfn, v))
    out = fn(xt)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                               atol=1e-6)
    assert used == ([True] if cpu else [])


def test_checkpoint_of_a_module_under_a_cast():
    """A module checkpointed inside ``functional_call`` with bf16 casts of
    its fp32 masters: the recompute binds the casts again, so the master
    gradients equal the plain call's bit for bit."""
    layer = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.GELU(),
                                torch.nn.Linear(32, 16))
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))

    class Wrap(torch.nn.Module):
        def __init__(self, remat):
            super().__init__()
            self.inner = layer
            self.remat = remat

        def forward(self, x):
            y = checkpointing.checkpoint(self.inner, x) if self.remat \
                else self.inner(x)
            return y.float().square().mean()

    out = []
    for remat in (False, True):
        wrap = Wrap(remat)
        params = dict(wrap.named_parameters())
        cast = {k: p.to(torch.bfloat16) for k, p in params.items()}
        for p in params.values():
            p.grad = None
        loss = torch.func.functional_call(wrap, cast,
                                          (x.to(torch.bfloat16),))
        loss.backward()
        out.append((loss.detach(), {k: p.grad.clone()
                                    for k, p in params.items()}))
        assert all(p.dtype == torch.float32 for p in params.values())
    _assert_bit_equal(*out)


def test_configure_reads_the_config_block_like_jax():
    block = {"partition_activations": True, "cpu_checkpointing": True,
             "contiguous_memory_optimization": True,
             "number_checkpoints": 4,
             "synchronize_checkpoint_boundary": True, "profile": True}
    raw = {"train_batch_size": 8,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "activation_checkpointing": block}
    assert not checkpointing.is_configured()
    checkpointing.configure(deepspeed_config=DeepSpeedConfig(dict(raw)),
                            num_checkpoints=6)
    jax_ckpt.reset()
    try:
        jax_ckpt.configure(deepspeed_config=jax_config.DeepSpeedConfig(
            dict(raw)), num_checkpoints=6)
        assert checkpointing._CONFIG == jax_ckpt._CONFIG
    finally:
        jax_ckpt.reset()
    assert checkpointing.is_configured()
    acfg = DeepSpeedConfig(dict(raw)).activation_checkpointing_config
    assert (acfg.number_checkpoints, acfg.cpu_checkpointing) == (4, True)
    checkpointing.reset()
    assert not checkpointing.is_configured()
    assert checkpointing._CONFIG == checkpointing._DEFAULTS
    off = DeepSpeedConfig({"train_batch_size": 8})
    assert not off.activation_checkpointing_config.cpu_checkpointing
    # partition_activations is the identity: one rank, no model parallelism
    checkpointing.configure(partition_activations=True)
    x, _, tfn = _fn_pair()
    np.testing.assert_array_equal(
        checkpointing.checkpoint(tfn, torch.from_numpy(x)).numpy(),
        tfn(torch.from_numpy(x)).numpy())


def test_rng_tracker_surface():
    with pytest.raises(NotImplementedError, match="seed"):
        checkpointing.get_cuda_rng_tracker()
    with pytest.raises(NotImplementedError):
        jax_ckpt.get_cuda_rng_tracker()
    assert checkpointing.model_parallel_cuda_manual_seed(1) is None
    assert jax_ckpt.model_parallel_cuda_manual_seed(1) is None
