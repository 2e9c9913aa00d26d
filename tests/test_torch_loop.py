"""The training loop users write on the PyTorch port (``engine.forward`` /
``backward`` / ``step``, ``eval_batch``, ``get_global_grad_norm``, the
SGD and Adagrad optimizers, a client optimizer and scheduler,
``initialize(args=)``, ``init_distributed`` and ``add_config_arguments``)
on the CPU, against the JAX engine's loop on the same inputs.

The tiny GPT-2 starts from the flax init of ``tests/model/oracle``
(``PRNGKey(0)``) bridged by ``flax_to_state_dict``, and trains on the
oracle's batches (bs 8, seq 32). Tolerances:

* the loop against the JAX loop (fp32 Adam, gas 2, 4 steps), SGD (tiny
  GPT-2) and Adagrad (``SimpleModel``) through 3 engine steps, eval
  losses: per-step losses and final
  params at rtol = atol = 1e-5, the bound ``tests/test_torch_engine.py``
  holds ``train_batch`` to against the JAX engine;
* ``gpt2_tiny_fp32_adam`` through the loop: rtol = atol = 1e-4, the
  golden curve's bound;
* the loop against the port's own ``train_batch``: bit-equal (one code
  path);
* the grad norm: fp32 at 1e-5; bf16 and fp16 at rtol 0.05 (the two
  engines round the reduced-precision forward at other points; the
  None/float pattern is compared exactly).
"""

import argparse
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.models import simple as jax_simple
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.bridge import (bert_flax_to_state_dict,
                                        flax_to_state_dict,
                                        simple_flax_to_state_dict)
from deepspeed_tpu_torch.models import bert, gpt2, simple
from deepspeed_tpu_torch.runtime import lr_schedules, optim
from tests.model import oracle

BASELINE = os.path.join(os.path.dirname(__file__), "model", "baselines",
                        "gpt2_tiny_fp32_adam.json")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny model's ops are microseconds long: one intra-op thread
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """(golden losses, oracle batches as numpy, bridged initial state)."""
    with open(BASELINE) as f:
        golden = json.load(f)["losses"]
    batches = [{"input_ids": np.array(b["input_ids"])}
               for b in oracle.make_batches(20)]
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


def _micro(batch, gas):
    mb = oracle.BATCH_SIZE // gas
    return [{"input_ids": batch["input_ids"][i * mb:(i + 1) * mb]}
            for i in range(gas)]


def _port_engine(init, cfg, **kw):
    model = gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=cfg, model_parameters=init, device="cpu", **kw)
    return engine


def _jax_engine(cfg, batches):
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    engine, *_ = deepspeed_tpu.initialize(
        model=jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(**oracle.TINY)),
        config=cfg, sample_batch=batches[0], seed=oracle.SEED)
    return engine


def _loop(engine, batches, gas):
    """forward/backward over each batch's gas micro-batches, then step;
    the per-micro-batch losses."""
    losses = []
    for batch in batches:
        for micro in _micro(batch, gas):
            loss = engine.forward(micro)
            engine.backward(loss)
            losses.append(float(np.asarray(loss.detach() if hasattr(
                loss, "detach") else loss)))
        engine.step()
    return losses


def _jax_params(engine):
    return flax_to_state_dict(jax.tree.map(np.asarray, engine.state.params))


def _assert_params(engine, want, **tol):
    got = engine.module.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k,
                                   **(tol or TOL))


# ----------------------------------------------------------- the loop


@pytest.mark.parametrize("gas,over", [
    (2, {}),
    (2, {"gradient_clipping": 0.5, "optimizer": {"type": "AdamW", "params": {
        "lr": 2e-3, "weight_decay": 0.01}}}),
    (1, {"gradient_clipping": 0.5, "optimizer": {"type": "AdamW", "params": {
        "lr": 2e-3, "weight_decay": 0.01, "sweep": True}},
         "scheduler": {"type": "WarmupLR", "params": {
             "warmup_min_lr": 1e-4, "warmup_max_lr": 2e-3,
             "warmup_num_steps": 8}}}),
])
def test_loop_matches_jax_loop(setup, gas, over):
    """The JAX engine's forward/backward/step against the port's on tiny
    GPT-2 fp32: per-micro-batch losses and final params at 1e-5."""
    _, batches, init = setup
    batches = batches[:4]
    cfg = _config(train_micro_batch_size_per_gpu=oracle.BATCH_SIZE // gas,
                  **over)
    jeng = _jax_engine(dict(cfg), batches)
    want = _loop(jeng, batches, gas)
    peng = _port_engine(init, dict(cfg))
    got = _loop(peng, batches, gas)
    np.testing.assert_allclose(got, want, **TOL)
    _assert_params(peng, _jax_params(jeng))
    assert peng.global_steps == jeng.global_steps == 4
    assert peng.micro_steps == jeng.micro_steps == 4 * gas


@pytest.mark.parametrize("gas", [1, 2])
def test_loop_reproduces_golden_curve(setup, gas):
    """The global step's loss is the mean of its micro-batch losses."""
    golden, batches, init = setup
    engine = _port_engine(init, _config(
        train_micro_batch_size_per_gpu=oracle.BATCH_SIZE // gas))
    losses = []
    for batch in batches:
        step = []
        for m in _micro(batch, gas):
            loss = engine.forward(m)
            engine.backward(loss)
            step.append(float(loss.detach()))
        engine.step()
        losses.append(float(np.mean(step)))
    np.testing.assert_allclose(losses, golden, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,over", [
    ("fp32_gas2", {"train_micro_batch_size_per_gpu": 4}),
    ("bf16_clip", {"bf16": {"enabled": True}, "gradient_clipping": 1.0}),
    ("bf16_acc_gas2", {"bf16": {"enabled": True},
                       "train_micro_batch_size_per_gpu": 4,
                       "gradient_accumulation_dtype": "bf16"}),
    ("fp16_dynamic", {"fp16": {"enabled": True, "loss_scale": 0,
                               "initial_scale_power": 8}}),
    ("sweep_warmup", {"optimizer": {"type": "Adam", "params": {
        "lr": 2e-3, "sweep": True}}, "scheduler": {
        "type": "WarmupLR", "params": {"warmup_max_lr": 2e-3,
                                       "warmup_num_steps": 3}}}),
])
def test_loop_is_bit_equal_to_train_batch(setup, name, over):
    _, batches, init = setup
    cfg = _config(**over)
    a = _port_engine(init, dict(cfg))
    b = _port_engine(init, dict(cfg))
    gas = a.gradient_accumulation_steps()
    for batch in batches[:4]:
        want = a.train_batch(data_iter=iter(_micro(batch, gas)))
        got = []
        for m in _micro(batch, gas):
            loss = b.forward(m)
            b.backward(loss)
            got.append(loss.detach())
        b.step()
        assert torch.equal(torch.stack(got).mean(), want)
    for (k, x), y in zip(a.module.state_dict().items(),
                         b.module.state_dict().values()):
        assert torch.equal(x, y), k
    assert a.global_steps == b.global_steps == 4
    assert a.loss_scale == b.loss_scale


def _acc_buffer(engine):
    """The accumulation buffer as fp32 numpy, keyed as the state_dict."""
    if hasattr(engine, "state"):
        return {k: v.numpy() for k, v in flax_to_state_dict(jax.tree.map(
            lambda a: np.asarray(a.astype(np.float32)),
            engine.state.acc_grads)).items()}
    return {k: v.float().numpy() for k, v in engine._acc.items()}


def test_gas1_accumulation_dtype_follows_jax(setup):
    """gas 1 with ``gradient_accumulation_dtype`` bf16: the JAX
    ``forward`` casts each gradient into the bf16 buffer (engine.py:1534),
    its fused gas-1 ``train_batch`` keeps them fp32 (engine.py:1702); so
    does the port. SGD, whose update is the gradient itself: the buffer
    after one forward/backward is bf16 in both engines and agrees within
    one bf16 ulp (rtol 1e-2); the loop and ``train_batch`` each match
    JAX's at 1e-5; ``train_batch`` is bit-equal to the run without the
    buffer dtype, the loop is not, in both engines."""
    _, batches, init = setup
    batches = batches[:3]
    base = _config(optimizer={"type": "SGD", "params": {"lr": 0.01}})
    cfg = dict(base, gradient_accumulation_dtype="bf16")
    for make in (lambda: _jax_engine(dict(cfg), batches),
                 lambda: _port_engine(init, dict(cfg))):
        engine = make()
        engine.backward(engine.forward(batches[0]))
        buf = _acc_buffer(engine)
        if hasattr(engine, "state"):
            want_buf = buf
            assert all(a.dtype == jax.numpy.bfloat16 for a in
                       jax.tree.leaves(engine.state.acc_grads))
        else:
            assert all(a.dtype == torch.bfloat16
                       for a in engine._acc.values())
    assert buf.keys() == want_buf.keys()
    for k in buf:
        np.testing.assert_allclose(buf[k], want_buf[k], rtol=1e-2,
                                   atol=1e-8, err_msg=k)

    def train(engine, loop):
        if loop:
            return _loop(engine, batches, 1)
        return [float(np.asarray(engine.train_batch(batch=b)))
                for b in batches]

    for loop in (True, False):
        jeng = _jax_engine(dict(cfg), batches)
        want = train(jeng, loop)
        peng = _port_engine(init, dict(cfg))
        got = train(peng, loop)
        np.testing.assert_allclose(got, want, **TOL)
        _assert_params(peng, _jax_params(jeng))
        plain = _port_engine(init, dict(base))
        train(plain, loop)
        same = all(torch.equal(p, plain.params[k])
                   for k, p in peng.params.items())
        assert same == (not loop)
        if loop:
            loop_params = _jax_params(jeng)
    jax_tb = _jax_params(jeng)
    assert any(not torch.equal(loop_params[k], jax_tb[k]) for k in jax_tb)


def test_boundary_sequence_and_step_noop_match_jax(setup):
    """gas 3: is_gradient_accumulation_boundary before and after each
    backward, and global_steps after each step() (a no-op off the
    boundary), in both engines; the port's params do not move off it."""
    _, batches, init = setup
    cfg = _config(train_batch_size=6, train_micro_batch_size_per_gpu=2)
    micro = [{"input_ids": batches[0]["input_ids"][i:i + 2]}
             for i in range(0, 6, 2)] * 2
    seqs = []
    for make in (lambda: _jax_engine(dict(cfg), [micro[0]]),
                 lambda: _port_engine(init, dict(cfg))):
        engine = make()
        seq = [engine.is_gradient_accumulation_boundary()]
        for m in micro:
            loss = engine.forward(m)
            seq.append(engine.is_gradient_accumulation_boundary())
            engine.backward(loss)
            seq.append(engine.is_gradient_accumulation_boundary())
            engine.step()
            seq.append(engine.global_steps)
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert seqs[1][:7] == [True, True, False, 0, False, False, 0]

    engine = _port_engine(init, dict(cfg))
    before = {k: p.detach().clone() for k, p in engine.params.items()}
    engine.backward(engine.forward(micro[0]))
    engine.step()
    assert engine.global_steps == 0
    assert all(torch.equal(p, before[k]) for k, p in engine.params.items())


def test_backward_and_step_misuse_raise(setup):
    engine = _port_engine(setup[2], _config())
    with pytest.raises(RuntimeError, match="prior forward"):
        engine.backward()
    with pytest.raises(RuntimeError, match="gradients of backward"):
        engine.step()
    loss = engine.forward(setup[1][0])
    assert engine.backward() is loss        # the pending loss by default
    engine.step()
    assert engine.global_steps == 1 and engine.micro_steps == 1


def test_fp16_overflow_through_step_skips_update_and_scheduler(setup):
    """An overflow skips the update and the scheduler; with hysteresis 2
    the first leaves the scale, the second halves it (as train_batch)."""
    _, batches, init = setup
    engine = _port_engine(init, _config(
        fp16={"enabled": True, "loss_scale": 0, "initial_scale_power": 8},
        scheduler={"type": "WarmupLR", "params": {"warmup_num_steps": 4}}))
    with torch.no_grad():
        engine.params["wte"][0, 0] = float("inf")
    before = {k: p.detach().clone() for k, p in engine.params.items()}
    for n in (1, 2):
        engine.backward(engine.forward(batches[0]))
        engine.step()
        assert engine.skipped_steps == n and engine.step_count == 0
        assert engine.lr_scheduler.last_batch_iteration == -1
    assert engine.loss_scale == 2 ** 7
    assert all(torch.equal(p, before[k]) for k, p in engine.params.items())


# ------------------------------------------------- get_global_grad_norm


@pytest.mark.parametrize("precision,clip,rtol", [
    ("fp32", 0.5, 1e-5), ("fp32", 0.0, 1e-5),
    ("bf16", 1.0, 0.05), ("bf16", 0.0, 0.05),
    ("fp16", 1.0, 0.05), ("fp16", 0.0, 0.05),
])
def test_global_grad_norm_follows_jax_contract(setup, precision, clip,
                                               rtol):
    """None until the first print-cadence fetch, a host float after it,
    and always None when the step takes no norm (bf16/fp32 without
    clipping); fp16 always takes one."""
    _, batches, init = setup
    over = {"steps_per_print": 2, "gradient_clipping": clip}
    if precision == "bf16":
        over["bf16"] = {"enabled": True}
    if precision == "fp16":
        over["fp16"] = {"enabled": True, "loss_scale": 0,
                        "initial_scale_power": 8}
    cfg = _config(**over)
    norms = []
    for engine in (_jax_engine(dict(cfg), batches),
                   _port_engine(init, dict(cfg))):
        seq = []
        for batch in batches[:5]:
            engine.train_batch(batch=batch)
            seq.append(engine.get_global_grad_norm())
        norms.append(seq)
    want, got = norms
    assert [x is None for x in got] == [x is None for x in want]
    takes_norm = precision == "fp16" or clip > 0
    assert got[0] is None and (got[1] is not None) == takes_norm
    for g, w in zip(got, want):
        if w is not None:
            assert isinstance(g, float)
            np.testing.assert_allclose(g, w, rtol=rtol)


# ------------------------------------------------------- eval_batch


@pytest.mark.parametrize("family", ["gpt2", "bert"])
def test_eval_batch_and_call_match_jax_with_dropout(family):
    """Models configured with dropout 0.1: ``eval_batch`` and
    ``engine(batch)`` take no dropout and no gradient, equal the JAX
    engine's at 1e-5 at the init and after 2 JAX training steps (their
    params bridged), give equal results twice, equal the same weights'
    eval at dropout 0, and leave the module in training mode."""
    if family == "gpt2":
        batches = [{"input_ids": np.array(b["input_ids"])}
                   for b in oracle.make_batches(3)]
        jcfg = jax_gpt2.GPT2Config(**oracle.TINY, dropout=0.1)
        jmodel = jax_gpt2.GPT2LMHeadModel(jcfg)
        pcfg = gpt2.GPT2Config(**oracle.TINY, dropout=0.1)
        port, to_sd = gpt2.GPT2LMHeadModel, flax_to_state_dict
        cfg = _config()
    else:
        batches = [{k: np.array(v) for k, v in b.items()}
                   for b in oracle.make_bert_batches(3)]
        jcfg = jax_bert.BertConfig(**oracle.TINY_BERT,
                                   hidden_dropout_prob=0.1,
                                   attention_probs_dropout_prob=0.1)
        jmodel = jax_bert.BertForPreTraining(jcfg)
        pcfg = bert.BertConfig(**oracle.TINY_BERT, hidden_dropout_prob=0.1,
                               attention_probs_dropout_prob=0.1)
        port, to_sd = bert.BertForPreTraining, bert_flax_to_state_dict
        cfg = _config(optimizer={"type": "Lamb", "params": {"lr": 1e-3}})
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=jmodel, config=dict(cfg),
                                        sample_batch=batches[0],
                                        seed=oracle.SEED)
    for trained in (False, True):
        if trained:
            for b in batches[:2]:
                jeng.train_batch(batch=b)
        sd = to_sd(jax.tree.map(np.asarray, jeng.state.params))
        peng, *_ = deepspeed_tpu_torch.initialize(
            model=port(pcfg, device="cpu"), config=dict(cfg),
            model_parameters=sd, device="cpu")
        batch = batches[2]
        want = float(jeng.eval_batch(batch))
        got = peng.eval_batch(batch)
        assert not got.requires_grad and peng.module.training
        np.testing.assert_allclose(float(got), want, **TOL)
        np.testing.assert_allclose(float(jeng(batch)), want, **TOL)
        assert torch.equal(peng(batch), got)
        assert torch.equal(peng.eval_batch(batch), got)
        plain = dataclasses.replace(
            pcfg, **({"dropout": 0.0} if family == "gpt2" else
                     {"hidden_dropout_prob": 0.0,
                      "attention_probs_dropout_prob": 0.0}))
        eng0, *_ = deepspeed_tpu_torch.initialize(
            model=port(plain, device="cpu"), config=dict(cfg),
            model_parameters=sd, device="cpu")
        assert torch.equal(eng0.eval_batch(batch), got)
        # the training forward draws masks: another loss
        assert float(peng.forward(batch).detach()) != float(got)


# ------------------------------------------------------ optimizers


@pytest.mark.parametrize("opt", [
    {"type": "SGD", "params": {"lr": 0.05}},
    {"type": "SGD", "params": {"lr": 0.05, "momentum": 0.9,
                               "weight_decay": 0.01}},
    {"type": "SGD", "params": {"lr": 0.05, "momentum": 0.9,
                               "nesterov": True}},
])
def test_sgd_engine_steps_match_jax(setup, opt):
    _, batches, init = setup
    batches = batches[:3]
    cfg = _config(optimizer=opt, gradient_clipping=1.0)
    jeng = _jax_engine(dict(cfg), batches)
    want = [float(jeng.train_batch(batch=b)) for b in batches]
    peng = _port_engine(init, dict(cfg))
    got = [float(peng.train_batch(batch=b)) for b in batches]
    np.testing.assert_allclose(got, want, **TOL)
    _assert_params(peng, _jax_params(jeng))
    assert type(peng.opt_state).__name__ == "SGDState"


@pytest.mark.parametrize("opt", [
    {"type": "Adagrad", "params": {"lr": 0.02}},
    {"type": "Adagrad", "params": {"lr": 0.02, "weight_decay": 0.01,
                                   "eps": 1e-6}},
])
def test_adagrad_engine_steps_match_jax(opt):
    """On ``SimpleModel`` (2 x 16): Adagrad's first step divides each
    gradient by its own magnitude, so on GPT-2 the key-bias gradients,
    zero but for rounding (softmax ignores a shift of every key's
    logit), would turn each engine's last-bit noise into lr-sized
    updates of either sign."""
    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((8, 16)).astype(np.float32),
                rng.standard_normal((8, 16)).astype(np.float32))
               for _ in range(3)]
    cfg = _config(optimizer=opt, gradient_clipping=1.0)
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(
        model=jax_simple.SimpleModel(hidden_dim=16, nlayers=2),
        config=dict(cfg), sample_batch=jax_simple.sample_batch(8, 16))
    init = simple_flax_to_state_dict(jax.tree.map(np.asarray,
                                                  jeng.state.params))
    want = [float(jeng.train_batch(batch=b)) for b in batches]
    peng, *_ = deepspeed_tpu_torch.initialize(
        model=simple.SimpleModel(16, 2, device="cpu"), config=dict(cfg),
        model_parameters=init, device="cpu")
    got = [float(peng.train_batch(batch=tuple(map(torch.from_numpy, b))))
           for b in batches]
    np.testing.assert_allclose(got, want, **TOL)
    final = simple_flax_to_state_dict(jax.tree.map(np.asarray,
                                                   jeng.state.params))
    _assert_params(peng, final)
    assert type(peng.opt_state).__name__ == "AdagradState"


def test_client_optimizer_and_scheduler_equal_the_config_ones(setup):
    _, batches, init = setup
    sched_params = {"warmup_min_lr": 1e-4, "warmup_max_lr": 2e-3,
                    "warmup_num_steps": 3}
    built = _port_engine(init, _config(
        optimizer={"type": "AdamW", "params": {"lr": 2e-3,
                                               "weight_decay": 0.01}},
        scheduler={"type": "WarmupLR", "params": sched_params}))
    client_opt = optim.adam(weight_decay=0.01)
    client_sched = lr_schedules.WarmupLR(**sched_params)
    client = _port_engine(init, _config(optimizer={
        "type": "AdamW", "params": {"lr": 2e-3}}),
        optimizer=client_opt, lr_scheduler=client_sched)
    assert client.optimizer is client_opt
    assert client.lr_scheduler is client_sched
    for batch in batches[:4]:
        assert torch.equal(built.train_batch(batch=batch),
                           client.train_batch(batch=batch))
    assert client_sched.last_batch_iteration == 3
    for x, y in zip(built.module.state_dict().values(),
                    client.module.state_dict().values()):
        assert torch.equal(x, y)


def test_foreign_client_optimizer_and_scheduler_raise(setup):
    """The JAX engine asserts on a client optimizer that is not its
    Optimizer pair; the port raises TypeError, for a torch.optim
    optimizer too."""
    _, batches, init = setup
    model = gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    torch_opt = torch.optim.SGD(model.parameters(), lr=0.1)
    for kw in ({"optimizer": torch_opt}, {"optimizer": object()},
               {"lr_scheduler": torch.optim.lr_scheduler.StepLR(
                   torch_opt, 1)}, {"lr_scheduler": object()}):
        with pytest.raises(TypeError, match="client"):
            _port_engine(init, _config(), **kw)
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    with pytest.raises(AssertionError, match="Optimizer"):
        deepspeed_tpu.initialize(
            model=jax_gpt2.GPT2LMHeadModel(
                jax_gpt2.GPT2Config(**oracle.TINY)),
            config=_config(), sample_batch=batches[0], optimizer=object())


# -------------------------------------------- args, distributed, argparse


@pytest.mark.parametrize("argv", [
    [],
    ["--deepspeed", "--deepspeed_config", "ds.json"],
    ["--deepscale", "--deepscale_config", "old.json", "--deepspeed_mpi"],
])
def test_add_config_arguments_parses_like_jax(argv):
    want = deepspeed_tpu.add_config_arguments(
        argparse.ArgumentParser()).parse_args(argv)
    parser = argparse.ArgumentParser()
    assert deepspeed_tpu_torch.add_config_arguments(parser) is parser
    assert vars(parser.parse_args(argv)) == vars(want)


def test_initialize_reads_args_deepspeed_config(setup, tmp_path):
    _, batches, init = setup
    path = tmp_path / "ds.json"
    path.write_text(json.dumps(_config(optimizer={
        "type": "SGD", "params": {"lr": 0.05, "momentum": 0.9}})))
    parser = deepspeed_tpu_torch.add_config_arguments(
        argparse.ArgumentParser())
    args = parser.parse_args(["--deepspeed", "--deepspeed_config",
                              str(path)])
    model = gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    engine, opt, loader, sched = deepspeed_tpu_torch.initialize(
        args=args, model=model, model_parameters=init, device="cpu")
    assert engine.config.optimizer_name == "sgd" and opt is engine.optimizer
    assert engine.get_lr() == [0.05]
    # config= wins over args, as in the JAX engine
    engine2, *_ = deepspeed_tpu_torch.initialize(
        args=args, model=gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"],
                                              device="cpu"),
        config=_config(), device="cpu")
    assert engine2.config.optimizer_name == "adam"
    with pytest.raises(ValueError, match="deepspeed_config"):
        deepspeed_tpu_torch.initialize(args=argparse.Namespace(),
                                       model=model, device="cpu")


def test_init_distributed_gloo_at_world_size_one(setup, monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    dist = torch.distributed
    assert not dist.is_initialized()
    try:
        deepspeed_tpu_torch.init_distributed("gloo", verbose=False)
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo" and dist.get_rank() == 0
        deepspeed_tpu_torch.init_distributed("gloo")   # again: a no-op
        engine = _port_engine(setup[2], _config())
        engine.train_batch(batch=setup[1][0])
        assert engine.global_steps == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            deepspeed_tpu_torch.init_distributed()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="init_method"):
        deepspeed_tpu_torch.init_distributed("gloo")
    assert not dist.is_initialized()


def test_checkpointing_is_the_public_alias():
    from deepspeed_tpu_torch.runtime.activation_checkpointing import \
        checkpointing
    assert deepspeed_tpu_torch.checkpointing is checkpointing
    assert {"add_config_arguments", "init_distributed", "checkpointing"} \
        <= set(deepspeed_tpu_torch.__all__)
