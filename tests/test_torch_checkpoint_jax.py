"""Checkpoints between the JAX engine and the PyTorch port, both ways.

A tag written by ``deepspeed_tpu``'s engine loads into the port's engine
and training continues; a tag the port writes loads into
``deepspeed_tpu.initialize(...).load_checkpoint`` (the JAX package is not
edited for it). Each case runs one JAX engine: it trains 3 steps and
saves (tag ``jax``), then takes 3 more, the reference the port's engine
continues to after loading ``jax``. The port's engine then saves (tag
``port``); the JAX engine loads it and takes 3 more steps, the reference
the port's next 3 steps continue to. Losses and params are held at the
engine-parity tolerance of ``tests/test_torch_engine.py``, rtol = atol =
1e-5.

The cases: GPT-2 with 11 layers (JAX flattens ``h_10`` before ``h_2``;
the port's sweep vector runs ``h.0, h.1, h.2, ...``) under Adam's sweep
and per-tensor forms, and tiny BERT under fused LAMB, each at ZeRO 0 on
one device and at ZeRO 1 on the suite's 8-device mesh (the moments saved
as 8 index-keyed shards, ``partition_count`` 8, which the port
reassembles). This file holds the sweep's cases;
``test_torch_checkpoint_jax_adam.py`` the per-tensor Adam's and
``test_torch_checkpoint_jax_tools.py`` BERT's and the tools'.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.models import bert, gpt2
from deepspeed_tpu_torch.runtime import engine as engine_mod
from tests.model import oracle

TOL = dict(rtol=1e-5, atol=1e-5)
N_LAYER = 11


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny models' microsecond ops oversubscribe the cores under
    ``-n 6`` with torch's default intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gpt2_family():
    jcfg = jax_gpt2.GPT2Config(**dict(oracle.TINY, n_layer=N_LAYER))
    batches = [{"input_ids": np.array(b["input_ids"])}
               for b in oracle.make_batches(9)]
    return (lambda: jax_gpt2.GPT2LMHeadModel(jcfg),
            lambda seed: gpt2.GPT2LMHeadModel(
                dataclasses.replace(gpt2.PRESETS["tiny"], n_layer=N_LAYER),
                device="cpu", seed=seed),
            batches, bridge.flax_to_state_dict)


def _bert_family():
    batches = [{k: np.array(v) for k, v in b.items()}
               for b in oracle.make_bert_batches(9)]
    return (lambda: jax_bert.BertForPreTraining(
                jax_bert.BertConfig(**oracle.TINY_BERT)),
            lambda seed: _seeded_bert(seed), batches,
            bridge.bert_flax_to_state_dict)


def _seeded_bert(seed):
    torch.manual_seed(seed)
    return bert.BertForPreTraining(bert.BertConfig(**oracle.TINY_BERT),
                                   device="cpu")


# the port runs the fused kernels' plain versions; the JAX engine runs
# the same update rules without Pallas (``fused`` would run the Pallas
# kernels in interpret mode, minutes on the CPU): the state they keep is
# the same tree
OPTIMIZERS = {
    "sweep": {"type": "Adam", "params": {"lr": 2e-3, "sweep": True}},
    "adam": {"type": "AdamW", "params": {"lr": 2e-3, "weight_decay": 0.01}},
    "lamb": {"type": "Lamb", "params": {"lr": 2e-3, "weight_decay": 0.01}},
}


def _config(opt, stage, micro, port=False):
    params = dict(OPTIMIZERS[opt]["params"])
    if port and opt != "sweep":
        params["fused"] = True
    return {"train_batch_size": oracle.BATCH_SIZE,
            "train_micro_batch_size_per_gpu": micro,
            "steps_per_print": 10 ** 9, "gradient_clipping": 1.0,
            "optimizer": dict(OPTIMIZERS[opt], params=params),
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_min_lr": 1e-4, "warmup_max_lr": 2e-3,
                "warmup_num_steps": 8}},
            "zero_optimization": {"stage": stage}}


def _jax_engine(make_model, cfg, ndev, batches):
    groups.destroy()
    groups.initialize(devices=jax.devices()[:ndev])
    engine, *_ = deepspeed_tpu.initialize(
        model=make_model(), config=cfg, sample_batch=batches[0],
        seed=oracle.SEED)
    return engine


def _jax_params(engine, to_sd):
    return to_sd(jax.tree.map(np.asarray, engine.state.params))


def _assert_params(got, want):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(),
                                   err_msg=k, **TOL)


def cross_engines(tmp_path, monkeypatch, family, opt, stage, ndev):
    """One case of the module docstring's round trip."""
    make_jax, make_port, batches, to_sd = (
        _gpt2_family() if family == "gpt2" else _bert_family())
    jcfg = _config(opt, stage, oracle.BATCH_SIZE // ndev)
    jax_eng = _jax_engine(make_jax, jcfg, ndev, batches)
    for b in batches[:3]:
        jax_eng.train_batch(batch=b)
    jax_eng.save_checkpoint(str(tmp_path), tag="jax")
    if ndev > 1:
        import pickle as _p
        with open(tmp_path / "jax" /
                  "zero_pp_rank_0_mp_rank_00_optim_states.pt", "rb") as f:
            z = _p.load(f)
        assert z["partition_count"] == 8
        assert max(len(r["shards"]) for r in
                   z["optimizer_state_dict"].values()) > 1
    want = [float(jax_eng.train_batch(batch=b)) for b in batches[3:6]]
    want_params = _jax_params(jax_eng, to_sd)

    # JAX -> port: a port engine from another init loads the JAX tag
    port, *_ = deepspeed_tpu_torch.initialize(
        model=make_port(7),
        config=_config(opt, stage, oracle.BATCH_SIZE, port=True),
        device="cpu")
    logged = []
    monkeypatch.setattr(engine_mod, "log_dist",
                        lambda msg, **kw: logged.append(msg))
    path, _ = port.load_checkpoint(str(tmp_path), tag="jax")
    assert path.endswith(os.path.join("jax", "mp_rank_00_model_states.pt"))
    assert any(f"saved at dp={ndev}, resuming at dp=1" in m
               for m in logged) == (ndev > 1)
    assert (port.global_steps, port.micro_steps, port.step_count) == (3, 3, 3)
    assert port.opt_state.step == 3
    assert port.lr_scheduler.last_batch_iteration == 2
    got = [float(port.train_batch(batch=b)) for b in batches[3:6]]
    np.testing.assert_allclose(got, want, **TOL)
    _assert_params(port.params, want_params)

    # port -> JAX: the JAX engine loads the port's tag and continues
    port.save_checkpoint(str(tmp_path), tag="port")
    jax_eng.load_checkpoint(str(tmp_path), tag="port")
    assert jax_eng.global_steps == 6
    want = [float(jax_eng.train_batch(batch=b)) for b in batches[6:9]]
    got = [float(port.train_batch(batch=b)) for b in batches[6:9]]
    np.testing.assert_allclose(got, want, **TOL)
    _assert_params(port.params, _jax_params(jax_eng, to_sd))


STAGES = pytest.mark.parametrize("stage,ndev", [(0, 1), (1, 8)],
                                ids=["zero0", "zero1-8dev"])


@STAGES
def test_sweep_tags_cross_between_engines(tmp_path, monkeypatch, stage,
                                          ndev):
    """GPT-2 with 11 layers under Adam's sweep: one padded vector of
    moments, reordered and transposed leaf by leaf between the two
    packages' orders."""
    cross_engines(tmp_path, monkeypatch, "gpt2", "sweep", stage, ndev)
