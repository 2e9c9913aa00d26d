"""Checkpoints between the JAX engine and the PyTorch port: BERT with
LAMB, and the tools.

BERT's round trip is ``tests/test_torch_checkpoint_jax.py``'s
(``cross_engines``, rtol = atol = 1e-5), under fused LAMB on the port, at
ZeRO 0 and at ZeRO 1 on the 8-device mesh. The tools run on a 2-layer
GPT-2 tag of the JAX engine and the port's tag of the same state:
``zero_to_fp32`` gives the same dict on both (bit-equal), and the port's
dict is its masters; ``save_16bit_model`` equals the JAX 16-bit export
mapped through the bridge, and the JAX reader takes its file;
``init_inference(checkpoint=)`` on the JAX tag, the port's tag and the
16-bit file generates the greedy tokens of ``init_inference(params=)`` on
the same weights, and ``init_serving(checkpoint=)`` builds.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.utils import zero_to_fp32 as jax_zero_to_fp32
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.utils import zero_to_fp32
from tests.model import oracle
from tests.test_torch_checkpoint_jax import (STAGES, _config, _jax_engine,
                                             _one_thread,  # noqa: F401
                                             cross_engines)


@STAGES
def test_lamb_bert_tags_cross_between_engines(tmp_path, monkeypatch, stage,
                                              ndev):
    cross_engines(tmp_path, monkeypatch, "bert", "lamb", stage, ndev)


@pytest.fixture(scope="module")
def tags(tmp_path_factory):
    """A 2-layer GPT-2 tag of the JAX engine (``jax``) and the port's tag
    of the same state (``port``, saved right after loading ``jax``)."""
    root = tmp_path_factory.mktemp("ckpt")
    batches = [{"input_ids": np.array(b["input_ids"])}
               for b in oracle.make_batches(2)]
    cfg = _config("adam", 0, 8)
    cfg["optimizer"]["params"]["lr"] = 3e-2     # move off the init
    jax_eng = _jax_engine(
        lambda: jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(**oracle.TINY)),
        cfg, 1, batches)
    for b in batches:
        jax_eng.train_batch(batch=b)
    jax_eng.save_checkpoint(str(root / "j"), tag="jax")
    port, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu"),
        config=cfg, device="cpu")
    port.load_checkpoint(str(root / "j"), tag="jax")
    port.save_checkpoint(str(root / "p"), tag="port")
    return root, jax_eng, port


def test_zero_to_fp32_same_dict_on_both_tags(tags, tmp_path):
    root, jax_eng, port = tags
    want = jax_zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(
        str(root / "j"))
    for d in ("j", "p"):
        got = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(
            str(root / d))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's tag against the live masters, through the layout table
    table = bridge.layout_of(port.params)
    for name, p in port.params.items():
        arr = got[bridge.keystr(table[name][0])]
        perm = table[name][1]
        np.testing.assert_array_equal(
            arr if perm is None else arr.transpose(perm), p.detach().numpy())
    out = tmp_path / "fp32.bin"
    zero_to_fp32.main([str(root / "p"), str(out), "-t", "port"])
    with open(out, "rb") as f:
        assert len(pickle.load(f)) == len(port.params)


def test_save_16bit_model_equals_jax_export(tags, tmp_path):
    _, jax_eng, port = tags
    port.save_16bit_model(str(tmp_path), "model16.bin")
    sd = torch.load(tmp_path / "model16.bin", weights_only=True)
    want = bridge.flax_to_state_dict(jax.tree.map(
        lambda x: np.asarray(x).astype(np.float32),
        jax_eng._consolidated_16bit_state_dict()))
    assert sd.keys() == want.keys()
    for k, w in want.items():
        assert sd[k].dtype == torch.bfloat16
        assert torch.equal(sd[k].float(), w), k
    # the JAX package's own reader takes the port's file
    from deepspeed_tpu.runtime.state_dict_factory import load_checkpoint_file
    back = load_checkpoint_file(str(tmp_path / "model16.bin"))
    np.testing.assert_array_equal(back["wte"], want["wte"].numpy())


@pytest.mark.parametrize("which", ["jax", "port", "bit16"])
def test_init_inference_checkpoint_generates_like_params(tags, tmp_path,
                                                         which):
    root, _, port = tags
    if which == "bit16":
        port.save_16bit_model(str(tmp_path))
        path = tmp_path / "pytorch_model.bin"
    else:
        path = root / ("j" if which == "jax" else "p") / which / \
            "mp_rank_00_model_states.pt"
    ids = torch.as_tensor(gpt2.synthetic_batch(2, 8, 512, seed=3,
                                               device="cpu")["input_ids"])
    params = {k: p.detach().clone() for k, p in port.params.items()}
    if which == "bit16":
        params = {k: v.to(torch.bfloat16).float() for k, v in params.items()}
    make = lambda: gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    want = deepspeed_tpu_torch.init_inference(
        make(), params=params, dtype=torch.float32, device="cpu").generate(
            ids, max_new_tokens=6)
    eng = deepspeed_tpu_torch.init_inference(
        make(), checkpoint=str(path), dtype=torch.float32, device="cpu")
    assert torch.equal(eng.generate(ids, max_new_tokens=6), want)
    srv = deepspeed_tpu_torch.init_serving(
        model=make(), checkpoint=str(path), dtype=torch.float32,
        device="cpu", config={"serving": {"max_batch": 2, "block_size": 8,
                                          "attention_impl": "gather"}})
    assert srv is not None
