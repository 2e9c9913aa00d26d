"""GPT-J in the PyTorch port against the JAX package's
``deepspeed_tpu.models.gptj``, on the CPU in fp32.

A 2-layer GPT-J (n_embd 64, n_head 4, ``rotary_dim`` 8: partial rotary
on a head dim of 16) from the flax init, carried across by
``bridge.gptj_flax_to_state_dict``; the JAX side runs its plain
attention (``use_flash=False``), as JAX's own CPU tests do. Held to JAX:
logits and loss; ``hf_gptj_to_params`` on a synthetic HF-layout state
dict made from a seed (no checkpoint is downloaded); the bridge both
ways; greedy tokens of ``init_inference(...).generate`` (recompute: GPT-J
has no KV cache in either package); three ``train_batch`` steps of Adam;
a checkpoint tag of either engine loaded by the other. Tolerances:
logits, loss rtol = atol = 1e-4 (``tests/test_torch_gpt2.py``'s:
LayerNorm and matmuls sum in another order); the engines' losses and
masters rtol = atol = 1e-5 (``tests/test_torch_engine.py``'s); the HF
mapping and the bridge exactly; greedy tokens exactly.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gptj as jax_gptj
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.models import gptj
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE_TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=4,
            rotary_dim=8)


def _ids(B, S, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, S),
                                                dtype=np.int32)


@pytest.fixture(scope="module")
def tiny():
    """(flax model, numpy params, port model, ids [2, 16])."""
    ids = _ids(2, 16, 0)
    jm = jax_gptj.GPTJForCausalLM(jax_gptj.GPTJConfig(**TINY,
                                                      use_flash=False))
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), {"input_ids": jnp.asarray(ids)})["params"])
    tm = gptj.GPTJForCausalLM(gptj.GPTJConfig(**TINY), device="cpu")
    tm.load_state_dict(bridge.gptj_flax_to_state_dict(params))
    return jm, params, tm.eval(), ids


def test_config_and_parameter_count_match_jax():
    """The defaults are GPT-J-6B's (JAX gptj.py:30-36): 28 × 4096, 16
    heads of 256, rotary_dim 64, vocab 50400; 6.05 G parameters, counted
    on the meta device."""
    for f in dataclasses.fields(gptj.GPTJConfig):
        assert getattr(gptj.GPTJConfig(), f.name) == \
            getattr(jax_gptj.GPTJConfig(), f.name), f.name
    cfg = gptj.PRESETS["gptj-6b"]
    assert cfg.n_embd // cfg.n_head == 256 and cfg.inner == 16384
    meta = gptj.GPTJForCausalLM(cfg, device="meta")
    assert sum(p.numel() for p in meta.parameters()) == cfg.num_params()
    assert round(cfg.num_params() / 1e9, 2) == 6.05
    small = gptj.GPTJForCausalLM(gptj.GPTJConfig(**TINY), device="meta")
    assert sum(p.numel() for p in small.parameters()) == \
        gptj.GPTJConfig(**TINY).num_params()


def test_bridge_both_ways_leaf_by_leaf(tiny):
    """JAX params as numpy -> the port's state_dict -> the flax tree:
    every leaf equal, and the state_dict names every port tensor."""
    _, params, tm, _ = tiny
    sd = bridge.gptj_flax_to_state_dict(params)
    assert set(sd) == set(tm.state_dict())
    back = bridge.state_dict_to_flax(sd)
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(flat) == set(got)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))
    # the port model's own parameters (a torch state_dict) go the same way
    again = bridge.state_dict_to_flax(dict(tm.named_parameters()))
    for path, leaf in dict(jax.tree_util.tree_flatten_with_path(
            again)[0]).items():
        np.testing.assert_array_equal(leaf, flat[path])


def test_logits_and_loss_match_jax(tiny):
    jm, params, tm, ids = tiny
    batch = {"input_ids": jnp.asarray(ids)}
    want = np.asarray(jax.jit(lambda p, b: jm.apply(
        {"params": p}, b, return_logits=True))(params, batch))
    want_loss = float(jax.jit(lambda p, b: jm.apply({"params": p}, b))(
        params, batch))
    tids = torch.from_numpy(ids).long()
    with torch.no_grad():
        got = tm({"input_ids": tids}, return_logits=True)
        loss = tm({"input_ids": tids})
        masked = tm((tids, torch.where(tids % 3 == 0, -100, tids)))
    assert got.shape == (2, 16, 256)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    # labels with ignored positions: the shared masked CE of both
    labels = np.where(ids % 3 == 0, -100, ids)
    want_masked = float(jm.apply({"params": params}, (jnp.asarray(ids),
                                                      jnp.asarray(labels))))
    np.testing.assert_allclose(float(masked), want_masked, **TOL)
    assert int(tm.loss_count((tids, torch.from_numpy(labels)))) == \
        int((labels[:, 1:] >= 0).sum())


def _hf_state_dict(cfg, seed, prefix="transformer."):
    """A synthetic HF ``GPTJForCausalLM`` state dict (torch [out, in]
    weights) from a numpy seed."""
    rng = np.random.default_rng(seed)
    E, inner, V = cfg["n_embd"], 4 * cfg["n_embd"], cfg["vocab_size"]

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.05

    sd = {f"{prefix}wte.weight": r(V, E), f"{prefix}ln_f.weight": 1 + r(E),
          f"{prefix}ln_f.bias": r(E), "lm_head.weight": r(V, E),
          "lm_head.bias": r(V)}
    for i in range(cfg["n_layer"]):
        p = f"{prefix}h.{i}."
        sd.update({p + "ln_1.weight": 1 + r(E), p + "ln_1.bias": r(E),
                   p + "attn.q_proj.weight": r(E, E),
                   p + "attn.k_proj.weight": r(E, E),
                   p + "attn.v_proj.weight": r(E, E),
                   p + "attn.out_proj.weight": r(E, E),
                   p + "mlp.fc_in.weight": r(inner, E),
                   p + "mlp.fc_in.bias": r(inner),
                   p + "mlp.fc_out.weight": r(E, inner),
                   p + "mlp.fc_out.bias": r(E)})
    return sd


@pytest.mark.parametrize("prefix,as_torch", [("transformer.", False),
                                             ("transformer.", True),
                                             ("", False)])
def test_hf_state_dict_maps_as_jax_maps_it(tiny, prefix, as_torch):
    """``hf_gptj_to_params`` gives JAX's tree, leaf for leaf, from numpy or
    torch tensors, with or without the ``transformer.`` prefix; the
    mapped weights give the JAX model's logits in the port."""
    jm, _, _, ids = tiny
    sd = _hf_state_dict(TINY, seed=11, prefix=prefix)
    want = jax_gptj.hf_gptj_to_params(sd, jax_gptj.GPTJConfig(**TINY))
    given = {k: torch.from_numpy(v) for k, v in sd.items()} if as_torch \
        else sd
    got = gptj.hf_gptj_to_params(given, gptj.GPTJConfig(**TINY))
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(flat_g) == set(flat_w)
    for path, leaf in flat_w.items():
        np.testing.assert_array_equal(flat_g[path], leaf, err_msg=str(path))
    assert gptj.is_hf_gptj_state_dict(sd) == \
        jax_gptj.is_hf_gptj_state_dict(sd) is True
    tm = gptj.GPTJForCausalLM(gptj.GPTJConfig(**TINY), device="cpu")
    tm.load_state_dict(bridge.gptj_flax_to_state_dict(got))
    with torch.no_grad():
        logits = tm({"input_ids": torch.from_numpy(ids).long()},
                    return_logits=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jm.apply(
        {"params": want}, {"input_ids": jnp.asarray(ids)},
        return_logits=True)), **TOL)


def test_hf_layer_count_and_naming_checks_match_jax():
    sd = _hf_state_dict(TINY, seed=12)
    deeper = jax_gptj.GPTJConfig(**dict(TINY, n_layer=3))
    with pytest.raises(AssertionError, match="3"):
        jax_gptj.hf_gptj_to_params(sd, deeper)
    with pytest.raises(ValueError, match="n_layer=3"):
        gptj.hf_gptj_to_params(sd, gptj.GPTJConfig(**dict(TINY, n_layer=3)))
    neo = {"transformer.h.0.attn.attention.q_proj.weight": np.zeros(1)}
    assert gptj.is_hf_gptj_state_dict(neo) == \
        jax_gptj.is_hf_gptj_state_dict(neo) is False


def test_generate_greedy_matches_jax_inference_engine(tiny):
    """``init_inference(...).generate`` recomputes the whole sequence a
    token (no KV cache in either package): the port's greedy tokens equal
    the JAX engine's on the same params."""
    jm, params, tm, ids = tiny
    eng = deepspeed_tpu_torch.init_inference(tm, dtype=torch.float32,
                                             device="cpu")
    assert not eng._supports_kv_cache()
    got = eng.generate(torch.from_numpy(ids).long(), max_new_tokens=8)
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    jeng = deepspeed_tpu.init_inference(jm, params=params, dtype=jnp.float32)
    want = np.asarray(jeng.generate(jnp.asarray(ids), max_new_tokens=8))
    assert got.shape == (2, 24)
    np.testing.assert_array_equal(got.numpy(), want)


def _config(stage=0):
    return {"train_batch_size": 4, "steps_per_print": 10 ** 9,
            "gradient_clipping": 1.0,
            "optimizer": {"type": "Adam", "params": {"lr": 2e-3}},
            "zero_optimization": {"stage": stage}}


@pytest.fixture(scope="module")
def engines(tiny, tmp_path_factory):
    """The JAX engine and the port's on the same init and batches: 3
    steps each, the JAX tag ``jax`` after them, 2 more steps of JAX as the
    reference; the JAX params and losses at each point."""
    jm, params, _, _ = tiny
    batches = [{"input_ids": _ids(4, 16, 100 + s)} for s in range(6)]
    root = tmp_path_factory.mktemp("gptj_ckpt")
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=jm, config=_config(),
                                        sample_batch=batches[0], seed=0)
    first = [float(jeng.train_batch(batch=b)) for b in batches[:3]]
    at3 = bridge.gptj_flax_to_state_dict(jax.tree.map(np.asarray,
                                                      jeng.state.params))
    jeng.save_checkpoint(str(root), tag="jax")
    then = [float(jeng.train_batch(batch=b)) for b in batches[3:5]]
    port, *_ = deepspeed_tpu_torch.initialize(
        model=gptj.GPTJForCausalLM(gptj.GPTJConfig(**TINY), device="cpu"),
        config=_config(), model_parameters=bridge.gptj_flax_to_state_dict(
            params), device="cpu")
    got = [float(port.train_batch(batch={"input_ids": torch.from_numpy(
        b["input_ids"]).long()})) for b in batches[:3]]
    return dict(jeng=jeng, batches=batches, root=root, first=first, at3=at3,
                then=then, port=port, got=got)


def test_three_adam_steps_match_jax_engine(engines):
    np.testing.assert_allclose(engines["got"], engines["first"],
                               **ENGINE_TOL)
    for k, w in engines["at3"].items():
        np.testing.assert_allclose(engines["port"].params[k].detach().numpy(),
                                   w.numpy(), err_msg=k, **ENGINE_TOL)


def test_checkpoint_tags_load_into_either_engine(engines):
    """The JAX tag loads into a port engine from another init, which then
    takes JAX's next steps; the port's tag loads into the JAX engine,
    which then takes the port's next step."""
    e = engines
    torch_batches = [{"input_ids": torch.from_numpy(b["input_ids"]).long()}
                     for b in e["batches"]]
    resumed, *_ = deepspeed_tpu_torch.initialize(
        model=gptj.GPTJForCausalLM(gptj.GPTJConfig(**TINY), device="cpu",
                                   seed=7),
        config=_config(), device="cpu")
    resumed.load_checkpoint(str(e["root"]), tag="jax")
    assert resumed.global_steps == 3
    got = [float(resumed.train_batch(batch=b)) for b in torch_batches[3:5]]
    np.testing.assert_allclose(got, e["then"], **ENGINE_TOL)
    resumed.save_checkpoint(str(e["root"]), tag="port")
    e["jeng"].load_checkpoint(str(e["root"]), tag="port")
    assert e["jeng"].global_steps == 5
    want = float(e["jeng"].train_batch(batch=e["batches"][5]))
    np.testing.assert_allclose(float(resumed.train_batch(
        batch=torch_batches[5])), want, **ENGINE_TOL)
    params = bridge.gptj_flax_to_state_dict(jax.tree.map(
        np.asarray, e["jeng"].state.params))
    for k, w in params.items():
        np.testing.assert_allclose(resumed.params[k].detach().numpy(),
                                   w.numpy(), err_msg=k, **ENGINE_TOL)
    # init_inference(checkpoint=) reads the tag's flax tree through the
    # GPT-J layout table
    inf = deepspeed_tpu_torch.init_inference(
        gptj.GPTJForCausalLM(gptj.GPTJConfig(**TINY), device="cpu"),
        dtype=torch.float32, device="cpu",
        checkpoint=str(e["root"] / "port" / "mp_rank_00_model_states.pt"))
    for k, p in inf.module.named_parameters():
        np.testing.assert_array_equal(
            p.detach().numpy(),
            bridge.from_flax(bridge.layout_of([k]), _module_tree(
                e["root"] / "port" / "mp_rank_00_model_states.pt"))[k])


def _module_tree(path):
    from deepspeed_tpu_torch.runtime.checkpoint_io import (load_file,
                                                           module_tree)
    return module_tree(load_file(str(path), kind="model_states"), str(path))


def test_no_card_means_cuda_and_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        gptj.GPTJForCausalLM(gptj.GPTJConfig(**TINY))


def test_synthetic_batch_matches_jax_draws():
    got = gptj.synthetic_batch(2, 8, 256, seed=4, device="cpu")["input_ids"]
    want = np.random.default_rng(4).integers(0, 256, (2, 8), dtype=np.int32)
    np.testing.assert_array_equal(got.numpy(), want)
