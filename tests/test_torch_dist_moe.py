"""Expert parallelism in the PyTorch port (``torch.distributed`` over gloo,
one process a rank) against the JAX engine on 2- and 4-device meshes with
``groups.initialize(ep_size=)``, on the CPU.

Tiny MoE-GPT (``oracle.TINY_MOE``: 4 experts, top-1, on the second
block) from the flax init, bs 8 × seq 32, 4 steps a case. The port runs
at world 2 with ep 2 and at world 4 with ep 2 (dp 2 × ep 2: the case
that tells the expert-parallel group from the expert-data group) and ep
4, each beside the same case at ep 1 in the same spawn. Each rank feeds
its rows of the global batches the JAX engine takes whole; the JAX
engine gates the global batch, and so does the port.

Training against JAX runs at a top-1 capacity where no token can drop
(capacity factor 4 = the expert count), since JAX's RTS priorities are
threefry draws; ``eval_batch`` runs at eval capacity factor 0.5, where
tokens drop, and matches JAX with the drops. Against the port at ep 1
the cases also train with drops (capacity factor 1, RTS noise) and
top-2 (Gumbel noise): the port draws the same noise at any world and
expert-parallel size. Tolerances: ``tests/test_torch_dist_engine.py``'s
rtol = atol = 1e-4 for losses, masters and the clipped gradient norm
against JAX; 1e-5 for the port at ep > 1 against ep 1 (the sums run in
another order) and for eval losses.
"""

import copy
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.runtime import checkpoint_io as jax_ckpt
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.bridge import flax_to_state_dict
from deepspeed_tpu_torch.moe.layer import is_moe_param
from deepspeed_tpu_torch.utils import groups as tgroups
from tests import torch_dist_worker as worker
from tests.model import oracle

TOL = dict(rtol=1e-4, atol=1e-4)
SELF_TOL = dict(rtol=1e-5, atol=1e-5)
STEPS = 4
MESHES = [(2, 2), (4, 2), (4, 4)]          # (world, ep)
TRAIN_MOE = dict(moe_capacity_factor=4.0, moe_eval_capacity_factor=0.5)


def _config(stage, fused):
    return {"train_batch_size": oracle.BATCH_SIZE,
            "steps_per_print": 10 ** 9, "gradient_clipping": 0.5,
            "optimizer": {"type": "AdamW", "params": {
                "lr": 2e-3, "weight_decay": 0.01, "fused": fused}},
            "zero_optimization": {"stage": stage}}


def _sweep(stage):
    cfg = _config(stage, False)
    cfg["optimizer"]["params"]["sweep"] = True
    return cfg


def _lamb(stage, fused):
    cfg = _config(stage, fused)
    cfg["optimizer"] = {"type": "Lamb", "params": {
        "lr": 2e-3, "weight_decay": 0.01, "fused": fused}}
    return cfg


# name -> (model config over TINY_MOE, port config, held to JAX). Every
# case is held to the port at ep 1; the ZeRO-0 sweep and LAMB cases to
# their JAX-held ZeRO-1 twins (test_zero0_equals_zero1)
CASES = {
    "zero0": (TRAIN_MOE, _config(0, False), True),
    "zero1_fused": (TRAIN_MOE, _config(1, True), True),
    # the sweep's state: the dense leaves' chunk and the experts' chunk
    "sweep_zero0": (TRAIN_MOE, _sweep(0), False),
    "sweep_zero1": (TRAIN_MOE, _sweep(1), True),
    # LAMB's trust ratio takes the norm of a whole expert leaf (all the
    # layer's experts), summed over the ranks at ZeRO 0 too
    "lamb_zero0": (TRAIN_MOE, _lamb(0, False), False),
    "lamb_zero1_fused": (TRAIN_MOE, _lamb(1, True), True),
    "rts_drops": (dict(moe_capacity_factor=1.0), _config(1, False), False),
    "top2": (dict(moe_k=2, moe_capacity_factor=1.0), _config(0, True),
             False),
}


def _model_cfg(over):
    return {k: v for k, v in dict(oracle.TINY_MOE, **over).items()
            if k not in oracle.TINY}


@pytest.fixture(scope="module")
def setup():
    """(oracle batches as numpy, the bridged flax init of tiny MoE-GPT)."""
    batches = [{"input_ids": np.array(b["input_ids"])}
               for b in oracle.make_batches(STEPS)]
    model = jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(**oracle.TINY_MOE))
    params = model.init(jax.random.PRNGKey(oracle.SEED), batches[0])
    init = flax_to_state_dict(jax.tree.map(np.asarray, params["params"]))
    return batches, init


def _whole(ranks, ep):
    """The masters with every expert leaf stacked back from the ranks of
    the first expert-parallel group (rank e holds experts e·E/ep ..)."""
    out = dict(ranks[0]["params"])
    for k in out:
        if is_moe_param(k):
            out[k] = np.concatenate([ranks[e]["params"][k]
                                     for e in range(ep)])
    return out


@pytest.fixture(scope="module")
def port(setup, tmp_path_factory):
    """{(world, ep): {case name: [rank results]}}: one spawn a world
    size, every ep of it (and ep 1) in it."""
    batches, init = setup
    out = {}
    for world in sorted({w for w, _ in MESHES}):
        eps = [1] + [ep for w, ep in MESHES if w == world]
        cases, keys = [], []
        for ep in eps:
            for name, (moe, cfg, _) in CASES.items():
                cases.append(dict(model="gpt2", model_cfg=_model_cfg(moe),
                                  config=cfg, init=init, batches=batches,
                                  eval=True, ep_size=ep))
                keys.append((ep, name))
        res = worker.run("engine", world,
                         str(tmp_path_factory.mktemp(f"moe{world}")), cases)
        assert all(r["jax_modules"] == [] for r in res)
        for i, (ep, name) in enumerate(keys):
            out.setdefault((world, ep), {})[name] = [r["cases"][i]
                                                     for r in res]
    return out


_JAX_RUNS = {}


def _jax_engine(moe, cfg, world, ep, batches):
    """The JAX engine's losses, masters, clipped-grad norm of the last
    step and eval loss of the first batch on a ``world``-device mesh
    with ``ep_size=ep``."""
    key = (repr(sorted(moe.items())), repr(sorted(cfg.items())), world, ep)
    if key in _JAX_RUNS:
        return _JAX_RUNS[key]
    groups.destroy()
    groups.initialize(ep_size=ep, devices=jax.devices()[:world])
    engine, *_ = deepspeed_tpu.initialize(
        model=jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(
            **dict(oracle.TINY_MOE, **moe))),
        config=copy.deepcopy(dict(cfg, steps_per_print=1)),
        sample_batch=batches[0], seed=oracle.SEED)
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    norm = engine.get_global_grad_norm()
    params = flax_to_state_dict(jax.tree.map(np.asarray,
                                             engine.state.params))
    ev = float(engine.eval_batch(batches[0]))
    groups.destroy()
    _JAX_RUNS[key] = (losses, {k: v.numpy() for k, v in params.items()},
                      norm, ev)
    return _JAX_RUNS[key]


def _jax_config(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["optimizer"]["params"].pop("fused")
    return cfg


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][2]])
@pytest.mark.parametrize("world,ep", MESHES)
def test_matches_jax_engine_on_an_expert_mesh(setup, port, world, ep, name):
    """Losses, masters (the experts stacked from the ranks), the clipped
    gradient norm and eval_batch with drops against the JAX engine on a
    ``world``-device mesh with ``ep_size=ep``; the ranks that hold the
    same experts hold the same masters."""
    batches, _ = setup
    moe, cfg, _ = CASES[name]
    ranks = port[(world, ep)][name]
    want_losses, want_params, want_norm, want_eval = _jax_engine(
        moe, _jax_config(cfg), world, ep, batches)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want_losses, **TOL)
        np.testing.assert_allclose(r["last_norm"], want_norm, **TOL)
        np.testing.assert_allclose(r["eval"], want_eval, **SELF_TOL)
    got = _whole(ranks, ep)
    assert set(got) == set(want_params)
    for k, w in want_params.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **TOL)
    for r, res in enumerate(ranks):
        for k, p in res["params"].items():
            twin = ranks[r % ep]["params"][k]
            assert np.array_equal(p, twin), (r, k)
            if not is_moe_param(k):
                assert np.array_equal(p, ranks[0]["params"][k]), (r, k)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("world,ep", MESHES)
def test_expert_parallel_equals_ep1(port, world, ep, name):
    """The port at ep > 1 takes the steps it takes at ep 1 on the same
    world and batches, with drops and RTS or Gumbel noise too: the
    gating is global and the noise is drawn for the global tokens."""
    a, b = port[(world, 1)][name], port[(world, ep)][name]
    np.testing.assert_allclose(b[0]["losses"], a[0]["losses"], **SELF_TOL)
    np.testing.assert_allclose(b[0]["eval"], a[0]["eval"], **SELF_TOL)
    whole = _whole(b, ep)
    for k, p in a[0]["params"].items():
        np.testing.assert_allclose(whole[k], p, err_msg=k, **SELF_TOL)


@pytest.mark.parametrize("world,ep", MESHES)
def test_zero0_equals_zero1(port, world, ep):
    """The sweep is elementwise on its chunks: ZeRO 0 and 1 bit-equal.
    LAMB (plain at ZeRO 0, fused at ZeRO 1) sums its norms in another
    order: 1e-5."""
    z0, z1 = port[(world, ep)]["sweep_zero0"], port[(world, ep)]["sweep_zero1"]
    assert z0[0]["losses"] == z1[0]["losses"]
    for r in range(world):
        for k, p in z0[r]["params"].items():
            assert np.array_equal(z1[r]["params"][k], p), (r, k)
    l0, l1 = (port[(world, ep)][n][0] for n in ("lamb_zero0",
                                                 "lamb_zero1_fused"))
    np.testing.assert_allclose(l0["losses"], l1["losses"], **SELF_TOL)
    for k, p in l1["params"].items():
        np.testing.assert_allclose(l0["params"][k], p, err_msg=k, **SELF_TOL)


@pytest.mark.parametrize("world,ep", MESHES)
def test_zero1_cuts_experts_over_the_expert_data_group(port, world, ep):
    """At ZeRO 1 a rank keeps the optimizer state of its slices: the
    dense tensors cut over the world, its experts over the world / ep
    ranks that hold them; the sweep keeps a chunk of the dense leaves'
    vector (padded to sweep_pad() × world) and of its experts' (padded to
    sweep_pad() × world / ep)."""
    from deepspeed_tpu_torch.ops.adam.fused_adam import sweep_pad
    from deepspeed_tpu_torch.runtime.zero.partition import choose_dim
    params = port[(world, ep)]["zero1_fused"][0]["params"]
    want = 0
    for k, p in params.items():
        w = world // ep if is_moe_param(k) else world
        want += p.size // w if choose_dim(p.shape, w) is not None else p.size
    assert port[(world, ep)]["zero1_fused"][0]["state_numel"] == 2 * want
    chunks = 0
    for expert, w in ((False, world), (True, world // ep)):
        n = sum(p.size for k, p in params.items()
                if is_moe_param(k) == expert)
        q = sweep_pad() * w
        chunks += -(-n // q) * q // w
    assert port[(world, ep)]["sweep_zero1"][0]["state_numel"] == 2 * chunks


def test_groups_at_expert_parallel_sizes(tmp_path):
    """rank = d·ep + e: the expert-parallel group is the ep consecutive
    ranks, the expert-data group the ranks with the same e."""
    res = worker.run("groups", 4, str(tmp_path), [{"ep_size": 2},
                                                  {"ep_size": 4},
                                                  {"ep_size": 1}])
    for r, out in enumerate(res):
        ep2, ep4, ep1 = out["cases"]
        assert ep2 == {"ep": 2, "ep_rank": r % 2, "edp": 2, "edp_rank": r // 2,
                       "ep_ranks": [r // 2 * 2, r // 2 * 2 + 1],
                       "edp_ranks": [r % 2, r % 2 + 2]}
        assert ep4["ep_ranks"] == [0, 1, 2, 3] and ep4["edp_ranks"] == [r]
        assert ep1 == {"ep": 1, "ep_rank": 0, "edp": 4, "edp_rank": r,
                       "ep_ranks": None, "edp_ranks": None}


def test_all_to_all_is_its_own_inverse(tmp_path):
    """``comm.all_to_all`` exchanges dimension-0 chunks over the
    expert-parallel group: rank r's chunk j goes to rank j. Its backward
    is the inverse exchange: a cotangent of r + 1 on rank r's output
    comes back as j + 1 on chunk j."""
    res = worker.run("all_to_all", 2, str(tmp_path), [{}])
    for r, out in enumerate(res):
        got = out["cases"][0]
        np.testing.assert_array_equal(got["out"], np.array(
            [[r], [10 + r]], np.float32).repeat(3, 1))
        np.testing.assert_array_equal(got["grad"], np.array(
            [[1.0], [2.0]], np.float32).repeat(3, 1))


# ------------------------------------------------------------ checkpoints
CKPT_MOE = TRAIN_MOE
CKPT_CFGS = {"fused": _config(1, True), "sweep": _sweep(1)}


@pytest.fixture(scope="module", params=list(CKPT_CFGS))
def ep2_tag(request, setup, tmp_path_factory):
    """A tag the port writes at world 2, ep 2, ZeRO 1 after 2 steps; its
    next 2 steps; and a JAX tag written on a 2-device mesh at ep 2,
    loaded by the port at world 2, ep 2 (its masters); with the
    per-tensor fused Adam and with the sweep."""
    ckpt_cfg = CKPT_CFGS[request.param]
    batches, init = setup
    root = tmp_path_factory.mktemp("moe_ckpt")
    jax_dir = str(root / "jax")
    groups.destroy()
    groups.initialize(ep_size=2, devices=jax.devices()[:2])
    engine, *_ = deepspeed_tpu.initialize(
        model=jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(
            **dict(oracle.TINY_MOE, **CKPT_MOE))),
        config=_jax_config(ckpt_cfg), sample_batch=batches[0],
        seed=oracle.SEED)
    for b in batches[:2]:
        engine.train_batch(batch=b)
    engine.save_checkpoint(jax_dir, tag="j")
    jax_params = {k: v.numpy() for k, v in flax_to_state_dict(jax.tree.map(
        np.asarray, engine.state.params)).items()}
    jax_after = [float(engine.train_batch(batch=b)) for b in batches[2:]]
    groups.destroy()
    common = dict(model="gpt2", model_cfg=_model_cfg(CKPT_MOE),
                  config=ckpt_cfg, init=init, ep_size=2)
    port_dir = str(root / "port")
    res = worker.run("checkpoint", 2, str(root / "spawn"), [
        dict(common, dir=port_dir, batches=batches[:2], save=True, tag="p",
             after=batches[2:]),
        dict(common, dir=jax_dir, load=True, load_tag="j",
             after=batches[2:])])
    return (batches, port_dir, [r["cases"][0] for r in res], jax_dir,
            jax_params, jax_after, [r["cases"][1] for r in res], ckpt_cfg)


def test_ep2_tag_holds_the_jax_layout(ep2_tag):
    """One file a global expert, written once; the model-states tree
    without the experts; the shard payloads' expert leaves whole-layer
    [E, ...], as in the JAX tag."""
    _, port_dir, ranks, jax_dir, _, _, _, _ = ep2_tag
    files = ranks[0]["files"]
    assert [f for f in files if f.startswith("layer_")] == [
        f"layer_0_expert_{e}_mp_rank_00_model_states.pt" for e in range(4)]
    assert sorted(f for f in os.listdir(os.path.join(jax_dir, "j"))
                  if f.startswith("layer_")) == [
        f for f in files if f.startswith("layer_")]
    sd = jax_ckpt.load_file(os.path.join(port_dir, "p",
                                         "mp_rank_00_model_states.pt"))
    jsd = jax_ckpt.load_file(os.path.join(jax_dir, "j",
                                          "mp_rank_00_model_states.pt"))
    for key in ("has_moe_layers", "moe_layer_prefixes",
                "moe_expert_counts"):
        assert sd[key] == jsd[key], key
    assert jax.tree.structure(sd["module"]) == \
        jax.tree.structure(jsd["module"])
    exp = jax_ckpt.load_file(os.path.join(
        port_dir, "p", "layer_0_expert_3_mp_rank_00_model_states.pt"))
    jexp = jax_ckpt.load_file(os.path.join(
        jax_dir, "j", "layer_0_expert_3_mp_rank_00_model_states.pt"))
    assert {k: v.shape for k, v in exp.items()} == \
        {k: v.shape for k, v in jexp.items()}
    at_save = _whole([dict(r, params=r["params_at_save"]) for r in ranks],
                     2)
    np.testing.assert_array_equal(
        exp["h_1/moe/deepspeed_moe/deepspeed_experts/fc1/kernel"],
        at_save["h.1.moe.deepspeed_moe.deepspeed_experts.fc1.weight"][3])


def test_ep2_tag_resumes_at_ep1_and_in_jax(setup, ep2_tag):
    """The port's ep-2 tag loads into the port at ep 1 (one rank) and
    into the JAX engine on one device: the masters bit-equal to the
    saving ranks', the next 2 steps equal theirs."""
    _, init = setup
    batches, port_dir, ranks, _, _, _, _, ckpt_cfg = ep2_tag
    want = _whole([dict(r, params=r["params_at_save"]) for r in ranks], 2)
    tgroups.destroy()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=worker.make_model({"model": "gpt2",
                                 "model_cfg": _model_cfg(CKPT_MOE)}),
        config=copy.deepcopy(ckpt_cfg), device="cpu")
    engine.load_checkpoint(port_dir, tag="p")
    for k, p in engine.params.items():
        assert np.array_equal(p.detach().numpy(), want[k]), k
    after = [float(engine.train_batch(batch=b)) for b in batches[2:]]
    np.testing.assert_allclose(after, ranks[0]["after"], **SELF_TOL)
    tgroups.destroy()

    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    jengine, *_ = deepspeed_tpu.initialize(
        model=jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(
            **dict(oracle.TINY_MOE, **CKPT_MOE))),
        config=_jax_config(ckpt_cfg), sample_batch=batches[0],
        seed=oracle.SEED)
    jengine.load_checkpoint(port_dir, tag="p")
    got = {k: v.numpy() for k, v in flax_to_state_dict(jax.tree.map(
        np.asarray, jengine.state.params)).items()}
    for k, w in want.items():
        assert np.array_equal(got[k], w), k
    jafter = [float(jengine.train_batch(batch=b)) for b in batches[2:]]
    groups.destroy()
    np.testing.assert_allclose(jafter, ranks[0]["after"], **TOL)


def test_jax_tag_loads_into_the_port_both_ways(setup, ep2_tag):
    """The JAX engine's ep-2 tag loads into the port at world 2, ep 2 and
    at ep 1: masters bit-equal to JAX's, the next 2 steps equal the JAX
    engine's."""
    batches, _, _, jax_dir, jax_params, jax_after, loaded, ckpt_cfg = \
        ep2_tag
    got = _whole([dict(r, params=r["params"]) for r in loaded], 2)
    for r in loaded:
        np.testing.assert_allclose(r["after"], jax_after, **TOL)
    tgroups.destroy()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=worker.make_model({"model": "gpt2",
                                 "model_cfg": _model_cfg(CKPT_MOE)}),
        config=copy.deepcopy(ckpt_cfg), device="cpu")
    engine.load_checkpoint(jax_dir, tag="j")
    for k, p in engine.params.items():
        assert np.array_equal(p.detach().numpy(), jax_params[k]), k
    after = [float(engine.train_batch(batch=b)) for b in batches[2:]]
    np.testing.assert_allclose(after, jax_after, **TOL)
    tgroups.destroy()
    assert set(got) == set(jax_params)
