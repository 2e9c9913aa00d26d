"""Sequence parallelism in the port's GPT-2: ``attention_mode=
"ring:<axis>"`` / ``"ulysses:<axis>"`` through the engine, on gloo ranks
spawned by ``tests/torch_dist_worker.py``, against the JAX engine on 2-
and 4-device meshes, on the CPU.

JAX shards the batch by rows over the data axis and, inside attention,
``shard_map`` with ``P(None, None, axis, None)`` hands each device every
row and its own S/n chunk of the sequence. The port's ranks hold their
rows and make that layout with an all-to-all over the axis's group
(``models/gpt2._sequence_parallel``), so each rank feeds the engine its
rows of the same global batches, as for data parallelism. Tiny GPT-2
from the flax init, learned and rope positions, ZeRO 0 and 1, bs 8 ×
seq 32, 3 steps of Adam with the clip. Tolerances: ``tests/
test_torch_dist_engine.py``'s rtol = atol = 1e-4 for losses and masters
against JAX (Adam turns a last-bit difference of two gradient sums into
~1e-5); 1e-5 for the losses against the port's own ``auto`` mode (the
ring merges the chunks' partial outputs in another order), masters at
1e-4. MoE-GPT at ep 2 on 4 ranks runs ``ring:data`` (over the
expert-data group) and ``ring:expert`` (over the expert-parallel group)
against the JAX engine with ``ep_size=2``.
"""

import copy

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.bridge import flax_to_state_dict
from deepspeed_tpu_torch.models import gpt2
from tests import torch_dist_worker as worker
from tests.model import oracle

TOL = dict(rtol=1e-4, atol=1e-4)
AUTO_TOL = dict(rtol=1e-5, atol=1e-5)
STEPS = 3
WORLDS = (2, 4)
MODES = ("ring:data", "ulysses:data")
POSITIONS = ("learned", "rope")
STAGES = (0, 1)
MOE = dict(moe_num_experts=4, moe_capacity_factor=4.0)   # no token drops
MOE_MODES = ("ring:data", "ring:expert")


def _config(stage):
    return {"train_batch_size": oracle.BATCH_SIZE,
            "steps_per_print": 10 ** 9, "gradient_clipping": 0.5,
            "optimizer": {"type": "Adam", "params": {"lr": 2e-3}},
            "zero_optimization": {"stage": stage}}


def _init(model_cfg, batch):
    model = jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(
        **dict(oracle.TINY, **model_cfg)))
    params = model.init(jax.random.PRNGKey(oracle.SEED), batch)["params"]
    return flax_to_state_dict(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def setup():
    """(oracle batches as numpy, {position_embedding or "moe": the
    bridged flax init})."""
    batches = [{"input_ids": np.array(b["input_ids"])}
               for b in oracle.make_batches(STEPS)]
    inits = {pos: _init({"position_embedding": pos}, batches[0])
             for pos in POSITIONS}
    inits["moe"] = _init(MOE, batches[0])
    return batches, inits


def _dense_cases(batches, inits):
    keys, cases = [], []
    for mode in MODES + ("auto",):
        for pos in POSITIONS:
            for stage in (STAGES if mode != "auto" else (1,)):
                keys.append((mode, pos, stage))
                cases.append(dict(model="gpt2", model_cfg={
                    "attention_mode": mode, "position_embedding": pos},
                    config=_config(stage), init=inits[pos],
                    batches=batches))
    return keys, cases


@pytest.fixture(scope="module")
def port(setup, tmp_path_factory):
    """{world: {case key: [rank results]}}: one spawn a world size."""
    batches, inits = setup
    out = {}
    for world in WORLDS:
        keys, cases = _dense_cases(batches, inits)
        # a sequence the group's ranks do not divide
        short = {"input_ids": batches[0]["input_ids"][:, :world * 4 + 1]}
        for mode in MODES:
            keys.append(("indivisible", mode))
            cases.append(dict(kind="step_error", model="gpt2", model_cfg={
                "attention_mode": mode}, config=_config(1), batch=short))
        keys.append(("axes", 1))
        cases.append(dict(kind="axis", ep_size=1))
        if world == 4:
            keys.append(("axes", 2))
            cases.append(dict(kind="axis", ep_size=2))
            for mode in MOE_MODES + ("auto",):
                keys.append(("moe", mode))
                cases.append(dict(model="gpt2", model_cfg=dict(
                    MOE, attention_mode=mode), config=_config(1),
                    init=inits["moe"], batches=batches, ep_size=2))
        res = worker.run("engine", world,
                         str(tmp_path_factory.mktemp(f"ring{world}")), cases)
        assert all(r["jax_modules"] == [] for r in res)
        out[world] = {k: [r["cases"][i] for r in res]
                      for i, k in enumerate(keys)}
    return out


_JAX_RUNS = {}


def _jax_engine(model_cfg, world, batches, ep=1):
    """The JAX engine's losses and masters on a ``world``-device mesh
    (ZeRO 1: JAX's update does not depend on the stage)."""
    key = (repr(sorted(model_cfg.items())), world, ep)
    if key not in _JAX_RUNS:
        groups.destroy()
        groups.initialize(ep_size=ep, devices=jax.devices()[:world])
        engine, *_ = deepspeed_tpu.initialize(
            model=jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(
                **dict(oracle.TINY, **model_cfg))),
            config=copy.deepcopy(_config(1)), sample_batch=batches[0],
            seed=oracle.SEED)
        losses = [float(engine.train_batch(batch=b)) for b in batches]
        params = flax_to_state_dict(jax.tree.map(np.asarray,
                                                 engine.state.params))
        groups.destroy()
        _JAX_RUNS[key] = (losses, {k: v.numpy() for k, v in params.items()})
    return _JAX_RUNS[key]


def _assert_run(ranks, want_losses, want_params, tol=TOL, param_tol=TOL):
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want_losses, **tol)
    got = ranks[0]["params"]
    assert set(got) == set(want_params)
    for k, w in want_params.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **param_tol)
    for r in ranks[1:]:
        for k, p in got.items():
            assert np.array_equal(r["params"][k], p), k


# against the JAX engine: every mode and position on the 2-device mesh,
# each mode with one of the positions on the 4-device one (one JAX run
# serves both stages; the other two world-4 runs are held to the port's
# auto mode, which tests/test_torch_dist_engine.py holds to JAX)
JAX_PAIRS = [(m, p, 2) for m in MODES for p in POSITIONS] + [
    ("ring:data", "rope", 4), ("ulysses:data", "learned", 4)]


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("mode,pos,world", JAX_PAIRS)
def test_matches_jax_engine_on_a_mesh(setup, port, mode, pos, world, stage):
    """Losses and updated masters of ``mode`` with ``pos`` positions at
    ZeRO ``stage`` against the JAX engine's same mode on a
    ``world``-device mesh; every rank's masters equal."""
    batches, _ = setup
    want = _jax_engine({"attention_mode": mode, "position_embedding": pos},
                       world, batches)
    _assert_run(port[world][(mode, pos, stage)], *want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("mode", MODES)
def test_each_mode_equals_auto(port, mode, pos, stage, world):
    """Sequence parallelism changes where attention runs, not what it
    computes: the mode's losses and masters at ZeRO ``stage`` are
    ``auto``'s at ZeRO 1 on the same batches (Adam updates a slice as it
    updates the whole tensor)."""
    auto = port[world][("auto", pos, 1)]
    _assert_run(port[world][(mode, pos, stage)], auto[0]["losses"],
                auto[0]["params"], tol=AUTO_TOL)


@pytest.mark.parametrize("mode", MOE_MODES)
def test_moe_at_ep2_matches_jax_engine_on_an_expert_mesh(setup, port, mode):
    """MoE-GPT at ep 2 on 4 ranks: ``ring:data`` exchanges over the
    expert-data group, ``ring:expert`` over the expert-parallel group;
    losses against the JAX engine with ``ep_size=2``, the dense masters
    (equal on every rank) and each rank's experts against JAX's."""
    batches, _ = setup
    want_losses, want_params = _jax_engine(dict(MOE, attention_mode=mode), 4,
                                           batches, ep=2)
    ranks = port[4][("moe", mode)]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want_losses, **TOL)
    for rank, r in enumerate(ranks):
        for k, p in r["params"].items():
            w = want_params[k]
            if p.shape != w.shape:      # this rank's experts of the layer
                e = rank % 2
                w = w[e * p.shape[0]:(e + 1) * p.shape[0]]
            np.testing.assert_allclose(p, w, err_msg=k, **TOL)
    auto = port[4][("moe", "auto")]
    for a, b in zip(ranks, auto):
        np.testing.assert_allclose(a["losses"], b["losses"], **AUTO_TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", MODES)
def test_sequence_not_divisible_raises(setup, port, mode, world):
    """S must divide by the group's ranks, as ``shard_map`` requires: the
    port raises ``ValueError`` naming the sequence on every rank, and the
    JAX engine raises on the same global batch."""
    batches, _ = setup
    for text in port[world][("indivisible", mode)]:
        assert text.startswith("ValueError") and "divide" in text, text
    short = {"input_ids": batches[0]["input_ids"][:, :world * 4 + 1]}
    groups.destroy()
    groups.initialize(devices=jax.devices()[:world])
    engine, *_ = deepspeed_tpu.initialize(
        model=jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(
            **dict(oracle.TINY, attention_mode=mode))),
        config=copy.deepcopy(_config(1)), sample_batch=batches[0],
        seed=oracle.SEED)
    with pytest.raises(Exception, match="divisible|divide"):
        engine.train_batch(batch=short)
    groups.destroy()


@pytest.mark.parametrize("world", WORLDS)
def test_axis_names_map_to_groups(port, world):
    """``data`` is the world at ep 1 and the expert-data group at ep 2
    (ranks e, e + 2); ``expert`` a group of one at ep 1 and the
    expert-parallel group at ep 2 (ranks 2d, 2d + 1); ``model`` and
    ``pipe`` groups of one, as the JAX mesh's axes of size 1."""
    for rank, axes in enumerate(port[world][("axes", 1)]):
        assert axes == {"pipe": [1, None], "data": [world,
                                                    list(range(world))],
                        "expert": [1, None], "model": [1, None]}
    if world == 4:
        for rank, axes in enumerate(port[4][("axes", 2)]):
            assert axes["data"] == [2, [rank % 2, rank % 2 + 2]]
            assert axes["expert"] == [2, [rank // 2 * 2, rank // 2 * 2 + 1]]
            assert axes["model"] == axes["pipe"] == [1, None]


@pytest.mark.parametrize("mode", ["ring:seq", "ulysses:seq"])
def test_an_axis_the_mesh_lacks_raises(setup, mode):
    """``"ring:seq"``: the port raises ``ValueError`` when the model is
    built; the JAX engine raises at its first trace, as its mesh has no
    such axis (``shard_map``'s ``ValueError`` for the ring, a
    ``KeyError`` of the mesh's shape for Ulysses)."""
    batches, _ = setup
    with pytest.raises(ValueError, match="seq"):
        gpt2.GPT2LMHeadModel(gpt2.GPT2Config(
            **dict(oracle.TINY, attention_mode=mode)), device="cpu")
    groups.destroy()
    groups.initialize(devices=jax.devices()[:2])
    with pytest.raises((ValueError, KeyError), match="seq"):
        engine, *_ = deepspeed_tpu.initialize(
            model=jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(
                **dict(oracle.TINY, attention_mode=mode))),
            config=copy.deepcopy(_config(1)), sample_batch=batches[0],
            seed=oracle.SEED)
        engine.train_batch(batch=batches[0])
    groups.destroy()


def test_decode_under_a_sequence_mode_raises():
    """A KV cache holds whole sequences: cached decoding refuses a
    sequence-parallel mode, as JAX's asserts."""
    import torch
    model = gpt2.GPT2LMHeadModel(gpt2.GPT2Config(
        **dict(oracle.TINY, attention_mode="ring:data")), device="cpu")
    with pytest.raises(ValueError, match="sequence parallelism"):
        model({"input_ids": torch.zeros(1, 4, dtype=torch.long)},
              cache=model.new_cache(1))
