"""Data parallelism in the PyTorch port (``torch.distributed`` over gloo,
one process a rank) against the JAX engine on a 2- and a 4-device mesh,
on the CPU.

The port's ranks run in processes spawned by ``tests/torch_dist_worker.py``
(one spawn a world size for all the cases of this file); each rank feeds
the engine its rows of the same global batches the JAX engine takes as
global arrays (rank r the r-th run of rows of each micro-batch). Tiny
GPT-2 from the flax init, 4 steps a case, bs 8 × seq 32. Tolerances are
``tests/test_torch_engine.py``'s: fp32 losses and masters at rtol = atol
= 1e-4 (the Adam forms' normalised update turns a last-bit difference of
two gradient sums into ~1e-5); the bf16 accumulator's losses at 1e-5 and
masters at atol 1e-4, as its single-rank test. Every case runs at ZeRO 0
and ZeRO 1 and each is held to the JAX engine; JAX's update does not
depend on the stage, so one JAX run serves both. Every rank's masters
must be equal, the optimizer state at ZeRO 1 a world'th of ZeRO 0's (up
to the replicated tensors), and world 2 equal to the port's own world 1
on the same global batches.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.bridge import flax_to_state_dict
from tests import torch_dist_worker as worker
from tests.model import oracle

TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 4
WORLDS = (2, 4)


def _config(opt, stage=1, **over):
    cfg = {"train_batch_size": oracle.BATCH_SIZE,
           "steps_per_print": 10 ** 9, "optimizer": opt,
           "zero_optimization": {"stage": stage}}
    cfg.update(over)
    return cfg


ADAMW = {"type": "AdamW", "params": {"lr": 2e-3, "weight_decay": 0.01}}
SGD = {"type": "SGD", "params": {"lr": 2e-2, "momentum": 0.9}}
ADAGRAD = {"type": "Adagrad", "params": {"lr": 1e-2}}


def _with(opt, **params):
    return {"type": opt["type"], "params": dict(opt["params"], **params)}


# name -> (JAX config, port config): the port's fused forms run their
# kernels' plain versions; the JAX engine runs the same rules without
# Pallas (interpret mode would take minutes)
CASES = {
    "sweep_zero1_clip": (_config(_with(ADAMW, sweep=True),
                                 gradient_clipping=0.5),) * 2,
    "sweep_zero0_clip": (_config(_with(ADAMW, sweep=True), stage=0,
                                 gradient_clipping=0.5),) * 2,
    "fused_adam_zero1_clip": (
        _config(ADAMW, gradient_clipping=0.5),
        _config(_with(ADAMW, fused=True), gradient_clipping=0.5)),
    "fused_adam_zero0_clip": (
        _config(ADAMW, stage=0, gradient_clipping=0.5),
        _config(_with(ADAMW, fused=True), stage=0, gradient_clipping=0.5)),
    "sgd_zero1": (_config(SGD),) * 2,
    "sgd_zero0": (_config(SGD, stage=0),) * 2,
    "adagrad_zero1": (_config(ADAGRAD),) * 2,
    "adagrad_zero0": (_config(ADAGRAD, stage=0),) * 2,
    "gas2_bf16_accumulator": (_config(
        {"type": "Adam", "params": {"lr": 2e-3}}, gradient_accumulation_steps=2,
        gradient_accumulation_dtype="bf16"),) * 2,
    # MoQ fake-quantizes the gathered masters, the same on every rank
    # (tests/test_torch_moq.py's schedule: 6 -> 4 bits, period 1)
    "moq_zero1": (_config({"type": "Adam", "params": {"lr": oracle.LR}},
                          quantize_training={
                              "enabled": True,
                              "quantize_bits": {"start_bits": 6,
                                                "target_bits": 4},
                              "quantize_schedule": {"quantize_period": 1},
                              "quantize_groups": 8}),) * 2,
}


@pytest.fixture(scope="module")
def setup():
    """(oracle batches as numpy, the bridged flax init)."""
    batches = [{"input_ids": np.array(b["input_ids"])}
               for b in oracle.make_batches(STEPS)]
    model = jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(**oracle.TINY))
    params = model.init(jax.random.PRNGKey(oracle.SEED), batches[0])
    init = flax_to_state_dict(jax.tree.map(np.asarray, params["params"]))
    return batches, init


@pytest.fixture(scope="module")
def port(setup, tmp_path_factory):
    """{world: {case name: [rank results]}}: one spawn a world size."""
    batches, init = setup
    names = list(CASES)
    cases = [dict(model="gpt2", config=CASES[n][1], init=init,
                  batches=batches, eval=True) for n in names]
    cases.append(dict(model="gpt2", config=CASES["sgd_zero1"][1], init=init,
                      batches=batches, client="sgd"))
    cases.append(dict(model="gpt2", config=CASES["sgd_zero1"][1], init=init,
                      batches=batches, manual_allreduce=True))
    cases.append(dict(model="gpt2", config=CLIENT_LAMB_CONFIG, init=init,
                      batches=batches, client="lamb"))
    out = {}
    for world in WORLDS:
        res = worker.run("engine", world,
                         str(tmp_path_factory.mktemp(f"engine{world}")),
                         cases)
        assert all(r["jax_modules"] == [] for r in res)
        out[world] = {n: [r["cases"][i] for r in res]
                      for i, n in enumerate(names + ["client_sgd_zero1",
                                                     "manual_allreduce",
                                                     "client_lamb_zero1"])}
    return out


_JAX_RUNS = {}


def _jax_engine(cfg, ndev, batches):
    """The JAX engine's losses and masters on an ``ndev``-device mesh,
    run once for the ZeRO stages of one configuration."""
    cfg = dict(cfg, zero_optimization={"stage": 1})
    key = (repr(sorted(cfg.items())), ndev)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _run_jax_engine(cfg, ndev, batches)
    return _JAX_RUNS[key]


def _run_jax_engine(cfg, ndev, batches):
    groups.destroy()
    groups.initialize(devices=jax.devices()[:ndev])
    engine, *_ = deepspeed_tpu.initialize(
        model=jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(**oracle.TINY)),
        config=copy.deepcopy(cfg), sample_batch=batches[0],
        seed=oracle.SEED)
    gas = engine.gradient_accumulation_steps()
    mb = oracle.BATCH_SIZE // gas
    losses = [float(engine.train_batch(data_iter=iter(
        {"input_ids": b["input_ids"][i * mb:(i + 1) * mb]}
        for i in range(gas)))) for b in batches]
    params = flax_to_state_dict(jax.tree.map(np.asarray,
                                             engine.state.params))
    return losses, {k: v.numpy() for k, v in params.items()}


def _assert_params(got, want, **tol):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **tol)


# against JAX's 2- and 4-device meshes (MoQ on the 2-device one)
JAX_PAIRS = [(n, w) for w in WORLDS for n in CASES
             if w == 2 or n != "moq_zero1"]


@pytest.mark.parametrize("name,world", JAX_PAIRS)
def test_matches_jax_engine_on_a_mesh(setup, port, name, world):
    """Losses and masters against the JAX engine on a ``world``-device
    mesh; every rank's masters equal."""
    batches, _ = setup
    ranks = port[world][name]
    want_losses, want_params = _jax_engine(CASES[name][0], world, batches)
    got = ranks[0]
    assert got["micro_batch"] == oracle.BATCH_SIZE // world // (
        2 if name.startswith("gas2") else 1)
    for r in ranks[1:]:
        assert r["losses"] == got["losses"]
        for k, p in got["params"].items():
            assert np.array_equal(r["params"][k], p), k
    if name.startswith("gas2"):
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5,
                                   atol=1e-5)
        _assert_params(got["params"], want_params, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(got["losses"], want_losses, **TOL)
        _assert_params(got["params"], want_params, **TOL)
    assert got["global_samples"] == STEPS * oracle.BATCH_SIZE
    if name.endswith("clip"):
        # the clip's norm is the averaged gradients', equal on every rank
        norms = {r["grad_norm"] for r in ranks}
        assert len(norms) == 1


@pytest.mark.parametrize("world", WORLDS)
def test_zero1_keeps_a_world_th_of_the_state(port, world):
    """At ZeRO 1 each rank keeps the optimizer state of its slices: a
    world'th of ZeRO 0's, up to the tensors no dimension of which the
    world divides; the sweep keeps its chunk of the two moments, padded
    to a multiple of sweep_pad() × world."""
    from deepspeed_tpu_torch.ops.adam.fused_adam import sweep_pad
    n = sum(p.size for p in port[world]["sgd_zero1"][0]["params"].values())
    q = sweep_pad() * world
    sweep = port[world]["sweep_zero1_clip"][0]["state_numel"]
    assert sweep == 2 * (-(-n // q) * q) // world
    for z0_name, z1_name in ZERO_PAIRS[1:]:
        z0 = port[world][z0_name][0]["state_numel"]
        z1 = port[world][z1_name][0]["state_numel"]
        assert z0 / world <= z1 < z0 / world * 1.02, (z0_name, z0, z1)


ZERO_PAIRS = [("sweep_zero0_clip", "sweep_zero1_clip"),
              ("fused_adam_zero0_clip", "fused_adam_zero1_clip"),
              ("sgd_zero0", "sgd_zero1"), ("adagrad_zero0", "adagrad_zero1")]


@pytest.mark.parametrize("world", WORLDS)
def test_zero0_equals_zero1_bit_for_bit(port, world):
    """The elementwise optimizers update a slice as they update the whole
    tensor, and the clip is the averaged gradients': ZeRO 1's losses and
    masters equal ZeRO 0's bit for bit."""
    for z0_name, z1_name in ZERO_PAIRS:
        z0, z1 = port[world][z0_name][0], port[world][z1_name][0]
        assert z0["losses"] == z1["losses"], z0_name
        for k, p in z0["params"].items():
            assert np.array_equal(z1["params"][k], p), (z0_name, k)


def test_world2_equals_the_port_at_world1(setup, port):
    """The port at world 2 takes the steps its world 1 takes on the same
    global batches (dropout 0): the averaged gradients are the global
    batch's."""
    batches, init = setup
    for name in ("sweep_zero1_clip", "sgd_zero1", "gas2_bf16_accumulator"):
        cfg = CASES[name][1]
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=worker.make_model({"model": "gpt2"}),
            config=copy.deepcopy(cfg), model_parameters=init, device="cpu")
        gas = engine.gradient_accumulation_steps()
        losses = [float(engine.train_batch(data_iter=iter(
            worker.rank_rows(b, 0, 1, gas, i) for i in range(gas))))
            for b in batches]
        got = port[2][name][0]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        _assert_params(got["params"], {k: p.detach().numpy() for k, p in
                                       engine.params.items()}, **TOL)
        # eval_batch: the mean over the ranks' rows of the first batch
        want_eval = float(engine.eval_batch(batches[0]))
        np.testing.assert_allclose(got["eval"], want_eval, rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_client_optimizer_runs_on_slices(port, world):
    """A client ``Optimizer(init, update)`` that declares
    ``takes_slices`` (an elementwise update, as ``optim.sgd``'s) is handed
    each rank's slices at ZeRO 1: client SGD equals the config's SGD bit
    for bit, with as little state."""
    client = port[world]["client_sgd_zero1"][0]
    config = port[world]["sgd_zero1"][0]
    assert client["losses"] == config["losses"]
    assert client["state_numel"] == config["state_numel"]
    for k, p in config["params"].items():
        assert np.array_equal(client["params"][k], p), k


@pytest.mark.parametrize("world", WORLDS)
def test_backward_without_allreduce_then_allreduce_gradients(port, world):
    """``backward(allreduce_gradients=False)``, then
    ``engine.allreduce_gradients()`` and ``step()`` (the reference's
    manual form) takes ``train_batch``'s step bit for bit."""
    manual = port[world]["manual_allreduce"][0]
    auto = port[world]["sgd_zero1"][0]
    assert manual["losses"] == auto["losses"]
    for k, p in auto["params"].items():
        assert np.array_equal(manual["params"][k], p), k


CLIENT_LAMB_CONFIG = _config({"type": "Adam", "params": {"lr": 2e-3}})


def test_client_optimizer_with_norms_sees_whole_tensors(setup, port):
    """A client optimizer that does not declare ``takes_slices`` (here
    LAMB without ``partition=``, whose trust ratio is a per-tensor norm)
    gets whole tensors at ZeRO 1 and keeps its state whole on every rank,
    as under JAX's GSPMD its math sees whole tensors: world 2 and 4 take
    the steps of world 1."""
    from deepspeed_tpu_torch.runtime import optim
    batches, init = setup
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=worker.make_model({"model": "gpt2"}),
        config=copy.deepcopy(CLIENT_LAMB_CONFIG), model_parameters=init,
        device="cpu", optimizer=optim.lamb(weight_decay=0.01))
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    want = {k: p.detach().numpy() for k, p in engine.params.items()}
    n = sum(p.size for p in want.values())
    for world in WORLDS:
        got = port[world]["client_lamb_zero1"]
        for r in got:
            np.testing.assert_allclose(r["losses"], losses, **TOL)
            _assert_params(r["params"], want, **TOL)
            # mu and nu of every whole tensor
            assert r["state_numel"] == 2 * n


def test_a_prebuilt_config_of_another_world_raises():
    """A ``DeepSpeedConfig`` triangulated for a data-parallel world the
    group does not have raises in the engine."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    cfg = DeepSpeedConfig(_config(SGD), data_parallel_size=2)
    with pytest.raises(ValueError, match="data-parallel world 2"):
        deepspeed_tpu_torch.initialize(
            model=worker.make_model({"model": "gpt2"}), config=cfg,
            device="cpu")


def test_groups_without_a_process_group():
    """No process group: a world of one rank, rank 0; the data group is
    the world, and model or pipe sizes above 1 raise naming their ROADMAP
    item; an expert size above 1 does not divide the world of one
    rank."""
    from deepspeed_tpu_torch.utils import groups as tgroups
    tgroups.destroy()
    assert not tgroups.mesh_is_initialized()
    tgroups.initialize()
    assert tgroups.mesh_is_initialized() and not tgroups.dist_active()
    assert (tgroups.get_data_parallel_world_size(), tgroups.get_world_size(),
            tgroups.get_data_parallel_rank(),
            tgroups.get_model_parallel_world_size()) == (1, 1, 0, 1)
    assert tgroups.MESH_AXES == groups.MESH_AXES
    assert (tgroups.get_expert_parallel_world_size(),
            tgroups.get_expert_parallel_rank(),
            tgroups.get_expert_data_parallel_world_size(),
            tgroups.get_expert_data_parallel_rank()) == (1, 0, 1, 0)
    for kw, item in (("mp_size", "item 11"), ("pp_size", "item 9")):
        with pytest.raises(NotImplementedError, match=item):
            tgroups.initialize(**{kw: 2})
    with pytest.raises(ValueError, match="not divisible"):
        tgroups.initialize(ep_size=2)
    tgroups.destroy()


@pytest.mark.parametrize("shape,world,dim", [
    ((8, 3), 2, 0), ((3, 8), 2, 1), ((3, 4, 8), 4, 2), ((6, 8, 4), 4, 1),
    ((3, 5), 2, None), ((), 2, None), ((0, 4), 2, None), ((5,), 1, 0)])
def test_partition_rule_and_boxes_tile_each_tensor(shape, world, dim):
    """The leading dimension when the world divides it, else the largest
    other; none: replicated. The ranks' boxes tile the tensor once, and
    ``local`` is the box's view (contiguous when cut on dimension 0)."""
    from deepspeed_tpu_torch.runtime.zero.partition import ZeroPartition
    t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    seen = torch.zeros(shape)
    for rank in range(world):
        part = ZeroPartition({"w": shape}, world, rank)
        assert part.dims["w"] == dim and part.sharded("w") == (
            dim is not None)
        box = part.box("w")
        local = part.local("w", t)
        assert torch.equal(local, t[tuple(slice(a, b) for a, b in box)])
        if dim == 0:
            assert local.is_contiguous()
        seen[tuple(slice(a, b) for a, b in box)] += 1
        if dim is None:
            break
    assert bool((seen == 1).all())
