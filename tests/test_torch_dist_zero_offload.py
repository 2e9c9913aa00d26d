"""The optimizer offload, MoE at ZeRO 2 and 3, and stage-2/3 and offload
checkpoints in the PyTorch port (``torch.distributed`` over gloo, one
process a rank) against the JAX engine, on the CPU.

* Offload: the Adam moments in host RAM (``offload_optimizer.device:
  cpu``) or in files of a temporary folder through the async IO engine
  (``nvme``), the update by the host CPU-Adam (``csrc/cpu_adam.cpp``, the
  JAX package's source), at ZeRO 1-3 on 2 and 4 ranks: losses and
  masters against the JAX engine's offload on a mesh of as many devices,
  and ``gpt2_tiny_fp32_adam``'s golden curve, at 2e-4 relative, the JAX
  suite's offload tolerance (``tests/model/test_loss_parity.py:124``).
* MoE-GPT at ep 2 on 4 ranks (the experts cut over the expert-data group
  of 2) at ZeRO 2 and 3 against the JAX engine on a 4-device mesh at ep
  2, at 1e-4.
* Checkpoints: a stage-3 tag the port writes at world 2 (rank 0 without
  the ``module`` tree, every master's slices in the shard files) resumes
  the port at world 2 bit for bit, at world 4 and in the JAX engine at
  1e-4; the JAX engine's stage-3 tag and its offload tag (moments by the
  JAX grad layout's rule) resume the port at 1e-4 and 2e-4; the port's
  offload tags (cpu and nvme) resume it bit for bit.

The stage-3 persistence threshold keeps GPT-2's [64]-long tensors whole
and cuts the matrices (``tests/test_torch_dist_zero.py``).
"""

import copy
import json
import os
import shutil

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.bridge import flax_to_state_dict
from deepspeed_tpu_torch.moe.layer import is_moe_param
from tests import torch_dist_worker as worker
from tests.model import oracle

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain available")

TOL = dict(rtol=1e-4, atol=1e-4)
OFFLOAD_TOL = dict(rtol=2e-4, atol=2e-4)
STEPS = 4
GOLDEN_STEPS = 20
PERSIST = 1000
GOLDEN = os.path.join(os.path.dirname(__file__), "model", "baselines",
                      "gpt2_tiny_fp32_adam.json")
MOE = dict(moe_num_experts=4, moe_k=1, moe_capacity_factor=4.0,
           moe_eval_capacity_factor=0.5)


def _config(stage, offload=None, fused=False, clip=0.5, lr=2e-3, wd=0.01,
            sweep=False):
    zero = {"stage": stage, "stage3_param_persistence_threshold": PERSIST}
    if offload is not None:
        zero["offload_optimizer"] = offload
    params = {"lr": lr, "weight_decay": wd}
    if fused:
        params["fused"] = True
    if sweep:
        params["sweep"] = True
    cfg = {"train_batch_size": oracle.BATCH_SIZE, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "AdamW", "params": params},
           "zero_optimization": zero}
    if clip:
        cfg["gradient_clipping"] = clip
    return cfg


def _golden_config(stage, offload):
    return _config(stage, offload, clip=0, lr=oracle.LR, wd=0.0)


CPU = {"device": "cpu"}


def _nvme(root):
    return {"device": "nvme", "nvme_path": str(root)}


# the async IO engine's thread pool (buffered pread/pwrite, the
# reference's own engine where O_DIRECT is refused): an O_DIRECT write
# to a virtual disk can take ~10 ms, which makes a tiny model's step
# ~1.6 s on the kernel engine. One case runs the kernel engine
# (nvme_kernel_zero2), and so does tests/test_torch_zero.py's swapper
# test
THREAD_POOL = {"DS_AIO_DISABLE_KERNEL": "1"}


@pytest.fixture(scope="module")
def setup():
    """(oracle batches as numpy, the bridged flax inits of tiny GPT-2 and
    tiny MoE-GPT)."""
    batches = [{"input_ids": np.array(b["input_ids"])}
               for b in oracle.make_batches(GOLDEN_STEPS)]
    inits = {}
    for name, cfg in (("gpt2", oracle.TINY),
                      ("moe", dict(oracle.TINY, **MOE))):
        model = jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(**cfg))
        params = model.init(jax.random.PRNGKey(oracle.SEED), batches[0])
        inits[name] = flax_to_state_dict(jax.tree.map(np.asarray,
                                                      params["params"]))
    return batches, inits


def _jax_engine(cfg, ndev, ep=1, moe=False):
    groups.destroy()
    groups.initialize(ep_size=ep, devices=jax.devices()[:ndev])
    model_cfg = dict(oracle.TINY, **MOE) if moe else oracle.TINY
    batches = [{"input_ids": np.array(b["input_ids"])}
               for b in oracle.make_batches(1)]
    engine, *_ = deepspeed_tpu.initialize(
        model=jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(**model_cfg)),
        config=copy.deepcopy(cfg), sample_batch=batches[0],
        seed=oracle.SEED)
    return engine


def _masters(engine):
    return {k: v.numpy() for k, v in flax_to_state_dict(jax.tree.map(
        np.asarray, engine.state.params)).items()}


@pytest.fixture(scope="module")
def jax_tags(setup, tmp_path_factory):
    """The JAX engine on a 2-device mesh: a ZeRO-3 tag and an offloaded
    ZeRO-2 tag after 2 steps, and each run's next 2 losses."""
    batches, _ = setup
    root = tmp_path_factory.mktemp("jax_tags")
    out = {}
    for name, cfg in (("zero3", _config(3)), ("offload", _config(2, CPU))):
        engine = _jax_engine(cfg, 2)
        for b in batches[:2]:
            engine.train_batch(batch=b)
        engine.save_checkpoint(str(root), tag=name)
        out[name] = [float(engine.train_batch(batch=b))
                     for b in batches[2:STEPS]]
        out[name + "_masters"] = _masters(engine)
    groups.destroy()
    return str(root), out


@pytest.fixture(scope="module")
def port(setup, jax_tags, tmp_path_factory):
    """{world: {case: [rank results]}}: one spawn a world size (world 2's
    first: world 4 loads its tag)."""
    batches, inits = setup
    jax_dir, _ = jax_tags
    root = tmp_path_factory.mktemp("port_zero_offload")
    tags = str(root / "tags")
    first, after = batches[:2], batches[2:STEPS]
    gpt = dict(model="gpt2", init=inits["gpt2"])
    out = {}
    for world in (2, 4):
        nvme = root / f"nvme{world}"
        named = []
        for stage in (1, 2, 3):
            named.append((f"cpu_zero{stage}", dict(
                gpt, config=_config(stage, CPU), batches=batches[:STEPS])))
            named.append((f"nvme_zero{stage}", dict(
                gpt, config=_config(stage, _nvme(nvme)),
                batches=batches[:STEPS], env=THREAD_POOL)))
        if world == 2:
            named += [
                ("nvme_kernel_zero2", dict(
                    gpt, config=_config(2, _nvme(nvme)),
                    batches=batches[:STEPS])),
                ("golden_cpu_zero3", dict(gpt, config=_golden_config(
                    3, CPU), batches=batches)),
                ("golden_nvme_zero2", dict(gpt, config=_golden_config(
                    2, _nvme(nvme)), batches=batches, env=THREAD_POOL)),
                # port -> port: stage 3, offload to RAM and to NVMe
                ("save_zero3", dict(gpt, kind="checkpoint", dir=tags,
                                    config=_config(3, fused=True),
                                    batches=first, save=True, tag="z3",
                                    after=after)),
                ("resume_zero3", dict(gpt, kind="checkpoint", dir=tags,
                                      config=_config(3, fused=True),
                                      load=True, load_tag="z3", seed=1,
                                      batches=after)),
                # the stage-3 sweep: its vector of slices saved whole
                ("save_sweep_zero3", dict(gpt, kind="checkpoint", dir=tags,
                                          config=_config(3, sweep=True),
                                          batches=first, save=True,
                                          tag="sweep3", after=after)),
                ("resume_sweep_zero3", dict(
                    gpt, kind="checkpoint", dir=tags,
                    config=_config(3, sweep=True), load=True,
                    load_tag="sweep3", seed=1, batches=after)),
                ("save_cpu_zero2", dict(gpt, kind="checkpoint", dir=tags,
                                        config=_config(2, CPU),
                                        batches=first, save=True,
                                        tag="cpu", after=after)),
                ("resume_cpu_zero2", dict(gpt, kind="checkpoint", dir=tags,
                                          config=_config(2, CPU), load=True,
                                          load_tag="cpu", seed=1,
                                          batches=after)),
                ("save_nvme_zero3", dict(gpt, kind="checkpoint", dir=tags,
                                         config=_config(3, _nvme(nvme)),
                                         batches=first, save=True,
                                         tag="nvme", after=after,
                                         env=THREAD_POOL)),
                ("resume_nvme_zero3", dict(gpt, kind="checkpoint", dir=tags,
                                           config=_config(3, _nvme(nvme)),
                                           load=True, load_tag="nvme",
                                           seed=1, batches=after,
                                           env=THREAD_POOL)),
                # JAX -> port
                ("jax_zero3", dict(gpt, kind="checkpoint", dir=jax_dir,
                                   config=_config(3), load=True,
                                   load_tag="zero3", seed=1, batches=after)),
                ("jax_offload", dict(gpt, kind="checkpoint", dir=jax_dir,
                                     config=_config(2, CPU), load=True,
                                     load_tag="offload", seed=1,
                                     batches=after)),
            ]
        else:
            named += [
                # the world-2 stage-3 tags at world 4
                ("resume_zero3", dict(gpt, kind="checkpoint", dir=tags,
                                      config=_config(3, fused=True),
                                      load=True, load_tag="z3", seed=1,
                                      batches=after)),
                ("resume_sweep_zero3", dict(
                    gpt, kind="checkpoint", dir=tags,
                    config=_config(3, sweep=True), load=True,
                    load_tag="sweep3", seed=1, batches=after)),
            ] + [(f"moe_zero{stage}", dict(
                model="gpt2", model_cfg=MOE, init=inits["moe"], ep_size=2,
                config=_config(stage, fused=True), batches=batches[:STEPS]))
                for stage in (2, 3)]
        names = [n for n, _ in named]
        res = worker.run("engine", world, str(root / f"spawn{world}"),
                         [c for _, c in named])
        assert all(r["jax_modules"] == [] for r in res)
        out[world] = {n: [r["cases"][i] for r in res]
                      for i, n in enumerate(names)}
        # the swap folders are removed when their engines close, or kept
        # by a live one: none is left once every engine is gone
        assert not os.path.exists(nvme) or not any(
            f.endswith(".swp") for _, _, fs in os.walk(nvme) for f in fs)
    return tags, out


_JAX_RUNS = {}


def _jax_offload(world):
    """The JAX engine's offloaded run (stage 2, host CPU-Adam) on a
    ``world``-device mesh: losses and masters."""
    if world not in _JAX_RUNS:
        batches = [{"input_ids": np.array(b["input_ids"])}
                   for b in oracle.make_batches(STEPS)]
        engine = _jax_engine(_config(2, CPU), world)
        losses = [float(engine.train_batch(batch=b)) for b in batches]
        _JAX_RUNS[world] = (losses, _masters(engine))
        groups.destroy()
    return _JAX_RUNS[world]


def _assert_params(got, want, **tol):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **tol)


OFFLOAD_PAIRS = [(w, d, s) for w in (2, 4) for d in ("cpu", "nvme")
                 for s in (1, 2, 3)] + [(2, "nvme_kernel", 2)]


@pytest.mark.parametrize("world,device,stage", OFFLOAD_PAIRS)
def test_offload_matches_jax_engine(port, world, device, stage):
    """Losses and masters at 2e-4 against the JAX engine's offload on a
    mesh of ``world`` devices; every rank's masters equal; no optimizer
    state on the device."""
    want_losses, want_params = _jax_offload(world)
    ranks = port[1][world][f"{device}_zero{stage}"]
    for r in ranks:
        assert r["state_numel"] == 0
        np.testing.assert_allclose(r["losses"], want_losses, **OFFLOAD_TOL)
        _assert_params(r["params"], want_params, **OFFLOAD_TOL)
        assert r["losses"] == ranks[0]["losses"]


@pytest.mark.parametrize("name", ("golden_cpu_zero3", "golden_nvme_zero2"))
def test_offload_reproduces_the_golden_curve(port, name):
    with open(GOLDEN) as f:
        golden = json.load(f)["losses"]
    for r in port[1][2][name]:
        np.testing.assert_allclose(r["losses"], golden, **OFFLOAD_TOL)


def _whole(ranks, ep):
    """The masters with every expert leaf stacked from the ranks of the
    first expert-parallel group."""
    out = dict(ranks[0]["params"])
    for k in out:
        if is_moe_param(k):
            out[k] = np.concatenate([ranks[e]["params"][k]
                                     for e in range(ep)])
    return out


@pytest.mark.parametrize("stage", (2, 3))
def test_moe_at_ep2_matches_jax_engine(port, stage):
    """MoE-GPT at world 4, ep 2: the dense tensors cut over the world,
    the experts over the expert-data group of 2 (their masters too at
    stage 3), against the JAX engine on a 4-device mesh at ep 2."""
    key = "moe"
    if key not in _JAX_RUNS:
        batches = [{"input_ids": np.array(b["input_ids"])}
                   for b in oracle.make_batches(STEPS)]
        engine = _jax_engine(_config(3), 4, ep=2, moe=True)
        losses = [float(engine.train_batch(batch=b)) for b in batches]
        _JAX_RUNS[key] = (losses, _masters(engine))
        groups.destroy()
    want_losses, want_params = _JAX_RUNS[key]
    ranks = port[1][4][f"moe_zero{stage}"]
    np.testing.assert_allclose(ranks[0]["losses"], want_losses, **TOL)
    _assert_params(_whole(ranks, 2), want_params, **TOL)


@pytest.mark.parametrize("name", ("zero3", "cpu_zero2", "nvme_zero3",
                                  "sweep_zero3"))
def test_port_tag_resumes_bit_equal(port, name):
    """A fresh engine (another init seed) loads the tag at the world that
    wrote it and takes the saving run's next 2 steps bit for bit: losses
    and masters (the host moments of an offloaded run included)."""
    saved = port[1][2][f"save_{name}"]
    resumed = port[1][2][f"resume_{name}"]
    for s, r in zip(saved, resumed):
        assert r["losses"] == s["after"]
        for k, p in s["params"].items():
            assert np.array_equal(r["params"][k], p), k


def test_stage3_tag_holds_shards_and_no_module(port):
    """At stage 3 rank 0 writes the model states without ``module`` (it
    does not hold the masters), each rank its shard file."""
    from deepspeed_tpu.runtime import checkpoint_io as jax_ckpt
    tags, out = port
    files = out[2]["save_zero3"][0]["files"]
    assert "zero_pp_rank_1_mp_rank_00_optim_states.pt" in files
    sd = jax_ckpt.load_file(os.path.join(tags, "z3",
                                         "mp_rank_00_model_states.pt"))
    assert sd["module"] is None
    z = jax_ckpt.load_file(os.path.join(
        tags, "z3", "zero_pp_rank_1_mp_rank_00_optim_states.pt"))
    assert z["zero_stage"] == 3 and z["partition_count"] == 2
    # zero_to_fp32 reassembles the slices, as the JAX package's does
    from deepspeed_tpu.utils import zero_to_fp32 as jax_z2f
    from deepspeed_tpu_torch.utils import zero_to_fp32
    got = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(tags, "z3")
    want = jax_z2f.get_fp32_state_dict_from_zero_checkpoint(tags, "z3")
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k], np.asarray(v)), k
    at_save = out[2]["save_zero3"][0]["params_at_save"]
    np.testing.assert_array_equal(got["['h_1']['attn']['qkv']['kernel']"],
                                  at_save["h.1.attn.qkv.weight"].T)


def _resumes_at_world4_and_in_jax(port, name, tag):
    """The world-2 stage-3 tag ``tag`` (run ``save_{name}``) at world 4
    and in the JAX engine on a 2-device mesh: the next 2 steps at 1e-4
    of the saving run's, and JAX's masters at 1e-4 of its."""
    tags, out = port
    want = out[2][f"save_{name}"][0]["after"]
    for r in out[4][f"resume_{name}"]:
        np.testing.assert_allclose(r["losses"], want, **TOL)
    batches = [{"input_ids": np.array(b["input_ids"])}
               for b in oracle.make_batches(STEPS)]
    engine = _jax_engine(_config(3, sweep=name.startswith("sweep")), 2)
    engine.load_checkpoint(tags, tag=tag)
    got = [float(engine.train_batch(batch=b)) for b in batches[2:]]
    groups.destroy()
    np.testing.assert_allclose(got, want, **TOL)
    _assert_params(out[2][f"save_{name}"][0]["params"], _masters(engine),
                   **TOL)


def test_stage3_tag_resumes_at_world4_and_in_jax(port):
    """The world-2 stage-3 tag at world 4 (elastic reassembly of the
    shards) and in the JAX engine on a 2-device mesh: the next 2 steps
    at 1e-4 of the saving run's."""
    _resumes_at_world4_and_in_jax(port, "zero3", "z3")


def test_stage3_sweep_tag_resumes_at_world4_and_in_jax(port):
    """The Adam sweep's stage-3 tag: its moments are JAX's one vector in
    JAX's leaf order, gathered from the ranks' vectors of slices; it
    resumes at world 4 and in JAX's own sweep on a 2-device mesh."""
    _resumes_at_world4_and_in_jax(port, "sweep_zero3", "sweep3")


@pytest.mark.parametrize("name,tol", [("zero3", TOL),
                                      ("offload", OFFLOAD_TOL)])
def test_jax_tags_resume_the_port(jax_tags, port, name, tol):
    """The JAX engine's stage-3 tag and its offload tag (the host moments
    cut by its grad layout, reassembled here) load into the port at
    world 2 and take the JAX run's next 2 steps."""
    _, want = jax_tags
    for r in port[1][2][f"jax_{name}"]:
        np.testing.assert_allclose(r["losses"], want[name], **tol)
        _assert_params(r["params"], want[name + "_masters"], **tol)
