"""ZeRO-3 parameter offload in the PyTorch port
(``runtime/zero/param_offload.py``: ``HostParamStore``, the layered
``Zero3OffloadEngine``; ``models/gpt2.gpt2_offload_layers``) against the
JAX package's engine, on the CPU.

Two layered models: the JAX suite's 8 × 64 MLP stack
(``tests/unit/test_param_offload.py``'s ``_Body`` / ``_Head``) and GPT-2
with 2 blocks of width 32, vocab 256, seq 16. Each JAX reference engine
is built once a configuration, through ``deepspeed_tpu.initialize`` (its
routing), and the port's engine, built through the port's
``initialize``, starts from the JAX engine's ``state_dict`` (masters and
moments) through the bridge (``bridge.layer_from_jax``: the port cannot
draw JAX's threefry init). Both take 3 steps on the same batches.

Tolerances: fp32 losses at rtol 1e-5 and masters at atol 2e-5 (lr 1e-3:
Adam's normalised step turns a last-bit gradient difference into up to
~1e-5 of the master); bf16 losses at rtol 2e-3, and the masters' change
over the 3 steps within 10% relative L2 of JAX's, all tensors together
(0.064 measured), and within 15% for each leaf alone (0.087 measured at
most, the MLP's fc bias). The two packages round the bf16 activations
and gradients at other points, and Adam's normalised step moves every
master by about lr a step whatever its gradient's size, so an element
whose gradient is zero but for rounding (the key third of the qkv bias:
softmax does not see it) moves at random in both. The per-leaf check
leaves out the elements whose fp32 first moment, from the fp32 JAX run
on the same init and batches, is under 1e-7 of its leaf's RMS (the key
bias at ~2e-9 of it; the smallest other element sits at 4e-6). NVMe
against RAM, and a tag resumed by the engine that wrote it, are
bit-equal; a tag crossing packages resumes within the fp32 tolerances.
"""

import dataclasses
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.runtime.config import \
    DeepSpeedConfigError as JaxConfigError
from deepspeed_tpu.runtime.zero import aot_check as jax_aot
from deepspeed_tpu.runtime.zero.param_offload import \
    Zero3OffloadEngine as JaxEngine
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError
from deepspeed_tpu_torch.runtime.zero import aot_check
from deepspeed_tpu_torch.runtime.zero.param_offload import (
    HostParamStore, Zero3OffloadEngine)
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.unit import test_param_offload as jax_suite

LR = 1e-3
STEPS = 3
HID, NLAYERS = jax_suite.HID, jax_suite.NLAYERS
GPT = dict(vocab_size=256, n_positions=16, n_embd=32, n_layer=2, n_head=2)
FP32_TOL = dict(loss_rtol=1e-5, master_atol=2e-5)
BF16_LOSS_RTOL, BF16_UPDATE_RTOL, BF16_LEAF_RTOL = 2e-3, 0.1, 0.15
DEAD_GRAD = 1e-7        # of the leaf's RMS first moment: zero but rounding


class Body(nn.Module):
    """The JAX suite's ``_Body``: relu(Dense(64)(x)); ``layers.0`` is
    flax's ``Dense_0`` (``bridge.SIMPLE_LAYOUT``)."""

    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(HID, HID, device="meta")])

    def forward(self, x):
        return torch.relu(self.layers[0](x))


class Head(nn.Module):
    """The JAX suite's ``_Head``: mean((Dense(64)(x) - batch[1])²)."""

    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(HID, HID, device="meta")])

    def forward(self, x, batch):
        return torch.mean((self.layers[0](x) - batch[1]) ** 2)


def port_mlp_layers():
    body = Body()                 # one module, one skeleton
    return [body] * NLAYERS + [Head()]


def gpt_batch(seed):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, GPT["vocab_size"], (4, 16),
                                      dtype=np.int32)}


def _ids(b):
    return b["input_ids"]


MODELS = {
    "mlp": dict(jax=jax_suite._layers, port=port_mlp_layers,
                batch=lambda s: jax_suite._batch(s), input_fn=None),
    "gpt2": dict(jax=lambda: jax_gpt2.gpt2_offload_layers(
                     jax_gpt2.GPT2Config(**GPT)),
                 port=lambda: gpt2.gpt2_offload_layers(
                     dataclasses.replace(gpt2.PRESETS["tiny"], **GPT)),
                 batch=gpt_batch, input_fn=_ids),
}
# (model, bf16, how the config asks for parameter offload)
RUNS = {"mlp_fp32": ("mlp", False, {"offload_param": {"device": "cpu"}}),
        "gpt2_fp32": ("gpt2", False, {"offload_param": {"device": "cpu"}}),
        "gpt2_bf16": ("gpt2", True, {"cpu_offload_params": True})}


def _config(bf16, zero, **over):
    cfg = {"train_batch_size": 4,
           "optimizer": {"type": "Adam", "params": {"lr": LR}},
           "zero_optimization": dict(zero, stage=3),
           "bf16": {"enabled": bf16}}
    cfg.update(over)
    return cfg


def _port_engine(model, bf16, zero):
    m = MODELS[model]
    kw = {} if m["input_fn"] is None else {"input_fn": m["input_fn"]}
    out = deepspeed_tpu_torch.initialize(
        model=m["port"](), config=_config(bf16, zero),
        sample_batch=m["batch"](0), device="cpu", **kw)
    assert out[1:] == (None, None, None)
    return out[0]


def _params(sd):
    return [[np.asarray(a, np.float32) for a in layer]
            for layer in sd["params"]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per run: the JAX reference (built by ``deepspeed_tpu.initialize``;
    its step-0 state, losses and masters after 3 steps, a tag after step
    2) and the port (started from that state; the same), then each
    package resuming the other's step-2 tag for step 3."""
    out = {}
    for name, (model, bf16, zero) in RUNS.items():
        m = MODELS[model]
        root = tmp_path_factory.mktemp(name)
        kw = {} if m["input_fn"] is None else {"input_fn": m["input_fn"]}
        jeng = deepspeed_tpu.initialize(
            model=m["jax"](), config=_config(bf16, zero),
            sample_batch=m["batch"](0), **kw)[0]
        assert isinstance(jeng, JaxEngine)
        sd0 = jeng.state_dict()
        batches = [m["batch"](s + 1) for s in range(STEPS)]
        jax_losses = []
        for s, b in enumerate(batches):
            if s == STEPS - 1:
                jeng.save_checkpoint(str(root / "jax"), client_state={
                    "by": "jax"})
            jax_losses.append(float(jeng.train_batch(b)))
        jax_sd = jeng.state_dict()

        peng = _port_engine(model, bf16, zero)
        peng.load_state_dict(sd0)
        port_losses = []
        for s, b in enumerate(batches):
            if s == STEPS - 1:
                peng.save_checkpoint(str(root / "port"),
                                     client_state={"by": "port"})
            port_losses.append(float(peng.train_batch(b)))
        run = {"engine": peng, "jax_engine": jeng, "sd0": sd0,
               "jax": (jax_losses, jax_sd), "root": root,
               "port": (port_losses, peng.state_dict()), "bf16": bf16}
        if not bf16:
            # the port resumes JAX's tag, JAX the port's
            fresh = _port_engine(model, bf16, zero)
            path, client = fresh.load_checkpoint(str(root / "jax"))
            steps = fresh.global_steps
            run["port_from_jax"] = (float(fresh.train_batch(batches[-1])),
                                    fresh.state_dict(), client, steps)
            jeng.load_checkpoint(str(root / "port"))
            run["jax_from_port"] = (float(jeng.train_batch(batches[-1])),
                                    jeng.state_dict())
        out[name] = run
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_matches_jax_engine(runs, name):
    """Losses and masters after 3 steps against JAX's engine from the
    same bridged state; the moments too in fp32."""
    run = runs[name]
    (jl, jsd), (pl, psd) = run["jax"], run["port"]
    assert isinstance(run["engine"], Zero3OffloadEngine)
    assert run["engine"].compute_dtype == (torch.bfloat16 if run["bf16"]
                                           else torch.float32)
    assert run["jax_engine"].compute_dtype == (
        jnp.bfloat16 if run["bf16"] else jnp.float32)
    assert jsd["step"] == psd["step"] == STEPS
    if not run["bf16"]:
        np.testing.assert_allclose(pl, jl, rtol=FP32_TOL["loss_rtol"])
        for key in ("params", "exp_avg", "exp_avg_sq"):
            for la, lb in zip(jsd[key], psd[key]):
                assert [np.shape(a) for a in la] == [b.shape for b in lb]
                for a, b in zip(la, lb):
                    np.testing.assert_allclose(
                        b, np.asarray(a, np.float32), rtol=0,
                        atol=FP32_TOL["master_atol"], err_msg=key)
        return
    np.testing.assert_allclose(pl, jl, rtol=BF16_LOSS_RTOL)
    p0 = _params(run["sd0"])
    # the fp32 JAX run starts from the same init and takes the same batches
    assert all(np.array_equal(a, b) for la, lb in zip(
        p0, _params(runs["gpt2_fp32"]["sd0"])) for a, b in zip(la, lb))
    m32 = runs["gpt2_fp32"]["jax"][1]["exp_avg"]
    want, got = [], []
    for li, (l0, la, lb, lm) in enumerate(zip(p0, _params(jsd),
                                              psd["params"], m32)):
        for j, (a0, a, b, m) in enumerate(zip(l0, la, lb, lm)):
            want.append((a - a0).ravel())
            got.append((b - a0).ravel())
            m = np.abs(np.asarray(m, np.float32))
            live = m >= DEAD_GRAD * np.sqrt(np.mean(m ** 2))
            w, g = (a - a0)[live], (b - a0)[live]
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= BF16_LEAF_RTOL, (li, j, err)
    want, got = np.concatenate(want), np.concatenate(got)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= BF16_UPDATE_RTOL, err


@pytest.mark.parametrize("name", ["mlp_fp32", "gpt2_fp32"])
def test_tags_load_both_ways(runs, name):
    """A step-2 tag of either package resumes in the other: its step 3
    equals the writer's (fp32 tolerances); the client state comes back,
    ``latest`` names the tag."""
    run = runs[name]
    (jl, jsd), (pl, psd) = run["jax"], run["port"]
    loss, sd, client, steps = run["port_from_jax"]
    assert client == {"by": "jax"} and steps == STEPS - 1
    assert (run["root"] / "jax" / "latest").read_text() == \
        f"global_step{STEPS - 1}"
    np.testing.assert_allclose(loss, jl[-1], rtol=FP32_TOL["loss_rtol"])
    loss_j, sd_j = run["jax_from_port"]
    np.testing.assert_allclose(loss_j, pl[-1], rtol=FP32_TOL["loss_rtol"])
    for got, want in ((sd, jsd), (sd_j, psd)):
        for la, lb in zip(_params(got), _params(want)):
            for a, b in zip(la, lb):
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=FP32_TOL["master_atol"])


def test_port_tag_resumes_bit_equal_and_no_latest_starts_fresh(
        runs, tmp_path):
    """The port's own tag resumes it bit for bit; a folder without
    ``latest`` loads nothing and returns ``(None, {})`` (JAX
    param_offload.py:373-384)."""
    run = runs["gpt2_fp32"]
    fresh = _port_engine("gpt2", False, RUNS["gpt2_fp32"][2])
    assert fresh.load_checkpoint(str(tmp_path)) == (None, {})
    path, client = fresh.load_checkpoint(str(run["root"] / "port"))
    assert client == {"by": "port"} and path.endswith(
        "mp_rank_00_model_states.pt")
    loss = float(fresh.train_batch(gpt_batch(STEPS)))
    assert loss == run["port"][0][-1]
    for la, lb in zip(fresh.state_dict()["params"],
                      run["port"][1]["params"]):
        for a, b in zip(la, lb):
            assert np.array_equal(a, b)
    with open(path, "rb") as f:
        sd = pickle.load(f)
    # JAX's file: lists of numpy arrays, JAX's leaf order per layer
    assert set(sd) == {"params", "exp_avg", "exp_avg_sq", "step",
                       "client_state"}
    assert all(isinstance(a, np.ndarray) for layer in sd["params"]
               for a in layer)


def test_nvme_mode_equals_ram_mode(tmp_path, monkeypatch):
    """Masters in files of the swap folder (read back a layer at a time
    for the fetch and the update) give the RAM run's losses and masters
    bit for bit; ``close`` removes the store's own folder, and in a
    caller-supplied folder shared by two stores only its own files. The
    files go through the async IO engine's thread pool
    (``DS_AIO_DISABLE_KERNEL``, as ``tests/test_torch_dist_zero_offload
    .py``'s ``THREAD_POOL`` cases): kernel AIO over ``O_DIRECT`` pays a
    disk round trip a request, tens of ms on a slow temporary disk, and
    runs in ``chip_smoke.py`` phase 21."""
    monkeypatch.setenv("DS_AIO_DISABLE_KERNEL", "1")
    zero = {"offload_param": {"device": "nvme", "nvme_path": str(tmp_path)}}
    nvme = _port_engine("mlp", False, zero)
    ram = _port_engine("mlp", False, RUNS["mlp_fp32"][2])
    assert nvme.store.swapper is not None and ram.store.swapper is None
    for s in range(STEPS):
        b = jax_suite._batch(s + 20)
        assert float(nvme.train_batch(b)) == float(ram.train_batch(b))
    for la, lb in zip(nvme.state_dict()["params"],
                      ram.state_dict()["params"]):
        for a, b in zip(la, lb):
            assert np.array_equal(a, b)
    folder = nvme.store._swap_folder
    assert os.listdir(folder)
    nvme.close()
    assert not os.path.exists(folder)
    # two stores in one caller-supplied folder: each removes its own files
    shared = tmp_path / "shared"
    a, b = (HostParamStore(nvme_path=str(tmp_path), swap_folder=str(shared),
                           device="cpu") for _ in range(2))
    a.add_layer({"w": torch.ones(4)})
    b.add_layer({"w": torch.zeros(4)})
    a.close()
    assert len(os.listdir(shared)) == 1
    assert torch.equal(b.host_leaves(0)[0], torch.zeros(4))
    b.close()
    assert shared.exists() and os.listdir(shared) == []


def test_device_holds_at_most_two_layers(runs):
    """``peak_live_bytes`` is at most the two largest layers (the fetched
    one and the prefetched next), against the whole model; nothing is
    live after a step. JAX's own bound on the MLP stack holds too."""
    for name in ("mlp_fp32", "gpt2_fp32", "gpt2_bf16"):
        store = runs[name]["engine"].store
        item = 2 if runs[name]["bf16"] else 4
        layers = sorted((sum(int(np.prod(s)) for s in meta) * item
                         for meta in store._meta), reverse=True)
        assert store.live_bytes == 0
        assert store.peak_live_bytes <= layers[0] + layers[1], name
        assert store.total_param_bytes == sum(layers) * 4 // item
    mlp = runs["mlp_fp32"]["engine"].store
    assert mlp.peak_live_bytes * 3 < mlp.total_param_bytes
    jst = runs["mlp_fp32"]["jax_engine"].store
    assert mlp.peak_live_bytes == jst.peak_live_bytes


def test_masters_are_born_on_the_host_c_contiguous():
    """The store's masters are fp32, C-contiguous and writable whatever
    the layer hands it (the JAX suite's
    ``test_masters_are_c_contiguous_writable``); the layers are drawn on
    the CPU from (seed, layer) and one skeleton serves a repeated
    module."""
    st = HostParamStore(device="cpu")
    st.add_layer({"w": torch.arange(12.).reshape(3, 4).t(),
                  "b": torch.arange(4, dtype=torch.float64)})
    for h in st.host_leaves(0):
        assert h.dtype == torch.float32 and h.is_contiguous()
        assert torch.zeros_like(h).is_contiguous()
    a = Zero3OffloadEngine(port_mlp_layers(), device="cpu", seed=5)
    b = Zero3OffloadEngine(port_mlp_layers(), device="cpu", seed=5)
    c = Zero3OffloadEngine(port_mlp_layers(), device="cpu", seed=6)
    pa, pb, pc = (e.state_dict()["params"] for e in (a, b, c))
    assert all(np.array_equal(x, y) for la, lb in zip(pa, pb)
               for x, y in zip(la, lb))
    assert not np.array_equal(pa[0][1], pc[0][1])
    assert not np.array_equal(pa[0][1], pa[1][1])     # layers differ
    assert len({id(m) for m in a._mods}) == 2
    assert all(p.device.type == "meta" for m in a._mods
               for p in m.parameters())


REFUSALS = {
    "not_layered": (dict(model="single"), AssertionError, "layered"),
    "no_sample_batch": (dict(sample_batch=None), AssertionError,
                        "sample_batch"),
    "client_optimizer": (dict(optimizer=object()), AssertionError,
                         "client"),
    "lr_scheduler": (dict(lr_scheduler=object()), AssertionError, "client"),
    "training_data": (dict(training_data=[1]), AssertionError, "client"),
    "lamb": (dict(config={"optimizer": {"type": "Lamb"}}), AssertionError,
             "unsupported"),
    "nvme_without_path": (dict(config={"zero_optimization": {
        "stage": 3, "offload_param": {"device": "nvme"}}}),
        AssertionError, "nvme_path"),
    "scheduler": (dict(config={"scheduler": {"type": "WarmupLR",
                                             "params": {}}}),
                  "config", "scheduler"),
    "gradient_clipping": (dict(config={"gradient_clipping": 1.0}),
                          "config", "gradient_clipping"),
    "fp16": (dict(config={"fp16": {"enabled": True}}), "config", "fp16"),
    "sparse_gradients": (dict(config={"sparse_gradients": True}), "config",
                         "sparse_gradients"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_initialize_refusals_match_jax(case):
    """Every refusal of JAX's parameter-offload branch
    (``deepspeed_tpu/__init__.py:84-155``) is the port's, with the
    exception class JAX's tests expect."""
    over, exc, match = REFUSALS[case]
    results = []
    for pkg, layers, single in (
            (deepspeed_tpu, jax_suite._layers, jax_suite._Body),
            (deepspeed_tpu_torch, port_mlp_layers, Body)):
        kw = dict(model=layers(), config=_config(False, {
            "offload_param": {"device": "cpu"}}),
            sample_batch=jax_suite._batch())
        for k, v in over.items():
            if k == "config":
                kw["config"] = dict(kw["config"], **v)
            elif k == "model":
                kw["model"] = single()
            elif v is None:
                del kw[k]
            else:
                kw[k] = v
        want = exc if exc != "config" else (
            JaxConfigError if pkg is deepspeed_tpu else DeepSpeedConfigError)
        with pytest.raises(want, match=match):
            pkg.initialize(**kw)
        results.append(want.__name__)
    assert results[0] == results[1]


def test_stage_below_3_keeps_cpu_offload_params_a_no_op():
    """``cpu_offload_params`` asks for parameter offload at stage 3 only
    (JAX's historical no-op below it): at stage 1 ``initialize`` builds
    the monolithic engine, which refuses ``offload_param`` proper."""
    model = gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    cfg = {"train_batch_size": 4,
           "optimizer": {"type": "Adam", "params": {"lr": LR}}}
    engine = deepspeed_tpu_torch.initialize(model=model, device="cpu",
                                            config=dict(cfg, zero_optimization={
                                                "stage": 1,
                                                "cpu_offload_params": True}))[0]
    assert isinstance(engine, deepspeed_tpu_torch.DeepSpeedEngine)
    with pytest.raises(ValueError, match="layered"):
        deepspeed_tpu_torch.DeepSpeedEngine(
            model, deepspeed_tpu_torch.DeepSpeedConfig(dict(
                cfg, zero_optimization={"stage": 3, "offload_param": {
                    "device": "cpu"}})), torch.device("cpu"))


# ------------------------------------------------ the per-rank footprint
def test_footprint_matches_jax_at_the_tiny_shape():
    """At the tiny GPT-2 on a 4-device mesh at stage 3 (threshold 1000:
    LayerNorms and biases whole, matrices cut): the masters' bytes equal
    JAX's ``state_footprint_per_chip``; the moments and gradients differ
    by the layout rules the module names (JAX cuts every tensor's moments
    and accumulator and keeps a 4-byte step on the device), exactly."""
    from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JaxGPT2
    from deepspeed_tpu.utils import groups
    import jax
    cfg = dataclasses.replace(gpt2.PRESETS["tiny"], **GPT)
    world, threshold = 4, 1000
    groups.destroy()
    groups.initialize(devices=jax.devices()[:world])
    try:
        jeng = deepspeed_tpu.initialize(
            model=JaxGPT2(jax_gpt2.GPT2Config(**GPT)),
            config={"train_batch_size": 4,
                    "optimizer": {"type": "Adam", "params": {"lr": LR}},
                    "zero_optimization": {
                        "stage": 3,
                        "stage3_param_persistence_threshold": threshold}},
            sample_batch=gpt_batch(0), abstract_init=True)[0]
        want = jax_aot.state_footprint_per_chip(jeng)
    finally:
        groups.destroy()
    model = gpt2.GPT2LMHeadModel(cfg, device="meta")
    got = aot_check.state_footprint_per_rank(
        model, world, stage=3, param_persistence_threshold=threshold)
    shapes = [tuple(p.shape) for p in model.parameters()]
    n = sum(int(np.prod(s)) for s in shapes)
    whole = sum(int(np.prod(s)) for s in shapes
                if int(np.prod(s)) < threshold)
    assert got["params"] == want["params"] == 4 * ((n - whole) // world
                                                   + whole)
    # the port keeps a persistent tensor's moments and gradient whole
    extra = 4 * (whole - whole // world)
    assert got["opt_state"] == want["opt_state"] - 4 + 2 * extra
    assert got["acc_grads"] == want["acc_grads"] + extra
    assert got["total"] == sum(got[k] for k in ("params", "opt_state",
                                                "acc_grads"))


def test_footprint_at_gpt2_xl_world_16_against_northstar():
    """GPT-2 1.5B at world 16, stage 3, threshold 1e5, against the JAX
    artifact ``NORTHSTAR_AOT.json`` (read only): the masters equal; the
    moments and gradients carry the persistent tensors whole (1,001,600
    elements: 48 blocks' LayerNorms and biases and ln_f), the step no
    device bytes."""
    import json
    with open(os.path.join(os.path.dirname(__file__), os.pardir,
                           "NORTHSTAR_AOT.json")) as f:
        want = json.load(f)["per_chip_state_bytes"]
    model = gpt2.GPT2LMHeadModel(gpt2.PRESETS["gpt2-xl"], device="meta")
    got = aot_check.state_footprint_per_rank(model, 16)
    persistent = 48 * (4 * 1600 + 3 * 1600 + 1600 + 4 * 1600 + 1600) + 3200
    extra = 4 * (persistent - persistent // 16)
    assert extra == 3756000
    assert got["params"] == want["params"] == 393177600
    assert got["opt_state"] == want["opt_state"] - 4 + 2 * extra
    assert got["acc_grads"] == want["acc_grads"] + extra
    assert got["total"] == 1572710400
