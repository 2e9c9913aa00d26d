"""The ZeRO surface of the PyTorch port against the JAX package, on the
CPU: the ``zero_optimization`` config block (``DeepSpeedZeroConfig``,
deprecated spellings included), ``estimate_zero_mem``, ``zero.Init``,
``zero.GatheredParameters`` and ``TiledLinear`` /
``TiledLinearReturnBias`` (1e-6 against the flax modules on the same
weights), and the host ops of the optimizer offload: ``DeepSpeedCPUAdam``
and ``DeepSpeedCPUAdagrad`` bit-equal to the JAX package's on the same
buffers (the same source built with the same flags), and the NVMe
swapper's round trips. The stages and the offload in the engine are in
``tests/test_torch_dist_zero.py`` and ``test_torch_dist_zero_offload.py``.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu import zero as jax_zero
from deepspeed_tpu.runtime.zero.config import \
    DeepSpeedZeroConfig as JaxZeroConfig
from deepspeed_tpu.runtime.zero.partition import \
    estimate_zero_mem as jax_estimate
from deepspeed_tpu_torch import bridge, zero
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.runtime.zero.tiling import (TiledLinear,
                                                     TiledLinearReturnBias)

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ toolchain available")

ZERO_BLOCKS = [
    {},
    {"stage": 1},
    {"stage": 2, "reduce_bucket_size": 5e7, "allgather_bucket_size": 2e8,
     "contiguous_gradients": False, "overlap_comm": True},
    {"stage": 3},
    {"stage": 3, "stage3_param_persistence_threshold": 1000,
     "stage3_max_live_parameters": 3e8, "stage3_max_reuse_distance": 5e8,
     "stage3_prefetch_bucket_size": 1e6, "sub_group_size": 1e8,
     "stage3_gather_16bit_weights_on_model_save": True},
    {"stage": 3, "stage3_gather_fp16_weights_on_model_save": True},
    {"stage": 2, "cpu_offload": True},
    {"stage": 1, "cpu_offload_params": True},
    {"stage": 3, "offload_optimizer": {"device": "nvme",
                                       "nvme_path": "/local_nvme",
                                       "buffer_count": 8,
                                       "pin_memory": True,
                                       "pipeline_read": True}},
    {"stage": 2, "offload_optimizer": {"device": "cpu"},
     "cpu_offload": True},
    {"stage": 3, "offload_param": {"device": "cpu", "buffer_size": 1e7,
                                   "max_in_cpu": 1e8}},
    {"stage": 0, "elastic_checkpoint": False, "legacy_stage1": True,
     "round_robin_gradients": True, "ignore_unused_parameters": False},
]


@pytest.mark.parametrize("block", ZERO_BLOCKS, ids=str)
def test_zero_config_matches_jax(block):
    """Every field, the deprecated spellings' mappings and the stage-3
    defaults (``overlap_comm``) as JAX parses them."""
    cfg = {"zero_optimization": block}
    got = dataclasses.asdict(DeepSpeedZeroConfig.from_dict(cfg))
    assert got == dataclasses.asdict(JaxZeroConfig.from_dict(cfg))


def test_engine_config_exposes_the_zero_block():
    """``DeepSpeedConfig.zero_config`` is the block; the legacy
    ``"zero_optimization": true`` is stage 1 (JAX's copy reads the bool as
    a dict and raises TypeError)."""
    cfg = DeepSpeedConfig({"train_batch_size": 8, "zero_optimization": {
        "stage": 3, "stage3_param_persistence_threshold": 7,
        "cpu_offload": True}})
    assert cfg.zero_config.param_persistence_threshold == 7
    assert cfg.zero_config.offload_optimizer.device == "cpu"
    assert cfg.zero_optimization_stage == 3
    legacy = DeepSpeedConfig({"train_batch_size": 8,
                              "zero_optimization": True})
    assert legacy.zero_optimization_stage == 1
    with pytest.raises(TypeError):
        JaxZeroConfig.from_dict({"zero_optimization": True})


@pytest.mark.parametrize("n,world,stage", [
    (1_500_000_000, 1, 0), (1_500_000_000, 16, 1), (355_000_000, 8, 2),
    (1_557_611_200, 16, 3), (124_000_000, 3, 3)])
def test_estimate_zero_mem_matches_jax(n, world, stage):
    assert zero.estimate_zero_mem(n, world, stage) == \
        jax_estimate(n, world, stage)


def test_init_is_a_no_op_context_as_in_jax():
    for remote in (None, "cpu", "nvme"):
        with zero.Init(remote_device=remote) as ctx:
            pass
        with jax_zero.Init(remote_device=remote) as jctx:
            pass
        assert ctx.remote_device == jctx.remote_device == remote
        assert ctx.enabled and jctx.enabled
    zero.register_external_parameter(None, None)
    zero.unregister_external_parameter(None, None)
    assert [e.name for e in zero.ZeroParamStatus] == \
        [e.name for e in jax_zero.ZeroParamStatus]
    assert [e.name for e in zero.ZeroParamType] == \
        [e.name for e in jax_zero.ZeroParamType]


def test_gathered_parameters_yield_detached_copies_as_jax():
    """Without a process group the copies equal the tensors (1e-6, as
    JAX's ``device_get``); mutating them writes nothing back."""
    rng = np.random.default_rng(0)
    arrays = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in arrays.items()}
    with zero.GatheredParameters(params, modifier_rank=0) as got, \
            jax_zero.GatheredParameters(
                {k: jax.numpy.asarray(v) for k, v in arrays.items()}) as want:
        for k in arrays:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-6)
            assert not got[k].requires_grad
            got[k].add_(1.0)
    for k, v in arrays.items():
        assert np.array_equal(params[k].detach().numpy(), v)
    with zero.GatheredParameters([params["a"]]) as (a,):
        assert torch.equal(a, params["a"].detach())
    with zero.GatheredParameters(params, enabled=False) as same:
        assert same is params


@pytest.mark.parametrize("cls_name,in_f,out_f,splits", [
    ("TiledLinear", 10, 7, (3, 2)), ("TiledLinear", 16, 12, (1, 1)),
    ("TiledLinear", 9, 13, (4, 5)), ("TiledLinearReturnBias", 10, 7, (3, 2)),
])
def test_tiled_linear_matches_jax(cls_name, in_f, out_f, splits):
    """The flax module's params bridged into the port's module (each
    tile_{ic}_{oc}'s kernel transposed): the outputs at 1e-6; the tiles
    sum to the untiled Linear."""
    from deepspeed_tpu.runtime.zero import tiling as jax_tiling
    jcls = getattr(jax_tiling, cls_name)
    jmod = jcls(in_features=in_f, out_features=out_f, in_splits=splits[0],
                out_splits=splits[1])
    x = np.random.default_rng(1).standard_normal((3, 5, in_f)).astype(
        np.float32)
    params = jax.tree.map(np.asarray,
                          jmod.init(jax.random.PRNGKey(0), x)["params"])
    if cls_name == "TiledLinearReturnBias":
        params["bias"] = np.linspace(-1, 1, out_f).astype(np.float32)
    mod = {"TiledLinear": TiledLinear,
           "TiledLinearReturnBias": TiledLinearReturnBias}[cls_name](
               in_f, out_f, *splits)
    sd = bridge.tiled_flax_to_state_dict(params)
    assert set(sd) == set(mod.state_dict())
    mod.load_state_dict(sd)
    want = jmod.apply({"params": params}, x)
    got = mod(torch.from_numpy(x))
    if cls_name == "TiledLinearReturnBias":
        np.testing.assert_allclose(got[1].detach().numpy(),
                                   np.asarray(want[1]), rtol=1e-6)
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    if cls_name == "TiledLinear":
        # the untiled Linear: tile (ic, oc) is W[oc rows, ic columns]
        w = torch.cat([torch.cat([getattr(mod, f"tile_{ic}_{oc}").weight
                                  for ic in range(splits[0])], dim=1)
                       for oc in range(splits[1])], dim=0)
        b = torch.cat([getattr(mod, f"tile_{splits[0] - 1}_{oc}").bias
                       for oc in range(splits[1])])
        np.testing.assert_allclose(
            got.detach().numpy(),
            torch.nn.functional.linear(torch.from_numpy(x), w, b).detach()
            .numpy(), rtol=1e-5, atol=1e-5)


def test_tiled_linear_init_is_flax_dense_like():
    """lecun-normal kernels (variance 1 / fan_in of the tile), zero
    biases on the last input tile only."""
    mod = TiledLinear(256, 512, in_splits=2, out_splits=1, seed=3)
    w = mod.tile_0_0.weight.detach()
    assert abs(float(w.var()) * 128 - 1.0) < 0.1
    assert mod.tile_0_0.bias is None and \
        torch.count_nonzero(mod.tile_1_0.bias) == 0


@needs_gxx
@pytest.mark.parametrize("adamw,wd", [(True, 0.0), (True, 0.01),
                                      (False, 0.01)])
def test_cpu_adam_is_bit_equal_to_jax(adamw, wd):
    """Three steps on the same buffers (sizes off the 8-lane AVX width
    too): params and moments bit-equal to the JAX package's CPU-Adam."""
    from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JaxAdam
    from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
    rng = np.random.default_rng(2)
    shapes = [(37,), (16, 8), (3, 5, 7)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-8, weight_decay=wd,
              adamw_mode=adamw)
    mine = DeepSpeedCPUAdam([torch.from_numpy(p.copy()) for p in params],
                            **kw)
    ref = JaxAdam([p.copy() for p in params], **kw)
    for step in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        mine.step([torch.from_numpy(g) for g in grads], lr=1e-2 / (step + 1))
        ref.step(grads, lr=1e-2 / (step + 1))
    for a, b in zip(mine.params + mine.exp_avg + mine.exp_avg_sq,
                    ref.params + ref.exp_avg + ref.exp_avg_sq):
        assert np.array_equal(a.numpy(), b)
    assert mine.step_count == ref.step_count == 3


@needs_gxx
def test_cpu_adagrad_is_bit_equal_to_jax():
    from deepspeed_tpu.ops.adagrad import \
        DeepSpeedCPUAdagrad as JaxAdagrad
    from deepspeed_tpu_torch.ops.adagrad import DeepSpeedCPUAdagrad
    rng = np.random.default_rng(3)
    params = [rng.standard_normal(s).astype(np.float32)
              for s in ((21,), (4, 6))]
    mine = DeepSpeedCPUAdagrad([torch.from_numpy(p.copy()) for p in params],
                               lr=0.05, weight_decay=0.01)
    ref = JaxAdagrad([p.copy() for p in params], lr=0.05, weight_decay=0.01)
    for _ in range(3):
        grads = [rng.standard_normal(p.shape).astype(np.float32)
                 for p in params]
        mine.step([torch.from_numpy(g) for g in grads])
        ref.step(grads)
    for a, b in zip(mine.params + mine.exp_avg_sq,
                    ref.params + ref.exp_avg_sq):
        assert np.array_equal(a.numpy(), b)


@needs_gxx
def test_cpu_adam_refuses_tensors_it_cannot_read():
    from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
    opt = DeepSpeedCPUAdam([torch.zeros(4)])
    with pytest.raises(ValueError, match="elements"):
        opt.step([torch.zeros(5)])


@needs_gxx
def test_swapper_round_trips(tmp_path):
    """swap_out then swap_in, swap_in_async + wait, several keys in
    flight, overwrite in place; the engine the probe names (kernel AIO
    or the thread pool, both the reference's own) reports itself."""
    from deepspeed_tpu_torch.ops.aio.aio_handle import AsyncIOHandle
    from deepspeed_tpu_torch.runtime.swap_tensor.swapper import \
        AsyncTensorSwapper
    folder = tmp_path / "swap"
    sw = AsyncTensorSwapper(str(folder), AsyncIOHandle(thread_count=2))
    rng = np.random.default_rng(4)
    data = {f"t{i}": torch.from_numpy(rng.standard_normal(n).astype(
        np.float32)) for i, n in enumerate((1, 1000, 3 * 4096 + 5))}
    data["i64"] = torch.arange(77, dtype=torch.int64)
    for k, t in data.items():
        sw.swap_out(k, t)
    sw.synchronize()
    for k, t in data.items():
        assert torch.equal(sw.swap_in(k), t)
    pending = {k: sw.swap_in_async(k) for k in data}
    for k, (buf, req) in pending.items():
        assert sw.wait(req, buf.numel() * buf.element_size()) == \
            buf.numel() * buf.element_size()
        assert torch.equal(buf, data[k])
    sw.swap_out("t1", data["t1"] * 2, block=True)
    assert torch.equal(sw.swap_in("t1"), data["t1"] * 2)
    assert isinstance(sw.aio.kernel_aio_available(str(folder)), bool)
    assert sw.aio.max_inflight() >= 0
    buf = torch.empty(10)
    with pytest.raises(OSError):
        sw.wait(sw.aio.async_pread(buf, str(folder / "missing.swp")), 40)
