"""The port's data path through the engine, on the CPU, against the JAX
engine (``initialize(training_data=)``, ``deepspeed_io``, the prefetch
pipeline, curriculum learning, progressive layer drop, and the loader's
position in checkpoints).

The tiny GPT-2 of ``tests/model/oracle`` (bs 8, seq 32; the flax init
bridged by ``flax_to_state_dict``) is fed a dataset of the oracle's rows
through ``initialize(training_data=)`` -> ``RepeatingLoader`` in both
engines. Each configuration's JAX run is module-scoped and shared.
Tolerance: losses and final params at rtol = atol = 1e-5, the bound
``tests/test_torch_engine.py`` holds the fp32 engines to.
"""

import logging
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.models import simple as jax_simple
from deepspeed_tpu.runtime import dataloader as jax_dl
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.bridge import flax_to_state_dict
from deepspeed_tpu_torch.models import gpt2, simple
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.prefetch import (PrefetchIterator,
                                                  PrefetchLoader)
from deepspeed_tpu_torch.utils.logging import logger as port_logger
from tests.model import oracle
from tests.torch_threads import one_torch_thread  # noqa: F401

STEPS = 4
TOL = dict(rtol=1e-5, atol=1e-5)


class _Rows:
    """The oracle's token rows as a dataset of dict samples."""

    def __init__(self, n_batches):
        self.ids = np.concatenate([
            np.asarray(b["input_ids"])
            for b in oracle.make_batches(n_batches)])

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i]}


def _config(**over):
    cfg = {"train_batch_size": oracle.BATCH_SIZE,
           "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": oracle.LR}},
           "data_prefetch": {"enabled": True, "depth": 2}}
    cfg.update(over)
    return cfg


# 3 batches an epoch: step 4 wraps and reshuffles
PREFETCH = _config()
CURRICULUM = _config(curriculum_learning={
    "enabled": True, "min_difficulty": 16, "max_difficulty": 32,
    "schedule_type": "fixed_discrete",
    "schedule_config": {"difficulty": [16, 32], "max_step": [2]}})


@pytest.fixture(scope="module")
def init():
    model = jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(**oracle.TINY))
    batch = oracle.make_batches(1)[0]
    params = jax.jit(model.init)(jax.random.PRNGKey(oracle.SEED), batch)
    return flax_to_state_dict(jax.tree.map(np.asarray, params["params"]))


def _jax_run(cfg, steps=STEPS):
    """The JAX engine fed by initialize(training_data=): losses, final
    params, the difficulty after each step and the loader's state."""
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    engine, _, loader, _ = deepspeed_tpu.initialize(
        model=jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(**oracle.TINY)),
        config=dict(cfg), sample_batch=oracle.make_batches(1)[0],
        training_data=_Rows(3), seed=oracle.SEED)
    it = jax_dl.RepeatingLoader(loader)
    losses, seqlens = [], []
    for _ in range(steps):
        losses.append(float(engine.train_batch(data_iter=it)))
        cs = engine.curriculum_scheduler
        seqlens.append(cs.get_current_difficulty() if cs else None)
    params = flax_to_state_dict(jax.tree.map(np.asarray,
                                             engine.state.params))
    engine.close()
    groups.destroy()
    return losses, params, seqlens, it.state_dict()


@pytest.fixture(scope="module")
def jax_prefetch():
    return _jax_run(PREFETCH)


@pytest.fixture(scope="module")
def jax_curriculum():
    return _jax_run(CURRICULUM)


def _port_engine(cfg, init, device="cpu"):
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu"),
        config=dict(cfg), model_parameters=init, device=device,
        training_data=_Rows(3))
    return engine, loader


def _port_run(cfg, init, steps=STEPS):
    engine, loader = _port_engine(cfg, init)
    it = RepeatingLoader(loader)
    losses, seqlens = [], []
    for _ in range(steps):
        loss = engine.train_batch(data_iter=it)
        losses.append(float(loss))
        cs = engine.curriculum_scheduler
        seqlens.append(cs.get_current_difficulty() if cs else None)
    return engine, loader, it, losses, seqlens


@pytest.fixture
def warnings_seen():
    """The port logger's warnings during the test (it does not
    propagate to the root logger, so caplog misses them)."""
    seen = []

    class _Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    handler = _Keep(logging.WARNING)
    port_logger.addHandler(handler)
    yield seen
    port_logger.removeHandler(handler)


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("ds-prefetch")]


def _same_params(engine, want, tol=TOL):
    got = engine.module.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k,
                                   **tol)


def test_training_data_with_prefetch_matches_jax(init, jax_prefetch):
    """initialize(training_data=) returns a PrefetchLoader (host workers
    and the device stage, here the CPU placement); 4 steps across a
    reshuffling wrap-around equal the JAX engine's; close() joins every
    pipeline thread."""
    want_losses, want_params, _, want_state = jax_prefetch
    engine, loader, it, losses, _ = _port_run(PREFETCH, init)
    assert isinstance(loader, PrefetchLoader)
    assert loader.place_fn is not None and len(loader) == 3
    assert engine.training_dataloader is loader
    np.testing.assert_allclose(losses, want_losses, **TOL)
    _same_params(engine, want_params)
    assert it.state_dict() == want_state == {"epoch": 1,
                                             "batch_in_epoch": 1}
    engine.close()
    assert not _prefetch_threads()
    engine.close()                                  # idempotent


def test_resume_through_checkpoint_matches_jax(init, jax_prefetch,
                                               tmp_path):
    """A tag saved with data_iter= after step 2 carries (epoch 0, batch
    2); a fresh engine and loader that load it with data_iter= run steps
    3-4 (the last batch of epoch 0, then epoch 1's first) bit-equal to
    the uninterrupted run, and equal to the JAX engine's steps 3-4."""
    want_losses, want_params, _, _ = jax_prefetch
    engine, loader = _port_engine(PREFETCH, init)
    it = RepeatingLoader(loader)
    first = [float(engine.train_batch(data_iter=it)) for _ in range(2)]
    engine.save_checkpoint(str(tmp_path), tag="t2", data_iter=it)
    rest = [float(engine.train_batch(data_iter=it)) for _ in range(2)]
    engine.close()
    fresh, fresh_loader = _port_engine(PREFETCH, gpt2.GPT2LMHeadModel(
        gpt2.PRESETS["tiny"], seed=7, device="cpu").state_dict())
    it2 = RepeatingLoader(fresh_loader)
    fresh.load_checkpoint(str(tmp_path), tag="t2", data_iter=it2)
    assert it2.state_dict() == {"epoch": 0, "batch_in_epoch": 2}
    resumed = [float(fresh.train_batch(data_iter=it2)) for _ in range(2)]
    assert resumed == rest
    np.testing.assert_allclose(first + resumed, want_losses, **TOL)
    _same_params(fresh, want_params)
    fresh.close()


def test_curriculum_plateaus_match_jax(init, jax_curriculum,
                                       warnings_seen):
    """fixed_discrete over two plateaus (seq 16 for steps 1-2, then 32):
    each step's length is JAX's schedule, the losses JAX's at 1e-5; the
    device stage is off under curriculum, warned once. The params at
    atol 1e-4: at seq 16 the two engines' gradients agree to 1e-6
    relative, but Adam's normalised update carries that rounding up to
    3e-5 into a few weights whose gradient is near zero (as in
    ``tests/test_torch_engine.py``'s bf16-accumulator case)."""
    want_losses, want_params, want_seqlens, _ = jax_curriculum
    engine, loader, it, losses, seqlens = _port_run(CURRICULUM, init)
    engine.deepspeed_io(_Rows(3))
    assert seqlens == want_seqlens == [16, 16, 32, 32]
    assert loader.place_fn is None
    assert sum("device stage disabled under curriculum" in m
               for m in warnings_seen) == 1
    np.testing.assert_allclose(losses, want_losses, **TOL)
    _same_params(engine, want_params, dict(rtol=0, atol=1e-4))
    engine.close()


class _JaxPLDNet(fnn.Module):
    """x -> Dense(8) scaled by θ under PLD -> mean squared error."""

    @fnn.compact
    def __call__(self, batch, progressive_layer_drop=False, pld_theta=1.0):
        x, y = batch
        h = fnn.Dense(8)(x)
        if progressive_layer_drop:
            h = h * pld_theta
        return jnp.mean((h - y) ** 2)


class _TorchPLDNet(torch.nn.Module):
    """The same module in torch; records each θ it is given."""

    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(4, 8)
        self.thetas = []

    def forward(self, batch, progressive_layer_drop=False, pld_theta=1.0):
        x, y = batch
        h = self.dense(x)
        if progressive_layer_drop:
            self.thetas.append(pld_theta)
            h = h * pld_theta
        return torch.mean((h - y) ** 2)


def _pld_dataset():
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((32, 4)).astype(np.float32)
    ys = rng.standard_normal((32, 8)).astype(np.float32)
    return [(xs[i], ys[i]) for i in range(32)]


def test_pld_schedule_and_kwargs_match_jax():
    """θ(t) = (1 - θ̄) e^(-γ t) + θ̄ before each step (t = the steps
    done before it, so 1 at the first), passed as progressive_layer_drop=True, pld_theta=θ to the
    module: the θs the torch module saw, the schedule and the losses
    equal the JAX engine's over 4 steps, on a tiny module written in
    both frameworks (the flax init copied across)."""
    cfg = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                      "gamma": 0.2}}
    data = _pld_dataset()
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    sample = (jnp.zeros((8, 4)), jnp.zeros((8, 8)))
    params = _JaxPLDNet().init(jax.random.PRNGKey(0), sample)["params"]
    jengine, _, jloader, _ = deepspeed_tpu.initialize(
        model=_JaxPLDNet(), config=dict(cfg), sample_batch=sample,
        model_parameters=params, training_data=data)
    jit = jax_dl.RepeatingLoader(jloader)
    want, want_thetas = [], []
    for _ in range(STEPS):
        want.append(float(jengine.train_batch(data_iter=jit)))
        want_thetas.append(jengine.progressive_layer_drop.get_theta())
    groups.destroy()

    module = _TorchPLDNet()
    dense = params["Dense_0"]
    sd = {"dense.weight": torch.from_numpy(np.asarray(dense["kernel"]).T
                                           .copy()),
          "dense.bias": torch.from_numpy(np.array(dense["bias"]))}
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=module, config=dict(cfg), model_parameters=sd, device="cpu",
        training_data=data)
    it = RepeatingLoader(loader)
    got = [float(engine.train_batch(data_iter=it)) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(module.thetas, want_thetas, rtol=1e-12)
    np.testing.assert_allclose(
        module.thetas, [0.5 * np.exp(-0.2 * t) + 0.5 for t in range(4)],
        rtol=1e-12)


def test_pld_module_without_the_kwargs_fails_as_in_jax():
    """A module whose forward takes no PLD kwargs raises TypeError in
    both engines."""
    cfg = {"train_batch_size": 4, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "progressive_layer_drop": {"enabled": True}}
    batch = (np.ones((4, 4), np.float32), np.ones((4, 4), np.float32))
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    jengine, *_ = deepspeed_tpu.initialize(
        model=jax_simple.SimpleModel(hidden_dim=4), config=dict(cfg),
        sample_batch=jax_simple.sample_batch(4, 4))
    with pytest.raises(TypeError):
        jengine.train_batch(batch=batch)
    groups.destroy()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=simple.SimpleModel(4, device="cpu"), config=dict(cfg),
        device="cpu")
    with pytest.raises(TypeError, match="progressive_layer_drop"):
        engine.train_batch(batch=batch)


def test_training_data_on_the_default_device_needs_a_card():
    """device=None means CUDA: without a card initialize raises rather
    than run the data path on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.initialize(
            model=simple.SimpleModel(4, device="cpu"),
            config={"train_batch_size": 4,
                    "data_prefetch": {"enabled": True}},
            training_data=simple.random_dataset(8, 4))


# ----------------------------------------------------- engine plumbing


def _simple_engine(**over):
    cfg = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    cfg.update(over)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=simple.SimpleModel(16, device="cpu"), config=cfg,
        device="cpu")
    return engine


def _forever():
    while True:
        yield from DeepSpeedDataLoader(simple.random_dataset(64, 16),
                                       batch_size=8)


def test_train_batch_wraps_a_user_iterator_once():
    engine = _simple_engine(data_prefetch={"enabled": True})
    it = _forever()
    engine.train_batch(data_iter=it)
    engine.train_batch(data_iter=it)
    (src, wrapped), = engine._prefetch_wrap_cache.values()
    assert src is it and isinstance(wrapped, PrefetchIterator)
    engine.close()
    assert not _prefetch_threads() and not engine._prefetch_wrap_cache


def test_stateful_and_prefetched_iterators_pass_through(warnings_seen):
    """A RepeatingLoader over a plain loader is not wrapped (its resume
    counters would run ahead of training; warned once), nor one over a
    deepspeed_io PrefetchLoader (already a pipeline)."""
    engine = _simple_engine(data_prefetch={"enabled": True})
    plain = RepeatingLoader(simple.random_dataloader(engine, 64, 16))
    for _ in range(2):
        engine.train_batch(data_iter=plain)
    assert not engine._prefetch_wrap_cache
    assert plain.state_dict() == {"epoch": 0, "batch_in_epoch": 2}
    assert sum("not wrapping the stateful" in m
               for m in warnings_seen) == 1
    rl = RepeatingLoader(engine.deepspeed_io(simple.random_dataset(64, 16),
                                             num_local_io_workers=2))
    for _ in range(3):
        engine.train_batch(data_iter=rl)
    assert not engine._prefetch_wrap_cache and _prefetch_threads()
    assert rl.state_dict() == {"epoch": 0, "batch_in_epoch": 3}
    engine.close()
    assert not _prefetch_threads()


def test_prefetch_off_keeps_the_plain_loader(monkeypatch, warnings_seen):
    engine = _simple_engine(data_prefetch={"enabled": False},
                            dataloader_drop_last=False)
    loader = engine.deepspeed_io(simple.random_dataset(20, 16),
                                 num_local_io_workers=4)
    assert isinstance(loader, DeepSpeedDataLoader) and len(loader) == 3
    assert any("has no effect while data_prefetch is disabled" in m
               for m in warnings_seen)
    assert engine._maybe_prefetch_iter(iter([])) is not None
    monkeypatch.setenv("DS_DATA_PREFETCH", "1")
    forced = _simple_engine(data_prefetch={"enabled": False})
    assert isinstance(forced.deepspeed_io(simple.random_dataset(16, 16)),
                      PrefetchLoader)
    forced.close()
    engine = _simple_engine(data_prefetch={"enabled": True,
                                           "to_device": False})
    assert engine._prefetch_place_fn() is None
    engine.close()


@pytest.mark.parametrize("route", [None, "train", "eval"])
def test_deepspeed_io_rank_slice_and_sampler(route):
    """The loader takes this rank's micro-batch rows, the data group's
    rank and size (1 here), shuffles unless a sampler gives the order
    (used verbatim), and drops the last partial batch by default."""
    engine = _simple_engine(train_micro_batch_size_per_gpu=4,
                            gradient_accumulation_steps=2,
                            data_prefetch={"enabled": True})
    loader = engine.deepspeed_io(simple.random_dataset(18, 16),
                                 route=route).loader
    assert (loader.batch_size, loader.process_index,
            loader.process_count) == (4, 0, 1)
    assert loader.shuffle and loader.drop_last and len(loader) == 4
    sampled = engine.deepspeed_io(simple.random_dataset(18, 16),
                                  data_sampler=range(17, -1, -1),
                                  route=route).loader
    assert not sampled.shuffle
    assert [i.tolist() for i in sampled._index_plan()][0] == [17, 16, 15,
                                                              14]
    engine.close()


# the schedules, the first being chip_smoke.py phase 22's
SCHEDULES = {
    "fixed_linear": {"min_difficulty": 64, "max_difficulty": 1024,
                     "schedule_type": "fixed_linear",
                     "schedule_config": {"total_curriculum_step": 4,
                                         "difficulty_step": 8}},
    "fixed_root": {"min_difficulty": 8, "max_difficulty": 100,
                   "schedule_type": "fixed_root",
                   "schedule_config": {"total_curriculum_step": 7,
                                       "difficulty_step": 4,
                                       "root_degree": 2}},
    "fixed_discrete": {"min_difficulty": 1, "max_difficulty": 9,
                       "schedule_type": "fixed_discrete",
                       "schedule_config": {"difficulty": [1, 4, 9],
                                           "max_step": [2, 5]}},
    "custom": {"min_difficulty": 2, "max_difficulty": 50,
               "schedule_type": "custom"},
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_curriculum_schedule_and_truncation_equal_jax(name):
    """Each step's difficulty, and the truncated batch (axis 1 of every
    leaf of 2 or more dims; a view), equal JAX's scheduler's."""
    from deepspeed_tpu.runtime.data_pipeline import \
        curriculum_scheduler as jax_cs
    from deepspeed_tpu_torch.runtime.data_pipeline import \
        curriculum_scheduler as port_cs
    port = port_cs.CurriculumScheduler(dict(SCHEDULES[name]))
    ref = jax_cs.CurriculumScheduler(dict(SCHEDULES[name]))
    if name == "custom":
        for s in (port, ref):
            s.set_custom_get_difficulty(lambda step: 2 + 5 * step)
    batch = {"ids": np.arange(3 * 1100).reshape(3, 1100), "lens":
             np.arange(3), "x": np.ones((3, 1100, 2), np.float32)}
    for step in range(12):
        got = port_cs.apply_seqlen_truncation(
            port, step, {k: torch.from_numpy(v) for k, v in batch.items()})
        want = jax_cs.apply_seqlen_truncation(ref, step, batch)
        assert port.get_current_difficulty() == ref.get_current_difficulty()
        for k in batch:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        assert got["ids"].data_ptr() == batch["ids"].ctypes.data or \
            got["ids"].shape[1] == 1100
    if name == "fixed_linear":
        lens = [port_cs.CurriculumScheduler(dict(SCHEDULES[name]))
                .update_difficulty(s) for s in (1, 2, 3, 4)]
        assert lens == [304, 544, 784, 1024]
