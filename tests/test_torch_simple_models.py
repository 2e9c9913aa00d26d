"""The fixture models (``models/simple.py``) and the CIFAR-10 net
(``models/cifar.py``) of the PyTorch port against the JAX package's, on
the CPU: flax params carried across by ``bridge.simple_flax_to_state_dict``
/ ``cifar_flax_to_state_dict``, the loss and every gradient at rtol =
atol = 1e-5 (the bound of ``tests/test_torch_bert.py``), and a few
engine steps against the JAX engine at the same bound. The data helpers
draw the JAX functions' numpy values exactly.
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import cifar as jax_cifar
from deepspeed_tpu.models import simple as jax_simple
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.bridge import (cifar_flax_to_state_dict,
                                        simple_flax_to_state_dict)
from deepspeed_tpu_torch.models import cifar, simple
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _xy(batch=8, din=16, dout=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, din)).astype(np.float32),
            rng.standard_normal((batch, dout)).astype(np.float32))


def _emb_batch(vocab=50, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, vocab, (8, 12), dtype=np.int32),
            "targets": rng.standard_normal((8, dim)).astype(np.float32)}


CASES = {
    "simple_1": (lambda: jax_simple.SimpleModel(16),
                 lambda: simple.SimpleModel(16, device="cpu"),
                 simple_flax_to_state_dict, _xy),
    "simple_3": (lambda: jax_simple.SimpleModel(16, nlayers=3),
                 lambda: simple.SimpleModel(16, 3, device="cpu"),
                 simple_flax_to_state_dict, _xy),
    "linear_stack": (lambda: jax_simple.LinearStack(12, 32, 10, 3),
                     lambda: simple.LinearStack(12, 32, 10, 3, device="cpu"),
                     simple_flax_to_state_dict,
                     lambda: _xy(din=12, dout=10)),
    "embedding": (lambda: jax_simple.EmbeddingModel(50, 16),
                  lambda: simple.EmbeddingModel(50, 16, device="cpu"),
                  simple_flax_to_state_dict, _emb_batch),
    "cifar": (lambda: jax_cifar.CifarNet(),
              lambda: cifar.CifarNet(device="cpu"),
              cifar_flax_to_state_dict,
              lambda: tuple(np.asarray(a) for a in
                            jax_cifar.synthetic_cifar_batch(8, seed=1))),
}


def _to_torch(batch):
    if isinstance(batch, dict):
        return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return tuple(torch.from_numpy(np.array(v)) for v in batch)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_grads_match_jax(name):
    make_jax, make_port, to_sd, make_batch = CASES[name]
    batch = make_batch()
    jmodel = make_jax()
    params = jmodel.init(jax.random.PRNGKey(0), batch)["params"]
    want, want_g = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, batch))(params)
    model = make_port()
    sd = to_sd(jax.tree.map(np.asarray, params))
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    loss = model(_to_torch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    want_g = to_sd(jax.tree.map(np.asarray, want_g))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                   err_msg=k, **TOL)


def test_cifar_logits_match_jax():
    batch = tuple(np.asarray(a) for a in
                  jax_cifar.synthetic_cifar_batch(4, seed=2))
    jmodel = jax_cifar.CifarNet()
    params = jmodel.init(jax.random.PRNGKey(3), batch)["params"]
    want = jmodel.apply({"params": params}, batch, return_logits=True)
    model = cifar.CifarNet(device="cpu")
    model.load_state_dict(cifar_flax_to_state_dict(
        jax.tree.map(np.asarray, params)))
    tb = _to_torch(batch)
    got = model(tb, return_logits=True)
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(model((tb[0],)).detach().numpy(),
                                  got.detach().numpy())


@pytest.mark.parametrize("name,opt", [
    ("simple_3", {"type": "Adam", "params": {"lr": 1e-2}}),
    ("linear_stack", {"type": "SGD", "params": {"lr": 0.05,
                                                "momentum": 0.9}}),
    ("cifar", {"type": "SGD", "params": {"lr": 0.01, "momentum": 0.9}}),
])
def test_engine_steps_match_jax_engine(name, opt):
    """Three steps of each engine. The CIFAR net runs SGD: under Adam,
    whose step divides each gradient by its own magnitude, a weight whose
    gradient is near zero (ReLU units barely alive) turns last-bit
    gradient differences into 1.5e-5 of the update after 3 steps."""
    make_jax, make_port, to_sd, make_batch = CASES[name]
    batch = make_batch()
    cfg = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
           "optimizer": opt}
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=make_jax(), config=dict(cfg),
                                        sample_batch=batch)
    init = to_sd(jax.tree.map(np.asarray, jeng.state.params))
    want = [float(jeng.train_batch(batch=batch)) for _ in range(3)]
    peng, *_ = deepspeed_tpu_torch.initialize(
        model=make_port(), config=dict(cfg), model_parameters=init,
        device="cpu")
    got = [float(peng.train_batch(batch=_to_torch(batch)))
           for _ in range(3)]
    np.testing.assert_allclose(got, want, **TOL)
    assert got[-1] < got[0]
    final = to_sd(jax.tree.map(np.asarray, jeng.state.params))
    for k, p in peng.module.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[k].numpy(), err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("precision", ["fp16", "bf16"])
@pytest.mark.parametrize("name", ["simple_3", "linear_stack"])
def test_low_precision_engine_takes_fp32_batches_as_jax(name, precision):
    """ROADMAP Queue C item C7: an fp16 or bf16 engine fed fp32 (x, y)
    batches. Flax's ``Dense`` promotes its input and its low-precision
    kernel to their common type, so the JAX engine computes in fp32 over
    the cast params; the port's fixture denses promote the same way
    (they raised "mat1 and mat2 must have the same dtype" before). Three
    Adam steps against the JAX engine: losses at rtol = atol = 1e-5 (both
    round the masters to the compute dtype at the same points and compute
    the products in fp32); masters at atol 1e-4 (the gradients are
    rounded to the compute dtype, and a sum in another order can land one
    ulp away, 2^-8 relative in bf16, which Adam's normalised update at
    lr 1e-2 carries to ~2e-5 of a weight)."""
    make_jax, make_port, to_sd, make_batch = CASES[name]
    batch = make_batch()
    assert batch[0].dtype == np.float32
    cfg = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           precision: {"enabled": True}}
    if precision == "fp16":
        cfg["fp16"].update(loss_scale=0, initial_scale_power=8)
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=make_jax(), config=dict(cfg),
                                        sample_batch=batch)
    init = to_sd(jax.tree.map(np.asarray, jeng.state.params))
    want = [float(jeng.train_batch(batch=batch)) for _ in range(3)]
    peng, *_ = deepspeed_tpu_torch.initialize(
        model=make_port(), config=dict(cfg), model_parameters=init,
        device="cpu")
    got = [float(peng.train_batch(batch=_to_torch(batch)))
           for _ in range(3)]
    np.testing.assert_allclose(got, want, **TOL)
    assert got[-1] < got[0]
    final = to_sd(jax.tree.map(np.asarray, jeng.state.params))
    for k, p in peng.params.items():
        np.testing.assert_allclose(p.detach().numpy(), final[k].numpy(),
                                   err_msg=k, rtol=0, atol=1e-4)


def test_data_helpers_draw_the_jax_values():
    want = jax_simple.random_dataset(5, 7, seed=3)
    got = simple.random_dataset(5, 7, seed=3)
    assert len(got) == 5
    for (x, y), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
    zx, zy = simple.sample_batch(4, 7, device="cpu")
    assert zx.shape == zy.shape == (4, 7) and not zx.any()
    images, labels = cifar.synthetic_cifar_batch(6, seed=4, device="cpu")
    wi, wl = jax_cifar.synthetic_cifar_batch(6, seed=4)
    np.testing.assert_array_equal(images.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(wl))
    assert labels.dtype == torch.int64


@pytest.mark.parametrize("make", [
    lambda s: simple.SimpleModel(64, 2, device="cpu", seed=s),
    lambda s: simple.LinearStack(64, 64, 64, 2, device="cpu", seed=s),
    lambda s: simple.EmbeddingModel(400, 64, device="cpu", seed=s),
    lambda s: cifar.CifarNet(device="cpu", seed=s),
])
def test_seeded_init_has_flax_statistics(make):
    """The same seed draws the same weights; dense kernels have the
    LeCun-normal std 1/sqrt(fan_in), biases are zero."""
    a, b = make(7), make(7)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    assert not torch.equal(next(make(8).parameters()),
                           next(a.parameters()))
    for k, p in a.named_parameters():
        if k.endswith("bias"):
            assert not p.any()
        elif p.numel() >= 4096:
            fan_in = p[0].numel()
            assert abs(p.std().item() * fan_in ** 0.5 - 1.0) < 0.1, k
    if not torch.cuda.is_available():      # device=None means the card
        with pytest.raises(RuntimeError, match="CUDA"):
            simple.SimpleModel(4)
