"""Test-fixture models (counterpart of ``deepspeed_tpu/models/simple.py``):
``SimpleModel``, ``LinearStack`` and ``EmbeddingModel`` as ``nn.Module``s
whose ``forward(batch)`` returns the loss, the DeepSpeed convention.

Weights are drawn from ``seed`` with the flax initialisers' statistics
(denses LeCun-normal, zero biases; the embedding table normal with
variance 1 / dim); ``bridge.simple_flax_to_state_dict`` carries flax
params across. Flax's ``Dense_{i}`` becomes ``layers.{i}`` and
``EmbeddingModel``'s ``wte`` / ``Dense_0`` become ``wte`` / ``dense``.
"""

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from deepspeed_tpu_torch.models.common import lecun_normal_
from deepspeed_tpu_torch.ops._platform import resolve_device


class _Seeded(nn.Module):
    """Builds on ``device`` (None means CUDA) and draws from ``seed``."""

    def _draw(self, seed):
        gen = torch.Generator(device=next(self.parameters()).device)
        gen.manual_seed(seed)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (nn.Linear, nn.Embedding)):
                    lecun_normal_(mod.weight, gen)
                if isinstance(mod, nn.Linear) and mod.bias is not None:
                    nn.init.zeros_(mod.bias)


class SimpleModel(_Seeded):
    """``nlayers`` hidden -> hidden denses, then the mean squared error
    against the targets (the reference ``SimpleModel``)."""

    def __init__(self, hidden_dim: int, nlayers: int = 1, *, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.layers = nn.ModuleList(nn.Linear(hidden_dim, hidden_dim, **kw)
                                    for _ in range(nlayers))
        self._draw(seed)

    def forward(self, batch):
        x, y = batch
        for layer in self.layers:
            x = layer(x)
        return torch.mean((x - y) ** 2)


class LinearStack(_Seeded):
    """A deep stack of bias-free denses (the reference ``LinearStack``):
    input -> hidden, ``num_layers`` hidden -> hidden with ReLU, hidden ->
    output; the mean squared error against the targets."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 128,
                 output_dim: int = 128, num_layers: int = 4, *, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype, bias=False)
        dims = [input_dim] + [hidden_dim] * (num_layers + 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b, **kw)
                                    for a, b in zip(dims, dims[1:]))
        self._draw(seed)

    def forward(self, batch):
        x, y = batch
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if 0 < i < last:
                x = F.relu(x)
        return torch.mean((x - y) ** 2)


class EmbeddingModel(_Seeded):
    """An embedding table and a dense head (the sparse-gradient fixture):
    the mean of the batch's token rows, a dense, the mean squared error
    against ``targets``. Batch: ``{"input_ids", "targets"}``."""

    def __init__(self, vocab: int, dim: int, *, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.wte = nn.Embedding(vocab, dim, **kw)
        self.dense = nn.Linear(dim, dim, **kw)
        self._draw(seed)

    def forward(self, batch):
        x = self.wte(batch["input_ids"].long()).mean(dim=1)
        return torch.mean((self.dense(x) - batch["targets"]) ** 2)


def random_dataset(total_samples, hidden_dim, seed=0, dtype=np.float32):
    """(x, y) pairs of Gaussian vectors, the JAX function's numpy draws."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((total_samples, hidden_dim)).astype(dtype)
    ys = rng.standard_normal((total_samples, hidden_dim)).astype(dtype)
    return [(xs[i], ys[i]) for i in range(total_samples)]


def random_dataloader(model_engine, total_samples, hidden_dim, seed=0,
                      dtype=np.float32):
    """A ``DeepSpeedDataLoader`` of this rank's micro-batches over
    :func:`random_dataset` (JAX ``random_dataloader``, whose one process
    loads the global batch)."""
    from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
    ds = random_dataset(total_samples, hidden_dim, seed=seed, dtype=dtype)
    return DeepSpeedDataLoader(
        ds, batch_size=model_engine.train_micro_batch_size_per_gpu())


def sample_batch(batch_size, hidden_dim, dtype=torch.float32, device=None):
    """A zero (x, y) batch on ``device`` (None means CUDA)."""
    dev = resolve_device(device)
    return (torch.zeros((batch_size, hidden_dim), dtype=dtype, device=dev),
            torch.zeros((batch_size, hidden_dim), dtype=dtype, device=dev))
