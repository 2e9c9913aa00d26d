"""The CIFAR-10 CNN of DeepSpeedExamples (counterpart of
``deepspeed_tpu/models/cifar.py``): conv5x5(6) -> pool -> conv5x5(16) ->
pool -> fc120 -> fc84 -> fc10, ``forward(batch)`` returning the mean
cross-entropy.

Batches are the JAX package's: ``(images [B, 32, 32, 3] float, labels
[B])`` or ``{"images", "labels"}``, channels last. The convolutions run
channels first and the features are flattened channels last, as flax
flattens them, so ``bridge.cifar_flax_to_state_dict`` carries flax
params across unchanged in meaning. Weights are drawn from ``seed`` with
flax's statistics (LeCun-normal kernels, zero biases).
"""

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from deepspeed_tpu_torch.models.common import lecun_normal_
from deepspeed_tpu_torch.ops._platform import resolve_device


class CifarNet(nn.Module):
    """conv1, conv2 (5 x 5, VALID), fc1, fc2, fc3; ReLU and 2 x 2 max
    pooling as in the flax net."""

    def __init__(self, num_classes: int = 10, *, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.conv1 = nn.Conv2d(3, 6, 5, **kw)
        self.conv2 = nn.Conv2d(6, 16, 5, **kw)
        self.fc1 = nn.Linear(16 * 5 * 5, 120, **kw)
        self.fc2 = nn.Linear(120, 84, **kw)
        self.fc3 = nn.Linear(84, num_classes, **kw)
        gen = torch.Generator(device=kw["device"]).manual_seed(seed)
        with torch.no_grad():
            for mod in (self.conv1, self.conv2, self.fc1, self.fc2,
                        self.fc3):
                lecun_normal_(mod.weight, gen)
                nn.init.zeros_(mod.bias)

    def forward(self, batch, return_logits: bool = False):
        if isinstance(batch, (tuple, list)):
            images, labels = batch[0], (batch[1] if len(batch) > 1
                                        else None)
        else:
            images, labels = batch["images"], batch.get("labels")
        x = images.permute(0, 3, 1, 2)                  # NHWC -> NCHW
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # flax's order
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        logits = self.fc3(x)
        if return_logits or labels is None:
            return logits
        logp = F.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, labels.long()[:, None]).mean()


def synthetic_cifar_batch(batch_size, seed=0, device=None):
    """The JAX function's numpy draws (images, labels) as tensors on
    ``device`` (None means CUDA)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch_size, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, batch_size, dtype=np.int32)
    return (torch.from_numpy(images).to(dev),
            torch.from_numpy(labels).long().to(dev))
