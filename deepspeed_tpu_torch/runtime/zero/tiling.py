"""``TiledLinear``: a large Linear cut into a grid of tiles (counterpart
of ``deepspeed_tpu/runtime/zero/tiling.py``).

The reference's ``TiledLinear`` (``deepspeed/runtime/zero/tiling.py:27``)
and ``TiledLinearReturnBias`` (:257) split one ``nn.Linear`` into
``in_splits`` x ``out_splits`` smaller ones, so that each tile is a
parameter of its own: ZeRO-3 cuts, gathers and checkpoints it apart.
out[:, oc] = sum_ic x[:, ic] @ W[ic, oc] (+ bias[oc]), the untiled
Linear for any split counts. Each tile ``tile_{ic}_{oc}`` is an
``nn.Linear``; the bias sits on the last input tile only, as in the JAX
module (``bridge.TILED_LAYOUT`` maps the two). Initialised as flax's
Dense (lecun normal kernels, zero biases) from a seed.
"""

import torch
from torch import nn

from deepspeed_tpu_torch.models.common import lecun_normal_


def partition_uniform(num_items, num_parts):
    """The even split, the remainder spread over the leading parts: the
    part boundaries (the reference's ``runtime/utils.py``
    ``partition_uniform``; the JAX package's copy is in
    ``runtime/pipe/module.py``)."""
    parts = [0] * (num_parts + 1)
    chunk = num_items // num_parts
    residual = num_items % num_parts
    for p in range(num_parts):
        parts[p + 1] = parts[p] + chunk + (1 if p < residual else 0)
    return parts


def split_dim(total, parts):
    """(sizes, bounds) of the near-even split of ``total`` into
    ``parts``."""
    bounds = partition_uniform(total, parts)
    return [bounds[i + 1] - bounds[i] for i in range(parts)], bounds


class TiledLinear(nn.Module):
    """An ``in_splits`` x ``out_splits`` grid of Linear tiles, equal to
    one Linear of ``in_features`` -> ``out_features``."""

    def __init__(self, in_features, out_features, in_splits=1, out_splits=1,
                 use_bias=True, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.in_sizes, self.in_bounds = split_dim(in_features, in_splits)
        self.out_sizes, _ = split_dim(out_features, out_splits)
        gen = torch.Generator().manual_seed(seed)
        for oc, osz in enumerate(self.out_sizes):
            for ic, isz in enumerate(self.in_sizes):
                bias = use_bias and ic == len(self.in_sizes) - 1
                tile = nn.Linear(isz, osz, bias=bias, dtype=dtype)
                with torch.no_grad():
                    lecun_normal_(tile.weight, gen)
                    if bias:
                        tile.bias.zero_()
                self.add_module(f"tile_{ic}_{oc}", tile.to(device))

    def forward(self, x):
        if x.shape[-1] != self.in_features:
            raise ValueError(f"expected {self.in_features} input features, "
                             f"got {tuple(x.shape)}")
        outs = []
        for oc in range(len(self.out_sizes)):
            acc = None
            for ic in range(len(self.in_sizes)):
                xin = x[..., self.in_bounds[ic]:self.in_bounds[ic + 1]]
                y = getattr(self, f"tile_{ic}_{oc}")(xin)
                acc = y if acc is None else acc + y
            outs.append(acc)
        return torch.cat(outs, dim=-1)


class TiledLinearReturnBias(nn.Module):
    """:class:`TiledLinear` without its bias, returning ``(out, bias)``:
    the reference's form for a row-parallel layer that adds the bias
    after its all-reduce (tiling.py:257)."""

    def __init__(self, in_features, out_features, in_splits=1, out_splits=1,
                 use_bias=True, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        self.tiles = TiledLinear(in_features, out_features, in_splits,
                                 out_splits, use_bias=False, device=device,
                                 dtype=dtype, seed=seed)
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                              device=device))
                     if use_bias else None)

    def forward(self, x):
        return self.tiles(x), self.bias
