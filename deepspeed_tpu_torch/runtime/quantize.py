"""Quantize-aware training (MoQ): the schedule (counterpart of
``deepspeed_tpu/runtime/quantize.py``).

Progressive bit reduction during training. Pure host logic: per-block
bits and periods; a block whose step counter reaches its period drops one
bit and doubles its period; with ``fp16_mixed_quantize`` each tensor
becomes ``ratio * x + (1 - ratio) * quantize(x)`` with the ratio falling
by ``q_change_ratio`` a step; an overflowed fp16 step is skipped; only
tensors with ``ndim >= 2`` and ``numel % q_groups == 0`` are quantized;
``bits >= 16`` passes the tensor through without a launch.

Eigenvalue guidance is not ported (the engine's config raises for it), so
every parameter is block 0 and ``any_precision_switch`` is exposed but
unused. ``block_eigenvalue`` keys are the reference's ``path_str`` form:
the port's parameter names with ``/`` for ``.``.

Two differences from the JAX class, both of representation:
* the parameters are a dict of name -> tensor quantized **in place**
  (the JAX class returns a new pytree); a tensor that the port stores as
  the transpose of the flax layout (``transposed`` names, the ``[out,
  in]`` dense weights) is grouped over its transpose, as flax groups it;
* the stochastic-rounding seed is an integer counter this object owns,
  one per quantized tensor, where the JAX package keeps a module global
  (``_SR_COUNTER``).
"""

import math

import torch
from torch import nn

from deepspeed_tpu_torch.ops.quantizer.int8_linear import QuantDense
from deepspeed_tpu_torch.ops.quantizer.quantizer import quantize_multi


def transposed_weight_names(module):
    """The parameters of ``module`` stored as the transpose of the flax
    layout: the ``[out, in]`` weights of ``QuantDense`` and ``nn.Linear``
    (flax kernels are ``[in, out]``)."""
    return {f"{name}.weight" if name else "weight"
            for name, m in module.named_modules()
            if isinstance(m, (QuantDense, nn.Linear))}


def path_str(name):
    """A port parameter name in the JAX ``eigenvalue.path_str`` form
    (``h.0.attn.qkv.weight`` -> ``h/0/attn/qkv/weight``)."""
    return name.replace(".", "/")


class Quantizer:
    def __init__(self, q_groups=1, q_mixed_fp16=False, q_change_ratio=0.001,
                 q_type=0, q_rounding=0, q_verbose=False, q_eigenvalue=False,
                 use_quantizer_kernel=True, layer_num=0,
                 q_start_bits=16, q_target_bits=8, q_period=1000):
        n = layer_num if layer_num != 0 else 1
        self.q_groups = q_groups
        self.q_mixed_fp16 = q_mixed_fp16
        self.q_change_ratio = q_change_ratio
        self.q_type = q_type            # 0 symmetric, 1 asymmetric
        self.q_rounding = q_rounding    # 0 nearest, 1 stochastic
        self.q_verbose = q_verbose
        self.use_eigenvalue = q_eigenvalue
        self.use_quantizer_kernel = use_quantizer_kernel
        self.layer_num = layer_num
        self.q_start_bits = [q_start_bits] * n
        self.q_target_bits = q_target_bits
        self.q_period = [q_period] * n
        self.qsteps = 0
        self.quantize_real_ratio = 1.0
        self.seed = 0                   # the stochastic-rounding counter
        self._seen_blocks = set()

    def any_precision_switch(self):
        """True when the next step drops a bit for some block (JAX
        quantize.py:52-65); only blocks that own a quantized tensor count
        once they are known."""
        ids = range(len(self.q_start_bits))
        if self.qsteps > 0:
            ids = self._seen_blocks
        return any(
            self.q_start_bits[i] != self.q_target_bits
            and self.qsteps + 1 >= self.q_period[i]
            for i in ids)

    def current_bits(self, index=0):
        return self.q_start_bits[index]

    def _maybe_switch(self, index, factor):
        """Per-block bit drop and period doubling at the period boundary
        (JAX quantize.py:70-87)."""
        if (self.q_start_bits[index] != self.q_target_bits
                and self.qsteps >= self.q_period[index]):
            self.quantize_real_ratio = 1.0
            if self.use_eigenvalue:
                self.q_period[index] = (self.q_period[index] << 1) * factor
                self.q_start_bits[index] -= 1
            else:
                for i in range(len(self.q_start_bits)):
                    self.q_start_bits[i] -= 1
                    self.q_period[i] <<= 1
            if self.q_verbose:
                print(f"MoQ: block {index} -> {self.q_start_bits[index]} "
                      f"bits, next period {self.q_period[index]} "
                      f"(step {self.qsteps})", flush=True)

    @torch.no_grad()
    def quantize(self, params, overflow=False, eigenvalue_enabled=False,
                 block_eigenvalue=None, transposed=()):
        """Fake-quantize ``params`` (name -> tensor) in place, in name
        order (the JAX tree walk's order for the port's names): the seeds
        and bit switches follow that order, and the tensors go to the
        kernel together, one :func:`quantize_multi` call (out of place and
        blended where the mixed-fp16 ratio is below 1).
        ``transposed``: the names stored as the transpose of the reference
        layout. ``block_eigenvalue``: ``{path_str(name): (curvature_ratio,
        block_id)}``; empty puts every tensor in block 0."""
        if overflow and not eigenvalue_enabled:
            return
        self.qsteps += 1
        block_eigenvalue = block_eigenvalue or {}
        # the reference lowers the ratio before its parameter loop
        if self.q_mixed_fp16:
            self.quantize_real_ratio = max(
                0.0, self.quantize_real_ratio - self.q_change_ratio)
        # (tensor, bits, seed, transposed) quantized in place, and with the
        # mixed-fp16 blend beside its ratio
        in_place, mixed = [], []
        for name in sorted(params):
            x = params[name]
            if x.dim() < 2 or x.numel() % self.q_groups:
                continue
            ev, layer_id = block_eigenvalue.get(path_str(name), (None, 0))
            if layer_id >= len(self.q_start_bits):
                raise ValueError(
                    f"MoQ: eigenvalue block id {layer_id} for param "
                    f"'{path_str(name)}' exceeds the quantizer's "
                    f"layer_num={self.layer_num}; set eigenvalue."
                    "layer_num to the model's repeated-layer count")
            self._seen_blocks.add(layer_id)
            factor = 1 + math.floor(ev * 4) if ev is not None else 1
            self._maybe_switch(layer_id, factor)
            bits = self.q_start_bits[layer_id]
            if bits >= 16:
                continue
            self.seed += 1
            item = (x, bits, self.seed, name in transposed)
            ratio = self.quantize_real_ratio
            if self.q_mixed_fp16 and ratio < 1.0:
                mixed.append((item, ratio))
            else:
                in_place.append(item)
        # one multi-tensor call for each kind (one launch a step)
        for items, mix in ((in_place, False), (mixed, True)):
            if not items:
                continue
            if mix:
                items, ratios = zip(*items)
            xs, bits, seeds, trans = zip(*items)
            kw = dict(num_bits=list(bits), groups=self.q_groups,
                      symmetric=self.q_type == 0,
                      stochastic=self.q_rounding == 1, seeds=list(seeds),
                      transposed=list(trans))
            if not mix:
                quantize_multi(xs, out=xs, **kw)
                continue
            for x, qx, ratio in zip(xs, quantize_multi(xs, **kw), ratios):
                x.copy_(ratio * x + (1.0 - ratio) * qx)
