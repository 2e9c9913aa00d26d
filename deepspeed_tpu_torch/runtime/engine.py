"""The training engine, main path (counterpart of
``deepspeed_tpu/runtime/engine.py``'s ``DeepSpeedEngine``).

The loop users write, with the JAX engine's contract:
``loss = engine.forward(batch)`` (the unscaled loss of one micro-batch,
with its graph, in training mode, dropout keyed by (seed, micro_steps)),
``engine.backward(loss)`` (the loss-scaled backward divided by gas; it
advances ``micro_steps``) and ``engine.step()`` (nothing off the
gradient-accumulation boundary; on it the epilogue, the update, MoQ and
the scheduler). ``train_batch`` is that loop over ``gas`` micro-batches.
``eval_batch`` (and ``engine(batch)``, as in JAX) computes the loss
without gradients or dropout.

One rank: fp32 master parameters (the module's own), the forward in the
compute dtype (bf16, fp16 or fp32) through ``torch.func.functional_call``
so the gradients land on the fp32 masters, gradient accumulation over
``gas`` micro-batches (in fp32, or in the ``gradient_accumulation_dtype``
bf16/fp16 buffer as the JAX micro-step casts into it, engine.py:1144-1150,
1532-1535, at every gas; only ``train_batch`` at gas 1 keeps the fp32
gradients, as the JAX fused gas-1 step has no buffer, engine.py:1702),
then the epilogue and update of the JAX step in the same order
(engine.py:1555-1628): unscale, the non-finite check (fp16 only), the
global norm (fp16 or clipping only), the clip coefficient, the
loss-scale update, the optimizer update, ``p += u``.

Data parallelism over ``torch.distributed`` (``utils/groups.py``: the
data group is the world; one process a rank, each fed its own
micro-batches). With a process group, at any world size, the engine
broadcasts the masters from rank 0 at construction; averages the
gradients over the group (one all-reduce over a flat buffer: on the
accumulation boundary with fp32 accumulation, or each micro-step's fp32
gradients before the cast into a bf16/fp16 ``gradient_accumulation_dtype``
buffer, as JAX's psum precedes that cast, engine.py:1527-1536); takes the
norm and the clip from the averaged gradients, so they are equal on every
rank; agrees on an fp16 overflow (the flag is reduced with MAX before the
host reads it); and returns losses averaged over the ranks, the mean over
the global batch when every rank's loss is a mean over the same count
(see README for masked losses). At ZeRO stage 1 each rank keeps and
updates the optimizer state of its slices only
(``runtime/zero/partition.py``) and the updates are all-gathered; at
stage 0 every rank keeps the whole state. Without a process group the
engine runs no collective: one rank's partition is the whole state, as on
the JAX package's one-device mesh.

MoQ (``quantize_training``): after an applied step and before the lr
scheduler advances, the schedule of ``runtime/quantize.py`` fake-quantizes
the fp32 masters in place under ``no_grad`` (engine.py:3111-3130, where
the JAX engine replaces the params pytree); an fp16 step that overflowed
skips it.

Host syncs: bf16 and fp32 steps make none, but for the grad-norm fetch of
``get_global_grad_norm`` every ``steps_per_print`` steps when the step
takes a norm (as in JAX). An fp16 step makes one, to read the overflow
flag that decides whether the update is applied; this is the port's
counterpart of the JAX ``lax.cond`` (engine.py:1627), which keeps that
decision on the device.

The engine numbers the module's dropout sites (``dropout.number_sites``)
once, at construction, so layers a user stacks draw distinct masks.
Remat and dropout live in the models (``models/gpt2.py``,
``models/bert.py``, ``ops/transformer/transformer.py``); the casts of
the masters stay outside every recomputed block (``runtime/
activation_checkpointing/checkpointing.remat``).
"""

import glob
import os
import re

import numpy as np
import torch
from torch.func import functional_call

from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.runtime import checkpoint_io
from deepspeed_tpu_torch.runtime import dropout as dropout_lib
from deepspeed_tpu_torch.runtime import optim as optim_lib
from deepspeed_tpu_torch.runtime.config import (ADAGRAD_OPTIMIZER,
                                                ADAMW_OPTIMIZER,
                                                ADAM_OPTIMIZER,
                                                LAMB_OPTIMIZER,
                                                SGD_OPTIMIZER,
                                                DeepSpeedConfig)
from deepspeed_tpu_torch.runtime.constants import (LATEST_FILE,
                                                   MODEL_FILE_SUFFIX,
                                                   OPTIM_FILE_SUFFIX)
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (make_scale_state,
                                                          update_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime.quantize import (Quantizer,
                                                  transposed_weight_names)
from deepspeed_tpu_torch.runtime.zero.partition import ZeroPartition
from deepspeed_tpu_torch.telemetry.metrics import get_registry
from deepspeed_tpu_torch.telemetry.tracer import trace_span
from deepspeed_tpu_torch.utils import groups
from deepspeed_tpu_torch.utils.logging import log_dist, logger


def _to_device(batch, device):
    if isinstance(batch, torch.Tensor):
        return batch.to(device, non_blocking=True)
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_device(v, device) for v in batch)
    return torch.as_tensor(batch, device=device)


def _grad_of(name, p):
    if p.grad is None:
        raise RuntimeError(f"no gradient reached {name}: the loss graph is "
                           f"cut")
    return p.grad


class DeepSpeedEngine:
    """The training loop over a module whose ``forward(batch)`` returns
    the loss. ``module`` holds the fp32 master parameters on ``device``.
    ``optimizer`` is a client ``optim.Optimizer(init, update)`` pair and
    ``lr_scheduler`` a client schedule (``lr_at``, ``step``); ``seed``
    keys the dropout masks (JAX engine.py:245)."""

    def __init__(self, module: torch.nn.Module, config: DeepSpeedConfig,
                 device: torch.device, optimizer=None, lr_scheduler=None,
                 seed: int = 42):
        if not groups.mesh_is_initialized():
            groups.initialize()
        self._dist = groups.dist_active()
        self.dp_group = groups.get_data_parallel_group()
        self.dp_world_size = groups.get_data_parallel_world_size()
        self.dp_rank = groups.get_data_parallel_rank()
        if config.world_size != self.dp_world_size:
            raise ValueError(
                f"the config was triangulated for data-parallel world "
                f"{config.world_size}, but the data group has "
                f"{self.dp_world_size} ranks")
        self.module = dropout_lib.number_sites(module)
        self.config = config
        self.device = device
        self.client_optimizer = optimizer
        self.client_lr_scheduler = lr_scheduler
        self._seed = int(seed)
        self.params = dict(module.named_parameters())
        for name, p in self.params.items():
            if p.dtype != torch.float32 or p.device.type != device.type:
                raise ValueError(f"master parameter {name} must be fp32 on "
                                 f"{device}, got {p.dtype} on {p.device}")
        if self._dist:
            # the masters start equal on every rank
            with torch.no_grad():
                for p in self.params.values():
                    torch.distributed.broadcast(p, 0, group=self.dp_group)
        # ZeRO-1 over a process group: each rank's slices
        self._partition = (ZeroPartition(
            {n: p.shape for n, p in self.params.items()},
            self.dp_world_size, self.dp_rank, self.dp_group)
            if self._dist and config.zero_optimization_stage == 1 else None)
        if config.fp16_enabled:
            self.compute_dtype = torch.float16
        elif config.bfloat16_enabled:
            self.compute_dtype = torch.bfloat16
        else:
            self.compute_dtype = torch.float32
        self._dynamic_scale = bool(config.fp16_enabled
                                   and config.fp16.dynamic_loss_scale)
        if config.fp16_enabled:
            init_scale = (config.initial_dynamic_scale if self._dynamic_scale
                          else config.loss_scale)
        else:
            init_scale = 1.0
        self.scale = make_scale_state(init_scale,
                                      delayed_shift=config.fp16.hysteresis)
        # the accumulation buffer's dtype; None: the masters' fp32 .grad
        self._acc_dtype = {"bf16": torch.bfloat16,
                           "fp16": torch.float16}.get(
                               config.gradient_accumulation_dtype)
        self._acc = None
        self._fused_gas1 = False   # inside train_batch at gas 1
        self._reduce_grads = True  # the last backward's allreduce_gradients

        self.optimizer = self._configure_optimizer()
        # the engine hands the optimizer each rank's slices (ZeRO 1) when
        # its update acts on slices; the sweep cuts its own state, and any
        # other optimizer (a client's) sees whole tensors
        self._sliced = self._partition is not None and \
            self.optimizer.takes_slices
        self.opt_state = self.optimizer.init(self._local(
            {k: p.detach() for k, p in self.params.items()}))
        self.lr_scheduler, self._lr_fn = self._configure_lr_scheduler()
        self.quantizer = self._configure_quantizer()
        self._transposed = transposed_weight_names(module)

        # the last step's norm as a device scalar (None when the step
        # takes none), and as a host float fetched at print cadence
        self.global_grad_norm = None
        self._last_grad_norm = None
        self._pending_loss = None
        self._pending_weight = None     # the last forward's loss weight
        self.step_count = 0      # applied optimizer steps (indexes the lr)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0

        # checkpoints: the JAX tag format; the layout table of a model
        # family the JAX package shares (None: a user module, saved under
        # its own parameter names)
        self._ckpt_async = config.checkpoint_async_save
        self._ckpt_writer = None
        self._layout = bridge.layout_of(self.params)
        self._pinned = {}        # reused pinned host buffers of snapshots

    # ------------------------------------------------------------- config
    def _configure_optimizer(self):
        """A client optimizer, or the one the config names
        (engine.py:922-1017): Adam/AdamW (``sweep`` -> the whole-state
        kernel, ``fused`` -> the per-tensor kernel, else plain torch), LAMB
        (``fused`` -> the one-launch pass-1 kernel, else plain torch), SGD
        and Adagrad (plain torch). At ZeRO 1 over a process group the sweep
        and LAMB take the partition (their chunks, their norms)."""
        if self.client_optimizer is not None:
            if not isinstance(self.client_optimizer, optim_lib.Optimizer):
                raise TypeError(
                    "client optimizer must be a deepspeed_tpu_torch "
                    "Optimizer(init, update) pair, got "
                    f"{type(self.client_optimizer).__name__}")
            return self.client_optimizer
        from deepspeed_tpu_torch.ops.adam import fused_adam
        from deepspeed_tpu_torch.ops.lamb import fused_lamb
        cfg = self.config
        params = dict(cfg.optimizer_params or {})
        betas = params.get("betas", (0.9, 0.999))
        if cfg.optimizer_name == SGD_OPTIMIZER:
            return optim_lib.sgd(momentum=params.get("momentum", 0.0),
                                 weight_decay=params.get("weight_decay", 0.0),
                                 nesterov=params.get("nesterov", False))
        if cfg.optimizer_name == ADAGRAD_OPTIMIZER:
            return optim_lib.adagrad(
                eps=params.get("eps", 1e-8),
                weight_decay=params.get("weight_decay", 0.0))
        if cfg.optimizer_name == LAMB_OPTIMIZER:
            kw = dict(b1=betas[0], b2=betas[1], eps=params.get("eps", 1e-6),
                      weight_decay=params.get("weight_decay", 0.0),
                      min_coeff=params.get("min_coeff", 0.01),
                      max_coeff=params.get("max_coeff", 10.0),
                      bias_correction=params.get("bias_correction", True),
                      partition=self._partition)
            if cfg.optimizer_fused:
                return fused_lamb.fused_lamb(**kw)
            return optim_lib.lamb(**kw)
        kw = dict(b1=betas[0], b2=betas[1], eps=params.get("eps", 1e-8),
                  weight_decay=params.get("weight_decay", 0.0),
                  adam_w_mode=params.get("adam_w_mode", True),
                  bias_correction=params.get("bias_correction", True))
        if cfg.optimizer_sweep:
            return fused_adam.fused_adam_sweep(**kw,
                                               partition=self._partition)
        if cfg.optimizer_fused:
            return fused_adam.fused_adam(**kw)
        return optim_lib.adam(**kw)

    def _configure_lr_scheduler(self):
        """A client schedule, the config's, or the constant base lr
        (engine.py:1019-1028)."""
        base_lr = float((self.config.optimizer_params or {}).get("lr", 1e-3))
        sched = self.client_lr_scheduler
        if sched is not None:
            if not (callable(getattr(sched, "lr_at", None))
                    and callable(getattr(sched, "step", None))):
                raise TypeError(
                    "client lr_scheduler must be a deepspeed_tpu_torch "
                    "schedule (lr_at(step) and step()), got "
                    f"{type(sched).__name__}")
            return sched, sched.lr_at
        if self.config.scheduler_name is not None:
            sched = get_lr_schedule(self.config.scheduler_name,
                                    self.config.scheduler_params)
            return sched, sched.lr_at
        return None, (lambda step: base_lr)

    def _configure_quantizer(self):
        """The MoQ schedule from ``quantize_training`` (engine.py:401-417);
        eigenvalue guidance is refused by the config."""
        if not self.config.quantize_training_enabled:
            return None
        qc = self.config.quantize_training_config
        return Quantizer(
            q_groups=qc.quantize_groups,
            q_mixed_fp16=qc.fp16_mixed_quantize,
            q_change_ratio=qc.quantize_change_ratio,
            q_type=0 if qc.quantize_type == "symmetric" else 1,
            q_rounding=1 if qc.rounding == "stochastic" else 0,
            q_start_bits=qc.start_bits, q_target_bits=qc.target_bits,
            q_period=qc.quantize_period)

    # ------------------------------------------------------------- queries
    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def steps_per_print(self):
        return self.config.steps_per_print

    def is_gradient_accumulation_boundary(self):
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    def get_global_grad_norm(self):
        """The global gradient norm as a host float, fetched at
        ``steps_per_print`` cadence (engine.py:883): None until the first
        fetch, and always None when the step takes no norm (bf16/fp32
        without clipping)."""
        return self._last_grad_norm

    @property
    def loss_scale(self):
        return self.scale.loss_scale

    def get_lr(self):
        """lr of the next applied step."""
        return [float(self._lr_fn(self.step_count))]

    # ------------------------------------------------------ data parallel
    def _local(self, tree):
        """This rank's slices of a dict of parameter-shaped tensors when
        the engine slices the optimizer's inputs (ZeRO 1 over a process
        group), contiguous (a copy only for a slice cut off dimension 0);
        else the dict itself."""
        if not self._sliced:
            return tree
        part = self._partition
        return {k: part.local(k, t).contiguous() for k, t in tree.items()}

    def _average(self, grads):
        """The gradients averaged over the data group: one all-reduce (SUM,
        then × 1/world) over a flat fp32 buffer; the returned tensors are
        views of it."""
        flat = torch.cat([g.reshape(-1) for g in grads.values()])
        torch.distributed.all_reduce(flat, group=self.dp_group)
        flat.mul_(1.0 / self.dp_world_size)
        out, off = {}, 0
        for k, g in grads.items():
            out[k] = flat[off:off + g.numel()].view(g.shape)
            off += g.numel()
        return out

    def _loss_weight(self, batch):
        """This rank's weight in the mean over the data group, n_r · world
        / Σ n, where n_r counts the terms its loss averages (the module's
        ``loss_count(batch)``, the labels that are not ignored): the
        ranks' mean of the weighted losses is then the mean over the
        global batch, as JAX's loss of a global array is, and so is the
        average of their gradients. One scalar all-reduce a micro-step;
        exactly 1 when the ranks hold as many terms. None without a
        process group, or for a module without ``loss_count`` (its loss
        averages over its rows, and every rank holds as many)."""
        count = getattr(self.module, "loss_count", None)
        if not self._dist or count is None:
            return None
        n = count(batch).to(torch.float32).reshape(())
        total = n.clone()
        torch.distributed.all_reduce(total, group=self.dp_group)
        return n * float(self.dp_world_size) / total.clamp(min=1.0)

    def _mean_over_ranks(self, loss):
        """A device scalar averaged over the data group (no host sync)."""
        if not self._dist:
            return loss
        loss = loss.detach().clone()
        torch.distributed.all_reduce(loss, group=self.dp_group)
        return loss.mul_(1.0 / self.dp_world_size)

    def allreduce_gradients(self):
        """Average the masters' gradients over the data group now (the
        reference's ``allreduce_gradients``), for a loop whose boundary
        ``backward`` passed ``allreduce_gradients=False``. Without a
        process group there is nothing to average."""
        if not self._dist:
            return
        grads = self._average({k: _grad_of(k, p)
                               for k, p in self.params.items()})
        for k, p in self.params.items():
            p.grad = grads[k]

    # ------------------------------------------------------------- step
    def _compute_loss(self, batch):
        """Forward in the compute dtype; the cast of each master is part of
        the graph, so its gradient arrives on the fp32 master."""
        cparams = {k: p.to(self.compute_dtype) for k, p in self.params.items()}
        return functional_call(self.module, cparams, (batch,)).float()

    def _grad_epilogue(self, grads, per_rank=False):
        """unscale, non-finite check, norm, clip coefficient, scale update
        (engine.py:1555-1593). Returns (grads, finite, clip_coef);
        ``finite`` is a host bool (fp16: read from the device).
        ``per_rank``: the gradients were not averaged over the data
        group, so one rank's overflow is agreed with a MAX all-reduce
        (averaged, a non-finite value is already on every rank)."""
        cfg = self.config
        inv_scale = 1.0 / self.scale.loss_scale
        if inv_scale != 1.0:
            torch._foreach_mul_(list(grads.values()), inv_scale)
        finite = True
        if cfg.fp16_enabled:
            flags = torch.stack([torch.isfinite(g).all()
                                 for g in grads.values()])
            if per_rank:
                # one rank's overflow skips the step on every rank
                bad = (~flags.all()).float()
                torch.distributed.all_reduce(
                    bad, op=torch.distributed.ReduceOp.MAX,
                    group=self.dp_group)
                finite = not bool(bad)    # the fp16 step's one host sync
            else:
                finite = bool(flags.all())    # the fp16 step's one host sync
        # the norm is taken only where the step uses it (engine.py:1544)
        self.global_grad_norm = None
        if cfg.fp16_enabled or cfg.gradient_clipping > 0:
            self.global_grad_norm = optim_lib.global_norm(grads)
        clip_coef = None
        if cfg.gradient_clipping > 0:
            clip_coef = optim_lib.clip_coefficient(self.global_grad_norm,
                                                   cfg.gradient_clipping)
            if not self.optimizer.fuses_clip:
                torch._foreach_mul_(list(grads.values()), clip_coef)
        self.scale = update_scale(
            self.scale, not finite, dynamic=self._dynamic_scale,
            scale_window=cfg.fp16.loss_scale_window,
            min_scale=cfg.fp16.min_loss_scale,
            delayed_shift=cfg.fp16.hysteresis)
        return grads, finite, clip_coef

    @torch.no_grad()
    def _apply_update(self, grads, clip_coef):
        """lr at the applied-step count, the optimizer update, p += u
        (engine.py:1602-1621). At ZeRO 1 the optimizer updates this rank's
        slices and the whole update is all-gathered (the epilogue
        all-gather of JAX's sharded update, partition.py:12-15) before
        every rank adds it to its masters."""
        lr = self._lr_fn(self.step_count)
        params = {k: p.detach() for k, p in self.params.items()}
        kw = {"clip_coef": clip_coef} if self.optimizer.fuses_clip else {}
        updates, self.opt_state = self.optimizer.update(
            self._local(grads), self.opt_state, self._local(params), lr,
            **kw)
        if self._sliced:
            updates = self._partition.all_gather(updates)
        torch._foreach_add_(list(params.values()),
                            [updates[k] for k in params])
        self.step_count += 1

    # ------------------------------------------------------------- loop
    def _dropout_key(self):
        """(seed, micro_steps), and the data-parallel rank when the world
        is above one rank: each rank draws its own masks for its rows."""
        key = (self._seed, self.micro_steps)
        if self.dp_world_size > 1:
            key += (self.dp_rank,)
        return key

    def forward(self, batch):
        """The loss of one micro-batch, unscaled, with its graph, in
        training mode; the dropout masks are keyed by (seed,
        ``micro_steps``) (engine.py:2757, 2770)."""
        if not self.module.training:
            self.module.train()
        batch = _to_device(batch, self.device)
        with dropout_lib.key_scope(self._dropout_key()):
            loss = self._compute_loss(batch)
        self._pending_loss = loss
        self._pending_weight = self._loss_weight(batch)
        return loss

    def backward(self, loss=None, allreduce_gradients=True,
                 release_loss=False):
        """The backward of ``loss`` (by default the last ``forward``'s)
        times loss_scale / gas; gradients accumulate in fp32 in each
        master's ``.grad``, or are cast into the bf16/fp16 buffer and added
        there (``a + g.astype(a.dtype)``), at every gas as in JAX, but in
        ``train_batch`` at gas 1. Advances ``micro_steps`` (engine.py:3022).
        With a process group the gradients are averaged over the data
        group: each micro-step's before the cast into the buffer, else
        the accumulated ones at ``step()``; the last ``forward``'s loss
        is weighted first by the rank's share of the global batch's terms
        (:meth:`_loss_weight`). ``allreduce_gradients=False`` skips that
        averaging (for this micro-step's buffer cast, or at the boundary
        ``step()`` after this call), as the reference's flag does;
        :meth:`allreduce_gradients` runs it by hand. ``release_loss`` is
        the reference's signature."""
        if loss is None:
            loss = self._pending_loss
        if loss is None:
            raise RuntimeError("backward() requires a prior forward()")
        weighted = loss
        if loss is self._pending_loss and self._pending_weight is not None:
            weighted = loss * self._pending_weight
        scale = self.scale.loss_scale / self.gradient_accumulation_steps()
        (weighted * scale).backward()
        self._reduce_grads = bool(allreduce_gradients)
        if self._acc_dtype is not None and not self._fused_gas1:
            with torch.no_grad():
                grads = {k: _grad_of(k, p) for k, p in self.params.items()}
                if self._dist and allreduce_gradients:
                    grads = self._average(grads)
                grads = {k: g.to(self._acc_dtype) for k, g in grads.items()}
                if self._acc is None:
                    self._acc = grads
                else:
                    torch._foreach_add_(list(self._acc.values()),
                                        [grads[k] for k in self._acc])
            for p in self.params.values():
                p.grad = None
        self._pending_loss = self._pending_weight = None
        self.micro_steps += 1
        return loss

    def step(self):
        """The optimizer step on the gradient-accumulation boundary, else
        nothing (engine.py:3071, 3096): unscale, the non-finite check, the
        norm and clip, the update (skipped after an fp16 overflow), MoQ,
        then the scheduler (which does not advance on a skipped step)."""
        if not self.is_gradient_accumulation_boundary():
            return
        # fp32 .grad is averaged here, unless the last backward said not
        # to; the buffer's micro-steps were averaged before their cast
        average_now = self._dist and self._acc is None and self._reduce_grads
        if self._acc is not None:
            # the buffer, read back in fp32 and reset (engine.py:1596-1600)
            for k, p in self.params.items():
                p.grad = self._acc[k].float()
            self._acc = None
        if all(p.grad is None for p in self.params.values()):
            raise RuntimeError("step() on the accumulation boundary needs "
                               "the gradients of backward()")
        grads = {k: _grad_of(k, p) for k, p in self.params.items()}
        if average_now:
            grads = self._average(grads)
        grads, finite, clip_coef = self._grad_epilogue(
            grads, per_rank=self._dist and not self._reduce_grads)
        if finite:
            self._apply_update(grads, clip_coef)
        self.global_steps += 1
        self.global_samples += self.config.train_batch_size
        if self.quantizer is not None:
            self.quantizer.quantize(self.params, overflow=not finite,
                                    transposed=self._transposed)
        if not finite:
            # the scheduler does not advance on a skipped step
            self.skipped_steps += 1
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step()
        for p in self.params.values():
            p.grad = None
        if self.global_steps % self.steps_per_print() == 0 \
                and self.global_grad_norm is not None:
            # the print cadence's one device fetch (engine.py:3161-3168)
            self._last_grad_norm = float(self.global_grad_norm)

    def train_batch(self, data_iter=None, batch=None):
        """One global step: ``forward`` and ``backward`` over ``gas``
        micro-batches (each from ``data_iter``, or ``batch`` every time),
        then ``step`` (engine.py:3316-3345). At gas 1 the gradients skip
        the ``gradient_accumulation_dtype`` buffer, as the JAX fused gas-1
        step does (engine.py:1702). Returns the mean micro-batch loss as a
        device fp32 scalar; over a data group each micro-batch's is the
        global micro-batch's (each rank passes its own rows)."""
        if data_iter is None and batch is None:
            raise ValueError("train_batch needs data_iter or batch")
        gas = self.gradient_accumulation_steps()
        losses = []
        self._fused_gas1 = gas == 1
        try:
            for _ in range(gas):
                micro = batch if batch is not None else next(data_iter)
                loss = self.forward(micro)
                weight = self._pending_weight
                self.backward(loss)
                losses.append((loss if weight is None
                               else loss * weight).detach())
            self.step()
        finally:
            self._fused_gas1 = False
        return self._mean_over_ranks(torch.stack(losses).mean())

    def eval_batch(self, batch):
        """The loss of ``batch`` without gradients or dropout, the module
        in eval mode for the call (engine.py:3401); over a data group the
        loss of the ranks' batches together."""
        was_training = self.module.training
        self.module.eval()
        try:
            with torch.no_grad(), dropout_lib.key_scope(None):
                batch = _to_device(batch, self.device)
                loss = self._compute_loss(batch)
                weight = self._loss_weight(batch)
                return self._mean_over_ranks(
                    loss if weight is None else loss * weight)
        finally:
            self.module.train(was_training)

    def __call__(self, batch):
        """``eval_batch``, as the JAX engine's ``__call__`` is
        (engine.py:3407); the training forward is :meth:`forward`."""
        return self.eval_batch(batch)

    # ------------------------------------------------------------ checkpoints
    # The JAX engine's tag format (runtime/engine.py:3628-4135): per tag
    # ``mp_rank_00_model_states.pt`` (the ``module`` tree and the counters,
    # rank 0), ``zero_pp_rank_{r}_mp_rank_00_optim_states.pt`` a rank (the
    # shards-v1 payloads of its part of the optimizer state and the fp32
    # masters, the loss-scale state), then ``manifest.json``, then the
    # ``latest`` pointer (rank 0, once every rank's file is there). A rank
    # writes its ZeRO-1 slices as index-keyed boxes; a tensor every rank
    # holds whole is written by rank 0. For a model family of
    # ``bridge.LAYOUTS`` the trees carry the JAX engine's key paths and
    # flax layouts, so either engine loads the other's tags, at any world
    # size.

    def _get_ckpt_name(self, checkpoints_path, tag):
        return os.path.join(checkpoints_path, str(tag),
                            "mp_rank_00" + MODEL_FILE_SUFFIX)

    def _get_zero_ckpt_name(self, checkpoints_path, tag, rank=None):
        rank = self.dp_rank if rank is None else rank
        return os.path.join(checkpoints_path, str(tag),
                            f"zero_pp_rank_{rank}_mp_rank_00"
                            + OPTIM_FILE_SUFFIX)

    def _path(self, name):
        """The JAX key path (``keystr``) of a parameter's leaf."""
        if self._layout is None:
            return bridge.keystr((name,))
        return bridge.keystr(self._layout[name][0])

    def _flax_view(self, name, t):
        """``t`` (a tensor shaped like parameter ``name``) in the saved
        layout: permuted to flax's for a model family, else as it is."""
        if self._layout is None:
            return t
        perm = bridge.inverse(self._layout[name][1])
        return t if perm is None else t.permute(perm)

    def _opt_items(self, state):
        """``(key path, parameter name or None, value)`` of every optimizer
        leaf, in the JAX tree's paths (``.step``,
        ``.mu['h_0']['ln_1']['scale']``, the sweep's ``.mu`` vector)."""
        if not hasattr(state, "_fields"):
            raise TypeError(f"cannot checkpoint optimizer state of type "
                            f"{type(state).__name__}: a NamedTuple of ints, "
                            f"tensors and dicts of tensors is expected")
        for field in state._fields:
            val = getattr(state, field)
            if isinstance(val, dict):
                for name, t in val.items():
                    yield f".{field}{self._path(name)}", name, t
            elif isinstance(val, (int, np.integer, torch.Tensor)):
                yield f".{field}", None, val
            elif val != ():
                raise TypeError(f"cannot checkpoint optimizer field "
                                f"{field} of type {type(val).__name__}")

    def _opt_leaves(self, state):
        """The key paths of the optimizer state's leaves."""
        return [path for path, _, _ in self._opt_items(state)]

    def _box(self, name, sliced=True):
        """The torch-layout index box of parameter ``name`` this rank
        writes, or None (another rank writes it): its ZeRO-1 slice, or
        the whole tensor on rank 0 (every tensor without a process
        group, or with ``sliced`` False: an optimizer state the rank
        keeps whole)."""
        part = self._partition
        if sliced and part is not None and part.sharded(name):
            return part.box(name)
        if self.dp_rank != 0:
            return None
        return tuple((0, int(d)) for d in self.params[name].shape)

    def _flax_record(self, name, t, box):
        """(``t`` in the saved layout, its box there, the whole leaf's
        saved shape)."""
        full = tuple(int(d) for d in self.params[name].shape)
        perm = (None if self._layout is None
                else bridge.inverse(self._layout[name][1]))
        if perm is None:
            return t, box, full
        return (t.permute(perm), tuple(box[a] for a in perm),
                tuple(full[a] for a in perm))

    def _sweep_full(self, vec):
        """A sweep moment as the whole vector in the saved (JAX) leaf
        order: gathered from every rank's chunk when the sweep is
        partitioned, then reordered for a model family."""
        if self._partition is not None and self.optimizer.partitions_state:
            with trace_span("checkpoint/gather_sweep"):
                vec = self._partition.gather_flat(vec)
        if self._layout is not None:
            vec = bridge.flat_to_jax(
                vec, self._layout, list(self.params),
                [tuple(p.shape) for p in self.params.values()])
        return vec

    def _restore_opt_state(self, arrays, saved_dp=1):
        """The optimizer state rebuilt like the current one from
        ``{key path: ndarray}`` (whole leaves, reassembled from every
        rank's boxes), on the engine's device: this rank's slices or
        chunk of it. ``saved_dp``: the world size that wrote them."""
        from deepspeed_tpu_torch.ops.adam.fused_adam import (AdamSweepState,
                                                             sweep_pad)
        state = self.opt_state
        sweep = isinstance(state, AdamSweepState)
        split = sweep and self.optimizer.partitions_state
        fields = {}
        for field in state._fields:
            val = getattr(state, field)
            if isinstance(val, (int, np.integer)):
                fields[field] = int(arrays[f".{field}"])
            elif isinstance(val, dict):
                fields[field] = self._local({
                    name: self._to_device(
                        arrays[f".{field}{self._path(name)}"], name,
                        self.params[name], self._perm(name)).to(t.dtype)
                    for name, t in val.items()})
            elif isinstance(val, torch.Tensor):
                vec = torch.from_numpy(np.require(
                    arrays[f".{field}"], requirements=["C", "W"])).to(
                        self.device)
                n_pad = val.numel() * (self.dp_world_size if split else 1)
                if sweep:
                    # the saved length is read, not recomputed; padding of
                    # a whole quantum more than the writer's world pads
                    # to is another model's leaves
                    n = sum(p.numel() for p in self.params.values())
                    q = sweep_pad() * max(1, int(saved_dp))
                    if vec.numel() >= -(-n // q) * q + q:
                        raise ValueError(
                            f"optimizer leaf .{field} holds {vec.numel()} "
                            f"elements, more than this model's sweep "
                            f"vector of {n} and its padding")
                    if self._layout is not None:
                        vec = bridge.flat_from_jax(
                            vec, self._layout, list(self.params),
                            [tuple(p.shape) for p in self.params.values()],
                            n_pad)
                    elif vec.numel() != n_pad and vec.numel() >= n:
                        # another world's padding
                        out = torch.zeros(n_pad, dtype=vec.dtype,
                                          device=vec.device)
                        out[:n] = vec[:n]
                        vec = out
                    if split:
                        vec = self._partition.chunk(vec).contiguous()
                if vec.shape != val.shape or vec.dtype != val.dtype:
                    raise ValueError(
                        f"optimizer leaf .{field} is {vec.dtype} "
                        f"{tuple(vec.shape)} in the checkpoint, "
                        f"{val.dtype} {tuple(val.shape)} in this engine")
                fields[field] = vec
            else:
                fields[field] = val
        return type(state)(**fields)

    def _to_device(self, arr, name, like, perm):
        """A saved leaf (flax layout) as a tensor like ``like`` (torch
        layout) on the engine's device, permuted there."""
        t = torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(
            self.device)
        if perm is not None:
            t = t.permute(perm)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf for {name} has shape "
                             f"{tuple(t.shape)}, the model's is "
                             f"{tuple(like.shape)}")
        # contiguous as the live state is: a permuted view would change
        # the order of LAMB's norm reductions, and with it the last bits
        return t.to(like.dtype).contiguous()

    def _host(self, key, t, copy):
        """A host numpy array of tensor ``t``. CUDA tensors go into a
        pinned buffer by a non-blocking copy (valid once the stream is
        synchronised; the buffers are reused by the next snapshot, which
        comes after the previous persist drained). CPU tensors: a
        contiguous array, copied when ``copy`` (a view would alias the
        masters, which the next step updates in place)."""
        t = t.detach()
        if t.device.type == "cuda":
            buf = self._pinned.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self._pinned[key] = buf
            buf.copy_(t, non_blocking=True)
            return buf.numpy()
        if copy:
            return t.clone(memory_format=torch.contiguous_format).numpy()
        return t.contiguous().numpy()

    def _snapshot_checkpoint(self, client_state, data_iter):
        """Device -> host copies of everything a save writes, and the
        model-states metadata. Under ``async_save`` the host arrays own
        their bytes (JAX engine.py:3743-3748): the masters are updated in
        place (``p += u``), so a view would pickle the next step's
        weights."""
        from deepspeed_tpu_torch.ops.adam.fused_adam import AdamSweepState
        copy = self._ckpt_async
        rank0 = self.dp_rank == 0
        part = self._partition
        with trace_span("checkpoint/gather_shards"):
            params, p_boxes = {}, {}
            for n, p in self.params.items():
                box = self._box(n)
                if box is None:
                    continue
                local = p if part is None else part.local(n, p)
                t, key, full = self._flax_record(n, local, box)
                params[self._path(n)] = self._host(("p", n), t, copy)
                p_boxes[self._path(n)] = (key, full)
            opt, o_boxes = {}, {}
            for path, name, val in self._opt_items(self.opt_state):
                if isinstance(val, (int, np.integer)):
                    opt[path] = np.asarray(val, np.int32)
                elif name is not None:
                    # a sliced state holds this rank's slices; else the
                    # whole tensors, which rank 0 writes
                    box = self._box(name, sliced=self._sliced)
                    if box is None:
                        continue
                    t, key, full = self._flax_record(name, val, box)
                    opt[path] = self._host(("o", path), t, copy)
                    o_boxes[path] = (key, full)
                elif isinstance(self.opt_state, AdamSweepState):
                    full = self._sweep_full(val)
                    n = full.numel()
                    if self.optimizer.partitions_state:
                        c = n // self.dp_world_size
                        r = self.dp_rank
                        opt[path] = self._host(("o", path),
                                               full[r * c:(r + 1) * c], copy)
                        o_boxes[path] = (((r * c, (r + 1) * c),), (n,))
                    elif rank0:
                        opt[path] = self._host(("o", path), full, copy)
                elif rank0:
                    opt[path] = self._host(("o", path), val, copy)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        zero_sd = {
            "format": "shards-v1",
            "optimizer_state_dict": checkpoint_io.tree_local_shards(
                opt, o_boxes),
            "offload_optimizer_state": None,
            "param_shards": checkpoint_io.tree_local_shards(params,
                                                            p_boxes),
            "scale_state": {
                "loss_scale": np.array(self.scale.loss_scale, np.float32),
                "good_steps": np.array(self.scale.good_steps, np.int32),
                "hysteresis": np.array(self.scale.hysteresis, np.int32)},
            "zero_stage": self.config.zero_optimization_stage,
            "partition_count": self.dp_world_size,
        }
        if not rank0:
            return {"zero_sd": zero_sd, "module": None, "meta": None}
        # the module tree: the whole masters (the param_shards arrays where
        # rank 0 wrote a whole tensor)
        by_path = {}
        for n, p in self.params.items():
            key, full = p_boxes[self._path(n)]
            by_path[n] = (params[self._path(n)]
                          if key == checkpoint_io.full_key(full)
                          else self._host(("m", n), self._flax_view(n, p),
                                          copy))
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        module = (bridge.nest((self._layout[n][0], a)
                              for n, a in by_path.items())
                  if self._layout is not None else by_path)
        it_state = None
        if data_iter is not None:
            sd_fn = getattr(data_iter, "state_dict", None)
            if sd_fn is not None:
                it_state = sd_fn()
            else:
                logger.warning(
                    "save_checkpoint(data_iter=...): the iterator has no "
                    "state_dict(); the data-stream position is NOT saved "
                    "(wrap the loader in RepeatingLoader for "
                    "deterministic resume)")
        from deepspeed_tpu_torch import __version__
        meta = {
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "skipped_steps": self.skipped_steps,
            "micro_steps": self.micro_steps,
            "dp_world_size": self.dp_world_size,
            "mp_world_size": 1,
            "loss_scale": float(self.scale.loss_scale),
            "lr_scheduler": (self.lr_scheduler.state_dict()
                             if self.lr_scheduler is not None
                             and hasattr(self.lr_scheduler, "state_dict")
                             else None),
            "data_iterator": it_state,
            "ds_config": self.config._param_dict,
            "ds_version": f"torch-{__version__}",
            "client_state": client_state or {},
        }
        return {"zero_sd": zero_sd, "module": module, "meta": meta}

    def _persist_checkpoint(self, save_dir, tag, snapshot, save_latest):
        """The file half of a save, host I/O only, no collective (safe on
        the background writer's thread). The order is the crash contract:
        each rank's shard file; then on rank 0 the model states, the gate
        on every rank's shard file (file polling), the purge of a larger
        world's stale rank files, the manifest, then ``latest``."""
        tag_dir = os.path.join(save_dir, tag)
        checkpoint_io.dump_file(snapshot["zero_sd"],
                                self._get_zero_ckpt_name(save_dir, tag),
                                kind="zero_states")
        meta = snapshot["meta"]
        if meta is None:             # not rank 0
            return
        world = self.dp_world_size
        sd = {"module": snapshot["module"], "has_moe_layers": False,
              "moe_layer_prefixes": [], "moe_expert_counts": [], **meta}
        checkpoint_io.dump_file(sd, self._get_ckpt_name(save_dir, tag),
                                kind="model_states")
        checkpoint_io.wait_for_files(
            [self._get_zero_ckpt_name(save_dir, tag, r)
             for r in range(world)],
            timeout_s=self.config.checkpoint_wait_timeout_s,
            describe=f"all {world} ranks' shard files of tag {tag!r}")
        for f in glob.glob(os.path.join(tag_dir,
                                        "zero_pp_rank_*" + OPTIM_FILE_SUFFIX)):
            m = re.search(r"zero_pp_rank_(\d+)_", os.path.basename(f))
            if m and int(m.group(1)) >= world:
                os.remove(f)
        checkpoint_io.write_manifest(tag_dir, meta={
            "tag": tag, "global_steps": meta["global_steps"],
            "dp_world_size": world, "processes": world})
        if save_latest:
            checkpoint_io.write_latest(save_dir, LATEST_FILE, tag)

    def _get_ckpt_writer(self):
        if self._ckpt_writer is None:
            from deepspeed_tpu_torch.runtime.async_checkpoint import \
                AsyncCheckpointWriter
            self._ckpt_writer = AsyncCheckpointWriter(
                retries=self.config.checkpoint_persist_retries,
                backoff_s=self.config.checkpoint_persist_backoff_s)
        return self._ckpt_writer

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True, data_iter=None):
        """Save the engine to ``save_dir/tag`` (default tag
        ``global_step{N}``), in two phases as in JAX (engine.py:3640):
        the snapshot copies the device state to the host at the step
        boundary; the persist writes the files. Under
        ``checkpoint.async_save`` the persist runs on a background writer
        while training goes on; the next save or load drains it, and a
        failure there re-raises. ``data_iter``: anything with
        ``state_dict()``, whose position is saved with the tag.

        Each rank writes its own shard file; rank 0 writes the model
        states, waits for every rank's file, then writes the manifest and
        ``latest``. A sync save ends with a barrier, so no rank returns
        before the tag is whole; an async save's next save or load drains
        the writer (a load then waits at a barrier for every rank's).

        Tag validation (``checkpoint.tag_validation``, JAX
        engine.py:3717-3740): under ``Warn`` and ``Fail`` the ranks compare
        the tag, ``[global_steps, micro_steps]`` and the masters' shapes
        (``all_gather_object``, over a process group of any size); a
        mismatch raises on every rank under ``Fail`` and logs once (rank
        0) under ``Warn``; ``Ignore`` compares nothing."""
        tag = str(f"global_step{self.global_steps}" if tag is None else tag)
        if self._ckpt_writer is not None:
            self._ckpt_writer.drain()
        self._validate_checkpoint_tag(tag)
        with trace_span("checkpoint/save", tag=tag):
            os.makedirs(os.path.join(save_dir, tag), exist_ok=True)
            snapshot = self._snapshot_checkpoint(client_state, data_iter)
        if not self._ckpt_async:
            with trace_span("checkpoint/persist", tag=tag):
                self._persist_checkpoint(save_dir, tag, snapshot,
                                         save_latest)
            if self._dist:
                torch.distributed.barrier(group=self.dp_group)
            log_dist(f"saved checkpoint {save_dir}/{tag}", ranks=[0])
            return True
        get_registry().counter(
            "checkpoint_async_saves_total",
            "async (snapshot-then-persist) saves started").inc()
        self._get_ckpt_writer().submit(
            lambda: self._persist_checkpoint(save_dir, tag, snapshot,
                                             save_latest), tag=tag)
        log_dist(f"checkpoint {save_dir}/{tag}: snapshot taken, persisting "
                 f"in background", ranks=[0])
        return True

    def _validate_checkpoint_tag(self, tag):
        """The cross-rank comparison of ``checkpoint.tag_validation``."""
        if not (self._dist and self.config.checkpoint_tag_validation_enabled):
            return
        mine = {"tag": str(tag),
                "counters": [self.global_steps, self.micro_steps],
                "shapes": {n: tuple(p.shape)
                           for n, p in self.params.items()}}
        seen = [None] * self.dp_world_size
        torch.distributed.all_gather_object(seen, mine, group=self.dp_group)
        what = {"tag": "checkpoint tag", "counters":
                "[global_steps, micro_steps]", "shapes": "parameter shapes"}
        bad = [(key, r, o[key]) for key in what for r, o in enumerate(seen)
               if o[key] != seen[0][key]]
        if not bad:
            return
        key, r, theirs = bad[0]
        msg = (f"cross-rank checkpoint mismatch: rank {r}'s {what[key]} "
               f"{theirs if key != 'shapes' else '(differ)'} differs from "
               f"rank 0's {seen[0][key] if key != 'shapes' else ''}")
        if self.config.checkpoint_tag_validation_fail:
            raise RuntimeError(msg + " (checkpoint.tag_validation: Fail)")
        if self.dp_rank == 0:
            logger.warning(msg + "; writing anyway (checkpoint."
                                 "tag_validation: Warn)")

    def _verify_load_tag(self, load_dir, tag, explicit_tag):
        """The tag to load (JAX engine.py:3900): an intact tag as it is, a
        tag without a manifest with a warning; a missing, empty or corrupt
        tag raises, unless it came from ``latest`` and
        ``checkpoint.fallback_to_intact`` finds the newest intact one."""
        tag_dir = os.path.join(load_dir, tag)
        status, detail = checkpoint_io.verify_tag(tag_dir)
        if status == "intact":
            return tag
        if status == "legacy":
            logger.warning(
                f"checkpoint tag {tag!r} at {tag_dir} has no completeness "
                f"manifest ({detail}); loading with per-file checks only")
            return tag
        source = ("requested" if explicit_tag
                  else "named by the 'latest' pointer")
        msg = (f"checkpoint tag {tag!r} ({source}) at {tag_dir} is not "
               f"loadable: {detail}")
        error = FileNotFoundError if status == "missing" else RuntimeError
        if explicit_tag or not self.config.checkpoint_fallback:
            raise error(msg)
        fallback = checkpoint_io.newest_intact_tag(load_dir, exclude=(tag,))
        if fallback is None:
            raise error(msg + "; no intact fallback tag exists under "
                        + str(load_dir))
        logger.warning(f"{msg}; falling back to the newest intact tag "
                       f"{fallback!r}")
        return fallback

    def _perm(self, name):
        return None if self._layout is None else self._layout[name][1]

    def _module_arrays(self, sd, zero_payloads, strict):
        """``{parameter name: ndarray in the saved layout}`` from the model
        states' ``module`` tree, or else from the shard files."""
        tree = sd.get("module")
        if tree is None:
            paths = {n: self._path(n) for n in self.params}
            merged = checkpoint_io.restore_tree(
                list(paths.values()),
                [z["param_shards"] for z in zero_payloads])
            return {n: merged[paths[n]] for n in self.params}
        if self._layout is None:
            named = dict(tree)
        else:
            named = {}
            for n, (path, _) in self._layout.items():
                try:
                    named[n] = bridge.get_path(tree, path)
                except (KeyError, TypeError):
                    if strict:
                        raise KeyError(
                            f"checkpoint module has no leaf "
                            f"{'/'.join(path)} for parameter {n}") from None
        missing = set(self.params) - set(named)
        extra = set(named) - set(self.params)
        if strict and (missing or extra):
            raise KeyError(f"checkpoint module does not match the model: "
                           f"missing {sorted(missing)[:4]}, unexpected "
                           f"{sorted(extra)[:4]}")
        return {n: a for n, a in named.items() if n in self.params}

    def _check_optimizer_kind(self, sd, path):
        """Refuse the moments of another optimizer (LAMB's into Adam has
        the same key paths; JAX would load them silently)."""
        family = {ADAMW_OPTIMIZER: ADAM_OPTIMIZER}
        saved = ((sd.get("ds_config") or {}).get("optimizer") or {}).get(
            "type")
        ours = self.config.optimizer_name
        if self.client_optimizer is not None or not saved or ours is None:
            return
        saved = saved.lower()
        if family.get(saved, saved) != family.get(ours, ours):
            raise ValueError(
                f"{path} holds the state of optimizer {saved!r}; this "
                f"engine runs {ours!r}, whose state it is not "
                f"(load_optimizer_states=False starts fresh moments)")

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False, data_iter=None):
        """Load a tag written by this engine or by the JAX engine
        (engine.py:3925-4100): the ``latest`` tag unless ``tag`` is given
        (verified, with the ``fallback_to_intact`` rule), the masters,
        and unless ``load_module_only`` the counters, the loss-scale
        state, the lr scheduler, the optimizer state (applied steps =
        ``global_steps - skipped_steps``) and the data iterator's
        position. Returns ``(model-states path, client_state)``, or
        ``(None, {})`` when there is no ``latest``. Any world size loads
        a tag of any other: each rank reassembles every leaf from all the
        rank files' index-keyed boxes (JAX's shard reassembly,
        engine.py:3965-3990), then keeps its own slices.

        A resumed run draws the uninterrupted run's dropout masks when the
        engine was built with the same ``seed`` (the seed is not saved,
        as in JAX). MoQ keeps no schedule state in the tag (neither does
        JAX's), so its bit width restarts from the config."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.drain()
        if self._dist:
            # every rank's async persist drained: the tag is whole
            torch.distributed.barrier(group=self.dp_group)
        explicit_tag = tag is not None
        if tag is None:
            latest = os.path.join(load_dir, LATEST_FILE)
            if not os.path.isfile(latest):
                logger.warning(f"no 'latest' file at {latest}; nothing "
                               f"loaded")
                return None, {}
            with open(latest) as f:
                tag = f.read().strip()
        tag = self._verify_load_tag(load_dir, str(tag), explicit_tag)
        path = self._get_ckpt_name(load_dir, tag)
        with trace_span("checkpoint/load", tag=tag):
            sd = checkpoint_io.load_file(path, kind="model_states")
            checkpoint_io.check_no_moe(sd, path)
            zero_payloads = [
                checkpoint_io.load_file(p, kind="zero_states")
                for p in sorted(glob.glob(os.path.join(
                    load_dir, tag, "zero_pp_rank_*" + OPTIM_FILE_SUFFIX)))]
            saved_dp = (zero_payloads[0].get("partition_count")
                        if zero_payloads else None)
            if saved_dp is not None and saved_dp != self.dp_world_size:
                # shards carry global indices: reassembly is elastic
                log_dist(f"elastic checkpoint load: saved at dp={saved_dp}, "
                         f"resuming at dp={self.dp_world_size} (shard "
                         f"reassembly)", ranks=[0])
            arrays = self._module_arrays(sd, zero_payloads,
                                         load_module_strict)
            if not load_module_only and load_optimizer_states and \
                    zero_payloads:
                self._check_optimizer_kind(sd, path)
                if zero_payloads[0].get("format") != "shards-v1":
                    raise NotImplementedError(
                        f"{path}: optimizer state in the pre-shards format "
                        f"is not ported")
                want = self._opt_leaves(self.opt_state)
                try:
                    opt_arrays = checkpoint_io.restore_tree(
                        want, [z["optimizer_state_dict"]
                               for z in zero_payloads])
                except KeyError as e:
                    raise KeyError(
                        f"{e.args[0]}: the tag's optimizer state does not "
                        f"match this engine's "
                        f"{type(self.opt_state).__name__}") from None
                opt_state = self._restore_opt_state(opt_arrays,
                                                    saved_dp or 1)
            with torch.no_grad():
                for n, a in arrays.items():
                    self.params[n].copy_(self._to_device(
                        a, n, self.params[n], self._perm(n)))
        client_state = sd.get("client_state", {})
        if not load_module_only:
            self.global_steps = sd.get("global_steps", 0)
            self.global_samples = sd.get("global_samples", 0)
            self.skipped_steps = sd.get("skipped_steps", 0)
            self.micro_steps = sd.get("micro_steps", 0)
            # applied steps index the lr (JAX's state.step)
            self.step_count = self.global_steps - self.skipped_steps
            self.scale = self.scale._replace(
                loss_scale=float(sd.get("loss_scale", 1.0)))
            if load_lr_scheduler_states and self.lr_scheduler is not None \
                    and sd.get("lr_scheduler") is not None:
                self.lr_scheduler.load_state_dict(sd["lr_scheduler"])
            if load_optimizer_states:
                if not zero_payloads:
                    logger.warning(
                        f"no zero_pp_rank files under {load_dir}/{tag}; "
                        f"resuming with FRESH optimizer state and loss "
                        f"scale")
                else:
                    self.opt_state = opt_state
                    ss = zero_payloads[0].get("scale_state")
                    if ss is not None:
                        self.scale = self.scale._replace(
                            loss_scale=float(ss["loss_scale"]),
                            good_steps=int(ss["good_steps"]),
                            hysteresis=int(ss["hysteresis"]))
            if data_iter is not None:
                it_state = sd.get("data_iterator")
                restore = getattr(data_iter, "load_state_dict", None)
                if it_state is None:
                    logger.warning(
                        "load_checkpoint(data_iter=...): the checkpoint "
                        "carries no data-iterator state (saved without "
                        "data_iter=); the stream is NOT rewound")
                elif restore is None:
                    logger.warning(
                        "load_checkpoint(data_iter=...): the iterator has "
                        "no load_state_dict(); the stream is NOT rewound")
                else:
                    restore(it_state)
        log_dist(f"loaded checkpoint {load_dir}/{tag}", ranks=[0])
        return path, client_state

    def save_16bit_model(self, save_dir, save_filename="pytorch_model.bin"):
        """One consolidated 16-bit weight file (JAX engine.py:4123): the
        masters cast to bf16 (to fp16 when the compute dtype is fp16),
        under their ``state_dict`` names, written with ``torch.save`` as
        the reference DeepSpeed writes ``pytorch_model.bin``: numpy has no
        bfloat16, and the JAX ``load_checkpoint_file`` reads this file
        (widening bf16)."""
        dtype = (torch.bfloat16 if self.compute_dtype == torch.float32
                 else self.compute_dtype)
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, save_filename)
        with trace_span("checkpoint/save_16bit_model"):
            sd = {n: p.detach().to(dtype).cpu()
                  for n, p in self.params.items()}

            def write(f):
                torch.save(sd, f)
            nbytes = checkpoint_io._atomic_write(path, write)
        get_registry().counter("checkpoint_write_bytes_total",
                               "bytes written by checkpoint saves",
                               labels={"kind": "bit16"}).inc(nbytes)
        return True

    def close(self):
        """Drain the async writer (a failed background save re-raises
        here, its last chance to surface) and release the pinned snapshot
        buffers. Idempotent."""
        try:
            if self._ckpt_writer is not None:
                self._ckpt_writer.close()
        finally:
            self._pinned = {}
