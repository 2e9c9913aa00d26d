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

ZeRO stages 0 and 1 at world size 1 are the same math: one rank's
partition is the whole optimizer state, as on the JAX package's
one-device mesh.

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

import torch
from torch.func import functional_call

from deepspeed_tpu_torch.runtime import dropout as dropout_lib
from deepspeed_tpu_torch.runtime import optim as optim_lib
from deepspeed_tpu_torch.runtime.config import (ADAGRAD_OPTIMIZER,
                                                LAMB_OPTIMIZER,
                                                SGD_OPTIMIZER,
                                                DeepSpeedConfig)
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (make_scale_state,
                                                          update_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime.quantize import (Quantizer,
                                                  transposed_weight_names)


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
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() and \
                dist.get_world_size() > 1:
            raise NotImplementedError(
                "ZeRO over torch.distributed is not ported yet")
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

        self.optimizer = self._configure_optimizer()
        self.opt_state = self.optimizer.init(
            {k: p.detach() for k, p in self.params.items()})
        self.lr_scheduler, self._lr_fn = self._configure_lr_scheduler()
        self.quantizer = self._configure_quantizer()
        self._transposed = transposed_weight_names(module)

        # the last step's norm as a device scalar (None when the step
        # takes none), and as a host float fetched at print cadence
        self.global_grad_norm = None
        self._last_grad_norm = None
        self._pending_loss = None
        self.step_count = 0      # applied optimizer steps (indexes the lr)
        self.global_steps = 0
        self.micro_steps = 0
        self.skipped_steps = 0

    # ------------------------------------------------------------- config
    def _configure_optimizer(self):
        """A client optimizer, or the one the config names
        (engine.py:922-1017): Adam/AdamW (``sweep`` -> the whole-state
        kernel, ``fused`` -> the per-tensor kernel, else plain torch), LAMB
        (``fused`` -> the one-launch pass-1 kernel, else plain torch), SGD
        and Adagrad (plain torch)."""
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
                      bias_correction=params.get("bias_correction", True))
            if cfg.optimizer_fused:
                return fused_lamb.fused_lamb(**kw)
            return optim_lib.lamb(**kw)
        kw = dict(b1=betas[0], b2=betas[1], eps=params.get("eps", 1e-8),
                  weight_decay=params.get("weight_decay", 0.0),
                  adam_w_mode=params.get("adam_w_mode", True),
                  bias_correction=params.get("bias_correction", True))
        if cfg.optimizer_sweep:
            return fused_adam.fused_adam_sweep(**kw)
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

    # ------------------------------------------------------------- step
    def _compute_loss(self, batch):
        """Forward in the compute dtype; the cast of each master is part of
        the graph, so its gradient arrives on the fp32 master."""
        cparams = {k: p.to(self.compute_dtype) for k, p in self.params.items()}
        return functional_call(self.module, cparams, (batch,)).float()

    def _grad_epilogue(self, grads):
        """unscale, non-finite check, norm, clip coefficient, scale update
        (engine.py:1555-1593). Returns (grads, finite, clip_coef);
        ``finite`` is a host bool (fp16: read from the device)."""
        cfg = self.config
        inv_scale = 1.0 / self.scale.loss_scale
        if inv_scale != 1.0:
            torch._foreach_mul_(list(grads.values()), inv_scale)
        finite = True
        if cfg.fp16_enabled:
            flags = torch.stack([torch.isfinite(g).all()
                                 for g in grads.values()])
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
        (engine.py:1602-1621)."""
        lr = self._lr_fn(self.step_count)
        params = {k: p.detach() for k, p in self.params.items()}
        if self.optimizer.fuses_clip:
            updates, self.opt_state = self.optimizer.update(
                grads, self.opt_state, params, lr, clip_coef=clip_coef)
        else:
            updates, self.opt_state = self.optimizer.update(
                grads, self.opt_state, params, lr)
        torch._foreach_add_(list(params.values()),
                            [updates[k] for k in params])
        self.step_count += 1

    # ------------------------------------------------------------- loop
    def forward(self, batch):
        """The loss of one micro-batch, unscaled, with its graph, in
        training mode; the dropout masks are keyed by (seed,
        ``micro_steps``) (engine.py:2757, 2770)."""
        if not self.module.training:
            self.module.train()
        with dropout_lib.key_scope((self._seed, self.micro_steps)):
            loss = self._compute_loss(_to_device(batch, self.device))
        self._pending_loss = loss
        return loss

    def backward(self, loss=None, allreduce_gradients=True,
                 release_loss=False):
        """The backward of ``loss`` (by default the last ``forward``'s)
        times loss_scale / gas; gradients accumulate in fp32 in each
        master's ``.grad``, or are cast into the bf16/fp16 buffer and added
        there (``a + g.astype(a.dtype)``), at every gas as in JAX, but in
        ``train_batch`` at gas 1. Advances ``micro_steps`` (engine.py:3022).
        The last two arguments are the reference's signature; one rank has
        no allreduce to skip."""
        if loss is None:
            loss = self._pending_loss
        if loss is None:
            raise RuntimeError("backward() requires a prior forward()")
        scale = self.scale.loss_scale / self.gradient_accumulation_steps()
        (loss * scale).backward()
        if self._acc_dtype is not None and not self._fused_gas1:
            with torch.no_grad():
                grads = {k: _grad_of(k, p).to(self._acc_dtype)
                         for k, p in self.params.items()}
                if self._acc is None:
                    self._acc = grads
                else:
                    torch._foreach_add_(list(self._acc.values()),
                                        [grads[k] for k in self._acc])
            for p in self.params.values():
                p.grad = None
        self._pending_loss = None
        self.micro_steps += 1
        return loss

    def step(self):
        """The optimizer step on the gradient-accumulation boundary, else
        nothing (engine.py:3071, 3096): unscale, the non-finite check, the
        norm and clip, the update (skipped after an fp16 overflow), MoQ,
        then the scheduler (which does not advance on a skipped step)."""
        if not self.is_gradient_accumulation_boundary():
            return
        if self._acc is not None:
            # the buffer, read back in fp32 and reset (engine.py:1596-1600)
            for k, p in self.params.items():
                p.grad = self._acc[k].float()
            self._acc = None
        if all(p.grad is None for p in self.params.values()):
            raise RuntimeError("step() on the accumulation boundary needs "
                               "the gradients of backward()")
        grads = {k: _grad_of(k, p) for k, p in self.params.items()}
        grads, finite, clip_coef = self._grad_epilogue(grads)
        if finite:
            self._apply_update(grads, clip_coef)
        self.global_steps += 1
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
        device fp32 scalar."""
        if data_iter is None and batch is None:
            raise ValueError("train_batch needs data_iter or batch")
        gas = self.gradient_accumulation_steps()
        losses = []
        self._fused_gas1 = gas == 1
        try:
            for _ in range(gas):
                micro = batch if batch is not None else next(data_iter)
                loss = self.forward(micro)
                self.backward(loss)
                losses.append(loss.detach())
            self.step()
        finally:
            self._fused_gas1 = False
        return torch.stack(losses).mean()

    def eval_batch(self, batch):
        """The loss of ``batch`` without gradients or dropout, the module
        in eval mode for the call (engine.py:3401)."""
        was_training = self.module.training
        self.module.eval()
        try:
            with torch.no_grad(), dropout_lib.key_scope(None):
                return self._compute_loss(_to_device(batch, self.device))
        finally:
            self.module.train(was_training)

    def __call__(self, batch):
        """``eval_batch``, as the JAX engine's ``__call__`` is
        (engine.py:3407); the training forward is :meth:`forward`."""
        return self.eval_batch(batch)
