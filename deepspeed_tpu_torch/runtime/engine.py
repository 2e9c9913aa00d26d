"""The training engine, main path (counterpart of
``deepspeed_tpu/runtime/engine.py``'s ``DeepSpeedEngine``).

One rank: fp32 master parameters (the module's own), the forward in the
compute dtype (bf16, fp16 or fp32) through ``torch.func.functional_call``
so the gradients land on the fp32 masters, gradient accumulation over
``gas`` micro-batches, then the epilogue and update of the JAX step in
the same order (engine.py:1555-1628): unscale, the non-finite check
(fp16 only), the global norm (fp16 or clipping only), the clip
coefficient, the loss-scale update, the optimizer update, ``p += u``.

ZeRO stages 0 and 1 at world size 1 are the same math: one rank's
partition is the whole optimizer state, as on the JAX package's
one-device mesh.

MoQ (``quantize_training``): after an applied step and before the lr
scheduler advances, the schedule of ``runtime/quantize.py`` fake-quantizes
the fp32 masters in place under ``no_grad`` (engine.py:3111-3130, where
the JAX engine replaces the params pytree); an fp16 step that overflowed
skips it.

Host syncs: bf16 and fp32 steps make none. An fp16 step makes one, to read
the overflow flag that decides whether the update is applied; this is the
port's counterpart of the JAX ``lax.cond`` (engine.py:1627), which keeps
that decision on the device.
"""

import torch
from torch.func import functional_call

from deepspeed_tpu_torch.runtime import optim as optim_lib
from deepspeed_tpu_torch.runtime.config import (LAMB_OPTIMIZER,
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


class DeepSpeedEngine:
    """``train_batch`` over a module whose ``forward(batch)`` returns the
    loss. ``module`` holds the fp32 master parameters on ``device``."""

    def __init__(self, module: torch.nn.Module, config: DeepSpeedConfig,
                 device: torch.device):
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() and \
                dist.get_world_size() > 1:
            raise NotImplementedError(
                "ZeRO over torch.distributed is not ported yet")
        self.module = module
        self.config = config
        self.device = device
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

        self.optimizer = self._configure_optimizer()
        self.opt_state = self.optimizer.init(
            {k: p.detach() for k, p in self.params.items()})
        self.lr_scheduler, self._lr_fn = self._configure_lr_scheduler()
        self.quantizer = self._configure_quantizer()
        self._transposed = transposed_weight_names(module)

        self.global_grad_norm = None   # device scalar of the last step
        self.step_count = 0      # applied optimizer steps (indexes the lr)
        self.global_steps = 0
        self.micro_steps = 0
        self.skipped_steps = 0

    # ------------------------------------------------------------- config
    def _configure_optimizer(self):
        """The optimizers the config lets through (engine.py:928-1009):
        Adam/AdamW (``sweep`` -> the whole-state kernel, ``fused`` -> the
        per-tensor kernel, else plain torch) and LAMB (``fused`` -> the
        one-launch pass-1 kernel, else plain torch)."""
        from deepspeed_tpu_torch.ops.adam import fused_adam
        from deepspeed_tpu_torch.ops.lamb import fused_lamb
        cfg = self.config
        params = dict(cfg.optimizer_params or {})
        betas = params.get("betas", (0.9, 0.999))
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
        base_lr = float((self.config.optimizer_params or {}).get("lr", 1e-3))
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

    def _micro_step(self, batch):
        """Forward + backward of one micro-batch; grads accumulate in fp32
        in each master's ``.grad``. Returns the unscaled loss."""
        gas = self.gradient_accumulation_steps()
        scale = self.scale.loss_scale / gas
        loss = self._compute_loss(_to_device(batch, self.device))
        sloss = loss * scale
        sloss.backward()
        self.micro_steps += 1
        return sloss.detach() * gas / self.scale.loss_scale

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

    def train_batch(self, data_iter=None, batch=None):
        """One global step: ``gas`` micro-batches (each from ``data_iter``,
        or ``batch`` every time), then the optimizer step. Returns the mean
        micro-batch loss as a device fp32 scalar."""
        if data_iter is None and batch is None:
            raise ValueError("train_batch needs data_iter or batch")
        for p in self.params.values():
            p.grad = None
        losses = []
        for _ in range(self.gradient_accumulation_steps()):
            micro = batch if batch is not None else next(data_iter)
            losses.append(self._micro_step(micro))
        grads = {k: p.grad for k, p in self.params.items()}
        missing = [k for k, g in grads.items() if g is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing[:3]}: the "
                               f"loss graph is cut")
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
        return torch.stack(losses).mean()
