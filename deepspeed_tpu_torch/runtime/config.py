"""The training config (counterpart of ``deepspeed_tpu/runtime/config.py``)
over the keys the port's training path reads: the batch triad, optimizer,
scheduler, fp16, bf16, gradient_clipping, zero_optimization.stage,
steps_per_print and the ``quantize_training`` (MoQ) block. The raw
``sparse_attention`` block is kept as it is given, as the JAX config keeps
it (the models read it through ``ops.sparse_attention.
sparse_attention_utils``). The attribute
names are the JAX ``DeepSpeedConfig``'s.

A key that turns on something the port does not run yet raises
``NotImplementedError`` naming it, as the JAX ``initialize`` fails loudly
on keys it does not implement; keys it does not know are ignored, as
there. Every ``enabled`` block the JAX config reads that changes the
step's math is either ported or in :data:`_UNPORTED_BLOCKS`; blocks that
only observe (tensorboard, flops_profiler) and blocks the JAX engine
never consumes (amp, autotuning) are ignored, as there.
"""

import json
import os

from deepspeed_tpu_torch.runtime import constants as C

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
DEEPSPEED_OPTIMIZERS = [ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER,
                        "onebitadam", "onebitlamb", "sgd", "adagrad"]
PORTED_OPTIMIZERS = (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER)

# (top-level block, what it enables): rejected when enabled
_UNPORTED_BLOCKS = (
    ("comm_overlap", "comm_overlap"),
    ("telemetry", "telemetry"),
    ("data_prefetch", "data_prefetch"),
    ("curriculum_learning", "curriculum learning"),
    ("progressive_layer_drop", "progressive layer drop"),
    ("moe", "MoE"),
    # eigenvalue-guided MoQ needs Hessian-vector products (a double
    # backward through the flash kernels, which have none)
    (C.EIGENVALUE, "eigenvalue-guided MoQ"),
    # rewrites the batch triad before triangulation (JAX config.py:1202)
    ("elasticity", "elasticity"),
    # rolls the train state back and rescues the fp16 scale
    ("guardian", "the guardian"),
)


class DeepSpeedConfigError(Exception):
    pass


def _not_ported(what):
    raise NotImplementedError(f"{what} is not ported yet")


class DeepSpeedFP16Config:
    def __init__(self, param_dict):
        fp16 = param_dict.get(C.FP16, {}) or {}
        self.enabled = fp16.get(C.FP16_ENABLED, C.FP16_ENABLED_DEFAULT)
        self.loss_scale = fp16.get(C.FP16_LOSS_SCALE, C.FP16_LOSS_SCALE_DEFAULT)
        self.initial_scale_power = fp16.get(
            C.FP16_INITIAL_SCALE_POWER, C.FP16_INITIAL_SCALE_POWER_DEFAULT)
        self.loss_scale_window = fp16.get(C.FP16_LOSS_SCALE_WINDOW,
                                          C.FP16_LOSS_SCALE_WINDOW_DEFAULT)
        self.hysteresis = fp16.get(C.FP16_HYSTERESIS, C.FP16_HYSTERESIS_DEFAULT)
        self.min_loss_scale = fp16.get(C.FP16_MIN_LOSS_SCALE,
                                       C.FP16_MIN_LOSS_SCALE_DEFAULT)

    @property
    def dynamic_loss_scale(self):
        return self.loss_scale == 0


class DeepSpeedQuantizeTrainingConfig:
    """The MoQ quantize-aware-training block (JAX config.py:1133-1158).
    ``schedule_offset`` and ``quantize_offset`` are parsed and, as in the
    JAX engine, never used."""

    def __init__(self, param_dict):
        qt = param_dict.get(C.QUANTIZE_TRAINING, {}) or {}
        self.enabled = qt.get(C.QUANTIZE_TRAINING_ENABLED,
                              C.QUANTIZE_TRAINING_ENABLED_DEFAULT)
        bits = qt.get(C.QUANTIZE_BITS, {}) or {}
        self.start_bits = bits.get(C.START_BITS, C.START_BITS_DEFAULT)
        self.target_bits = bits.get(C.TARGET_BITS, C.TARGET_BITS_DEFAULT)
        sched = qt.get(C.QUANTIZE_SCHEDULE, {}) or {}
        self.quantize_period = sched.get(C.QUANTIZE_PERIOD,
                                         C.QUANTIZE_PERIOD_DEFAULT)
        self.schedule_offset = sched.get(C.SCHEDULE_OFFSET,
                                         C.SCHEDULE_OFFSET_DEFAULT)
        self.quantize_groups = qt.get(C.QUANTIZE_GROUPS,
                                      C.QUANTIZE_GROUPS_DEFAULT)
        self.quantize_verbose = qt.get(C.QUANTIZE_VERBOSE,
                                       C.QUANTIZE_VERBOSE_DEFAULT)
        self.quantizer_kernel = qt.get(C.QUANTIZER_KERNEL,
                                       C.QUANTIZER_KERNEL_DEFAULT)
        self.quantize_change_ratio = qt.get(C.QUANTIZE_CHANGE_RATIO,
                                            C.QUANTIZE_CHANGE_RATIO_DEFAULT)
        self.quantize_type = qt.get(C.QUANTIZE_TYPE, C.QUANTIZE_SYMMETRIC)
        algo = qt.get(C.QUANTIZE_ALGO, {}) or {}
        self.rounding = algo.get(C.QUANTIZE_ROUNDING, "nearest")
        self.stochastic_rounding = self.rounding == "stochastic"
        mixed = qt.get(C.FP16_MIXED_QUANTIZE, {}) or {}
        self.fp16_mixed_quantize = mixed.get("enabled", False)
        self.quantize_offset = mixed.get(C.QUANTIZE_OFFSET,
                                         C.QUANTIZE_OFFSET_DEFAULT)


class DeepSpeedConfig:
    """Parsed training config for one rank (world size 1)."""

    def __init__(self, config):
        if isinstance(config, str):
            if not os.path.exists(config):
                raise DeepSpeedConfigError(
                    f"DeepSpeed config file not found: {config}")
            with open(config) as f:
                self._param_dict = json.load(f)
        elif isinstance(config, dict):
            self._param_dict = dict(config)
        else:
            raise DeepSpeedConfigError(
                f"Expected a path or dict for the DeepSpeed config, got "
                f"{type(config)}")
        self.world_size = 1
        self._initialize_params(self._param_dict)
        self._configure_train_batch_size()
        self._do_sanity_check()
        self._reject_unported(self._param_dict)

    def _initialize_params(self, pd):
        self.train_batch_size = pd.get(C.TRAIN_BATCH_SIZE,
                                       C.TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = pd.get(
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = pd.get(
            C.GRADIENT_ACCUMULATION_STEPS,
            C.GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self.steps_per_print = pd.get(C.STEPS_PER_PRINT,
                                      C.STEPS_PER_PRINT_DEFAULT)

        zero = pd.get(C.ZERO_OPTIMIZATION) or {}
        self.zero_optimization_stage = zero.get(C.ZERO_STAGE,
                                                C.ZERO_STAGE_DEFAULT)
        self.zero_enabled = self.zero_optimization_stage > 0

        self.fp16 = DeepSpeedFP16Config(pd)
        self.fp16_enabled = self.fp16.enabled
        bf = pd.get(C.BFLOAT16, pd.get(C.BFLOAT16_OLD, {})) or {}
        self.bfloat16_enabled = bf.get(C.BFLOAT16_ENABLED,
                                       C.BFLOAT16_ENABLED_DEFAULT)
        self.loss_scale = self.fp16.loss_scale
        self.initial_dynamic_scale = 2 ** self.fp16.initial_scale_power

        self.gradient_clipping = pd.get(C.GRADIENT_CLIPPING,
                                        C.GRADIENT_CLIPPING_DEFAULT)

        optimizer = pd.get(C.OPTIMIZER, {}) or {}
        self.optimizer_name = optimizer.get(C.TYPE, C.OPTIMIZER_TYPE_DEFAULT)
        if self.optimizer_name is not None and \
                self.optimizer_name.lower() in DEEPSPEED_OPTIMIZERS:
            self.optimizer_name = self.optimizer_name.lower()
        self.optimizer_params = optimizer.get(C.OPTIMIZER_PARAMS, None)
        params = self.optimizer_params or {}
        # the fused-kernel forms of Adam and LAMB
        # (engine._configure_optimizer)
        self.optimizer_fused = bool(params.get("fused", False))
        self.optimizer_sweep = bool(params.get("sweep", False))

        scheduler = pd.get(C.SCHEDULER, {}) or {}
        self.scheduler_name = scheduler.get(C.TYPE, C.SCHEDULER_TYPE_DEFAULT)
        self.scheduler_params = scheduler.get(C.SCHEDULER_PARAMS, None)

        self.quantize_training_config = DeepSpeedQuantizeTrainingConfig(pd)
        self.quantize_training_enabled = self.quantize_training_config.enabled
        ev = pd.get(C.EIGENVALUE, {}) or {}
        self.eigenvalue_enabled = ev.get(C.EIGENVALUE_ENABLED,
                                         C.EIGENVALUE_ENABLED_DEFAULT)
        self.sparse_attention = pd.get(C.SPARSE_ATTENTION, None)

    # -- batch triangulation (JAX config.py:1403-1450) -----------------------

    def _batch_assertion(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if train_batch <= 0:
            raise DeepSpeedConfigError(
                f"Train batch size: {train_batch} has to be greater than 0")
        if micro_batch <= 0:
            raise DeepSpeedConfigError(
                f"Micro batch size per gpu: {micro_batch} has to be greater "
                f"than 0")
        if grad_acc <= 0:
            raise DeepSpeedConfigError(
                f"Gradient accumulation steps: {grad_acc} has to be greater "
                f"than 0")
        if train_batch != micro_batch * grad_acc * self.world_size:
            raise DeepSpeedConfigError(
                f"Check batch related parameters. train_batch_size is not "
                f"equal to micro_batch_per_gpu * gradient_acc_step * "
                f"world_size {train_batch} != {micro_batch} * {grad_acc} * "
                f"{self.world_size}")

    def _set_batch_related_parameters(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if train_batch is not None and micro_batch is not None and \
                grad_acc is not None:
            pass
        elif train_batch is not None and micro_batch is not None:
            self.gradient_accumulation_steps = \
                train_batch // micro_batch // self.world_size
        elif train_batch is not None and grad_acc is not None:
            self.train_micro_batch_size_per_gpu = \
                train_batch // self.world_size // grad_acc
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * self.world_size
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = \
                train_batch // self.world_size
        elif micro_batch is not None:
            self.train_batch_size = micro_batch * self.world_size
            self.gradient_accumulation_steps = 1
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu "
                "needs to be provided")

    def _configure_train_batch_size(self):
        self._set_batch_related_parameters()
        self._batch_assertion()

    # -- checks -------------------------------------------------------------

    def _do_sanity_check(self):
        if self.fp16_enabled and self.bfloat16_enabled:
            raise DeepSpeedConfigError(
                "fp16 and bf16 modes are mutually exclusive")
        if self.optimizer_sweep and self.optimizer_name not in \
                (ADAM_OPTIMIZER, ADAMW_OPTIMIZER):
            raise ValueError(
                f"optimizer.params.sweep is the whole-state fused-Adam "
                f"path; it does not apply to optimizer "
                f"{self.optimizer_name!r}")

    def _reject_unported(self, pd):
        stage = self.zero_optimization_stage
        if stage not in (0, 1, 2, 3):
            raise DeepSpeedConfigError(f"invalid ZeRO stage {stage}")
        if stage >= 2:
            _not_ported(f"zero_optimization.stage={stage}")
        zero = pd.get(C.ZERO_OPTIMIZATION) or {}
        for key in ("offload_optimizer", "offload_param"):
            device = (zero.get(key) or {}).get("device")
            if device not in (None, "none"):
                _not_ported(f"zero_optimization.{key} (device={device!r})")
        for key in ("cpu_offload", "cpu_offload_params"):
            if zero.get(key):
                _not_ported(f"zero_optimization.{key}")
        if self.optimizer_name is not None and \
                self.optimizer_name not in PORTED_OPTIMIZERS:
            _not_ported(f"optimizer {self.optimizer_name!r}")
        if pd.get("pipeline") is not None:
            _not_ported("pipeline parallelism")
        if pd.get("sparse_gradients"):
            _not_ported("sparse_gradients")
        if self.eigenvalue_enabled and not self.quantize_training_enabled:
            # the JAX engine's check (engine.py:422-428) comes first
            raise ValueError(
                "eigenvalue.enabled=true has no consumer without "
                "quantize_training (MoQ): the curvature estimate only "
                "guides the quantization schedule — enable "
                "quantize_training or drop the eigenvalue block")
        for key, what in _UNPORTED_BLOCKS:
            if (pd.get(key) or {}).get("enabled"):
                _not_ported(f"{what} ({key}.enabled)")
