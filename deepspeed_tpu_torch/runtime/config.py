"""The training config (counterpart of ``deepspeed_tpu/runtime/config.py``)
over the keys the port's training path reads: the batch triad, optimizer,
scheduler, fp16, bf16, gradient_clipping, the ``zero_optimization``
block (``zero_config``, a ``runtime/zero/config.py``
``DeepSpeedZeroConfig``: the stage and the optimizer offload),
steps_per_print, gradient_accumulation_dtype, the ``checkpoint`` block
(read by the engine's saves and loads), the ``quantize_training``
(MoQ) block, the ``activation_checkpointing`` block (read by
``checkpointing.configure``) and the data path's ``data_prefetch``,
``dataloader_drop_last``, ``curriculum_learning`` and
``progressive_layer_drop`` (read by the engine's ``deepspeed_io`` and
``forward``). The raw
``sparse_attention`` block is kept as it is given, as the JAX config keeps
it (the models read it through ``ops.sparse_attention.
sparse_attention_utils``). The attribute
names are the JAX ``DeepSpeedConfig``'s.

A key that turns on something the port does not run yet raises
``NotImplementedError`` naming it, as the JAX ``initialize`` fails loudly
on keys it does not implement; keys it does not know are ignored, as
there. Every ``enabled`` block the JAX config reads that changes the
step's math, and the three observers the JAX engine acts on
(``tensorboard``, ``flops_profiler``, ``wall_clock_breakdown``), is
either ported or in :data:`_UNPORTED_BLOCKS`. The blocks the port does
not run (autotuning, comm_overlap, guardian, telemetry) are still
validated by the JAX validators' rules
(:data:`_RANGE_RULES`), so a config the JAX package refuses is refused
here too. The ``serving`` block is :class:`DeepSpeedServingConfig`, read
by ``init_serving``. The keys the JAX config refuses off-default (``amp.enabled``,
``prescale_gradients``, ``gradient_predivide_factor`` != 1,
``disable_allgather``, ``communication_data_type``,
``optimizer.legacy_fusion``, ``fp16.fp16_master_weights_and_grads``, a
``gradient_accumulation_dtype`` outside fp32|bf16|fp16) raise the same
``DeepSpeedConfigError`` (JAX config.py:1464-1509).
"""

import json
import os

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
SGD_OPTIMIZER = "sgd"
ADAGRAD_OPTIMIZER = "adagrad"
DEEPSPEED_OPTIMIZERS = [ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER,
                        "onebitadam", "onebitlamb", SGD_OPTIMIZER,
                        ADAGRAD_OPTIMIZER]
PORTED_OPTIMIZERS = (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER,
                     SGD_OPTIMIZER, ADAGRAD_OPTIMIZER)

# (top-level block, what it enables): rejected when enabled
_UNPORTED_BLOCKS = (
    ("comm_overlap", "comm_overlap"),
    ("telemetry", "telemetry"),
    # eigenvalue-guided MoQ needs Hessian-vector products (a double
    # backward through the flash kernels, which have none)
    (C.EIGENVALUE, "eigenvalue-guided MoQ"),
    # rewrites the batch triad before triangulation (JAX config.py:1202)
    ("elasticity", "elasticity"),
    # rolls the train state back and rescues the fp16 scale
    ("guardian", "the guardian"),
    # observers the JAX engine acts on (runtime/engine.py:795-826)
    (C.TENSORBOARD, "the TensorBoard/CSV monitor"),
    (C.FLOPS_PROFILER, "the flops profiler"),
)


def _positive(v):
    return v > 0


def _non_negative(v):
    return v >= 0


def _at_least(n):
    return lambda v: v >= n


def _unit_interval(v):
    return 0.0 < v <= 1.0


def _open_unit_interval(v):
    return 0.0 < v < 1.0


def _autotuning_space(v):
    return v is None or (isinstance(v, dict) and all(
        isinstance(x, list) and x for x in v.values()))


# The JAX validators of the blocks the port parses but does not run
# (JAX runtime/config.py: telemetry :419-565, comm_overlap :613,
# guardian :690-717, autotuning :1028-1058): (block path, key, default,
# cast, valid, what a valid value is, environment override or None).
# Each raises
# DeepSpeedConfigError on the value the JAX config refuses, whether or
# not the block is enabled.
_RANGE_RULES = (
    (("comm_overlap",), "bucket_mb", 4.0, float, _positive, "> 0", None),
    (("guardian",), "action_cooldown_steps", 25, int, _non_negative,
     ">= 0", "DS_GUARDIAN_COOLDOWN_STEPS"),
    (("guardian",), "divergence_streak", 2, int, _at_least(1), ">= 1",
     None),
    (("guardian",), "divergence_window", 50, int, _at_least(1), ">= 1",
     None),
    (("guardian",), "max_rollbacks", 2, int, _non_negative, ">= 0",
     "DS_GUARDIAN_MAX_ROLLBACKS"),
    (("guardian",), "rollback_cooldown_steps", 200, int, _at_least(1),
     ">= 1", None),
    (("guardian",), "resume_clear_steps", 64, int, _at_least(1), ">= 1",
     None),
    (("autotuning",), "metric", "goodput", str,
     lambda v: v in ("goodput", "step_time"), "'goodput' or 'step_time'",
     None),
    (("autotuning",), "top_k", 3, int, _at_least(1), ">= 1",
     "DS_AUTOTUNING_TOP_K"),
    (("autotuning",), "probe_steps", 8, int, _at_least(1), ">= 1", None),
    (("autotuning",), "probe_warmup_steps", 2, int, _non_negative,
     ">= 0", None),
    (("autotuning",), "memory_headroom", 0.95, float, _unit_interval,
     "in (0, 1]", None),
    (("autotuning",), "hbm_budget_gb", 0.0, float, _non_negative,
     ">= 0 (0 = detect)", None),
    (("autotuning",), "space", None, None, _autotuning_space,
     "a map of each dimension name to a non-empty list", None),
    (("telemetry", "anatomy"), "capture_steps", 3, int, _at_least(1),
     ">= 1", None),
    (("telemetry", "anatomy"), "keep_raw_traces", 2, int, _non_negative,
     ">= 0", None),
    (("telemetry", "fleet"), "cadence", 0, int, _non_negative, ">= 0",
     None),
    (("telemetry", "fleet"), "desync_cadence", 0, int, _non_negative,
     ">= 0", None),
    (("telemetry", "fleet"), "step_time_skew_frac", 0.25, float,
     _unit_interval, "in (0, 1]", None),
    (("telemetry", "fleet"), "input_wait_skew_frac", 0.25, float,
     _unit_interval, "in (0, 1]", None),
    (("telemetry", "fleet"), "checkpoint_skew_frac", 0.5, float,
     _unit_interval, "in (0, 1]", None),
    (("telemetry", "fleet"), "window_ring", 128, int, _at_least(1),
     ">= 1", None),
    (("telemetry", "memory"), "cadence", 0, int, _non_negative, ">= 0",
     None),
    (("telemetry", "memory"), "leak_windows", 4, int, _at_least(2),
     ">= 2", None),
    (("telemetry", "memory"), "warmup_windows", 2, int, _non_negative,
     ">= 0", None),
    (("telemetry", "memory"), "drift_threshold", 0.25, float, _positive,
     "> 0", None),
    (("telemetry", "memory"), "frag_threshold", 0.5, float,
     _unit_interval, "in (0, 1]", None),
    (("telemetry", "memory"), "headroom", 0.92, float, _unit_interval,
     "in (0, 1]", None),
    (("telemetry", "memory"), "budget_bytes", 0, int, _non_negative,
     ">= 0", None),
    (("telemetry", "memory"), "ring_size", 64, int, _at_least(1), ">= 1",
     None),
    (("telemetry", "chronicle"), "max_events", 16384, int, _at_least(1),
     ">= 1", None),
    (("telemetry", "chronicle"), "step_window", 8, int, _non_negative,
     ">= 0", None),
    (("telemetry", "chronicle"), "time_window_s", 30.0, float, _positive,
     "> 0", None),
    (("telemetry", "server"), "port", 0, int, lambda v: 0 <= v <= 65535,
     "in [0, 65535]", None),
    (("telemetry", "server"), "events_tail", 256, int, _at_least(1),
     ">= 1", None),
    (("telemetry", "slo"), "fast_window_s", 300.0, float, _positive,
     "> 0", None),
    (("telemetry", "slo"), "burn_threshold", 1.0, float, _positive, "> 0",
     None),
    (("telemetry", "slo"), "eval_interval_s", 10.0, float, _positive,
     "> 0", None),
    (("telemetry", "slo"), "goodput_target", 0.90, float,
     _open_unit_interval, "in (0, 1)", None),
    (("telemetry", "slo"), "ttft_target", 0.99, float,
     _open_unit_interval, "in (0, 1)", None),
    (("telemetry", "slo"), "e2e_target", 0.99, float, _open_unit_interval,
     "in (0, 1)", None),
    (("telemetry", "slo"), "ttft_threshold_ms", 500.0, float, _positive,
     "> 0", None),
    (("telemetry", "slo"), "e2e_threshold_ms", 5000.0, float, _positive,
     "> 0", None),
    (("telemetry", "federation"), "aggregator", "auto", str,
     lambda v: v in ("auto", "always", "never"),
     "one of auto/always/never", None),
    (("telemetry", "federation"), "scrape_interval_s", 2.0, float,
     _positive, "> 0", None),
    (("telemetry", "federation"), "timeout_s", 2.0, float, _positive,
     "> 0", None),
    (("telemetry", "federation"), "stale_after_s", 10.0, float, _positive,
     "> 0", None),
    (("telemetry", "federation"), "events_ring", 4096, int, _at_least(16),
     ">= 16", None),
    (("telemetry", "federation"), "goodput_target", 0.90, float,
     _open_unit_interval, "in (0, 1)", None),
    (("telemetry", "federation"), "ttft_target", 0.99, float,
     _open_unit_interval, "in (0, 1)", None),
    (("telemetry", "federation"), "peers", (), tuple,
     lambda v: all(isinstance(p, str) and p.startswith("http") for p in v),
     "http base urls", None),
)


def _block(pd, path):
    node = pd
    for key in path:
        node = node.get(key, {}) or {}
    return node


def _check_ranges(pd):
    """Apply :data:`_RANGE_RULES` (and the SLO window order) to ``pd``."""
    for path, key, default, cast, valid, what, env in _RANGE_RULES:
        value = _block(pd, path).get(key, default)
        if env is not None and os.environ.get(env):
            value = os.environ[env]
        if cast is not None:
            value = cast(value or ()) if cast is tuple else cast(value)
        if not valid(value):
            raise DeepSpeedConfigError(
                f"{'.'.join(path)}.{key} must be {what}, got {value!r}")
    slo = _block(pd, ("telemetry", "slo"))
    fast = float(slo.get("fast_window_s", 300.0))
    slow = float(slo.get("slow_window_s", 3600.0))
    if not 0.0 < fast < slow:
        raise DeepSpeedConfigError(
            f"telemetry.slo windows must satisfy 0 < fast_window_s < "
            f"slow_window_s, got {fast} / {slow}")


class DeepSpeedConfigError(Exception):
    pass


def _not_ported(what):
    raise NotImplementedError(f"{what} is not ported yet")


def _env_flag(name, current):
    """``current`` unless the environment variable ``name`` is set, then
    whether it reads as true (1/true/yes/on)."""
    env = os.environ.get(name)
    if env is None:
        return current
    return env.lower() in ("1", "true", "yes", "on")


class DeepSpeedServingObservabilityConfig:
    """``serving.observability`` (JAX config.py:719-795): the serving
    observatory (telemetry/serving_observatory.py) — per-request
    timelines and per-slot trace lanes, the slot-step ledger and the
    windowed SLO rules escalating to ``snapshot_file``.
    ``DS_SERVING_OBS`` = 1/0 force-toggles ``enabled``."""

    def __init__(self, serving_dict):
        o = serving_dict.get(C.SERVING_OBSERVABILITY, {}) or {}
        self.enabled = _env_flag("DS_SERVING_OBS", o.get(
            C.SERVING_OBS_ENABLED, C.SERVING_OBS_ENABLED_DEFAULT))
        self.window = int(o.get(C.SERVING_OBS_WINDOW,
                                C.SERVING_OBS_WINDOW_DEFAULT))
        self.warmup_windows = int(o.get(C.SERVING_OBS_WARMUP,
                                        C.SERVING_OBS_WARMUP_DEFAULT))
        self.ttft_slo_ms = float(o.get(C.SERVING_OBS_TTFT_SLO_MS,
                                       C.SERVING_OBS_TTFT_SLO_MS_DEFAULT))
        self.ttft_breach_frac = float(
            o.get(C.SERVING_OBS_TTFT_BREACH_FRAC,
                  C.SERVING_OBS_TTFT_BREACH_FRAC_DEFAULT))
        self.queue_growth_windows = int(
            o.get(C.SERVING_OBS_QUEUE_GROWTH_WINDOWS,
                  C.SERVING_OBS_QUEUE_GROWTH_WINDOWS_DEFAULT))
        self.preemption_thrash = int(
            o.get(C.SERVING_OBS_PREEMPTION_THRASH,
                  C.SERVING_OBS_PREEMPTION_THRASH_DEFAULT))
        self.no_progress_steps = int(
            o.get(C.SERVING_OBS_NO_PROGRESS_STEPS,
                  C.SERVING_OBS_NO_PROGRESS_STEPS_DEFAULT))
        self.timeline_ring = int(o.get(C.SERVING_OBS_TIMELINE_RING,
                                       C.SERVING_OBS_TIMELINE_RING_DEFAULT))
        self.window_ring = int(o.get(C.SERVING_OBS_WINDOW_RING,
                                     C.SERVING_OBS_WINDOW_RING_DEFAULT))
        self.trace_lanes = o.get(C.SERVING_OBS_TRACE_LANES,
                                 C.SERVING_OBS_TRACE_LANES_DEFAULT)
        self.snapshot_file = o.get(C.SERVING_OBS_SNAPSHOT_FILE,
                                   C.SERVING_OBS_SNAPSHOT_FILE_DEFAULT)
        for name, ok, what in (
                ("window", self.window >= 1, ">= 1"),
                ("warmup_windows", self.warmup_windows >= 0, ">= 0"),
                ("ttft_breach_frac", 0.0 < self.ttft_breach_frac <= 1.0,
                 "in (0, 1]"),
                ("no_progress_steps", self.no_progress_steps >= 1, ">= 1"),
                ("queue_growth_windows", self.queue_growth_windows >= 1,
                 ">= 1"),
                # every window has >= 0 preemptions: a 0 threshold would
                # fire the thrash rule on every window
                ("preemption_thrash", self.preemption_thrash >= 1,
                 ">= 1 (disable rules with enabled=false)"),
                ("ttft_slo_ms", self.ttft_slo_ms > 0, "> 0")):
            if not ok:
                raise DeepSpeedConfigError(
                    f"serving.observability.{name} must be {what}, got "
                    f"{getattr(self, name)}")


class DeepSpeedServingPrefixCacheConfig:
    """``serving.prefix_cache`` (JAX config.py:798-823): the
    content-addressed LRU index of FULL KV blocks, mapped read-only at
    admission with copy-on-write forks. ``capacity_blocks`` 0 leaves it
    uncapped (still bounded by the pool). ``DS_SERVING_PREFIX_CACHE`` =
    1/0 force-toggles ``enabled``."""

    def __init__(self, serving_dict):
        p = serving_dict.get(C.SERVING_PREFIX_CACHE, {}) or {}
        self.enabled = _env_flag("DS_SERVING_PREFIX_CACHE", p.get(
            C.SERVING_PREFIX_ENABLED, C.SERVING_PREFIX_ENABLED_DEFAULT))
        self.capacity_blocks = int(
            p.get(C.SERVING_PREFIX_CAPACITY_BLOCKS,
                  C.SERVING_PREFIX_CAPACITY_BLOCKS_DEFAULT))
        if self.capacity_blocks < 0:
            raise DeepSpeedConfigError(
                f"serving.prefix_cache.capacity_blocks must be >= 0 "
                f"(0 = uncapped), got {self.capacity_blocks}")


class DeepSpeedServingSpeculativeConfig:
    """``serving.speculative`` (JAX config.py:826-885): draft/verify
    speculative decoding. ``draft_layers`` 0 picks ``n_layer // 4``
    (floor 1); ``draft_model`` null means the truncated-layer self-draft
    (an explicit draft is passed as ``draft_params``). ``acceptance``
    "exact" keeps outputs equal to the non-speculative engine's.
    ``DS_SERVING_SPEC`` = 1/0 force-toggles ``enabled``."""

    def __init__(self, serving_dict):
        sp = serving_dict.get(C.SERVING_SPECULATIVE, {}) or {}
        self.enabled = _env_flag("DS_SERVING_SPEC", sp.get(
            C.SERVING_SPEC_ENABLED, C.SERVING_SPEC_ENABLED_DEFAULT))
        self.k = int(sp.get(C.SERVING_SPEC_K, C.SERVING_SPEC_K_DEFAULT))
        self.draft_layers = int(sp.get(C.SERVING_SPEC_DRAFT_LAYERS,
                                       C.SERVING_SPEC_DRAFT_LAYERS_DEFAULT))
        self.draft_model = sp.get(C.SERVING_SPEC_DRAFT_MODEL,
                                  C.SERVING_SPEC_DRAFT_MODEL_DEFAULT)
        self.acceptance = sp.get(C.SERVING_SPEC_ACCEPTANCE,
                                 C.SERVING_SPEC_ACCEPTANCE_DEFAULT)
        self.typical_threshold = float(
            sp.get(C.SERVING_SPEC_TYPICAL_THRESHOLD,
                   C.SERVING_SPEC_TYPICAL_THRESHOLD_DEFAULT))
        self.acceptance_floor = float(
            sp.get(C.SERVING_SPEC_ACCEPTANCE_FLOOR,
                   C.SERVING_SPEC_ACCEPTANCE_FLOOR_DEFAULT))
        if self.k < 1:
            raise DeepSpeedConfigError(
                f"serving.speculative.k must be >= 1, got {self.k}")
        if self.draft_layers < 0:
            raise DeepSpeedConfigError(
                f"serving.speculative.draft_layers must be >= 0 "
                f"(0 = auto), got {self.draft_layers}")
        if self.acceptance not in ("exact", "typical"):
            raise DeepSpeedConfigError(
                f"serving.speculative.acceptance must be 'exact' or "
                f"'typical', got {self.acceptance!r}")
        if not 0.0 < self.typical_threshold <= 1.0:
            raise DeepSpeedConfigError(
                f"serving.speculative.typical_threshold must be in "
                f"(0, 1], got {self.typical_threshold}")
        if not 0.0 <= self.acceptance_floor <= 1.0:
            raise DeepSpeedConfigError(
                f"serving.speculative.acceptance_floor must be in "
                f"[0, 1], got {self.acceptance_floor}")
        if self.draft_model is not None and not isinstance(
                self.draft_model, str):
            raise DeepSpeedConfigError(
                f"serving.speculative.draft_model must be null "
                f"(self-draft) or a string tag, got "
                f"{type(self.draft_model).__name__}")


class DeepSpeedServingRouterConfig:
    """``serving.router`` (JAX config.py:888-921): the scoring weights of
    ``ServingRouter`` (serving/router.py) over per-replica signals and
    prefix affinity. ``breach_penalty`` dominates the load terms, so a
    breaching replica only receives work when every replica breaches.
    ``replicas`` is validated only: the caller builds the replicas and
    hands them to ``ServingRouter``."""

    def __init__(self, serving_dict):
        r = serving_dict.get(C.SERVING_ROUTER, {}) or {}
        self.replicas = int(r.get(C.SERVING_ROUTER_REPLICAS,
                                  C.SERVING_ROUTER_REPLICAS_DEFAULT))
        self.affinity_weight = float(
            r.get(C.SERVING_ROUTER_AFFINITY_WEIGHT,
                  C.SERVING_ROUTER_AFFINITY_WEIGHT_DEFAULT))
        self.queue_weight = float(
            r.get(C.SERVING_ROUTER_QUEUE_WEIGHT,
                  C.SERVING_ROUTER_QUEUE_WEIGHT_DEFAULT))
        self.occupancy_weight = float(
            r.get(C.SERVING_ROUTER_OCCUPANCY_WEIGHT,
                  C.SERVING_ROUTER_OCCUPANCY_WEIGHT_DEFAULT))
        self.breach_penalty = float(
            r.get(C.SERVING_ROUTER_BREACH_PENALTY,
                  C.SERVING_ROUTER_BREACH_PENALTY_DEFAULT))
        if self.replicas < 1:
            raise DeepSpeedConfigError(
                f"serving.router.replicas must be >= 1, got "
                f"{self.replicas}")
        for name in ("affinity_weight", "queue_weight",
                     "occupancy_weight", "breach_penalty"):
            if getattr(self, name) < 0:
                raise DeepSpeedConfigError(
                    f"serving.router.{name} must be >= 0, got "
                    f"{getattr(self, name)}")


class DeepSpeedServingConfig:
    """``serving`` block (JAX config.py:924-981): the continuous-batching
    server over a paged KV cache. ``num_blocks`` 0 auto-sizes the pool so
    the full batch at full length fits; ``max_model_len`` 0 defers to the
    model's ``n_positions``. ``DS_SERVING_MAX_BATCH`` /
    ``DS_SERVING_BLOCK_SIZE`` / ``DS_SERVING_PREFILL_CHUNK`` override
    their keys."""

    def __init__(self, param_dict):
        s = param_dict.get(C.SERVING, {}) or {}
        self.block_size = int(s.get(C.SERVING_BLOCK_SIZE,
                                    C.SERVING_BLOCK_SIZE_DEFAULT))
        self.num_blocks = int(s.get(C.SERVING_NUM_BLOCKS,
                                    C.SERVING_NUM_BLOCKS_DEFAULT))
        self.max_batch = int(s.get(C.SERVING_MAX_BATCH,
                                   C.SERVING_MAX_BATCH_DEFAULT))
        self.prefill_chunk = int(s.get(C.SERVING_PREFILL_CHUNK,
                                       C.SERVING_PREFILL_CHUNK_DEFAULT))
        self.max_model_len = int(s.get(C.SERVING_MAX_MODEL_LEN,
                                       C.SERVING_MAX_MODEL_LEN_DEFAULT))
        self.attention_impl = s.get(C.SERVING_ATTENTION_IMPL,
                                    C.SERVING_ATTENTION_IMPL_DEFAULT)
        self.decode_steps = int(s.get(C.SERVING_DECODE_STEPS,
                                      C.SERVING_DECODE_STEPS_DEFAULT))
        self.observability = DeepSpeedServingObservabilityConfig(s)
        self.prefix_cache = DeepSpeedServingPrefixCacheConfig(s)
        self.router = DeepSpeedServingRouterConfig(s)
        self.speculative = DeepSpeedServingSpeculativeConfig(s)
        for env, attr in (("DS_SERVING_MAX_BATCH", "max_batch"),
                          ("DS_SERVING_BLOCK_SIZE", "block_size"),
                          ("DS_SERVING_PREFILL_CHUNK", "prefill_chunk")):
            val = os.environ.get(env)
            if val is not None:
                setattr(self, attr, int(val))
        if self.block_size < 1:
            raise DeepSpeedConfigError(
                f"serving.block_size must be >= 1, got {self.block_size}")
        if self.max_batch < 1:
            raise DeepSpeedConfigError(
                f"serving.max_batch must be >= 1, got {self.max_batch}")
        if self.prefill_chunk < 1:
            raise DeepSpeedConfigError(
                f"serving.prefill_chunk must be >= 1, got "
                f"{self.prefill_chunk}")
        if self.num_blocks < 0 or self.num_blocks == 1:
            raise DeepSpeedConfigError(
                f"serving.num_blocks must be 0 (auto) or >= 2 (1 usable "
                f"+ the reserved null block), got {self.num_blocks}")
        if self.attention_impl not in ("paged", "gather"):
            raise DeepSpeedConfigError(
                f"serving.attention_impl must be 'paged' or 'gather', "
                f"got {self.attention_impl!r}")
        if self.decode_steps < 1:
            raise DeepSpeedConfigError(
                f"serving.decode_steps must be >= 1, got "
                f"{self.decode_steps}")


class DeepSpeedDataPrefetchConfig:
    """``data_prefetch`` (JAX config.py:566-588; ``runtime/prefetch.py``):
    the background input pipeline, host collate workers and the
    copy-stream device stage. ``DS_DATA_PREFETCH`` = 1/0 force-toggles
    ``enabled`` after the JSON is read."""

    def __init__(self, param_dict):
        p = param_dict.get(C.DATA_PREFETCH, {}) or {}
        self.enabled = p.get(C.DATA_PREFETCH_ENABLED,
                             C.DATA_PREFETCH_ENABLED_DEFAULT)
        self.depth = int(p.get(C.DATA_PREFETCH_DEPTH,
                               C.DATA_PREFETCH_DEPTH_DEFAULT))
        self.to_device = p.get(C.DATA_PREFETCH_TO_DEVICE,
                               C.DATA_PREFETCH_TO_DEVICE_DEFAULT)
        self.enabled = _env_flag("DS_DATA_PREFETCH", self.enabled)
        if self.depth < 1:
            raise DeepSpeedConfigError(
                f"data_prefetch.depth must be >= 1, got {self.depth}")


class DeepSpeedPLDConfig:
    """``progressive_layer_drop`` (JAX config.py:1118-1123)."""

    def __init__(self, param_dict):
        pld = param_dict.get(C.PROGRESSIVE_LAYER_DROP, {}) or {}
        self.enabled = pld.get(C.PLD_ENABLED, C.PLD_ENABLED_DEFAULT)
        self.theta = pld.get(C.PLD_THETA, C.PLD_THETA_DEFAULT)
        self.gamma = pld.get(C.PLD_GAMMA, C.PLD_GAMMA_DEFAULT)


class DeepSpeedCurriculumConfig:
    """``curriculum_learning`` (JAX config.py:1126-1131): ``params`` is
    the block without ``enabled``, the ``CurriculumScheduler``'s
    config."""

    def __init__(self, param_dict):
        cl = param_dict.get(C.CURRICULUM_LEARNING, {}) or {}
        self.enabled = cl.get(C.CURRICULUM_ENABLED,
                              C.CURRICULUM_ENABLED_DEFAULT)
        self.params = {k: v for k, v in cl.items()
                       if k != C.CURRICULUM_ENABLED}


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
        self.master_weights_and_grads = fp16.get(
            C.FP16_MASTER_WEIGHTS_AND_GRADS,
            C.FP16_MASTER_WEIGHTS_AND_GRADS_DEFAULT)

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


class DeepSpeedActivationCheckpointingConfig:
    """The ``activation_checkpointing`` block (JAX config.py:1075), read
    by ``checkpointing.configure(deepspeed_config=...)``."""

    def __init__(self, param_dict):
        ac = param_dict.get(C.ACTIVATION_CHECKPOINTING, {}) or {}
        self.partition_activations = ac.get(
            C.ACT_CHKPT_PARTITION_ACTIVATIONS,
            C.ACT_CHKPT_PARTITION_ACTIVATIONS_DEFAULT)
        self.number_checkpoints = ac.get(
            C.ACT_CHKPT_NUMBER_CHECKPOINTS,
            C.ACT_CHKPT_NUMBER_CHECKPOINTS_DEFAULT)
        self.contiguous_memory_optimization = ac.get(
            C.ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION,
            C.ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT)
        self.synchronize_checkpoint_boundary = ac.get(
            C.ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY,
            C.ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT)
        self.profile = ac.get(C.ACT_CHKPT_PROFILE, C.ACT_CHKPT_PROFILE_DEFAULT)
        self.cpu_checkpointing = ac.get(C.ACT_CHKPT_CPU_CHECKPOINTING,
                                        C.ACT_CHKPT_CPU_CHECKPOINTING_DEFAULT)


class DeepSpeedConfig:
    """Parsed training config. ``world_size`` is the data-parallel world:
    ``data_parallel_size`` when given (as the JAX config takes it from the
    engine's mesh), else the data group's (``utils.groups``; 1 without a
    process group). The batch triad holds over it."""

    def __init__(self, config, data_parallel_size=None):
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
        if data_parallel_size is None:
            from deepspeed_tpu_torch.utils import groups
            data_parallel_size = groups.get_data_parallel_world_size()
        self.world_size = int(data_parallel_size)
        self._initialize_params(self._param_dict)
        self._configure_train_batch_size()
        self._do_sanity_check()
        _check_ranges(self._param_dict)
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

        try:
            self.zero_config = DeepSpeedZeroConfig.from_dict(pd)
        except AssertionError as e:
            raise DeepSpeedConfigError(str(e)) from None
        self.zero_optimization_stage = self.zero_config.stage
        self.zero_enabled = self.zero_optimization_stage > 0

        self.fp16 = DeepSpeedFP16Config(pd)
        self.fp16_enabled = self.fp16.enabled
        bf = pd.get(C.BFLOAT16, pd.get(C.BFLOAT16_OLD, {})) or {}
        self.bfloat16_enabled = bf.get(C.BFLOAT16_ENABLED,
                                       C.BFLOAT16_ENABLED_DEFAULT)
        self.fp16_master_weights_and_gradients = \
            self.fp16.master_weights_and_grads
        self.amp_enabled = (pd.get(C.AMP, {}) or {}).get(C.AMP_ENABLED,
                                                         C.AMP_ENABLED_DEFAULT)
        self.loss_scale = self.fp16.loss_scale
        self.initial_dynamic_scale = 2 ** self.fp16.initial_scale_power
        self.disable_allgather = pd.get(C.DISABLE_ALLGATHER,
                                        C.DISABLE_ALLGATHER_DEFAULT)
        self.communication_data_type = pd.get(
            C.COMMUNICATION_DATA_TYPE, C.COMMUNICATION_DATA_TYPE_DEFAULT)
        self.prescale_gradients = pd.get(C.PRESCALE_GRADIENTS,
                                         C.PRESCALE_GRADIENTS_DEFAULT)
        self.gradient_predivide_factor = pd.get(
            C.GRADIENT_PREDIVIDE_FACTOR, C.GRADIENT_PREDIVIDE_FACTOR_DEFAULT)
        self.gradient_accumulation_dtype = pd.get(
            C.GRADIENT_ACCUMULATION_FORMAT, None)

        self.gradient_clipping = pd.get(C.GRADIENT_CLIPPING,
                                        C.GRADIENT_CLIPPING_DEFAULT)

        optimizer = pd.get(C.OPTIMIZER, {}) or {}
        self.optimizer_name = optimizer.get(C.TYPE, C.OPTIMIZER_TYPE_DEFAULT)
        if self.optimizer_name is not None and \
                self.optimizer_name.lower() in DEEPSPEED_OPTIMIZERS:
            self.optimizer_name = self.optimizer_name.lower()
        self.optimizer_params = optimizer.get(C.OPTIMIZER_PARAMS, None)
        self.optimizer_legacy_fusion = optimizer.get(C.LEGACY_FUSION,
                                                     C.LEGACY_FUSION_DEFAULT)
        params = self.optimizer_params or {}
        # the fused-kernel forms of Adam and LAMB
        # (engine._configure_optimizer)
        self.optimizer_fused = bool(params.get("fused", False))
        self.optimizer_sweep = bool(params.get("sweep", False))

        scheduler = pd.get(C.SCHEDULER, {}) or {}
        self.scheduler_name = scheduler.get(C.TYPE, C.SCHEDULER_TYPE_DEFAULT)
        self.scheduler_params = scheduler.get(C.SCHEDULER_PARAMS, None)

        self.activation_checkpointing_config = \
            DeepSpeedActivationCheckpointingConfig(pd)
        self.quantize_training_config = DeepSpeedQuantizeTrainingConfig(pd)
        self.quantize_training_enabled = self.quantize_training_config.enabled
        ev = pd.get(C.EIGENVALUE, {}) or {}
        self.eigenvalue_enabled = ev.get(C.EIGENVALUE_ENABLED,
                                         C.EIGENVALUE_ENABLED_DEFAULT)
        self.sparse_attention = pd.get(C.SPARSE_ATTENTION, None)
        self.pld_config = DeepSpeedPLDConfig(pd)
        self.pld_enabled = self.pld_config.enabled
        self.curriculum_config = DeepSpeedCurriculumConfig(pd)
        self.curriculum_enabled = self.curriculum_config.enabled
        self.dataloader_drop_last = pd.get(C.DATALOADER_DROP_LAST, None)
        self.data_prefetch = DeepSpeedDataPrefetchConfig(pd)
        self._read_checkpoint(pd)
        self.wall_clock_breakdown = pd.get(C.WALL_CLOCK_BREAKDOWN, False)
        self.serving = DeepSpeedServingConfig(pd)

    def _read_checkpoint(self, pd):
        """The ``checkpoint`` block with the JAX defaults, attribute names,
        environment overrides and errors (JAX config.py:1340-1382). The
        engine's save compares the tag across ranks under ``Warn`` and
        ``Fail``."""
        ckpt = pd.get(C.CHECKPOINT, {}) or {}
        self.checkpoint_tag_validation_mode = ckpt.get(
            C.CHECKPOINT_TAG_VALIDATION, C.CHECKPOINT_TAG_VALIDATION_DEFAULT)
        self.checkpoint_tag_validation_enabled = \
            self.checkpoint_tag_validation_mode != "Ignore"
        self.checkpoint_tag_validation_fail = \
            self.checkpoint_tag_validation_mode == "Fail"
        self.load_universal_checkpoint = ckpt.get(
            C.LOAD_UNIVERSAL_CHECKPOINT, C.LOAD_UNIVERSAL_CHECKPOINT_DEFAULT)
        self.checkpoint_async_save = _env_flag(
            "DS_CHECKPOINT_ASYNC_SAVE", bool(ckpt.get(
                C.CHECKPOINT_ASYNC_SAVE, C.CHECKPOINT_ASYNC_SAVE_DEFAULT)))
        self.checkpoint_fallback = _env_flag(
            "DS_CHECKPOINT_FALLBACK", bool(ckpt.get(
                C.CHECKPOINT_FALLBACK, C.CHECKPOINT_FALLBACK_DEFAULT)))
        self.checkpoint_wait_timeout_s = float(ckpt.get(
            C.CHECKPOINT_WAIT_TIMEOUT, C.CHECKPOINT_WAIT_TIMEOUT_DEFAULT))
        self.checkpoint_persist_retries = int(os.environ.get(
            "DS_CHECKPOINT_PERSIST_RETRIES", ckpt.get(
                C.CHECKPOINT_PERSIST_RETRIES,
                C.CHECKPOINT_PERSIST_RETRIES_DEFAULT)))
        self.checkpoint_persist_backoff_s = float(ckpt.get(
            C.CHECKPOINT_PERSIST_BACKOFF_S,
            C.CHECKPOINT_PERSIST_BACKOFF_S_DEFAULT))
        for key, value, ok, what in (
                (C.CHECKPOINT_WAIT_TIMEOUT, self.checkpoint_wait_timeout_s,
                 self.checkpoint_wait_timeout_s > 0, "> 0"),
                (C.CHECKPOINT_PERSIST_RETRIES,
                 self.checkpoint_persist_retries,
                 self.checkpoint_persist_retries >= 0, ">= 0"),
                (C.CHECKPOINT_PERSIST_BACKOFF_S,
                 self.checkpoint_persist_backoff_s,
                 self.checkpoint_persist_backoff_s >= 0, ">= 0")):
            if not ok:
                raise DeepSpeedConfigError(
                    f"checkpoint.{key} must be {what}, got {value}")

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
        # the keys the JAX config refuses off-default (config.py:1464-1509),
        # with its conditions: their reference mechanism has no counterpart
        # in the step, so they are refused rather than silently parsed
        if self.fp16_master_weights_and_gradients:
            raise DeepSpeedConfigError(
                "fp16_master_weights_and_grads: the masters stay fp32 — "
                "remove the key")
        if self.amp_enabled:
            raise DeepSpeedConfigError(
                "amp.enabled: apex AMP is not supported; use the native "
                "mixed-precision blocks, bf16 {enabled: true} or fp16 "
                "{enabled: true}")
        if self.prescale_gradients or self.gradient_predivide_factor != 1.0:
            raise DeepSpeedConfigError(
                "prescale_gradients/gradient_predivide_factor rescale "
                "gradients around the allreduce; the engine's is a plain "
                "fp32 mean, as the JAX config requires — remove the key "
                "(fp16 overflow is handled by the dynamic loss scaler)")
        if self.disable_allgather:
            raise DeepSpeedConfigError(
                "disable_allgather selects the ZeRO-1 update's collective; "
                "the engine always all-gathers the updates, as the JAX "
                "config requires — remove the key")
        if self.communication_data_type is not None:
            raise DeepSpeedConfigError(
                "communication_data_type casts gradients for the "
                "allreduce; the engine reduces them in fp32, as the JAX "
                "config requires — remove the key")
        if self.optimizer_legacy_fusion:
            raise DeepSpeedConfigError(
                "optimizer.legacy_fusion toggles a kernel-fusion fallback "
                "the optimizers do not have — remove the key")
        if self.gradient_accumulation_dtype not in (
                None, "fp32", "bf16", "fp16"):
            raise DeepSpeedConfigError(
                "data_types.grad_accum_dtype must be one of "
                "fp32|bf16|fp16, got "
                f"{self.gradient_accumulation_dtype!r}")
        if self.optimizer_sweep and self.optimizer_name not in \
                (ADAM_OPTIMIZER, ADAMW_OPTIMIZER):
            raise ValueError(
                f"optimizer.params.sweep is the whole-state fused-Adam "
                f"path; it does not apply to optimizer "
                f"{self.optimizer_name!r}")

    def _reject_unported(self, pd):
        device = self.zero_config.offload_optimizer.device
        if device not in (None, "none", "cpu", "nvme"):
            raise DeepSpeedConfigError(
                f"zero_optimization.offload_optimizer.device must be one of "
                f"none|cpu|nvme, got {device!r}")
        # parameter offload (offload_param, or the deprecated
        # cpu_offload_params at stage 3) is the layered engine, which
        # initialize() routes to before it parses a config (JAX
        # deepspeed_tpu/__init__.py:84-155); the monolithic engine refuses
        # it (runtime/engine.py)
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
        if self.wall_clock_breakdown:
            _not_ported("wall_clock_breakdown (the breakdown timers)")
