"""Config keys and defaults the port's training path reads (a subset of
``deepspeed_tpu/runtime/constants.py``, same names and values)."""

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

OPTIMIZER = "optimizer"
OPTIMIZER_TYPE_DEFAULT = None
OPTIMIZER_PARAMS = "params"
TYPE = "type"
LEGACY_FUSION = "legacy_fusion"
LEGACY_FUSION_DEFAULT = False

SCHEDULER = "scheduler"
SCHEDULER_TYPE_DEFAULT = None
SCHEDULER_PARAMS = "params"

FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 32
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1
FP16_MASTER_WEIGHTS_AND_GRADS = "fp16_master_weights_and_grads"
FP16_MASTER_WEIGHTS_AND_GRADS_DEFAULT = False

BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"
BFLOAT16_ENABLED = "enabled"
BFLOAT16_ENABLED_DEFAULT = False

AMP = "amp"
AMP_ENABLED = "enabled"
AMP_ENABLED_DEFAULT = False

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0
PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0
COMMUNICATION_DATA_TYPE = "communication_data_type"
COMMUNICATION_DATA_TYPE_DEFAULT = None
DISABLE_ALLGATHER = "disable_allgather"
DISABLE_ALLGATHER_DEFAULT = False
# the accumulator of gas > 1 micro-batches: fp32 (default), bf16 or fp16
GRADIENT_ACCUMULATION_FORMAT = "gradient_accumulation_dtype"

ZERO_OPTIMIZATION = "zero_optimization"
ZERO_STAGE = "stage"
ZERO_STAGE_DEFAULT = 0

# Eigenvalue (MoQ curvature guidance)
EIGENVALUE = "eigenvalue"
EIGENVALUE_ENABLED = "enabled"
EIGENVALUE_ENABLED_DEFAULT = False
EIGENVALUE_VERBOSE = "verbose"
EIGENVALUE_VERBOSE_DEFAULT = False
EIGENVALUE_MAX_ITER = "max_iter"
EIGENVALUE_MAX_ITER_DEFAULT = 100
EIGENVALUE_TOL = "tol"
EIGENVALUE_TOL_DEFAULT = 1e-2
EIGENVALUE_STABILITY = "stability"
EIGENVALUE_STABILITY_DEFAULT = 1e-6
EIGENVALUE_GAS_BOUNDARY_RESOLUTION = "gas_boundary_resolution"
EIGENVALUE_GAS_BOUNDARY_RESOLUTION_DEFAULT = 1
EIGENVALUE_LAYER_NAME = "layer_name"
EIGENVALUE_LAYER_NAME_DEFAULT = "bert.encoder.layer"
EIGENVALUE_LAYER_NUM = "layer_num"
EIGENVALUE_LAYER_NUM_DEFAULT = 0

# Activation checkpointing (remat)
ACTIVATION_CHECKPOINTING = "activation_checkpointing"
ACT_CHKPT_PARTITION_ACTIVATIONS = "partition_activations"
ACT_CHKPT_PARTITION_ACTIVATIONS_DEFAULT = False
ACT_CHKPT_NUMBER_CHECKPOINTS = "number_checkpoints"
ACT_CHKPT_NUMBER_CHECKPOINTS_DEFAULT = None
ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION = "contiguous_memory_optimization"
ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT = False
ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY = "synchronize_checkpoint_boundary"
ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT = False
ACT_CHKPT_PROFILE = "profile"
ACT_CHKPT_PROFILE_DEFAULT = False
ACT_CHKPT_CPU_CHECKPOINTING = "cpu_checkpointing"
ACT_CHKPT_CPU_CHECKPOINTING_DEFAULT = False

# Quantize-aware training (MoQ)
QUANTIZE_TRAINING = "quantize_training"
QUANTIZE_TRAINING_ENABLED = "enabled"
QUANTIZE_TRAINING_ENABLED_DEFAULT = False
QUANTIZE_BITS = "quantize_bits"
START_BITS = "start_bits"
START_BITS_DEFAULT = 16
TARGET_BITS = "target_bits"
TARGET_BITS_DEFAULT = 8
QUANTIZER_KERNEL = "quantizer_kernel"
QUANTIZER_KERNEL_DEFAULT = False
QUANTIZE_SCHEDULE = "quantize_schedule"
QUANTIZE_PERIOD = "quantize_period"
QUANTIZE_PERIOD_DEFAULT = 1000
SCHEDULE_OFFSET = "schedule_offset"
SCHEDULE_OFFSET_DEFAULT = 1000
QUANTIZE_GROUPS = "quantize_groups"
QUANTIZE_GROUPS_DEFAULT = 1
QUANTIZE_CHANGE_RATIO = "quantize_change_ratio"
QUANTIZE_CHANGE_RATIO_DEFAULT = 0.001
QUANTIZE_TYPE = "quantize_type"
QUANTIZE_SYMMETRIC = "symmetric"
QUANTIZE_ASYMMETRIC = "asymmetric"
STOCHASTIC_ROUNDING = "stochastic_rounding"
STOCHASTIC_ROUNDING_DEFAULT = False
QUANTIZE_VERBOSE = "quantize_verbose"
QUANTIZE_VERBOSE_DEFAULT = False
QUANTIZE_ALGO = "quantize_algo"
QUANTIZE_ROUNDING = "rounding"
FP16_MIXED_QUANTIZE = "fp16_mixed_quantize"
QUANTIZE_OFFSET = "quantize_offset"
QUANTIZE_OFFSET_DEFAULT = 1000

# block-sparse attention (kept raw, as the JAX config keeps it)
SPARSE_ATTENTION = "sparse_attention"

# observer blocks the JAX engine acts on (TensorBoard/CSV events, the
# flops profiler, the breakdown timers); refused until they are ported
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
TENSORBOARD = "tensorboard"
FLOPS_PROFILER = "flops_profiler"

# serving: continuous-batching inference server (serving/). Paged KV
# cache of `block_size`-token blocks (`num_blocks` 0 -> sized so
# `max_batch` full-length sequences fit, i.e. preemption-free), a
# `max_batch`-slot static decode batch, `prefill_chunk`-token chunked
# prefill, and `max_model_len` (0 -> the model's n_positions) as the
# per-request position cap.
SERVING = "serving"
SERVING_BLOCK_SIZE = "block_size"
SERVING_BLOCK_SIZE_DEFAULT = 16
SERVING_NUM_BLOCKS = "num_blocks"
SERVING_NUM_BLOCKS_DEFAULT = 0
SERVING_MAX_BATCH = "max_batch"
SERVING_MAX_BATCH_DEFAULT = 8
SERVING_PREFILL_CHUNK = "prefill_chunk"
SERVING_PREFILL_CHUNK_DEFAULT = 32
SERVING_MAX_MODEL_LEN = "max_model_len"
SERVING_MAX_MODEL_LEN_DEFAULT = 0
# "paged" attends over the LIVE KV blocks (serving/paged_attention.py);
# "gather" materialises the block table into the contiguous view the
# decode kernel reads (ops/transformer/decode.py)
SERVING_ATTENTION_IMPL = "attention_impl"
SERVING_ATTENTION_IMPL_DEFAULT = "paged"
# tokens decoded per dispatch (>1 amortises the host dispatch and the
# one device sync over K tokens)
SERVING_DECODE_STEPS = "decode_steps"
SERVING_DECODE_STEPS_DEFAULT = 1

# serving.speculative: draft/verify speculative decoding
# (serving/speculative.py); DS_SERVING_SPEC=1/0 force-toggles `enabled`
SERVING_SPECULATIVE = "speculative"
SERVING_SPEC_ENABLED = "enabled"
SERVING_SPEC_ENABLED_DEFAULT = False
SERVING_SPEC_K = "k"                        # drafted tokens per dispatch
SERVING_SPEC_K_DEFAULT = 4
SERVING_SPEC_DRAFT_LAYERS = "draft_layers"  # 0 -> n_layer // 4 (min 1)
SERVING_SPEC_DRAFT_LAYERS_DEFAULT = 0
SERVING_SPEC_DRAFT_MODEL = "draft_model"    # null -> self-draft
SERVING_SPEC_DRAFT_MODEL_DEFAULT = None
SERVING_SPEC_ACCEPTANCE = "acceptance"      # "exact" | "typical"
SERVING_SPEC_ACCEPTANCE_DEFAULT = "exact"
SERVING_SPEC_TYPICAL_THRESHOLD = "typical_threshold"
SERVING_SPEC_TYPICAL_THRESHOLD_DEFAULT = 0.3
SERVING_SPEC_ACCEPTANCE_FLOOR = "acceptance_floor"
SERVING_SPEC_ACCEPTANCE_FLOOR_DEFAULT = 0.35

# serving.prefix_cache: block-level shared-prefix KV reuse
# (serving/kv_cache.py PrefixCache); DS_SERVING_PREFIX_CACHE=1/0
# force-toggles `enabled`
SERVING_PREFIX_CACHE = "prefix_cache"
SERVING_PREFIX_ENABLED = "enabled"
SERVING_PREFIX_ENABLED_DEFAULT = False
SERVING_PREFIX_CAPACITY_BLOCKS = "capacity_blocks"
SERVING_PREFIX_CAPACITY_BLOCKS_DEFAULT = 0

# serving.router: multi-replica admission (not ported yet: replicas > 1
# raises)
SERVING_ROUTER = "router"
SERVING_ROUTER_REPLICAS = "replicas"
SERVING_ROUTER_REPLICAS_DEFAULT = 1
SERVING_ROUTER_AFFINITY_WEIGHT = "affinity_weight"
SERVING_ROUTER_AFFINITY_WEIGHT_DEFAULT = 4.0
SERVING_ROUTER_QUEUE_WEIGHT = "queue_weight"
SERVING_ROUTER_QUEUE_WEIGHT_DEFAULT = 1.0
SERVING_ROUTER_OCCUPANCY_WEIGHT = "occupancy_weight"
SERVING_ROUTER_OCCUPANCY_WEIGHT_DEFAULT = 2.0
SERVING_ROUTER_BREACH_PENALTY = "breach_penalty"
SERVING_ROUTER_BREACH_PENALTY_DEFAULT = 100.0

# serving.observability: the serving observatory (not ported yet:
# enabled raises); DS_SERVING_OBS=1/0 force-toggles `enabled`
SERVING_OBSERVABILITY = "observability"
SERVING_OBS_ENABLED = "enabled"
SERVING_OBS_ENABLED_DEFAULT = False
SERVING_OBS_WINDOW = "window"               # scheduler steps per window
SERVING_OBS_WINDOW_DEFAULT = 32
SERVING_OBS_WARMUP = "warmup_windows"       # windows before rules arm
SERVING_OBS_WARMUP_DEFAULT = 1
SERVING_OBS_TTFT_SLO_MS = "ttft_slo_ms"
SERVING_OBS_TTFT_SLO_MS_DEFAULT = 1000.0
SERVING_OBS_TTFT_BREACH_FRAC = "ttft_breach_frac"
SERVING_OBS_TTFT_BREACH_FRAC_DEFAULT = 0.5
SERVING_OBS_QUEUE_GROWTH_WINDOWS = "queue_growth_windows"
SERVING_OBS_QUEUE_GROWTH_WINDOWS_DEFAULT = 3
SERVING_OBS_PREEMPTION_THRASH = "preemption_thrash"  # per window
SERVING_OBS_PREEMPTION_THRASH_DEFAULT = 8
SERVING_OBS_NO_PROGRESS_STEPS = "no_progress_steps"
SERVING_OBS_NO_PROGRESS_STEPS_DEFAULT = 200
SERVING_OBS_TIMELINE_RING = "timeline_ring"  # finished timelines kept
SERVING_OBS_TIMELINE_RING_DEFAULT = 64
SERVING_OBS_WINDOW_RING = "window_ring"
SERVING_OBS_WINDOW_RING_DEFAULT = 128
SERVING_OBS_TRACE_LANES = "trace_lanes"     # per-slot Chrome lanes
SERVING_OBS_TRACE_LANES_DEFAULT = True
SERVING_OBS_SNAPSHOT_FILE = "snapshot_file"
SERVING_OBS_SNAPSHOT_FILE_DEFAULT = "SERVING_HEALTH.json"

# Checkpoint files (JAX runtime/engine.py:69-71) and the ``checkpoint``
# block (JAX constants.py:420-448)
MODEL_FILE_SUFFIX = "_model_states.pt"
OPTIM_FILE_SUFFIX = "_optim_states.pt"
LATEST_FILE = "latest"
CHECKPOINT = "checkpoint"
CHECKPOINT_TAG_VALIDATION = "tag_validation"
CHECKPOINT_TAG_VALIDATION_DEFAULT = "Warn"
CHECKPOINT_TAG_VALIDATION_MODES = ["Warn", "Ignore", "Fail"]
LOAD_UNIVERSAL_CHECKPOINT = "load_universal"
LOAD_UNIVERSAL_CHECKPOINT_DEFAULT = False
# async_save: save_checkpoint returns after the snapshot and a background
# thread writes the files. DS_CHECKPOINT_ASYNC_SAVE=1/0 force-toggles it.
CHECKPOINT_ASYNC_SAVE = "async_save"
CHECKPOINT_ASYNC_SAVE_DEFAULT = False
# fallback_to_intact: a ``latest`` pointer to a tag that fails manifest
# verification loads the newest intact tag instead of raising; an explicit
# tag= never falls back. DS_CHECKPOINT_FALLBACK=1/0.
CHECKPOINT_FALLBACK = "fallback_to_intact"
CHECKPOINT_FALLBACK_DEFAULT = True
# how long the manifest writer waits for every rank's shard file
CHECKPOINT_WAIT_TIMEOUT = "rank_wait_timeout_s"
CHECKPOINT_WAIT_TIMEOUT_DEFAULT = 300.0
# persist retries with jittered exponential backoff before the failure
# surfaces at the next drain. DS_CHECKPOINT_PERSIST_RETRIES.
CHECKPOINT_PERSIST_RETRIES = "persist_retries"
CHECKPOINT_PERSIST_RETRIES_DEFAULT = 2
CHECKPOINT_PERSIST_BACKOFF_S = "persist_retry_backoff_s"
CHECKPOINT_PERSIST_BACKOFF_S_DEFAULT = 0.05
