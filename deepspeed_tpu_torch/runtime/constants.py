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

# the flops profiler, which the JAX engine acts on; refused until ported
FLOPS_PROFILER = "flops_profiler"

# Observability
DUMP_STATE = "dump_state"
DUMP_STATE_DEFAULT = False
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False
MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False
TENSORBOARD = "tensorboard"
TENSORBOARD_ENABLED = "enabled"
TENSORBOARD_ENABLED_DEFAULT = False
TENSORBOARD_OUTPUT_PATH = "output_path"
TENSORBOARD_OUTPUT_PATH_DEFAULT = ""
TENSORBOARD_JOB_NAME = "job_name"
TENSORBOARD_JOB_NAME_DEFAULT = "DeepSpeedJobName"

# Telemetry (trace spans, compile watch, metrics sinks)
TELEMETRY = "telemetry"
TELEMETRY_ENABLED = "enabled"
TELEMETRY_ENABLED_DEFAULT = False
TELEMETRY_OUTPUT_PATH = "output_path"
TELEMETRY_OUTPUT_PATH_DEFAULT = ""          # "" -> "telemetry/"
TELEMETRY_JOB_NAME = "job_name"
TELEMETRY_JOB_NAME_DEFAULT = "DeepSpeedJobName"
TELEMETRY_TRACE = "trace"
TELEMETRY_TRACE_DEFAULT = True
TELEMETRY_JAX_ANNOTATIONS = "jax_annotations"
TELEMETRY_JAX_ANNOTATIONS_DEFAULT = False
TELEMETRY_COMPILE_WATCH = "compile_watch"
TELEMETRY_COMPILE_WATCH_DEFAULT = True
TELEMETRY_JSONL = "jsonl"
TELEMETRY_JSONL_DEFAULT = True
TELEMETRY_PROMETHEUS = "prometheus"
TELEMETRY_PROMETHEUS_DEFAULT = True
TELEMETRY_MEMORY_METRICS = "memory_metrics"
TELEMETRY_MEMORY_METRICS_DEFAULT = True
TELEMETRY_MAX_TRACE_EVENTS = "max_trace_events"
TELEMETRY_MAX_TRACE_EVENTS_DEFAULT = 100000

# telemetry.cost_explorer (parsed; an enabled block is refused: not ported)
COST_EXPLORER = "cost_explorer"
COST_EXPLORER_ENABLED = "enabled"
COST_EXPLORER_ENABLED_DEFAULT = False
COST_EXPLORER_PEAK_TFLOPS = "peak_tflops"          # 0 -> chip table
COST_EXPLORER_PEAK_TFLOPS_DEFAULT = 0
COST_EXPLORER_PEAK_HBM_GBPS = "peak_hbm_gbps"      # 0 -> chip table
COST_EXPLORER_PEAK_HBM_GBPS_DEFAULT = 0
COST_EXPLORER_ICI_GBPS = "ici_gbps"                # 0 -> chip table
COST_EXPLORER_ICI_GBPS_DEFAULT = 0
COST_EXPLORER_HBM_GB = "hbm_gb"                    # 0 -> device/chip table
COST_EXPLORER_HBM_GB_DEFAULT = 0
COST_EXPLORER_PREFLIGHT = "preflight"
COST_EXPLORER_PREFLIGHT_DEFAULT = True
COST_EXPLORER_PREFLIGHT_THRESHOLD = "preflight_threshold"
COST_EXPLORER_PREFLIGHT_THRESHOLD_DEFAULT = 0.95

# telemetry.health (parsed; an enabled block is refused: not ported)
TELEMETRY_HEALTH = "health"
HEALTH_ENABLED = "enabled"
HEALTH_ENABLED_DEFAULT = False
HEALTH_BUCKET_DEPTH = "bucket_depth"       # max module buckets (<= 32)
HEALTH_BUCKET_DEPTH_DEFAULT = 8
HEALTH_CADENCE = "cadence"                 # 0 -> steps_per_print
HEALTH_CADENCE_DEFAULT = 0
HEALTH_EWMA_ALPHA = "ewma_alpha"
HEALTH_EWMA_ALPHA_DEFAULT = 0.1
HEALTH_LOSS_SPIKE_ZSCORE = "loss_spike_zscore"
HEALTH_LOSS_SPIKE_ZSCORE_DEFAULT = 6.0
HEALTH_GRAD_SPIKE_ZSCORE = "grad_spike_zscore"
HEALTH_GRAD_SPIKE_ZSCORE_DEFAULT = 6.0
HEALTH_WARMUP_SAMPLES = "warmup_samples"   # samples before z-rules arm
HEALTH_WARMUP_SAMPLES_DEFAULT = 8
HEALTH_OVERFLOW_STREAK = "overflow_streak"  # consecutive skips -> critical
HEALTH_OVERFLOW_STREAK_DEFAULT = 4
HEALTH_STALL_WINDOW = "stall_window"       # health samples; <2 disables
HEALTH_STALL_WINDOW_DEFAULT = 50
HEALTH_STALL_REL_DELTA = "stall_rel_delta"
HEALTH_STALL_REL_DELTA_DEFAULT = 1e-3
HEALTH_RING_SIZE = "ring_size"             # forensics ring buffer samples
HEALTH_RING_SIZE_DEFAULT = 256
HEALTH_SNAPSHOT_FILE = "snapshot_file"     # "" -> <output_path>/HEALTH.json
HEALTH_SNAPSHOT_FILE_DEFAULT = ""
HEALTH_TRACE_ON_ANOMALY = "trace_on_anomaly"
HEALTH_TRACE_ON_ANOMALY_DEFAULT = True

# telemetry.goodput (parsed; an enabled block is refused: not ported)
TELEMETRY_GOODPUT = "goodput"
GOODPUT_ENABLED = "enabled"
GOODPUT_ENABLED_DEFAULT = False
GOODPUT_CADENCE = "cadence"                 # window ticks; 0 -> steps_per_print
GOODPUT_CADENCE_DEFAULT = 0
GOODPUT_INPUT_WAIT_FRAC = "input_wait_frac"  # window fraction -> input_stall
GOODPUT_INPUT_WAIT_FRAC_DEFAULT = 0.25
GOODPUT_UNATTRIBUTED_FRAC = "unattributed_frac"
GOODPUT_UNATTRIBUTED_FRAC_DEFAULT = 0.5
GOODPUT_WARMUP_WINDOWS = "warmup_windows"   # windows before rules arm
GOODPUT_WARMUP_WINDOWS_DEFAULT = 1
GOODPUT_WINDOW_RING = "window_ring"         # per-window ring buffer size
GOODPUT_WINDOW_RING_DEFAULT = 128
GOODPUT_SNAPSHOT_FILE = "snapshot_file"     # "" -> <output_path>/GOODPUT.json
GOODPUT_SNAPSHOT_FILE_DEFAULT = ""
GOODPUT_PROFILER_CAPTURE = "profiler_capture"
GOODPUT_PROFILER_CAPTURE_DEFAULT = True
GOODPUT_PROFILER_CAPTURE_STEPS = "profiler_capture_steps"
GOODPUT_PROFILER_CAPTURE_STEPS_DEFAULT = 5
GOODPUT_PROFILER_MAX_CAPTURES = "profiler_max_captures"  # per run
GOODPUT_PROFILER_MAX_CAPTURES_DEFAULT = 1
GOODPUT_PROFILER_DIR = "profiler_dir"       # "" -> <output_path>/goodput_profile
GOODPUT_PROFILER_DIR_DEFAULT = ""

# telemetry.anatomy (parsed; read only by the JAX engine's profile_step,
# which is not ported)
TELEMETRY_ANATOMY = "anatomy"
ANATOMY_ENABLED = "enabled"
ANATOMY_ENABLED_DEFAULT = True
ANATOMY_CAPTURE_STEPS = "capture_steps"     # default steps per profile_step
ANATOMY_CAPTURE_STEPS_DEFAULT = 3
ANATOMY_KEEP_RAW_TRACES = "keep_raw_traces"  # newest N raw trace dirs kept
ANATOMY_KEEP_RAW_TRACES_DEFAULT = 2
ANATOMY_REPORT_FILE = "report_file"  # "" -> <output_path>/STEP_ANATOMY.json
ANATOMY_REPORT_FILE_DEFAULT = ""

# telemetry.fleet (parsed; an enabled block is refused: not ported).
# DS_TELEMETRY_FLEET, DS_TELEMETRY_FLEET_RUN_DIR, DS_TELEMETRY_FLEET_RANK
TELEMETRY_FLEET = "fleet"
FLEET_ENABLED = "enabled"
FLEET_ENABLED_DEFAULT = False
FLEET_RUN_DIR = "run_dir"                   # "" -> <output_path>/fleet_run
FLEET_RUN_DIR_DEFAULT = ""
FLEET_RANK = "rank"                         # -1 -> dist.get_rank()
FLEET_RANK_DEFAULT = -1
FLEET_CADENCE = "cadence"                   # ship every N steps; 0 -> steps_per_print
FLEET_CADENCE_DEFAULT = 0
FLEET_DESYNC = "desync"                     # arm the desync sentinel
FLEET_DESYNC_DEFAULT = True
FLEET_DESYNC_CADENCE = "desync_cadence"     # checksum every N fleet ticks; 0 -> 1
FLEET_DESYNC_CADENCE_DEFAULT = 0
FLEET_STEP_TIME_SKEW_FRAC = "step_time_skew_frac"   # (slow-fast)/slow
FLEET_STEP_TIME_SKEW_FRAC_DEFAULT = 0.25
FLEET_INPUT_WAIT_SKEW_FRAC = "input_wait_skew_frac"  # max-min window frac
FLEET_INPUT_WAIT_SKEW_FRAC_DEFAULT = 0.25
FLEET_CHECKPOINT_SKEW_FRAC = "checkpoint_skew_frac"  # (max-min)/max
FLEET_CHECKPOINT_SKEW_FRAC_DEFAULT = 0.5
FLEET_CHECKPOINT_SKEW_FLOOR_MS = "checkpoint_skew_floor_ms"
FLEET_CHECKPOINT_SKEW_FLOOR_MS_DEFAULT = 50.0
FLEET_WARMUP_WINDOWS = "warmup_windows"     # windows before the skew rules arm
FLEET_WARMUP_WINDOWS_DEFAULT = 1
FLEET_WINDOW_RING = "window_ring"           # merged-window ring buffer size
FLEET_WINDOW_RING_DEFAULT = 128
FLEET_SNAPSHOT_FILE = "snapshot_file"       # "" -> <output_path>/FLEET_HEALTH.json
FLEET_SNAPSHOT_FILE_DEFAULT = ""
FLEET_BACKGROUND_SHIP = "background_ship"   # write records off-thread
FLEET_BACKGROUND_SHIP_DEFAULT = True

# telemetry.memory (parsed; an enabled block is refused: not ported)
TELEMETRY_MEMORY = "memory"
MEMORY_ENABLED = "enabled"
MEMORY_ENABLED_DEFAULT = False
MEMORY_CADENCE = "cadence"                  # windows every N steps; 0 -> steps_per_print
MEMORY_CADENCE_DEFAULT = 0
MEMORY_SNAPSHOT_FILE = "snapshot_file"      # "" -> <output_path>/MEMORY_HEALTH.json
MEMORY_SNAPSHOT_FILE_DEFAULT = ""
MEMORY_REPORT_FILE = "report_file"          # "" -> <output_path>/MEMORY_ANATOMY.json
MEMORY_REPORT_FILE_DEFAULT = ""
MEMORY_LEAK_WINDOWS = "leak_windows"        # monotone-growth windows before hbm_leak fires
MEMORY_LEAK_WINDOWS_DEFAULT = 4
MEMORY_WARMUP_WINDOWS = "warmup_windows"    # windows before the rules arm
MEMORY_WARMUP_WINDOWS_DEFAULT = 2
MEMORY_DRIFT_THRESHOLD = "drift_threshold"  # |measured/predicted - 1| that flags
MEMORY_DRIFT_THRESHOLD_DEFAULT = 0.25
MEMORY_FRAG_THRESHOLD = "frag_threshold"    # KV pool fragmentation that flags
MEMORY_FRAG_THRESHOLD_DEFAULT = 0.5
MEMORY_HEADROOM = "headroom"                # oom_risk fires above headroom x budget
MEMORY_HEADROOM_DEFAULT = 0.92
MEMORY_BUDGET_BYTES = "budget_bytes"        # 0 -> detect (device memory_stats only)
MEMORY_BUDGET_BYTES_DEFAULT = 0
MEMORY_RING_SIZE = "ring_size"              # live-bytes window ring buffer size
MEMORY_RING_SIZE_DEFAULT = 64

# telemetry.chronicle (parsed; an enabled block is refused: the caller
# arms a RunChronicle with set_chronicle)
TELEMETRY_CHRONICLE = "chronicle"
CHRONICLE_ENABLED = "enabled"
CHRONICLE_ENABLED_DEFAULT = False
CHRONICLE_RUN_DIR = "run_dir"               # "" -> <output_path>/chronicle
CHRONICLE_RUN_DIR_DEFAULT = ""
CHRONICLE_MAX_EVENTS = "max_events"         # in-memory cap; past it NEW events drop (counted)
CHRONICLE_MAX_EVENTS_DEFAULT = 16384
CHRONICLE_SUMMARY_FILE = "summary_file"     # "" -> <output_path>/CHRONICLE.json
CHRONICLE_SUMMARY_FILE_DEFAULT = ""
CHRONICLE_INCIDENTS_FILE = "incidents_file"  # "" -> <output_path>/INCIDENTS.json
CHRONICLE_INCIDENTS_FILE_DEFAULT = ""
CHRONICLE_STEP_WINDOW = "step_window"       # correlator step-join radius
CHRONICLE_STEP_WINDOW_DEFAULT = 8
CHRONICLE_TIME_WINDOW_S = "time_window_s"   # correlator time-join radius
CHRONICLE_TIME_WINDOW_S_DEFAULT = 30.0
CHRONICLE_BACKGROUND = "background"         # stream writes off-thread
CHRONICLE_BACKGROUND_DEFAULT = True

# telemetry.server: the live observability plane (telemetry/
# obs_server.py) — a zero-dependency stdlib HTTP endpoint on rank 0
# serving GET /metrics (render_prometheus over the live registry — a
# real scrape target; the .prom file sink stays the node_exporter
# textfile-collector path), /healthz + /readyz (armed-monitor
# inventory), /api/report/{goodput,health,serving,memory,fleet,
# guardian,chronicle,incidents,slo} (each monitor's HOST-SIDE report —
# a scrape never forces a device fetch, sync, or compile) and
# /api/events (bounded chronicle tail, ?since_seq= resumable).
# DS_TELEMETRY_SERVER=1/0 force-toggles `enabled`.
TELEMETRY_SERVER = "server"
SERVER_ENABLED = "enabled"
SERVER_ENABLED_DEFAULT = False
SERVER_HOST = "host"                        # bind address (loopback default)
SERVER_HOST_DEFAULT = "127.0.0.1"
SERVER_PORT = "port"                        # 0 -> auto-pick a free port
SERVER_PORT_DEFAULT = 0
SERVER_TOKEN = "token"                      # "" -> no auth; else Bearer <token>
SERVER_TOKEN_DEFAULT = ""
SERVER_EVENTS_TAIL = "events_tail"          # /api/events max tail length
SERVER_EVENTS_TAIL_DEFAULT = 256

# telemetry.slo: the SLO burn-rate monitor (telemetry/slo.py) — SRE
# multi-window error-budget alerting over declarative objectives
# (latency objectives from registry histograms, training goodput from
# the ledger). Fast+slow windows both burning -> page-tier
# `slo_burn_page` anomaly (critical; a guardian admission-pause rule),
# fast-only -> `slo_burn_fast` (warning); escalation rides the shared
# protocol into SLO_REPORT.json, the chronicle and the guardian.
# DS_TELEMETRY_SLO=1/0 force-toggles `enabled`.
TELEMETRY_SLO = "slo"
SLO_ENABLED = "enabled"
SLO_ENABLED_DEFAULT = False
SLO_FAST_WINDOW_S = "fast_window_s"         # onset window (~5 min)
SLO_FAST_WINDOW_S_DEFAULT = 300.0
SLO_SLOW_WINDOW_S = "slow_window_s"         # sustain window (~1 h)
SLO_SLOW_WINDOW_S_DEFAULT = 3600.0
SLO_BURN_THRESHOLD = "burn_threshold"       # burn (x budget) that counts as burning
SLO_BURN_THRESHOLD_DEFAULT = 1.0
SLO_EVAL_INTERVAL_S = "eval_interval_s"     # tick self-throttle
SLO_EVAL_INTERVAL_S_DEFAULT = 10.0
SLO_OBJECTIVES = "objectives"               # [] -> goodput default (+ serving adds ttft/e2e)
SLO_OBJECTIVES_DEFAULT = ()
SLO_GOODPUT_TARGET = "goodput_target"       # default training_goodput objective target
SLO_GOODPUT_TARGET_DEFAULT = 0.90
SLO_TTFT_TARGET = "ttft_target"             # serving_ttft objective target
SLO_TTFT_TARGET_DEFAULT = 0.99
SLO_TTFT_THRESHOLD_MS = "ttft_threshold_ms"
SLO_TTFT_THRESHOLD_MS_DEFAULT = 500.0
SLO_E2E_TARGET = "e2e_target"               # serving_e2e objective target
SLO_E2E_TARGET_DEFAULT = 0.99
SLO_E2E_THRESHOLD_MS = "e2e_threshold_ms"
SLO_E2E_THRESHOLD_MS_DEFAULT = 5000.0
SLO_SNAPSHOT_FILE = "snapshot_file"         # "" -> <output_path>/SLO_REPORT.json
SLO_SNAPSHOT_FILE_DEFAULT = ""

# telemetry.federation (parsed; an enabled block is refused: not ported)
TELEMETRY_FEDERATION = "federation"
FEDERATION_ENABLED = "enabled"
FEDERATION_ENABLED_DEFAULT = False
FEDERATION_PEERS = "peers"                  # static peer base-url list
FEDERATION_PEERS_DEFAULT = ()
FEDERATION_RUN_DIR = "run_dir"              # peer-registry dir ("" -> chronicle run_dir)
FEDERATION_RUN_DIR_DEFAULT = ""
FEDERATION_AGGREGATOR = "aggregator"        # auto (rank 0) / always / never
FEDERATION_AGGREGATOR_DEFAULT = "auto"
FEDERATION_SCRAPE_INTERVAL_S = "scrape_interval_s"
FEDERATION_SCRAPE_INTERVAL_S_DEFAULT = 2.0
FEDERATION_TIMEOUT_S = "timeout_s"          # per-request peer timeout
FEDERATION_TIMEOUT_S_DEFAULT = 2.0
FEDERATION_STALE_AFTER_S = "stale_after_s"  # last-seen age that marks a peer stale
FEDERATION_STALE_AFTER_S_DEFAULT = 10.0
FEDERATION_EVENTS_RING = "events_ring"      # merged per-peer event buffer
FEDERATION_EVENTS_RING_DEFAULT = 4096
FEDERATION_SNAPSHOT_FILE = "snapshot_file"  # "" -> <output_path>/FLEET_CONTROL.json
FEDERATION_SNAPSHOT_FILE_DEFAULT = ""
FEDERATION_GOODPUT_TARGET = "goodput_target"   # fleet_goodput objective target
FEDERATION_GOODPUT_TARGET_DEFAULT = 0.90
FEDERATION_TTFT_TARGET = "ttft_target"         # fleet_ttft objective target
FEDERATION_TTFT_TARGET_DEFAULT = 0.99


# Guardian (runtime/guardian.py): the anomaly->action policy engine.
# Config-gated and OFF by default — arming it means the run may take
# emergency checkpoints, roll itself back to the newest intact tag on
# confirmed divergence, reset a collapsed fp16 loss scale, and pause
# serving admission under overload. Every action is rate-limited,
# bounded, and journaled to GUARDIAN.json. DS_GUARDIAN=1/0 force-toggles.
GUARDIAN = "guardian"
GUARDIAN_ENABLED = "enabled"
GUARDIAN_ENABLED_DEFAULT = False
GUARDIAN_JOURNAL_FILE = "journal_file"      # "" -> <output_path>/GUARDIAN.json
GUARDIAN_JOURNAL_FILE_DEFAULT = ""
GUARDIAN_ACTION_COOLDOWN = "action_cooldown_steps"
GUARDIAN_ACTION_COOLDOWN_DEFAULT = 25
GUARDIAN_EMERGENCY_CHECKPOINT = "emergency_checkpoint"
GUARDIAN_EMERGENCY_CHECKPOINT_DEFAULT = True
GUARDIAN_EMERGENCY_RULES = "emergency_rules"  # [] -> built-in warning tier
GUARDIAN_MAX_EMERGENCY_CHECKPOINTS = "max_emergency_checkpoints"
GUARDIAN_MAX_EMERGENCY_CHECKPOINTS_DEFAULT = 4
GUARDIAN_ROLLBACK = "rollback"
GUARDIAN_ROLLBACK_DEFAULT = True
GUARDIAN_DIVERGENCE_WINDOW = "divergence_window"    # steps of evidence
GUARDIAN_DIVERGENCE_WINDOW_DEFAULT = 50
GUARDIAN_DIVERGENCE_STREAK = "divergence_streak"    # nonfinite firings
GUARDIAN_DIVERGENCE_STREAK_DEFAULT = 2
GUARDIAN_ROLLBACK_COOLDOWN = "rollback_cooldown_steps"
GUARDIAN_ROLLBACK_COOLDOWN_DEFAULT = 200
GUARDIAN_MAX_ROLLBACKS = "max_rollbacks"
GUARDIAN_MAX_ROLLBACKS_DEFAULT = 2
GUARDIAN_FP16_RESCUE = "fp16_rescue"
GUARDIAN_FP16_RESCUE_DEFAULT = True
GUARDIAN_MAX_FP16_RESCUES = "max_fp16_rescues"
GUARDIAN_MAX_FP16_RESCUES_DEFAULT = 2
GUARDIAN_SERVING_DEGRADE = "serving_degrade"
GUARDIAN_SERVING_DEGRADE_DEFAULT = True
GUARDIAN_PAUSE_RULES = "pause_rules"        # [] -> built-in overload rules
GUARDIAN_RESUME_CLEAR_STEPS = "resume_clear_steps"
GUARDIAN_RESUME_CLEAR_STEPS_DEFAULT = 64

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

# serving.router: SLO-aware multi-replica admission (serving/router.py).
# Each request is scored per replica as
#   affinity_weight * matched-prefix-blocks
#   - queue_weight * (queue_depth + active) - occupancy_weight * kv_occupancy
#   - breach_penalty * (recent ttft_slo_breach or queue_growth)
# and lands on the argmax. `replicas` is validated only: the caller builds
# the replica engines and hands them to ServingRouter
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

# serving.observability: the serving observatory
# (telemetry/serving_observatory.py); DS_SERVING_OBS=1/0 force-toggles
# `enabled`
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

# Data routes of ``engine.deepspeed_io`` (JAX constants.py:9-10)
ROUTE_TRAIN = "train"
ROUTE_EVAL = "eval"

# Dataloader
DATALOADER_DROP_LAST = "dataloader_drop_last"
DATALOADER_DROP_LAST_DEFAULT = False

# data_prefetch: the background input pipeline (runtime/prefetch.py).
# When enabled, deepspeed_io-built loaders (and iterators handed to
# train_batch) are wrapped in a bounded pipeline: host worker threads
# fetch and collate the next `depth` batches, and a device stage copies
# batch N+1 to the card on a copy stream while step N computes.
# `num_local_io_workers` (deepspeed_io argument) sets the host-stage
# worker count. DS_DATA_PREFETCH=1/0 force-toggles `enabled`.
DATA_PREFETCH = "data_prefetch"
DATA_PREFETCH_ENABLED = "enabled"
DATA_PREFETCH_ENABLED_DEFAULT = False
DATA_PREFETCH_DEPTH = "depth"               # max batches in the pipeline
DATA_PREFETCH_DEPTH_DEFAULT = 2
DATA_PREFETCH_TO_DEVICE = "to_device"       # arm the device stage
DATA_PREFETCH_TO_DEVICE_DEFAULT = True

# Progressive layer drop
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
PLD_ENABLED = "enabled"
PLD_ENABLED_DEFAULT = False
PLD_THETA = "theta"
PLD_THETA_DEFAULT = 1.0
PLD_GAMMA = "gamma"
PLD_GAMMA_DEFAULT = 0.001

# Curriculum learning
CURRICULUM_LEARNING = "curriculum_learning"
CURRICULUM_ENABLED = "enabled"
CURRICULUM_ENABLED_DEFAULT = False
