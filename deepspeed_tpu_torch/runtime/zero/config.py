"""The ``zero_optimization`` config block (counterpart of
``deepspeed_tpu/runtime/zero/config.py``).

Schema parity with the reference's ``DeepSpeedZeroConfig``
(``deepspeed/runtime/zero/config.py:14``) and ``zero/offload_config.py``:
the same JSON keys, defaults and deprecated spellings
(``cpu_offload`` -> ``offload_optimizer.device = "cpu"``,
``cpu_offload_params`` -> ``offload_param.device = "cpu"``,
``stage3_param_persistence_threshold`` -> ``param_persistence_threshold``),
as typed dataclasses. The bucket-size and prefetch knobs are parsed and
kept; the engine's collectives are one per process group a step
(``runtime/zero/partition.py``), so it reads none of them.
"""

from dataclasses import dataclass, field
from typing import Optional

ZERO_OPTIMIZATION = "zero_optimization"

VALID_STAGES = (0, 1, 2, 3)

OFFLOAD_DEVICE_NONE = "none"
OFFLOAD_DEVICE_CPU = "cpu"
OFFLOAD_DEVICE_NVME = "nvme"


@dataclass
class DeepSpeedZeroOffloadParamConfig:
    """zero_optimization.offload_param sub-dict (offload_config.py)."""
    device: str = OFFLOAD_DEVICE_NONE
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = int(1e8)
    max_in_cpu: int = int(1e9)
    pin_memory: bool = False

    @classmethod
    def from_dict(cls, d):
        d = d or {}
        return cls(device=d.get("device", OFFLOAD_DEVICE_NONE),
                   nvme_path=d.get("nvme_path"),
                   buffer_count=d.get("buffer_count", 5),
                   buffer_size=int(d.get("buffer_size", 1e8)),
                   max_in_cpu=int(d.get("max_in_cpu", 1e9)),
                   pin_memory=d.get("pin_memory", False))


@dataclass
class DeepSpeedZeroOffloadOptimizerConfig:
    """zero_optimization.offload_optimizer sub-dict."""
    device: str = OFFLOAD_DEVICE_NONE
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False

    @property
    def pipeline(self):
        return self.pipeline_read or self.pipeline_write

    @classmethod
    def from_dict(cls, d):
        d = d or {}
        return cls(device=d.get("device", OFFLOAD_DEVICE_NONE),
                   nvme_path=d.get("nvme_path"),
                   buffer_count=d.get("buffer_count", 4),
                   pin_memory=d.get("pin_memory", False),
                   pipeline_read=d.get("pipeline_read", False),
                   pipeline_write=d.get("pipeline_write", False),
                   fast_init=d.get("fast_init", False))


@dataclass
class DeepSpeedZeroConfig:
    """The zero_optimization config block (reference zero/config.py:14)."""
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = int(5e8)
    allgather_partitions: bool = True
    allgather_bucket_size: int = int(5e8)
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = True
    cpu_offload: Optional[bool] = None        # deprecated spelling
    cpu_offload_params: Optional[bool] = None  # deprecated spelling
    cpu_offload_use_pin_memory: Optional[bool] = None
    offload_param: DeepSpeedZeroOffloadParamConfig = field(
        default_factory=DeepSpeedZeroOffloadParamConfig)
    offload_optimizer: DeepSpeedZeroOffloadOptimizerConfig = field(
        default_factory=DeepSpeedZeroOffloadOptimizerConfig)
    sub_group_size: int = int(1e9)
    max_live_parameters: int = int(1e9)
    max_reuse_distance: int = int(1e9)
    prefetch_bucket_size: int = int(5e7)
    param_persistence_threshold: int = int(1e5)
    gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False

    @classmethod
    def from_dict(cls, config_dict):
        z = config_dict.get(ZERO_OPTIMIZATION)
        if isinstance(z, bool):
            # "zero_optimization": true -> stage 1 (legacy form; the JAX
            # copy reads the bool as a dict first and fails on it)
            z = {"stage": 1} if z else {}
        z = dict(z or {})

        stage = z.get("stage", 0)
        assert stage in VALID_STAGES, f"invalid ZeRO stage {stage}"

        offload_opt = DeepSpeedZeroOffloadOptimizerConfig.from_dict(
            z.get("offload_optimizer"))
        offload_param = DeepSpeedZeroOffloadParamConfig.from_dict(
            z.get("offload_param"))

        # Deprecated boolean spellings map onto the offload sub-configs
        # (reference zero/config.py reads both).
        if z.get("cpu_offload") and offload_opt.device == OFFLOAD_DEVICE_NONE:
            offload_opt.device = OFFLOAD_DEVICE_CPU
        if z.get("cpu_offload_params") and offload_param.device == OFFLOAD_DEVICE_NONE:
            offload_param.device = OFFLOAD_DEVICE_CPU

        overlap_comm = z.get("overlap_comm")
        if overlap_comm is None:
            # reference default: True for stage 3, False otherwise
            overlap_comm = stage == 3

        return cls(
            stage=stage,
            contiguous_gradients=z.get("contiguous_gradients", True),
            reduce_scatter=z.get("reduce_scatter", True),
            reduce_bucket_size=int(z.get("reduce_bucket_size", 5e8)),
            allgather_partitions=z.get("allgather_partitions", True),
            allgather_bucket_size=int(z.get("allgather_bucket_size", 5e8)),
            overlap_comm=overlap_comm,
            load_from_fp32_weights=z.get("load_from_fp32_weights", True),
            elastic_checkpoint=z.get("elastic_checkpoint", True),
            cpu_offload=z.get("cpu_offload"),
            cpu_offload_params=z.get("cpu_offload_params"),
            cpu_offload_use_pin_memory=z.get("cpu_offload_use_pin_memory"),
            offload_param=offload_param,
            offload_optimizer=offload_opt,
            sub_group_size=int(z.get("sub_group_size", 1e9)),
            max_live_parameters=int(z.get("stage3_max_live_parameters", 1e9)),
            max_reuse_distance=int(z.get("stage3_max_reuse_distance", 1e9)),
            prefetch_bucket_size=int(z.get("stage3_prefetch_bucket_size", 5e7)),
            param_persistence_threshold=int(
                z.get("stage3_param_persistence_threshold", 1e5)),
            gather_16bit_weights_on_model_save=z.get(
                "stage3_gather_16bit_weights_on_model_save",
                z.get("stage3_gather_fp16_weights_on_model_save", False)),
            ignore_unused_parameters=z.get("ignore_unused_parameters", True),
            legacy_stage1=z.get("legacy_stage1", False),
            round_robin_gradients=z.get("round_robin_gradients", False),
        )
