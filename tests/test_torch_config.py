"""The PyTorch port's training config against the JAX package's: the same
JSON dicts go through both ``DeepSpeedConfig``s (world size 1) and must
give the same batch triad, precision, optimizer, scheduler, clipping and
ZeRO stage; keys that turn on what the port does not run yet raise."""

import json

import pytest

from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfigError as JaxError
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                DeepSpeedConfigError)

FIELDS = ("train_batch_size", "train_micro_batch_size_per_gpu",
          "gradient_accumulation_steps", "steps_per_print", "fp16_enabled",
          "bfloat16_enabled", "loss_scale", "initial_dynamic_scale",
          "gradient_clipping", "optimizer_name", "optimizer_params",
          "scheduler_name", "scheduler_params", "zero_optimization_stage",
          "zero_enabled")
FP16_FIELDS = ("enabled", "loss_scale", "initial_scale_power",
               "loss_scale_window", "hysteresis", "min_loss_scale",
               "dynamic_loss_scale")


def basic(**over):
    d = {"train_batch_size": 32,
         "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    d.update(over)
    return d


CONFIGS = [
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4,
     "gradient_accumulation_steps": 8},
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 32, "gradient_accumulation_steps": 2},
    {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2},
    {"train_batch_size": 32},
    {"train_micro_batch_size_per_gpu": 4, "steps_per_print": 5},
    basic(fp16={"enabled": True, "loss_scale": 0, "initial_scale_power": 16,
                "loss_scale_window": 500, "hysteresis": 3,
                "min_loss_scale": 2}),
    basic(fp16={"enabled": True, "loss_scale": 128.0}),
    basic(bf16={"enabled": True}),
    basic(bfloat16={"enabled": True}),
    basic(gradient_clipping=1.0, zero_optimization={"stage": 1}),
    basic(optimizer={"type": "AdamW", "params": {
        "lr": 3e-4, "betas": [0.8, 0.99], "eps": 1e-6, "weight_decay": 0.01,
        "sweep": True}}),
    basic(optimizer={"type": "Adam", "params": {"lr": 1e-3, "fused": True}},
          scheduler={"type": "WarmupLR", "params": {
              "warmup_min_lr": 0, "warmup_max_lr": 1e-3}}),
    {"train_batch_size": 8, "optimizer": {"type": "adam"},
     "wall_clock_breakdown": False},
    basic(optimizer={"type": "Lamb", "params": {
        "lr": 1e-4, "fused": True, "betas": [0.9, 0.98], "eps": 1e-6,
        "weight_decay": 0.01, "min_coeff": 0.02, "max_coeff": 5.0,
        "bias_correction": False}}, bf16={"enabled": True}),
    basic(optimizer={"type": "LAMB", "params": {"lr": 1e-3}}),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: json.dumps(c)[:60])
def test_config_matches_jax(cfg):
    want = JaxConfig(dict(cfg), data_parallel_size=1)
    got = DeepSpeedConfig(dict(cfg))
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for f in FP16_FIELDS:
        assert getattr(got.fp16, f) == getattr(want.fp16, f), f


def test_fused_and_sweep_flags():
    cfg = DeepSpeedConfig(basic(optimizer={"type": "Adam", "params": {
        "lr": 1e-3, "sweep": True}}))
    assert cfg.optimizer_sweep and not cfg.optimizer_fused
    cfg = DeepSpeedConfig(basic(optimizer={"type": "Adam", "params": {
        "fused": True}}))
    assert cfg.optimizer_fused and not cfg.optimizer_sweep


def test_file_roundtrip(tmp_path):
    path = tmp_path / "ds_config.json"
    path.write_text(json.dumps(basic(bf16={"enabled": True})))
    assert DeepSpeedConfig(str(path)).bfloat16_enabled
    with pytest.raises(DeepSpeedConfigError, match="not found"):
        DeepSpeedConfig(str(tmp_path / "missing.json"))


@pytest.mark.parametrize("cfg", [
    {"steps_per_print": 10},
    {"train_batch_size": 33, "train_micro_batch_size_per_gpu": 4,
     "gradient_accumulation_steps": 2},
    {"train_batch_size": 0},
    basic(fp16={"enabled": True}, bf16={"enabled": True}),
])
def test_invalid_configs_raise_like_jax(cfg):
    with pytest.raises(JaxError):
        JaxConfig(dict(cfg), data_parallel_size=1)
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedConfig(dict(cfg))


@pytest.mark.parametrize("over,what", [
    ({"zero_optimization": {"stage": 2}}, "stage=2"),
    ({"zero_optimization": {"stage": 3}}, "stage=3"),
    ({"zero_optimization": {"stage": 1, "offload_optimizer": {
        "device": "cpu"}}}, "offload_optimizer"),
    ({"zero_optimization": {"stage": 1, "cpu_offload": True}},
     "cpu_offload"),
    ({"comm_overlap": {"enabled": True}}, "comm_overlap"),
    ({"optimizer": {"type": "OneBitAdam"}}, "onebitadam"),
    ({"optimizer": {"type": "OneBitLamb"}}, "onebitlamb"),
    ({"optimizer": {"type": "SGD"}}, "sgd"),
    ({"optimizer": {"type": "Adagrad"}}, "adagrad"),
    ({"pipeline": {"stages": 2}}, "pipeline"),
    ({"moe": {"enabled": True}}, "MoE"),
    ({"telemetry": {"enabled": True}}, "telemetry"),
    ({"data_prefetch": {"enabled": True}}, "data_prefetch"),
    ({"curriculum_learning": {"enabled": True}}, "curriculum"),
    ({"progressive_layer_drop": {"enabled": True}}, "layer drop"),
    ({"sparse_gradients": True}, "sparse_gradients"),
])
def test_unported_keys_raise(over, what):
    with pytest.raises(NotImplementedError, match="not ported yet") as err:
        DeepSpeedConfig(basic(**over))
    assert what in str(err.value)


def test_disabled_blocks_are_accepted():
    cfg = DeepSpeedConfig(basic(telemetry={"enabled": False},
                                comm_overlap={"enabled": False},
                                zero_optimization={"stage": 1,
                                                   "offload_optimizer": {
                                                       "device": "none"}}))
    assert cfg.zero_optimization_stage == 1


def test_sweep_needs_adam():
    with pytest.raises(ValueError, match="sweep"):
        DeepSpeedConfig(basic(optimizer={"type": "Lamb", "params": {
            "sweep": True}}))


def test_lamb_is_admitted_with_fused_flag():
    cfg = DeepSpeedConfig(basic(optimizer={"type": "lamb", "params": {
        "lr": 1e-4, "fused": True}}))
    assert cfg.optimizer_name == "lamb" and cfg.optimizer_fused
    assert not cfg.optimizer_sweep
