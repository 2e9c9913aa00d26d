"""The PyTorch port's training config against the JAX package's: the same
JSON dicts go through both ``DeepSpeedConfig``s (world size 1) and must
give the same batch triad, precision, optimizer, scheduler, clipping,
ZeRO stage and MoQ block; keys that turn on what the port does not run yet
raise."""

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
QUANTIZE_FIELDS = ("enabled", "start_bits", "target_bits", "quantize_period",
                   "schedule_offset", "quantize_groups", "quantize_verbose",
                   "quantizer_kernel", "quantize_change_ratio",
                   "quantize_type", "rounding", "stochastic_rounding",
                   "fp16_mixed_quantize", "quantize_offset")
MOQ = {"enabled": True, "quantize_bits": {"start_bits": 12,
                                          "target_bits": 8},
       "quantize_schedule": {"quantize_period": 2, "schedule_offset": 10},
       "quantize_groups": 8, "quantize_type": "asymmetric",
       "quantize_algo": {"rounding": "stochastic"},
       "fp16_mixed_quantize": {"enabled": True, "quantize_offset": 5},
       "quantize_change_ratio": 0.01, "quantize_verbose": True}


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
    basic(quantize_training=MOQ),
    basic(quantize_training={"enabled": True}),
    basic(quantize_training={"enabled": False}, eigenvalue={
        "enabled": False}),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: json.dumps(c)[:60])
def test_config_matches_jax(cfg):
    want = JaxConfig(dict(cfg), data_parallel_size=1)
    got = DeepSpeedConfig(dict(cfg))
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for f in FP16_FIELDS:
        assert getattr(got.fp16, f) == getattr(want.fp16, f), f
    assert got.quantize_training_enabled == want.quantize_training_enabled
    assert got.eigenvalue_enabled == want.eigenvalue_enabled
    for f in QUANTIZE_FIELDS:
        assert getattr(got.quantize_training_config, f) == \
            getattr(want.quantize_training_config, f), f


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
    ({"quantize_training": {"enabled": True},
      "eigenvalue": {"enabled": True, "layer_num": 2}}, "eigenvalue"),
    ({"elasticity": {"enabled": True}}, "elasticity"),
    ({"guardian": {"enabled": True}}, "guardian"),
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


def test_eigenvalue_without_moq_raises_the_jax_error():
    """JAX engine.py:422-428: the curvature estimate has no consumer
    without quantize_training; the port raises the same ValueError."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    cfg = basic(eigenvalue={"enabled": True, "layer_num": 2})
    with pytest.raises(ValueError, match="no consumer"):
        DeepSpeedConfig(cfg)
    with pytest.raises(ValueError, match="no consumer"):
        deepspeed_tpu_torch.initialize(
            model=gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu"),
            config=cfg, device="cpu")


def test_quantize_training_is_no_longer_ignored():
    """The fault of the parent: the port parsed no ``quantize_training``
    block and trained unquantized. Now the engine builds the MoQ schedule
    from it (tests/test_torch_moq.py holds its effect to the JAX
    engine)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu"),
        config=basic(train_batch_size=2, quantize_training=MOQ),
        device="cpu")
    q = engine.quantizer
    assert q is not None and q.q_groups == 8 and q.q_type == 1
    assert q.q_rounding == 1 and q.q_mixed_fp16
    assert (q.q_start_bits, q.q_target_bits, q.q_period) == ([12], 8, [2])


@pytest.mark.parametrize("block", [None, {}, {"mode": "fixed", "block": 64},
                                   {"mode": "bigbird", "block": 16,
                                    "num_random_blocks": 2}])
def test_sparse_attention_block_is_exposed_raw(block):
    """The raw ``sparse_attention`` block, as the JAX config keeps it
    (runtime/config.py:1337)."""
    cfg = basic() if block is None else basic(sparse_attention=block)
    want = JaxConfig(json.loads(json.dumps(cfg))).sparse_attention
    assert DeepSpeedConfig(cfg).sparse_attention == want == block


@pytest.mark.parametrize("over", [
    {"amp": {"enabled": True}},
    {"prescale_gradients": True},
    {"gradient_predivide_factor": 2.0},
    {"disable_allgather": True},
    {"communication_data_type": "fp16"},
    {"optimizer": {"type": "Adam", "legacy_fusion": True,
                   "params": {"lr": 1e-3}}},
    {"fp16": {"enabled": True, "fp16_master_weights_and_grads": True}},
    {"gradient_accumulation_dtype": "fp8"},
], ids=lambda o: json.dumps(o)[:50])
def test_keys_the_jax_config_refuses_raise(over):
    """The keys JAX ``_do_sanity_check`` refuses off-default
    (tests/unit/test_config.py:194-217): the port raises the same error
    class on the same dicts, where it used to build the config."""
    with pytest.raises(JaxError):
        JaxConfig(basic(**over), data_parallel_size=1)
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedConfig(basic(**over))


@pytest.mark.parametrize("over", [
    {"amp": {"enabled": False}}, {"gradient_predivide_factor": 1.0},
    {"prescale_gradients": False}, {"disable_allgather": False},
    {"gradient_accumulation_dtype": "bf16"},
    {"gradient_accumulation_dtype": "fp16"},
    {"gradient_accumulation_dtype": "fp32"}])
def test_refused_keys_at_their_defaults_parse(over):
    got = DeepSpeedConfig(basic(**over))
    want = JaxConfig(basic(**over), data_parallel_size=1)
    assert got.gradient_accumulation_dtype == \
        want.gradient_accumulation_dtype
    assert got.gradient_predivide_factor == want.gradient_predivide_factor
