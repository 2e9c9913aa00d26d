"""ZeRO stages 2 and 3 and the optimizer offload on the card, at world
size 1 over NCCL (one card takes one rank). Every test carries the
``cuda`` marker and skips without a card. This file imports no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_zero.py

A 4-layer GPT-2 of width 256 in bf16 over fp32 masters, fused Adam (the
``ds_adam_multi`` kernel) and clip 1.0, 3 steps. At world 1 every tensor
is one rank's whole slice, so stages 2 and 3 run their collectives
(reduce-scatter, the stage-3 gather and its backward) on one rank and
must equal stage 0 without a process group bit for bit: losses and
masters; so must the Adam sweep at stage 3 (its vector of the rank's
slices) and MoQ at stage 3 (gathered, quantized whole, cut back). The
offload runs the host CPU-Adam on the same gradients: its losses within
2e-4 relative (the JAX suite's offload tolerance,
tests/model/test_loss_parity.py:124). Parameter offload (the layered
engine, 4 blocks) streams each layer from pinned host RAM on side
streams: its losses within 2e-4 of the same layers resident on the card
(``chip_smoke.resident_oracle``: plain autograd, Adam with CPU-Adam's
formula), at most two layers on the card, 2 flash forwards a block a
step.
"""

import dataclasses
import math

import pytest
import torch

import chip_smoke
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.ops import op_builder

pytestmark = pytest.mark.cuda

CFG = dataclasses.replace(gpt2.PRESETS["tiny"], vocab_size=1024,
                          n_positions=256, n_embd=256, n_layer=4, n_head=4)
STEPS = 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _config(stage, offload=None, form="fused", **over):
    zero = {"stage": stage, "stage3_param_persistence_threshold": 1000}
    if offload is not None:
        zero["offload_optimizer"] = offload
    cfg = {"train_batch_size": 4, "steps_per_print": 10 ** 9,
           "bf16": {"enabled": True}, "gradient_clipping": 1.0,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3,
                                                    form: True}},
           "zero_optimization": zero}
    cfg.update(over)
    return cfg


MOQ = {"enabled": True, "quantize_groups": 8,
       "quantize_bits": {"start_bits": 12, "target_bits": 8},
       "quantize_schedule": {"quantize_period": 2}}


def _run(config):
    from deepspeed_tpu_torch.utils import groups
    groups.destroy()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2.GPT2LMHeadModel(CFG, seed=0), config=config)
    batch = gpt2.synthetic_batch(4, 256, CFG.vocab_size, seed=1)
    op_builder.reset_launch_counts()
    losses = [float(engine.train_batch(batch=batch)) for _ in range(STEPS)]
    launches = dict(op_builder.LAUNCHES)
    from deepspeed_tpu_torch import zero
    with zero.GatheredParameters(dict(engine.params)) as masters:
        pass
    return losses, masters, launches, engine


@pytest.fixture
def nccl(card):
    import torch.distributed as dist
    yield lambda: deepspeed_tpu_torch.init_distributed()
    if dist.is_initialized():
        dist.destroy_process_group()


def test_stages_2_and_3_over_nccl_equal_stage_0(nccl, tmp_path):
    want = _run(_config(0))
    assert want[2].get("flash_fwd") == CFG.n_layer * STEPS
    assert want[2].get("adam") == STEPS
    nccl()
    for stage in (2, 3):
        got = _run(_config(stage))
        assert got[0] == want[0], stage
        for k, p in want[1].items():
            assert torch.equal(got[1][k], p), (stage, k)
        assert got[2] == want[2], stage


def test_offload_on_the_card(nccl, tmp_path):
    want = _run(_config(0))
    nccl()
    for stage, offload in ((3, {"device": "cpu"}),
                           (2, {"device": "nvme",
                                "nvme_path": str(tmp_path)})):
        losses, masters, launches, engine = _run(_config(stage, offload))
        assert engine.opt_state is None
        assert engine._offload_opt.last_host_ms > 0
        # the flash kernels ran; Adam ran on the host
        assert launches.get("flash_fwd") == CFG.n_layer * STEPS
        assert "adam" not in launches
        assert losses[0] == want[0][0]
        for a, b in zip(losses, want[0]):
            assert abs(a - b) <= 2e-4 * abs(b), (stage, losses, want[0])
        del engine


@pytest.mark.parametrize("what", ["sweep", "moq"])
def test_stage3_sweep_and_moq_over_nccl_equal_stage_0(nccl, what):
    """The Adam sweep (one launch a step) and MoQ (one quantize call a
    step, bits 12 -> 11 at step 2) at stage 3 over NCCL world 1 equal
    stage 0 without a process group bit for bit."""
    over = {"quantize_training": MOQ} if what == "moq" else {}
    form = "sweep" if what == "sweep" else "fused"
    want = _run(_config(0, form=form, **over))
    assert want[2].get("adam") == STEPS
    if what == "moq":
        assert want[2].get("quantize") == STEPS
    nccl()
    got = _run(_config(3, form=form, **over))
    assert got[0] == want[0]
    for k, p in want[1].items():
        assert torch.equal(got[1][k], p), k
    assert got[2] == want[2]


def test_layered_offload_against_the_resident_layers(card, tmp_path):
    """4 blocks streamed from pinned host RAM: losses within 2e-4 of the
    resident oracle's and the masters after the last update within
    ``OFFLOAD_MASTER_RTOL`` of the oracle's change, leaf by leaf
    (``chip_smoke.master_gaps``); at most two layers on the card; 2 flash forwards
    (the sweep and the recompute) and 1 backward a block a step, no Adam
    launch; NVMe masters bit-equal to RAM."""
    cfg = dataclasses.replace(CFG, n_layer=4)
    # a batch of its own each step: a gradient copy read a step stale
    # would not show with one batch repeated
    batches = [gpt2.synthetic_batch(4, 256, cfg.vocab_size, seed=1 + k)
               for k in range(STEPS)]

    def make(nvme=None):
        off = {"device": "cpu"} if nvme is None else {
            "device": "nvme", "nvme_path": str(nvme)}
        return deepspeed_tpu_torch.initialize(
            model=gpt2.gpt2_offload_layers(cfg), sample_batch=batches[0],
            input_fn=lambda b: b["input_ids"],
            config={"train_batch_size": 4, "bf16": {"enabled": True},
                    "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                    "zero_optimization": {"stage": 3,
                                          "offload_param": off}})[0]

    engine = make()
    want, p0, final = chip_smoke.resident_oracle(torch, engine, batches,
                                                 lr=1e-3)
    op_builder.reset_launch_counts()
    losses = [float(engine.train_batch(b)) for b in batches]
    assert dict(op_builder.LAUNCHES) == {
        "flash_fwd": 2 * cfg.n_layer * STEPS,
        "flash_bwd_dq": cfg.n_layer * STEPS,
        "flash_bwd_dkv": cfg.n_layer * STEPS}
    for a, b in zip(losses, want):
        assert abs(a - b) <= 2e-4 * abs(b), (losses, want)
    gaps = chip_smoke.master_gaps(torch, engine, p0, final)
    print("master gaps:", gaps)
    chip_smoke.check_master_gaps(gaps, chip_smoke.OFFLOAD_MASTER_RTOL,
                                 "4 blocks")
    store = engine.store
    layer_bytes = sorted((sum(math.prod(s) for s in meta) * 2
                          for meta in store._meta), reverse=True)
    assert store.peak_live_bytes <= layer_bytes[0] + layer_bytes[1]
    assert store.live_bytes == 0 and engine.last_host_ms > 0
    nvme = make(tmp_path)
    got = [float(nvme.train_batch(b)) for b in batches]
    assert got == losses
    for la, lb in zip(nvme.state_dict()["params"],
                      engine.state_dict()["params"]):
        for a, b in zip(la, lb):
            assert (a == b).all()
    nvme.close()
