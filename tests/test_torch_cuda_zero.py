"""ZeRO stages 2 and 3 and the optimizer offload on the card, at world
size 1 over NCCL (one card takes one rank). Every test carries the
``cuda`` marker and skips without a card. This file imports no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_zero.py

A 4-layer GPT-2 of width 256 in bf16 over fp32 masters, fused Adam (the
``ds_adam_multi`` kernel) and clip 1.0, 3 steps. At world 1 every tensor
is one rank's whole slice, so stages 2 and 3 run their collectives
(reduce-scatter, the stage-3 gather and its backward) on one rank and
must equal stage 0 without a process group bit for bit: losses and
masters. The offload runs the host CPU-Adam on the same gradients: its
losses within 2e-4 relative (the JAX suite's offload tolerance,
tests/model/test_loss_parity.py:124).
"""

import dataclasses

import pytest
import torch

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


def _config(stage, offload=None):
    zero = {"stage": stage, "stage3_param_persistence_threshold": 1000}
    if offload is not None:
        zero["offload_optimizer"] = offload
    return {"train_batch_size": 4, "steps_per_print": 10 ** 9,
            "bf16": {"enabled": True}, "gradient_clipping": 1.0,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3,
                                                     "fused": True}},
            "zero_optimization": zero}


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
