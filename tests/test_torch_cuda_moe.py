"""MoE-GPT on the card: its training step on the CUDA kernels (flash
attention forward and backward, the Adam kernels) against the same step
on the CPU's plain versions. Every test carries the ``cuda`` marker and
skips without a card. This file imports no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_moe.py

Tolerances: fp32 loss and gradients at rtol = atol = 1e-4 (the flash
kernels' fp32 outputs are within 2e-5 of the plain version's; a gate's
argmax reads logits that differ in the last bits, and none of these
inputs sits on a tie); the losses and masters after 3 AdamW steps at
1e-4. bf16: the
scatter and einsum impls give the same loss bit for bit (each token has
one slot), and the grouped impl within 2e-2.
"""

import dataclasses

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.ops import op_builder

pytestmark = pytest.mark.cuda

CFG = gpt2.GPT2Config(vocab_size=512, n_positions=256, n_embd=256,
                      n_layer=2, n_head=4, moe_num_experts=4,
                      moe_expert_interval=1, moe_capacity_factor=1.0)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _batch(device, seed=0):
    return gpt2.synthetic_batch(4, 128, CFG.vocab_size, seed=seed,
                                device=device)


@pytest.mark.parametrize("impl", ["scatter", "einsum", "grouped"])
@pytest.mark.parametrize("k", [1, 2])
def test_loss_and_grads_match_the_plain_path(card, impl, k):
    cfg = dataclasses.replace(CFG, moe_dispatch_impl=impl, moe_k=k)
    cpu = gpt2.GPT2LMHeadModel(cfg, device="cpu", seed=0)
    gpu = gpt2.GPT2LMHeadModel(cfg, device="cuda", seed=0)
    gpu.load_state_dict(cpu.state_dict())
    op_builder.reset_launch_counts()
    losses = []
    for m, dev in ((cpu, "cpu"), (gpu, "cuda")):
        loss = m(_batch(dev))
        loss.backward()
        losses.append(loss.item())
    assert op_builder.LAUNCHES.get("flash_fwd", 0) == cfg.n_layer
    assert op_builder.LAUNCHES.get("flash_bwd_dq", 0) == cfg.n_layer
    torch.testing.assert_close(losses[1], losses[0], **TOL)
    for (n, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        torch.testing.assert_close(q.grad.cpu(), p.grad, msg=n, **TOL)


def _engine(device, impl="scatter", bf16=False, cf=1.0):
    cfg = dataclasses.replace(CFG, moe_dispatch_impl=impl,
                              moe_capacity_factor=cf)
    config = {"train_batch_size": 4, "gradient_clipping": 1.0,
              "optimizer": {"type": "AdamW", "params": {
                  "lr": 1e-3, "weight_decay": 0.01, "fused": True}}}
    if bf16:
        config["bf16"] = {"enabled": True}
    # the same weights on both devices (their generators draw apart)
    init = gpt2.GPT2LMHeadModel(cfg, device="cpu", seed=0).state_dict()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2.GPT2LMHeadModel(cfg, device=device, seed=0),
        config=config, model_parameters=init, device=device)
    return engine


def test_engine_steps_match_the_plain_path(card):
    """3 fp32 ``train_batch`` steps at a capacity where no token drops
    (capacity factor 4 = the expert count), so the RTS priorities, which
    the CPU and CUDA generators draw differently, cannot change a slot's
    use: the card's losses and masters within 1e-4 of the CPU's."""
    runs = []
    for dev in ("cpu", "cuda"):
        engine = _engine(dev, cf=4.0)
        losses = [float(engine.train_batch(batch=_batch(dev, seed=i)))
                  for i in range(3)]
        runs.append((losses, {k: p.detach().cpu()
                              for k, p in engine.params.items()}))
    torch.testing.assert_close(runs[1][0], runs[0][0], **TOL)
    for k, p in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][k], p, msg=k, **TOL)


def test_bf16_dispatch_impls_agree(card):
    """bf16 on the card: scatter = einsum bit for bit, grouped within
    2e-2, for the loss of one batch in eval."""
    losses = {}
    for impl in ("scatter", "einsum", "grouped"):
        engine = _engine("cuda", impl, bf16=True)
        losses[impl] = float(engine.eval_batch(_batch("cuda")))
    assert losses["scatter"] == losses["einsum"]
    assert abs(losses["grouped"] - losses["scatter"]) <= 2e-2
