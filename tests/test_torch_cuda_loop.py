"""The training loop's recompute on the card: what activation
checkpointing needs of the kernels, and dropout on CUDA tensors. Every
test carries the ``cuda`` marker and skips without a card. This file
imports no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_loop.py

A recompute is exact only if each kernel's forward gives the same bits
when it runs again: the flash forward (o and lse) and the fused layer's
LayerNorm and bias-GeLU kernels. With that, gradients with and without
checkpointing are bit-equal (atol 0) with dropout 0.1 on: the masks are
drawn again from the same (seed, micro-step, site) key.

Checkpoints on the card: a tag saved after 3 steps loads into an engine
built from another init seed, and its next 3 steps on the kernels (Adam's
sweep, the fused per-tensor Adam, fused LAMB; dropout 0.1) are bit-equal
to the uninterrupted run's, launches included. An async save's snapshot
goes into pinned host buffers by non-blocking copies; the stream is
synchronised before the background persist reads them, and the step after
the save (which updates the masters in place) does not reach the files.

Data parallelism on the card's one device: the lse gradient's backward
kernels against their plain version, and ZeRO 1 at world size 1 over
NCCL bit-equal to the engine without a process group.
"""

import dataclasses
import time

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.transformer import flash, transformer
from deepspeed_tpu_torch.runtime import checkpoint_io, dropout

pytestmark = pytest.mark.cuda

CFG = gpt2.GPT2Config(vocab_size=512, n_positions=256, n_embd=256,
                      n_layer=2, n_head=4)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("causal,seq", [(True, 256), (False, 128),
                                        (True, 200)])
def test_flash_forward_is_bit_equal_on_rerun(gen, causal, seq):
    q, k, v = (torch.randn(2, 4, seq, 64, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    o1, lse1 = flash.flash_attention_fwd(q, k, v, causal)
    o2, lse2 = flash.flash_attention_fwd(q, k, v, causal)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


@pytest.mark.parametrize("pre_ln", [False, True])
def test_fused_layer_forward_is_bit_equal_on_rerun(gen, pre_ln):
    cfg = transformer.DeepSpeedTransformerConfig(
        hidden_size=256, heads=4, pre_layer_norm=pre_ln)
    layer = transformer.DeepSpeedTransformerLayer(cfg, device="cuda",
                                                  dtype=torch.bfloat16)
    layer.reset_parameters(gen)
    x = torch.randn(4, 128, 256, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    op_builder.reset_launch_counts()
    with torch.no_grad():
        a, b = layer(x), layer(x)
    assert torch.equal(a, b)
    assert op_builder.LAUNCHES["ln_fwd"] == 4
    assert op_builder.LAUNCHES["bias_gelu"] == 2
    assert op_builder.LAUNCHES["flash_fwd"] == 2


def _engine(remat, p=0.1):
    model = gpt2.GPT2LMHeadModel(dataclasses.replace(CFG, dropout=p,
                                                     remat=remat), seed=0)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config={
        "train_batch_size": 4, "bf16": {"enabled": True},
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}})
    return engine


def test_gpt2_block_gradients_bit_equal_with_checkpointing(gen):
    """One micro-batch through the engine (bf16 over fp32 masters,
    dropout 0.1): loss and every master gradient with each block
    recomputed equal the stored-activation run's; the recompute runs the
    flash forward again (two launches a block)."""
    batch = gpt2.synthetic_batch(4, 256, CFG.vocab_size, seed=1)
    out, launches = [], []
    for remat in (False, True):
        engine = _engine(remat)
        op_builder.reset_launch_counts()
        loss = engine.forward(batch)
        engine.backward(loss)
        torch.cuda.synchronize()
        launches.append(dict(op_builder.LAUNCHES))
        out.append((loss.detach(), {k: p.grad.clone()
                                    for k, p in engine.params.items()}))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k
    n = CFG.n_layer
    assert launches[0]["flash_fwd"] == n and launches[1]["flash_fwd"] == 2 * n
    assert launches[0]["flash_bwd_dq"] == launches[1]["flash_bwd_dq"] == n


@pytest.mark.parametrize("knob", ["normalize_invertible", "gelu_checkpoint"])
def test_fused_layer_gradients_bit_equal_with_checkpointing(gen, knob):
    base = transformer.DeepSpeedTransformerConfig(
        hidden_size=256, heads=4, attn_dropout_ratio=0.1,
        hidden_dropout_ratio=0.1)
    x = torch.randn(4, 128, 256, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    init = None
    out = []
    for cfg in (base, dataclasses.replace(base, **{knob: True})):
        layer = dropout.number_sites(transformer.DeepSpeedTransformerLayer(
            cfg, device="cuda", dtype=torch.bfloat16))
        if init is None:
            init = {k: v.clone() for k, v in layer.state_dict().items()}
        layer.load_state_dict(init)
        xs = x.clone().requires_grad_(True)
        with dropout.key_scope((7, 3)):
            y = layer(xs)
        (y.float() ** 2).mean().backward()
        out.append([y.detach(), xs.grad] + [p.grad for p in
                                            layer.parameters()])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_dropout_on_cuda_tensors(gen):
    x = torch.ones(4, 1024, 1024, device="cuda", dtype=torch.bfloat16)
    with dropout.key_scope((42, 0)):
        y = dropout.dropout(x, 0.1, site=0)
        again = dropout.dropout(x, 0.1, site=0)
        other = dropout.dropout(x, 0.1, site=1)
    share = (y != 0).float().mean().item()
    assert abs(share - 0.9) < 0.001
    assert torch.equal(y, again) and not torch.equal(y, other)
    kept = y[y != 0]
    assert torch.equal(kept, torch.full_like(kept, 1.0 / 0.9))
    assert y.dtype == torch.bfloat16 and y.is_cuda


def test_loop_equals_train_batch_on_the_card(gen):
    batch = gpt2.synthetic_batch(4, 256, CFG.vocab_size, seed=2)
    a, b = _engine(False, p=0.0), _engine(False, p=0.0)
    for _ in range(3):
        want = a.train_batch(batch=batch)
        loss = b.forward(batch)
        b.backward(loss)
        b.step()
        assert torch.equal(loss.detach(), want)
    for x, y in zip(a.module.parameters(), b.module.parameters()):
        assert torch.equal(x, y)


def _ckpt_engine(seed, opt, **over):
    model = gpt2.GPT2LMHeadModel(dataclasses.replace(CFG, dropout=0.1),
                                 seed=seed)
    cfg = {"train_batch_size": 4, "bf16": {"enabled": True},
           "steps_per_print": 10 ** 9, "gradient_clipping": 1.0,
           "optimizer": opt}
    cfg.update(over)
    return deepspeed_tpu_torch.initialize(model=model, config=cfg)[0]


def _ckpt_batches(n):
    return [gpt2.synthetic_batch(4, 128, CFG.vocab_size, seed=10 + i)
            for i in range(n)]


@pytest.mark.parametrize("opt", [
    {"type": "Adam", "params": {"lr": 1e-3, "sweep": True}},
    {"type": "Adam", "params": {"lr": 1e-3, "fused": True}},
    {"type": "Lamb", "params": {"lr": 1e-3, "fused": True}},
], ids=["sweep", "fused_adam", "fused_lamb"])
def test_resume_is_bit_equal_on_the_kernels(gen, tmp_path, opt):
    batches = _ckpt_batches(6)
    ref = _ckpt_engine(0, opt)
    for b in batches[:3]:
        ref.train_batch(batch=b)
    ref.save_checkpoint(str(tmp_path))
    op_builder.reset_launch_counts()
    want = [ref.train_batch(batch=b) for b in batches[3:]]
    want_counts = dict(op_builder.LAUNCHES)
    resumed = _ckpt_engine(1, opt)
    resumed.load_checkpoint(str(tmp_path))
    op_builder.reset_launch_counts()
    got = [resumed.train_batch(batch=b) for b in batches[3:]]
    assert dict(op_builder.LAUNCHES) == want_counts
    assert want_counts["flash_fwd"] == 3 * CFG.n_layer
    assert want_counts[opt["type"].lower()] == 3
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    for k, p in ref.params.items():
        assert torch.equal(p, resumed.params[k]), k
    mu_a, mu_b = ref.opt_state.mu, resumed.opt_state.mu
    if isinstance(mu_a, dict):
        assert all(torch.equal(mu_a[k], mu_b[k]) for k in mu_a)
    else:
        assert torch.equal(mu_a, mu_b)


@pytest.mark.parametrize("delay_s", [0.0, 0.3])
def test_async_snapshot_is_synchronised_and_owns_its_bytes(
        gen, tmp_path, monkeypatch, delay_s):
    """The persist starts at once (delay 0: it would read pinned buffers
    a DMA is still filling if the stream were not synchronised) or after
    the next step has updated the masters in place (delay 0.3 s): the
    files hold the masters and moments at the save."""
    opt = {"type": "Adam", "params": {"lr": 1e-3, "sweep": True}}
    batches = _ckpt_batches(3)
    eng = _ckpt_engine(0, opt, checkpoint={"async_save": True})
    for b in batches[:2]:
        eng.train_batch(batch=b)
    at_save = {k: p.detach().clone() for k, p in eng.params.items()}
    mu_at_save = eng.opt_state.mu.clone()
    real_dump = checkpoint_io.dump_file

    def late_dump(obj, path, kind="checkpoint"):
        time.sleep(delay_s)
        return real_dump(obj, path, kind)

    monkeypatch.setattr(checkpoint_io, "dump_file", late_dump)
    eng.save_checkpoint(str(tmp_path), tag="t")
    assert all(buf.is_pinned() for buf in eng._pinned.values())
    eng.train_batch(batch=batches[2])
    eng._ckpt_writer.drain()
    assert not torch.equal(eng.params["wte"], at_save["wte"])
    resumed = _ckpt_engine(1, opt)
    resumed.load_checkpoint(str(tmp_path), tag="t")
    for k, p in at_save.items():
        assert torch.equal(resumed.params[k], p), k
    assert torch.equal(resumed.opt_state.mu, mu_at_save)
    eng.close()


def _close(got, want, tol):
    """|got - want| <= tol + tol * |want| everywhere (chip_smoke's form)."""
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


@pytest.mark.parametrize("B,H,S", [(2, 4, 200), (8, 16, 1024)],
                         ids=["small", "gpt2_medium"])
@pytest.mark.parametrize("causal", [True, False])
def test_lse_gradient_kernels_match_the_plain_version(gen, B, H, S, causal):
    """``flash_attention_with_lse`` under random output and lse cotangents
    (bf16, D 64): the backward kernels' dq, dk, dv against the plain
    backward on the same inputs, o and lse (2e-2, the flash backward's
    bf16 tolerance, as chip_smoke phase 18 holds them); with a zero lse
    cotangent, ``flash_attention``'s gradients bit for bit."""
    q, k, v, g_out = (torch.randn(B, H, S, 64, generator=gen, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(4))
    g_lse = torch.randn(B, H, S, generator=gen, device="cuda")
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o, lse = flash.flash_attention_with_lse(q, k, v, causal)
    got = torch.autograd.grad((o, lse), (q, k, v), (g_out, g_lse))
    qd, kd, vd, od = (t.detach() for t in (q, k, v, o))
    plain = flash.flash_attention_bwd_plain(qd, kd, vd, od, lse.detach(),
                                            g_out, causal, g_lse=g_lse)
    for g, w in zip(got, plain):
        assert _close(g, w, 2e-2)
    zero = torch.autograd.grad(flash.flash_attention_with_lse(
        q, k, v, causal), (q, k, v), (g_out, torch.zeros_like(g_lse)))
    ref = torch.autograd.grad(flash.flash_attention(q, k, v, causal),
                              (q, k, v), g_out)
    assert all(torch.equal(a, b) for a, b in zip(zero, ref))


@pytest.mark.parametrize("opt", [
    {"type": "Adam", "params": {"lr": 1e-3, "sweep": True}},
    {"type": "Adam", "params": {"lr": 1e-3, "fused": True}},
    {"type": "Lamb", "params": {"lr": 1e-3, "fused": True}},
], ids=["sweep", "fused_adam", "fused_lamb"])
def test_world1_nccl_engine_equals_no_process_group(gen, opt):
    """ZeRO 1 at world size 1 over NCCL (the gradient all-reduce, the
    partition's all-gather, LAMB's norm all-reduce, the loss average)
    takes the steps the engine takes without a process group, bit for
    bit: losses, masters and optimizer state."""
    import torch.distributed as dist
    batches = _ckpt_batches(3)
    runs = []
    for grouped in (False, True):
        if grouped:
            deepspeed_tpu_torch.init_distributed()
        try:
            eng = _ckpt_engine(0, opt, zero_optimization={"stage": 1})
            losses = [eng.train_batch(batch=b) for b in batches]
            runs.append((losses, eng))
        finally:
            if grouped:
                dist.destroy_process_group()
    (a, ea), (b, eb) = runs
    assert eb._partition is not None and ea._partition is None
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for k, p in ea.params.items():
        assert torch.equal(p, eb.params[k]), k
    mu_a, mu_b = ea.opt_state.mu, eb.opt_state.mu
    if isinstance(mu_a, dict):
        assert all(torch.equal(mu_a[k], mu_b[k]) for k in mu_a)
    else:
        assert torch.equal(mu_a, mu_b)
