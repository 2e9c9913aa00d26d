"""Where the training loop's time goes on one card: GPT-2 medium through
``engine.forward`` / ``backward`` / ``step`` (bf16 over fp32 masters,
ZeRO 1, Adam ``sweep`` lr 1e-4, clip 1.0, train batch 8 × 1024), one
engine a variant, all built first and then timed in turns (each variant
``--steps`` steps a round, ``--rounds`` rounds, after two warm-up steps):

* ``gas1``: micro-batch 8, no dropout, no remat (``chip_smoke.py`` phase
  6's step, through the loop);
* ``gas2``: micro-batch 4, gas 2, no dropout, no remat;
* ``gas2_dropout``: gas 2, dropout 0.1 at GPT-2's 49 sites;
* ``gas2_dropout_remat``: gas 2, dropout 0.1, each block recomputed
  (``checkpointing.remat``, the kept design: the block's tensors put
  back into its own parameter slots for the recompute);
* ``gas2_dropout_remat_fcall``: the same with the first design, which
  bound them with ``torch.func.functional_call`` over an adapter module.

Per variant: the median step ms, tokens/s, and one profiled step (device
busy ms, idle share, device ms by kernel group). The remat variants'
losses are held equal to ``gas2_dropout``'s (bit-equal expected). Needs
one NVIDIA H100::

    python tests/perf/torch_loop_variants.py [--steps 5 --rounds 2]
"""
import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import torch
from torch import nn
from torch.func import functional_call

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
from chip_smoke import card_line, device_profile  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.models import gpt2  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing  # noqa: E402

SEQ, BATCH, LR = 1024, 8, 1e-4


class _Method(nn.Module):
    """The first design's adapter: a module's method as a module."""

    def __init__(self, module, method):
        super().__init__()
        self.m = module
        self.method = method

    def forward(self, *args):
        return getattr(self.m, self.method)(*args)


def remat_fcall(module, *args, method="forward"):
    """The first design of ``checkpointing.remat``: the tensors bound
    with ``functional_call`` in the forward and the recompute, the global
    RNG state saved and restored by ``torch.utils.checkpoint``."""
    bound = _Method(module, method)
    tensors = {f"m.{k}": t for k, t in module.named_parameters()}
    tensors.update({f"m.{k}": t for k, t in module.named_buffers()})

    def run(*a):
        return functional_call(bound, tensors, a)
    return checkpointing._checkpointed(run, args, preserve_rng_state=True)


VARIANTS = {
    "gas1": dict(micro=8, p=0.0, remat=False),
    "gas2": dict(micro=4, p=0.0, remat=False),
    "gas2_dropout": dict(micro=4, p=0.1, remat=False),
    "gas2_dropout_remat": dict(micro=4, p=0.1, remat=True),
    "gas2_dropout_remat_fcall": dict(micro=4, p=0.1, remat=True,
                                     fcall=True),
}


def make(cfg, v):
    model = gpt2.GPT2LMHeadModel(dataclasses.replace(
        cfg, dropout=v["p"], remat=v["remat"]), seed=0)
    config = {"train_batch_size": BATCH,
              "train_micro_batch_size_per_gpu": v["micro"],
              "steps_per_print": 10 ** 9, "bf16": {"enabled": True},
              "zero_optimization": {"stage": 1}, "gradient_clipping": 1.0,
              "optimizer": {"type": "Adam", "params": {"lr": LR,
                                                       "sweep": True}}}
    return deepspeed_tpu_torch.initialize(model=model, config=config)[0]


def step(engine, micros, fcall):
    """One global step of the loop; the mean micro-batch loss."""
    kept = gpt2.remat
    if fcall:
        gpt2.remat = remat_fcall
    try:
        losses = []
        for m in micros:
            loss = engine.forward(m)
            engine.backward(loss)
            losses.append(loss.detach())
        engine.step()
    finally:
        gpt2.remat = kept
    return torch.stack(losses).mean()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    op_builder.load_kernels()
    cfg = gpt2.PRESETS["gpt2-medium"]
    batch = gpt2.synthetic_batch(BATCH, SEQ, cfg.vocab_size, seed=4)
    engines, micros, ms, losses = {}, {}, {}, {}
    for name, v in VARIANTS.items():
        engines[name] = make(cfg, v)
        micros[name] = [{"input_ids": batch["input_ids"][i:i + v["micro"]]}
                        for i in range(0, BATCH, v["micro"])]
        losses[name] = [float(step(engines[name], micros[name],
                                   v.get("fcall", False)))
                        for _ in range(2)]
        ms[name] = []
    for _ in range(args.rounds):
        for name, v in VARIANTS.items():
            for _ in range(args.steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = step(engines[name], micros[name],
                            v.get("fcall", False))
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
                losses[name].append(float(loss))
    out = {"card": card, "config": "gpt2-medium bs 8 x 1024 bf16 zero1 "
                                   "adam-sweep lr 1e-4 clip 1.0",
           "variants": {}}
    for name, v in VARIANTS.items():
        prof = device_profile(torch, lambda: step(
            engines[name], micros[name], v.get("fcall", False)))
        med = statistics.median(ms[name])
        out["variants"][name] = {
            **{k: x for k, x in v.items()}, "step_ms": ms[name],
            "step_ms_median": med, "tokens_per_s": BATCH * SEQ / med * 1e3,
            "losses": losses[name],
            "profile": {k: prof[k] for k in (
                "wall_ms", "device_busy_ms", "device_idle_share",
                "device_ms_by_group")}}
        print(f"{name}: {med:.1f} ms (idle share "
              f"{prof['device_idle_share']})", flush=True)
    want = losses["gas2_dropout"]
    for name in ("gas2_dropout_remat", "gas2_dropout_remat_fcall"):
        if losses[name] != want:
            raise AssertionError(f"{name} losses {losses[name]} != "
                                 f"gas2_dropout's {want}")
    print(json.dumps({"loop_variants": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
