"""The per-rank state footprint of a ZeRO engine, from shapes alone
(counterpart of ``deepspeed_tpu/runtime/zero/aot_check.py``'s
``state_footprint_per_chip``, :47-59).

The model is built on the ``meta`` device (no storage) and cut with the
engine's own partition rule (``runtime/zero/partition.ZeroPartition``) at
a given world size and rank, with no process group: the bytes one rank
of that world keeps for

* ``params``: the fp32 masters (at stage 3 this rank's slices, a tensor
  below ``param_persistence_threshold`` elements whole; below stage 3
  every tensor whole);
* ``opt_state``: the optimizer's fp32 moments (Adam: 2), over the
  optimizer's view of the masters (from stage 1 this rank's slices of
  the engine's partition; the step count is a host int, no device
  bytes);
* ``acc_grads``: the fp32 gradients (from stage 2 this rank's slices);

and their ``total``. These are the engine's rules (``runtime/engine.py``:
one partition, with stage 3's persistence threshold, cuts the masters,
the moments and the gradients), so they differ from JAX's where its
layout differs: JAX cuts the moments and the gradient accumulator of
every tensor (``min_numel`` 0, engine.py:1116-1129) and keeps Adam's
step as a 4-byte device scalar, where the port keeps a persistent
tensor's moments and gradient whole beside its master.

JAX's lowering of the step, its compile and its HLO collective census
are XLA's: they are not ported (the port has no ahead-of-time program to
inspect; its collectives are ``torch.distributed`` calls, one a process
group a step).

Run as a module for GPT-2 1.5B (``gpt2-xl``) at world 16, stage 3::

    python -m deepspeed_tpu_torch.runtime.zero.aot_check
"""

import argparse
import json

from deepspeed_tpu_torch.runtime.zero.partition import ZeroPartition


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def state_footprint_per_rank(model, world, rank=0, stage=3,
                             param_persistence_threshold=int(1e5),
                             moments=2):
    """``{"params", "opt_state", "acc_grads", "total"}`` in bytes, of rank
    ``rank`` of ``world`` at ZeRO ``stage``, for ``model`` (any module,
    best built on the ``meta`` device). ``moments``: the optimizer's fp32
    states a parameter (Adam 2)."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    part = None
    if stage >= 1:
        part = ZeroPartition(
            shapes, world, rank,
            min_numel=param_persistence_threshold if stage == 3 else 0)

    def numel(sliced):
        if part is None or not sliced:
            return sum(_numel(s) for s in shapes.values())
        return sum(_numel(part.local_shape(n)) for n in shapes)

    fp32 = 4
    out = {"params": numel(stage == 3) * fp32,
           "opt_state": moments * numel(stage >= 1) * fp32,
           "acc_grads": numel(stage >= 2) * fp32}
    out["total"] = sum(out.values())
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="per-rank ZeRO state bytes of a GPT-2 preset")
    parser.add_argument("--preset", default="gpt2-xl")
    parser.add_argument("--world", type=int, default=16)
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--stage", type=int, default=3)
    parser.add_argument("--persistence-threshold", type=int,
                        default=int(1e5))
    args = parser.parse_args(argv)
    from deepspeed_tpu_torch.models import gpt2
    cfg = gpt2.PRESETS[args.preset]
    model = gpt2.GPT2LMHeadModel(cfg, device="meta")
    state = state_footprint_per_rank(
        model, args.world, args.rank, args.stage,
        args.persistence_threshold)
    print(json.dumps({
        "config": {"model": args.preset, "n_embd": cfg.n_embd,
                   "n_layer": cfg.n_layer, "n_head": cfg.n_head,
                   "world": args.world, "rank": args.rank,
                   "zero_stage": args.stage,
                   "param_persistence_threshold":
                       args.persistence_threshold,
                   "dtype": "fp32 masters, moments and gradients"},
        "n_params": sum(p.numel() for p in model.parameters()),
        "per_rank_state_bytes": state}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
