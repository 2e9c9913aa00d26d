"""The fp32 BigBird check of ``tests/test_torch_cuda_kernels.py``
(``test_fused_sparse_attention_gradients_on_cuda``: the whole fused form
on the card against the same function on CPU tensors) over layout seeds
0-63, each route also held against a float64 dense reference of the same
attention. Both routes about equally far from float64 means the
card-vs-CPU difference is summation order; a missed or doubled pair, or
a fault in the dense global-row part, would put one route far off.

Prints a line a seed (card-CPU / card-f64 / CPU-f64 max abs difference
of out, dq, dk, dv and the bias gradient, and the largest ratio of a
difference to the test's 2e-5 tolerance) and a summary; writes the
per-seed record to the JSON path given as the first argument, if any.
Needs one CUDA card::

    python tests/perf/torch_sparse_bigbird_sweep.py [out.json]
"""
import json
import os
import random
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from deepspeed_tpu_torch.ops.sparse_attention import fused_kernels as sfk  # noqa
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as ssc  # noqa
from deepspeed_tpu_torch.ops.sparse_attention import kernels as sk  # noqa

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip(), flush=True)
# the test's shapes and inputs: H 2, S 512, D 64, BigBird block 32 with one
# random block, inputs from a CUDA generator seeded 0
H, SEQ, D = 2, 512, 64
gen = torch.Generator(device="cuda").manual_seed(0)
x = [torch.randn(2, H, SEQ, D, generator=gen, device="cuda")
     for _ in range(4)]
kpb = torch.randn(2, SEQ, generator=gen, device="cuda")


def run(lay, block, dev, causal=False):
    t = [a.detach().to(dev).requires_grad_() for a in x[:3] + [kpb]]
    out = sfk.block_sparse_attention_fused(t[0], t[1], t[2], lay,
                                           key_padding_bias=t[3],
                                           block=block, causal=causal)
    out.backward(x[3].to(dev))
    return [out.detach().cpu().double()] + [a.grad.cpu().double() for a in t]


def ref64(lay, block, causal=False):
    t = [a.detach().cpu().double().requires_grad_() for a in x[:3] + [kpb]]
    mask = torch.from_numpy(sk.layout_to_dense_mask(lay, block, SEQ)).bool()
    if causal:
        mask = mask & torch.tril(torch.ones(SEQ, SEQ, dtype=torch.bool))
    s = t[0] @ t[1].transpose(-1, -2) * D ** -0.5
    s = torch.where(mask[None], s, -1e30) + t[3][:, None, None, :]
    out = torch.softmax(s, -1) @ t[2]
    out.backward(x[3].cpu().double())
    return [out.detach()] + [a.grad for a in t]


names = ["out", "dq", "dk", "dv", "dkpb"]
rows = []
for seed in range(64):
    random.seed(seed)
    lay = ssc.BigBirdSparsityConfig(num_heads=H, block=32,
                                    num_random_blocks=1).make_layout(SEQ)
    g, c, r = run(lay, 32, "cuda"), run(lay, 32, "cpu"), ref64(lay, 32)
    row = {"seed": seed}
    for n, a, b, w in zip(names, g, c, r):
        err = (a - b).abs()
        row[n] = {
            "card_cpu": err.max().item(),
            "ratio_2e5": (err / (2e-5 + 2e-5 * b.abs())).max().item(),
            "n_over": int((err > 2e-5 + 2e-5 * b.abs()).sum()),
            "card_f64": (a - w).abs().max().item(),
            "cpu_f64": (b - w).abs().max().item(),
            "card_f64_ratio": ((a - w).abs() / (1e-6 + w.abs())).max().item(),
            "ref_max": w.abs().max().item(),
        }
    rows.append(row)
    worst = max(row[n]["ratio_2e5"] for n in names)
    print(f"seed {seed}: worst ratio at 2e-5 {worst:.3f} " + " ".join(
        f"{n}:{row[n]['card_cpu']:.2e}/{row[n]['card_f64']:.2e}/"
        f"{row[n]['cpu_f64']:.2e}" for n in names), flush=True)
if len(sys.argv) > 1:
    with open(sys.argv[1], "w") as f:
        json.dump(rows, f)
fails = [r["seed"] for r in rows
         if any(r[n]["n_over"] for n in names)]
print("seeds over 2e-5:", fails)
for n in names:
    print(n, "max card-cpu", max(r[n]["card_cpu"] for r in rows),
          "max card-f64", max(r[n]["card_f64"] for r in rows),
          "max cpu-f64", max(r[n]["cpu_f64"] for r in rows),
          "max ratio", max(r[n]["ratio_2e5"] for r in rows))
