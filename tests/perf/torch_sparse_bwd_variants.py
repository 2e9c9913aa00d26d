"""Variants of the bf16 block-sparse dq and dk/dv kernels
(``deepspeed_tpu_torch/csrc/sparse_attention.cu``), timed in turns against
the kept source at the sparse BERT-large and GPT-2 medium paths' shapes.

Each variant is the kept source with one change: dk/dv capped at three
CTAs an SM (``__launch_bounds__(128, 3)``), a 2-stage ring, or the grid in
index order instead of longest segment first. Each is built with nvcc
into its own library under ``build/sparse_variants/`` (plain C interface,
loaded with ctypes) and swapped in under the package's wrappers; every
variant's dq, delta, dk and dv must equal the kept kernels' bit for bit.
Times: CUDA events over 30 calls of the wrapper, two readings a variant
(variants in order, then in reverse). Needs one NVIDIA H100 and nvcc::

    python tests/perf/torch_sparse_bwd_variants.py
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
from deepspeed_tpu_torch.ops import op_builder  # noqa
from deepspeed_tpu_torch.ops.sparse_attention import fused_kernels as sfk  # noqa
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as ssc  # noqa

CSRC = os.path.join(ROOT, "deepspeed_tpu_torch", "csrc")
SRC = os.path.join(CSRC, "sparse_attention.cu")
OUT = os.path.join(ROOT, "build", "sparse_variants")
base = open(SRC).read()
VARIANTS = {
    "kept": base,
    "dkv_3ctas": base.replace(
        "__launch_bounds__(kThreads) sparse_dkv_bf16",
        "__launch_bounds__(kThreads, 3) sparse_dkv_bf16"),
    "stages2": base.replace("constexpr int kStages = 3;",
                            "constexpr int kStages = 2;"),
    "index_order": base.replace("const int seg = a.order[blockIdx.x / a.B];",
                                "const int seg = blockIdx.x / a.B;"),
}


def build(name, src):
    os.makedirs(OUT, exist_ok=True)
    path = f"{OUT}/{name}.cu"
    with open(path, "w") as f:
        f.write(src)
    so = f"{OUT}/{name}.so"
    r = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "-gencode=arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "--expt-relaxed-constexpr", "-shared",
         "-Xcompiler", "-fPIC", f"-I{CSRC}", "-Xptxas", "-v",
         "-o", so, path], capture_output=True, text=True)
    if r.returncode:
        print(r.stderr[-2000:])
        raise SystemExit(f"{name} failed to build")
    # registers and spills of the bf16 dq and dk/dv kernels at D 64
    regs, spills, fn = {}, {}, None
    for ln in r.stderr.splitlines():
        if "Compiling entry function" in ln:
            fn = next((k for k in ("sparse_dq_bf16ILi64", "sparse_dkv_bf16ILi64")
                       if k in ln), None)
        elif fn and "spill stores" in ln:
            spills[fn[:-5]] = ln.strip()
        elif fn and "Used" in ln:
            regs[fn[:-5]] = ln.split("Used ")[1].split(",")[0]
    lib = ctypes.CDLL(os.path.abspath(so))
    for n in ("ds_sparse_fwd", "ds_sparse_dq", "ds_sparse_dkv"):
        getattr(lib, n).argtypes = op_builder._SIGNATURES[n]
        getattr(lib, n).restype = ctypes.c_int
    return lib, regs, spills


def ms(fn, iters=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip(), flush=True)
assert all(src != base for name, src in VARIANTS.items() if name != "kept")
libs = {}
for name, src in VARIANTS.items():
    libs[name], regs, spills = build(name, src)
    print(name, "D 64:", regs, spills, flush=True)

H, D = 16, 64
gen = torch.Generator(device="cuda").manual_seed(5)
cases = []
lay = ssc.FixedSparsityConfig(num_heads=H, block=64, num_local_blocks=4,
                              num_global_blocks=1).make_layout(2048) != 0
cases.append(("bert", 4, 2048, sfk._get_plan(lay, 64, False, None,
                                              "cuda:0").strat))
glay, gb = sfk.sparse_mode_layout("sparse:1024/128", H, 4096)
cases.append(("gpt2", 2, 4096, sfk._get_plan(np.asarray(glay) != 0, gb, True,
                                              None, "cuda:0").strat))
out = {}
for cname, B, S, strat in cases:
    q, do = (torch.randn(B, H, S, D, generator=gen, device="cuda")
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, H, strat.Skv, D, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    op_builder._lib = libs["kept"]
    o, lse = sfk.sparse_attention_fwd(q, k, v, None, strat)
    ref = sfk.sparse_attention_dq(q, k, v, None, do, o, lse, strat)
    ref = ref + sfk.sparse_attention_dkv(q, k, v, None, do, lse, ref[1],
                                         strat)[:2]
    times = {n: {"dq": [], "dkv": []} for n in libs}
    for rnd in range(2):
        names = list(libs) if rnd == 0 else list(reversed(list(libs)))
        for n in names:
            op_builder._lib = libs[n]
            got = sfk.sparse_attention_dq(q, k, v, None, do, o, lse, strat)
            got = got + sfk.sparse_attention_dkv(q, k, v, None, do, lse,
                                                 got[1], strat)[:2]
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            times[n]["dq"].append(ms(lambda: sfk.sparse_attention_dq(
                q, k, v, None, do, o, lse, strat)))
            times[n]["dkv"].append(ms(lambda: sfk.sparse_attention_dkv(
                q, k, v, None, do, lse, ref[1], strat)))
            if not same:
                raise SystemExit(f"variant {n} differs from the kept kernels")
    out[cname] = times
    print(cname, json.dumps(times), flush=True)
op_builder._lib = None
print(json.dumps({"variants": out}))
