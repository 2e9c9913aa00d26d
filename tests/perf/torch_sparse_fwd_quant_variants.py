"""The bf16 block-sparse forward and the MoQ grouped quantize against their
parent forms and tuning variants, in one process on one card.

The parent commit's kernel sources (all of ``csrc/``) are built with nvcc
from a checkout of it into ``build/sparse_fwd_quant_variants/`` and loaded
with ctypes: its sparse forward goes through the package's own wrapper
(the C interface did not change), its quantizer through the parent's own
``ops/quantizer/quantizer.py`` (loaded from that checkout: two launches a
tensor, 200 a MoQ step). The kept kernels go through the package's
wrappers. Each variant is the kept source with one change, built alone:

* ``fwd_3ctas``: the sparse forward without its cap of four CTAs an SM
  (``__launch_bounds__(128)``: 144 registers, three CTAs);
* ``forward``: the quantizer's rounding launch walking the chunks first
  to last (the kept one walks them last first, where the statistics
  launch's tail may still lie in L2);
* ``chunk32768``: chunks of 32768 elements (the kept 16384; the
  wrapper's ``CHUNK`` set to match).

Every form is held against the plain versions first (the sparse forward
o within 2e-2, lse 2e-5; the quantizer bit-equal per tensor), then timed
in turns by CUDA events:

* the sparse forward at the sparse BERT-large path (B 4, H 16, S 2048,
  D 64, Fixed block 64, window 256, 1 global; the packed lists and the
  raw ones) and the causal sparse GPT-2 path (B 2, S 4096,
  ``sparse:1024/128``, packed): ms over 30 calls, the device time from
  the profiler, the bound, and ``scaled_dot_product_attention`` with the
  layout's boolean mask;
* the quantizer over BERT-large's 100 fp32 masters (groups 8, 10 bits
  nearest, and 6 bits stochastic), in place: the whole step's call
  through the wrapper (``quantize_multi``; the parent's 100 calls of its
  ``quantize``), the C entry alone, the device time of every quantize
  kernel from the profiler, and the wrapper's host time;
* end to end: the sparse BERT-large step (bs 4 x 2048, fused LAMB) and
  the sparse GPT-2 medium step (bs 2 x 4096, Adam sweep) with the parent's
  library swapped in for every kernel, against the kept one, in turns.

Needs one NVIDIA H100, nvcc and a checkout of the parent commit::

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python tests/perf/torch_sparse_fwd_quant_variants.py --parent build/parent
"""
import argparse
import ctypes
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
from chip_smoke import (_device_kernels, bert_config, card_line,  # noqa: E402
                        cuda_ms, host_call_ms, kernel_device_ms,
                        quantize_entry, train_config)
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.models import bert, gpt2  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402
from deepspeed_tpu_torch.ops.quantizer import quantizer  # noqa: E402
from deepspeed_tpu_torch.ops.sparse_attention import \
    fused_kernels as sfk  # noqa: E402
from deepspeed_tpu_torch.ops.sparse_attention import \
    kernels as sk  # noqa: E402
from deepspeed_tpu_torch.ops.sparse_attention import \
    sparsity_config as ssc  # noqa: E402
from deepspeed_tpu_torch.runtime import quantize as quantize_mod  # noqa: E402

OUT = os.path.join(ROOT, "build", "sparse_fwd_quant_variants")
CSRC = os.path.join(ROOT, "deepspeed_tpu_torch", "csrc")
NVCC = "/usr/local/cuda/bin/nvcc"
FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--expt-relaxed-constexpr", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HBM, BF16 = 3.35e12, 989e12
H, D = 16, 64


def compile_async(tag, src, include):
    """Start nvcc on one source; returns (process, object path)."""
    os.makedirs(OUT, exist_ok=True)
    obj = os.path.join(OUT, f"{tag}.o")
    p = subprocess.Popen([NVCC, *FLAGS, f"-I{include}", "-c", src, "-o", obj],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    return p, obj


def finish(name, jobs, signatures):
    """Wait for the objects, link them into ``name``.so, load it and set
    the argtypes of the entry points it holds. Returns (lib, ptxas
    lines of the kernels that matter)."""
    logs = []
    for p, obj in jobs:
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode:
            print(out[-3000:])
            raise SystemExit(f"{name}: {obj} failed to build")
    so = os.path.join(OUT, f"{name}.so")
    r = subprocess.run([NVCC, "-shared", "-o", so, *(o for _, o in jobs)],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stderr[-3000:])
        raise SystemExit(f"{name} failed to link")
    lib = ctypes.CDLL(so)
    for fn, argtypes in signatures.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    regs, fn = {}, None
    for ln in "\n".join(logs).splitlines():
        if "Compiling entry function" in ln:
            fn = next((k for k in ("sparse_fwd_bf16ILi64", "quant_")
                       if k in ln), None)
            if fn:
                fn = ln.split("'")[1] if "'" in ln else fn
        elif fn and "Used" in ln:
            regs[fn] = ln.split("Used ")[1].split(",")[0]
        elif fn and "spill stores" in ln and not ln.strip().startswith("0"):
            regs[fn + " spill"] = ln.strip()
    return lib, regs


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def median(xs):
    return statistics.median(xs)


def turns(forms, fns, reps=2):
    """{form: [ms, ...]}: each form timed in turns, forward then back,
    ``reps`` times (CUDA events, 30 calls a reading)."""
    out = {f: [] for f in forms}
    for _ in range(reps):
        for f in list(forms) + list(reversed(forms)):
            fns[f][0]()
            out[f].append(cuda_ms(fns[f][1], iters=30))
    return out


# ------------------------------------------------------------ sparse forward
def sparse_shapes():
    """(name, B, S, strategy, SDPA element mask) of the two paths."""
    lay = ssc.FixedSparsityConfig(num_heads=H, block=64, num_local_blocks=4,
                                  num_global_blocks=1).make_layout(2048)
    bmask = torch.from_numpy(sk.layout_to_dense_mask(lay, 64, 2048)).cuda() \
        .bool()[None]
    lay = lay != 0
    glay, gb = sfk.sparse_mode_layout("sparse:1024/128", H, 4096)
    gmask = torch.from_numpy(sk.layout_to_dense_mask(glay, gb, 4096)).cuda() \
        .bool().tril()[None]
    return [
        ("bert", 4, 2048, sfk._get_plan(lay, 64, False, None, "cuda:0").strat,
         bmask),
        ("bert_predicated", 4, 2048,
         sfk._get_strategy(lay, 64, False, None, device="cuda:0"), bmask),
        ("gpt2", 2, 4096, sfk._get_plan(np.asarray(glay) != 0, gb, True, None,
                                        "cuda:0").strat, gmask)]


def sparse_forward(libs, gen):
    """Each shape: errors against the plain version, times in turns
    (parent, kept, fwd_3ctas), device times, bound, SDPA with the mask."""
    F = torch.nn.functional
    out = {}
    for name, b, S, strat, mask in sparse_shapes():
        q = torch.randn(b, H, S, D, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, H, S, D, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, H, S, D, generator=gen, device="cuda").bfloat16()
        kp = torch.cat([k, k[:, :, :strat.Skv - S]], 2) if strat.Skv > S else k
        vp = torch.cat([v, v[:, :, :strat.Skv - S]], 2) if strat.Skv > S else v
        o_ref, lse_ref = sfk.sparse_attention_fwd_plain(q, kp, vp, None,
                                                        strat)
        row = {"shape": f"B{b} H{H} S{S} Skv{strat.Skv} D{D} bf16",
               "tile_pairs_a_head": strat.tile_pairs // H}
        fns = {}
        for form, lib in libs.items():
            def use(lib=lib):
                op_builder._lib = lib

            def call():
                return sfk.sparse_attention_fwd(q, kp, vp, None, strat)
            use()
            o, lse = call()
            o2, lse2 = call()
            torch.cuda.synchronize()
            row[f"{form}_err"] = {
                "o": (o.float() - o_ref.float()).abs().max().item(),
                "lse": (lse - lse_ref).abs().max().item(),
                "rerun_bit_equal": bool(torch.equal(o, o2)
                                        and torch.equal(lse, lse2))}
            if not (row[f"{form}_err"]["o"] <= 2e-2 * (1 + o_ref.float().abs()
                                                       .max().item())
                    and row[f"{form}_err"]["lse"] <= 2e-5 * (
                        1 + lse_ref.abs().max().item())):
                raise SystemExit(f"{form} sparse forward disagrees at {name}: "
                                 f"{row[f'{form}_err']}")
            fns[form] = (use, call)
            row[f"{form}_device_ms"] = kernel_device_ms(torch, call,
                                                        "sparse_fwd")
        times = turns(list(libs), fns)
        op_builder._lib = libs["kept"]
        pairs = b * int(strat.element_mask("cuda").sum())
        tq, tk = b * H * S * D * 2, b * H * strat.Skv * D * 2
        nbytes, flops = 2 * tq + 2 * tk + b * H * S * 4, 4 * D * pairs
        bound = max(nbytes / HBM, flops / BF16) * 1e3
        row.update({f"{f}_ms": median(t) for f, t in times.items()})
        row.update(readings=times, live_pairs=pairs, bound_ms=bound,
                   bound_by="bytes" if nbytes / HBM >= flops / BF16
                   else "operations",
                   kept_tflops=flops / median(times["kept"]) / 1e9,
                   sdpa_mask_fwd_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask), iters=10),
                   plain_ms=cuda_ms(lambda: sfk.sparse_attention_fwd_plain(
                       q, kp, vp, None, strat), iters=3))
        print(f"sparse_fwd {name}: {json.dumps(row)}", flush=True)
        out[name] = row
        del q, k, v, kp, vp, o_ref, lse_ref, o, lse, o2, lse2
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ quantizer
def bert_large_masters(gen):
    """Random fp32 tensors of BERT-large's 100 quantized masters' shapes
    (name order) and whether each is stored [out, in]."""
    model = bert.BertForPreTraining(bert.PRESETS["bert-large"], seed=0)
    tr = quantize_mod.transposed_weight_names(model)
    items = [(n, tuple(p.shape)) for n, p in sorted(model.named_parameters())
             if p.dim() >= 2]
    del model
    torch.cuda.empty_cache()
    xs = [torch.randn(*s, generator=gen, device="cuda") * 0.02
          for _, s in items]
    return xs, [n in tr for n, _ in items]


def quant_device_ms(fn, iters=5):
    """Device ms of one call of ``fn``: every quantize kernel's time from
    the profiler, summed, over ``iters`` calls."""
    for _ in range(3):
        evs = [e for e in _device_kernels(torch, fn, iters) if "quant" in e[0]]
        if evs:
            return sum(e[2] for e in evs) / 1e3 / iters, \
                {e[0][:60]: e[1] // iters for e in evs}
    return None, {}


def parent_entry(plib, pq, xs, trs, bits, stochastic):
    """The parent's C entry, two launches a tensor, with its wrapper's
    arguments (in place)."""
    stream = torch.cuda.current_stream().cuda_stream
    calls = []
    for i, (x, tr) in enumerate(zip(xs, trs)):
        n = x.numel()
        part = torch.empty(2 * 8 * -(-(n // 8) // pq.CHUNK), device="cuda")
        rows, cols = x.shape if tr else (n, 1)
        calls.append((part, (x.data_ptr(), x.data_ptr(), part.data_ptr(),
                             part.numel(), n, 8, int(tr), rows, cols, bits,
                             1, int(stochastic), i + 1, 0, 1, stream)))

    def run():
        for _, args in calls:
            if plib.ds_quantize(*args):
                raise RuntimeError("the parent's ds_quantize failed")
    return run


def quantize_timing(libs, plib, pq, gen, stochastic):
    """The MoQ step's quantize at BERT-large's 100 masters: every form
    bit-equal to the plain version, then timed in turns."""
    bits = 6 if stochastic else 10
    xs, trs = bert_large_masters(gen)
    n_el = sum(x.numel() for x in xs)
    seeds = list(range(1, len(xs) + 1))
    kw = dict(stochastic=stochastic, seeds=seeds, transposed=trs)
    want = quantizer.quantize_multi_plain(xs, bits, 8, **kw)
    forms = {}   # name -> (setup, run in place on xs)

    def kept_setup(lib, chunk=quantizer.CHUNK):
        def setup():
            op_builder._lib = lib
            quantizer.CHUNK = chunk
            quantizer._multi_cache.clear()
        return setup

    variants = {"kept": kept_setup(libs["kept"]),
                "forward": kept_setup(libs["forward"]),
                "chunk32768": kept_setup(libs["chunk32768"], chunk=32768)}
    out = {"shape": f"{len(xs)} fp32 tensors, {n_el} elements (BERT-large's "
                    f"MoQ step), groups 8, {bits} bits, symmetric, "
                    + ("stochastic" if stochastic else "nearest")
                    + ", in place",
           "bound_ms": 8 * n_el / HBM * 1e3}
    # every form bit-equal to the plain version, before xs is quantized in
    # place by the timing runs
    for name, setup in variants.items():
        setup()
        ys = [x.clone() for x in xs]
        quantizer.quantize_multi(ys, bits, 8, out=ys, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(y, w) for y, w in zip(ys, want)):
            raise SystemExit(f"quantize form {name} differs from the plain "
                             f"version")
        del ys
    ys = [x.clone() for x in xs]   # the parent: its wrapper, 100 calls
    for y, tr, sd in zip(ys, trs, seeds):
        pq.quantize(y, bits, 8, stochastic=stochastic, seed=sd,
                    transposed=tr, out=y)
    torch.cuda.synchronize()
    if not all(torch.equal(y, w) for y, w in zip(ys, want)):
        raise SystemExit("the parent's quantize differs from the plain "
                         "version")
    del ys, want
    # the C entries alone, in place on xs
    for name, setup in variants.items():
        setup()
        forms[name] = (setup, quantize_entry(
            torch, quantizer, op_builder._lib, xs, trs, bits, stochastic))
    forms["parent"] = (lambda: None,
                       parent_entry(plib, pq, xs, trs, bits, stochastic))
    names = ["parent"] + list(variants)
    times = {n: [] for n in names}
    for _ in range(2):
        for n in names + names[::-1]:
            forms[n][0]()
            times[n].append(cuda_ms(forms[n][1], iters=10))
    for n in names:
        forms[n][0]()
        out[f"{n}_entry_ms"] = median(times[n])
        out[f"{n}_device_ms"], out[f"{n}_kernels"] = quant_device_ms(
            forms[n][1])
    out["entry_readings"] = times

    # the whole step's call through the wrappers, and its host time
    def kept_call():
        quantizer.quantize_multi(xs, bits, 8, out=xs, **kw)

    def parent_call():
        for x, tr, sd in zip(xs, trs, seeds):
            pq.quantize(x, bits, 8, stochastic=stochastic, seed=sd,
                        transposed=tr, out=x)
    variants["kept"]()
    wr = {"kept": [], "parent": []}
    for _ in range(3):
        for n, fn in (("parent", parent_call), ("kept", kept_call),
                      ("kept", kept_call), ("parent", parent_call)):
            wr[n].append(cuda_ms(fn, iters=10))
    out.update(kept_wrapper_ms=median(wr["kept"]),
               parent_wrapper_ms=median(wr["parent"]), wrapper_readings=wr,
               kept_wrapper_host_ms=host_call_ms(kept_call, 100, 10),
               parent_wrapper_host_ms=host_call_ms(parent_call, 100, 10),
               plain_ms=cuda_ms(lambda: quantizer.quantize_multi_plain(
                   xs, bits, 8, **kw), iters=2))
    print(f"quantize {'stochastic' if stochastic else 'nearest'}: "
          f"{json.dumps(out)}", flush=True)
    del xs
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ end to end
def e2e(libs, gen):
    """Sparse BERT-large and sparse GPT-2 medium steps with the parent's
    library against the kept one, in turns (median of steps 2-4 of each
    run of 4)."""
    out = {}
    bcfg = dataclasses.replace(
        bert.PRESETS["bert-large"], sparse_attention_mode="fixed",
        sparse_block=64, sparse_num_local_blocks=4,
        sparse_num_global_blocks=1, max_position_embeddings=2048)
    gcfg = dataclasses.replace(gpt2.PRESETS["gpt2-medium"],
                               attention_mode="sparse:1024/128",
                               n_positions=4096)
    for name, make, config, batch in (
            ("sparse_bert_large_bs4_seq2048",
             lambda: bert.BertForPreTraining(bcfg, seed=0),
             bert_config(fused=True, batch=4),
             bert.synthetic_mlm_batch(4, 2048, bcfg.vocab_size, seed=7)),
            ("sparse_gpt2_medium_bs2_seq4096",
             lambda: gpt2.GPT2LMHeadModel(gcfg, seed=0),
             train_config(batch=2, sweep=True),
             gpt2.synthetic_batch(2, 4096, gcfg.vocab_size, seed=9))):
        engine, *_ = deepspeed_tpu_torch.initialize(model=make(),
                                                    config=config)
        runs = {"parent": [], "kept": []}
        for form in ("parent", "kept", "kept", "parent") * 2:
            op_builder._lib = libs[form]
            ms = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.train_batch(batch=batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            runs[form].append(median(ms[1:]))
        out[name] = {"parent_step_ms": median(runs["parent"]),
                     "kept_step_ms": median(runs["kept"]), "runs": runs}
        print(f"e2e {name}: {json.dumps(out[name])}", flush=True)
        del engine
        torch.cuda.empty_cache()
    op_builder._lib = libs["kept"]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a checkout of the parent commit")
    ap.add_argument("--parts", default="sparse,quantize,e2e",
                    help="which of sparse, quantize, e2e to run")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pcsrc = os.path.join(args.parent, "deepspeed_tpu_torch", "csrc")
    pob = load_module(os.path.join(args.parent, "deepspeed_tpu_torch", "ops",
                                   "op_builder.py"), "parent_op_builder")
    base = {s: open(os.path.join(CSRC, s)).read()
            for s in ("sparse_attention.cu", "quantizer.cu")}
    chunk = "constexpr int kChunk = 16384;"
    edits = {
        "fwd_3ctas": ("sparse_attention.cu", [(
            "__launch_bounds__(kThreads, 4) sparse_fwd_bf16",
            "__launch_bounds__(kThreads) sparse_fwd_bf16")]),
        "forward": ("quantizer.cu", [(
            "const Where w = locate(t, t.chunks - 1 - blockIdx.x);",
            "const Where w = locate(t, blockIdx.x);")]),
        "chunk32768": ("quantizer.cu", [
            (chunk, "constexpr int kChunk = 32768;")])}
    os.makedirs(OUT, exist_ok=True)
    paths = {}
    for name, (src, subs) in edits.items():
        text = base[src]
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: the kept source changed")
            text = text.replace(old, new)
        paths[name] = os.path.join(OUT, f"{name}.cu")
        with open(paths[name], "w") as f:
            f.write(text)
    # every build at once: the parent's sources, the variants' sources
    t0 = time.perf_counter()
    jobs = {"parent": [compile_async(f"parent_{s[:-3]}",
                                     os.path.join(pcsrc, s), pcsrc)
                       for s in pob.SOURCES]}
    for name, path in paths.items():
        jobs[name] = [compile_async(name, path, CSRC)]
    kept = op_builder.load_kernels()
    libs, regs = {"kept": kept}, {}
    for name, js in jobs.items():
        libs[name], regs[name] = finish(
            name, js, pob._SIGNATURES if name == "parent"
            else op_builder._SIGNATURES)
    print(f"builds {time.perf_counter() - t0:.1f} s; registers {regs}",
          flush=True)
    pq = load_module(os.path.join(args.parent, "deepspeed_tpu_torch", "ops",
                                  "quantizer", "quantizer.py"),
                     "parent_quantizer")
    pq.op_builder = types.SimpleNamespace(
        load_kernels=lambda: libs["parent"],
        check_launch=lambda err, name: None if err == 0 else
        (_ for _ in ()).throw(RuntimeError(f"parent {name}: {err}")))
    gen = torch.Generator(device="cuda").manual_seed(10)
    result = {"card": card_line(), "registers": regs}
    if "sparse" in parts:
        result["sparse_fwd"] = sparse_forward(
            {k: libs[k] for k in ("parent", "kept", "fwd_3ctas")}, gen)
    op_builder._lib = kept
    if "quantize" in parts:
        kept_chunk = quantizer.CHUNK
        for stochastic in (False, True):
            result["quantize_" + ("stochastic" if stochastic else
                                  "nearest")] = quantize_timing(
                libs, libs["parent"], pq, gen, stochastic)
        quantizer.CHUNK = kept_chunk
        quantizer._multi_cache.clear()
    op_builder._lib = kept
    if "e2e" in parts:
        result["e2e"] = e2e({"parent": libs["parent"], "kept": kept}, gen)
    print(json.dumps({"variants": result}))


if __name__ == "__main__":
    main()
