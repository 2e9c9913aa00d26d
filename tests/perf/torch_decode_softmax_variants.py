"""The decode attention and scaled softmax kernels against their parent
forms, in one process on one card.

The parent's ``csrc/decode_attention.cu`` and ``csrc/fused.cu`` (one CTA
per (batch, head) row; the softmax with 2-byte scalar accesses) are built
with nvcc from a checkout of the parent commit into
``build/decode_softmax_variants/``, loaded with ctypes, and driven through
the parent's own ``ops/transformer/decode.py`` wrapper (loaded from that
checkout); the kept kernels go through the package's wrappers. Both are
held against the plain versions, then timed in turns (parent, kept, kept,
parent, three times: six readings a form):

* decode, bf16 and int8 KV, at B 8 H 16 T 1024 len 928 (the generation
  path), B 1 len 1000 (one stream) and B 64 with per-sequence lengths from
  seed 0, uniform in 1-1024 (a serving batch); D 64. ``ms``: the wrapper
  by CUDA events over 100 back-to-back calls; ``kernel_ms``: the C entry
  alone; ``device_ms``: the kernel's device time from ``torch.profiler``;
  ``cold_kernel_ms``: the C entry cycling through four caches (134 MB at
  the generation path, past the 50 MB L2); ``host_us``: ``time.perf_counter``
  over 1000 calls without a sync (ten windows of 100, synchronised
  between windows). SDPA with the length mask beside the bf16 rows;
* variants of the kept decode kernel (the split rule: the kept one,
  splits below two waves aiming at 2 CTAs an SM, or below one wave at 1;
  half and twice the rows a thread a step), each held against the plain
  version, timed
  by the C entry (events, hot and cycling four caches) and the profiler;
* the wrapper's host cost by piece (1000 calls each);
* the softmax's C entry at [131072, 128] and [131072, 1024] bf16 (and h
  4096, 16384), beside ``torch.softmax``, by events and by the profiler;
* GPT-2 medium's greedy decode ms/token end to end with the parent's
  decode wrapper and kernel swapped into the model against the kept ones,
  in turns (:func:`e2e_ab`).

Needs one NVIDIA H100, nvcc and a checkout of the parent commit::

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python tests/perf/torch_decode_softmax_variants.py --parent build/parent
"""
import argparse
import ctypes
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
from chip_smoke import (card_line, cuda_ms, host_call_ms,  # noqa: E402
                        maybe_device_ms)
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import decode, fused  # noqa: E402

OUT = os.path.join(ROOT, "build", "decode_softmax_variants")
HBM = 3.35e12
H, D, T = 16, 64, 1024
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
PARENT_SIGNATURES = {
    "ds_decode_attention": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                            _I, _I, _L, _L, _L, _L, _F, _I, _P],
    "ds_softmax": [_P, _P, _L, _I, _F, _I, _P],
}


def nvcc(name, sources, include):
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, f"{name}.so")
    r = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "-gencode=arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "--expt-relaxed-constexpr", "-shared",
         "-Xcompiler", "-fPIC", f"-I{include}", "-Xptxas", "-v", "-o", so,
         *sources], capture_output=True, text=True)
    if r.returncode:
        print(r.stderr[-3000:])
        raise SystemExit(f"{name} failed to build")
    return so, r.stderr


def ptxas_lines(log, keys):
    """'function: registers, spills' for the entry functions whose mangled
    names hold one of ``keys``."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln
            fn = fn if any(k in fn for k in keys) else None
        elif fn and "Used" in ln:
            out[fn] = ln.split("Used ")[1].strip()
        elif fn and "spill" in ln:
            out[fn + " spill"] = ln.strip()
    return out


def host_us(fn):
    """The host time of one call in µs (chip_smoke.host_call_ms)."""
    return host_call_ms(fn) * 1e3


def parent_decode_module(parent_root, lib):
    """The parent's decode.py, bound to the parent's kernel library."""
    path = os.path.join(parent_root, "deepspeed_tpu_torch", "ops",
                        "transformer", "decode.py")
    spec = importlib.util.spec_from_file_location("parent_decode", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def check_launch(err, name):
        if err != 0:
            raise RuntimeError(f"parent {name} failed: cudaError {err}")

    mod.op_builder = types.SimpleNamespace(load_kernels=lambda: lib,
                                           check_launch=check_launch)
    return mod


def parent_entry(plib, q, k, ks, v, vs, lens, o, stream):
    """The parent's C entry with the arguments its wrapper passes."""
    B, H, _, D = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ks.data_ptr() if ks is not None else None,
            vs.data_ptr() if vs is not None else None, lens.data_ptr(),
            int(lens.dim() == 1), o.data_ptr(), 1, int(ks is not None), B, H,
            k.shape[2], D, H * D, D, H * D, D, D ** -0.5, 1, stream)
    return lambda: plib.ds_decode_attention(*args)


def kept_entry(lib, q, k, ks, v, vs, lens, o):
    """The kept C entry with the arguments the wrapper packs (the split
    plan of the moment)."""
    args, stream = decode._launch_args(q, k, v, ks, vs, lens, o, 1,
                                       q.shape[-1] ** -0.5)
    return lambda: lib.ds_decode_attention(args, stream)


def device_ms(fn, name=None):
    return maybe_device_ms(torch, fn, name)


def cycler(fns):
    """Calls the functions of ``fns`` in turn, one a call."""
    state = [0]

    def call():
        state[0] += 1
        return fns[state[0] % len(fns)]()
    return call


def close(got, want, tol):
    err = (got.float() - want.float()).abs()
    return err.max().item(), bool((err <= tol + tol * want.float().abs())
                                  .all())


def decode_cases(gen):
    rng = np.random.default_rng(0)
    ragged = torch.tensor(rng.integers(1, T + 1, 64), dtype=torch.int32,
                          device="cuda")
    return [("B8 H16 T1024 len928 D64", 8,
             torch.full((), 928, dtype=torch.int32, device="cuda")),
            ("B1 H16 T1024 len1000 D64", 1,
             torch.full((), 1000, dtype=torch.int32, device="cuda")),
            ("B64 H16 T1024 ragged lens (seed 0, 1-1024) D64", 64, ragged)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a checkout of the parent commit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = card_line()
    print("card:", card, flush=True)
    print("python", sys.version.split()[0], "torch", torch.__version__,
          "cuda", torch.version.cuda, flush=True)
    csrc = os.path.join(ROOT, "deepspeed_tpu_torch", "csrc")
    pcsrc = os.path.join(args.parent, "deepspeed_tpu_torch", "csrc")
    t0 = time.perf_counter()
    pso, plog = nvcc("parent", [os.path.join(pcsrc, "decode_attention.cu"),
                                os.path.join(pcsrc, "fused.cu")], pcsrc)
    _, klog = nvcc("kept", [os.path.join(csrc, "decode_attention.cu"),
                            os.path.join(csrc, "fused.cu")], csrc)
    plib = ctypes.CDLL(pso)
    for n, at in PARENT_SIGNATURES.items():
        getattr(plib, n).argtypes = at
        getattr(plib, n).restype = ctypes.c_int
    lib = op_builder.load_kernels()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    regs = {"parent": ptxas_lines(plog, ("decode_kernel", "softmax_")),
            "kept": ptxas_lines(klog, ("decode_kernel", "softmax_"))}
    print("ptxas", json.dumps(regs, indent=0), flush=True)
    pdec = parent_decode_module(args.parent, plib)
    stream = torch.cuda.current_stream().cuda_stream
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    out = {"card": card, "decode": [], "softmax": [], "host": {}}
    for shape, B, lens in decode_cases(gen):
        q = rnd(B, H, 1, D)
        caches = [(rnd(B, H, T, D), rnd(B, H, T, D)) for _ in range(4)]
        kc, vc = caches[0]
        kq, ks = decode.quantize_kv(kc)
        vq, vs = decode.quantize_kv(vc)
        qcaches = [decode.quantize_kv(a) + decode.quantize_kv(b)
                   for a, b in caches]
        per_seq = lens.dim() == 1
        live = int(lens.sum()) * H if per_seq else B * H * int(lens)
        mask = (torch.arange(T, device="cuda")[None, :]
                < (lens[:, None] if per_seq else lens.reshape(1, 1))
                )[:, None, None, :]
        splits, chunk = decode._plan(q.device, B * H, T)
        for kind in ("bf16", "int8"):
            quant = kind == "int8"
            sc = dict(k_scale=ks, v_scale=vs) if quant else {}
            kk, vv = (kq, vq) if quant else (kc, vc)
            want = decode.decode_attention_plain(q, kk, vv, lens, **sc)
            wrappers = {
                "parent": lambda: pdec.decode_attention(q, kk, vv, lens,
                                                        **sc),
                "kept": lambda: decode.decode_attention(q, kk, vv, lens,
                                                        **sc)}
            row = {"shape": shape, "kv": kind, "splits": splits,
                   "chunk": chunk,
                   "bytes": 2 * live * ((D + 4) if quant else 2 * D)
                   + 2 * B * H * D * 2}
            row["bound_ms"] = row["bytes"] / HBM * 1e3
            for name, fn in wrappers.items():
                got = fn()
                torch.cuda.synchronize()
                err, ok = close(got, want, 2e-2)
                again = fn()
                row[f"{name}_max_abs_err"] = err
                row[f"{name}_rerun_bit_equal"] = bool(torch.equal(got, again))
                if not ok:
                    raise SystemExit(f"{name} decode {kind} {shape} "
                                     f"disagrees with plain: {err}")
            # the C entries alone, with the arguments the wrappers pass;
            # cold: cycling through four caches
            o = torch.empty_like(q)
            sets = qcaches if quant else [(a, None, b_, None)
                                          for a, b_ in caches]
            sets[0] = (kk, sc.get("k_scale"), vv, sc.get("v_scale"))
            ents = {
                "parent": [parent_entry(plib, q, *c, lens, o, stream)
                           for c in sets],
                "kept": [kept_entry(lib, q, *c, lens, o)
                         for c in sets]}
            entries = {n: e[0] for n, e in ents.items()}
            cold = {n: cycler(e) for n, e in ents.items()}
            for turn in ("parent", "kept", "kept", "parent") * 3:
                r = row.setdefault(turn, {k: [] for k in (
                    "ms", "kernel_ms", "device_ms", "cold_kernel_ms", "host_us")})
                r["ms"].append(cuda_ms(wrappers[turn], iters=100))
                r["kernel_ms"].append(cuda_ms(entries[turn], iters=100))
                r["device_ms"].append(device_ms(
                    entries[turn], "decode_kernel"))
                r["cold_kernel_ms"].append(cuda_ms(cold[turn], iters=100))
                r["host_us"].append(host_us(wrappers[turn]))
            if not quant:
                sdpa = lambda: F.scaled_dot_product_attention(
                    q, kc, vc, attn_mask=mask)
                row["sdpa_mask_ms"] = cuda_ms(sdpa, iters=100)
                row["sdpa_mask_device_ms"] = device_ms(sdpa)
            print("decode", json.dumps(row), flush=True)
            out["decode"].append(row)
        del caches, qcaches
        torch.cuda.empty_cache()

    # tuning variants of the kept kernel: the split rule, half and twice
    # the rows a thread a step
    src = open(os.path.join(csrc, "decode_attention.cu")).read()
    u_line = "constexpr int U = R >= 128 ? 1 : (128 / R > 8 ? 8 : 128 / R);"
    sources = {
        "rows_half": src.replace(u_line, "constexpr int U = R >= 64 ? 1 : "
                                 "(64 / R > 4 ? 4 : 64 / R);"),
        "rows_x2": src.replace(u_line, "constexpr int U = R >= 256 ? 1 : "
                               "(256 / R > 16 ? 16 : 256 / R);"),
    }
    vlibs = {"kept": lib}
    kept_rule = decode.SPLIT_BELOW, decode.SPLIT_CTAS_PER_SM
    for name, vsrc in sources.items():
        if vsrc == src:
            raise SystemExit(f"variant {name} changed nothing")
        path = os.path.join(OUT, f"{name}.cu")
        os.makedirs(OUT, exist_ok=True)
        with open(path, "w") as f:
            f.write(vsrc)
        so, log = nvcc(name, [path], csrc)
        vlib = ctypes.CDLL(so)
        vlib.ds_decode_attention.argtypes = \
            op_builder._SIGNATURES["ds_decode_attention"]
        vlib.ds_decode_attention.restype = ctypes.c_int
        vlibs[name] = vlib
        print(name, json.dumps(ptxas_lines(log, ("decode_kernelI13",))),
              flush=True)
    # (source, SPLIT_BELOW, SPLIT_CTAS_PER_SM): the kept rule; splits
    # below two waves aiming at 2 CTAs an SM; below one wave at 1
    variants = [("kept", 0.5, 1), ("kept", 2, 2), ("kept", 1, 1),
                ("rows_half", 0.5, 1), ("rows_x2", 0.5, 1)]
    out["variants"] = []
    for shape, B, lens in decode_cases(gen):
        q = rnd(B, H, 1, D)
        caches = [(rnd(B, H, T, D), rnd(B, H, T, D)) for _ in range(4)]
        o = torch.empty_like(q)
        for kind in ("bf16", "int8"):
            sets = ([decode.quantize_kv(a) + decode.quantize_kv(b_)
                     for a, b_ in caches] if kind == "int8" else
                    [(a, None, b_, None) for a, b_ in caches])
            k0, ks0, v0, vs0 = sets[0]
            want = decode.decode_attention_plain(q, k0, v0, lens,
                                                 k_scale=ks0, v_scale=vs0)
            row = {"shape": shape, "kv": kind}
            for rnd_i in range(2):
                order = variants if rnd_i == 0 else variants[::-1]
                for name, below, target in order:
                    decode.SPLIT_BELOW = below
                    decode.SPLIT_CTAS_PER_SM = target
                    decode._PLANS.clear()
                    op_builder._lib = vlibs[name]
                    got = decode.decode_attention(q, k0, v0, lens,
                                                  k_scale=ks0, v_scale=vs0)
                    torch.cuda.synchronize()
                    err, ok = close(got, want, 2e-2)
                    if not ok:
                        raise SystemExit(f"variant {name}/{below}/{target} "
                                         f"{kind} "
                                         f"{shape} disagrees: {err}")
                    ents = [kept_entry(vlibs[name], q, *c, lens, o)
                            for c in sets]
                    r = row.setdefault(f"{name} below {below} target {target}", {
                        "plan": decode._plan(q.device, B * H, T),
                        "kernel_ms": [], "device_ms": [],
                        "cold_kernel_ms": []})
                    r["kernel_ms"].append(cuda_ms(ents[0], iters=100))
                    r["device_ms"].append(device_ms(
                        ents[0], "decode_kernel"))
                    r["cold_kernel_ms"].append(cuda_ms(cycler(ents),
                                                       iters=100))
            print("variant", json.dumps(row), flush=True)
            out["variants"].append(row)
        del caches
        torch.cuda.empty_cache()
    decode.SPLIT_BELOW, decode.SPLIT_CTAS_PER_SM = kept_rule
    decode._PLANS.clear()
    op_builder._lib = lib

    # the wrapper's host cost by piece, at the generation path's shape
    B = 8
    q = rnd(B, H, 1, D)
    kc, vc = rnd(B, H, T, D), rnd(B, H, T, D)
    lens = torch.full((), 928, dtype=torch.int32, device="cuda")
    dev = q.device
    p_args = (q.data_ptr(), kc.data_ptr(), vc.data_ptr(), None, None,
              lens.data_ptr(), 0, q.data_ptr(), 1, 0, B, H, T, D, H * D, D,
              H * D, D, D ** -0.5, 1, stream)
    pieces = {
        "parent wrapper": lambda: pdec.decode_attention(q, kc, vc, lens),
        "kept wrapper": lambda: decode.decode_attention(q, kc, vc, lens),
        "parent _lengths (as_tensor + to)": lambda: pdec._lengths(lens, B,
                                                                   dev),
        "kept _lengths (device int32 as is)": lambda: decode._lengths(
            lens, B, dev),
        "use_kernel": lambda: decode.use_kernel(q, kc, vc, None, None),
        "torch.empty + permute": lambda: torch.empty(
            (B, 1, H, D), dtype=q.dtype, device=dev).permute(0, 2, 1, 3),
        "torch.empty_strided": lambda: torch.empty_strided(
            (B, H, 1, D), (H * D, D, H * D, 1), dtype=q.dtype, device=dev),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "raw stream query": (lambda: decode._stream(dev)),
        "op_builder.load_kernels()": op_builder.load_kernels,
        "5 x data_ptr()": lambda: (q.data_ptr(), kc.data_ptr(),
                                   vc.data_ptr(), lens.data_ptr(),
                                   q.data_ptr()),
        "parent ctypes launch, 21 arguments": lambda:
            plib.ds_decode_attention(*p_args),
    }
    o = torch.empty_like(q)
    pieces["kept _launch_args (plan, scratch, pack)"] = \
        lambda: decode._launch_args(q, kc, vc, None, None, lens, o, 1,
                                    D ** -0.5)
    pieces["kept ctypes launch, packed"] = kept_entry(lib, q, kc, None, vc,
                                                      None, lens, o)
    for name, fn in pieces.items():
        out["host"][name] = host_us(fn)
    print("host", json.dumps(out["host"]), flush=True)

    # the softmax's C entries
    for n, h in ((131072, 128), (131072, 1024), (8192, 4096), (2048, 16384)):
        x = rnd(n, h)
        y = torch.empty_like(x)
        want = fused.softmax_plain(x)
        row = {"shape": f"[{n}, {h}] bf16", "bytes": 4 * n * h}
        row["bound_ms"] = row["bytes"] / HBM * 1e3
        ents = {"parent": lambda: plib.ds_softmax(x.data_ptr(), y.data_ptr(),
                                                  n, h, 1.0, 1, stream),
                "kept": lambda: lib.ds_softmax(x.data_ptr(), y.data_ptr(), n,
                                               h, 1.0, 1, stream)}
        for name, fn in ents.items():
            y.zero_()
            if fn() != 0:
                raise SystemExit(f"{name} softmax launch failed")
            torch.cuda.synchronize()
            err, ok = close(y, want, 2 ** -7)
            row[f"{name}_max_abs_err"] = err
            if not ok:
                raise SystemExit(f"{name} softmax [{n}, {h}] disagrees: {err}")
        for turn in ("parent", "kept", "kept", "parent") * 3:
            r = row.setdefault(turn, {"ms": [], "device_ms": []})
            r["ms"].append(cuda_ms(ents[turn], iters=100))
            r["device_ms"].append(device_ms(ents[turn], "softmax_"))
        lib_call = lambda: torch.softmax(x, -1)
        row["torch_softmax_ms"] = cuda_ms(lib_call, iters=100)
        row["torch_softmax_device_ms"] = device_ms(lib_call)
        print("softmax", json.dumps(row), flush=True)
        out["softmax"].append(row)
        del x, y, want
        torch.cuda.empty_cache()
    out["e2e"] = e2e_ab(pdec)
    print(json.dumps({"variants": out}))


def e2e_ab(pdec):
    """GPT-2 medium (bf16, weights from seed 0) greedy decode ms/token with
    the parent's decode wrapper and kernel swapped into the model against
    the kept ones, in turns (parent, kept, kept, parent, three times): bs 8
    × prompt 896 (64 new), bs 8 × prompt 32 (128 new), and prompt 32 (32
    new) on an int8 KV cache. ms/token = (generate(new) − generate(1)) /
    (new − 1), each the best of two runs, host clock, synchronised; six
    readings a form and their median."""
    import dataclasses

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    cfg = gpt2.PRESETS["gpt2-medium"]
    engines = {
        "bf16": deepspeed_tpu_torch.init_inference(
            gpt2.GPT2LMHeadModel(cfg, seed=0), dtype=torch.bfloat16),
        "int8_kv": deepspeed_tpu_torch.init_inference(
            gpt2.GPT2LMHeadModel(dataclasses.replace(
                cfg, kv_cache_dtype="int8"), seed=0), dtype=torch.bfloat16)}
    runs = [("bs8 prompt 896 new 64", "bf16", 896, 64),
            ("bs8 prompt 32 new 128", "bf16", 32, 128),
            ("bs8 prompt 32 new 32 int8-kv", "int8_kv", 32, 32)]
    ids = {S: gpt2.synthetic_batch(8, S, cfg.vocab_size, seed=S)["input_ids"]
           for S in (32, 896)}
    kept = (gpt2.decode_attention, gpt2.decode_attention_quantized)
    forms = {"parent": (pdec.decode_attention,
                        pdec.decode_attention_quantized), "kept": kept}

    def best_ms(eng, x, new):
        best = float("inf")
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.generate(x, max_new_tokens=new)
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    res = {name: {} for name, *_ in runs}
    tokens = {}
    engines["bf16"].generate(ids[32], max_new_tokens=4)   # warm-up
    for turn in ("parent", "kept", "kept", "parent") * 3:
        gpt2.decode_attention, gpt2.decode_attention_quantized = forms[turn]
        for name, eng, S, new in runs:
            e = engines[eng]
            out = e.generate(ids[S], max_new_tokens=new)
            if tokens.setdefault(name, out).shape != out.shape:
                raise SystemExit(f"{name}: output shape changed")
            agree = (tokens[name] == out).float().mean().item()
            ms = (best_ms(e, ids[S], new) - best_ms(e, ids[S], 1)) / (new - 1)
            res[name].setdefault(turn, []).append(ms)
            res[name].setdefault(f"{turn}_token_agreement", []).append(agree)
    gpt2.decode_attention, gpt2.decode_attention_quantized = kept
    for r in res.values():
        for form in forms:
            r[f"{form}_median"] = statistics.median(r[form])
    print("e2e", json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
