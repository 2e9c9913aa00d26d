"""The flash kernels at head dim 256 (GPT-J's) against their plain versions
and SDPA, and the kept kernels at head dims up to 128 against the parent
commit's, in one process on one card.

* ``-Xptxas -v``: registers and spills of every flash entry function, the
  parent's and the kept ``csrc/flash_fwd.cu`` / ``csrc/flash_bwd.cu``
  built here by one nvcc command each (the same flags for both), into
  ``build/flash_d256/``.
* Bit-equality at D <= 128: the parent's and the kept libraries take the
  same arguments (the C interface is unchanged) on the same inputs; o,
  lse, dq, dk, dv and delta must be bit-equal at every head-dim class
  (16, 20, 64, 80, 128), fp32 and bf16, causal and not, ragged lengths,
  Sq != Sk both ways, packed qkv views.
* D 256: the kept kernels through the package's wrappers at GPT-J's
  training shape (B 4, H 16, S 2048, causal, bf16) and a ragged fp32
  shape, held against ``flash_attention_fwd_plain`` /
  ``flash_attention_bwd_plain`` (max_abs_err), timed by CUDA events
  beside the plain versions and SDPA's forward and backward (flash and
  cuDNN backends pinned), with the bounds: 4·D flops a visible pair
  (forward), 6·D (dq), 8·D (dk/dv) at 989 TFLOP/s, or the bytes at
  3.35 TB/s.

Needs one NVIDIA H100, nvcc and a checkout of the parent commit::

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python tests/perf/torch_flash_d256.py --parent build/parent

Prints a line a check and a JSON summary line; writes the whole report
to ``build/flash_d256/report.json``.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
from chip_smoke import (BF16_FLOPS, HBM_BYTES_PER_S, card_line,  # noqa: E402
                        cuda_ms, sdpa_bwd_backend_ms, sdpa_fwd_backend_ms)
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import flash  # noqa: E402

OUT = os.path.join(ROOT, "build", "flash_d256")
ENTRIES = ("ds_flash_fwd", "ds_flash_bwd_dq", "ds_flash_bwd_dkv")

# (B, H, Sq, Sk, D, causal, packed) at D <= 128
SAME_CASES = [
    (2, 4, 160, 160, 16, True, False), (1, 2, 160, 160, 20, False, False),
    (2, 4, 333, 333, 64, True, False), (1, 2, 191, 193, 64, False, False),
    (1, 2, 160, 160, 80, True, False), (1, 2, 193, 193, 128, True, False),
    (1, 2, 200, 77, 128, True, False), (1, 2, 77, 200, 64, True, False),
    (2, 4, 150, 150, 64, True, True), (1, 3, 70, 70, 128, False, True),
]


def nvcc(name, csrc):
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, f"{name}.so")
    r = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "-gencode=arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "--expt-relaxed-constexpr", "-lineinfo",
         "-shared", "-Xcompiler", "-fPIC", f"-I{csrc}", "-Xptxas", "-v",
         "-o", so, os.path.join(csrc, "flash_fwd.cu"),
         os.path.join(csrc, "flash_bwd.cu")], capture_output=True, text=True)
    if r.returncode:
        print(r.stderr[-6000:])
        raise SystemExit(f"{name} failed to build")
    lib = ctypes.CDLL(so)
    for entry in ENTRIES:
        fn = getattr(lib, entry)
        fn.argtypes = op_builder._SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return lib, r.stderr


def ptxas(log):
    """{entry function: 'N registers, ... spill stores/loads'} for the
    flash kernels."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else None
        elif fn and "spill" in ln:
            out[fn] = ln.split("ptxas info    :")[-1].strip()
        elif fn and "Used" in ln:
            out[fn] += "; " + ln.split("Used ")[1].strip()
    return out


def inputs(gen, dtype, B, H, Sq, Sk, D, packed):
    def r(*s):
        return torch.randn(*s, generator=gen, device="cuda").to(dtype)
    if packed:
        qkv = r(B, Sq, 3, H, D)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    else:
        q, k, v = r(B, H, Sq, D), r(B, H, Sk, D), r(B, H, Sk, D)
    return q, k, v, r(B, H, Sq, D)


def run_lib(lib, q, k, v, do, causal):
    """o, lse, dq, dk, dv, delta from one library's C entries, with the
    arguments the package's wrappers pass."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    dt = flash._DTYPES[q.dtype]
    vec = int(D % 8 == 0 and flash._aligned16(q, k, v))
    o = flash._heads_view(B, Sq, H, D, q)
    lse = torch.empty((B, H, Sq), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.ds_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), dt, B, H, Sq, Sk, D, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], D ** -0.5,
        int(causal), vec, stream)
    assert err == 0, err
    delta = torch.empty_like(lse)
    dq = flash._heads_view(B, Sq, H, D, q)
    dk = flash._heads_view(B, Sk, H, D, k)
    dv = flash._heads_view(B, Sk, H, D, v)
    strides = (ctypes.c_longlong * 24)(*(
        st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]))
    vec = int(D % 8 == 0 and flash._aligned16(q, k, v, o, do))
    for fn in (lib.ds_flash_bwd_dq, lib.ds_flash_bwd_dkv):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), None, delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dt, B, H, Sq,
                 Sk, D, strides, D ** -0.5, int(causal), vec, stream)
        assert err == 0, err
    torch.cuda.synchronize()
    return o, lse, dq, dk, dv, delta


def same_as_parent(parent, kept):
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in SAME_CASES:
            B, H, Sq, Sk, D, causal, packed = case
            q, k, v, do = inputs(gen, dtype, B, H, Sq, Sk, D, packed)
            a = run_lib(parent, q, k, v, do, causal)
            b = run_lib(kept, q, k, v, do, causal)
            names = ("o", "lse", "dq", "dk", "dv", "delta")
            diff = [n for n, x, y in zip(names, a, b) if not torch.equal(x, y)]
            out.append({"case": list(case), "dtype": str(dtype),
                        "bit_equal": not diff, "differ": diff})
            print(f"parent vs kept {case} {dtype}: "
                  f"{'bit-equal' if not diff else diff}", flush=True)
    return out


def d256(B, H, Sq, Sk, causal, dtype, timing):
    """The kept kernels at D 256 through the wrappers against the plain
    versions: max_abs_err of each output, and the times."""
    D = 256
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = inputs(gen, dtype, B, H, Sq, Sk, D, False)
    before = dict(op_builder.LAUNCHES)
    o, lse = flash.flash_attention_fwd(q, k, v, causal)
    dq, dk, dv, delta = flash.flash_attention_bwd(q, k, v, o, lse, do,
                                                  causal, return_delta=True)
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert op_builder.LAUNCHES[name] == before.get(name, 0) + 1, name
    o_p, lse_p = flash.flash_attention_fwd_plain(q, k, v, causal)
    dq_p, dk_p, dv_p, delta_p = flash.flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal, return_delta=True)
    err = {n: (a.float() - b.float()).abs().max().item() for n, a, b in (
        ("o", o, o_p), ("lse", lse, lse_p), ("dq", dq, dq_p),
        ("dk", dk, dk_p), ("dv", dv, dv_p), ("delta", delta, delta_p))}
    res = {"shape": f"B{B} H{H} Sq{Sq} Sk{Sk} D{D} "
                    f"{'causal' if causal else 'non-causal'} {dtype}",
           "max_abs_err": err}
    if timing:
        pairs = B * H * (Sq * (Sq + 1) // 2 if causal else Sq * Sk)
        tensor, row = B * H * Sq * D * 2, B * H * Sq * 4
        res.update(
            fwd_ms=cuda_ms(lambda: flash.flash_attention_fwd(q, k, v,
                                                             causal)),
            bwd_ms=cuda_ms(lambda: flash.flash_attention_bwd(
                q, k, v, o, lse, do, causal)),
            fwd_plain_ms=cuda_ms(lambda: flash.flash_attention_fwd_plain(
                q, k, v, causal), iters=3, warmup=1),
            bwd_plain_ms=cuda_ms(lambda: flash.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal), iters=3, warmup=1),
            fwd_bound_ms=max(4 * tensor + row, 0) / HBM_BYTES_PER_S * 1e3,
            fwd_flops_ms=4 * D * pairs / BF16_FLOPS * 1e3,
            dq_flops_ms=6 * D * pairs / BF16_FLOPS * 1e3,
            dkv_flops_ms=8 * D * pairs / BF16_FLOPS * 1e3)
        from torch.nn.attention import SDPBackend
        for key, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                             ("cudnn", SDPBackend.CUDNN_ATTENTION)):
            res[f"sdpa_{key}_fwd_ms"] = sdpa_fwd_backend_ms(
                torch, q, k, v, causal, backend)[0]
            res[f"sdpa_{key}_bwd_ms"] = sdpa_bwd_backend_ms(
                torch, q, k, v, do, causal, backend)
    print(f"d256: {json.dumps(res)}", flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout of the parent commit")
    args = ap.parse_args()
    card = card_line()
    print(f"card: {card}", flush=True)
    parent, plog = nvcc("parent", os.path.join(
        args.parent, "deepspeed_tpu_torch", "csrc"))
    kept, klog = nvcc("kept", os.path.join(ROOT, "deepspeed_tpu_torch",
                                           "csrc"))
    report = {"card": card, "ptxas_parent": ptxas(plog),
              "ptxas_kept": ptxas(klog)}
    for side in ("parent", "kept"):
        for k, v in report[f"ptxas_{side}"].items():
            print(f"ptxas {side} {k}: {v}", flush=True)
    report["same_as_parent"] = same_as_parent(parent, kept)
    op_builder.load_kernels()
    report["d256"] = [
        d256(1, 2, 191, 191, True, torch.float32, False),
        d256(1, 2, 97, 33, True, torch.bfloat16, False),
        d256(4, 16, 2048, 2048, True, torch.bfloat16, True)]
    with open(os.path.join(OUT, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    bad = [c for c in report["same_as_parent"] if not c["bit_equal"]]
    print(json.dumps({"flash_d256": {
        "bit_equal_cases": len(report["same_as_parent"]) - len(bad),
        "differing_cases": len(bad), "card": card}}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
