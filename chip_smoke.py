#!/usr/bin/env python3
"""Drive the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``deepspeed_tpu_torch/csrc`` into
   ``build/torch_ext/`` and print the build time;
3. hold every kernel against its plain PyTorch version on the card
   (tolerances: fp32 atol = rtol = 2e-5; bf16 atol = rtol = 2e-2, the
   plain forward rounds the normalised softmax weights to bf16 before P·V
   where the kernel rounds the unnormalised ones and divides by their
   fp32 sum after, and the backward's outputs are bf16; Adam rtol 1e-6,
   atol 1e-7): flash forward; decode, fp and int8 KV, fp32 and bf16, at
   B 8 (one split), B 1 (8 splits of 128 keys) and B 2 (4 of 256) × H 16
   × T 1024, at every live length at a split boundary (± 1), scalar and
   per-sequence, two runs bit-equal, zeros at length 0; the flash
   backward (dq, dk/dv) at
   the training shape (B 8, H 16, S 1024, D 64, causal) and at Sq < Sk,
   then at B 8, H 16 in bf16: every head-dim class (16, 20, 64, 80, 128),
   Sq != Sk both ways (rows with no visible key), lengths one short of
   and one past the 64-row tile and the 3-stage ring, a packed qkv
   projection, delta = rowsum(do·o) from the dq kernel (2e-5), and two
   backward runs bit-equal; the flash forward at the same shape classes
   (and one short of and one past its 128-row CTA)
   (o and lse on every row; o = 0 and lse at most -5e29 on the rows
   that see no key) and two forward runs bit-equal; both Adam forms at
   GPT-2 medium's size (the per-tensor form: all 292 tensors in one
   launch);
4. the generation path at full width: GPT-2 medium (24 layers, n_embd
   1024, 16 heads, vocab 50257 padded to 50304) on weights drawn from a
   seed, cast to bf16 by ``init_inference``, greedy ``generate`` on 8
   prompts of 896 tokens (64 new) and of 32 tokens (128 new), and with an
   int8 KV cache on 8 prompts of 32 tokens (32 new). Launch counts are
   zeroed just before and read just after; every kernel of the path must
   have launched, the decode kernels exactly once a layer and a generated
   token after the first. The prefill logits and the first decode step's
   logits
   must agree with the same model run on the plain attention versions on
   the card;
5. time the generation path and its kernels; decode (bf16 and int8 KV)
   at the generation path's B 8 × len 928, at B 1 × len 1000 and at B 64
   with per-sequence lengths from seed 0: the wrapper and its C entry by
   CUDA events, the kernel's device time from the profiler, the wrapper's
   host time, the plain version and SDPA with the length mask;
6. the training path at full width: ``initialize`` on GPT-2 medium, bs 8
   × seq 1024, bf16 over fp32 masters, ZeRO stage 1, Adam lr 1e-4 with
   ``sweep: true`` and ``gradient_clipping`` 1.0, 10 steps on one
   synthetic batch from a seed, then 3 steps of a second engine with
   ``fused: true``. Launch counts are zeroed just before and read just
   after: flash_fwd, flash_bwd_dq and flash_bwd_dkv 24 a step, adam once a
   sweep step and once a fused step (one multi-tensor launch for the 292
   tensors). The losses must be finite, the
   first near ln(50257), and the loss on the repeated batch must fall;
7. one-step parity: a 2-layer model at full width takes one step on the
   kernels and one with attention and Adam on their plain versions; the
   loss, the gradients and the updated params must agree;
8. time the training step (median of steps 3-10), tokens/s, MFU, peak
   memory, one profiled step, and each kernel at the main path's shapes
   (CUDA events) beside its plain version, its least possible time on the
   card and, where one exists, the PyTorch call that computes the same
   function (``scaled_dot_product_attention``'s forward and its backward
   alone on the flash backend pinned, cuDNN's beside it; the forward's
   wrapper against SDPA's call, and the device times of both from the
   profiler;
   ``torch.optim.AdamW(fused=True)``, ``F.layer_norm``,
   ``native_layer_norm_backward``, add + ``F.gelu``: timed for the table
   only);
9. the BERT MLM path at full width: ``initialize`` on BERT-large (24
   layers, hidden 1024, 16 heads, intermediate 4096, vocab 30522 padded
   to 30592, post-LN, eps 1e-12), bs 64 × seq 128 with 15% of positions
   masked, bf16 over fp32 masters, ZeRO 0, LAMB lr 1e-4: 10 steps with
   ``fused: true`` (the one-launch LAMB kernel), then 3 with ``fused:
   false`` (plain LAMB) from the same seed, whose losses must agree with
   the fused run's within 0.02. Launch counts are zeroed just before each
   run and read just after: flash_fwd, flash_bwd_dq, flash_bwd_dkv 24 a
   step, ln_fwd and ln_bwd 48, bias_gelu 24, lamb 1 (0 with plain LAMB).
   Then a one-step parity on a 2-layer full-width BERT (kernels against
   the plain versions of attention, LayerNorm, bias-GeLU and LAMB pass 1),
   flash against ``scaled_dot_product_attention`` at B 64, S 128 (the
   forward alone against SDPA's on the flash and cuDNN backends), the
   step time, tokens/s, samples/s, MFU, idle share and peak memory, and
   the four new kernels' timings. Phase 3 holds those kernels against
   their plain versions at BERT-large's shapes and ragged ones first;
10. the MoQ path: the BERT path of phase 9 (fused LAMB) with a
   ``quantize_training`` block (symmetric, nearest, groups 8, 12 -> 8 bits,
   period 2: bits 12, 11, 11, 10, 10, 10, 10, 9, 9, 9), 10 steps. Launch
   counts zeroed just before and read just after: phase 9's a step plus
   one quantize call a step (the 100 2-D masters in one table of
   ``ds_quantize_multi``, one kernel launch); after every step each of
   the
   8 groups of two sampled tensors (the first qkv weight, [out, in], and
   the word embeddings) holds at most 2^bits levels; the losses fall. The
   step time is printed beside phase 9's. Then a 2-layer full-width BERT
   takes one step and its post-update masters are fake-quantized by the
   MoQ schedule on the kernel (one call) and on the plain version:
   bit-equal (nearest at 8 bits and stochastic at 6). Phase 3 holds
   ``ds_quantize_multi`` bit-equal to its plain version, one tensor a call
   (fp32/bf16, symmetric/asymmetric, nearest/stochastic, 8/4 bits, groups
   1/8/7, a ragged row, BERT-large's qkv weight and word embeddings), on
   BERT-large's 100-master table and on a 64 MB group beside small
   tensors (nearest and stochastic, out of place twice, which shows the
   counters back at 0, and in place; one kernel call each), and
   ``ds_softmax`` within 2e-6 (fp32) and
   one bf16 ulp at [131072, 128], [131072, 1024], h 1000, 1003, 7, 4096,
   16384 and 40000, and on a view one element past an aligned start;
11. int8-weight GPT-2 medium: ``init_inference(dtype=torch.int8)``,
   greedy ``generate`` on 8 prompts of 896 tokens (32 new); prefill ms,
   decode ms/token, the weights' device bytes (int8, bf16, scales, shed);
   the prefill logits within 0.25 of a bf16 model built from the
   dequantized weights, greedy agreement at least 7/8;
12. the block-sparse BERT path, ``bench.py``'s bert-sparse row:
   BERT-large with Fixed block-sparse attention (block 64, a 256-token
   local window, 1 global block; positions widened to 2048), bs 4 × seq
   2048, bf16 over fp32 masters, ZeRO 0, fused LAMB lr 1e-4, 10 steps.
   Launch counts zeroed just before and read just after: exactly 24
   sparse_fwd, 24 sparse_dq, 24 sparse_dkv and 1 lamb a step, nothing
   else (no flash, LayerNorm or bias-GeLU kernel). Losses finite, the
   first near ln(vocab), falling. Step ms, tokens/s, samples/s, MFU (the
   attention term scaled by the layout's density, ``bench.py:560-571``),
   idle share, peak memory; beside it, 5 steps of the dense BERT-large at
   the same bs 4 × 2048 on the flash kernels. Phase 3 holds the three
   sparse kernels (forward, dq, dk/dv with the bias cotangent) against
   their plain versions (fp32 2e-5, bf16 2e-2; lse 2e-5) at blocks 16,
   64 and 128, causal and bidirectional, with and without a key bias,
   packed rectangular layouts, empty rows, the predicated (raw) lists,
   and the BERT and GPT-2 paths' own shapes; dq's delta against the
   plain one (2e-5), the forward rerun bit-equal at every case and the
   backward at the BERT, GPT-2 and a biased causal shape; then the bf16
   forward's shape classes (``SPARSE_FWD_SHAPES``: D 16/24/32/64, fine
   blocks 16/32/64, query and key tails, empty rows, packed and raw);
13. one-step parity of a 2-layer full-width sparse BERT, kernels against
   the plain versions (sparse kernels and LAMB pass 1; the tolerances of
   phase 9's parity), then ``DS_SPARSE_IMPL=predicated`` against
   ``fused`` on the kernels;
14. GPT-2 medium with ``attention_mode="sparse:1024/128"`` (causal; a
   decomposition with dense global rows and packed global columns), bs 2
   × seq 4096, positions widened, bf16, Adam ``sweep``, 5 steps: exactly
   24 sparse_fwd, 24 sparse_dq, 24 sparse_dkv and 1 adam a step.

Prints an ``e2e`` JSON line, a ``train`` JSON line, a ``bert`` JSON line,
a ``moq`` JSON line, an ``int8`` JSON line, a ``sparse`` JSON line, a
``kernels`` JSON line (the softmax, on no path as in the JAX package,
with 0 launches, and its C entry's and ``torch.softmax``'s device times
from the profiler; the decode rows' ``single_stream`` and
``serving_batch`` shapes beside the main path's; the sparse kernels'
predicated rows with the launches of phase 13's predicated step; the
sparse rows' SDPA yardstick is the masked
backward alone, and ``sparse timing`` lines give the three sparse kernels
at the BERT and GPT-2 shapes, the forward's device time from the profiler
beside SDPA-with-mask's forward; the quantize row times the one call's C
entry, its device time, the whole step's call through the wrapper and
stochastic rounding at 6 bits), the card line, and last ``{"ok": true,
"device": {...}}``. Exits non-zero with no result when CUDA is
unavailable or any phase fails.
"""

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 3.35 TB/s,
# bf16 tensor cores 989 TFLOP/s, fp32 outside the tensor cores 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

B, H, D = 8, 16, 64          # GPT-2 medium heads at batch 8
T_CACHE = 1024               # aligned_cache_len(1024)
DECODE_LEN = 896 + 32        # live cache length halfway through the long run
SEQ = 1024                   # training sequence (bench.py headline)
LR = 1e-4
TRAIN_STEPS, FUSED_STEPS = 10, 3
BERT_B, BERT_S = 64, 128     # bench.py's BERT-large row
BERT_STEPS, BERT_PLAIN_STEPS = 10, 3
MOQ_STEPS = 10
INT8_NEW = 32                # new tokens of the int8-weight generate
ADAM_TOL = dict(rtol=1e-6, atol=1e-7)
SPARSE_B, SPARSE_S = 4, 2048  # bench.py's bert-sparse row
SPARSE_BLOCK, SPARSE_WINDOW = 64, 256
SPARSE_STEPS, DENSE_LONG_STEPS = 10, 5
GPT_SPARSE_B, GPT_SPARSE_S = 2, 4096
GPT_SPARSE_MODE, GPT_SPARSE_STEPS = "sparse:1024/128", 5


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms (CUDA events around ``iters``)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, reps=3):
    """Best wall time of ``fn`` in ms, synchronised."""
    import torch
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def host_call_ms(fn, calls=1000, window=100):
    """Host time of one call of ``fn`` in ms: ``calls`` calls in windows
    of ``window`` with no sync inside a window (so the queue of launches
    never fills), synchronised between windows."""
    import torch
    total = 0.0
    fn()
    torch.cuda.synchronize()
    for _ in range(calls // window):
        t0 = time.perf_counter()
        for _ in range(window):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / calls * 1e3


def device_profile(torch, fn):
    """Run ``fn`` once under ``torch.profiler``: wall ms, device-busy ms
    (sum of kernel self times, one stream), the idle share, the device ms
    of each kernel group, and the largest kernels and the PyTorch ops
    whose kernels took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, kernels, ops = {}, [], []
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        # kernel events only: the CPU ops that launched them also carry
        # their device time (kept apart, by op)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CPU:
            ops.append((us / 1e3, ev.count, ev.key[:60]))
        if us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels.append((us / 1e3, ev.count, ev.key[:60]))
        name = ev.key.lower()
        group = ("flash_fwd" if "flash_fwd" in name else
                 "flash_bwd" if "flash_bwd" in name else
                 "adam" if "adam_kernel" in name
                 or "adam_multi_kernel" in name else
                 "layer_norm" if "ln_fwd_kernel" in name
                 or "ln_bwd_kernel" in name else
                 "bias_gelu" if "bias_gelu_kernel" in name else
                 "lamb" if "lamb_" in name else
                 "quantize" if "quant_stats_multi" in name
                 or "quant_apply_multi" in name else
                 "softmax" if "softmax_" in name else
                 "decode_attention" if "decode_kernel" in name else
                 "sparse_attention" if "sparse_" in name else
                 "matmul" if any(s in name for s in (
                     "gemm", "gemv", "cutlass", "nvjet", "xmma")) else
                 "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3
    busy = sum(groups.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": (1 - busy / wall_ms) if busy else None,
            "device_ms_by_group": groups,
            "top_kernels_ms_count_name": sorted(kernels, reverse=True)[:8],
            "top_ops_device_ms_count_name": sorted(ops, reverse=True)[:12]}


def close(got, want, tol):
    """Max abs error, and whether |got - want| <= tol + tol*|want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return err.max().item(), bool((err <= tol + tol * want.abs()).all())


def check_kernels(torch, flash, decode):
    """Phase 3: every kernel against its plain version. Returns the max
    abs error of each kernel at the main path's shapes (bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    main_err = {}
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    for dtype, tol in tols.items():
        for sq, sk, causal in [(896, 896, True), (896, 896, False),
                               (1024, 1024, True), (1024, 1024, False),
                               (32, 32, True), (32, 896, True),
                               (128, 1024, False)]:
            q = rnd(B, H, sq, D, dtype=dtype)
            k, v = rnd(B, H, sk, D, dtype=dtype), rnd(B, H, sk, D, dtype=dtype)
            o, lse = flash.flash_attention_fwd(q, k, v, causal)
            o_ref, lse_ref = flash.flash_attention_fwd_plain(q, k, v, causal)
            torch.cuda.synchronize()
            err, ok = close(o, o_ref, tol)
            err_l, ok_l = close(lse, lse_ref, 2e-5)
            print(f"check flash_fwd {str(dtype)[6:]} Sq={sq} Sk={sk} "
                  f"causal={causal}: o err {err:.3g}, lse err {err_l:.3g}")
            if not (ok and ok_l):
                raise AssertionError("flash_fwd disagrees with its plain "
                                     "version")
            if dtype == torch.bfloat16 and sq == sk and causal:
                main_err["flash_fwd"] = max(main_err.get("flash_fwd", 0), err)
        for name, err in check_decode_kernels(torch, decode, rnd, dtype,
                                              tol).items():
            if dtype == torch.bfloat16:
                main_err[name] = max(main_err.get(name, 0), err)
    check_flash_fwd_shapes(torch, flash, rnd)
    return main_err


# (batch, heads) of the decode checks at T_CACHE on 132 SMs: the
# generation path (one split), B 1 (8 splits of 128 keys), B 2 (4 of 256)
DECODE_CHECKS = [(B, H), (1, H), (2, H)]


def check_decode_kernels(torch, decode, rnd, dtype, tol):
    """Phase 3, decode: the fp and int8 kernels against their plain
    versions at each DECODE_CHECKS shape, for every live length at the
    split plan's chunk boundaries (± 1), 1, 7, 513, DECODE_LEN, T - 1 and T,
    scalar and per-sequence; two runs bit-equal; zeros at length 0.
    Returns the max abs error of each kernel."""
    errs = {}
    for batch, heads in DECODE_CHECKS:
        q = rnd(batch, heads, 1, D, dtype=dtype)
        k = rnd(batch, heads, T_CACHE, D, dtype=dtype)
        v = rnd(batch, heads, T_CACHE, D, dtype=dtype)
        kq, ks = decode.quantize_kv(k)
        vq, vs = decode.quantize_kv(v)
        splits, chunk = decode._plan(q.device, batch * heads, T_CACHE)
        lengths = {1, 7, 513, DECODE_LEN, T_CACHE - 1, T_CACHE}
        for i in range(1, splits):
            lengths |= {i * chunk - 1, i * chunk, i * chunk + 1}
        kinds = [("decode_attention", k, v, {}),
                 ("decode_attention_int8", kq, vq,
                  {"k_scale": ks, "v_scale": vs})]
        for length in sorted(lengths):
            for per_seq in (False, True):
                lens = (torch.tensor([max(1, length - 3 * i)
                                      for i in range(batch)],
                                     dtype=torch.int32, device="cuda")
                        if per_seq else length)
                dev_lens = decode._lengths(lens, batch, q.device)
                for name, kk, vv, sc in kinds:
                    got = decode.decode_attention(q, kk, vv, lens, **sc)
                    want = decode.decode_attention_plain(q, kk, vv, dev_lens,
                                                         **sc)
                    torch.cuda.synchronize()
                    err, ok = close(got, want, tol)
                    if not ok:
                        raise AssertionError(
                            f"{name} {dtype} B{batch} splits {splits} len "
                            f"{length} per_seq {per_seq} disagrees with its "
                            f"plain version: {err}")
                    errs[name] = max(errs.get(name, 0), err)
        for name, kk, vv, sc in kinds:
            first = decode.decode_attention(q, kk, vv, DECODE_LEN, **sc)
            again = decode.decode_attention(q, kk, vv, DECODE_LEN, **sc)
            zero = decode.decode_attention(q, kk, vv, 0, **sc)
            if not torch.equal(first, again):
                raise AssertionError(f"{name} reruns differ")
            if not bool((zero == 0).all()):
                raise AssertionError(f"{name} at length 0 is not zero")
        print(f"check decode {str(dtype)[6:]} B{batch} H{heads} "
              f"T{T_CACHE}: {splits} splits of {chunk}, lengths "
              f"{sorted(lengths)}, max err {errs}", flush=True)
    return errs


# (Sq, Sk, D, causal, packed) at B 8, H 16, bf16: the forward's shape
# classes of tests/test_torch_cuda_kernels.py at full size. Every head-dim
# class (16, 20 padded to 32, 64, 80 padded to 128, 128); one short of and
# one past the 64-row tile, the 128-row CTA and the 192-key ring; Sq != Sk
# both ways (Sq > Sk causal: the first Sq - Sk rows see no key); a packed
# qkv projection.
FWD_SHAPES = [(896, 896, 16, True, False), (896, 896, 20, False, False),
              (896, 896, 80, True, False), (896, 896, 128, True, False),
              (128, 128, 128, False, False),
              (63, 63, 64, True, False), (65, 65, 64, True, False),
              (127, 127, 64, True, False), (129, 129, 32, False, False),
              (191, 191, 64, True, False), (193, 193, 64, False, False),
              (65, 191, 64, True, False), (193, 63, 64, False, False),
              (SEQ, 896, 64, True, False), (896, 128, 128, True, False),
              (300, 100, 20, True, False), (SEQ, SEQ, 64, True, True),
              (BERT_S, BERT_S, 64, False, True)]


def check_flash_fwd_shapes(torch, flash, rnd):
    """Phase 3, the bf16 flash forward beyond the main shapes: o within
    2e-2 and lse within 2e-5 on every row, o = 0 and lse at most -5e29
    on the rows with no visible key (no softmax there); then two runs at
    the prefill shape bit-equal."""
    for sq, sk, d, causal, packed in FWD_SHAPES:
        if packed:
            qkv = rnd(B, sq, 3, H, d, dtype=torch.bfloat16)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            q = rnd(B, H, sq, d, dtype=torch.bfloat16)
            k, v = (rnd(B, H, sk, d, dtype=torch.bfloat16) for _ in range(2))
        o, lse = flash.flash_attention_fwd(q, k, v, causal)
        o_ref, lse_ref = flash.flash_attention_fwd_plain(q, k, v, causal)
        torch.cuda.synchronize()
        sees = torch.ones(sq, dtype=torch.bool, device="cuda")
        if causal:
            sees = torch.arange(sq, device="cuda") + sk - sq >= 0
        err, ok = close(o, o_ref, 2e-2)
        err_l, ok_l = close(lse, lse_ref, 2e-5)
        keyless = int((~sees).sum())
        ok_k = bool((lse[:, :, ~sees] <= -5e29).all() and
                    (o[:, :, ~sees] == 0).all())
        print(f"check flash_fwd bf16 Sq={sq} Sk={sk} D={d} causal={causal} "
              f"packed={packed}: o err {err:.3g}, lse err {err_l:.3g}, "
              f"{keyless} rows with no key at the masking value: {ok_k}",
              flush=True)
        if not (ok and ok_l and ok_k):
            raise AssertionError("flash_fwd disagrees with its plain version")
        del q, k, v, o, lse, o_ref, lse_ref
    q, k, v = (rnd(B, H, 896, D, dtype=torch.bfloat16) for _ in range(3))
    runs = [flash.flash_attention_fwd(q, k, v, True) for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("flash_fwd is not bit-reproducible")
    print("check flash_fwd: two runs bit-equal (o, lse)", flush=True)


@contextlib.contextmanager
def plain_attention(gpt2, attn_mod, decode):
    """Route the model's attention through the plain versions (the
    reference run for the end-to-end check), restoring the kernels."""
    saved = (gpt2.attention, gpt2.decode_attention,
             gpt2.decode_attention_quantized)
    gpt2.attention = lambda q, k, v, causal=True: attn_mod.mha_reference(
        q, k, v, causal=causal)
    gpt2.decode_attention = lambda q, kc, vc, lens: \
        decode.decode_attention_plain(q, kc, vc, lens)
    gpt2.decode_attention_quantized = lambda q, kc, ks, vc, vs, lens: \
        decode.decode_attention_plain(q, kc, vc, lens, k_scale=ks,
                                      v_scale=vs)
    try:
        yield
    finally:
        (gpt2.attention, gpt2.decode_attention,
         gpt2.decode_attention_quantized) = saved


def first_logits(torch, model, ids, tok=None):
    """Prefill logits of the last prompt position and the first decode
    step's logits (fed ``tok``, default the greedy token)."""
    with torch.no_grad():
        cache = model.new_cache(ids.shape[0])
        pre = model({"input_ids": ids}, cache=cache, last_only=True)[:, -1]
        if tok is None:
            tok = pre[:, :model.config.vocab_size].argmax(-1)
        step = model({"input_ids": tok[:, None]}, cache=cache,
                     last_only=True)[:, -1]
    return pre, step, tok


def check_training_kernels(torch, flash, fused_adam, param_shapes):
    """Phase 3, training kernels: the flash backward and both Adam forms
    against their plain versions. Returns the max abs error of each at
    the main path's shapes (bf16 flash, the real sweep size)."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    main_err = {}
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    for dtype, tol in tols.items():
        for sq, sk in [(SEQ, SEQ), (128, SEQ)]:
            q, do = rnd(B, H, sq, D, dtype=dtype), rnd(B, H, sq, D,
                                                       dtype=dtype)
            k, v = rnd(B, H, sk, D, dtype=dtype), rnd(B, H, sk, D,
                                                      dtype=dtype)
            o, lse = flash.flash_attention_fwd(q, k, v, True)
            got = flash.flash_attention_bwd(q, k, v, o, lse, do, True)
            want = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
            torch.cuda.synchronize()
            errs = [close(g, w, tol) for g, w in zip(got, want)]
            print(f"check flash_bwd {str(dtype)[6:]} Sq={sq} Sk={sk} causal: "
                  + ", ".join(f"{n} err {e:.3g}" for n, (e, _) in
                              zip(("dq", "dk", "dv"), errs)), flush=True)
            if not all(ok for _, ok in errs):
                raise AssertionError("flash_bwd disagrees with its plain "
                                     "version")
            if dtype == torch.bfloat16 and sq == sk:
                main_err["flash_bwd_dq"] = errs[0][0]
                main_err["flash_bwd_dkv"] = max(errs[1][0], errs[2][0])
            del q, k, v, o, lse, do, got, want
    check_flash_bwd_shapes(torch, flash, rnd)

    n = sum(math.prod(s) for s in param_shapes)
    n = -(-n // fused_adam.sweep_pad()) * fused_adam.sweep_pad()
    p, g = rnd(n), rnd(n) * 1e-3
    m, v = rnd(n) * 1e-4, rnd(n).square() * 1e-8
    cc = torch.tensor(0.25, device="cuda")
    for wd, cast in [(0.0, None), (0.01, torch.bfloat16)]:
        kw = dict(weight_decay=wd, cast_dtype=cast)
        got = fused_adam.adam_sweep_apply(p if wd else None, g, m, v, LR,
                                          0.271, 0.002997, cc, **kw)
        want = fused_adam.adam_sweep_apply_plain(p, g, m, v, LR, 0.271,
                                                 0.002997, cc, **kw)
        torch.cuda.synchronize()
        case_err = 0.0
        for a, b in zip(got, want):
            if b is None:
                continue
            # the bf16 cast of p + u: one bf16 ulp where the fp32 sums
            # differ in the last bit
            tol = ADAM_TOL if a.dtype == torch.float32 else dict(
                rtol=1e-2, atol=1e-2)
            torch.testing.assert_close(a.float(), b.float(), **tol)
            if a.dtype == torch.float32:
                case_err = max(case_err,
                               (a - b).abs().max().item())
        if wd == 0.0:
            main_err["adam_sweep"] = case_err
        print(f"check adam sweep n={n} wd={wd} cast={cast}: "
              f"err {case_err:.3g}", flush=True)
    del got, want
    # the per-tensor form: every tensor of the model in one launch
    lists, off = [[], [], [], []], 0
    for shape in param_shapes:
        size = math.prod(shape)
        for lst, t in zip(lists, (p, g, m, v)):
            lst.append(t[off:off + size].view(shape))
        off += size
    got = fused_adam.fused_adam_multi(*lists, LR, 0.271, 0.002997)
    errs = []
    for i, args in enumerate(zip(*lists)):
        want = fused_adam.adam_sweep_apply_plain(*args, LR, 0.271,
                                                 0.002997)[:3]
        for a, b in zip((got[0][i], got[1][i], got[2][i]), want):
            torch.testing.assert_close(a, b, **ADAM_TOL)
            errs.append((a - b).abs().max().item())
    main_err["adam_per_tensor"] = max(errs)
    print(f"check adam per-tensor, {len(param_shapes)} tensors in one "
          f"launch: err {max(errs):.3g}", flush=True)
    return main_err


# (Sq, Sk, D, causal, packed) at B 8, H 16, bf16: the shape classes of
# tests/test_torch_cuda_kernels.py at full size. Every head-dim class (16,
# 20 padded to 32, 64, 80 padded to 128, 128); Sq != Sk both ways (Sq > Sk
# causal: the first 128 rows see no key); one short of and one past the
# 64-row tile and the 192-row ring (96 at D 128); a packed qkv projection.
BWD_SHAPES = [(SEQ, SEQ, 16, True, False), (SEQ, SEQ, 20, True, False),
              (SEQ, SEQ, 80, True, False), (SEQ, SEQ, 128, True, False),
              (SEQ, SEQ, 128, False, False), (SEQ, 896, 64, True, False),
              (896, SEQ, 128, True, False),
              (SEQ - 1, SEQ - 1, 64, True, False),
              (SEQ + 1, SEQ + 1, 64, False, False),
              (3 * 64 * 5 + 1, 3 * 64 * 5 - 1, 64, True, False),
              (3 * 32 * 10 + 1, 3 * 32 * 10 + 1, 128, True, False),
              (SEQ, SEQ, 64, True, True)]


def check_flash_bwd_shapes(torch, flash, rnd):
    """Phase 3, the flash backward beyond the main shape (bf16, 2e-2;
    delta 2e-5, fp32 sums in another order), then two runs at the main
    shape bit-equal (no atomics)."""
    tol = 2e-2
    for sq, sk, d, causal, packed in BWD_SHAPES:
        if packed:
            qkv = rnd(B, sq, 3, H, d, dtype=torch.bfloat16)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            q = rnd(B, H, sq, d, dtype=torch.bfloat16)
            k, v = (rnd(B, H, sk, d, dtype=torch.bfloat16) for _ in range(2))
        do = rnd(B, H, sq, d, dtype=torch.bfloat16)
        o, lse = flash.flash_attention_fwd(q, k, v, causal)
        got = flash.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                        return_delta=True)
        want = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                               return_delta=True)
        torch.cuda.synchronize()
        errs = [close(g, w, tol) for g, w in zip(got[:3], want[:3])]
        errs.append(close(got[3], want[3], 2e-5))
        print(f"check flash_bwd bf16 Sq={sq} Sk={sk} D={d} causal={causal}"
              f" packed={packed}: " + ", ".join(
                  f"{n} err {e:.3g}" for n, (e, _) in
                  zip(("dq", "dk", "dv", "delta"), errs)), flush=True)
        if not all(ok for _, ok in errs):
            raise AssertionError("flash_bwd disagrees with its plain version")
        del q, k, v, o, lse, do, got, want
    q, k, v, do = (rnd(B, H, SEQ, D, dtype=torch.bfloat16) for _ in range(4))
    o, lse = flash.flash_attention_fwd(q, k, v, True)
    runs = [flash.flash_attention_bwd(q, k, v, o, lse, do, True,
                                      return_delta=True) for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("flash_bwd is not bit-reproducible")
    print("check flash_bwd: two runs bit-equal (dq, dk, dv, delta)",
          flush=True)


def train_config(batch=B, **opt):
    """The headline training config: bf16 over fp32 masters, ZeRO-1,
    Adam lr 1e-4, clip 1.0; ``opt`` adds ``sweep`` or ``fused``."""
    return {"train_batch_size": batch,
            "train_micro_batch_size_per_gpu": batch,
            "steps_per_print": 10 ** 9, "bf16": {"enabled": True},
            "zero_optimization": {"stage": 1}, "gradient_clipping": 1.0,
            "optimizer": {"type": "Adam", "params": {"lr": LR, **opt}}}


def run_steps(torch, engine, batch, n):
    """n train_batch steps; (losses, synchronised host ms of each)."""
    losses, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return losses, ms


@contextlib.contextmanager
def plain_training(gpt2, attn_mod, decode, fused_adam):
    """Attention and the Adam sweep on their plain versions."""
    saved = fused_adam.adam_sweep_apply
    fused_adam.adam_sweep_apply = fused_adam.adam_sweep_apply_plain
    try:
        with plain_attention(gpt2, attn_mod, decode):
            yield
    finally:
        fused_adam.adam_sweep_apply = saved


def one_step_parity(torch, deepspeed_tpu_torch, gpt2, attn_mod, decode,
                    fused_adam, cfg, batch):
    """Phase 7: a 2-layer full-width model, one step on the kernels and
    one on the plain versions, from the same seed and batch.

    Tolerances (bf16): loss within 0.02 absolute (the forward kernel keeps
    the softmax weights in fp32, the plain version rounds them); the
    gradients within 2e-2 relative in L2 over all tensors; the updated
    params within 2·lr absolute (Adam's first step moves each parameter
    by lr·sign(g), so a gradient near zero whose sign differs between the
    routes moves its parameter the other way) with at least 95% of them
    equal to 1e-6."""
    import dataclasses
    cfg2 = dataclasses.replace(cfg, n_layer=2)

    def one(plain):
        model = gpt2.GPT2LMHeadModel(cfg2, seed=5)
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=model, config=train_config(sweep=True))
        ctx = (plain_training(gpt2, attn_mod, decode, fused_adam) if plain
               else contextlib.nullcontext())
        with ctx:
            engine._micro_step(batch)
            grads = {k: p.grad.clone() for k, p in engine.params.items()}
            loss = float(engine.train_batch(batch=batch))
        params = {k: p.detach().clone() for k, p in engine.params.items()}
        return loss, grads, params

    loss_k, grads_k, params_k = one(False)
    loss_p, grads_p, params_p = one(True)
    num = sum((grads_k[k] - grads_p[k]).square().sum() for k in grads_p)
    den = sum(grads_p[k].square().sum() for k in grads_p)
    grad_rel = (num / den).sqrt().item()
    worst = max(((grads_k[k] - grads_p[k]).norm() /
                 grads_p[k].norm().clamp(min=1e-30)).item()
                for k in grads_p)
    dmax = max((params_k[k] - params_p[k]).abs().max().item()
               for k in params_p)
    n_all = sum(t.numel() for t in params_p.values())
    n_diff = sum(((params_k[k] - params_p[k]).abs() > 1e-6).sum().item()
                 for k in params_p)
    out = {"loss_kernels": loss_k, "loss_plain": loss_p,
           "loss_abs_err": abs(loss_k - loss_p), "grad_rel_l2": grad_rel,
           "grad_rel_l2_worst_tensor": worst, "param_max_abs_diff": dmax,
           "param_share_differing": n_diff / n_all}
    print(f"parity 2-layer one step: {json.dumps(out)}", flush=True)
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= 0.02
            and grad_rel <= 2e-2 and dmax <= 2 * LR * 1.001
            and n_diff / n_all <= 0.05):
        raise AssertionError(f"kernel and plain training steps disagree: "
                             f"{out}")
    return out


def sdpa_bwd_backend_ms(torch, q, k, v, do, causal, backend):
    """The backward alone of ``scaled_dot_product_attention`` on one backend
    (a yardstick, timed only): the graph is built once, then
    ``torch.autograd.grad(out, (q, k, v), do, retain_graph=True)`` is timed
    with CUDA events. None where the backend refuses the shape."""
    from torch.nn.attention import sdpa_kernel
    F = torch.nn.functional
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    try:
        with sdpa_kernel(backend):
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
            return cuda_ms(lambda: torch.autograd.grad(
                out, (qg, kg, vg), do, retain_graph=True))
    except RuntimeError as err:
        print(f"SDPA {backend.name} refused the shape: {err}"[:200],
              flush=True)
        return None


def sdpa_fwd_backend_ms(torch, q, k, v, causal, backend):
    """``scaled_dot_product_attention`` forward on one backend (a
    yardstick, timed only; the forward twin of :func:`sdpa_bwd_backend_ms`):
    (ms of the call by CUDA events, device ms of its kernels from the
    profiler), or (None, None) where the backend refuses the shape."""
    from torch.nn.attention import sdpa_kernel
    F = torch.nn.functional
    fn = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    try:
        with sdpa_kernel(backend):
            return cuda_ms(fn), call_device_ms(torch, fn)
    except RuntimeError as err:
        print(f"SDPA {backend.name} refused the shape: {err}"[:200],
              flush=True)
        return None, None


def _device_kernels(torch, fn, iters):
    """(name, count, device µs) of every CUDA kernel ``torch.profiler``
    recorded over ``iters`` calls of ``fn``, after one call unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(ev.key, ev.count, ev.self_device_time_total)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


def kernel_device_ms(torch, fn, name, iters=20):
    """Mean device time in ms of one launch of the kernel whose name holds
    ``name``, from ``torch.profiler`` over ``iters`` calls of ``fn`` (no
    host time in it, where CUDA events around a short kernel can time the
    host's enqueue). Divided by the launches the profiler recorded: it
    can drop some of a window's kernel records, or all of them, and then
    the window is profiled again (three windows at most)."""
    for _ in range(3):
        evs = [ev for ev in _device_kernels(torch, fn, iters)
               if name in ev[0]]
        count = sum(ev[1] for ev in evs)
        if count:
            return sum(ev[2] for ev in evs) / 1e3 / count
    raise RuntimeError(f"the profiler recorded no {name} kernel")


def call_device_ms(torch, fn, iters=20):
    """Mean device time in ms of one call of ``fn`` (a library call that
    launches kernels of its own): every kernel the profiler recorded,
    summed, over the launches of the kernel it recorded most often (each
    call launches each of its kernels once); a window with no record is
    profiled again, as in :func:`kernel_device_ms`."""
    for _ in range(3):
        evs = _device_kernels(torch, fn, iters)
        if evs:
            return sum(ev[2] for ev in evs) / 1e3 / max(ev[1] for ev in evs)
    raise RuntimeError("the profiler recorded no kernel")


def maybe_device_ms(torch, fn, name=None, iters=20):
    """:func:`kernel_device_ms` of the kernel ``name`` (or
    :func:`call_device_ms` of the whole call), or None where the profiler
    recorded nothing in three windows (it can drop a window's records)."""
    try:
        return (kernel_device_ms(torch, fn, name, iters) if name else
                call_device_ms(torch, fn, iters))
    except RuntimeError as e:
        print(f"profiler: {e}", flush=True)
        return None


def decode_timing(torch, decode, op_builder, batch, lens, quantized):
    """Decode at [batch, 16, 1024, 64] (bf16 q, a bf16 or int8 cache) with
    ``lens`` (a device scalar or a [batch] vector): ``ms`` the wrapper by
    CUDA events over 100 back-to-back calls, ``kernel_ms`` its C entry
    alone, ``device_ms`` the kernel's device time from the profiler,
    ``host_ms`` the wrapper's host time (1000 calls, no sync inside a
    window of 100), the plain version, and for the bf16 cache SDPA with
    the length mask (``library_ms`` its call by events,
    ``library_device_ms`` its kernels). Bound: the live K/V rows (and the
    int8 form's row scales) read once, q read and o written, at 3.35 TB/s;
    4 flops an element of a live row at 989 TFLOP/s."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, kc, vc = rnd(batch, H, 1, D), rnd(batch, H, T_CACHE, D), \
        rnd(batch, H, T_CACHE, D)
    sc = {}
    if quantized:
        kc, sc["k_scale"] = decode.quantize_kv(kc)
        vc, sc["v_scale"] = decode.quantize_kv(vc)
    per_seq = lens.dim() == 1
    live = H * (int(lens.sum()) if per_seq else batch * int(lens))
    wrapper = lambda: decode.decode_attention(q, kc, vc, lens, **sc)
    o = wrapper()
    args, stream = decode._launch_args(q, kc, vc, sc.get("k_scale"),
                                       sc.get("v_scale"), lens, o, 1,
                                       D ** -0.5)
    lib = op_builder.load_kernels()
    kernel = lambda: lib.ds_decode_attention(args, stream)
    splits, chunk = decode._plan(q.device, batch * H, T_CACHE)
    out = {"shape": f"B{batch} H{H} T{T_CACHE} "
                    + (f"per-sequence lengths (seed 0, 1-{T_CACHE})"
                       if per_seq else f"len{int(lens)}") + f" D{D} "
                    + ("int8 KV, bf16 q" if quantized else "bf16"),
           "splits": splits, "chunk": chunk,
           "ms": cuda_ms(wrapper, iters=100),
           "kernel_ms": cuda_ms(kernel, iters=100),
           "device_ms": maybe_device_ms(torch, kernel, "decode_kernel"),
           "host_ms": host_call_ms(wrapper),
           "plain_ms": cuda_ms(lambda: decode.decode_attention_plain(
               q, kc, vc, lens, **sc)),
           "library_ms": None,
           "bytes": 2 * live * ((D + 4) if quantized else 2 * D)
           + 2 * batch * H * D * 2 + 4 * lens.numel(),
           "flops": 4 * live * D}
    if not quantized:
        cols = torch.arange(T_CACHE, device="cuda")
        mask = (cols[None, :] < (lens[:, None] if per_seq
                                 else lens.reshape(1, 1)))[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(q, kc, vc,
                                                      attn_mask=mask)
        out["library_ms"] = cuda_ms(sdpa, iters=100)
        out["library_device_ms"] = maybe_device_ms(torch, sdpa)
    out["bound_ms"] = max(out["bytes"] / HBM_BYTES_PER_S,
                          out["flops"] / BF16_FLOPS) * 1e3
    return out


def decode_row(torch, np, decode, op_builder, quantized):
    """The kernels-line row of the fp (or int8) decode kernel: the
    generation path's shape (B 8, len DECODE_LEN), with ``single_stream``
    (B 1, len 1000) and ``serving_batch`` (B 64, per-sequence lengths
    drawn from seed 0, uniform in 1-1024) beside it."""
    rng = np.random.default_rng(0)
    shapes = {
        "main_path": (B, torch.full((), DECODE_LEN, dtype=torch.int32,
                                    device="cuda")),
        "single_stream": (1, torch.full((), 1000, dtype=torch.int32,
                                        device="cuda")),
        "serving_batch": (64, torch.tensor(rng.integers(1, T_CACHE + 1, 64),
                                           dtype=torch.int32,
                                           device="cuda"))}
    times = {label: decode_timing(torch, decode, op_builder, batch, lens,
                                  quantized)
             for label, (batch, lens) in shapes.items()}
    row = {"name": "decode_attention_int8" if quantized
           else "decode_attention", "route": "cuda",
           "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
           "replaces": "deepspeed_tpu/ops/transformer/decode.py:54"
           + (" (quantized=True)" if quantized else ""),
           **times.pop("main_path"),
           "library_note": "none: no PyTorch call attends over an int8 "
                           "cache" if quantized else
                           "scaled_dot_product_attention with the length "
                           "mask (one call)"}
    for label, t in times.items():
        t.pop("bytes")
        t.pop("flops")
        row[label] = t
    torch.cuda.empty_cache()
    return row


def flash_fwd_timing(torch, flash, batch, seq, causal):
    """The forward at [batch, 16, seq, 64] bf16: ``ms`` times the wrapper
    (what the models call; CUDA events), ``kernel_ms`` its C entry point
    alone (without the wrapper's checks and allocations) and
    ``device_ms`` the kernel's device time from the profiler. SDPA's
    forward on the same inputs, on the flash backend pinned, on cuDNN's
    and unpinned: each call by CUDA events (``sdpa_*_ms``, to hold
    against ``ms``) and the device time of its kernels from the profiler
    (``sdpa_*_device_ms``, to hold against ``device_ms``). Bound: q, k, v
    read and o, lse written at 3.35 TB/s, or 4·D flops a visible
    (query, key) pair at 989 TFLOP/s."""
    from torch.nn.attention import SDPBackend

    from deepspeed_tpu_torch.ops import op_builder
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (torch.randn(batch, H, seq, D, generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    o, lse = flash.flash_attention_fwd(q, k, v, causal)
    lib = op_builder.load_kernels()
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), 1, batch, H, seq, seq, D, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], D ** -0.5,
            int(causal), 1, stream)
    kernel = lambda: lib.ds_flash_fwd(*args)
    pairs = batch * H * (seq * (seq + 1) // 2 if causal else seq * seq)
    out = {"shape": f"B{batch} H{H} S{seq} D{D} "
                    f"{'causal' if causal else 'non-causal'} bf16",
           "ms": cuda_ms(lambda: flash.flash_attention_fwd(q, k, v, causal)),
           "kernel_ms": cuda_ms(kernel),
           "device_ms": kernel_device_ms(torch, kernel, "flash_fwd"),
           "bytes": 4 * batch * H * seq * D * 2 + batch * H * seq * 4,
           "flops": 4 * D * pairs}
    for key, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                         ("cudnn", SDPBackend.CUDNN_ATTENTION)):
        out[f"sdpa_{key}_ms"], out[f"sdpa_{key}_device_ms"] = \
            sdpa_fwd_backend_ms(torch, q, k, v, causal, backend)
    unpinned = lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)
    out["sdpa_unpinned_ms"] = cuda_ms(unpinned)
    out["sdpa_unpinned_device_ms"] = call_device_ms(torch, unpinned)
    out["bound_ms"] = max(out["bytes"] / HBM_BYTES_PER_S,
                          out["flops"] / BF16_FLOPS) * 1e3
    out["x_bound"] = out["ms"] / out["bound_ms"]
    out["device_tflops"] = out["flops"] / out["device_ms"] / 1e9
    if out["sdpa_flash_ms"]:
        # call against call, and device time against device time
        out["over_sdpa_flash"] = out["ms"] / out["sdpa_flash_ms"]
        out["device_over_sdpa_flash"] = (out["device_ms"] /
                                         out["sdpa_flash_device_ms"])
    print(f"flash_fwd timing: {json.dumps(out)}", flush=True)
    del q, k, v, o, lse
    return out


# what the kernels line and phase 5 keep of :func:`flash_fwd_timing`
SDPA_FWD_KEYS = ("sdpa_flash_device_ms", "sdpa_cudnn_ms",
                 "sdpa_cudnn_device_ms", "sdpa_unpinned_ms",
                 "sdpa_unpinned_device_ms", "device_tflops",
                 "over_sdpa_flash", "device_over_sdpa_flash")


def sdpa_bwd_ms(torch, q, k, v, do, causal):
    """SDPA's backward alone on the flash backend pinned, or on the
    memory-efficient one where flash refuses the shape: (ms, backend)."""
    from torch.nn.attention import SDPBackend
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        ms = sdpa_bwd_backend_ms(torch, q, k, v, do, causal, backend)
        if ms is not None:
            return ms, backend.name
    raise RuntimeError("no SDPA backend takes this shape")


def flash_bwd_timing(torch, flash, batch, seq, causal):
    """The two backward kernels alone at [batch, 16, seq, 64] bf16 (their C
    entry points, without the wrapper's allocations; dq writes delta, dk/dv
    reads it), the wrapper, and SDPA's backward alone on the same inputs.
    Times by CUDA events."""
    import ctypes

    from deepspeed_tpu_torch.ops import op_builder
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(batch, H, seq, D, generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    o, lse = flash.flash_attention_fwd(q, k, v, causal)
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = op_builder.load_kernels()
    strides = (ctypes.c_longlong * 24)(*(
        st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]))
    stream = torch.cuda.current_stream().cuda_stream

    def launch(fn):
        return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), do.data_ptr(), lse.data_ptr(), None,
                          delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                          dv.data_ptr(), 1, batch, H, seq, seq, D, strides,
                          D ** -0.5, int(causal), 1, stream)

    pairs = batch * H * (seq * (seq + 1) // 2 if causal else seq * seq)
    tensor, rowstat = batch * H * seq * D * 2, batch * H * seq * 4
    out = {"shape": f"B{batch} H{H} S{seq} D{D} "
                    f"{'causal' if causal else 'non-causal'} bf16",
           "dq_ms": cuda_ms(launch(lib.ds_flash_bwd_dq)),
           "dkv_ms": cuda_ms(launch(lib.ds_flash_bwd_dkv)),
           "wrapper_ms": cuda_ms(lambda: flash.flash_attention_bwd(
               q, k, v, o, lse, do, causal)),
           # q, k, v, o, do and lse read, dq and delta written; q, k, v,
           # do, lse and delta read, dk and dv written
           "dq_bytes": 6 * tensor + 2 * rowstat,
           "dkv_bytes": 6 * tensor + 2 * rowstat,
           "dq_flops": 6 * D * pairs, "dkv_flops": 8 * D * pairs}
    out["sdpa_bwd_ms"], out["sdpa_backend"] = sdpa_bwd_ms(torch, q, k, v, do,
                                                          causal)
    # cuDNN's backend, which SDPA may pick when no backend is pinned
    from torch.nn.attention import SDPBackend
    out["sdpa_cudnn_bwd_ms"] = sdpa_bwd_backend_ms(
        torch, q, k, v, do, causal, SDPBackend.CUDNN_ATTENTION)
    for name in ("dq", "dkv"):
        bound = max(out[f"{name}_bytes"] / HBM_BYTES_PER_S,
                    out[f"{name}_flops"] / BF16_FLOPS) * 1e3
        out[f"{name}_x_bound"] = out[f"{name}_ms"] / bound
        out[f"{name}_tflops"] = out[f"{name}_flops"] / out[f"{name}_ms"] / 1e9
    out["dq_plus_dkv_over_sdpa"] = (out["dq_ms"] + out["dkv_ms"]) / \
        out["sdpa_bwd_ms"]
    print(f"flash_bwd timing: {json.dumps(out)}", flush=True)
    del q, k, v, do, o, lse, delta, dq, dk, dv
    return out


def training_kernel_rows(torch, flash, fused_adam, param_shapes):
    """Timings of the training kernels at the main path's shapes: (rows
    without launches, max_abs_err and card)."""
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v, do = (rnd(B, H, SEQ, D) for _ in range(4))
    o, lse = flash.flash_attention_fwd(q, k, v, True)
    plain_ms = cuda_ms(lambda: flash.flash_attention_bwd_plain(
        q, k, v, o, lse, do, True), iters=5)
    del q, k, v, do, o, lse
    bwd = flash_bwd_timing(torch, flash, B, SEQ, True)
    sdpa_note = (f"scaled_dot_product_attention backward alone "
                 f"({bwd['sdpa_backend']} backend pinned), dq, dk and dv "
                 f"together")
    rows = [
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "deepspeed_tpu/ops/transformer/flash.py:258",
         "shape": bwd["shape"], "ms": bwd["dq_ms"],
         "plain_ms": plain_ms, "plain_note": "the whole plain backward",
         "library_ms": bwd["sdpa_bwd_ms"], "library_note": sdpa_note,
         "bytes": bwd["dq_bytes"], "flops": bwd["dq_flops"],
         "peak": BF16_FLOPS},
        {"name": "flash_bwd_dkv", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "deepspeed_tpu/ops/transformer/flash.py:292",
         "shape": bwd["shape"], "ms": bwd["dkv_ms"],
         "plain_ms": plain_ms, "plain_note": "the whole plain backward",
         "library_ms": bwd["sdpa_bwd_ms"], "library_note": sdpa_note,
         "bytes": bwd["dkv_bytes"], "flops": bwd["dkv_flops"],
         "peak": BF16_FLOPS},
    ]

    # Adam, sweep form: the main path's call (wd 0, no cast, clip on)
    n = sum(math.prod(s) for s in param_shapes)
    n_pad = -(-n // fused_adam.sweep_pad()) * fused_adam.sweep_pad()
    g = rnd(n_pad, dtype=torch.float32) * 1e-3
    m = rnd(n_pad, dtype=torch.float32) * 1e-4
    v = rnd(n_pad, dtype=torch.float32).square() * 1e-8
    cc = torch.tensor(0.5, device="cuda")
    sweep = lambda: fused_adam.adam_sweep_apply(None, g, m, v, LR, 0.271,
                                                0.002997, cc)
    plain = lambda: fused_adam.adam_sweep_apply_plain(None, g, m, v, LR,
                                                      0.271, 0.002997, cc)
    p = torch.nn.Parameter(rnd(n_pad, dtype=torch.float32))
    p.grad = g
    opt = torch.optim.AdamW([p], lr=LR, weight_decay=0.0, fused=True)
    rows.append({
        "name": "adam_sweep", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/adam.cu",
        "replaces": "deepspeed_tpu/ops/adam/fused_adam.py:130",
        "shape": f"flat fp32 n={n_pad} (GPT-2 medium), wd 0, no cast, "
                 f"clip on",
        "ms": cuda_ms(sweep, iters=10), "plain_ms": cuda_ms(plain, iters=5),
        "library_ms": cuda_ms(opt.step, iters=10),
        "library_note": "torch.optim.AdamW(fused=True).step on one flat "
                        "tensor (updates p in place)",
        "bytes": 24 * n_pad, "flops": 14 * n_pad, "peak": FP32_FLOPS})
    del g, m, v, p, opt

    # Adam, per-tensor form: the optimizer's whole-step call (one launch
    # for all the tensors) as the fused engine makes it
    names = [f"t{i}" for i in range(len(param_shapes))]
    ps = {k: rnd(*s, dtype=torch.float32) for k, s in zip(names, param_shapes)}
    gs = {k: rnd(*s, dtype=torch.float32) * 1e-3
          for k, s in zip(names, param_shapes)}
    opt = fused_adam.fused_adam()
    state = opt.init(ps)
    step = lambda: opt.update(gs, state, ps, LR)

    def enqueue_ms(fn, reps=5):
        """The host's time for ``fn``, synchronised before, not after:
        what the wrapper costs the host, apart from the device's time."""
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return best

    plain = lambda: [fused_adam.adam_sweep_apply_plain(
        ps[k], gs[k], state.mu[k], state.nu[k], LR, 0.271, 0.002997)
        for k in names]
    params = [torch.nn.Parameter(t.clone()) for t in ps.values()]
    for prm, gr in zip(params, gs.values()):
        prm.grad = gr
    aw = torch.optim.AdamW(params, lr=LR, weight_decay=0.0, fused=True)
    rows.append({
        "name": "adam_per_tensor", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/adam.cu",
        "replaces": "deepspeed_tpu/ops/adam/fused_adam.py:35",
        "shape": f"{len(param_shapes)} fp32 tensors, {n} elements "
                 f"(GPT-2 medium), the fused optimizer's step: "
                 f"{-(-len(names) // fused_adam.MULTI_MAX_TENSORS)} launch",
        "ms": cuda_ms(step, iters=10),
        "device_ms": kernel_device_ms(torch, step, "adam_multi", iters=5),
        "host_ms": enqueue_ms(step),
        "host_note": "the whole-step call's host time (table, views, "
                     "launch), not waiting for the device",
        "plain_ms": cuda_ms(plain, iters=3),
        "library_ms": cuda_ms(aw.step, iters=5),
        "library_note": "torch.optim.AdamW(fused=True).step over the same "
                        "tensors (multi-tensor, updates p in place)",
        "library_host_ms": enqueue_ms(aw.step),
        "bytes": 28 * n, "flops": 14 * n, "peak": FP32_FLOPS})
    del ps, gs, state, params, opt, aw
    torch.cuda.empty_cache()
    return rows


def bert_param_shapes(torch, bert, cfg):
    model = bert.BertForPreTraining(cfg, seed=0)
    shapes = [tuple(p.shape) for p in model.parameters()]
    del model
    torch.cuda.empty_cache()
    return shapes


def bert_moq_table(torch, bert, quantize_mod, cfg):
    """(shape, stored [out, in]) of each tensor a MoQ step quantizes on
    ``cfg``'s BERT: the 2-D parameters in name order, as the engine hands
    them to the schedule."""
    model = bert.BertForPreTraining(cfg, seed=0)
    tr = quantize_mod.transposed_weight_names(model)
    table = [(tuple(p.shape), n in tr)
             for n, p in sorted(model.named_parameters()) if p.dim() >= 2]
    del model
    torch.cuda.empty_cache()
    return table


def lamb_state(torch, gen, shapes):
    """p, g, m, v lists over ``shapes``, LAMB-like magnitudes."""
    def rnd(s):
        return torch.randn(*s, generator=gen, device="cuda")
    return ([rnd(s) * 0.02 for s in shapes], [rnd(s) * 1e-3 for s in shapes],
            [rnd(s) * 1e-4 for s in shapes],
            [rnd(s).square() * 1e-8 for s in shapes])


def check_bert_kernels(torch, flash, fused, fused_lamb, param_shapes):
    """Phase 3, the BERT path's kernels against their plain versions: the
    LayerNorm forward and backward and bias-GeLU at BERT-large's shapes
    and ragged ones, fp32 and bf16 (tolerances: fp32 2e-5; bf16 2e-2, one
    bf16 ulp where the fp32 results straddle a rounding boundary; mu and
    rstd 2e-5); LAMB pass 1 over BERT-large's 298 tensors (u, m, v rtol
    1e-6, atol 1e-7; the squared norms rtol 1e-5, sums in another order)
    and over ragged ones with weight decay; the flash kernels at B 64,
    H 16, S 128, non-causal. Returns the max abs error of each new kernel
    at the main path's shapes (bf16; LAMB fp32)."""
    gen = torch.Generator(device="cuda").manual_seed(11)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    main_err = {}
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    for dtype, tol in tols.items():
        for n, h in [(BERT_B * BERT_S, 1024), (37, 20), (5, 1000), (9, 7),
                     (1000, 64)]:
            x = rnd(n, h, dtype=dtype) * 2 + 0.5
            g = 1 + 0.1 * rnd(h, dtype=dtype)
            b = 0.1 * rnd(h, dtype=dtype)
            dy = rnd(n, h, dtype=dtype)
            y, mu, rstd = fused.layer_norm_fwd(x, g, b, 1e-12)
            dx = fused.layer_norm_bwd(x, g, mu, rstd, dy)
            y_ref, mu_ref, rstd_ref = fused.layer_norm_fwd_plain(x, g, b,
                                                                 1e-12)
            dx_ref = fused.layer_norm_bwd_plain(x, g, mu_ref, rstd_ref, dy)
            torch.cuda.synchronize()
            errs = {"y": close(y, y_ref, tol), "dx": close(dx, dx_ref, tol),
                    "mu": close(mu, mu_ref, 2e-5),
                    "rstd": close(rstd, rstd_ref, 2e-5)}
            print(f"check layer_norm {str(dtype)[6:]} [{n}, {h}]: " +
                  ", ".join(f"{k} err {e:.3g}" for k, (e, _) in errs.items()),
                  flush=True)
            if not all(ok for _, ok in errs.values()):
                raise AssertionError("the layer norm kernels disagree with "
                                     "their plain versions")
            if dtype == torch.bfloat16 and h == 1024:
                main_err["ln_fwd"] = errs["y"][0]
                main_err["ln_bwd"] = errs["dx"][0]
        for n, h in [(BERT_B * BERT_S, 4096), (37, 20), (5, 1000), (3, 7)]:
            x, bias = rnd(n, h, dtype=dtype) * 3, rnd(h, dtype=dtype)
            err, ok = close(fused.bias_gelu(x, bias),
                            fused.bias_gelu_plain(x, bias), tol)
            print(f"check bias_gelu {str(dtype)[6:]} [{n}, {h}]: err "
                  f"{err:.3g}", flush=True)
            if not ok:
                raise AssertionError("bias_gelu disagrees with its plain "
                                     "version")
            if dtype == torch.bfloat16 and h == 4096:
                main_err["bias_gelu"] = err
        # the attention of the BERT path: flash at S 128, non-causal
        q, k, v, do = (rnd(BERT_B, H, BERT_S, D, dtype=dtype)
                       for _ in range(4))
        o, lse = flash.flash_attention_fwd(q, k, v, False)
        o_ref, lse_ref = flash.flash_attention_fwd_plain(q, k, v, False)
        got = flash.flash_attention_bwd(q, k, v, o, lse, do, False)
        want = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, False)
        torch.cuda.synchronize()
        errs = [close(o, o_ref, tol), close(lse, lse_ref, 2e-5)] + \
            [close(a, w, tol) for a, w in zip(got, want)]
        print(f"check flash {str(dtype)[6:]} B{BERT_B} S{BERT_S} "
              f"non-causal: o, lse, dq, dk, dv err "
              f"{[round(e, 6) for e, _ in errs]}", flush=True)
        if not all(ok for _, ok in errs):
            raise AssertionError("flash disagrees with its plain version at "
                                 "the BERT shape")
        del x, dy, q, k, v, do, o, got, want

    for wd, shapes in [(0.0, param_shapes),
                       (0.01, [(1024, 1024), (0,), (7, 3), (20000,)])]:
        ps, gs, ms, vs = lamb_state(torch, gen, shapes)
        if wd:
            ps[2] = rnd(22)[1:].view(7, 3)     # not 16-byte aligned
        args = (ps, gs, ms, vs, 0.271, 0.002997)
        got = fused_lamb.lamb_pass1(*args, weight_decay=wd)
        want = fused_lamb.lamb_pass1_all_plain(*args, weight_decay=wd)
        torch.cuda.synchronize()
        err = 0.0
        for a_list, w_list in zip(got[:3], want[:3]):
            for a, w in zip(a_list, w_list):
                torch.testing.assert_close(a, w, **ADAM_TOL)
                if a.numel():
                    err = max(err, (a - w).abs().max().item())
        for a, w in zip(got[3:], want[3:]):
            torch.testing.assert_close(a, w, rtol=1e-5, atol=0)
        print(f"check lamb pass 1, {len(shapes)} tensors, wd {wd}: err "
              f"{err:.3g}", flush=True)
        if not wd:
            main_err["lamb"] = err
        del ps, gs, ms, vs, got, want
    torch.cuda.empty_cache()
    return main_err


def bert_config(fused, batch=BERT_B):
    """``bench.py``'s BERT-large row: bf16 over fp32 masters, ZeRO 0,
    LAMB lr 1e-4 (``fused`` selects the one-launch pass-1 kernel)."""
    return {"train_batch_size": batch,
            "train_micro_batch_size_per_gpu": batch,
            "steps_per_print": 10 ** 9, "bf16": {"enabled": True},
            "zero_optimization": {"stage": 0},
            "optimizer": {"type": "Lamb", "params": {"lr": LR,
                                                     "fused": fused}}}


@contextlib.contextmanager
def plain_bert(transformer, attn_mod, fused, fused_lamb):
    """The BERT path's attention, LayerNorm, bias-GeLU and LAMB pass 1 on
    their plain versions, restoring the kernels."""
    saved = (transformer.attention, fused.layer_norm_fwd,
             fused.layer_norm_bwd, fused.bias_gelu, fused_lamb.lamb_pass1)
    transformer.attention = lambda q, k, v, causal=True, mask=None: \
        attn_mod.mha_reference(q, k, v, causal=causal, mask=mask)
    fused.layer_norm_fwd = fused.layer_norm_fwd_plain
    fused.layer_norm_bwd = fused.layer_norm_bwd_plain
    fused.bias_gelu = fused.bias_gelu_plain
    fused_lamb.lamb_pass1 = fused_lamb.lamb_pass1_all_plain
    try:
        yield
    finally:
        (transformer.attention, fused.layer_norm_fwd, fused.layer_norm_bwd,
         fused.bias_gelu, fused_lamb.lamb_pass1) = saved


def bert_one_step_parity(torch, deepspeed_tpu_torch, bert, op_builder,
                         plain_ctx, cfg, batch):
    """A 2-layer BERT at full width, one fused-LAMB step on the kernels and
    one on the plain versions, from the same seed and batch.

    Tolerances (bf16): loss within 0.02 absolute; the gradients within
    2e-2 relative in L2 over all tensors; the updated params within
    2·lr·max_coeff (LAMB's first step moves each element by lr·ratio·u with
    u ≈ ±1 and the ratio at most 10, so a gradient near zero whose sign
    differs between the routes moves its element the other way) with at
    most 5% of them differing by more than 1e-6."""
    import dataclasses
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)

    def one(plain):
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=bert.BertForPreTraining(cfg2, seed=5),
            config=bert_config(fused=True))
        op_builder.reset_launch_counts()
        with plain_ctx() if plain else contextlib.nullcontext():
            engine._micro_step(batch)
            grads = {k: p.grad.clone() for k, p in engine.params.items()}
            loss = float(engine.train_batch(batch=batch))
        launched = sum(op_builder.LAUNCHES.values())
        if plain != (launched == 0):
            raise AssertionError(f"plain={plain} run launched {launched} "
                                 f"kernels")
        params = {k: p.detach().clone() for k, p in engine.params.items()}
        return loss, grads, params

    loss_k, grads_k, params_k = one(False)
    loss_p, grads_p, params_p = one(True)
    num = sum((grads_k[k] - grads_p[k]).square().sum() for k in grads_p)
    den = sum(grads_p[k].square().sum() for k in grads_p)
    grad_rel = (num / den).sqrt().item()
    worst = max(((grads_k[k] - grads_p[k]).norm() /
                 grads_p[k].norm().clamp(min=1e-30)).item()
                for k in grads_p)
    dmax = max((params_k[k] - params_p[k]).abs().max().item()
               for k in params_p)
    n_all = sum(t.numel() for t in params_p.values())
    n_diff = sum(((params_k[k] - params_p[k]).abs() > 1e-6).sum().item()
                 for k in params_p)
    out = {"loss_kernels": loss_k, "loss_plain": loss_p,
           "loss_abs_err": abs(loss_k - loss_p), "grad_rel_l2": grad_rel,
           "grad_rel_l2_worst_tensor": worst, "param_max_abs_diff": dmax,
           "param_share_differing": n_diff / n_all}
    print(f"bert parity 2-layer one step: {json.dumps(out)}", flush=True)
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= 0.02
            and grad_rel <= 2e-2 and dmax <= 2 * LR * 10 * 1.001
            and n_diff / n_all <= 0.05):
        raise AssertionError(f"BERT kernel and plain steps disagree: {out}")
    return out


def flash_vs_sdpa(torch, flash):
    """The forward kernel alone against ``scaled_dot_product_attention``'s
    forward on pinned backends, forward + backward against SDPA's at the
    BERT shape, and the backward kernels alone against SDPA's backward
    alone (timed only)."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, k, v, do = (torch.randn(BERT_B, H, BERT_S, D, generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = {
        "shape": f"B{BERT_B} H{H} S{BERT_S} D{D} non-causal bf16",
        "fwd": flash_fwd_timing(torch, flash, BERT_B, BERT_S, False),
        "flash_fwd_bwd_ms": cuda_ms(lambda: torch.autograd.grad(
            flash.flash_attention(qg, kg, vg, causal=False), (qg, kg, vg),
            do)),
        "sdpa_fwd_bwd_ms": cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qg, kg, vg), (qg, kg, vg), do)),
        "bwd": flash_bwd_timing(torch, flash, BERT_B, BERT_S, False),
    }
    print(f"flash vs SDPA at the BERT shape: {json.dumps(out)}", flush=True)
    return out


def bert_kernel_rows(torch, fused, fused_lamb, param_shapes):
    """Timings of the BERT path's kernels at its shapes (rows without
    launches, max_abs_err and card)."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(13)
    bf16 = torch.bfloat16

    def rnd(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    from deepspeed_tpu_torch.ops import op_builder
    lib = op_builder.load_kernels()
    stream = torch.cuda.current_stream().cuda_stream
    n, h, inter = BERT_B * BERT_S, 1024, 4096
    x, dy = rnd(n, h), rnd(n, h)
    g, b = 1 + 0.1 * rnd(h), 0.1 * rnd(h)
    y, mu, rstd = fused.layer_norm_fwd(x, g, b, 1e-12)
    dx = torch.empty_like(x)
    # the kernels alone (``ms``), without the wrappers' checks and
    # allocations, which ``wrapper_ms`` includes
    ln_fwd = lambda: lib.ds_ln_fwd(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
        mu.data_ptr(), rstd.data_ptr(), n, h, 1e-12, 1, 1, stream)
    ln_bwd = lambda: lib.ds_ln_bwd(
        x.data_ptr(), g.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), n, h, 1, 1, stream)
    # torch's own layer norm keeps mean and rstd as [n, 1]
    _, t_mu, t_rstd = torch.native_layer_norm(x, [h], g, b, 1e-12)
    row = n * h * 2
    rows = [
        {"name": "ln_fwd", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/fused.cu",
         "replaces": "deepspeed_tpu/ops/transformer/fused.py:43",
         "shape": f"[{n}, {h}] bf16, eps 1e-12",
         "ms": cuda_ms(ln_fwd, iters=100),
         "wrapper_ms": cuda_ms(lambda: fused.layer_norm_fwd(x, g, b, 1e-12),
                               iters=100),
         "plain_ms": cuda_ms(lambda: fused.layer_norm_fwd_plain(
             x, g, b, 1e-12)),
         "library_ms": cuda_ms(lambda: F.layer_norm(x, [h], g, b, 1e-12),
                               iters=100),
         "library_note": "F.layer_norm (one call; keeps no mu/rstd)",
         "bytes": 2 * row + 2 * h * 2 + 2 * n * 4, "flops": 8 * n * h,
         "peak": FP32_FLOPS},
        {"name": "ln_bwd", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/fused.cu",
         "replaces": "deepspeed_tpu/ops/transformer/fused.py:55",
         "shape": f"[{n}, {h}] bf16, dx only",
         "ms": cuda_ms(ln_bwd, iters=100),
         "wrapper_ms": cuda_ms(lambda: fused.layer_norm_bwd(
             x, g, mu, rstd, dy), iters=100),
         "plain_ms": cuda_ms(lambda: fused.layer_norm_bwd_plain(
             x, g, mu, rstd, dy)),
         "library_ms": cuda_ms(lambda: torch.ops.aten.native_layer_norm_backward(
             dy, x, [h], t_mu, t_rstd, g, b, [True, False, False]),
             iters=100),
         "library_note": "torch.ops.aten.native_layer_norm_backward, dx "
                         "only (one call)",
         "bytes": 3 * row + h * 2 + 2 * n * 4, "flops": 11 * n * h,
         "peak": FP32_FLOPS},
    ]
    del x, dy, dx, y, mu, rstd, t_mu, t_rstd
    xi, bias = rnd(n, inter), rnd(inter)
    yi = torch.empty_like(xi)
    gelu = lambda: lib.ds_bias_gelu(xi.data_ptr(), bias.data_ptr(),
                                    yi.data_ptr(), n * inter, inter, 1, 1,
                                    stream)
    rows.append({
        "name": "bias_gelu", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/fused.cu",
        "replaces": "deepspeed_tpu/ops/transformer/fused.py:147",
        "shape": f"[{n}, {inter}] bf16",
        "ms": cuda_ms(gelu, iters=100),
        "wrapper_ms": cuda_ms(lambda: fused.bias_gelu(xi, bias), iters=100),
        "plain_ms": cuda_ms(lambda: fused.bias_gelu_plain(xi, bias)),
        "library_ms": cuda_ms(lambda: F.gelu(xi + bias, approximate="tanh"),
                              iters=100),
        "library_note": "two calls: add, then F.gelu(approximate='tanh')",
        "bytes": 2 * n * inter * 2 + inter * 2, "flops": 12 * n * inter,
        "peak": FP32_FLOPS})
    del xi, bias, yi
    ps, gs, ms_, vs = lamb_state(torch, gen, param_shapes)
    n_params = sum(p.numel() for p in ps)
    args = (ps, gs, ms_, vs, 0.271, 0.002997)
    outs = [torch.empty(n_params, device="cuda") for _ in range(3)]
    table, n_chunks = fused_lamb.launch_table(ps, gs, ms_, vs, outs)
    partial = torch.empty(2 * n_chunks, device="cuda")
    wsq, usq = torch.empty(len(ps), device="cuda"), torch.empty(
        len(ps), device="cuda")
    lamb = lambda: lib.ds_lamb(
        table.data_ptr(), len(ps), n_chunks, partial.data_ptr(),
        wsq.data_ptr(), usq.data_ptr(), 0.271, 0.002997, 0.9, 0.1, 0.999,
        0.001, 1e-6, 0.0, stream)
    rows.append({
        "name": "lamb", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/lamb.cu",
        "replaces": "deepspeed_tpu/ops/lamb/fused_lamb.py:28",
        "shape": f"{len(ps)} fp32 tensors, {n_params} elements "
                 f"(BERT-large), wd 0, one launch",
        "ms": cuda_ms(lamb, iters=10),
        "wrapper_ms": cuda_ms(lambda: fused_lamb.lamb_pass1(*args),
                              iters=10),
        "plain_ms": cuda_ms(lambda: fused_lamb.lamb_pass1_all_plain(*args),
                            iters=3),
        "library_ms": None,
        "library_note": "PyTorch has no LAMB",
        "bytes": 28 * n_params + 8 * len(ps), "flops": 20 * n_params,
        "peak": FP32_FLOPS})
    del ps, gs, ms_, vs, args, outs, table, partial, wsq, usq
    torch.cuda.empty_cache()
    return rows


def moq_block(start_bits=12, target_bits=8, period=2, rounding="nearest"):
    """DeepSpeed's documented MoQ block (symmetric, nearest, 8 groups,
    16 -> 8 bits over periods of 400) with its bits and period cut so that
    the bit drops show inside the run: 12 -> 8, period 2, so bits 12, 11,
    11, 10, 10, 10, 10, 9, 9, 9 over 10 steps."""
    return {"enabled": True, "quantize_type": "symmetric",
            "quantize_algo": {"rounding": rounding}, "quantize_groups": 8,
            "quantize_bits": {"start_bits": start_bits,
                              "target_bits": target_bits},
            "quantize_schedule": {"quantize_period": period}}


def check_quant_kernels(torch, quantizer, fused, bert_shapes, moq_table):
    """Phase 3, the MoQ quantizer and the softmax against their plain
    versions. ``ds_quantize_multi``: bit-equal (atol 0) for fp32 and bf16,
    symmetric and asymmetric, nearest and stochastic (the same Philox
    bits), 8 and 4 bits, groups 1, 8 and 7, a ragged row, BERT-large's qkv
    weight in its [out, in] layout and its word embeddings, one tensor a
    call; then the MoQ step's table (``moq_table``: BERT-large's 100
    masters) and a 64 MB group beside small tensors in one call, twice
    out of place and once in place, nearest and stochastic. ``ds_softmax``:
    fp32 within 2e-6 absolute (expf and the row sum in another order),
    bf16 within one bf16 ulp (2^-7 relative); at BERT-large's and GPT-2
    medium's attention-score shapes and at h 1000 and 7. Returns the max
    abs error of each at the main path's shapes."""
    from deepspeed_tpu_torch.ops import op_builder
    gen = torch.Generator(device="cuda").manual_seed(21)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    qkv, emb = (3072, 1024), (30592, 1024)   # BERT-large's largest two
    if not {qkv, emb} <= set(bert_shapes):
        raise AssertionError("BERT-large's shapes changed")
    cases = [((64, 256), 1, False), ((64, 256), 8, False),
             ((63, 77), 7, False), (qkv, 8, True), (emb, 8, False)]
    main_err = {"quantize": 0.0}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape, groups, transposed in cases:
            x = rnd(*shape, dtype=dtype) * 0.05
            for symmetric in (True, False):
                for stochastic in (False, True):
                    for bits in (8, 4):
                        kw = dict(num_bits=bits, groups=groups,
                                  symmetric=symmetric, stochastic=stochastic,
                                  seed=99 if stochastic else None,
                                  transposed=transposed)
                        got = quantizer.quantize(x, **kw)
                        want = quantizer.quantize_plain(x, **kw)
                        torch.cuda.synchronize()
                        err = (got.float() - want.float()).abs().max().item()
                        n_cases += 1
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"quantize {dtype} {shape} {kw} differs from "
                                f"its plain version by {err}")
                        if dtype == torch.float32 and shape in (qkv, emb):
                            main_err["quantize"] = max(main_err["quantize"],
                                                       err)
            del x, got, want
    print(f"check quantize: {n_cases} cases bit-equal to the plain version "
          f"(fp32/bf16, sym/asym, nearest/stochastic, 8/4 bits, groups "
          f"1/8/7, qkv {qkv} transposed, embeddings {emb})", flush=True)
    # the MoQ step's table (BERT-large's 100 masters) in one call: out of
    # place twice (the counters back at 0) and in place; then a 64 MB
    # group beside small fp32 and bf16 tensors
    xs = [rnd(*shape) * 0.02 for shape, _ in moq_table]
    tables = [(xs, 8, [tr for _, tr in moq_table], (10, 6)),
              ([rnd(4096, 4096), rnd(63, 77, dtype=torch.bfloat16),
                rnd(3072, 1024), rnd(1000, 9, dtype=torch.bfloat16)],
               [1, 7, 8, 3], [False, False, True, False], ([8, 4, 10, 3],
                                                          [6, 3, 8, 2]))]
    for ts, groups, trs, (bits_n, bits_s) in tables:
        for stochastic, bits in ((False, bits_n), (True, bits_s)):
            kw = dict(stochastic=stochastic, transposed=trs,
                      seeds=list(range(1, len(ts) + 1)))
            want = quantizer.quantize_multi_plain(ts, bits, groups, **kw)
            before = op_builder.LAUNCHES["quantize"]
            runs = [quantizer.quantize_multi(ts, bits, groups, **kw)
                    for _ in range(2)]
            ys = [t.clone() for t in ts]
            runs.append(quantizer.quantize_multi(ys, bits, groups, out=ys,
                                                 **kw))
            torch.cuda.synchronize()
            launched = op_builder.LAUNCHES["quantize"] - before
            if launched != 3 or not all(torch.equal(g, w) for run in runs
                                        for g, w in zip(run, want)):
                raise AssertionError(
                    f"quantize_multi over {len(ts)} tensors (stochastic "
                    f"{stochastic}) differs from the plain version or took "
                    f"{launched} calls for 3")
            n_cases += 1
            del want, runs, ys
    del xs, tables
    print(f"check quantize_multi: BERT-large's {len(moq_table)} masters "
          f"and a 64 MB group beside small tensors, nearest and "
          f"stochastic, out of place twice and in place: one kernel "
          f"call each, bit-equal", flush=True)
    for dtype, tol in ((torch.float32, 2e-6), (torch.bfloat16, 2 ** -7)):
        for n, h, name in [(BERT_B * H * BERT_S, BERT_S, "softmax"),
                           (B * H * SEQ, SEQ, "softmax_h1024"),
                           (37, 1000, None), (33, 1003, None), (9, 7, None),
                           (5, 4096, None), (7, 16384, None),
                           (2, 40000, None), (19, 1024, "unaligned")]:
            # unaligned: a view one element past an aligned start (one
            # element a load); 1003: rows that are not whole vectors;
            # 16384: one block a row in registers; 40000: three passes
            x = (rnd(n * h + 1, dtype=dtype) * 4)[1:].view(n, h) \
                if name == "unaligned" else rnd(n, h, dtype=dtype) * 4
            got = fused.fused_softmax(x, 0.125)
            want = fused.softmax_plain(x, 0.125)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            ok = bool((err <= (tol if dtype == torch.float32 else
                               tol * want.float().abs())).all())
            print(f"check softmax {str(dtype)[6:]} [{n}, {h}]: err "
                  f"{err.max().item():.3g}", flush=True)
            if not ok:
                raise AssertionError("softmax disagrees with its plain "
                                     "version")
            if dtype == torch.bfloat16 and name in ("softmax",
                                                    "softmax_h1024"):
                main_err[name] = err.max().item()
            del x, got, want, err
    torch.cuda.empty_cache()
    return main_err


def quantize_entry(torch, quantizer, lib, xs, transposed, bits, stochastic):
    """The C entry of the multi-tensor quantize alone, with the arguments
    its wrapper passes for ``xs`` in place (groups 8, symmetric, seeds 1,
    2, ...; the plan built by one wrapper call): a function of no
    arguments that makes the call."""
    quantizer._multi_cache.clear()
    quantizer.quantize_multi(xs, bits, 8, stochastic=stochastic,
                             seeds=list(range(1, len(xs) + 1)),
                             transposed=transposed, out=xs)
    (plan,) = quantizer._multi_cache.values()
    stream = torch.cuda.current_stream().cuda_stream
    calls = []
    for first, stop, partial, scale, count, chunks, groups in plan.calls:
        table = plan.rows[first:stop].copy()
        # the plan too: its device scratch must outlive the cache entry
        calls.append((table, plan, (
            table.ctypes.data, stop - first, partial.data_ptr(),
            scale.data_ptr(), count.data_ptr(), chunks, groups, 1,
            int(stochastic), stream)))

    def run():
        for _, _, args in calls:
            if lib.ds_quantize_multi(*args):
                raise RuntimeError("ds_quantize_multi failed")
    return run


def quant_kernel_rows(torch, quantizer, fused, moq_tensors):
    """Timings of ``ds_quantize_multi`` over BERT-large's 100 quantized
    fp32 masters (``moq_tensors``: (shape, transposed) of each; one MoQ
    step, one call): the C entry alone by CUDA events
    (``ms``), the device time of its kernels from the profiler, the whole
    step's call
    through the wrapper (``wrapper_ms``, and its host time), stochastic
    rounding at 6 bits; and of ``ds_softmax`` at the two attention-score
    shapes (rows without launches, max_abs_err and card)."""
    from deepspeed_tpu_torch.ops import op_builder
    gen = torch.Generator(device="cuda").manual_seed(23)
    lib = op_builder.load_kernels()
    stream = torch.cuda.current_stream().cuda_stream
    xs = [torch.randn(*s, generator=gen, device="cuda") * 0.02
          for s, _ in moq_tensors]
    transposed = [tr for _, tr in moq_tensors]
    entry = quantize_entry(torch, quantizer, lib, xs, transposed, 10, False)
    stochastic = quantize_entry(torch, quantizer, lib, xs, transposed, 6,
                                True)

    def wrapper_call():
        quantizer.quantize_multi(xs, 10, 8, transposed=transposed, out=xs)

    def plain_sweep():
        quantizer.quantize_multi_plain(xs, 10, 8, transposed=transposed)

    n_el = sum(x.numel() for x in xs)
    rows = [{
        "name": "quantize", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/quantizer.cu",
        "replaces": "deepspeed_tpu/ops/quantizer/quantizer.py:68",
        "shape": f"{len(xs)} fp32 tensors, {n_el} elements (BERT-large's "
                 f"MoQ step), groups 8, 10 bits, symmetric, nearest, in "
                 f"place; one call, one launch",
        "ms": cuda_ms(entry, iters=10),
        "device_ms_profiled": maybe_device_ms(torch, entry, None, iters=5),
        "wrapper_ms": cuda_ms(wrapper_call, iters=10),
        "wrapper_host_ms": host_call_ms(wrapper_call, 100, 10),
        "stochastic_6bit_ms": cuda_ms(stochastic, iters=10),
        "plain_ms": cuda_ms(plain_sweep, iters=2),
        "library_ms": None,
        "library_note": "no PyTorch call computes a grouped fake-quantize "
                        "with its own absmax scale: "
                        "torch.fake_quantize_per_channel_affine takes the "
                        "scale as an input",
        "bytes": 8 * n_el, "flops": 5 * n_el, "peak": FP32_FLOPS}]
    quantizer._multi_cache.clear()
    del xs, entry, stochastic
    F = torch.nn.functional
    for name, n, h in (("softmax", BERT_B * H * BERT_S, BERT_S),
                       ("softmax_h1024", B * H * SEQ, SEQ)):
        x = torch.randn(n, h, generator=gen, device="cuda").to(torch.bfloat16)
        y = torch.empty_like(x)
        kernel = lambda: lib.ds_softmax(x.data_ptr(), y.data_ptr(), n, h,
                                        1.0, 1, stream)
        rows.append({
            "name": name, "route": "cuda",
            "source": "deepspeed_tpu_torch/csrc/fused.cu",
            "replaces": "deepspeed_tpu/ops/transformer/fused.py:226",
            "shape": f"[{n}, {h}] bf16, scale 1.0 "
                     + ("(BERT-large's attention scores, B64 H16 S128)"
                        if h == BERT_S else
                        "(GPT-2 medium's, B8 H16 S1024)"),
            "ms": cuda_ms(kernel, iters=100),
            "device_ms": maybe_device_ms(torch, kernel, "softmax_"),
            "wrapper_ms": cuda_ms(lambda: fused.fused_softmax(x), iters=100),
            "plain_ms": cuda_ms(lambda: fused.softmax_plain(x)),
            "library_ms": cuda_ms(lambda: torch.softmax(x, -1), iters=100),
            "library_device_ms": maybe_device_ms(
                torch, lambda: torch.softmax(x, -1)),
            "library_note": "torch.softmax(x, -1) (one call)",
            "bytes": 2 * n * h * 2, "flops": 5 * n * h, "peak": FP32_FLOPS})
        del x, y
    torch.cuda.empty_cache()
    return rows


def group_levels(torch, t, groups, transposed, bits):
    """The most distinct values any group of ``t`` holds; fails above
    2^bits."""
    ref = t.detach().t() if transposed else t.detach()
    most = max(torch.unique(g).numel() for g in ref.reshape(groups, -1))
    if most > 2 ** bits:
        raise AssertionError(f"a group holds {most} levels at {bits} bits")
    return most


def moq_phase(torch, deepspeed_tpu_torch, bert, op_builder, cfg, batch,
              base_counts_per_step, bert_ms):
    """The MoQ path: BERT-large with ``quantize_training`` for MOQ_STEPS
    steps. Launch counts zeroed just before and read just after: the BERT
    path's per step plus one quantize launch a step (the 100 masters in
    one table). After every step
    two sampled tensors (the first layer's qkv weight, [out, in], and the
    word embeddings) hold at most 2^bits levels in each of their 8
    groups. Returns (moq line, launch counts, (shape, transposed) of each
    quantized tensor)."""
    config = dict(bert_config(fused=True), quantize_training=moq_block())
    torch.cuda.reset_peak_memory_stats()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=bert.BertForPreTraining(cfg, seed=0), config=config)
    q = engine.quantizer
    moq_tensors = [(tuple(p.shape), k in engine._transposed)
                   for k, p in sorted(engine.params.items()) if p.dim() >= 2]
    n_quantized = len(moq_tensors)
    sampled = {"layer.0.layer.attn_qkv.weight": True,
               "word_embeddings": False}
    for name, tr in sampled.items():
        if (name in engine._transposed) != tr:
            raise AssertionError(f"{name}: transposed layout expected {tr}")
    op_builder.reset_launch_counts()
    losses, ms, bits, levels = [], [], [], []
    for _ in range(MOQ_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        bits.append(q.current_bits())
        levels.append({n: group_levels(torch, engine.params[n], 8, tr,
                                       bits[-1])
                       for n, tr in sampled.items()})
    counts = dict(op_builder.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    profile_step = device_profile(torch, lambda: engine.train_batch(
        batch=batch))
    del engine
    torch.cuda.empty_cache()
    print(f"moq losses {losses}, bits {bits}, levels {levels}", flush=True)
    want = {k: c * MOQ_STEPS for k, c in base_counts_per_step.items()}
    want["quantize"] = MOQ_STEPS   # one launch for the step's masters
    got = {k: counts.get(k, 0) for k in want}
    if got != want or sum(counts.values()) != sum(want.values()) or \
            n_quantized != 100:
        raise AssertionError(f"MoQ launches {counts} on {n_quantized} "
                             f"tensors, expected {want}")
    if bits != [12, 11, 11, 10, 10, 10, 10, 9, 9, 9]:
        raise AssertionError(f"MoQ bit schedule {bits}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"MoQ losses {losses} not finite or not falling")
    med = statistics.median(ms[2:])
    base = statistics.median(bert_ms[2:])
    line = {"config": "bert-large bs64 seq128 bf16 zero0 lamb(fused) lr1e-4 "
                      "+ quantize_training symmetric nearest groups 8, "
                      "12 -> 8 bits, period 2",
            "step_ms_median_3_10": med, "step_ms": ms,
            "step_ms_without_moq_median_3_10": base,
            "moq_cost_ms": med - base,
            "losses": losses, "bits": bits, "sampled_group_levels": levels,
            "quantized_tensors": n_quantized,
            "launches": counts, "peak_mem_gb": peak / 1e9,
            "profile_train_step": profile_step}
    return line, counts, moq_tensors


def moq_parity(torch, deepspeed_tpu_torch, bert, quantize_mod, quantizer,
               op_builder, cfg, batch):
    """A 2-layer BERT at full width takes one LAMB step; the same
    post-update masters are then fake-quantized by the MoQ schedule on the
    kernel (its 12 masters in one call) and on the plain version
    (nearest at 8 bits, and stochastic at 6): the results must be
    bit-equal."""
    import dataclasses
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=bert.BertForPreTraining(cfg2, seed=5),
        config=bert_config(fused=True))
    engine.train_batch(batch=batch)
    masters = {k: p.detach().clone() for k, p in engine.params.items()}
    transposed = engine._transposed
    del engine

    out = {}
    for rounding, bits in (("nearest", 8), ("stochastic", 6)):
        runs = []
        for plain in (False, True):
            params = {k: v.clone() for k, v in masters.items()}
            sched = quantize_mod.Quantizer(
                q_groups=8, q_rounding=int(rounding == "stochastic"),
                q_start_bits=bits, q_target_bits=bits)
            op_builder.reset_launch_counts()
            saved = quantize_mod.quantize_multi
            if plain:
                quantize_mod.quantize_multi = quantizer.quantize_multi_plain
            try:
                sched.quantize(params, transposed=transposed)
            finally:
                quantize_mod.quantize_multi = saved
            torch.cuda.synchronize()
            launched = op_builder.LAUNCHES.get("quantize", 0)
            if launched != (0 if plain else 1):
                raise AssertionError(f"plain={plain}: {launched} quantize "
                                     f"launches")
            runs.append(params)
        differ = [k for k in masters if not torch.equal(runs[0][k],
                                                        runs[1][k])]
        changed = sum(1 for k in masters
                      if not torch.equal(runs[0][k], masters[k]))
        out[rounding] = {"bits": bits, "tensors_quantized": changed,
                         "tensors_differing": len(differ)}
        if differ or changed != 12:
            raise AssertionError(f"MoQ kernel and plain quantizer differ on "
                                 f"{differ[:3]} ({rounding}), {changed} "
                                 f"tensors changed")
    print(f"moq parity 2-layer: {json.dumps(out)}", flush=True)
    return out


def int8_phase(torch, deepspeed_tpu_torch, gpt2, module_quantize, op_builder,
               cfg, ids):
    """GPT-2 medium with int8 transformer weights: ``init_inference(dtype=
    torch.int8)``, greedy ``generate`` on bs 8 × prompt 896, 32 new tokens;
    prefill ms, decode ms/token, the weights' device bytes. The prefill
    logits must lie within 0.25 absolute of a bf16 model built from the
    dequantized weights (the int8 path rounds x·q to bf16 and then
    multiplies by the bf16-rounded scale where the reference rounds
    q·scale to bf16: a relative difference of ~2^-8 in each of the 96
    products, which after 24 layers moves logits of size ~3 by up to
    ~0.1), with the greedy tokens of at least 7 of the 8 sequences
    agreeing. Returns (int8 line, launch counts)."""
    import copy
    torch.cuda.reset_peak_memory_stats()
    engine = deepspeed_tpu_torch.init_inference(
        gpt2.GPT2LMHeadModel(cfg, seed=0), dtype=torch.int8)
    engine.generate(ids[:, :32], max_new_tokens=4)          # warm-up
    torch.cuda.synchronize()
    op_builder.reset_launch_counts()
    out = engine.generate(ids, max_new_tokens=INT8_NEW)
    torch.cuda.synchronize()
    counts = dict(op_builder.LAUNCHES)
    if out.shape != (B, ids.shape[1] + INT8_NEW) or \
            not torch.equal(out[:, :ids.shape[1]], ids) or \
            int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"int8 generate: output {tuple(out.shape)}")
    for k in ("flash_fwd", "decode_attention"):
        if counts.get(k, 0) == 0:
            raise AssertionError(f"kernel {k} never launched on the int8 path")
    prefill_ms = host_ms(lambda: engine.generate(ids, max_new_tokens=1))
    gen_ms = host_ms(lambda: engine.generate(ids, max_new_tokens=INT8_NEW),
                     reps=2)
    mod = engine.module
    int8_bytes = sum(p.numel() for p in mod.parameters()
                     if p.dtype == torch.int8)
    bf16_bytes = sum(2 * p.numel() for p in mod.parameters()
                     if p.dtype == torch.bfloat16)
    scale_bytes = sum(4 * s.numel() for s in engine.quant_scales.values())
    saved = engine.int8_bytes_saved

    ref = copy.deepcopy(mod)
    module_quantize.dequantize_transformer_layer(ref, dtype=torch.bfloat16)
    ref_bytes = sum(p.numel() * p.element_size() for p in ref.parameters())
    with torch.no_grad():
        got = mod({"input_ids": ids}, return_logits=True, last_only=True)
        want = ref({"input_ids": ids}, return_logits=True, last_only=True)
    got, want = got[:, -1, :cfg.vocab_size], want[:, -1, :cfg.vocab_size]
    err = (got - want).abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    ref_ms = host_ms(lambda: ref({"input_ids": ids}, return_logits=True,
                                 last_only=True))
    peak = torch.cuda.max_memory_allocated()
    del ref, engine, mod
    torch.cuda.empty_cache()
    line = {"config": "gpt2-medium int8 weights (qkv, attn proj, mlp fc, "
                      "mlp proj; per-row fp32 scales), bf16 activations, "
                      "bs8 prompt896, 32 new, greedy",
            "prefill_ms": prefill_ms, "generate_ms": gen_ms,
            "decode_ms_per_token": (gen_ms - prefill_ms) / (INT8_NEW - 1),
            "tokens_per_s": B * INT8_NEW / gen_ms * 1e3,
            "dequantized_bf16_prefill_forward_ms": ref_ms,
            "int8_bytes_saved": saved,
            "weight_bytes": {"int8": int8_bytes, "bf16": bf16_bytes,
                             "scales_fp32": scale_bytes,
                             "total": int8_bytes + bf16_bytes + scale_bytes,
                             "all_bf16_model": ref_bytes,
                             "bytes_shed": ref_bytes - int8_bytes
                             - bf16_bytes - scale_bytes},
            "prefill_logits_vs_dequantized_bf16": {
                "max_abs_err": err, "logit_scale": want.abs().max().item(),
                "argmax_agree": agree},
            "launches": counts, "peak_mem_gb": peak / 1e9}
    print(f"int8 check: prefill logits max abs err {err:.4g} against the "
          f"dequantized bf16 model, argmax agree {agree}", flush=True)
    if not (err <= 0.25 and agree >= 7 / 8):
        raise AssertionError(f"int8 logits disagree with the dequantized "
                             f"bf16 model: {err}, agreement {agree}")
    return line, counts


def sparse_case(np, sfk, lay, block, causal, packed):
    """The strategy of the fused form's kernel part (the path's own plan:
    the layout decomposed, its global columns packed) or of the predicated
    form (the raw layout), on the card."""
    lay = np.asarray(lay) != 0
    if packed:
        return sfk._get_plan(lay, block, causal, D ** -0.5, "cuda:0").strat
    return sfk._get_strategy(lay, block, causal, D ** -0.5, device="cuda:0")


def bert_sparse_layout(ssc, heads):
    """bench.py's bert-sparse layout: Fixed, block 64, 4 local blocks (a
    256-token window), 1 global block, bidirectional, at seq 2048."""
    return ssc.FixedSparsityConfig(
        num_heads=heads, block=SPARSE_BLOCK,
        num_local_blocks=SPARSE_WINDOW // SPARSE_BLOCK,
        num_global_blocks=1).make_layout(SPARSE_S)


def check_sparse_kernels(torch, np, sfk, ssc):
    """Phase 3, the sparse kernels (forward, dq with its delta, dk/dv and
    the bias cotangent) against their plain versions; the backward of the
    BERT, GPT-2 and a biased causal case rerun bit-equal. Returns the max
    abs errors at
    the BERT path's shape (bf16; fused and predicated lists) and the
    largest bias-cotangent error of the bf16 cases."""
    gen = torch.Generator(device="cuda").manual_seed(21)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def fixed(block, causal, seq):
        return ssc.FixedSparsityConfig(
            num_heads=H, block=block, num_local_blocks=4,
            attention="unidirectional" if causal else "bidirectional"
        ).make_layout(seq)

    def with_empty_rows(lay):
        lay = lay.copy()
        lay[:, 1, :] = 0                 # no live block
        lay[:, 2, :] = 0
        lay[:, 2, 3] = 1                 # a block above the diagonal only
        return lay

    from deepspeed_tpu_torch.ops.sparse_attention.fused_kernels import \
        sparse_mode_layout
    gpt_lay, _ = sparse_mode_layout(GPT_SPARSE_MODE, H, GPT_SPARSE_S)
    # (name, batch, layout, block, causal, packed, bias)
    cases = [
        ("bert", SPARSE_B, bert_sparse_layout(ssc, H), SPARSE_BLOCK, False,
         True, False),
        ("bert_predicated", SPARSE_B, bert_sparse_layout(ssc, H),
         SPARSE_BLOCK, False, False, False),
        ("gpt2", GPT_SPARSE_B, gpt_lay, 128, True, True, False),
        ("b16_causal_bias", 2, fixed(16, True, 1024), 16, True, True, True),
        ("b16_bidi", 2, fixed(16, False, 1024), 16, False, True, False),
        ("b64_causal_bias_empty_rows_raw", 2,
         with_empty_rows(fixed(64, True, 1024)), 64, True, False, True),
        ("b128_bidi_bias_packed", 2, fixed(128, False, 2048), 128, False,
         True, True),
        ("b128_causal_raw", 2, fixed(128, True, 1024), 128, True, False,
         False),
    ]
    main_err, dbias_err = {}, 0.0
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    for dtype, tol in tols.items():
        for name, b, lay, block, causal, packed, bias in cases:
            strat = sparse_case(np, sfk, lay, block, causal, packed)
            S, Skv = strat.Sq, strat.Skv
            q, do = rnd(b, H, S, D, dtype=dtype), rnd(b, H, S, D, dtype=dtype)
            k, v = rnd(b, H, Skv, D, dtype=dtype), rnd(b, H, Skv, D,
                                                       dtype=dtype)
            kpb = rnd(b, Skv) if bias else None
            o, lse = sfk.sparse_attention_fwd(q, k, v, kpb, strat)
            o2, lse2 = sfk.sparse_attention_fwd(q, k, v, kpb, strat)
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                raise AssertionError(f"sparse forward reruns differ "
                                     f"({name}, {dtype})")
            del o2, lse2
            o_ref, lse_ref = sfk.sparse_attention_fwd_plain(q, k, v, kpb,
                                                            strat)
            # dq computes delta = rowsum(do·o) from the rows it stages
            dq, delta = sfk.sparse_attention_dq(q, k, v, kpb, do, o_ref,
                                                lse_ref, strat)
            dq_ref, delta_ref = sfk.sparse_attention_dq_plain(
                q, k, v, kpb, do, o_ref, lse_ref, strat)
            dk, dv, db = sfk.sparse_attention_dkv(q, k, v, kpb, do, lse_ref,
                                                  delta, strat, True)
            dk_ref, dv_ref, db_ref = sfk.sparse_attention_dkv_plain(
                q, k, v, kpb, do, lse_ref, delta, strat, True)
            if name in ("bert", "gpt2", "b16_causal_bias"):
                # the backward reruns bit-equal (no atomics, fixed order)
                again = sfk.sparse_attention_dq(q, k, v, kpb, do, o_ref,
                                                lse_ref, strat) + \
                    sfk.sparse_attention_dkv(q, k, v, kpb, do, lse_ref,
                                             delta, strat, True)
                if not all(a is b is None or torch.equal(a, b) for a, b in
                           zip(again, (dq, delta, dk, dv, db))):
                    raise AssertionError(f"sparse backward reruns differ "
                                         f"({name}, {dtype})")
                del again
            torch.cuda.synchronize()
            errs = {"o": close(o, o_ref, tol), "lse": close(lse, lse_ref, 2e-5),
                    "delta": close(delta, delta_ref, 2e-5),
                    "dq": close(dq, dq_ref, tol), "dk": close(dk, dk_ref, tol),
                    "dv": close(dv, dv_ref, tol)}
            if bias:
                errs["dbias"] = close(db, db_ref, tol)
            print(f"check sparse {name} {str(dtype)[6:]} B{b} S{S} Skv{Skv} "
                  f"block {block}: " + ", ".join(
                      f"{k} err {e:.3g}" for k, (e, _) in errs.items()),
                  flush=True)
            if not all(ok for _, ok in errs.values()):
                raise AssertionError(f"sparse kernels disagree with their "
                                     f"plain versions ({name}, {dtype})")
            if name.startswith("b64_causal"):
                if not ((lse[:, :, 64:192] == -1e30).all()
                        and (o[:, :, 64:192] == 0).all()):
                    raise AssertionError("rows with no visible key did not "
                                         "give 0 and lse -1e30")
            if dtype == torch.bfloat16:
                if bias:
                    dbias_err = max(dbias_err, errs["dbias"][0])
                if name.startswith("bert"):
                    suffix = "_predicated" if name.endswith("predicated") \
                        else ""
                    main_err["sparse_fwd" + suffix] = errs["o"][0]
                    main_err["sparse_dq" + suffix] = errs["dq"][0]
                    main_err["sparse_dkv" + suffix] = max(errs["dk"][0],
                                                          errs["dv"][0])
            del q, k, v, do, kpb, o, lse, o_ref, lse_ref, dq, dq_ref, dk, dv
            del dk_ref, dv_ref, db, db_ref, delta, delta_ref
    torch.cuda.empty_cache()
    return main_err, dbias_err


# (block, causal, seq, packed, bias, D, empty) at B 2, H 16, bf16: head
# dims 16, 24 and 32 (DP 32), 64; fine blocks 16, 32, 64; query tails (seq
# % 64 of 16 and 32), the raw lists' key tail, rows with no live key,
# packed and raw lists (tests/test_torch_cuda_kernels.py's forward cases)
SPARSE_FWD_SHAPES = [
    (16, False, 208, False, True, 16, False),
    (32, True, 352, True, True, 32, True),
    (64, False, 512, False, False, 64, True),
    (64, True, 1024, True, True, 64, False),
    (16, True, 144, False, False, 24, False),
    (32, False, 96, False, True, 64, False),
    (16, True, 512, True, False, 64, True),
    (32, False, 256, True, False, 16, False)]


def check_sparse_fwd_shapes(torch, np, sfk, ssc):
    """Phase 3, the bf16 sparse forward beyond the paths' shapes: o
    within 2e-2 and lse within 2e-5 of the plain version, o = 0 and lse
    -1e30 on rows with no live key, and a rerun bit-equal."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    worst = {"o": 0.0, "lse": 0.0}
    for block, causal, seq, packed, bias, d, empty in SPARSE_FWD_SHAPES:
        lay = ssc.FixedSparsityConfig(
            num_heads=H, block=block, num_local_blocks=4,
            attention="unidirectional" if causal else "bidirectional"
        ).make_layout(seq) != 0
        if empty:
            lay[:, 1, :] = False             # a row with no live block
            lay[:, 2, :] = False
            lay[:, 2, 3] = True              # only above the diagonal
        strat = sparse_case(np, sfk, lay, block, causal, packed)
        q = torch.randn(2, H, seq, d, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(2, H, strat.Skv, d, generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        kpb = torch.randn(2, strat.Skv, generator=gen, device="cuda") \
            if bias else None
        o, lse = sfk.sparse_attention_fwd(q, k, v, kpb, strat)
        o2, lse2 = sfk.sparse_attention_fwd(q, k, v, kpb, strat)
        o_ref, lse_ref = sfk.sparse_attention_fwd_plain(q, k, v, kpb, strat)
        torch.cuda.synchronize()
        errs = {"o": close(o, o_ref, 2e-2), "lse": close(lse, lse_ref, 2e-5)}
        dead = slice(block, (3 if causal else 2) * block)
        if not (all(ok for _, ok in errs.values()) and torch.equal(o, o2)
                and torch.equal(lse, lse2)) or (empty and not (
                    (lse[:, :, dead] == -1e30).all()
                    and (o[:, :, dead] == 0).all())):
            raise AssertionError(
                f"sparse forward (block {block}, causal {causal}, seq "
                f"{seq}, packed {packed}, D {d}): errors {errs}, rerun "
                f"equal {torch.equal(o, o2)}")
        for key, (e, _) in errs.items():
            worst[key] = max(worst[key], e)
        del q, k, v, kpb, o, lse, o2, lse2, o_ref, lse_ref
    print(f"check sparse_fwd shapes: {len(SPARSE_FWD_SHAPES)} classes (D "
          f"16/24/32/64, fine blocks 16/32/64, query and key tails, empty "
          f"rows, packed and raw), reruns bit-equal, max errors {worst}",
          flush=True)
    torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_sparse(sfk, fused_lamb):
    """The sparse kernels and LAMB pass 1 on their plain versions,
    restoring the kernels."""
    saved = (sfk.sparse_attention_fwd, sfk.sparse_attention_dq,
             sfk.sparse_attention_dkv, fused_lamb.lamb_pass1)
    sfk.sparse_attention_fwd = sfk.sparse_attention_fwd_plain
    sfk.sparse_attention_dq = sfk.sparse_attention_dq_plain
    sfk.sparse_attention_dkv = sfk.sparse_attention_dkv_plain
    fused_lamb.lamb_pass1 = fused_lamb.lamb_pass1_all_plain
    try:
        yield
    finally:
        (sfk.sparse_attention_fwd, sfk.sparse_attention_dq,
         sfk.sparse_attention_dkv, fused_lamb.lamb_pass1) = saved


def sparse_bert_phase(torch, deepspeed_tpu_torch, bert, op_builder, cfg,
                      dense_cfg, batch, density, card):
    """Phase 12: the sparse BERT-large path, then the dense one at the same
    shape. Returns the ``sparse`` line's BERT part and the launches of the
    sparse run."""
    torch.cuda.reset_peak_memory_stats()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=bert.BertForPreTraining(cfg, seed=0),
        config=bert_config(fused=True, batch=SPARSE_B))
    op_builder.reset_launch_counts()
    losses, step_ms = run_steps(torch, engine, batch, SPARSE_STEPS)
    counts = dict(op_builder.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    profile = device_profile(torch, lambda: engine.train_batch(batch=batch))
    n_params = sum(p.numel() for p in engine.params.values())
    del engine
    torch.cuda.empty_cache()
    print(f"launches on the sparse BERT path: {counts}", flush=True)
    print(f"sparse bert losses: {losses}", flush=True)
    want = {"sparse_fwd": 24 * SPARSE_STEPS, "sparse_dq": 24 * SPARSE_STEPS,
            "sparse_dkv": 24 * SPARSE_STEPS, "lamb": SPARSE_STEPS}
    if counts != want:
        raise AssertionError(f"sparse BERT launches {counts}, expected "
                             f"{want} and nothing else")
    ln_vocab = math.log(cfg.vocab_size)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("a sparse BERT loss is not finite")
    if abs(losses[0] - ln_vocab) > 0.5 or not losses[-1] < losses[0]:
        raise AssertionError(f"sparse BERT losses {losses}: the first is "
                             f"not near ln(vocab) {ln_vocab} or they do "
                             f"not fall")

    torch.cuda.reset_peak_memory_stats()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=bert.BertForPreTraining(dense_cfg, seed=0),
        config=bert_config(fused=True, batch=SPARSE_B))
    op_builder.reset_launch_counts()
    dense_losses, dense_ms = run_steps(torch, engine, batch,
                                       DENSE_LONG_STEPS)
    dense_counts = dict(op_builder.LAUNCHES)
    dense_peak = torch.cuda.max_memory_allocated()
    del engine
    torch.cuda.empty_cache()
    if dense_counts.get("flash_fwd") != 24 * DENSE_LONG_STEPS or any(
            k.startswith("sparse") for k in dense_counts):
        raise AssertionError(f"dense BERT launches {dense_counts}")
    if not all(math.isfinite(x) for x in dense_losses):
        raise AssertionError("a dense BERT loss is not finite")

    med = statistics.median(step_ms[2:])
    dense_med = statistics.median(dense_ms[2:])
    L, E, S = cfg.num_hidden_layers, cfg.hidden_size, SPARSE_S
    fpt = 6 * n_params + 12 * L * E * S * density
    dense_fpt = 6 * n_params + 12 * L * E * S
    tokens = SPARSE_B * SPARSE_S
    return {
        "card": card,
        "config": f"bert-large bs{SPARSE_B} seq{SPARSE_S} bf16 zero0 "
                  f"lamb(fused) lr{LR}, post-LN, MLM 15%, Fixed block "
                  f"{SPARSE_BLOCK} window {SPARSE_WINDOW} 1 global",
        "layout_density": density, "n_params": n_params,
        "step_ms_median_3_10": med, "step_ms": step_ms,
        "tokens_per_s": tokens / med * 1e3,
        "samples_per_s": SPARSE_B / med * 1e3,
        "flops_per_token": fpt,
        "mfu": fpt * tokens / (med / 1e3) / BF16_FLOPS,
        "device_idle_share": profile["device_idle_share"],
        "peak_mem_gb": peak / 1e9, "losses": losses,
        "launches": counts, "profile_train_step": profile,
        "dense_same_shape": {
            "step_ms_median_3_5": dense_med, "step_ms": dense_ms,
            "tokens_per_s": tokens / dense_med * 1e3,
            "mfu": dense_fpt * tokens / (dense_med / 1e3) / BF16_FLOPS,
            "peak_mem_gb": dense_peak / 1e9, "losses": dense_losses,
            "launches": dense_counts},
        "sparse_speedup_vs_dense": dense_med / med,
    }, counts


def compare_steps(torch, a, b):
    """Loss, gradient and parameter differences of two one-step runs."""
    loss_a, grads_a, params_a = a
    loss_b, grads_b, params_b = b
    num = sum((grads_a[k] - grads_b[k]).square().sum() for k in grads_b)
    den = sum(grads_b[k].square().sum() for k in grads_b)
    n_all = sum(t.numel() for t in params_b.values())
    n_diff = sum(((params_a[k] - params_b[k]).abs() > 1e-6).sum().item()
                 for k in params_b)
    return {"loss_a": loss_a, "loss_b": loss_b,
            "loss_abs_err": abs(loss_a - loss_b),
            "grad_rel_l2": (num / den).sqrt().item(),
            "param_max_abs_diff": max(
                (params_a[k] - params_b[k]).abs().max().item()
                for k in params_b),
            "param_share_differing": n_diff / n_all}


def sparse_bert_parity(torch, os, deepspeed_tpu_torch, bert, op_builder, sfk,
                       fused_lamb, cfg, batch):
    """Phase 13: a 2-layer full-width sparse BERT, one fused-LAMB step on
    the kernels, one on the plain versions, and one on the kernels with
    ``DS_SPARSE_IMPL=predicated``. Tolerances: phase 9's (loss 0.02,
    gradients 2e-2 relative in L2, params within 2·lr·max_coeff with at
    most 5% differing by more than 1e-6). Returns the comparisons and the
    launches of the predicated step."""
    import dataclasses
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)

    def one(plain, impl):
        os.environ["DS_SPARSE_IMPL"] = impl
        try:
            engine, *_ = deepspeed_tpu_torch.initialize(
                model=bert.BertForPreTraining(cfg2, seed=5),
                config=bert_config(fused=True, batch=SPARSE_B))
            op_builder.reset_launch_counts()
            with plain_sparse(sfk, fused_lamb) if plain else \
                    contextlib.nullcontext():
                engine._micro_step(batch)
                grads = {k: p.grad.clone() for k, p in engine.params.items()}
                loss = float(engine.train_batch(batch=batch))
            counts = dict(op_builder.LAUNCHES)
        finally:
            del os.environ["DS_SPARSE_IMPL"]
        params = {k: p.detach().clone() for k, p in engine.params.items()}
        del engine
        torch.cuda.empty_cache()
        return (loss, grads, params), counts

    kern, kern_counts = one(False, "fused")
    plain, plain_counts = one(True, "fused")
    pred, pred_counts = one(False, "predicated")
    # two layers, a forward and a backward in each of the two passes
    want = {"sparse_fwd": 4, "sparse_dq": 4, "sparse_dkv": 4, "lamb": 1}
    if kern_counts != want or pred_counts != want or plain_counts:
        raise AssertionError(f"parity launches: kernels {kern_counts}, "
                             f"plain {plain_counts}, predicated "
                             f"{pred_counts}")
    out = {"kernels_vs_plain": compare_steps(torch, kern, plain),
           "predicated_vs_fused": compare_steps(torch, pred, kern)}
    print(f"sparse bert parity 2-layer one step: {json.dumps(out)}",
          flush=True)
    for what, c in out.items():
        if not (math.isfinite(c["loss_a"]) and c["loss_abs_err"] <= 0.02
                and c["grad_rel_l2"] <= 2e-2
                and c["param_max_abs_diff"] <= 2 * LR * 10 * 1.001
                and c["param_share_differing"] <= 0.05):
            raise AssertionError(f"sparse BERT {what} disagree: {c}")
    return out, pred_counts


def sparse_gpt2_phase(torch, deepspeed_tpu_torch, gpt2, op_builder, cfg,
                      density, card):
    """Phase 14: GPT-2 medium with causal sparse attention. Returns the
    ``sparse`` line's GPT-2 part and its launches."""
    batch = gpt2.synthetic_batch(GPT_SPARSE_B, GPT_SPARSE_S, cfg.vocab_size,
                                 seed=9)
    torch.cuda.reset_peak_memory_stats()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2.GPT2LMHeadModel(cfg, seed=0),
        config=train_config(batch=GPT_SPARSE_B, sweep=True))
    op_builder.reset_launch_counts()
    losses, step_ms = run_steps(torch, engine, batch, GPT_SPARSE_STEPS)
    counts = dict(op_builder.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    profile = device_profile(torch, lambda: engine.train_batch(batch=batch))
    n_params = sum(p.numel() for p in engine.params.values())
    del engine
    torch.cuda.empty_cache()
    print(f"launches on the sparse GPT-2 path: {counts}", flush=True)
    print(f"sparse gpt2 losses: {losses}", flush=True)
    n = GPT_SPARSE_STEPS
    want = {"sparse_fwd": 24 * n, "sparse_dq": 24 * n, "sparse_dkv": 24 * n,
            "adam": n}
    if counts != want:
        raise AssertionError(f"sparse GPT-2 launches {counts}, expected "
                             f"{want}")
    if not all(math.isfinite(x) for x in losses) or \
            abs(losses[0] - math.log(cfg.vocab_size)) > 0.5 or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"sparse GPT-2 losses {losses}")
    med = statistics.median(step_ms[2:])
    tokens = GPT_SPARSE_B * GPT_SPARSE_S
    fpt = 6 * n_params + 12 * cfg.n_layer * cfg.n_embd * GPT_SPARSE_S * \
        density
    return {
        "card": card,
        "config": f"gpt2-medium attention_mode={GPT_SPARSE_MODE} "
                  f"bs{GPT_SPARSE_B} seq{GPT_SPARSE_S} bf16 zero1 "
                  f"adam-sweep clip1.0",
        "layout_density": density, "n_params": n_params,
        "step_ms_median_3_5": med, "step_ms": step_ms,
        "tokens_per_s": tokens / med * 1e3, "flops_per_token": fpt,
        "mfu": fpt * tokens / (med / 1e3) / BF16_FLOPS,
        "device_idle_share": profile["device_idle_share"],
        "peak_mem_gb": peak / 1e9, "losses": losses, "launches": counts,
        "profile_train_step": profile,
    }, counts


def sdpa_masked_ms(torch, q, k, v, do, mask):
    """``scaled_dot_product_attention`` with a boolean element mask (a
    yardstick, timed only; unpinned: PyTorch picks the backend): (forward
    ms, backward-alone ms, the backward's kernels by device time). The
    backward is timed on a retained graph: ``torch.autograd.grad(out, (q,
    k, v), do, retain_graph=True)`` by CUDA events."""
    F = torch.nn.functional
    fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), iters=10)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    bwd_fn = lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                         retain_graph=True)
    bwd = cuda_ms(bwd_fn, iters=10)
    kernels = sorted(_device_kernels(torch, bwd_fn, 2), key=lambda e: -e[2])
    del out, qg, kg, vg
    return fwd, bwd, [name[:70] for name, _, _ in kernels[:3]]


def sparse_shape_timing(torch, sfk, strat, q, k, v, do, what):
    """The three sparse wrappers at one shape (bf16, CUDA events), their
    bounds and their plain versions' times. dq reads q, k, v, do, o and
    lse and writes dq and delta; dk/dv reads q, k, v, do, lse and delta
    and writes dk and dv; the forward reads q, k, v and writes o, lse.
    Operations: 4, 6 and 8 D flops a live (query, key) pair."""
    b, _, S, _ = q.shape
    Skv = strat.Skv
    o, lse = sfk.sparse_attention_fwd(q, k, v, None, strat)
    dq, delta = sfk.sparse_attention_dq(q, k, v, None, do, o, lse, strat)
    pairs = b * int(strat.element_mask("cuda").sum())
    tq, tk = b * H * S * D * 2, b * H * Skv * D * 2    # one q-, one k-side
    row = b * H * S * 4                                # one fp32 row stat
    out = {"shape": what, "live_pairs": pairs,
           "tile_pairs_a_head": strat.tile_pairs // H,
           "fwd": {"bytes": 2 * tq + 2 * tk + row, "flops": 4 * D * pairs,
                   "fn": lambda: sfk.sparse_attention_fwd(q, k, v, None,
                                                          strat),
                   "plain": lambda: sfk.sparse_attention_fwd_plain(
                       q, k, v, None, strat)},
           "dq": {"bytes": 4 * tq + 2 * tk + 2 * row, "flops": 6 * D * pairs,
                  "fn": lambda: sfk.sparse_attention_dq(
                      q, k, v, None, do, o, lse, strat),
                  "plain": lambda: sfk.sparse_attention_dq_plain(
                      q, k, v, None, do, o, lse, strat)},
           "dkv": {"bytes": 2 * tq + 4 * tk + 2 * row, "flops": 8 * D * pairs,
                   "fn": lambda: sfk.sparse_attention_dkv(
                       q, k, v, None, do, lse, delta, strat),
                   "plain": lambda: sfk.sparse_attention_dkv_plain(
                       q, k, v, None, do, lse, delta, strat)}}
    out["fwd"]["device_ms"] = maybe_device_ms(torch, out["fwd"]["fn"],
                                              "sparse_fwd")
    for key in ("fwd", "dq", "dkv"):
        t = out[key]
        t["ms"] = cuda_ms(t.pop("fn"))
        t["plain_ms"] = cuda_ms(t.pop("plain"), iters=3)
        t["bound_ms"] = max(t["bytes"] / HBM_BYTES_PER_S,
                            t["flops"] / BF16_FLOPS) * 1e3
        t["bound_by"] = "bytes" if t["bytes"] / HBM_BYTES_PER_S >= \
            t["flops"] / BF16_FLOPS else "operations"
        t["x_bound"] = t["ms"] / t["bound_ms"]
        t["tflops"] = t["flops"] / t["ms"] / 1e9
    del o, lse, dq, delta
    return out


def sparse_kernel_rows(torch, np, sfk, sk, ssc):
    """Timings of the sparse kernels (bf16) at the BERT path's shape,
    through the fused form's packed lists (rows 16-18) and the predicated
    form's raw lists (rows 19-21), and at the causal sparse GPT-2 path's
    shape (packed; printed as ``sparse timing`` and kept in the fused
    rows under ``gpt2``). The PyTorch call that computes the same function
    is ``scaled_dot_product_attention`` with the layout expanded to a
    boolean element mask; its backward is timed alone."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    bf16 = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf16)

    def extend(x, Skv):
        S = x.shape[2]
        return torch.cat([x, x[:, :, :Skv - S]], 2) if Skv > S else x

    def report(t, sdpa_fwd, sdpa_bwd, kernels):
        t.update(sdpa_fwd_ms=sdpa_fwd, sdpa_bwd_ms=sdpa_bwd,
                 sdpa_bwd_kernels=kernels,
                 dq_plus_dkv_ms=t["dq"]["ms"] + t["dkv"]["ms"],
                 dq_plus_dkv_over_sdpa_bwd=(t["dq"]["ms"] + t["dkv"]["ms"])
                 / sdpa_bwd)
        print(f"sparse timing: {json.dumps(t)}", flush=True)

    # the causal sparse GPT-2 path: sparse:1024/128 at B 2, S 4096
    glay, gblock = sfk.sparse_mode_layout(GPT_SPARSE_MODE, H, GPT_SPARSE_S)
    b, S = GPT_SPARSE_B, GPT_SPARSE_S
    q, do, k, v = (rnd(b, H, S, D) for _ in range(4))
    mask = torch.from_numpy(sk.layout_to_dense_mask(glay, gblock, S)).cuda() \
        .bool().tril()[None]
    sdpa = sdpa_masked_ms(torch, q, k, v, do, mask)
    strat = sparse_case(np, sfk, glay, gblock, True, True)
    gpt = sparse_shape_timing(
        torch, sfk, strat, q, extend(k, strat.Skv), extend(v, strat.Skv),
        do, f"B{b} H{H} S{S} Skv{strat.Skv} D{D} bf16, causal "
            f"{GPT_SPARSE_MODE}, global columns packed")
    report(gpt, *sdpa)
    del q, do, k, v, mask

    lay = bert_sparse_layout(ssc, H)
    b, S = SPARSE_B, SPARSE_S
    q, do = rnd(b, H, S, D), rnd(b, H, S, D)
    k, v = rnd(b, H, S, D), rnd(b, H, S, D)
    mask = torch.from_numpy(sk.layout_to_dense_mask(lay, SPARSE_BLOCK, S)
                            ).cuda().bool()[None]
    sdpa_fwd, sdpa_bwd, sdpa_kernels = sdpa_masked_ms(torch, q, k, v, do,
                                                      mask)
    rows = []
    for packed, suffix in ((True, ""), (False, "_predicated")):
        strat = sparse_case(np, sfk, lay, SPARSE_BLOCK, False, packed)
        t = sparse_shape_timing(
            torch, sfk, strat, q, extend(k, strat.Skv), extend(v, strat.Skv),
            do, f"B{b} H{H} S{S} Skv{strat.Skv} D{D} bf16, Fixed block "
                f"{SPARSE_BLOCK}, {strat.tile_pairs // H} live 64x64 tiles "
                f"a head, " + ("global columns packed" if packed
                               else "raw layout (predicated form)"))
        report(t, sdpa_fwd, sdpa_bwd, sdpa_kernels)
        src = "deepspeed_tpu/ops/sparse_attention/" + (
            "fused_kernels.py" if packed else "kernels.py")
        lines = ((192, 239, 279) if packed else (35, 88, 129))
        common = {"route": "cuda",
                  "source": "deepspeed_tpu_torch/csrc/sparse_attention.cu",
                  "shape": t["shape"], "peak": BF16_FLOPS,
                  "live_pairs": t["live_pairs"],
                  "tile_pairs": strat.tile_pairs}
        bwd_note = ("scaled_dot_product_attention backward alone (retained "
                    "forward) with the layout's boolean mask, dq, dk and dv "
                    "together; kernels " + ", ".join(sdpa_kernels))
        for key, name, line, lib, note in (
                ("fwd", "sparse_fwd", lines[0], sdpa_fwd,
                 "scaled_dot_product_attention with the layout's boolean "
                 "element mask"),
                ("dq", "sparse_dq", lines[1], sdpa_bwd, bwd_note),
                ("dkv", "sparse_dkv", lines[2], sdpa_bwd, bwd_note)):
            row = dict(common, name=name + suffix, replaces=f"{src}:{line}",
                       ms=t[key]["ms"], plain_ms=t[key]["plain_ms"],
                       **({"device_ms": t[key]["device_ms"]}
                          if "device_ms" in t[key] else {}),
                       library_ms=lib, library_note=note,
                       bytes=t[key]["bytes"], flops=t[key]["flops"])
            if packed:
                row["gpt2"] = {"shape": gpt["shape"], **{
                    f: gpt[key][f] for f in ("ms", "device_ms", "bound_ms",
                                             "bound_by", "x_bound",
                                             "plain_ms") if f in gpt[key]},
                    "library_ms": gpt["sdpa_fwd_ms"] if key == "fwd"
                    else gpt["sdpa_bwd_ms"]}
            rows.append(row)
    del q, k, v, do, mask
    torch.cuda.empty_cache()
    return rows


def finish_rows(rows, launches, max_err, card):
    """bound_ms (the larger of bytes at 3.35 TB/s and operations at the
    peak of their type), launches and max_abs_err for each row."""
    out = []
    for row in rows:
        t_bytes = row.pop("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = row.pop("flops") / row.pop("peak", BF16_FLOPS) * 1e3
        row.update(launches=launches[row["name"]],
                   max_abs_err=max_err[row["name"]],
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   card=card)
        out.append(row)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import dataclasses
    import os

    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import bert, gpt2
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.adam import fused_adam
    from deepspeed_tpu_torch.module_inject import module_quantize
    from deepspeed_tpu_torch.ops.lamb import fused_lamb
    from deepspeed_tpu_torch.ops.quantizer import quantizer
    from deepspeed_tpu_torch.ops.sparse_attention import fused_kernels as sfk
    from deepspeed_tpu_torch.ops.sparse_attention import kernels as sk
    from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as ssc
    from deepspeed_tpu_torch.ops.transformer import attention as attn_mod
    from deepspeed_tpu_torch.ops.transformer import (decode, flash, fused,
                                                     transformer)
    from deepspeed_tpu_torch.runtime import quantize as quantize_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = card_line()
    print(f"card: {card}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    op_builder.load_kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s ({op_builder.BUILD_DIR})",
          flush=True)

    # 3. kernels against their plain versions
    max_err = check_kernels(torch, flash, decode)
    cfg = gpt2.PRESETS["gpt2-medium"]
    param_shapes = [tuple(p.shape) for p in
                    gpt2.GPT2LMHeadModel(cfg, seed=0).parameters()]
    torch.cuda.empty_cache()
    max_err.update(check_training_kernels(torch, flash, fused_adam,
                                          param_shapes))
    bert_cfg = bert.PRESETS["bert-large"]
    bert_shapes = bert_param_shapes(torch, bert, bert_cfg)
    max_err.update(check_bert_kernels(torch, flash, fused, fused_lamb,
                                      bert_shapes))
    max_err.update(check_quant_kernels(
        torch, quantizer, fused, bert_shapes,
        bert_moq_table(torch, bert, quantize_mod, bert_cfg)))
    sparse_err, sparse_dbias_err = check_sparse_kernels(torch, np, sfk, ssc)
    max_err.update(sparse_err)
    check_sparse_fwd_shapes(torch, np, sfk, ssc)

    # 4. the generation path at full width
    model = gpt2.GPT2LMHeadModel(cfg, seed=0)
    engine = deepspeed_tpu_torch.init_inference(model, dtype=torch.bfloat16)
    qcfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    qengine = deepspeed_tpu_torch.init_inference(
        gpt2.GPT2LMHeadModel(qcfg, seed=0), dtype=torch.bfloat16)
    long_ids = gpt2.synthetic_batch(B, 896, cfg.vocab_size, seed=1)["input_ids"]
    short_ids = gpt2.synthetic_batch(B, 32, cfg.vocab_size, seed=2)["input_ids"]
    engine.generate(short_ids, max_new_tokens=4)      # warm-up (cuBLAS, ...)
    torch.cuda.synchronize()

    op_builder.reset_launch_counts()
    runs = [("bs8 prompt 896 new 64", engine, long_ids, 64),
            ("bs8 prompt 32 new 128", engine, short_ids, 128),
            ("bs8 prompt 32 new 32 int8-kv", qengine, short_ids, 32)]
    outs = []
    for name, eng, ids, new in runs:
        out = eng.generate(ids, max_new_tokens=new)
        torch.cuda.synchronize()
        outs.append(out)
    launches = dict(op_builder.LAUNCHES)
    print(f"launches on the main path: {launches}", flush=True)
    for (name, _, ids, new), out in zip(runs, outs):
        if out.shape != (B, ids.shape[1] + new):
            raise AssertionError(f"{name}: output shape {tuple(out.shape)}")
        if not torch.equal(out[:, :ids.shape[1]], ids):
            raise AssertionError(f"{name}: prompt not preserved")
        if int(out.max()) >= cfg.vocab_size or int(out.min()) < 0:
            raise AssertionError(f"{name}: token outside the vocab")
    for k in ("flash_fwd", "decode_attention", "decode_attention_int8"):
        if launches.get(k, 0) == 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
    # one decode launch a layer and a generated token after the first
    n_layer = cfg.n_layer
    want = {"decode_attention": n_layer * sum(
                new - 1 for _, eng, _, new in runs if eng is engine),
            "decode_attention_int8": n_layer * sum(
                new - 1 for _, eng, _, new in runs if eng is qengine)}
    for k, n in want.items():
        if launches.get(k, 0) != n:
            raise AssertionError(f"{k}: {launches.get(k, 0)} launches on "
                                 f"the generation path, expected {n}")

    # the same model on the plain attention versions, on the card. The
    # bf16 logits (largest about 3) differ by up to 0.05 after 24 layers,
    # since the kernels and the plain versions round the softmax weights
    # to bf16 at other points: the tolerance is 0.1 absolute, and the
    # greedy tokens of at least 7 of the 8 sequences must agree (a
    # near-tie may flip one)
    logit_tol, min_agree = 0.1, 7 / 8
    agree = {}
    for name, eng, ids in [("prompt 896", engine, long_ids),
                           ("prompt 32", engine, short_ids),
                           ("prompt 32 int8-kv", qengine, short_ids)]:
        pre, step, tok = first_logits(torch, eng.module, ids)
        with plain_attention(gpt2, attn_mod, decode):
            pre_ref, step_ref, _ = first_logits(torch, eng.module, ids, tok)
        scale = pre_ref.abs().max().item()
        for what, got, want in (("prefill", pre, pre_ref),
                                ("decode step", step, step_ref)):
            err = (got - want).abs().max().item()
            same = (got[:, :cfg.vocab_size].argmax(-1)
                    == want[:, :cfg.vocab_size].argmax(-1)).float().mean()
            agree[f"{name} {what}"] = {"max_abs_err": err,
                                       "logit_scale": scale,
                                       "argmax_agree": same.item()}
            print(f"e2e check {name} {what}: logits max abs err {err:.4g} "
                  f"(max |logit| {scale:.3g}), argmax agree {same.item()}")
            if not (err <= logit_tol and same.item() >= min_agree):
                raise AssertionError(f"{name} {what} logits disagree with "
                                     f"the plain run: max abs err {err} "
                                     f"(tolerance {logit_tol}), greedy "
                                     f"agreement {same.item()}")

    # 5. timings of the generation path
    prefill_ms = host_ms(lambda: engine.generate(long_ids, max_new_tokens=1))
    gen_ms = host_ms(lambda: engine.generate(long_ids, max_new_tokens=64),
                     reps=2)
    short_prefill_ms = host_ms(
        lambda: engine.generate(short_ids, max_new_tokens=1))
    short_ms = host_ms(lambda: engine.generate(short_ids, max_new_tokens=128),
                       reps=2)
    e2e = {
        "card": card,
        "prompt896_new64": {
            "prefill_ms": prefill_ms, "generate_ms": gen_ms,
            "decode_ms_per_token": (gen_ms - prefill_ms) / 63,
            "tokens_per_s": B * 64 / gen_ms * 1e3},
        "prompt32_new128": {
            "prefill_ms": short_prefill_ms, "generate_ms": short_ms,
            "decode_ms_per_token": (short_ms - short_prefill_ms) / 127,
            "tokens_per_s": B * 128 / short_ms * 1e3},
        "logit_checks": agree,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        # where the time goes: one prefill, and a decode-heavy run
        "profile_prefill_896": device_profile(
            torch, lambda: engine.generate(long_ids, max_new_tokens=1)),
        "profile_prompt32_new16": device_profile(
            torch, lambda: engine.generate(short_ids, max_new_tokens=16)),
    }

    gen = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v = rnd(B, H, 896, D), rnd(B, H, 896, D), rnd(B, H, 896, D)
    fwd = flash_fwd_timing(torch, flash, B, 896, True)
    flash_row = {
        "name": "flash_fwd", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "deepspeed_tpu/ops/transformer/flash.py:211",
        "shape": fwd["shape"], "ms": fwd["ms"],
        "kernel_ms": fwd["kernel_ms"], "device_ms": fwd["device_ms"],
        "plain_ms": cuda_ms(
            lambda: flash.flash_attention_fwd_plain(q, k, v, True)),
        "library_ms": fwd["sdpa_flash_ms"],
        "library_note": "scaled_dot_product_attention forward, flash "
                        "backend pinned",
        **{key: fwd[key] for key in SDPA_FWD_KEYS if key in fwd},
        "bytes": fwd["bytes"], "flops": fwd["flops"],
    }
    decode_rows = [decode_row(torch, np, decode, op_builder, quantized)
                   for quantized in (False, True)]
    gen_launches = dict(launches)
    del engine, qengine, model, q, k, v
    torch.cuda.empty_cache()

    # 6. the training path at full width
    batch = gpt2.synthetic_batch(B, SEQ, cfg.vocab_size, seed=4)
    torch.cuda.reset_peak_memory_stats()
    model = gpt2.GPT2LMHeadModel(cfg, seed=0)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=train_config(sweep=True))
    fused_engine, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2.GPT2LMHeadModel(cfg, seed=0),
        config=train_config(fused=True))
    op_builder.reset_launch_counts()
    losses, step_ms = run_steps(torch, engine, batch, TRAIN_STEPS)
    sweep_counts = dict(op_builder.LAUNCHES)
    fused_losses, fused_ms = run_steps(torch, fused_engine, batch,
                                       FUSED_STEPS)
    train_launches = dict(op_builder.LAUNCHES)
    peak_mem = torch.cuda.max_memory_allocated()
    fused_counts = {k: train_launches.get(k, 0) - sweep_counts.get(k, 0)
                    for k in train_launches}
    print(f"launches on the training path: sweep {sweep_counts}, "
          f"fused {fused_counts}", flush=True)
    print(f"train losses: sweep {losses}, fused {fused_losses}", flush=True)
    n_tensors = len(engine.params)
    # the fused Adam: one launch a step for up to MULTI_MAX_TENSORS tensors
    fused_launches = -(-n_tensors // fused_adam.MULTI_MAX_TENSORS)
    for counts, steps, adam_per_step in (
            (sweep_counts, TRAIN_STEPS, 1),
            (fused_counts, FUSED_STEPS, fused_launches)):
        want = {"flash_fwd": 24 * steps, "flash_bwd_dq": 24 * steps,
                "flash_bwd_dkv": 24 * steps, "adam": adam_per_step * steps}
        got = {k: counts.get(k, 0) for k in want}
        if got != want or sum(counts.values()) != sum(want.values()):
            raise AssertionError(f"training launches {counts}, expected "
                                 f"{want}")
    # random init: logits of variance ~0.4 add ~0.2 to ln(vocab); both
    # engines start from the same weights, so their first losses are equal
    ln_vocab = math.log(cfg.vocab_size)
    if not all(math.isfinite(x) for x in losses + fused_losses):
        raise AssertionError("a training loss is not finite")
    if abs(losses[0] - ln_vocab) > 0.5 or fused_losses[0] != losses[0]:
        raise AssertionError(f"first losses {losses[0]}, "
                             f"{fused_losses[0]} are not near ln(vocab) "
                             f"{ln_vocab}")
    if not (losses[-1] < losses[0] and fused_losses[-1] < fused_losses[0]):
        raise AssertionError("the loss on the repeated batch did not fall")
    # the two Adam forms are the same math (clip fused or applied first)
    if max(abs(a - b) for a, b in zip(losses, fused_losses)) > 0.05:
        raise AssertionError("the sweep and per-tensor Adam runs diverge")
    del fused_engine
    torch.cuda.empty_cache()

    # 7. one step on the kernels against one on the plain versions
    parity = one_step_parity(torch, deepspeed_tpu_torch, gpt2, attn_mod,
                             decode, fused_adam, cfg, batch)

    # 8. training timings, a profiled step, the kernels
    med = statistics.median(step_ms[2:TRAIN_STEPS])
    n_params = sum(p.numel() for p in engine.params.values())
    flops_per_token = 6 * n_params + 12 * cfg.n_layer * cfg.n_embd * SEQ
    train = {
        "card": card, "config": "gpt2-medium bs8 seq1024 bf16 zero1 "
                                "adam-sweep clip1.0",
        "n_params": n_params, "step_ms_median_3_10": med,
        "step_ms": step_ms, "fused_step_ms": fused_ms,
        "tokens_per_s": B * SEQ / med * 1e3,
        "flops_per_token": flops_per_token,
        "mfu": flops_per_token * B * SEQ / (med / 1e3) / BF16_FLOPS,
        "losses": losses, "fused_losses": fused_losses,
        "peak_mem_gb": peak_mem / 1e9,
        "launches_sweep_run": sweep_counts,
        "launches_fused_run": fused_counts,
        "parity_2layer": parity,
        "profile_train_step": device_profile(
            torch, lambda: engine.train_batch(batch=batch)),
    }
    del engine, model
    torch.cuda.empty_cache()

    # 9. the BERT MLM path at full width: fused LAMB, then plain LAMB
    bert_batch = bert.synthetic_mlm_batch(BERT_B, BERT_S,
                                          bert_cfg.vocab_size, seed=6)
    torch.cuda.reset_peak_memory_stats()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=bert.BertForPreTraining(bert_cfg, seed=0),
        config=bert_config(fused=True))
    op_builder.reset_launch_counts()
    bert_losses, bert_ms = run_steps(torch, engine, bert_batch, BERT_STEPS)
    bert_counts = dict(op_builder.LAUNCHES)
    bert_peak = torch.cuda.max_memory_allocated()
    bert_profile = device_profile(
        torch, lambda: engine.train_batch(batch=bert_batch))
    bert_n_params = sum(p.numel() for p in engine.params.values())
    del engine
    torch.cuda.empty_cache()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=bert.BertForPreTraining(bert_cfg, seed=0),
        config=bert_config(fused=False))
    op_builder.reset_launch_counts()
    plain_losses, plain_ms = run_steps(torch, engine, bert_batch,
                                       BERT_PLAIN_STEPS)
    bert_plain_counts = dict(op_builder.LAUNCHES)
    del engine
    torch.cuda.empty_cache()
    print(f"launches on the BERT path: fused LAMB {bert_counts}, plain "
          f"LAMB {bert_plain_counts}", flush=True)
    print(f"bert losses: fused LAMB {bert_losses}, plain LAMB "
          f"{plain_losses}", flush=True)
    per_step = {"flash_fwd": 24, "flash_bwd_dq": 24, "flash_bwd_dkv": 24,
                "ln_fwd": 48, "ln_bwd": 48, "bias_gelu": 24}
    for counts, steps, lamb_per_step in ((bert_counts, BERT_STEPS, 1),
                                         (bert_plain_counts,
                                          BERT_PLAIN_STEPS, 0)):
        want = {k: c * steps for k, c in per_step.items()}
        if lamb_per_step:
            want["lamb"] = lamb_per_step * steps
        got = {k: counts.get(k, 0) for k in want}
        if got != want or sum(counts.values()) != sum(want.values()):
            raise AssertionError(f"BERT launches {counts}, expected {want}")
    ln_vocab = math.log(bert_cfg.vocab_size)
    if not all(math.isfinite(x) for x in bert_losses + plain_losses):
        raise AssertionError("a BERT training loss is not finite")
    if abs(bert_losses[0] - ln_vocab) > 0.5 or \
            plain_losses[0] != bert_losses[0]:
        raise AssertionError(f"first BERT losses {bert_losses[0]}, "
                             f"{plain_losses[0]} are not near ln(vocab) "
                             f"{ln_vocab} or differ")
    if not (bert_losses[-1] < bert_losses[0]
            and plain_losses[-1] < plain_losses[0]):
        raise AssertionError("the BERT loss on the repeated batch did not "
                             "fall")
    # fused and plain LAMB are the same math (the norms summed in another
    # order): 0.02 absolute over the plain run's steps
    lamb_diff = max(abs(a - b) for a, b in zip(bert_losses, plain_losses))
    if lamb_diff > 0.02:
        raise AssertionError(f"fused and plain LAMB diverge by {lamb_diff}")

    bert_parity = bert_one_step_parity(
        torch, deepspeed_tpu_torch, bert, op_builder,
        lambda: plain_bert(transformer, attn_mod, fused, fused_lamb),
        bert_cfg, bert_batch)
    sdpa = flash_vs_sdpa(torch, flash)
    bert_med = statistics.median(bert_ms[2:BERT_STEPS])
    bert_fpt = 6 * bert_n_params + \
        12 * bert_cfg.num_hidden_layers * bert_cfg.hidden_size * BERT_S
    bert_line = {
        "card": card,
        "config": f"bert-large bs{BERT_B} seq{BERT_S} bf16 zero0 "
                  f"lamb(fused) lr{LR}, post-LN, MLM 15%",
        "n_params": bert_n_params, "step_ms_median_3_10": bert_med,
        "step_ms": bert_ms, "plain_lamb_step_ms": plain_ms,
        "tokens_per_s": BERT_B * BERT_S / bert_med * 1e3,
        "samples_per_s": BERT_B / bert_med * 1e3,
        "flops_per_token": bert_fpt,
        "mfu": bert_fpt * BERT_B * BERT_S / (bert_med / 1e3) / BF16_FLOPS,
        "device_idle_share": bert_profile["device_idle_share"],
        "peak_mem_gb": bert_peak / 1e9,
        "first_loss": bert_losses[0], "last_loss": bert_losses[-1],
        "losses": bert_losses, "plain_lamb_losses": plain_losses,
        "fused_vs_plain_lamb_max_loss_diff": lamb_diff,
        "launches_fused_lamb_run": bert_counts,
        "launches_plain_lamb_run": bert_plain_counts,
        "parity_2layer": bert_parity, "flash_vs_sdpa_s128": sdpa,
        "profile_train_step": bert_profile,
    }

    # 10. the MoQ path: BERT-large with quantize_training, then a one-step
    # kernel-against-plain parity of the quantizer on a 2-layer BERT
    moq_line, moq_counts, moq_tensors = moq_phase(
        torch, deepspeed_tpu_torch, bert, op_builder, bert_cfg, bert_batch,
        dict(per_step, lamb=1), bert_ms)
    moq_line["parity_2layer"] = moq_parity(
        torch, deepspeed_tpu_torch, bert, quantize_mod, quantizer, op_builder,
        bert_cfg, bert_batch)
    moq_line["card"] = card

    # 11. int8-weight GPT-2 medium generation
    int8_line, int8_counts = int8_phase(
        torch, deepspeed_tpu_torch, gpt2, module_quantize, op_builder, cfg,
        long_ids)
    int8_line["card"] = card

    # 12. the sparse BERT-large path, and the dense one at the same shape
    sparse_cfg = dataclasses.replace(
        bert_cfg, sparse_attention_mode="fixed", sparse_block=SPARSE_BLOCK,
        sparse_num_local_blocks=SPARSE_WINDOW // SPARSE_BLOCK,
        sparse_num_global_blocks=1, max_position_embeddings=SPARSE_S)
    lay = bert_sparse_layout(ssc, bert_cfg.num_attention_heads)
    sparse_batch = bert.synthetic_mlm_batch(SPARSE_B, SPARSE_S,
                                            bert_cfg.vocab_size, seed=7)
    sparse_line, sparse_counts = sparse_bert_phase(
        torch, deepspeed_tpu_torch, bert, op_builder, sparse_cfg,
        dataclasses.replace(bert_cfg, max_position_embeddings=SPARSE_S),
        sparse_batch, float(lay.sum()) / lay.size, card)

    # 13. one step, kernels against plain, then predicated against fused
    sparse_line["parity_2layer"], pred_counts = sparse_bert_parity(
        torch, os, deepspeed_tpu_torch, bert, op_builder, sfk, fused_lamb,
        sparse_cfg, sparse_batch)

    # 14. causal sparse GPT-2 medium at seq 4096
    glay, _ = sfk.sparse_mode_layout(GPT_SPARSE_MODE, cfg.n_head,
                                     GPT_SPARSE_S)
    sparse_line["gpt2"], gpt_counts = sparse_gpt2_phase(
        torch, deepspeed_tpu_torch, gpt2, op_builder, dataclasses.replace(
            cfg, attention_mode=GPT_SPARSE_MODE, n_positions=GPT_SPARSE_S),
        float((glay != 0).sum()) / glay.size, card)
    sparse_line["max_abs_err_bias_cotangent_bf16"] = sparse_dbias_err

    bert_all = {k: bert_counts.get(k, 0) + bert_plain_counts.get(k, 0)
                + moq_counts.get(k, 0) for k in per_step}
    launches = {"flash_fwd": gen_launches.get("flash_fwd", 0) +
                train_launches.get("flash_fwd", 0) + bert_all["flash_fwd"]
                + int8_counts.get("flash_fwd", 0),
                "decode_attention": gen_launches.get("decode_attention", 0)
                + int8_counts.get("decode_attention", 0),
                "decode_attention_int8": gen_launches.get(
                    "decode_attention_int8", 0),
                "flash_bwd_dq": train_launches.get("flash_bwd_dq", 0) +
                bert_all["flash_bwd_dq"],
                "flash_bwd_dkv": train_launches.get("flash_bwd_dkv", 0) +
                bert_all["flash_bwd_dkv"],
                "adam_sweep": sweep_counts.get("adam", 0),
                "adam_per_tensor": fused_counts.get("adam", 0),
                "ln_fwd": bert_all["ln_fwd"], "ln_bwd": bert_all["ln_bwd"],
                "bias_gelu": bert_all["bias_gelu"],
                "lamb": bert_counts.get("lamb", 0) + moq_counts.get("lamb", 0),
                "quantize": moq_counts.get("quantize", 0),
                # on no path, as in the JAX package
                "softmax": 0, "softmax_h1024": 0}
    for name in ("sparse_fwd", "sparse_dq", "sparse_dkv"):
        launches[name] = sparse_counts[name] + gpt_counts[name]
        launches[name + "_predicated"] = pred_counts[name]
    bert_fwd = sdpa["fwd"]
    flash_row["bert_shape"] = {
        key: bert_fwd[key] for key in (
            "shape", "ms", "kernel_ms", "device_ms", "bound_ms", "x_bound",
            "sdpa_flash_ms", *SDPA_FWD_KEYS) if key in bert_fwd}
    flash_row["launches_by_path"] = {
        "generate": gen_launches.get("flash_fwd", 0),
        "train": train_launches.get("flash_fwd", 0),
        "bert": bert_counts.get("flash_fwd", 0)
        + bert_plain_counts.get("flash_fwd", 0),
        "moq": moq_counts.get("flash_fwd", 0),
        "int8_generate": int8_counts.get("flash_fwd", 0)}
    for row in [flash_row] + decode_rows:
        row["peak"] = BF16_FLOPS
    rows = finish_rows(
        [flash_row] + decode_rows
        + training_kernel_rows(torch, flash, fused_adam, param_shapes)
        + bert_kernel_rows(torch, fused, fused_lamb, bert_shapes)
        + quant_kernel_rows(torch, quantizer, fused, moq_tensors)
        + sparse_kernel_rows(torch, np, sfk, sk, ssc),
        launches, max_err, card)
    for row in rows:
        if row["name"] == "sparse_dkv":
            row["max_abs_err_bias_cotangent"] = sparse_dbias_err
        if row["name"] in ("sparse_fwd", "sparse_dq", "sparse_dkv"):
            row["launches_by_path"] = {
                "bert_sparse": sparse_counts[row["name"]],
                "gpt2_sparse": gpt_counts[row["name"]]}

    print(json.dumps({"e2e": e2e}))
    print(json.dumps({"train": train}))
    print(json.dumps({"bert": bert_line}))
    print(json.dumps({"moq": moq_line}))
    print(json.dumps({"int8": int8_line}))
    print(json.dumps({"sparse": sparse_line}))
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
