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
   plain version rounds the softmax weights to bf16 before P·V where the
   kernels keep fp32);
4. the main path at full width: GPT-2 medium (24 layers, n_embd 1024,
   16 heads, vocab 50257 padded to 50304) on weights drawn from a seed,
   cast to bf16 by ``init_inference``, greedy ``generate`` on 8 prompts of
   896 tokens (64 new) and of 32 tokens (128 new), and with an int8 KV
   cache on 8 prompts of 32 tokens (32 new). Launch counts are zeroed just
   before and read just after; every kernel must have launched. The
   prefill logits and the first decode step's logits must agree with the
   same model run on the plain attention versions on the card;
5. time the end-to-end path and each kernel at the main path's shapes
   (CUDA events) beside its plain version, its least possible time on the
   card and, where one exists, the PyTorch call that computes the same
   function (``scaled_dot_product_attention``, timed for the table only).

Prints a ``kernels`` JSON line, an ``e2e`` JSON line, the card line, and
last ``{"ok": true, "device": {...}}``. Exits non-zero with no result
when CUDA is unavailable or any phase fails.
"""

import contextlib
import json
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 3.35 TB/s,
# bf16 tensor cores 989 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

B, H, D = 8, 16, 64          # GPT-2 medium heads at batch 8
T_CACHE = 1024               # aligned_cache_len(1024)
DECODE_LEN = 896 + 32        # live cache length halfway through the long run


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


def device_profile(torch, fn):
    """Run ``fn`` once under ``torch.profiler``: wall ms, device-busy ms
    (sum of kernel self times, one stream), the idle share, and the
    device ms of each kernel group."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, kernels = {}, []
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        # kernel events only: the CPU ops that launched them also carry
        # their device time
        if us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels.append((us / 1e3, ev.count, ev.key[:60]))
        name = ev.key.lower()
        group = ("flash_fwd" if "flash_fwd" in name else
                 "decode_attention" if "decode_kernel" in name else
                 "matmul" if any(s in name for s in (
                     "gemm", "gemv", "cutlass", "nvjet", "xmma")) else
                 "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3
    busy = sum(groups.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": (1 - busy / wall_ms) if busy else None,
            "device_ms_by_group": groups,
            "top_kernels_ms_count_name": sorted(kernels, reverse=True)[:6]}


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
        q = rnd(B, H, 1, D, dtype=dtype)
        k, v = rnd(B, H, T_CACHE, D, dtype=dtype), rnd(B, H, T_CACHE, D,
                                                        dtype=dtype)
        kq, ks = decode.quantize_kv(k)
        vq, vs = decode.quantize_kv(v)
        for length in (1, 7, 513, 1024):
            for per_seq in (False, True):
                lens = (torch.tensor([max(1, length - 3 * i)
                                      for i in range(B)], dtype=torch.int32,
                                     device="cuda")
                        if per_seq else length)
                dev_lens = decode._lengths(lens, B, "cuda")
                for name, got, want in [
                        ("decode_attention",
                         decode.decode_attention(q, k, v, lens),
                         decode.decode_attention_plain(q, k, v, dev_lens)),
                        ("decode_attention_int8",
                         decode.decode_attention_quantized(q, kq, ks, vq, vs,
                                                           lens),
                         decode.decode_attention_plain(
                             q, kq, vq, dev_lens, k_scale=ks, v_scale=vs))]:
                    torch.cuda.synchronize()
                    err, ok = close(got, want, tol)
                    print(f"check {name} {str(dtype)[6:]} T={T_CACHE} "
                          f"len={length} per_seq={per_seq}: err {err:.3g}")
                    if not ok:
                        raise AssertionError(f"{name} disagrees with its "
                                             "plain version")
                    if dtype == torch.bfloat16:
                        main_err[name] = max(main_err.get(name, 0), err)
    return main_err


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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import dataclasses

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.transformer import attention as attn_mod
    from deepspeed_tpu_torch.ops.transformer import decode, flash
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

    # 4. the main path at full width
    cfg = gpt2.PRESETS["gpt2-medium"]
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

    # the same model on the plain attention versions, on the card. The
    # bf16 logits (largest about 3) differ by up to 0.05 after 24 layers,
    # since the kernels keep the softmax weights in fp32 where the plain
    # versions round them to bf16: the tolerance is 0.1 absolute, and the
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

    # 5. timings
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

    F = torch.nn.functional
    q, k, v = rnd(B, H, 896, D), rnd(B, H, 896, D), rnd(B, H, 896, D)
    pairs = sum(min(r + 1, 896) for r in range(896))
    flash_row = {
        "name": "flash_fwd", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "deepspeed_tpu/ops/transformer/flash.py:211",
        "shape": "B8 H16 S896 D64 causal bf16",
        "ms": cuda_ms(lambda: flash.flash_attention_fwd(q, k, v, True)),
        "plain_ms": cuda_ms(
            lambda: flash.flash_attention_fwd_plain(q, k, v, True)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        "bytes": 4 * B * H * 896 * D * 2 + B * H * 896 * 4,
        "flops": 4 * D * pairs * B * H,
    }
    qd = rnd(B, H, 1, D)
    kc, vc = rnd(B, H, T_CACHE, D), rnd(B, H, T_CACHE, D)
    kq, ks = decode.quantize_kv(kc)
    vq, vs = decode.quantize_kv(vc)
    lens = torch.full((), DECODE_LEN, dtype=torch.int32, device="cuda")
    mask = (torch.arange(T_CACHE, device="cuda") < DECODE_LEN)[None, None,
                                                                None, :]
    live = B * H * DECODE_LEN
    decode_row = {
        "name": "decode_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/transformer/decode.py:54",
        "shape": f"B8 H16 T{T_CACHE} len{DECODE_LEN} D64 bf16",
        "ms": cuda_ms(lambda: decode.decode_attention(qd, kc, vc, lens),
                      iters=100),
        "plain_ms": cuda_ms(
            lambda: decode.decode_attention_plain(qd, kc, vc, lens)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, kc, vc, attn_mask=mask), iters=100),
        "bytes": 2 * live * D * 2 + 2 * B * H * D * 2 + 4,
        "flops": 4 * live * D,
    }
    int8_row = {
        "name": "decode_attention_int8", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/transformer/decode.py:54 "
                    "(quantized=True)",
        "shape": f"B8 H16 T{T_CACHE} len{DECODE_LEN} D64 int8 KV, bf16 q",
        "ms": cuda_ms(lambda: decode.decode_attention_quantized(
            qd, kq, ks, vq, vs, lens), iters=100),
        "plain_ms": cuda_ms(lambda: decode.decode_attention_plain(
            qd, kq, vq, lens, k_scale=ks, v_scale=vs)),
        "library_ms": None,
        "bytes": 2 * live * (D + 4) + 2 * B * H * D * 2 + 4,
        "flops": 4 * live * D,
    }
    rows = []
    for row in (flash_row, decode_row, int8_row):
        t_bytes = row.pop("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = row.pop("flops") / BF16_FLOPS * 1e3
        row.update(launches=launches.get(row["name"], 0),
                   max_abs_err=max_err[row["name"]],
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   card=card)
        rows.append(row)

    print(json.dumps({"e2e": e2e}))
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
