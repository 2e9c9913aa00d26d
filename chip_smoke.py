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
   24 sparse_fwd, 24 sparse_dq, 24 sparse_dkv and 1 adam a step;
15. the training loop users write, at full width: GPT-2 medium through
   ``engine.forward`` / ``backward`` / ``step`` (micro-batch 4 × 1024, gas
   2, bf16, ZeRO 1, Adam ``sweep`` lr 1e-4, clip 1.0, dropout 0.1), 10
   global steps with remat off and then 10 with remat on from the same
   seed, each with exact launch counts (a step: 48 flash_fwd, 96 with
   remat, whose recompute runs the forward again; 48 dq, 48 dk/dv, 1
   adam), step ms (median of steps 3-10), tokens/s, MFU (the recompute's
   flops not counted), peak memory and one more step profiled (device
   busy ms, idle share); remat on against off in the
   per-step losses and final params, bit-equal (a recompute that drew
   other masks would differ); losses finite and falling. Then on the remat-on engine: one
   site's keep share over a [4, 1024, 1024] activation within 0.9 ±
   0.001; two forwards at one (seed, micro-step) equal, the next
   micro-step's different; ``eval_batch`` twice equal and equal to the
   same weights' eval at dropout 0. Then at dropout 0 without remat, the
   loop against ``train_batch`` on the same micro-batches with the
   per-tensor Adam (one multi-tensor launch a step), 3 steps, losses and
   params bit-equal. Then BERT-large (bs 64 × 128, fused LAMB, hidden
   and attention dropout 0.1) through the loop, 10 steps with remat off
   and 10 with remat on each layer (a step on: 48 flash_fwd, 96 ln_fwd,
   48 bias_gelu, 24 dq, 24 dk/dv, 48 ln_bwd, 1 lamb), held as GPT-2's;
16. continuous-batching serving: GPT-2 medium at full width through
   ``init_serving`` (bf16; max_batch 8, block 16, prefill_chunk 256,
   max_model_len 1024, num_blocks 0, which sizes 513 blocks) on a trace of
   32 requests all at t = 0 (prompts 8-896 tokens, 16-128 new, uniform
   from seed 0, greedy): the ``paged`` impl, the ``gather`` impl eager
   and graph-replayed (twice) and with an int8 KV cache. Launch counts
   zeroed just before each run and read just after: on the gather impl
   exactly 24 decode launches a decode dispatch and nothing else; every
   request finishes by length (``max_tokens``); the graph run's tokens
   equal the eager run's and the rerun's, with one capture; the first
   decode step's logits within 0.1 of the same step with
   ``decode_attention_plain``; the kernel on the pools' gathered view with
   per-slot lengths including 0 against its plain version. Then a
   profiled window of 16 decode steps per impl (device idle share,
   kernels a dispatch, device ms by group, the tracer's spans in the
   trace). Then the trace in fp32 with TF32 off four ways, each pair
   equal request by request or first diverging at a near tie (top-2
   logit gap < 1e-4, printed): paged against gather, num_blocks 129
   (preempting) against auto, speculation (exact, k 4, self-draft)
   against off, and the prefix cache on against off (and again on a
   variant whose prompts share a 256-token prefix, where it hits).
17. checkpoints at full width, under ``build/ckpt_smoke`` (deleted at
   the end; about 23 GB written): GPT-2 medium in phase 6's configuration
   (Adam sweep) takes 3 steps, saves (sync), saves the same state again
   under ``checkpoint.async_save`` and takes 3 more steps while that
   persist runs; the async tag's files must equal the sync tag's byte for
   byte. An engine built from another init seed loads the sync tag and
   takes the same 3 steps: losses, masters and the flat moments
   bit-equal, exactly phase 6's launches a step (24 flash_fwd, 24 dq, 24
   dk/dv, 1 adam). ``zero_to_fp32`` on the tag equals the masters at the
   save bit for bit, and ``init_inference(checkpoint=<tag>/mp_rank_00_
   model_states.pt)`` generates phase 4's 8 x 896 prompts (16 greedy
   tokens) as ``init_inference(params=<those masters>)`` does. The same
   resume with per-tensor fused Adam, then ``save_16bit_model`` (every
   tensor the master cast to bf16), then BERT-large in phase 9's
   configuration with dropout 0.1 (fused LAMB; phase 9's launches a
   step).
18. data parallelism at world size 1 (the one card; NCCL refuses two
   ranks on one device): GPT-2 medium in phase 6's configuration and
   BERT-large in phase 9's at ZeRO 1 take 3 steps without a process
   group, then ``init_distributed()`` (NCCL, world 1) and 3 steps with
   one, through ``initialize`` -> ``train_batch``: losses, masters and
   optimizer state bit-equal, exactly phases 6's and 9's launches a
   step; the step times beside phases 6's and 9's medians. Then phase
   17's resume over NCCL under ``checkpoint.tag_validation: "Fail"``,
   sync and async, bit-equal, and the save's sweep-moment gather timed;
   the lse gradient of ``flash_attention_with_lse`` at B 8, H 16, S 1024,
   D 64, bf16, causal and not, random output and lse cotangents: the
   kernels' dq, dk, dv against the plain backward on the same bf16
   inputs (phase 3's 2e-2 of rows 3 and 4; the error against the inputs
   upcast to fp32 printed), and with a zero lse cotangent bit-equal to
   ``flash_attention``'s; ring and Ulysses
   attention at world 1 bit-equal to ``flash_attention``, forward and
   gradients. The process group is destroyed at the end.
19. MoE-GPT at full width, nothing cut (``bench.py``'s ``gpt2-moe`` row,
   bench.py:158-160, 226-232): GPT-2 small (12 x 768, 12 heads, vocab
   50304 padded) with 8 experts, top-1, on every 2nd block (6 MoE
   blocks), capacity factor 1.25, bs 8 x 1024, ZeRO 0, Adam (the sweep),
   bf16 over fp32 masters, clip 1.0, the scatter impl: 10 steps with
   exactly 12 flash_fwd, 12 dq, 12 dkv and 1 adam a step (step ms, tokens
   /s, MFU with bench.py:551-557's MoE accounting, peak memory, the idle
   share of a profiled step, the last step's exp_counts a layer and its
   dropped share); a save whose tag holds 48 expert files, then a fresh
   engine from another seed resumes bit-equal (losses, masters, the
   sweep's moments); ``init_inference(moe=True, checkpoint=)`` on that tag
   generates 8 x 896 prompts, 64 new (12 flash_fwd and 12 decode launches
   a token after the first; prefill and decode ms/token), and in fp32 its
   greedy tokens (8 x 128, 16 new) equal a plain-attention run's; on 2
   full-width layers the scatter and einsum impls give the same loss bit
   for bit (gradients within 1e-2 relative L2), grouped within 0.02 and
   2e-2, and in fp32 the kernels' loss and gradients within 1e-4 and
   1e-3 (relative L2) of the plain versions'; top-2 takes 3
   finite, falling steps; world 1 over NCCL, with the default groups and
   with ``ep_size=1``, is bit-equal to no process group (ep > 1 needs
   more than one card; the line says so).
20. ZeRO stages 2 and 3 and the optimizer offload at GPT-2 XL width
   (``bench.py``'s gpt2-xl row, bench.py:154: 48 x 1600, 25 heads, vocab
   50257 padded, bs 4 x 1024, bf16 over fp32 masters, Adam lr 1e-4 with
   ``fused: true``), 3 steps each: (a) stage 0 without a process group;
   (b) stage 2 and (c) stage 3 over an NCCL world-1 group, losses and
   masters bit-equal to (a), exactly 48 flash_fwd, 48 dq, 48 dk/dv and 2
   adam launches a step (580 tensors, 448 a launch); (d) stage 3 with
   ``offload_optimizer: cpu`` (the host CPU-Adam, moments in pinned host
   RAM), losses within 2e-4 relative of (a), the flash launches only;
   (e) NVMe offload at GPT-2 medium, stage 2, 2 steps, moments in files
   under ``build/zero_nvme`` (deleted after), bit-equal to the same run
   offloaded to RAM; (f) GPT-2 XL with the Adam sweep (``sweep: true``)
   at stage 3 over NCCL, the sweep's vector this rank's master slices,
   bit-equal to stage 0 with the sweep (1 adam launch a step); (g)
   BERT-large with MoQ (fused LAMB, ``moq_block()``) at stage 3 over
   NCCL, the cut masters gathered, quantized whole and cut back,
   bit-equal to stage 0 with MoQ (1 quantize call a step). For each run:
   step ms, CPU-Adam host ms, peak device memory beside
   ``estimate_zero_mem``, the whole compute-dtype copy's size, launches;
   the host's RAM; which aio engine ran.
21. ZeRO-3 parameter offload (``runtime/zero/param_offload.py``) at GPT-2
   XL width, ``bench.py``'s gpt2-xl row at bs 4 x 1024 through
   ``initialize(model=gpt2_offload_layers(cfg), config=bench.py:370-378's
   config, sample_batch=, input_fn=)``: 3 steps (a batch of its own
   each) streamed a layer at a time from pinned host RAM (the masters born on the host, CPU-Adam on
   the host) against (a) the same layers all resident on the card (plain
   autograd, Adam with CPU-Adam's formula), losses within
   ``OFFLOAD_RTOL`` and the masters after the last update within
   ``OFFLOAD_MASTER_RTOL`` of the oracle's change, leaf by leaf; (b)
   ``peak_live_bytes`` at most 2 × the largest layer's bf16 bytes,
   beside ``torch.cuda.max_memory_allocated``; (c)
   exactly 96 flash_fwd (the sweep and the recompute), 48 dq and 48 dk/dv
   a step and no Adam launch; (d) NVMe masters (``build/param_offload``,
   deleted after) at 8 blocks of XL width bit-equal to RAM, 2 steps; (e)
   a tag saved after step 2 resumes bit-equal in a fresh engine. Step ms,
   H2D and D2H GB a step, CPU-Adam ms, peak memory, and one more step
   under the profiler: its compute kernels' ms, the H2D and D2H copies'
   ms (side streams) and the CPU-Adam ms beside its wall ms.
22. the data path (``bench.py``'s gpt2-medium row fed as
   bench.py:444-470 feeds it: ``initialize(training_data=)`` on a per-row
   dataset over a pool of 8 batches, ``deepspeed_io(...,
   num_local_io_workers=2)``, ``RepeatingLoader``; bf16, ZeRO 1, Adam
   ``fused: true``, ``data_prefetch`` depth 2, whose device stage copies
   pinned batches on a copy stream): (a) 6 steps through the prefetched
   loader against the same 6 batches pre-placed on the card, losses and
   masters bit-equal; each path's step ms, the hits and misses, the host
   share of the steps' wall spent in ``next()``; (b) a tag saved with
   ``data_iter=`` after step 3 (under ``build/data_smoke``, deleted
   after) resumes in a fresh engine and loader, steps 4-6 bit-equal; (c)
   curriculum ``fixed_linear`` 64 -> 1024, step 8, over 4 steps: the
   lengths JAX's schedule gives (304, 544, 784, 1024), exactly 24
   flash_fwd, 24 dq, 24 dk/dv and 1 adam a step, and phase 7's 2-layer
   parity at S 72 and S 200 (the engine cuts the 1024 batch); (d) no
   ``ds-prefetch-*`` thread alive after ``close()``;
23. the serving observatory and the router (GPT-2 medium, bf16, phase
   16's ``SERVE_CFG`` with the gather impl replayed as a CUDA graph;
   every file in a ``tempfile.mkdtemp()`` directory, removed at the
   end): (a) phase 16's 32-request trace with ``serving.observability``
   on (window 16, trace lanes, an enabled tracer), off, on with its hooks
   timed, off: tokens equal request by request, the slot ledger summing
   exactly to steps x 8 x 1 with every kept token one ``decode_useful``
   unit, every timeline queued -> admitted -> first_token -> finished in
   order, the snapshot strict JSON with the JAX schema string, and under
   ``torch.cuda.set_sync_debug_mode("warn")`` the same count of
   synchronizing calls in 16 steps of decode on as off; useful tokens/s
   each way, the hooks' host ms a step, ``wasted_fraction``; (b) phase
   16's undersized pool (129 blocks) observed: the report's preemption
   reasons and recompute tokens equal the server's counters, and
   ``close()`` writes the final snapshot; (c) two ``ServingEngine``
   replicas of the one engine (each its own KV pool, the prefix cache
   on) behind ``ServingRouter``, observed under an SLO no run can breach:
   two seeded 256-token system prompts, 16 requests each (phase 16's
   tails and lengths), one warm-up request a group submitted together and
   served, then the other 30 at once; the two warm-ups land on different
   replicas, each group's 15 on the replica that holds its prefix with
   16 affinity blocks, no ``ttft_slo_breach`` / ``queue_growth``, router
   ids unique and each collected once, tokens equal one engine's for the
   same requests (a divergence only at a near tie, checked in fp32 as in
   phase 16); ``routed_by_replica``, prefix hits a replica, useful
   tokens/s, TTFT and inter-token latency p50/p99; (d) a ``RunChronicle``
   armed for (c): one ``router`` event a request, its report strict JSON,
   no writer thread after ``close()`` and the global chronicle disabled
   again.

Prints an ``e2e`` JSON line, a ``train`` JSON line, a ``bert`` JSON line,
a ``moq`` JSON line, an ``int8`` JSON line, a ``sparse`` JSON line, a
``loop`` JSON line (per model, remat off and on: losses, step ms,
launches, peak memory; the checks), a ``serving`` JSON line (per run:
useful tokens/s, TTFT and inter-token
latency p50/p99, decode ms a dispatch, launches a dispatch), a ``ckpt``
JSON line (tag bytes, sync save ms, the async save's snapshot and
background persist ms, load ms, write and read GB/s, the steps' ms while
the persist ran beside phase 6's median, the bytes the phase wrote, per
model the losses and launches), a ``dp`` JSON line (per model the NCCL
world-1 losses, step ms beside the no-group run's and the phase median,
the bit-equality checks and launches; the checkpoint's numbers and the
sweep-moment gather; the lse-gradient errors; ring / Ulysses), a ``moe``
JSON line (phase 19's figures and checks, its launches by kernel row), a
``zero`` JSON line (phase 20's runs and checks), an ``offload`` JSON
line (phase 21's figures and checks), a ``data`` JSON line (phase 22's
figures and checks, its launches by kernel row), a ``serve_obs`` JSON
line (phase 23's figures and checks), a ``kernels`` JSON
line (the softmax, on no path as in the JAX package, with 0 launches,
and its C entry's and ``torch.softmax``'s device times from the
profiler; the decode rows' ``single_stream`` and
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

import collections
import contextlib
import json
import math
import os
import shutil
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
                 "memcpy_htod" if "memcpy htod" in name else
                 "memcpy_dtoh" if "memcpy dtoh" in name else
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


def micro_batch_grads(engine, batch):
    """The master gradients of one ``forward`` / ``backward`` of
    ``batch``, cloned; ``.grad`` is cleared after, so the next step
    starts from none."""
    engine.backward(engine.forward(batch))
    grads = {k: p.grad.clone() for k, p in engine.params.items()}
    for p in engine.params.values():
        p.grad = None
    return grads


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
                    fused_adam, cfg, batch, config=None, what="2-layer"):
    """Phase 7: a 2-layer full-width model, one step on the kernels and
    one on the plain versions, from the same seed and batch, in
    ``config`` (default: phase 6's with the sweep).

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
            model=model, config=config or train_config(sweep=True))
        ctx = (plain_training(gpt2, attn_mod, decode, fused_adam) if plain
               else contextlib.nullcontext())
        with ctx:
            grads = micro_batch_grads(engine, batch)
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
    print(f"parity {what} one step: {json.dumps(out)}", flush=True)
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
    can drop some of a window's kernel records, or all of them (seen in
    all three windows of 5 calls of the per-tensor Adam step), and then a
    longer window is profiled (five windows at most)."""
    for attempt in range(5):
        evs = [ev for ev in _device_kernels(torch, fn, iters * (1 + attempt))
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
            grads = micro_batch_grads(engine, batch)
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
                grads = micro_batch_grads(engine, batch)
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


# phase 15, the training loop users write: forward / backward / step with
# dropout and remat, GPT-2 medium (gas 2) and BERT-large
LOOP_MICRO, LOOP_GAS, LOOP_STEPS, LOOP_CHECK_STEPS = 4, 2, 10, 3
LOOP_DROPOUT = 0.1
LOOP_SHARE_TOL = 1e-3        # one site's keep share over 4M draws


def loop_config(**opt):
    """Phase 6's GPT-2 config at micro-batch 4 and gas 2 (train batch 8)."""
    return dict(train_config(**opt),
                train_micro_batch_size_per_gpu=LOOP_MICRO)


def loop_steps(torch, engine, micros, n):
    """n global steps of the user loop (``forward`` and ``backward`` over
    the micro-batches, then ``step``); (mean losses, synchronised host ms
    of each step)."""
    losses, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = []
        for micro in micros:
            loss = engine.forward(micro)
            engine.backward(loss)
            step.append(loss.detach())
        engine.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(torch.stack(step).mean()))
    return losses, ms


def check_counts(what, counts, per_step, steps):
    """Exactly ``per_step`` launches of each kernel a step and no other."""
    want = {k: c * steps for k, c in per_step.items()}
    got = {k: counts.get(k, 0) for k in want}
    if got != want or sum(counts.values()) != sum(want.values()):
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def remat_pair(torch, op_builder, make_engine, micros, per_step, what):
    """The same run with remat off, then on (dropout on in both): per run
    the losses, step ms, launches (checked exactly), the peak of device
    memory from the model's build on, and the final params; the remat-on
    engine is returned for the checks that follow."""
    runs, engine = {}, None
    for remat in (False, True):
        del engine
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine = make_engine(remat)
        op_builder.reset_launch_counts()
        losses, ms = loop_steps(torch, engine, micros, LOOP_STEPS)
        counts = dict(op_builder.LAUNCHES)
        check_counts(f"{what} remat={remat}", counts, per_step[remat],
                     LOOP_STEPS)
        runs[remat] = {
            "losses": losses, "step_ms": ms,
            "step_ms_median_3_10": statistics.median(ms[2:LOOP_STEPS]),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts,
            # on the host, out of the next run's peak
            "params": {k: p.detach().cpu()
                       for k, p in engine.params.items()}}
        # where one more step's time goes (after the compared steps)
        runs[remat]["profile_step"] = device_profile(
            torch, lambda: loop_steps(torch, engine, micros, 1))
    off, on = runs[False], runs[True]
    loss_diff = max(abs(a - b) for a, b in zip(off["losses"], on["losses"]))
    param_diff = max((off["params"][k] - on["params"][k]).abs().max().item()
                     for k in off["params"])
    bit_equal = loss_diff == 0 and param_diff == 0
    print(f"loop {what}: remat on against off, losses max diff "
          f"{loss_diff}, final params max diff {param_diff}, bit-equal "
          f"{bit_equal}", flush=True)
    if not bit_equal:
        raise AssertionError(f"{what}: remat on and off not bit-equal: "
                             f"losses {loss_diff}, params {param_diff}")
    for run in (off, on):
        if not all(math.isfinite(x) for x in run["losses"]) or \
                not run["losses"][-1] < run["losses"][0]:
            raise AssertionError(f"{what}: losses not finite and falling: "
                                 f"{run['losses']}")
        del run["params"]
    return {"remat_off": off, "remat_on": on,
            "remat_loss_max_diff": loss_diff,
            "remat_param_max_diff": param_diff,
            "remat_bit_equal": bit_equal,
            "remat_step_cost": on["step_ms_median_3_10"]
            / off["step_ms_median_3_10"] - 1,
            "remat_peak_saving_gb": off["peak_mem_gb"] - on["peak_mem_gb"]}, \
        engine


def loop_phase(torch, deepspeed_tpu_torch, gpt2, bert, dropout, op_builder,
               cfg, bert_cfg, card):
    """Phase 15: the user loop at full width. Returns the ``loop`` line and
    the phase's launches by kernel row."""
    import dataclasses
    rows = collections.Counter()
    batch = gpt2.synthetic_batch(B, SEQ, cfg.vocab_size, seed=4)
    micros = [{"input_ids": batch["input_ids"][i * LOOP_MICRO:
                                              (i + 1) * LOOP_MICRO]}
              for i in range(LOOP_GAS)]
    layers = cfg.n_layer

    def gpt_engine(remat, p=LOOP_DROPOUT, **opt):
        model = gpt2.GPT2LMHeadModel(dataclasses.replace(
            cfg, dropout=p, remat=remat), seed=0)
        return deepspeed_tpu_torch.initialize(
            model=model, config=loop_config(**(opt or {"sweep": True})))[0]

    # (a) GPT-2 medium, dropout 0.1, remat off then on
    per_micro = {False: layers, True: 2 * layers}    # the recompute's
    per_step = {r: {"flash_fwd": LOOP_GAS * per_micro[r],
                    "flash_bwd_dq": LOOP_GAS * layers,
                    "flash_bwd_dkv": LOOP_GAS * layers, "adam": 1}
                for r in (False, True)}
    gpt_line, engine = remat_pair(torch, op_builder, gpt_engine, micros,
                                  per_step, "gpt2-medium")
    for run in (gpt_line["remat_off"], gpt_line["remat_on"]):
        for k, n in run["launches"].items():
            rows["adam_sweep" if k == "adam" else k] += n
    n_params = sum(p.numel() for p in engine.params.values())
    fpt = 6 * n_params + 12 * cfg.n_layer * cfg.n_embd * SEQ
    med = gpt_line["remat_on"]["step_ms_median_3_10"]
    gpt_line.update({
        "config": f"gpt2-medium micro {LOOP_MICRO} x {SEQ}, gas "
                  f"{LOOP_GAS}, bf16 zero1 adam-sweep lr {LR} clip 1.0, "
                  f"dropout {LOOP_DROPOUT}, remat on (off for the "
                  f"comparison)",
        "tokens_per_s": B * SEQ / med * 1e3,
        "tokens_per_s_remat_off": B * SEQ
        / gpt_line["remat_off"]["step_ms_median_3_10"] * 1e3,
        "flops_per_token": fpt,
        "mfu": fpt * B * SEQ / (med / 1e3) / BF16_FLOPS,
        "mfu_note": "6N + 12LES flops a token (bench.py:551), the "
                    "recompute's flops not counted"})

    # (b)3 one site's keep share over a [4, 1024, 1024] activation
    site = engine.module.h[0].attn.drop
    with dropout.key_scope((engine._seed, engine.micro_steps)):
        kept = dropout.dropout(torch.ones(LOOP_MICRO, SEQ, cfg.n_embd,
                                          device=engine.device,
                                          dtype=torch.bfloat16),
                               site.p, site.site)
    share = (kept != 0).float().mean().item()
    if abs(share - (1 - LOOP_DROPOUT)) > LOOP_SHARE_TOL:
        raise AssertionError(f"keep share {share}, expected "
                             f"{1 - LOOP_DROPOUT} ± {LOOP_SHARE_TOL}")
    del kept

    # (b)4 two forwards at one (seed, micro-step) agree, the next differs
    with torch.no_grad():
        first = engine.forward(micros[0])
        again = engine.forward(micros[0])
    engine.backward(engine.forward(micros[0]))     # the next micro-step
    with torch.no_grad():
        nxt = engine.forward(micros[0])
    if not torch.equal(first, again) or torch.equal(first, nxt):
        raise AssertionError(f"forwards at one key {float(first)}, "
                             f"{float(again)}; next {float(nxt)}")
    for p in engine.params.values():
        p.grad = None

    # (b)5 eval twice equal, and equal to the same weights at dropout 0
    ev = [engine.eval_batch(batch) for _ in range(2)]
    state = engine.module.state_dict()
    del engine
    torch.cuda.empty_cache()
    plain = gpt_engine(False, p=0.0)
    plain.module.load_state_dict(state)
    ev0 = plain.eval_batch(batch)
    if not (torch.equal(ev[0], ev[1]) and torch.equal(ev[0], ev0)):
        raise AssertionError(f"eval {float(ev[0])}, {float(ev[1])}; at "
                             f"dropout 0 {float(ev0)}")
    del plain, state
    torch.cuda.empty_cache()
    op_builder.reset_launch_counts()

    # (b)1 dropout 0, remat off: the loop against train_batch, per-tensor
    # Adam (one multi-tensor launch a step), bit-equal
    a, b = (gpt_engine(False, p=0.0, fused=True) for _ in range(2))
    tb_losses, loop_ms = [], []
    for _ in range(LOOP_CHECK_STEPS):
        tb_losses.append(float(a.train_batch(data_iter=iter(micros))))
        (loop_loss,), ms = loop_steps(torch, b, micros, 1)
        loop_ms += ms
        if loop_loss != tb_losses[-1]:
            raise AssertionError(f"loop loss {loop_loss} != train_batch "
                                 f"{tb_losses[-1]}")
    same = all(torch.equal(x, y) for x, y in zip(a.module.parameters(),
                                                 b.module.parameters()))
    if not same:
        raise AssertionError("loop and train_batch params differ")
    check_counts("loop against train_batch", dict(op_builder.LAUNCHES),
                 {"flash_fwd": 2 * LOOP_GAS * layers,
                  "flash_bwd_dq": 2 * LOOP_GAS * layers,
                  "flash_bwd_dkv": 2 * LOOP_GAS * layers, "adam": 2},
                 LOOP_CHECK_STEPS)
    for k, n in op_builder.LAUNCHES.items():
        rows["adam_per_tensor" if k == "adam" else k] += n
    gpt_line["loop_vs_train_batch"] = {
        "steps": LOOP_CHECK_STEPS, "losses": tb_losses,
        "params_bit_equal": same,
        # gas 2 without dropout or remat, per-tensor Adam: beside phase
        # 6's gas-1 fused steps, the cost of two half-size micro-batches
        "loop_step_ms_dropout0_remat_off": loop_ms}
    gpt_line["checks"] = {"keep_share": share, "same_key_loss": float(first),
                          "next_micro_step_loss": float(nxt),
                          "eval_loss": float(ev[0]),
                          "eval_loss_dropout0": float(ev0)}
    del a, b
    torch.cuda.empty_cache()

    # (c) BERT-large, hidden and attention dropout 0.1, remat off then on
    bert_batch = bert.synthetic_mlm_batch(BERT_B, BERT_S,
                                          bert_cfg.vocab_size, seed=6)
    blayers = bert_cfg.num_hidden_layers

    def bert_engine(remat):
        model = bert.BertForPreTraining(dataclasses.replace(
            bert_cfg, hidden_dropout_prob=LOOP_DROPOUT,
            attention_probs_dropout_prob=LOOP_DROPOUT, remat=remat), seed=0)
        return deepspeed_tpu_torch.initialize(
            model=model, config=bert_config(fused=True))[0]

    bper = {r: {"flash_fwd": blayers * (2 if r else 1),
                "flash_bwd_dq": blayers, "flash_bwd_dkv": blayers,
                "ln_fwd": 2 * blayers * (2 if r else 1),
                "ln_bwd": 2 * blayers,
                "bias_gelu": blayers * (2 if r else 1), "lamb": 1}
            for r in (False, True)}
    bert_line, engine = remat_pair(torch, op_builder, bert_engine,
                                   [bert_batch], bper, "bert-large")
    del engine
    torch.cuda.empty_cache()
    for run in (bert_line["remat_off"], bert_line["remat_on"]):
        for k, n in run["launches"].items():
            rows[k] += n
    bmed = bert_line["remat_on"]["step_ms_median_3_10"]
    bert_line.update({
        "config": f"bert-large bs{BERT_B} seq{BERT_S} bf16 zero0 "
                  f"lamb(fused) lr{LR}, hidden and attention dropout "
                  f"{LOOP_DROPOUT}, remat on each layer (off for the "
                  f"comparison)",
        "tokens_per_s": BERT_B * BERT_S / bmed * 1e3,
        "samples_per_s": BERT_B / bmed * 1e3})
    line = {"card": card, "gpt2": gpt_line, "bert": bert_line,
            "launches": dict(rows)}
    print(f"loop: gpt2 step {med:.1f} ms remat on, "
          f"{gpt_line['remat_off']['step_ms_median_3_10']:.1f} off; peak "
          f"{gpt_line['remat_on']['peak_mem_gb']:.2f} / "
          f"{gpt_line['remat_off']['peak_mem_gb']:.2f} GB; bert "
          f"{bmed:.1f} / {bert_line['remat_off']['step_ms_median_3_10']:.1f}"
          f" ms", flush=True)
    return line, dict(rows)


# phase 16, continuous-batching serving: GPT-2 medium through init_serving
SERVE_CFG = {"max_batch": 8, "block_size": 16, "prefill_chunk": 256,
             "max_model_len": 1024, "num_blocks": 0}
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 32, (8, 896), (16, 128)
SERVE_PREEMPT_BLOCKS = 129   # 128 usable blocks: 2048 positions for 8 slots
SERVE_SHARED_PREFIX = 256    # the prefix-cache pair's shared system prompt
SERVE_TIE_GAP = 1e-4         # a divergence must be a near tie in fp32
SERVE_LOGIT_TOL = 0.1        # first decode step, kernel against plain, bf16
SERVE_WINDOW = 16            # steps in a profiled window of decode


def serving_trace(np, vocab, shared_prefix=0):
    """32 requests, all submitted at once: prompts of 8-896 tokens and
    16-128 new tokens, uniform from seed 0 (with ``shared_prefix``, the
    first that many tokens of every prompt are one seeded system
    prompt, cut back to 896)."""
    rng = np.random.default_rng(0)
    prefix = np.random.default_rng(1).integers(0, vocab, shared_prefix)
    trace = []
    for _ in range(SERVE_REQUESTS):
        p = int(rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))
        g = int(rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1))
        ids = np.concatenate([prefix, rng.integers(0, vocab, p)])
        trace.append((ids[:SERVE_PROMPT[1]], g))
    return trace


def serve_trace(torch, np, srv, trace):
    """Drive ``trace`` through ``srv.serve_forever`` with every request
    submitted at t = 0. Returns the tokens and finish reasons request by
    request and the end-to-end numbers: useful tokens/s, TTFT and
    inter-token latency p50/p99 (each token's delivery time, by wrapping
    the server's ``_deliver``), decode ms a dispatch (host time of each
    ``_run_decode``, which ends in the dispatch's one sync)."""
    times, dispatch_s = {}, []
    deliver, run_decode = srv._deliver, srv._run_decode

    def timed_deliver(req, tokens, now):
        n = deliver(req, tokens, now)
        times.setdefault(req.req_id, []).extend([now] * n)
        return n

    def timed_decode(*args):
        t0 = time.perf_counter()
        run_decode(*args)
        dispatch_s.append(time.perf_counter() - t0)

    srv._deliver, srv._run_decode = timed_deliver, timed_decode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [srv.submit(p, max_new_tokens=g) for p, g in trace]
    outs = {o.req_id: o for o in srv.serve_forever()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    srv._deliver, srv._run_decode = deliver, run_decode
    res = [outs[r] for r in rids]
    ttft = [o.ttft_s * 1e3 for o in res]
    itl = [(b - a) * 1e3 for r in rids
           for a, b in zip(times[r], times[r][1:])]
    n_tok = sum(len(o.tokens) for o in res)
    return {"tokens": [o.tokens for o in res],
            "reasons": [o.finish_reason for o in res],
            "metrics": {
                "wall_s": wall, "useful_tokens": n_tok,
                "useful_tokens_per_s": n_tok / wall,
                "ttft_ms_p50": float(np.percentile(ttft, 50)),
                "ttft_ms_p99": float(np.percentile(ttft, 99)),
                "itl_ms_p50": float(np.percentile(itl, 50)),
                "itl_ms_p99": float(np.percentile(itl, 99)),
                "decode_dispatches": len(dispatch_s),
                "decode_ms_per_dispatch_median":
                    statistics.median(dispatch_s) * 1e3,
                "preemptions": srv.scheduler.preemptions_total,
                "compile_stats": srv.compile_stats()}}


def decode_window(torch, srv, trace, tracer_mod):
    """Profile SERVE_WINDOW steps of pure decode: 8 requests of the
    trace's first prompts cut to 32 tokens (128 new), stepped until every
    slot decodes, then the window under ``torch.profiler`` with the
    tracer's ``record_function`` spans on. Device idle share = 1 - the
    kernels' summed device time over the window's wall time; kernels a
    dispatch from the profiler's kernel count."""
    from torch.profiler import ProfilerActivity, profile
    for p, _ in trace[:srv.max_batch]:
        srv.submit(p[:32], max_new_tokens=SERVE_NEW[1])
    from deepspeed_tpu_torch.serving.scheduler import RequestState
    while sum(r is not None and r.state is RequestState.RUNNING
              for r in srv.scheduler.slots) < srv.max_batch:
        srv.step()
    srv.step()
    old = tracer_mod.set_tracer(tracer_mod.Tracer(enabled=True,
                                                  torch_annotations=True))
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(SERVE_WINDOW):
                srv.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        tracer_mod.set_tracer(old)
    busy, kernels, groups, spans = 0.0, 0, {}, set()
    for ev in prof.key_averages():
        if ev.key in ("serving_step", "serving_decode", "serving_prefill"):
            # the spans also show on the device timeline as annotations
            # covering their kernels: not device work of their own
            spans.add(ev.key)
            continue
        if ev.device_type != torch.autograd.DeviceType.CUDA or \
                ev.self_device_time_total <= 0:
            continue
        ms = ev.self_device_time_total / 1e3
        busy += ms
        kernels += ev.count
        name = ev.key.lower()
        group = ("decode_attention" if "decode_kernel" in name else
                 "matmul" if any(s in name for s in (
                     "gemm", "gemv", "cutlass", "nvjet", "xmma")) else
                 "memcpy" if "memcpy" in name else
                 "index/gather" if "index" in name else "other")
        groups[group] = groups.get(group, 0.0) + ms
    srv.serve_forever()      # drain
    return {"window_steps": SERVE_WINDOW, "wall_ms": wall_ms,
            "device_busy_ms": busy, "device_idle_share": 1 - busy / wall_ms,
            "kernels_per_dispatch": kernels / SERVE_WINDOW,
            "device_ms_per_dispatch_by_group": {
                k: v / SERVE_WINDOW for k, v in groups.items()},
            "spans_in_trace": sorted(spans)}


@contextlib.contextmanager
def plain_decode(runner_mod, decode):
    """Route the runner's decode attention through the plain version."""
    saved = runner_mod.decode_attention
    runner_mod.decode_attention = lambda q, k, v, lens, k_scale=None, \
        v_scale=None: decode.decode_attention_plain(
            q, k, v, lens, k_scale=k_scale, v_scale=v_scale)
    try:
        yield
    finally:
        runner_mod.decode_attention = saved


def first_decode_check(torch, np, srv, trace, runner_mod, decode, vocab):
    """The first decode dispatch's logits on the kernel against the same
    step with ``decode_attention_plain``, on the card (bf16): the inputs
    of the server's first decode call are kept and the one-token stack is
    run again eagerly both ways. Returns (max abs err, max |logit|)."""
    seen = {}
    inner = srv._decode_fn

    def spy(*args):
        seen.setdefault("args", [np.array(a) for a in args])
        return inner(*args)

    srv._decode_fn = spy
    for p, g in trace[:srv.max_batch]:
        srv.submit(p, max_new_tokens=g)
    while "args" not in seen:
        srv.step()
    srv._decode_fn = inner
    bt, pos, active, tok, _, _, lanes, budget = seen["args"]
    r = srv.runner
    live = active & (budget > 0)

    def logits():
        ints = r.upload(r.step_inputs(tok, pos, live, bt, lanes))
        rows = torch.from_numpy(live).cuda()
        return r.stack_decode(ints, len(pos))[rows][:, :vocab]

    got = logits()
    with plain_decode(runner_mod, decode):
        want = logits()
    torch.cuda.synchronize()
    srv.serve_forever()
    return (got - want).abs().max().item(), want.abs().max().item()


def check_gathered_view(torch, srv, decode):
    """The decode kernel on the serving pools' gathered view (layer 0,
    every slot's table of a finished run, a random query) with per-slot
    lengths including 0, against its plain version (2e-2, bf16)."""
    B, MB = srv.max_batch, srv.max_blocks_per_seq
    bt = torch.arange(1, B * MB + 1, device="cuda").remainder(
        srv.cache.num_blocks - 1).add(1).view(B, MB)
    k, v, ks, vs = srv.cache.gather(0, bt)
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(B, srv.cache.n_head, 1, srv.cache.head_dim,
                    generator=gen, device="cuda").to(k.dtype
                                                     if ks is None
                                                     else torch.bfloat16)
    T = k.shape[2]
    lens = torch.tensor([0, 1, 15, 16, 17, 513, T - 1, T][:B],
                        dtype=torch.int32, device="cuda")
    got = decode.decode_attention(q, k, v, lens, k_scale=ks, v_scale=vs)
    want = decode.decode_attention_plain(q, k, v, lens, k_scale=ks,
                                         v_scale=vs)
    torch.cuda.synchronize()
    # the plain version has no zero-length rule: slot 0 is checked alone
    err, ok = close(got[1:], want[1:], 2e-2)
    if not ok or not bool((got[0] == 0).all()):
        raise AssertionError(f"decode kernel on the serving view disagrees "
                             f"with its plain version: {err}")
    return err


def near_tie_gap(torch, model, prompt, tokens, j, vocab):
    """Top-2 logit gap of the fp32 model at the position that produced
    token j of a request (prompt + tokens[:j])."""
    ids = torch.tensor(list(prompt) + list(tokens[:j]), device="cuda")
    with torch.no_grad():
        logits = model({"input_ids": ids[None]}, return_logits=True)[0, -1]
    top = torch.topk(logits[:vocab].float(), 2).values
    return (top[0] - top[1]).item()


def compare_runs(torch, model, trace, a, b, what, vocab):
    """Equal tokens request by request, or a first divergence at a near
    tie (top-2 gap < SERVE_TIE_GAP), printed. Returns the gaps."""
    gaps = []
    for (prompt, _), ta, tb in zip(trace, a["tokens"], b["tokens"]):
        if ta == tb:
            continue
        j = next(i for i, (x, y) in enumerate(zip(ta, tb)) if x != y)
        gap = near_tie_gap(torch, model, prompt, ta, j, vocab)
        print(f"serving {what}: first divergence at token {j}, top-2 "
              f"logit gap {gap:.3g}", flush=True)
        if gap >= SERVE_TIE_GAP:
            raise AssertionError(f"serving {what}: tokens diverge at a "
                                 f"logit gap of {gap} (not a near tie)")
        gaps.append(gap)
    return gaps


def serving_phase(torch, np, deepspeed_tpu_torch, gpt2, decode, op_builder,
                  cfg, card):
    """Phase 16: GPT-2 medium through ``init_serving`` (see the module
    docstring). Returns the ``serving`` line and the decode-kernel
    launches of its main-path runs."""
    import dataclasses
    from deepspeed_tpu_torch.serving import runner as runner_mod
    from deepspeed_tpu_torch.serving.server import ServingEngine
    from deepspeed_tpu_torch.telemetry import tracer as tracer_mod
    vocab, n_layer = cfg.vocab_size, cfg.n_layer
    trace = serving_trace(np, vocab)
    conf = {"serving": SERVE_CFG}
    eng = deepspeed_tpu_torch.init_inference(gpt2.GPT2LMHeadModel(cfg, seed=0),
                                             dtype=torch.bfloat16)
    qeng = deepspeed_tpu_torch.init_inference(
        gpt2.GPT2LMHeadModel(dataclasses.replace(cfg, kv_cache_dtype="int8"),
                             seed=0), dtype=torch.bfloat16)
    line = {"card": card, "config": dict(SERVE_CFG, model="gpt2-medium",
                                         requests=SERVE_REQUESTS,
                                         prompt=SERVE_PROMPT,
                                         new=SERVE_NEW, greedy=True)}
    counts = {}

    def server(engine, impl, graph=True, **over):
        c = {"serving": dict(SERVE_CFG, attention_impl=impl, **over)}
        if graph:
            return deepspeed_tpu_torch.init_serving(engine=engine, config=c)
        return ServingEngine(engine, config=c, cuda_graph=False)

    runs = {}
    for name, engine, impl, graph, kernel in (
            ("paged", eng, "paged", True, None),
            ("gather_eager", eng, "gather", False, "decode_attention"),
            ("gather_graph", eng, "gather", True, "decode_attention"),
            ("gather_graph_rerun", eng, "gather", True, "decode_attention"),
            ("int8_kv_gather_graph", qeng, "gather", True,
             "decode_attention_int8")):
        srv = server(engine, impl, graph)
        if graph and impl == "gather" and \
                srv.compile_stats().get("graph_captures") != 1:
            raise AssertionError(f"serving {name}: {srv.compile_stats()}")
        op_builder.reset_launch_counts()
        res = serve_trace(torch, np, srv, trace)
        launched = dict(op_builder.LAUNCHES)
        m = res["metrics"]
        m["launches"] = launched
        if kernel is not None:
            per = launched.get(kernel, 0) / m["decode_dispatches"]
            m["decode_kernel_launches_per_dispatch"] = per
            if per != n_layer or sum(launched.values()) != \
                    launched.get(kernel, 0):
                raise AssertionError(
                    f"serving {name}: launches {launched} over "
                    f"{m['decode_dispatches']} dispatches, expected "
                    f"{n_layer} {kernel} a dispatch and nothing else")
            counts[kernel] = counts.get(kernel, 0) + launched[kernel]
        if set(res["reasons"]) != {"max_tokens"}:
            raise AssertionError(f"serving {name}: finish reasons "
                                 f"{sorted(set(res['reasons']))}")
        runs[name] = res
        print(f"serving {name}: {json.dumps(m)}", flush=True)
        del srv
        torch.cuda.empty_cache()
    if runs["gather_graph"]["tokens"] != runs["gather_eager"]["tokens"]:
        raise AssertionError("serving: the graph-replayed gather run's "
                             "tokens differ from the eager run's")
    if runs["gather_graph"]["tokens"] != \
            runs["gather_graph_rerun"]["tokens"]:
        raise AssertionError("serving: two runs of the trace differ")
    line["runs"] = {k: v["metrics"] for k, v in runs.items()}
    line["bf16_paged_vs_gather_equal_requests"] = sum(
        a == b for a, b in zip(runs["paged"]["tokens"],
                               runs["gather_graph"]["tokens"]))

    # check 3: the first decode step, kernel against plain
    err, scale = first_decode_check(torch, np, server(eng, "gather"), trace,
                                    runner_mod, decode, vocab)
    print(f"serving first decode step: logits max abs err {err:.4g} (max "
          f"|logit| {scale:.3g})", flush=True)
    if err > SERVE_LOGIT_TOL:
        raise AssertionError(f"serving first decode step disagrees with "
                             f"the plain version: {err}")
    line["first_decode_step"] = {"max_abs_err": err, "logit_scale": scale,
                                 "tolerance": SERVE_LOGIT_TOL}
    line["gathered_view_max_abs_err"] = {
        "bf16": check_gathered_view(torch, server(eng, "gather"), decode),
        "int8": check_gathered_view(torch, server(qeng, "gather"), decode)}

    # the profiled windows of decode
    line["decode_windows"] = {}
    for name, engine, impl, graph in (
            ("paged", eng, "paged", True),
            ("gather_eager", eng, "gather", False),
            ("gather_graph", eng, "gather", True),
            ("int8_kv_gather_graph", qeng, "gather", True)):
        w = decode_window(torch, server(engine, impl, graph), trace,
                          tracer_mod)
        line["decode_windows"][name] = w
        print(f"serving decode window {name}: {json.dumps(w)}", flush=True)
        torch.cuda.empty_cache()
    del eng, qeng
    torch.cuda.empty_cache()

    # check 5: fp32, TF32 off, four pairs
    model32 = gpt2.GPT2LMHeadModel(cfg, seed=0)
    eng32 = deepspeed_tpu_torch.init_inference(model32, dtype=torch.float32)
    shared = serving_trace(np, vocab, SERVE_SHARED_PREFIX)
    fp32 = {}
    for name, impl, over, tr in (
            ("paged", "paged", {}, trace),
            ("gather", "gather", {}, trace),
            ("paged_num_blocks_129", "paged",
             {"num_blocks": SERVE_PREEMPT_BLOCKS}, trace),
            ("paged_speculative_k4", "paged",
             {"speculative": {"enabled": True, "k": 4,
                              "acceptance": "exact"}}, trace),
            ("paged_prefix_cache_on", "paged",
             {"prefix_cache": {"enabled": True}}, trace),
            ("paged_shared_prefix", "paged", {}, shared),
            ("paged_shared_prefix_cache_on", "paged",
             {"prefix_cache": {"enabled": True}}, shared)):
        srv = server(eng32, impl, **over)
        res = serve_trace(torch, np, srv, tr)
        res["metrics"]["prefix_cache"] = (
            None if srv.cache.prefix_cache is None
            else srv.cache.prefix_cache.stats())
        fp32[name] = res
        print(f"serving fp32 {name}: {json.dumps(res['metrics'])}",
              flush=True)
        del srv
        torch.cuda.empty_cache()
    if fp32["paged_num_blocks_129"]["metrics"]["preemptions"] == 0:
        raise AssertionError("serving: num_blocks 129 preempted nothing")
    if fp32["paged_shared_prefix_cache_on"]["metrics"]["prefix_cache"][
            "hits"] == 0:
        raise AssertionError("serving: the prefix cache never hit")
    pairs = {}
    for what, a, b, tr in (
            ("paged vs gather", "paged", "gather", trace),
            ("num_blocks 129 vs auto", "paged", "paged_num_blocks_129",
             trace),
            ("speculative k4 vs off", "paged", "paged_speculative_k4",
             trace),
            ("prefix cache on vs off", "paged", "paged_prefix_cache_on",
             trace),
            ("prefix cache on vs off, shared prefix", "paged_shared_prefix",
             "paged_shared_prefix_cache_on", shared)):
        gaps = compare_runs(torch, model32, tr, fp32[a], fp32[b], what,
                            vocab)
        pairs[what] = {"equal_requests": sum(
            x == y for x, y in zip(fp32[a]["tokens"], fp32[b]["tokens"])),
            "near_tie_gaps": gaps}
    line["fp32_pairs"] = pairs
    line["fp32_runs"] = {k: v["metrics"] for k, v in fp32.items()}
    del eng32, model32
    torch.cuda.empty_cache()
    return line, counts


# phase 17, checkpoints at full width: a tag saved after 3 steps loads
# into a fresh engine built from another init seed, and its next 3 steps
# are bit-equal to the uninterrupted run's on the training kernels
CKPT_STEPS = 3
CKPT_NEW = 16                 # new tokens of the load -> serve check


def tag_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, names in os.walk(path) for f in names)


def same_files(a, b):
    """The tags' ``.pt`` files byte for byte (the manifests name their
    tags, so they differ)."""
    names = sorted(n for n in os.listdir(a) if n.endswith(".pt"))
    if names != sorted(n for n in os.listdir(b) if n.endswith(".pt")):
        return False
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            while True:
                x, y = fa.read(1 << 26), fb.read(1 << 26)
                if x != y:
                    return False
                if not x:
                    break
    return True


def equal_states(torch, a, b, what):
    """The masters and every optimizer leaf of two engines bit-equal."""
    for k, p in a.params.items():
        if not torch.equal(p, b.params[k]):
            raise AssertionError(f"{what}: master {k} differs after resume")
    for field in a.opt_state._fields:
        x, y = getattr(a.opt_state, field), getattr(b.opt_state, field)
        if isinstance(x, dict):
            bad = [k for k in x if not torch.equal(x[k], y[k])]
        elif isinstance(x, torch.Tensor):
            bad = [] if torch.equal(x, y) else [field]
        else:
            bad = [] if x == y else [field]
        if bad:
            raise AssertionError(f"{what}: optimizer {field} differs after "
                                 f"resume: {bad[:3]}")


def resume_pair(torch, op_builder, checkpoint_io, make_engine, batch, root,
                tag, per_step, what, rows, adam_row=None, overlap=False):
    """The reference engine takes 3 steps, saves ``tag`` (sync) and takes 3
    more; with ``overlap`` it also saves the same state again under
    ``async_save`` while those 3 steps run, and that tag's files must equal
    the sync tag's byte for byte. A fresh engine from another init seed
    loads ``tag`` and takes the same 3 steps: losses, masters and the
    optimizer state bit-equal, launches exactly ``per_step`` a step.
    Returns (measurements, the reference's masters at the save, the
    resumed engine); the launches go into ``rows``."""
    def count(counts):
        for k, n in counts.items():
            rows[adam_row if k == "adam" else k] += n

    timing = {}

    def timed(name, fn):
        def run(*args, **kw):
            t = time.perf_counter()
            result = fn(*args, **kw)
            timing[name] = timing.get(name, 0.0) + \
                (time.perf_counter() - t) * 1e3
            return result
        return run

    ref = make_engine(0)
    op_builder.reset_launch_counts()
    run_steps(torch, ref, batch, CKPT_STEPS)
    count(op_builder.LAUNCHES)
    at_save = {k: p.detach().clone() for k, p in ref.params.items()}
    ref._snapshot_checkpoint = timed("snapshot", ref._snapshot_checkpoint)
    ref._persist_checkpoint = timed("persist", ref._persist_checkpoint)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref.save_checkpoint(root, tag=tag)
    save_ms = (time.perf_counter() - t0) * 1e3
    nbytes = tag_bytes(os.path.join(root, tag))
    # the first snapshot also allocates the pinned host buffers
    out = {"tag_bytes": nbytes, "save_ms": save_ms,
           "save_snapshot_ms": timing.pop("snapshot"),
           "save_persist_ms": timing.pop("persist"),
           "write_gb_s": nbytes / save_ms / 1e6}
    if overlap:
        ref._ckpt_async = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref.save_checkpoint(root, tag=tag + "_async")
        out["snapshot_ms"] = (time.perf_counter() - t0) * 1e3
    op_builder.reset_launch_counts()
    want, ms = run_steps(torch, ref, batch, CKPT_STEPS)
    ref_counts = dict(op_builder.LAUNCHES)
    count(ref_counts)
    check_counts(f"{what} reference", ref_counts, per_step, CKPT_STEPS)
    if overlap:
        out["persist_in_flight_after_steps"] = ref._ckpt_writer.in_flight
        ref._ckpt_writer.drain()
        ref.close()
        out.update(persist_ms=timing.pop("persist"),
                   snapshot_only_ms=timing.pop("snapshot"),
                   overlapped_step_ms=ms,
                   async_tag_bytes=tag_bytes(os.path.join(root,
                                                          tag + "_async")))
        if not same_files(os.path.join(root, tag),
                          os.path.join(root, tag + "_async")):
            raise AssertionError(f"{what}: the async tag's files differ "
                                 f"from the sync tag's")
        print(f"ckpt {what}: the async tag's files equal the sync tag's "
              f"byte for byte", flush=True)
        shutil.rmtree(os.path.join(root, tag + "_async"))
    else:
        out["step_ms_after_save"] = ms
    fresh = make_engine(1)
    read = checkpoint_io.load_file
    checkpoint_io.load_file = timed("read", read)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        fresh.load_checkpoint(root, tag=tag)
        torch.cuda.synchronize()
    finally:
        checkpoint_io.load_file = read
    out["load_ms"] = (time.perf_counter() - t0) * 1e3
    out["load_unpickle_ms"] = timing.pop("read")
    out["read_gb_s"] = nbytes / out["load_ms"] / 1e6
    op_builder.reset_launch_counts()
    got, got_ms = run_steps(torch, fresh, batch, CKPT_STEPS)
    counts = dict(op_builder.LAUNCHES)
    count(counts)
    check_counts(f"{what} resumed", counts, per_step, CKPT_STEPS)
    print(f"ckpt {what}: reference losses {want}, resumed {got}; save "
          f"{save_ms:.0f} ms, load {out['load_ms']:.0f} ms, tag "
          f"{nbytes / 1e9:.3f} GB; resumed launches {counts}", flush=True)
    if got != want:
        raise AssertionError(f"{what}: resumed losses {got} differ from the "
                             f"uninterrupted run's {want}")
    equal_states(torch, ref, fresh, what)
    out.update(losses=want, resumed_losses=got, resumed_step_ms=got_ms,
               resumed_launches=counts, bit_equal=True)
    del ref
    return out, at_save, fresh


def checkpoint_phase(torch, deepspeed_tpu_torch, gpt2, bert, op_builder, cfg,
                     bert_cfg, card, train_step_ms):
    """Phase 17: checkpoints at full width. GPT-2 medium in phase 6's
    configuration (sweep, with the async save overlapped; then per-tensor
    fused Adam) and BERT-large in phase 9's with dropout 0.1 resume
    bit-equal; then zero_to_fp32, init_inference(checkpoint=) and
    save_16bit_model on the GPT-2 tag. Every tag lies under
    ``build/ckpt_smoke`` and is deleted at the end. Returns the ``ckpt``
    line and the phase's launches by kernel row."""
    import dataclasses
    from deepspeed_tpu_torch import bridge
    from deepspeed_tpu_torch.runtime import checkpoint_io
    from deepspeed_tpu_torch.utils import zero_to_fp32
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "ckpt_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rows = collections.Counter()
    written = 0
    try:
        batch = gpt2.synthetic_batch(B, SEQ, cfg.vocab_size, seed=4)
        layers = cfg.n_layer
        gpt_step = {"flash_fwd": layers, "flash_bwd_dq": layers,
                    "flash_bwd_dkv": layers, "adam": 1}

        def gpt_engine(**opt):
            return lambda seed: deepspeed_tpu_torch.initialize(
                model=gpt2.GPT2LMHeadModel(cfg, seed=seed),
                config=train_config(**opt))[0]

        sweep, at_save, resumed = resume_pair(
            torch, op_builder, checkpoint_io, gpt_engine(sweep=True), batch,
            root, "gpt2", gpt_step, "gpt2-medium sweep", rows, "adam_sweep",
            overlap=True)
        written += sweep["tag_bytes"] + sweep["async_tag_bytes"]

        # load -> serve on the sweep's tag
        fp32 = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(
            root, tag="gpt2")
        table = bridge.layout_of(at_save)
        for name, t in at_save.items():
            arr = fp32[bridge.keystr(table[name][0])]
            perm = table[name][1]
            host = torch.from_numpy(arr if perm is None
                                    else arr.transpose(perm))
            if not torch.equal(host, t.cpu()):
                raise AssertionError(f"zero_to_fp32: {name} differs from "
                                     f"the master at the save")
        del fp32
        print("ckpt zero_to_fp32: every tensor bit-equal to the masters at "
              "the save", flush=True)
        ids = gpt2.synthetic_batch(B, 896, cfg.vocab_size, seed=1)[
            "input_ids"]
        del resumed
        torch.cuda.empty_cache()
        op_builder.reset_launch_counts()
        tokens = {}
        for how in ("checkpoint", "params"):
            kw = ({"checkpoint": os.path.join(root, "gpt2",
                                              "mp_rank_00_model_states.pt")}
                  if how == "checkpoint" else {"params": at_save})
            t0 = time.perf_counter()
            eng = deepspeed_tpu_torch.init_inference(
                gpt2.GPT2LMHeadModel(cfg, seed=3), dtype=torch.bfloat16,
                **kw)
            torch.cuda.synchronize()
            build_ms = (time.perf_counter() - t0) * 1e3
            tokens[how] = eng.generate(ids, max_new_tokens=CKPT_NEW)
            del eng
            torch.cuda.empty_cache()
            if how == "checkpoint":
                sweep["init_inference_checkpoint_ms"] = build_ms
        for k, n in op_builder.LAUNCHES.items():
            rows[k] += n
        same = torch.equal(tokens["checkpoint"], tokens["params"])
        print(f"ckpt init_inference(checkpoint=): {B} x 896 prompts, "
              f"{CKPT_NEW} new greedy tokens equal to params=: {same}",
              flush=True)
        if not same:
            raise AssertionError("init_inference(checkpoint=) generates "
                                 "other tokens than params=")
        del tokens, at_save
        shutil.rmtree(os.path.join(root, "gpt2"))
        torch.cuda.empty_cache()

        fused, _, resumed = resume_pair(
            torch, op_builder, checkpoint_io, gpt_engine(fused=True), batch,
            root, "gpt2_fused", gpt_step, "gpt2-medium fused adam", rows,
            "adam_per_tensor")
        written += fused["tag_bytes"]
        resumed.save_16bit_model(os.path.join(root, "bit16"))
        path16 = os.path.join(root, "bit16", "pytorch_model.bin")
        written += os.path.getsize(path16)
        sd16 = torch.load(path16, weights_only=True)
        for name, p in resumed.params.items():
            if sd16[name].dtype != torch.bfloat16 or not torch.equal(
                    sd16[name], p.detach().to(torch.bfloat16).cpu()):
                raise AssertionError(f"save_16bit_model: {name} is not the "
                                     f"master cast to bf16")
        print("ckpt save_16bit_model: every tensor equals the master cast "
              "to bf16", flush=True)
        del resumed, sd16
        shutil.rmtree(os.path.join(root, "gpt2_fused"))
        torch.cuda.empty_cache()

        blayers = bert_cfg.num_hidden_layers
        bert_step = {"flash_fwd": blayers, "flash_bwd_dq": blayers,
                     "flash_bwd_dkv": blayers, "ln_fwd": 2 * blayers,
                     "ln_bwd": 2 * blayers, "bias_gelu": blayers, "lamb": 1}
        bert_batch = bert.synthetic_mlm_batch(BERT_B, BERT_S,
                                              bert_cfg.vocab_size, seed=6)
        dropped = dataclasses.replace(
            bert_cfg, hidden_dropout_prob=LOOP_DROPOUT,
            attention_probs_dropout_prob=LOOP_DROPOUT)
        bert_out, _, resumed = resume_pair(
            torch, op_builder, checkpoint_io,
            lambda seed: deepspeed_tpu_torch.initialize(
                model=bert.BertForPreTraining(dropped, seed=seed),
                config=bert_config(fused=True))[0],
            bert_batch, root, "bert", bert_step,
            "bert-large fused lamb dropout 0.1", rows)
        written += bert_out["tag_bytes"]
        del resumed
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line = {
        "card": card,
        "gpt2_sweep": sweep, "gpt2_fused": fused, "bert_lamb": bert_out,
        "tag_bytes": sweep["tag_bytes"], "save_ms": sweep["save_ms"],
        "snapshot_ms": sweep["snapshot_ms"],
        "persist_ms": sweep["persist_ms"], "load_ms": sweep["load_ms"],
        "write_gb_s": sweep["write_gb_s"], "read_gb_s": sweep["read_gb_s"],
        "overlapped_step_ms": sweep["overlapped_step_ms"],
        "phase6_step_ms_median": train_step_ms,
        "bytes_written": written,
        "config": "gpt2-medium bs8 seq1024 bf16 zero1 adam sweep / fused, "
                  "clip 1.0; bert-large bs64 seq128 fused lamb, dropout "
                  "0.1; 3 steps, save, 3 steps",
    }
    print(f"ckpt: step-boundary pause (snapshot) {sweep['snapshot_ms']:.0f} "
          f"ms, background persist {sweep['persist_ms']:.0f} ms, steps "
          f"while it ran {[round(x, 1) for x in sweep['overlapped_step_ms']]}"
          f" ms against phase 6's median {train_step_ms:.1f} ms; "
          f"{written / 1e9:.2f} GB written", flush=True)
    return line, rows


# phase 18, data parallelism at world size 1 on the card: the NCCL path
# against no process group, a checkpoint with tag validation, the lse
# gradient and ring / Ulysses attention
DP_STEPS = 3
# the lse gradient against the plain backward on the same bf16 inputs
# (its products in fp32; it rounds p and ds to bf16 where the kernels
# do): phase 3's tolerance of rows 3 and 4. The error against the plain
# backward on the inputs upcast to fp32 is printed, not held to a bound:
# it is the rounding of p, ds and the outputs to bf16, which the kernels
# and their plain version share
LSE_TOL = 2e-2


def dp_engines(torch, op_builder, make, batch, per_step, what):
    """``make()`` built and run DP_STEPS steps, launches counted and held
    to ``per_step``; (losses, step ms, the masters, launches)."""
    engine = make()
    op_builder.reset_launch_counts()
    losses, ms = run_steps(torch, engine, batch, DP_STEPS)
    counts = dict(op_builder.LAUNCHES)
    check_counts(what, counts, per_step, DP_STEPS)
    masters = {k: p.detach().clone() for k, p in engine.params.items()}
    state = engine.opt_state
    del engine
    torch.cuda.empty_cache()
    return losses, ms, masters, counts, state


def same_state(torch, a, b):
    """Two optimizer states bit-equal (tensors, dicts of them, ints)."""
    for field in a._fields:
        x, y = getattr(a, field), getattr(b, field)
        if isinstance(x, dict):
            if not all(torch.equal(x[k], y[k]) for k in x):
                return False
        elif isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


def lse_grad_check(torch, flash, causal):
    """The lse gradient at GPT-2 medium's attention shape (B 8, H 16, S
    1024, D 64, bf16), random output and lse cotangents: the kernels'
    dq, dk, dv against the plain backward on the same inputs, o and lse
    (``close`` at LSE_TOL; the error against the fp32 upcast printed),
    and with a zero lse cotangent bit for bit ``flash_attention``'s
    gradients."""
    gen = torch.Generator(device="cuda").manual_seed(18 + causal)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v = (rnd(B, H, SEQ, D).requires_grad_() for _ in range(3))
    g_out = rnd(B, H, SEQ, D)
    g_lse = rnd(B, H, SEQ, dtype=torch.float32)
    o, lse = flash.flash_attention_with_lse(q, k, v, causal)
    got = torch.autograd.grad((o, lse), (q, k, v), (g_out, g_lse))
    qd, kd, vd, od = (t.detach() for t in (q, k, v, o))
    wants = {
        "plain": flash.flash_attention_bwd_plain(
            qd, kd, vd, od, lse.detach(), g_out, causal, g_lse=g_lse),
        "fp32": flash.flash_attention_bwd_plain(
            qd.float(), kd.float(), vd.float(), od.float(), lse.detach(),
            g_out.float(), causal, g_lse=g_lse)}
    torch.cuda.synchronize()
    errs = {}
    for ref, want in wants.items():
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err, ok = close(g, w, LSE_TOL)
            errs[f"{name}_vs_{ref}"] = err
            if ref == "plain" and not ok:
                raise AssertionError(
                    f"lse gradient {name} (causal={causal}) off the plain "
                    f"version: max abs err {err}, tolerance {LSE_TOL}")
    o, lse = flash.flash_attention_with_lse(q, k, v, causal)
    zero = torch.autograd.grad((o, lse), (q, k, v),
                               (g_out, torch.zeros_like(g_lse)))
    ref = torch.autograd.grad(flash.flash_attention(q, k, v, causal),
                              (q, k, v), g_out)
    if not all(torch.equal(a, b) for a, b in zip(zero, ref)):
        raise AssertionError("with a zero lse cotangent the gradients "
                             "differ from flash_attention's")
    print(f"dp lse gradient causal={causal}: max abs err "
          + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
          + " against the plain version (bf16, fp32); g_lse = 0 "
            "bit-equal to flash_attention", flush=True)
    return errs


def sequence_parallel_check(torch, flash, ring):
    """Ring and Ulysses at world 1 (one chunk, no rotation; Ulysses' two
    all-to-alls over NCCL): forward and gradients bit for bit
    ``flash_attention``'s, causal and not."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    out = {}
    for causal in (True, False):
        q, k, v, do = (torch.randn(B, H, SEQ, D, generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        ref = flash.flash_attention(q, k, v, causal)
        ref_g = torch.autograd.grad(ref, (q, k, v), do)
        for name, fn in (("ring", ring.ring_attention),
                         ("ulysses", ring.ulysses_attention)):
            got = fn(q, k, v, causal=causal)
            got_g = torch.autograd.grad(got, (q, k, v), do)
            same = torch.equal(got, ref) and all(
                torch.equal(a, b) for a, b in zip(got_g, ref_g))
            out[f"{name}_causal{causal}"] = same
            if not same:
                raise AssertionError(f"{name} attention at world 1 "
                                     f"(causal={causal}) differs from "
                                     f"flash_attention")
    print(f"dp ring / ulysses at world 1: bit-equal to flash_attention "
          f"{out}", flush=True)
    return out


def sweep_gather_ms(torch, engine):
    """The save's sweep-moment gather on a sweep engine: all_gather of
    the rank's chunk, then the reorder to JAX's leaf order (CUDA events,
    one moment)."""
    from deepspeed_tpu_torch import bridge
    part, mu = engine._partition, engine.opt_state.mu
    names = list(engine.params)
    shapes = [tuple(p.shape) for p in engine.params.values()]
    gather = cuda_ms(lambda: part.gather_flat(mu), iters=5, warmup=1)
    full = part.gather_flat(mu)
    reorder = cuda_ms(lambda: bridge.flat_to_jax(
        full, engine._layout, names, shapes), iters=5, warmup=1)
    return {"gather_ms": gather, "reorder_ms": reorder,
            "moment_bytes": full.numel() * 4}


def dp_phase(torch, deepspeed_tpu_torch, gpt2, bert, flash, ring,
             op_builder, cfg, bert_cfg, card, train_step_ms, bert_step_ms):
    """Phase 18: data parallelism at world size 1 over NCCL. GPT-2 medium
    (phase 6's sweep config) and BERT-large (phase 9's fused LAMB at ZeRO
    1) take 3 steps without a process group and 3 with one: losses,
    masters and optimizer state bit-equal. A checkpoint under
    ``tag_validation: Fail``, sync and async, resumes bit-equal. Then the
    lse gradient and ring / Ulysses. Returns the ``dp`` line and the
    main path's launches by kernel row."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.runtime import checkpoint_io
    rows = collections.Counter()
    layers, blayers = cfg.n_layer, bert_cfg.num_hidden_layers
    gpt_step = {"flash_fwd": layers, "flash_bwd_dq": layers,
                "flash_bwd_dkv": layers, "adam": 1}
    bert_step = {"flash_fwd": blayers, "flash_bwd_dq": blayers,
                 "flash_bwd_dkv": blayers, "ln_fwd": 2 * blayers,
                 "ln_bwd": 2 * blayers, "bias_gelu": blayers, "lamb": 1}
    batch = gpt2.synthetic_batch(B, SEQ, cfg.vocab_size, seed=4)
    bert_batch = bert.synthetic_mlm_batch(BERT_B, BERT_S,
                                          bert_cfg.vocab_size, seed=6)
    bert_z1 = dict(bert_config(fused=True), zero_optimization={"stage": 1})
    models = {
        "gpt2": (lambda: deepspeed_tpu_torch.initialize(
            model=gpt2.GPT2LMHeadModel(cfg, seed=0),
            config=train_config(sweep=True))[0], batch, gpt_step,
            "adam_sweep"),
        "bert": (lambda: deepspeed_tpu_torch.initialize(
            model=bert.BertForPreTraining(bert_cfg, seed=0),
            config=bert_z1)[0], bert_batch, bert_step, None)}
    runs = {}
    for name, (make, data, per_step, _) in models.items():
        runs[name, "alone"] = dp_engines(torch, op_builder, make, data,
                                         per_step,
                                         f"dp {name} without a group")
    if dist.is_initialized():
        raise AssertionError("a process group exists before phase 18")
    deepspeed_tpu_torch.init_distributed()         # NCCL, world 1
    line = {"card": card, "backend": dist.get_backend(),
            "world_size": dist.get_world_size()}
    try:
        for name, (make, data, per_step, adam_row) in models.items():
            got = dp_engines(torch, op_builder, make, data, per_step,
                             f"dp {name} over NCCL")
            for k, n in got[3].items():
                rows[adam_row if k == "adam" else k] += n
            want = runs[name, "alone"]
            equal = {
                "losses": got[0] == want[0],
                "masters": all(torch.equal(got[2][k], want[2][k])
                               for k in want[2]),
                "optimizer_state": same_state(torch, got[4], want[4])}
            ref_ms = train_step_ms if name == "gpt2" else bert_step_ms
            print(f"dp {name} world 1 over NCCL: losses {got[0]} (no group "
                  f"{want[0]}); bit-equal {equal}; step ms {got[1]} against "
                  f"{want[1]} without a group, phase {6 if name == 'gpt2' else 9}"
                  f"'s median {ref_ms:.1f}", flush=True)
            if not all(equal.values()):
                raise AssertionError(f"dp {name}: the world-1 NCCL path is "
                                     f"not bit-equal to no group: {equal}")
            line[name] = {"losses": got[0], "step_ms": got[1],
                          "no_group_step_ms": want[1],
                          "phase_median_step_ms": ref_ms,
                          "bit_equal": equal, "launches": got[3]}
            del got, want
            runs.pop((name, "alone"))
            torch.cuda.empty_cache()

        root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "dp_smoke")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        try:
            make = lambda seed: deepspeed_tpu_torch.initialize(
                model=gpt2.GPT2LMHeadModel(cfg, seed=seed),
                config=dict(train_config(sweep=True),
                            checkpoint={"tag_validation": "Fail"}))[0]
            ckpt, _, resumed = resume_pair(
                torch, op_builder, checkpoint_io, make, batch, root, "dp",
                gpt_step, "dp gpt2-medium sweep, NCCL world 1, "
                "tag_validation Fail", rows, "adam_sweep", overlap=True)
            ckpt["sweep_gather"] = sweep_gather_ms(torch, resumed)
            print(f"dp checkpoint: sync and async tags over NCCL resume "
                  f"bit-equal; the save's sweep-moment gather "
                  f"{ckpt['sweep_gather']}", flush=True)
            del resumed
            torch.cuda.empty_cache()
        finally:
            shutil.rmtree(root, ignore_errors=True)
        line["checkpoint"] = ckpt
        line["lse_grad_max_abs_err"] = {
            f"causal{c}": lse_grad_check(torch, flash, c)
            for c in (True, False)}
        line["lse_grad_tolerance"] = LSE_TOL
        line["ring_ulysses_world1_bit_equal"] = sequence_parallel_check(
            torch, flash, ring)
    finally:
        dist.destroy_process_group()
    return line, rows


# phase 19, MoE-GPT (bench.py's gpt2-moe row, nothing cut): GPT-2 small
# (12 x 768, 12 heads, vocab 50304 padded) with 8 experts, top-1, on every
# 2nd block (6 MoE blocks), capacity factor 1.25, bs 8 x 1024, ZeRO 0,
# Adam (the sweep), bf16 over fp32 masters (bench.py:158-160, 226-232)
MOE_EXPERTS, MOE_CF = 8, 1.25
MOE_STEPS, MOE_TOP2_STEPS, MOE_RESUME_STEPS = 10, 3, 2
MOE_NEW = 64                  # new tokens of the generation (phase 4's)
MOE_CHECK_PROMPT, MOE_CHECK_NEW = 128, 16


def moe_config(gpt2, **over):
    import dataclasses
    return dataclasses.replace(gpt2.PRESETS["gpt2"], **{
        "moe_num_experts": MOE_EXPERTS, "moe_expert_interval": 2,
        "moe_k": 1, "moe_capacity_factor": MOE_CF,
        "moe_dispatch_impl": "scatter", **over})


def moe_train_config():
    return {"train_batch_size": B, "train_micro_batch_size_per_gpu": B,
            "steps_per_print": 10 ** 9, "bf16": {"enabled": True},
            "zero_optimization": {"stage": 0}, "gradient_clipping": 1.0,
            "optimizer": {"type": "Adam", "params": {"lr": LR,
                                                     "sweep": True}}}


class ExpertCounts:
    """Forward hooks on the MoE layers that keep each call's exp_counts
    while ``on``."""

    def __init__(self, model, moe_layer_cls):
        self.on, self.counts = False, []
        self.handles = [m.register_forward_hook(self._hook)
                        for m in model.modules()
                        if isinstance(m, moe_layer_cls)]

    def _hook(self, module, args, out):
        if self.on:
            self.counts.append(out[2].detach())

    def remove(self):
        for h in self.handles:
            h.remove()


def moe_drop_share(counts, tokens, experts, cf, k=1):
    """The share of routed tokens over capacity, from each layer's
    exp_counts (top-1: every count above C is a dropped token)."""
    cap = max(math.ceil(tokens / experts * cf * k), 4)
    over = sum(float((c - cap).clamp(min=0).sum()) for c in counts)
    return over / (len(counts) * tokens * k), cap


def moe_impl_parity(torch, deepspeed_tpu_torch, gpt2, attn_mod, decode,
                    fused_adam, batch):
    """A 2-layer full-width MoE model (one MoE block): one micro-batch's
    loss and gradients in bf16 with the scatter, einsum and grouped impls
    on the kernels; then scatter in fp32 on the kernels and on the plain
    versions. Tolerances: scatter = einsum bit for bit in the loss (each
    token has one slot, so the one-hot products add exact zeros), the
    gradients within 1e-2 relative in L2 (the backward's reductions
    differ); grouped within 0.02 of the loss and 2e-2 of the gradients
    (its GEMMs run on the routed rows only). The kernels against the
    plain versions run in fp32 (loss within 1e-4, gradients within 1e-3
    relative in L2): in bf16 a gate's argmax flips for the tokens whose
    top two logits lie within the attention routes' rounding, and a
    flipped token moves its expert's gradient (0.089 relative in L2 on
    this model, on an NVIDIA H100 80GB HBM3 at 700 W), which says nothing
    of the kernels."""

    def one(impl, plain=False, fp32=False):
        config = moe_train_config()
        if fp32:
            del config["bf16"]
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=gpt2.GPT2LMHeadModel(moe_config(
                gpt2, n_layer=2, moe_dispatch_impl=impl), seed=5),
            config=config)
        ctx = (plain_training(gpt2, attn_mod, decode, fused_adam) if plain
               else contextlib.nullcontext())
        with ctx:
            loss = engine.forward(batch)
            engine.backward(loss)
        grads = {k: p.grad.clone() for k, p in engine.params.items()}
        del engine
        torch.cuda.empty_cache()
        return loss.item(), grads

    def rel(a, b):
        num = sum((a[k] - b[k]).square().sum() for k in b)
        return (num / sum(b[k].square().sum() for k in b)).sqrt().item()

    runs = {impl: one(impl) for impl in ("scatter", "einsum", "grouped")}
    base_loss, base_grads = runs["scatter"]
    out = {name: {"loss": loss, "loss_abs_err": abs(loss - base_loss),
                  "grad_rel_l2": rel(grads, base_grads)}
           for name, (loss, grads) in runs.items() if name != "scatter"}
    out["scatter_loss"] = base_loss
    out["scatter_einsum_loss_bit_equal"] = runs["einsum"][0] == base_loss
    k_loss, k_grads = one("scatter", fp32=True)
    p_loss, p_grads = one("scatter", plain=True, fp32=True)
    out["fp32_kernels_vs_plain"] = {
        "loss": k_loss, "loss_abs_err": abs(k_loss - p_loss),
        "grad_rel_l2": rel(k_grads, p_grads)}
    print(f"moe impl parity 2-layer: {json.dumps(out)}", flush=True)
    plain = out["fp32_kernels_vs_plain"]
    if not (out["scatter_einsum_loss_bit_equal"]
            and out["einsum"]["grad_rel_l2"] <= 1e-2
            and out["grouped"]["loss_abs_err"] <= 0.02
            and out["grouped"]["grad_rel_l2"] <= 2e-2
            and plain["loss_abs_err"] <= 1e-4
            and plain["grad_rel_l2"] <= 1e-3):
        raise AssertionError(f"MoE dispatch impls disagree: {out}")
    return out


def moe_resume(torch, deepspeed_tpu_torch, gpt2, op_builder, engine, batch,
               root):
    """Save the engine's tag, take MOE_RESUME_STEPS steps; a fresh engine
    from another init seed loads the tag and takes them too: losses,
    masters and the sweep's moments bit-equal. Returns (line, tag path,
    launches)."""
    from deepspeed_tpu_torch.runtime import checkpoint_io
    t0 = time.perf_counter()
    engine.save_checkpoint(root, tag="moe")
    save_s = time.perf_counter() - t0
    tag_dir = os.path.join(root, "moe")
    files = sorted(os.listdir(tag_dir))
    experts = [f for f in files if f.startswith("layer_")]
    sd = checkpoint_io.load_file(os.path.join(
        tag_dir, "mp_rank_00_model_states.pt"))
    op_builder.reset_launch_counts()
    ref, _ = run_steps(torch, engine, batch, MOE_RESUME_STEPS)
    masters = {k: p.detach().clone() for k, p in engine.params.items()}
    state = engine.opt_state
    fresh, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2.GPT2LMHeadModel(moe_config(gpt2), seed=1),
        config=moe_train_config())
    t0 = time.perf_counter()
    fresh.load_checkpoint(root, tag="moe")
    load_s = time.perf_counter() - t0
    got, _ = run_steps(torch, fresh, batch, MOE_RESUME_STEPS)
    counts = dict(op_builder.LAUNCHES)
    equal = {"losses": got == ref,
             "masters": all(torch.equal(fresh.params[k], masters[k])
                            for k in masters),
             "moments": same_state(torch, fresh.opt_state, state)}
    line = {"expert_files": len(experts), "files": len(files),
            "moe_layer_prefixes": sd["moe_layer_prefixes"],
            "moe_expert_counts": sd["moe_expert_counts"],
            "save_s": save_s, "load_s": load_s, "losses": ref,
            "resumed_losses": got, "bit_equal": equal}
    print(f"moe resume: {json.dumps(line)}", flush=True)
    if len(experts) != 6 * MOE_EXPERTS or not all(equal.values()):
        raise AssertionError(f"MoE resume failed: {line}")
    del fresh
    torch.cuda.empty_cache()
    return line, os.path.join(tag_dir, "mp_rank_00_model_states.pt"), counts


def moe_generation(torch, deepspeed_tpu_torch, gpt2, attn_mod, decode,
                   op_builder, path):
    """``init_inference(moe=True, checkpoint=)`` on the tag: bf16 greedy
    generation at phase 4's shape (8 x 896, 64 new; its launches counted
    and returned), timed; then fp32 greedy tokens (8 x 128, 16 new) on the
    kernels equal to a plain-attention run's. Returns (line, launches)."""
    cfg = moe_config(gpt2)
    ids = gpt2.synthetic_batch(B, 896, cfg.vocab_size, seed=1)["input_ids"]
    eng = deepspeed_tpu_torch.init_inference(
        gpt2.GPT2LMHeadModel(cfg, seed=0), dtype=torch.bfloat16,
        checkpoint=path, moe=True, moe_experts=MOE_EXPERTS)
    eng.generate(ids[:, :32], max_new_tokens=4)          # warm-up
    torch.cuda.synchronize()
    op_builder.reset_launch_counts()
    out = eng.generate(ids, max_new_tokens=MOE_NEW)
    torch.cuda.synchronize()
    counts = dict(op_builder.LAUNCHES)
    want = {"flash_fwd": cfg.n_layer,
            "decode_attention": cfg.n_layer * (MOE_NEW - 1)}
    if {k: counts.get(k, 0) for k in want} != want:
        raise AssertionError(f"MoE generation launches {counts}, expected "
                             f"{want}")
    if out.shape != (B, 896 + MOE_NEW) or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"MoE generation output {tuple(out.shape)}")
    prefill_ms = host_ms(lambda: eng.generate(ids, max_new_tokens=1))
    gen_ms = host_ms(lambda: eng.generate(ids, max_new_tokens=MOE_NEW),
                     reps=2)
    del eng
    torch.cuda.empty_cache()
    f32 = deepspeed_tpu_torch.init_inference(
        gpt2.GPT2LMHeadModel(cfg, seed=0), dtype=torch.float32,
        checkpoint=path, moe=True)
    short = ids[:, :MOE_CHECK_PROMPT]
    kern = f32.generate(short, max_new_tokens=MOE_CHECK_NEW)
    with plain_attention(gpt2, attn_mod, decode):
        plain = f32.generate(short, max_new_tokens=MOE_CHECK_NEW)
    del f32
    torch.cuda.empty_cache()
    line = {"prompt": [B, 896], "new": MOE_NEW, "prefill_ms": prefill_ms,
            "generate_ms": gen_ms,
            "decode_ms_per_token": (gen_ms - prefill_ms) / (MOE_NEW - 1),
            "tokens_per_s": B * MOE_NEW / gen_ms * 1e3,
            "fp32_greedy_equal_plain": bool(torch.equal(kern, plain)),
            "fp32_check_shape": [B, MOE_CHECK_PROMPT, MOE_CHECK_NEW]}
    print(f"moe generation: {json.dumps(line)}", flush=True)
    if not line["fp32_greedy_equal_plain"]:
        raise AssertionError("MoE greedy tokens on the kernels differ from "
                             "the plain-attention run's")
    return line, counts


def moe_world1(torch, deepspeed_tpu_torch, gpt2, op_builder, batch):
    """World 1 over NCCL: 3 steps with the default groups (ep 1) and with
    ``groups.initialize(ep_size=1)``, each bit-equal to 3 steps without a
    process group (losses, masters, moments). Returns (line, launches)."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.utils import groups

    def make():
        return deepspeed_tpu_torch.initialize(
            model=gpt2.GPT2LMHeadModel(moe_config(gpt2), seed=0),
            config=moe_train_config())[0]

    per_step = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                "adam": 1}
    rows = collections.Counter()
    groups.destroy()
    alone = dp_engines(torch, op_builder, make, batch, per_step,
                       "moe without a group")
    if dist.is_initialized():
        raise AssertionError("a process group exists before phase 19")
    deepspeed_tpu_torch.init_distributed()         # NCCL, world 1
    line = {"backend": dist.get_backend(), "world_size": dist.get_world_size(),
            "ep_gt_1": "not run: expert parallelism above 1 needs more than "
                       "one card (tests/test_torch_dist_moe.py runs ep 2 "
                       "and 4 over gloo on the CPU)"}
    try:
        for name, ep in (("default_groups", None), ("ep_size_1", 1)):
            groups.destroy()
            if ep is not None:
                groups.initialize(ep_size=ep)
            got = dp_engines(torch, op_builder, make, batch, per_step,
                             f"moe over NCCL ({name})")
            for k, n in got[3].items():
                rows["adam_sweep" if k == "adam" else k] += n
            equal = {"losses": got[0] == alone[0],
                     "masters": all(torch.equal(got[2][k], alone[2][k])
                                    for k in alone[2]),
                     "optimizer_state": same_state(torch, got[4], alone[4])}
            line[name] = {"losses": got[0], "step_ms": got[1],
                          "bit_equal_no_group": equal}
            print(f"moe world 1 over NCCL ({name}): {json.dumps(line[name])}",
                  flush=True)
            if not all(equal.values()):
                raise AssertionError(f"moe {name}: not bit-equal to no "
                                     f"group: {equal}")
    finally:
        groups.destroy()
        dist.destroy_process_group()
    line["no_group"] = {"losses": alone[0], "step_ms": alone[1]}
    for k, n in alone[3].items():
        rows["adam_sweep" if k == "adam" else k] += n
    return line, rows


def moe_phase(torch, deepspeed_tpu_torch, gpt2, attn_mod, decode, fused_adam,
              op_builder, card):
    """Phase 19: MoE-GPT at full width. Returns the ``moe`` line and the
    phase's launches by kernel row."""
    from deepspeed_tpu_torch.moe.sharded_moe import MOELayer
    rows = collections.Counter()
    cfg = moe_config(gpt2)
    batch = gpt2.synthetic_batch(B, SEQ, cfg.vocab_size, seed=4)
    per_step = {"flash_fwd": cfg.n_layer, "flash_bwd_dq": cfg.n_layer,
                "flash_bwd_dkv": cfg.n_layer, "adam": 1}

    def book(counts):
        for k, n in counts.items():
            rows["adam_sweep" if k == "adam" else k] += n

    # 1. training, scatter: 10 steps, launches counted on the main path
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = gpt2.GPT2LMHeadModel(cfg, seed=0)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model,
                                                config=moe_train_config())
    hooks = ExpertCounts(model, MOELayer)
    op_builder.reset_launch_counts()
    losses, step_ms = [], []
    for i in range(MOE_STEPS):
        hooks.on = i == MOE_STEPS - 1
        got, ms = run_steps(torch, engine, batch, 1)
        losses += got
        step_ms += ms
    hooks.on = False
    counts = dict(op_builder.LAUNCHES)
    check_counts("moe training", counts, per_step, MOE_STEPS)
    book(counts)
    peak = torch.cuda.max_memory_allocated()
    profile = device_profile(torch, lambda: engine.train_batch(batch=batch))
    drop, cap = moe_drop_share(hooks.counts, B * SEQ, MOE_EXPERTS, MOE_CF)
    exp_counts = [[int(x) for x in c.tolist()] for c in hooks.counts]
    hooks.remove()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a MoE training loss is not finite: {losses}")
    if not (abs(losses[0] - math.log(cfg.vocab_size)) < 0.5
            and losses[-1] < losses[0]):
        raise AssertionError(f"MoE losses {losses}: not near ln(vocab) or "
                             f"not falling")
    med = statistics.median(step_ms[2:MOE_STEPS])
    n_params = sum(p.numel() for p in engine.params.values())
    width, n_moe = cfg.n_embd, cfg.n_layer // cfg.moe_expert_interval
    # bench.py:551-557: (E - k) expert MLPs a MoE block do no work for a
    # token
    fpt = 6 * n_params + 12 * cfg.n_layer * width * SEQ \
        - 6 * (MOE_EXPERTS - 1) * 8 * width * width * n_moe
    line = {"card": card,
            "config": "gpt2-moe: gpt2 12x768, 8 experts top-1 every 2nd "
                      "layer, cf 1.25, bs8 seq1024 bf16 zero0 adam-sweep "
                      "clip1.0, scatter",
            "n_params": n_params, "step_ms_median_3_10": med,
            "step_ms": step_ms, "tokens_per_s": B * SEQ / med * 1e3,
            "flops_per_token": fpt,
            "mfu": fpt * B * SEQ / (med / 1e3) / BF16_FLOPS,
            "peak_mem_gb": peak / 1e9,
            "device_idle_share": profile["device_idle_share"],
            "losses": losses, "capacity": cap,
            "exp_counts_last_step": exp_counts,
            "dropped_share_last_step": drop,
            "launches_training": counts, "profile_train_step": profile}
    print(f"moe training: losses {losses}, step ms median {med:.2f}, "
          f"dropped share {drop:.4f}, exp_counts {exp_counts}", flush=True)

    # 4. the checkpoint, from the training engine (its steps join the
    # training launches), then 5. generation from its tag
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "moe_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        line["resume"], path, counts = moe_resume(
            torch, deepspeed_tpu_torch, gpt2, op_builder, engine, batch,
            root)
        check_counts("moe resume", counts, per_step, 2 * MOE_RESUME_STEPS)
        book(counts)
        del engine, model
        torch.cuda.empty_cache()
        line["generation"], counts = moe_generation(
            torch, deepspeed_tpu_torch, gpt2, attn_mod, decode, op_builder,
            path)
        book(counts)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # 2. the dispatch impls on 2 full-width layers
    line["impl_parity_2layer"] = moe_impl_parity(
        torch, deepspeed_tpu_torch, gpt2, attn_mod, decode, fused_adam, batch)

    # 3. top-2: 3 steps, finite and falling
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2.GPT2LMHeadModel(moe_config(gpt2, moe_k=2), seed=0),
        config=moe_train_config())
    op_builder.reset_launch_counts()
    top2, top2_ms = run_steps(torch, engine, batch, MOE_TOP2_STEPS)
    counts = dict(op_builder.LAUNCHES)
    check_counts("moe top-2", counts, per_step, MOE_TOP2_STEPS)
    book(counts)
    del engine
    torch.cuda.empty_cache()
    line["top2"] = {"losses": top2, "step_ms": top2_ms}
    print(f"moe top-2: {json.dumps(line['top2'])}", flush=True)
    if not (all(math.isfinite(x) for x in top2) and top2[-1] < top2[0]):
        raise AssertionError(f"MoE top-2 losses {top2}")

    # 6. world 1 over NCCL
    line["world1_nccl"], counts = moe_world1(
        torch, deepspeed_tpu_torch, gpt2, op_builder, batch)
    for k, n in counts.items():
        rows[k] += n
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "adam_sweep",
              "decode_attention"):
        if rows.get(k, 0) == 0:
            raise AssertionError(f"kernel {k} never launched in phase 19")
    return line, rows


# phase 20, ZeRO stages 2 and 3 and the optimizer offload at GPT-2 XL
# width (bench.py's gpt2-xl row, bench.py:154): bs 4 x 1024, bf16 over
# fp32 masters, Adam lr 1e-4, fused; then NVMe offload at GPT-2 medium
ZERO_B, ZERO_STEPS, NVME_STEPS = 4, 3, 2
OFFLOAD_RTOL = 2e-4      # tests/model/test_loss_parity.py:124
# the streamed masters against the resident oracle's, a leaf at a time, as
# a share of the oracle's change over the steps (master_gaps): twice the
# largest gap measured on an H100 at GPT-2 XL width, a batch of its own
# each step (0.0497, wte; 0.0213 at the card test's 4 blocks). A gradient
# read a step stale gave 0.69 on a tiny model, a skipped last update 0.36
OFFLOAD_MASTER_RTOL = 0.1


def zero_train_config(stage, offload=None, batch=ZERO_B, form="fused"):
    """bench.py's gpt2-xl config at ZeRO ``stage``; Adam in ``form``
    (``fused``: the per-tensor kernel, ``sweep``: the whole-state one)."""
    zero = {"stage": stage}
    if offload is not None:
        zero["offload_optimizer"] = offload
    return {"train_batch_size": batch,
            "train_micro_batch_size_per_gpu": batch,
            "steps_per_print": 10 ** 9, "bf16": {"enabled": True},
            "zero_optimization": zero,
            "optimizer": {"type": "Adam", "params": {"lr": LR, form: True}}}


def host_ram_gb():
    """(total, available) host RAM in GB, from /proc/meminfo."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            info[key] = int(val.split()[0]) * 1024 / 1e9
    return info["MemTotal"], info["MemAvailable"]


def zero_run(torch, deepspeed_tpu_torch, gpt2, op_builder, cfg, config,
             batch, steps, per_step, what, model=None):
    """One engine of phase 20 built and run ``steps`` steps, its launches
    held to ``per_step``. ``model`` builds the module (default GPT-2 of
    ``cfg`` from seed 0). Returns (figures, the whole masters on the
    host)."""
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.runtime.zero.partition import estimate_zero_mem
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    engine = deepspeed_tpu_torch.initialize(
        model=(model or (lambda: gpt2.GPT2LMHeadModel(cfg, seed=0)))(),
        config=config)[0]
    op_builder.reset_launch_counts()
    losses, ms = run_steps(torch, engine, batch, steps)
    counts = dict(op_builder.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    check_counts(what, counts, per_step, steps)
    n = sum(math.prod(s) for s in engine._shapes.values())
    off = engine._offload_opt
    figures = {
        "losses": losses, "step_ms": ms,
        "step_ms_median": statistics.median(ms[1:]),
        "cpu_adam_host_ms": None if off is None else off.last_host_ms,
        "peak_mem_gb": peak / 1e9,
        # the JAX package's model: bf16 params, fp32 grads, masters and
        # m + v (none of the moments on the card under offload)
        "estimate_zero_mem_gb": estimate_zero_mem(
            n, engine.dp_world_size, engine.zero_stage,
            optimizer_mult=0 if off is not None else 2) / 1e9,
        "gathered_compute_copy_gb": n * 2 / 1e9,
        "n_params": n, "n_tensors": len(engine._shapes),
        "launches": counts, "process_group": engine._dist,
        "zero_stage": engine.zero_stage,
        "adam": "sweep" if engine.config.optimizer_sweep else "fused"}
    with zero.GatheredParameters(dict(engine.params)) as whole:
        masters = {k: t.cpu() for k, t in whole.items()}
    del engine, whole
    torch.cuda.empty_cache()
    print(f"zero {what}: {json.dumps(figures)}", flush=True)
    return figures, masters


def bit_equal_runs(torch, runs, want, key, ref, got, what):
    """Phase 20's check: run ``key``'s losses and masters (``got``) equal
    run ``ref``'s (``want``) bit for bit; returns the comparison."""
    out = {"losses": runs[key]["losses"] == runs[ref]["losses"],
           "masters": all(torch.equal(got[k], want[k]) for k in want),
           "max_abs_master_diff": max(
               float((got[k] - want[k]).abs().max()) for k in want)}
    print(f"zero ({key[0]}) against ({ref[0]}): {out}", flush=True)
    if not (out["losses"] and out["masters"]):
        raise AssertionError(f"{what} is not bit-equal: {out}")
    return out


def zero_phase(torch, deepspeed_tpu_torch, gpt2, bert, op_builder, card,
               bert_cfg, bert_batch):
    """Phase 20: GPT-2 XL at stages 0, 2 and 3 and stage 3 offloaded to
    host RAM, then GPT-2 medium offloaded to NVMe; GPT-2 XL with the Adam
    sweep and BERT-large with MoQ, each at stage 3 against stage 0.
    Returns the ``zero`` line and the main path's launches by kernel
    row."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.ops.adam import fused_adam
    from deepspeed_tpu_torch.ops.aio.aio_handle import AsyncIOHandle
    t0 = time.perf_counter()
    cfg = gpt2.PRESETS["gpt2-xl"]
    layers = cfg.n_layer
    batch = gpt2.synthetic_batch(ZERO_B, SEQ, cfg.vocab_size, seed=8)
    n_tensors = 4 + 12 * layers     # wte, wpe, ln_f's two; 12 a block
    adam = -(-n_tensors // fused_adam.MULTI_MAX_TENSORS)
    flash = {"flash_fwd": layers, "flash_bwd_dq": layers,
             "flash_bwd_dkv": layers}
    total, avail = host_ram_gb()
    line = {"card": card, "config": "gpt2-xl bs4 seq1024 bf16 "
            "adam(fused) lr1e-4",
            "host_ram_gb": {"total": total, "available_at_start": avail}}
    print(f"zero: host RAM {total:.1f} GB, {avail:.1f} GB available",
          flush=True)
    rows = collections.Counter()
    runs = {}
    if dist.is_initialized():
        raise AssertionError("a process group exists before phase 20")
    runs["a_stage0_no_group"], want = zero_run(
        torch, deepspeed_tpu_torch, gpt2, op_builder, cfg,
        zero_train_config(0), batch, ZERO_STEPS, dict(flash, adam=adam),
        "(a) gpt2-xl stage 0, no process group")
    if len(want) != n_tensors:
        raise AssertionError(f"gpt2-xl holds {len(want)} tensors, "
                             f"expected {n_tensors}")
    # random init: the first loss near ln(vocab), as phase 6 checks
    first = runs["a_stage0_no_group"]["losses"]
    if not all(math.isfinite(x) for x in first) or \
            abs(first[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"gpt2-xl losses {first}: not finite, or the "
                             f"first not near ln(vocab)")
    # the stage-0 references of the sweep and of MoQ (no process group)
    runs["f_ref_stage0_sweep"], want_sweep = zero_run(
        torch, deepspeed_tpu_torch, gpt2, op_builder, cfg,
        zero_train_config(0, form="sweep"), batch, ZERO_STEPS,
        dict(flash, adam=1), "(f) reference: gpt2-xl stage 0, Adam sweep")
    bert_model = lambda: bert.BertForPreTraining(bert_cfg, seed=0)
    bert_per_step = {"flash_fwd": 24, "flash_bwd_dq": 24,
                     "flash_bwd_dkv": 24, "ln_fwd": 48, "ln_bwd": 48,
                     "bias_gelu": 24, "lamb": 1, "quantize": 1}
    moq_cfg = lambda stage: dict(
        bert_config(fused=True), quantize_training=moq_block(),
        zero_optimization={"stage": stage})
    runs["g_ref_bert_stage0_moq"], want_moq = zero_run(
        torch, deepspeed_tpu_torch, gpt2, op_builder, bert_cfg, moq_cfg(0),
        bert_batch, ZERO_STEPS, bert_per_step,
        "(g) reference: bert-large stage 0, MoQ", model=bert_model)
    deepspeed_tpu_torch.init_distributed()         # NCCL, world 1
    bit_equal = {}
    try:
        # the sweep at stage 3: one flat vector of the rank's slices
        runs["f_stage3_sweep_nccl"], got = zero_run(
            torch, deepspeed_tpu_torch, gpt2, op_builder, cfg,
            zero_train_config(3, form="sweep"), batch, ZERO_STEPS,
            dict(flash, adam=1), "(f) gpt2-xl stage 3, Adam sweep, over "
            "NCCL world 1")
        bit_equal["f_stage3_sweep_nccl"] = bit_equal_runs(
            torch, runs, want_sweep, "f_stage3_sweep_nccl",
            "f_ref_stage0_sweep", got, "gpt2-xl stage 3 with the sweep")
        del got, want_sweep
        # MoQ at stage 3: gathered, quantized whole, cut back
        runs["g_bert_stage3_moq_nccl"], got = zero_run(
            torch, deepspeed_tpu_torch, gpt2, op_builder, bert_cfg,
            moq_cfg(3), bert_batch, ZERO_STEPS, bert_per_step,
            "(g) bert-large stage 3, MoQ, over NCCL world 1",
            model=bert_model)
        bit_equal["g_bert_stage3_moq_nccl"] = bit_equal_runs(
            torch, runs, want_moq, "g_bert_stage3_moq_nccl",
            "g_ref_bert_stage0_moq", got, "bert-large stage 3 with MoQ")
        del got, want_moq
        for key, stage in (("b_stage2_nccl", 2), ("c_stage3_nccl", 3)):
            runs[key], got = zero_run(
                torch, deepspeed_tpu_torch, gpt2, op_builder, cfg,
                zero_train_config(stage), batch, ZERO_STEPS,
                dict(flash, adam=adam), f"({key[0]}) gpt2-xl stage {stage} "
                f"over NCCL world 1")
            bit_equal[key] = bit_equal_runs(
                torch, runs, want, key, "a_stage0_no_group", got,
                f"gpt2-xl stage {stage} against stage 0")
            del got
        runs["d_stage3_offload_cpu"], got = zero_run(
            torch, deepspeed_tpu_torch, gpt2, op_builder, cfg,
            zero_train_config(3, {"device": "cpu"}), batch, ZERO_STEPS,
            flash, "(d) gpt2-xl stage 3, offload_optimizer cpu")
        ref = runs["a_stage0_no_group"]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(runs["d_stage3_offload_cpu"]["losses"], ref))
        line["offload_cpu_max_rel_loss_diff"] = rel
        line["offload_cpu_max_abs_master_diff"] = max(
            float((got[k] - want[k]).abs().max()) for k in want)
        del got, want
        if not rel <= OFFLOAD_RTOL:
            raise AssertionError(f"gpt2-xl offloaded losses differ from "
                                 f"stage 0 by {rel} relative (tolerance "
                                 f"{OFFLOAD_RTOL})")
        # (e) NVMe: GPT-2 medium, stage 2, against the same run offloaded
        # to host RAM
        mcfg = gpt2.PRESETS["gpt2-medium"]
        mbatch = gpt2.synthetic_batch(B, SEQ, mcfg.vocab_size, seed=4)
        mflash = {k: mcfg.n_layer for k in flash}
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "zero_nvme")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        try:
            handle = AsyncIOHandle()
            handle.reset_max_inflight()
            runs["e_medium_stage2_offload_nvme"], nvme = zero_run(
                torch, deepspeed_tpu_torch, gpt2, op_builder, mcfg,
                zero_train_config(2, {"device": "nvme", "nvme_path": root},
                                  batch=B), mbatch, NVME_STEPS, mflash,
                "(e) gpt2-medium stage 2, offload_optimizer nvme")
            line["nvme"] = {
                "kernel_aio": handle.kernel_aio_available(root),
                "max_inflight": handle.max_inflight(),
                "swap_path": "build/zero_nvme"}
            runs["e_ref_medium_stage2_offload_cpu"], ram = zero_run(
                torch, deepspeed_tpu_torch, gpt2, op_builder, mcfg,
                zero_train_config(2, {"device": "cpu"}, batch=B), mbatch,
                NVME_STEPS, mflash,
                "(e) reference: gpt2-medium stage 2, offload_optimizer cpu")
            same = (runs["e_medium_stage2_offload_nvme"]["losses"]
                    == runs["e_ref_medium_stage2_offload_cpu"]["losses"]
                    and all(torch.equal(nvme[k], ram[k]) for k in ram))
            line["nvme"]["bit_equal_to_ram_offload"] = same
            del nvme, ram
            if not same:
                raise AssertionError("NVMe offload is not bit-equal to "
                                     "the same run offloaded to RAM")
        finally:
            shutil.rmtree(root, ignore_errors=True)
        line["nvme"]["swap_folder_removed"] = not os.path.exists(root)
    finally:
        dist.destroy_process_group()
    for figures in runs.values():
        adam = "adam_sweep" if figures["adam"] == "sweep" \
            else "adam_per_tensor"
        for k, v in figures["launches"].items():
            rows[adam if k == "adam" else k] += v
    line.update(runs=runs, bit_equal_to_stage0=bit_equal,
                offload_rtol=OFFLOAD_RTOL,
                phase_s=time.perf_counter() - t0)
    print(f"zero: phase 20 took {line['phase_s']:.1f} s", flush=True)
    return line, rows


# phase 21, ZeRO-3 parameter offload: bench.py's gpt2-xl row streamed a
# layer at a time from host RAM (bench.py:275-420, BENCH_OFFLOAD=layered)
OFFLOAD_STEPS = 3
OFFLOAD_NVME_LAYERS = 8      # the NVMe and resume checks' depth


def offload_config(nvme_path=None):
    """bench.py:370-378's config: ZeRO 3 with offload_param, bf16, Adam."""
    off = ({"device": "cpu"} if nvme_path is None
           else {"device": "nvme", "nvme_path": nvme_path})
    return {"train_batch_size": ZERO_B, "steps_per_print": 10 ** 9,
            "bf16": {"enabled": True},
            "zero_optimization": {"stage": 3, "offload_param": off},
            "optimizer": {"type": "Adam", "params": {"lr": LR}}}


def layered_engine(deepspeed_tpu_torch, gpt2, cfg, batch, nvme_path=None):
    return deepspeed_tpu_torch.initialize(
        model=gpt2.gpt2_offload_layers(cfg), config=offload_config(nvme_path),
        sample_batch=batch, input_fn=lambda b: b["input_ids"])[0]


def resident_oracle(torch, engine, batches, lr=LR):
    """The layered engine's layers all resident on the card, from its
    initial masters, one step a batch of ``batches``: plain autograd over the whole stack (the same
    modules through ``functional_call``, bf16 over fp32 masters), then
    Adam with CPU-Adam's formula (csrc/cpu_adam.cpp: step size lr / bc1,
    denominator sqrt(v) / sqrt(bc2) + eps). Returns (the losses, the
    initial masters, the final masters): the masters a dict a layer of
    fp32 tensors on the card, for :func:`master_gaps`."""
    from torch.func import functional_call
    dev, dt = engine.device, engine.compute_dtype
    masters = [{n: h.to(dev, copy=True).requires_grad_() for n, h in zip(
        engine.store.names[i], engine.store.host_leaves(i))}
        for i in range(len(engine._mods))]
    initial = [{n: p.detach().clone() for n, p in layer.items()}
               for layer in masters]
    state = [{n: (torch.zeros_like(p), torch.zeros_like(p))
              for n, p in layer.items()} for layer in masters]
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses = []
    for step, batch in enumerate(batches, 1):
        x = batch["input_ids"]
        for mod, layer in zip(engine._mods[:-1], masters[:-1]):
            x = functional_call(mod, {n: p.to(dt) for n, p in layer.items()},
                                (x,))
        loss = functional_call(engine._mods[-1], {
            n: p.to(dt) for n, p in masters[-1].items()}, (x, batch))
        loss.backward()
        losses.append(float(loss.detach()))
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
        with torch.no_grad():
            for layer, st in zip(masters, state):
                for n, p in layer.items():
                    m, v = st[n]
                    g = p.grad
                    m.mul_(b1).add_(g, alpha=1 - b1)
                    v.mul_(b2).addcmul_(g, g, value=1 - b2)
                    p.addcdiv_(m, v.sqrt().mul_(1 / math.sqrt(bc2)).add_(eps),
                               value=-lr / bc1)
                    p.grad = None
    final = [{n: p.detach() for n, p in layer.items()} for layer in masters]
    del masters, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return losses, initial, final


def master_gaps(torch, engine, initial, final):
    """The streamed masters (the engine's host fp32, after its steps)
    against the resident oracle's, leaf by leaf: for each leaf name the
    largest relative L2 gap over the layers, ||streamed - oracle|| over
    the oracle's change ||oracle - initial||. The key third of the qkv
    bias is a kind of its own (``...qkv.bias[k]``): softmax does not see a
    constant added to a row's scores, so its gradient is zero but for
    rounding and Adam's normalised step moves it at random in both runs;
    it is reported, not held to the tolerance."""
    gaps = {}
    for i, (p0, want) in enumerate(zip(initial, final)):
        for n, h in zip(engine.store.names[i], engine.store.host_leaves(i)):
            o = want[n].reshape(-1)
            got = h.to(o.device).reshape(-1)
            d0 = p0[n].reshape(-1)
            parts = {n: slice(None)}
            if n.endswith("attn.qkv.bias"):
                e = o.numel() // 3
                parts = {n + "[q,v]": torch.cat([
                    torch.arange(0, e), torch.arange(2 * e, 3 * e)]).to(
                    o.device), n + "[k]": slice(e, 2 * e)}
            for kind, idx in parts.items():
                moved = float(torch.linalg.vector_norm(o[idx] - d0[idx]))
                off = float(torch.linalg.vector_norm(got[idx] - o[idx]))
                gap = (off / moved if moved else
                       (0.0 if off == 0 else math.inf))
                gaps[kind] = max(gaps.get(kind, 0.0), gap)
    return gaps


def check_master_gaps(gaps, rtol, what):
    """Every leaf kind but the qkv bias's key third within ``rtol``."""
    bad = {k: g for k, g in gaps.items()
           if not k.endswith("[k]") and not g <= rtol}
    if bad:
        raise AssertionError(f"{what}: the streamed masters differ from the "
                             f"resident oracle's beyond {rtol} of the "
                             f"oracle's change: {bad} (all: {gaps})")


def layered_steps(torch, engine, batches):
    """A layered step a batch: (losses, host ms of each, CPU-Adam ms of
    each)."""
    losses, ms, adam_ms = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        ms.append((time.perf_counter() - t0) * 1e3)
        adam_ms.append(engine.last_host_ms)
    return losses, ms, adam_ms


def offload_phase(torch, deepspeed_tpu_torch, gpt2, op_builder, card):
    """Phase 21: ZeRO-3 parameter offload at GPT-2 XL width. Returns the
    ``offload`` line and the main path's launches by kernel row."""
    import dataclasses
    t0 = time.perf_counter()
    cfg = gpt2.PRESETS["gpt2-xl"]
    L = cfg.n_layer
    batch = gpt2.synthetic_batch(ZERO_B, SEQ, cfg.vocab_size, seed=8)
    total, avail = host_ram_gb()
    line = {"card": card, "config": "gpt2-xl bs4 seq1024 bf16 zero3 "
            "offload_param cpu, Adam (host CPU-Adam) lr1e-4",
            "host_ram_gb": {"total": total, "available_at_start": avail}}
    rows = collections.Counter()
    torch.cuda.empty_cache()
    t_init = time.perf_counter()
    engine = layered_engine(deepspeed_tpu_torch, gpt2, cfg, batch)
    line["init_s"] = time.perf_counter() - t_init
    store = engine.store
    if len({id(m) for m in engine._mods}) != 3:
        raise AssertionError("the layered engine keeps one module a layer "
                             "kind: embed, block, head")
    # (a) the oracle: every layer resident, plain autograd, CPU-Adam's rule
    op_builder.reset_launch_counts()
    # a batch of its own each step: a gradient copy that CPU-Adam read a
    # step stale would not show with one batch repeated
    batches = [gpt2.synthetic_batch(ZERO_B, SEQ, cfg.vocab_size, seed=8 + k)
               for k in range(OFFLOAD_STEPS)]
    want, oracle_p0, oracle_final = resident_oracle(torch, engine, batches)
    oracle_counts = dict(op_builder.LAUNCHES)
    check_counts("(a) resident oracle", oracle_counts,
                 {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L},
                 OFFLOAD_STEPS)
    rows.update(oracle_counts)
    # the streamed run: launches zeroed just before, read just after
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    h2d0, d2h0 = store.h2d_bytes, engine.d2h_bytes
    op_builder.reset_launch_counts()
    losses, ms, adam_ms = layered_steps(torch, engine, batches)
    counts = dict(op_builder.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    # (c) the flash forward twice a block (the sweep and the recompute),
    # the backward once; no device Adam (rows 12 and 13)
    check_counts("(c) layered gpt2-xl", counts,
                 {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L},
                 OFFLOAD_STEPS)
    rows.update(counts)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    print(f"offload: streamed losses {losses}, resident oracle {want}, "
          f"max rel diff {rel:.3g}", flush=True)
    if not (all(math.isfinite(x) for x in losses) and rel <= OFFLOAD_RTOL):
        raise AssertionError(f"(a) layered losses {losses} differ from the "
                             f"resident oracle's {want} by {rel} relative "
                             f"(tolerance {OFFLOAD_RTOL})")
    # ... and the masters after the last update, leaf by leaf
    gaps = master_gaps(torch, engine, oracle_p0, oracle_final)
    del oracle_p0, oracle_final
    torch.cuda.empty_cache()
    print(f"offload: master gaps to the resident oracle by leaf (of the "
          f"oracle's change): {json.dumps(gaps, sort_keys=True)}",
          flush=True)
    check_master_gaps(gaps, OFFLOAD_MASTER_RTOL, "(a) layered gpt2-xl")
    layer_bf16 = [sum(math.prod(s) for s in meta) * 2 for meta in store._meta]
    bound = 2 * max(layer_bf16)
    print(f"offload: peak_live_bytes {store.peak_live_bytes / 1e9:.4f} GB "
          f"(bound {bound / 1e9:.4f}, model {sum(layer_bf16) / 1e9:.3f} GB "
          f"bf16); torch.cuda.max_memory_allocated "
          f"{peak / 1e9:.3f} GB", flush=True)
    # (b) two layers at most on the card
    if not (store.peak_live_bytes <= bound and store.live_bytes == 0):
        raise AssertionError(f"(b) peak_live_bytes {store.peak_live_bytes} "
                             f"above 2 layers ({bound})")
    h2d = (store.h2d_bytes - h2d0) / OFFLOAD_STEPS
    d2h = (engine.d2h_bytes - d2h0) / OFFLOAD_STEPS
    # where a streamed step goes: one more step under the profiler (its
    # launches are not the counted run's); the copies run on the two side
    # streams beside the compute stream's kernels
    prof = device_profile(torch, lambda: engine.train_batch(batch))
    by = prof["device_ms_by_group"]
    copy_ms = {k: by.get(k, 0.0) for k in ("memcpy_htod", "memcpy_dtoh")}
    compute_ms = prof["device_busy_ms"] - sum(copy_ms.values())
    prof.update(compute_ms=compute_ms,
                compute_idle_share=1 - compute_ms / prof["wall_ms"],
                cpu_adam_ms=engine.last_host_ms,
                h2d_gb_per_s=h2d / 1e9 / (copy_ms["memcpy_htod"] / 1e3)
                if copy_ms["memcpy_htod"] else None,
                d2h_gb_per_s=d2h / 1e9 / (copy_ms["memcpy_dtoh"] / 1e3)
                if copy_ms["memcpy_dtoh"] else None)
    print(f"offload profile: wall {prof['wall_ms']:.1f} ms, compute "
          f"{compute_ms:.1f} ms, H2D copies {copy_ms['memcpy_htod']:.1f} "
          f"ms, D2H {copy_ms['memcpy_dtoh']:.1f} ms, CPU-Adam "
          f"{engine.last_host_ms:.1f} ms", flush=True)
    line.update({
        "losses": losses, "oracle_losses": want, "max_rel_loss_diff": rel,
        "offload_rtol": OFFLOAD_RTOL, "master_gap_by_leaf": gaps,
        "master_rtol": OFFLOAD_MASTER_RTOL, "step_ms": ms,
        "step_ms_median": statistics.median(ms[1:]),
        "cpu_adam_ms": adam_ms, "h2d_gb_per_step": h2d / 1e9,
        "d2h_gb_per_step": d2h / 1e9,
        "h2d_d2h_gb_per_s_if_serial": (h2d + d2h) / 1e9 / (
            statistics.median(ms[1:]) / 1e3),
        "peak_live_bytes": store.peak_live_bytes,
        "peak_live_bound_2_layers": bound,
        "model_bf16_bytes": sum(layer_bf16),
        "model_fp32_bytes": store.total_param_bytes,
        "peak_mem_gb": peak / 1e9, "n_layers": len(engine._mods),
        "distinct_modules": 3, "launches": counts,
        "launches_oracle": oracle_counts, "profile_step": prof})
    print(f"offload (gpt2-xl): step {line['step_ms_median']:.1f} ms, "
          f"CPU-Adam {adam_ms} ms, H2D {h2d / 1e9:.2f} GB and D2H "
          f"{d2h / 1e9:.2f} GB a step", flush=True)
    del engine, store
    torch.cuda.empty_cache()

    # (d) NVMe against RAM and (e) a resume, at 8 blocks of XL width
    small = dataclasses.replace(cfg, n_layer=OFFLOAD_NVME_LAYERS)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "param_offload")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        op_builder.reset_launch_counts()
        ram = layered_engine(deepspeed_tpu_torch, gpt2, small, batch)
        ram_losses, _, _ = layered_steps(torch, ram, [batch] * 2)
        ram.save_checkpoint(os.path.join(root, "tags"), tag="step2")
        at_save = ram.state_dict()["params"]
        ram_losses += layered_steps(torch, ram, [batch])[0]
        final = ram.state_dict()["params"]
        del ram
        nvme = layered_engine(deepspeed_tpu_torch, gpt2, small, batch,
                              nvme_path=os.path.join(root, "nvme"))
        t_n = time.perf_counter()
        nvme_losses, nvme_ms, nvme_adam = layered_steps(torch, nvme,
                                                        [batch] * 2)
        nvme_params = nvme.state_dict()["params"]
        folder = nvme.store._swap_folder
        nvme.close()
        same = nvme_losses == ram_losses[:2] and all(
            (a == b).all() for la, lb in zip(nvme_params, at_save)
            for a, b in zip(la, lb))
        line["nvme_8_blocks"] = {
            "losses": nvme_losses, "ram_losses": ram_losses[:2],
            "bit_equal_to_ram": bool(same), "step_ms": nvme_ms,
            "adam_and_swap_ms": nvme_adam,
            "s": time.perf_counter() - t_n,
            "swap_folder_removed": not os.path.exists(folder)}
        print(f"offload (d) nvme, 8 blocks: {line['nvme_8_blocks']}",
              flush=True)
        if not same or os.path.exists(folder):
            raise AssertionError(f"(d) NVMe is not bit-equal to RAM, or its "
                                 f"folder was left: {line['nvme_8_blocks']}")
        del nvme, nvme_params
        fresh = layered_engine(deepspeed_tpu_torch, gpt2, small, batch)
        path, _ = fresh.load_checkpoint(os.path.join(root, "tags"))
        tag_bytes = os.path.getsize(path)
        resumed = layered_steps(torch, fresh, [batch])[0]
        same = resumed == ram_losses[2:] and all(
            (a == b).all() for la, lb in zip(fresh.state_dict()["params"],
                                             final) for a, b in zip(la, lb))
        line["resume_8_blocks"] = {"loss": resumed, "want": ram_losses[2:],
                                   "bit_equal": bool(same),
                                   "tag_bytes": tag_bytes}
        print(f"offload (e) resume, 8 blocks: {line['resume_8_blocks']}",
              flush=True)
        if not same:
            raise AssertionError(f"(e) the resumed step is not bit-equal: "
                                 f"{line['resume_8_blocks']}")
        del fresh
        small_counts = dict(op_builder.LAUNCHES)
        n = OFFLOAD_NVME_LAYERS
        check_counts("(d, e) layered 8 blocks", small_counts,
                     {"flash_fwd": 2 * n, "flash_bwd_dq": n,
                      "flash_bwd_dkv": n}, 3 + 2 + 1)
        rows.update(small_counts)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line["launches_by_row"] = dict(rows)
    line["phase_s"] = time.perf_counter() - t0
    print(f"offload: phase 21 took {line['phase_s']:.1f} s", flush=True)
    return line, rows


# phase 22, the data path: bench.py's gpt2-medium row (bench.py:153,
# 340-348) fed as bench.py:444-470 feeds it, initialize(training_data=) ->
# RepeatingLoader(training_dataloader) behind data_prefetch depth 2 with
# 2 I/O workers; Adam's fused form (BENCH_FUSED_OPT=1), so row 12 runs
DATA_STEPS, DATA_SAVE_AT, DATA_WORKERS = 6, 3, 2
# JAX's CurriculumScheduler for fixed_linear 64 -> 1024, difficulty_step
# 8, total_curriculum_step 4, at steps 1-4
# (tests/test_torch_data_engine.py holds the port's schedule to it)
CURRICULUM_LENS = [304, 544, 784, 1024]
CURRICULUM_PARITY_LENS = (72, 200)


class RowDataset:
    """bench.py's ``_RowDataset`` (bench.py:455-467): ``n_batches`` x B
    rows that index a pool of 8 synthetic batches modulo."""
    POOL = 8

    def __init__(self, gpt2, cfg, n_batches):
        self._batches = [gpt2.synthetic_batch(B, SEQ, cfg.vocab_size,
                                              seed=100 + i, device="cpu")
                         for i in range(self.POOL)]
        self._rows = B * n_batches

    def __len__(self):
        return self._rows

    def __getitem__(self, i):
        b, r = divmod(i % (B * self.POOL), B)
        return {k: v[r] for k, v in self._batches[b].items()}


def data_config(prefetch=True, **over):
    """bench.py:340-348 for the gpt2-medium row (bf16, ZeRO 1,
    data_prefetch depth 2) with Adam's fused form."""
    config = {"train_batch_size": B, "train_micro_batch_size_per_gpu": B,
              "steps_per_print": 10 ** 9, "bf16": {"enabled": True},
              "zero_optimization": {"stage": 1},
              "optimizer": {"type": "Adam",
                            "params": {"lr": LR, "fused": True}},
              "data_prefetch": {"enabled": prefetch, "depth": 2}}
    config.update(over)
    return config


def curriculum_block(schedule):
    return {"enabled": True, "min_difficulty": 64, "max_difficulty": SEQ,
            **schedule}


def timed_steps(torch, engine, feed, n):
    """n steps of ``engine.train_batch(**feed())``; (losses,
    synchronised host ms of each)."""
    losses, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = engine.train_batch(**feed())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return losses, ms


def prefetch_threads():
    import threading
    return [t.name for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("ds-prefetch")]


def data_phase(torch, deepspeed_tpu_torch, gpt2, attn_mod, decode,
               fused_adam, op_builder, cfg, card):
    """Phase 22: the data path at GPT-2 medium width. (a) 6 steps through
    the prefetched loader against the same 6 batches pre-placed on the
    card, losses and masters bit-equal; (b) a tag saved with data_iter=
    after step 3 resumes in a fresh engine and loader, steps 4-6
    bit-equal; (c) curriculum fixed_linear 64 -> 1024 over 4 steps, each
    step's length JAX's schedule, rows 1, 3 and 4 24 a step, and a
    2-layer step at S 72 and S 200 on the kernels against the plain
    versions; (d) no pipeline thread after close(). Returns the ``data``
    line and the launches by kernel row."""
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
    from deepspeed_tpu_torch.runtime.prefetch import CudaBatchPlacer
    from deepspeed_tpu_torch.telemetry.metrics import get_registry

    class TimedLoader(RepeatingLoader):
        """A RepeatingLoader that keeps the host ms of each next()."""

        def __init__(self, loader):
            super().__init__(loader)
            self.next_ms = []

        def __next__(self):
            t0 = time.perf_counter()
            try:
                return super().__next__()
            finally:
                self.next_ms.append((time.perf_counter() - t0) * 1e3)

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "data_smoke")
    shutil.rmtree(root, ignore_errors=True)
    rows = collections.Counter()
    L = cfg.n_layer
    step = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "adam": 1}
    # bench.py's epoch outlasts every pull: steps * 8 + 4 batches
    data = RowDataset(gpt2, cfg, 10 * 8 + 4)
    line = {"card": card,
            "config": "gpt2-medium bs8 seq1024 bf16 zero1 adam(fused) "
                      "lr1e-4, data_prefetch depth 2, 2 io workers",
            "dataset_rows": len(data)}

    def count(what, per_step, steps):
        counts = dict(op_builder.LAUNCHES)
        check_counts(what, counts, per_step, steps)
        for k, n in counts.items():
            rows["adam_per_tensor" if k == "adam" else k] += n

    try:
        # (a) the prefetched loader
        reg = get_registry()
        hits = reg.counter("prefetch_hits_total")
        misses = reg.counter("prefetch_misses_total")
        h0, m0 = hits.value, misses.value
        engine, _, loader, _ = deepspeed_tpu_torch.initialize(
            model=gpt2.GPT2LMHeadModel(cfg, seed=0), config=data_config(),
            training_data=data)
        # bench.py:469-470: the row's loader from deepspeed_io with 2 I/O
        # workers (initialize's has one; (b) and (c) feed through it)
        loader = engine.deepspeed_io(data, num_local_io_workers=DATA_WORKERS)
        if not isinstance(loader.place_fn, CudaBatchPlacer) or not \
                isinstance(engine.training_dataloader.place_fn,
                           CudaBatchPlacer):
            raise AssertionError("the device stage is not the copy stream")
        it = TimedLoader(loader)
        feed = lambda: {"data_iter": it}       # noqa: E731
        op_builder.reset_launch_counts()
        losses, ms = timed_steps(torch, engine, feed, DATA_SAVE_AT)
        tag = engine.save_checkpoint(root, tag="data3", data_iter=it)
        more, more_ms = timed_steps(torch, engine, feed,
                                    DATA_STEPS - DATA_SAVE_AT)
        count("(a) prefetched", step, DATA_STEPS)
        losses += more
        ms += more_ms
        state = it.state_dict()
        final = {k: p.detach().clone() for k, p in engine.params.items()}
        prefetched = {
            "losses": losses, "step_ms": ms,
            "step_ms_median_2_6": statistics.median(ms[1:]),
            "hits": hits.value - h0, "misses": misses.value - m0,
            "next_ms": it.next_ms,
            "next_share": sum(it.next_ms) / sum(ms),
            "next_share_2_6": sum(it.next_ms[1:]) / sum(ms[1:]),
            "loader_state": state}
        engine.close()
        del engine, loader, it
        torch.cuda.empty_cache()

        # the pre-placed path (bench.py's BENCH_PREFETCH=0): the same
        # batches, in the plain loader's order, on the card first
        ref, _, plain, _ = deepspeed_tpu_torch.initialize(
            model=gpt2.GPT2LMHeadModel(cfg, seed=0),
            config=data_config(prefetch=False), training_data=data)
        plain_it = RepeatingLoader(plain)
        batches = [{k: v.to("cuda") for k, v in next(plain_it).items()}
                   for _ in range(DATA_STEPS)]
        torch.cuda.synchronize()
        feed_iter = iter(batches)
        op_builder.reset_launch_counts()
        want, want_ms = timed_steps(torch, ref, lambda: {
            "batch": next(feed_iter)}, DATA_STEPS)
        count("(a) pre-placed", step, DATA_STEPS)
        same_masters = all(torch.equal(p, final[k])
                           for k, p in ref.params.items())
        preplaced = {"losses": want, "step_ms": want_ms,
                     "step_ms_median_2_6": statistics.median(want_ms[1:])}
        del ref, plain, plain_it, batches
        torch.cuda.empty_cache()
        line["a_prefetched"] = prefetched
        line["a_preplaced"] = preplaced
        line["a_bit_equal"] = losses == want and same_masters
        print(f"data (a) prefetched: steps {ms} ms (median "
              f"{prefetched['step_ms_median_2_6']:.2f}), hits "
              f"{prefetched['hits']}, misses {prefetched['misses']}, "
              f"next() {prefetched['next_ms']} ms "
              f"({prefetched['next_share']:.5f} "
              f"of the steps' wall, {prefetched['next_share_2_6']:.6f} "
              f"over steps 2-6); "
              f"pre-placed: {want_ms} ms (median "
              f"{preplaced['step_ms_median_2_6']:.2f}); losses {losses}; "
              f"bit-equal {line['a_bit_equal']}", flush=True)
        if not line["a_bit_equal"]:
            raise AssertionError(f"(a) prefetched losses {losses} are not "
                                 f"bit-equal to the pre-placed {want}")
        if state != {"epoch": 0, "batch_in_epoch": DATA_STEPS}:
            raise AssertionError(f"(a) the loader's state {state}")

        # (b) a fresh engine and loader resume from the tag
        fresh, _, fresh_loader, _ = deepspeed_tpu_torch.initialize(
            model=gpt2.GPT2LMHeadModel(cfg, seed=1), config=data_config(),
            training_data=data)
        fresh_it = RepeatingLoader(fresh_loader)
        fresh.load_checkpoint(root, tag="data3", data_iter=fresh_it)
        resumed_state = fresh_it.state_dict()
        op_builder.reset_launch_counts()
        resumed, _ = timed_steps(torch, fresh, lambda: {
            "data_iter": fresh_it}, DATA_STEPS - DATA_SAVE_AT)
        count("(b) resumed", step, DATA_STEPS - DATA_SAVE_AT)
        same = resumed == losses[DATA_SAVE_AT:] and all(
            torch.equal(p, final[k]) for k, p in fresh.params.items())
        line["b_resume"] = {"saved": bool(tag),
                            "loaded_state": resumed_state,
                            "losses": resumed, "bit_equal": same}
        print(f"data (b) resume: {line['b_resume']}", flush=True)
        fresh.close()
        del fresh, fresh_loader, fresh_it, final
        torch.cuda.empty_cache()
        if resumed_state != {"epoch": 0, "batch_in_epoch": DATA_SAVE_AT} \
                or not same:
            raise AssertionError(f"(b) the resume is not bit-equal: "
                                 f"{line['b_resume']}")

        # (c) curriculum: the device stage off, the lengths JAX's
        linear = curriculum_block({
            "schedule_type": "fixed_linear",
            "schedule_config": {"total_curriculum_step": 4,
                                "difficulty_step": 8}})
        cur, _, cur_loader, _ = deepspeed_tpu_torch.initialize(
            model=gpt2.GPT2LMHeadModel(cfg, seed=0),
            config=data_config(curriculum_learning=linear),
            training_data=data)
        if cur_loader.place_fn is not None:
            raise AssertionError("(c) the device stage is on under "
                                 "curriculum learning")
        cur_it = RepeatingLoader(cur_loader)
        lens, cur_losses, cur_ms = [], [], []
        op_builder.reset_launch_counts()
        for _ in CURRICULUM_LENS:
            loss, t = timed_steps(torch, cur, lambda: {"data_iter": cur_it},
                                  1)
            cur_losses += loss
            cur_ms += t
            lens.append(cur.curriculum_scheduler.get_current_difficulty())
        count("(c) curriculum", step, len(CURRICULUM_LENS))
        cur.close()
        del cur, cur_loader, cur_it
        torch.cuda.empty_cache()
        parity = {}
        for S in CURRICULUM_PARITY_LENS:
            at_s = curriculum_block({
                "schedule_type": "fixed_discrete",
                "schedule_config": {"difficulty": [S, SEQ],
                                    "max_step": [1]}})
            parity[f"S{S}"] = one_step_parity(
                torch, deepspeed_tpu_torch, gpt2, attn_mod, decode,
                fused_adam, cfg, data._batches[0],
                config=train_config(sweep=True, batch=B) | {
                    "curriculum_learning": at_s},
                what=f"2-layer curriculum S {S}")
        line["c_curriculum"] = {"lens": lens, "want": CURRICULUM_LENS,
                                "losses": cur_losses, "step_ms": cur_ms,
                                "parity_2layer": parity}
        print(f"data (c) curriculum: lengths {lens}, losses {cur_losses}, "
              f"step ms {cur_ms}", flush=True)
        if lens != CURRICULUM_LENS or not all(
                math.isfinite(x) for x in cur_losses):
            raise AssertionError(f"(c) curriculum lengths {lens}, expected "
                                 f"{CURRICULUM_LENS}; losses {cur_losses}")

        # (d) every pipeline stopped
        alive = prefetch_threads()
        line["d_threads_after_close"] = alive
        if alive:
            raise AssertionError(f"(d) pipeline threads alive after "
                                 f"close(): {alive}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line["launches_by_row"] = dict(rows)
    line["phase_s"] = time.perf_counter() - t_phase
    print(f"data: phase 22 took {line['phase_s']:.1f} s", flush=True)
    return line, rows


# phase 23, the serving observatory and the router: GPT-2 medium with
# phase 16's server configuration (the gather impl replayed as a CUDA
# graph), nothing cut
OBS_WINDOW = 16              # scheduler steps a window of the observatory
ROUTER_PREFIX = 256          # each group's system prompt
ROUTER_GROUP = 16            # requests a group (one warm-up + 15)
OBS_HOOKS = ("record_submit", "on_admit", "on_preempt",
             "on_admission_fail", "record_prefill", "record_decode",
             "record_first_token", "record_finish", "end_step")


def obs_block(tmp, name, **over):
    """A ``serving.observability`` block writing under ``tmp``."""
    return dict({"enabled": True, "window": OBS_WINDOW, "trace_lanes": True,
                 "snapshot_file": os.path.join(tmp, name)}, **over)


@contextlib.contextmanager
def timed_hooks(obs):
    """Host seconds spent inside the observatory's hooks (the scheduler
    holds the same object as its observer, so instance attributes catch
    both call sites)."""
    spent = [0.0]

    def wrap(fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[0] += time.perf_counter() - t0
        return timed

    for name in OBS_HOOKS:
        setattr(obs, name, wrap(getattr(obs, name)))
    try:
        yield spent
    finally:
        for name in OBS_HOOKS:
            delattr(obs, name)


def count_syncs(torch, srv, trace):
    """Synchronizing calls in SERVE_WINDOW steps of pure decode (8
    requests of the trace's first prompts cut to 32 tokens), counted by
    ``torch.cuda.set_sync_debug_mode("warn")``'s warnings (its one-time
    notice that the mode is a prototype is not a call)."""
    import warnings
    from deepspeed_tpu_torch.serving.scheduler import RequestState
    for p, _ in trace[:srv.max_batch]:
        srv.submit(p[:32], max_new_tokens=SERVE_NEW[1])
    while sum(r is not None and r.state is RequestState.RUNNING
              for r in srv.scheduler.slots) < srv.max_batch:
        srv.step()
    srv.step()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(SERVE_WINDOW):
                srv.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    srv.serve_forever()      # drain
    return sum("called a synchronizing cuda operation" in
               str(w.message).lower() for w in seen)


def check_timelines(report, n):
    """Every request's timeline reads queued -> admitted -> first_token
    -> finished in order, with monotonic times."""
    tls = report["timelines"]["recent"]
    if len(tls) != n or report["timelines"]["active"]:
        raise AssertionError(f"serve_obs: {len(tls)} finished timelines, "
                             f"expected {n}")
    for tl in tls:
        names = [e["event"] for e in tl["events"]]
        at = [names.index(k) if k in names else -1 for k in (
            "queued", "admitted", "first_token", "finished")]
        ts = [e["t_ms"] for e in tl["events"]]
        if at[0] != 0 or not 0 < at[1] < at[2] < at[3] or \
                at[3] != len(names) - 1 or ts != sorted(ts):
            raise AssertionError(f"serve_obs: timeline of request "
                                 f"{tl['req_id']} out of order: {names}")


def load_strict(path):
    with open(path) as f:
        return json.load(f, parse_constant=lambda tok: (_ for _ in ()).throw(
            AssertionError(f"{path} carries a bare {tok}")))


def router_trace(np, vocab):
    """Two groups of ROUTER_GROUP requests, each behind its own seeded
    ROUTER_PREFIX-token system prompt (seeds 1 and 2), interleaved; the
    tails and lengths drawn as in :func:`serving_trace`. Returns the
    trace and each request's group."""
    rng = np.random.default_rng(0)
    heads = [np.random.default_rng(s).integers(0, vocab, ROUTER_PREFIX)
             for s in (1, 2)]
    trace, groups = [], []
    for i in range(2 * ROUTER_GROUP):
        p = int(rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))
        g = int(rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1))
        ids = np.concatenate([heads[i % 2], rng.integers(0, vocab, p)])
        trace.append((ids[:SERVE_PROMPT[1]], g))
        groups.append(i % 2)
    return trace, groups


def route_trace(torch, np, router, trace, warm):
    """The warm-up (the requests ``warm``, submitted together, served to
    completion), then the other requests submitted at once and served.
    Returns tokens request by request, each submit's decision and the
    end-to-end numbers of the second part (as :func:`serve_trace`)."""
    times, saved = {}, []
    for ri, srv in enumerate(router.engines):
        deliver = srv._deliver

        def timed(req, tokens, now, deliver=deliver, ri=ri):
            n = deliver(req, tokens, now)
            times.setdefault((ri, req.req_id), []).extend([now] * n)
            return n
        saved.append(deliver)
        srv._deliver = timed
    rest = [i for i in range(len(trace)) if i not in warm]
    rid, decisions, outs = {}, {}, {}

    def submit(idx):
        for i in idx:
            rid[i] = router.submit(trace[i][0], max_new_tokens=trace[i][1])
            decisions[i] = router.last_decision

    def drain():
        for o in router.serve_forever():
            if o.req_id in outs:
                raise AssertionError(f"serve_obs: router id {o.req_id} "
                                     f"collected twice")
            outs[o.req_id] = o

    try:
        submit(warm)
        drain()
        times.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        submit(rest)
        drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for srv, deliver in zip(router.engines, saved):
            srv._deliver = deliver
    if sorted(outs) != list(range(len(trace))) or \
            sorted(rid.values()) != list(range(len(trace))):
        raise AssertionError("serve_obs: router ids not unique or not "
                             "all collected once")
    ttft = [outs[rid[i]].ttft_s * 1e3 for i in rest]
    itl = [(b - a) * 1e3 for ts in times.values()
           for a, b in zip(ts, ts[1:])]
    n_tok = sum(len(outs[rid[i]].tokens) for i in rest)
    return {"tokens": [outs[rid[i]].tokens for i in range(len(trace))],
            "reasons": [outs[rid[i]].finish_reason
                        for i in range(len(trace))],
            "decisions": decisions,
            "metrics": {
                "wall_s": wall, "useful_tokens": n_tok,
                "useful_tokens_per_s": n_tok / wall,
                "ttft_ms_p50": float(np.percentile(ttft, 50)),
                "ttft_ms_p99": float(np.percentile(ttft, 99)),
                "itl_ms_p50": float(np.percentile(itl, 50)),
                "itl_ms_p99": float(np.percentile(itl, 99))}}


def serve_obs_phase(torch, np, deepspeed_tpu_torch, gpt2, op_builder, cfg,
                    card):
    """Phase 23: the serving observatory and ``ServingRouter`` on GPT-2
    medium (see the module docstring). Returns the ``serve_obs`` line and
    the decode-kernel launches of its main-path runs."""
    import tempfile
    import threading
    from deepspeed_tpu_torch.serving import ServingRouter
    from deepspeed_tpu_torch.telemetry import chronicle as chron_mod
    from deepspeed_tpu_torch.telemetry import tracer as tracer_mod
    t_phase = time.perf_counter()
    vocab = cfg.vocab_size
    tmp = tempfile.mkdtemp(prefix="serve_obs_")
    trace = serving_trace(np, vocab)
    eng = deepspeed_tpu_torch.init_inference(gpt2.GPT2LMHeadModel(cfg, seed=0),
                                             dtype=torch.bfloat16)
    line = {"card": card, "config": dict(SERVE_CFG, attention_impl="gather",
                                         model="gpt2-medium",
                                         requests=SERVE_REQUESTS,
                                         prompt=SERVE_PROMPT, new=SERVE_NEW,
                                         obs_window=OBS_WINDOW)}
    counts = collections.Counter()

    def server(**over):
        c = dict(SERVE_CFG, attention_impl="gather", **over)
        srv = deepspeed_tpu_torch.init_serving(engine=eng,
                                               config={"serving": c})
        if srv.compile_stats().get("graph_captures") != 1:
            raise AssertionError(f"serve_obs: {srv.compile_stats()}")
        return srv

    def main_path(srv, tr):
        op_builder.reset_launch_counts()
        res = serve_trace(torch, np, srv, tr)
        launched = dict(op_builder.LAUNCHES)
        counts.update(launched)
        res["metrics"]["launches"] = launched
        if set(launched) != {"decode_attention"}:
            raise AssertionError(f"serve_obs: launches {launched}")
        return res

    try:
        # (a) the observatory on one engine, in turns: off, on (an
        # enabled tracer taking the lanes), on with its hooks timed, off
        off = server()
        runs = {"off": main_path(off, trace)}
        tracer = tracer_mod.Tracer(enabled=True)
        old_tracer = tracer_mod.set_tracer(tracer)
        try:
            on = server(observability=obs_block(tmp, "a.json"))
            runs["on"] = main_path(on, trace)
        finally:
            tracer_mod.set_tracer(old_tracer)
        on2 = server(observability=obs_block(tmp, "a2.json"))
        with timed_hooks(on2.observatory) as spent:
            runs["on_timed"] = main_path(on2, trace)
        runs["off_again"] = main_path(off, trace)
        for name in ("off", "on_timed", "off_again"):
            if runs[name]["tokens"] != runs["on"]["tokens"]:
                raise AssertionError(f"serve_obs: tokens of the {name} run "
                                     f"differ from the observed run's")
        rep = on.serving_report(write=True)
        led = rep["slot_ledger"]
        if led["total_units"] != led["steps"] * SERVE_CFG["max_batch"] * 1 \
                or sum(led["units"].values()) != led["total_units"] or \
                led["units"]["decode_useful"] != sum(
                    len(t) for t in runs["on"]["tokens"]):
            raise AssertionError(f"serve_obs: slot ledger {led}")
        check_timelines(rep, SERVE_REQUESTS)
        snap = load_strict(on.observatory.snapshot_path)
        if snap["schema"] != "deepspeed_tpu.serving_health/3":
            raise AssertionError(f"serve_obs: schema {snap['schema']}")
        lanes = [e for e in tracer.events()
                 if 0 <= e.get("tid", 0) - tracer_mod._LANE_TID_BASE < 1000]
        syncs = {"on": count_syncs(torch, server(observability=obs_block(
            tmp, "sync.json")), trace), "off": count_syncs(torch, server(),
                                                           trace)}
        if syncs["on"] != syncs["off"] or syncs["on"] == 0:
            raise AssertionError(f"serve_obs: synchronizing calls {syncs}")
        steps = on2.observatory.steps_seen
        tps = {k: v["metrics"]["useful_tokens_per_s"] for k, v in runs.items()}
        line["observatory"] = {
            "useful_tokens_per_s": tps,
            "on_vs_off": (tps["on"] + tps["on_timed"])
            / (tps["off"] + tps["off_again"]) - 1,
            "obs_host_ms_per_step": spent[0] * 1e3 / steps,
            "steps": steps, "wasted_fraction": led["wasted_frac"],
            "slot_ledger_units": led["units"], "ledger_steps": led["steps"],
            "verdict": rep["verdict"],
            "anomaly_counts": rep["counters"]["anomaly_counts"],
            "lane_events": len(lanes),
            "syncs_in_16_decode_steps": syncs,
            "runs": {k: v["metrics"] for k, v in runs.items()}}
        print(f"serve_obs (a): {json.dumps(line['observatory'])}",
              flush=True)
        del on, off, on2
        torch.cuda.empty_cache()

        # (b) preemption under the observatory: phase 16's undersized pool
        pre = server(num_blocks=SERVE_PREEMPT_BLOCKS,
                     observability=obs_block(tmp, "b.json",
                                             warmup_windows=0,
                                             preemption_thrash=1))
        # the process registry's counter also holds phase 16's runs
        burned = -pre.registry.counter("serving_recompute_tokens_total").value
        res = main_path(pre, trace)
        rep = pre.serving_report()
        burned += pre.registry.counter("serving_recompute_tokens_total").value
        if pre.scheduler.preemptions_total == 0 or \
                rep["counters"]["preemptions_by_reason"] != \
                dict(pre.scheduler.preemptions_by_reason) or \
                rep["counters"]["recompute_tokens"] != burned:
            raise AssertionError(f"serve_obs: preemption counters "
                                 f"{rep['counters']} against the server's "
                                 f"{dict(pre.scheduler.preemptions_by_reason)}"
                                 f", {burned} recompute tokens")
        before = pre.observatory._snapshots_written
        pre.close()
        if pre.observatory._snapshots_written != before + 1:
            raise AssertionError("serve_obs: close() wrote no snapshot")
        closed = load_strict(pre.observatory.snapshot_path)
        line["preemption"] = {
            "preemptions_by_reason": rep["counters"]["preemptions_by_reason"],
            "recompute_tokens": rep["counters"]["recompute_tokens"],
            "anomaly_counts": closed["counters"]["anomaly_counts"],
            "wasted_fraction": rep["slot_ledger"]["wasted_frac"],
            "slot_ledger_units": rep["slot_ledger"]["units"],
            "metrics": res["metrics"]}
        print(f"serve_obs (b): {json.dumps(line['preemption'])}", flush=True)
        del pre
        torch.cuda.empty_cache()

        # (c) + (d): two replicas behind the router, a chronicle armed
        rtrace, groups = router_trace(np, vocab)
        warm = [groups.index(0), groups.index(1)]
        ch = chron_mod.RunChronicle(run_dir=os.path.join(tmp, "chronicle"))
        old_chron = chron_mod.set_chronicle(ch)
        try:
            reps = [server(prefix_cache={"enabled": True},
                           observability=obs_block(
                               tmp, f"replica{i}.json", ttft_slo_ms=1e9,
                               trace_lanes=False))
                    for i in range(2)]
            router = ServingRouter(reps)
            op_builder.reset_launch_counts()
            routed = route_trace(torch, np, router, rtrace, warm)
            launched = dict(op_builder.LAUNCHES)
        finally:
            chron_mod.set_chronicle(old_chron)
            ch.close()
        counts.update(launched)
        fired = [a["rule"] for r in reps for a in r.observatory.anomalies]
        if {"ttft_slo_breach", "queue_growth"} & set(fired):
            raise AssertionError(f"serve_obs: SLO rules fired: {fired}")
        if sorted(routed["decisions"][i].replica for i in warm) != [0, 1]:
            raise AssertionError("serve_obs: the warm-up requests share a "
                                 "replica")
        home = {groups[i]: routed["decisions"][i].replica for i in warm}
        for i, d in routed["decisions"].items():
            if i in warm:
                continue
            want = ROUTER_PREFIX // SERVE_CFG["block_size"]
            if d.replica != home[groups[i]] or d.affinity_blocks != want:
                raise AssertionError(
                    f"serve_obs: request {i} of group {groups[i]} went to "
                    f"replica {d.replica} with {d.affinity_blocks} affinity "
                    f"blocks (its prefix is on {home[groups[i]]})")
        # the same requests through one engine, in the same order
        single = server(prefix_cache={"enabled": True})
        alone = ServingRouter([single])
        op_builder.reset_launch_counts()
        one = route_trace(torch, np, alone, rtrace, warm)
        counts.update(op_builder.LAUNCHES)
        del alone, single
        gaps = []
        if one["tokens"] != routed["tokens"]:
            model32 = gpt2.GPT2LMHeadModel(cfg, seed=0)
            deepspeed_tpu_torch.init_inference(model32, dtype=torch.float32)
            gaps = compare_runs(torch, model32, rtrace, one, routed,
                                "router vs one engine", vocab)
            del model32
        stats = router.stats()
        line["router"] = {
            "routed_by_replica": list(router.routed_by_replica),
            "prefix_hits_by_replica": [
                r["prefix_cache"]["hits"] for r in stats["replicas"]],
            "prefix_stats": [r["prefix_cache"] for r in stats["replicas"]],
            "affinity_blocks": sorted({d.affinity_blocks for d in
                                       routed["decisions"].values()}),
            "equal_requests_vs_one_engine": sum(
                a == b for a, b in zip(one["tokens"], routed["tokens"])),
            "near_tie_gaps": gaps,
            "metrics": routed["metrics"],
            "one_engine_metrics": one["metrics"],
            "anomalies": fired}
        print(f"serve_obs (c): {json.dumps(line['router'])}", flush=True)
        rep = ch.report()
        json.dumps(rep, allow_nan=False)
        n_router = sum(e["source"] == "router" for e in rep["events"])
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith("ds-chronicle")]
        if n_router != len(rtrace) or alive or ch._wthread.is_alive() or \
                chron_mod.get_chronicle().enabled:
            raise AssertionError(f"serve_obs: {n_router} router events, "
                                 f"writer threads {alive}, global "
                                 f"{chron_mod.get_chronicle().enabled}")
        line["chronicle"] = {"n_events": rep["n_events"],
                             "counts_by_source": rep["counts_by_source"],
                             "router_events": n_router}
        router.close()
        del router, reps
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del eng
        torch.cuda.empty_cache()
    line["launches_by_row"] = dict(counts)
    line["phase_s"] = time.perf_counter() - t_phase
    print(f"serve_obs: phase 23 took {line['phase_s']:.1f} s", flush=True)
    return line, dict(counts)



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
    script_t0 = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import dataclasses

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
                                                     ring, transformer)
    from deepspeed_tpu_torch.runtime import dropout
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

    # 15. the training loop users write (forward / backward / step) with
    # dropout 0.1 and remat: GPT-2 medium at gas 2, BERT-large
    loop_line, loop_counts = loop_phase(
        torch, deepspeed_tpu_torch, gpt2, bert, dropout, op_builder, cfg,
        bert_cfg, card)

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
    for name, n in loop_counts.items():
        launches[name] += n
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
        "int8_generate": int8_counts.get("flash_fwd", 0),
        "loop": loop_counts.get("flash_fwd", 0)}
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

    # 16. continuous-batching serving on GPT-2 medium. Last: run before
    # the kernel timings, its profiled windows of graph replays were
    # followed by a profiler session that recorded no kernel of the
    # ctypes library, so it runs after every kernel timing; its decode
    # launches join the decode rows' main-path counts
    serving_line, serving_counts = serving_phase(
        torch, np, deepspeed_tpu_torch, gpt2, decode, op_builder, cfg, card)
    for row in rows:
        if row["name"] in ("decode_attention", "decode_attention_int8"):
            row["launches_by_path"] = {
                "generate": gen_launches.get(row["name"], 0),
                "int8_generate": int8_counts.get(row["name"], 0),
                "serving": serving_counts.get(row["name"], 0)}
            row["launches"] += serving_counts.get(row["name"], 0)

    # 17. checkpoints: GPT-2 medium and BERT-large resume bit-equal, the
    # async save overlapped with steps, then load -> serve
    ckpt_line, ckpt_counts = checkpoint_phase(
        torch, deepspeed_tpu_torch, gpt2, bert, op_builder, cfg, bert_cfg,
        card, med)
    for row in rows:
        row["launches"] += ckpt_counts.get(row["name"], 0)
    ckpt_line["launches_by_row"] = dict(ckpt_counts)

    # 18. data parallelism at world size 1 over NCCL: bit-equal to no
    # process group; a checkpoint under tag validation; the lse gradient;
    # ring and Ulysses
    dp_line, dp_counts = dp_phase(
        torch, deepspeed_tpu_torch, gpt2, bert, flash, ring, op_builder,
        cfg, bert_cfg, card, med, bert_med)
    for row in rows:
        row["launches"] += dp_counts.get(row["name"], 0)
    dp_line["launches_by_row"] = dict(dp_counts)

    # 19. MoE-GPT (bench.py's gpt2-moe row): training, the dispatch
    # impls, top-2, a resume, generation from the tag, world 1 over NCCL
    moe_line, moe_counts = moe_phase(
        torch, deepspeed_tpu_torch, gpt2, attn_mod, decode, fused_adam,
        op_builder, card)
    for row in rows:
        row["launches"] += moe_counts.get(row["name"], 0)
    moe_line["launches_by_row"] = dict(moe_counts)

    # 20. ZeRO stages 2 and 3 and the optimizer offload at GPT-2 XL
    # width (bench.py's gpt2-xl row); NVMe offload at GPT-2 medium
    zero_line, zero_counts = zero_phase(torch, deepspeed_tpu_torch, gpt2,
                                        bert, op_builder, card, bert_cfg,
                                        bert_batch)
    for row in rows:
        row["launches"] += zero_counts.get(row["name"], 0)
    zero_line["launches_by_row"] = dict(zero_counts)

    # 21. ZeRO-3 parameter offload: GPT-2 XL streamed a layer at a time
    # from host RAM against the resident oracle; NVMe and a resume at 8
    # blocks of XL width
    offload_line, offload_counts = offload_phase(
        torch, deepspeed_tpu_torch, gpt2, op_builder, card)
    for row in rows:
        row["launches"] += offload_counts.get(row["name"], 0)
    offload_line["script_s"] = time.perf_counter() - script_t0

    # 22. the data path: bench.py's gpt2-medium row through
    # initialize(training_data=) / deepspeed_io, the prefetch pipeline's
    # copy-stream device stage, a resume, curriculum learning
    data_line, data_counts = data_phase(
        torch, deepspeed_tpu_torch, gpt2, attn_mod, decode, fused_adam,
        op_builder, cfg, card)
    for row in rows:
        row["launches"] += data_counts.get(row["name"], 0)
    data_line["script_s"] = time.perf_counter() - script_t0

    # 23. the serving observatory on phase 16's server, preemption under
    # it, ServingRouter over two replicas on the card, the run chronicle
    serve_obs_line, serve_obs_counts = serve_obs_phase(
        torch, np, deepspeed_tpu_torch, gpt2, op_builder, cfg, card)
    for row in rows:
        n = serve_obs_counts.get(row["name"], 0)
        row["launches"] += n
        if n:
            row.setdefault("launches_by_path", {})["serve_obs"] = n
    serve_obs_line["script_s"] = time.perf_counter() - script_t0

    print(json.dumps({"e2e": e2e}))
    print(json.dumps({"train": train}))
    print(json.dumps({"bert": bert_line}))
    print(json.dumps({"moq": moq_line}))
    print(json.dumps({"int8": int8_line}))
    print(json.dumps({"sparse": sparse_line}))
    print(json.dumps({"loop": loop_line}))
    print(json.dumps({"serving": serving_line}))
    print(json.dumps({"ckpt": ckpt_line}))
    print(json.dumps({"dp": dp_line}))
    print(json.dumps({"moe": moe_line}))
    print(json.dumps({"zero": zero_line}))
    print(json.dumps({"offload": offload_line}))
    print(json.dumps({"data": data_line}))
    print(json.dumps({"serve_obs": serve_obs_line}))
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
