"""Does the serving observatory's cost grow with the size of the Python
process? ``chip_smoke.py`` phase 23 (a)'s four runs on one card — phase
16's GPT-2 medium server (bf16, the gather impl replayed as a CUDA
graph) on phase 16's 32-request trace: unobserved, observed with an
enabled tracer taking the lanes, observed, unobserved — three times: in
a fresh process, beside 4 M long-lived dicts (a heap like the one the
whole script holds by phase 23), and after ``gc.freeze()`` of that heap.
Per run: useful tokens/s, the garbage collector's collections by
generation and the ms spent in them (``gc.callbacks``). Needs one NVIDIA
card::

    python tests/perf/torch_serve_obs_gc_probe.py
"""
import gc
import json
import os
import sys
import tempfile
import time


def main():
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.telemetry import tracer as tracer_mod
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    op_builder.load_kernels()
    print(f"card: {cs.card_line()}", flush=True)
    cfg = gpt2.PRESETS["gpt2-medium"]
    eng = deepspeed_tpu_torch.init_inference(
        gpt2.GPT2LMHeadModel(cfg, seed=0), dtype=torch.bfloat16)
    trace = cs.serving_trace(np, cfg.vocab_size)
    tmp = tempfile.mkdtemp()
    stats = {"n": [0, 0, 0], "s": 0.0, "t0": 0.0}

    def on_gc(phase, info):
        if phase == "start":
            stats["t0"] = time.perf_counter()
        else:
            stats["n"][info["generation"]] += 1
            stats["s"] += time.perf_counter() - stats["t0"]

    gc.callbacks.append(on_gc)

    def server(**over):
        c = dict(cs.SERVE_CFG, attention_impl="gather", **over)
        return deepspeed_tpu_torch.init_serving(engine=eng,
                                                config={"serving": c})

    def run(srv, tracer=False):
        stats["n"], stats["s"] = [0, 0, 0], 0.0
        old = tracer_mod.set_tracer(tracer_mod.Tracer(enabled=True)) \
            if tracer else None
        try:
            m = cs.serve_trace(torch, np, srv, trace)["metrics"]
        finally:
            if tracer:
                tracer_mod.set_tracer(old)
        return {"tok_s": m["useful_tokens_per_s"],
                "gc_collections": list(stats["n"]),
                "gc_ms": stats["s"] * 1e3}

    def four(label):
        off = server()
        on = server(observability=cs.obs_block(tmp, "a.json"))
        on2 = server(observability=cs.obs_block(tmp, "b.json"))
        out = {"off": run(off), "on_tracer": run(on, tracer=True),
               "on": run(on2), "off_again": run(off)}
        print(label, json.dumps(out), flush=True)

    four("small heap")
    heap = [{"i": i, "s": str(i)} for i in range(4_000_000)]
    four("4M-dict heap")
    gc.freeze()
    four("4M-dict heap, gc.freeze()")
    del heap
    return 0


if __name__ == "__main__":
    sys.exit(main())
