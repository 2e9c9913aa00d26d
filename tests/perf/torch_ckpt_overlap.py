"""What an async checkpoint costs the steps that run beside its persist,
on one card: GPT-2 medium in ``chip_smoke.py`` phase 6's configuration
(bf16 over fp32 masters, ZeRO 1, Adam ``sweep``, clip 1.0, bs 8 × 1024).

After a sync save (which also allocates the pinned snapshot buffers),
each variant takes an async save and then steps until its persist ends
(at least 3, at most ``--max-steps``), timing each step (synchronised
host ms, with its start's offset from the save). Beside them a probe
thread sleeps 1 ms at a time and records every wake-up later than 20 ms
(the GIL, or the host, held elsewhere), and the persist's file writes
and fsyncs are recorded with their offsets. Variants:

* ``p5``: the port's ``dump_file`` (pickle protocol 5: an array's bytes
  go from its buffer to the file);
* ``p4``: the same with protocol 4 (the JAX writer's default: each array
  first copied into a bytes object);
* ``p5_nofsync``: protocol 5 with ``os.fsync`` skipped;
* ``sleep``: the persist replaced by a sleep of the ``p5`` persist's
  length (no I/O, no GIL held).

``--variants`` runs them in the order given (repeats allowed). With each
variant the machine's memory and I/O pressure (``/proc/pressure``, where
the kernel has it: the share of time some task stalled, over the
variant) and ``/proc/meminfo``'s Dirty and Writeback are recorded.
Each tag (about 5.7 GB) lies under ``build/ckpt_overlap`` and is deleted
after its variant. Needs one NVIDIA H100::

    python tests/perf/torch_ckpt_overlap.py [--max-steps 80]
        [--variants p5,p4,p5_nofsync,sleep]
"""
import argparse
import json
import os
import pickle
import shutil
import statistics
import sys
import threading
import time
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
from chip_smoke import B, SEQ, card_line, train_config  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.models import gpt2  # noqa: E402
from deepspeed_tpu_torch.runtime import checkpoint_io  # noqa: E402

TAG_DIR = os.path.join(ROOT, "build", "ckpt_overlap")


class Probe:
    """Wake-ups of a 1 ms sleep loop later than ``late_s``."""

    def __init__(self, t0, late_s=0.02):
        self.t0, self.late_s = t0, late_s
        self.late, self.stop = [], threading.Event()
        self.thread = threading.Thread(target=self.run, daemon=True)

    def run(self):
        while not self.stop.is_set():
            t = time.perf_counter()
            time.sleep(0.001)
            over = time.perf_counter() - t - 0.001
            if over > self.late_s:
                self.late.append((round(t - self.t0, 3),
                                  round(over * 1e3, 1)))

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()


def pressure():
    """``{"memory": µs, "io": µs}``: the kernel's cumulative time some
    task stalled on memory and on I/O, and Dirty / Writeback kB."""
    out = {}
    for what in ("memory", "io"):
        try:
            with open(f"/proc/pressure/{what}") as f:
                out[what] = int(f.readline().split("total=")[1])
        except (OSError, IndexError, ValueError):
            out[what] = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                key = line.split(":")[0]
                if key in ("Dirty", "Writeback"):
                    out[key + "_kb"] = int(line.split()[1])
    except OSError:
        pass
    return out


def recorded(events, t0, what, fn):
    def run(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            events.append((what, round(t - t0, 3),
                           round((time.perf_counter() - t) * 1e3, 1)))
    return run


def variant(name, engine, batch, max_steps, sleep_s=None):
    events = []
    saved = (checkpoint_io.dump_file, checkpoint_io.pickle, os.fsync,
             engine._persist_checkpoint)
    t0 = time.perf_counter()
    checkpoint_io.dump_file = recorded(
        events, t0, "dump", checkpoint_io.dump_file)
    fsync = os.fsync
    os.fsync = recorded(events, t0, "fsync", fsync)
    if name == "p4":
        checkpoint_io.pickle = types.SimpleNamespace(
            dump=lambda obj, f, protocol=None: pickle.dump(obj, f,
                                                           protocol=4),
            load=pickle.load)
    if name == "p5_nofsync":
        os.fsync = recorded(events, t0, "fsync(skipped)", lambda fd: None)
    persist_ms = {}

    def persist(*args):
        t = time.perf_counter()
        if sleep_s is not None:
            time.sleep(sleep_s)
        else:
            saved[3](*args)
        persist_ms["ms"] = (time.perf_counter() - t) * 1e3

    engine._persist_checkpoint = persist
    steps, before = [], pressure()
    try:
        with Probe(t0) as probe:
            torch.cuda.synchronize()
            t0 = probe.t0 = time.perf_counter()
            engine.save_checkpoint(TAG_DIR, tag=name)
            snapshot_ms = (time.perf_counter() - t0) * 1e3
            while len(steps) < max_steps and (
                    len(steps) < 3 or engine._ckpt_writer.in_flight):
                torch.cuda.synchronize()
                t = time.perf_counter()
                engine.train_batch(batch=batch)
                torch.cuda.synchronize()
                steps.append((round(t - t0, 3),
                              round((time.perf_counter() - t) * 1e3, 1)))
            engine._ckpt_writer.drain()
        after = pressure()
    finally:
        (checkpoint_io.dump_file, checkpoint_io.pickle, os.fsync,
         engine._persist_checkpoint) = saved
        shutil.rmtree(os.path.join(TAG_DIR, name), ignore_errors=True)
    ms = [s[1] for s in steps]
    stalled = {f"{k}_stall_ms": (after[k] - before[k]) / 1e3
               for k in ("memory", "io") if before.get(k) is not None}
    return {"variant": name, "snapshot_ms": snapshot_ms, **stalled,
            "meminfo_after": {k: v for k, v in after.items()
                              if k.endswith("_kb")},
            "persist_ms": persist_ms["ms"], "steps": steps,
            "first_step_ms": ms[0], "median_step_ms": statistics.median(ms),
            "late_wakeups": probe.late[:40],
            "late_wakeup_max_ms": max([x[1] for x in probe.late],
                                      default=0.0),
            "persist_events": events}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-steps", type=int, default=80)
    ap.add_argument("--variants", default="p5,p4,p5_nofsync,sleep")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    cfg = gpt2.PRESETS["gpt2-medium"]
    config = dict(train_config(sweep=True),
                  checkpoint={"async_save": True})
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2.GPT2LMHeadModel(cfg, seed=0), config=config)
    batch = gpt2.synthetic_batch(B, SEQ, cfg.vocab_size, seed=4)
    base = []
    for _ in range(8):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        base.append((time.perf_counter() - t) * 1e3)
    shutil.rmtree(TAG_DIR, ignore_errors=True)
    os.makedirs(TAG_DIR)
    try:
        engine._ckpt_async = False
        t = time.perf_counter()
        engine.save_checkpoint(TAG_DIR, tag="first")   # pinned buffers
        first_ms = (time.perf_counter() - t) * 1e3
        shutil.rmtree(os.path.join(TAG_DIR, "first"))
        engine._ckpt_async = True
        rows = []
        for name in args.variants.split(","):
            sleep_s = rows[0]["persist_ms"] / 1e3 if name == "sleep" \
                else None
            row = variant(name, engine, batch, args.max_steps, sleep_s)
            rows.append(row)
            print(json.dumps(row), flush=True)
            print(f"{name}: snapshot {row['snapshot_ms']:.0f} ms, persist "
                  f"{row['persist_ms']:.0f} ms, {len(row['steps'])} steps "
                  f"beside it: first {row['first_step_ms']:.0f} ms, median "
                  f"{row['median_step_ms']:.1f} ms; latest probe wake-up "
                  f"{row['late_wakeup_max_ms']:.0f} ms late; stalled on "
                  f"memory {row.get('memory_stall_ms')} ms, on I/O "
                  f"{row.get('io_stall_ms')} ms", flush=True)
    finally:
        shutil.rmtree(TAG_DIR, ignore_errors=True)
    print(json.dumps({"ckpt_overlap": {
        "card": card, "step_ms_without_save": base[2:],
        "step_ms_median_without_save": statistics.median(base[2:]),
        "first_sync_save_ms": first_ms,
        "variants": [{k: r.get(k) for k in (
            "variant", "snapshot_ms", "persist_ms", "first_step_ms",
            "median_step_ms", "late_wakeup_max_ms", "memory_stall_ms",
            "io_stall_ms")} for r in rows]}}))


if __name__ == "__main__":
    main()
