"""Serving subsystem tests of the port (the cases of
tests/unit/test_serving.py, on ``deepspeed_tpu_torch.serving``).

Host-side invariants run with no device work (the scheduler and
allocator are pure bookkeeping): FCFS admission order,
preemption-by-eviction victim choice and re-queue position, allocator
no-leak / no-double-free under churn. The end-to-end tests drive the
port's ServingEngine over a tiny GPT-2 on the CPU and pin greedy parity
with the port's own batch-synchronous ``generate()`` across a
heterogeneous request mix, mask correctness when requests finish
mid-batch, parity under forced eviction, exactly one decode and one
prefill signature for the whole trace, and the serving metrics in the
registry. (The JAX reference's checkpoint-load telemetry case belongs to
``InferenceEngine`` checkpoint loading, which the port does not run
yet.)
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfigError,
                                                DeepSpeedServingConfig)
from deepspeed_tpu_torch.serving.kv_cache import (BlockAllocator,
                                                  BlockAllocatorError,
                                                  PagedKVCache)
from deepspeed_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler, Request, RequestState)
from deepspeed_tpu_torch.serving.server import ServingEngine
from deepspeed_tpu_torch.telemetry.metrics import MetricsRegistry
from tests.torch_threads import one_torch_thread  # noqa: F401


# ------------------------------------------------------- block allocator
def test_allocator_basic_and_all_or_nothing():
    a = BlockAllocator(8)                      # 7 usable, block 0 reserved
    assert a.num_usable == 7
    got = a.allocate(3)
    assert len(got) == 3 and 0 not in got
    assert a.allocate(5) is None               # all-or-nothing: only 4 left
    assert a.num_free == 4
    assert a.allocate(4) is not None
    assert a.occupancy() == 1.0
    a.check_consistency()


def test_allocator_double_free_and_foreign_free_raise():
    a = BlockAllocator(6)
    blocks = a.allocate(2)
    a.free(blocks)
    with pytest.raises(BlockAllocatorError):
        a.free(blocks)                          # double-free
    with pytest.raises(BlockAllocatorError):
        a.free([a.num_blocks + 5])              # foreign id
    a.check_consistency()


def test_allocator_no_leak_under_churn():
    rng = np.random.default_rng(0)
    a = BlockAllocator(33)
    live = []
    for _ in range(500):
        if live and rng.random() < 0.45:
            a.free(live.pop(rng.integers(len(live))))
        else:
            got = a.allocate(int(rng.integers(1, 5)))
            if got is not None:
                live.append(got)
        a.check_consistency()
    for b in live:
        a.free(b)
    a.check_consistency()
    assert a.num_free == a.num_usable and a.num_allocated == 0


# ------------------------------------------------------------- scheduler
def _host_cache(num_blocks=9, block_size=4):
    """PagedKVCache used purely for its allocator/blocks_for host logic."""
    return PagedKVCache(n_layer=1, n_head=1, head_dim=4,
                        block_size=block_size, num_blocks=num_blocks)


def _req(i, prompt_len, max_new=4, **kw):
    return Request(req_id=i, prompt=list(range(1, prompt_len + 1)),
                   max_new_tokens=max_new, **kw)


def test_admission_is_strict_fcfs():
    cache = _host_cache(num_blocks=9, block_size=4)    # 8 usable blocks
    sched = ContinuousBatchingScheduler(cache, max_batch=2,
                                        max_model_len=32)
    for i, plen in enumerate((8, 4, 4, 4)):
        sched.submit(_req(i, plen))
    sched.schedule()
    # exactly the first two requests, in submit order, slot order
    assert [r.req_id for r in sched.slots] == [0, 1]
    assert [r.req_id for r in sched.waiting] == [2, 3]


def test_blocked_head_blocks_the_tail():
    cache = _host_cache(num_blocks=9, block_size=4)    # 8 usable
    sched = ContinuousBatchingScheduler(cache, max_batch=3,
                                        max_model_len=32)
    sched.submit(_req(0, 20))     # 5 blocks
    sched.submit(_req(1, 20))     # 5 blocks -> does not fit behind req 0
    sched.submit(_req(2, 4))      # 1 block — WOULD fit, must still wait
    sched.schedule()
    assert [r.req_id for r in sched.slots if r is not None] == [0]
    assert [r.req_id for r in sched.waiting] == [1, 2], \
        "FCFS: a blocked head must not be overtaken by a smaller request"


def test_preemption_evicts_latest_and_requeues_front():
    cache = _host_cache(num_blocks=9, block_size=4)    # 8 usable
    sched = ContinuousBatchingScheduler(cache, max_batch=2,
                                        max_model_len=64)
    sched.submit(_req(0, 12, max_new=40))   # 3 blocks
    sched.submit(_req(1, 12, max_new=40))   # 3 blocks
    plan = sched.schedule()
    assert plan.prefill is not None
    r0, r1 = sched.slots
    # simulate both being decode-ready and r0 filling the pool
    for r in (r0, r1):
        r.state = RequestState.RUNNING
        r.cached_len = 12
    extra = sched.allocator.allocate(2)      # pool now dry
    r0.block_table.extend(extra)
    r0.cached_len = 20                        # next write needs block 6
    plan = sched.schedule()
    # r1 (latest admitted) was evicted so r0 could grow
    assert sched.preemptions_total == 1
    assert r1.state is RequestState.WAITING and r1.slot is None
    assert not r1.block_table and r1.cached_len == 0
    assert sched.waiting[0] is r1, "victim re-queues at the FRONT"
    assert plan.decode_slots == [0]
    sched.allocator.check_consistency()


def test_self_preemption_when_alone():
    cache = _host_cache(num_blocks=3, block_size=4)    # 2 usable
    sched = ContinuousBatchingScheduler(cache, max_batch=1,
                                        max_model_len=64)
    sched.submit(_req(0, 8, max_new=40))     # exactly 2 blocks
    sched.schedule()
    r0 = sched.slots[0]
    r0.state = RequestState.RUNNING
    r0.cached_len = 8                         # next write needs block 3
    plan = sched.schedule()
    assert plan.decode_slots == []
    assert r0.state is RequestState.WAITING and r0.preemptions == 1
    sched.allocator.check_consistency()
    assert sched.allocator.num_allocated == 0


def test_decode_plan_excludes_slots_preempted_by_later_growth():
    """Slot reuse can put the NEWEST request in a LOW slot index; when a
    later (older) slot's block growth evicts it, the decode plan must
    not name the emptied slot (a one-pass append crashed the server)."""
    cache = _host_cache(num_blocks=3, block_size=4)    # 2 usable
    sched = ContinuousBatchingScheduler(cache, max_batch=2,
                                        max_model_len=32)
    sched.submit(_req(0, 4, max_new=20))
    sched.submit(_req(1, 4, max_new=20))
    sched.schedule()
    r0, r1 = sched.slots
    sched.finish(r0, "max_tokens")          # slot 0 frees
    sched.submit(_req(2, 1, max_new=20))    # re-admits into slot 0
    sched.schedule()
    r2 = sched.slots[0]
    assert r2.req_id == 2 and r2.admit_seq > r1.admit_seq
    # r1 (older, slot 1) now needs a block with the pool dry and its own
    # capacity exhausted -> r2 (newest, slot 0) is evicted mid-pass
    r1.state = RequestState.RUNNING
    r1.cached_len = 4
    plan = sched.schedule()
    assert sched.slots[0] is None and r2.state is RequestState.WAITING
    assert plan.decode_slots == [1], (
        "decode plan must only name slots that survived capacity growth")
    sched.allocator.check_consistency()


def test_prefill_plan_excludes_preempted_victim():
    """A PREFILL-state request evicted during capacity growth must not
    appear in the same iteration's prefill plan (the server would run a
    chunk for a request sitting in the waiting queue)."""
    cache = _host_cache(num_blocks=4, block_size=4)    # 3 usable
    sched = ContinuousBatchingScheduler(cache, max_batch=2,
                                        max_model_len=32)
    sched.submit(_req(0, 4, max_new=20))
    sched.schedule()
    r0 = sched.slots[0]
    r0.state = RequestState.RUNNING
    r0.cached_len = 4                        # owned capacity exhausted
    sched.submit(_req(1, 8, max_new=4))      # takes the last 2 blocks
    plan = sched.schedule()
    r1 = [r for r in (sched.slots + list(sched.waiting))
          if r is not None and r.req_id == 1][0]
    assert r1.state is RequestState.WAITING, "victim must be evicted"
    assert plan.prefill == [], (
        "evicted prefill victim must not be in the prefill plan")
    assert plan.decode_slots == [0]
    sched.allocator.check_consistency()


def test_budget_shrinks_to_owned_capacity_before_self_eviction():
    """A lone request that owns the whole pool must keep emitting tokens
    from the capacity it has (budget shrink), not self-evict into an
    admission/eviction livelock."""
    cache = _host_cache(num_blocks=3, block_size=4)    # 2 usable
    sched = ContinuousBatchingScheduler(cache, max_batch=1,
                                        max_model_len=32, decode_steps=8)
    sched.submit(_req(0, 4, max_new=20))
    sched.schedule()
    r0 = sched.slots[0]
    r0.state = RequestState.RUNNING
    r0.cached_len = 5                        # 3 tokens of owned capacity
    plan = sched.schedule()                  # pool dry after growth
    assert plan.decode_slots == [0]
    assert r0.step_budget == 3, "budget must shrink to owned capacity"
    assert r0.preemptions == 0


def test_infeasible_requests_fail_instead_of_livelock():
    # a prompt that can never fit is rejected at submit
    cache = _host_cache(num_blocks=3, block_size=4)    # 2 usable = 8 pos
    sched = ContinuousBatchingScheduler(cache, max_batch=1,
                                        max_model_len=32)
    with pytest.raises(ValueError):
        sched.submit(_req(0, 12))
    # a (resumed) request whose prompt+generated outgrew the pool fails
    # at admission with reason 'capacity' instead of blocking the head
    req = _req(1, 4, max_new=30)
    req.output_tokens = list(range(9))       # full_prompt = 13 > 8 pos
    sched.submit(req)
    sched.schedule()
    assert not sched.waiting and sched.slots == [None]
    assert [r.req_id for r in sched.failed] == [1]
    assert req.state is RequestState.FINISHED
    assert req.finish_reason == "capacity"
    assert not sched.has_work()


def test_e2e_outgrowing_request_fails_cleanly():
    """End to end: a request that outgrows a deliberately tiny pool makes
    partial progress, then finishes with reason 'capacity' — no hang."""
    eng = _engine(GPT2Config(vocab_size=256, n_positions=64, n_embd=32,
                             n_layer=2, n_head=2), seed=3)
    srv = ServingEngine(eng, config={"max_batch": 1, "block_size": 8,
                                     "num_blocks": 3},   # 16 positions
                        registry=MetricsRegistry())
    rng = np.random.default_rng(9)
    rid = srv.submit(rng.integers(0, 256, (8,)), max_new_tokens=30)
    outs = {o.req_id: o for o in srv.serve_forever()}
    assert outs[rid].finish_reason == "capacity"
    assert len(outs[rid].tokens) >= 1, "partial progress must be kept"
    assert outs[rid].preemptions >= 1
    srv.cache.allocator.check_consistency()
    assert srv.cache.allocator.num_allocated == 0


def test_finish_releases_slot_and_blocks():
    cache = _host_cache()
    sched = ContinuousBatchingScheduler(cache, max_batch=2,
                                        max_model_len=32)
    sched.submit(_req(0, 6))
    sched.schedule()
    req = sched.slots[0]
    held = list(req.block_table)
    sched.finish(req, "max_tokens")
    assert req.state is RequestState.FINISHED
    assert sched.slots[0] is None and not req.block_table
    sched.allocator.check_consistency()
    assert all(b not in sched.allocator._allocated for b in held)


def test_submit_validation():
    cache = _host_cache()
    sched = ContinuousBatchingScheduler(cache, max_batch=1,
                                        max_model_len=8)
    with pytest.raises(ValueError):
        sched.submit(_req(0, 0))
    with pytest.raises(ValueError):
        sched.submit(_req(1, 9))


def test_server_submit_rejects_top_p_zero(tiny_serving):
    """top_p=0 would mask EVERY token (exclusive-cumsum nucleus) and
    deterministically emit token 0 — reject it at submit."""
    cfg, eng, srv, registry = tiny_serving
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError):
            srv.submit([1, 2, 3], max_new_tokens=2, temperature=1.0,
                       top_p=bad)
    assert srv.scheduler.num_waiting == 0
    for bad in ([300], [-1]):
        with pytest.raises(ValueError, match="out of range"):
            srv.submit(bad)
    with pytest.raises(ValueError, match="max_new_tokens"):
        srv.submit([1], max_new_tokens=0)


def test_serving_config_validation():
    cfg = DeepSpeedServingConfig({"serving": {"block_size": 8,
                                              "max_batch": 4}})
    assert cfg.block_size == 8 and cfg.max_batch == 4
    assert cfg.num_blocks == 0 and cfg.max_model_len == 0
    for bad in ({"block_size": 0}, {"max_batch": 0},
                {"prefill_chunk": 0}, {"num_blocks": 1},
                {"num_blocks": -2}, {"decode_steps": 0},
                {"attention_impl": "dense"}):
        with pytest.raises(DeepSpeedConfigError):
            DeepSpeedServingConfig({"serving": bad})


# ------------------------------------------------------------- sampling
def test_top_p_filter_keeps_nucleus():
    from deepspeed_tpu_torch.serving.sampling import NEG_INF, top_p_filter
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05],
                                     [0.97, 0.01, 0.01, 0.01]]))
    out = top_p_filter(logits, torch.tensor([0.6, 0.5])).numpy()
    # row 0: 0.5 kept, 0.3 kept (exclusive cum 0.5 < 0.6), rest cut
    assert np.all(out[0, :2] > NEG_INF / 2) and \
        np.all(out[0, 2:] <= NEG_INF / 2)
    # row 1: only the dominant token survives (top-1 always kept)
    assert out[1, 0] > NEG_INF / 2 and np.all(out[1, 1:] <= NEG_INF / 2)
    full = top_p_filter(logits, torch.tensor([1.0, 1.0])).numpy()
    assert np.all(full[0] > NEG_INF / 2)


def test_sample_tokens_mixed_policies():
    from deepspeed_tpu_torch.serving.sampling import (make_rng_lane,
                                                      sample_tokens)
    rng = np.random.default_rng(3)
    base = rng.standard_normal((3, 16)).astype(np.float32)
    base[2] = base[1]        # slots 1 and 2: same distribution, same seed
    logits = torch.from_numpy(base)
    lanes = torch.from_numpy(np.stack([make_rng_lane(s) for s in (0, 1, 1)]))
    pos = torch.tensor([5, 5, 5])
    temp, top_p = torch.tensor([0.0, 0.8, 0.8]), torch.tensor([1., .9, .9])
    toks = sample_tokens(logits, temp, top_p, lanes, pos, all_greedy=False)
    assert toks[0] == int(np.argmax(base[0]))            # greedy slot
    assert toks[1] == toks[2], "same seed+position must sample identically"
    draws = {int(sample_tokens(logits, temp, top_p, lanes, pos + i,
                               all_greedy=False)[1]) for i in range(40)}
    assert len(draws) > 1, "fresh randomness at each position"


# ------------------------------------------------- decode op per-seq lens
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_per_sequence_lengths(dtype):
    from deepspeed_tpu_torch.ops.transformer.decode import decode_attention
    gen = torch.Generator().manual_seed(1)
    B, H, T, D = 3, 2, 32, 16
    q, k, v = (torch.randn(B, H, n, D, generator=gen).to(dtype)
               for n in (1, T, T))
    lens = [1, 13, 32]
    got = decode_attention(q, k, v, torch.tensor(lens, dtype=torch.int32))
    for b, L in enumerate(lens):
        want = decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], L)
        torch.testing.assert_close(got[b], want[0], rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ end-to-end
def _engine(cfg, seed=0, dtype=torch.float32):
    return deepspeed_tpu_torch.init_inference(
        GPT2LMHeadModel(cfg, device="cpu", seed=seed), dtype=dtype,
        device="cpu")


@pytest.fixture(scope="module")
def tiny_serving():
    cfg = GPT2Config(vocab_size=256, n_positions=64, n_embd=32,
                     n_layer=2, n_head=2)
    eng = _engine(cfg)
    registry = MetricsRegistry()
    srv = ServingEngine(eng, config={"max_batch": 3, "block_size": 8,
                                     "prefill_chunk": 6},
                        registry=registry)
    return cfg, eng, srv, registry


def _baseline(eng, prompt, n_new):
    out = eng.generate(torch.as_tensor(np.asarray(prompt))[None],
                       max_new_tokens=n_new)
    return out[0, len(prompt):].tolist()


def test_e2e_heterogeneous_parity_and_one_decode_program(tiny_serving):
    cfg, eng, srv, registry = tiny_serving
    rng = np.random.default_rng(7)
    cases = [(1, 5), (11, 3), (30, 9), (7, 5), (19, 2), (4, 7)]
    prompts = [rng.integers(0, cfg.vocab_size, (p,)) for p, _ in cases]
    rids = [srv.submit(p, max_new_tokens=g)
            for p, (_, g) in zip(prompts, cases)]
    outs = {o.req_id: o for o in srv.serve_forever()}
    assert len(outs) == len(cases)
    for rid, p, (_, g) in zip(rids, prompts, cases):
        assert outs[rid].tokens == _baseline(eng, p, g), f"req {rid}"
        assert outs[rid].finish_reason == "max_tokens"
        assert outs[rid].ttft_s is not None
    # ONE decode signature, ONE prefill signature, zero retraces
    assert srv.compile_stats() == {"decode_signatures": 1,
                                   "prefill_signatures": 1, "retraces": 0}
    snap = registry.snapshot()
    sigs = {row["labels"]["fn"]: row["value"]
            for row in snap["program_signatures_total"]}
    assert sigs == {"serving_decode_step": 1.0,
                    "serving_prefill_chunk": 1.0}
    assert "program_retraces_total" not in snap


def test_e2e_steady_state_adds_zero_signatures(tiny_serving):
    """A fresh wave of differently-shaped requests adds no signature:
    request churn changes tensor values, never program shapes."""
    cfg, eng, srv, registry = tiny_serving
    rng = np.random.default_rng(11)
    before = srv._watch.compiles
    for plen, gen in ((13, 4), (2, 6), (27, 3)):
        srv.submit(rng.integers(0, cfg.vocab_size, (plen,)), gen)
    assert len(srv.serve_forever()) == 3
    assert srv._watch.compiles == before and srv._watch.retraces == 0


def test_e2e_mask_correct_when_requests_finish_mid_batch(tiny_serving):
    """A short request finishing mid-batch (and a new one admitted into
    its slot) must not perturb a long survivor's tokens."""
    cfg, eng, srv, registry = tiny_serving
    rng = np.random.default_rng(13)
    long_p = rng.integers(0, cfg.vocab_size, (10,))
    shorts = [rng.integers(0, cfg.vocab_size, (3,)) for _ in range(4)]
    rid_long = srv.submit(long_p, max_new_tokens=12)
    rid_shorts = [srv.submit(s, max_new_tokens=2) for s in shorts]
    outs = {o.req_id: o for o in srv.serve_forever()}
    assert outs[rid_long].tokens == _baseline(eng, long_p, 12)
    for rid, s in zip(rid_shorts, shorts):
        assert outs[rid].tokens == _baseline(eng, s, 2)
    assert srv.scheduler.num_active == 0
    srv.cache.allocator.check_consistency()
    assert srv.cache.allocator.num_allocated == 0


@pytest.mark.parametrize("variant", [
    {"attention_impl": "gather"},
    {"decode_steps": 4},
    {"decode_steps": 4, "attention_impl": "gather"},
], ids=lambda v: "-".join(f"{k}={x}" for k, x in v.items()))
def test_e2e_variant_parity(tiny_serving, variant):
    """The gather impl and multi-step dispatches give the same greedy
    tokens: multi-step only changes how many tokens ride one dispatch."""
    cfg, eng, srv, registry = tiny_serving
    v = ServingEngine(eng, config={"max_batch": 2, "block_size": 8,
                                   "prefill_chunk": 6, **variant},
                      registry=MetricsRegistry())
    rng = np.random.default_rng(23)
    cases = [(9, 7), (1, 5), (17, 3)]
    prompts = [rng.integers(0, cfg.vocab_size, (p,)) for p, _ in cases]
    rids = [v.submit(p, max_new_tokens=g)
            for p, (_, g) in zip(prompts, cases)]
    outs = {o.req_id: o for o in v.serve_forever()}
    for rid, p, (_, g) in zip(rids, prompts, cases):
        assert outs[rid].tokens == _baseline(eng, p, g), (variant, rid)
    assert v.compile_stats()["decode_signatures"] == 1
    v.cache.allocator.check_consistency()
    assert v.cache.allocator.num_allocated == 0


@pytest.mark.parametrize("impl", ["paged", "gather"])
def test_e2e_int8_kv_and_int8_weights_parity(impl):
    """int8 weights (bf16 activations) with the int8 KV layout serve
    with exact greedy parity against the same engine's generate()."""
    cfg = GPT2Config(vocab_size=256, n_positions=64, n_embd=32,
                     n_layer=2, n_head=2, kv_cache_dtype="int8")
    eng = _engine(cfg, seed=2, dtype=torch.int8)
    assert eng.quant_scales, "int8 weights must be armed"
    srv = ServingEngine(eng, config={"max_batch": 2, "block_size": 8,
                                     "attention_impl": impl},
                        registry=MetricsRegistry())
    assert srv.cache.int8_kv
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, (n,)) for n in (13, 5, 21)]
    rids = [srv.submit(p, max_new_tokens=6) for p in prompts]
    outs = {o.req_id: o for o in srv.serve_forever()}
    for rid, p in zip(rids, prompts):
        assert outs[rid].tokens == _baseline(eng, p, 6)
    assert srv.compile_stats()["decode_signatures"] == 1


def test_e2e_eviction_parity_and_allocator_clean():
    """A tiny pool forces preemption mid-generation; recompute-on-resume
    reproduces the uncontended greedy tokens, and the allocator ends
    empty."""
    eng = _engine(GPT2Config(vocab_size=256, n_positions=64, n_embd=32,
                             n_layer=2, n_head=2), seed=1)
    # 6 usable blocks x 8 = 48 positions for two requests needing 35 each
    srv = ServingEngine(eng, config={"max_batch": 2, "block_size": 8,
                                     "num_blocks": 7},
                        registry=MetricsRegistry())
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, (15,)) for _ in range(2)]
    rids = [srv.submit(p, max_new_tokens=20) for p in prompts]
    outs = {o.req_id: o for o in srv.serve_forever()}
    assert srv.scheduler.preemptions_total >= 1, \
        "scenario must actually exercise eviction"
    for rid, p in zip(rids, prompts):
        assert outs[rid].tokens == _baseline(eng, p, 20)
    srv.cache.allocator.check_consistency()
    assert srv.cache.allocator.num_allocated == 0


def test_e2e_eos_and_model_len_finish_reasons(tiny_serving):
    cfg, eng, srv, registry = tiny_serving
    rng = np.random.default_rng(17)
    p = rng.integers(0, cfg.vocab_size, (6,))
    greedy = _baseline(eng, p, 4)
    eos = greedy[-1]
    rid_eos = srv.submit(p, max_new_tokens=10, eos_token_id=eos)
    # prompt near the model cap: finishes by model_len before max_tokens
    long_p = rng.integers(0, cfg.vocab_size, (60,))
    rid_cap = srv.submit(long_p, max_new_tokens=30)
    outs = {o.req_id: o for o in srv.serve_forever()}
    assert outs[rid_eos].finish_reason == "eos"
    assert outs[rid_eos].tokens == greedy[:greedy.index(eos) + 1]
    assert outs[rid_cap].finish_reason == "model_len"
    assert len(outs[rid_cap].tokens) == 64 - 60 + 1


def test_serving_metrics_flow_through_registry(tiny_serving):
    cfg, eng, srv, registry = tiny_serving
    snap = registry.snapshot()
    for name in ("serving_ttft_ms", "serving_token_latency_ms",
                 "serving_e2e_latency_ms", "serving_queue_depth",
                 "serving_active_requests", "serving_kv_occupancy",
                 "serving_kv_pool_bytes", "serving_tokens_generated_total",
                 "serving_requests_submitted_total",
                 "serving_requests_finished_total",
                 "serving_decode_steps_total",
                 "serving_prefill_chunks_total"):
        assert name in snap, f"metric {name} missing from the registry"
    assert snap["serving_ttft_ms"][0]["count"] >= 1
    reasons = {r["labels"]["reason"]
               for r in snap["serving_requests_finished_total"]}
    assert "max_tokens" in reasons
    assert snap["serving_kv_pool_bytes"][0]["value"] == \
        srv.cache.pool_bytes()
    h = registry.histogram("serving_ttft_ms")
    assert h.quantile(0.5) is not None


def test_livelock_guard_and_report(tiny_serving, monkeypatch):
    """serve_forever's guard: a step that never progresses fails every
    pending request with 'livelock' and attaches the state dump."""
    from deepspeed_tpu_torch.serving.server import (SERVING_HEALTH_SCHEMA,
                                                    ServingLivelockError)
    cfg, eng, srv, registry = tiny_serving
    v = ServingEngine(eng, config={"max_batch": 2, "block_size": 8},
                      registry=MetricsRegistry())
    v.submit([1, 2, 3], max_new_tokens=4)
    monkeypatch.setattr(v, "step", lambda: False)
    with pytest.raises(ServingLivelockError) as err:
        v.serve_forever()
    report = err.value.report
    assert report["schema"] == SERVING_HEALTH_SCHEMA
    assert report["engine_state"]["scheduler"]["waiting"] == 0
    assert [o.finish_reason for o in v.collect()] == ["livelock"]
    assert v.router_signals()["queue_depth"] == 0


@pytest.mark.parametrize("what", ["guardian", "obs_server", "slo"])
def test_unported_hooks_raise(tiny_serving, what):
    cfg, eng, srv, registry = tiny_serving
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ServingEngine(eng, config={"max_batch": 1}, **{what: object()})
    with pytest.raises(ValueError, match="use_flash"):
        ServingEngine(eng, config={"max_batch": 1}, use_flash=False)


def test_tracer_spans_and_annotations(tiny_serving, tmp_path):
    """The server's spans reach an enabled tracer (serving_step around
    serving_prefill and serving_decode), as torch.profiler annotations
    too, and export as a Chrome trace; the disabled tracer records
    nothing."""
    import json

    from deepspeed_tpu_torch.telemetry import tracer as tracer_mod
    cfg, eng, srv, registry = tiny_serving
    tr = tracer_mod.Tracer(enabled=True, torch_annotations=True)
    old = tracer_mod.set_tracer(tr)
    try:
        srv.submit([1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=2)
        with torch.profiler.profile() as prof:
            srv.serve_forever()
    finally:
        tracer_mod.set_tracer(old)
    names = {e["name"] for e in tr.events()}
    assert {"serving_step", "serving_prefill", "serving_decode"} <= names
    keys = {ev.key for ev in prof.key_averages()}
    assert {"serving_step", "serving_decode"} <= keys
    doc = json.loads(open(tr.export(str(tmp_path / "t.json"))).read())
    assert len(doc["traceEvents"]) == len(tr.events())
    assert tracer_mod.get_tracer().span("x") is tracer_mod._NULL_SPAN
