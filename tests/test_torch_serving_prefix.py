"""Shared-prefix KV reuse tests of the port (the cases of
tests/unit/test_prefix_cache.py on ``deepspeed_tpu_torch.serving``,
except the router's, which tests/test_torch_serving_router.py holds
to the JAX router).

Host-side invariants run with no device work: refcount share/release
churn never leaks, the null block is never refcounted, the double-free
guard names the owning request and refcount, all-or-nothing admission
rolls shared references back, cold cached blocks are reclaimed BEFORE
any preemption fires, and preempting one sharer leaves the other
sharers' tables intact. The end-to-end tests drive the port's
ServingEngine on the CPU: greedy outputs equal cache-on vs cache-off
(across COW forks and preemption/resume) with one decode signature and
no retrace, and int8-KV shared blocks byte-equal to a fresh rewrite of
the same prefix.
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
                                                  PagedKVCache, PrefixCache)
from deepspeed_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler, Request, RequestState)
from deepspeed_tpu_torch.serving.server import ServingEngine
from deepspeed_tpu_torch.telemetry.metrics import MetricsRegistry
from tests.torch_threads import one_torch_thread  # noqa: F401


# -------------------------------------------------- refcounted allocator
def test_share_and_release_refcounts():
    a = BlockAllocator(8)
    blocks = a.allocate(2, owner="r1")
    a.share(blocks, owner="r2")
    a.share(blocks, owner="r3")
    assert a.refcount(blocks[0]) == 3
    assert a.num_allocated == 2, "refcounts don't inflate the block count"
    a.free(blocks, owner="r2")
    assert a.refcount(blocks[0]) == 2
    a.free(blocks, owner="r1")
    a.free(blocks, owner="r3")
    assert a.num_allocated == 0 and a.num_free == a.num_usable
    a.check_consistency()


def test_null_block_never_refcounted():
    a = BlockAllocator(4)
    assert 0 not in a.allocate(3)
    with pytest.raises(BlockAllocatorError):
        a.share([0])
    with pytest.raises(BlockAllocatorError):
        a.free([0])
    a.check_consistency()


def test_double_free_names_owner_and_refcount():
    a = BlockAllocator(6)
    blocks = a.allocate(1, owner=7)
    a.free(blocks, owner=7)
    with pytest.raises(BlockAllocatorError) as ei:
        a.free(blocks, owner=7)
    msg = str(ei.value)
    assert "refcount 0" in msg and "request 7" in msg, msg


def test_foreign_free_names_holders():
    a = BlockAllocator(6)
    blocks = a.allocate(1, owner="mine")
    with pytest.raises(BlockAllocatorError) as ei:
        a.free(blocks, owner="thief")
    msg = str(ei.value)
    assert "thief" in msg and "mine" in msg and "refcount 1" in msg, msg
    a.free(blocks, owner="mine")
    a.check_consistency()


def test_share_free_churn_never_leaks():
    rng = np.random.default_rng(2)
    a = BlockAllocator(17)
    live = []                           # (blocks, owner)
    next_owner = 0
    for _ in range(600):
        roll = rng.random()
        if live and roll < 0.35:
            a.free(*live.pop(int(rng.integers(len(live)))))
        elif live and roll < 0.55:
            blocks, _ = live[int(rng.integers(len(live)))]
            owner = f"s{next_owner}"
            next_owner += 1
            a.share(blocks, owner=owner)
            live.append((blocks, owner))
        else:
            owner = f"o{next_owner}"
            next_owner += 1
            got = a.allocate(int(rng.integers(1, 4)), owner=owner)
            if got is not None:
                live.append((got, owner))
        a.check_consistency()
    for blocks, owner in live:
        a.free(blocks, owner=owner)
    a.check_consistency()
    assert a.num_allocated == 0 and a.num_free == a.num_usable


# ----------------------------------------------------------- prefix index
def _pc(num_blocks=32, block_size=4, capacity=0, salt="t"):
    alloc = BlockAllocator(num_blocks)
    return alloc, PrefixCache(alloc, block_size=block_size,
                              capacity_blocks=capacity, salt=salt)


def test_chain_digest_is_position_and_salt_aware():
    _, pc = _pc(salt="a")
    _, pc2 = _pc(salt="b")
    d = pc.chain_digest(None, [1, 2, 3, 4], 0)
    assert pc.chain_digest(None, [1, 2, 3, 4], 4) != d, \
        "same tokens at a different position must not collide"
    assert pc2.chain_digest(None, [1, 2, 3, 4], 0) != d, \
        "different attention/dtype salt must not collide"
    parent = pc.chain_digest(None, [9, 9, 9, 9], 0)
    assert pc.chain_digest(parent, [1, 2, 3, 4], 4) != \
        pc.chain_digest(None, [1, 2, 3, 4], 4), \
        "a block's digest must certify its whole prefix chain"


def test_lookup_walks_longest_chain_and_insert_dedups():
    alloc, pc = _pc()
    blocks = alloc.allocate(3, owner="w")
    tokens = list(range(12))
    d = None
    for j, b in enumerate(blocks):
        d = pc.insert(d, tokens[j * 4:(j + 1) * 4], j * 4, b)
    hit, digests = pc.lookup(tokens + [99, 98])
    assert hit == blocks and len(digests) == 3
    # divergent third block: only the two-block chain matches
    hit2, _ = pc.lookup(tokens[:8] + [77, 77, 77, 77])
    assert hit2 == blocks[:2]
    # identical re-insert keeps the FIRST writer's block (live sharers
    # must never see a remap)
    assert pc.insert(digests[1], tokens[8:12], 8, 31) == digests[2]
    assert pc.lookup(tokens)[0] == blocks
    assert alloc.refcount(blocks[2]) == 2, "dedup must not double-share"


def test_reclaim_lru_first_and_skips_live_sharers():
    alloc, pc = _pc()
    blocks = alloc.allocate(3, owner="w")
    d0 = pc.insert(None, [1, 2, 3, 4], 0, blocks[0])
    pc.insert(None, [5, 6, 7, 8], 0, blocks[1])
    pc.insert(None, [9, 9, 9, 9], 0, blocks[2])
    alloc.free([blocks[0], blocks[2]], owner="w")   # b1 still held by "w"
    pc.lookup([1, 2, 3, 4])                          # touch: b0 now MRU
    assert pc.reclaim(1) == 1
    assert pc.stats()["evictions"] == 1
    # b2 (cold) went first; b0 (touched) survived; b1 (shared) untouched
    assert pc.lookup([1, 2, 3, 4])[0] == [blocks[0]]
    assert pc.lookup([9, 9, 9, 9])[0] == []
    assert alloc.refcount(blocks[1]) == 2
    assert pc.reclaim(5) == 1, "only b0 is reclaimable; b1 is live"
    alloc.free([blocks[1]], owner="w")
    assert pc.drop_all() == 1
    alloc.check_consistency()
    assert alloc.num_allocated == 0


def test_capacity_bound_evicts_cold_never_live():
    alloc, pc = _pc(capacity=2)
    blocks = alloc.allocate(3, owner="w")
    pc.insert(None, [1, 1, 1, 1], 0, blocks[0])
    pc.insert(None, [2, 2, 2, 2], 0, blocks[1])
    alloc.free([blocks[0]], owner="w")       # only b0 is cold
    pc.insert(None, [3, 3, 3, 3], 0, blocks[2])
    assert pc.resident_blocks() == 2 and pc.stats()["evictions"] == 1
    assert pc.lookup([1, 1, 1, 1])[0] == []
    # every entry live: a further insert is SKIPPED, never steals
    blocks2 = alloc.allocate(1, owner="w")
    pc.insert(None, [4, 4, 4, 4], 0, blocks2[0])
    assert pc.resident_blocks() == 2
    assert pc.lookup([4, 4, 4, 4])[0] == []


# ------------------------------------------------- scheduler admission
def _host_cache(num_blocks=17, block_size=4, prefix=True):
    cache = PagedKVCache(n_layer=1, n_head=1, head_dim=4,
                         block_size=block_size, num_blocks=num_blocks)
    if prefix:
        cache.attach_prefix_cache(attention_impl="paged")
    return cache


def _req(i, prompt, max_new=4):
    return Request(req_id=i, prompt=list(prompt), max_new_tokens=max_new)


def _index_prompt(cache, req):
    """Register a slotted request's FULL prompt blocks (what the server
    does as prefill chunks complete)."""
    pc, bs = cache.prefix_cache, cache.block_size
    d = None
    full = req.full_prompt
    for j in range(len(full) // bs):
        d = pc.insert(d, full[j * bs:(j + 1) * bs], j * bs,
                      req.block_table[j])
    return d


def test_admission_maps_shared_prefix_read_only():
    cache = _host_cache()
    sched = ContinuousBatchingScheduler(cache, max_batch=2,
                                        max_model_len=64)
    prefix = list(range(1, 9))                       # 2 full blocks
    sched.submit(_req(0, prefix + [20, 21]))
    sched.schedule()
    r0 = sched.slots[0]
    _index_prompt(cache, r0)
    sched.submit(_req(1, prefix + [30, 31, 32]))
    sched.schedule()
    r1 = sched.slots[1]
    assert r1.prefix_hit_blocks == 2
    assert r1.block_table[:2] == r0.block_table[:2], \
        "hit blocks map into the sharer's table"
    assert r1.cached_len == 8, "prefill starts at the first uncached token"
    assert r1.cow_fork is None
    assert cache.allocator.refcount(r0.block_table[0]) == 3  # r0+r1+index
    # preempting the SHARER leaves the owner's table intact
    shared_ids = list(r0.block_table[:2])
    state_before = r0.state
    sched._preempt(r1, "test")
    assert r0.block_table[:2] == shared_ids and \
        r0.state is state_before, \
        "preempting a sharer must not disturb the block owner"
    assert cache.allocator.refcount(r0.block_table[0]) == 2
    sched.finish(r0, "max_tokens")
    cache.prefix_cache.drop_all()
    cache.allocator.check_consistency()
    assert cache.allocator.num_allocated == 0


def test_fully_cached_prompt_plans_exactly_one_cow_fork():
    cache = _host_cache()
    sched = ContinuousBatchingScheduler(cache, max_batch=2,
                                        max_model_len=64)
    prompt = list(range(1, 9))                       # exactly 2 blocks
    sched.submit(_req(0, prompt))
    sched.schedule()
    r0 = sched.slots[0]
    _index_prompt(cache, r0)
    sched.submit(_req(1, list(prompt)))
    plan = sched.schedule()
    r1 = sched.slots[1]
    # the last position must be rewritten (it produces the first logits):
    # table = shared chain with its tail swapped for a fresh fork target
    assert plan.cow_forks == [r1]
    src, idx = r1.cow_fork
    assert src == r0.block_table[1] and idx == 1
    assert r1.block_table[0] == r0.block_table[0]
    assert r1.block_table[1] != r0.block_table[1]
    assert r1.cached_len == len(prompt) - 1
    assert r1.shared_blocks == 1
    assert r1.state is RequestState.RUNNING, \
        "one-position rewrite rides the decode step, not a prefill chunk"
    # the fork source carries r1's pinning reference until the copy lands
    assert cache.allocator.refcount(src) == 3
    # preempt r1 BEFORE the copy lands: the pending fork reference and
    # the fresh target must both release (server never ran)
    sched._preempt(r1, "test")
    assert cache.allocator.refcount(src) == 2
    sched.finish(r0, "max_tokens")
    cache.prefix_cache.drop_all()
    cache.allocator.check_consistency()
    assert cache.allocator.num_allocated == 0


def test_admission_rollback_is_all_or_nothing_under_sharing():
    # pool sized so the sharer's MATCH fits but its fresh tail does not
    cache = _host_cache(num_blocks=6)                # 5 usable
    sched = ContinuousBatchingScheduler(cache, max_batch=2,
                                        max_model_len=64)
    prefix = list(range(1, 9))                       # 2 blocks
    sched.submit(_req(0, prefix + [20, 21], max_new=2))   # 3 blocks
    sched.schedule()
    r0 = sched.slots[0]
    _index_prompt(cache, r0)
    base_rc = cache.allocator.refcount(r0.block_table[0])
    # needs 2 shared + 3 fresh with only 2 free -> must roll back fully
    # (the index's own references keep every block rc>=2: nothing is
    # reclaimable, so the grant genuinely cannot be met)
    sched.submit(_req(1, prefix + list(range(30, 41)), max_new=2))
    sched.schedule()
    assert sched.slots[1] is None and len(sched.waiting) == 1
    assert cache.allocator.refcount(r0.block_table[0]) == base_rc, \
        "failed admission must release the shared references it took"
    assert sched.preemptions_total == 0
    cache.allocator.check_consistency()


def test_cold_cached_blocks_reclaimed_before_preemption():
    cache = _host_cache(num_blocks=7)                # 6 usable
    sched = ContinuousBatchingScheduler(cache, max_batch=2,
                                        max_model_len=64)
    pc = cache.prefix_cache
    # a finished request's prefix stays warm: 4 cache-only blocks
    sched.submit(_req(0, list(range(1, 17)), max_new=1))
    sched.schedule()
    r0 = sched.slots[0]
    _index_prompt(cache, r0)
    sched.finish(r0, "max_tokens")
    assert pc.reclaimable_blocks() == 4
    assert cache.allocator.num_free == 2
    # a DIFFERENT 3-block prompt: admission must reclaim cold cache
    # blocks instead of failing or preempting
    sched.submit(_req(1, list(range(50, 61)), max_new=2))
    sched.schedule()
    assert sched.slots[0] is not None or sched.slots[1] is not None
    assert sched.preemptions_total == 0, \
        "a cold cached block is free capacity, not a preemption reason"
    assert pc.stats()["evictions"] >= 1


# ------------------------------------------------------------ end-to-end
def _engine(seed=0, kv="auto", dtype=torch.float32):
    cfg = GPT2Config(vocab_size=256, n_positions=64, n_embd=32,
                     n_layer=2, n_head=2, kv_cache_dtype=kv)
    return cfg, deepspeed_tpu_torch.init_inference(
        GPT2LMHeadModel(cfg, device="cpu", seed=seed), dtype=dtype,
        device="cpu")


@pytest.fixture(scope="module")
def tiny_engine():
    return _engine()


def _baseline(eng, prompt, n_new):
    out = eng.generate(torch.as_tensor(np.asarray(prompt))[None],
                       max_new_tokens=n_new)
    return out[0, len(prompt):].tolist()


def _cache_on(eng, **over):
    cfg = {"max_batch": 2, "block_size": 8, "prefill_chunk": 6,
           "prefix_cache": {"enabled": True}, **over}
    return ServingEngine(eng, config=cfg, registry=MetricsRegistry())


@pytest.mark.parametrize("impl", ["paged", "gather"])
def test_e2e_cow_parity_one_program_and_counters(tiny_engine, impl):
    """Shared-prefix traffic (including a fully-cached prompt, the COW
    fork path) gives the cache-off tokens, with one decode signature and
    no retrace; the hit/miss/shared gauges flow through the registry."""
    cfg, eng = tiny_engine
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 256, (24,))                     # 3 blocks
    prompts = [np.concatenate([prefix, rng.integers(0, 256, (t,))])
               for t in (5, 3, 7)]
    prompts.append(prefix.copy())            # fully cached -> COW fork
    srv = _cache_on(eng, attention_impl=impl)
    rids = [srv.submit(p, max_new_tokens=4) for p in prompts]
    outs = {o.req_id: o for o in srv.serve_forever()}
    for rid, p in zip(rids, prompts):
        assert outs[rid].tokens == _baseline(eng, p, 4), rid
    pc = srv.cache.prefix_cache
    assert pc.hits > 0 and pc.cow_forks >= 1
    assert srv.compile_stats() == {"decode_signatures": 1,
                                   "prefill_signatures": 1, "retraces": 0}
    snap = srv.registry.snapshot()
    assert snap["serving_prefix_cache_hits_total"][0]["value"] == pc.hits
    assert snap["serving_prefix_cache_misses_total"][0]["value"] == \
        pc.misses
    assert snap["serving_prefix_cow_forks_total"][0]["value"] == \
        pc.cow_forks
    assert "serving_prefix_blocks_shared" in snap
    assert srv._engine_state()["prefix_cache"]["hit_rate"] == \
        pc.stats()["hit_rate"]
    assert pc.shared_blocks() == 0
    pc.drop_all()
    srv.cache.allocator.check_consistency()
    assert srv.cache.allocator.num_allocated == 0


def test_e2e_preemption_with_sharing_stays_exact(tiny_engine):
    """Tiny pool + shared prefixes: preemption of sharing requests (and
    resume onto re-matched cached blocks) keeps greedy parity, and the
    refcounted teardown drains completely."""
    cfg, eng = tiny_engine
    srv = _cache_on(eng, num_blocks=7)       # 6 usable x 8 = 48 positions
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, 256, (16,))
    prompts = [np.concatenate([prefix, rng.integers(0, 256, (3,))])
               for _ in range(2)]
    rids = [srv.submit(p, max_new_tokens=18) for p in prompts]
    outs = {o.req_id: o for o in srv.serve_forever()}
    assert srv.scheduler.preemptions_total >= 1, \
        "scenario must actually exercise preemption under sharing"
    for rid, p in zip(rids, prompts):
        assert outs[rid].tokens == _baseline(eng, p, 18), rid
    assert srv.compile_stats()["retraces"] == 0
    srv.cache.prefix_cache.drop_all()
    srv.cache.allocator.check_consistency()
    assert srv.cache.allocator.num_allocated == 0


def test_e2e_recompute_tokens_counted(tiny_engine):
    """Re-prefilled positions after a preemption are booked as
    recompute; a hit request's prefill starts at its first uncached
    token."""
    cfg, eng = tiny_engine
    srv = _cache_on(eng, num_blocks=7)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, (15,)) for _ in range(2)]
    for p in prompts:
        srv.submit(p, max_new_tokens=20)
    srv.serve_forever()
    snap = srv.registry.snapshot()
    assert srv.scheduler.preemptions_total >= 1
    assert snap["serving_preemptions_total"][0]["value"] == \
        srv.scheduler.preemptions_total
    assert snap["serving_preemptions_total"][0]["labels"] == {
        "reason": "capacity_growth"}


@pytest.mark.parametrize("impl", ["paged", "gather"])
def test_e2e_int8_shared_blocks_bit_exact(impl):
    """Quantize-on-write determinism: the int8 bytes (and fp32 scales) a
    SHARED prefix block carries equal what a fresh engine writes for the
    same prompt."""
    cfg, eng = _engine(seed=2, kv="int8", dtype=torch.int8)
    prompt = np.random.default_rng(11).integers(0, 256, (16,))

    def prefix_pool_bytes(srv, blocks):
        return {name: p[:, blocks].clone()
                for name, p in srv.cache.pools.items()}

    srv_a = _cache_on(eng, attention_impl=impl)
    assert srv_a.cache.int8_kv
    rid = srv_a.submit(prompt, max_new_tokens=4)
    outs_a = {o.req_id: o for o in srv_a.serve_forever()}
    pc = srv_a.cache.prefix_cache
    shared_blocks, _ = pc.lookup(list(prompt))
    assert len(shared_blocks) == 2, "both full prompt blocks must index"
    a_bytes = prefix_pool_bytes(srv_a, shared_blocks)
    srv_b = ServingEngine(eng, config={"max_batch": 2, "block_size": 8,
                                       "prefill_chunk": 6,
                                       "attention_impl": impl},
                          registry=MetricsRegistry())
    srv_b.submit(prompt, max_new_tokens=4)     # stays live past prefill
    while srv_b.scheduler.num_active == 0:
        srv_b.step()
    r = next(r for r in srv_b.scheduler.slots if r is not None)
    while r.cached_len < 16:
        srv_b.step()
    b_bytes = prefix_pool_bytes(srv_b, r.block_table[:2])
    for name in a_bytes:
        assert torch.equal(a_bytes[name], b_bytes[name]), \
            f"pool {name!r} diverged — int8 blocks must share bit-exactly"
    rid2 = srv_a.submit(prompt, max_new_tokens=4)
    outs2 = {o.req_id: o for o in srv_a.serve_forever()}
    assert outs2[rid2].tokens == outs_a[rid].tokens


def test_prefix_cache_config_block(monkeypatch):
    cfg = DeepSpeedServingConfig({"serving": {"prefix_cache": {
        "enabled": True, "capacity_blocks": 5}}})
    assert cfg.prefix_cache.enabled and cfg.prefix_cache.capacity_blocks == 5
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedServingConfig({"serving": {"prefix_cache": {
            "capacity_blocks": -1}}})
    monkeypatch.setenv("DS_SERVING_PREFIX_CACHE", "1")
    assert DeepSpeedServingConfig({"serving": {}}).prefix_cache.enabled
    monkeypatch.setenv("DS_SERVING_PREFIX_CACHE", "0")
    assert not DeepSpeedServingConfig({"serving": {"prefix_cache": {
        "enabled": True}}}).prefix_cache.enabled
    # ported: the router's block is accepted and parsed as the JAX
    # config parses it
    from deepspeed_tpu.runtime.config import \
        DeepSpeedServingConfig as JaxServingConfig
    block = {"serving": {"router": {"replicas": 2}}}
    assert vars(DeepSpeedServingConfig(block).router) == \
        vars(JaxServingConfig(block).router)
    assert DeepSpeedServingConfig(block).router.replicas == 2
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedServingConfig({"serving": {"router": {
            "queue_weight": -1}}})
