"""The port's serving modules against the JAX package's, on the CPU,
and the port's own serving contracts.

A tiny GPT-2 (2 layers, n_embd 64, 4 heads, vocab 128, n_positions 128,
fp32) gets seeded flax weights, bridged with
``bridge.flax_to_state_dict`` (:func:`tiny_pair`; the end-to-end parity
over mixed traces is tests/test_torch_serving_e2e.py). The modules are
held to JAX one by one on identical numpy inputs: the paged attention functions (atol 1e-5), the runner's decode
logits and the pools a prefill chunk writes (atol 1e-4), ``top_p_filter``
(exact), the allocator and the prefix digests (byte-equal) and the
scheduler's plans over a scripted sequence (equal). Sampled tokens are a
function of (seed, position) only; one decode and one prefill signature
serve a mixed trace; ``device=None`` raises without a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JaxGPT2
from deepspeed_tpu.serving import kv_cache as jkv
from deepspeed_tpu.serving import paged_attention as jpa
from deepspeed_tpu.serving import sampling as jsampling
from deepspeed_tpu.serving import scheduler as jsched
from deepspeed_tpu.serving.server import ServingEngine as JaxServingEngine
from deepspeed_tpu.telemetry.metrics import MetricsRegistry as JaxRegistry
from deepspeed_tpu_torch.bridge import flax_to_state_dict
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.serving import kv_cache, paged_attention, sampling
from deepspeed_tpu_torch.serving import scheduler as sched
from deepspeed_tpu_torch.serving.server import ServingEngine
from deepspeed_tpu_torch.telemetry.metrics import MetricsRegistry

TINY = dict(vocab_size=128, n_positions=128, n_embd=64, n_layer=2, n_head=4)
BASE = {"max_batch": 4, "block_size": 8, "prefill_chunk": 8}

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny model's ops are microseconds long: one intra-op thread
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def jax_params(cfg_kw, seed):
    model = JaxGPT2(JaxGPT2Config(**cfg_kw))
    return model, model.init(jax.random.PRNGKey(seed), {
        "input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]


def tiny_pair(seed=0, kv="auto", int8_weights=False, **over):
    """(JAX InferenceEngine, port InferenceEngine, flax params) over the
    same seeded weights; fp32, or int8 weights under bf16 activations."""
    cfg_kw = dict(TINY, kv_cache_dtype=kv, **over)
    model, params = jax_params(cfg_kw, seed)
    jeng = deepspeed_tpu.init_inference(
        model, params=params,
        dtype=jnp.int8 if int8_weights else jnp.float32)
    sd = flax_to_state_dict(jax.tree.map(np.asarray, params))
    teng = deepspeed_tpu_torch.init_inference(
        gpt2.GPT2LMHeadModel(gpt2.GPT2Config(**cfg_kw), device="cpu"),
        params=sd, dtype=torch.int8 if int8_weights else torch.float32,
        device="cpu")
    return jeng, teng, params


def mixed_trace(n=10, seed=0, vocab=128, shared_prefix=0):
    """Prompts of 1-40 tokens (after an optional seeded shared prefix),
    1-24 new tokens, from ``seed``."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, shared_prefix)
    return [(np.concatenate([prefix, rng.integers(
        0, vocab, int(rng.integers(1, 41)))]).astype(np.int32),
        int(rng.integers(1, 25))) for _ in range(n)]


def serve(srv, trace, **submit_kw):
    rids = [srv.submit(p, max_new_tokens=g, **submit_kw) for p, g in trace]
    outs = {o.req_id: o for o in srv.serve_forever()}
    return [(outs[r].tokens, outs[r].finish_reason) for r in rids]


def counters(srv):
    pc = srv.cache.prefix_cache
    return {"preemptions": srv.scheduler.preemptions_total,
            "prefix_hits": None if pc is None else pc.hits,
            "prefix_misses": None if pc is None else pc.misses,
            "cow_forks": None if pc is None else pc.cow_forks}


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.fixture(scope="module")
def pair_int8_kv():
    return tiny_pair(seed=1, kv="int8")


# ------------------------------------------------------------ modules
def _pools(rng, L=2, N=9, H=4, BS=8, D=16, int8=False):
    shape = (L, N, H, BS, D)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.random(shape[:4]).astype(np.float32) / 50
        vs = rng.random(shape[:4]).astype(np.float32) / 50
        return k, v, ks, vs
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32), None, None)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_and_verify_attention_match_jax(int8):
    rng = np.random.default_rng(0)
    k, v, ks, vs = _pools(rng, int8=int8)
    B, H, D, C, MB, BS = 3, 4, 16, 4, 4, 8
    bt = rng.integers(1, 9, (B, MB)).astype(np.int32)
    past = np.array([0, 5, 29], np.int32)
    n_blocks = -(-int(past.max()) // BS)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, H, D)).astype(np.float32)
    vc = rng.standard_normal((B, H, D)).astype(np.float32)
    want = jpa.paged_decode_attention(
        _j(q), _j(kc), _j(vc), 1, _j(k), _j(v), _j(bt), _j(past),
        k_scale_pool=_j(ks), v_scale_pool=_j(vs))
    got = paged_attention.paged_decode_attention(
        _t(q), _t(kc), _t(vc), 1, _t(k), _t(v), _t(bt).long(), _t(past),
        n_blocks=n_blocks, k_scale_pool=_t(ks), v_scale_pool=_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    qc = rng.standard_normal((B, H, C, D)).astype(np.float32)
    kch = rng.standard_normal((B, H, C, D)).astype(np.float32)
    vch = rng.standard_normal((B, H, C, D)).astype(np.float32)
    want = jpa.paged_verify_attention(
        _j(qc), _j(kch), _j(vch), 0, _j(k), _j(v), _j(bt), _j(past),
        k_scale_pool=_j(ks), v_scale_pool=_j(vs))
    got = paged_attention.paged_verify_attention(
        _t(qc), _t(kch), _t(vch), 0, _t(k), _t(v), _t(bt).long(),
        _t(past), n_blocks=n_blocks, k_scale_pool=_t(ks),
        v_scale_pool=_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("start", [0, 3, 8, 21])
def test_paged_prefill_attention_matches_jax(int8, start):
    rng = np.random.default_rng(start)
    k, v, ks, vs = _pools(rng, int8=int8)
    H, C, D = 4, 6, 16
    bt_row = rng.permutation(np.arange(1, 9))[:4].astype(np.int32)
    q, kc, vc = (rng.standard_normal((H, C, D)).astype(np.float32)
                 for _ in range(3))
    pos = start + np.arange(C, dtype=np.int32)
    want = jpa.paged_prefill_attention(
        _j(q), _j(kc), _j(vc), 1, _j(k), _j(v), _j(bt_row), _j(pos),
        jnp.int32(start), k_scale_pool=_j(ks), v_scale_pool=_j(vs))
    got = paged_attention.paged_prefill_attention(
        _t(q), _t(kc), _t(vc), 1, _t(k), _t(v), _t(bt_row).long(), start,
        k_scale_pool=_t(ks), v_scale_pool=_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def _servers(pair, impl, int8=False):
    jeng, teng, _ = pair
    conf = dict(BASE, attention_impl=impl)
    return (JaxServingEngine(jeng, config=conf, registry=JaxRegistry()),
            ServingEngine(teng, config=conf, registry=MetricsRegistry()))


def _pool_arrays(js, ts):
    """Both servers' pools as numpy, block 0 (the null block, whose rows
    several writes may share) left out."""
    j = {n: np.asarray(p)[:, 1:] for n, p in js.pools.items()}
    t = {n: p[:, 1:].numpy() for n, p in ts.cache.pools.items()}
    return j, t


@pytest.mark.parametrize("impl", ["paged", "gather"])
def test_runner_prefill_pools_and_decode_logits_match_jax(pair, pair_int8_kv,
                                                          impl):
    """A prefill chunk's pool writes, then one decode step's logits, on
    identical pools, block tables and lengths (atol 1e-4; the int8 pools
    are compared dequantised, at most one level of the row apart)."""
    for p in (pair, pair_int8_kv):
        js, ts = _servers(p, impl)
        jr, tr = js.runner, ts.runner
        MB = js.max_blocks_per_seq
        bt_row = np.zeros((MB,), np.int32)
        bt_row[:3] = [4, 2, 7]
        tokens = np.arange(3, 11, dtype=np.int32)
        for start in (0, 8):
            js.pools = jr.prefill_chunk(
                jeng_params(p), jeng_scales(p), js.pools, bt_row, tokens,
                np.int32(start), np.int32(8 if start == 0 else 5))
            tr.prefill_chunk(bt_row.astype(np.int64), tokens.astype(
                np.int64), start, 8 if start == 0 else 5)
        j, t = _pool_arrays(js, ts)
        if "k_scale" in j:
            for name in ("k", "v"):
                scale = j[name + "_scale"][..., None]
                jd = j[name].astype(np.float32) * scale
                td = t[name].astype(np.float32) * t[name + "_scale"][..., None]
                # at most one int8 level of the row apart (a value on a
                # rounding boundary may round the other way)
                assert np.all(np.abs(td - jd) <= 1e-4 + scale * 1.001)
        else:
            for name in j:
                np.testing.assert_allclose(t[name], j[name], atol=1e-4,
                                           rtol=0)
        B = js.max_batch
        bt = np.zeros((B, MB), np.int32)
        bt[1] = bt_row
        pos = np.array([0, 13, 0, 0], np.int32)
        live = np.array([False, True, False, False])
        tok = np.array([0, 9, 0, 0], np.int32)
        _, want = jr._stack_decode(jeng_params(p), jeng_scales(p) or {},
                                   js.pools, jnp.asarray(bt),
                                   jnp.asarray(pos), jnp.asarray(live),
                                   jnp.asarray(tok))
        ints = tr.upload(tr.step_inputs(tok.astype(np.int64),
                                        pos.astype(np.int64), live,
                                        bt.astype(np.int64)))
        got = tr.stack_decode(ints, B, n_blocks=tr.n_blocks_for(pos))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want)[1],
                                   atol=1e-4, rtol=0)


def jeng_params(p):
    return p[0].params


def jeng_scales(p):
    return p[0].quant_scales


def test_top_p_filter_matches_jax_exactly():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((16, 128)) * 3).astype(np.float32)
    top_p = rng.uniform(0.05, 1.0, 16).astype(np.float32)
    top_p[:2] = 1.0
    want = np.asarray(jsampling.top_p_filter(_j(logits), _j(top_p)))
    got = sampling.top_p_filter(_t(logits), _t(top_p)).numpy()
    assert np.array_equal(got, want)


def test_greedy_sampling_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 130)).astype(np.float32)
    temp = np.array([0.0, 0.0, 0.0, 0.0], np.float32)
    want = np.asarray(jsampling.sample_tokens(
        _j(logits), _j(temp), _j(np.ones(4, np.float32)),
        jnp.zeros((4, 2), jnp.uint32), jnp.zeros(4, jnp.int32),
        vocab_size=128))
    got = sampling.sample_tokens(
        _t(logits), _t(temp), _t(np.ones(4, np.float32)),
        torch.zeros(4, 2, dtype=torch.long), torch.zeros(4), all_greedy=True,
        vocab_size=128).numpy()
    assert np.array_equal(got, want)


def test_allocator_and_prefix_digests_byte_equal():
    """The same allocate/share/free sequence gives the same block ids, and
    the chain digests (and so the salt of each layout) are byte-equal."""
    ja, ta = jkv.BlockAllocator(17), kv_cache.BlockAllocator(17)
    rng = np.random.default_rng(2)
    live = []
    for _ in range(200):
        if live and rng.random() < 0.4:
            blocks = live.pop(int(rng.integers(len(live))))
            ja.free(blocks)
            ta.free(blocks)
        else:
            n = int(rng.integers(1, 4))
            got, want = ta.allocate(n), ja.allocate(n)
            assert got == want
            if got is not None:
                live.append(got)
    assert ta._free == ja._free
    for impl, dt, jdt in (("paged", torch.float32, jnp.float32),
                          ("gather", torch.bfloat16, jnp.bfloat16),
                          ("paged", torch.int8, None)):
        jc = jkv.PagedKVCache(1, 1, 4, 8, 9, dtype=jdt or jnp.float32,
                              int8_kv=jdt is None)
        tc = kv_cache.PagedKVCache(1, 1, 4, 8, 9, dtype=dt,
                                   int8_kv=dt == torch.int8)
        jp = jc.attach_prefix_cache(attention_impl=impl)
        tp = tc.attach_prefix_cache(attention_impl=impl)
        assert tp.root_digest == jp.root_digest
        parent_j = parent_t = None
        for j in range(3):
            toks = rng.integers(0, 50000, 8)
            parent_j = jp.chain_digest(parent_j, toks, 8 * j)
            parent_t = tp.chain_digest(parent_t, toks, 8 * j)
            assert parent_t == parent_j


def _ops(rng):
    """A scripted sequence of submits and simulated progress."""
    ops = []
    for i in range(14):
        ops.append(("submit", i, int(rng.integers(1, 30)),
                    int(rng.integers(1, 12))))
        ops.append(("progress", int(rng.integers(0, 6))))
        if i % 3 == 2:
            ops.append(("finish_oldest",))
    return ops


def _plan_trace(mod, cache, decode_steps, ops):
    s = mod.ContinuousBatchingScheduler(cache, max_batch=3,
                                        max_model_len=48,
                                        decode_steps=decode_steps)
    out = []
    for op in ops:
        if op[0] == "submit":
            _, i, plen, new = op
            s.submit(mod.Request(req_id=i, prompt=list(range(1, plen + 1)),
                                 max_new_tokens=new))
        elif op[0] == "finish_oldest":
            live = [r for r in s.slots if r is not None]
            if live:
                s.finish(min(live, key=lambda r: r.admit_seq), "max_tokens")
        plan = s.schedule()
        out.append(([r.req_id for r in plan.prefill], plan.decode_slots,
                    [r.req_id for r in plan.cow_forks],
                    [None if r is None else (r.req_id, list(r.block_table),
                                             r.cached_len, r.step_budget)
                     for r in s.slots],
                    [r.req_id for r in s.waiting], s.preemptions_total))
        if op[0] == "progress":
            for r in s.slots:
                if r is None:
                    continue
                if r.state is mod.RequestState.PREFILL:
                    r.cached_len = len(r.full_prompt) - 1
                    r.state = mod.RequestState.RUNNING
                else:
                    r.cached_len += min(op[1], r.step_budget)
    return out


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_scheduler_plans_match_jax(decode_steps):
    ops = _ops(np.random.default_rng(decode_steps))
    want = _plan_trace(jsched, jkv.PagedKVCache(1, 1, 4, 4, 14),
                       decode_steps, ops)
    got = _plan_trace(sched, kv_cache.PagedKVCache(1, 1, 4, 4, 14),
                      decode_steps, ops)
    assert got == want
    assert any(p[5] for p in got), "the script must preempt"


# ----------------------------------------------- the port's own contracts
SAMPLED = dict(temperature=0.9, top_p=0.8, seed=11)


def _sampled_run(teng, **over):
    conf = dict(BASE, **over)
    return [t for t, _ in serve(ServingEngine(
        teng, config=conf, registry=MetricsRegistry()),
        mixed_trace(n=6, seed=9), **SAMPLED)]


@pytest.mark.parametrize("over", [
    {"max_batch": 2}, {"num_blocks": 10}, {"decode_steps": 3},
    {"speculative": {"enabled": True, "k": 3}},
    {"attention_impl": "gather"}], ids=lambda o: str(o)[:40])
def test_sampled_tokens_depend_on_seed_and_position_only(pair, over):
    base = _sampled_run(pair[1])
    assert _sampled_run(pair[1], **over) == base
    if "num_blocks" in over:
        srv = ServingEngine(pair[1], config=dict(BASE, **over),
                            registry=MetricsRegistry())
        serve(srv, mixed_trace(n=6, seed=9), **SAMPLED)
        assert srv.scheduler.preemptions_total > 0


def test_sampling_draws_vary_with_seed_and_position():
    logits = torch.zeros(4, 64)
    lanes = torch.from_numpy(np.stack([sampling.make_rng_lane(s)
                                       for s in (0, 0, 1, 1)]))
    pos = torch.tensor([5, 6, 5, 5])
    toks = sampling.sample_tokens(logits, torch.ones(4), torch.ones(4),
                                  lanes, pos, all_greedy=False)
    assert toks[0] != toks[1] or toks[0] != toks[2]
    assert toks[2] == toks[3]
    u = sampling.uniform_noise(lanes, pos, 64)
    assert float(u.min()) > 0 and float(u.max()) < 1


def test_uniform_noise_bits_are_fixed():
    """The generator's bits are a pinned function of (lane, position,
    vocab index): the first draws of seed 0 at position 0."""
    u = sampling.uniform_noise(torch.from_numpy(
        sampling.make_rng_lane(0)[None]), torch.zeros(1), 4)
    h = (u * (1 << 24) - 0.5).round().long()
    assert h.tolist() == PINNED_DRAWS


PINNED_DRAWS = [[6689836, 9128452, 6754022, 4400918]]


def test_one_decode_and_one_prefill_signature_over_a_mixed_trace(pair):
    ts = ServingEngine(pair[1], config=BASE, registry=MetricsRegistry())
    serve(ts, mixed_trace(n=12, seed=13))
    serve(ts, mixed_trace(n=5, seed=14))
    assert ts.compile_stats() == {"decode_signatures": 1,
                                  "prefill_signatures": 1, "retraces": 0}
    snap = ts.registry.snapshot()
    assert {r["labels"]["fn"]: r["value"]
            for r in snap["program_signatures_total"]} == {
        "serving_decode_step": 1.0, "serving_prefill_chunk": 1.0}
    assert "program_retraces_total" not in snap


def test_init_serving_device_none_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = gpt2.GPT2LMHeadModel(gpt2.GPT2Config(**TINY), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.init_serving(model=model, config={
            "serving": BASE})
    srv = deepspeed_tpu_torch.init_serving(
        model=model, dtype=torch.float32, device="cpu",
        config={"serving": BASE})
    assert srv.cache.pools["k"].device.type == "cpu"
    assert srv.runner.attention_impl == "paged"
