"""The serving path's device pieces on the card: the decode kernel on
the paged pools' gathered view, the captured decode graph against the
eager stack, and the in-place pool writes. Every test carries the
``cuda`` marker and skips without a card. This file imports no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serving.py

Tolerances: the kernel against its plain version as in
tests/test_torch_cuda_kernels.py (fp32 2e-5, bf16 2e-2); the graph
replay against the eager stack bit-equal (the same kernels on the same
inputs, in the same order).
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.transformer import decode
from deepspeed_tpu_torch.serving.kv_cache import PagedKVCache
from deepspeed_tpu_torch.serving.server import ServingEngine
from deepspeed_tpu_torch.telemetry.metrics import MetricsRegistry

pytestmark = pytest.mark.cuda

TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
CFG = gpt2.GPT2Config(vocab_size=512, n_positions=256, n_embd=128,
                      n_layer=2, n_head=4)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _filled_cache(gen, dtype, int8, num_blocks=40, block_size=16):
    cache = PagedKVCache(n_layer=2, n_head=16, head_dim=64,
                         block_size=block_size, num_blocks=num_blocks,
                         dtype=dtype, int8_kv=int8)
    pools = cache.init_pools("cuda")
    for name, p in pools.items():
        p.copy_(torch.randn(p.shape, generator=gen, device="cuda").mul(
            50 if p.dtype == torch.int8 else 1).clamp(-127, 127).to(p.dtype)
            if not name.endswith("scale")
            else torch.rand(p.shape, generator=gen, device="cuda") / 64)
    return cache


@pytest.mark.parametrize("dtype,int8", [(torch.float32, False),
                                        (torch.bfloat16, False),
                                        (torch.bfloat16, True)])
@pytest.mark.parametrize("blocks_per_seq", [1, 8, 64])
def test_decode_kernel_on_gathered_view(gen, dtype, int8, blocks_per_seq):
    """Per-slot lengths with zeros (idle slots), a one-token slot, block
    edges and the full window: the kernel on ``PagedKVCache.gather``'s
    view against its plain version; length-0 slots give zeros."""
    cache = _filled_cache(gen, dtype, int8)
    B = 8
    bt = torch.randint(1, cache.num_blocks, (B, blocks_per_seq),
                       generator=gen, device="cuda")
    k, v, ks, vs = cache.gather(1, bt)
    T = k.shape[2]
    assert k.is_contiguous() and k.shape == (B, 16, T, 64)
    q = torch.randn(B, 16, 1, 64, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor([0, 1, min(15, T), min(16, T), min(17, T), T - 1,
                         T, 0], dtype=torch.int32, device="cuda")
    got = decode.decode_attention(q, k, v, lens, k_scale=ks, v_scale=vs)
    want = decode.decode_attention_plain(q, k, v, lens, k_scale=ks,
                                         v_scale=vs)
    torch.cuda.synchronize()
    live = lens > 0
    tol = TOLS[dtype]
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               rtol=tol, atol=tol)
    assert bool((got[~live] == 0).all())


def test_pool_writes_in_place_through_the_null_block(gen):
    """Writes keep the pools' addresses; rows routed to block 0 (idle
    slots, several in one store) leave every live block as written."""
    cache = PagedKVCache(n_layer=3, n_head=4, head_dim=16, block_size=8,
                         num_blocks=12, dtype=torch.bfloat16, int8_kv=True)
    pools = cache.init_pools("cuda")
    ptrs = {n: p.data_ptr() for n, p in pools.items()}
    blk = torch.tensor([3, 0, 5, 0, 0], device="cuda")
    off = torch.tensor([1, 2, 7, 2, 0], device="cuda")
    k = torch.randn(3, 5, 4, 16, generator=gen, device="cuda")
    v = torch.randn(3, 5, 4, 16, generator=gen, device="cuda")
    cache.write_all_layers(k, v, blk, off)
    cache.write_decode(1, k[0], v[0], blk, off)
    cache.copy_block(5, 9)
    torch.cuda.synchronize()
    assert {n: p.data_ptr() for n, p in pools.items()} == ptrs
    kq, kscale = decode.quantize_kv(k)
    # layer 1 holds the later one-layer write of k[0]
    for layer, src in ((0, 0), (1, 0), (2, 2)):
        for i in (0, 2):
            b, o = int(blk[i]), int(off[i])
            assert torch.equal(pools["k"][layer, b, :, o], kq[src, i])
            assert torch.equal(pools["k_scale"][layer, b, :, o],
                               kscale[src, i])
    assert torch.equal(pools["k"][:, 9], pools["k"][:, 5])
    assert torch.equal(pools["v_scale"][:, 9], pools["v_scale"][:, 5])


def _trace(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG.vocab_size, int(rng.integers(1, 60))),
             int(rng.integers(4, 20))) for _ in range(n)]


def _serve(srv, trace):
    rids = [srv.submit(p, max_new_tokens=g) for p, g in trace]
    outs = {o.req_id: o for o in srv.serve_forever()}
    return [outs[r].tokens for r in rids]


@pytest.mark.parametrize("dtype,kv", [(torch.bfloat16, "auto"),
                                      (torch.float32, "auto"),
                                      (torch.bfloat16, "int8")])
def test_graph_replay_matches_eager_decode(gen, dtype, kv):
    """The captured one-token gather stack replayed against the same
    stack run eagerly: bit-equal tokens over a mixed trace, bit-equal
    logits on one step's inputs, one capture, n_layer decode launches a
    replay counted."""
    import dataclasses
    cfg = dataclasses.replace(CFG, kv_cache_dtype=kv)
    eng = deepspeed_tpu_torch.init_inference(gpt2.GPT2LMHeadModel(cfg),
                                             dtype=dtype)
    conf = {"max_batch": 4, "block_size": 16, "prefill_chunk": 32,
            "attention_impl": "gather"}
    graph = ServingEngine(eng, config=conf, registry=MetricsRegistry())
    eager = ServingEngine(eng, config=conf, cuda_graph=False,
                          registry=MetricsRegistry())
    assert graph.compile_stats()["graph_captures"] == 1
    assert "graph_captures" not in eager.compile_stats()
    trace = _trace()
    op_builder.reset_launch_counts()
    got = _serve(graph, trace)
    launched = dict(op_builder.LAUNCHES)
    dispatches = graph.registry.counter("serving_decode_steps_total").value
    assert got == _serve(eager, trace)
    name = "decode_attention_int8" if kv == "int8" else "decode_attention"
    assert launched == {name: cfg.n_layer * dispatches}
    r = graph.runner
    B, MB = graph.max_batch, graph.max_blocks_per_seq
    bt = np.arange(1, B * MB + 1).reshape(B, MB) % 30 + 1
    pos = np.array([0, 5, 17, 40])
    live = np.array([True, True, False, True])
    ints = r.upload(r.step_inputs(np.array([3, 1, 4, 1]), pos, live, bt))
    want = r.stack_decode(ints, B).clone()
    got = r._logits(ints, B, r.n_blocks_for(pos)).clone()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_sampling_bits_equal_on_cpu_and_card(gen):
    """The sampler's counter hash gives the same bits on the card as on
    the CPU (the uniforms are exact functions of them)."""
    from deepspeed_tpu_torch.serving import sampling
    lanes = torch.from_numpy(np.stack([sampling.make_rng_lane(s)
                                       for s in (0, 7, 2 ** 40)]))
    pos = torch.tensor([0, 5, 1023])
    cpu = sampling.uniform_noise(lanes, pos, 50304)
    card = sampling.uniform_noise(lanes.cuda(), pos.cuda(), 50304).cpu()
    assert torch.equal(cpu, card)


def _decode_window_syncs(srv, n_steps=8):
    """Synchronizing calls in ``n_steps`` steps of pure decode, counted
    by ``torch.cuda.set_sync_debug_mode("warn")``'s warnings (its
    one-time notice that the mode is a prototype is not a call)."""
    import warnings
    from deepspeed_tpu_torch.serving.scheduler import RequestState
    rng = np.random.default_rng(1)
    for _ in range(srv.max_batch):
        srv.submit(rng.integers(0, CFG.vocab_size, 12), max_new_tokens=40)
    while sum(r is not None and r.state is RequestState.RUNNING
              for r in srv.scheduler.slots) < srv.max_batch:
        srv.step()
    srv.step()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n_steps):
                srv.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    srv.serve_forever()
    return sum("called a synchronizing cuda operation" in
               str(w.message).lower() for w in seen)


def test_observatory_adds_no_synchronizing_call(gen, tmp_path):
    """The serving observatory books host values the server already
    holds: a window of graph-replayed decode makes the same synchronizing
    calls with observability on as off, and the same tokens."""
    eng = deepspeed_tpu_torch.init_inference(gpt2.GPT2LMHeadModel(CFG),
                                             dtype=torch.bfloat16)
    conf = {"max_batch": 4, "block_size": 16, "prefill_chunk": 32,
            "attention_impl": "gather"}
    obs = dict(conf, observability={
        "enabled": True, "window": 4,
        "snapshot_file": str(tmp_path / "SERVING_HEALTH.json")})
    on = ServingEngine(eng, config=obs, registry=MetricsRegistry())
    off = ServingEngine(eng, config=conf, registry=MetricsRegistry())
    assert on.compile_stats()["graph_captures"] == 1
    counts = {"on": _decode_window_syncs(on),
              "off": _decode_window_syncs(off)}
    assert counts["on"] == counts["off"] > 0
    trace = _trace(seed=3)
    assert _serve(on, trace) == _serve(off, trace)
    led = on.serving_report()["slot_ledger"]
    assert led["total_units"] == led["steps"] * 4


def test_router_places_by_prefix_affinity_on_the_card(gen, tmp_path):
    """Two replicas of one engine (their own pools, the prefix cache on,
    observed) behind ServingRouter: after one warm-up request a group on
    different replicas, each group's requests go to the replica holding
    its prefix, and every request's tokens equal one engine's."""
    from deepspeed_tpu_torch.serving import ServingRouter
    eng = deepspeed_tpu_torch.init_inference(gpt2.GPT2LMHeadModel(CFG),
                                             dtype=torch.bfloat16)

    def replica(i=None):
        conf = {"max_batch": 4, "block_size": 16, "prefill_chunk": 32,
                "attention_impl": "gather",
                "prefix_cache": {"enabled": True}}
        if i is not None:
            conf["observability"] = {
                "enabled": True, "window": 4, "ttft_slo_ms": 1e9,
                "snapshot_file": str(tmp_path / f"replica{i}.json")}
        return ServingEngine(eng, config=conf, registry=MetricsRegistry())

    rng = np.random.default_rng(5)
    heads = [rng.integers(0, CFG.vocab_size, 32) for _ in range(2)]
    reqs = [(np.concatenate([heads[i % 2], rng.integers(
        0, CFG.vocab_size, int(rng.integers(1, 30)))]),
        int(rng.integers(4, 16))) for i in range(12)]

    def run(router):
        rids = [router.submit(p, max_new_tokens=g) for p, g in reqs[:2]]
        first = [router.last_decision]
        outs = {o.req_id: o for o in router.serve_forever()}
        decisions = []
        for p, g in reqs[2:]:
            rids.append(router.submit(p, max_new_tokens=g))
            decisions.append(router.last_decision)
        outs.update({o.req_id: o for o in router.serve_forever()})
        assert sorted(outs) == sorted(rids) == list(range(len(reqs)))
        return [outs[r].tokens for r in rids], first, decisions

    router = ServingRouter([replica(0), replica(1)])
    tokens, _, decisions = run(router)
    assert router.routed_by_replica == [6, 6]
    for i, d in enumerate(decisions, start=2):
        assert d.replica == i % 2 and d.affinity_blocks == 2
    alone, _, _ = run(ServingRouter([replica()]))
    assert tokens == alone
    router.close()


def _mission_control(tmp_path, name, registry):
    """A guardian (cooldown 0, 3 quiet steps to resume), an SLO monitor
    built from a ``telemetry`` block and a token-guarded obs server."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.guardian import Guardian
    from deepspeed_tpu_torch.telemetry.obs_server import ObsServer
    from deepspeed_tpu_torch.telemetry.slo import SloMonitor
    tcfg = DeepSpeedConfig({"train_batch_size": 1, "telemetry": {
        "enabled": True, "slo": {"enabled": True}}}).telemetry
    d = tmp_path / name
    guardian = Guardian(action_cooldown_steps=0, resume_clear_steps=3,
                        journal_path=str(d / "GUARDIAN.json"),
                        registry=registry)
    slo = SloMonitor.from_config(tcfg, output_path=str(d),
                                 registry=registry)
    slo.on_anomaly = guardian.hook("slo")
    return guardian, slo, ObsServer(registry=registry, token="t")


def test_overload_cycle_and_no_added_sync_on_the_card(gen, tmp_path):
    """The mission-control plane on the gather impl's graph: the pool
    starved, admission pauses on ``queue_growth`` and a submit is refused
    with it; the chaos lifted, the backlog drains and admission resumes
    after the quiet steps. A decode window makes the same synchronizing
    calls with the plane armed as without it, and the greedy tokens equal
    an unarmed server's."""
    from deepspeed_tpu_torch.serving.server import \
        ServingAdmissionPausedError
    from deepspeed_tpu_torch.testing.chaos import PoolStarvationChaos
    eng = deepspeed_tpu_torch.init_inference(gpt2.GPT2LMHeadModel(CFG),
                                             dtype=torch.bfloat16)
    conf = {"max_batch": 4, "block_size": 16, "prefill_chunk": 32,
            "attention_impl": "gather",
            "observability": {"enabled": True, "window": 2,
                              "warmup_windows": 0,
                              "queue_growth_windows": 1, "ttft_slo_ms": 1e9,
                              "snapshot_file": str(tmp_path / "s.json")}}

    def armed(name):
        reg = MetricsRegistry()
        g, slo, http = _mission_control(tmp_path, name, reg)
        srv = ServingEngine(eng, config=conf, registry=reg, guardian=g,
                            slo=slo, obs_server=http)
        assert srv.compile_stats()["graph_captures"] == 1
        return srv, g, http

    srv, g, http = armed("cycle")
    rng = np.random.default_rng(2)
    chaos = PoolStarvationChaos(srv.cache.allocator, hold_frac=1.0)
    chaos.install()
    accepted = []
    try:
        for _ in range(24):
            if srv._admission_pause_rule is not None:
                break
            accepted.append(srv.submit(rng.integers(0, CFG.vocab_size, 6),
                                       max_new_tokens=4))
            srv.step()
        assert srv._admission_pause_rule == "queue_growth"
        with pytest.raises(ServingAdmissionPausedError) as ei:
            srv.submit(rng.integers(0, CFG.vocab_size, 6), max_new_tokens=4)
        assert ei.value.rule == "queue_growth"
    finally:
        chaos.uninstall()
    outs = {o.req_id: o for o in srv.serve_forever()}
    assert set(outs) == set(accepted)
    for _ in range(20):
        if srv._admission_pause_rule is None:
            break
        srv.step()
    assert srv._admission_pause_rule is None
    assert g.action_counts == {"serving_pause": 1, "serving_resume": 1}
    srv.close()
    http.close()

    on, _, http_on = armed("sync")
    off = ServingEngine(eng, config={k: v for k, v in conf.items()
                                     if k != "observability"},
                        registry=MetricsRegistry())
    counts = {"on": _decode_window_syncs(on),
              "off": _decode_window_syncs(off)}
    assert counts["on"] == counts["off"] > 0
    trace = _trace(seed=4)
    assert _serve(on, trace) == _serve(off, trace)
    on.close()
    http_on.close()
