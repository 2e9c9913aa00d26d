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
