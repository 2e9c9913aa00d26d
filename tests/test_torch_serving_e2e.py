"""The port's continuous-batching server against the JAX package's, end
to end on the CPU.

The tiny GPT-2 of tests/test_torch_serving_parity.py (seeded flax
weights, bridged). The same seeded mixed trace (prompts of 1-40 tokens,
1-24 new tokens) goes through ``deepspeed_tpu``'s ``ServingEngine`` and
the port's at max_batch 4, block 8, prefill_chunk 8. Greedy tokens,
finish reasons and the scheduler's counters (preemptions, prefix hits
and misses, COW forks) must be equal request by request, for each
attention impl, an fp32 and an int8 KV cache, a pool small enough to
preempt, ``decode_steps`` 3, the prefix cache on a shared-prefix trace,
and speculation (``exact``, k 3: the self-draft and an explicit 1-layer
draft model).
"""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.serving.server import ServingEngine as JaxServingEngine
from deepspeed_tpu.telemetry.metrics import MetricsRegistry as JaxRegistry
from deepspeed_tpu_torch.bridge import flax_to_state_dict
from deepspeed_tpu_torch.serving.server import ServingEngine
from deepspeed_tpu_torch.telemetry.metrics import MetricsRegistry
from tests.test_torch_serving_parity import (BASE, TINY, counters,
                                             jax_params, mixed_trace, serve,
                                             tiny_pair)
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.fixture(scope="module")
def pair_int8_kv():
    return tiny_pair(seed=1, kv="int8")


CASES = {
    "paged": ({}, {}),
    "gather": ({"attention_impl": "gather"}, {}),
    "preempt": ({"num_blocks": 12}, {}),
    "preempt_gather": ({"num_blocks": 12, "attention_impl": "gather"}, {}),
    "decode_steps_3": ({"decode_steps": 3}, {}),
    "decode_steps_3_gather": ({"decode_steps": 3,
                               "attention_impl": "gather"}, {}),
    "prefix_cache": ({"prefix_cache": {"enabled": True}},
                     {"shared_prefix": 24}),
    "speculative_self_draft": ({"speculative": {"enabled": True, "k": 3}},
                               {}),
    "speculative_gather_preempt": ({"speculative": {"enabled": True,
                                                    "k": 3},
                                    "attention_impl": "gather",
                                    "num_blocks": 12}, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_equal_jax(pair, case):
    over, trace_kw = CASES[case]
    jeng, teng, _ = pair
    trace = mixed_trace(**trace_kw)
    conf = dict(BASE, **over)
    js = JaxServingEngine(jeng, config=conf, registry=JaxRegistry())
    ts = ServingEngine(teng, config=conf, registry=MetricsRegistry())
    assert serve(ts, trace) == serve(js, trace)
    assert counters(ts) == counters(js)
    if "num_blocks" in over:
        assert ts.scheduler.preemptions_total > 0
    if "prefix_cache" in over:
        assert ts.cache.prefix_cache.hits > 0
    assert ts.compile_stats() == js.compile_stats()
    ts.cache.allocator.check_consistency()


@pytest.mark.parametrize("impl", ["paged", "gather"])
def test_int8_kv_tokens_equal_jax(pair_int8_kv, impl):
    jeng, teng, _ = pair_int8_kv
    assert teng.module.config.kv_cache_dtype == "int8"
    trace = mixed_trace(seed=3)
    conf = dict(BASE, attention_impl=impl)
    js = JaxServingEngine(jeng, config=conf, registry=JaxRegistry())
    ts = ServingEngine(teng, config=conf, registry=MetricsRegistry())
    assert ts.cache.int8_kv
    assert serve(ts, trace) == serve(js, trace)


def test_explicit_draft_model_tokens_equal_jax(pair):
    """An explicit 1-layer draft (its own seeded weights) under exact
    acceptance: tokens equal the JAX engine's with the same draft."""
    jeng, teng, _ = pair
    _, dparams = jax_params(dict(TINY, n_layer=1), seed=7)
    dsd = flax_to_state_dict(jax.tree.map(np.asarray, dparams))
    conf = dict(BASE, speculative={"enabled": True, "k": 3,
                                   "draft_layers": 1})
    js = JaxServingEngine(jeng, config=conf, registry=JaxRegistry(),
                          draft_params=dparams)
    ts = ServingEngine(teng, config=conf, registry=MetricsRegistry(),
                       draft_params=dsd)
    trace = mixed_trace(seed=5)
    assert serve(ts, trace) == serve(js, trace)
    assert ts.registry.snapshot()["serving_spec_drafted_total"][0][
        "value"] > 0


