"""Speculative decoding tests of the port (the cases of
tests/unit/test_speculative.py on ``deepspeed_tpu_torch.serving``,
except those of the serving observatory and the guardian, which are not
ported yet).

With ``acceptance="exact"`` the speculative engine must give the same
tokens as the non-speculative one for greedy AND sampled traffic (the
draw of a token depends only on (seed, position), so verify replays the
draws sequential decoding makes), compose with int8 weights + int8 KV
and with the COW prefix cache, survive preemption, and hold steady state
at exactly {1 draft, 1 verify} signatures with no decode signature and
no retrace. Rejection cost is booked in the registry and per request.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfigError,
                                                DeepSpeedServingConfig)
from deepspeed_tpu_torch.serving.scheduler import Request
from deepspeed_tpu_torch.serving.server import ServingEngine
from deepspeed_tpu_torch.serving.speculative import (SpeculativeDecoder,
                                                     default_draft_layers,
                                                     validate_draft_params)
from deepspeed_tpu_torch.telemetry.metrics import MetricsRegistry
from tests.torch_threads import one_torch_thread  # noqa: F401

SPEC_COMPILE = {"decode_signatures": 0, "prefill_signatures": 1,
                "retraces": 0, "draft_signatures": 1,
                "verify_signatures": 1}


def _make_engine(seed=0, n_layer=4, kv="auto", dtype=torch.float32):
    cfg = GPT2Config(vocab_size=256, n_positions=64, n_embd=32,
                     n_layer=n_layer, n_head=2, kv_cache_dtype=kv)
    return cfg, deepspeed_tpu_torch.init_inference(
        GPT2LMHeadModel(cfg, device="cpu", seed=seed), dtype=dtype,
        device="cpu")


def _spec_cfg(k=3, extra=None, spec_extra=None):
    cfg = {"max_batch": 3, "block_size": 8, "prefill_chunk": 6,
           "speculative": dict({"enabled": True, "k": k,
                                "draft_layers": 2}, **(spec_extra or {}))}
    cfg.update(extra or {})
    return cfg


def _baseline(eng, prompt, n_new):
    out = eng.generate(torch.as_tensor(np.asarray(prompt))[None],
                       max_new_tokens=n_new)
    return out[0, len(prompt):].tolist()


@pytest.fixture(scope="module")
def tiny():
    return _make_engine()


@pytest.mark.parametrize("impl", ["paged", "gather"])
def test_greedy_parity_and_two_programs(tiny, impl):
    """Heterogeneous greedy trace through the speculative path: every
    token equal to batch-synchronous generate(), steady state at exactly
    {1 draft, 1 verify} signatures, allocator clean, counters live."""
    cfg, eng = tiny
    srv = ServingEngine(eng, config=_spec_cfg(extra={"attention_impl":
                                                     impl}),
                        registry=MetricsRegistry())
    rng = np.random.default_rng(7)
    cases = [(1, 5), (11, 3), (30, 9), (7, 5), (19, 2), (4, 7)]
    prompts = [rng.integers(0, cfg.vocab_size, (p,)) for p, _ in cases]
    rids = [srv.submit(p, max_new_tokens=g)
            for p, (_, g) in zip(prompts, cases)]
    outs = {o.req_id: o for o in srv.serve_forever()}
    for rid, p, (_, g) in zip(rids, prompts, cases):
        assert outs[rid].tokens == _baseline(eng, p, g), f"req {rid}"
    assert srv.compile_stats() == SPEC_COMPILE
    srv.cache.allocator.check_consistency()
    assert srv.cache.allocator.num_allocated == 0
    snap = srv.registry.snapshot()
    drafted = snap["serving_spec_drafted_total"][0]["value"]
    accepted = snap["serving_spec_accepted_total"][0]["value"]
    assert drafted > 0 and 0 < accepted <= drafted
    assert snap["serving_spec_acceptance_rate"][0]["value"] == \
        pytest.approx(accepted / drafted)


REQS = [  # (prompt_len, gen, temperature, top_p, seed)
    (9, 6, 0.0, 1.0, 0), (5, 8, 0.9, 0.8, 3),
    (14, 5, 0.7, 1.0, 4), (3, 7, 1.1, 0.6, 9)]


def _serve_mixed(eng, conf, reqs=REQS, vocab=256, seed=23):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, (p,)) for p, *_ in reqs]
    srv = ServingEngine(eng, config=conf, registry=MetricsRegistry())
    rids = [srv.submit(p, max_new_tokens=g, temperature=t, top_p=tp, seed=s)
            for p, (_, g, t, tp, s) in zip(prompts, reqs)]
    outs = {o.req_id: o for o in srv.serve_forever()}
    return [outs[r].tokens for r in rids], srv


def test_sampled_mixed_parity_vs_nonspec_engine(tiny):
    """Mixed greedy/sampled traffic: exact acceptance reproduces the
    non-speculative engine's streams token for token."""
    cfg, eng = tiny
    spec, _ = _serve_mixed(eng, _spec_cfg())
    plain, _ = _serve_mixed(eng, {"max_batch": 3, "block_size": 8,
                                  "prefill_chunk": 6})
    assert spec == plain


def test_int8_weights_int8_kv_parity():
    """int8 weight storage + int8 KV + speculation: equal to the same
    engine's non-speculative serving."""
    cfg, eng = _make_engine(seed=2, kv="int8", dtype=torch.int8)
    assert eng.quant_scales
    reqs = [(13, 6, 0.0, 1.0, 0), (5, 4, 0.8, 0.9, 7), (21, 5, 0.0, 1.0, 0)]
    spec, srv = _serve_mixed(eng, _spec_cfg(extra={"max_batch": 2}), reqs,
                             seed=11)
    assert srv.cache.int8_kv and srv.compile_stats() == SPEC_COMPILE
    plain, _ = _serve_mixed(eng, {"max_batch": 2, "block_size": 8}, reqs,
                            seed=11)
    assert spec == plain


def test_prefix_cache_composition(tiny):
    """Speculation over COW-forked prefix blocks: the draft/verify writes
    land only at positions >= cached_len, so shared blocks stay clean."""
    cfg, eng = tiny
    srv = ServingEngine(
        eng, config=_spec_cfg(extra={"prefix_cache": {"enabled": True}}),
        registry=MetricsRegistry())
    rng = np.random.default_rng(31)
    head = rng.integers(0, cfg.vocab_size, (24,))
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab_size, (t,))])
               for t in (3, 5, 7, 4)]
    for wave in range(2):     # the first wave seeds the index
        rids = [srv.submit(p, max_new_tokens=6) for p in prompts]
        outs = {o.req_id: o for o in srv.serve_forever()}
        for rid, p in zip(rids, prompts):
            assert outs[rid].tokens == _baseline(eng, p, 6), (wave, rid)
    pc = srv.cache.prefix_cache
    assert pc.stats()["hits"] > 0
    assert srv.compile_stats() == SPEC_COMPILE
    assert pc.shared_blocks() == 0
    pc.drop_all()
    srv.cache.allocator.check_consistency()
    assert srv.cache.allocator.num_allocated == 0


def test_preemption_under_speculation_parity():
    """An undersized pool forces eviction while speculation is live;
    recompute-on-resume reproduces the uncontended greedy tokens."""
    cfg, eng = _make_engine(seed=1, n_layer=2)
    srv = ServingEngine(
        eng, config=_spec_cfg(extra={"max_batch": 2, "num_blocks": 7}),
        registry=MetricsRegistry())
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (15,)) for _ in range(2)]
    rids = [srv.submit(p, max_new_tokens=20) for p in prompts]
    outs = {o.req_id: o for o in srv.serve_forever()}
    assert srv.scheduler.preemptions_total >= 1
    for rid, p in zip(rids, prompts):
        assert outs[rid].tokens == _baseline(eng, p, 20)
    srv.cache.allocator.check_consistency()
    assert srv.cache.allocator.num_allocated == 0


def _bad_draft(eng, row=7):
    """A deliberately BAD explicit draft: the target's weights with the
    final LN collapsed to a constant output of ``wte[row]``, so the draft
    predicts that row whatever the input."""
    sd = {k: v.clone() for k, v in eng.module.state_dict().items()}
    sd["ln_f.weight"] = torch.zeros_like(sd["ln_f.weight"])
    sd["ln_f.bias"] = sd["wte"][row].clone()
    return sd


def test_explicit_draft_params_rejections_booked(tiny):
    """Exact acceptance keeps parity even when the draft is hostile, and
    the rejection cost shows in the counters and per request."""
    cfg, eng = tiny
    srv = ServingEngine(eng, config=_spec_cfg(), registry=MetricsRegistry(),
                        draft_params=_bad_draft(eng))
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, cfg.vocab_size, (p,)) for p in (9, 4, 17)]
    rids = [srv.submit(p, max_new_tokens=8) for p in prompts]
    outs = {o.req_id: o for o in srv.serve_forever()}
    for rid, p in zip(rids, prompts):
        assert outs[rid].tokens == _baseline(eng, p, 8)
    snap = srv.registry.snapshot()
    assert snap["serving_spec_rejected_total"][0]["value"] > 0, \
        "a hostile draft must miss"


def test_validate_draft_params_errors(tiny):
    cfg, eng = tiny
    target = eng.module.state_dict()
    good = dict(target)
    validate_draft_params(good, target, 2)          # no raise
    with pytest.raises(ValueError, match="missing 'wte'"):
        validate_draft_params({"wpe": 0, "ln_f.weight": 0}, target, 1)
    bad_wte = dict(good)
    bad_wte["wte"] = torch.zeros(7, 3)
    with pytest.raises(ValueError, match="vocab and embedding width"):
        validate_draft_params(bad_wte, target, 1)
    shallow = {k: v for k, v in good.items() if not k.startswith("h.3.")}
    with pytest.raises(ValueError, match="no h.3"):
        validate_draft_params(shallow, target, 4)


def test_default_draft_layers_floor():
    assert default_draft_layers(2) == 1
    assert default_draft_layers(8) == 2
    assert default_draft_layers(48) == 12


def test_config_validation_errors():
    for bad in ({"k": 0}, {"acceptance": "hopeful"},
                {"typical_threshold": 0.0}, {"typical_threshold": 1.5},
                {"acceptance_floor": -0.1}, {"acceptance_floor": 1.5},
                {"draft_model": 7}):
        with pytest.raises(DeepSpeedConfigError):
            DeepSpeedServingConfig(
                {"serving": {"speculative": dict({"enabled": True}, **bad)}})
    ok = DeepSpeedServingConfig(
        {"serving": {"speculative": {"enabled": True, "k": 5,
                                     "acceptance": "typical"}}})
    assert ok.speculative.enabled and ok.speculative.k == 5


def test_env_override_toggles(monkeypatch):
    monkeypatch.setenv("DS_SERVING_SPEC", "1")
    on = DeepSpeedServingConfig({"serving": {}})
    assert on.speculative.enabled is True
    monkeypatch.setenv("DS_SERVING_SPEC", "0")
    off = DeepSpeedServingConfig(
        {"serving": {"speculative": {"enabled": True}}})
    assert off.speculative.enabled is False


def test_typical_mode_greedy_slots_stay_exact(tiny):
    """acceptance="typical" relaxes SAMPLED slots only; an all-greedy
    trace still equals generate()."""
    cfg, eng = tiny
    srv = ServingEngine(
        eng, config=_spec_cfg(spec_extra={"acceptance": "typical",
                                          "typical_threshold": 0.3}),
        registry=MetricsRegistry())
    rng = np.random.default_rng(53)
    prompts = [rng.integers(0, cfg.vocab_size, (p,)) for p in (6, 12, 3)]
    rids = [srv.submit(p, max_new_tokens=7) for p in prompts]
    outs = {o.req_id: o for o in srv.serve_forever()}
    for rid, p in zip(rids, prompts):
        assert outs[rid].tokens == _baseline(eng, p, 7)
    assert srv.compile_stats() == SPEC_COMPILE


def test_typical_mode_accepts_at_least_exact_on_sampled_slots(tiny):
    """On sampled traffic the typical rule accepts every draft the exact
    rule does and possibly more (fewer verify dispatches)."""
    cfg, eng = tiny
    reqs = [(9, 10, 0.9, 1.0, 1), (5, 10, 1.0, 0.9, 2)]
    _, exact = _serve_mixed(eng, _spec_cfg(), reqs)
    _, typical = _serve_mixed(eng, _spec_cfg(spec_extra={
        "acceptance": "typical", "typical_threshold": 0.01}), reqs)
    rate = [s.registry.snapshot()["serving_spec_acceptance_rate"][0][
        "value"] for s in (exact, typical)]
    assert rate[1] >= rate[0]


def test_request_spec_acceptance_rate_property():
    r = Request(req_id=0, prompt=[1, 2], max_new_tokens=4)
    assert r.spec_acceptance_rate is None
    r.spec_drafted, r.spec_accepted = 10, 7
    assert r.spec_acceptance_rate == pytest.approx(0.7)


def test_decoder_rejects_bad_construction(tiny):
    cfg, eng = tiny
    srv = ServingEngine(eng, config=_spec_cfg(), registry=MetricsRegistry())
    with pytest.raises(ValueError):
        SpeculativeDecoder(srv.runner, k=0)
    with pytest.raises(ValueError):
        SpeculativeDecoder(srv.runner, k=2, acceptance="maybe")
    with pytest.raises(ValueError):
        SpeculativeDecoder(srv.runner, k=2, draft_layers=99)
