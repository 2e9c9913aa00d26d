"""Data parallelism in the PyTorch port, second part: BERT with LAMB (fused
and plain) and with the Fixed block-sparse layout, an fp16 overflow on one
rank only, the dropout masks a rank draws, the Adam sweep and MoQ at
ZeRO 3 against stage 0, and the ring refusal. gloo ranks spawned by ``tests/torch_dist_worker.py``
against the JAX engine on a 2- and a 4-device mesh, on the CPU.

The BERT batches mask 15% of the positions at random (``-100`` labels
elsewhere), so the ranks' rows hold different numbers of labels: the
engine weights each rank's loss by its share of the global batch's
labels, and the losses and gradients are the global batch's mean, as
JAX's. Each case runs at ZeRO 0 and 1, fused and plain LAMB, and each
is held to the JAX engine; JAX's update does not depend on the stage,
so one JAX run serves them all. Tolerances: fp32 losses and masters at
rtol = atol = 1e-4 (``tests/test_torch_engine.py``'s); fp16 at its
single-rank test's envelope, rtol 0.03 / atol 0.08.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.models import simple as jax_simple
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.bridge import (bert_flax_to_state_dict,
                                        simple_flax_to_state_dict)
from deepspeed_tpu_torch.runtime import dropout
from tests import torch_dist_worker as worker
from tests.model import oracle

TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 3
WORLDS = (2, 4)
LAMB = {"type": "Lamb", "params": {"lr": 2e-3, "weight_decay": 0.01}}
EMB = {"vocab": 50, "dim": 16}


def _lamb(fused, stage):
    params = dict(LAMB["params"], fused=True) if fused else LAMB["params"]
    return {"train_batch_size": oracle.BATCH_SIZE,
            "steps_per_print": 10 ** 9, "gradient_clipping": 0.5,
            "optimizer": {"type": "Lamb", "params": params},
            "zero_optimization": {"stage": stage}}


# MoQ at 12 bits over the 3 steps: one rounding flip moves a master a
# level, inside TOL
MOQ = {"enabled": True, "quantize_groups": 8,
       "quantize_bits": {"start_bits": 12, "target_bits": 8},
       "quantize_schedule": {"quantize_period": 100}}

FP16 = {"train_batch_size": oracle.BATCH_SIZE, "steps_per_print": 10 ** 9,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
        "fp16": {"enabled": True, "loss_scale": 0,
                 "initial_scale_power": 8},
        "zero_optimization": {"stage": 1}}

# name -> (model config, JAX config, port config, worlds)
CASES = {
    "bert_fused_lamb_zero1": ("bert", _lamb(False, 1), _lamb(True, 1),
                              WORLDS),
    "bert_fused_lamb_zero0": ("bert", _lamb(False, 0), _lamb(True, 0),
                              WORLDS),
    "bert_lamb_zero1": ("bert", _lamb(False, 1), _lamb(False, 1), (2,)),
    "sparse_bert_fused_lamb_zero1": ("sparse", _lamb(False, 1),
                                     _lamb(True, 1), (2,)),
    "fp16_one_rank_overflows": ("embedding", FP16, FP16, WORLDS),
}
MODELS = {"bert": oracle.TINY_BERT, "sparse": oracle.TINY_BERT_SPARSE}


def _bert_batches():
    return [{k: np.asarray(v) for k, v in jax_bert.synthetic_mlm_batch(
        oracle.BATCH_SIZE, oracle.SEQ_LEN, oracle.TINY_BERT["vocab_size"],
        seed=1000 + s).items()}
        for s in range(STEPS)]


def _emb_batches():
    """Step 1's targets on the last rows (the last rank's, at world 2
    and 4) are 1e30: their squared error overflows, so that rank's
    gradients do and the others' do not."""
    out = []
    for s in range(STEPS + 1):
        rng = np.random.default_rng(s)
        b = {"input_ids": rng.integers(0, EMB["vocab"], (8, 12),
                                       dtype=np.int32),
             "targets": rng.standard_normal((8, EMB["dim"])).astype(
                 np.float32)}
        if s == 1:
            b["targets"][-2:] = 1e30
        out.append(b)
    return out


def _jax_model(kind):
    if kind == "embedding":
        return jax_simple.EmbeddingModel(EMB["vocab"], EMB["dim"])
    return jax_bert.BertForPreTraining(jax_bert.BertConfig(**MODELS[kind]))


@pytest.fixture(scope="module")
def setup():
    """{model kind: (batches, bridged flax init)}."""
    out = {}
    for kind in ("bert", "sparse", "embedding"):
        batches = _emb_batches() if kind == "embedding" else _bert_batches()
        params = _jax_model(kind).init(jax.random.PRNGKey(oracle.SEED),
                                       batches[0])["params"]
        to_sd = (simple_flax_to_state_dict if kind == "embedding"
                 else bert_flax_to_state_dict)
        out[kind] = (batches, to_sd(jax.tree.map(np.asarray, params)))
    return out


def _port_case(kind, cfg, setup):
    batches, init = setup[kind]
    if kind == "embedding":
        return dict(model="embedding", model_cfg=EMB, config=cfg, init=init,
                    batches=batches)
    return dict(model="bert", model_cfg=MODELS[kind], config=cfg, init=init,
                batches=batches, eval=True)


@pytest.fixture(scope="module")
def port(setup, tmp_path_factory):
    """{world: {case: [rank results]}}, with the dropout masks and the
    refusals in the world-2 spawn: one spawn a world size."""
    out = {}
    for world in WORLDS:
        names = [n for n, c in CASES.items() if world in c[3]]
        cases = [_port_case(CASES[n][0], CASES[n][2], setup) for n in names]
        if world == 2:
            # fp16 without averaging, at ZeRO 0: each rank steps on its
            # own gradients, and one rank's overflow still skips every rank
            names.append("fp16_one_rank_overflows_no_allreduce")
            cases.append(dict(_port_case("embedding", dict(
                FP16, zero_optimization={"stage": 0}), setup),
                no_allreduce=True))
            names.append("dropout")
            cases.append(dict(kind="dropout", seed=42, micro_step=3, p=0.1))
            bert_cfg = dict(_lamb(False, 1))
            # what ZeRO 3 used to refuse, the Adam sweep (with the clip)
            # and MoQ, run at stage 3 and at stage 0 on BERT
            sweep = {"type": "Adam", "params": {"lr": 2e-3, "sweep": True}}
            for stage in (3, 0):
                names.append(f"sweep_stage{stage}")
                cases.append(_port_case("bert", dict(
                    bert_cfg, optimizer=sweep,
                    zero_optimization={"stage": stage}), setup))
                names.append(f"moq_stage{stage}")
                cases.append(_port_case("bert", dict(
                    bert_cfg, zero_optimization={"stage": stage},
                    quantize_training=MOQ), setup))
            names.append("refuse_ring")
            cases.append(dict(kind="refusal", model="gpt2", model_cfg={
                "attention_mode": "ring:data"}, config=bert_cfg))
        res = worker.run("engine", world,
                         str(tmp_path_factory.mktemp(f"bert{world}")), cases)
        assert all(r["jax_modules"] == [] for r in res)
        out[world] = {n: [r["cases"][i] for r in res]
                      for i, n in enumerate(names)}
    out["dropout"] = out[2]["dropout"]
    out["refusals"] = [[out[2][n][r] for n in ("sweep_stage3", "moq_stage3",
                                                "refuse_ring")]
                       for r in range(2)]
    out["stage0"] = [[out[2][n][r] for n in ("sweep_stage0", "moq_stage0")]
                     for r in range(2)]
    return out


_JAX_RUNS = {}


def _jax_engine(kind, cfg, ndev, batches):
    """The JAX engine's run on an ``ndev``-device mesh, once for the ZeRO
    stages of one configuration."""
    cfg = dict(cfg, zero_optimization={"stage": 1})
    key = (kind, repr(sorted(cfg.items())), ndev)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _run_jax_engine(kind, cfg, ndev, batches)
    return _JAX_RUNS[key]


def _run_jax_engine(kind, cfg, ndev, batches):
    groups.destroy()
    groups.initialize(devices=jax.devices()[:ndev])
    engine, *_ = deepspeed_tpu.initialize(
        model=_jax_model(kind), config=copy.deepcopy(cfg),
        sample_batch=batches[0], seed=oracle.SEED)
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    to_sd = (simple_flax_to_state_dict if kind == "embedding"
             else bert_flax_to_state_dict)
    params = to_sd(jax.tree.map(np.asarray, engine.state.params))
    return (losses, {k: v.numpy() for k, v in params.items()},
            int(engine.skipped_steps), float(engine.loss_scale),
            float(engine.eval_batch(batches[0])))


# against the JAX engine on the 2- and the 4-device mesh (plain LAMB and
# sparse BERT on the 2-device one)
JAX_PAIRS = [(n, w) for w in WORLDS for n, c in CASES.items() if w in c[3]]


@pytest.mark.parametrize("name,world", JAX_PAIRS)
def test_matches_jax_engine_on_a_mesh(setup, port, name, world):
    kind, jax_cfg = CASES[name][:2]
    batches = setup[kind][0]
    want_losses, want_params, want_skipped, want_scale, want_eval = \
        _jax_engine(kind, jax_cfg, world, batches)
    ranks = port[world][name]
    got = ranks[0]
    for r in ranks[1:]:
        for k, p in got["params"].items():
            assert np.array_equal(r["params"][k], p), k
    if kind != "embedding":
        # the ranks' rows hold different numbers of labels
        counts = {int((worker.rank_rows(b, r, world, 1, 0)["labels"] >= 0)
                      .sum()) for b in batches for r in range(world)}
        assert len(counts) > 1
        np.testing.assert_allclose(got["eval"], want_eval, **TOL)
    tol = TOL
    if kind == "embedding":
        # both engines skip the step one rank overflowed (hysteresis 2:
        # the scale stays), then go on equally
        assert got["skipped"] == want_skipped == 1
        assert got["loss_scale"] == want_scale
        finite = [i for i, x in enumerate(want_losses) if np.isfinite(x)]
        assert finite == [0, 2, 3]
        assert not np.isfinite(got["losses"][1])
        want_losses = [want_losses[i] for i in finite]
        got = dict(got, losses=[got["losses"][i] for i in finite])
        tol = dict(rtol=0.03, atol=0.08)
    np.testing.assert_allclose(got["losses"], want_losses, **tol)
    for k, w in want_params.items():
        np.testing.assert_allclose(got["params"][k], w, err_msg=k, **tol)


def test_fp16_overflow_without_averaging_skips_on_every_rank(port):
    """``backward(allreduce_gradients=False)`` then ``step()`` at ZeRO 0:
    each rank steps on its own gradients, so only the last rank's
    overflow; the flag is agreed over the group (MAX), and both ranks
    skip step 1 and keep the same loss scale."""
    ranks = port[2]["fp16_one_rank_overflows_no_allreduce"]
    assert [r["skipped"] for r in ranks] == [1, 1]
    assert ranks[0]["loss_scale"] == ranks[1]["loss_scale"]
    assert np.isfinite(ranks[0]["losses"][1])
    assert not np.isfinite(ranks[1]["losses"][1])
    # the masters differ: nothing averaged the ranks' gradients
    assert any(not np.array_equal(ranks[0]["params"][k], p)
               for k, p in ranks[1]["params"].items())


def _mask_before(seed, micro_step, site, p, shape):
    """The mask one site drew before the rank entered the key (the
    two-part key's seed mix, written out)."""
    m64 = (1 << 64) - 1

    def mix(z):
        z = (z + 0x9E3779B97F4A7C15) & m64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m64
        return z ^ (z >> 31)

    z = mix(mix(mix(seed) ^ micro_step) ^ site) >> 1
    gen = torch.Generator().manual_seed(z)
    return (torch.rand(shape, generator=gen) >= p).numpy()


def test_dropout_masks_differ_by_rank_and_world1_keeps_its_masks(port):
    """At world 2 the ranks draw different masks for the same site and
    step; world 1 (no rank in the key) draws the masks it drew before."""
    a, b = port["dropout"]
    assert a.shape == b.shape and not np.array_equal(a != 0, b != 0)
    x = torch.ones(64, 64)
    with dropout.key_scope((42, 3)):
        world1 = dropout.dropout(x, 0.1, site=0).numpy()
    assert np.array_equal(world1 != 0, _mask_before(42, 3, 0, 0.1, (64, 64)))
    assert not np.array_equal(world1 != 0, a != 0)


def test_refusals_at_world_two(port):
    """GPT-2's ring/Ulysses modes raise on every rank of a real two-rank
    group, naming themselves. The Adam sweep (clip 0.5) and MoQ, which
    ZeRO 3 used to refuse, run there on BERT: losses and masters equal on
    both ranks and within 1e-4 of the same run at stage 0 (the JAX
    engine holds both on a mesh in tests/test_torch_dist_zero.py)."""
    for rank_out, rank_ref in zip(port["refusals"], port["stage0"]):
        *runs, ring_mode = rank_out
        for got, want in zip(runs, rank_ref):
            assert np.all(np.isfinite(got["losses"]))
            np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
            for k, p in want["params"].items():
                np.testing.assert_allclose(got["params"][k], p, err_msg=k,
                                           **TOL)
        assert ring_mode.startswith("NotImplementedError") and "ring" in \
            ring_mode
    a, b = port["refusals"]
    for got, other in zip(a[:2], b[:2]):
        assert got["losses"] == other["losses"]


@pytest.mark.parametrize("name,world", [("bert_fused_lamb_zero0", 2),
                                        ("bert_fused_lamb_zero0", 4),
                                        ("bert_lamb_zero1", 2)])
def test_matches_the_ports_fused_lamb_at_zero1(port, name, world):
    """ZeRO 0 (every rank the whole state) and plain LAMB at
    ZeRO 1 (its norms summed over the ranks in ``optim.lamb``) take the
    steps of fused LAMB at ZeRO 1, which the JAX engine holds: losses and
    masters at 1e-4 (the trust ratios' norms sum in another order)."""
    want = port[world]["bert_fused_lamb_zero1"][0]
    ranks = port[world][name]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], **TOL)
        for k, w in want["params"].items():
            np.testing.assert_allclose(r["params"][k], w, err_msg=k, **TOL)
