"""ZeRO stages 2 and 3 in the PyTorch port (``torch.distributed`` over
gloo, one process a rank) against the JAX engine on a 2- and a 4-device
mesh, on the CPU.

The ranks run in processes of ``tests/torch_dist_worker.py``'s fork
server, one spawn a world size for all the cases of this file; each rank
feeds the engine its rows of the global batches the JAX engine takes
whole. Stage 2 reduce-scatters the gradients into each rank's slices
(the Adam sweep straight into its flat chunk); stage 3 also cuts the
fp32 masters, gathers them for the forward and reduce-scatters in the
backward. The stage-3 persistence threshold is set so that both kinds of
tensor occur: GPT-2's [64]-long LayerNorm and bias tensors (and the
embedding model's bias) stay whole on every rank, the matrices are cut.
Every case is held to the JAX engine at ZeRO 3 with the same threshold
(JAX's update does not depend on the stage; one JAX run a configuration
and mesh serves both stages). Tolerances: fp32 losses and masters at
rtol = atol = 1e-4 (``tests/test_torch_dist_engine.py``'s, as the Adam
forms' normalised update turns a last-bit difference of two gradient sums
into ~1e-5); the bf16 accumulator's losses at 1e-5 and masters at atol
1e-4; fp16 at its single-rank envelope, rtol 0.03 / atol 0.08. The
golden curve ``gpt2_tiny_fp32_adam`` at 1e-4, as
``tests/model/test_loss_parity.py:96-100`` holds the JAX stages to it.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.models import simple as jax_simple
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.bridge import (flax_to_state_dict,
                                        simple_flax_to_state_dict)
from tests import torch_dist_worker as worker
from tests.model import oracle

TOL = dict(rtol=1e-4, atol=1e-4)
FP16_TOL = dict(rtol=0.03, atol=0.08)
STEPS = 4
GOLDEN_STEPS = 20
WORLDS = (2, 4)
# the stage-3 persistence thresholds: tensors below stay whole
PERSIST = {"gpt2": 1000, "embedding": 100}
EMB = {"vocab": 50, "dim": 16}
GOLDEN = os.path.join(os.path.dirname(__file__), "model", "baselines",
                      "gpt2_tiny_fp32_adam.json")


def _config(opt, stage, kind="gpt2", **over):
    cfg = {"train_batch_size": oracle.BATCH_SIZE,
           "steps_per_print": 10 ** 9, "optimizer": opt,
           "zero_optimization": {
               "stage": stage,
               "stage3_param_persistence_threshold": PERSIST[kind]}}
    cfg.update(over)
    return cfg


ADAMW = {"type": "AdamW", "params": {"lr": 2e-3, "weight_decay": 0.01}}
LAMB = {"type": "Lamb", "params": {"lr": 2e-3, "weight_decay": 0.01}}
ADAM = {"type": "Adam", "params": {"lr": 2e-3}}
FP16 = {"fp16": {"enabled": True, "loss_scale": 0, "initial_scale_power": 8}}


def _with(opt, **params):
    return {"type": opt["type"], "params": dict(opt["params"], **params)}


def _cases():
    """name -> (model kind, JAX config, port config)."""
    out = {}
    for stage in (2, 3):
        z = f"zero{stage}"
        out[f"adamw_clip_{z}"] = ("gpt2", _config(ADAMW, 3,
                                                  gradient_clipping=0.5),
                                  _config(ADAMW, stage,
                                          gradient_clipping=0.5))
        out[f"fused_adam_clip_{z}"] = (
            "gpt2", _config(ADAMW, 3, gradient_clipping=0.5),
            _config(_with(ADAMW, fused=True), stage, gradient_clipping=0.5))
        out[f"lamb_clip_{z}"] = ("gpt2", _config(LAMB, 3,
                                                 gradient_clipping=0.5),
                                 _config(LAMB, stage, gradient_clipping=0.5))
        out[f"fused_lamb_clip_{z}"] = (
            "gpt2", _config(LAMB, 3, gradient_clipping=0.5),
            _config(_with(LAMB, fused=True), stage, gradient_clipping=0.5))
        gas2 = dict(gradient_accumulation_steps=2,
                    gradient_accumulation_dtype="bf16")
        out[f"gas2_bf16_{z}"] = ("gpt2", _config(ADAM, 3, **gas2),
                                 _config(ADAM, stage, **gas2))
        fp16 = {"type": "Adam", "params": {"lr": 1e-2}}
        out[f"fp16_one_rank_overflows_{z}"] = (
            "embedding", _config(fp16, 3, "embedding", **FP16),
            _config(fp16, stage, "embedding", **FP16))
    # the sweep reduce-scatters its flat gradient vector into its chunk
    # (stage 2; at stage 3 it raises, tests/test_torch_dist_bert.py)
    out["sweep_clip_zero2"] = ("gpt2", _config(ADAMW, 3,
                                               gradient_clipping=0.5),
                               _config(_with(ADAMW, sweep=True), 2,
                                       gradient_clipping=0.5))
    return out


CASES = _cases()


def _emb_batches():
    """Step 1's targets on the last rows (the last rank's, at world 2
    and 4) are 1e30: their squared error overflows, so that rank's
    gradients do and the others' do not (tests/test_torch_dist_bert.py's
    batches)."""
    out = []
    for s in range(STEPS):
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
    return jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(**oracle.TINY))


@pytest.fixture(scope="module")
def setup():
    """{model kind: (batches, the bridged flax init)}."""
    out = {}
    gpt_batches = [{"input_ids": np.array(b["input_ids"])}
                   for b in oracle.make_batches(GOLDEN_STEPS)]
    for kind, batches in (("gpt2", gpt_batches),
                          ("embedding", _emb_batches())):
        params = _jax_model(kind).init(jax.random.PRNGKey(oracle.SEED),
                                       batches[0])["params"]
        to_sd = (simple_flax_to_state_dict if kind == "embedding"
                 else flax_to_state_dict)
        out[kind] = (batches, to_sd(jax.tree.map(np.asarray, params)))
    return out


def _port_case(kind, cfg, setup, **kw):
    batches, init = setup[kind]
    if kind == "embedding":
        return dict(model="embedding", model_cfg=EMB, config=cfg, init=init,
                    batches=batches, **kw)
    return dict(model="gpt2", config=cfg, init=init,
                batches=batches[:STEPS], eval=True, **kw)


GOLDEN_CFG = {"train_batch_size": oracle.BATCH_SIZE,
              "steps_per_print": 10 ** 9,
              "optimizer": {"type": "Adam", "params": {"lr": oracle.LR}}}
CLIENT_CFG = _config(ADAM, 3)


@pytest.fixture(scope="module")
def port(setup, tmp_path_factory):
    """{world: {case: [rank results]}}: one spawn a world size."""
    out = {}
    for world in WORLDS:
        names = list(CASES)
        cases = [_port_case(CASES[n][0], CASES[n][2], setup) for n in names]
        for stage in (2, 3):
            names.append(f"golden_zero{stage}")
            cases.append(dict(_port_case("gpt2", dict(
                GOLDEN_CFG, zero_optimization=_config(ADAM, stage)[
                    "zero_optimization"]), setup),
                batches=setup["gpt2"][0]))
            # the reference's manual loop: backward without the
            # reduction, allreduce_gradients(), step()
            names.append(f"manual_allreduce_zero{stage}")
            cases.append(_port_case("gpt2", CASES[
                f"fused_adam_clip_zero{stage}"][2], setup,
                manual_allreduce=True))
            # a client optimizer without takes_slices: whole tensors
            names.append(f"client_lamb_zero{stage}")
            cases.append(_port_case("gpt2", _config(ADAM, stage), setup,
                                    client="lamb"))
        res = worker.run("engine", world,
                         str(tmp_path_factory.mktemp(f"zero{world}")),
                         cases)
        assert all(r["jax_modules"] == [] for r in res)
        out[world] = {n: [r["cases"][i] for r in res]
                      for i, n in enumerate(names)}
    return out


_JAX_RUNS = {}


def _jax_engine(kind, cfg, ndev, batches):
    """The JAX engine's losses, masters, skipped steps and eval loss on an
    ``ndev``-device mesh, once a configuration."""
    key = (kind, repr(sorted(cfg.items())), ndev)
    if key not in _JAX_RUNS:
        groups.destroy()
        groups.initialize(devices=jax.devices()[:ndev])
        engine, *_ = deepspeed_tpu.initialize(
            model=_jax_model(kind), config=copy.deepcopy(cfg),
            sample_batch=batches[0], seed=oracle.SEED)
        gas = engine.gradient_accumulation_steps()
        mb = oracle.BATCH_SIZE // gas
        losses = [float(engine.train_batch(data_iter=iter(
            {k: v[i * mb:(i + 1) * mb] for k, v in b.items()}
            for i in range(gas)))) for b in batches]
        to_sd = (simple_flax_to_state_dict if kind == "embedding"
                 else flax_to_state_dict)
        params = to_sd(jax.tree.map(np.asarray, engine.state.params))
        ev = (None if kind == "embedding"
              else float(engine.eval_batch(batches[0])))
        _JAX_RUNS[key] = (losses, {k: v.numpy() for k, v in params.items()},
                          int(engine.skipped_steps), ev)
        groups.destroy()
    return _JAX_RUNS[key]


def _assert_params(got, want, **tol):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **tol)


JAX_PAIRS = [(n, w) for w in WORLDS for n in CASES]


@pytest.mark.parametrize("name,world", JAX_PAIRS)
def test_matches_jax_engine_on_a_mesh(setup, port, name, world):
    """Losses, masters (gathered from the ranks' slices at stage 3) and
    the eval loss against the JAX engine on a ``world``-device mesh;
    every rank's masters equal; an fp16 overflow on one rank's rows skips
    the step on every rank, as in JAX."""
    kind, jax_cfg, _ = CASES[name]
    batches = setup[kind][0][:STEPS]
    want_losses, want_params, want_skipped, want_eval = _jax_engine(
        kind, jax_cfg, world, batches)
    ranks = port[world][name]
    got = ranks[0]
    for r in ranks[1:]:
        assert r["losses"] == got["losses"]
        for k, p in got["params"].items():
            assert np.array_equal(r["params"][k], p), k
    if name.startswith("gas2"):
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5,
                                   atol=1e-5)
        _assert_params(got["params"], want_params, rtol=0, atol=1e-4)
    elif name.startswith("fp16"):
        assert [r["skipped"] for r in ranks] == [want_skipped] * world
        assert want_skipped == 1
        np.testing.assert_allclose(got["losses"], want_losses, **FP16_TOL)
        _assert_params(got["params"], want_params, **FP16_TOL)
    else:
        np.testing.assert_allclose(got["losses"], want_losses, **TOL)
        _assert_params(got["params"], want_params, **TOL)
    if want_eval is not None:
        np.testing.assert_allclose(got["eval"], want_eval, rtol=1e-5)
    if "clip" in name:
        # the norm of the reduced slices summed over the ranks: one value
        assert len({r["last_norm"] for r in ranks}) == 1


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("stage", (2, 3))
def test_golden_curve(port, world, stage):
    """``gpt2_tiny_fp32_adam`` (20 steps, fp32 Adam) at 1e-4."""
    with open(GOLDEN) as f:
        golden = json.load(f)["losses"]
    for r in port[world][f"golden_zero{stage}"]:
        np.testing.assert_allclose(r["losses"], golden, **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_stages_keep_a_worlds_share(setup, port, world):
    """Stage 2 keeps the optimizer state of the rank's slices; stage 3
    also only the masters' slices (the persistent tensors whole): a
    world'th of the model, up to those whole tensors."""
    init = setup["gpt2"][1]
    n = sum(v.numel() for v in init.values())
    whole = sum(v.numel() for v in init.values()
                if v.numel() < PERSIST["gpt2"])
    for stage in (2, 3):
        r = port[world][f"fused_adam_clip_zero{stage}"][0]
        assert n / world <= r["state_numel"] / 2 <= n / world + whole
        masters = r["masters_numel"]
        if stage == 2:
            assert masters == n
        else:
            assert n / world <= masters <= n / world + whole
            assert masters == (n - whole) / world + whole


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("stage", (2, 3))
def test_manual_allreduce_equals_train_batch(port, world, stage):
    """``backward(allreduce_gradients=False)``, ``allreduce_gradients()``
    (stage 2: the reduce-scatter, its slices kept for ``step``; stage 3
    reduces in the backward) and ``step()`` take ``train_batch``'s step
    bit for bit."""
    manual = port[world][f"manual_allreduce_zero{stage}"][0]
    auto = port[world][f"fused_adam_clip_zero{stage}"][0]
    assert manual["losses"] == auto["losses"]
    for k, p in auto["params"].items():
        assert np.array_equal(manual["params"][k], p), k


@pytest.mark.parametrize("stage", (2, 3))
def test_client_optimizer_without_slices_sees_whole_tensors(setup, port,
                                                            stage):
    """A client optimizer that does not take slices (LAMB without
    ``partition=``) gets the gathered gradients (and at stage 3 the
    gathered masters, its update cut back to the slices): worlds 2 and
    4 take the steps of one rank."""
    from deepspeed_tpu_torch.runtime import optim
    batches, init = setup["gpt2"]
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=worker.make_model({"model": "gpt2"}),
        config=copy.deepcopy(_config(ADAM, stage)), model_parameters=init,
        device="cpu", optimizer=optim.lamb(weight_decay=0.01))
    losses = [float(engine.train_batch(batch=b)) for b in batches[:STEPS]]
    want = {k: p.detach().numpy() for k, p in engine.params.items()}
    for world in WORLDS:
        for r in port[world][f"client_lamb_zero{stage}"]:
            np.testing.assert_allclose(r["losses"], losses, **TOL)
            _assert_params(r["params"], want, **TOL)
