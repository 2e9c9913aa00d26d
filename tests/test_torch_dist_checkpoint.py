"""Checkpoints of the PyTorch port at world sizes above one (gloo ranks
spawned by ``tests/torch_dist_worker.py``), against its own world sizes
and the JAX engine, on the CPU.

A world-2 engine (tiny GPT-2 with 3 layers, so JAX's sorted leaf order,
``h_0 h_1 h_2 ln_f wpe wte``, differs from the port's; bs 8 × seq 32)
trains 2 steps, saves, and trains 2 more: the reference the loaders
continue to. Each rank writes its ``zero_pp_rank_{r}`` file of index-keyed
boxes; rank 0 the model states, the manifest and ``latest``. The tag
loads at world 1, 2 and 4 and into the JAX engine on a 2-device mesh; the
JAX engine's tags from a 2- and an 8-device mesh load into the port at
world 2 and 4. The optimizers: Adam's sweep (a flat vector in chunks,
reordered to JAX's leaf order at the save) and fused AdamW (per-tensor
slices). Tolerances: the world-2 resume is bit-equal to the uninterrupted
run; across world sizes and engines, losses and masters at rtol = atol =
1e-4 (``tests/test_torch_engine.py``'s fp32 bound: the averaged gradients
sum in another order).
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.bridge import flax_to_state_dict
from deepspeed_tpu_torch.runtime import checkpoint_io
from deepspeed_tpu_torch.utils import zero_to_fp32
from tests import torch_dist_worker as worker
from tests.model import oracle

TOL = dict(rtol=1e-4, atol=1e-4)
N_LAYER = 3
ADAMW = {"type": "AdamW", "params": {"lr": 2e-3, "weight_decay": 0.01}}
OPTS = {"sweep": (dict(ADAMW, params=dict(ADAMW["params"], sweep=True)),) * 2,
        "fused": (ADAMW, dict(ADAMW, params=dict(ADAMW["params"],
                                                 fused=True)))}


def _config(opt, port=True, **ckpt):
    return {"train_batch_size": oracle.BATCH_SIZE,
            "steps_per_print": 10 ** 9, "gradient_clipping": 1.0,
            "optimizer": copy.deepcopy(OPTS[opt][1 if port else 0]),
            "zero_optimization": {"stage": 1}, "checkpoint": ckpt}


def _jax_engine(opt, ndev, batch0):
    groups.destroy()
    groups.initialize(devices=jax.devices()[:ndev])
    engine, *_ = deepspeed_tpu.initialize(
        model=jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(
            **dict(oracle.TINY, n_layer=N_LAYER))),
        config=_config(opt, port=False), sample_batch=batch0,
        seed=oracle.SEED)
    return engine


def _jax_params(engine):
    sd = flax_to_state_dict(jax.tree.map(np.asarray, engine.state.params))
    return {k: v.numpy() for k, v in sd.items()}


def _assert_params(got, want, **tol):
    assert set(got) == set(want)
    for k, w in want.items():
        if tol:
            np.testing.assert_allclose(got[k], w, err_msg=k, **tol)
        else:
            assert np.array_equal(got[k], w), k


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every save and load, in two spawns (world 2 saves, loads JAX's
    tags and validates tags; world 4 loads), the JAX engines in this
    process, and the port at world 1."""
    root = str(tmp_path_factory.mktemp("ckpt"))
    batches = [{"input_ids": np.array(b["input_ids"])}
               for b in oracle.make_batches(4)]
    first, then = batches[:2], batches[2:]
    jmodel = jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(
        **dict(oracle.TINY, n_layer=N_LAYER)))
    init = flax_to_state_dict(jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(oracle.SEED), batches[0])["params"]))
    model_cfg = {"n_layer": N_LAYER}
    out = {"root": root, "init": init}

    # the JAX engine's tags: 2 steps, save, 2 steps (the reference); the
    # sweep's from a 2- and an 8-device mesh, per-tensor Adam's from the
    # 8-device one
    jax_ref = {}
    for opt in OPTS:
        for ndev in (2, 8) if opt == "sweep" else (8,):
            eng = _jax_engine(opt, ndev, batches[0])
            for b in first:
                eng.train_batch(batch=b)
            eng.save_checkpoint(root, tag=f"jax_{opt}_dp{ndev}")
            jax_ref[opt, ndev] = ([float(eng.train_batch(batch=b))
                                   for b in then], _jax_params(eng))
    out["jax_ref"] = jax_ref

    def case(opt, **kw):
        cfg = _config(opt, **kw.pop("ckpt", {}))
        return dict(model="gpt2", model_cfg=model_cfg, config=cfg,
                    init=init, dir=root, **kw)

    w2 = []
    for opt in OPTS:
        w2.append(case(opt, batches=first, save=True, tag=f"port_{opt}",
                       after=then))
        w2.append(case(opt, batches=first, save=True,
                       tag=f"port_{opt}_async", after=then,
                       ckpt={"async_save": True}))
        w2.append(case(opt, load=True, load_tag=f"port_{opt}", after=then,
                       seed=1))
        for ndev in (2, 8) if opt == "sweep" else (8,):
            w2.append(case(opt, load=True, load_tag=f"jax_{opt}_dp{ndev}",
                           after=then, seed=1))
    w4 = [case(opt, load=True, load_tag=tag, after=then, seed=1)
          for opt in OPTS for tag in (f"port_{opt}", f"jax_{opt}_dp8")]
    # BERT at world 4: the token-type table [2, 64] is cut on dimension
    # 1 (strided boxes), the LAMB moments on their leading dimension
    bert_batches = [{k: np.asarray(v) for k, v in
                     jax_bert.synthetic_mlm_batch(
                         oracle.BATCH_SIZE, oracle.SEQ_LEN,
                         oracle.TINY_BERT["vocab_size"], seed=2000 + i,
                         masked_positions_format=True).items()}
                    for i in range(4)]
    bert_init = bridge.bert_flax_to_state_dict(jax.tree.map(
        np.asarray, jax_bert.BertForPreTraining(jax_bert.BertConfig(
            **oracle.TINY_BERT)).init(jax.random.PRNGKey(oracle.SEED),
                                      bert_batches[0])["params"]))
    bert_cfg = dict(_config("fused"), optimizer={
        "type": "Lamb", "params": {"lr": 2e-3, "fused": True}})
    w4.append(dict(model="bert", model_cfg=oracle.TINY_BERT,
                   config=bert_cfg, init=bert_init, dir=root,
                   batches=bert_batches[:2], save=True, tag="port_bert_w4",
                   after=bert_batches[2:]))
    out["bert"] = (bert_cfg, bert_batches)
    valid = [case("sweep", save=True, tag="fail", rank_tags=True,
                  ckpt={"tag_validation": "Fail"}),
             case("sweep", save=True, tag="warn", rank_steps=True,
                  ckpt={"tag_validation": "Warn"}),
             case("sweep", save=True, tag="ignore", rank_steps=True,
                  ckpt={"tag_validation": "Ignore"})]
    for name, world, cases in (("w2", 2, w2 + valid), ("w4", 4, w4)):
        res = worker.run("checkpoint", world,
                         str(tmp_path_factory.mktemp(name)), cases)
        assert all(r["jax_modules"] == [] for r in res)
        out[name] = [[r["cases"][i] for r in res] for i in range(len(cases))]
    out["valid"] = out["w2"][len(w2):]

    # the JAX engine on a 2-device mesh loads the port's world-2 tags
    jax_loads = {}
    for opt in OPTS:
        eng = _jax_engine(opt, 2, batches[0])
        eng.load_checkpoint(root, tag=f"port_{opt}")
        jax_loads[opt] = ([float(eng.train_batch(batch=b)) for b in then],
                          _jax_params(eng))
    out["jax_loads"] = jax_loads

    # the port at world 1 loads the world-2 tags
    w1 = {}
    for opt in OPTS:
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=worker.make_model({"model": "gpt2",
                                     "model_cfg": model_cfg}, seed=1),
            config=_config(opt), device="cpu")
        eng.load_checkpoint(root, tag=f"port_{opt}")
        w1[opt] = ([float(eng.train_batch(batch=b)) for b in then],
                   {k: p.detach().numpy() for k, p in eng.params.items()})
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=worker.make_model({"model": "bert",
                                 "model_cfg": oracle.TINY_BERT}, seed=1),
        config=bert_cfg, device="cpu")
    eng.load_checkpoint(root, tag="port_bert_w4")
    w1["bert"] = ([float(eng.train_batch(batch=b))
                   for b in bert_batches[2:]],
                  {k: p.detach().numpy() for k, p in eng.params.items()})
    out["w1"] = w1
    return out


# run["w2"]: the sweep's save, async save, port load, JAX dp-2 and dp-8
# loads; then fused Adam's save, async save, port load, JAX dp-8 load
W2 = {"sweep": {"save": 0, "async": 1, "port": 2, "jax2": 3, "jax8": 4},
      "fused": {"save": 5, "async": 6, "port": 7, "jax8": 8}}


def _saver(run, opt, async_save=False):
    return run["w2"][W2[opt]["async" if async_save else "save"]]


def _w2_load(run, opt, what):
    return run["w2"][W2[opt][what]]


@pytest.mark.parametrize("opt", list(OPTS))
def test_world2_save_writes_every_ranks_file(run, opt):
    """Two rank files, the model states and the manifest, which records
    world 2; ``latest`` written."""
    assert os.path.isfile(os.path.join(run["root"], "latest"))
    for async_save in (False, True):
        ranks = _saver(run, opt, async_save)
        tag = f"port_{opt}" + ("_async" if async_save else "")
        assert all(r["error"] is None for r in ranks)
        assert ranks[0]["files"] == [
            "manifest.json", "mp_rank_00_model_states.pt",
            "zero_pp_rank_0_mp_rank_00_optim_states.pt",
            "zero_pp_rank_1_mp_rank_00_optim_states.pt"]
        tag_dir = os.path.join(run["root"], tag)
        assert checkpoint_io.verify_tag(tag_dir) == ("intact", "")
        doc = checkpoint_io.load_manifest(tag_dir)
        assert doc["dp_world_size"] == 2 and doc["processes"] == 2
        zero = [checkpoint_io.load_file(os.path.join(
            tag_dir, f"zero_pp_rank_{r}_mp_rank_00_optim_states.pt"))
            for r in range(2)]
        assert [z["partition_count"] for z in zero] == [2, 2]
        # rank 1 writes its boxes (rank 0 also the replicated leaves):
        # the two ranks' boxes of a leaf are disjoint halves of it
        opt1 = zero[1]["optimizer_state_dict"]
        assert (".mu" in opt1) == (opt == "sweep") and len(opt1) > 1
        for path, rec in opt1.items():
            if not rec["shape"]:
                continue
            (k1, a1), = rec["shards"]
            (k0, a0), = zero[0]["optimizer_state_dict"][path]["shards"]
            assert k0 != k1 and a0.size == a1.size == \
                np.prod(rec["shape"]) // 2, path


@pytest.mark.parametrize("opt", list(OPTS))
def test_async_save_equals_the_sync_save(run, opt):
    sync, async_ = _saver(run, opt), _saver(run, opt, True)
    assert [r["after"] for r in sync] == [r["after"] for r in async_]
    for name in ("mp_rank_00_model_states.pt",
                 "zero_pp_rank_0_mp_rank_00_optim_states.pt",
                 "zero_pp_rank_1_mp_rank_00_optim_states.pt"):
        a = checkpoint_io.load_file(os.path.join(run["root"], f"port_{opt}",
                                                 name))
        b = checkpoint_io.load_file(os.path.join(
            run["root"], f"port_{opt}_async", name))
        if "optimizer_state_dict" in a:
            a, b = a["optimizer_state_dict"], b["optimizer_state_dict"]
            assert set(a) == set(b)
            for k in a:
                assert np.array_equal(a[k]["shards"][0][1],
                                      b[k]["shards"][0][1]), k


@pytest.mark.parametrize("opt", list(OPTS))
def test_world2_resume_is_bit_equal(run, opt):
    saver, loaded = _saver(run, opt), _w2_load(run, opt, "port")
    assert loaded[0]["global_steps"] == 2
    assert loaded[0]["global_samples"] == 2 * oracle.BATCH_SIZE
    assert loaded[0]["client_state"] == {"rank_said": 0}
    assert [r["after"] for r in loaded] == [r["after"] for r in saver]
    for r in range(2):
        _assert_params(loaded[r]["params"], saver[r]["params"])


@pytest.mark.parametrize("opt", list(OPTS))
def test_world2_tag_resumes_at_world_1_and_4(run, opt):
    want_losses = _saver(run, opt)[0]["after"]
    want_params = _saver(run, opt)[0]["params"]
    losses, params = run["w1"][opt]
    np.testing.assert_allclose(losses, want_losses, **TOL)
    _assert_params(params, want_params, **TOL)
    w4 = run["w4"][list(OPTS).index(opt) * 2]
    for r in w4:
        np.testing.assert_allclose(r["after"], want_losses, **TOL)
        _assert_params(r["params"], want_params, **TOL)
    # each rank of world 4 keeps less state than a rank of world 2 (the
    # sweep's chunks are padded to sweep_pad() × world)
    assert w4[0]["state_numel"] < _w2_load(run, opt,
                                           "port")[0]["state_numel"]


@pytest.mark.parametrize("opt", list(OPTS))
def test_jax_loads_the_ports_world2_tag(run, opt):
    losses, params = run["jax_loads"][opt]
    saver = _saver(run, opt)[0]
    np.testing.assert_allclose(losses, saver["after"], **TOL)
    _assert_params(params, saver["params"], **TOL)


@pytest.mark.parametrize("opt,ndev", [("sweep", 2), ("sweep", 8),
                                      ("fused", 8)])
def test_port_loads_jax_mesh_tags(run, opt, ndev):
    """JAX's tags from a 2- and an 8-device mesh (one file of index-keyed
    shards, ``partition_count`` 2 or 8) load into the port at world 2,
    and the 8-device tag at world 4 too; training continues as the JAX
    engine's does."""
    want_losses, want_params = run["jax_ref"][opt, ndev]
    loads = [_w2_load(run, opt, f"jax{ndev}")]
    if ndev == 8:
        loads.append(run["w4"][list(OPTS).index(opt) * 2 + 1])
    for ranks in loads:
        for r in ranks:
            np.testing.assert_allclose(r["after"], want_losses, **TOL)
            _assert_params(r["params"], want_params, **TOL)


@pytest.mark.parametrize("opt", list(OPTS))
def test_zero_to_fp32_on_a_world2_tag(run, opt):
    """The consolidated fp32 dict of the two rank files is the masters at
    the save, bit for bit."""
    fp32 = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(
        run["root"], tag=f"port_{opt}")
    want = _saver(run, opt)[0]["params_at_save"]
    table = bridge.layout_of({k: torch.from_numpy(v)
                              for k, v in want.items()})
    assert len(fp32) == len(want)
    for name, w in want.items():
        arr = fp32[bridge.keystr(table[name][0])]
        perm = table[name][1]
        assert np.array_equal(arr if perm is None else arr.transpose(perm),
                              w), name


def test_tag_validation_across_ranks(run):
    """Ranks given different tags: ``Fail`` raises on every rank and
    writes nothing; ranks whose counters differ: ``Warn`` logs once
    (rank 0) and saves; ``Ignore`` compares nothing."""
    fail, warn, ignore = run["valid"]
    assert all(r["error"] and "checkpoint tag" in r["error"]
               and "Fail" in r["error"] for r in fail)
    assert all(r["files"] == [] for r in fail)
    assert [r["error"] for r in warn] == [None, None]
    assert any("mismatch" in w for w in warn[0]["warnings"])
    assert not any("mismatch" in w for w in warn[1]["warnings"])
    assert "mp_rank_00_model_states.pt" in warn[0]["files"]
    assert [r["error"] for r in ignore] == [None, None]
    assert not any("mismatch" in w for r in ignore for w in r["warnings"])


def test_world4_bert_tag_with_strided_boxes_resumes_at_world1(run):
    """Four rank files; the token-type table's boxes are column ranges
    (its 2 rows do not divide by 4); the tag resumes at world 1."""
    saver = run["w4"][-1]
    assert all(r["error"] is None for r in saver)
    assert [f for f in saver[0]["files"] if f.startswith("zero_pp")] == [
        f"zero_pp_rank_{r}_mp_rank_00_optim_states.pt" for r in range(4)]
    tag_dir = os.path.join(run["root"], "port_bert_w4")
    z = checkpoint_io.load_file(os.path.join(
        tag_dir, "zero_pp_rank_1_mp_rank_00_optim_states.pt"))
    (key, arr), = [rec for path, rec in z["param_shards"].items()
                   if "token_type" in path][0]["shards"]
    assert key == ((0, 2), (16, 32)) and arr.shape == (2, 16)
    losses, params = run["w1"]["bert"]
    np.testing.assert_allclose(losses, saver[0]["after"], **TOL)
    _assert_params(params, saver[0]["params"], **TOL)
