"""Port -> port resume on the CPU: ``save_checkpoint`` after 3 steps, a
fresh engine from another init ``load_checkpoint``s the tag, and its next
3 steps are bit-equal (``torch.equal``) to the uninterrupted run's: the
losses, the fp32 masters, the optimizer state, the loss-scale state and
every counter.

The cases: each optimizer the port has (Adam's sweep and per-tensor
forms, plain Adam, AdamW with decay, LAMB fused and plain, SGD with
momentum, Adagrad), gas 2 through ``forward`` / ``backward`` / ``step``,
dropout 0.1 (masks keyed by (seed, micro_steps)), WarmupLR, and fp16 with
an overflow before the save (``loss_scale``, ``good_steps`` and
``hysteresis`` restored). Then the load options as JAX has them
(``load_module_only``, ``load_optimizer_states=False``), ``client_state``
and a ``data_iter`` position, the async snapshot owning its bytes, a
mismatched optimizer's state refused, a user module saved under its
``state_dict`` names, the MoE layout refused, and ``init_inference``'s
refusals of what is not ported.
"""

import dataclasses
import pickle
import time

import pytest
import torch
from torch import nn

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.ops.adam.fused_adam import AdamSweepState
from deepspeed_tpu_torch.runtime import checkpoint_io

STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(opt="Adam", gas=1, **over):
    params = {"lr": 1e-2 if opt in ("SGD", "Adagrad") else 2e-3}
    cfg = {"train_batch_size": 8,
           "train_micro_batch_size_per_gpu": 8 // gas,
           "steps_per_print": 10 ** 9, "gradient_clipping": 1.0,
           "optimizer": {"type": opt, "params": params}}
    cfg.update(over)
    return cfg


def _engine(cfg, seed=0, model_cfg=None):
    model = gpt2.GPT2LMHeadModel(model_cfg or gpt2.PRESETS["tiny"],
                                 device="cpu", seed=seed)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                device="cpu")
    return engine


BATCHES = [gpt2.synthetic_batch(8, 32, 512, seed=100 + i, device="cpu")
           for i in range(2 * STEPS)]


def _steps(engine, batches):
    """One global step a batch through the loop users write (gas
    micro-batches of ``forward`` / ``backward``, then ``step``)."""
    gas = engine.gradient_accumulation_steps()
    losses = []
    for b in batches:
        mb = 8 // gas
        for i in range(gas):
            loss = engine.forward({"input_ids":
                                   b["input_ids"][i * mb:(i + 1) * mb]})
            engine.backward(loss)
            losses.append(loss.detach().clone())
        engine.step()
    return losses


def _flat_state(state):
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if isinstance(v, dict):
            out.update({f"{f}.{k}": t for k, t in v.items()})
        elif isinstance(v, torch.Tensor):
            out[f] = v
        elif v != ():
            out[f] = torch.tensor(v)
    return out


def _assert_bit_equal(a, b):
    assert (a.global_steps, a.global_samples, a.micro_steps,
            a.skipped_steps, a.step_count, tuple(a.scale)) == \
        (b.global_steps, b.global_samples, b.micro_steps, b.skipped_steps,
         b.step_count, tuple(b.scale))
    for k, p in a.params.items():
        assert torch.equal(p, b.params[k]), k
    sa, sb = _flat_state(a.opt_state), _flat_state(b.opt_state)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _resume(tmp_path, cfg, model_cfg=None, before=None):
    """(uninterrupted engine, resumed engine, their losses after the
    save). ``before(engine, i)`` runs ahead of step i of the first 3."""
    a = _engine(cfg, model_cfg=model_cfg)
    for i, b in enumerate(BATCHES[:STEPS]):
        if before is not None:
            before(a, i)
        _steps(a, [b])
    a.save_checkpoint(str(tmp_path))
    ref = _steps(a, BATCHES[STEPS:])
    r = _engine(cfg, seed=5, model_cfg=model_cfg)
    r.load_checkpoint(str(tmp_path))
    got = _steps(r, BATCHES[STEPS:])
    return a, r, ref, got


OPTIMIZERS = {
    "adam_sweep": ("Adam", {"sweep": True}),
    "adam_fused": ("Adam", {"fused": True}),
    "adam": ("Adam", {}),
    "adamw_decay": ("AdamW", {"weight_decay": 0.01}),
    "lamb_fused": ("Lamb", {"fused": True, "weight_decay": 0.01}),
    "lamb": ("Lamb", {}),
    "sgd_momentum": ("SGD", {"momentum": 0.9}),
    "adagrad": ("Adagrad", {}),
}


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_resume_is_bit_equal_for_every_optimizer(tmp_path, name):
    opt, extra = OPTIMIZERS[name]
    cfg = _config(opt)
    cfg["optimizer"]["params"].update(extra)
    a, r, ref, got = _resume(tmp_path, cfg)
    assert all(torch.equal(x, y) for x, y in zip(ref, got))
    _assert_bit_equal(a, r)
    assert a.global_steps == 2 * STEPS


@pytest.mark.parametrize("case", ["gas2", "dropout", "warmup_lr",
                                  "bf16_gas2_acc"])
def test_resume_is_bit_equal_through_the_loop(tmp_path, case):
    model_cfg = None
    if case == "gas2":
        cfg = _config("Adam", gas=2)
    elif case == "dropout":
        cfg = _config("Adam", gas=2)
        model_cfg = dataclasses.replace(gpt2.PRESETS["tiny"], dropout=0.1)
    elif case == "warmup_lr":
        cfg = _config("AdamW", scheduler={"type": "WarmupLR", "params": {
            "warmup_min_lr": 1e-4, "warmup_max_lr": 2e-3,
            "warmup_num_steps": 5}})
    else:
        cfg = _config("Adam", gas=2, bf16={"enabled": True},
                      gradient_accumulation_dtype="bf16")
    a, r, ref, got = _resume(tmp_path, cfg, model_cfg=model_cfg)
    assert all(torch.equal(x, y) for x, y in zip(ref, got))
    _assert_bit_equal(a, r)
    if case == "dropout":
        # the masks matter: the same steps without dropout differ
        plain = _engine(_config("Adam", gas=2))
        plain.load_checkpoint(str(tmp_path))
        assert not torch.equal(_steps(plain, BATCHES[STEPS:])[0], ref[0])
    if case == "warmup_lr":
        assert r.lr_scheduler.last_batch_iteration == 2 * STEPS - 1
        assert r.get_lr() == a.get_lr()


def test_fp16_resume_restores_the_loss_scale_state(tmp_path):
    """An overflow before the save: skipped_steps 1, the hysteresis
    consumed, good_steps counting toward a scale window of 2. The resumed
    run doubles the scale on the same step as the uninterrupted one."""
    cfg = _config("Adam", fp16={"enabled": True, "loss_scale": 0,
                                "initial_scale_power": 8,
                                "loss_scale_window": 2})
    held = {}

    def overflow_on_step_1(engine, i):
        w = engine.params["wte"]
        with torch.no_grad():
            if i == 1:
                held["x"] = w[0, 0].clone()
                w[0, 0] = float("inf")
            elif i == 2:
                w[0, 0] = held["x"]

    a, r, ref, got = _resume(tmp_path, cfg, before=overflow_on_step_1)
    assert all(torch.equal(x, y) for x, y in zip(ref, got))
    _assert_bit_equal(a, r)
    assert a.skipped_steps == 1 and a.step_count == 2 * STEPS - 1
    sd = checkpoint_io.load_file(str(
        tmp_path / "global_step3" / "zero_pp_rank_0_mp_rank_00_optim_states"
        ".pt"))
    assert int(sd["scale_state"]["hysteresis"]) == 1
    assert int(sd["scale_state"]["good_steps"]) == 1


def test_load_options_behave_as_in_jax(tmp_path):
    a = _engine(_config("Adam", scheduler={"type": "WarmupLR", "params": {
        "warmup_num_steps": 10}}))
    _steps(a, BATCHES[:STEPS])
    a.save_checkpoint(str(tmp_path), tag="t", client_state={"epoch": 4})

    only = _engine(_config("Adam"), seed=5)
    path, client = only.load_checkpoint(str(tmp_path), tag="t",
                                        load_module_only=True)
    assert client == {"epoch": 4}
    assert all(torch.equal(p, only.params[k]) for k, p in a.params.items())
    assert (only.global_steps, only.step_count, only.opt_state.step) == \
        (0, 0, 0)
    assert all(not t.any() for t in only.opt_state.mu.values())

    fresh = _engine(_config("Adam", scheduler={"type": "WarmupLR",
                                               "params": {
                                                   "warmup_num_steps": 10}}),
                    seed=5)
    fresh.load_checkpoint(str(tmp_path), tag="t",
                          load_optimizer_states=False)
    assert all(torch.equal(p, fresh.params[k]) for k, p in a.params.items())
    assert (fresh.global_steps, fresh.step_count, fresh.micro_steps) == \
        (STEPS, STEPS, STEPS)
    assert fresh.lr_scheduler.last_batch_iteration == STEPS - 1
    # JAX keeps the engine's own optimizer state here (fresh moments)
    assert fresh.opt_state.step == 0
    assert all(not t.any() for t in fresh.opt_state.mu.values())

    nosched = _engine(_config("Adam", scheduler={"type": "WarmupLR",
                                                 "params": {
                                                     "warmup_num_steps": 10}}),
                      seed=5)
    nosched.load_checkpoint(str(tmp_path), tag="t",
                            load_lr_scheduler_states=False)
    assert nosched.lr_scheduler.last_batch_iteration == -1
    assert nosched.opt_state.step == STEPS


class _Stream:
    def __init__(self, pos=0):
        self.pos = pos

    def state_dict(self):
        return {"pos": self.pos}

    def load_state_dict(self, sd):
        self.pos = sd["pos"]


def test_data_iter_position_round_trips(tmp_path):
    a = _engine(_config("Adam"))
    _steps(a, BATCHES[:1])
    a.save_checkpoint(str(tmp_path), data_iter=_Stream(17))
    it = _Stream()
    _engine(_config("Adam"), seed=5).load_checkpoint(str(tmp_path),
                                                     data_iter=it)
    assert it.pos == 17
    sd = checkpoint_io.load_file(str(tmp_path / "global_step1" /
                                     "mp_rank_00_model_states.pt"))
    assert sd["data_iterator"] == {"pos": 17}
    # an iterator without state_dict saves nothing; loading one without
    # load_state_dict leaves it as it is
    a.save_checkpoint(str(tmp_path), tag="plain", data_iter=iter([]))
    assert checkpoint_io.load_file(str(
        tmp_path / "plain" / "mp_rank_00_model_states.pt"))[
            "data_iterator"] is None


def test_async_snapshot_owns_its_bytes(tmp_path, monkeypatch):
    """The step after an async save changes the masters in place while the
    persist is still waiting: the files hold the weights at the save."""
    a = _engine(_config("Adam", checkpoint={"async_save": True}))
    _steps(a, BATCHES[:2])
    at_save = {k: p.detach().clone() for k, p in a.params.items()}
    mu_at_save = {k: t.clone() for k, t in a.opt_state.mu.items()}
    real_dump = checkpoint_io.dump_file

    def late_dump(obj, path, kind="checkpoint"):
        time.sleep(0.3)
        return real_dump(obj, path, kind)

    monkeypatch.setattr(checkpoint_io, "dump_file", late_dump)
    a.save_checkpoint(str(tmp_path), tag="t")
    _steps(a, BATCHES[2:3])            # runs while the persist sleeps
    assert a._ckpt_writer.in_flight
    a._ckpt_writer.drain()
    assert not torch.equal(a.params["wte"], at_save["wte"])
    r = _engine(_config("Adam"), seed=5)
    r.load_checkpoint(str(tmp_path), tag="t")
    for k, p in at_save.items():
        assert torch.equal(r.params[k], p), k
        assert torch.equal(r.opt_state.mu[k], mu_at_save[k]), k
    a.close()


@pytest.mark.parametrize("saved,loader,error", [
    ("adam_sweep", "adam", KeyError),
    ("adam", "adam_sweep", KeyError),
    ("lamb", "adam", ValueError),
    ("sgd_momentum", "adagrad", ValueError),
])
def test_mismatched_optimizer_state_raises(tmp_path, saved, loader, error):
    """Another optimizer's state is refused with a clear error, never
    replaced by fresh moments: the sweep's vector and the per-tensor
    leaves have other key paths (``restore_tree``'s KeyError, as in JAX);
    LAMB's moments have Adam's paths, so the saved config decides."""
    cfgs = {}
    for name in (saved, loader):
        opt, extra = OPTIMIZERS[name]
        cfgs[name] = _config(opt)
        cfgs[name]["optimizer"]["params"].update(extra)
    a = _engine(cfgs[saved])
    _steps(a, BATCHES[:1])
    a.save_checkpoint(str(tmp_path))
    r = _engine(cfgs[loader], seed=5)
    before = {k: p.detach().clone() for k, p in r.params.items()}
    with pytest.raises(error, match="optimizer|missing leaf"):
        r.load_checkpoint(str(tmp_path))
    assert all(torch.equal(p, before[k]) for k, p in r.params.items())
    assert r.global_steps == 0
    r.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    assert r.global_steps == 1


def test_sweep_tag_holds_the_jax_leaf_order(tmp_path):
    """The sweep's saved ``.mu`` is JAX's order: the flax tree flattened
    with sorted keys (``h_10`` before ``h_2``), kernels ``[in, out]``."""
    from deepspeed_tpu_torch import bridge
    cfg = _config("Adam")
    cfg["optimizer"]["params"]["sweep"] = True
    model_cfg = dataclasses.replace(gpt2.PRESETS["tiny"], n_layer=11)
    a = _engine(cfg, model_cfg=model_cfg)
    _steps(a, BATCHES[:1])
    a.save_checkpoint(str(tmp_path))
    z = checkpoint_io.load_file(str(
        tmp_path / "global_step1" / "zero_pp_rank_0_mp_rank_00_optim_states"
        ".pt"))
    mu = checkpoint_io.assemble([z["optimizer_state_dict"]])[".mu"]
    assert isinstance(a.opt_state, AdamSweepState)
    assert mu.shape == tuple(a.opt_state.mu.shape)
    table = bridge.layout_of(a.params)
    order = bridge.jax_order(table, list(a.params))
    assert order.index("h.10.ln_1.weight") < order.index("h.2.ln_1.weight")
    off = 0
    live = {k: a.opt_state.mu[o:o + p.numel()].view(p.shape)
            for k, p, o in _offsets(a.params)}
    for name in order:
        n = a.params[name].numel()
        perm = bridge.inverse(table[name][1])
        want = live[name] if perm is None else live[name].permute(perm)
        assert torch.equal(torch.from_numpy(mu[off:off + n]),
                           want.reshape(-1)), name
        off += n


def _offsets(params):
    off = 0
    for k, p in params.items():
        yield k, p, off
        off += p.numel()


class _UserNet(nn.Module):
    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.enc = nn.Linear(16, 32)
        self.head = nn.Linear(32, 1, bias=False)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)

    def forward(self, batch):
        x, y = batch
        return torch.mean((self.head(torch.tanh(self.enc(x))) - y) ** 2)


def test_user_module_saves_under_its_state_dict_names(tmp_path):
    def engine(seed):
        return deepspeed_tpu_torch.initialize(
            model=_UserNet(seed), config=_config("Adam"), device="cpu")[0]

    g = torch.Generator().manual_seed(0)
    batches = [(torch.randn(8, 16, generator=g), torch.randn(8, 1,
                                                             generator=g))
               for _ in range(4)]
    a = engine(0)
    for b in batches[:2]:
        a.train_batch(batch=b)
    a.save_checkpoint(str(tmp_path))
    sd = checkpoint_io.load_file(str(tmp_path / "global_step2" /
                                     "mp_rank_00_model_states.pt"))
    assert sorted(sd["module"]) == ["enc.bias", "enc.weight", "head.weight"]
    ref = [a.train_batch(batch=b) for b in batches[2:]]
    r = engine(1)
    r.load_checkpoint(str(tmp_path))
    assert all(torch.equal(x, r.train_batch(batch=b))
               for x, b in zip(ref, batches[2:]))
    _assert_bit_equal(a, r)


def test_moe_layout_is_refused(tmp_path):
    a = _engine(_config("Adam"))
    a.save_checkpoint(str(tmp_path), tag="t")
    path = tmp_path / "t" / "mp_rank_00_model_states.pt"
    sd = checkpoint_io.load_file(str(path))
    sd["has_moe_layers"] = True
    with open(path, "wb") as f:
        pickle.dump(sd, f)
    (tmp_path / "t" / "manifest.json").unlink()
    with pytest.raises(NotImplementedError, match="MoE"):
        _engine(_config("Adam")).load_checkpoint(str(tmp_path), tag="t")


def test_save_16bit_model_dtype_follows_compute(tmp_path):
    a = _engine(_config("Adam", fp16={"enabled": True}))
    a.save_16bit_model(str(tmp_path))
    sd = torch.load(tmp_path / "pytorch_model.bin", weights_only=True)
    assert {t.dtype for t in sd.values()} == {torch.float16}
    assert torch.equal(sd["wte"], a.params["wte"].detach().half())


def test_inference_refuses_what_is_not_ported(tmp_path):
    make = lambda: gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    desc = tmp_path / "megatron.json"
    desc.write_text("{}")
    with pytest.raises(NotImplementedError, match="Megatron"):
        deepspeed_tpu_torch.init_inference(make(), checkpoint=str(desc),
                                           device="cpu")
    with pytest.raises(NotImplementedError, match="weight_quantizer"):
        deepspeed_tpu_torch.init_inference(make(), quantization_setting=8,
                                           device="cpu")
    hf = tmp_path / "hf.bin"
    torch.save({"transformer.wte.weight": torch.zeros(4)}, hf)
    with pytest.raises(NotImplementedError, match="HF/Megatron"):
        deepspeed_tpu_torch.init_inference(make(), checkpoint=str(hf),
                                           device="cpu")


def test_sweep_state_of_a_larger_model_is_refused(tmp_path):
    """The sweep vector's saved length is read: a deeper model's moments
    (more than one padding quantum longer) do not load into a shallower
    one, even with the module check relaxed."""
    cfg = _config("Adam")
    cfg["optimizer"]["params"]["sweep"] = True
    deep = _engine(cfg, model_cfg=dataclasses.replace(gpt2.PRESETS["tiny"],
                                                       n_layer=4))
    _steps(deep, BATCHES[:1])
    deep.save_checkpoint(str(tmp_path))
    shallow = _engine(cfg)
    with pytest.raises(ValueError, match="more than this model"):
        shallow.load_checkpoint(str(tmp_path), load_module_strict=False)
