"""MoE in the PyTorch port (``deepspeed_tpu_torch/moe``, MoE-GPT) against
the JAX package on the CPU.

The JAX MoE code has no Pallas kernel and runs as it is. Inputs come from
numpy seeds; the port's tensors are fp32. Tolerances: the gating
functions' outputs at 1e-6 (the same fp32 ops; slots and masks exact);
the layer's outputs, ``l_aux`` and gradients at 1e-5; the tiny MoE-GPT's
loss and logits at 1e-5 and its gradients at 1e-5; engine steps against
the JAX engine at ``tests/test_torch_dist_engine.py``'s rtol = atol =
1e-4 (AdamW's normalised update turns a last-bit difference of a
gradient into ~1e-5).

JAX draws the RTS priorities, RSample normals and Gumbel noise from
threefry keys; the port's gate functions take the noise as tensors, so
the function tests draw JAX's noise from the key with JAX's own formula
and feed both. The model and engine tests run without noise (eval, or
training at a top-1 capacity where no token can drop, so slot order
cannot change the result).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.moe import layer as jax_layer
from deepspeed_tpu.moe import sharded_moe as jax_moe
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.moe import layer, sharded_moe
from tests.model import oracle
from tests.torch_threads import one_torch_thread  # noqa: F401

S, E, M = 24, 4, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _logits(seed=0, s=S, e=E):
    return np.random.default_rng(seed).standard_normal((s, e)).astype(
        np.float32)


@pytest.mark.parametrize("tokens,experts,cf,min_cap", [
    (24, 4, 1.0, 4), (24, 4, 1.25, 4), (7, 4, 1.0, 4), (8192, 8, 1.25, 4),
    (8, 8, 1.25, 4), (100, 3, 2.5, 1), (64, 8, 0.1, 2)])
def test_capacity_matches_jax(tokens, experts, cf, min_cap):
    assert sharded_moe._capacity(tokens, experts, cf, min_cap) == \
        jax_moe._capacity(tokens, experts, cf, min_cap)


def _check_dense(got, want):
    l_aux, combine, dispatch, counts = got
    np.testing.assert_allclose(l_aux.numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(combine.numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)
    assert np.array_equal(dispatch.numpy(), np.asarray(want[2]))
    assert np.array_equal(counts.numpy(), np.asarray(want[3]))


def _check_sparse(got, want):
    l_aux, routing, C, counts = got
    np.testing.assert_allclose(l_aux.numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    assert C == want[2]
    assert np.array_equal(counts.numpy(), np.asarray(want[3]))
    assert len(routing) == len(want[1])
    for (e, loc, g, v), (we, wloc, wg, wv) in zip(routing, want[1]):
        wv = np.asarray(wv)
        assert np.array_equal(v.numpy(), wv)
        assert np.array_equal(e.numpy(), np.asarray(we))
        # a dropped token's slot is not used; a live one's is exact
        assert np.array_equal(loc.numpy()[wv], np.asarray(wloc)[wv])
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-6,
                                   atol=1e-6)


TOP1_CASES = {
    # name: (capacity_factor, min_capacity, policy, rts, used, drop, key)
    "no_rng_drops": (1.0, 4, None, True, False, True, False),
    "rts_drops": (1.0, 4, None, True, False, True, True),
    "rts_rsample_drops": (0.75, 2, "RSample", True, False, True, True),
    "rsample_no_rts": (1.0, 4, "RSample", False, False, True, True),
    "used_token": (1.0, 4, None, True, True, True, True),
    "no_drop_tokens": (0.5, 4, None, True, False, False, True),
    "large_capacity": (4.0, 4, None, True, False, True, False),
}


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("name", list(TOP1_CASES))
def test_top1gating_matches_jax(name, sparse):
    """Dense and factored forms, with JAX's noise fed to the port: RTS
    priorities ``uniform(fold_in(k, 1), (S,))``, RSample normals
    ``normal(k, (S, E))``."""
    cf, min_cap, policy, rts, used, drop, keyed = TOP1_CASES[name]
    logits = _logits(1)
    key = jax.random.PRNGKey(3) if keyed else None
    used_np = (np.random.default_rng(2).random(S) > 0.3).astype(
        np.float32) if used else None
    want = jax_moe.top1gating(
        jnp.asarray(logits), cf, min_cap, policy, key, drop, rts,
        used_token=None if used_np is None else jnp.asarray(used_np),
        sparse=sparse)
    noise = priority = None
    if keyed:
        if policy == "RSample":
            noise = _t(jax.random.normal(key, (S, E)))
        if rts:
            priority = _t(jax.random.uniform(jax.random.fold_in(key, 1),
                                             (S,)))
    got = sharded_moe.top1gating(
        _t(logits), cf, min_cap, policy, noise, drop, rts,
        used_token=None if used_np is None else _t(used_np), sparse=sparse,
        priority=priority)
    (_check_sparse if sparse else _check_dense)(got, want)
    if drop and not sparse:
        # the cases with drops do drop
        assert float(got[2].sum()) < float((used_np if used else
                                            np.ones(S)).sum()) or \
            name == "large_capacity"


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("cf,min_cap,keyed", [
    (1.0, 4, False), (1.0, 4, True), (0.5, 2, True), (2.0, 4, True)])
def test_top2gating_matches_jax(cf, min_cap, keyed, sparse):
    """The second choice with JAX's Gumbel noise ``gumbel(k, (S, E))``
    fed to the port, or noise-free without a key."""
    logits = _logits(4)
    key = jax.random.PRNGKey(5) if keyed else None
    want = jax_moe.top2gating(jnp.asarray(logits), cf, min_cap, key,
                              sparse=sparse)
    gumbel = _t(jax.random.gumbel(key, (S, E))) if keyed else None
    got = sharded_moe.top2gating(_t(logits), cf, min_cap, gumbel,
                                 sparse=sparse)
    (_check_sparse if sparse else _check_dense)(got, want)


# ------------------------------------------------------------------- layer
def _moe_rows():
    """The bridge's MoE rows at the top of a tree."""
    return [(t[2:], tuple(f[2:].split("/")), perm)
            for t, f, perm in bridge._moe("x", "x")]


def _port_moe_state(params):
    out = {}
    for name, path, perm in _moe_rows():
        try:
            leaf = np.asarray(bridge.get_path(params, path))
        except KeyError:
            continue
        out[name] = torch.from_numpy(np.array(
            leaf if perm is None else np.transpose(leaf, perm)))
    return out


def _flax_grads(grads):
    return {n: (np.asarray(bridge.get_path(grads, path)) if perm is None
                else np.transpose(np.asarray(bridge.get_path(grads, path)),
                                  perm))
            for n, path, perm in _moe_rows()
            if _has(grads, path)}


def _has(tree, path):
    try:
        bridge.get_path(tree, path)
        return True
    except KeyError:
        return False


LAYER_KW = dict(capacity_factor=1.0, eval_capacity_factor=0.75,
                min_capacity=2)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("impl", ["scatter", "einsum", "grouped"])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_layer_matches_jax(k, impl, residual, train):
    """``MoE``: output, l_aux, exp_counts and every parameter's and the
    input's gradient (jax.grad against autograd) at capacities that
    drop tokens; train mode reads ``capacity_factor``, eval
    ``eval_capacity_factor``."""
    x = np.random.default_rng(7).standard_normal((S, M)).astype(np.float32)
    g_out = np.random.default_rng(8).standard_normal((S, M)).astype(
        np.float32)
    jm = jax_layer.MoE(hidden_size=M, num_experts=E, k=k,
                       use_residual=residual, dispatch_impl=impl, **LAYER_KW)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def jloss(p, xx):
        out, l_aux, _ = jm.apply({"params": p}, xx, train=train)
        return jnp.sum(out * g_out) + l_aux, (out, l_aux)

    (_, (jout, jl_aux)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    _, _, jcounts = jm.apply({"params": params}, jnp.asarray(x),
                             train=train)

    pm = layer.MoE(M, num_experts=E, k=k, use_residual=residual,
                   dispatch_impl=impl, **LAYER_KW)
    pm.load_state_dict(_port_moe_state(params))
    pm.train(train)
    xt = _t(x).requires_grad_()
    out, l_aux, counts = pm(xt)
    (torch.sum(out * _t(g_out)) + l_aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l_aux.item(), float(jl_aux), rtol=1e-6)
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    want = _flax_grads(jg)
    assert set(want) == set(dict(pm.named_parameters()))
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n], rtol=1e-5,
                                   atol=1e-5, err_msg=n)


def test_dispatch_impls_agree_bit_for_bit_at_top1():
    """scatter and einsum route each token to one slot: the outputs are
    equal bit for bit (JAX sharded_moe.py:313-324)."""
    x = torch.randn(64, M, generator=torch.Generator().manual_seed(1))
    outs = []
    for impl in ("scatter", "einsum"):
        m = layer.MoE(M, num_experts=E, dispatch_impl=impl, **LAYER_KW)
        m.reset_parameters(torch.Generator().manual_seed(0))
        outs.append(m(x))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


class _Doubler(torch.nn.Module):
    """A custom stacked expert: 2x."""

    def __init__(self, num_experts, hidden_size, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.full((num_experts, 1, 1), 2.0))

    def reset_parameters(self, *args):
        pass

    def forward(self, x):
        return x * self.scale


def test_grouped_refuses_a_custom_expert_as_jax_does():
    with pytest.raises(NotImplementedError, match="MLPExpert"):
        layer.MoE(M, expert=_Doubler, num_experts=E,
                  dispatch_impl="grouped")
    import flax.linen as nn

    class JDoubler(nn.Module):
        hidden_size: int

        @nn.compact
        def __call__(self, x):
            return 2.0 * x
    jm = jax_layer.MoE(hidden_size=M, expert=JDoubler, num_experts=E,
                       dispatch_impl="grouped")
    with pytest.raises(NotImplementedError, match="MLPExpert"):
        jm.init(jax.random.PRNGKey(0), jnp.zeros((S, M)))
    # the scatter impl runs it
    m = layer.MoE(M, expert=_Doubler, expert_kwargs={"hidden_size": M},
                  num_experts=E, **LAYER_KW)
    x = torch.randn(S, M)
    out, _, _ = m(x)
    assert out.shape == x.shape and torch.isfinite(out).all()


def test_bad_dispatch_impl_and_ep_size_raise():
    with pytest.raises(ValueError, match="dispatch_impl"):
        layer.MoE(M, num_experts=E, dispatch_impl="dense")
    with pytest.raises(ValueError, match="expert-parallel group"):
        layer.MoE(M, num_experts=E, ep_size=2)


def test_is_moe_param():
    m = gpt2.GPT2LMHeadModel(dataclasses.replace(
        gpt2.PRESETS["tiny"], moe_num_experts=4), device="cpu")
    names = [n for n, _ in m.named_parameters() if layer.is_moe_param(n)]
    assert names == [f"h.1.moe.deepspeed_moe.deepspeed_experts.{fc}.{p}"
                     for fc in ("fc1", "fc2") for p in ("weight", "bias")]
    assert jax_layer.is_moe_param(
        "h_1/moe/deepspeed_moe/deepspeed_experts/fc1/kernel")


def test_gating_noise_is_keyed_and_recomputed():
    """The port's training noise: drawn only in training mode with a key
    in scope; the same key draws the same noise (a remat recompute), the
    next micro-step other noise."""
    from deepspeed_tpu_torch.runtime import dropout
    m = dropout.number_sites(layer.MoE(M, num_experts=E, capacity_factor=0.5,
                                       min_capacity=1))
    m.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(64, M, generator=torch.Generator().manual_seed(2))
    plain = m(x)[0]
    with dropout.key_scope((42, 0)):
        a = m(x)[0]
        b = m(x)[0]
    with dropout.key_scope((42, 1)):
        c = m(x)[0]
    assert torch.equal(a, b)
    assert not torch.equal(a, plain) and not torch.equal(a, c)
    m.eval()
    plain_eval = m(x)[0]
    with dropout.key_scope((42, 0)):
        assert torch.equal(m(x)[0], plain_eval)


# ------------------------------------------------------------------- model
def _cfgs(**moe):
    kw = dict(oracle.TINY_MOE, **moe)
    port = dataclasses.replace(gpt2.PRESETS["tiny"], **{
        k: v for k, v in kw.items() if k not in oracle.TINY})
    return jax_gpt2.GPT2Config(**kw), port


def _bridged(jcfg, batch, seed=oracle.SEED):
    model = jax_gpt2.GPT2LMHeadModel(jcfg)
    params = model.init(jax.random.PRNGKey(seed), batch)["params"]
    return model, params, bridge.flax_to_state_dict(
        jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("impl", ["scatter", "einsum", "grouped"])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_gpt2_eval_matches_jax(k, impl):
    """Tiny MoE-GPT (oracle.TINY_MOE) in eval at capacity factor 1.25 on
    2 × 8 tokens (C = 5 a expert), where tokens drop: loss, logits and
    every gradient."""
    batch = {"input_ids": np.array(
        oracle.make_batches(1)[0]["input_ids"])[:2, :8]}
    jcfg, pcfg = _cfgs(moe_k=k, moe_dispatch_impl=impl,
                       moe_eval_capacity_factor=1.25)
    jm, params, sd = _bridged(jcfg, batch)
    jloss, jgrad = jax.value_and_grad(
        lambda p: jm.apply({"params": p}, batch))(params)
    jlogits = jm.apply({"params": params}, batch, return_logits=True)
    pm = gpt2.GPT2LMHeadModel(pcfg, device="cpu").eval()
    pm.load_state_dict(sd)
    ids = torch.from_numpy(np.array(batch["input_ids"])).long()
    loss = pm({"input_ids": ids})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    with torch.no_grad():
        logits = pm({"input_ids": ids}, return_logits=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, jgrad))
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=n)
    # the eval capacity drops tokens here
    with torch.no_grad():
        h = pm.h[0](pm.wte[ids] + pm.wpe[:ids.shape[1]])
        x = pm.h[1].ln_2(h + pm.h[1].attn(pm.h[1].ln_1(h)))
        _, routing, _, _ = pm.h[1].moe.deepspeed_moe.gate(
            x.reshape(-1, x.shape[-1]), sparse=True)
    assert not all(bool(v.all()) for _, _, _, v in routing)


def test_remat_equals_no_remat():
    """remat recomputes the MoE blocks (with the gating noise of the
    key): losses and masters bit-equal over 3 training steps with RTS
    at a capacity that drops."""
    batches = [{"input_ids": np.asarray(b["input_ids"])}
               for b in oracle.make_batches(3)]
    jcfg, pcfg = _cfgs(moe_capacity_factor=1.0)
    _, _, init = _bridged(jcfg, batches[0])
    runs = []
    for remat in (False, True):
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=gpt2.GPT2LMHeadModel(dataclasses.replace(pcfg,
                                                           remat=remat),
                                       device="cpu"),
            config=_engine_config(0), model_parameters=init, device="cpu")
        losses = [float(engine.train_batch(batch=b)) for b in batches]
        runs.append((losses, {k: p.detach().clone()
                              for k, p in engine.params.items()}))
    assert runs[0][0] == runs[1][0]
    for k, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][k]), k


def _engine_config(stage, **opt):
    return {"train_batch_size": oracle.BATCH_SIZE,
            "steps_per_print": 10 ** 9, "gradient_clipping": 0.5,
            "optimizer": {"type": "AdamW", "params": dict(
                lr=2e-3, weight_decay=0.01, **opt)},
            "zero_optimization": {"stage": stage}}


ENGINE_STEPS = 10
ENGINE_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_engine_run():
    """The JAX engine's 10 steps on tiny MoE-GPT at a no-drop capacity
    (capacity factor 4 = the expert count: C = S), its eval_batch of the
    first batch at eval capacity 1.25 (drops), on one device."""
    batches = [{"input_ids": np.asarray(b["input_ids"])}
               for b in oracle.make_batches(ENGINE_STEPS)]
    jcfg, pcfg = _cfgs(moe_capacity_factor=4.0)
    _, _, init = _bridged(jcfg, batches[0])
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    engine, *_ = deepspeed_tpu.initialize(
        model=jax_gpt2.GPT2LMHeadModel(jcfg), config=_engine_config(1),
        sample_batch=batches[0], seed=oracle.SEED)
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    params = bridge.flax_to_state_dict(jax.tree.map(np.asarray,
                                                    engine.state.params))
    ev = float(engine.eval_batch(batches[0]))
    groups.destroy()
    return batches, pcfg, init, losses, params, ev


@pytest.mark.parametrize("stage,opt", [(0, {}), (1, {}), (0, {"sweep": True}),
                                       (1, {"fused": True})])
def test_engine_matches_jax_engine(jax_engine_run, stage, opt):
    """10 steps of ``train_batch`` (AdamW, decay, a clip of 0.5) against
    the JAX engine, ZeRO 0 and 1, at a no-drop capacity; then
    ``eval_batch`` at the eval capacity (with drops)."""
    batches, pcfg, init, want_losses, want_params, want_eval = \
        jax_engine_run
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2.GPT2LMHeadModel(pcfg, device="cpu"),
        config=_engine_config(stage, **opt), model_parameters=init,
        device="cpu")
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    np.testing.assert_allclose(losses, want_losses, **ENGINE_TOL)
    for k, p in engine.params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want_params[k].numpy(), err_msg=k,
                                   **ENGINE_TOL)
    np.testing.assert_allclose(float(engine.eval_batch(batches[0])),
                               want_eval, **ENGINE_TOL)


def test_loop_equals_train_batch():
    """forward / backward / step takes train_batch's steps bit for bit on
    MoE-GPT (with RTS noise and drops)."""
    batches = [{"input_ids": np.asarray(b["input_ids"])}
               for b in oracle.make_batches(3)]
    jcfg, pcfg = _cfgs(moe_capacity_factor=1.0)
    _, _, init = _bridged(jcfg, batches[0])
    runs = []
    for loop in (False, True):
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=gpt2.GPT2LMHeadModel(pcfg, device="cpu"),
            config=_engine_config(0), model_parameters=init, device="cpu")
        losses = []
        for b in batches:
            if loop:
                loss = engine.forward(b)
                engine.backward(loss)
                engine.step()
                losses.append(float(loss))
            else:
                losses.append(float(engine.train_batch(batch=b)))
        runs.append((losses, {k: p.detach().clone()
                              for k, p in engine.params.items()}))
    assert runs[0][0] == runs[1][0]
    for k, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][k]), k


def test_moe_with_pipeline_stages_raises():
    with pytest.raises(NotImplementedError, match="MoE"):
        gpt2.GPT2LMHeadModel(dataclasses.replace(
            gpt2.PRESETS["tiny"], moe_num_experts=4, pp_stages=2),
            device="cpu")
