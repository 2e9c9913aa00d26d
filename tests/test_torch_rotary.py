"""Rotary position embeddings in the PyTorch port against the JAX package:
``ops.transformer.rotary`` on numpy-seeded inputs, the four properties of
JAX's ``tests/unit/test_rotary.py`` on the port, and GPT-2 with
``position_embedding="rope"`` on bridged weights (logits, cached
generation) against the flax model and the JAX inference engine, on the
CPU in fp32.

Tolerances: the rotation rtol = atol = 1e-5 (fp32 trig tables: torch's
and XLA's cos, sin and pow round their last bits differently, and the
angle grows with the position); the model's logits rtol = atol = 1e-4
(tests/test_torch_gpt2.py's: LayerNorm and matmuls sum in another
order); greedy tokens exactly.
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
from deepspeed_tpu.ops.transformer import rotary as jax_rotary
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.bridge import flax_to_state_dict
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.ops.transformer import rotary
from tests.torch_threads import one_torch_thread  # noqa: F401

ROT_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _qk(seed=0, B=1, H=2, S=16, D=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, H, S, D)).astype(np.float32))


@pytest.mark.parametrize("rotary_dim,offset,base", [
    (None, 0, 10000.0), (None, 37, 10000.0), (8, 0, 10000.0),
    (8, 100, 10000.0), (16, 5, 500.0)])
def test_rotation_matches_jax(rotary_dim, offset, base):
    """Full and partial rotary dims, offset 0 and > 0, another base."""
    q, k = _qk(seed=offset + (rotary_dim or 0), B=2, H=3, S=24, D=32)
    want = jax.jit(lambda a, b: jax_rotary.apply_rotary_pos_emb(
        a, b, offset=offset, base=base, rotary_dim=rotary_dim))(q, k)
    got = rotary.apply_rotary_pos_emb(torch.from_numpy(q),
                                      torch.from_numpy(k), offset=offset,
                                      base=base, rotary_dim=rotary_dim)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ROT_TOL)
    cos, sin = rotary.rotary_tables(24, rotary_dim or 32, base=base,
                                    offset=offset)
    wcos, wsin = jax_rotary.rotary_tables(24, rotary_dim or 32, base=base,
                                          offset=offset)
    np.testing.assert_allclose(cos.numpy(), np.asarray(wcos), **ROT_TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(wsin), **ROT_TOL)


def test_bf16_keeps_its_dtype_and_matches_jax():
    q, k = _qk(seed=3)
    qb = torch.from_numpy(q).bfloat16()
    kb = torch.from_numpy(k).bfloat16()
    got = rotary.apply_rotary_pos_emb(qb, kb, offset=7, rotary_dim=16)
    want = jax_rotary.apply_rotary_pos_emb(
        jnp.asarray(qb.float().numpy(), jnp.bfloat16),
        jnp.asarray(kb.float().numpy(), jnp.bfloat16), offset=7,
        rotary_dim=16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        # both rotate in fp32 and round once to bf16: at most one ulp
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=2 ** -7)


def test_per_row_offsets_rotate_each_row_at_its_own():
    """A [B] tensor of offsets (decode steps of rows at different lengths)
    rotates row b as the scalar offset[b] does."""
    q, k = (torch.from_numpy(a) for a in _qk(seed=5, B=3, S=4))
    offs = torch.tensor([0, 9, 31])
    got = rotary.apply_rotary_pos_emb(q, k, offset=offs, rotary_dim=16)
    for b in range(3):
        want = rotary.apply_rotary_pos_emb(q[b:b + 1], k[b:b + 1],
                                           offset=int(offs[b]),
                                           rotary_dim=16)
        for g, w in zip(got, want):
            torch.testing.assert_close(g[b:b + 1], w, rtol=0, atol=0)
    # a 0-d tensor (a decode step's cache length) acts as the int
    zero_d = rotary.apply_rotary_pos_emb(q, k, offset=torch.tensor(9))
    as_int = rotary.apply_rotary_pos_emb(q, k, offset=9)
    for g, w in zip(zero_d, as_int):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_odd_rotary_dim_raises_as_jax_asserts():
    q, k = _qk()
    with pytest.raises(ValueError, match="even"):
        rotary.apply_rotary_pos_emb(torch.from_numpy(q), torch.from_numpy(k),
                                    rotary_dim=7)
    with pytest.raises(AssertionError, match="even"):
        jax_rotary.apply_rotary_pos_emb(q, k, rotary_dim=7)


# the four properties of tests/unit/test_rotary.py, on the port
def test_rotation_preserves_norm():
    q, k = (torch.from_numpy(a) for a in _qk())
    qr, _ = rotary.apply_rotary_pos_emb(q, k)
    torch.testing.assert_close(q.norm(dim=-1), qr.norm(dim=-1), rtol=1e-5,
                               atol=1e-5)


def test_scores_depend_only_on_relative_position():
    """<rot(q, i), rot(k, j)> is a function of i - j only."""
    q, k = (torch.from_numpy(a) for a in _qk(S=16))
    q0 = q[:, :, :1].expand(q.shape)
    k0 = k[:, :, :1].expand(k.shape)
    q0r, k0r = rotary.apply_rotary_pos_emb(q0, k0)
    scores = torch.einsum("bhqd,bhkd->bhqk", q0r, k0r).numpy()
    for delta in (-3, 0, 5):
        diag = np.diagonal(scores, offset=delta, axis1=2, axis2=3)
        np.testing.assert_allclose(diag, diag[..., :1].repeat(
            diag.shape[-1], -1), rtol=1e-4, atol=1e-4)


def test_offset_continues_rotation():
    """rot(x, offset)[t] == rot(x, 0)[offset + t]: the decode contract."""
    x = torch.from_numpy(_qk(S=1, B=1, H=1, D=16)[0]).expand(1, 1, 12, 16)
    full, _ = rotary.apply_rotary_pos_emb(x, x, offset=0)
    tail, _ = rotary.apply_rotary_pos_emb(x[:, :, :4], x[:, :, :4], offset=8)
    torch.testing.assert_close(tail, full[:, :, 8:], rtol=1e-5, atol=1e-6)


def test_partial_rotary_dim_leaves_the_tail():
    q, k = (torch.from_numpy(a) for a in _qk(D=32))
    qr, _ = rotary.apply_rotary_pos_emb(q, k, rotary_dim=16)
    assert torch.equal(qr[..., 16:], q[..., 16:])
    assert not torch.allclose(qr[..., 2:16], q[..., 2:16])


# GPT-2 with rope
ROPE = dict(vocab_size=512, n_positions=128, n_embd=64, n_layer=2, n_head=4,
            position_embedding="rope")


@pytest.fixture(scope="module")
def rope_models():
    """(flax model, numpy params, port model, ids [2, 12])."""
    ids = np.random.default_rng(3).integers(0, 512, (2, 12), dtype=np.int32)
    jm = jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config(**ROPE))
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), {"input_ids": jnp.asarray(ids)})["params"])
    tm = gpt2.GPT2LMHeadModel(gpt2.GPT2Config(**ROPE), device="cpu")
    tm.load_state_dict(flax_to_state_dict(params))
    return jm, params, tm.eval(), ids


def test_rope_model_has_no_position_table(rope_models):
    jm, params, tm, _ = rope_models
    assert "wpe" not in params and tm.wpe is None
    assert "wpe" not in dict(tm.named_parameters())
    cfg = gpt2.GPT2Config(**ROPE)
    assert cfg.num_params() == jax_gpt2.GPT2Config(**ROPE).num_params()
    assert cfg.num_params() == sum(p.numel() for p in tm.parameters())


def test_rope_logits_and_loss_match_jax(rope_models):
    jm, params, tm, ids = rope_models
    apply = jax.jit(lambda p, b: jm.apply({"params": p}, b,
                                          return_logits=True))
    want = np.asarray(apply(params, {"input_ids": jnp.asarray(ids)}))
    want_loss = float(jax.jit(lambda p, b: jm.apply({"params": p}, b))(
        params, {"input_ids": jnp.asarray(ids)}))
    tids = torch.from_numpy(ids).long()
    with torch.no_grad():
        got = tm({"input_ids": tids}, return_logits=True)
        loss = tm({"input_ids": tids})
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    # the rotation acts: a learned-position model with a zero wpe table
    # on the same weights gives other logits
    learned = gpt2.GPT2LMHeadModel(gpt2.PRESETS["tiny"], device="cpu")
    learned.load_state_dict(flax_to_state_dict(
        dict(params, wpe=np.zeros((128, 64), np.float32))))
    with torch.no_grad():
        plain = learned({"input_ids": tids}, return_logits=True)
    assert not torch.allclose(plain, got, atol=1e-3)


def test_rope_cached_decode_logits_match_recompute(rope_models):
    """Each cached decode step rotates at its position: its logits equal
    the full forward's at that position."""
    _, _, tm, ids = rope_models
    tids = torch.from_numpy(ids).long()
    with torch.no_grad():
        full = tm({"input_ids": tids}, return_logits=True)
        cache = tm.new_cache(2)
        pre = tm({"input_ids": tids[:, :8]}, cache=cache)
        steps = [tm({"input_ids": tids[:, t:t + 1]}, cache=cache)
                 for t in range(8, 12)]
    torch.testing.assert_close(pre, full[:, :8], **TOL)
    for t, step in zip(range(8, 12), steps):
        torch.testing.assert_close(step[:, 0], full[:, t], **TOL)


def test_rope_generate_cached_equals_recompute_and_jax(rope_models):
    """Greedy cached generation equals recompute in the port, and the JAX
    inference engine's tokens (JAX's test_gpt2_rope_cached_generate_
    matches_recompute, on the port)."""
    jm, params, tm, ids = rope_models
    eng = deepspeed_tpu_torch.init_inference(tm, dtype=torch.float32,
                                             device="cpu")
    tids = torch.from_numpy(ids).long()
    cached = eng.generate(tids, max_new_tokens=10)
    recompute = eng.generate(tids, max_new_tokens=10, use_cache=False)
    assert torch.equal(cached, recompute)
    groups.destroy()
    groups.initialize(devices=jax.devices()[:1])
    jeng = deepspeed_tpu.init_inference(jm, params=params, dtype=jnp.float32)
    want = np.asarray(jeng.generate(jnp.asarray(ids), max_new_tokens=10))
    np.testing.assert_array_equal(cached.numpy(), want)


def test_rope_through_the_layered_decomposition():
    """gpt2_offload_layers with rope: the embedding holds no wpe (JAX
    ``_OffloadEmbed`` under rope)."""
    cfg = gpt2.GPT2Config(**ROPE)
    embed = gpt2.gpt2_offload_layers(cfg)[0]
    assert embed.wpe is None and [n for n, _ in embed.named_parameters()] \
        == ["wte"]
    learned = gpt2.gpt2_offload_layers(dataclasses.replace(
        cfg, position_embedding="learned"))[0]
    assert sorted(n for n, _ in learned.named_parameters()) == ["wpe", "wte"]


def test_unknown_position_embedding_raises():
    with pytest.raises(ValueError, match="position_embedding"):
        gpt2.GPT2LMHeadModel(gpt2.GPT2Config(
            **dict(ROPE, position_embedding="alibi")), device="cpu")
