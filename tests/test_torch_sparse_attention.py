"""Block-sparse attention in the PyTorch port against the JAX package, on
the CPU.

The JAX side runs its Pallas kernels in interpret mode (as
``tests/unit/test_sparse_attention.py`` does); the port runs the plain
versions of its kernels. Inputs come from numpy seeds; everything is
fp32 and compared at rtol = atol = 1e-5 (the two sides sum in another
order: an online softmax over tiles against dense rows). Layouts are
compared exactly.

The tile lists that the CUDA kernels walk are checked here too: an
emulation of the kernels' loops over the lists (online softmax per output
tile, the pair's fine-block bits, the positional triangle on real-region
tiles, dk/dv over the column-major list) must give the plain versions'
results.
"""

import collections
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import fused_kernels as jfk
from deepspeed_tpu.ops.sparse_attention import kernels as jk
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.sparse_attention import fused_kernels as fk
from deepspeed_tpu_torch.ops.sparse_attention import kernels as tk
from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc
from tests.test_torch_flash_bwd import _Ring
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
B, H, S, D = 2, 2, 128, 16


def _layout(name, block, mod=jsc, seq=S, seed=7):
    """(layout, causal) of a named config at (H, seq); ``seed`` seeds
    BigBird's and Variable's random blocks."""
    random.seed(seed)
    cfg = {
        "fixed": lambda: mod.FixedSparsityConfig(
            num_heads=H, block=block, num_local_blocks=4,
            num_global_blocks=1),
        "fixed-uni": lambda: mod.FixedSparsityConfig(
            num_heads=H, block=block, num_local_blocks=4,
            attention="unidirectional"),
        "bigbird": lambda: mod.BigBirdSparsityConfig(
            num_heads=H, block=block, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1),
        "bigbird-uni": lambda: mod.BigBirdSparsityConfig(
            num_heads=H, block=block, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1,
            attention="unidirectional", different_layout_per_head=True),
        "longformer": lambda: mod.BSLongformerSparsityConfig(
            num_heads=H, block=block, num_sliding_window_blocks=3),
        "variable": lambda: mod.VariableSparsityConfig(
            num_heads=H, block=block, num_random_blocks=1,
            local_window_blocks=[2, 4], different_layout_per_head=True),
        "dense": lambda: mod.DenseSparsityConfig(num_heads=H, block=block),
    }[name]()
    return cfg.make_layout(seq), getattr(cfg, "attention", "") == \
        "unidirectional"


def _inputs(seed, bias):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((B, H, S, D)).astype(np.float32)
                  for _ in range(4))
    kpb = None
    if bias:
        kpb = (0.5 * rng.standard_normal((B, S))).astype(np.float32)
        kpb[0, -5:] = -1e9      # padded keys
    return q, k, v, w, kpb


def _jax_grads(fn, q, k, v, w, kpb):
    """JAX's output and gradients of sum(fn(...) · w), jitted (the
    interpret-mode kernels run op by op in Python otherwise)."""
    def loss(q, k, v, kpb):
        return jnp.sum(fn(q, k, v, kpb) * w)
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    if kpb is None:
        out = jax.jit(lambda q, k, v: fn(q, k, v, None))(*args)
        grads = jax.jit(jax.grad(lambda q, k, v: loss(q, k, v, None),
                                 argnums=(0, 1, 2)))(*args)
    else:
        out = jax.jit(fn)(*args, jnp.asarray(kpb))
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
            *args, jnp.asarray(kpb))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_grads(fn, q, k, v, w, kpb):
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    tb = None if kpb is None else torch.tensor(kpb, requires_grad=True)
    out = fn(*ts, tb)
    (out * torch.from_numpy(w)).sum().backward()
    grads = [t.grad.numpy() for t in ts]
    if tb is not None:
        grads.append(None if tb.grad is None else tb.grad.numpy())
    return out.detach().numpy(), grads


def _assert_all_close(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("name", ["fixed", "fixed-uni", "bigbird",
                                  "bigbird-uni", "longformer", "variable"])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_matches_jax(name, block, bias):
    lay, causal = _layout(name, block)
    q, k, v, w, kpb = _inputs(sum(map(ord, name)) + block + bias, bias)
    want = _jax_grads(lambda q, k, v, b: jfk.block_sparse_attention_fused(
        q, k, v, lay, key_padding_bias=b, block=block, causal=causal),
        q, k, v, w, kpb)
    got = _torch_grads(lambda q, k, v, b: fk.block_sparse_attention_fused(
        q, k, v, lay, key_padding_bias=b, block=block, causal=causal),
        q, k, v, w, kpb)
    _assert_all_close(got, want)


def _with_empty_rows(block):
    """A causal Fixed layout where block row 2 is empty and block row 5
    attends only a block above the diagonal (no key it may see)."""
    lay, _ = _layout("fixed-uni", block)
    lay = lay.copy()
    lay[:, 2, :] = 0
    lay[:, 5, :] = 0
    lay[:, 5, 7] = 1
    return lay


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_empty_and_fully_masked_rows(causal, bias):
    block = 8
    lay = _with_empty_rows(block)
    q, k, v, w, kpb = _inputs(3, bias)
    want = _jax_grads(lambda q, k, v, b: jfk.block_sparse_attention_fused(
        q, k, v, lay, key_padding_bias=b, block=block, causal=causal),
        q, k, v, w, kpb)
    got = _torch_grads(lambda q, k, v, b: fk.block_sparse_attention_fused(
        q, k, v, lay, key_padding_bias=b, block=block, causal=causal),
        q, k, v, w, kpb)
    _assert_all_close(got, want)
    rows = np.arange(2 * block, 3 * block)
    np.testing.assert_array_equal(got[0][:, :, rows], 0)
    if causal:
        np.testing.assert_array_equal(
            got[0][:, :, 5 * block:6 * block], 0)


@pytest.mark.parametrize("bias", [False, True])
def test_attend_lse_with_an_lse_cotangent(bias):
    """The strategy's ``attend_lse``: out, lse and every gradient with a
    cotangent on both outputs, on a rectangular (packed-style) layout."""
    block = 16
    lay, _ = _layout("fixed-uni", block)
    lay = lay != 0
    lay2 = np.concatenate([lay, lay[:, :, :4]], axis=2)     # Skv = 192
    lay2[:, 3, :] = False                                   # an empty row
    rng = np.random.default_rng(11)
    Skv = lay2.shape[2] * block
    q, w = (rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((B, H, Skv, D)).astype(np.float32)
            for _ in range(2))
    w_lse = rng.standard_normal((B, H, S)).astype(np.float32)
    kpb = (0.3 * rng.standard_normal((B, Skv))).astype(np.float32) \
        if bias else None
    js = jfk._get_strategy(lay2, block, True, D ** -0.5, causal_nblocks=8)

    def jloss(q, k, v, b):
        out, lse = js.attend_lse(q, k, v, b)
        return jnp.sum(out * w) + jnp.sum(
            jnp.where(lse > -1e29, lse, 0.0) * w_lse), (out, lse)
    jargs = [jnp.asarray(x) for x in (q, k, v)] + [
        None if kpb is None else jnp.asarray(kpb)]
    argnums = (0, 1, 2, 3) if bias else (0, 1, 2)
    jgrads, (jout, jlse) = jax.grad(jloss, argnums=argnums,
                                    has_aux=True)(*jargs)

    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    tb = None if kpb is None else torch.tensor(kpb, requires_grad=True)
    ps = fk._get_strategy(lay2, block, True, D ** -0.5, causal_nblocks=8)
    out, lse = ps.attend_lse(*ts, tb)
    ((out * torch.from_numpy(w)).sum() + (torch.where(
        lse > -1e29, lse, 0.0) * torch.from_numpy(w_lse)).sum()).backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    np.testing.assert_allclose(lse.detach().numpy(), jlse, **TOL)
    got = [t.grad.numpy() for t in ts] + ([tb.grad.numpy()] if bias else [])
    for g, want in zip(got, jgrads):
        np.testing.assert_allclose(g, np.asarray(want), **TOL)
    assert (lse[:, :, 3 * block:4 * block] == -1e30).all()


@pytest.mark.parametrize("name,block", [
    ("fixed", 16), ("fixed-uni", 8), ("bigbird", 8), ("bigbird-uni", 16),
    ("longformer", 16), ("variable", 8)])
def test_decomposition_and_packed_layout_match_jax(name, block, monkeypatch):
    lay, causal = _layout(name, block)
    lay = lay != 0
    for want, got in zip(jfk._decompose_layout(lay, causal),
                         fk._decompose_layout(lay, causal)):
        np.testing.assert_array_equal(got, want)
    # the JAX packed layout, as block_sparse_attention_fused hands it to
    # its strategy cache
    seen = []
    real = jfk._get_strategy

    def spy(layout, *args, **kw):
        seen.append((np.asarray(layout), kw.get("causal_nblocks")))
        return real(layout, *args, **kw)
    monkeypatch.setattr(jfk, "_get_strategy", spy)
    q = jnp.zeros((1, H, S, D))
    jfk.block_sparse_attention_fused(q, q, q, lay, block=block,
                                     causal=causal)
    jlay2, jnb = seen[-1]
    gr, gc, rem = fk._decompose_layout(lay, causal)
    if not len(gc):
        assert jnb is None
        np.testing.assert_array_equal(rem, jlay2)
        return
    lay2, nb, gap, pad = fk._pack_layout(lay, rem, gr, gc, causal, block)
    nq = lay.shape[1]
    assert jnb == nq and nb == nq + gap // block
    # the real region, then the packed columns, then dead padding only
    np.testing.assert_array_equal(lay2[:, :, :nq], jlay2[:, :, :nq])
    assert not lay2[:, :, nq:nb].any()
    np.testing.assert_array_equal(lay2[:, :, nb:nb + len(gc)],
                                  jlay2[:, :, nq:nq + len(gc)])
    assert not lay2[:, :, nb + len(gc):].any()
    assert not jlay2[:, :, nq + len(gc):].any()
    # the packed region starts and ends on a 64-key tile edge
    assert (nb * block) % fk.TILE == 0 and (lay2.shape[2] * block) % \
        fk.TILE == 0


def test_packing_pads_a_ragged_sequence_to_a_tile_edge():
    """S = 80 at block 16: the packed columns start at key 128."""
    lay = tsc.BSLongformerSparsityConfig(num_heads=2, block=16).make_layout(
        80) != 0
    gr, gc, rem = fk._decompose_layout(lay, False)
    assert len(gc) and len(gr)
    lay2, nb, gap, pad = fk._pack_layout(lay, rem, gr, gc, False, 16)
    assert nb * 16 == 128 and gap == 48 and pad == 64 - 16 * len(gc)
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 2, 80, 16)).astype(np.float32)
               for _ in range(3))
    want = jfk.block_sparse_attention_fused(q, k, v, lay, block=16)
    got = fk.block_sparse_attention_fused(*map(torch.from_numpy, (q, k, v)),
                                          lay, block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_masked_dense_part_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, H, 16, D)).astype(np.float32)
    kg, vg = (rng.standard_normal((B, H, 40, D)).astype(np.float32)
              for _ in range(2))
    bm = rng.random((H, 16, 40)) < 0.6
    bm[:, 3] = False
    row_ids, col_ids = np.arange(16) * 3, np.arange(40)
    kpb = rng.standard_normal((B, 40)).astype(np.float32)
    want = jfk._masked_dense_part(q, kg, vg, bm, col_ids, row_ids, True,
                                  jnp.asarray(kpb), D ** -0.5)
    mask = fk._dense_part_mask(bm, col_ids, row_ids, True, "cpu")
    got = fk._masked_dense_part(*map(torch.from_numpy, (q, kg, vg)), mask,
                                torch.from_numpy(kpb), D ** -0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name,block", [
    ("fixed", 16), ("fixed-uni", 8), ("bigbird", 16), ("variable", 8)])
@pytest.mark.parametrize("bias", [False, True])
def test_predicated_matches_jax(name, block, bias):
    """No bias gradient, as JAX's ``_bs_bwd``; every row sees its
    diagonal so the JAX predicated kernel's output is defined."""
    lay, causal = _layout(name, block)
    lay = lay.copy()
    for h in range(lay.shape[0]):
        np.fill_diagonal(lay[h], 1)
    q, k, v, w, kpb = _inputs(21, bias)
    want = _jax_grads(lambda q, k, v, b: jk.block_sparse_attention(
        q, k, v, jnp.asarray(lay), b, block, causal), q, k, v, w, None)
    want_out = np.asarray(jk.block_sparse_attention(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(lay),
        None if kpb is None else jnp.asarray(kpb), block, causal))
    got = _torch_grads(lambda q, k, v, b: tk.block_sparse_attention(
        q, k, v, lay, b, block, causal), q, k, v, w, kpb)
    np.testing.assert_allclose(got[0], want_out, **TOL)
    if kpb is None:
        _assert_all_close(got, want)
    else:
        # q, k, v gradients under the bias; none for the bias itself
        want = _jax_grads(lambda q, k, v, b: jk.block_sparse_attention(
            q, k, v, jnp.asarray(lay), jnp.asarray(kpb), block, causal),
            q, k, v, w, None)
        for g, ww in zip(got[1][:3], want[1]):
            np.testing.assert_allclose(g, ww, **TOL)
        assert len(got[1]) == 4 and got[1][3] is None


@pytest.mark.parametrize("name,block", [
    ("fixed", 16), ("fixed-uni", 8), ("bigbird", 8), ("longformer", 16)])
@pytest.mark.parametrize("bias", [False, True])
def test_gathered_matches_jax(name, block, bias):
    lay, causal = _layout(name, block)
    q, k, v, w, kpb = _inputs(31, bias)
    want = _jax_grads(lambda q, k, v, b: jk.block_sparse_attention_gathered(
        q, k, v, lay, key_padding_bias=b, block=block, causal=causal),
        q, k, v, w, kpb)
    got = _torch_grads(lambda q, k, v, b: tk.block_sparse_attention_gathered(
        q, k, v, lay, key_padding_bias=b, block=block, causal=causal),
        q, k, v, w, kpb)
    _assert_all_close(got, want)


def test_layout_to_dense_mask_matches_jax():
    lay, _ = _layout("bigbird", 16)
    np.testing.assert_array_equal(tk.layout_to_dense_mask(lay, 16, S),
                                  jk.layout_to_dense_mask(lay, 16, S))


@pytest.mark.parametrize("mode", ["sparse", "sparse:1024/128", "sparse:16/8",
                                  "sparse:64/16"])
def test_sparse_mode_parsing_and_layout_match_jax(mode):
    assert fk.parse_sparse_mode(mode) == jfk.parse_sparse_mode(mode)
    _, blk = fk.parse_sparse_mode(mode)
    for seq in (4 * blk, 8 * blk):
        got, gb = fk.sparse_mode_layout(mode, 3, seq)
        want, wb = jfk.sparse_mode_layout(mode, 3, seq)
        assert gb == wb
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["dense", "sparse:", "sparse:16", "sparse:a/8",
                                  "sparse:12/8", "sparse:0/8", "sparse:16/0"])
def test_sparse_mode_errors_match_jax(mode):
    with pytest.raises(ValueError) as want:
        jfk.parse_sparse_mode(mode)
    with pytest.raises(ValueError) as got:
        fk.parse_sparse_mode(mode)
    assert str(got.value) == str(want.value)


def test_sparse_mode_layout_length_error_matches_jax():
    with pytest.raises(ValueError) as want:
        jfk.sparse_mode_layout("sparse:16/8", 2, 60)
    with pytest.raises(ValueError) as got:
        fk.sparse_mode_layout("sparse:16/8", 2, 60)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("impl", ["fused", "gathered", "predicated"])
def test_ds_sparse_impl_dispatch(impl, monkeypatch):
    """``DS_SPARSE_IMPL`` picks the form; all three agree; a bad value
    raises the JAX error."""
    called = []
    for mod, name in ((sparse_self_attention, "block_sparse_attention_fused"),
                      (sparse_self_attention,
                       "block_sparse_attention_gathered"),
                      (sparse_self_attention, "block_sparse_attention")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **kw: (
            called.append(_n), _r(*a, **kw))[1])
    monkeypatch.setenv("DS_SPARSE_IMPL", impl)
    cfg = tsc.FixedSparsityConfig(num_heads=H, block=16)
    attn = sparse_self_attention.SparseSelfAttention(cfg)
    q, k, v, _, _ = _inputs(41, False)
    mask = np.ones((B, S), bool)
    mask[1, -16:] = False
    out = attn(*map(torch.from_numpy, (q, k, v)),
               key_padding_mask=torch.from_numpy(mask))
    assert called == [{"fused": "block_sparse_attention_fused",
                       "gathered": "block_sparse_attention_gathered",
                       "predicated": "block_sparse_attention"}[impl]]
    want = jk.block_sparse_attention_gathered(
        q, k, v, cfg.make_layout(S), key_padding_bias=jnp.where(
            jnp.asarray(mask), 0.0, -1e9), block=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    monkeypatch.setenv("DS_SPARSE_IMPL", "triton")
    with pytest.raises(ValueError, match="DS_SPARSE_IMPL must be"):
        attn(*map(torch.from_numpy, (q, k, v)))


def test_sparse_self_attention_refusals():
    attn = sparse_self_attention.SparseSelfAttention(
        tsc.FixedSparsityConfig(num_heads=H, block=16),
        key_padding_mask_mode="mul")
    x = torch.zeros(B, H, S, D)
    with pytest.raises(NotImplementedError, match="attn_mask"):
        attn(x, x, x, attn_mask=torch.ones(S, S))
    with pytest.raises(NotImplementedError, match="key_padding_mask_mode"):
        attn(x, x, x, key_padding_mask=torch.zeros(B, S))
    with pytest.raises(ValueError, match="blocks 8, 16, 32"):
        fk.block_sparse_attention_fused(
            x, x, x, np.ones((H, S // 4, S // 4)), block=4)


def test_layout_cache_is_keyed_by_content():
    a = tsc.FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=2)
    b = tsc.FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=4)
    la = sparse_self_attention.get_layout(a, 128)
    assert sparse_self_attention.get_layout(
        tsc.FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=2),
        128) is la
    assert not np.array_equal(sparse_self_attention.get_layout(b, 128), la)


# ------------------------------------------------ the kernels' tile lists
def _live(word, rl, cl, f, n):
    """The pair's fine-block bit of each (tile-local row, key)."""
    shift = ((rl[:, None] // f) * n + cl[None, :] // f).astype(np.uint64)
    word = np.array([word]).view(np.uint64)[0]
    return ((word >> shift) & np.uint64(1)) == 1


# The bf16 kernels' walk (csrc/sparse_attention.cu): one CTA per (output
# tile, batch element), the output tiles in the strategy's order (longest
# segment first); the segment's streamed tiles come through the ring of 3
# slots (``_Ring``); mask arithmetic runs only on the flagged pairs.


def _tile_rows(x, start):
    """Rows start .. start + 63 of [S, D], zero past the end."""
    out = np.zeros((fk.TILE, x.shape[-1]))
    live = x[start:start + fk.TILE]
    out[:len(live)] = live
    return out


def _tile_vals(x, start, fill):
    """x[start .. start + 63], ``fill`` past the end."""
    out = np.full(fk.TILE, fill, dtype=np.float64)
    live = x[start:start + fk.TILE]
    out[:len(live)] = live
    return out


def _ctas(strat, walk, n_out, B):
    """(batch, head, output tile, segment) in the kernels' grid order."""
    order = walk[1]
    for i in range(B * strat.H * n_out):
        b, seg = i % B, int(order[i // B])
        yield b, seg // n_out, seg % n_out, seg


def _pair_live(strat, e, bits, qt, kt):
    """[64 rows, 64 keys] liveness of pair e, rows past Sq and keys past
    Skv dead."""
    T, f = fk.TILE, strat.fine
    rows, keys = np.arange(qt * T, qt * T + T), np.arange(kt * T, kt * T + T)
    live = _live(bits[e], rows - qt * T, keys - kt * T, f, T // f)
    live &= (rows[:, None] < strat.Sq) & (keys[None, :] < strat.Skv)
    if strat.causal and kt < strat.causal_ntiles:
        live &= keys[None, :] <= rows[:, None]
    return live


def _emulate_fwd(q, k, v, kpb, strat):
    """o and lse of the bf16 forward kernel's walk over the row-major
    lists: its CTA order, the ring, the online softmax in the log2 domain
    (q k^T sm_scale log2e + bias log2e, exp2; lse = m ln2 + log l), and
    mask code (-1e30, p = 0 while a row's max is -1e30) only on the
    flagged pairs, whose unflagged neighbours must be live on every row of
    the sequence."""
    Bq, Hq, Sq, _ = q.shape
    Skv, T = k.shape[2], fk.TILE
    ptr, idx, bits = strat.fwd_lists
    flags = strat.fwd_walk[0]
    log2e = np.log2(np.e)
    scale2 = D ** -0.5 * log2e
    o, lse = np.zeros(q.shape), np.zeros((Bq, Hq, Sq))
    for b, h, it, seg in _ctas(strat, strat.fwd_walk, strat.n_qtiles, Bq):
        q0 = it * T
        live_r = np.arange(q0, q0 + T) < Sq
        Q = _tile_rows(q[b, h], q0)
        m, l = np.full(T, fk.NEG_INF), np.zeros(T)
        acc = np.zeros((T, q.shape[-1]))
        e0, cnt = ptr[seg], ptr[seg + 1] - ptr[seg]
        ring = _Ring(cnt)
        for j in range(cnt):
            ring.take(j)
            e, kt = e0 + j, idx[e0 + j]
            K, V = _tile_rows(k[b, h], kt * T), _tile_rows(v[b, h], kt * T)
            bias = np.zeros(T) if kpb is None else _tile_vals(kpb[b], kt * T,
                                                              0.0)
            x = Q @ K.T * scale2 + bias[None, :] * log2e
            live = _pair_live(strat, e, bits, it, kt)
            if flags[e]:
                x = np.where(live, x, fk.NEG_INF)   # the mask code
            else:
                assert live[live_r].all()           # no mask code
            m_new = np.maximum(m, x.max(1))
            dead = (m_new <= fk.NEG_INF / 2) & bool(flags[e])
            p = np.where(dead[:, None], 0.0, np.exp2(x - m_new[:, None]))
            alpha = np.exp2(m - m_new)
            l = l * alpha + p.sum(1)
            acc = acc * alpha[:, None] + p @ V
            m = m_new
        inv = np.where(l > 0, 1.0 / np.where(l > 0, l, 1.0), 0.0)
        o[b, h, q0:q0 + T] = (acc * inv[:, None])[live_r]
        lse[b, h, q0:q0 + T] = np.where(
            l > 0, m * np.log(2.0) + np.log(np.where(l > 0, l, 1.0)),
            fk.NEG_INF)[live_r]
    return o, lse


def _emulate_dq(q, k, v, kpb, do, o, lse, strat, g_lse=None):
    """dq and delta of the dq kernel's walk over the row-major lists, and
    the visits of each (query, key) pair."""
    Bq, Hq, Sq, _ = q.shape
    Skv, T = k.shape[2], fk.TILE
    ptr, idx, bits = strat.fwd_lists
    flags = strat.fwd_walk[0]
    scale = D ** -0.5
    dq, delta = np.zeros(q.shape), np.zeros((Bq, Hq, Sq))
    seen = np.zeros((Bq, Hq, Sq, Skv), int)
    for b, h, it, seg in _ctas(strat, strat.fwd_walk, strat.n_qtiles, Bq):
        q0 = it * T
        rows = np.arange(q0, q0 + T)
        live_r = rows < Sq
        Q, dO, O = (_tile_rows(x[b, h], q0) for x in (q, do, o))
        dl = (dO * O).sum(-1)                     # from the staged rows
        if g_lse is not None:
            dl -= _tile_vals(g_lse[b, h], q0, 0.0)
        L = _tile_vals(lse[b, h], q0, np.inf)
        L[L <= fk.NEG_INF / 2] = np.inf           # no live key: p = 0
        e0, cnt = ptr[seg], ptr[seg + 1] - ptr[seg]
        ring, acc = _Ring(cnt), np.zeros((T, q.shape[-1]))
        for j in range(cnt):
            ring.take(j)
            e, kt = e0 + j, idx[e0 + j]
            keys = np.arange(kt * T, kt * T + T)
            K, V = _tile_rows(k[b, h], kt * T), _tile_rows(v[b, h], kt * T)
            bias = np.zeros(T) if kpb is None else _tile_vals(kpb[b], kt * T,
                                                              0.0)
            x = Q @ K.T * scale + bias[None, :] - L[:, None]
            live = _pair_live(strat, e, bits, it, kt)
            if flags[e]:
                x = np.where(live, x, -np.inf)    # the mask code
            else:
                assert live.all()                 # no mask code
            keep = keys < Skv
            seen[b, h][np.ix_(rows[live_r], keys[keep])] += \
                live[live_r][:, keep]
            ds = np.exp(x) * (dO @ V.T - dl[:, None]) * scale
            acc += ds @ K
        dq[b, h, rows[live_r]] = acc[live_r]
        delta[b, h, rows[live_r]] = dl[live_r]
    return dq, delta, seen


def _emulate_dkv(q, k, v, kpb, do, lse, delta, strat):
    """dk, dv and dbias of the dk/dv kernel's walk over the column-major
    lists (s^T = k q^T per pair), and the visits of each pair."""
    Bq, Hq, Sq, _ = q.shape
    Skv, T = k.shape[2], fk.TILE
    ptr, idx, bits = strat.bwd_lists
    flags = strat.bwd_walk[0]
    scale = D ** -0.5
    dk, dv = np.zeros(k.shape), np.zeros(v.shape)
    dbias = np.zeros((Bq, Hq, Skv))
    seen = np.zeros((Bq, Hq, Sq, Skv), int)
    for b, h, kt, seg in _ctas(strat, strat.bwd_walk, strat.n_ktiles, Bq):
        k0 = kt * T
        keys = np.arange(k0, k0 + T)
        live_k = keys < Skv
        K, V = _tile_rows(k[b, h], k0), _tile_rows(v[b, h], k0)
        bias = np.zeros(T) if kpb is None else _tile_vals(kpb[b], k0, 0.0)
        e0, cnt = ptr[seg], ptr[seg + 1] - ptr[seg]
        ring = _Ring(cnt)
        adk, adv = np.zeros((T, k.shape[-1])), np.zeros((T, k.shape[-1]))
        adb = np.zeros(T)
        for j in range(cnt):
            ring.take(j)
            e, it = e0 + j, idx[e0 + j]
            rows = np.arange(it * T, it * T + T)
            Q, dO = _tile_rows(q[b, h], it * T), _tile_rows(do[b, h], it * T)
            L = _tile_vals(lse[b, h], it * T, np.inf)   # +inf past Sq
            L[L <= fk.NEG_INF / 2] = np.inf
            Dl = _tile_vals(delta[b, h], it * T, 0.0)
            xt = K @ Q.T * scale + bias[:, None] - L[None, :]
            live = _pair_live(strat, e, bits, it, kt)
            if flags[e]:
                xt = np.where(live.T, xt, -np.inf)
            else:
                assert live.all()
            keep = rows < Sq
            seen[b, h][np.ix_(rows[keep], keys[live_k])] += \
                live[keep][:, live_k]
            pt = np.exp(xt)
            dsig = pt * (V @ dO.T - Dl[None, :])
            adv += pt @ dO
            adk += (dsig * scale) @ Q
            adb += dsig.sum(1)
        dk[b, h, keys[live_k]] = adk[live_k]
        dv[b, h, keys[live_k]] = adv[live_k]
        dbias[b, h, keys[live_k]] = adb[live_k]
    return dk, dv, dbias, seen


@pytest.mark.parametrize("block,causal,name,seq", [
    (8, True, "fixed-uni", 128), (16, False, "bigbird", 128),
    (32, True, "bigbird-uni", 256), (64, False, "fixed", 256),
    (128, True, "fixed-uni", 512), (16, True, "variable", 80),
    (16, True, "dense", 256)])
def test_tile_lists_reproduce_the_plain_versions(block, causal, name, seq):
    """The lists the CUDA kernels walk (fine-block bits, causal tiles
    dropped, packed columns after a tile-aligned real region) give the
    plain versions' out, lse, dq, delta, dk, dv and dbias, with and without
    an lse cotangent, through the backward kernels' walk (CTA order, ring,
    mask code on flagged pairs only); each kernel visits every live pair
    once."""
    lay = _layout(name, block, tsc, seq)[0] != 0
    gr, gc, rem = fk._decompose_layout(lay, causal)
    if name == "dense":
        lay2, nb = lay, None                      # the predicated form's
    elif len(gc):
        lay2, nb, gap, pad = fk._pack_layout(lay, rem, gr, gc, causal, block)
    else:
        lay2, nb = rem, None
    strat = fk._get_strategy(lay2, block, causal, D ** -0.5, nb)
    if name == "dense":                           # tiles above the diagonal
        assert strat.tile_pairs < np.count_nonzero(
            fk._tile_bits(lay2, block))
    rng = np.random.default_rng(block)
    Skv = strat.Skv
    q, do = (rng.standard_normal((1, H, seq, D)) for _ in range(2))
    k, v = (rng.standard_normal((1, H, Skv, D)) for _ in range(2))
    kpb = 0.5 * rng.standard_normal((1, Skv))
    g_lse = rng.standard_normal((1, H, seq))
    o, lse = _emulate_fwd(q, k, v, kpb, strat)
    t = [torch.from_numpy(x) for x in (q, k, v, kpb, do)]
    po, plse = fk.sparse_attention_fwd_plain(t[0], t[1], t[2], t[3], strat)
    # the emulation runs in fp64, the plain versions in fp32
    np.testing.assert_allclose(o, po.numpy(), **TOL)
    np.testing.assert_allclose(lse, plse.numpy(), **TOL)
    live = np.broadcast_to(strat.element_mask("cpu").numpy()[None],
                           (1, H, seq, Skv))
    for gl in (None, g_lse):
        dq, delta, seen_q = _emulate_dq(q, k, v, kpb, do, o, lse, strat, gl)
        dk, dv, dbias, seen_kv = _emulate_dkv(q, k, v, kpb, do, lse, delta,
                                              strat)
        np.testing.assert_array_equal(seen_q, live)
        np.testing.assert_array_equal(seen_kv, live)
        pdq, pdelta = fk.sparse_attention_dq_plain(
            t[0], t[1], t[2], t[3], t[4], torch.from_numpy(o), plse, strat,
            None if gl is None else torch.from_numpy(gl))
        pdk, pdv, pdb = fk.sparse_attention_dkv_plain(
            t[0], t[1], t[2], t[3], t[4], plse, pdelta, strat, True)
        for got, want in ((dq, pdq), (delta, pdelta), (dk, pdk), (dv, pdv),
                          (dbias, pdb)):
            np.testing.assert_allclose(got, want.numpy(), **TOL)


def _brute_walk(strat):
    """The backward kernels' flags and orders counted from the element
    mask: a pair is listed where its tile holds a live fine block (causal
    tiles above the diagonal dropped), flagged where any of its 64 x 64
    elements is not live; segments longest first."""
    T = fk.TILE
    H, Sq, Skv = strat.H, strat.Sq, strat.Skv
    nq, nk = strat.n_qtiles, strat.n_ktiles
    live = np.zeros((H, nq * T, nk * T), bool)
    live[:, :Sq, :Skv] = strat.element_mask("cpu").numpy()
    tiles = live.reshape(H, nq, T, nk, T)
    full = tiles.all(axis=(2, 4))
    listed = fk._tile_bits(strat.lay, strat.block)[:, :nq, :nk] != 0
    if strat.causal:
        i, j = np.arange(nq)[:, None], np.arange(nk)[None, :]
        listed &= ~((j > i) & (j < strat.causal_ntiles))
    out = {}
    for name, lst, fl in (("fwd", listed, full),
                          ("bwd", listed.transpose(0, 2, 1),
                           full.transpose(0, 2, 1))):
        h, a, b = np.nonzero(lst)
        counts = lst.sum(-1).reshape(-1)
        out[name] = ((~fl[h, a, b]).astype(np.uint8),
                     np.argsort(-counts, kind="stable").astype(np.int32),
                     counts.reshape(H, -1))
    return out


@pytest.mark.parametrize("block,causal,name,seq", [
    (8, True, "fixed-uni", 128), (16, False, "bigbird", 128),
    (32, True, "bigbird-uni", 256), (64, False, "fixed", 256),
    (128, True, "fixed-uni", 512), (16, True, "variable", 80),
    (16, True, "dense", 256), (16, False, "longformer", 80)])
@pytest.mark.parametrize("packed", [True, False])
def test_strategy_flags_and_orders_match_a_brute_force_count(
        block, causal, name, seq, packed):
    lay = _layout(name, block, tsc, seq)[0] != 0
    strat = fk._get_plan(lay, block, causal, D ** -0.5, "cpu").strat \
        if packed else fk._get_strategy(lay, block, causal, D ** -0.5)
    want = _brute_walk(strat)
    for got, (flags, order, _) in ((strat.fwd_walk, want["fwd"]),
                                   (strat.bwd_walk, want["bwd"])):
        np.testing.assert_array_equal(got[0], flags)
        np.testing.assert_array_equal(got[1], order)


@pytest.mark.parametrize("name,block,seq,seed", [
    ("fixed", 64, 2048, 7),          # the sparse BERT path's layout
    ("fixed", 16, 144, 7),           # a key tail in the raw lists
    ("fixed-uni", 128, 1024, 7),
    ("fixed-uni", 8, 136, 7),        # causal, ragged
    ("bigbird", 32, 512, 0), ("bigbird", 32, 512, 17),
    ("bigbird", 16, 208, 48), ("bigbird-uni", 32, 256, 3),
    ("longformer", 16, 80, 7)])
@pytest.mark.parametrize("packed", [True, False])
def test_unflagged_pairs_are_all_live_in_the_element_mask(name, block, seq,
                                                          seed, packed):
    """The bf16 kernels run no mask code on a pair the host flags 0: on
    every such pair of the row- and column-major lists each (row < Sq,
    key) of the 64 x 64 tile is live in the strategy's element mask, and
    every key lies before Skv."""
    lay, causal = _layout(name, block, tsc, seq, seed)
    lay = lay != 0
    strat = fk._get_plan(lay, block, causal, D ** -0.5, "cpu").strat \
        if packed else fk._get_strategy(lay, block, causal, D ** -0.5)
    T = fk.TILE
    mask = strat.element_mask("cpu").numpy()
    unflagged = 0
    for (ptr, idx, _), (flags, _), n_out, rows_out in (
            (strat.fwd_lists, strat.fwd_walk, strat.n_qtiles, True),
            (strat.bwd_lists, strat.bwd_walk, strat.n_ktiles, False)):
        for seg in range(len(ptr) - 1):
            h, out = divmod(seg, n_out)
            for e in range(ptr[seg], ptr[seg + 1]):
                if flags[e]:
                    continue
                qt, kt = (out, idx[e]) if rows_out else (idx[e], out)
                assert (kt + 1) * T <= strat.Skv
                assert mask[h, qt * T:(qt + 1) * T, kt * T:(kt + 1) * T].all()
                unflagged += 1
    if name == "fixed" and block == 64:
        assert unflagged == 2 * strat.tile_pairs   # every pair, both lists


def test_bert_path_dkv_lists_run_the_longest_first():
    """The sparse BERT path (Fixed, block 64, window 256, 1 global, S 2048,
    global columns packed): a head's 40 key tiles hold 32 pairs (8 tiles:
    the packed global columns), 4 (24) and none (8: the real-region global
    columns), 352 in all; the 32-pair tiles of every head lead the dk/dv
    grid; no pair needs the mask."""
    heads = 2
    lay = tsc.FixedSparsityConfig(num_heads=heads, block=64,
                                  num_local_blocks=4,
                                  num_global_blocks=1).make_layout(2048) != 0
    strat = fk._get_plan(lay, 64, False, D ** -0.5, "cpu").strat
    want = _brute_walk(strat)
    counts = want["bwd"][2]
    for h in range(heads):
        assert sorted(collections.Counter(counts[h]).items()) == \
            [(0, 8), (4, 24), (32, 8)]
    assert strat.tile_pairs == 352 * heads
    np.testing.assert_array_equal(strat.bwd_walk[1], want["bwd"][1])
    lead = np.diff(strat.bwd_lists[0])[strat.bwd_walk[1][:8 * heads]]
    assert (lead == 32).all()
    assert not strat.fwd_walk[0].any() and not strat.bwd_walk[0].any()


def test_strategy_is_cached_per_layout_and_device():
    lay = np.ones((2, 4, 4), bool)
    a = fk._get_strategy(lay, 16, False, 0.25)
    assert fk._get_strategy(lay.astype(int), 16, False, 0.25) is a
    assert fk._get_strategy(lay, 16, True, 0.25) is not a
    assert fk._get_strategy(lay, 16, False, 0.25, device="meta") is not a


def test_cpu_route_launches_nothing(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU call must not build the kernels")
    monkeypatch.setattr(op_builder, "load_kernels", no_build)
    op_builder.reset_launch_counts()
    q, k, v, w, kpb = _inputs(1, True)
    lay, causal = _layout("bigbird", 16)
    _torch_grads(lambda q, k, v, b: fk.block_sparse_attention_fused(
        q, k, v, lay, key_padding_bias=b, block=16, causal=causal),
        q, k, v, w, kpb)
    _torch_grads(lambda q, k, v, b: tk.block_sparse_attention(
        q, k, v, lay, b, 16, causal), q, k, v, w, kpb)
    assert sum(op_builder.LAUNCHES.values()) == 0
