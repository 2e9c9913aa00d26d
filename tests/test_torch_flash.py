"""The PyTorch port's flash-attention forward and attention dispatcher
against the JAX package (Pallas kernels in interpret mode on the CPU).

Inputs come from a numpy seed and go through both. On the CPU the port's
wrappers run their plain versions; fp32 tolerance rtol = atol = 2e-5 (the
two sum in a different order). The CUDA kernel itself is held against the
plain version in tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import attention as jax_attention
from deepspeed_tpu.ops.transformer import flash as jax_flash
from deepspeed_tpu_torch.ops.transformer import attention, flash

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(B, H, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D)).astype(np.float32),
            rng.standard_normal((B, H, Sk, D)).astype(np.float32),
            rng.standard_normal((B, H, Sk, D)).astype(np.float32))


CASES = [
    # (B, H, Sq, Sk, D, causal)
    (2, 2, 64, 64, 16, True),
    (2, 2, 64, 64, 16, False),
    (1, 2, 24, 96, 32, True),     # Sq < Sk: offset causal mask
    (1, 2, 100, 100, 16, True),   # S not a power of two
    (1, 3, 100, 100, 16, False),
    (1, 1, 40, 72, 64, False),
]


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", CASES)
def test_flash_fwd_matches_jax_flash_with_lse(B, H, Sq, Sk, D, causal):
    q, k, v = _qkv(B, H, Sq, Sk, D, seed=Sq + Sk + D)
    want_o, want_lse = jax_flash.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    got_o, got_lse = flash.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal)
    assert got_o.shape == (B, H, Sq, D) and got_lse.shape == (B, H, Sq)
    assert got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_flash_attention(causal):
    q, k, v = _qkv(2, 3, 48, 48, 32, seed=7)
    want = jax_flash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, 0.3)
    got = flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    o, lse = flash.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, 0.3)
    torch.testing.assert_close(o, got, rtol=0, atol=0)
    assert lse.shape == (2, 3, 48)


@pytest.mark.parametrize("with_bias,with_mask,causal", [
    (False, False, True), (True, False, True), (False, True, False),
    (True, True, True)])
def test_mha_reference_matches_jax(with_bias, with_mask, causal):
    q, k, v = _qkv(1, 2, 20, 36, 16, seed=3)
    rng = np.random.default_rng(5)
    bias = rng.standard_normal((1, 2, 20, 36)).astype(np.float32) \
        if with_bias else None
    mask = (rng.random((1, 1, 20, 36)) > 0.3) if with_mask else None
    want = jax_attention.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bias=None if bias is None else jnp.asarray(bias),
        mask=None if mask is None else jnp.asarray(mask))
    got = attention.mha_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, bias=None if bias is None else torch.from_numpy(bias),
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_dispatch_on_cpu_runs_plain_version(monkeypatch):
    """CPU tensors never build or launch a kernel, with or without mask."""
    from deepspeed_tpu_torch.ops import op_builder

    def no_build(*a, **k):
        raise AssertionError("a CPU call must not build the kernels")
    monkeypatch.setattr(op_builder, "load_kernels", no_build)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 30, 30, 16, seed=1))
    want = jax_attention.attention(jnp.asarray(q.numpy()),
                                   jnp.asarray(k.numpy()),
                                   jnp.asarray(v.numpy()), causal=True,
                                   use_flash=True)
    got = attention.attention(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    mask = torch.ones(1, 1, 30, 30, dtype=torch.bool)
    torch.testing.assert_close(attention.attention(q, k, v, mask=mask), got,
                               rtol=2e-5, atol=2e-5)


# The bf16 forward kernel's walk (csrc/flash_fwd.cu), emulated in numpy: a
# CTA holds WG warpgroups of 64 query rows (two at head dims up to 64, one
# at 128 and 256; the grid runs the heavy causal tiles first) and streams
# key tiles of BK through a ring of STAGES slots, Q staged into the last
# slot until the loop's first issue (at head dims above 128 Q has its own
# region after the ring, read in every tile). The CTA walks its last warpgroup's tiles; each
# warpgroup skips those past its own diagonal. Scores are in the log2
# domain (sm_scale · log2 e folded in), tiles where the mask cannot bite
# run without it, and a row that has seen no key keeps its running max at
# -inf with an ex2 offset of 0. The emulation asserts that split (and that
# the mask bites on every masked tile), the ring order (a slot is
# overwritten only after its tile, or Q, has been read) and that every
# visible (query, key) pair is visited exactly once.
WG_ROWS, BK, STAGES = 64, 64, 3
LOG2E, LN2 = np.log2(np.e), np.log(2.0)


def _warpgroups(D):
    return 2 if D <= 64 else 1


class _FwdRing:
    """Slot contents in issue order: Q in slot STAGES-1, tiles 0 ..
    STAGES-2 in the prologue; iteration j waits for tile j, then (after
    the barrier) issues tile j + STAGES - 1 into the slot that tile j - 1
    (or Q, at j = 0) has left."""

    def __init__(self, n_tiles, q_in_ring=True):
        self.n, self.slots = n_tiles, [None] * STAGES
        self.q = "q" if q_in_ring else None
        self.slots[STAGES - 1] = self.q
        for t in range(min(STAGES - 1, n_tiles)):
            self.slots[t] = t

    def take(self, j):
        nxt = j + STAGES - 1
        if nxt < self.n:
            assert self.slots[nxt % STAGES] == (self.q if j == 0 else j - 1)
            self.slots[nxt % STAGES] = nxt
        assert self.slots[j % STAGES] == j


def _rows(x, start, n):
    """Rows start .. start + n - 1 of [S, D], zero past the end."""
    out = np.zeros((n, x.shape[-1]))
    live = x[start:start + n]
    out[:len(live)] = live
    return out


def _tiles(end):
    return -(-end // BK) if end > 0 else 0


def _emulate_fwd(q, k, v, causal, scale):
    B, H, Sq, D = q.shape
    Sk, off = k.shape[2], k.shape[2] - q.shape[2]
    wg = _warpgroups(D)
    rows_cta = WG_ROWS * wg
    o, lse = np.zeros(q.shape), np.zeros((B, H, Sq))
    seen = np.zeros((B, H, Sq, Sk), int)
    n_ctas = -(-Sq // rows_cta)
    walked = []
    for blk in range(n_ctas):
        q0 = (n_ctas - 1 - blk) * rows_cta      # heavy causal tiles first
        n_tiles = _tiles(min(Sk, q0 + rows_cta + off) if causal else Sk)
        walked.append(n_tiles)
        for b in range(B):
            for h in range(H):
                ring = _FwdRing(n_tiles, q_in_ring=D <= 128)
                groups = []
                for w in range(wg):
                    w0 = q0 + w * WG_ROWS
                    kv_end, full_end = Sk, Sk
                    if causal:
                        kv_end = min(Sk, w0 + WG_ROWS + off)
                        full_end = max(0, min(Sk, w0 + off + 1))
                    groups.append(dict(
                        rows=np.arange(w0, w0 + WG_ROWS),
                        Q=_rows(q[b, h], w0, WG_ROWS),
                        n_tiles=_tiles(kv_end), n_full=full_end // BK,
                        m=np.full(WG_ROWS, -np.inf), l=np.zeros(WG_ROWS),
                        acc=np.zeros((WG_ROWS, D))))
                assert max(g["n_tiles"] for g in groups) == n_tiles
                for j in range(n_tiles):
                    ring.take(j)
                    keys = np.arange(j * BK, (j + 1) * BK)
                    K, V = _rows(k[b, h], j * BK, BK), _rows(v[b, h], j * BK,
                                                              BK)
                    for g in groups:
                        rows = g["rows"]
                        vis = (keys[None, :] < Sk) & (
                            (not causal) |
                            (keys[None, :] <= rows[:, None] + off))
                        if j >= g["n_tiles"]:
                            assert not vis.any()    # past the diagonal
                            continue
                        s = g["Q"] @ K.T * (scale * LOG2E)
                        if j < g["n_full"]:
                            assert vis.all()        # no mask arithmetic
                        else:
                            assert not vis.all()    # the mask bites
                            s = np.where(vis, s, -np.inf)
                        m = g["m"]
                        mx = np.maximum(m, s.max(1))
                        none = mx == -np.inf        # no key seen yet
                        with np.errstate(invalid="ignore"):
                            alpha = np.where(none, 1.0, np.exp2(m - mx))
                        shift = np.where(none, 0.0, mx)
                        g["m"] = np.where(none, m, mx)
                        p = np.exp2(s - shift[:, None])
                        g["l"] = g["l"] * alpha + p.sum(1)
                        g["acc"] = g["acc"] * alpha[:, None] + p @ V
                        live = rows < Sq
                        ok = vis & live[:, None]
                        seen[b, h][np.ix_(rows[live], keys[keys < Sk])] += \
                            ok[live][:, keys < Sk]
                for g in groups:
                    rows, l = g["rows"], g["l"]
                    live = rows < Sq
                    lsafe = np.where(l > 0, l, 1.0)
                    out = np.where(l[:, None] > 0, g["acc"] / lsafe[:, None],
                                   0.0)
                    row_lse = np.where(l > 0, g["m"] * LN2 + np.log(lsafe),
                                       flash.NEG_INF)
                    o[b, h, rows[live]] = out[live]
                    lse[b, h, rows[live]] = row_lse[live]
    if causal:
        assert walked == sorted(walked, reverse=True)
    return o, lse, seen


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", [
    (1, 2, 130, 130, 64, True),      # ragged, three query tiles
    (1, 1, 200, 77, 128, True),      # Sq > Sk: 123 rows see no key
    (1, 1, 300, 100, 16, True),      # Sq > Sk: a CTA with no tile at all
    (1, 1, 77, 200, 20, True),       # Sq < Sk: offset causal mask
    (1, 1, 191, 191, 64, True),      # one short of the 192-key ring
    (2, 1, 193, 193, 16, False),     # one past it
    (1, 1, 129, 129, 32, True),      # one past the 128-row CTA
    (1, 1, 127, 127, 64, False),     # one short of it
    (1, 1, 65, 63, 20, False),       # one past a tile; Sk one short
    (1, 2, 100, 40, 64, False),      # Sq > Sk, one key tile (ring reuse)
    (1, 1, 40, 129, 128, False),     # Sq < Sk, three key tiles
    (1, 1, 130, 130, 256, True),     # D 256: Q outside the ring
    (1, 1, 70, 200, 256, False),     # D 256, Sq < Sk, four key tiles
])
def test_kernel_walk_reproduces_plain_and_jax_forward(B, H, Sq, Sk, D,
                                                      causal):
    """The forward kernel's walk (full and masked tiles, ring order, the
    log2-domain online softmax) gives the plain version's o and lse on
    every row and the JAX package's (fp32, 2e-5), with o = 0 and the
    masking value (lse <= -5e29) on rows with no visible key."""
    q, k, v = _qkv(B, H, Sq, Sk, D, seed=Sq * 3 + Sk + D)
    scale = D ** -0.5
    got_o, got_lse, seen = _emulate_fwd(q, k, v, causal, scale)
    rows, keys = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    visible = (not causal) | (keys <= rows + Sk - Sq)
    np.testing.assert_array_equal(
        seen, np.broadcast_to(visible, seen.shape).astype(int))
    sees = visible.any(1)
    assert np.all(got_lse[..., ~sees] <= -5e29)
    assert np.all(got_o[..., ~sees, :] == 0)
    plain_o, plain_lse = flash.flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, scale)
    jax_o, jax_lse = jax_flash.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale)
    np.testing.assert_allclose(got_o, plain_o.numpy(), **TOL)
    np.testing.assert_allclose(got_lse, plain_lse.numpy(), **TOL)
    # o against JAX only on the rows that see a key: on a row with none the
    # JAX kernels average v over the tiles they visited, where the port
    # gives 0 (the lse agrees, at the masking value in both)
    np.testing.assert_allclose(got_o[..., sees, :],
                               np.asarray(jax_o)[..., sees, :], **TOL)
    np.testing.assert_allclose(got_lse, np.asarray(jax_lse), **TOL)
