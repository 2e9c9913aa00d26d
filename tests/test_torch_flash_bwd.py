"""The PyTorch port's flash-attention backward against the JAX package.

The JAX side is ``jax.vjp`` of ``deepspeed_tpu.ops.transformer.flash
.flash_attention``, whose Pallas backward kernels run in interpret mode
on the CPU. The port's side is its plain backward (the explicit formulas,
not an autograd of the forward) and the autograd ``Function`` that wraps
the kernels, whose CPU route runs the same plain versions. Inputs come
from a numpy seed; fp32 tolerance rtol = atol = 2e-5 (the two sum in a
different order). The CUDA kernels are held against the plain version in
tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import flash as jax_flash
from deepspeed_tpu_torch.ops.transformer import attention, flash

TOL = dict(rtol=2e-5, atol=2e-5)

CASES = [
    # (B, H, Sq, Sk, D, causal): the forward's cases (test_torch_flash.py)
    (2, 2, 64, 64, 16, True),
    (2, 2, 64, 64, 16, False),
    (1, 2, 24, 96, 32, True),     # Sq < Sk: offset causal mask
    (1, 2, 100, 100, 16, True),   # S not a power of two
    (1, 3, 100, 100, 16, False),
    (1, 1, 40, 72, 64, False),
]


def _inputs(B, H, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    do = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, sm_scale=None):
    _, vjp = jax.vjp(lambda a, b, c: jax_flash.flash_attention(
        a, b, c, causal, sm_scale), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", CASES)
def test_plain_backward_matches_jax_vjp(B, H, Sq, Sk, D, causal):
    q, k, v, do = _inputs(B, H, Sq, Sk, D, seed=Sq + Sk + D + causal)
    want = _jax_grads(q, k, v, do, causal)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash.flash_attention_fwd(tq, tk, tv, causal)
    got = flash.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal)
    for name, g, w in zip("dq dk dv".split(), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", CASES)
def test_autograd_function_matches_jax_vjp(B, H, Sq, Sk, D, causal):
    q, k, v, do = _inputs(B, H, Sq, Sk, D, seed=3 * Sq + D)
    want = _jax_grads(q, k, v, do, causal, 0.3)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash.flash_attention(tq, tk, tv, causal, 0.3)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip("dq dk dv".split(), got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


def test_plain_backward_is_not_the_forward_autograd_in_bf16():
    """In bf16 the explicit formulas round p and ds where the JAX kernels
    do; the result stays within bf16 reach of the fp32 gradients."""
    q, k, v, do = _inputs(1, 2, 48, 48, 32, seed=11)
    want = _jax_grads(q, k, v, do, True)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, k, v, do))
    o, lse = flash.flash_attention_fwd(tq, tk, tv, True)
    got = flash.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0.05,
                                   atol=0.05)


def test_attention_cpu_gradients_match_jax():
    """The model-level dispatcher is differentiable on the CPU (the plain
    dense route), with the same gradients as the JAX flash vjp."""
    q, k, v, do = _inputs(2, 2, 30, 30, 16, seed=5)
    want = _jax_grads(q, k, v, do, True)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention.attention(tq, tk, tv, causal=True)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_flash_attention_with_lse_stays_forward_only():
    q, k, v, _ = _inputs(1, 1, 8, 8, 16, seed=2)
    tq = torch.from_numpy(q).requires_grad_()
    o, lse = flash.flash_attention_with_lse(tq, torch.from_numpy(k),
                                            torch.from_numpy(v))
    assert not o.requires_grad and not lse.requires_grad


# The bf16 CUDA kernels' walk (csrc/flash_bwd.cu), emulated in numpy: a CTA
# owns ROWS rows and streams tiles of the other side (64 rows, 32 at head
# dims above 64) through a ring of STAGES slots. Tiles where the mask
# cannot bite run without it; the emulation asserts that split, the ring
# order (a tile is read from its slot before any later load overwrites
# it) and that every visible (query, key) pair is visited exactly once.
ROWS, STAGES = 64, 3
NEG_INF = flash.NEG_INF


def _inner_tile(D):
    return 64 if D <= 64 else 32


class _Ring:
    """Slot contents in issue order: the prologue fills slots 0 .. S-2;
    iteration j waits for tile j, then (after the barrier) issues tile
    j + S - 1 into the slot tile j - 1 has left."""

    def __init__(self, n_tiles):
        self.n, self.slots = n_tiles, [None] * STAGES
        for t in range(min(STAGES - 1, n_tiles)):
            self.slots[t % STAGES] = t

    def take(self, j):
        nxt = j + STAGES - 1
        if nxt < self.n:
            assert self.slots[nxt % STAGES] in (None, j - 1)
            self.slots[nxt % STAGES] = nxt
        assert self.slots[j % STAGES] == j
        return j


def _rows(x, start, n):
    """Rows start .. start + n - 1 of [S, D], zero past the end."""
    out = np.zeros((n, x.shape[-1]))
    live = x[start:start + n]
    out[:len(live)] = live
    return out


def _emulate_dq(q, k, v, o, do, lse, causal, scale):
    B, H, Sq, D = q.shape
    Sk, BN, off = k.shape[2], _inner_tile(D), k.shape[2] - q.shape[2]
    dq, delta = np.zeros(q.shape), np.zeros((B, H, Sq))
    seen = np.zeros((B, H, Sq, Sk), int)
    n_ctas = -(-Sq // ROWS)
    for b in range(B):
        for h in range(H):
            for blk in range(n_ctas):
                q0 = (n_ctas - 1 - blk) * ROWS      # heavy causal tiles first
                rows = np.arange(q0, q0 + ROWS)
                live = rows < Sq
                Q, dO, O = (_rows(x[b, h], q0, ROWS) for x in (q, do, o))
                dl = (dO * O).sum(-1)
                L = np.full(ROWS, np.inf)
                L[live] = lse[b, h, rows[live]]
                L[L <= NEG_INF / 2] = np.inf        # no visible key: p = 0
                kv_end, full_end = Sk, Sk
                if causal:
                    kv_end = min(Sk, q0 + ROWS + off)
                    full_end = max(0, min(Sk, q0 + off + 1))
                n_tiles = -(-kv_end // BN) if kv_end > 0 else 0
                n_full = full_end // BN
                ring, acc = _Ring(n_tiles), np.zeros((ROWS, D))
                for j in range(n_tiles):
                    ring.take(j)
                    keys = np.arange(j * BN, (j + 1) * BN)
                    K, V = _rows(k[b, h], j * BN, BN), _rows(v[b, h], j * BN,
                                                              BN)
                    vis = (keys[None, :] < Sk) & (
                        (not causal) | (keys[None, :] <= rows[:, None] + off))
                    p = np.exp(Q @ K.T * scale - L[:, None])
                    if j < n_full:
                        assert vis.all()            # no mask arithmetic
                    else:
                        p = np.where(vis, p, 0.0)
                    ok = vis & live[:, None] & np.isfinite(L)[:, None]
                    seen[b, h][np.ix_(rows[live], keys[keys < Sk])] += \
                        ok[live][:, keys < Sk]
                    ds = p * (dO @ V.T - dl[:, None]) * scale
                    acc += ds @ K
                dq[b, h, rows[live]] = acc[live]
                delta[b, h, rows[live]] = dl[live]
    return dq, delta, seen


def _emulate_dkv(q, k, v, do, lse, delta, causal, scale):
    B, H, Sq, D = q.shape
    Sk, BQ, off = k.shape[2], _inner_tile(D), k.shape[2] - q.shape[2]
    dk, dv = np.zeros(k.shape), np.zeros(v.shape)
    seen = np.zeros((B, H, Sq, Sk), int)
    for b in range(B):
        for h in range(H):
            for k0 in range(0, Sk, ROWS):
                keys = np.arange(k0, k0 + ROWS)
                K, V = _rows(k[b, h], k0, ROWS), _rows(v[b, h], k0, ROWS)
                q_begin = (max(k0 - off, 0) // BQ) * BQ if causal else 0
                n_tiles = -(-(Sq - q_begin) // BQ) if q_begin < Sq else 0
                n_masked = 0
                if causal:
                    span = k0 + ROWS - 1 - off - q_begin
                    n_masked = 0 if span <= 0 else min(n_tiles,
                                                       -(-span // BQ))
                ring = _Ring(n_tiles)
                adk, adv = np.zeros((ROWS, D)), np.zeros((ROWS, D))
                for j in range(n_tiles):
                    ring.take(j)
                    qt = q_begin + j * BQ
                    cols = np.arange(qt, qt + BQ)
                    Q, dO = _rows(q[b, h], qt, BQ), _rows(do[b, h], qt, BQ)
                    L, Dl = np.zeros(BQ), np.zeros(BQ)  # zero-filled past Sq
                    L[cols < Sq] = lse[b, h, cols[cols < Sq]]
                    Dl[cols < Sq] = delta[b, h, cols[cols < Sq]]
                    vis = (not causal) | (keys[:, None] <= cols[None, :] + off)
                    if j < n_masked:
                        L = np.where(L <= NEG_INF / 2, np.inf, L)
                        pt = np.where(vis, np.exp(K @ Q.T * scale - L), 0.0)
                    else:
                        assert vis.all() and (L > NEG_INF / 2).all()
                        pt = np.exp(K @ Q.T * scale - L)
                    ok = vis & (keys[:, None] < Sk) & (cols[None, :] < Sq) & \
                        (L < np.inf)[None, :]
                    seen[b, h][np.ix_(cols[cols < Sq], keys[keys < Sk])] += \
                        ok[keys < Sk][:, cols < Sq].T
                    dst = pt * (V @ dO.T - Dl[None, :]) * scale
                    adv += pt @ dO
                    adk += dst @ Q
                live = keys < Sk
                dk[b, h, keys[live]] = adk[live]
                dv[b, h, keys[live]] = adv[live]
    return dk, dv, seen


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", [
    (1, 2, 130, 130, 64, True),
    (1, 1, 200, 77, 128, True),      # Sq > Sk: 123 rows see no key
    (1, 1, 77, 200, 20, True),       # Sq < Sk: offset causal mask
    (2, 1, 193, 193, 64, False),     # one past the 192-row ring
    (1, 1, 300, 100, 32, True),
    (1, 1, 65, 63, 16, False),
    (1, 1, 97, 97, 128, True),       # one past the 96-row ring at D 128
])
def test_kernel_tile_walk_reproduces_plain_backward(B, H, Sq, Sk, D, causal):
    """The dq and dk/dv kernels' walk (full tiles, diagonal tiles, ring
    order) gives the plain version's dq, dk, dv and delta; every visible
    pair is visited once by each kernel."""
    q, k, v, do = _inputs(B, H, Sq, Sk, D, seed=Sq * 7 + Sk + D)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash.flash_attention_fwd_plain(tq, tk, tv, causal)
    scale = D ** -0.5
    *want, want_delta = flash.flash_attention_bwd_plain(
        tq, tk, tv, o, lse, tdo, causal, return_delta=True)
    o64, lse64 = o.double().numpy(), lse.numpy()
    dq, delta, seen_q = _emulate_dq(q, k, v, o64, do, lse64, causal, scale)
    dk, dv, seen_kv = _emulate_dkv(q, k, v, do, lse64, delta, causal, scale)
    rows, keys = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    visible = np.broadcast_to((not causal) | (keys <= rows + Sk - Sq),
                              seen_q.shape)
    np.testing.assert_array_equal(seen_q, visible)
    np.testing.assert_array_equal(seen_kv, visible)
    # the emulation runs in fp64, the plain version in fp32
    for name, got, w in zip(("dq", "dk", "dv", "delta"), (dq, dk, dv, delta),
                            (*want, want_delta)):
        np.testing.assert_allclose(got, w.numpy(), **TOL, err_msg=name)
