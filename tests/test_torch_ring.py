"""The lse gradient of the port's flash attention, and ring and Ulysses
attention over ``torch.distributed`` (gloo ranks spawned by
``tests/torch_dist_worker.py``), against the JAX package on the CPU.

* ``flash_attention_with_lse`` is differentiable in both outputs: its
  gradients under random output and lse cotangents match ``jax.vjp`` of
  the JAX ``flash_attention_with_lse`` (whose Pallas backward runs in
  interpret mode), causal and not, at rtol = atol = 2e-5 (fp32; the two
  sum in another order, ``tests/test_torch_flash_bwd.py``'s bound). The
  plain backward's delta − g_lse also matches the autograd of the plain
  forward.
* Ring and Ulysses at world 2 and 4: each rank holds its chunk of the
  sequence; the chunks' outputs and gradients, concatenated, match
  ``jax.vjp`` of the JAX ``ring_attention`` / ``ulysses_attention`` on a 2-
  and a 4-device mesh (their jnp attention on the CPU), causal and not,
  at 2e-5. Ulysses with heads that the world does not divide raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import flash as jax_flash
from deepspeed_tpu.ops.transformer import ring as jax_ring
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.ops.transformer import flash
from tests import torch_dist_worker as worker

TOL = dict(rtol=2e-5, atol=2e-5)
WORLDS = (2, 4)


def _jax_vjp(fn, args, cotangent):
    """(fn(*args), its VJP at ``cotangent``), traced and compiled as one
    ``jax.jit`` (the same values as eager ``jax.vjp``, ten times sooner
    on the CPU)."""
    @jax.jit
    def run(args, cotangent):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cotangent)

    return run(jax.tree.map(jnp.asarray, args),
               jax.tree.map(jnp.asarray, cotangent))


def _arrays(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", [
    (2, 2, 64, 64, 16, True), (2, 2, 64, 64, 16, False),
    (1, 2, 24, 96, 32, True), (1, 3, 40, 72, 32, False)])
def test_lse_gradient_matches_jax_vjp(B, H, Sq, Sk, D, causal):
    rng = np.random.default_rng(Sq + Sk + D + causal)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, Sk, D)).astype(np.float32)
            for _ in range(2))
    g_out = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    g_lse = rng.standard_normal((B, H, Sq)).astype(np.float32)
    (o, lse), want = _jax_vjp(
        lambda a, b, c: jax_flash.flash_attention_with_lse(a, b, c, causal,
                                                           0.3),
        (q, k, v), (g_out, g_lse))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    to, tlse = flash.flash_attention_with_lse(tq, tk, tv, causal, 0.3)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(o), **TOL)
    np.testing.assert_allclose(tlse.detach().numpy(), np.asarray(lse),
                               **TOL)
    got = torch.autograd.grad((to, tlse), (tq, tk, tv),
                              (torch.from_numpy(g_out),
                               torch.from_numpy(g_lse)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    # the lse cotangent alone (no output cotangent)
    _, want = _jax_vjp(
        lambda a, b, c: jax_flash.flash_attention_with_lse(a, b, c, causal,
                                                           0.3)[1],
        (q, k, v), g_lse)
    to, tlse = flash.flash_attention_with_lse(tq, tk, tv, causal, 0.3)
    got = torch.autograd.grad(tlse, (tq, tk, tv), torch.from_numpy(g_lse))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_folds_g_lse_like_autograd(causal):
    """delta − g_lse in the plain backward against the autograd of the
    plain forward (dense softmax and logsumexp), fp32."""
    q, k, v, g_out = (torch.from_numpy(a) for a in _arrays((1, 2, 48, 16),
                                                           seed=5))
    g_lse = torch.from_numpy(_arrays((1, 2, 48), seed=6, n=1)[0])
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = flash.flash_attention_fwd_plain(*qkv, causal, 0.25)
    want = torch.autograd.grad((o, lse), qkv, (g_out, g_lse))
    o, lse = flash.flash_attention_fwd_plain(q, k, v, causal, 0.25)
    got = flash.flash_attention_bwd_plain(q, k, v, o, lse, g_out, causal,
                                          0.25, g_lse=g_lse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


# (fn, B, H, S, D, causal): S divides by 4; Ulysses' H by the world
RING_CASES = [("ring", 2, 2, 64, 16, True), ("ring", 2, 2, 64, 16, False),
              ("ulysses", 1, 4, 64, 16, True),
              ("ulysses", 1, 4, 64, 16, False)]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """{world: [rank results a case]}, one spawn a world size; the last
    case is Ulysses with heads the world does not divide."""
    out = {}
    for world in WORLDS:
        cases = []
        for i, (fn, B, H, S, D, causal) in enumerate(RING_CASES):
            q, k, v, do = _arrays((B, H, S, D), seed=10 + i)
            cases.append(dict(fn=fn, q=q, k=k, v=v, do=do, causal=causal,
                              scale=0.3))
        q, k, v, do = _arrays((1, world + 1, 16, 8), seed=99)
        cases.append(dict(fn="ulysses", q=q, k=k, v=v, do=do, causal=True))
        res = worker.run("ring", world,
                         str(tmp_path_factory.mktemp(f"ring{world}")), cases)
        assert all(r["jax_modules"] == [] for r in res)
        out[world] = [[r["cases"][i] for r in res] for i in range(len(cases))]
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(len(RING_CASES)),
                         ids=[f"{c[0]}-causal{c[5]}" for c in RING_CASES])
def test_sequence_parallel_matches_jax(port, case, world):
    fn, B, H, S, D, causal = RING_CASES[case]
    q, k, v, do = _arrays((B, H, S, D), seed=10 + case)
    groups.destroy()
    mesh = groups.initialize(devices=jax.devices()[:world])
    jfn = {"ring": jax_ring.ring_attention,
           "ulysses": jax_ring.ulysses_attention}[fn]
    out, want = _jax_vjp(lambda a, b, c: jfn(a, b, c, mesh, "data",
                                             causal=causal, sm_scale=0.3),
                         (q, k, v), do)
    ranks = port[world][case]
    got_out = np.concatenate([r["out"] for r in ranks], axis=2)
    np.testing.assert_allclose(got_out, np.asarray(out), **TOL)
    for i, name in enumerate(("dq", "dk", "dv")):
        got = np.concatenate([r["grads"][i] for r in ranks], axis=2)
        np.testing.assert_allclose(got, np.asarray(want[i]), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_refuses_heads_the_world_does_not_divide(port, world):
    for r in port[world][-1]:
        assert "divisible" in r["error"]


@pytest.mark.parametrize("causal", [True, False])
def test_world_one_without_a_group_is_flash_attention(causal):
    """Without a process group ring and Ulysses are one chunk: forward and
    gradients ``flash_attention``'s bit for bit."""
    from deepspeed_tpu_torch.ops.transformer import ring
    q, k, v, do = (torch.from_numpy(a) for a in _arrays((2, 4, 32, 16),
                                                        seed=3))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    ref = flash.flash_attention(q, k, v, causal)
    ref_g = torch.autograd.grad(ref, (q, k, v), do)
    for fn in (ring.ring_attention, ring.ulysses_attention):
        out = fn(q, k, v, causal=causal)
        grads = torch.autograd.grad(out, (q, k, v), do)
        assert torch.equal(out, ref)
        assert all(torch.equal(a, b) for a, b in zip(grads, ref_g))
