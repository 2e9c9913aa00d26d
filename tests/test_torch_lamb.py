"""The PyTorch port's LAMB (plain and fused forms) against the JAX
package's.

The JAX side runs ``fused_lamb_update`` / ``fused_lamb``, whose Pallas
pass-1 kernel runs in interpret mode on the CPU, and ``optim.lamb``; the
port's side runs its plain versions, which its wrappers take on CPU
tensors. Inputs come from a numpy seed. Tolerance rtol 1e-6, atol 1e-7:
the elementwise chain is the same fp32 operations in the same order; the
norms are sums taken in another order, which moves the trust ratio by an
ulp or two. The CUDA kernel is held against the plain version in
tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.lamb import fused_lamb as jax_fl
from deepspeed_tpu.runtime import optim as jax_optim
from deepspeed_tpu_torch.ops.lamb import fused_lamb
from deepspeed_tpu_torch.runtime import optim

TOL = dict(rtol=1e-6, atol=1e-7)
LR, BC1, BC2 = np.float32(1e-3), np.float32(0.271), np.float32(0.002997)


def _state(shape, seed, p_scale=1.0, g_scale=1.0):
    rng = np.random.default_rng(seed)
    p = (p_scale * rng.standard_normal(shape)).astype(np.float32)
    g = (g_scale * rng.standard_normal(shape)).astype(np.float32)
    m = (0.1 * g_scale * rng.standard_normal(shape)).astype(np.float32)
    v = (0.01 * g_scale ** 2 * rng.standard_normal(shape) ** 2).astype(
        np.float32)
    return p, g, m, v


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("case,shape,p_scale,weight_decay", [
    ("plain", (37, 53), 1.0, 0.0),
    ("decay", (37, 53), 1.0, 0.01),
    ("larger than one 32768-element block", (300, 129), 1.0, 0.01),
    ("zero tensor: ratio 1", (64,), 0.0, 0.0),
    ("ratio clamped at max_coeff", (16, 16), 1e3, 0.0),
    ("ratio clamped at min_coeff", (16, 16), 1e-5, 0.0),
])
def test_fused_lamb_update_matches_jax(case, shape, p_scale, weight_decay):
    p, g, m, v = _state(shape, seed=len(case), p_scale=p_scale)
    kw = dict(b1=0.9, b2=0.999, eps=1e-6, weight_decay=weight_decay,
              min_coeff=0.01, max_coeff=10.0)
    want = jax_fl.fused_lamb_update(*(jnp.asarray(a) for a in (p, g, m, v)),
                                    LR, BC1, BC2, **kw)
    got = fused_lamb.fused_lamb_update(
        *(torch.from_numpy(a) for a in (p, g, m, v)), float(LR), float(BC1),
        float(BC2), **kw)
    for a, b in zip(got, want):
        assert a.shape == shape and a.dtype == torch.float32
        _close(a, b)
    # the branch of the trust ratio this case exercises
    u, _, _, wsq, usq = fused_lamb.lamb_pass1_plain(
        *(torch.from_numpy(a) for a in (p, g, m, v)), float(BC1), float(BC2),
        weight_decay=weight_decay)
    ratio = float(optim.lamb_trust_ratio(wsq.sqrt(), usq.sqrt(), 0.01, 10.0))
    expect = {"zero tensor: ratio 1": 1.0, "ratio clamped at max_coeff": 10.0,
              "ratio clamped at min_coeff": 0.01}.get(case)
    if expect is not None:
        assert ratio == pytest.approx(expect, rel=1e-7)
    else:
        assert 0.01 < ratio < 10.0
    assert torch.isfinite(got[0]).all()


def test_pass1_over_many_tensors_equals_per_tensor():
    """``lamb_pass1`` on lists (the engine's one-launch form on CUDA) gives
    each tensor's pass 1 and the stacked squared norms."""
    shapes = [(33, 7), (5,), (40000,), (2, 3, 4)]
    states = [_state(s, seed=i) for i, s in enumerate(shapes)]
    cols = [[torch.from_numpy(st[j]) for st in states] for j in range(4)]
    us, ms, vs, wsq, usq = fused_lamb.lamb_pass1(*cols, 0.19, 0.002,
                                                 weight_decay=0.01)
    assert wsq.shape == usq.shape == (len(shapes),)
    for i, st in enumerate(states):
        want = fused_lamb.lamb_pass1_plain(
            *(torch.from_numpy(a) for a in st), 0.19, 0.002,
            weight_decay=0.01)
        for a, b in zip((us[i], ms[i], vs[i], wsq[i], usq[i]), want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_lamb_optimizers_match_jax_over_steps(fused, weight_decay):
    """``fused_lamb`` (config ``fused: true``) and ``optim.lamb`` against
    their JAX counterparts over three steps on a dict of tensors, one of
    them zero (a bias at init) and one larger than a kernel block."""
    rng = np.random.default_rng(9)
    shapes = {"a": (33, 7), "bias": (5,), "c": (2, 3, 4), "big": (40000,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    params["bias"][:] = 0.0
    kw = dict(weight_decay=weight_decay)
    jax_opt = (jax_fl.fused_lamb(**kw) if fused else jax_optim.lamb(**kw))
    port_opt = (fused_lamb.fused_lamb(**kw) if fused else optim.lamb(**kw))
    jp = {k: jnp.asarray(a) for k, a in params.items()}
    tp = {k: torch.from_numpy(a.copy()) for k, a in params.items()}
    js, ts = jax_opt.init(jp), port_opt.init(tp)
    for _ in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        ju, js = jax_opt.update({k: jnp.asarray(a) for k, a in grads.items()},
                                js, jp, LR)
        tu, ts = port_opt.update({k: torch.from_numpy(a)
                                  for k, a in grads.items()}, ts, tp,
                                 float(LR))
        for k in shapes:
            _close(tu[k], ju[k])
            _close(ts.mu[k], js.mu[k])
            _close(ts.nu[k], js.nu[k])
        jp = {k: jp[k] + ju[k] for k in jp}
        tp = {k: tp[k] + tu[k] for k in tp}
    assert ts.step == int(js.step) == 3


def test_fused_lamb_shell_takes_the_reference_arguments():
    opt = fused_lamb.FusedLamb(lr=1e-3, betas=(0.8, 0.99), eps=1e-7,
                               weight_decay=0.01, max_grad_norm=1.0)
    p = {"w": torch.ones(4)}
    state = opt.init(p)
    upd, state = opt.update({"w": torch.full((4,), 0.5)}, state, p, 1e-3)
    assert state.step == 1 and not opt.fuses_clip
    # first step: u = 1 + wd·p = 1.01 everywhere and ratio = ‖p‖ / ‖u‖,
    # so ratio · u = ‖p‖ / √4 = 1 and the update is −lr
    torch.testing.assert_close(upd["w"], torch.full((4,), -1e-3),
                               rtol=1e-5, atol=1e-8)
