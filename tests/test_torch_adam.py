"""The PyTorch port's fused Adam forms against the JAX package's.

The JAX side runs ``fused_adam_update`` and ``adam_sweep_apply(use_pallas
=True)``, whose Pallas kernels run in interpret mode on the CPU; the
port's side runs its plain versions, which its wrappers take on CPU
tensors. Inputs come from a numpy seed. Tolerance rtol 1e-6, atol 1e-7:
the same fp32 operations in the same order. The CUDA kernel is held
against the plain version in tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam import fused_adam as jax_fa
from deepspeed_tpu.runtime import optim as jax_optim
from deepspeed_tpu_torch.ops.adam import fused_adam
from deepspeed_tpu_torch.runtime import optim

TOL = dict(rtol=1e-6, atol=1e-7)
LR, BC1, BC2 = np.float32(1e-3), np.float32(0.271), np.float32(0.002997)


def _state(shape, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    m = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    v = (0.01 * rng.standard_normal(shape) ** 2).astype(np.float32)
    return p, g, m, v


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_per_tensor_form_matches_jax(weight_decay, adam_w_mode):
    p, g, m, v = _state((37, 53), seed=int(weight_decay * 100) + adam_w_mode)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay,
              adam_w_mode=adam_w_mode)
    want = jax_fa.fused_adam_update(*(jnp.asarray(a) for a in (p, g, m, v)),
                                    LR, BC1, BC2, **kw)
    got = fused_adam.fused_adam_update(
        *(torch.from_numpy(a) for a in (p, g, m, v)), float(LR), float(BC1),
        float(BC2), **kw)
    for a, b in zip(got, want):
        assert a.shape == (37, 53)
        _close(a, b)


@pytest.mark.parametrize("weight_decay,adam_w_mode,clip_coef,cast", [
    (0.0, True, 1.0, False), (0.0, True, 0.5, False),
    (0.01, True, 0.5, False), (0.01, False, 0.5, False),
    (0.01, True, 0.5, True), (0.0, True, 1.0, True)])
def test_sweep_form_matches_jax(weight_decay, adam_w_mode, clip_coef, cast):
    n = fused_adam.sweep_pad() * 2
    p, g, m, v = _state((n,), seed=7)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay,
              adam_w_mode=adam_w_mode)
    want = jax_fa.adam_sweep_apply(
        *(jnp.asarray(a) for a in (p, g, m, v)), LR, BC1, BC2,
        np.float32(clip_coef), cast_dtype=jnp.bfloat16 if cast else None,
        use_pallas=True, **kw)
    got = fused_adam.adam_sweep_apply(
        *(torch.from_numpy(a) for a in (p, g, m, v)), float(LR), float(BC1),
        float(BC2), clip_coef, cast_dtype=torch.bfloat16 if cast else None,
        **kw)
    for a, b in zip(got[:3], want[:3]):
        _close(a, b)
    if cast:
        assert got[3].dtype == torch.bfloat16
        _close(got[3], np.asarray(want[3].astype(jnp.float32)))
    else:
        assert got[3] is None and want[3] is None


def test_sweep_skips_params_without_decay_or_cast():
    n = fused_adam.sweep_pad()
    _, g, m, v = _state((n,), seed=3)
    u, _, _, cast = fused_adam.adam_sweep_apply(
        None, torch.from_numpy(g), torch.from_numpy(m), torch.from_numpy(v),
        1e-3, 0.1, 0.001, 0.5)
    assert cast is None and u.dtype == torch.float32


@pytest.mark.parametrize("weight_decay,clip", [(0.0, None), (0.01, 0.3)])
def test_optimizer_forms_match_jax_over_steps(weight_decay, clip):
    """fused (per tensor) and sweep (flat, clip inside) against the JAX
    optimizers over three steps on a dict of tensors."""
    rng = np.random.default_rng(9)
    shapes = {"a": (33, 7), "b": (5,), "c": (2, 3, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    kw = dict(weight_decay=weight_decay)
    for jax_opt, port_opt in (
            (jax_fa.fused_adam(**kw), fused_adam.fused_adam(**kw)),
            (jax_fa.fused_adam_sweep(use_pallas=True, **kw),
             fused_adam.fused_adam_sweep(**kw))):
        jp = {k: jnp.asarray(a) for k, a in params.items()}
        tp = {k: torch.from_numpy(a.copy()) for k, a in params.items()}
        js, ts = jax_opt.init(jp), port_opt.init(tp)
        for step in range(3):
            grads = {k: rng.standard_normal(s).astype(np.float32)
                     for k, s in shapes.items()}
            jg = {k: jnp.asarray(a) for k, a in grads.items()}
            tg = {k: torch.from_numpy(a) for k, a in grads.items()}
            cc = None
            if clip is not None:
                norm = jax_optim.global_norm(jg)
                cc = np.float32(jnp.minimum(clip / (norm + 1e-6), 1.0))
            if port_opt.fuses_clip:
                ju, js = jax_opt.update(jg, js, jp, LR, clip_coef=cc)
                tu, ts = port_opt.update(tg, ts, tp, float(LR),
                                         clip_coef=None if cc is None
                                         else float(cc))
            else:
                if cc is not None:
                    jg = {k: g * cc for k, g in jg.items()}
                    tg = {k: g * float(cc) for k, g in tg.items()}
                ju, js = jax_opt.update(jg, js, jp, LR)
                tu, ts = port_opt.update(tg, ts, tp, float(LR))
            for k in shapes:
                _close(tu[k], ju[k])
            jp = {k: jp[k] + ju[k] for k in jp}
            tp = {k: tp[k] + tu[k] for k in tp}
        assert ts.step == int(js.step) == 3
