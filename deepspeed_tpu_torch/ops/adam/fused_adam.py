"""Fused Adam: the Hopper kernel ``csrc/adam.cu`` and its plain PyTorch
version (counterpart of ``deepspeed_tpu/ops/adam/fused_adam.py``).

One elementwise kernel reads (p, g, m, v) once and writes (update, m, v).
Exposed two ways, as in the JAX package:

* :func:`fused_adam_update` and :func:`fused_adam`: one launch per tensor
  (config ``optimizer.params.fused``);
* :func:`adam_sweep_apply` and :func:`fused_adam_sweep`: one launch over
  the whole state flattened into padded fp32 vectors, with the global-norm
  clip coefficient folded in (``optimizer.params.sweep``).

On CUDA tensors the wrappers launch the kernel; on CPU tensors they run
:func:`adam_sweep_apply_plain`. m and v come back as new tensors, as the
JAX functions return them.
"""

from typing import NamedTuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops._platform import use_kernel
from deepspeed_tpu_torch.runtime import optim as optim_lib

_SWEEP_PAD = 256 * 128   # the JAX sweep kernel's block (rows x lanes)


def sweep_pad():
    """Flat-vector padding quantum of the sweep, the JAX package's 32768
    (its kernel's block), kept so the flat layouts of the two agree."""
    return _SWEEP_PAD


def adam_sweep_apply_plain(p, g, m, v, lr, bc1, bc2, clip_coef=1.0, *,
                           b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                           adam_w_mode=True, cast_dtype=None):
    """The Adam chain in plain torch, operation for operation as the JAX
    sweep's jnp twin (fused_adam.py:175-189); with ``clip_coef`` 1 it is
    also the plain version of the per-tensor form. ``clip_coef`` may be a
    float or a device scalar; p is read only for weight decay or the cast.
    Returns ``(u, m_new, v_new, cast)`` with ``cast = (p + u)`` in
    ``cast_dtype`` or None."""
    gg = g.float() * clip_coef
    if not adam_w_mode and weight_decay > 0.0:
        gg = gg + weight_decay * p.float()
    m_new = b1 * m + (1.0 - b1) * gg
    v_new = b2 * v + (1.0 - b2) * gg * gg
    u = -float(lr) * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if adam_w_mode and weight_decay > 0.0:
        u = u - float(np.float32(lr) * np.float32(weight_decay)) * p.float()
    cast = ((p.float() + u).to(cast_dtype) if cast_dtype is not None
            else None)
    return u.to(g.dtype if p is None else p.dtype), m_new, v_new, cast


def _launch(p, g, m, v, lr, bc1, bc2, clip_coef, b1, b2, eps, weight_decay,
            adam_w_mode, read_p, cast_dtype):
    """Launch ``ds_adam`` over flat fp32 vectors; (u, m_new, v_new, cast)."""
    for name, t in (("g", g), ("m", m), ("v", v)) + \
            ((("p", p),) if read_p else ()):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.shape != g.shape:
            raise ValueError(f"adam kernel takes contiguous fp32 tensors of "
                             f"one shape; {name} is {t.dtype} "
                             f"{tuple(t.shape)}")
    if cast_dtype not in (None, torch.bfloat16):
        raise TypeError(f"adam kernel casts to bfloat16 only, got "
                        f"{cast_dtype}")
    if cast_dtype is not None and not read_p:
        raise ValueError("the cast output needs p")
    n = g.numel()
    u, mo, vo = torch.empty_like(g), torch.empty_like(m), torch.empty_like(v)
    cast = (torch.empty(g.shape, dtype=cast_dtype, device=g.device)
            if cast_dtype is not None else None)
    if n == 0:
        return u, mo, vo, cast
    cc = None
    if isinstance(clip_coef, torch.Tensor):
        if clip_coef.numel() != 1 or clip_coef.device != g.device:
            raise ValueError("clip_coef must be a scalar on the grads' device")
        cc = clip_coef.reshape(()).float()
    elif float(clip_coef) != 1.0:
        cc = torch.tensor(float(clip_coef), dtype=torch.float32,
                          device=g.device)
    bufs = [g, m, v, u, mo, vo] + ([p] if read_p else []) + \
        ([cast] if cast is not None else [])
    vec = int(all(t.data_ptr() % 16 == 0 for t in bufs))
    f32 = lambda x: float(np.float32(x))
    lib = op_builder.load_kernels()
    err = lib.ds_adam(
        p.data_ptr() if read_p else None, g.data_ptr(), m.data_ptr(),
        v.data_ptr(), u.data_ptr(), mo.data_ptr(), vo.data_ptr(),
        cast.data_ptr() if cast is not None else None, n,
        cc.data_ptr() if cc is not None else None, f32(lr), f32(bc1),
        f32(bc2), f32(b1), f32(1.0 - b1), f32(b2), f32(1.0 - b2), f32(eps),
        f32(weight_decay), int(bool(adam_w_mode)), int(bool(read_p)), vec,
        torch.cuda.current_stream(g.device).cuda_stream)
    op_builder.check_launch(err, "adam")
    return u, mo, vo, cast


def fused_adam_update(p, g, m, v, lr, bc1, bc2, *, b1=0.9, b2=0.999,
                      eps=1e-8, weight_decay=0.0, adam_w_mode=True):
    """One Adam step for a single fp32 tensor; returns (update, m, v).
    CUDA tensors launch the kernel (p always read, clip coefficient 1, as
    the TPU ``_adam_kernel``); CPU tensors run the plain version."""
    if not use_kernel(p, g, m, v):
        u, m_new, v_new, _ = adam_sweep_apply_plain(
            p, g, m, v, lr, bc1, bc2, 1.0, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay, adam_w_mode=adam_w_mode)
        return u, m_new, v_new
    shape = p.shape
    u, m_new, v_new, _ = _launch(
        p.reshape(-1), g.reshape(-1), m.reshape(-1), v.reshape(-1), lr, bc1,
        bc2, 1.0, b1, b2, eps, weight_decay, adam_w_mode, True, None)
    return u.view(shape), m_new.view(shape), v_new.view(shape)


def fused_adam(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
               adam_w_mode=True, bias_correction=True):
    """Optimizer pair over :func:`fused_adam_update`: one launch per
    tensor (the TPU package's ``fused_adam``)."""

    def init(params):
        return optim_lib.adam().init(params)

    def update(grads, state, params, lr):
        step = state.step + 1
        bc1, bc2 = optim_lib.bias_corrections(b1, b2, step, bias_correction)
        out = {k: fused_adam_update(params[k], g, state.mu[k], state.nu[k],
                                    lr, bc1, bc2, b1=b1, b2=b2, eps=eps,
                                    weight_decay=weight_decay,
                                    adam_w_mode=adam_w_mode)
               for k, g in grads.items()}
        return ({k: o[0] for k, o in out.items()},
                optim_lib.AdamState(step=step,
                                    mu={k: o[1] for k, o in out.items()},
                                    nu={k: o[2] for k, o in out.items()}))

    return optim_lib.Optimizer(init, update)


def adam_sweep_apply(p, g, m, v, lr, bc1, bc2, clip_coef=1.0, *, b1=0.9,
                     b2=0.999, eps=1e-8, weight_decay=0.0, adam_w_mode=True,
                     cast_dtype=None):
    """One pass over the whole flattened state: g · clip_coef, the Adam
    update and, with ``cast_dtype`` (bf16), the cast of p + u. Inputs are
    flat fp32 vectors whose length is a multiple of :func:`sweep_pad`
    (``optim.flatten_tree(pad_to=sweep_pad())``). p is read only for
    weight decay or the cast, so it may be None otherwise. ``clip_coef``
    is a float or a device scalar (no host sync). Returns
    ``(u, m_new, v_new, cast)``."""
    read_p = weight_decay > 0.0 or cast_dtype is not None
    if not use_kernel(g, m, v, p if read_p else None):
        return adam_sweep_apply_plain(
            p, g, m, v, lr, bc1, bc2, clip_coef, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay, adam_w_mode=adam_w_mode,
            cast_dtype=cast_dtype)
    if g.dim() != 1 or g.numel() % _SWEEP_PAD:
        raise ValueError(f"adam_sweep_apply: flat length {g.numel()} must "
                         f"be a multiple of {_SWEEP_PAD} "
                         f"(flatten_tree(pad_to=sweep_pad()))")
    return _launch(p, g, m, v, lr, bc1, bc2, clip_coef, b1, b2, eps,
                   weight_decay, adam_w_mode, read_p, cast_dtype)


class AdamSweepState(NamedTuple):
    """Whole-state sweep moments: one padded fp32 vector each."""
    step: int
    mu: torch.Tensor
    nu: torch.Tensor


def fused_adam_sweep(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                     adam_w_mode=True, bias_correction=True):
    """Adam as one whole-state sweep (config ``optimizer.params.sweep``).

    The grads are flattened into one padded vector each step (a flat
    grad buffer that ``.grad`` aliases would save that copy: a later
    change); the params are flattened only for weight decay. The
    global-norm clip rides inside the sweep (``fuses_clip``), so the
    engine skips its own pass over the grads. The cast output is not
    used: the engine's forward casts the masters itself."""

    def init(params):
        vec, _ = optim_lib.flatten_tree(params, pad_to=_SWEEP_PAD)
        return AdamSweepState(step=0, mu=torch.zeros_like(vec),
                              nu=torch.zeros_like(vec))

    def update(grads, state, params, lr, clip_coef=None):
        step = state.step + 1
        bc1, bc2 = optim_lib.bias_corrections(b1, b2, step, bias_correction)
        flat_g, spec = optim_lib.flatten_tree(grads, pad_to=_SWEEP_PAD)
        flat_p = (optim_lib.flatten_tree(params, pad_to=_SWEEP_PAD)[0]
                  if weight_decay > 0.0 else None)
        u, mu, nu, _ = adam_sweep_apply(
            flat_p, flat_g, state.mu, state.nu, lr, bc1, bc2,
            1.0 if clip_coef is None else clip_coef, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay, adam_w_mode=adam_w_mode)
        updates = optim_lib.unflatten_tree(u, spec)
        return updates, AdamSweepState(step=step, mu=mu, nu=nu)

    return optim_lib.Optimizer(init, update, fuses_clip=True)
