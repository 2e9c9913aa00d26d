"""Optimizer update rules on dicts of tensors (counterpart of
``deepspeed_tpu/runtime/optim.py``).

Each optimizer is an ``Optimizer(init, update)`` pair:
``update(grads, state, params, lr)`` returns ``(updates, state)`` and the
engine adds the updates to the fp32 master params. Params, grads and
updates are dicts ``name -> tensor``; the applied-step count and the
learning rate are host numbers, so the bias corrections are too. The
arithmetic follows the JAX functions operation by operation, with the
bias corrections taken in fp32 as ``1 - b ** step`` is there.
"""

from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params, lr) -> (updates, state)
    # fuses_clip: the optimizer applies the global-norm clip inside its
    # own sweep: update() accepts clip_coef= and the engine skips the
    # separate clip pass over the grads
    fuses_clip: bool = False
    # partitions_state: the optimizer cuts its state by the ZeRO
    # partition it was built with (the sweep's flat chunks) and gathers
    # its own updates; the engine hands it whole gradients and params
    # (at ZeRO 2 its chunk of the reduce-scattered flat gradients)
    partitions_state: bool = False
    # takes_slices: the update acts on a tensor's slice as on the whole
    # tensor (elementwise, or LAMB built with ``partition=``, which sums
    # its norms over the ranks). At ZeRO >= 1 over a process group the
    # engine then hands it each rank's slices (``runtime/zero/
    # partition.py``) and gathers the updates. Otherwise (a client
    # optimizer by default) it gets whole tensors and keeps its state
    # whole on every rank: under JAX's GSPMD a client's math sees whole
    # tensors too
    takes_slices: bool = False


class AdamState(NamedTuple):
    step: int        # applied updates so far
    mu: Any
    nu: Any


def bias_corrections(b1, b2, step, bias_correction=True):
    """(1 − b1^step, 1 − b2^step) in fp32, as the JAX step computes them
    (``1.0 - b ** step.astype(float32)``); (1, 1) without correction."""
    if not bias_correction:
        return 1.0, 1.0
    one, s = np.float32(1.0), np.float32(step)
    return (float(one - np.float32(b1) ** s),
            float(one - np.float32(b2) ** s))


def adam(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, adam_w_mode=True,
         bias_correction=True):
    """Adam/AdamW in plain torch (the default, as the JAX default is jnp).

    adam_w_mode=True: decoupled weight decay (AdamW); False: L2 decay
    folded into the gradient."""

    def init(params):
        return AdamState(
            step=0,
            mu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()})

    def update(grads, state, params, lr):
        step = state.step + 1
        bc1, bc2 = bias_corrections(b1, b2, step, bias_correction)
        lr = float(lr)
        if not adam_w_mode and weight_decay > 0.0:
            grads = {k: g + weight_decay * params[k] for k, g in grads.items()}
        mu = {k: b1 * state.mu[k] + (1.0 - b1) * g for k, g in grads.items()}
        nu = {k: b2 * state.nu[k] + (1.0 - b2) * (g * g)
              for k, g in grads.items()}
        lr_wd = float(np.float32(lr) * np.float32(weight_decay))
        updates = {}
        for k in grads:
            u = -lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
            if adam_w_mode and weight_decay > 0.0:
                u = u - lr_wd * params[k]
            updates[k] = u
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update, takes_slices=True)


class LambState(NamedTuple):
    step: int        # applied updates so far
    mu: Any
    nu: Any


def lamb_trust_ratio(w_norm, u_norm, min_coeff, max_coeff):
    """clip(‖w‖ / ‖u‖, min_coeff, max_coeff), or 1 where either norm is 0
    (a tensor that starts at zero takes the plain Adam-style step). Works
    on device scalars or vectors of norms; nothing is read back."""
    return torch.where((w_norm > 0) & (u_norm > 0),
                       torch.clamp(w_norm / u_norm, min_coeff, max_coeff),
                       torch.ones_like(w_norm))


def lamb(b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0, min_coeff=0.01,
         max_coeff=10.0, bias_correction=True, partition=None):
    """LAMB with a per-tensor trust ratio in plain torch (the JAX
    ``optim.lamb``, config ``fused: false``): Adam moments, the update
    direction u = m̂ / (√v̂ + eps) (+ wd · p), and −lr · ratio · u.

    ``partition`` (a ``runtime.zero.partition.ZeroPartition``): the
    update sees each rank's slices, so the squared norms of the slices
    are summed over the ranks (each replicated tensor once) before the
    trust ratio, one all-reduce a step."""

    def init(params):
        zeros = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        return LambState(step=0, mu=zeros,
                         nu={k: torch.zeros_like(z) for k, z in zeros.items()})

    def update(grads, state, params, lr):
        step = state.step + 1
        bc1, bc2 = bias_corrections(b1, b2, step, bias_correction)
        lr = float(lr)
        mu = {k: b1 * state.mu[k] + (1.0 - b1) * g for k, g in grads.items()}
        nu = {k: b2 * state.nu[k] + (1.0 - b2) * (g * g)
              for k, g in grads.items()}
        updates = {}
        for k in grads:
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
            if weight_decay > 0.0:
                u = u + weight_decay * params[k]
            updates[k] = u
        if partition is None:
            for k, u in updates.items():
                ratio = lamb_trust_ratio(
                    torch.linalg.vector_norm(params[k].float()),
                    torch.linalg.vector_norm(u.float()), min_coeff,
                    max_coeff)
                updates[k] = -lr * ratio * u
        else:
            names = list(updates)
            sq = partition.sum_over_ranks(names, torch.stack([
                torch.stack([torch.sum(torch.square(params[k].float()))
                             for k in names]),
                torch.stack([torch.sum(torch.square(updates[k].float()))
                             for k in names])]))
            ratio = lamb_trust_ratio(torch.sqrt(sq[0]), torch.sqrt(sq[1]),
                                     min_coeff, max_coeff)
            for i, k in enumerate(names):
                updates[k] = -lr * ratio[i] * updates[k]
        return updates, LambState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update,
                     takes_slices=partition is not None)


class SGDState(NamedTuple):
    momentum: Any    # () without momentum, else the buffers


def sgd(momentum=0.0, weight_decay=0.0, nesterov=False):
    """SGD with optional momentum (Nesterov or heavy-ball) and L2 weight
    decay folded into the gradient (JAX ``optim.sgd``)."""

    def init(params):
        if momentum == 0.0:
            return SGDState(momentum=())
        return SGDState(momentum={k: torch.zeros_like(p)
                                  for k, p in params.items()})

    def update(grads, state, params, lr):
        lr = float(lr)
        if weight_decay > 0.0:
            grads = {k: g + weight_decay * params[k]
                     for k, g in grads.items()}
        if momentum == 0.0:
            return {k: -lr * g for k, g in grads.items()}, state
        buf = {k: momentum * state.momentum[k] + g for k, g in grads.items()}
        if nesterov:
            upd = {k: -lr * (g + momentum * buf[k]) for k, g in grads.items()}
        else:
            upd = {k: -lr * b for k, b in buf.items()}
        return upd, SGDState(momentum=buf)

    return Optimizer(init, update, takes_slices=True)


class AdagradState(NamedTuple):
    accum: Any


def adagrad(eps=1e-8, weight_decay=0.0, initial_accumulator_value=0.0):
    """Adagrad: the sum of squared gradients scales each step (JAX
    ``optim.adagrad``)."""

    def init(params):
        return AdagradState(accum={
            k: torch.full_like(p, initial_accumulator_value)
            for k, p in params.items()})

    def update(grads, state, params, lr):
        lr = float(lr)
        if weight_decay > 0.0:
            grads = {k: g + weight_decay * params[k]
                     for k, g in grads.items()}
        accum = {k: state.accum[k] + g * g for k, g in grads.items()}
        updates = {k: -lr * g / (torch.sqrt(accum[k]) + eps)
                   for k, g in grads.items()}
        return updates, AdagradState(accum=accum)

    return Optimizer(init, update, takes_slices=True)


class FlatTreeSpec(NamedTuple):
    """How to rebuild a dict of tensors from one flat vector: the names,
    per-tensor shapes and dtypes, ``n`` the unpadded element count and
    ``n_pad`` the padded vector length."""
    names: tuple
    shapes: tuple
    dtypes: tuple
    n: int
    n_pad: int


def flatten_tree(tree, pad_to=1, dtype=torch.float32):
    """One contiguous ``dtype`` vector holding the dict's tensors back to
    back in key order, zero-padded to a multiple of ``pad_to``, and the
    :class:`FlatTreeSpec` that undoes it."""
    if not tree:
        raise ValueError("flatten_tree: empty tree")
    names = tuple(tree)
    leaves = [tree[k] for k in names]
    n = sum(x.numel() for x in leaves)
    pad_to = max(1, int(pad_to))
    n_pad = -(-n // pad_to) * pad_to
    vec = torch.empty(n_pad, dtype=dtype, device=leaves[0].device)
    torch.cat([x.reshape(-1).to(dtype) for x in leaves], out=vec[:n])
    vec[n:].zero_()
    spec = FlatTreeSpec(names=names,
                        shapes=tuple(tuple(x.shape) for x in leaves),
                        dtypes=tuple(x.dtype for x in leaves), n=n,
                        n_pad=n_pad)
    return vec, spec


def unflatten_tree(vec, spec: FlatTreeSpec):
    """The dict back from a (padded) flat vector made against the same
    structure; each tensor is a view of ``vec`` when its dtype matches,
    else a cast copy."""
    if tuple(vec.shape) != (spec.n_pad,):
        raise ValueError(f"unflatten_tree: vector shape {tuple(vec.shape)} "
                         f"!= spec ({spec.n_pad},)")
    out, off = {}, 0
    for name, shape, dt in zip(spec.names, spec.shapes, spec.dtypes):
        size = int(np.prod(shape)) if shape else 1
        out[name] = vec[off:off + size].view(shape).to(dt)
        off += size
    return out


def global_norm(tree):
    """Global L2 norm over a dict of tensors, as a device fp32 scalar: the
    square root of the sum of each tensor's sum of squares."""
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(x.float())) for x in tree.values()]).sum())


def clip_coefficient(norm, max_norm):
    """min(max_norm / (norm + 1e-6), 1): the torch-semantics clip
    coefficient, a device scalar when ``norm`` is one."""
    return torch.clamp(max_norm / (norm + 1e-6), max=1.0)


def clip_by_global_norm(grads, max_norm):
    """Scale grads so that their global norm is at most ``max_norm``;
    returns (clipped grads, norm)."""
    norm = global_norm(grads)
    coef = clip_coefficient(norm, max_norm)
    return {k: g * coef for k, g in grads.items()}, norm
