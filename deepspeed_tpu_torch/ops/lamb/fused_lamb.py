"""Fused LAMB: the Hopper kernel ``csrc/lamb.cu`` (pass 1) and its plain
PyTorch version (counterpart of ``deepspeed_tpu/ops/lamb/fused_lamb.py``).

Pass 1 reads (p, g, m, v) once and writes the update direction u, the new
moments and each tensor's sum(p²) and sum(u²); the trust ratio
``where(‖w‖ > 0 & ‖u‖ > 0, clip(‖w‖/‖u‖, min, max), 1)`` and the update
−lr · ratio · u are plain torch on the device, as the JAX package leaves
them to XLA. Nothing in a step reads a value back to the host.

On CUDA, :func:`lamb_pass1` takes all of a step's tensors in one launch
(a device table of their pointers, rebuilt each call, since ``.grad``
tensors are new every step); u, m' and v' come back as views of three
flat buffers. On the CPU it runs :func:`lamb_pass1_plain` per tensor, as
the JAX function runs its kernel per tensor.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops._platform import use_kernel
from deepspeed_tpu_torch.runtime import optim as optim_lib

_CHUNK = 16384   # elements a block of the kernel updates (lamb.cu kChunk)


def lamb_pass1_plain(p, g, m, v, bc1, bc2, *, b1=0.9, b2=0.999, eps=1e-6,
                     weight_decay=0.0):
    """One tensor, in fp32, in the order of the JAX kernel
    (fused_lamb.py:31-41): returns (u, m', v', sum(p²), sum(u²)), the sums
    as device scalars."""
    pf, gf = p.float(), g.float()
    m_new = b1 * m + (1.0 - b1) * gf
    v_new = b2 * v + (1.0 - b2) * gf * gf
    u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if weight_decay > 0.0:
        u = u + weight_decay * pf
    return u, m_new, v_new, torch.sum(pf * pf), torch.sum(u * u)


def lamb_pass1_all_plain(ps, gs, ms, vs, bc1, bc2, **kw):
    """The plain version of :func:`lamb_pass1`: :func:`lamb_pass1_plain`
    per tensor, the squared norms stacked."""
    outs = [lamb_pass1_plain(p, g, m, v, bc1, bc2, **kw)
            for p, g, m, v in zip(ps, gs, ms, vs)]
    return ([o[0] for o in outs], [o[1] for o in outs],
            [o[2] for o in outs], torch.stack([o[3] for o in outs]),
            torch.stack([o[4] for o in outs]))


def lamb_pass1(ps, gs, ms, vs, bc1, bc2, *, b1=0.9, b2=0.999, eps=1e-6,
               weight_decay=0.0):
    """Pass 1 over lists of tensors: (us, m's, v's, wsq, usq) with wsq and
    usq fp32 vectors of the tensors' sum(p²) and sum(u²).

    CUDA tensors: one ``ds_lamb`` launch over all of them (contiguous fp32
    p, g, m, v of matching sizes). CPU tensors:
    :func:`lamb_pass1_all_plain`."""
    if not (len(ps) == len(gs) == len(ms) == len(vs)) or not ps:
        raise ValueError("lamb_pass1 takes equal, non-empty lists")
    if not use_kernel(*ps, *gs, *ms, *vs):
        return lamb_pass1_all_plain(ps, gs, ms, vs, bc1, bc2, b1=b1, b2=b2,
                                    eps=eps, weight_decay=weight_decay)
    for i, group in enumerate(zip(ps, gs, ms, vs)):
        for name, t in zip("pgmv", group):
            if t.dtype != torch.float32 or not t.is_contiguous() or \
                    t.numel() != group[0].numel():
                raise ValueError(f"lamb kernel takes contiguous fp32 tensors "
                                 f"of one size; {name}[{i}] is {t.dtype} "
                                 f"{tuple(t.shape)}")
    dev = gs[0].device
    sizes = [g.numel() for g in gs]
    outs = [torch.empty(sum(sizes), dtype=torch.float32, device=dev)
            for _ in range(3)]
    table, n_chunks = launch_table(ps, gs, ms, vs, outs)
    partial = torch.empty(2 * n_chunks, dtype=torch.float32, device=dev)
    wsq = torch.empty(len(gs), dtype=torch.float32, device=dev)
    usq = torch.empty_like(wsq)
    f32 = lambda x: float(np.float32(x))
    err = op_builder.load_kernels().ds_lamb(
        table.data_ptr(), len(gs), n_chunks, partial.data_ptr(),
        wsq.data_ptr(), usq.data_ptr(), f32(bc1), f32(bc2), f32(b1),
        f32(1.0 - b1), f32(b2), f32(1.0 - b2), f32(eps), f32(weight_decay),
        torch.cuda.current_stream(dev).cuda_stream)
    op_builder.check_launch(err, "lamb")
    us, m_out, v_out = ([t.view(g.shape) for t, g in zip(o.split(sizes), gs)]
                        for o in outs)
    return us, m_out, v_out, wsq, usq


def launch_table(ps, gs, ms, vs, outs):
    """The kernel's device table for inputs ``ps, gs, ms, vs`` and the
    three flat fp32 outputs ``outs`` (u, m', v', each tensor at its running
    offset), and the launch's chunk count. The output pointers are
    computed, not taken from views."""
    rows, chunk0, off = [], 0, 0
    out_ptrs = [o.data_ptr() for o in outs]
    for p, g, m, v in zip(ps, gs, ms, vs):
        n = g.numel()
        rows += [p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr()]
        rows += [ptr + 4 * off for ptr in out_ptrs] + [n, chunk0]
        chunk0 += -(-n // _CHUNK)
        off += n
    # pinned, so the copy is queued on the stream without a host wait
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
        gs[0].device, non_blocking=True)
    return table, chunk0


def _scaled_updates(us, wsq, usq, lr, min_coeff, max_coeff):
    """−lr · ratio · u for each tensor, computed in place in the us (the
    JAX ``-lr * ratio * u``: the scalar product first)."""
    ratio = optim_lib.lamb_trust_ratio(torch.sqrt(wsq), torch.sqrt(usq),
                                       min_coeff, max_coeff)
    scale = -float(lr) * ratio
    torch._foreach_mul_(us, list(scale.unbind(0)))
    return us


def fused_lamb_update(p, g, m, v, lr, bc1, bc2, *, b1=0.9, b2=0.999,
                      eps=1e-6, weight_decay=0.0, min_coeff=0.01,
                      max_coeff=10.0):
    """One fused LAMB step for a single fp32 tensor; returns
    (update, m, v)."""
    us, m_new, v_new, wsq, usq = lamb_pass1(
        [p], [g], [m], [v], bc1, bc2, b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay)
    upd = _scaled_updates(us, wsq, usq, lr, min_coeff, max_coeff)[0]
    return upd.to(p.dtype), m_new[0], v_new[0]


def fused_lamb(b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0, min_coeff=0.01,
               max_coeff=10.0, bias_correction=True, partition=None):
    """Optimizer pair over :func:`lamb_pass1` (config ``fused: true``): on
    CUDA one kernel launch a step for all tensors. The engine applies the
    global-norm clip to the grads first (``fuses_clip`` False), as the JAX
    engine does for LAMB.

    ``partition`` (ZeRO >= 1 over a process group): pass 1 runs on each
    rank's slices, and a trust ratio needs the whole tensor's norms, so
    the stacked sum(p²) and sum(u²) are summed over the ranks (each
    replicated tensor counted once) before :func:`_scaled_updates`: one
    small all-reduce a step."""

    def init(params):
        return optim_lib.lamb().init(params)

    def update(grads, state, params, lr):
        step = state.step + 1
        bc1, bc2 = optim_lib.bias_corrections(b1, b2, step, bias_correction)
        names = list(grads)
        us, mu, nu, wsq, usq = lamb_pass1(
            [params[k] for k in names], [grads[k] for k in names],
            [state.mu[k] for k in names], [state.nu[k] for k in names],
            bc1, bc2, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
        if partition is not None:
            wsq, usq = partition.sum_over_ranks(names,
                                                torch.stack([wsq, usq]))
        updates = _scaled_updates(us, wsq, usq, lr, min_coeff, max_coeff)
        return (dict(zip(names, updates)),
                optim_lib.LambState(step=step, mu=dict(zip(names, mu)),
                                    nu=dict(zip(names, nu))))

    return optim_lib.Optimizer(init, update,
                               takes_slices=partition is not None)


class FusedLamb:
    """The reference wrapper's constructor surface
    (``ops/lamb/fused_lamb.py:12``): returns the :func:`fused_lamb`
    pair."""

    def __new__(cls, params=None, lr=1e-3, betas=(0.9, 0.999), eps=1e-6,
                weight_decay=0.0, min_coeff=0.01, max_coeff=10.0,
                bias_correction=True, **_):
        return fused_lamb(b1=betas[0], b2=betas[1], eps=eps,
                          weight_decay=weight_decay, min_coeff=min_coeff,
                          max_coeff=max_coeff, bias_correction=bias_correction)
