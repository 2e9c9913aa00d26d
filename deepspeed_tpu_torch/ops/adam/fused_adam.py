"""Fused Adam: the Hopper kernel ``csrc/adam.cu`` and its plain PyTorch
version (counterpart of ``deepspeed_tpu/ops/adam/fused_adam.py``).

An elementwise kernel reads (p, g, m, v) once and writes (update, m, v).
Exposed two ways, as in the JAX package:

* :func:`fused_adam_update` and :func:`fused_adam`: the per-tensor form
  (config ``optimizer.params.fused``). :func:`fused_adam_multi` updates a
  list of tensors in one launch (up to ``MULTI_MAX_TENSORS`` a launch),
  the table of tensors passed by value in the kernel's parameters;
  :func:`fused_adam` makes one such call a step, and
  :func:`fused_adam_update` is the call with one tensor;
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
# csrc/adam.cu's multi-tensor launch: tensors a launch (kMaxTensors) and
# elements a block (kChunk)
MULTI_MAX_TENSORS = 448
MULTI_CHUNK = 4096


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


def _multi_route(ps, gs, ms, vs):
    """True (launch) when the lists lie on one CUDA device, False on the
    CPU; raises on unequal lists or tensors on different devices. Cheap
    per tensor: the fused optimizer passes every tensor of a model."""
    if not (len(ps) == len(gs) == len(ms) == len(vs)):
        raise ValueError("fused_adam_multi takes equal lists")
    devices = {t.get_device() for lst in (ps, gs, ms, vs) for t in lst}
    if len(devices) != 1:
        raise ValueError(f"tensors must share one device, got {devices}")
    return use_kernel(gs[0])


def _check_multi(ps, gs, ms, vs):
    """The kernel's contract: fp32 p, g, m, v of one size per tensor.
    Tensors that are not contiguous are replaced by contiguous copies (the
    outputs are fresh flat buffers either way). Returns the sizes and the
    four lists."""
    sizes = [g.numel() for g in gs]
    lists = []
    for name, lst in zip("pgmv", (ps, gs, ms, vs)):
        # comprehensions, not generators: the host cost is per tensor
        if {t.dtype for t in lst} == {torch.float32} and \
                (lst is gs or [t.numel() for t in lst] == sizes):
            if not all([t.is_contiguous() for t in lst]):
                lst = [t.contiguous() for t in lst]
            lists.append(lst)
            continue
        for i, (t, n) in enumerate(zip(lst, sizes)):
            if t.dtype != torch.float32 or t.numel() != n:
                raise ValueError(f"adam kernel takes fp32 tensors of one "
                                 f"size; {name}[{i}] is {t.dtype} "
                                 f"{tuple(t.shape)}")
    return (sizes, *lists)


def multi_table(ps, gs, ms, vs, sizes=None):
    """The host table of ``ds_adam_multi`` for the lists: int64 [n, 6]
    rows (p, g, m, v pointers, numel, output offset), the offsets running
    over the sizes padded to multiples of 4 so that each tensor's outputs
    start 16-byte aligned; also the padded sizes and the flat output
    length."""
    if sizes is None:
        sizes = [g.numel() for g in gs]
    padded = [-(-n // 4) * 4 for n in sizes]
    table = np.empty((len(gs), 6), dtype=np.int64)
    table[:, 0] = [t.data_ptr() for t in ps]
    table[:, 1] = [t.data_ptr() for t in gs]
    table[:, 2] = [t.data_ptr() for t in ms]
    table[:, 3] = [t.data_ptr() for t in vs]
    table[:, 4] = sizes
    table[0, 5] = 0
    np.cumsum(padded[:-1], out=table[1:, 5])
    return table, padded, int(table[-1, 5]) + padded[-1]


def fused_adam_multi(ps, gs, ms, vs, lr, bc1, bc2, *, b1=0.9, b2=0.999,
                     eps=1e-8, weight_decay=0.0, adam_w_mode=True):
    """One Adam step for every fp32 tensor of the lists (the TPU
    ``_adam_kernel`` applied to each: p always read, clip coefficient 1);
    returns three lists (updates, m, v) in the tensors' shapes.

    CUDA tensors launch ``ds_adam_multi`` once for up to
    ``MULTI_MAX_TENSORS`` tensors (the table travels in the kernel's
    parameters); the outputs are views of three flat fp32 buffers. CPU
    tensors run :func:`adam_sweep_apply_plain` on each tensor."""
    ps, gs, ms, vs = list(ps), list(gs), list(ms), list(vs)
    if not gs:
        return [], [], []
    if not _multi_route(ps, gs, ms, vs):
        outs = [adam_sweep_apply_plain(p, g, m, v, lr, bc1, bc2, 1.0, b1=b1,
                                       b2=b2, eps=eps,
                                       weight_decay=weight_decay,
                                       adam_w_mode=adam_w_mode)
                for p, g, m, v in zip(ps, gs, ms, vs)]
        return ([o[0] for o in outs], [o[1] for o in outs],
                [o[2] for o in outs])
    sizes, ps, gs, ms, vs = _check_multi(ps, gs, ms, vs)
    table, padded, total = multi_table(ps, gs, ms, vs, sizes)
    dev = gs[0].device
    u, mo, vo = (torch.empty(total, dtype=torch.float32, device=dev)
                 for _ in range(3))
    f32 = lambda x: float(np.float32(x))
    lib = op_builder.load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i in range(0, len(gs), MULTI_MAX_TENSORS):
        part = np.ascontiguousarray(table[i:i + MULTI_MAX_TENSORS])
        if not part[:, 4].any():
            continue  # only empty tensors: nothing to launch
        err = lib.ds_adam_multi(
            part.ctypes.data, len(part), u.data_ptr(), mo.data_ptr(),
            vo.data_ptr(), f32(lr), f32(bc1), f32(bc2), f32(b1),
            f32(1.0 - b1), f32(b2), f32(1.0 - b2), f32(eps),
            f32(weight_decay), int(bool(adam_w_mode)), stream)
        op_builder.check_launch(err, "adam")
    if padded == sizes:
        parts = lambda flat: flat.split(sizes)
    else:
        split = [n for size, pad in zip(sizes, padded)
                 for n in (size, pad - size)]
        parts = lambda flat: flat.split(split)[::2]
    # views in the tensors' shapes; split already gives the 1-D ones (and
    # view(*ints) costs the host half what view(torch.Size) does)
    shapes = [None if g.dim() == 1 else tuple(g.shape) for g in gs]
    return tuple([t if shape is None else t.view(*shape) if shape
                  else t.view(())
                  for t, shape in zip(parts(flat), shapes)]
                 for flat in (u, mo, vo))


def fused_adam_update(p, g, m, v, lr, bc1, bc2, *, b1=0.9, b2=0.999,
                      eps=1e-8, weight_decay=0.0, adam_w_mode=True):
    """One Adam step for a single fp32 tensor; returns (update, m, v):
    :func:`fused_adam_multi` with one tensor (the JAX counterpart's API).
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    u, m_new, v_new = fused_adam_multi(
        [p], [g], [m], [v], lr, bc1, bc2, b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay, adam_w_mode=adam_w_mode)
    return u[0], m_new[0], v_new[0]


def fused_adam(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
               adam_w_mode=True, bias_correction=True):
    """Optimizer pair over :func:`fused_adam_multi` (the TPU package's
    ``fused_adam``): on CUDA one kernel launch a step for up to
    ``MULTI_MAX_TENSORS`` tensors."""

    def init(params):
        return optim_lib.adam().init(params)

    def update(grads, state, params, lr):
        step = state.step + 1
        bc1, bc2 = optim_lib.bias_corrections(b1, b2, step, bias_correction)
        keys = list(grads)
        us, mu, nu = fused_adam_multi(
            [params[k] for k in keys], [grads[k] for k in keys],
            [state.mu[k] for k in keys], [state.nu[k] for k in keys], lr,
            bc1, bc2, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
            adam_w_mode=adam_w_mode)
        return (dict(zip(keys, us)),
                optim_lib.AdamState(step=step, mu=dict(zip(keys, mu)),
                                    nu=dict(zip(keys, nu))))

    return optim_lib.Optimizer(init, update, takes_slices=True)


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


def _sweep_parts(names, partition):
    """[(names, expert)]: the sweep's flat vectors, one, or at a partition
    with expert leaves (expert parallelism) the dense leaves' and the
    experts'."""
    names = list(names)
    if partition is None or not partition.expert:
        return [(names, False)]
    parts = [([n for n in names if n not in partition.expert], False),
             ([n for n in names if n in partition.expert], True)]
    return [(ns, expert) for ns, expert in parts if ns]


def _quantum(partition, expert):
    """A flat vector's padding: the kernel's block times the ranks it is
    cut over."""
    return _SWEEP_PAD * (1 if partition is None
                         else partition.group_world(expert))


def sweep_specs(shapes, partition=None):
    """The specs of :func:`sweep_flatten` from ``{name: shape}`` alone:
    ``[(FlatTreeSpec, expert)]``, one a flat vector."""
    specs = []
    for names, expert in _sweep_parts(shapes, partition):
        q = _quantum(partition, expert)
        sizes = [int(np.prod(shapes[n])) if shapes[n] else 1 for n in names]
        n = sum(sizes)
        specs.append((optim_lib.FlatTreeSpec(
            names=tuple(names), shapes=tuple(tuple(shapes[k])
                                             for k in names),
            dtypes=(torch.float32,) * len(names), n=n,
            n_pad=-(-n // q) * q), expert))
    return specs


def sweep_flatten(tree, partition=None):
    """This rank's flat fp32 vector of ``tree`` in the sweep's state layout
    and its specs (:func:`sweep_specs`): the tree back to back in key
    order, zero-padded to a multiple of ``sweep_pad()`` (× the world it is
    cut over, with a ``partition``), and this rank's chunk of it. With
    expert leaves in the partition, the dense leaves' chunk (cut over the
    world) then the experts' (cut over the expert-data group)."""
    vecs, specs = [], []
    for names, expert in _sweep_parts(tree, partition):
        vec, spec = optim_lib.flatten_tree({k: tree[k] for k in names},
                                           pad_to=_quantum(partition, expert))
        if partition is not None:
            vec = partition.chunk(vec, expert)
        vecs.append(vec)
        specs.append((spec, expert))
    return (vecs[0] if len(vecs) == 1 else torch.cat(vecs)), specs


def sweep_unflatten(vec, specs, partition=None):
    """The whole tree of this rank's sweep vector ``vec`` (the inverse of
    :func:`sweep_flatten`): each part's chunks gathered over its group,
    then cut into the leaves (views)."""
    out, off = {}, 0
    for spec, expert in specs:
        n = spec.n_pad // (1 if partition is None
                           else partition.group_world(expert))
        piece = vec[off:off + n]
        off += n
        if partition is not None:
            piece = partition.gather_flat(piece, expert)
        out.update(optim_lib.unflatten_tree(piece, spec))
    return out


def fused_adam_sweep(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                     adam_w_mode=True, bias_correction=True, partition=None):
    """Adam as one whole-state sweep (config ``optimizer.params.sweep``).

    ``partition`` (ZeRO >= 1 over a process group,
    ``runtime.zero.partition.ZeroPartition``): the flat vectors are padded
    to a multiple of ``sweep_pad() × world`` and each rank keeps and
    updates its contiguous chunk (a multiple of the kernel's block, so
    it starts on the kernel's 16-byte alignment); the chunks of the
    update are then all-gathered into the whole vector. At an
    expert-parallel partition the state is two chunks back to back, the
    dense leaves' and the experts' (:func:`sweep_flatten`), swept in one
    launch and gathered over their own groups. The clip
    coefficient is the engine's, from the averaged gradients of the
    whole model, the same on every rank.

    The grads are flattened into one padded vector each step (a flat
    grad buffer that ``.grad`` aliases would save that copy: a later
    change); at ZeRO 2 ``update`` takes, in place of the dict, the
    chunk of that vector the engine reduce-scattered (the flatten is
    then the reduce-scatter's input). The params are flattened only for
    weight decay. The
    global-norm clip rides inside the sweep (``fuses_clip``), so the
    engine skips its own pass over the grads. The cast output is not
    used: the engine's forward casts the masters itself."""

    def init(params):
        vec, _ = sweep_flatten(params, partition)
        return AdamSweepState(step=0, mu=torch.zeros_like(vec),
                              nu=torch.zeros_like(vec))

    def update(grads, state, params, lr, clip_coef=None):
        step = state.step + 1
        bc1, bc2 = optim_lib.bias_corrections(b1, b2, step, bias_correction)
        if isinstance(grads, torch.Tensor):
            # ZeRO 2: the engine reduce-scattered the flat gradient
            # vector straight into this rank's chunk
            flat_g = grads
            specs = sweep_specs({k: tuple(p.shape)
                                 for k, p in params.items()}, partition)
        else:
            flat_g, specs = sweep_flatten(grads, partition)
        flat_p = (sweep_flatten(params, partition)[0]
                  if weight_decay > 0.0 else None)
        u, mu, nu, _ = adam_sweep_apply(
            flat_p, flat_g, state.mu, state.nu, lr, bc1, bc2,
            1.0 if clip_coef is None else clip_coef, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay, adam_w_mode=adam_w_mode)
        return (sweep_unflatten(u, specs, partition),
                AdamSweepState(step=step, mu=mu, nu=nu))

    return optim_lib.Optimizer(init, update, fuses_clip=True,
                               partitions_state=partition is not None)
