"""Block-sparse flash attention over a list of live tiles: the Hopper
kernels of ``csrc/sparse_attention.cu`` (forward, dq, dk/dv), their plain
PyTorch versions, and the host half of
``deepspeed_tpu/ops/sparse_attention/fused_kernels.py``: the layout
decomposition, the packing of global columns, the strategy cache and the
autograd ``Function`` that joins the kernels.

Semantics are the JAX module's. q, k, v are ``[B, H, S, D]``; the layout
is ``[H, S // block, S // block]``; an optional ``[B, S]`` additive
key-padding bias is shared by the heads of a batch element. Layouts of
the "band + global" kind are decomposed: the key columns attended by
nearly every row are gathered into a packed region after the real
sequence (``Skv > Sq``) and go through the same kernels, where the
positional causal triangle applies to the real region only (the packed
columns carry block-level causality in the layout itself); the few global
rows are computed densely in plain torch and overwrite their output rows.

What differs from the TPU design, and why:

* The TPU walks one flat work list per (batch·head) on a sequential grid,
  carrying its accumulators from one step to the next. Hopper blocks run
  in no order, so the host builds, once per strategy, a CSR list per head
  of 64 × 64 tiles: for each output tile, the live streamed tiles and the
  fine-block bits of the pair (row-major for the forward and dq,
  column-major for dk/dv). One CTA owns one (batch·head, output tile) and
  loops over its segment. The lists go to the device once, when the
  strategy is built, not on every call.
* Tiles are the card's: 64 query rows × 64 keys (one warpgroup's
  ``wgmma`` in the backward, ``mma.sync`` in the forward), not the TPU's
  512 × 1024 (``DS_SPARSE_BQ``/``DS_SPARSE_BKC`` are not read). A fine
  block smaller than the tile (8, 16, 32) is masked per pair with a 64-bit
  word of fine-block bits; a larger one (a multiple of 64) spans several
  tiles. Causal tiles wholly above the diagonal are dropped from the lists
  (they add nothing).
* With the lists the host flags, once, the pairs that need mask
  arithmetic (a fine-block word that is not all-ones, a causal diagonal
  tile, the key tail); the backward kernels run every other pair without
  it. It also orders each list's output tiles longest segment first, the
  order in which the backward kernels' grids walk them.
* The dq kernel computes delta = rowsum(do·o) − g_lse for its rows from
  the rows it stages, and writes it for the dk/dv kernel.
* The packed region starts on a tile edge: the real region is padded with
  dead key columns up to a multiple of 64 when the sequence is not.
* ``D`` is read from the tensors on every call, never kept on the
  strategy.
* Only the dense global-row part is recomputed in the backward
  (``torch.utils.checkpoint``); the kernel ``Function`` saves q, k, v, o
  and the lse, which are O(S), so the forward kernel runs once a layer.

The kernel wrappers pick their route from the tensors' device only: CUDA
tensors launch the kernel (or raise), CPU tensors run the plain version.
"""

import ctypes
import hashlib

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops._platform import use_kernel
from deepspeed_tpu_torch.ops.transformer.flash import (_DTYPES, _aligned16,
                                                       _heads_view)

NEG_INF = -1e30
TILE = 64        # query rows and keys of one kernel tile
MAX_D = 64       # head dims the kernels take


# ------------------------------------------------------------ tile lists
def _check_block(block):
    """The kernels' tiles hold whole fine blocks (8, 16, 32: at most 64
    fine blocks a tile, one 64-bit word), or a fine block holds whole
    tiles (a multiple of 64)."""
    if not ((TILE % block == 0 and block >= 8) or block % TILE == 0):
        raise ValueError(
            f"block-sparse attention takes blocks 8, 16, 32 or a multiple "
            f"of {TILE}, got {block}")


def _tile_bits(lay, block):
    """[H, nq, nk] bool fine layout -> [H, nqt, nkt] uint64: bit
    (r·n + c) of a tile pair is fine block (r, c) inside it, n = 64 /
    fine block (one bit a pair when a fine block spans whole tiles)."""
    H, nq, nk = lay.shape
    if block >= TILE:
        m = block // TILE
        return lay.repeat(m, axis=1).repeat(m, axis=2).astype(np.uint64)
    n = TILE // block
    nqt, nkt = -(-nq // n), -(-nk // n)
    pad = np.zeros((H, nqt * n, nkt * n), bool)
    pad[:, :nq, :nk] = lay
    view = pad.reshape(H, nqt, n, nkt, n).astype(np.uint64)
    weights = np.left_shift(np.uint64(1), np.arange(n * n, dtype=np.uint64)
                            ).reshape(n, n)
    return (view * weights[None, None, :, None, :]).sum(axis=(2, 4),
                                                        dtype=np.uint64)


def _csr(bits):
    """[H, n_out, n_stream] uint64 -> (ptr [H·n_out + 1] int32, idx [nnz]
    int32, bits [nnz] int64): the live streamed tiles of each output tile,
    in order, heads one after another."""
    H, n_out, _ = bits.shape
    h, i, j = np.nonzero(bits)
    counts = np.bincount(h * n_out + i, minlength=H * n_out)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return ptr, j.astype(np.int32), bits[h, i, j].view(np.int64)


def _full_word(fine):
    """The fine-block word of a pair whose every fine block is live."""
    n = (TILE // min(fine, TILE)) ** 2
    return np.uint64(0xFFFFFFFFFFFFFFFF) if n == 64 else np.uint64((1 << n) - 1)


def _walk(lists, n_out, queries_out, fine, causal, causal_ntiles, Skv):
    """(flags uint8 [nnz], order int32 [H·n_out]) of one CSR list: 1 where
    a pair needs mask arithmetic (its fine-block word is not all-ones, it
    is a causal diagonal tile of the real region, or it holds the key
    tail), and the segments by length, longest first (ties in index
    order). ``queries_out``: the output tiles are query tiles."""
    ptr, idx, words = lists
    counts = np.diff(ptr)
    out = np.repeat(np.arange(len(counts)) % n_out, counts)
    qt, kt = (out, idx) if queries_out else (idx, out)
    flags = (words.view(np.uint64) != _full_word(fine)) | \
        ((kt + 1) * TILE > Skv)
    if causal:
        flags |= (qt == kt) & (kt < causal_ntiles)
    order = np.argsort(-counts, kind="stable")
    return flags.astype(np.uint8), order.astype(np.int32)


class _Strategy:
    """One layout's tile lists (on ``device``) and its autograd entry
    points.

    ``lay`` [H, nq, nk] may be rectangular (nk > nq): key columns from
    ``causal_nblocks`` fine blocks on are packed global columns whose
    causality the layout already holds at block level; the positional
    triangle applies to the real region before them."""

    def __init__(self, lay, block, causal, sm_scale, causal_nblocks, device):
        _check_block(block)
        H, nq, nk = lay.shape
        self.lay = lay
        self.block, self.causal, self.sm_scale = block, causal, sm_scale
        self.H, self.Sq, self.Skv = H, nq * block, nk * block
        if causal_nblocks is None:
            causal_nblocks = nk
        self.real_tokens = causal_nblocks * block
        if causal_nblocks != nk and self.real_tokens % TILE:
            raise ValueError(f"the packed region must start on a tile "
                             f"edge, got {self.real_tokens} real keys")
        self.causal_ntiles = -(-self.real_tokens // TILE)
        self.fine = min(block, TILE)
        bits = _tile_bits(lay, block)
        self.n_qtiles, self.n_ktiles = bits.shape[1:]
        if causal:
            # tiles of the real region wholly above the diagonal
            i = np.arange(self.n_qtiles)[:, None]
            j = np.arange(self.n_ktiles)[None, :]
            bits[:, (j > i) & (j < self.causal_ntiles)] = 0
        self.tile_pairs = int(np.count_nonzero(bits))
        self.fwd_lists = _csr(bits)
        self.bwd_lists = _csr(bits.transpose(0, 2, 1))
        # the backward kernels' mask flags and CTA orders
        walk = (self.fine, causal, self.causal_ntiles, self.Skv)
        self.fwd_walk = _walk(self.fwd_lists, self.n_qtiles, True, *walk)
        self.bwd_walk = _walk(self.bwd_lists, self.n_ktiles, False, *walk)
        self.device = _device(device)
        if self.device.type == "cuda":
            self.fwd_dev = tuple(torch.from_numpy(a).to(self.device)
                                 for a in self.fwd_lists + self.fwd_walk)
            self.bwd_dev = tuple(torch.from_numpy(a).to(self.device)
                                 for a in self.bwd_lists + self.bwd_walk)

    def element_mask(self, device):
        """[H, Sq, Skv] bool: the fine layout expanded to elements, with
        the positional triangle on the real region when causal."""
        lay = torch.from_numpy(self.lay).to(device)
        mask = lay.repeat_interleave(self.block, 1).repeat_interleave(
            self.block, 2)
        if self.causal:
            rows = torch.arange(self.Sq, device=device)[:, None]
            cols = torch.arange(self.Skv, device=device)[None, :]
            mask = mask & ((cols <= rows) | (cols >= self.real_tokens))
        return mask

    def attend(self, q, k, v, kpb=None):
        """Attention output [B, H, Sq, D], differentiable in q, k, v and
        the bias."""
        return SparseAttentionFunction.apply(q, k, v, kpb, self, False,
                                             True)

    def attend_lse(self, q, k, v, kpb=None):
        """``(out, lse)`` with lse [B, H, Sq] fp32, both differentiable:
        an lse cotangent folds into delta (JAX ``_bwd_impl``)."""
        return SparseAttentionFunction.apply(q, k, v, kpb, self, True, True)


def _device(device):
    """``device`` with the current CUDA index filled in (``cuda`` ->
    ``cuda:0``), so a strategy built for ``cuda`` serves ``cuda:0``
    tensors."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _layout_key(lay):
    # a digest, not the raw bytes: sweeps over lengths would otherwise keep
    # every layout alive for the life of the process
    return hashlib.sha256(lay.tobytes()).digest(), lay.shape


_strategy_cache = {}


def _get_strategy(layout, block, causal, sm_scale, causal_nblocks=None,
                  device="cpu"):
    lay = np.asarray(layout) != 0
    key = (_layout_key(lay), block, causal, sm_scale, causal_nblocks,
           str(_device(device)))
    if key not in _strategy_cache:
        _strategy_cache[key] = _Strategy(lay, block, causal, sm_scale,
                                         causal_nblocks, device)
    return _strategy_cache[key]


# ------------------------------------------------------------ kernels
def _scale(strat, D):
    return strat.sm_scale if strat.sm_scale is not None else D ** -0.5


def _check(q, k, v, kpb, strat):
    for t in (q, k, v):
        if t.dim() != 4 or t.stride(3) != 1:
            raise ValueError("sparse attention takes [B, H, S, D] tensors "
                             "with a contiguous head dim")
    B, H, Sq, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if (H, Sq, k.shape[2]) != (strat.H, strat.Sq, strat.Skv):
        raise ValueError(f"(H, Sq, Skv) {(H, Sq, k.shape[2])} do not match "
                         f"the layout's {(strat.H, strat.Sq, strat.Skv)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"sparse kernels take float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"sparse kernels take head dims up to {MAX_D}, "
                         f"got {D}")
    if kpb is not None and tuple(kpb.shape) != (B, strat.Skv):
        raise ValueError(f"key bias must be [B, Skv] = {(B, strat.Skv)}, "
                         f"got {tuple(kpb.shape)}")
    if strat.device != q.device:
        raise ValueError(f"the strategy's tile lists lie on "
                         f"{strat.device}, the tensors on {q.device}")


def _launch(name, fn_name, strat, lists, n_out, q, k, v, *, o=None,
            dout=None, lse=None, delta=None, dq=None, dk=None, dv=None,
            bias=None, dbias=None, g_lse=None, staged=()):
    """One launch of a kernel of ``csrc/sparse_attention.cu``; ``lists``:
    (ptr, idx, bits, flags, order) on the device."""
    B, H, Sq, D = q.shape
    tensors = (q, k, v, o, dout, lse, delta, dq, dk, dv, bias, dbias,
               *lists, g_lse)
    ptrs = (ctypes.c_void_p * 18)(*(0 if t is None else t.data_ptr()
                                    for t in tensors))
    strides = (ctypes.c_longlong * 24)(*(
        st for t in (q, k, v, o, dout, dq, dk, dv)
        for st in (t.stride()[:3] if t is not None else (0, 0, 0))))
    # the rows a kernel stages in shared memory load as 16-byte vectors
    # when aligned
    vec = int(q.dtype == torch.bfloat16 and D % 8 == 0
              and _aligned16(*staged))
    dims = (ctypes.c_int * 11)(
        _DTYPES[q.dtype], B, H, Sq, k.shape[2], D, n_out,
        int(strat.causal), strat.causal_ntiles, strat.fine, vec)
    lib = op_builder.load_kernels()
    err = getattr(lib, fn_name)(
        ptrs, strides, dims, float(_scale(strat, D)),
        torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check_launch(err, name)


def _masked_scores(q, k, kpb, strat):
    """fp32 q kᵀ · sm_scale over the element mask (-1e30 elsewhere), then
    the key bias, in the JAX kernels' order (``_scores``, then the add)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * \
        _scale(strat, q.shape[-1])
    s = torch.where(strat.element_mask(q.device), s, NEG_INF)
    if kpb is not None:
        s = s + kpb.float()[:, None, None, :]
    return s


def sparse_attention_fwd_plain(q, k, v, kpb, strat):
    """Masked dense attention with the kernel's outputs: (o in q.dtype,
    lse fp32 [B, H, Sq]). Rows with no live key give o = 0 and lse =
    -1e30 (the clamp of ``fused_kernels.py:220`` and ``l_safe``); the
    unnormalised weights are rounded to v.dtype before P·V, as the kernels
    round them."""
    s = _masked_scores(q, k, kpb, strat)
    m = s.amax(-1, keepdim=True)
    p = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def _probs(q, k, kpb, lse, strat):
    s = _masked_scores(q, k, kpb, strat)
    lse = lse.float()[..., None]
    return torch.where(lse <= NEG_INF / 2, 0.0, torch.exp(s - lse))


def sparse_attention_dq_plain(q, k, v, kpb, do, o, lse, strat, g_lse=None):
    """(dq, delta) of the dq kernel on dense matrices: delta =
    rowsum(do·o) − g_lse (fp32 [B, H, Sq]), p = exp(s − lse) (0 where lse
    is -1e30), ds = p·(do vᵀ − delta)·sm_scale rounded to q.dtype, dq = ds
    k accumulated in fp32."""
    delta = (do.float() * o.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    p = _probs(q, k, kpb, lse, strat)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * _scale(strat, q.shape[-1])
    dq = torch.matmul(ds.to(q.dtype).float(), k.float()).to(q.dtype)
    return dq, delta


def sparse_attention_dkv_plain(q, k, v, kpb, do, lse, delta, strat,
                               want_dbias=False):
    """(dk, dv, dbias) of the dk/dv kernel on dense matrices: dv = pᵀ do
    with p rounded to do.dtype, dk = dsᵀ q with ds rounded to q.dtype, and
    the bias cotangent dbias [B, H, Skv] = Σ_rows p·(dp − delta) before
    sm_scale (fp32) when ``want_dbias`` and a bias is given, else None."""
    p = _probs(q, k, kpb, lse, strat)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    dsig = p * (dp - delta.float()[..., None])
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    ds = (dsig * _scale(strat, q.shape[-1])).to(q.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dbias = dsig.sum(-2) if want_dbias and kpb is not None else None
    return dk.to(k.dtype), dv.to(v.dtype), dbias


def sparse_attention_fwd(q, k, v, kpb, strat):
    """(o [B, H, Sq, D] in q.dtype, lse [B, H, Sq] fp32) of attention
    over the strategy's layout. CUDA tensors launch ``ds_sparse_fwd``; CPU
    tensors run :func:`sparse_attention_fwd_plain`. q, k, v may be strided
    views with a contiguous head dim; ``o`` is a [B, H, Sq, D] view of a
    [B, Sq, H, D] buffer."""
    if not use_kernel(q, k, v, kpb):
        return sparse_attention_fwd_plain(q, k, v, kpb, strat)
    _check(q, k, v, kpb, strat)
    B, H, Sq, D = q.shape
    o = _heads_view(B, Sq, H, D, q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _launch("sparse_fwd", "ds_sparse_fwd", strat, strat.fwd_dev,
            strat.n_qtiles, q, k, v, o=o, lse=lse,
            bias=None if kpb is None else kpb.float().contiguous(),
            staged=(k, v))
    return o, lse


def _bwd_inputs(q, do, **rows):
    """``do`` with a contiguous head dim, and the fp32 [B, H, Sq] row
    statistics (lse, delta, g_lse) contiguous; None stays None."""
    B, H, Sq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for name, t in rows.items():
        if t is not None and (t.shape != (B, H, Sq)
                              or t.dtype != torch.float32):
            raise ValueError(f"{name} must be fp32 {(B, H, Sq)}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if do.stride(3) != 1:
        do = do.contiguous()
    return (do, *(None if t is None else t.contiguous()
                  for t in rows.values()))


def sparse_attention_dq(q, k, v, kpb, do, o, lse, strat, g_lse=None):
    """(dq, delta) over the row-major tile lists, delta = rowsum(do·o) −
    g_lse fp32 [B, H, Sq] (g_lse: the lse cotangent, or None), which the
    dk/dv kernel reads. CUDA tensors launch ``ds_sparse_dq``, which
    computes delta from the rows it stages; CPU tensors run
    :func:`sparse_attention_dq_plain`."""
    if not use_kernel(q, k, v, kpb, do, o, lse, g_lse):
        return sparse_attention_dq_plain(q, k, v, kpb, do, o, lse, strat,
                                         g_lse)
    _check(q, k, v, kpb, strat)
    if o.shape != q.shape or o.dtype != q.dtype or o.stride(3) != 1:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype} with a contiguous "
                         f"head dim")
    do, lse, g_lse = _bwd_inputs(q, do, lse=lse, g_lse=g_lse)
    B, H, Sq, D = q.shape
    dq = _heads_view(B, Sq, H, D, q)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _launch("sparse_dq", "ds_sparse_dq", strat, strat.fwd_dev,
            strat.n_qtiles, q, k, v, o=o, dout=do, lse=lse, delta=delta,
            dq=dq, bias=None if kpb is None else kpb.float().contiguous(),
            g_lse=g_lse, staged=(q, k, v, do, o))
    return dq, delta


def sparse_attention_dkv(q, k, v, kpb, do, lse, delta, strat,
                         want_dbias=False):
    """(dk, dv, dbias [B, H, Skv] fp32 or None) over the column-major tile
    lists. CUDA tensors launch ``ds_sparse_dkv``; CPU tensors run
    :func:`sparse_attention_dkv_plain`. The bias cotangent is written only
    when ``want_dbias`` and a bias is given."""
    if not use_kernel(q, k, v, kpb, do, lse, delta):
        return sparse_attention_dkv_plain(q, k, v, kpb, do, lse, delta,
                                          strat, want_dbias)
    _check(q, k, v, kpb, strat)
    do, lse, delta = _bwd_inputs(q, do, lse=lse, delta=delta)
    B, H, _, D = q.shape
    Skv = k.shape[2]
    dk = _heads_view(B, Skv, H, D, k)
    dv = _heads_view(B, Skv, H, D, v)
    dbias = torch.empty((B, H, Skv), dtype=torch.float32, device=q.device) \
        if want_dbias and kpb is not None else None
    _launch("sparse_dkv", "ds_sparse_dkv", strat, strat.bwd_dev,
            strat.n_ktiles, q, k, v, dout=do, lse=lse, delta=delta, dk=dk,
            dv=dv, bias=None if kpb is None else kpb.float().contiguous(),
            dbias=dbias, staged=(q, k, v, do))
    return dk, dv, dbias


class SparseAttentionFunction(torch.autograd.Function):
    """Differentiable block-sparse attention on the three kernels: the
    forward kernel, then dq (which computes delta) and dk/dv on the saved
    q, k, v, o and lse.
    ``with_lse`` also returns the lse (its cotangent folds into delta);
    ``bias_grad=False`` returns no bias gradient (the predicated form,
    JAX ``kernels.py:390-391``)."""

    @staticmethod
    def forward(ctx, q, k, v, kpb, strat, with_lse, bias_grad):
        o, lse = sparse_attention_fwd(q, k, v, kpb, strat)
        ctx.save_for_backward(q, k, v, kpb, o, lse)
        ctx.strat, ctx.bias_grad = strat, bias_grad
        ctx.set_materialize_grads(False)
        return (o, lse) if with_lse else o

    @staticmethod
    def backward(ctx, do, g_lse=None):
        q, k, v, kpb, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        # the dq kernel computes delta = rowsum(do·o) − g_lse (JAX
        # ``_bwd_impl``) and writes it for the dk/dv kernel
        dq, delta = sparse_attention_dq(q, k, v, kpb, do, o, lse, ctx.strat,
                                        g_lse)
        want_db = ctx.bias_grad and kpb is not None and \
            ctx.needs_input_grad[3]
        dk, dv, dbias = sparse_attention_dkv(q, k, v, kpb, do, lse, delta,
                                             ctx.strat, want_db)
        if dbias is not None:
            # the bias is shared by the heads of a batch element
            dbias = dbias.sum(1).to(kpb.dtype)
        return dq, dk, dv, dbias, None, None, None


# ------------------------------------------------ layout decomposition
def _decompose_layout(lay, causal, col_thresh=0.75, row_thresh=0.75):
    """lay [H, nq, nk] bool -> (gr rows, gc cols, remainder layout).

    A column j is global when its mean liveness over the rows causality
    permits (r >= j when causal) reaches col_thresh in any head; rows
    symmetrically. Remainder = lay with global rows/cols zeroed."""
    H, nq, nk = lay.shape
    if causal:
        tri = np.tril(np.ones((nq, nk), bool))          # r >= j
        denom_c = np.maximum(tri.sum(axis=0), 1)        # rows >= j
        colness = (lay & tri).sum(axis=1) / denom_c     # [H, nk]
        denom_r = np.maximum(tri.sum(axis=1), 1)        # cols <= r
        rowness = (lay & tri).sum(axis=2) / denom_r     # [H, nq]
    else:
        colness = lay.mean(axis=1)
        rowness = lay.mean(axis=2)
    gc = np.nonzero((colness >= col_thresh).any(axis=0))[0]
    gr = np.nonzero((rowness >= row_thresh).any(axis=0))[0]
    rem = lay.copy()
    rem[:, :, gc] = False
    rem[:, gr, :] = False
    return gr, gc, rem


def _pack_layout(lay, rem, gr, gc, causal, block):
    """The rectangular layout with the global columns packed after the
    real sequence (JAX ``block_sparse_attention_fused``, :776-797), on
    this card's tile edge: (lay2, causal_nblocks, gap_tokens,
    pad_tokens). ``rem`` is updated in place, as in JAX."""
    H, nq, _ = lay.shape
    S = nq * block
    gap = (-(-S // TILE) * TILE - S) // block        # dead real-region blocks
    g_tok = len(gc) * block
    pad = (-(-g_tok // TILE) * TILE - g_tok) // block
    packed = np.zeros((H, nq, len(gc)), bool)
    for t, j in enumerate(gc):
        packed[:, :, t] = lay[:, :, j]
        if causal:
            # rows r < j are fully causal-masked, row r == j needs the
            # positional triangle (stays in the real region)
            packed[:, :j + 1, t] = False
            rem[:, j, j] = lay[:, j, j]
    packed[:, gr, :] = False
    lay2 = np.concatenate([rem, np.zeros((H, nq, gap), bool), packed,
                           np.zeros((H, nq, pad), bool)], axis=2)
    return lay2, nq + gap, gap * block, pad * block


def _expand_mask(bm, blk):
    """[H, nq, g] block mask -> [H, nq*blk, g*blk] element mask."""
    H, nq, g = bm.shape
    return np.broadcast_to(
        bm[:, :, None, :, None], (H, nq, blk, g, blk)).reshape(
            H, nq * blk, g * blk)


def _dense_part_mask(block_mask, col_ids, row_ids, causal, device):
    """The element mask of the dense global-row part: ``block_mask`` [H,
    R, G] (element-expanded) and, when causal, col <= row."""
    mask = torch.as_tensor(np.ascontiguousarray(block_mask), device=device)
    if causal:
        cm = np.asarray(col_ids)[None, :] <= np.asarray(row_ids)[:, None]
        mask = mask & torch.as_tensor(cm, device=device)[None]
    return mask


def _masked_dense_part(q, kg, vg, mask, kpb, sm_scale):
    """Dense masked attention of q rows against a key subset, with its
    own normalisation: returns (out, lse).

    q [B, H, R, D]; kg, vg [B, H, G, D]; mask [H, R, G] bool (from
    :func:`_dense_part_mask`); kpb [B, G] additive bias or None."""
    s = torch.matmul(q.float(), kg.float().transpose(-1, -2)) * sm_scale
    s = torch.where(mask[None], s, NEG_INF)
    if kpb is not None:
        s = s + kpb.float()[:, None, None, :]
    m = s.amax(-1)
    # fully-masked rows: zero weights, lse stays -1e30
    p = torch.where((m <= NEG_INF / 2)[..., None], 0.0,
                    torch.exp(s - m[..., None]))
    l = p.sum(-1)
    l_safe = torch.where(l == 0.0, 1.0, l)
    w = (p / l_safe[..., None]).to(vg.dtype).float()
    out = torch.matmul(w, vg.float()).to(q.dtype)
    return out, m + torch.log(l_safe)


class _Plan:
    """The decomposition of one layout on one device: the strategy of the
    kernel part, the packed column ids and the dense global rows."""

    def __init__(self, lay, block, causal, sm_scale, device):
        H, nq, _ = lay.shape
        S = nq * block
        gr, gc, rem = _decompose_layout(lay, causal)
        self.col_ids = self.row_ids = None
        self.gap_tokens = self.pad_tokens = 0
        if len(gc):
            lay2, causal_nblocks, self.gap_tokens, self.pad_tokens = \
                _pack_layout(lay, rem, gr, gc, causal, block)
            col_ids = (gc[:, None] * block + np.arange(block)).reshape(-1)
            self.col_ids = torch.as_tensor(col_ids, device=device)
            self.strat = _get_strategy(lay2, block, causal, sm_scale,
                                       causal_nblocks, device)
        else:
            self.strat = _get_strategy(rem, block, causal, sm_scale,
                                       device=device)
        if len(gr):
            # the few global rows attend (nearly) everything: dense torch
            row_ids = (gr[:, None] * block + np.arange(block)).reshape(-1)
            self.row_ids = torch.as_tensor(row_ids, device=device)
            self.row_mask = _dense_part_mask(
                _expand_mask(lay[:, gr, :], block), np.arange(S), row_ids,
                causal, device)
        self.gr, self.gc = gr, gc

    def pack(self, x, dim):
        """x with the global columns (along ``dim``) appended after the
        real sequence, dead zeros before them up to a tile edge and after
        them up to a whole tile."""
        def zeros(n):
            shape = list(x.shape)
            shape[dim] = n
            return x.new_zeros(shape)
        parts = [x]
        if self.gap_tokens:
            parts.append(zeros(self.gap_tokens))
        parts.append(x.index_select(dim, self.col_ids))
        if self.pad_tokens:
            parts.append(zeros(self.pad_tokens))
        return torch.cat(parts, dim=dim)


_plan_cache = {}


def _get_plan(lay, block, causal, sm_scale, device):
    key = (_layout_key(lay), block, causal, sm_scale, str(_device(device)))
    if key not in _plan_cache:
        _plan_cache[key] = _Plan(lay, block, causal, sm_scale, device)
    return _plan_cache[key]


def parse_sparse_mode(mode):
    """'sparse' or 'sparse:<window_tokens>/<block>' -> (window, block);
    the defaults are the JAX package's (1024/128)."""
    bad = ValueError(
        f"sparse attention mode {mode!r}: expected 'sparse' or "
        "'sparse:<window_tokens>/<block>' (e.g. 'sparse:1024/128')")
    if mode == "sparse":
        return 1024, 128
    if not mode.startswith("sparse:"):
        raise bad
    parts = mode.split(":", 1)[1].split("/")
    if len(parts) != 2:
        raise bad
    try:
        win, blk = int(parts[0]), int(parts[1])
    except ValueError:
        raise bad from None
    if blk <= 0 or win <= 0 or win % blk:
        raise ValueError(
            f"sparse attention mode {mode!r}: window {win} must be a "
            f"positive multiple of block {blk}")
    return win, blk


def sparse_mode_layout(mode, num_heads, seq_len):
    """The causal layout a mode string means: unidirectional Fixed with
    ``window // block`` local blocks and 1 global. Returns (layout,
    block)."""
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import get_layout
    from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import \
        FixedSparsityConfig
    win, blk = parse_sparse_mode(mode)
    if seq_len % blk:
        raise ValueError(
            f"sparse attention mode {mode!r}: sequence length {seq_len} "
            f"must be a multiple of block {blk}")
    layout = get_layout(FixedSparsityConfig(
        num_heads=num_heads, block=blk, num_local_blocks=win // blk,
        num_global_blocks=1, attention="unidirectional"), seq_len)
    return layout, blk


def block_sparse_attention_fused(q, k, v, layout, key_padding_bias=None,
                                 block=None, causal=False, sm_scale=None):
    """Block-sparse attention over live tiles (band + global split).

    q, k, v [B, H, S, D]; layout [H, S // block, S // block] (numpy);
    optional [B, S] additive key-padding bias. Differentiable in q, k, v
    and the bias."""
    if isinstance(layout, torch.Tensor):
        layout = layout.cpu().numpy()
    B, H, S, D = q.shape
    lay = np.asarray(layout) != 0
    if block is None:
        block = S // lay.shape[-1]
    if sm_scale is None:
        sm_scale = D ** -0.5
    if lay.shape[1] * block != S:
        raise ValueError(f"layout {lay.shape} with block {block} does not "
                         f"cover the sequence {S}")
    plan = _get_plan(lay, block, causal, sm_scale, q.device)
    kpb = key_padding_bias
    if plan.col_ids is None and plan.row_ids is None:
        return plan.strat.attend(q, k, v, kpb)
    if plan.col_ids is not None:
        out = plan.strat.attend(q, plan.pack(k, 2), plan.pack(v, 2),
                                None if kpb is None else plan.pack(kpb, 1))
    else:
        out = plan.strat.attend(q, k, v, kpb)
    if plan.row_ids is None:
        return out

    def dense_rows(q, k, v, kpb):
        qg = q.index_select(2, plan.row_ids)
        return _masked_dense_part(qg, k, v, plan.row_mask, kpb,
                                  sm_scale)[0]

    # the dense part's [B, H, R, S] fp32 scores are not kept for the
    # backward across layers: recompute them there
    gout = checkpoint(dense_rows, q, k, v, kpb, use_reentrant=False)
    return out.index_copy(2, plan.row_ids, gout)
