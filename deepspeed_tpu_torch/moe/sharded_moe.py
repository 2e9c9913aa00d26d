"""GShard-style top-k gating and the MoE layer (counterpart of
``deepspeed_tpu/moe/sharded_moe.py``).

The gating math is the JAX package's tensor algebra (``top1gating``
:51, ``top2gating`` :122); the transport is the reference DeepSpeed's:
at an expert-parallel size above 1 the dispatched ``[E, C, M]`` tensor
goes to the ranks that hold the experts through ``comm.all_to_all``, and
the expert output comes back through it (where JAX puts its
``_expert_constraint``, :38-48, :426, :436).

**Global gating.** The JAX layer gates the global batch: under GSPMD the
sharded ``[B·S, E]`` array is one array, so the capacity C comes from the
global token count, a token's slot counts the earlier (or higher-priority)
tokens routed to its expert on every rank, and ``me``, ``ce`` (so
``l_aux``) and ``exp_counts`` are global. The port gates the same way
over the data-parallel group (the world, rank r holding global tokens
r·S .. (r + 1)·S - 1): each rank all-gathers the group's expert masks
(and RTS priorities), computes the global slots and keeps its own rows;
``me`` is summed over the ranks by an all-reduce whose backward sums the
cotangents, so the gate's gradient is the global one. Every rank must
hold as many tokens. With one rank (or no process group) nothing is
exchanged.

**Noise.** JAX draws the RTS priorities, the RSample normals and the
top-2 Gumbel noise from threefry keys the port cannot reproduce. So the
gate functions take the noise as tensors (``priority``, ``noise``,
``gumbel``), and :class:`TopKGate` draws it, in training mode with a key
in scope, from a generator keyed like dropout's masks by (seed,
micro-step, site) (``runtime/dropout.py``): for the global token count,
the same on every rank (each keeps its rows), so a run at any world size
or expert-parallel size draws the same noise, and a recompute under remat
draws it again. With no key (eval, inference) there is no noise, as in
JAX without a ``gating`` rng: the priority is token order and top-2's
second choice is the noise-free argmax (JAX's deliberate deviation,
:136-144).
"""

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.runtime import dropout as dropout_lib
from deepspeed_tpu_torch.utils import groups

# the gates' noise streams: a domain of sites apart from dropout's (the
# JAX engine feeds the gate fold_in(rng, 7), engine.py:1303-1307)
GATING_SITE_BASE = 7 << 32
DISPATCH_IMPLS = ("grouped", "scatter", "einsum")


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int) -> int:
    """Static per-expert capacity (JAX sharded_moe.py:27)."""
    cap = int(np.ceil(num_tokens / num_experts * capacity_factor))
    return max(cap, min_capacity)


class TokenGroup:
    """The ranks whose tokens one gating call routes together: ``world``
    ranks of ``group`` (None: the default group), this one ``rank``."""

    def __init__(self, world, rank, group=None):
        self.world, self.rank, self.group = int(world), int(rank), group


def data_token_group():
    """The data-parallel group as a :class:`TokenGroup`, or None when it
    has one rank (the JAX mesh's global batch is then the local one)."""
    world = groups.get_data_parallel_world_size()
    if world == 1:
        return None
    return TokenGroup(world, groups.get_data_parallel_rank(),
                      groups.get_data_parallel_group())


class _AllReduceSum(torch.autograd.Function):
    """SUM over the group; the backward sums the cotangents too: each
    rank's copy of the result feeds its own loss, and the gradient of the
    ranks' mean loss reaches every rank's input through all of them."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        x = x.clone()
        torch.distributed.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        torch.distributed.all_reduce(grad, group=ctx.group)
        return None, grad


def _token_sum(t, tg, differentiable=False):
    """``t.sum(0)`` over the global tokens."""
    s = t.sum(0)
    if tg is None:
        return s
    if differentiable:
        return _AllReduceSum.apply(tg.group, s)
    s = s.detach().clone()
    torch.distributed.all_reduce(s, group=tg.group)
    return s


def _gather_rows(t, tg):
    """The global rows of ``t`` (rank order), without gradient."""
    if tg is None:
        return t
    t = t.detach().contiguous()
    out = torch.empty((tg.world * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    torch.distributed.all_gather_into_tensor(out, t, group=tg.group)
    return out


def _local_rows(t, tg, n):
    if tg is None:
        return t
    return t[tg.rank * n:(tg.rank + 1) * n]


def _one_hot(idx, num):
    return F.one_hot(idx, num).to(torch.float32)


def _slot_one_hot(loc, capacity):
    """JAX ``one_hot(loc, C)``: a zero row where ``loc`` >= C."""
    loc = loc.long()
    return _one_hot(loc.clamp(max=capacity - 1), capacity) * \
        (loc < capacity).to(torch.float32)[:, None]


def top1gating(logits, capacity_factor=1.0, min_capacity=4,
               noisy_gate_policy=None, noise=None, drop_tokens=True,
               use_rts=True, used_token=None, sparse=False, priority=None,
               token_group=None):
    """Top-1 gating (JAX sharded_moe.py:51). ``logits`` [S, E] fp32 (this
    rank's S tokens). ``noise`` [S, E]: the RSample normals (used under
    ``noisy_gate_policy="RSample"``); ``priority`` [S]: the RTS
    priorities (used with ``use_rts``); without them token order decides.
    ``token_group``: route with the tokens of these ranks (global gating).

    Returns (l_aux, combine_weights [S, E, C], dispatch_mask [S, E, C]
    bool, exp_counts [E]); with ``sparse=True`` the factored routing
    (l_aux, [(expert_s, slot_s, gate_s, valid_s)], C, exp_counts).
    ``drop_tokens=False`` takes C = the global token count, JAX's static
    worst case (:66-69)."""
    tg = token_group
    S_local, E = logits.shape
    S = S_local * (1 if tg is None else tg.world)
    C = S if not drop_tokens else _capacity(S, E, capacity_factor,
                                            min_capacity)
    if noisy_gate_policy == "RSample" and noise is not None:
        logits_w_noise = logits + noise
    else:
        logits_w_noise = logits

    gates = torch.softmax(logits, dim=1)
    indices1_s = torch.argmax(logits_w_noise, dim=1)
    mask1 = _one_hot(indices1_s, E)
    if used_token is not None:
        mask1 = mask1 * used_token[:, None]

    exp_counts = _token_sum(mask1, tg)

    # load-balancing auxiliary loss (GShard eq. 4)
    me = _token_sum(gates, tg, differentiable=True) / S
    ce = exp_counts / S
    l_aux = torch.sum(me * ce) * E

    # each token's place in its expert's queue, highest priority first
    g_mask = _gather_rows(mask1, tg)
    if use_rts and priority is not None:
        order = torch.argsort(-_gather_rows(priority, tg), stable=True)
        loc_sorted = torch.cumsum(g_mask[order], dim=0) - 1.0
        loc = loc_sorted[torch.argsort(order)]
    else:
        loc = torch.cumsum(g_mask, dim=0) - 1.0      # earlier tokens win
    locations1 = torch.sum(_local_rows(loc, tg, S_local) * mask1, dim=1)

    if drop_tokens:
        mask1 = mask1 * (locations1 < C)[:, None]

    gates1_s = torch.sum(gates * mask1, dim=1)
    if sparse:
        valid = torch.sum(mask1, dim=1) > 0
        return l_aux, [(indices1_s, locations1.long(), gates1_s, valid)], \
            C, exp_counts
    combine = gates1_s[:, None, None] * mask1[:, :, None] * \
        _slot_one_hot(locations1, C)[:, None, :]
    return l_aux, combine, combine != 0, exp_counts


def top2gating(logits, capacity_factor=1.0, min_capacity=4, gumbel=None,
               sparse=False, token_group=None):
    """Top-2 gating (JAX sharded_moe.py:122): the second expert is the
    argmax of the logits plus ``gumbel`` [S, E] noise with the first
    masked out (the noise-free argmax without ``gumbel``); the pair's
    gates renormalised. Returns as :func:`top1gating`, with two routing
    entries when ``sparse``."""
    tg = token_group
    S_local, E = logits.shape
    S = S_local * (1 if tg is None else tg.world)
    C = _capacity(S, E, capacity_factor * 2, min_capacity)

    gates = torch.softmax(logits, dim=1)
    indices1_s = torch.argmax(gates, dim=1)
    mask1 = _one_hot(indices1_s, E)
    logits_w_noise = logits if gumbel is None else logits + gumbel
    logits_except1 = torch.where(mask1.bool(), float("-inf"), logits_w_noise)
    indices2_s = torch.argmax(logits_except1, dim=1)
    mask2 = _one_hot(indices2_s, E)

    g_mask1, g_mask2 = _gather_rows(mask1, tg), _gather_rows(mask2, tg)
    locations1 = _local_rows(torch.cumsum(g_mask1, dim=0) - 1.0, tg,
                             S_local)
    locations2 = _local_rows(torch.cumsum(g_mask2, dim=0) - 1.0
                             + torch.sum(g_mask1, dim=0, keepdim=True), tg,
                             S_local)

    exp_counts = _token_sum(mask1 + mask2, tg)
    me = _token_sum(gates, tg, differentiable=True) / S
    ce = _token_sum(mask1, tg) / S
    l_aux = torch.sum(me * ce) * E

    loc1_s = torch.sum(locations1 * mask1, dim=1)
    loc2_s = torch.sum(locations2 * mask2, dim=1)
    mask1 = mask1 * (loc1_s < C)[:, None]
    mask2 = mask2 * (loc2_s < C)[:, None]

    gates1_s = torch.sum(gates * mask1, dim=1)
    gates2_s = torch.sum(gates * mask2, dim=1)
    denom = gates1_s + gates2_s
    denom = torch.where(denom < 1e-9, 1.0, denom)
    gates1_s = gates1_s / denom
    gates2_s = gates2_s / denom

    if sparse:
        routing = [(indices1_s, loc1_s.long(), gates1_s,
                    torch.sum(mask1, dim=1) > 0),
                   (indices2_s, loc2_s.long(), gates2_s,
                    torch.sum(mask2, dim=1) > 0)]
        return l_aux, routing, C, exp_counts
    combine = (gates1_s[:, None, None] * mask1[:, :, None]
               * _slot_one_hot(loc1_s, C)[:, None, :]
               + gates2_s[:, None, None] * mask2[:, :, None]
               * _slot_one_hot(loc2_s, C)[:, None, :])
    return l_aux, combine, combine != 0, exp_counts


def lecun_normal_(t, fan_in, generator):
    """flax ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class TopKGate(nn.Module):
    """The gate (JAX ``TopKGate`` :271): a linear ``wg`` [M, E] run in fp32
    whatever the compute dtype (:283-290), then top-k gating. In training
    mode with a key in scope it draws its noise (the module docstring);
    ``site`` is numbered by ``runtime.dropout.number_sites``."""

    numbered_gate = True     # runtime.dropout.number_sites numbers it

    def __init__(self, model_dim, num_experts, k=1, capacity_factor=1.0,
                 eval_capacity_factor=1.0, min_capacity=4,
                 noisy_gate_policy=None, drop_tokens=True, use_rts=True,
                 device=None):
        super().__init__()
        if k not in (1, 2):
            raise ValueError(f"only top-1 and top-2 gating are supported, "
                             f"got k={k}")
        if noisy_gate_policy not in (None, "RSample"):
            raise ValueError(f"noisy_gate_policy must be None or 'RSample', "
                             f"got {noisy_gate_policy!r}")
        self.num_experts, self.k = int(num_experts), int(k)
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens, self.use_rts = drop_tokens, use_rts
        self.wg = nn.Parameter(torch.empty(model_dim, num_experts,
                                           device=device))
        self.site = None

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        lecun_normal_(self.wg, self.wg.shape[0], generator)

    def _noise(self, S_local, device, tg):
        """The training noise of this call, this rank's rows: (priority
        [S] or None, RSample normals [S, E] or None, Gumbel [S, E] or
        None), drawn for the global tokens."""
        key = dropout_lib.current_key()
        if not (self.training and key is not None
                and (self.use_rts or self.noisy_gate_policy)):
            return None, None, None
        if self.site is None:
            raise RuntimeError(
                "gate site not numbered: run the model through the engine, "
                "or call runtime.dropout.number_sites(model) before a "
                "key_scope")
        world, rank = (1, 0) if tg is None else (tg.world, tg.rank)
        S, E = S_local * world, self.num_experts
        gen = dropout_lib._generator(device)
        gen.manual_seed(dropout_lib.mask_seed(
            key[0], key[1], GATING_SITE_BASE + self.site))
        rows = slice(rank * S_local, (rank + 1) * S_local)
        if self.k == 2:
            u = torch.rand((S, E), generator=gen, device=device)
            tiny = torch.finfo(torch.float32).tiny
            return None, None, -torch.log(-torch.log(u.clamp(min=tiny)))[rows]
        priority = noise = None
        if self.use_rts:
            priority = torch.rand((S,), generator=gen, device=device)[rows]
        if self.noisy_gate_policy == "RSample":
            noise = torch.randn((S, E), generator=gen, device=device)[rows]
        return priority, noise, None

    def forward(self, x, used_token=None, sparse=False, token_group=None):
        logits = x.float() @ self.wg.float()
        priority, noise, gumbel = self._noise(x.shape[0], x.device,
                                              token_group)
        cf = self.capacity_factor if self.training else \
            self.eval_capacity_factor
        if self.k == 1:
            return top1gating(
                logits, cf, self.min_capacity,
                self.noisy_gate_policy if self.training else None, noise,
                self.drop_tokens, self.use_rts, used_token=used_token,
                sparse=sparse, priority=priority, token_group=token_group)
        return top2gating(logits, cf, self.min_capacity, gumbel,
                          sparse=sparse, token_group=token_group)


class MOELayer(nn.Module):
    """Dispatch -> experts -> combine (JAX ``MOELayer`` :301).

    ``expert`` is a stacked-expert module class: ``expert(num_experts,
    **expert_kwargs, device=)`` holds ``num_experts`` experts as ``[E,
    ...]`` parameters (flax's ``nn.vmap`` layout) and maps ``[E, C, M]``
    to ``[E, C, M]``; the default is ``layer.MLPExpert``. At an
    expert-parallel size ``ep`` the layer holds E / ep of them, experts
    ``e · E/ep ..`` of this rank's expert-parallel index e.

    ``dispatch_impl``: ``"scatter"`` routes tokens by index into an
    ``[E·C + 1, M]`` buffer whose last row swallows the dropped tokens
    (:411-416) and gathers the outputs back (:438-445); ``"einsum"`` runs
    the GShard ``"sec,sm->ecm"`` / ``"sec,ecm->sm"`` products over the
    dense masks; ``"grouped"`` sorts the tokens by expert and runs each
    expert's GEMMs over its contiguous rows, then scatter-adds the gated
    outputs (:342-378): no capacity padding, but the segment sizes are read
    on the host, one sync a layer. It takes only ``MLPExpert``
    (:370-376), and only at ep 1 (the port has no exchange for it; JAX
    gathers the expert weights there)."""

    def __init__(self, model_dim, num_experts, k=1, capacity_factor=1.0,
                 eval_capacity_factor=1.0, min_capacity=4,
                 noisy_gate_policy=None, drop_tokens=True, use_rts=True,
                 dispatch_impl="scatter", expert=None, expert_kwargs=None,
                 ep_size=None, device=None, dtype=torch.float32):
        super().__init__()
        from deepspeed_tpu_torch.moe.layer import MLPExpert
        if dispatch_impl not in DISPATCH_IMPLS:
            raise ValueError(f"dispatch_impl must be 'grouped', 'scatter' or "
                             f"'einsum', got {dispatch_impl!r}")
        group_ep = groups.get_expert_parallel_world_size()
        ep = group_ep if ep_size is None else int(ep_size)
        if ep != group_ep:
            raise ValueError(
                f"MoE ep_size={ep}, but the expert-parallel group has "
                f"{group_ep} ranks (utils.groups.initialize(ep_size=...))")
        if num_experts % ep:
            raise ValueError(f"num_experts {num_experts} is not divisible "
                             f"by the expert-parallel size {ep}")
        expert = MLPExpert if expert is None else expert
        if dispatch_impl == "grouped":
            if expert is not MLPExpert:
                raise NotImplementedError(
                    "dispatch_impl='grouped' implements the standard "
                    "MLPExpert (fc1-gelu-fc2) as grouped matmuls; expert "
                    f"{expert.__name__} needs dispatch_impl='scatter'")
            if ep > 1:
                raise NotImplementedError(
                    "dispatch_impl='grouped' at expert-parallel size > 1 is "
                    "not ported (it has no [E, C, M] tensor to exchange); "
                    "use 'scatter'")
        self.num_experts, self.ep_size = int(num_experts), ep
        self.num_local_experts = self.num_experts // ep
        self.expert_offset = groups.get_expert_parallel_rank() * \
            self.num_local_experts
        self.dispatch_impl = dispatch_impl
        self.gate = TopKGate(model_dim, num_experts, k, capacity_factor,
                             eval_capacity_factor, min_capacity,
                             noisy_gate_policy, drop_tokens, use_rts,
                             device=device)
        self.deepspeed_experts = expert(self.num_local_experts,
                                        **(expert_kwargs or {}),
                                        device=device, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The gate, then every expert of the layer drawn in order, this
        rank keeping its own: the weights are the same at any ep."""
        self.gate.reset_parameters(generator)
        self.deepspeed_experts.reset_parameters(
            generator, self.num_experts, self.expert_offset)

    def _to_experts(self, dispatched):
        """[E, C, M] (this rank's tokens for every expert) -> [E/ep, ep·C,
        M] (every group rank's tokens for this rank's experts)."""
        if self.ep_size == 1:
            return dispatched
        E, C, M = dispatched.shape
        out = comm.all_to_all(dispatched,
                              groups.get_expert_parallel_group())
        return out.view(self.ep_size, self.num_local_experts, C, M) \
            .transpose(0, 1).reshape(self.num_local_experts,
                                     self.ep_size * C, M)

    def _from_experts(self, out):
        """The inverse of :meth:`_to_experts`."""
        if self.ep_size == 1:
            return out
        El, _, M = out.shape
        out = out.view(El, self.ep_size, -1, M).transpose(0, 1) \
            .reshape(self.num_experts, -1, M)
        return comm.all_to_all(out, groups.get_expert_parallel_group())

    def forward(self, x, used_token=None):
        """(output shaped like ``x``, l_aux, exp_counts)."""
        orig_shape = x.shape
        M = orig_shape[-1]
        xf = x.reshape(-1, M)
        if used_token is not None:
            used_token = used_token.reshape(-1)
        tg = data_token_group()
        E = self.num_experts
        if self.dispatch_impl == "grouped":
            l_aux, routing, C, exp_counts = self.gate(
                xf, used_token, sparse=True, token_group=tg)
            S = xf.shape[0]
            eid = torch.cat([r[0] for r in routing])
            gate_w = torch.cat([r[2] * r[3] for r in routing])
            tok = torch.arange(S, device=xf.device).repeat(len(routing))
            order = torch.argsort(eid, stable=True)
            sorted_tok = tok[order]
            # the segment sizes on the host: one sync a layer
            sizes = torch.bincount(eid, minlength=E).tolist()
            expert_out = self.deepspeed_experts.grouped(xf[sorted_tok],
                                                        sizes)
            combined = torch.zeros((S, M), dtype=expert_out.dtype,
                                   device=xf.device).index_add(
                0, sorted_tok,
                gate_w[order][:, None].to(expert_out.dtype) * expert_out)
            return combined.reshape(orig_shape), l_aux, exp_counts

        if self.dispatch_impl == "scatter":
            l_aux, routing, C, exp_counts = self.gate(
                xf, used_token, sparse=True, token_group=tg)
            # one extra trash row swallows the dropped tokens
            buf = xf.new_zeros((E * C + 1, M))
            for e_s, loc_s, _, valid in routing:
                slot = torch.where(valid, e_s * C + loc_s, E * C)
                buf = buf.index_add(0, slot, xf)
            dispatched = buf[:E * C].reshape(E, C, M)
        else:
            l_aux, combine, dispatch, exp_counts = self.gate(
                xf, used_token, token_group=tg)
            dispatched = torch.einsum("sec,sm->ecm",
                                      dispatch.to(xf.dtype), xf)
        expert_out = self._from_experts(
            self.deepspeed_experts(self._to_experts(dispatched)))

        if self.dispatch_impl == "scatter":
            flat = expert_out.reshape(E * C, M)
            combined = torch.zeros((xf.shape[0], M), dtype=expert_out.dtype,
                                   device=xf.device)
            for e_s, loc_s, gate_s, valid in routing:
                slot = torch.where(valid, e_s * C + loc_s, 0)
                combined = combined + (gate_s * valid)[:, None].to(
                    expert_out.dtype) * flat[slot]
        else:
            combined = torch.einsum("sec,ecm->sm",
                                    combine.to(expert_out.dtype), expert_out)
        return combined.reshape(orig_shape), l_aux, exp_counts
