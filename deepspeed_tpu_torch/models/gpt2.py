"""GPT-2 family in PyTorch (counterpart of ``deepspeed_tpu/models/gpt2.py``).

Training and prefill run causal attention through :func:`attention` (the
flash kernels on CUDA tensors, differentiable through the backward
kernels; the plain dense version on the CPU) or, with
``attention_mode="sparse"`` / ``"sparse:<window_tokens>/<block>"``,
through causal block-sparse attention (a unidirectional Fixed layout on
the sparse kernels; training only, as in JAX); every later token runs
:func:`decode_attention` (the decode kernel on CUDA tensors) over the KV
cache. The flax ``"cache"`` collection becomes an explicit
:class:`KVCache` passed to ``forward``; its ``pos`` is the JAX model's
``pos_index``/``cache_index``.

Batch convention: a dict with ``input_ids`` [B, S] (and optionally
``labels``), a tuple ``(input_ids, labels)``, or the ids tensor itself.
``forward`` returns the mean next-token cross-entropy unless logits are
asked for.

``dropout`` > 0 masks the embeddings, each attention projection's output
and each MLP output (the JAX sites, gpt2.py:219-220, 237-238, 399-400)
with :class:`~deepspeed_tpu_torch.runtime.dropout.Dropout`, active in
training mode under the engine's (seed, micro-step) key. ``remat``
recomputes each block in the backward (gpt2.py:424-426) through
``runtime.activation_checkpointing.checkpointing.remat``.

MoE-GPT (``moe_num_experts`` > 0, JAX gpt2.py:60-70): every
``moe_expert_interval``-th block, counting from the first, is a
:class:`MoEBlock` whose MLP is a ``moe.layer.MoE`` (JAX :428-436); the
loss is ``ce + moe_aux_loss_coef · Σ l_aux`` (:402, :460), and remat
recomputes MoE blocks too (:423-426). In decode a step routes its B
tokens with ``moe_eval_capacity_factor`` and ``min_capacity`` 4, so a
step can drop tokens, as in JAX.

:func:`gpt2_offload_layers` is the layered decomposition (embedding,
blocks, an untied loss head) that ZeRO-3 parameter offload streams one
layer at a time (``runtime/zero/param_offload.py``).

``position_embedding="rope"`` (JAX gpt2.py:121-125, 177-186) drops the
``wpe`` table and rotates q and k (``ops.transformer.rotary``, all of the
head dim) before attention; a cached decode step rotates at its position
``cache.pos``.

``attention_mode="ring:<axis>"`` / ``"ulysses:<axis>"`` (JAX
gpt2.py:196-203) shards the sequence over the ranks of a mesh axis
(``utils.groups.axis_group``). JAX's ``shard_map`` with
``P(None, None, axis, None)`` hands each device every row of the batch
and its own S/n chunk of the sequence; the port makes that layout
itself: each rank's ``[b, H, S, D]`` q, k, v go through one all-to-all
over the axis's group (rows to sequence chunks: ``[b·n, H, S/n, D]``,
rank r the r-th chunk), ``ring_attention`` / ``ulysses_attention`` run
on the chunk, and the inverse all-to-all brings the rank its rows back.
Rope is applied before, on whole rows, as in JAX; S must divide by n.
The loader, the loss and the gradient average are unchanged. Not ported
yet: pipeline stages (MoE with them raises, as JAX asserts, :403-406).
"""

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from deepspeed_tpu_torch.comm import all_to_all
from deepspeed_tpu_torch.models.common import masked_next_token_ce
from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.ops._platform import resolve_device
from deepspeed_tpu_torch.ops.quantizer.int8_linear import QuantDense
from deepspeed_tpu_torch.ops.sparse_attention.fused_kernels import (
    block_sparse_attention_fused, parse_sparse_mode, sparse_mode_layout)
from deepspeed_tpu_torch.ops.transformer.attention import attention
from deepspeed_tpu_torch.ops.transformer.decode import (
    aligned_cache_len, decode_attention, decode_attention_quantized,
    quantize_kv)
from deepspeed_tpu_torch.ops.transformer.ring import (ring_attention,
                                                      ulysses_attention)
from deepspeed_tpu_torch.ops.transformer.rotary import apply_rotary_pos_emb
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing \
    import remat
from deepspeed_tpu_torch.runtime.dropout import Dropout
from deepspeed_tpu_torch.utils import groups


def _pad_vocab(v: int, multiple: int = 128) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    remat: bool = False
    pp_stages: int = 1
    attention_mode: str = "auto"
    # MoE-GPT: >0 turns every moe_expert_interval-th block's MLP into a
    # MoE layer (experts on alternate layers at interval 2)
    moe_num_experts: int = 0
    moe_expert_interval: int = 2
    moe_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_eval_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01
    moe_dispatch_impl: str = "scatter"  # 'grouped' | 'scatter' | 'einsum'
    # "auto" keeps K/V in the activation dtype; "int8" stores the decode
    # cache quantized with one fp32 absmax scale per cached row
    kv_cache_dtype: str = "auto"
    position_embedding: str = "learned"

    @property
    def padded_vocab(self) -> int:
        return _pad_vocab(self.vocab_size)

    def num_params(self) -> int:
        wpe = 0 if self.position_embedding == "rope" \
            else self.n_positions * self.n_embd
        wte = self.padded_vocab * self.n_embd
        per_layer = 12 * self.n_embd ** 2 + 13 * self.n_embd
        return wte + wpe + self.n_layer * per_layer + 2 * self.n_embd


PRESETS = {
    "tiny": GPT2Config(vocab_size=512, n_positions=128, n_embd=64,
                       n_layer=2, n_head=4),
    "gpt2": GPT2Config(n_embd=768, n_layer=12, n_head=12),            # 125M
    "gpt2-medium": GPT2Config(n_embd=1024, n_layer=24, n_head=16),    # 350M
    "gpt2-large": GPT2Config(n_embd=1280, n_layer=36, n_head=20),     # 774M
    "gpt2-xl": GPT2Config(n_embd=1600, n_layer=48, n_head=25),        # 1.5B
}


SEQUENCE_MODES = ("ring:", "ulysses:")


def _check_ported(cfg: GPT2Config):
    if cfg.pp_stages > 1:
        what = "pp_stages > 1"
        if cfg.moe_num_experts > 0:
            what += (" with MoE (MoE blocks are not expressible in the "
                     "uniform GPipe stack; JAX refuses it too)")
        raise NotImplementedError(f"GPT-2 {what} is not ported yet")
    if cfg.position_embedding not in ("learned", "rope"):
        raise ValueError(f"position_embedding must be 'learned' or 'rope', "
                         f"got {cfg.position_embedding!r}")
    if cfg.attention_mode.startswith("sparse"):
        parse_sparse_mode(cfg.attention_mode)
    if cfg.attention_mode.startswith(SEQUENCE_MODES):
        # an axis the mesh lacks fails here, where JAX's shard_map fails
        # at its first trace
        groups.check_axis(cfg.attention_mode.split(":", 1)[1])
    if cfg.kv_cache_dtype not in ("auto", "int8"):
        raise ValueError(f"kv_cache_dtype must be 'auto' or 'int8', got "
                         f"{cfg.kv_cache_dtype!r}")


def _sequence_parallel(q, k, v, mode):
    """Causal attention of q, k, v ``[b, H, S, D]`` (this rank's rows)
    with the sequence split over the ranks of the mode's axis, as JAX's
    ``shard_map`` splits it: an all-to-all from rows to sequence chunks
    (q, k and v in one exchange), ring or Ulysses attention on
    ``[b·n, H, S/n, D]``, and the inverse all-to-all. A group of one rank
    attends over its rows directly."""
    kind, axis = mode.split(":", 1)
    group, n = groups.axis_group(axis)
    if group is None:
        return attention(q, k, v, causal=True)
    b, H, S, D = q.shape
    if S % n:
        raise ValueError(f"attention_mode={mode!r}: the sequence ({S}) "
                         f"must divide by the {axis!r} group's {n} ranks")
    c = S // n
    x = torch.stack([q, k, v]).reshape(3, b, H, n, c, D)
    # chunk j of the sequence to rank j; from rank j its rows of ours
    x = all_to_all(x.permute(3, 0, 1, 2, 4, 5), group)
    q, k, v = x.transpose(0, 1).reshape(3, n * b, H, c, D).unbind(0)
    fn = ring_attention if kind == "ring" else ulysses_attention
    out = fn(q, k, v, group=group, causal=True)
    # rank j's rows back to rank j; from rank j our rows' chunk j
    out = all_to_all(out.reshape(n, b, H, c, D), group)
    return out.permute(1, 2, 0, 3, 4).reshape(b, H, S, D)


class KVCache:
    """The decode cache of one generation: per layer, K and V as
    [B, H, T, D] (T = aligned_cache_len(n_positions)), in the activation
    dtype or as int8 with fp32 [B, H, T] scales. ``pos`` counts the tokens
    written; ``lens`` is the live length (a device int32 scalar) that the
    current call's decode steps attend up to. Allocated once per
    generation."""

    def __init__(self, config: GPT2Config, batch_size: int, dtype,
                 device):
        H = config.n_head
        D = config.n_embd // H
        T = aligned_cache_len(config.n_positions)
        self.int8 = config.kv_cache_dtype == "int8"
        shape = (batch_size, H, T, D)
        cdt = torch.int8 if self.int8 else dtype
        L = config.n_layer
        self.k = [torch.zeros(shape, dtype=cdt, device=device)
                  for _ in range(L)]
        self.v = [torch.zeros(shape, dtype=cdt, device=device)
                  for _ in range(L)]
        if self.int8:
            self.k_scale = [torch.zeros(shape[:3], device=device)
                            for _ in range(L)]
            self.v_scale = [torch.zeros(shape[:3], device=device)
                            for _ in range(L)]
        self.pos = 0
        self.lens = None

    def write(self, layer: int, pos: int, k_new, v_new):
        """Store [B, H, S, D] new K/V at positions pos .. pos+S-1."""
        end = pos + k_new.shape[2]
        if self.int8:
            kq, ks = quantize_kv(k_new)
            vq, vs = quantize_kv(v_new)
            self.k[layer][:, :, pos:end] = kq
            self.v[layer][:, :, pos:end] = vq
            self.k_scale[layer][:, :, pos:end] = ks
            self.v_scale[layer][:, :, pos:end] = vs
        else:
            self.k[layer][:, :, pos:end] = k_new
            self.v[layer][:, :, pos:end] = v_new


class CausalSelfAttention(nn.Module):
    def __init__(self, config: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        E = config.n_embd
        self.config = config
        self.qkv = QuantDense(E, 3 * E, device=device, dtype=dtype)
        self.proj = QuantDense(E, E, device=device, dtype=dtype)
        self.drop = Dropout(config.dropout)

    def forward(self, x, cache: KVCache = None, layer: int = 0):
        cfg = self.config
        B, S, E = x.shape
        H = cfg.n_head
        D = E // H
        # fused projection: [q | k | v] along the last dim, each (B, S, H, D)
        qkv = self.qkv(x).view(B, S, 3, H, D)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        if cfg.position_embedding == "rope":
            # decode steps continue the rotation at their position
            q, k = apply_rotary_pos_emb(
                q, k, offset=0 if cache is None else cache.pos)
        sparse = cfg.attention_mode.startswith("sparse")
        if sparse and cache is not None:
            raise ValueError(
                "KV-cache decode would silently run DENSE attention on a "
                "sparse-trained model; decode with attention_mode='auto'")
        sequence = cfg.attention_mode.startswith(SEQUENCE_MODES)
        if sequence and cache is not None:
            raise ValueError("KV-cache decode is incompatible with sequence "
                             "parallelism")
        if sequence:
            out = _sequence_parallel(q, k, v, cfg.attention_mode)
        elif sparse:
            layout, blk = sparse_mode_layout(cfg.attention_mode, H, S)
            out = block_sparse_attention_fused(q, k, v, layout, block=blk,
                                               causal=True)
        elif cache is None:
            out = attention(q, k, v, causal=True)
        elif cache.pos == 0:
            # prefill: write the prompt's K/V, attend over the fresh K/V
            cache.write(layer, 0, k, v)
            out = attention(q, k, v, causal=True)
        else:
            if S != 1:
                raise ValueError(f"decode steps take one token, got {S}")
            cache.write(layer, cache.pos, k, v)
            if cache.int8:
                out = decode_attention_quantized(
                    q, cache.k[layer], cache.k_scale[layer], cache.v[layer],
                    cache.v_scale[layer], cache.lens)
            else:
                out = decode_attention(q, cache.k[layer], cache.v[layer],
                                       cache.lens)
        out = out.transpose(1, 2).reshape(B, S, E)
        return self.drop(self.proj(out))


class MLP(nn.Module):
    def __init__(self, config: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        E = config.n_embd
        self.fc = QuantDense(E, 4 * E, device=device, dtype=dtype)
        self.proj = QuantDense(4 * E, E, device=device, dtype=dtype)
        self.drop = Dropout(config.dropout)

    def forward(self, x):
        return self.drop(self.proj(F.gelu(self.fc(x), approximate="tanh")))


class Block(nn.Module):
    def __init__(self, config: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        E = config.n_embd
        self.ln_1 = nn.LayerNorm(E, eps=1e-5, device=device, dtype=dtype)
        self.attn = CausalSelfAttention(config, device, dtype)
        self.ln_2 = nn.LayerNorm(E, eps=1e-5, device=device, dtype=dtype)
        self.mlp = MLP(config, device, dtype)

    def forward(self, x, cache: KVCache = None, layer: int = 0):
        x = x + self.attn(self.ln_1(x), cache, layer)
        return x + self.mlp(self.ln_2(x))


class MoEBlock(nn.Module):
    """A block whose MLP is a mixture of experts (JAX ``MoEBlock``);
    ``forward`` returns (x, l_aux)."""

    def __init__(self, config: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        E = config.n_embd
        self.ln_1 = nn.LayerNorm(E, eps=1e-5, device=device, dtype=dtype)
        self.attn = CausalSelfAttention(config, device, dtype)
        self.ln_2 = nn.LayerNorm(E, eps=1e-5, device=device, dtype=dtype)
        self.moe = MoE(E, num_experts=config.moe_num_experts,
                       k=config.moe_k,
                       capacity_factor=config.moe_capacity_factor,
                       eval_capacity_factor=config.moe_eval_capacity_factor,
                       dispatch_impl=config.moe_dispatch_impl,
                       device=device, dtype=dtype)

    def forward(self, x, cache: KVCache = None, layer: int = 0):
        x = x + self.attn(self.ln_1(x), cache, layer)
        h = self.ln_2(x)
        B, S, E = h.shape
        out, l_aux, _ = self.moe(h.reshape(B * S, E))
        return x + out.reshape(B, S, E), l_aux


@torch.no_grad()
def _init_block(blk, n_layer, generator):
    """The flax init of one block, drawn from ``generator``: normal(0.02),
    the residual projections normal(0.02/sqrt(2·n_layer)), zero biases,
    unit LayerNorm scales (a MoE block's experts by ``MoE``'s own)."""
    proj_std = 0.02 / np.sqrt(2 * n_layer)
    moe = isinstance(blk, MoEBlock)
    dense = ((blk.attn.qkv, 0.02), (blk.attn.proj, proj_std))
    if not moe:
        dense += ((blk.mlp.fc, 0.02), (blk.mlp.proj, proj_std))
    for layer, std in dense:
        nn.init.normal_(layer.weight, 0.0, std, generator=generator)
        nn.init.zeros_(layer.bias)
    if moe:
        blk.moe.reset_parameters(generator)
    for ln in (blk.ln_1, blk.ln_2):
        nn.init.ones_(ln.weight)
        nn.init.zeros_(ln.bias)


def is_moe_layer(config: GPT2Config, i: int) -> bool:
    """Block ``i`` is a MoE block: every interval-th, counting from the
    first, so interval 1 means every block (JAX gpt2.py:428-436)."""
    return config.moe_num_experts > 0 and \
        (i + 1) % config.moe_expert_interval == 0


def _unpack(batch):
    if isinstance(batch, (tuple, list)):
        return batch[0], (batch[1] if len(batch) > 1 else None)
    if isinstance(batch, dict):
        return batch["input_ids"], batch.get("labels")
    return batch, None


def next_token_count(batch):
    """The next-token terms a causal LM's loss of ``batch`` averages: the
    shifted labels (or ids) that are not ignored (≥ 0)."""
    input_ids, labels = _unpack(batch)
    return ((input_ids if labels is None else labels)[:, 1:] >= 0).sum()


class GPT2LMHeadModel(nn.Module):
    """GPT-2 causal LM with a tied LM head; ``forward`` returns the mean
    next-token cross-entropy, or fp32 logits over the padded vocab.

    ``device=None`` means CUDA (raises without a card), ``"meta"`` shapes
    without storage; weights are drawn from ``seed`` as the flax init draws them: normal(0.02), residual
    projections normal(0.02/sqrt(2·n_layer)), wpe normal(0.01), zero
    biases, unit LayerNorm scales."""

    def __init__(self, config: GPT2Config, *, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        _check_ported(config)
        dev = resolve_device(device)
        self.config = config
        E = config.n_embd
        self.wte = nn.Parameter(torch.empty(
            (config.padded_vocab, E), device=dev, dtype=dtype))
        # rope rotates q and k instead: no position table
        self.wpe = None if config.position_embedding == "rope" else \
            nn.Parameter(torch.empty((config.n_positions, E), device=dev,
                                     dtype=dtype))
        self.h = nn.ModuleList(
            (MoEBlock if is_moe_layer(config, i) else Block)(config, dev,
                                                             dtype)
            for i in range(config.n_layer))
        self.ln_f = nn.LayerNorm(E, eps=1e-5, device=dev, dtype=dtype)
        self.drop = Dropout(config.dropout)
        if dev.type != "meta":       # a meta model holds shapes only
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        gen = torch.Generator(device=self.wte.device).manual_seed(seed)
        nn.init.normal_(self.wte, 0.0, 0.02, generator=gen)
        if self.wpe is not None:
            nn.init.normal_(self.wpe, 0.0, 0.01, generator=gen)
        for blk in self.h:
            _init_block(blk, self.config.n_layer, gen)
        nn.init.ones_(self.ln_f.weight)
        nn.init.zeros_(self.ln_f.bias)

    def new_cache(self, batch_size: int) -> KVCache:
        """An empty decode cache for ``batch_size`` sequences."""
        return KVCache(self.config, batch_size, self.wte.dtype,
                       self.wte.device)

    def forward(self, batch, *, return_logits: bool = False,
                cache: KVCache = None, last_only: bool = False):
        """Loss, or fp32 logits [B, S, padded_vocab] with ``return_logits``
        (always in decode mode, i.e. with a ``cache``). ``last_only``
        keeps only the last position's logits."""
        cfg = self.config
        input_ids, labels = _unpack(batch)
        B, S = input_ids.shape
        pos = 0 if cache is None else cache.pos
        # the bound of the wpe table and of the cache (rope training has
        # neither, as in JAX)
        if pos + S > cfg.n_positions and (self.wpe is not None
                                          or cache is not None):
            raise ValueError(f"positions {pos}..{pos + S - 1} exceed "
                             f"n_positions ({cfg.n_positions})")
        x = F.embedding(input_ids, self.wte)
        if self.wpe is not None:
            x = x + self.wpe[pos:pos + S]
        x = self.drop(x)
        if cache is not None:
            return_logits = True
            cache.lens = torch.full((), pos + S, dtype=torch.int32,
                                    device=x.device)
        # remat: each block's activations are recomputed in the backward
        recompute = cfg.remat and cache is None and torch.is_grad_enabled()
        moe_aux = None
        for i, blk in enumerate(self.h):
            x = remat(blk, x) if recompute else blk(x, cache, i)
            if isinstance(blk, MoEBlock):
                x, l_aux = x
                moe_aux = l_aux if moe_aux is None else moe_aux + l_aux
        if cache is not None:
            cache.pos = pos + S
        x = self.ln_f(x)

        # tied LM head; fp32 logits for a stable softmax
        if return_logits:
            if last_only:
                x = x[:, -1:]
            return F.linear(x.float(), self.wte.float())
        shift_labels = (input_ids if labels is None else labels)[:, 1:]
        shift_logits = F.linear(x[:, :-1].float(), self.wte.float())
        ce = masked_next_token_ce(shift_logits, shift_labels)
        if moe_aux is None:
            return ce
        return ce + cfg.moe_aux_loss_coef * moe_aux

    def loss_count(self, batch):
        """The number of next-token terms the loss of ``batch`` averages
        (labels ≥ 0); the engine weights a rank's loss by it."""
        return next_token_count(batch)


class _PipeBlock(nn.Module):
    """A :class:`Block` under the name ``block``, mapping ``x -> x``: a
    body layer of :func:`gpt2_offload_layers` (JAX ``_PipeBlock``,
    gpt2.py:280-289, deterministic: the layered engine passes no dropout
    key)."""

    def __init__(self, config: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.block = Block(config, device, dtype)

    def forward(self, x):
        return self.block(x)

    def reset_parameters(self, generator=None):
        """:class:`GPT2LMHeadModel`'s init of one block."""
        _init_block(self.block, self.config.n_layer, generator)


class _OffloadEmbed(nn.Module):
    """The first layer of the layered decomposition: ids -> hidden (JAX
    ``_OffloadEmbed``, gpt2.py:292-307)."""

    def __init__(self, config: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        E = config.n_embd
        self.wte = nn.Parameter(torch.empty(
            (config.padded_vocab, E), device=device, dtype=dtype))
        self.wpe = None if config.position_embedding == "rope" else \
            nn.Parameter(torch.empty((config.n_positions, E), device=device,
                                     dtype=dtype))

    def forward(self, input_ids):
        S = input_ids.shape[1]
        x = F.embedding(input_ids, self.wte)
        return x if self.wpe is None else x + self.wpe[:S]

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        nn.init.normal_(self.wte, 0.0, 0.02, generator=generator)
        if self.wpe is not None:
            nn.init.normal_(self.wpe, 0.0, 0.01, generator=generator)


class _OffloadHead(nn.Module):
    """The loss head of the layered decomposition: (hidden, batch) -> the
    mean next-token cross-entropy (JAX ``_OffloadHead``, gpt2.py:
    310-332). The LM head is untied from the embedding, so that each
    layer's tensors stream on their own; the logits are fp32 from
    :class:`GPT2LMHeadModel`'s head (``x.float()`` times the weight
    upcast)."""

    def __init__(self, config: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        E = config.n_embd
        self.ln_f = nn.LayerNorm(E, eps=1e-5, device=device, dtype=dtype)
        self.lm_head = nn.Parameter(torch.empty(
            (config.padded_vocab, E), device=device, dtype=dtype))

    def forward(self, x, batch):
        input_ids, labels = _unpack(batch)
        shift_labels = (input_ids if labels is None else labels)[:, 1:]
        x = self.ln_f(x)
        shift_logits = F.linear(x[:, :-1].float(), self.lm_head.float())
        return masked_next_token_ce(shift_logits, shift_labels)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        nn.init.ones_(self.ln_f.weight)
        nn.init.zeros_(self.ln_f.bias)
        nn.init.normal_(self.lm_head, 0.0, 0.02, generator=generator)


def gpt2_offload_layers(cfg: GPT2Config, deterministic: bool = True):
    """The layered decomposition for ``runtime.zero.param_offload
    .Zero3OffloadEngine`` (parameters beyond the card's memory, streamed
    from host RAM or NVMe): ``[embed, block × n_layer, head]`` on the
    ``meta`` device, the body one block module ``n_layer`` times (the
    engine keeps one skeleton a distinct module and draws each layer's
    tensors on the host). Drive it through ``deepspeed_tpu_torch
    .initialize(model=gpt2_offload_layers(cfg), config={
    "zero_optimization": {"stage": 3, "offload_param": {"device":
    "cpu"}}, ...}, sample_batch=..., input_fn=lambda b:
    b["input_ids"])`` (JAX gpt2.py:335-345)."""
    _check_ported(cfg)
    if not deterministic:
        raise ValueError("the layered engine passes no dropout key: "
                         "gpt2_offload_layers runs deterministic=True only")
    if cfg.moe_num_experts > 0:
        raise ValueError("gpt2_offload_layers stacks dense blocks: a MoE "
                         "config would train without its experts (JAX's "
                         "stacks dense blocks whatever moe_num_experts "
                         "says)")
    block = _PipeBlock(cfg, device="meta")
    return ([_OffloadEmbed(cfg, device="meta")] + [block] * cfg.n_layer
            + [_OffloadHead(cfg, device="meta")])


def synthetic_batch(batch_size: int, seq_len: int, vocab_size: int, seed=0,
                    device=None):
    """Random token ids from ``seed`` (numpy, as in the JAX package)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab_size, (batch_size, seq_len), dtype=np.int32)
    return {"input_ids": torch.from_numpy(ids).long().to(
        resolve_device(device))}
