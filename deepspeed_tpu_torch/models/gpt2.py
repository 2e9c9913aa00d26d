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
``runtime.activation_checkpointing.checkpointing.remat``. Not ported yet:
pipeline stages, ring/ulysses attention, MoE, rotary embeddings.
"""

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from deepspeed_tpu_torch.models.common import masked_next_token_ce
from deepspeed_tpu_torch.ops._platform import resolve_device
from deepspeed_tpu_torch.ops.quantizer.int8_linear import QuantDense
from deepspeed_tpu_torch.ops.sparse_attention.fused_kernels import (
    block_sparse_attention_fused, parse_sparse_mode, sparse_mode_layout)
from deepspeed_tpu_torch.ops.transformer.attention import attention
from deepspeed_tpu_torch.ops.transformer.decode import (
    aligned_cache_len, decode_attention, decode_attention_quantized,
    quantize_kv)
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing \
    import remat
from deepspeed_tpu_torch.runtime.dropout import Dropout


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
    moe_num_experts: int = 0
    # "auto" keeps K/V in the activation dtype; "int8" stores the decode
    # cache quantized with one fp32 absmax scale per cached row
    kv_cache_dtype: str = "auto"
    position_embedding: str = "learned"

    @property
    def padded_vocab(self) -> int:
        return _pad_vocab(self.vocab_size)

    def num_params(self) -> int:
        wpe = self.n_positions * self.n_embd
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


def _check_ported(cfg: GPT2Config):
    unported = {
        "pp_stages > 1": cfg.pp_stages > 1,
        f"attention_mode={cfg.attention_mode!r}":
            cfg.attention_mode != "auto"
            and not cfg.attention_mode.startswith("sparse"),
        "MoE": cfg.moe_num_experts > 0,
        f"position_embedding={cfg.position_embedding!r}":
            cfg.position_embedding != "learned",
    }
    for what, hit in unported.items():
        if hit:
            if cfg.attention_mode.startswith(("ring:", "ulysses:")):
                what += (" (ops.transformer.ring is ported; the model "
                         "waits for how a rank's batch maps to sequence "
                         "chunks, ROADMAP Queue A item 6)")
            raise NotImplementedError(f"GPT-2 {what} is not ported yet")
    if cfg.attention_mode.startswith("sparse"):
        parse_sparse_mode(cfg.attention_mode)
    if cfg.kv_cache_dtype not in ("auto", "int8"):
        raise ValueError(f"kv_cache_dtype must be 'auto' or 'int8', got "
                         f"{cfg.kv_cache_dtype!r}")


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
        sparse = cfg.attention_mode.startswith("sparse")
        if sparse and cache is not None:
            raise ValueError(
                "KV-cache decode would silently run DENSE attention on a "
                "sparse-trained model; decode with attention_mode='auto'")
        if sparse:
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


def _unpack(batch):
    if isinstance(batch, (tuple, list)):
        return batch[0], (batch[1] if len(batch) > 1 else None)
    if isinstance(batch, dict):
        return batch["input_ids"], batch.get("labels")
    return batch, None


class GPT2LMHeadModel(nn.Module):
    """GPT-2 causal LM with a tied LM head; ``forward`` returns the mean
    next-token cross-entropy, or fp32 logits over the padded vocab.

    ``device=None`` means CUDA (raises without a card); weights are drawn
    from ``seed`` as the flax init draws them: normal(0.02), residual
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
        self.wpe = nn.Parameter(torch.empty(
            (config.n_positions, E), device=dev, dtype=dtype))
        self.h = nn.ModuleList(Block(config, dev, dtype)
                               for _ in range(config.n_layer))
        self.ln_f = nn.LayerNorm(E, eps=1e-5, device=dev, dtype=dtype)
        self.drop = Dropout(config.dropout)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        gen = torch.Generator(device=self.wte.device).manual_seed(seed)
        proj_std = 0.02 / np.sqrt(2 * self.config.n_layer)
        nn.init.normal_(self.wte, 0.0, 0.02, generator=gen)
        nn.init.normal_(self.wpe, 0.0, 0.01, generator=gen)
        for blk in self.h:
            for layer, std in ((blk.attn.qkv, 0.02), (blk.attn.proj, proj_std),
                               (blk.mlp.fc, 0.02), (blk.mlp.proj, proj_std)):
                nn.init.normal_(layer.weight, 0.0, std, generator=gen)
                nn.init.zeros_(layer.bias)
            for ln in (blk.ln_1, blk.ln_2):
                nn.init.ones_(ln.weight)
                nn.init.zeros_(ln.bias)
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
        if pos + S > cfg.n_positions:
            raise ValueError(f"positions {pos}..{pos + S - 1} exceed "
                             f"n_positions ({cfg.n_positions})")
        x = self.drop(F.embedding(input_ids, self.wte)
                      + self.wpe[pos:pos + S])
        if cache is not None:
            return_logits = True
            cache.lens = torch.full((), pos + S, dtype=torch.int32,
                                    device=x.device)
        # remat: each block's activations are recomputed in the backward
        recompute = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, blk in enumerate(self.h):
            x = remat(blk, x) if recompute else blk(x, cache, i)
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
        return masked_next_token_ce(shift_logits, shift_labels)

    def loss_count(self, batch):
        """The number of next-token terms the loss of ``batch`` averages
        (labels ≥ 0); the engine weights a rank's loss by it."""
        input_ids, labels = _unpack(batch)
        return ((input_ids if labels is None else labels)[:, 1:] >= 0).sum()


def synthetic_batch(batch_size: int, seq_len: int, vocab_size: int, seed=0,
                    device=None):
    """Random token ids from ``seed`` (numpy, as in the JAX package)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab_size, (batch_size, seq_len), dtype=np.int32)
    return {"input_ids": torch.from_numpy(ids).long().to(
        resolve_device(device))}
