"""GPT-J in PyTorch (counterpart of ``deepspeed_tpu/models/gptj.py``).

The HF GPT-J architecture: no learned positions (partial rotary on the
leading ``rotary_dim`` features of q and k, interleaved pairs,
``ops.transformer.rotary``), q/k/v and out projections without bias, a
PARALLEL residual ``x + attn(ln_1(x)) + mlp(ln_1(x))`` with a tanh-GeLU
MLP, then ``ln_f`` and an untied biased LM head. Attention is causal
flash attention (:func:`attention`: the flash kernels on CUDA tensors,
the plain dense version on the CPU); GPT-J-6B's head dim is
4096 / 16 = 256.

``forward(batch)`` returns the mean next-token cross-entropy over
``x[:, :-1]`` (``models.common.masked_next_token_ce``), or the logits
with ``return_logits=True``: the recompute-generate protocol of
``InferenceEngine.generate`` (GPT-J has no KV cache, in JAX as here).
The head runs in the parameters' dtype, as flax's ``Dense`` does.

Weights are drawn from ``seed`` with the flax initialisers' statistics
(denses LeCun-normal, zero biases, unit LayerNorm scales, ``wte``
normal(0.02)); ``bridge.gptj_flax_to_state_dict`` carries flax params
across, and :func:`hf_gptj_to_params` maps an HF ``GPTJForCausalLM``
state dict onto the flax layout, as JAX's does. The tensor-parallel
rules (``gptj_tp_rules``) are not ported (ROADMAP Queue A item 11).
"""

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from deepspeed_tpu_torch.models.common import (lecun_normal_,
                                               masked_next_token_ce)
# GPT-2's batch convention, loss count and seeded ids serve GPT-J as they
# are
from deepspeed_tpu_torch.models.gpt2 import (  # noqa: F401
    _unpack, next_token_count, synthetic_batch)
from deepspeed_tpu_torch.ops._platform import resolve_device
from deepspeed_tpu_torch.ops.transformer.attention import attention
from deepspeed_tpu_torch.ops.transformer.rotary import apply_rotary_pos_emb


@dataclasses.dataclass(frozen=True)
class GPTJConfig:
    vocab_size: int = 50400
    n_positions: int = 2048
    n_embd: int = 4096
    n_layer: int = 28
    n_head: int = 16
    rotary_dim: int = 64
    n_inner: Optional[int] = None       # default 4 · n_embd
    layer_norm_epsilon: float = 1e-5

    @property
    def inner(self):
        return self.n_inner or 4 * self.n_embd

    def num_params(self) -> int:
        E, inner = self.n_embd, self.inner
        per_layer = (4 * E * E + 2 * E * inner + inner + E  # denses
                     + 2 * E)                               # ln_1
        return (self.vocab_size * E * 2 + self.vocab_size   # wte, lm_head
                + self.n_layer * per_layer + 2 * E)


PRESETS = {
    "tiny": GPTJConfig(vocab_size=256, n_positions=64, n_embd=64,
                       n_layer=2, n_head=4, rotary_dim=8),
    "gptj-6b": GPTJConfig(),            # EleutherAI GPT-J-6B's shape
}


class GPTJBlock(nn.Module):
    def __init__(self, config: GPTJConfig, device=None, dtype=torch.float32):
        super().__init__()
        E = config.n_embd
        kw = dict(device=device, dtype=dtype)
        self.config = config
        self.ln_1 = nn.LayerNorm(E, eps=config.layer_norm_epsilon, **kw)
        self.qkv = nn.Linear(E, 3 * E, bias=False, **kw)
        self.out_proj = nn.Linear(E, E, bias=False, **kw)
        self.fc_in = nn.Linear(E, config.inner, **kw)
        self.fc_out = nn.Linear(config.inner, E, **kw)

    def forward(self, x):
        cfg = self.config
        B, S, E = x.shape
        H = cfg.n_head
        D = E // H
        h = self.ln_1(x)
        # fused projection: [q | k | v] along the last dim, each (H, D)
        qkv = self.qkv(h).view(B, S, 3, H, D)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        q, k = apply_rotary_pos_emb(q, k, rotary_dim=cfg.rotary_dim)
        a = attention(q, k, v, causal=True)
        a = self.out_proj(a.transpose(1, 2).reshape(B, S, E))
        m = self.fc_out(F.gelu(self.fc_in(h), approximate="tanh"))
        # parallel residual (mlp_after_attn=False in the reference policy)
        return x + a + m


class GPTJForCausalLM(nn.Module):
    """GPT-J causal LM; ``forward`` returns the mean next-token
    cross-entropy, or the logits [B, S, vocab] with ``return_logits``.
    ``device=None`` means CUDA (raises without a card), ``"meta"`` shapes
    without storage."""

    def __init__(self, config: GPTJConfig, *, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        E = config.n_embd
        if E % config.n_head:
            raise ValueError(f"n_embd ({E}) must divide by n_head "
                             f"({config.n_head})")
        self.config = config
        self.wte = nn.Parameter(torch.empty((config.vocab_size, E),
                                            device=dev, dtype=dtype))
        self.h = nn.ModuleList(GPTJBlock(config, dev, dtype)
                               for _ in range(config.n_layer))
        self.ln_f = nn.LayerNorm(E, eps=config.layer_norm_epsilon,
                                 device=dev, dtype=dtype)
        self.lm_head = nn.Linear(E, config.vocab_size, device=dev,
                                 dtype=dtype)
        if dev.type != "meta":
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        gen = torch.Generator(device=self.wte.device).manual_seed(seed)
        nn.init.normal_(self.wte, 0.0, 0.02, generator=gen)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                lecun_normal_(mod.weight, gen)
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)

    def forward(self, batch, *, return_logits: bool = False):
        input_ids, labels = _unpack(batch)
        x = F.embedding(input_ids, self.wte)
        for blk in self.h:
            x = blk(x)
        x = self.ln_f(x)
        if return_logits:
            return self.lm_head(x)
        # slice before the head: the last position predicts nothing
        shift_labels = (input_ids if labels is None else labels)[:, 1:]
        return masked_next_token_ce(self.lm_head(x[:, :-1]), shift_labels)

    def loss_count(self, batch):
        """The next-token terms the loss of ``batch`` averages (labels
        ≥ 0); the engine weights a rank's loss by it."""
        return next_token_count(batch)


def is_hf_gptj_state_dict(sd) -> bool:
    """HF GPT-J naming: ``transformer.h.N.attn.q_proj`` (no
    ``.attention.`` level, unlike GPT-Neo)."""
    keys = list(sd)
    return (any(".attn.q_proj.weight" in k for k in keys)
            and not any(".attn.attention." in k for k in keys))


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _hf_get(state_dict, name):
    """A tensor under its bare or ``transformer.``-prefixed HF key, as
    fp32 numpy (JAX ``runtime/state_dict_factory._hf_get``)."""
    for k in (name, f"transformer.{name}"):
        if k in state_dict:
            return _np32(state_dict[k])
    raise KeyError(name)


def _hf_layer_count(state_dict) -> int:
    """The transformer layers of an HF state dict (keys ``h.N.*`` /
    ``transformer.h.N.*``; JAX ``state_dict_factory._hf_layer_count``)."""
    return 1 + max(
        (int(k.split("h.")[1].split(".")[0]) for k in state_dict
         if ".h." in k or k.startswith("h.")), default=-1)


def hf_gptj_to_params(state_dict, config: GPTJConfig):
    """An HF ``GPTJForCausalLM`` state dict as the flax params tree of
    JAX's ``GPTJForCausalLM`` (numpy fp32 leaves; torch ``[out, in]``
    weights transposed to flax ``[in, out]``, q/k/v concatenated into the
    fused ``qkv`` kernel), the tree ``bridge.gptj_flax_to_state_dict``
    takes. Raises ``ValueError`` when the layer count is not
    ``config.n_layer``."""
    def get(name):
        return _hf_get(state_dict, name)

    ckpt_layers = _hf_layer_count(state_dict)
    if ckpt_layers != config.n_layer:
        raise ValueError(f"checkpoint has {ckpt_layers} layers, config says "
                         f"n_layer={config.n_layer}")
    p = {"wte": get("wte.weight"),
         "ln_f": {"scale": get("ln_f.weight"), "bias": get("ln_f.bias")},
         "lm_head": {"kernel": _np32(state_dict["lm_head.weight"]).T,
                     "bias": _np32(state_dict["lm_head.bias"])}}
    for i in range(config.n_layer):
        pre = f"h.{i}"
        qkv = np.concatenate(
            [get(f"{pre}.attn.q_proj.weight").T,
             get(f"{pre}.attn.k_proj.weight").T,
             get(f"{pre}.attn.v_proj.weight").T], axis=1)
        p[f"h_{i}"] = {
            "ln_1": {"scale": get(f"{pre}.ln_1.weight"),
                     "bias": get(f"{pre}.ln_1.bias")},
            "qkv": {"kernel": qkv},
            "out_proj": {"kernel": get(f"{pre}.attn.out_proj.weight").T},
            "fc_in": {"kernel": get(f"{pre}.mlp.fc_in.weight").T,
                      "bias": get(f"{pre}.mlp.fc_in.bias")},
            "fc_out": {"kernel": get(f"{pre}.mlp.fc_out.weight").T,
                       "bias": get(f"{pre}.mlp.fc_out.bias")},
        }
    return p

