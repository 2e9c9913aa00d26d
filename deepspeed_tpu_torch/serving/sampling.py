"""Per-request sampling for the decode step (counterpart of
``deepspeed_tpu/serving/sampling.py``).

Temperature, top-p and seed are per-request ``[B]`` tensors, so greedy
and sampled requests share one decode step. Whether a batch is all
greedy is decided on the host, from the host temperatures the server
builds anyway (JAX decides it on the device with ``lax.cond``): no
device value is read to decide it.

Randomness: a token's draw depends only on (request seed, absolute
position), the JAX package's contract, which keeps sampling unchanged
by the batch slot, ``decode_steps``, preemption and speculation. The
port draws with a counter-based generator of its own: a 32-bit integer
hash of (the seed's two lanes, the position, the vocab index) in
integer tensor ops, whose bits are equal on the CPU and the GPU, then a
uniform in (0, 1) from its top 24 bits, then Gumbel-max over the
filtered logits. It does NOT draw JAX's threefry tokens: sampled
streams differ from the JAX engine's. Greedy tokens and
:func:`top_p_filter` equal JAX's.

Top-p (nucleus): sort descending, keep the smallest prefix whose
*exclusive* cumulative probability is < p (the top-1 token always
survives), then threshold the unsorted logits.
"""

import numpy as np
import torch

NEG_INF = -1e30
_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2**32 for int64 tensors of uint32 values, in 16-bit
    halves so no product leaves the int64 range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """The murmur3 32-bit finaliser (a bijection on uint32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform_noise(rng_lanes, positions, vocab):
    """``[B, vocab]`` fp32 uniforms in (0, 1), a function of (lane,
    position, vocab index) only. rng_lanes ``[B, 2]`` int64 (uint32
    values), positions ``[B]``."""
    lanes = rng_lanes.long()
    pos = positions.long() & _M32
    row = _mix32(lanes[:, 0] ^ _mix32(lanes[:, 1] ^ _mix32(pos)))
    col = _mix32(torch.arange(vocab, device=lanes.device, dtype=torch.long)
                 ^ 0x9E3779B9)
    h = _mix32(row[:, None] ^ col[None, :])
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def top_p_filter(logits, top_p):
    """Nucleus filter. logits ``[B, V]`` fp32, top_p ``[B]`` in (0, 1];
    p >= 1 keeps everything. Non-nucleus entries become NEG_INF."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]      # exclusive cumsum: top-1 stays
    threshold = torch.where(keep, sorted_desc, torch.inf).amin(dim=-1)
    return torch.where(logits >= threshold[:, None], logits, NEG_INF)


def sample_tokens(logits, temperature, top_p, rng_lanes, positions, *,
                  all_greedy, vocab_size=None):
    """One token per slot (int64 ``[B]``).

    logits ``[B, Vpad]``; temperature/top_p ``[B]`` fp32 (temperature
    <= 0 is greedy for that slot); rng_lanes ``[B, 2]``; positions
    ``[B]`` absolute positions; ``all_greedy`` (host bool): every slot
    is greedy, so the argmax alone runs. ``vocab_size`` masks padded
    vocab rows, which are never sampled."""
    if vocab_size is not None and vocab_size < logits.shape[-1]:
        logits = logits[:, :vocab_size]
    logits = logits.float()
    argmax = torch.argmax(logits, dim=-1)
    if all_greedy:
        return argmax
    greedy = temperature <= 0.0
    safe_t = torch.where(greedy, 1.0, temperature)
    filtered = top_p_filter(logits / safe_t[:, None], top_p)
    u = uniform_noise(rng_lanes, positions, logits.shape[-1])
    sampled = torch.argmax(filtered - torch.log(-torch.log(u)), dim=-1)
    return torch.where(greedy, argmax, sampled)


def make_rng_lane(seed: int):
    """Host-side: one request's lane (two uint32 values as int64) from
    its seed, by splitmix64."""
    z = (int(seed) + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    z ^= z >> 31
    return np.array([z & _M32, z >> 32], np.int64)
