"""Dropout keyed by (seed, micro-step, site) (the port's counterpart of
the flax ``nn.Dropout`` the JAX models call, with the engine's dropout
rng ``fold_in(PRNGKey(seed), micro_steps)``, JAX engine.py:2757).

A :class:`Dropout` module is active only when the module is in training
mode and a key is in scope (:func:`key_scope`); the engine opens the
scope around each training forward with ``(seed, micro_steps)``, and
with ``(seed, micro_steps, rank)`` when the data-parallel world is above
one rank, so each rank draws its own masks for its own rows (world 1
keeps the two-part key's masks bit for bit). JAX draws one mask over the
global batch and slices it by rows; the port does not reproduce that. With no
key in scope the model is deterministic, as a flax model applied without
a ``dropout`` rng is (``deterministic = not self.has_rng("dropout")``).

Each mask is drawn from a generator seeded at the call from a 64-bit
mix of (seed, micro-step, site), where ``site`` numbers the model's
Dropout modules in ``named_modules`` order (:func:`number_sites`, which
the engine calls on its module; a module run under a key outside the
engine is numbered by its caller, and an unnumbered site raises rather
than share a mask with another). Nothing
advances between calls, so a recompute under activation checkpointing
(which re-enters the key the forward saw, ``activation_checkpointing``)
draws the same mask, and so does a rerun of the same micro-step. Kept
elements are scaled by 1 / (1 - p), as flax scales them. The masks are
not JAX's threefry draws, and the CPU and CUDA generators draw
different masks for one key.
"""

import contextlib

import torch
from torch import nn

_M64 = (1 << 64) - 1
_KEY = None          # (seed, micro_step) of the open scope, or None
_GENERATORS = {}     # device -> a generator reseeded at every draw


def _mix64(z):
    """splitmix64's finaliser: a bijection on 64-bit integers."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def mask_seed(seed, micro_step, site, rank=None):
    """The generator seed of one mask: a 63-bit mix of the keys (the
    data-parallel ``rank`` folded in last, when given)."""
    z = _mix64(_mix64(_mix64(int(seed) & _M64) ^ (int(micro_step) & _M64))
               ^ (int(site) & _M64))
    if rank is not None:
        z = _mix64(z ^ (int(rank) & _M64))
    return z >> 1


def current_key():
    """The (seed, micro_step[, rank]) in scope, or None."""
    return _KEY


@contextlib.contextmanager
def key_scope(key):
    """Make ``key`` (a (seed, micro_step) pair or a (seed, micro_step,
    rank) triple, or None for no dropout) the key of the Dropout modules
    called inside."""
    global _KEY
    if key is not None and len(key) not in (2, 3):
        raise ValueError(f"a dropout key is (seed, micro_step[, rank]), "
                         f"got {key!r}")
    saved, _KEY = _KEY, (None if key is None
                         else tuple(int(x) for x in key))
    try:
        yield
    finally:
        _KEY = saved


def _generator(device):
    gen = _GENERATORS.get(device)
    if gen is None:
        gen = _GENERATORS[device] = torch.Generator(device=device)
    return gen


def dropout(x, p, site):
    """``x`` with the mask of ``site`` under the key in scope: kept
    elements (probability 1 - p) divided by 1 - p, the rest 0 (flax
    ``nn.Dropout``). The identity with no key in scope or p == 0."""
    if p == 0.0 or _KEY is None:
        return x
    gen = _generator(x.device)
    gen.manual_seed(mask_seed(_KEY[0], _KEY[1], site, *_KEY[2:]))
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


class Dropout(nn.Module):
    """Dropout at one site of a model; active in training mode with a key
    in scope. ``site`` is set by :func:`number_sites`."""

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {p}")
        self.p = float(p)
        self.site = None

    def forward(self, x):
        if not self.training:
            return x
        if self.site is None and self.p > 0.0 and _KEY is not None:
            raise RuntimeError(
                "dropout site not numbered: run the model through the "
                "engine, or call number_sites(model) before a key_scope")
        return dropout(x, self.p, self.site)

    def extra_repr(self):
        return f"p={self.p}, site={self.site}"


def number_sites(model: nn.Module):
    """Number ``model``'s Dropout modules 0, 1, ... in ``named_modules``
    order, so each draws its own mask, and its MoE gates (modules with
    ``numbered_gate``, ``moe.sharded_moe.TopKGate``) 0, 1, ... apart, so
    each draws its own noise; returns ``model``."""
    for site, mod in enumerate(m for m in model.modules()
                               if isinstance(m, Dropout)):
        mod.site = site
    for site, mod in enumerate(m for m in model.modules()
                               if getattr(m, "numbered_gate", False)):
        mod.site = site
    return model
