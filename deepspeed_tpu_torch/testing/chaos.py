"""Deterministic chaos harness: seeded, budgeted fault injectors
(counterpart of ``deepspeed_tpu/testing/chaos.py``; the injectors the
serving overload cycle needs).

Every injector is **seeded** (the schedule is a pure function of the
seed and the call sequence, ``random.Random(seed)``), **budgeted** (it
stops after ``budget`` faults) and **reversible** (``uninstall()`` or the
context manager's exit restores every patched attribute in reverse
order). Nothing in the runtime imports this module.

Ported: :class:`ChaosFault`, :class:`FaultSchedule`, :class:`Injector`
and :class:`PoolStarvationChaos`. The JAX package's ``FilesystemChaos``,
``DivergenceChaos``, ``SlowCollateIterator`` and ``SigkillChaos`` are
not ported yet.
"""

import random

from deepspeed_tpu_torch.utils.logging import logger


class ChaosFault(OSError):
    """The synthetic failure an injector raises. An ``OSError`` on
    purpose: retry/fallback paths must treat it exactly like the real
    transient I/O error it stands in for."""


class FaultSchedule:
    """Seeded fire/don't-fire decision stream with an error budget.

    ``should_fire()`` is called once per guarded operation: it fires with
    probability ``p`` (1.0 = every call) once ``start_after`` calls have
    passed, and never more than ``budget`` times total. Two schedules
    built with the same arguments make identical decisions.
    """

    def __init__(self, seed=0, p=1.0, budget=1, start_after=0):
        self._rng = random.Random(seed)
        self.p = float(p)
        self.budget = int(budget)
        self.start_after = int(start_after)
        self.calls = 0
        self.fired = 0

    def should_fire(self):
        self.calls += 1
        if self.calls <= self.start_after or self.exhausted:
            return False
        # the RNG is consumed only on eligible calls so start_after does
        # not shift the decision stream
        if self.p >= 1.0 or self._rng.random() < self.p:
            self.fired += 1
            return True
        return False

    @property
    def exhausted(self):
        return self.fired >= self.budget

    def describe(self):
        return {"calls": self.calls, "fired": self.fired,
                "budget": self.budget, "exhausted": self.exhausted}


class Injector:
    """Reversible monkey-patching base.

    Subclasses implement ``_install()`` (declaring patches through
    ``self._patch(obj, name, replacement)``) and optionally
    ``_uninstall()`` for non-attribute resources (e.g. held pool
    blocks). ``uninstall`` restores every patched attribute in reverse
    order and is idempotent; the context-manager form guarantees
    restoration even when the test body throws.
    """

    def __init__(self):
        self._patches = []           # (obj, name, original), applied order
        self.installed = False

    def install(self):
        if not self.installed:
            self._install()
            self.installed = True
        return self

    def uninstall(self):
        if not self.installed:
            return
        try:
            self._uninstall()
        finally:
            while self._patches:
                obj, name, original = self._patches.pop()
                setattr(obj, name, original)
            self.installed = False

    def _install(self):
        raise NotImplementedError

    def _uninstall(self):
        pass

    def _patch(self, obj, name, replacement):
        original = getattr(obj, name)
        self._patches.append((obj, name, original))
        setattr(obj, name, replacement)
        return original

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False


class PoolStarvationChaos(Injector):
    """Seize KV-cache blocks from a serving allocator so admission
    starves.

    Holding ``hold_blocks`` (or ``hold_frac`` of the usable pool) makes
    waiting requests inadmissible: the queue grows, TTFT breaches — the
    overload signature the guardian's admission-pause policy keys on.
    ``uninstall`` returns every held block (the allocator's double-free
    guard makes a leak loud, so the teardown assertion is structural).
    """

    def __init__(self, allocator, hold_blocks=None, hold_frac=0.9):
        super().__init__()
        self.allocator = allocator
        if hold_blocks is None:
            hold_blocks = int(allocator.num_usable * float(hold_frac))
        self.hold_blocks = int(hold_blocks)
        self.held = None

    def _install(self):
        n = min(self.hold_blocks, self.allocator.num_free)
        self.held = self.allocator.allocate(n)
        if self.held is None:      # all-or-nothing pool: hold what exists
            self.held = []
        logger.warning(
            f"chaos: holding {len(self.held)} of "
            f"{self.allocator.num_usable} KV blocks")

    def _uninstall(self):
        if self.held:
            self.allocator.free(self.held)
        self.held = None
