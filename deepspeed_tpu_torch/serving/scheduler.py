"""Continuous-batching scheduler — admit/evict between decode steps
(counterpart of ``deepspeed_tpu/serving/scheduler.py``, ported as it is:
pure host bookkeeping; the lifecycle ``observer`` hook is the serving
observatory when ``serving.observability`` is on).

Orca-style iteration-level scheduling (OSDI '22) over a slot-based static
batch: the decode step always runs ``max_batch`` slots; the
scheduler decides *which request occupies which slot* between steps and
hands the server an active mask. Policy:

* **FCFS admission**: requests are admitted strictly in submit order. A
  head request whose prompt doesn't fit the free block pool blocks the
  tail (no out-of-order admission — the tests pin this).
* **Preemption by eviction**: when a running request needs one more KV
  block and the pool is dry, the LATEST-admitted running request is
  evicted — its blocks return to the pool and it re-queues at the FRONT
  of the waiting line (it still outranks everything submitted after it).
  Eviction is recompute-style (vLLM's recovery mode): the victim's
  generated-so-far tokens join its prompt and its KV is re-prefilled on
  re-admission.
* **Chunked prefill**: one bounded chunk per still-prefilling slot per
  scheduler iteration (earliest-admitted first — empty decode slots are
  pure waste, so prefill runs at batch priority), so a long prompt
  interleaves with decode dispatches at most ``max_batch`` chunks apart
  instead of stalling the batch for its whole forward (prefill covers
  ``prompt[:-1]``; the final prompt token is the request's first decode
  input — its KV is written by the decode step itself).
* **Shared-prefix admission** (when the cache carries a
  ``PrefixCache``): the prompt is walked block-by-block against the
  content-addressed index and every leading hit is mapped READ-ONLY
  into the new table (one refcount apiece) — prefill then starts at
  the first uncached token, so a cache-hit prefix costs one block-table
  copy and zero chunk dispatches. A fully-cached prompt must still
  rewrite its final position (that forward produces the first sampled
  logits), which lands inside the last shared block: the scheduler
  plans a copy-on-write fork (fresh block + one device block copy,
  executed by the server before the request's first dispatch). Cold
  cache-only blocks are reclaimed before ANY preemption fires, so the
  preemption-by-eviction path and its recompute accounting compose
  unchanged.

The scheduler is pure host-side bookkeeping: it never touches device
state. The server (serving/server.py) turns its ``StepPlan`` into the
fixed-shape inputs of the decode and prefill programs.
"""

import dataclasses
import enum
import time
from collections import deque
from typing import List, Optional


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0
    eos_token_id: Optional[int] = None
    # --- runtime state (scheduler/server owned) ---
    state: RequestState = RequestState.WAITING
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    block_table: List[int] = dataclasses.field(default_factory=list)
    cached_len: int = 0                  # KV positions written
    max_cached_len: int = 0              # high-water mark across evictions:
    # re-prefilled positions below it are RECOMPUTE (their KV existed
    # before a preemption threw it away)
    next_input: Optional[int] = None     # token the next decode step embeds
    # --- shared-prefix state (kv_cache.PrefixCache) ---
    shared_blocks: int = 0      # leading table entries mapped READ-ONLY
    # from the prefix index this admission; every KV write lands at
    # >= shared_blocks * block_size (asserted at admission)
    prefix_hit_blocks: int = 0  # blocks served from the index at the
    # last admission (the ledger's cached_prefill attribution)
    indexed_blocks: int = 0     # leading full blocks already registered
    prefix_digest: Optional[bytes] = None   # chain digest after them
    cow_fork: Optional[tuple] = None        # (src_block, table_index):
    # a pending copy-on-write fork — the server device-copies src into
    # block_table[table_index] and releases the src reference before
    # this request's first dispatch
    slot: Optional[int] = None
    admit_seq: int = -1
    preemptions: int = 0
    finish_reason: Optional[str] = None
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    step_budget: int = 0        # tokens the next decode dispatch may emit
    # --- speculative decoding state (serving/speculative.py) ---
    spec_drafted: int = 0       # draft tokens proposed for this request
    spec_accepted: int = 0      # of those, accepted by the verify pass
    # (rejected drafts roll back as a position edit: cached_len simply
    # does not advance past the accepted prefix)

    @property
    def spec_acceptance_rate(self) -> Optional[float]:
        """Per-request acceptance: accepted/drafted, None before any
        draft was proposed (e.g. speculation off)."""
        if not self.spec_drafted:
            return None
        return self.spec_accepted / self.spec_drafted

    @property
    def full_prompt(self) -> List[int]:
        """Tokens whose KV must exist to continue decoding — the original
        prompt plus everything generated so far (what a preempted request
        re-prefills on re-admission)."""
        return self.prompt + self.output_tokens


@dataclasses.dataclass
class StepPlan:
    """One scheduler iteration: one prefill chunk per still-prefilling
    slot (earliest-admitted first) + the decode slot set + the pending
    copy-on-write forks the server must execute FIRST."""
    prefill: List[Request] = dataclasses.field(default_factory=list)
    decode_slots: List[int] = dataclasses.field(default_factory=list)
    cow_forks: List[Request] = dataclasses.field(default_factory=list)

    @property
    def has_work(self) -> bool:
        return bool(self.prefill) or bool(self.decode_slots)


class ContinuousBatchingScheduler:
    def __init__(self, cache, max_batch: int, max_model_len: int,
                 decode_steps: int = 1, observer=None):
        self.cache = cache                      # PagedKVCache (owns alloc)
        self.allocator = cache.allocator
        self.max_batch = int(max_batch)
        self.max_model_len = int(max_model_len)
        self.decode_steps = int(decode_steps)
        # optional lifecycle observer (the serving observatory): called
        # synchronously on admit / preempt / admission-fail with the
        # request still carrying its pre-transition state
        self.observer = observer
        self.waiting = deque()
        self.slots: List[Optional[Request]] = [None] * self.max_batch
        self._admit_counter = 0
        self.preemptions_total = 0
        self.preemptions_by_reason = {}         # reason -> count
        # requests that can NEVER fit the pool (e.g. a preempted request
        # whose prompt+generated outgrew the usable blocks) — failed at
        # admission instead of livelocking the FCFS head; the server
        # drains these into its finished queue
        self.failed: List[Request] = []

    # ------------------------------------------------------------- state
    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slots)

    def has_work(self) -> bool:
        return bool(self.waiting) or self.num_active > 0

    # ------------------------------------------------------------ submit
    def submit(self, req: Request):
        p = len(req.prompt)
        if p < 1:
            raise ValueError("empty prompt")
        if p > self.max_model_len:
            raise ValueError(
                f"prompt length {p} exceeds max_model_len "
                f"{self.max_model_len}")
        if self.cache.blocks_for(p) > self.allocator.num_usable:
            raise ValueError(
                f"prompt needs {self.cache.blocks_for(p)} KV blocks but "
                f"the pool only has {self.allocator.num_usable} usable — "
                f"raise serving.num_blocks")
        req.state = RequestState.WAITING
        req.submit_t = time.perf_counter()
        self.waiting.append(req)

    # ---------------------------------------------------------- schedule
    def schedule(self) -> StepPlan:
        """Admission + capacity growth for one iteration. Called between
        decode steps — never mid-step."""
        self._admit()
        plan = StepPlan()
        # capacity growth FIRST: it may preempt slots (possibly ones in
        # PREFILL state), and the plan must only name requests that still
        # occupy a slot afterwards
        plan.decode_slots = self._ensure_decode_capacity()
        # one chunk per prefilling slot, earliest admission first: empty
        # decode slots are pure waste, so prefill runs at batch priority
        # (each chunk is still bounded, so decode interleaves at most
        # max_batch chunks later)
        plan.prefill = sorted(
            (r for r in self.slots
             if r is not None and r.state is RequestState.PREFILL),
            key=lambda r: r.admit_seq)
        # pending COW forks, collected AFTER capacity growth for the same
        # reason as the prefill plan: a fork whose request a later slot's
        # eviction removed is cleaned up by _preempt, not dispatched
        plan.cow_forks = [r for r in self.slots
                          if r is not None and r.cow_fork is not None]
        return plan

    def _allocate_reclaiming(self, n, owner):
        """All-or-nothing allocate, reclaiming cold prefix-cache blocks
        first when the free list is short. Cheaper than preemption in
        strictly every case: a reclaimed block costs nothing, an evicted
        request costs its whole prefix again as recompute."""
        blocks = self.allocator.allocate(n, owner=owner)
        pc = self.cache.prefix_cache
        if blocks is None and pc is not None:
            if pc.reclaim(n - self.allocator.num_free) > 0:
                blocks = self.allocator.allocate(n, owner=owner)
        return blocks

    def _admit(self):
        pc = self.cache.prefix_cache
        bs = self.cache.block_size
        while self.waiting:
            try:
                free = self.slots.index(None)
            except ValueError:
                return
            req = self.waiting[0]
            full = req.full_prompt
            need = self.cache.blocks_for(len(full))
            if need > self.allocator.num_usable:
                # can NEVER fit (a preempted request whose prompt +
                # generated tokens outgrew the pool): fail it instead of
                # blocking the FCFS head forever
                self.waiting.popleft()
                req.state = RequestState.FINISHED
                req.finish_reason = "capacity"
                req.finish_t = time.perf_counter()
                self.failed.append(req)
                if self.observer is not None:
                    self.observer.on_admission_fail(req)
                continue
            # shared-prefix walk: map every leading full block the index
            # holds read-only into this request's table. A fully-cached
            # prompt still needs position len(full)-1 REWRITTEN (the
            # last token's forward produces the first sampled logits),
            # and that position lives inside the last shared block — the
            # one divergent write, resolved by a copy-on-write fork.
            shared, digests = pc.lookup(full) if pc is not None else ([], [])
            k = len(shared)
            fork = k > 0 and k * bs >= len(full)
            fresh_needed = need - k + (1 if fork else 0)
            if k:
                # take the shared references BEFORE allocating: the
                # allocate path may reclaim cold refcount-1 cache
                # entries, and the blocks just matched are exactly that
                # until this incref pins them
                self.allocator.share(shared, owner=req.req_id)
            blocks = self._allocate_reclaiming(fresh_needed, req.req_id)
            if blocks is None:
                if k:       # roll the mapping back — all-or-nothing
                    self.allocator.free(shared, owner=req.req_id)
                return                      # strict FCFS: head blocks tail
            self.waiting.popleft()
            if pc is not None:
                pc.record_lookup(k, len(full) // bs)
            if fork:
                # need == k here (k*bs >= len(full) and a match can never
                # cover more tokens than the prompt has, so k*bs ==
                # len(full)): the table is the shared chain with its last
                # block replaced by the fresh fork target; the src
                # reference taken above is released by the server once
                # the device copy lands
                req.block_table = shared[:-1] + blocks
                req.cached_len = len(full) - 1
                req.shared_blocks = k - 1
                req.cow_fork = (shared[-1], k - 1)
            else:
                req.block_table = shared + blocks
                req.cached_len = k * bs
                req.shared_blocks = k
                req.cow_fork = None
            assert req.cached_len >= req.shared_blocks * bs, \
                "KV write position inside the read-only shared prefix"
            req.prefix_hit_blocks = k
            req.indexed_blocks = k
            req.prefix_digest = (digests[-1] if k
                                 else (pc.root_digest if pc else None))
            req.slot = free
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            req.next_input = full[-1]
            req.state = (RequestState.PREFILL
                         if len(full) - 1 - req.cached_len > 0
                         else RequestState.RUNNING)
            self.slots[free] = req
            if self.observer is not None:
                self.observer.on_admit(req)

    def _ensure_decode_capacity(self) -> List[int]:
        """Compute each running slot's dispatch budget (tokens the next
        decode dispatch may emit: capped by decode_steps, remaining
        generation and the model-length cap), grow its block table to
        cover the budget's KV writes, and preempt-by-eviction when the
        pool runs dry.

        Two phases: capacity growth may preempt ANY slot — including one
        visited earlier — so the decode list is collected only after
        every slot's growth has settled (a one-pass append could name a
        slot that a later slot's eviction emptied)."""
        for i in range(self.max_batch):
            req = self.slots[i]
            if req is None or req.state is not RequestState.RUNNING:
                continue
            budget = min(self.decode_steps,
                         req.max_new_tokens - len(req.output_tokens),
                         max(1, self.max_model_len - req.cached_len))
            req.step_budget = max(1, budget)
            while self.cache.blocks_for(
                    min(req.cached_len + req.step_budget,
                        self.max_model_len)) > len(req.block_table):
                # reclaim-before-preempt rides inside the allocate: a
                # cold cached block is free capacity, so no preemption
                # ever fires while the prefix index holds reclaimable
                # blocks
                grown = self._allocate_reclaiming(1, req.req_id)
                if grown is not None:
                    req.block_table.extend(grown)
                    continue
                # before evicting anyone, shrink the budget to the
                # capacity this slot already owns — guaranteed forward
                # progress even when the whole pool belongs to it (the
                # self-preempt/re-admit cycle would otherwise loop
                # without ever emitting a token)
                owned = (len(req.block_table) * self.cache.block_size
                         - req.cached_len)
                if owned >= 1:
                    req.step_budget = min(req.step_budget, owned)
                    break
                victim = self._pick_victim()
                self._preempt(victim, reason="capacity_growth")
                if victim is req:
                    break
        return [i for i in range(self.max_batch)
                if self.slots[i] is not None
                and self.slots[i].state is RequestState.RUNNING]

    def _pick_victim(self) -> Request:
        """Latest-admitted occupied slot — the request that has consumed
        the least scheduler priority loses its blocks first."""
        live = [r for r in self.slots if r is not None]
        assert live, "allocator dry with no slot to evict"
        return max(live, key=lambda r: r.admit_seq)

    def _preempt(self, req: Request, reason: str = "capacity_growth"):
        """Evict *req* (recompute-style). ``reason`` labels the
        preemption counters: ``capacity_growth`` is the only policy
        today (a running slot needed one more KV block and the pool was
        dry); ``admission`` is reserved for a future evict-to-admit
        policy — strict FCFS never evicts at admission."""
        # the high-water mark is what re-prefill will RE-compute: every
        # position below it had KV before this eviction threw it away
        req.max_cached_len = max(req.max_cached_len, req.cached_len)
        if self.observer is not None:
            self.observer.on_preempt(req, reason, req.cached_len)
        self._release_blocks(req)
        req.cached_len = 0
        self.slots[req.slot] = None
        req.slot = None
        req.state = RequestState.WAITING
        req.preemptions += 1
        self.preemptions_total += 1
        self.preemptions_by_reason[reason] = \
            self.preemptions_by_reason.get(reason, 0) + 1
        # front of the line: it was admitted before anything still waiting
        self.waiting.appendleft(req)

    def _release_blocks(self, req: Request):
        """Drop every block reference *req* holds — its table AND a
        pending COW fork's source. Frees are refcount decrements: blocks
        a sharer or the prefix index still references stay live, so
        preempting (or finishing) one sharer never perturbs another
        sharer's table — the sharing tests pin exactly that."""
        if req.cow_fork is not None:
            # fork planned but the device copy never ran (preempted or
            # failed in the same schedule that admitted it): release the
            # source reference the admission took
            self.allocator.free([req.cow_fork[0]], owner=req.req_id)
            req.cow_fork = None
        self.allocator.free(req.block_table, owner=req.req_id)
        req.block_table = []
        req.shared_blocks = 0

    # ------------------------------------------------------------ finish
    def finish(self, req: Request, reason: str):
        self._release_blocks(req)
        self.slots[req.slot] = None
        req.slot = None
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        req.finish_t = time.perf_counter()
