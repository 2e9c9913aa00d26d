"""Serving engine — the synchronous request-level front-end (counterpart
of ``deepspeed_tpu/serving/server.py``).

``ServingEngine`` glues the subsystem together on top of an
``InferenceEngine`` (which owns the model, its dtype and its int8
weights): a ``PagedKVCache`` block pool, the ``PagedGPT2Runner``'s
programs, the FCFS continuous-batching scheduler and chunked prefill.
The API is synchronous — ``submit()`` enqueues, ``step()`` advances the
world by one scheduler iteration (one bounded prefill chunk per
still-prefilling slot + one decode dispatch), ``collect()`` drains
finished requests — so a caller (or ``serve_forever``) owns the loop.

Metrics ride the port's registry (telemetry/metrics.py): TTFT and
inter-token latency histograms, queue-depth / active-slot / KV-occupancy
gauges, token/request/preemption counters. The entry points are
signature-watched (telemetry/compile_watch.py), which is how the tests
pin "exactly one decode program across a heterogeneous trace"; on CUDA
the gather impl's decode is one captured graph, counted as a capture.

With ``serving.observability`` on, the serving observatory
(telemetry/serving_observatory.py) books per-request timelines, the
slot-step ledger and the windowed SLO rules from host values the server
already holds; ``router_signals`` reads its recent anomalies for
``ServingRouter`` (serving/router.py). Preemptions, the livelock last
rites and refused submits go into the process-global run chronicle
(telemetry/chronicle.py) when one is armed.

The mission-control plane (JAX server.py:185-215, 356-415): a
``Guardian`` (runtime/guardian.py) pauses admission on an overload rule
(the observatory's ``queue_growth`` / ``ttft_slo_breach``, the SLO
monitor's ``slo_burn_page``), resumes it after quiet serving steps and
turns speculation off on ``speculation_waste``; an ``SloMonitor``
(telemetry/slo.py) burns the TTFT and end-to-end latency objectives; an
``ObsServer`` (telemetry/obs_server.py) serves ``serving_report`` at
``/api/report/serving``. Each is passed in or taken from the wrapped
engine (``_guardian`` / ``_slo`` / ``_obs_server``). Each step ticks
the SLO monitor, then the guardian, on the serving step clock; all of it
is host bookkeeping and adds no synchronization.

Not ported yet: the HBM residency observatory and ``profile_window``.
"""

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.serving.kv_cache import PagedKVCache
from deepspeed_tpu_torch.serving.prefill import ChunkedPrefill
from deepspeed_tpu_torch.serving.runner import PagedGPT2Runner
from deepspeed_tpu_torch.serving.sampling import make_rng_lane
from deepspeed_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler, Request, RequestState)
from deepspeed_tpu_torch.telemetry import chronicle as _chronicle
from deepspeed_tpu_torch.telemetry import metrics as _metrics
from deepspeed_tpu_torch.telemetry.compile_watch import CompileWatch
from deepspeed_tpu_torch.telemetry.serving_observatory import (
    SERVING_HEALTH_SCHEMA, ServingObservatory)
from deepspeed_tpu_torch.telemetry.tracer import trace_span
from deepspeed_tpu_torch.utils.logging import log_dist

# latency histograms: serving cares about the 0.1 ms .. 10 s band
_LAT_BUCKETS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500,
                5000, 10000)
_DECODE, _PREFILL = "serving_decode_step", "serving_prefill_chunk"
_DRAFT, _VERIFY = "serving_draft_step", "serving_verify_step"


class ServingLivelockError(RuntimeError):
    """serve_forever made no progress for its hard limit of iterations.
    Carries the ``serving_report()`` dict in ``.report``: the
    scheduler/slot/KV state dump and, with observability on, the
    slot-step ledger, windows and timelines."""

    def __init__(self, message, report=None):
        super().__init__(message)
        self.report = report


class ServingAdmissionPausedError(RuntimeError):
    """``submit()`` refused a request because the guardian paused
    admission (overload degradation). ``.rule`` names the rule that paused
    it: the structured reason a client can act on (back off, retry
    later)."""

    def __init__(self, rule):
        super().__init__(
            f"admission paused by the guardian (rule {rule!r}): the "
            f"server is shedding load; retry after recovery")
        self.rule = rule


@dataclasses.dataclass
class RequestOutput:
    req_id: int
    prompt: List[int]
    tokens: List[int]
    finish_reason: str
    ttft_s: Optional[float]
    latency_s: float
    preemptions: int


class ServingEngine:
    def __init__(self, engine, config=None, registry=None, use_flash=None,
                 guardian=None, obs_server=None, slo=None,
                 draft_params=None, draft_scales=None, cuda_graph=True):
        """``engine``: an ``InferenceEngine`` wrapping a GPT-2 model;
        ``config``: ``DeepSpeedServingConfig``, a ds-config dict (with or
        without the outer ``{"serving": ...}``), or ``None`` for defaults.
        ``draft_params``: an explicit small draft model for
        ``serving.speculative``, a GPT-2 ``state_dict`` pool- and
        vocab-compatible with the target (its int8 ``weight_scale``
        entries may come separately as ``draft_scales``); ``None``
        selects the truncated-layer self-draft. ``cuda_graph=False`` runs
        the gather impl's decode eagerly on CUDA (to hold the graph
        against). ``guardian``: a ``runtime.guardian.Guardian`` to wire
        the overload degradation into; ``slo`` / ``obs_server``: an
        ``SloMonitor`` and an ``ObsServer``; each falls back to the
        wrapped engine's own."""
        from deepspeed_tpu_torch.runtime.config import DeepSpeedServingConfig
        if config is None:
            config = DeepSpeedServingConfig({})
        elif isinstance(config, dict):
            pd = config if "serving" in config else {"serving": config}
            config = DeepSpeedServingConfig(pd)
        self.config = config
        self.engine = engine
        model = engine.module
        cfg = model.config
        device = engine.device
        n_pos = int(cfg.n_positions)
        self.max_model_len = (min(int(config.max_model_len), n_pos)
                              if config.max_model_len else n_pos)
        self.max_batch = int(config.max_batch)
        head_dim = cfg.n_embd // cfg.n_head
        int8_kv = getattr(cfg, "kv_cache_dtype", "auto") == "int8"
        self.max_blocks_per_seq = -(-self.max_model_len
                                    // int(config.block_size))
        num_blocks = int(config.num_blocks) or (
            1 + self.max_batch * self.max_blocks_per_seq)
        self.cache = PagedKVCache(
            n_layer=cfg.n_layer, n_head=cfg.n_head, head_dim=head_dim,
            block_size=config.block_size, num_blocks=num_blocks,
            dtype=engine.dtype, int8_kv=int8_kv)
        self.cache.init_pools(device)
        self.registry = registry if registry is not None \
            else _metrics.get_registry()
        self._watch = CompileWatch(registry=self.registry)
        self.runner = PagedGPT2Runner(
            model, self.cache, use_flash=use_flash,
            attention_impl=config.attention_impl,
            decode_steps=config.decode_steps, max_batch=self.max_batch,
            max_blocks=self.max_blocks_per_seq, cuda_graph=cuda_graph)
        if self.runner.graph_captured:
            self._watch.record_capture(_DECODE)
        # speculative decoding: a draft + verify pair replaces the decode
        # dispatch, and the scheduler's per-dispatch token budget becomes
        # k+1 (the verify width) so block growth covers every candidate
        spec_cfg = config.speculative
        self.speculative = None
        if spec_cfg.enabled:
            from deepspeed_tpu_torch.serving.speculative import (
                SpeculativeDecoder, default_draft_layers,
                validate_draft_params)
            draft_layers = spec_cfg.draft_layers or default_draft_layers(
                cfg.n_layer)
            if draft_params is not None:
                draft_params = {
                    name: t.to(device=device, dtype=(
                        engine.dtype if t.is_floating_point() and
                        not name.endswith("_scale") else t.dtype))
                    for name, t in {**draft_params,
                                    **(draft_scales or {})}.items()}
                validate_draft_params(draft_params, model.state_dict(),
                                      draft_layers)
            self.speculative = SpeculativeDecoder(
                self.runner, k=spec_cfg.k, draft_layers=draft_layers,
                acceptance=spec_cfg.acceptance,
                typical_threshold=spec_cfg.typical_threshold,
                draft_params=draft_params)
        dispatch_tokens = (self.speculative.k + 1
                           if self.speculative is not None
                           else int(config.decode_steps))
        self.scheduler = ContinuousBatchingScheduler(
            self.cache, max_batch=self.max_batch,
            max_model_len=self.max_model_len,
            decode_steps=dispatch_tokens)
        # serving observatory: host bookkeeping only (timelines, the
        # slot-step ledger, SLO rules); None when disabled, so every call
        # site is one attribute check
        obs_cfg = config.observability
        self.observatory = None
        if obs_cfg.enabled:
            self.observatory = ServingObservatory.from_config(
                obs_cfg, max_batch=self.max_batch,
                decode_steps=dispatch_tokens, registry=self.registry,
                engine_state_fn=self._engine_state,
                spec_acceptance_floor=(spec_cfg.acceptance_floor
                                       if self.speculative is not None
                                       else None))
            self.scheduler.observer = self.observatory
        # guardian overload degradation: the observatory's (and the SLO
        # monitor's) anomalies feed the guardian, whose serving policy
        # calls the pause / resume / speculation-disable actions below
        self.guardian = guardian if guardian is not None \
            else getattr(engine, "_guardian", None)
        self._serving_steps = 0
        self._admission_pause_rule = None     # None = admission open
        self._spec_disabled_rule = None       # None = speculation live
        if self.guardian is not None and self.guardian.enabled \
                and self.guardian.serving_degrade:
            self.guardian.pause_fn = self._pause_admission
            self.guardian.resume_fn = self._resume_admission
            self.guardian.spec_disable_fn = self._disable_speculation
            if self.observatory is not None:
                self.observatory.on_anomaly = self.guardian.hook("serving")
        # the SLO monitor burns the serving latency objectives; the obs
        # server serves the serving report
        self._slo = slo if slo is not None else getattr(engine, "_slo",
                                                        None)
        if self._slo is not None and getattr(self._slo, "enabled", False):
            for obj in getattr(self._slo, "serving_defaults", ()):
                self._slo.add_objective(obj)
        self._obs_server = obs_server if obs_server is not None \
            else getattr(engine, "_obs_server", None)
        if self._obs_server is not None:
            self._obs_server.register("serving", self.serving_report)
        # shared-prefix KV reuse: the scheduler reads cache.prefix_cache
        # at admission; the server runs the planned COW forks and
        # registers full blocks as prefill/decode completes them
        if config.prefix_cache.enabled:
            self.cache.attach_prefix_cache(
                capacity_blocks=config.prefix_cache.capacity_blocks,
                attention_impl=config.attention_impl)
        self._decode_fn = self._watch.wrap(self.runner.decode_step,
                                           name=_DECODE)
        self._prefill_fn = self._watch.wrap(self.runner.prefill_chunk,
                                            name=_PREFILL)
        # the COW fork's device copy is its own program, never a third
        # decode/prefill signature
        self._copy_fn = self._watch.wrap(self.cache.copy_block,
                                         name="serving_block_copy")
        self._draft_fn = self._verify_fn = None
        if self.speculative is not None:
            self._draft_fn = self._watch.wrap(self.speculative.draft_step,
                                              name=_DRAFT)
            self._verify_fn = self._watch.wrap(
                self.speculative.verify_step, name=_VERIFY)
        self.prefill = ChunkedPrefill(self._prefill_fn,
                                      chunk_size=config.prefill_chunk)
        self._next_id = 0
        self._finished = []
        self._lanes = {}              # req_id -> int64[2] rng lane
        self.registry.gauge(
            "serving_kv_pool_bytes",
            "allocated paged-KV pool size").set(self.cache.pool_bytes())
        log_dist(
            f"ServingEngine ready: max_batch={self.max_batch} "
            f"block_size={self.cache.block_size} "
            f"blocks={num_blocks} (usable "
            f"{self.cache.allocator.num_usable}) "
            f"max_model_len={self.max_model_len} "
            f"prefill_chunk={self.prefill.chunk_size} "
            f"kv={'int8' if int8_kv else 'native'} "
            f"impl={config.attention_impl} device={device}"
            + (" cuda_graph" if self.runner.graph_captured else "")
            + (f" speculative=k{self.speculative.k}/"
               f"L{self.speculative.draft_layers}"
               f"{'(draft model)' if draft_params is not None else ''}"
               if self.speculative is not None else ""), ranks=[0])

    # ------------------------------------------------------------ submit
    def submit(self, prompt, max_new_tokens=16, temperature=0.0,
               top_p=1.0, seed=0, eos_token_id=None) -> int:
        """Enqueue one request; returns its id. ``temperature<=0`` is
        greedy; otherwise temperature+top-p sampling on the request's own
        seeded RNG lane. Raises :class:`ServingAdmissionPausedError`
        while admission is paused."""
        if self._admission_pause_rule is not None:
            self.registry.counter(
                "serving_requests_rejected_total",
                "submits refused while admission was paused",
                labels={"reason": "admission_paused"}).inc()
            self._chronicle_serving("submit_refused", severity="watch",
                                    rule=self._admission_pause_rule)
            raise ServingAdmissionPausedError(self._admission_pause_rule)
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        vs = self.engine.module.config.vocab_size
        if prompt and (min(prompt) < 0 or max(prompt) >= vs):
            raise ValueError(f"prompt token out of range [0, {vs})")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not 0.0 < top_p <= 1.0:
            # top_p=0 would mask EVERY token (the nucleus keep-mask is
            # exclusive-cumsum < p); "greedy" is temperature<=0
            raise ValueError(
                f"top_p must be in (0, 1], got {top_p} (use "
                f"temperature=0 for greedy)")
        req = Request(req_id=self._next_id, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature), top_p=float(top_p),
                      seed=int(seed), eos_token_id=eos_token_id)
        self._next_id += 1
        self.scheduler.submit(req)
        self._lanes[req.req_id] = make_rng_lane(seed)
        if self.observatory is not None:
            self.observatory.record_submit(req)
        self.registry.counter("serving_requests_submitted_total",
                              "requests accepted by submit()").inc()
        self._publish_gauges()
        return req.req_id

    # -------------------------------------------------------------- step
    def step(self) -> bool:
        """One scheduler iteration: admission, one prefill chunk per
        still-prefilling slot, one decode dispatch. Returns True when
        any work was done."""
        with trace_span("serving_step"):
            plan = self.scheduler.schedule()
            progress = self._drain_failed()
            # acts: slot -> what it did this step (the slot-step ledger's
            # input), collected during the step because finished requests
            # vacate their slots before it ends
            acts = {}
            # COW forks first: a forked request may decode THIS step, and
            # its table already names the fork target
            for req in plan.cow_forks:
                progress |= self._run_cow_fork(req)
            for req in plan.prefill:
                progress |= self._run_prefill(req, acts)
            if plan.decode_slots:
                self._run_decode(plan.decode_slots, acts)
                progress = True
            self._publish_gauges()
            if self.observatory is not None:
                occupied = {i for i, r in enumerate(self.scheduler.slots)
                            if r is not None}
                self.observatory.end_step(
                    acts, occupied,
                    queue_depth=self.scheduler.num_waiting,
                    active=self.scheduler.num_active,
                    kv_occupancy=self.cache.allocator.occupancy(),
                    kv_fragmentation=self._kv_fragmentation(),
                    progress=progress)
            if self.guardian is not None or self._slo is not None:
                # the serving step clock (not training steps): the pause
                # policy fires here, and recovery counts quiet steps
                self._serving_steps += 1
                if self._slo is not None:
                    # burn-rate evaluation before the guardian's tick, so
                    # a page fired now pauses admission now
                    self._slo.tick(step=self._serving_steps)
                if self.guardian is not None:
                    self.guardian.serving_tick(self._serving_steps)
        return progress

    def _pause_admission(self, rule):
        """Guardian overload action: refuse new submits (they fail fast
        with the rule) until recovery; queued requests keep draining."""
        self._admission_pause_rule = str(rule)
        self.registry.gauge(
            "serving_admission_paused",
            "1 while the guardian has admission paused").set(1)
        self._chronicle_serving("admission_pause", severity="warning",
                                rule=str(rule))
        log_dist(f"serving: admission PAUSED (rule {rule}); new submits "
                 f"fail fast until recovery", ranks=[0])

    def _resume_admission(self):
        """Guardian recovery action: the overload rules stayed quiet for
        ``resume_clear_steps`` serving steps."""
        self._chronicle_serving("admission_resume", severity="info",
                                rule=self._admission_pause_rule)
        self._admission_pause_rule = None
        self.registry.gauge(
            "serving_admission_paused",
            "1 while the guardian has admission paused").set(0)
        log_dist("serving: admission RESUMED", ranks=[0])

    def _disable_speculation(self, rule):
        """Guardian degradation action (``speculation_waste``): decode
        falls back to the plain program, for the rest of the server's
        life (flapping would switch programs again and again)."""
        if self.speculative is None or self._spec_disabled_rule is not None:
            return
        self._spec_disabled_rule = str(rule)
        self.registry.gauge(
            "serving_speculation_disabled",
            "1 after the guardian disabled speculative decoding").set(1)
        self._chronicle_serving("speculation_disable", severity="warning",
                                rule=str(rule))
        log_dist(f"serving: speculation DISABLED (rule {rule}); decode "
                 f"falls back to the plain program", ranks=[0])

    def _fail_all_pending(self, reason):
        """Fail every waiting AND slotted request with *reason*; slotted
        requests release their blocks through the normal finish path."""
        count = 0
        waiting, self.scheduler.waiting = \
            list(self.scheduler.waiting), type(self.scheduler.waiting)()
        for req in waiting:
            req.state = RequestState.FINISHED
            req.finish_reason = reason
            req.finish_t = time.perf_counter()
            self._finished.append(req)
            count += 1
        for slot, req in enumerate(self.scheduler.slots):
            if req is None:
                continue
            self.scheduler.finish(req, reason)
            self._finished.append(req)
            if self.observatory is not None:
                self.observatory.record_finish(req, reason, slot)
            count += 1
        if count:
            self.registry.counter(
                "serving_requests_finished_total",
                "requests completed", labels={"reason": reason}).inc(count)
        return count

    def _drain_failed(self) -> bool:
        """Requests the scheduler failed at admission (prompt + generated
        tokens outgrew the pool) finish with reason 'capacity'."""
        failed = self.scheduler.failed
        if not failed:
            return False
        self.scheduler.failed = []
        for req in failed:
            self._finished.append(req)
            self.registry.counter(
                "serving_requests_finished_total",
                "requests completed", labels={"reason": "capacity"}).inc()
        return True

    def _run_cow_fork(self, req) -> bool:
        """Run one planned copy-on-write fork: copy the shared source
        block into the request's private fork target on the device, then
        release the source reference the admission pinned."""
        src, idx = req.cow_fork
        with trace_span("serving_cow_fork", req=req.req_id):
            self._copy_fn(np.int32(src), np.int32(req.block_table[idx]))
        self.cache.allocator.free([src], owner=req.req_id)
        req.cow_fork = None
        pc = self.cache.prefix_cache
        if pc is not None:
            pc.cow_forks += 1
        self.registry.counter(
            "serving_prefix_cow_forks_total",
            "copy-on-write block forks (first divergent write to a "
            "shared block)").inc()
        return True

    def _index_blocks(self, req):
        """Register every newly-FULL block of *req* in the prefix index.
        Called after prefill chunks and decode deliveries: generated
        tokens index too."""
        pc = self.cache.prefix_cache
        if pc is None:
            return
        bs = self.cache.block_size
        n_full = min(req.cached_len // bs, len(req.block_table))
        if req.indexed_blocks >= n_full:
            return
        full = req.full_prompt
        while req.indexed_blocks < n_full:
            b = req.indexed_blocks
            req.prefix_digest = pc.insert(
                req.prefix_digest, full[b * bs:(b + 1) * bs], b * bs,
                req.block_table[b])
            req.indexed_blocks += 1

    def _run_prefill(self, req, acts=None) -> bool:
        slot, start = req.slot, req.cached_len
        t0 = time.perf_counter_ns()
        with trace_span("serving_prefill", req=req.req_id):
            n_valid, n_recompute, done = self.prefill.run(
                req, self.max_blocks_per_seq)
        t1 = time.perf_counter_ns()
        self.registry.counter("serving_prefill_chunks_total",
                              "prefill chunks executed").inc()
        self.registry.counter("serving_prefill_tokens_total",
                              "prompt tokens cached by prefill").inc(n_valid)
        if n_recompute:
            # preemption COST: KV the pool computed once and an eviction
            # threw away
            self.registry.counter(
                "serving_recompute_tokens_total",
                "tokens re-prefilled because a preemption evicted their "
                "KV").inc(n_recompute)
        if acts is not None:
            # cached_prefill: the tail of a prefix-hit admission (useful
            # work; recompute outranks it)
            acts[slot] = ("recompute" if n_recompute
                          else ("cached_prefill" if req.prefix_hit_blocks
                                else "prefill"), n_valid)
        self._index_blocks(req)
        if self.observatory is not None:
            self.observatory.record_prefill(req, slot, start, n_valid,
                                            n_recompute, t0, t1, done)
        if done:
            req.state = RequestState.RUNNING
        return True

    def _run_decode(self, decode_slots, acts=None):
        B = self.max_batch
        MB = self.max_blocks_per_seq
        slots = self.scheduler.slots
        bt = self.cache.table_array(
            [r.block_table if r is not None else None for r in slots], MB,
            n_rows=B)
        pos = np.zeros((B,), np.int64)
        active = np.zeros((B,), bool)
        tok = np.zeros((B,), np.int64)
        temp = np.zeros((B,), np.float32)
        top_p = np.ones((B,), np.float32)
        lanes = np.zeros((B, 2), np.int64)
        budget = np.zeros((B,), np.int64)
        for i in decode_slots:
            r = slots[i]
            pos[i] = r.cached_len
            active[i] = True
            tok[i] = r.next_input
            temp[i] = r.temperature
            top_p[i] = r.top_p
            lanes[i] = self._lanes[r.req_id]
            budget[i] = r.step_budget
        spec = (self.speculative
                if self._spec_disabled_rule is None else None)
        t0 = time.perf_counter_ns()
        with trace_span("serving_decode", batch=len(decode_slots)):
            if spec is not None:
                # draft -> verify, device to device: the drafted tokens
                # feed verify without a host round-trip
                drafted = self._draft_fn(bt, pos, active, tok, budget)
                accepted, toks = self._verify_fn(
                    bt, pos, active, drafted, tok, temp, top_p, lanes,
                    budget)
                both = torch.cat([accepted[None], toks]).cpu().numpy()
                accepted, toks = both[0], both[1:]   # the one host sync
            else:
                toks = self._decode_fn(bt, pos, active, tok, temp, top_p,
                                       lanes, budget).cpu().numpy()
        # after the token read above, the dispatch's one sync: the
        # observatory's stamps add none
        t1 = time.perf_counter_ns()
        now = time.perf_counter()
        self.registry.counter("serving_decode_steps_total",
                              "decode dispatches executed").inc()
        if self.observatory is not None:
            # before delivery, so each timeline's decode_begin precedes
            # its first_token
            self.observatory.record_decode(
                {i: (slots[i], int(budget[i])) for i in decode_slots},
                t0, t1)
        if spec is None:
            for i in decode_slots:
                delivered = self._deliver(slots[i],
                                          toks[:budget[i], i].tolist(), now)
                if acts is not None:
                    acts[i] = ("decode", delivered)
            return
        # speculative delivery: per slot, min(accepted+1, budget) tokens
        # are real (accepted drafts + the target's bonus token); the rest
        # roll back by not advancing cached_len
        drafted_t = accepted_t = rejected_t = 0
        for i in decode_slots:
            r = slots[i]
            b = int(budget[i])
            cap = min(int(accepted[i]) + 1, b)
            delivered = self._deliver(r, toks[:cap, i].tolist(), now)
            considered = min(spec.k, max(b - 1, 0))
            rejected = considered - (cap - 1)
            r.spec_drafted += considered
            r.spec_accepted += cap - 1
            drafted_t += considered
            accepted_t += cap - 1
            rejected_t += rejected
            if acts is not None:
                acts[i] = ("decode", delivered, rejected)
        if drafted_t:
            drafted_c = self.registry.counter(
                "serving_spec_drafted_total",
                "draft tokens proposed to the verify program")
            drafted_c.inc(drafted_t)
            accepted_c = self.registry.counter(
                "serving_spec_accepted_total",
                "draft tokens the target accepted")
            accepted_c.inc(accepted_t)
            if rejected_t:
                self.registry.counter(
                    "serving_spec_rejected_total",
                    "draft tokens the target rejected (rolled back as "
                    "a position edit)").inc(rejected_t)
            self.registry.gauge(
                "serving_spec_acceptance_rate",
                "cumulative accepted/drafted ratio of speculative "
                "decoding").set(accepted_c.value / drafted_c.value)

    def _deliver(self, req, tokens, now):
        """Hand a dispatch's tokens to the request (anything it samples
        past eos/max_tokens/model_len is discarded). Returns the KEPT
        token count (the slot-step ledger's ``decode_useful``)."""
        slot = req.slot
        prev = req.last_token_t if req.first_token_t is not None else None
        delivered = 0
        reason = None
        for token in tokens:
            delivered += 1
            req.output_tokens.append(token)
            req.cached_len += 1
            req.next_input = token
            if req.eos_token_id is not None and token == req.eos_token_id:
                reason = "eos"
            elif len(req.output_tokens) >= req.max_new_tokens:
                reason = "max_tokens"
            elif req.cached_len >= self.max_model_len:
                reason = "model_len"
            if reason is not None:
                break
        if not delivered:
            return 0
        # register newly-full blocks BEFORE a finish releases the table:
        # a finished request's prefix stays warm in the index
        self._index_blocks(req)
        req.last_token_t = now
        if req.first_token_t is None:
            req.first_token_t = now
            ttft_ms = (now - req.submit_t) * 1e3
            self.registry.histogram(
                "serving_ttft_ms", "submit -> first generated token",
                buckets=_LAT_BUCKETS).observe(ttft_ms)
            if self.observatory is not None:
                self.observatory.record_first_token(req, ttft_ms)
            extra = 0      # same-dispatch tokens are part of the TTFT
        else:
            extra = delivered
        if extra > 0:
            # a multi-token dispatch records the amortised interval, so
            # the histogram compares across decode_steps settings
            per_tok = (now - prev) / extra * 1e3
            h = self.registry.histogram(
                "serving_token_latency_ms",
                "inter-token latency per request (dispatch-amortised)",
                buckets=_LAT_BUCKETS)
            for _ in range(extra):
                h.observe(per_tok)
        self.registry.counter(
            "serving_tokens_generated_total",
            "tokens sampled across all requests").inc(delivered)
        if reason is not None:
            self.scheduler.finish(req, reason)
            self._finished.append(req)
            if self.observatory is not None:
                self.observatory.record_finish(req, reason, slot)
            self.registry.counter(
                "serving_requests_finished_total",
                "requests completed", labels={"reason": reason}).inc()
            self.registry.histogram(
                "serving_e2e_latency_ms", "submit -> finish",
                buckets=_LAT_BUCKETS).observe(
                    (req.finish_t - req.submit_t) * 1e3)
        return delivered

    def _publish_gauges(self):
        self.registry.gauge("serving_queue_depth",
                            "requests waiting for admission").set(
                                self.scheduler.num_waiting)
        self.registry.gauge("serving_active_requests",
                            "requests occupying batch slots").set(
                                self.scheduler.num_active)
        self.registry.gauge("serving_kv_occupancy",
                            "fraction of usable KV blocks allocated").set(
                                self.cache.allocator.occupancy())
        self.registry.gauge("serving_kv_free_blocks",
                            "usable KV blocks currently free").set(
                                self.cache.allocator.num_free)
        if self.observatory is not None:
            self.registry.gauge(
                "serving_kv_fragmentation",
                "fraction of allocated KV positions no token has been "
                "written to (block-granularity over-allocation)").set(
                    self._kv_fragmentation())
        pc = self.cache.prefix_cache
        if pc is not None:
            for name, help_, total in (
                    ("serving_prefix_cache_hits_total",
                     "full prompt blocks served read-only from the "
                     "prefix index at admission", pc.hits),
                    ("serving_prefix_cache_misses_total",
                     "full prompt blocks the prefix index did not hold "
                     "at admission", pc.misses)):
                c = self.registry.counter(name, help_)
                if total > c.value:
                    c.inc(total - c.value)
            self.registry.gauge(
                "serving_prefix_blocks_shared",
                "resident prefix-index blocks currently mapped by at "
                "least one live request").set(pc.shared_blocks())
        for reason, total in self.scheduler.preemptions_by_reason.items():
            pre = self.registry.counter(
                "serving_preemptions_total",
                "evictions under block pressure, by reason",
                labels={"reason": reason})
            delta = total - pre.value
            if delta > 0:
                pre.inc(delta)
                self._chronicle_serving("preemption", severity="watch",
                                        reason=reason, count=delta)

    # ----------------------------------------------------------- collect
    def collect(self) -> List[RequestOutput]:
        """Drain finished requests (in finish order)."""
        out = []
        for req in self._finished:
            self._lanes.pop(req.req_id, None)
            out.append(RequestOutput(
                req_id=req.req_id, prompt=list(req.prompt),
                tokens=list(req.output_tokens),
                finish_reason=req.finish_reason,
                ttft_s=(None if req.first_token_t is None
                        else req.first_token_t - req.submit_t),
                latency_s=req.finish_t - req.submit_t,
                preemptions=req.preemptions))
        self._finished = []
        return out

    # -------------------------------------------------------------- loop
    def serve_forever(self, request_source=None, max_steps=None):
        """Drive the loop until drained: optionally pull submit-kwargs
        dicts from ``request_source`` (an iterable) to keep the queue
        primed, step until no work remains, return collected outputs."""
        source = iter(request_source) if request_source is not None else None
        outputs = []
        steps = 0
        idle = 0
        while True:
            while source is not None and \
                    self._admission_pause_rule is None and \
                    self.scheduler.num_waiting < 2 * self.max_batch:
                try:
                    self.submit(**next(source))
                except StopIteration:
                    source = None
                    break
            if not self.scheduler.has_work() and source is None:
                break
            idle = idle + 1 if not self.step() else 0
            if idle > 1000:
                # the scheduler guarantees forward progress; a long idle
                # spin means that invariant broke: every pending request
                # fails with a structured reason, the forensics snapshot
                # is forced to disk, and the report rides the exception
                n = self._fail_all_pending("livelock")
                self._chronicle_serving(
                    "livelock", severity="critical", failed=n,
                    detail=f"no progress for 1000 iterations; failed {n} "
                           f"pending request(s)")
                report = self.serving_report(write=True)
                raise ServingLivelockError(
                    "serving made no progress for 1000 iterations — "
                    f"failed {n} pending request(s) with reason "
                    f"'livelock'; "
                    f"kv_free={self.cache.allocator.num_free}/"
                    f"{self.cache.allocator.num_usable} blocks "
                    "(scheduler/slot/KV state dump attached as "
                    ".report)", report=report)
            outputs.extend(self.collect())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return outputs

    # -------------------------------------------------------- inspection
    def _kv_fragmentation(self):
        """The fraction of allocated KV positions no token has been
        written to (block-granularity over-allocation)."""
        allocated = used = 0
        for r in self.scheduler.slots:
            if r is not None:
                allocated += len(r.block_table) * self.cache.block_size
                used += r.cached_len
        return (1.0 - used / allocated) if allocated else 0.0

    def _engine_state(self):
        """Host-side scheduler/slot/KV dump — the core of
        ``serving_report()`` and the livelock exception."""
        slots = []
        for r in self.scheduler.slots:
            slots.append(None if r is None else {
                "req_id": r.req_id,
                "state": r.state.value,
                "prompt_len": len(r.prompt),
                "generated": len(r.output_tokens),
                "cached_len": r.cached_len,
                "blocks": len(r.block_table),
                "step_budget": r.step_budget,
                "preemptions": r.preemptions,
            })
        alloc = self.cache.allocator
        return {
            "scheduler": {
                "waiting": self.scheduler.num_waiting,
                "active": self.scheduler.num_active,
                "waiting_req_ids": [r.req_id for r in
                                    list(self.scheduler.waiting)[:32]],
                "slots": slots,
                "preemptions_by_reason":
                    dict(self.scheduler.preemptions_by_reason),
            },
            "kv": {
                "block_size": self.cache.block_size,
                "num_blocks": alloc.num_blocks,
                "usable": alloc.num_usable,
                "free": alloc.num_free,
                "allocated": alloc.num_allocated,
                "occupancy": round(alloc.occupancy(), 4),
                "fragmentation": round(self._kv_fragmentation(), 4),
                "pool_bytes": self.cache.pool_bytes(),
            },
            "prefix_cache": (None if self.cache.prefix_cache is None
                             else self.cache.prefix_cache.stats()),
            "compile": self.compile_stats(),
        }

    def router_signals(self):
        """The per-replica admission signals a :class:`ServingRouter`
        scores: queue and occupancy pressure, and whether the observatory
        fired ``ttft_slo_breach`` or ``queue_growth`` within its last two
        windows. With observability off the SLO flags stay False and
        routing reads load and affinity only."""
        sig = {
            "queue_depth": self.scheduler.num_waiting,
            "active": self.scheduler.num_active,
            "kv_occupancy": self.cache.allocator.occupancy(),
            "ttft_slo_breach": False,
            "queue_growth": False,
        }
        obs = self.observatory
        if obs is not None:
            horizon = obs.steps_seen - 2 * obs.window
            for a in obs.anomalies:
                if a.get("step", 0) >= horizon and \
                        a.get("rule") in ("ttft_slo_breach",
                                          "queue_growth"):
                    sig[a["rule"]] = True
        return sig

    def _chronicle_serving(self, event, severity=None, detail=None,
                           **data):
        """A serving event into the run chronicle (admission pause and
        resume, preemption, livelock last rites, a refused submit).
        ``step`` is the serving step clock, which the guardian and SLO
        ticks advance, not a training step."""
        chron = _chronicle.get_chronicle()
        if chron.enabled:
            chron.emit("serving", source="serving",
                       step=self._serving_steps,
                       severity=severity, detail=detail, event=event,
                       **data)

    def chronicle_report(self, write=False):
        """The wrapped engine's ``chronicle_report`` where it has one
        (the chronicle is process-global; the serving events above are in
        the same timeline), else ``{"enabled": False}``."""
        fn = getattr(self.engine, "chronicle_report", None)
        if fn is not None:
            return fn(write=write)
        return {"enabled": False}

    def serving_report(self, write=False):
        """The serving forensics dict: the observatory's report
        (slot-step ledger, windows, SLO anomalies, per-request timelines)
        with the live scheduler/slot/KV dump under ``engine_state``. With
        observability off, the dump alone. ``write=True`` also writes it
        to the observatory's ``snapshot_file`` (observability on only)."""
        if self.observatory is not None:
            report = self.observatory.report()
            if write:
                self.observatory.write_snapshot(report=report, force=True)
            return report
        return {"schema": SERVING_HEALTH_SCHEMA, "enabled": False,
                "engine_state": self._engine_state()}

    def close(self):
        """Teardown: unregister the serving report from the obs server
        (its provider points at this object), then force the
        observatory's final snapshot, so anomalies whose repeat firings
        all landed inside the snapshot throttle still reach
        ``snapshot_file``. Safe with observability off."""
        if self._obs_server is not None:
            self._obs_server.unregister("serving")
            self._obs_server = None
        if self.observatory is not None:
            self.observatory.close()

    def compile_stats(self):
        """Signature counts per entry point (the 'one decode program'
        guard reads this), and the CUDA graph captures where the decode
        is a captured graph."""
        w = self._watch
        stats = {"decode_signatures": w.signatures(_DECODE),
                 "prefill_signatures": w.signatures(_PREFILL),
                 "retraces": w.retraces}
        if self.speculative is not None:
            stats["draft_signatures"] = w.signatures(_DRAFT)
            stats["verify_signatures"] = w.signatures(_VERIFY)
        if self.runner.graph_captured:
            stats["graph_captures"] = w.captures
        return stats
