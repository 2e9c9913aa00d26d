"""SLO-aware multi-replica request router (counterpart of
``deepspeed_tpu/serving/router.py``).

One :class:`~deepspeed_tpu_torch.serving.server.ServingEngine` saturates
at its KV pool and static batch; serving past that is N replicas behind a
router. Placement is a host-side argmax over per-replica scores — no
device work, no state shared between replicas, no change to any
replica's programs or CUDA graphs:

    score = affinity_weight  * matched_prefix_blocks
          - queue_weight     * (queue_depth + active)
          - occupancy_weight * kv_occupancy
          - breach_penalty   * recent_slo_breach

``matched_prefix_blocks`` is the replica prefix cache's pure peek
(:meth:`PrefixCache.match_blocks`: no LRU touch, no counters), so a
shared-prefix flow concentrates on the replica that already holds its KV
instead of prefilling it on every replica. The load terms come from
:meth:`ServingEngine.router_signals`; ``recent_slo_breach`` is true when
the replica's serving observatory fired ``ttft_slo_breach`` or
``queue_growth`` within its last two windows. ``breach_penalty``
dominates the other terms, so a breaching replica only receives traffic
when every replica is breaching (failover, not a blacklist; ties go to
the lower replica index).

The router owns the request-id space: ``submit`` returns a router id and
``collect`` re-stamps each replica's outputs with it. Replicas may share
one ``InferenceEngine`` (its weights) and each hold their own KV pool.
"""

import dataclasses

from deepspeed_tpu_torch.telemetry.chronicle import get_chronicle
from deepspeed_tpu_torch.utils.logging import log_dist


@dataclasses.dataclass
class RouteDecision:
    """Why a request landed where it did (returned by ``explain``,
    recorded for the last ``submit``)."""
    replica: int
    score: float
    affinity_blocks: int
    scores: list          # every replica's score, index-aligned


class ServingRouter:
    def __init__(self, engines, config=None):
        """``engines``: the replica :class:`ServingEngine` instances (the
        caller builds them); ``config``: a
        ``DeepSpeedServingRouterConfig``, a ``{"router": {...}}``-style
        dict, or None for defaults."""
        if not engines:
            raise ValueError("ServingRouter needs at least one engine")
        from deepspeed_tpu_torch.runtime.config import \
            DeepSpeedServingRouterConfig
        if config is None or isinstance(config, dict):
            config = DeepSpeedServingRouterConfig(config or {})
        self.engines = list(engines)
        self.config = config
        self._next_id = 0
        # router id -> (replica index, replica-local req id)
        self._placement = {}
        self.last_decision = None
        self.routed_by_replica = [0] * len(self.engines)
        log_dist(f"ServingRouter ready: {len(self.engines)} replica(s) "
                 f"affinity={config.affinity_weight} "
                 f"queue={config.queue_weight} "
                 f"occupancy={config.occupancy_weight} "
                 f"breach={config.breach_penalty}", ranks=[0])

    # ---------------------------------------------------------- placement
    def _affinity(self, engine, prompt) -> int:
        pc = engine.cache.prefix_cache
        return pc.match_blocks(prompt) if pc is not None else 0

    def explain(self, prompt) -> RouteDecision:
        """Score every replica for ``prompt`` (no side effects)."""
        c = self.config
        scores, affinities = [], []
        for eng in self.engines:
            sig = eng.router_signals()
            aff = self._affinity(eng, prompt)
            breach = sig["ttft_slo_breach"] or sig["queue_growth"]
            scores.append(c.affinity_weight * aff
                          - c.queue_weight * (sig["queue_depth"]
                                              + sig["active"])
                          - c.occupancy_weight * sig["kv_occupancy"]
                          - c.breach_penalty * bool(breach))
            affinities.append(aff)
        best = max(range(len(scores)), key=lambda i: (scores[i], -i))
        return RouteDecision(replica=best, score=scores[best],
                             affinity_blocks=affinities[best],
                             scores=scores)

    def submit(self, prompt, **kwargs) -> int:
        """Route one request; returns the router-global request id."""
        prompt = [int(t) for t in list(prompt)]
        decision = self.explain(prompt)
        self.last_decision = decision
        local = self.engines[decision.replica].submit(prompt, **kwargs)
        rid = self._next_id
        self._next_id += 1
        self._placement[rid] = (decision.replica, local)
        self.routed_by_replica[decision.replica] += 1
        # the placement goes into the run chronicle, so the timeline
        # says why traffic moved (one attribute check when disabled)
        get_chronicle().emit(
            "serving", "router", request_id=rid,
            replica=decision.replica,
            score=round(decision.score, 6),
            affinity_blocks=decision.affinity_blocks)
        return rid

    # --------------------------------------------------------------- loop
    def step(self) -> bool:
        progress = False
        for eng in self.engines:
            if eng.scheduler.has_work():
                progress |= eng.step()
        return progress

    def collect(self):
        """Drain every replica, re-stamped with router ids (finish order
        within a replica, replicas in index order)."""
        by_local = {(ri, local): rid
                    for rid, (ri, local) in self._placement.items()}
        outs = []
        for ri, eng in enumerate(self.engines):
            for o in eng.collect():
                rid = by_local.get((ri, o.req_id))
                if rid is None:
                    continue          # submitted directly to the engine
                del self._placement[rid]
                outs.append(dataclasses.replace(o, req_id=rid))
        return outs

    def serve_forever(self, max_steps=None):
        """Step every replica until all are drained; returns the
        collected outputs. Each replica's own livelock guard still
        applies."""
        outputs = []
        steps = 0
        while any(e.scheduler.has_work() for e in self.engines):
            self.step()
            outputs.extend(self.collect())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        outputs.extend(self.collect())
        return outputs

    # ---------------------------------------------------------- telemetry
    def stats(self):
        reps = []
        for ri, eng in enumerate(self.engines):
            pc = eng.cache.prefix_cache
            reps.append({
                "routed": self.routed_by_replica[ri],
                "signals": eng.router_signals(),
                "prefix_cache": None if pc is None else pc.stats(),
            })
        return {"replicas": reps, "pending": len(self._placement)}

    def close(self):
        for eng in self.engines:
            eng.close()
