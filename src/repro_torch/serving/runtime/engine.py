"""Continuous-batching relay runtime (discrete-event, N-segment; port of
``repro/serving/runtime/engine.py``).

Replaces ``ServingEngine``'s sequential per-request loop with an
event-driven engine built for sustained mixed Poisson traffic:

* **Micro-batch aggregation** — per-pool :class:`MicroBatchAggregator`
  coalesces queued requests that share an (arm, segment) signature into
  pad-to-bucket batches, so each pool runs a handful of batch shapes
  (the ``Executor``'s per-bucket pattern) at sublinear per-item cost.
* **Segment-chained execution** — arms are relay-program templates
  (``repro_torch.serving.arms``): a completed segment batch does not block
  its replica, it enqueues per-request latent transfers whose completions
  enqueue the *next segment's* work items.  A two-hop relay is the
  edge→device special case; a 3-hop L→M→S cascade chains three pools, each
  held only for its own segment.
* **Compressed latent handoff** — the :class:`HandoffTransport` serializes
  every inter-segment latent through the row-wise int8 quantizer, halving
  bytes-on-wire and transfer latency at a measured (tiny) quality delta
  that is fed into the reward, so the LinUCB policy prices the trade.
* **Backpressure** — arm availability masks out arms whose pools exceed a
  backlog horizon, and pool occupancy in the context vector reflects both
  busy replicas and queued work, steering the policy away from congestion.
* **Fault tolerance** (sequential-engine parity) — replica failure
  injection as REPLICA_FAIL / REPLICA_RECOVER events: a failed replica
  accepts no new batches (in-flight work finishes) and its pool fails
  over to the surviving twin.  Straggler mitigation follows
  ``SimConfig.straggler_mode``: under ``"item"`` (the default) the
  detector fires a STRAGGLER_PARTIAL event that re-runs *only* the
  straggling samples on the twin as a sub-batch, priced at its own
  smaller bucket (:meth:`ContinuousRuntime._straggler_plan`), while the
  kept samples complete at their own pace; under ``"batch"`` a STRAGGLER
  event re-issues the whole lagging batch, capping every member at
  ``straggler_reissue ×`` the expected service time.  Straggler draws are
  request-intrinsic (``serving.context.straggler_slow``) so fault counters
  match the sequential engine's exactly in either mode.  The sub-batch
  price is the reference's: the port's ``Executor`` re-runs a straggler's
  whole bucket and slices it to keep its rows' bits
  (``serving/executor.py``), which at the relay's 8x8x4 latents is bound
  by kernel launches, so the two costs are close.

Rewards, contexts and records are bit-compatible with the sequential
engine (`repro_torch.serving.engine.Record`), so `summarize()` works
unchanged.  Policy updates fire at completion events (true async
ordering) rather than in arrival order.

Everything here is host numpy on the simulated clock, as in the
reference, so the records keep every float's order.  Two things touch a
device: the policy (on the device its caller built it on) and the
transport, whose first compressed ``handoff_error`` of a family (in
``_setup_arms``'s ``warm``) runs one int8 round trip on the runtime's
device — a ``quant_int8`` and a ``dequant_int8`` launch on the card.

Batch service time follows ``t(b) = t₁·(1 + growth·(b−1))`` — denoising at
moderate batch sizes is dominated by streaming the model weights, which a
batch amortizes, so per-item cost shrinks toward ``growth·t₁``.

Hot-path layout (the fleet-scale vectorization):

* replica ``busy_until`` times and failure flags live in two runtime-wide
  numpy arrays (each pool's list is a slice view), so the per-arrival
  occupancy/backlog/availability pass is one vectorized sweep
  (:meth:`ContinuousRuntime._snapshot`), cached on ``(now, state
  version)`` and invalidated by any pool mutation;
* ``_on_batch_done`` works per *batch*: every member shares the arm and
  segment (the BatchKey invariant), so quality penalties, wire bytes,
  occupancy keys and reward weights are per-arm precomputes, leaving only
  the per-item RNG-free tail (reward, policy update, record) in the loop;
* ARRIVE events are *streamed*: the sorted arrival list reserves its seq
  band up front (``EventQueue.reserve``) and each arrival is pushed
  lazily as the clock approaches it, bounding the heap by the in-flight
  window instead of the workload size (10⁶-request replays keep a
  constant-size heap);
* superseded FLUSH events (the aggregator deadline moved) are tagged with
  a per-pool generation and dropped on pop instead of running a no-op
  dispatch pass.

The records, fault counters and span structure equal the golden captures
of ``tests/golden/`` bit for bit (``tests/test_torch_runtime_golden.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.context import Request, context_vector
from repro_torch.core.program import (MERGE_NODE, SEGMENT_NODE, SELECT_NODE,
                                RelayGraph, compile_plan, phase_name,
                                select_outcome)
from repro_torch.serving import latency as lat
from repro_torch.serving.arms import ARMS, Arm, pools_used
from repro_torch.serving.context import (aggregate_occupancy, backlog_horizon,
                                   failure_schedule, fallback_avail,
                                   partition_stragglers, pool_inventory,
                                   pool_key, straggler_mode,
                                   telemetry_features)
from repro_torch.serving.obs.tracer import SpanTracer

from .batching import DEFAULT_BUCKETS, MicroBatchAggregator, bucketize
from .events import (ARRIVE, AUTOSCALE, BATCH_DONE, DEVICE_READY, FLUSH,
                     REPLICA_FAIL, REPLICA_RECOVER, STRAGGLER,
                     STRAGGLER_PARTIAL, EventQueue, WorkItem)
from .telemetry import RuntimeTelemetry
from .transport import HandoffTransport

#: arrivals kept ahead of the simulated clock in the event heap — the
#: streaming window.  Any value ≥ 1 yields the exact pre-fill pop order
#: (reserved seqs break ties identically); a modest cushion keeps the
#: producer entirely off the profile.
ARRIVAL_WINDOW = 256


@dataclass
class RuntimeConfig:
    """Continuous-runtime knobs: micro-batching, transport, observability.

    Every field has a bit-identity-preserving default — a default-
    constructed RuntimeConfig reproduces the golden record stream exactly
    (``tests/golden/``); every default is the reference's.  ``autoscaler``
    (None by default) attaches a replica autoscaler, duck-typed: an object
    with ``cfg.interval_s`` and ``decide(now, views)`` returning
    ``(pool, delta)`` pairs.  The runtime then fires AUTOSCALE evaluation
    ticks that may emit the ordinary REPLICA_FAIL / REPLICA_RECOVER
    pool-membership events.  The sequential engine reads only the
    transport's three fields (``HandoffTransport.for_runtime``).  Times
    are simulated seconds, bandwidth is Mbit/s."""

    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    linger_s: float = 0.25  # max wait for batch companions
    batch_cost_growth: float = 0.3  # t(b) = t1·(1 + growth·(b−1))
    compress_handoff: bool = True
    bw_mbps: float = 20.0
    quality_sensitivity: float = 1.0
    # span tracing (repro_torch.serving.obs.tracer): structured per-request
    # spans on the simulated clock — never perturbs decisions, quality or
    # faults
    trace: bool = True
    # optional obs.profiler.EventLoopProfiler wall-clock hooks around the
    # event loop's handler dispatch
    profiler: Optional[object] = None
    # optional replica autoscaler: telemetry-driven replica scale-up/down
    # through the REPLICA_FAIL/RECOVER events
    autoscaler: Optional[object] = None


@dataclass
class _PoolState:
    n: int
    free: List[int]
    busy_until: "np.ndarray"  # slice view into the runtime-wide array
    agg: MicroBatchAggregator
    # deadline of the single live FLUSH event (None: no flush pending);
    # flush_gen tags events so superseded ones are dropped on pop
    next_flush: Optional[float] = None
    flush_gen: int = 0
    failed: Set[int] = field(default_factory=set)  # injected outages

    # replicas parked by the autoscaler (a subset of ``failed``): a
    # scale-down adds here AND to failed — the pool drains it exactly like
    # an outage — and only members of this set are scale-up candidates
    scaled_down: Set[int] = field(default_factory=set)

    @property
    def n_alive(self) -> int:
        """Replicas currently in the pool (not failed, not scaled down)."""
        return self.n - len(self.failed)


@dataclass
class _Pending:
    req: Request
    arm_idx: int
    ctx: np.ndarray
    occ: Dict[str, float]  # decision-time occupancy (reward's l_dev)
    ideal_s: float  # zero-queue latency, for wait accounting


@dataclass
class _DagReq:
    """Per-request DAG execution state (graph arms only).

    ``decisions`` are the request's select outcomes, resolved at admission
    via the shared :func:`repro_torch.core.program.select_outcome` (pure in
    request + plan + transport, so the sequential engine replays them
    identically); ``skip`` the nodes those accepts cancel — they never
    spawn work items.  ``joins`` collects per-join predecessor arrival
    times; ``gates`` the completion instants of select gate nodes."""

    decisions: Dict[str, tuple]
    skip: frozenset
    base_pct: float
    joins: Dict[str, Dict[str, float]] = field(default_factory=dict)
    gates: Dict[str, float] = field(default_factory=dict)


@dataclass
class _Batch:
    """In-flight batch bookkeeping: supports straggler re-issue (the
    original completion event is superseded by bumping ``gen``).  A
    pre-staged partial re-issue sub-batch starts with ``replica=None`` —
    it acquires its twin replica only when STRAGGLER_PARTIAL fires."""

    pool: str
    replica: Optional[int]
    items: List[WorkItem]
    start: float
    dur: float  # nominal (straggler-free) service time incl. jitter
    gen: int = 0  # completion events carry the gen they were issued for
    twin: Optional[int] = None  # replica occupied by a re-issue
    # rids whose own straggler draw tripped the re-issue threshold (the
    # request-intrinsic set the tracer marks, matching the fault counters)
    tripped: frozenset = frozenset()


class ContinuousRuntime:
    """Drop-in ``run(requests) -> List[Record]`` engine; constructed by
    ``ServingEngine`` when ``runtime="continuous"`` (the default).

    ``device`` is the transport's: the card unless the caller passes
    ``"cpu"`` (raises when CUDA is absent)."""

    def __init__(self, policy, quality_table, cfg, rt_cfg: Optional[RuntimeConfig] = None,
                 executor=None, dynamic_reward: bool = True,
                 arms: Optional[Sequence[Arm]] = None, device=None):
        self.policy = policy
        self.qt = quality_table
        self.cfg = cfg  # SimConfig
        self.rt = rt_cfg or RuntimeConfig()
        self.executor = executor
        self.dynamic_reward = dynamic_reward
        self.arms = tuple(arms) if arms is not None else ARMS
        self.n_arms = len(self.arms)
        self.rng = np.random.default_rng(cfg.seed + 17)
        self.transport = HandoffTransport.for_runtime(self.rt, device=device)
        self.telemetry = RuntimeTelemetry()
        self.fault_counters = self.telemetry.faults
        self.tracer = SpanTracer()

    @property
    def trace(self) -> Dict[int, dict]:
        """Historical per-request timestamp-dict view, derived from spans."""
        return self.tracer.legacy_view()

    # ------------------------------------------------------------------
    # occupancy / backpressure
    # ------------------------------------------------------------------
    # _occ_pool/_backlog/_avail are the scalar reference implementations
    # (kept for tests and one-off pool states); the event loop reads the
    # vectorized-and-cached _snapshot instead, which computes the same
    # floats in the same order.

    def _occ_pool(self, st: _PoolState, now: float) -> float:
        if st.n_alive == 0:
            return 1.0
        busy = sum(
            1 for i, b in enumerate(st.busy_until)
            if b > now and i not in st.failed
        )
        queued = st.agg.depth() / st.agg.max_batch
        return float(min(1.0, (busy + queued) / st.n_alive))

    def _occupancies(self, now: float) -> dict:
        return aggregate_occupancy(
            {p: self._occ_pool(st, now) for p, st in self.pools.items()}
        )

    def _backlog(self, st: _PoolState, now: float) -> float:
        """Estimated seconds until a newly queued item could start."""
        if st.n_alive == 0:
            return np.inf
        busy_rem = sum(
            max(0.0, b - now) for i, b in enumerate(st.busy_until)
            if i not in st.failed
        ) / st.n_alive
        growth, bmax = self.rt.batch_cost_growth, st.agg.max_batch
        amort = (1.0 + growth * (bmax - 1)) / bmax  # batched per-item factor
        pend = (
            st.agg.pending_steps() * lat.STEP_COST[st.agg.pool] * amort
        ) / st.n_alive
        return busy_rem + pend

    def _avail(self, now: float) -> np.ndarray:
        horizon = backlog_horizon(self.cfg)
        backlog = {p: self._backlog(st, now) for p, st in self.pools.items()}
        out = np.zeros(self.n_arms, bool)
        for a in self.arms:
            out[a.idx] = all(backlog[p] < horizon for p in pools_used(a))
        return out

    def _snapshot(self, now: float):
        """One vectorized pass over the runtime-wide replica arrays →
        ``(grouped occupancy, availability mask)``, bit-identical to the
        scalar ``_occupancies``/``_avail`` pair.  Cached on ``(now, state
        version)``: any pool mutation bumps ``_ver`` and invalidates."""
        snap = self._snap
        if snap is not None and snap[0] == now and snap[1] == self._ver:
            return snap[2], snap[3]
        rem = self._busy_all - now
        np.maximum(rem, 0.0, out=rem)
        failed = self._failed_all
        rem[failed] = 0.0
        cnt = (self._busy_all > now) & ~failed
        rem_pp = np.add.reduceat(rem, self._pool_starts)
        cnt_pp = np.add.reduceat(cnt, self._pool_starts, dtype=np.int64)
        horizon = self._horizon
        occ: Dict[str, float] = {}
        ok = self._pool_ok
        for j, (p, st) in enumerate(self._pool_list):
            alive = st.n - len(st.failed)
            if alive == 0:
                occ[p] = 1.0
                ok[j] = False
                continue
            agg = st.agg
            queued = agg.depth() / agg.max_batch
            occ[p] = float(min(1.0, (int(cnt_pp[j]) + queued) / alive))
            backlog = float(rem_pp[j]) / alive + (
                agg.pending_steps() * self._pool_step_cost[j]
                * self._pool_amort[j]
            ) / alive
            ok[j] = backlog < horizon
        groups = aggregate_occupancy(occ)
        avail = ~(self._arm_pool_mat & ~ok).any(axis=1)
        self._snap = (now, self._ver, groups, avail)
        return groups, avail

    def _ctx_extra(self, now: float) -> Optional[np.ndarray]:
        """Live telemetry features (queue depth, batch occupancy) for the
        context vector, when ``cfg.telemetry_context`` is enabled."""
        if not getattr(self.cfg, "telemetry_context", False):
            return None
        depth = sum(st.agg.depth() for st in self.pools.values())
        qd = depth / (self.cfg.max_queue * len(self.pools))
        occs = [
            p.occupancy for p in self.telemetry.pools.values() if p.n_batches
        ]
        return telemetry_features(qd, float(np.mean(occs)) if occs else 1.0)

    # ------------------------------------------------------------------
    # event loop
    # ------------------------------------------------------------------

    def _setup_pools(self) -> None:
        """Array-backed pool state: one runtime-wide ``busy_until`` float
        array and one failure mask, with each pool's view sliced out (so
        per-replica writes and the vectorized snapshot share storage).
        Replica counts come from ``serving.context.pool_inventory`` — the
        testbed's POOL_REPLICAS unless ``cfg.pool_replicas`` overrides them
        (the fleet's heterogeneous-cluster seam)."""
        inventory = self.inventory = pool_inventory(self.cfg)
        names = list(inventory)
        total = sum(inventory.values())
        self._busy_all = np.zeros(total)
        self._failed_all = np.zeros(total, bool)
        self.pools = {}
        starts = []
        off = 0
        for p in names:
            n = inventory[p]
            starts.append(off)
            self.pools[p] = _PoolState(
                n=n, free=list(range(n)),
                busy_until=self._busy_all[off:off + n],
                agg=MicroBatchAggregator(p, self.rt.buckets, self.rt.linger_s),
            )
            off += n
        self._pool_starts = np.array(starts)
        self._pool_base = dict(zip(names, starts))
        self._pool_list = list(self.pools.items())
        self._pool_ok = np.empty(len(names), bool)
        growth = self.rt.batch_cost_growth
        self._pool_step_cost = [lat.STEP_COST[p] for p in names]
        self._pool_amort = []
        for p in names:
            bmax = self.pools[p].agg.max_batch
            self._pool_amort.append((1.0 + growth * (bmax - 1)) / bmax)
        self._horizon = backlog_horizon(self.cfg)
        self._ver = 0
        self._snap = None

    def _setup_arms(self) -> None:
        """Per-arm precomputes for the batched hot path.  The transport is
        warmed first so ``handoff_error``'s round trip (and on the card the
        kernel library's first load) happens here, not inside the first
        profiled BATCH_DONE handler."""
        self.transport.warm({a.family for a in self.arms})
        tcfg = self.transport.cfg
        names = [p for p, _ in self._pool_list]
        pool_j = {p: j for j, p in enumerate(names)}
        na = self.n_arms
        self._seg_info = [None] * na  # (phase, pool, steps) per segment
        self._ideal_base = [0.0] * na  # zero-queue denoise seconds
        self._arm_hops = [0] * na
        self._arm_is_relay = [False] * na
        self._wire_s = [0.0] * na  # RTT-free hop serialization seconds
        self._q_penalty: List[Optional[float]] = [None] * na
        self._occ_keys: List[Tuple[str, ...]] = [()] * na
        self._arm_pool_mat = np.zeros((na, len(names)), bool)
        # DAG arms: compiled plan (None → linear fast path untouched) and
        # gate-node → select-node map per arm
        self._plan = [None] * na
        self._gate_map: List[Dict[str, str]] = [{}] * na
        for a in self.arms:
            i, prog = a.idx, a.program
            if isinstance(prog, RelayGraph):
                plan = compile_plan(prog)
                if plan.is_chain:
                    # chain graphs normalize to the linear program and take
                    # the unmodified hot path below
                    prog = plan.linear_program()
                else:
                    self._plan[i] = plan
                    self._gate_map[i] = {
                        s.gate: nid for nid, s in plan.selects.items()
                        if s.gate is not None
                    }
                    # seg_idx indexes the canonical node order; join nodes
                    # hold a (nid, None, 0) placeholder — they never spawn
                    # pool work, but WorkItem.seg_idx stays positional
                    self._seg_info[i] = tuple(
                        (n.nid,
                         n.segment.pool if n.kind == SEGMENT_NODE else None,
                         n.segment.steps if n.kind == SEGMENT_NODE else 0)
                        for n in plan.nodes
                    )
                    self._arm_hops[i] = prog.n_hops
                    self._arm_is_relay[i] = prog.is_relay
                    self._wire_s[i] = lat.wire_seconds(
                        a.family, tcfg.bw_mbps, tcfg.compress
                    )
                    # _q_penalty stays None: DAG quality is per-request
                    # (select decisions) — priced at completion by the
                    # shared serving.engine.graph_quality
                    self._occ_keys[i] = tuple(
                        pool_key(p) for p in pools_used(a)
                    )
                    for p in pools_used(a):
                        self._arm_pool_mat[i, pool_j[p]] = True
                    continue
            self._seg_info[i] = tuple(
                (phase_name(prog, k), seg.pool, seg.steps)
                for k, seg in enumerate(prog.segments)
            )
            self._ideal_base[i] = sum(
                seg.steps * lat.STEP_COST[seg.pool] for seg in prog.segments
            )
            self._arm_hops[i] = prog.n_hops
            self._arm_is_relay[i] = prog.is_relay
            fam = a.family
            self._wire_s[i] = lat.wire_seconds(
                fam, tcfg.bw_mbps, tcfg.compress
            )
            if fam is not None and tcfg.compress:
                self._q_penalty[i] = (
                    tcfg.quality_sensitivity
                    * self.transport.handoff_error(fam) * max(prog.n_hops, 1)
                )
            self._occ_keys[i] = tuple(pool_key(p) for p in pools_used(a))
            for p in pools_used(a):
                self._arm_pool_mat[i, pool_j[p]] = True

    def run(self, requests: List[Request]):
        """Serve ``requests`` to completion; returns completion-ordered
        ``Record`` objects (times in simulated seconds).  Exactly
        :meth:`begin` followed by :meth:`_drain` — the split exists so a
        fleet driver (ROADMAP item 8(b)3) can interleave several
        clusters event-by-event on one global clock; the loop bodies are
        shared, so draining here or via repeated :meth:`step` calls yields
        bit-identical records, fault counters and spans."""
        self.begin(requests)
        self._drain()
        return self.records

    def begin(self, requests: List[Request]) -> None:
        """Initialize pool/arm state and seed the event queue WITHOUT
        draining it — the stepping entry point.  Seeds the failure
        schedule and the streaming-arrival window; further requests may
        arrive later via :meth:`inject` (the fleet router path)."""
        from repro_torch.serving.engine import (Record, graph_quality,
                                          score_and_update)

        self._Record, self._score = Record, score_and_update
        self._graph_quality = graph_quality
        self._setup_pools()
        self._setup_arms()
        self.pending: Dict[int, _Pending] = {}
        self._dag: Dict[int, _DagReq] = {}
        self.records: List[Record] = []
        self._batch_seq = 0
        self._inflight: Dict[int, _Batch] = {}
        evq = self.evq = EventQueue()
        # streaming arrivals: reserve the seq band the pre-fill would have
        # used, then push each ARRIVE lazily as the clock approaches it —
        # identical (t, seq) pop order with a heap bounded by the window
        arrivals = sorted(requests, key=lambda r: r.arrival)
        self._arrivals = arrivals
        self._arrive_base = evq.reserve(len(arrivals))
        self._next_arrival = 0
        for pool, idx, t_fail, t_recover in failure_schedule(self.cfg):
            evq.push(t_fail, REPLICA_FAIL, (pool, idx, t_recover))
            if np.isfinite(t_recover):
                evq.push(t_recover, REPLICA_RECOVER, (pool, idx))
        for _ in range(min(ARRIVAL_WINDOW, len(arrivals))):
            self._push_next_arrival()
        self._autoscale_armed = False
        if self.rt.autoscaler is not None and arrivals:
            self.ensure_autoscale(arrivals[0].arrival)

    def _drain(self) -> None:
        """Pop-and-handle until the event queue empties — the single-
        cluster hot loop (stale superseded FLUSH events drop on pop)."""
        evq, pools = self.evq, self.pools
        prof = self.rt.profiler
        if prof is None:
            while evq:
                now, kind, payload = evq.pop()
                if kind == FLUSH and payload[1] != pools[payload[0]].flush_gen:
                    continue  # superseded by a later deadline for this pool
                self._handle(kind, payload, now)
        else:
            from time import perf_counter

            prof.start()
            while evq:
                now, kind, payload = evq.pop()
                if kind == FLUSH and payload[1] != pools[payload[0]].flush_gen:
                    prof.record_stale(kind)
                    continue
                t0 = perf_counter()
                self._handle(kind, payload, now)
                prof.record(kind, perf_counter() - t0)
            prof.stop(evq)

    # ------------------------------------------------------------------
    # stepping interface (fleet driver)
    # ------------------------------------------------------------------

    def peek_time(self) -> Optional[float]:
        """Simulated timestamp (seconds) of this cluster's earliest queued
        event, or None when drained — what the fleet driver merges across
        clusters to find the globally next event."""
        heap = self.evq._heap
        return heap[0][0] if heap else None

    def step(self) -> Optional[float]:
        """Pop and handle exactly one event; returns its timestamp (None
        when the queue is empty).  A stale superseded FLUSH pops as a
        no-op, exactly as :meth:`_drain` drops it.  ``rt.profiler`` is not
        consulted on this path — fleet stepping is not the profiled
        single-cluster loop."""
        evq = self.evq
        if not evq:
            return None
        now, kind, payload = evq.pop()
        if kind == FLUSH and payload[1] != self.pools[payload[0]].flush_gen:
            return now
        self._handle(kind, payload, now)
        return now

    def inject(self, req: Request, t: Optional[float] = None) -> None:
        """Feed one routed request into the running simulation at time
        ``t`` (simulated seconds; defaults to ``req.arrival``) — the fleet
        router's admission path.  Unlike the pre-reserved streaming band
        of :meth:`begin`, injected arrivals take fresh heap seqs, so
        same-timestamp ties break after already-queued events."""
        t_arr = req.arrival if t is None else t
        self.evq.push(t_arr, ARRIVE, req)
        if self.rt.autoscaler is not None:
            self.ensure_autoscale(t_arr)

    def idle(self) -> bool:
        """True when nothing is queued or in flight — this cluster does no
        further work unless a request is injected."""
        return not self.evq and not self.pending

    def load_snapshot(self, now: float) -> Dict[str, object]:
        """Router-facing load view of this cluster at ``now``: grouped
        occupancy (the context-vector load features, from the cached
        vectorized snapshot), per-pool backlog seconds, queued/in-flight
        request counts, live-replica capacity and the fraction of arms the
        backlog horizon leaves available.  Read-only — computing it never
        perturbs the simulation (the snapshot caches on ``(now, state
        version)``), so routing cannot break bit-identity."""
        occ, avail = self._snapshot(now)
        return {
            "occupancy": dict(occ),
            "avail_frac": float(np.mean(avail)),
            "backlog_s": {
                p: float(self._backlog(st, now)) for p, st in self._pool_list
            },
            "queued": int(sum(st.agg.depth() for st in self.pools.values())),
            "inflight": len(self.pending),
            "capacity": int(sum(st.n_alive for st in self.pools.values())),
        }

    def _push_next_arrival(self) -> None:
        k = self._next_arrival
        if k < len(self._arrivals):
            self._next_arrival = k + 1
            req = self._arrivals[k]
            self.evq.push_at(req.arrival, self._arrive_base + k, ARRIVE, req)

    def _handle(self, kind: str, payload, now: float) -> None:
        if kind == ARRIVE:
            self._on_arrive(payload, now)
        elif kind == BATCH_DONE:
            self._on_batch_done(*payload, now=now)
        elif kind == DEVICE_READY:
            self._on_segment_ready(payload, now)
        elif kind == FLUSH:
            self._dispatch(payload[0], now)
        elif kind == STRAGGLER:
            self._on_straggler(payload, now)
        elif kind == STRAGGLER_PARTIAL:
            self._on_straggler_partial(payload, now)
        elif kind == REPLICA_FAIL:
            self._on_replica_fail(*payload, now=now)
        elif kind == REPLICA_RECOVER:
            self._on_replica_recover(*payload, now=now)
        elif kind == AUTOSCALE:
            self._on_autoscale(now)

    # ------------------------------------------------------------------

    def _item(self, req: Request, arm_idx: int, seg_idx: int) -> WorkItem:
        phase, pool, steps = self._seg_info[arm_idx][seg_idx]
        return WorkItem(req, arm_idx, phase, pool, steps, seg_idx=seg_idx)

    def _on_arrive(self, req: Request, now: float) -> None:
        self._push_next_arrival()  # keep the streaming window topped up
        occ, avail = self._snapshot(now)
        ctx = context_vector(req, occ, self._ctx_extra(now))
        if not avail.any():
            # everything congested: enqueue anyway — but never onto an arm
            # routing through a pool with zero live replicas, where the
            # work would sit in the aggregator with no dispatcher
            avail = fallback_avail(
                self.arms, {p: st.n_alive for p, st in self._pool_list}
            )
        arm_idx = self.policy.select(ctx, avail)

        plan = self._plan[arm_idx]
        if plan is None:
            # zero-queue latency: per-segment denoise + per-hop transfer
            ideal = self._ideal_base[arm_idx] + self._arm_hops[arm_idx] * (
                req.rtt_ms / 1000.0 + self._wire_s[arm_idx]
            )
        else:
            # DAG arm: zero-queue critical path, plus the request's select
            # decisions (clock- and RNG-free) resolved once at admission
            tcfg = self.transport.cfg
            ideal = lat.graph_ideal_seconds(
                plan, req.rtt_ms, bw_mbps=tcfg.bw_mbps,
                compressed=tcfg.compress,
            )
            base_pct = (
                self.transport.handoff_error(plan.graph.family) * 100.0
            )
            decisions = {
                nid: select_outcome(plan, nid, req.complexity, base_pct)
                for nid in plan.selects
            }
            skip: set = set()
            for nid, (accepted, _, _) in decisions.items():
                if accepted:
                    skip |= plan.selects[nid].skip_on_accept
            self._dag[req.rid] = _DagReq(decisions, frozenset(skip),
                                         base_pct)
        self.pending[req.rid] = _Pending(req, arm_idx, ctx, occ, ideal)
        item = self._item(req, arm_idx, 0)
        if self.rt.trace:
            self.tracer.start_request(req.rid, now, arm_idx,
                                      self.arms[arm_idx].label)
            self.tracer.enqueue(req.rid, item.phase, now)
        self.pools[item.pool].agg.push(item, now)
        self._dispatch(item.pool, now)

    def _batch_duration(self, pool: str, steps: int, bucket: int) -> float:
        base = lat.batch_service_time(
            pool, steps, bucket, self.rt.batch_cost_growth
        )
        jitter = float(np.clip(self.rng.normal(1.0, 0.03), 0.9, 1.15))
        return base * jitter

    def _straggler_plan(self, items: List[WorkItem]
                        ) -> Tuple[float, List[WorkItem], frozenset]:
        """Straggler draws for a dispatched batch →
        ``(slow, reissue_items, tripped_rids)``.

        ``slow`` is the batch's slowdown (max over the members it keeps — a
        batch moves at the pace of its slowest sample); ``reissue_items``
        are the members to split off for per-item twin re-issue (empty under
        whole-batch mode, where tripped members instead fold into ``slow``
        and the STRAGGLER cap handles the entire batch); ``tripped_rids``
        are the requests whose own draw exceeded the threshold (what the
        tracer marks as re-issued, in either mode).  Stragglers hit
        the first (edge) segment of relay programs only, mirroring the
        sequential engine.  Counters are per request so they match the
        sequential engine's exactly."""
        per_item = straggler_mode(self.cfg) == "item"
        first = items[0]
        is_relay_edge = first.seg_idx == 0 and self._arm_is_relay[first.arm_idx]
        if not is_relay_edge or self.cfg.straggler_prob <= 0.0:
            return 1.0, [], frozenset()
        kept_slow, reissue_rids, draws = partition_stragglers(
            self.cfg, [it.rid for it in items]
        )
        tripped = frozenset(reissue_rids)
        for rid, s in draws.items():
            if s > 1.0:
                self.telemetry.record_straggler(
                    reissued=rid in tripped, per_item=per_item
                )
        if not per_item:
            slow = max([kept_slow] + [draws[r] for r in reissue_rids])
            return slow, [], tripped
        return kept_slow, [it for it in items if it.rid in tripped], tripped

    def _dispatch(self, pool: str, now: float) -> None:
        st = self.pools[pool]
        self._ver += 1  # callers mutated the pool (push/free) or we will
        while st.free and st.agg.depth() > 0:
            res = st.agg.next_batch(now)
            forced = False
            if res is None:
                deadline = st.agg.flush_deadline()
                if deadline is not None and deadline <= now + 1e-9:
                    res = st.agg.next_batch(now, force=True)
                    forced = True
                else:
                    break
            if res is None:
                break
            items, bucket = res
            replica = st.free.pop()
            dur = self._batch_duration(pool, items[0].steps, bucket)
            slow, reissue_items, tripped = self._straggler_plan(items)
            bid = self._batch_seq
            self._batch_seq = bid + 1
            detect = now + dur * max(self.cfg.straggler_reissue - 1.0, 0.0)
            if reissue_items:
                # per-item mitigation: pre-stage a sub-batch of only the
                # straggling samples; when the detector trips, the twin
                # replica re-runs just those (the Executor's
                # generate_bucketed(..., subset=...) path), padded to their
                # own — usually smaller — bucket, so the re-issue cost
                # follows the same batch_cost_growth model.  The sub-batch
                # duration scales off the issued ``dur`` so the dispatch
                # jitter carries over.
                split = {it.rid for it in reissue_items}
                kept = [it for it in items if it.rid not in split]
                steps = items[0].steps
                sub_bucket = bucketize(
                    len(reissue_items), tuple(sorted(self.rt.buckets))
                )
                sub_dur = dur * (
                    lat.batch_service_time(
                        pool, steps, sub_bucket, self.rt.batch_cost_growth)
                    / lat.batch_service_time(
                        pool, steps, bucket, self.rt.batch_cost_growth)
                )
                sub_bid = self._batch_seq
                self._batch_seq = sub_bid + 1
                self._inflight[sub_bid] = _Batch(
                    pool, None, reissue_items, detect, sub_dur,
                    tripped=tripped,
                )
                self.evq.push(detect, STRAGGLER_PARTIAL, sub_bid)
                self._inflight[bid] = _Batch(pool, replica, kept, now, dur)
                # kept samples finish at their own (un-straggled) pace; a
                # batch whose every member straggles is abandoned once the
                # detector hands its samples to the twin
                done = now + dur * slow if kept else detect
            else:
                self._inflight[bid] = _Batch(pool, replica, items, now, dur,
                                             tripped=tripped)
                if slow > self.cfg.straggler_reissue:
                    # whole-batch mode lagging batch: the detector trips
                    # once it has exceeded (reissue−1)× its expected time;
                    # the re-issued twin copy then needs one more nominal
                    # service time, so completion lands at reissue ×
                    # expected — the sequential engine's cap
                    self.evq.push(detect, STRAGGLER, bid)
                done = now + dur * slow
            st.busy_until[replica] = done
            self.telemetry.record_batch(pool, len(items), bucket, dur, forced)
            if self.rt.trace:
                for it in items:
                    self.tracer.start_segment(
                        it.rid, it.phase, now, pool, batch=bid,
                        bucket=bucket, n_items=len(items), replica=replica,
                        seg_idx=it.seg_idx,
                    )
            self.evq.push(done, BATCH_DONE, (bid, 0))
        # flush maintenance: at most one live FLUSH per pool.  A lingering
        # sub-maximal batch (free replica available) arms a flush at its
        # linger deadline; any other end state — queue drained, or every
        # replica busy (a future BATCH_DONE's dispatch pass re-arms) —
        # supersedes whatever event is still in the heap by bumping the
        # generation, so the loop drops it on pop instead of running a
        # no-op force-dispatch pass per superseded deadline.
        if st.free and st.agg.depth() > 0:
            deadline = st.agg.flush_deadline()
            if deadline != st.next_flush:
                st.flush_gen += 1
                st.next_flush = deadline
                self.evq.push(deadline, FLUSH, (pool, st.flush_gen))
        elif st.next_flush is not None:
            st.flush_gen += 1
            st.next_flush = None
        self.telemetry.record_depth(pool, now, st.agg.depth())

    # ------------------------------------------------------------------
    # fault handling
    # ------------------------------------------------------------------

    def _on_straggler(self, bid: int, now: float) -> None:
        """Whole-batch re-issue: a still-straggling batch re-runs entirely
        on the twin replica, the copy completing one nominal service time
        from detection and superseding the original (slow) completion
        event.  Every member — straggling or not — pays the cap."""
        b = self._inflight.get(bid)
        if b is None or b.gen != 0:
            return
        st = self.pools[b.pool]
        self._ver += 1
        b.gen = 1
        done = now + b.dur
        if st.free:  # twin replica picks up the speculative copy
            b.twin = st.free.pop()
            st.busy_until[b.twin] = done
        # with no twin free the re-issue borrows capacity, keeping the cap
        # unconditional — the sequential engine's semantics exactly
        # the straggling original is abandoned at the capped completion
        st.busy_until[b.replica] = done
        self.telemetry.record_reissue(b.pool, n_items=len(b.items))
        if self.rt.trace:
            # mark only the members whose own draw tripped the detector —
            # the request-intrinsic set the fault counters use, so marker
            # sets are parity-comparable with the sequential engine even
            # though the whole batch pays the re-issue cap
            for rid in sorted(b.tripped):
                self.tracer.reissue(rid, now, partial=False)
        self.evq.push(done, BATCH_DONE, (bid, 1))

    def _on_straggler_partial(self, bid: int, now: float) -> None:
        """Partial re-issue: the twin replica picks up the pre-staged
        sub-batch holding only the straggling samples, completing one
        sub-batch service time after detection.  The kept samples of the
        original batch finish independently — per-item mitigation never
        taxes a healthy co-batched request."""
        b = self._inflight.get(bid)
        if b is None:
            return
        st = self.pools[b.pool]
        self._ver += 1
        done = now + b.dur
        if st.free:  # twin replica hosts the re-run
            b.replica = st.free.pop()
            st.busy_until[b.replica] = done
        # with no twin free the re-run borrows capacity — the completion
        # bound stays unconditional, matching the sequential engine
        self.telemetry.record_reissue(
            b.pool, n_items=len(b.items), partial=True
        )
        if self.rt.trace:
            for it in b.items:
                self.tracer.reissue(it.rid, now, partial=True)
        self.evq.push(done, BATCH_DONE, (bid, 0))

    def _on_replica_fail(self, pool: str, idx: int, t_recover: float,
                         autoscale: bool = False, *, now: float) -> None:
        """Remove a replica from service: the replica accepts no new
        batches (in-flight work finishes); the pool fails over to its
        surviving replicas.  ``autoscale=True`` marks an autoscaler
        scale-down rather than an injected outage — the replica parks in
        ``scaled_down`` (the scale-up candidate set) and the action counts
        in the autoscale counters, never in the fault counters (whose
        exact dicts the golden/parity suites compare)."""
        st = self.pools[pool]
        self._ver += 1
        st.failed.add(idx)
        self._failed_all[self._pool_base[pool] + idx] = True
        if idx in st.free:
            st.free.remove(idx)
        if autoscale:
            st.scaled_down.add(idx)
            self.telemetry.record_scale(pool, up=False)
        else:
            self.telemetry.record_failure(
                pool, recovers=bool(np.isfinite(t_recover))
            )

    def _on_replica_recover(self, pool: str, idx: int,
                            autoscale: bool = False, *, now: float) -> None:
        """Return a replica to service (outage recovery, or an autoscaler
        scale-up un-parking a ``scaled_down`` replica) and kick a dispatch
        pass so queued work claims it immediately."""
        st = self.pools[pool]
        self._ver += 1
        st.failed.discard(idx)
        st.scaled_down.discard(idx)
        self._failed_all[self._pool_base[pool] + idx] = False
        if autoscale:
            self.telemetry.record_scale(pool, up=True)
        if st.busy_until[idx] <= now and idx not in st.free:
            st.free.append(idx)
        self._dispatch(pool, now)

    # ------------------------------------------------------------------
    # autoscaling (a duck-typed autoscaler on ``rt.autoscaler``)
    # ------------------------------------------------------------------

    def ensure_autoscale(self, now: float) -> None:
        """Arm the next AUTOSCALE evaluation tick (one live tick at a
        time) ``interval_s`` seconds from ``now``; no-op without an
        attached autoscaler or with a tick already pending."""
        sc = self.rt.autoscaler
        if sc is None or self._autoscale_armed:
            return
        self._autoscale_armed = True
        self.evq.push(now + sc.cfg.interval_s, AUTOSCALE, None)

    def _on_autoscale(self, now: float) -> None:
        """Evaluate the autoscaling policy over per-pool telemetry and
        apply its decisions through the ordinary pool-membership events: a
        scale-down pushes REPLICA_FAIL (the replica drains exactly like an
        outage — in-flight work finishes, no new batches), a scale-up
        pushes REPLICA_RECOVER for a parked replica.  Scale-down prefers a
        free replica (highest index), else the highest-index live one;
        scale-up revives the lowest-index parked replica — both
        deterministic, so runs are reproducible.  The tick re-arms only
        while work remains, so the event loop still terminates."""
        self._autoscale_armed = False
        sc = self.rt.autoscaler
        views: Dict[str, Dict[str, float]] = {}
        for p, st in self._pool_list:
            views[p] = {
                "n_alive": st.n_alive,
                "n_parked": len(st.scaled_down),
                "n_total": st.n,
                "depth": st.agg.depth(),
                "backlog_s": float(self._backlog(st, now)),
                "occupancy": float(self._occ_pool(st, now)),
            }
        self.telemetry.record_autoscale_tick()
        for pool, delta in sc.decide(now, views):
            st = self.pools[pool]
            if delta > 0:
                parked = sorted(st.scaled_down)
                if parked:
                    self.evq.push(now, REPLICA_RECOVER, (pool, parked[0], True))
            elif delta < 0 and st.n_alive > 0:
                alive = [i for i in range(st.n) if i not in st.failed]
                free_alive = [i for i in alive if i in st.free]
                idx = max(free_alive) if free_alive else max(alive)
                self.evq.push(now, REPLICA_FAIL, (pool, idx, np.inf, True))
        if (self.pending or self._next_arrival < len(self._arrivals)
                or any(st.agg.depth() for _, st in self._pool_list)):
            self.ensure_autoscale(now)

    # ------------------------------------------------------------------

    def _on_batch_done(self, bid: int, gen: int, now: float) -> None:
        b = self._inflight.get(bid)
        if b is None or gen != b.gen:
            return  # completion superseded by a straggler re-issue
        del self._inflight[bid]
        st = self.pools[b.pool]
        self._ver += 1
        for replica in (b.replica, b.twin):
            if replica is None:
                continue
            st.busy_until[replica] = now
            # a replica that failed mid-batch rejoins only on recovery
            if replica not in st.failed:
                st.free.append(replica)
        # every member of a batch shares (arm, segment) — the BatchKey
        # invariant — so the batch either hops or completes as a whole and
        # per-arm quantities hoist out of the item loop
        items = b.items
        if items:
            trace = self.rt.trace
            tracer = self.tracer
            first = items[0]
            arm_idx = first.arm_idx
            plan = self._plan[arm_idx]
            if plan is not None:
                self._graph_batch_done(b, items, plan, now)
                self._dispatch(b.pool, now)
                return
            if first.seg_idx < len(self._seg_info[arm_idx]) - 1:
                # hop: the latents ship to the next segment's pool
                fam = self.arms[arm_idx].family
                nbytes = self.transport.wire_bytes(fam)
                wire_s = self._wire_s[arm_idx]
                compress = self.transport.cfg.compress
                self.telemetry.record_transfer(
                    b.pool, nbytes, n_items=len(items)
                )
                push = self.evq.push
                for it in items:
                    tsec = it.req.rtt_ms / 1000.0 + wire_s
                    if trace:
                        tracer.end_segment(it.rid, now)
                        tracer.hop(
                            it.rid, it.seg_idx, now, now + tsec, nbytes,
                            compressed=compress, pool=b.pool,
                        )
                    push(now + tsec, DEVICE_READY, it)
            else:
                penalty = self._q_penalty[arm_idx]
                occ_keys = self._occ_keys[arm_idx]
                policy, score = self.policy, self._score
                dyn, arms = self.dynamic_reward, self.arms
                Record, records = self._Record, self.records
                pending, qt = self.pending, self.qt
                for it in items:
                    rid = it.rid
                    if trace:
                        tracer.end_segment(rid, now)
                    pend = pending.pop(rid)
                    t_total = now - pend.req.arrival
                    q = qt[pend.req.rid, pend.arm_idx]
                    if penalty is not None:
                        q = dict(q)
                        for k in ("clip", "ir"):
                            if k in q:
                                q[k] = q[k] - penalty
                    occ = pend.occ
                    l_dev = max(occ[k] for k in occ_keys)
                    r_report = score(
                        policy, pend.arm_idx, pend.ctx, q, t_total, l_dev,
                        dynamic_reward=dyn, arms=arms,
                    )
                    if trace:
                        tracer.end_request(rid, now)
                    # clamp: ideal_s uses unjittered step costs, so a lone
                    # batch with jitter < 1 could otherwise report a
                    # (nonsensical) negative wait
                    records.append(Record(
                        pend.req.rid, pend.arm_idx, r_report, t_total, q,
                        pend.ctx, max(0.0, t_total - pend.ideal_s),
                    ))
        self._dispatch(b.pool, now)

    def _on_segment_ready(self, payload, now: float) -> None:
        """A hop's latent transfer landed: enqueue the next segment.
        Linear arms carry the *previous* segment's item (the next one is
        implied); DAG edges carry ``(next item, src nid)`` tuples so the
        landing knows which graph edge it traversed."""
        if isinstance(payload, tuple):
            self._graph_ready(*payload, now=now)
            return
        prev_item = payload
        item = self._item(prev_item.req, prev_item.arm_idx,
                          prev_item.seg_idx + 1)
        if self.rt.trace:
            self.tracer.enqueue(item.rid, item.phase, now)
        self.pools[item.pool].agg.push(item, now)
        self._dispatch(item.pool, now)

    # ------------------------------------------------------------------
    # DAG (RelayGraph) arm execution
    # ------------------------------------------------------------------

    def _graph_batch_done(self, b: _Batch, items: List[WorkItem], plan,
                          now: float) -> None:
        """Per-item tail of a DAG arm's batch: close spans, record gate
        completions, fan the latent out along live successor edges.  A
        batch can mix members of still-pending and already-completed
        requests (a rejected speculation's branch finishing after its
        reference resolved the select), so each item re-checks its own
        DAG state."""
        trace = self.rt.trace
        tracer = self.tracer
        arm_idx = items[0].arm_idx
        gate_map = self._gate_map[arm_idx]
        for it in items:
            nid = plan.order[it.seg_idx]
            if trace:
                tracer.end_segment(it.rid, now, name=nid)
            st = self._dag.get(it.rid)
            if st is None:
                continue  # request completed while this branch ran
            sel_nid = gate_map.get(nid)
            if sel_nid is not None:
                # the gate's completion is the select's decision instant
                st.gates[sel_nid] = now
                self._try_join(it, plan, st, sel_nid, now)
                if it.rid not in self._dag:
                    continue  # the join resolved and completed the request
            self._graph_fanout(it, plan, st, nid, now)

    def _graph_fanout(self, it: WorkItem, plan, st: _DagReq, nid: str,
                      now: float) -> None:
        """Ship node ``nid``'s output along its live (non-cancelled)
        successor edges: handoff edges pay RTT + wire serialization and
        emit hop spans; plain edges (same-pool continuation, join inputs)
        land immediately."""
        arm_idx = it.arm_idx
        node = plan.nodes[plan.index[nid]]
        live = [e for e in plan.succs[nid] if e.dst not in st.skip]
        trace = self.rt.trace
        if trace and len(live) > 1:
            self.tracer.branch_point(it.rid, nid, now, tuple(
                plan.nodes[plan.index[e.dst]].branch or e.dst for e in live
            ))
        wire_s = self._wire_s[arm_idx]
        compress = self.transport.cfg.compress
        src_pool = node.segment.pool if node.kind == SEGMENT_NODE else None
        push = self.evq.push
        for e in live:
            if e.handoff is not None:
                tsec = it.req.rtt_ms / 1000.0 + wire_s
                nbytes = self.transport.wire_bytes(self.arms[arm_idx].family)
                if src_pool is not None:
                    self.telemetry.record_transfer(src_pool, nbytes,
                                                   n_items=1)
                if trace:
                    dst = plan.nodes[plan.index[e.dst]]
                    self.tracer.hop(
                        it.rid, f":{nid}->{e.dst}", now, now + tsec, nbytes,
                        compressed=compress, pool=src_pool,
                        branch=dst.branch or node.branch,
                    )
            else:
                tsec = 0.0
            nxt = self._item(it.req, arm_idx, plan.index[e.dst])
            push(now + tsec, DEVICE_READY, (nxt, nid))

    def _graph_ready(self, item: WorkItem, src: str, *, now: float) -> None:
        """A DAG edge landed: enqueue a segment node's work item, or
        record a join input and try to resolve the join."""
        st = self._dag.get(item.rid)
        if st is None:
            return  # request completed while the latent was in flight
        plan = self._plan[item.arm_idx]
        node = plan.nodes[item.seg_idx]
        if node.kind == SEGMENT_NODE:
            if self.rt.trace:
                self.tracer.enqueue(item.rid, node.nid, now,
                                    branch=node.branch)
            self.pools[item.pool].agg.push(item, now)
            self._dispatch(item.pool, now)
            return
        st.joins.setdefault(node.nid, {})[src] = now
        self._try_join(item, plan, st, node.nid, now)

    def _try_join(self, it: WorkItem, plan, st: _DagReq, nid: str,
                  now: float) -> None:
        """Resolve a join node once its required inputs are in.

        Merge: every live predecessor's latent must have arrived —
        completion is the slower branch (this event).  Select: an accepted
        speculation needs the candidate latent *and* the gate's decision
        (completion is the later of the two); a rejection needs only the
        reference latent — the candidate branch is ignored on arrival,
        exactly like the sequential engine.  Resolution always happens at
        ``now`` (the last required input is the event being handled)."""
        node = plan.nodes[plan.index[nid]]
        arr = st.joins.get(nid, {})
        trace = self.rt.trace
        if node.kind == MERGE_NODE:
            need = [e.src for e in plan.preds[nid] if e.src not in st.skip]
            if any(s not in arr for s in need):
                return
            winner = max(need, key=lambda s: (arr[s], s))
            t0 = arr[winner]
            if trace:
                for s in need:
                    b = plan.nodes[plan.index[s]].branch
                    if s != winner and b:
                        self.tracer.mark_offpath(it.rid, b)
                self.tracer.join(
                    it.rid, nid, t0, now, kind="merge",
                    winner=plan.nodes[plan.index[winner]].branch or winner,
                    inputs=sorted(arr),
                )
        else:  # SELECT_NODE
            sel = plan.selects[nid]
            accepted, dev, bound = st.decisions[nid]
            cand = sel.candidates[0]
            if accepted:
                if cand not in arr or nid not in st.gates:
                    return
                arrival = arr[cand]
                winner, loser = cand, sel.reference
            else:
                if sel.reference not in arr:
                    return
                arrival = arr[sel.reference]
                winner, loser = sel.reference, cand
            if trace:
                b_lose = plan.nodes[plan.index[loser]].branch
                if b_lose:
                    self.tracer.mark_offpath(it.rid, b_lose)
                self.tracer.join(
                    it.rid, nid, arrival, now, kind="select",
                    accepted=accepted, deviation_pct=dev, bound_pct=bound,
                    winner=plan.nodes[plan.index[winner]].branch or winner,
                )
        if nid == plan.sink:
            self._graph_complete(it, plan, st, now)
        else:
            self._graph_fanout(it, plan, st, nid, now)

    def _graph_complete(self, it: WorkItem, plan, st: _DagReq,
                        now: float) -> None:
        """Emit the Record of a finished DAG request — the linear
        completion tail with the shared graph quality pricing."""
        rid = it.rid
        del self._dag[rid]
        pend = self.pending.pop(rid)
        t_total = now - pend.req.arrival
        q = self._graph_quality(
            self.transport, plan, self.arms[pend.arm_idx], st.decisions,
            st.base_pct, self.qt[pend.req.rid, pend.arm_idx],
        )
        occ = pend.occ
        l_dev = max(occ[k] for k in self._occ_keys[pend.arm_idx])
        r_report = self._score(
            self.policy, pend.arm_idx, pend.ctx, q, t_total, l_dev,
            dynamic_reward=self.dynamic_reward, arms=self.arms,
        )
        if self.rt.trace:
            self.tracer.end_request(rid, now)
        self.records.append(self._Record(
            pend.req.rid, pend.arm_idx, r_report, t_total, q, pend.ctx,
            max(0.0, t_total - pend.ideal_s),
        ))
