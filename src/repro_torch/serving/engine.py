"""Multi-tenant serving engine (paper Alg. 2 runtime; port of
``repro/serving/engine.py``): Poisson arrivals, pool/replica queueing, arm
filtering by availability, reward computation and online LinUCB updates.

Arms are relay-program templates (``repro_torch.serving.arms``): both
runtimes fold each request through its program's segments, holding every
replica pool only for the duration of its own segment — an N-hop cascade
occupies three pools in sequence, never simultaneously.  Hop transfers
are priced through the :class:`HandoffTransport`, so compressed-handoff
latency (and its measured quality delta) is modeled when a
``RuntimeConfig`` is supplied.  ``runtime="continuous"`` (the default)
serves through the discrete-event continuous-batching runtime
(:class:`repro_torch.serving.runtime.engine.ContinuousRuntime`);
``runtime="sequential"`` is the paper-faithful blocking loop below.

Everything here is host numpy on the simulated clock: the engine reads the
quality table and never runs a latent.  Two things touch a device: the
policy (on the device its caller built it on) and the transport, whose
first compressed ``handoff_error`` of a family runs one int8 round trip
(a ``quant_int8`` and a ``dequant_int8`` launch on the card) on the
engine's device.

Also provides the fault-tolerance hooks: replica failure injection with
pool failover, and straggler re-issue.  A re-issue is priced as the
reference prices it (``latency.reissue_latency`` here; in the continuous
runtime ``_straggler_plan``'s sub-batch at its own bucket: the straggler
re-run alone).  The port's executor pays more on the card:
``Executor.generate_bucketed(subset=)`` re-runs the straggler's whole
bucket and slices it, so that the re-run keeps its rows' bits
(``serving/executor.py``).  At the relay's 8x8x4 latents that path is
bound by kernel launches, so the two costs are close.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.context import Request, context_vector
from repro_torch.core.policies import Policy
from repro_torch.core.program import (MERGE_NODE, SEGMENT_NODE,
                                      SELECT_NODE, RelayGraph, compile_plan,
                                      phase_name, select_outcome)
from repro_torch.core.reward import RewardInputs, compute_reward
from repro_torch.device import resolve_device
from repro_torch.serving import latency as lat
from repro_torch.serving.arms import ARMS, N_ARMS, Arm, pools_used
from repro_torch.serving.context import (aggregate_occupancy,
                                         backlog_horizon, failure_schedule,
                                         fallback_avail, partition_stragglers,
                                         pool_inventory, pool_key,
                                         straggler_mode, telemetry_features)
from repro_torch.serving.obs.tracer import SpanTracer
from repro_torch.serving.runtime.telemetry import FaultCounters
from repro_torch.serving.runtime.transport import (HandoffTransport,
                                                   TransportConfig)


@dataclass
class SimConfig:
    """Workload + fault-injection knobs shared by both serving runtimes.

    Times are seconds of *simulated* clock throughout.  A SimConfig plus a
    seed fully determines a run: arrivals, straggler draws and service
    jitter all derive from ``seed`` (see ``repro_torch.serving.context``
    for the request-intrinsic draws), so identical configs replay
    bit-identically.
    """

    n_requests: int = 300
    mean_interarrival: float = 9.0  # paper: Poisson with μ = 9 s
    seed: int = 0
    max_queue: int = 4  # arm unavailable past this backlog per replica pool
    fail_replica: Optional[tuple] = None  # (pool, replica_idx, t_fail, t_recover)
    straggler_factor: float = 1.0  # >1 → random slowdowns; engine re-issues
    straggler_prob: float = 0.0
    straggler_reissue: float = 2.5  # re-issue if slower than this × expected
    # mitigation mode (serving.context.STRAGGLER_MODES): "item" re-runs only
    # the straggling samples of a lagging micro-batch on the twin replica
    # (partial-batch re-execution, the default); "batch" re-issues the whole
    # micro-batch, taxing healthy co-batched requests with the full cap
    straggler_mode: str = "item"
    # append live runtime telemetry (queue depth, batch occupancy) to the
    # LinUCB context vector — size policies with serving.context.context_dim
    telemetry_context: bool = False
    # per-pool replica counts overriding serving.arms.POOL_REPLICAS — the
    # fleet's heterogeneous-cluster seam (serving.context.pool_inventory).
    # None (the default) keeps the testbed inventory and the bit-identical
    # single-cluster golden path.
    pool_replicas: Optional[Dict[str, int]] = None


def make_requests(cfg: SimConfig, seed0: int = 0) -> List[Request]:
    """Draw the Poisson request stream of a SimConfig.

    Deterministic in ``cfg.seed``: arrivals (exponential interarrivals of
    mean ``cfg.mean_interarrival`` seconds), per-request complexity/RTT/
    battery/preference draws and the ``wants_text`` flag all come from one
    ``default_rng(cfg.seed)`` stream, so the same config always yields the
    same workload.  ``seed0`` offsets the prompt seeds (quality-table
    rows), letting train/test workloads share arrival statistics without
    sharing prompts."""
    rng = np.random.default_rng(cfg.seed)
    t = 0.0
    out = []
    for i in range(cfg.n_requests):
        t += rng.exponential(cfg.mean_interarrival)
        out.append(
            Request(
                rid=i,
                arrival=t,
                complexity=float(rng.uniform()),
                wants_text=bool(rng.uniform() < 0.35),
                rtt_ms=float(rng.lognormal(np.log(80), 0.6)),
                battery=float(rng.uniform()),
                pref_speed=float(rng.uniform()),
                prompt_seed=seed0 + i,
            )
        )
    return out


class Pools:
    """Replica free-time tracking + failure injection.

    Outages come from ``serving.context.failure_schedule`` — a single
    ``fail_replica`` tuple or a sequence of them (overlapping outages may
    kill every replica of a pool; see :meth:`n_alive`)."""

    def __init__(self, cfg: SimConfig):
        self.inventory = pool_inventory(cfg)
        self.free_at: Dict[str, List[float]] = {
            p: [0.0] * n for p, n in self.inventory.items()
        }
        self.cfg = cfg
        self.schedule = failure_schedule(cfg)

    def _replicas(self, pool: str, now: float):
        reps = list(enumerate(self.free_at[pool]))
        dead = {
            i for p, i, t_fail, t_rec in self.schedule
            if p == pool and t_fail <= now < t_rec
        }
        if dead:
            reps = [r for r in reps if r[0] not in dead]  # failover
        return reps

    def n_alive(self, pool: str, now: float) -> int:
        """Replicas of ``pool`` not inside an injected outage at ``now``."""
        return len(self._replicas(pool, now))

    def occupancy(self, pool: str, now: float) -> float:
        """Fraction of live replicas busy at ``now`` (1.0 for a dead pool)."""
        reps = self._replicas(pool, now)
        if not reps:
            return 1.0
        return float(np.mean([t > now for _, t in reps]))

    def backlog(self, pool: str, now: float) -> float:
        """Seconds until the earliest live replica frees up (inf if the
        pool has no live replicas) — the availability-mask signal."""
        reps = self._replicas(pool, now)
        if not reps:
            return np.inf
        return min(max(0.0, t - now) for _, t in reps)

    def acquire(self, pool: str, ready: float, duration: float) -> float:
        """Run a phase of `duration` on the earliest-available replica;
        returns completion time."""
        reps = self._replicas(pool, ready)
        if not reps:  # total pool outage: wait for the earliest recovery
            t_rec, idx = min(
                (t_rec, i) for p, i, t_fail, t_rec in self.schedule
                if p == pool and t_fail <= ready < t_rec
            )
            start = t_rec
        else:
            idx, free = min(reps, key=lambda r: r[1])
            start = max(ready, free)
        done = start + duration
        self.free_at[pool][idx] = done
        return done


@dataclass
class Record:
    """One served request's outcome — the currency every benchmark and
    parity suite consumes.  ``t_total``/``wait_s`` are simulated seconds
    (arrival → completion, and time beyond the zero-queue ideal).  On an
    uncompressed run the Records equal the reference engine's bit for bit
    (``tests/test_torch_engine.py``)."""

    rid: int
    arm: int
    reward: float
    t_total: float
    quality: dict
    ctx: np.ndarray
    wait_s: float


def score_and_update(policy, arm_idx: int, ctx: np.ndarray, quality: dict,
                     t_total: float, l_dev: float,
                     dynamic_reward: bool = True, arms=None) -> float:
    """Reward computation + policy update, shared by the sequential engine
    and the continuous runtime so their Records stay bit-compatible.

    The ablation flag changes only the LEARNING signal; reported rewards
    always use the full dynamic shaping so variants are comparable
    (Table IV protocol).  Returns the reported reward."""
    arm = (arms if arms is not None else ARMS)[arm_idx]
    ri = RewardInputs(
        quality=quality, t_total=t_total, m_vram=lat.arm_vram(arm),
        l_dev=l_dev, c_txt=ctx[1], c_pref=ctx[4], c_bat=ctx[3],
    )
    r_learn = compute_reward(ri, dynamic=dynamic_reward)
    r_report = r_learn if dynamic_reward else compute_reward(ri, dynamic=True)
    policy.update(ctx, arm_idx, r_learn)
    return r_report


class ServingEngine:
    """Single-cluster serving front end: owns the policy, quality table and
    SimConfig, and executes the workload on one of the two interchangeable
    runtimes (continuous-batching by default, sequential as the explicit
    paper-faithful fallback).  Deterministic in ``cfg.seed`` — see
    :meth:`run`."""

    def __init__(self, policy: Policy, quality_table, cfg: SimConfig,
                 executor=None, seed0: int = 0, dynamic_reward: bool = True,
                 runtime: str = "continuous", runtime_cfg=None,
                 arms: Optional[Sequence[Arm]] = None, device=None):
        """quality_table[i, arm] → dict of quality metrics for request i.

        ``runtime="continuous"`` (the default) delegates to the
        discrete-event continuous-batching runtime
        (``repro_torch.serving.runtime``) with micro-batch aggregation,
        compressed latent handoff and the full fault-injection model
        (replica failure + straggler re-issue).  ``runtime="sequential"``
        is the explicit fallback: the paper-faithful blocking per-request
        loop.  Records, fault counters and ``summarize()`` are
        interchangeable (sort records by ``rid`` to compare).

        ``runtime_cfg`` (a ``RuntimeConfig``) configures the continuous
        runtime (``None``: its defaults, compressed) and the sequential
        engine's handoff transport — compressed hop pricing and its
        quality delta; without it the sequential engine prices hops
        uncompressed (the reference's legacy behavior) and reads none of
        its other fields.

        ``arms`` swaps the action space (defaults to the paper's 11-arm
        space) — e.g. ``repro_torch.serving.arms.cascade_action_space()``.

        ``device`` is the transport's, in either runtime: the card unless
        the caller passes ``"cpu"`` (raises when CUDA is absent).
        ``executor`` is stored and passed on, not used: both runtimes read
        ``quality_table`` instead of running a latent."""
        self.policy = policy
        self.qt = quality_table
        self.cfg = cfg
        self.executor = executor
        self.rng = np.random.default_rng(cfg.seed + 17)
        self.dynamic_reward = dynamic_reward
        if runtime not in ("sequential", "continuous"):
            raise ValueError(f"unknown runtime {runtime!r}")
        self.runtime = runtime
        self.runtime_cfg = runtime_cfg
        self.arms = tuple(arms) if arms is not None else ARMS
        policy_arms = getattr(policy, "arms", None)
        if policy_arms is not None and len(policy_arms) != len(self.arms):
            raise ValueError(
                f"policy sized for {len(policy_arms)} arms but the engine's "
                f"action space has {len(self.arms)} — pass the same arms= to "
                f"both"
            )
        self.device = resolve_device(device)
        self.transport = (
            HandoffTransport.for_runtime(runtime_cfg, device=self.device)
            if runtime_cfg is not None
            else HandoffTransport(TransportConfig(compress=False),
                                  device=self.device)
        )
        self.telemetry = None  # populated by the continuous runtime
        self.tracer = SpanTracer()  # structured spans (both runtimes)
        self.trace = {}  # per-request phase timestamps (legacy dict view)
        self.fault_counters = FaultCounters()

    @property
    def n_arms(self) -> int:
        """Size of the engine's action space (arm histograms size to it)."""
        return len(self.arms)

    def _occupancies(self, pools: Pools, now: float) -> dict:
        """Grouped occupancy features of every pool at ``now`` (the context
        vector's three load dims; ``serving.context.aggregate_occupancy``)."""
        return aggregate_occupancy(
            {p: pools.occupancy(p, now) for p in pools.inventory}
        )

    def _avail(self, pools: Pools, now: float) -> np.ndarray:
        out = np.zeros(self.n_arms, bool)
        horizon = backlog_horizon(self.cfg)
        for a in self.arms:
            out[a.idx] = all(
                pools.backlog(p, now) < horizon for p in pools_used(a)
            )
        return out

    def _ctx_extra(self, pools: Pools, now: float):
        """Sequential-runtime analog of the live telemetry features: mean
        normalized backlog as queue depth; batch occupancy is 1.0 (every
        dispatch is a singleton batch — no padded slots)."""
        if not self.cfg.telemetry_context:
            return None
        horizon = backlog_horizon(self.cfg)
        qd = float(np.mean([
            min(pools.backlog(p, now), horizon) for p in pools.inventory
        ])) / horizon
        return telemetry_features(qd, 1.0)

    def run(self, requests: List[Request]) -> List[Record]:
        """Serve ``requests`` to completion; returns one Record each.

        Fully deterministic for a given ``(cfg, requests, policy seed)``:
        service jitter comes from ``default_rng(cfg.seed + 17)``, straggler
        draws are request-intrinsic, and the continuous runtime's event
        heap breaks time ties by insertion order.  Record order is
        completion order under the continuous runtime and arrival order
        under the sequential one — sort by ``rid`` to compare."""
        if self.runtime == "continuous":
            from repro_torch.serving.runtime.engine import ContinuousRuntime

            rt = ContinuousRuntime(
                self.policy, self.qt, self.cfg, self.runtime_cfg,
                executor=self.executor, dynamic_reward=self.dynamic_reward,
                arms=self.arms, device=self.device,
            )
            records = rt.run(requests)
            self.telemetry = rt.telemetry
            self.tracer = rt.tracer
            self.trace = rt.trace
            self.fault_counters = rt.fault_counters
            return records
        pools = Pools(self.cfg)
        per_item = straggler_mode(self.cfg) == "item"  # validates the mode
        tracer = self.tracer = SpanTracer()
        fc = self.fault_counters = FaultCounters()
        for _pool, _idx, _t_fail, t_rec in failure_schedule(self.cfg):
            fc.replica_failures += 1
            if np.isfinite(t_rec):
                fc.replica_recoveries += 1
        records = []
        pending = sorted(requests, key=lambda r: r.arrival)
        for req in pending:
            now = req.arrival
            occ = self._occupancies(pools, now)
            ctx = context_vector(req, occ, self._ctx_extra(pools, now))
            avail = self._avail(pools, now)
            if not avail.any():
                # everything congested: enqueue anyway — but never onto an
                # arm routing through a pool with zero live replicas (its
                # request would block until a recovery that may never come)
                avail = fallback_avail(
                    self.arms,
                    {p: pools.n_alive(p, now) for p in pools.inventory},
                )
            arm_idx = self.policy.select(ctx, avail)
            arm = self.arms[arm_idx]
            prog = arm.program

            if isinstance(prog, RelayGraph):
                records.append(self._run_graph_request(
                    req, arm_idx, arm, pools, occ, ctx, tracer, fc, per_item
                ))
                continue

            lb = lat.program_latency(
                prog, req.rtt_ms, rng=self.rng,
                compressed=self.transport.cfg.compress,
                bw_mbps=self.transport.cfg.bw_mbps,
            )
            seg_durs = list(lb.segment_s)

            # straggler injection + mitigation: this engine's batches are
            # singletons, so per-item and whole-batch re-issue coincide —
            # detection at (reissue−1)× plus one singleton re-run lands at
            # the reissue× cap (lat.reissue_latency).  The split comes from
            # the same shared partition the continuous runtime uses on its
            # micro-batches, so fault counters match it for the same
            # workload in either mitigation mode.  Stragglers hit the
            # first (edge) segment of relay programs only.  The price is
            # the reference's, not the card executor's (module docstring).
            kept_slow, tripped, draws = partition_stragglers(
                self.cfg, [req.rid]
            )
            nominal_edge = seg_durs[0]  # pre-straggler, for the marker time
            if prog.is_relay:
                if tripped:
                    seg_durs[0] = lat.reissue_latency(
                        seg_durs[0], self.cfg.straggler_reissue
                    )
                else:
                    seg_durs[0] = seg_durs[0] * kept_slow
                if draws[req.rid] > 1.0:
                    fc.note_straggler(bool(tripped), per_item=per_item)

            # segment-level pool holds: each pool is occupied only for the
            # duration of its own segment; hops add wire latency between
            tracer.start_request(req.rid, now, arm_idx, arm.label)
            nbytes = self.transport.wire_bytes(arm.family)
            ready = now
            done = now
            for k, seg in enumerate(prog.segments):
                done = pools.acquire(seg.pool, ready, seg_durs[k])
                start = done - seg_durs[k]
                name = phase_name(prog, k)
                tracer.enqueue(req.rid, name, ready)
                tracer.start_segment(req.rid, name, start, seg.pool,
                                     n_items=1, bucket=1, seg_idx=k)
                tracer.end_segment(req.rid, done)
                if k == 0 and prog.is_relay and tripped:
                    # detector trips once the edge exceeds (reissue−1)× its
                    # nominal service time — the singleton-batch analog of
                    # the continuous runtime's detection event
                    tracer.reissue(
                        req.rid,
                        start + nominal_edge
                        * max(self.cfg.straggler_reissue - 1.0, 0.0),
                        partial=per_item,
                    )
                if k < prog.n_hops:
                    tracer.hop(req.rid, k, done, done + lb.hop_s[k],
                               nbytes, compressed=self.transport.cfg.compress,
                               pool=seg.pool)
                ready = done + (lb.hop_s[k] if k < prog.n_hops else 0.0)
            tracer.end_request(req.rid, done)
            t_total = done - req.arrival
            wait = t_total - lb.total

            q = self.transport.quality_delta(
                arm.family, self.qt[req.rid, arm_idx], n_hops=arm.n_hops
            )
            l_dev = max(occ[pool_key(p)] for p in pools_used(arm))
            r_report = score_and_update(
                self.policy, arm_idx, ctx, q, t_total, l_dev,
                dynamic_reward=self.dynamic_reward, arms=self.arms,
            )
            records.append(
                Record(req.rid, arm_idx, r_report, t_total, q, ctx, wait)
            )
        self.trace = tracer.legacy_view()
        return records

    def _run_graph_request(self, req: Request, arm_idx: int, arm: Arm,
                           pools: Pools, occ: dict, ctx: np.ndarray,
                           tracer: SpanTracer, fc: FaultCounters,
                           per_item: bool) -> Record:
        """Serve one request whose arm is a DAG program (RelayGraph).

        The canonical-order walk generalizes the linear loop: each segment
        node is ready at the max over its live predecessors' arrival times
        and holds its pool for its own jittered duration; Merge resolves at
        the slower branch; Select resolves at its gate's completion via the
        shared :func:`repro_torch.core.program.select_outcome` decision
        (pure in request + plan + transport, so the continuous runtime
        replays it identically).  Accepted selects cancel the plan's
        ``skip_on_accept`` nodes — they never acquire a pool and emit no
        spans, in either engine.  Jitter draws happen in canonical node
        order from the same ``cfg.seed + 17`` stream the linear path uses."""
        prog = arm.program
        plan = compile_plan(prog)
        tcfg = self.transport.cfg
        node_s = lat.graph_node_seconds(plan, rng=self.rng)
        hop_s = lat.graph_hop_seconds(
            plan, req.rtt_ms, bw_mbps=tcfg.bw_mbps, compressed=tcfg.compress
        )
        # zero-queue baseline at this request's jittered costs, pre-straggler
        # (the linear path's `lb.total` analog) — clamped below because an
        # accepted speculation can legitimately beat the reference critical
        # path that the baseline prices
        ideal = lat.graph_critical_seconds(plan, node_s, hop_s)
        now = req.arrival

        base_pct = self.transport.handoff_error(prog.family) * 100.0
        decisions = {
            nid: select_outcome(plan, nid, req.complexity, base_pct)
            for nid in plan.selects
        }
        skip: set = set()
        for nid, (accepted, _, _) in decisions.items():
            if accepted:
                skip |= plan.selects[nid].skip_on_accept

        # straggler injection hits the root (edge) node only — the same
        # request-intrinsic partition and re-issue arithmetic as the linear
        # path's first segment
        kept_slow, tripped, draws = partition_stragglers(self.cfg, [req.rid])
        src = plan.source
        nominal_root = node_s[src]
        if prog.is_relay:
            if tripped:
                node_s[src] = lat.reissue_latency(
                    node_s[src], self.cfg.straggler_reissue
                )
            else:
                node_s[src] = node_s[src] * kept_slow
            if draws[req.rid] > 1.0:
                fc.note_straggler(bool(tripped), per_item=per_item)

        tracer.start_request(req.rid, now, arm_idx, arm.label)
        nbytes = self.transport.wire_bytes(arm.family)
        done: Dict[str, float] = {}
        for ni, node in enumerate(plan.nodes):
            nid = node.nid
            if nid in skip:
                continue
            live_preds = [e for e in plan.preds[nid] if e.src not in skip]
            if node.kind == SEGMENT_NODE:
                ready = now
                for e in live_preds:
                    ready = max(ready, done[e.src] + hop_s[(e.src, e.dst)])
                t_done = pools.acquire(node.segment.pool, ready, node_s[nid])
                start = t_done - node_s[nid]
                tracer.enqueue(req.rid, nid, ready, branch=node.branch)
                tracer.start_segment(req.rid, nid, start, node.segment.pool,
                                     n_items=1, bucket=1, seg_idx=ni,
                                     branch=node.branch)
                tracer.end_segment(req.rid, t_done, name=nid)
                if nid == src and prog.is_relay and tripped:
                    tracer.reissue(
                        req.rid,
                        start + nominal_root
                        * max(self.cfg.straggler_reissue - 1.0, 0.0),
                        partial=per_item,
                    )
                done[nid] = t_done
                live_succ = [e for e in plan.succs[nid] if e.dst not in skip]
                if len(live_succ) > 1:
                    branches = tuple(
                        plan.nodes[plan.index[e.dst]].branch or e.dst
                        for e in live_succ
                    )
                    tracer.branch_point(req.rid, nid, t_done, branches)
                for e in live_succ:
                    if e.handoff is not None:
                        dst = plan.nodes[plan.index[e.dst]]
                        tracer.hop(
                            req.rid, f":{nid}->{e.dst}", t_done,
                            t_done + hop_s[(nid, e.dst)], nbytes,
                            compressed=tcfg.compress,
                            pool=node.segment.pool,
                            branch=dst.branch or node.branch,
                        )
            elif node.kind == MERGE_NODE:
                arrive = {
                    e.src: done[e.src] + hop_s[(e.src, e.dst)]
                    for e in live_preds
                }
                winner = max(arrive, key=lambda s: (arrive[s], s))
                t_done = arrive[winner]
                for e in live_preds:
                    b = plan.nodes[plan.index[e.src]].branch
                    if e.src != winner and b:
                        tracer.mark_offpath(req.rid, b)
                tracer.join(
                    req.rid, nid, t_done, t_done, kind="merge",
                    winner=plan.nodes[plan.index[winner]].branch or winner,
                    inputs=sorted(arrive),
                )
                done[nid] = t_done
            else:  # SELECT_NODE
                sel = plan.selects[nid]
                accepted, dev, bound = decisions[nid]
                cand = sel.candidates[0]
                winner = cand if accepted else sel.reference
                loser = sel.reference if accepted else cand
                arrival = done[winner] + hop_s[(winner, nid)]
                decision_t = (
                    done[sel.gate] if sel.gate is not None and accepted
                    else arrival
                )
                t_done = max(arrival, decision_t)
                b_lose = plan.nodes[plan.index[loser]].branch
                if b_lose:
                    tracer.mark_offpath(req.rid, b_lose)
                tracer.join(
                    req.rid, nid, arrival, t_done, kind="select",
                    accepted=accepted, deviation_pct=dev, bound_pct=bound,
                    winner=plan.nodes[plan.index[winner]].branch or winner,
                )
                done[nid] = t_done
        t_done = done[plan.sink]
        tracer.end_request(req.rid, t_done)
        t_total = t_done - req.arrival
        wait = max(0.0, t_total - ideal)

        q = graph_quality(self.transport, plan, arm, decisions, base_pct,
                          self.qt[req.rid, arm_idx])
        l_dev = max(occ[pool_key(p)] for p in pools_used(arm))
        r_report = score_and_update(
            self.policy, arm_idx, ctx, q, t_total, l_dev,
            dynamic_reward=self.dynamic_reward, arms=self.arms,
        )
        return Record(req.rid, arm_idx, r_report, t_total, q, ctx, wait)


def graph_quality(transport: HandoffTransport, plan, arm: Arm,
                  decisions: dict, base_pct: float, q0: dict) -> dict:
    """Quality delta of a DAG program's surviving path — shared by both
    serving runtimes so their Records agree for identical decisions.

    Select sink: the surviving handoff's Eq. 1 deviation prices the
    penalty — an accepted speculation carries its modeled (decayed)
    post-verification deviation, a rejected one degenerates to the fixed
    arm's single-hop wire constant.  Merge sink: one-hop charge — latent
    averaging attenuates the branches' independent quantization noise
    rather than stacking it.  Segment sink (generic DAG): the linear rule,
    once per compressed hop."""
    sink = plan.nodes[plan.index[plan.sink]]
    if sink.kind == SELECT_NODE:
        accepted, dev, _ = decisions[plan.sink]
        dev_used = dev if accepted else base_pct
        return transport.deviation_quality_delta(arm.family, q0, dev_used)
    if sink.kind == MERGE_NODE:
        return transport.quality_delta(arm.family, q0, n_hops=1)
    return transport.quality_delta(arm.family, q0, n_hops=arm.n_hops)


def _pool_key(pool: str) -> str:
    return pool_key(pool)


def _static_plan(arm):
    """Legacy helper: the two-hop plan view an arm's program carries."""
    return arm.plan


def summarize(records: List[Record], n_arms: Optional[int] = None) -> dict:
    """``n_arms`` sizes the arm histogram (pass the action-space length for
    non-default spaces so histograms align across runs; defaults to the
    Table II width)."""
    qs = [r.quality for r in records]
    arr = lambda k: np.array([q[k] for q in qs])
    # gate on the request's wants_text flag (ctx[1]), not on ocr > 0: a text
    # request whose generation renders no legible text scores ocr == 0.0 and
    # must still count toward the OCR aggregate
    has_text = np.array([r.ctx[1] > 0.5 for r in records])
    rewards = np.array([r.reward for r in records])
    # decomposed rewards (quality / time) for the Fig. 6 style comparison
    t = np.array([r.t_total for r in records])
    return {
        "total_reward": float(np.mean(rewards)),
        "quality_reward": float(
            np.mean([_quality_part(r) for r in records])
        ),
        "time_reward": float(np.mean(-0.35 * t)),
        "mean_latency_s": float(np.mean(t)),
        "p95_latency_s": float(np.percentile(t, 95)),
        "clip": float(np.mean(arr("clip"))),
        "ir": float(np.mean(arr("ir"))),
        "pick": float(np.mean(arr("pick"))),
        "aes": float(np.mean(arr("aes"))),
        "ocr": float(np.mean(arr("ocr")[has_text])) if has_text.any() else 0.0,
        "text_fraction": float(np.mean(has_text)),
        "arm_histogram": np.bincount(
            [r.arm for r in records], minlength=n_arms or N_ARMS
        ).tolist(),
    }


def _quality_part(rec: Record) -> float:
    from repro_torch.core.reward import dynamic_weights

    w, _, _, _ = dynamic_weights(rec.ctx[1], rec.ctx[4], rec.ctx[3])
    return sum(w[k] * rec.quality.get(k, 0.0) for k in w)
