"""Structured per-request span tracing keyed to the RelayProgram IR (a copy
of ``repro/serving/obs/tracer.py``: plain Python, no tensors).

One request's execution becomes an ordered list of :class:`Span` objects
that *tile* the interval from arrival to completion with no gaps:

  queue:edge → edge → hop0 → queue:device → device          (2-hop relay)
  queue:edge → edge → hop0 → queue:mid1 → mid1 → hop1 → …   (N-hop cascade)

* ``queue:<seg>`` — time the segment's work item sat in the micro-batch
  aggregator (or, in the sequential engine, waited for a free replica);
* ``<seg>`` — the segment's service span, annotated with pool, replica,
  batch id, bucket and batch membership;
* ``hop<k>`` — the inter-segment latent transfer, annotated with wire
  bytes and compression;
* zero-length ``reissue`` markers record the straggler detector tripping
  on a request whose own draw exceeded the re-issue threshold (the same
  request-intrinsic criterion the fault counters use, so marker sets are
  parity-comparable across runtimes).

Because the spans tile the request's lifetime, per-segment attribution
sums to the request's ``t_total`` exactly (``stats.attribution_residual``).

Every timestamp is the *simulated* clock.  The tracer never draws random
numbers, never advances time and touches no tensor — tracing on vs off
is bit-identical in tokens, arm decisions, quality and fault counters.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

# span kinds
SEGMENT = "segment"
HOP = "hop"
QUEUE = "queue"
REISSUE = "reissue"
BRANCH = "branch"  # zero-length fan-out marker (DAG programs)
JOIN = "join"      # merge/select resolution span (DAG programs)


@dataclass(slots=True)
class Span:
    """One contiguous slice of a request's lifetime on the simulated clock."""

    rid: int
    name: str  # "edge" | "mid<k>" | "device" | "hop<k>" | "queue:<seg>" | "reissue"
    kind: str  # SEGMENT | HOP | QUEUE | REISSUE
    t0: float
    t1: float
    pool: Optional[str] = None
    meta: dict = field(default_factory=dict)

    @property
    def dur(self) -> float:
        """Span duration in simulated seconds (0.0 for markers)."""
        return self.t1 - self.t0

    def as_dict(self) -> dict:
        """JSON-ready form (pool/meta omitted when empty)."""
        d = {"rid": self.rid, "name": self.name, "kind": self.kind,
             "t0": self.t0, "t1": self.t1}
        if self.pool is not None:
            d["pool"] = self.pool
        if self.meta:
            d["meta"] = self.meta
        return d


@dataclass(slots=True)
class RequestTrace:
    """All spans of one request, plus its envelope (arrival → done)."""

    rid: int
    arrival: float
    arm_idx: int
    arm_label: Optional[str] = None
    done: Optional[float] = None
    spans: List[Span] = field(default_factory=list)

    @property
    def complete(self) -> bool:
        """Whether the request has finished (its ``done`` stamp is set)."""
        return self.done is not None

    @property
    def t_total(self) -> Optional[float]:
        """Arrival-to-completion simulated seconds (None while open)."""
        return None if self.done is None else self.done - self.arrival

    def attributed_s(self) -> float:
        """Sum of queue + segment + hop + join span durations along the
        request's *attribution path* — spans marked ``offpath`` (losing or
        non-critical DAG branches) are excluded, so the sum still tiles
        arrival → done exactly (markers are zero-length and contribute
        nothing)."""
        return sum(s.dur for s in self.spans if not s.meta.get("offpath"))


class SpanTracer:
    """Collects :class:`RequestTrace` objects from either serving runtime.

    Linear programs execute strictly sequentially (one segment at a time);
    DAG programs may hold several branch segments open concurrently for
    the same rid, so open queue/segment spans are keyed by
    ``(rid, segment name)``.  ``end_segment`` without a name closes the
    sole open span of the rid — the linear engines' calling convention —
    while the DAG paths pass the node id explicitly."""

    def __init__(self):
        self.requests: Dict[int, RequestTrace] = {}
        self._open_queue: Dict[Tuple[int, str], Span] = {}
        self._open_seg: Dict[Tuple[int, str], Span] = {}
        self._offpath: Dict[int, set] = {}  # rid → branches off the path

    def _append(self, rid: int, span: Span) -> None:
        """Append a span, flagging it offpath when its branch was already
        resolved away (a losing select branch can finish *after* the join
        resolves — its late spans must not re-enter the attribution)."""
        if span.meta.get("branch") in self._offpath.get(rid, ()):
            span.meta["offpath"] = True
        self.requests[rid].spans.append(span)

    # ------------------------------------------------------------------
    # recording (engine-facing)
    # ------------------------------------------------------------------

    def start_request(self, rid: int, t: float, arm_idx: int,
                      arm_label: Optional[str] = None) -> None:
        """Open a request's trace envelope at decision time ``t``."""
        self.requests[rid] = RequestTrace(rid, t, arm_idx, arm_label)

    def enqueue(self, rid: int, seg_name: str, t: float,
                branch: Optional[str] = None) -> None:
        """The segment's work item entered its pool queue at ``t``."""
        meta = {"branch": branch} if branch else {}
        self._open_queue[(rid, seg_name)] = Span(
            rid, f"queue:{seg_name}", QUEUE, t, t, None, meta)

    def start_segment(self, rid: int, seg_name: str, t: float, pool: str,
                      **meta) -> None:
        """The segment's batch dispatched at ``t`` — closes the pending
        queue span and opens the service span."""
        q = self._open_queue.pop((rid, seg_name), None)
        meta = {k: v for k, v in meta.items() if v is not None}
        if q is not None:
            q.t1 = t
            q.pool = pool
            self._append(rid, q)
            # the service span belongs to the same DAG branch its queue
            # span was enqueued on (the batching dispatcher doesn't know)
            if "branch" in q.meta and "branch" not in meta:
                meta["branch"] = q.meta["branch"]
        self._open_seg[(rid, seg_name)] = Span(rid, seg_name, SEGMENT, t, t,
                                               pool, meta)

    def end_segment(self, rid: int, t: float, name: Optional[str] = None,
                    **meta) -> None:
        """Close an open service span at ``t`` (no-op if none open).
        Without ``name`` the rid's sole open span closes — the linear
        engines' convention; DAG callers name the node explicitly."""
        if name is None:
            keys = [k for k in self._open_seg if k[0] == rid]
            if not keys:
                return
            name = keys[0][1]
        s = self._open_seg.pop((rid, name), None)
        if s is not None:
            s.t1 = t
            s.meta.update(meta)
            self._append(rid, s)

    def hop(self, rid: int, hop_idx, t0: float, t1: float,
            nbytes: int, compressed: bool, pool: Optional[str] = None,
            branch: Optional[str] = None) -> None:
        """Record one latent handoff: wire window [t0, t1] and payload
        bytes, attributed to the sending pool.  ``hop_idx`` is the hop's
        ordinal for linear programs or a ``src->dst`` edge label for DAG
        programs; ``branch`` tags hops feeding a named DAG branch."""
        meta = {"bytes": nbytes, "compressed": compressed}
        if branch:
            meta["branch"] = branch
        self._append(rid, Span(
            rid, f"hop{hop_idx}", HOP, t0, t1, pool, meta,
        ))

    def branch_point(self, rid: int, name: str, t: float,
                     branches: Tuple[str, ...]) -> None:
        """Zero-length marker at a DAG fan-out: node ``name`` handed its
        latent to several branches at ``t``."""
        self._append(rid, Span(
            rid, f"branch:{name}", BRANCH, t, t, None,
            {"branches": list(branches)},
        ))

    def join(self, rid: int, name: str, t0: float, t1: float,
             **meta) -> None:
        """Join-resolution span of a DAG merge/select node: from the
        winning branch's latent arrival ``t0`` to the resolution instant
        ``t1`` (the decision for a select, the slower arrival for a merge).
        Meta carries the outcome — winner branch, accepted flag, measured
        vs bound deviation — so trace consumers can audit Eq. 1 gating."""
        self._append(rid, Span(
            rid, f"join:{name}", JOIN, t0, t1, None,
            {k: v for k, v in meta.items() if v is not None},
        ))

    def mark_offpath(self, rid: int, branch: str) -> None:
        """Flag every span of ``branch`` as off the attribution path (the
        losing select branch, or a merge input that wasn't the critical
        one) so :meth:`RequestTrace.attributed_s` keeps tiling t_total.
        Sticky: spans of the branch appended later (a losing branch still
        in flight at resolution) are flagged on append."""
        self._offpath.setdefault(rid, set()).add(branch)
        for s in self.requests[rid].spans:
            if s.meta.get("branch") == branch:
                s.meta["offpath"] = True

    def reissue(self, rid: int, t: float, partial: bool) -> None:
        """Straggler detector tripped for this request (its own draw
        exceeded the threshold) — zero-length marker at detection time."""
        self._append(rid, Span(
            rid, "reissue", REISSUE, t, t, None, {"partial": partial},
        ))

    def end_request(self, rid: int, t: float) -> None:
        """Stamp the request complete at simulated time ``t``."""
        self.requests[rid].done = t

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.requests)

    def completed(self) -> List[RequestTrace]:
        """Traces of requests that finished (envelope closed)."""
        return [r for r in self.requests.values() if r.complete]

    def spans(self) -> Iterable[Span]:
        """Every recorded span across all requests (iteration order:
        request insertion, then span append order)."""
        for tr in self.requests.values():
            yield from tr.spans

    def coverage(self) -> float:
        """Fraction of completed requests that carry at least one segment
        span (the trace-completeness number the CI gate checks)."""
        done = self.completed()
        if not done:
            return 0.0
        traced = sum(
            1 for tr in done if any(s.kind == SEGMENT for s in tr.spans)
        )
        return traced / len(done)

    def legacy_view(self) -> Dict[int, dict]:
        """The historical ``engine.trace`` dict-of-timestamps view, derived
        from spans: ``<seg>_start`` / ``<seg>_done`` per segment,
        ``<seg>_enqueue`` for post-hop segments, accumulated ``transfer_s``
        / ``transfer_bytes``, ``reissued_at`` and ``done``."""
        out: Dict[int, dict] = {}
        for rid, tr in self.requests.items():
            d: dict = {"arrival": tr.arrival, "arm": tr.arm_idx}
            n_hops_seen = 0
            for s in tr.spans:
                if s.kind == SEGMENT:
                    d[f"{s.name}_start"] = s.t0
                    d[f"{s.name}_done"] = s.t1
                elif s.kind == HOP:
                    n_hops_seen += 1
                    d["transfer_s"] = d.get("transfer_s", 0.0) + s.dur
                    d["transfer_bytes"] = (
                        d.get("transfer_bytes", 0) + s.meta.get("bytes", 0)
                    )
                elif s.kind == QUEUE and n_hops_seen:
                    # queue spans after a hop mirror the old "<seg>_enqueue"
                    d[f"{s.name.split(':', 1)[1]}_enqueue"] = s.t0
                elif s.kind == REISSUE:
                    d["reissued_at"] = s.t0
            if tr.done is not None:
                d["done"] = tr.done
            out[rid] = d
        return out


def span_structure(tracer: SpanTracer, rid: int,
                   kinds: Tuple[str, ...] = (SEGMENT, HOP, REISSUE)
                   ) -> List[Tuple[str, str]]:
    """Structural signature of one request's trace: the ordered
    ``(kind, name)`` list over the given kinds, with reissue markers sorted
    into a canonical position (their *timing* is runtime-specific; their
    *presence* is request-intrinsic).  The cross-runtime parity suite
    asserts the sequential and continuous engines agree on this."""
    tr = tracer.requests[rid]
    ordered = [(s.kind, s.name) for s in tr.spans if s.kind in kinds
               and s.kind != REISSUE]
    markers = sorted(
        (s.kind, s.name) for s in tr.spans if s.kind == REISSUE
    )
    return ordered + markers
