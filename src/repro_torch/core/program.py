"""Segmented relay-program IR (port of the linear half of
``repro/core/program.py``): :class:`RelaySegment` — one model over a
slice of its sigma ladder; :class:`Handoff` — the Eq. 4 sigma-matched
edge between two segments with its wire-compression choice;
:class:`RelayProgram` — segments joined by handoffs; and the DAG IR
(:class:`RelayGraph` → :func:`compile_plan`) with its Eq. 1 speculation
model (:func:`select_outcome`), copied as is.  The LM relay walks
compiled chain plans (``serving/lm_relay.py``); the latent coordinators
(``core/relay.py::execute_graph``, the executor's graph pipeline) walk
every plan."""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.core.schedules import sigma_match

#: model roles within a relay family, largest to smallest
ROLES = ("large", "mid", "small")

#: node kinds of the DAG execution plan
SEGMENT_NODE = "segment"
MERGE_NODE = "merge"
SELECT_NODE = "select"


@dataclass(frozen=True)
class RelaySegment:
    """One model denoising the latent over ladder entries [start, stop)."""

    model: str  # role within the family: "large" | "mid" | "small"
    pool: Optional[str]  # replica pool executing this segment (None: unplaced)
    start: int  # first sigma-ladder entry this segment denoises from
    stop: int  # ladder entry reached at the handoff (exclusive step range)
    guidance: float = 1.0

    @property
    def steps(self) -> int:
        return self.stop - self.start


@dataclass(frozen=True)
class Handoff:
    """The edge joining two segments: the latent leaves the upstream model
    at ``sigma_out`` and the downstream model resumes at its ladder's
    closest entry ``sigma_in`` (Eq. 4).  ``compress`` selects the int8
    wire format for this hop."""

    sigma_out: float
    sigma_in: float
    compress: bool = False
    quantizer: str = "rowwise"

    @property
    def noise_gap(self) -> float:
        return abs(self.sigma_out - self.sigma_in)


@dataclass(frozen=True)
class RelayProgram:
    """Ordered segments joined by handoffs; ``len(handoffs) ==
    len(segments) - 1``.  A standalone model is a one-segment program."""

    family: str
    segments: Tuple[RelaySegment, ...]
    handoffs: Tuple[Handoff, ...]

    def __post_init__(self):
        if not self.segments:
            raise ValueError("a RelayProgram needs at least one segment")
        if len(self.handoffs) != len(self.segments) - 1:
            raise ValueError(
                f"{len(self.segments)} segments need "
                f"{len(self.segments) - 1} handoffs, got {len(self.handoffs)}"
            )
        for seg in self.segments:
            if not 0 <= seg.start < seg.stop:
                raise ValueError(f"empty or negative segment slice: {seg}")

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def n_hops(self) -> int:
        return len(self.handoffs)

    @property
    def is_relay(self) -> bool:
        return self.n_segments > 1

    @property
    def pools(self) -> Tuple[str, ...]:
        """Distinct pools in execution order."""
        return tuple(dict.fromkeys(s.pool for s in self.segments))

    @property
    def total_steps(self) -> int:
        return sum(s.steps for s in self.segments)

    def shape_key(self) -> tuple:
        """Identity of the pipeline modulo segment bounds: same family,
        role sequence, guidance and per-hop compression."""
        return (
            self.family,
            tuple((s.model, s.guidance) for s in self.segments),
            tuple(
                (h.compress, h.quantizer if h.compress else None)
                for h in self.handoffs
            ),
        )


def phase_name(program: RelayProgram, k: int) -> str:
    """Trace name of segment ``k``: the last segment is "device", the
    first segment of a relay "edge", interior cascade segments "mid<k>"."""
    if k == program.n_segments - 1:
        return "device"
    if k == 0:
        return "edge"
    return f"mid{k}"


def make_program(
    spec,
    route: Sequence[Tuple[str, Optional[str], Optional[int]]],
    *,
    guidance: float = 1.0,
    compress: bool = False,
    quantizer: str = "rowwise",
) -> RelayProgram:
    """Build a program over a family spec from a route of
    ``(role, pool, steps)`` hops, sigma-matching every handoff (Eq. 4).
    ``steps=None`` (mandatory for the last segment) runs to the end of
    that model's ladder."""
    segments, handoffs = [], []
    start = 0
    for k, (role, pool, steps) in enumerate(route):
        ladder = spec.ladder(role)
        t = len(ladder) - 1
        last = k == len(route) - 1
        if last:
            if steps is not None:
                raise ValueError("the final segment runs to its ladder end; "
                                 "pass steps=None")
            stop = t
        else:
            if steps is None:
                raise ValueError("interior segments need an explicit steps")
            stop = start + steps
        if not 0 <= start < stop <= t:
            raise ValueError(
                f"segment {k} ({role}) slice [{start}, {stop}) outside its "
                f"ladder of {t} steps"
            )
        segments.append(RelaySegment(role, pool, start, stop, guidance))
        if not last:
            next_ladder = spec.ladder(route[k + 1][0])
            nxt = sigma_match(ladder, stop, next_ladder)
            handoffs.append(
                Handoff(
                    sigma_out=float(ladder[stop]),
                    sigma_in=float(next_ladder[nxt]),
                    compress=compress,
                    quantizer=quantizer,
                )
            )
            start = nxt
    return RelayProgram(spec.name, tuple(segments), tuple(handoffs))


# ---------------------------------------------------------------------------
# DAG execution plans
#
# A RelayProgram is a chain; a RelayGraph is the general case: segment nodes
# joined by handoff edges, plus lightweight join nodes — Merge (latent
# averaging over all incoming branches) and Select (the Eq. 1 deviation
# bound picks which incoming handoff survives).  compile_plan() is the plan
# compiler: it validates the graph, fixes a canonical topological order
# (independent of declaration order), and precomputes everything the
# executors and engines need — predecessor/successor edges, ready node
# groups, and per-Select speculation metadata.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GraphNode:
    """One node of a DAG plan.

    ``kind`` is :data:`SEGMENT_NODE` (wraps a :class:`RelaySegment`),
    :data:`MERGE_NODE` (ensemble join: the latent becomes the mean of all
    incoming branch latents) or :data:`SELECT_NODE` (speculative join: the
    Eq. 1 deviation bound decides whether the *candidate* branch's handoff
    survives, else the *reference* branch's does).

    ``nid`` doubles as the node's phase/trace name (the graph analogue of
    :func:`phase_name`).  ``branch`` tags nodes on a speculative/ensemble
    branch for trace attribution.  Select nodes carry:

    * ``reference`` — nid of the predecessor that is the safe (non
      speculative) input; every other predecessor is a candidate;
    * ``gate`` — nid of the node whose completion provides the decision
      point (the verifier); on acceptance the reference continuation
      downstream of the gate is cancelled.  ``None`` means "decide when the
      reference input arrives" (no cancellation — both branches always run);
    * ``bound_pct`` — the Eq. 1 acceptance bound in percent; ``None`` means
      relative mode, :data:`SPEC_BOUND_REL` × the measured wire roundtrip
      deviation of the surviving hop.
    """

    nid: str
    kind: str = SEGMENT_NODE
    segment: Optional[RelaySegment] = None
    reference: Optional[str] = None
    gate: Optional[str] = None
    bound_pct: Optional[float] = None
    branch: Optional[str] = None

    def __post_init__(self):
        if self.kind not in (SEGMENT_NODE, MERGE_NODE, SELECT_NODE):
            raise ValueError(f"unknown node kind {self.kind!r}")
        if (self.kind == SEGMENT_NODE) != (self.segment is not None):
            raise ValueError(
                f"node {self.nid!r}: segment nodes (and only they) carry a "
                f"RelaySegment"
            )
        if self.kind == SELECT_NODE and self.reference is None:
            raise ValueError(f"select node {self.nid!r} needs a reference nid")


@dataclass(frozen=True)
class GraphEdge:
    """A directed edge of a DAG plan.  ``handoff`` is the wire crossing
    (Eq. 4 sigma match + per-hop compression choice) — ``None`` for
    zero-cost edges (same-pool continuation, or feeding a join node)."""

    src: str
    dst: str
    handoff: Optional[Handoff] = None


@dataclass(frozen=True)
class RelayGraph:
    """A DAG execution plan: the graph generalization of
    :class:`RelayProgram`.

    Duck-typed against the linear IR where consumers only need aggregate
    views: ``segments``/``handoffs`` (canonical topological order),
    ``pools``, ``n_hops``, ``total_steps``, ``is_relay`` and ``shape_key()``
    all exist, so the arm/context/latency layers accept either currency.
    """

    family: str
    nodes: Tuple[GraphNode, ...]
    edges: Tuple[GraphEdge, ...]

    def __post_init__(self):
        if not self.nodes:
            raise ValueError("a RelayGraph needs at least one node")
        nids = [n.nid for n in self.nodes]
        if len(set(nids)) != len(nids):
            raise ValueError(f"duplicate node ids in {sorted(nids)}")
        known = set(nids)
        for e in self.edges:
            if e.src not in known or e.dst not in known:
                raise ValueError(f"edge {e.src!r}->{e.dst!r} references an "
                                 f"unknown node")
            if e.src == e.dst:
                raise ValueError(f"self-loop on {e.src!r}")

    def node(self, nid: str) -> GraphNode:
        """Look up a node by id."""
        for n in self.nodes:
            if n.nid == nid:
                return n
        raise KeyError(nid)

    @property
    def segments(self) -> Tuple[RelaySegment, ...]:
        """Segments in canonical topological order (aggregate view)."""
        plan = compile_plan(self)
        return tuple(n.segment for n in plan.nodes if n.kind == SEGMENT_NODE)

    @property
    def handoffs(self) -> Tuple[Handoff, ...]:
        """Handoffs in canonical edge order (aggregate view)."""
        plan = compile_plan(self)
        return tuple(e.handoff for e in plan.edge_order if e.handoff is not None)

    @property
    def n_segments(self) -> int:
        return sum(1 for n in self.nodes if n.kind == SEGMENT_NODE)

    @property
    def n_hops(self) -> int:
        return len(self.handoffs)

    @property
    def is_relay(self) -> bool:
        return self.n_segments > 1

    @property
    def pools(self) -> Tuple[str, ...]:
        """Distinct pools in canonical topological order."""
        return tuple(dict.fromkeys(s.pool for s in self.segments))

    @property
    def total_steps(self) -> int:
        """Steps summed over every segment node (speculative branches
        included — this is *work*, not critical-path latency)."""
        return sum(s.steps for s in self.segments)

    def shape_key(self) -> tuple:
        """Compiled-pipeline identity, canonicalized: two declarations of
        the same graph (any node/edge ordering) share one key.  Chain
        graphs delegate to the equivalent linear program's key so they
        share the executor cache with legacy arms."""
        plan = compile_plan(self)
        if plan.is_chain:
            return plan.linear_program().shape_key()
        idx = plan.index
        return (
            "dag",
            self.family,
            tuple(
                (n.nid, n.kind,
                 (n.segment.model, n.segment.guidance)
                 if n.kind == SEGMENT_NODE else (n.reference, n.bound_pct))
                for n in plan.nodes
            ),
            tuple(
                (idx[e.src], idx[e.dst],
                 (e.handoff.compress,
                  e.handoff.quantizer if e.handoff.compress else None)
                 if e.handoff is not None else None)
                for e in plan.edge_order
            ),
        )


@dataclass(frozen=True)
class SelectInfo:
    """Compiled metadata of one Select node.

    ``candidates`` are the speculative predecessor nids (canonical order),
    ``reference`` the safe predecessor, ``gate`` the decision node and
    ``skip_on_accept`` every node on the gate→reference continuation that
    must be cancelled when the candidate handoff is accepted.  ``gap_frac``
    and ``verify_steps`` parameterize the deviation model
    (:func:`speculative_deviation_pct`) for the first candidate: the
    fraction of upstream (edge) steps the speculative handoff skipped, and
    how many downstream steps the candidate branch has refined for by
    verification time."""

    candidates: Tuple[str, ...]
    reference: str
    gate: Optional[str]
    skip_on_accept: frozenset
    gap_frac: float = 0.0
    verify_steps: int = 0


@dataclass(frozen=True)
class CompiledPlan:
    """A validated, topologically ordered view of a :class:`RelayGraph`.

    ``order``/``nodes`` fix the canonical node order (node index in this
    order is the runtime's ``seg_idx`` analogue — for a chain it *is* the
    segment index); ``groups`` are the antichain layers of ready nodes;
    ``preds``/``succs`` give incoming/outgoing edges per node in canonical
    order; ``selects`` maps each Select nid to its :class:`SelectInfo`."""

    graph: RelayGraph
    order: Tuple[str, ...]
    nodes: Tuple[GraphNode, ...]
    index: Mapping[str, int]
    preds: Mapping[str, Tuple[GraphEdge, ...]]
    succs: Mapping[str, Tuple[GraphEdge, ...]]
    edge_order: Tuple[GraphEdge, ...]
    groups: Tuple[Tuple[str, ...], ...]
    source: str
    sink: str
    is_chain: bool
    selects: Mapping[str, SelectInfo] = field(default_factory=dict)

    def node_at(self, i: int) -> GraphNode:
        """The node at canonical position ``i``."""
        return self.nodes[i]

    def linear_program(self) -> RelayProgram:
        """The equivalent :class:`RelayProgram` of a chain graph."""
        if not self.is_chain:
            raise ValueError("not a chain graph")
        segs = tuple(n.segment for n in self.nodes)
        hops = tuple(self.succs[nid][0].handoff for nid in self.order[:-1])
        if any(h is None for h in hops):
            raise ValueError("chain graphs need a Handoff on every edge")
        return RelayProgram(self.graph.family, segs, hops)


def _entry_stop(plan: "CompiledPlan", nid: str) -> int:
    """Ladder step at which the branch feeding ``nid`` left its upstream
    model: walk up (first predecessor each level) to the nearest edge that
    carries a Handoff and return its source segment's ``stop``."""
    cur = nid
    while True:
        pe = plan.preds.get(cur, ())
        if not pe:
            node = plan.graph.node(cur)
            return node.segment.start if node.kind == SEGMENT_NODE else 0
        e = pe[0]
        if e.handoff is not None:
            src = plan.graph.node(e.src)
            return src.segment.stop if src.kind == SEGMENT_NODE else 0
        cur = e.src


def _select_info(preds, succs, node) -> SelectInfo:
    """Derive a Select node's compiled metadata (see :class:`SelectInfo`)."""
    pred_nids = tuple(e.src for e in preds[node.nid])
    if node.reference not in pred_nids:
        raise ValueError(
            f"select {node.nid!r}: reference {node.reference!r} is not a "
            f"predecessor"
        )
    if len(pred_nids) < 2:
        raise ValueError(f"select {node.nid!r} needs >= 2 predecessors")
    candidates = tuple(n for n in pred_nids if n != node.reference)
    gate = node.gate
    skip: frozenset = frozenset()
    if gate is not None:
        # nodes on any gate → reference path, gate exclusive: cancelled
        # when the candidate handoff is accepted
        reach_from_gate = _reachable(succs, gate)
        reach_to_ref = _reachable_rev(preds, node.reference)
        skip = frozenset((reach_from_gate & reach_to_ref) - {gate})
    return SelectInfo(
        candidates=candidates,
        reference=node.reference,
        gate=gate,
        skip_on_accept=skip,
    )


def _reachable(succs, start: str) -> set:
    seen, stack = set(), [start]
    while stack:
        cur = stack.pop()
        for e in succs.get(cur, ()):
            if e.dst not in seen:
                seen.add(e.dst)
                stack.append(e.dst)
    return seen


def _reachable_rev(preds, start: str) -> set:
    seen, stack = {start}, [start]
    while stack:
        cur = stack.pop()
        for e in preds.get(cur, ()):
            if e.src not in seen:
                seen.add(e.src)
                stack.append(e.src)
    return seen


@lru_cache(maxsize=512)
def compile_plan(graph: RelayGraph) -> CompiledPlan:
    """Validate a :class:`RelayGraph` and fix its canonical execution
    structure.

    Validation: acyclic, exactly one source and one sink (hence connected),
    join nodes have >= 2 predecessors, select references are predecessors.
    The canonical topological order is Kahn's algorithm with a
    lexicographic-nid tie-break, so it depends only on the graph's
    structure — topologically equivalent declarations (shuffled node/edge
    tuples) compile to the identical plan, order, groups and
    ``shape_key``."""
    preds: Dict[str, list] = {n.nid: [] for n in graph.nodes}
    succs: Dict[str, list] = {n.nid: [] for n in graph.nodes}
    # canonical edge order: by (src nid, dst nid) — declaration independent
    edge_order = tuple(sorted(graph.edges, key=lambda e: (e.src, e.dst)))
    for e in edge_order:
        preds[e.dst].append(e)
        succs[e.src].append(e)
    sources = sorted(nid for nid, pe in preds.items() if not pe)
    sinks = sorted(nid for nid, se in succs.items() if not se)
    if len(sources) != 1:
        raise ValueError(f"a plan needs exactly one source, got {sources}")
    if len(sinks) != 1:
        raise ValueError(f"a plan needs exactly one sink, got {sinks}")
    # Kahn layers with deterministic (lexicographic) tie-break
    indeg = {nid: len(pe) for nid, pe in preds.items()}
    ready = sorted(nid for nid, d in indeg.items() if d == 0)
    order: list = []
    groups: list = []
    while ready:
        groups.append(tuple(ready))
        nxt = set()
        for nid in ready:
            order.append(nid)
            for e in succs[nid]:
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    nxt.add(e.dst)
        ready = sorted(nxt)
    if len(order) != len(graph.nodes):
        stuck = sorted(set(preds) - set(order))
        raise ValueError(f"cycle through {stuck}")
    by_id = {n.nid: n for n in graph.nodes}
    nodes = tuple(by_id[nid] for nid in order)
    preds_t = {nid: tuple(pe) for nid, pe in preds.items()}
    succs_t = {nid: tuple(se) for nid, se in succs.items()}
    for n in nodes:
        if n.kind in (MERGE_NODE, SELECT_NODE) and len(preds_t[n.nid]) < 2:
            raise ValueError(f"join node {n.nid!r} needs >= 2 predecessors")
        if n.kind == SEGMENT_NODE and len(preds_t[n.nid]) > 1:
            raise ValueError(
                f"segment node {n.nid!r} has {len(preds_t[n.nid])} inputs; "
                f"fan-in goes through Merge/Select join nodes"
            )
        if n.kind == SELECT_NODE and n.gate is not None and n.gate not in by_id:
            raise ValueError(f"select {n.nid!r}: unknown gate {n.gate!r}")
    is_chain = (
        all(n.kind == SEGMENT_NODE for n in nodes)
        and all(len(succs_t[nid]) <= 1 for nid in order)
        and all(len(preds_t[nid]) <= 1 for nid in order)
    )
    plan = CompiledPlan(
        graph=graph,
        order=tuple(order),
        nodes=nodes,
        index={nid: i for i, nid in enumerate(order)},
        preds=preds_t,
        succs=succs_t,
        edge_order=edge_order,
        groups=tuple(groups),
        source=sources[0],
        sink=sinks[0],
        is_chain=is_chain,
    )
    selects = {}
    for n in nodes:
        if n.kind == SELECT_NODE:
            info = _select_info(preds_t, succs_t, n)
            cand = info.candidates[0]
            cand_node, ref_node = by_id[cand], by_id[info.reference]
            verify = 0
            if (cand_node.kind == SEGMENT_NODE
                    and ref_node.kind == SEGMENT_NODE):
                verify = max(ref_node.segment.start - cand_node.segment.start, 0)
            s_cand = _entry_stop(plan, cand)
            s_ref = _entry_stop(plan, info.reference)
            gap = (s_ref - s_cand) / max(s_ref, 1)
            selects[n.nid] = SelectInfo(
                candidates=info.candidates,
                reference=info.reference,
                gate=info.gate,
                skip_on_accept=info.skip_on_accept,
                gap_frac=max(gap, 0.0),
                verify_steps=verify,
            )
    object.__setattr__(plan, "selects", selects)
    return plan


def linear_graph(program: RelayProgram) -> RelayGraph:
    """Bridge a linear :class:`RelayProgram` into the DAG IR: segment ``k``
    becomes node ``"n<k>"`` (zero-padded so the canonical lexicographic
    order equals the segment order), handoff ``k`` the edge joining
    consecutive nodes."""
    nodes = tuple(
        GraphNode(nid=f"n{k:02d}", kind=SEGMENT_NODE, segment=s)
        for k, s in enumerate(program.segments)
    )
    edges = tuple(
        GraphEdge(src=f"n{k:02d}", dst=f"n{k + 1:02d}", handoff=h)
        for k, h in enumerate(program.handoffs)
    )
    return RelayGraph(program.family, nodes, edges)


def as_graph(program) -> RelayGraph:
    """Coerce either plan currency to a :class:`RelayGraph`."""
    if isinstance(program, RelayGraph):
        return program
    return linear_graph(program)


# --- Eq. 1 speculation model -------------------------------------------------
#
# A speculative handoff leaves the edge model early (at step s_spec < s); the
# device branch refines from the early compressed latent while the edge
# finishes the remaining steps.  Fewer edge steps inflate the Eq. 1
# deviation (Fig. 2), and the candidate branch keeps denoising until the gate
# verifies it, while relay trajectories contract toward the full-model
# trajectory after a handoff (Fig. 2: deviation decays over post-handoff
# steps).

#: deviation inflation per unit (complexity × skipped-edge-step fraction)
SPEC_GAMMA = 4.0
#: per-device-step post-handoff contraction of the Eq. 1 deviation (Fig. 2)
SPEC_DECAY = 0.82
#: relative acceptance bound when Select.bound_pct is None:
#: SPEC_BOUND_REL × the measured wire roundtrip deviation
SPEC_BOUND_REL = 1.1


def speculative_deviation_pct(
    base_pct: float, gap_frac: float, verify_steps: int, complexity: float,
) -> float:
    """Modeled Eq. 1 deviation (percent) of a speculative handoff at
    verification time.

    ``base_pct`` is the wire's measured roundtrip deviation (the fixed
    arm's handoff deviation), ``gap_frac`` the fraction of edge steps the
    speculative handoff skipped, ``verify_steps`` how many device-ladder
    steps the candidate branch has refined for by the time the gate
    verifies it, and ``complexity`` the request's prompt complexity in
    [0, 1).  Deterministic in its inputs, so every engine and any replay
    agree on every accept/reject decision."""
    growth = 1.0 + SPEC_GAMMA * complexity * gap_frac
    return base_pct * growth * (SPEC_DECAY ** verify_steps)


def select_bound_pct(node: GraphNode, base_pct: float) -> float:
    """Resolve a Select node's acceptance bound: explicit ``bound_pct``,
    else relative mode (:data:`SPEC_BOUND_REL` × the wire deviation)."""
    if node.bound_pct is not None:
        return float(node.bound_pct)
    return SPEC_BOUND_REL * base_pct


def select_outcome(plan: CompiledPlan, nid: str, complexity: float,
                   base_pct: float) -> Tuple[bool, float, float]:
    """Gate decision of one Select node for one request: ``(accepted,
    deviation_pct, bound_pct)``.

    ``base_pct`` is the transport's measured roundtrip deviation for the
    program's family (percent).  The decision is a pure function of
    ``(plan, request complexity, transport)`` — no clock, no RNG."""
    sel = plan.selects[nid]
    node = plan.nodes[plan.index[nid]]
    dev = speculative_deviation_pct(
        base_pct, sel.gap_frac, sel.verify_steps, complexity
    )
    bound = select_bound_pct(node, base_pct)
    return dev <= bound, dev, bound
