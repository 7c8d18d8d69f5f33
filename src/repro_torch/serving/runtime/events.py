"""Discrete-event primitives for the continuous-batching relay runtime (a
copy of ``repro/serving/runtime/events.py``).

The runtime replaces the sequential per-request loop of ``ServingEngine``
with an event-driven simulation: request arrivals, batch completions,
latent-transfer completions, aggregator flush deadlines and fault
injections (replica failure/recovery, straggler detection) are all events
on a single monotone clock.  Ties are broken by insertion order so runs
are fully deterministic for a given seed.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, Tuple

from repro_torch.core.context import Request

# event kinds (ties at equal t break by insertion order — the heap key is
# (t, seq); the kind itself never participates in ordering)
ARRIVE = "arrive"
BATCH_DONE = "batch_done"
DEVICE_READY = "device_ready"
FLUSH = "flush"
# fault-tolerance events (sequential-engine parity): a replica dropping out
# of / rejoining its pool, and the straggler detector tripping on an
# in-flight batch (payload: batch id) to re-issue it on the twin replica.
# STRAGGLER re-issues the *whole* batch (straggler_mode="batch"); under
# straggler_mode="item" the detector instead fires STRAGGLER_PARTIAL, whose
# payload is the id of a pre-staged sub-batch holding only the straggling
# samples — the twin replica re-runs just those via the Executor's
# partial-batch re-execution path, while the kept samples complete at their
# own (un-straggled) pace.
REPLICA_FAIL = "replica_fail"
REPLICA_RECOVER = "replica_recover"
STRAGGLER = "straggler"
STRAGGLER_PARTIAL = "straggler_partial"
# autoscaler evaluation tick (payload: None): the attached
# fleet.autoscale policy inspects per-pool queue depth / backlog /
# occupancy and applies its decisions by pushing the membership events
# above — scale-down is a REPLICA_FAIL that never recovers on its own,
# scale-up a REPLICA_RECOVER of a parked replica
AUTOSCALE = "autoscale"

EDGE = "edge"
DEVICE = "device"


@dataclass(slots=True)
class WorkItem:
    """One segment of one request's relay-program execution, queued on a
    pool.

    An N-segment program becomes N sequential WorkItems (edge, mid…,
    device); a standalone request becomes a single device-phase item.
    ``seg_idx`` is the position in the arm's program (``phase`` is its
    human/trace name: "edge", "mid<k>", "device").
    """

    req: Request
    arm_idx: int
    phase: str  # EDGE | "mid<k>" | DEVICE
    pool: str
    steps: int  # denoising steps of this segment (drives service time)
    seg_idx: int = 0  # index into the arm program's segments
    enqueue_t: float = 0.0  # when it entered the aggregator queue

    @property
    def rid(self) -> int:
        """The carried request's id."""
        return self.req.rid


class EventQueue:
    """Min-heap of (time, seq, kind, payload) with deterministic ordering.

    Carries always-on integer op counters (pushes / pops / peak size) for
    the event-loop profiler — the ROADMAP's vectorization item needs the
    heap-op baseline, and bare int increments cost nothing measurable.

    :meth:`reserve` supports *streaming* event sources: a producer that
    knows its events in advance (e.g. the engine's sorted arrival stream)
    reserves a contiguous seq band up front and pushes each event lazily
    via :meth:`push_at` when the simulation approaches it.  Because the
    heap orders by ``(t, seq)``, a lazily pushed event with a reserved
    (low) seq pops in exactly the position it would have occupied had it
    been pre-filled — tie-breaking is bit-identical while the heap stays
    bounded by the number of *in-flight* events instead of the total
    event count."""

    def __init__(self):
        self._heap: list = []
        self._next_seq = 0
        self.n_pushed = 0
        self.n_popped = 0
        self.peak_size = 0

    def reserve(self, n: int) -> int:
        """Reserve ``n`` consecutive seq numbers for out-of-band pushes;
        returns the first reserved seq.  Subsequent :meth:`push` calls
        allocate seqs strictly after the reserved band."""
        base = self._next_seq
        self._next_seq += n
        return base

    def push(self, t: float, kind: str, payload: Any = None) -> None:
        """Schedule an event at simulated time ``t`` (seq auto-assigned;
        equal-time events pop in push order)."""
        seq = self._next_seq
        self._next_seq = seq + 1
        heapq.heappush(self._heap, (t, seq, kind, payload))
        self.n_pushed += 1
        if len(self._heap) > self.peak_size:
            self.peak_size = len(self._heap)

    def push_at(self, t: float, seq: int, kind: str, payload: Any = None) -> None:
        """Push with an explicitly reserved seq (see :meth:`reserve`)."""
        heapq.heappush(self._heap, (t, seq, kind, payload))
        self.n_pushed += 1
        if len(self._heap) > self.peak_size:
            self.peak_size = len(self._heap)

    def pop(self) -> Tuple[float, str, Any]:
        """Remove and return the earliest event as ``(t, kind, payload)``."""
        t, _, kind, payload = heapq.heappop(self._heap)
        self.n_popped += 1
        return t, kind, payload

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
