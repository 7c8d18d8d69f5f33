"""Per-pool micro-batch aggregator with pad-to-bucket shapes (a copy of
``repro/serving/runtime/batching.py``).

Queued work items that share a :class:`BatchKey` — (pool, arm, phase),
i.e. the same relay-program segment — run the *same* compiled launch, so
they can be coalesced into one batched device dispatch.  Batch sizes are
padded up to a small set of bucket shapes so each (key, bucket) pair maps
to one launch shape, the bucket ``Executor.generate_bucketed`` pads to
(arms sharing a program shape share one pipeline).

Dispatch is continuous-batching style: whenever a replica frees up the
aggregator hands over whatever is queued for the oldest key (up to the
largest bucket).  A short *linger* window lets a sub-maximal batch wait for
companions when traffic is flowing, bounded so light traffic never trades
latency for occupancy.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

from .events import WorkItem

DEFAULT_BUCKETS = (1, 2, 4, 8)


@dataclass(frozen=True)
class BatchKey:
    """Identity of one relay-program segment's compiled launch: all items
    sharing a key run the same arm's program at the same segment (hence the
    same weights, ladder slice and latent shape) and may be batched
    together."""

    pool: str
    arm_idx: int
    phase: str


def batch_key_for(item: WorkItem) -> BatchKey:
    """The :class:`BatchKey` a work item coalesces under."""
    return BatchKey(item.pool, item.arm_idx, item.phase)


def bucketize(n: int, buckets: Tuple[int, ...] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket ≥ n (n must not exceed the largest bucket)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds largest bucket {buckets[-1]}")


class MicroBatchAggregator:
    """FIFO-across-keys micro-batcher for one replica pool."""

    def __init__(self, pool: str, buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                 linger_s: float = 0.25):
        self.pool = pool
        self.buckets = tuple(sorted(buckets))
        self.max_batch = self.buckets[-1]
        self.linger_s = linger_s
        self.queues: "OrderedDict[BatchKey, Deque[WorkItem]]" = OrderedDict()
        # running aggregates: the engine's backpressure pass reads depth and
        # pending steps on every arrival, so these must be O(1), not a scan
        # over every queued item (the pre-vectorization hot-path cost)
        self._depth = 0
        self._pending_steps = 0

    def push(self, item: WorkItem, now: float) -> None:
        """Enqueue one work item (stamping its ``enqueue_t`` to ``now``)."""
        item.enqueue_t = now
        key = batch_key_for(item)
        if key.pool != self.pool:
            raise ValueError(f"item for pool {key.pool} pushed to {self.pool}")
        self.queues.setdefault(key, deque()).append(item)
        self._depth += 1
        self._pending_steps += item.steps

    def depth(self) -> int:
        """Total queued items across all keys (O(1))."""
        return self._depth

    def pending_steps(self) -> int:
        """Total denoising steps queued (drives the backlog estimate)."""
        return self._pending_steps

    def _oldest_key(self) -> Optional[BatchKey]:
        best, best_t = None, None
        for key, q in self.queues.items():
            if q and (best_t is None or q[0].enqueue_t < best_t):
                best, best_t = key, q[0].enqueue_t
        return best

    def flush_deadline(self) -> Optional[float]:
        """Time by which the oldest queued item must be dispatched even if
        its batch is sub-maximal (enqueue time + linger)."""
        key = self._oldest_key()
        if key is None:
            return None
        return self.queues[key][0].enqueue_t + self.linger_s

    def next_batch(self, now: float, force: bool = False
                   ) -> Optional[Tuple[List[WorkItem], int]]:
        """Pop the next dispatchable batch, or None if the aggregator
        prefers to linger (caller should schedule a FLUSH at
        :meth:`flush_deadline`).  Returns (items, padded_bucket_size)."""
        # a full bucket anywhere dispatches immediately — never head-of-line
        # blocked behind an older key that is still lingering sub-maximal
        key = next(
            (k for k, q in self.queues.items() if len(q) >= self.max_batch),
            None,
        )
        full = key is not None
        if not full:
            key = self._oldest_key()
        if key is None:
            return None
        q = self.queues[key]
        n = min(len(q), self.max_batch)
        # linger: a sub-maximal batch whose head is still young waits for
        # companions — unless forced (flush deadline) or already full.
        if (not full and not force
                and now - q[0].enqueue_t < self.linger_s):
            return None
        items = [q.popleft() for _ in range(n)]
        if not q:
            del self.queues[key]
        self._depth -= n
        self._pending_steps -= sum(it.steps for it in items)
        return items, bucketize(n, self.buckets)
