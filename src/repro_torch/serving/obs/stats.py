"""Bounded-memory streaming statistics for fleet-scale telemetry (a copy of
``repro/serving/obs/stats.py``, numpy only).

The continuous runtime must replay ~10⁶ requests (ROADMAP fleet-scale
item); per-sample lists — like the old unbounded
``PoolStats.depth_samples`` — grow O(requests) and would OOM the replay.
Everything here is O(1) per tracked series:

* :class:`StreamingMoments` — exact count / mean / min / max / sum via a
  running accumulation (no samples retained);
* :class:`ReservoirSample` — classic reservoir sampling (Vitter's
  Algorithm R) with a deterministic private RNG, giving approximate
  quantiles over an unbounded stream from a fixed-size buffer.  The RNG is
  private to the reservoir, so sampling never perturbs the simulation's
  random streams (numpy's global stream, torch's generators);
* :class:`StreamingQuantiles` — moments + reservoir, reporting
  p50/p95/p99;
* :class:`DepthSeries` — the queue-depth replacement for
  ``depth_samples``: exact mean/max plus reservoir quantiles.

Plus the latency-attribution helpers over a finished
:class:`~repro_torch.serving.obs.tracer.SpanTracer`: per-segment / per-hop /
per-queue attribution histograms whose per-request sums must equal the
engine's ``t_total`` (see :func:`attribution_residual`).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.serving.obs.tracer import REISSUE, SpanTracer

DEFAULT_RESERVOIR = 1024


class StreamingMoments:
    """Exact count/mean/min/max/sum in O(1) memory."""

    __slots__ = ("n", "total", "mn", "mx")

    def __init__(self):
        self.n = 0
        self.total = 0.0
        self.mn = np.inf
        self.mx = -np.inf

    def add(self, x: float) -> None:
        """Fold one sample into the running count/total/min/max."""
        self.n += 1
        self.total += x
        if x < self.mn:
            self.mn = x
        if x > self.mx:
            self.mx = x

    @property
    def mean(self) -> float:
        """Running mean (0.0 before any sample)."""
        return self.total / self.n if self.n else 0.0

    @property
    def max(self) -> float:
        """Largest sample seen (0.0 before any sample)."""
        return self.mx if self.n else 0.0

    @property
    def min(self) -> float:
        """Smallest sample seen (0.0 before any sample)."""
        return self.mn if self.n else 0.0


class ReservoirSample:
    """Fixed-capacity uniform sample of an unbounded stream (Algorithm R).

    Deterministic for a given seed; the RNG is private so the reservoir
    never consumes draws from any simulation stream."""

    def __init__(self, capacity: int = DEFAULT_RESERVOIR, seed: int = 0):
        if capacity <= 0:
            raise ValueError("reservoir capacity must be positive")
        self.capacity = capacity
        self._rng = np.random.default_rng(seed)
        self._buf = np.empty(capacity, np.float64)
        self.n_seen = 0

    def add(self, x: float) -> None:
        """Offer one sample (kept with probability capacity/n_seen)."""
        if self.n_seen < self.capacity:
            self._buf[self.n_seen] = x
        else:
            j = int(self._rng.integers(0, self.n_seen + 1))
            if j < self.capacity:
                self._buf[j] = x
        self.n_seen += 1

    def values(self) -> np.ndarray:
        """The currently retained samples (≤ capacity, unordered)."""
        return self._buf[: min(self.n_seen, self.capacity)]

    def quantile(self, q: float) -> float:
        """Estimated q-quantile from the reservoir (0.0 when empty)."""
        v = self.values()
        return float(np.quantile(v, q)) if v.size else 0.0

    @property
    def nbytes(self) -> int:
        """Fixed buffer footprint in bytes (capacity × 8)."""
        return self._buf.nbytes


class StreamingQuantiles:
    """Moments + reservoir quantiles; the bounded replacement for keeping a
    per-sample list around just to call ``np.percentile`` at the end."""

    def __init__(self, capacity: int = DEFAULT_RESERVOIR, seed: int = 0):
        self.moments = StreamingMoments()
        self.reservoir = ReservoirSample(capacity, seed)

    def add(self, x: float) -> None:
        """Fold one sample into both the moments and the reservoir."""
        self.moments.add(x)
        self.reservoir.add(x)

    @property
    def n(self) -> int:
        """Samples seen (exact, regardless of reservoir capacity)."""
        return self.moments.n

    def summary(self) -> Dict[str, float]:
        """JSON-ready digest: exact count/mean/min/max + p50/p95/p99."""
        return {
            "count": self.moments.n,
            "mean": self.moments.mean,
            "min": self.moments.min,
            "max": self.moments.max,
            "p50": self.reservoir.quantile(0.50),
            "p95": self.reservoir.quantile(0.95),
            "p99": self.reservoir.quantile(0.99),
        }


class DepthSeries:
    """Queue-depth series with exact mean/max and reservoir quantiles —
    O(1) memory per pool regardless of how many dispatches sample it."""

    def __init__(self, capacity: int = DEFAULT_RESERVOIR, seed: int = 0):
        self._q = StreamingQuantiles(capacity, seed)

    def add(self, t: float, depth: int) -> None:
        """Sample the queue depth at simulated time ``t`` (t is accepted
        for API symmetry with the old (t, depth) samples; only the depth
        distribution is retained)."""
        self._q.add(float(depth))

    @property
    def n(self) -> int:
        """Depth samples recorded."""
        return self._q.n

    @property
    def mean(self) -> float:
        """Exact mean queue depth over all samples."""
        return self._q.moments.mean

    @property
    def max(self) -> int:
        """Exact maximum queue depth observed."""
        return int(self._q.moments.max)

    def p95(self) -> float:
        """Reservoir-estimated 95th-percentile depth."""
        return self._q.reservoir.quantile(0.95)

    def summary(self) -> Dict[str, float]:
        """JSON-ready digest (see StreamingQuantiles.summary)."""
        return self._q.summary()


# ---------------------------------------------------------------------------
# latency attribution over a finished tracer
# ---------------------------------------------------------------------------


def latency_attribution(tracer: SpanTracer,
                        capacity: int = DEFAULT_RESERVOIR) -> Dict[str, dict]:
    """Per-span-name streaming attribution over completed requests.

    Returns ``{span_name: StreamingQuantiles.summary() + total_s share}``
    for every segment / hop / queue span name seen (e.g. ``edge``,
    ``hop0``, ``queue:device``), plus an ``_overall`` entry over per-request
    ``t_total``.  The per-name totals sum to the per-request totals — the
    invariant :func:`attribution_residual` quantifies."""
    per_name: Dict[str, StreamingQuantiles] = {}
    overall = StreamingQuantiles(capacity)
    for tr in tracer.completed():
        overall.add(tr.t_total)
        for s in tr.spans:
            if s.kind == REISSUE:
                continue
            per_name.setdefault(
                s.name, StreamingQuantiles(capacity)
            ).add(s.dur)
    total_s = overall.moments.total
    out: Dict[str, dict] = {}
    for name in sorted(per_name):
        q = per_name[name]
        d = q.summary()
        d["total_s"] = q.moments.total
        d["share"] = q.moments.total / total_s if total_s else 0.0
        out[name] = d
    d = overall.summary()
    d["total_s"] = total_s
    out["_overall"] = d
    return out


def attribution_residual(tracer: SpanTracer) -> float:
    """Max over completed requests of |Σ span durations − t_total|.

    The spans of a request tile its lifetime, so this is float noise
    (≤ 1e-6) when the engines instrument correctly — the acceptance gate
    for the traced benchmark runs."""
    residual = 0.0
    for tr in tracer.completed():
        residual = max(residual, abs(tr.attributed_s() - tr.t_total))
    return residual


def attribution_by_kind(tracer: SpanTracer) -> Dict[str, float]:
    """Total seconds attributed per span kind (segment / hop / queue)."""
    out: Dict[str, float] = {}
    for tr in tracer.completed():
        for s in tr.spans:
            if s.kind == REISSUE:
                continue
            out[s.kind] = out.get(s.kind, 0.0) + s.dur
    return {k: out[k] for k in sorted(out)}
