"""Shared serving context: the decision-time quantities both runtimes must
compute identically (a copy of ``repro/serving/context.py``, numpy only).

The sequential engine loop and the discrete-event continuous runtime
(``serving/engine.py``, ``serving/runtime/engine.py``) read three pieces
of scheduler-visible state from here, so that they make identical arm
decisions:

* :func:`aggregate_occupancy` — folding per-replica-pool occupancies into
  the context vector's three load features
  ({vega, sdxl, sd3: max(sd3l, sd3m)});
* :func:`backlog_horizon` — the ``max_queue × 10 s`` backlog past which an
  arm is masked unavailable;
* :func:`straggler_slow` — the per-request straggler draw, deterministic
  in ``(seed, rid)`` so a request straggles identically whichever engine
  (and whichever micro-batch) executes it, making fault counters
  comparable across runtimes.

It also defines the optional telemetry context features (live queue depth
and batch occupancy) appended to the LinUCB context vector when
``SimConfig.telemetry_context`` is enabled.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

import numpy as np

from repro_torch.core.context import CTX_DIM
from repro_torch.serving.arms import POOL_REPLICAS

#: seconds of acceptable backlog per allowed queue slot (the availability
#: mask horizon is ``max_queue ×`` this)
BACKLOG_SECONDS_PER_SLOT = 10.0

#: context load features → the replica pools they aggregate (mid-size
#: cascade stages fold into their family's feature; idle pools report 0
#: occupancy so the grouped max is unchanged for non-cascade workloads)
POOL_GROUPS: Dict[str, Tuple[str, ...]] = {
    "vega": ("vega",),
    "sdxl": ("sdxl", "ssd1b"),
    "sd3": ("sd3l", "sd3lt", "sd3m"),
}

#: extra context dims appended when ``SimConfig.telemetry_context`` is on
N_TELEMETRY_FEATURES = 2

_POOL_KEY = {p: grp for grp, pools in POOL_GROUPS.items() for p in pools}


def pool_key(pool: str) -> str:
    """Context-feature key of a replica pool (sd3l / sd3m share "sd3")."""
    return _POOL_KEY[pool]


def aggregate_occupancy(per_pool: Mapping[str, float]) -> Dict[str, float]:
    """Fold per-replica-pool occupancies into the context load features.

    A relay is gated by its most loaded stage, so grouped pools aggregate
    with max (the SD3 relay spans sd3l and sd3m)."""
    return {
        grp: max(per_pool[p] for p in pools)
        for grp, pools in POOL_GROUPS.items()
    }


def backlog_horizon(cfg) -> float:
    """Seconds of backlog past which an arm is masked unavailable."""
    return cfg.max_queue * BACKLOG_SECONDS_PER_SLOT


def pool_inventory(cfg) -> Dict[str, int]:
    """Replica inventory of a SimConfig: pool name → replica count.

    Defaults to the testbed's ``serving.arms.POOL_REPLICAS``;
    ``cfg.pool_replicas`` overrides the *counts* per pool (the fleet's
    heterogeneous-cluster seam) but must cover exactly the same pool set —
    the context features (:data:`POOL_GROUPS`), the arm availability masks
    and the vectorized pool snapshot all iterate the full pool list, so a
    missing pool would silently skew every load feature.  Counts must be
    ≥ 1 (``np.add.reduceat`` cannot represent an empty replica slice; model
    a drained pool with autoscaling or failure injection instead).  Both
    engines read their inventory through this one accessor, so a cluster's
    pool sizing is decided in exactly one place."""
    override = getattr(cfg, "pool_replicas", None)
    if override is None:
        return dict(POOL_REPLICAS)
    if set(override) != set(POOL_REPLICAS):
        raise ValueError(
            f"pool_replicas must cover exactly {sorted(POOL_REPLICAS)}; "
            f"got {sorted(override)}"
        )
    bad = {p: n for p, n in override.items() if int(n) < 1}
    if bad:
        raise ValueError(f"pool_replicas counts must be >= 1: {bad}")
    # preserve POOL_REPLICAS key order: the vectorized snapshot's reduceat
    # segment layout (and hence float summation order) follows it
    return {p: int(override[p]) for p in POOL_REPLICAS}


def failure_schedule(cfg) -> Tuple[Tuple[str, int, float, float], ...]:
    """Normalized replica-outage schedule of a SimConfig.

    ``fail_replica`` accepts a single ``(pool, replica_idx, t_fail,
    t_recover)`` tuple (the historical form) or a sequence of them
    (concurrent/overlapping outages, e.g. both replicas of one pool).
    Both engines derive their failure injection from this one accessor so
    the schedules — and hence the fault counters — agree by construction."""
    f = getattr(cfg, "fail_replica", None)
    if f is None:
        return ()
    if isinstance(f[0], str):  # single outage tuple
        return (tuple(f),)
    return tuple(tuple(o) for o in f)


def fallback_avail(arms, n_alive_by_pool: Mapping[str, int]) -> "np.ndarray":
    """Availability mask for the everything-congested fallback.

    When every arm is masked by the backlog horizon the scheduler must
    still place the request *somewhere* — but "somewhere" must not be an
    arm whose program routes through a pool with zero live replicas: work
    queued on a fully-dead pool sits in the aggregator until (if ever) a
    replica recovers, and with no recovery scheduled the request is lost.
    The fallback therefore opens exactly the arms whose every pool has at
    least one live replica; only if *no* such arm exists (total outage of
    every pool some arm needs) does it degrade to the historical
    all-arms-open behavior."""
    out = np.zeros(len(arms), bool)
    for a in arms:
        out[a.idx] = all(n_alive_by_pool[p] > 0 for p in a.program.pools)
    if not out.any():
        out[:] = True
    return out


#: straggler mitigation modes: "item" re-issues only the straggling samples
#: of a lagging micro-batch as a twin-replica sub-batch (partial-batch
#: re-execution via ``Executor.generate_bucketed(..., subset=...)``);
#: "batch" re-issues the whole micro-batch, capping every member at
#: ``straggler_reissue ×`` expected (the pre-partial-re-execution model).
STRAGGLER_MODES = ("item", "batch")


def straggler_mode(cfg) -> str:
    """Validated straggler mitigation mode of a SimConfig — the one
    accessor both engines use, so an unknown mode fails loudly in either."""
    mode = getattr(cfg, "straggler_mode", "item")
    if mode not in STRAGGLER_MODES:
        raise ValueError(
            f"unknown straggler_mode {mode!r}; expected one of {STRAGGLER_MODES}"
        )
    return mode


def straggler_slow(cfg, rid: int) -> float:
    """Per-request straggler slowdown factor (≥ 1).

    Keyed by ``(seed, rid)`` rather than drawn from an engine-order RNG
    stream: batch composition and completion order differ between the
    runtimes, so only a request-intrinsic draw lets the parity suite
    assert their fault counters match."""
    if cfg.straggler_prob <= 0.0:
        return 1.0
    u = np.random.default_rng([int(cfg.seed), int(rid), 0x57A6]).uniform()
    return float(cfg.straggler_factor) if u < cfg.straggler_prob else 1.0


def partition_stragglers(
    cfg, rids: Iterable[int]
) -> Tuple[float, List[int], Dict[int, float]]:
    """Split a dispatched edge-phase batch by its members' request-intrinsic
    straggler draws: ``(kept_slow, reissue_rids, draws)``.

    ``reissue_rids`` are the members whose draw trips the re-issue detector
    (slow > ``straggler_reissue``) — under per-item mitigation exactly these
    re-run on the twin replica as a sub-batch; ``kept_slow`` is the max
    slowdown among the remaining members (the batch still moves at the pace
    of its slowest *kept* sample).  Under whole-batch mitigation callers
    fold the tripped members back in (the entire batch re-issues).
    ``draws`` carries every member's slowdown so callers account injected
    stragglers without re-deriving the per-request RNG.

    Shared by both engines (the sequential engine passes its singleton
    "batch") so the kept/re-issued split — and therefore the fault
    counters — is identical by construction."""
    kept_slow, reissue, draws = 1.0, [], {}
    for rid in rids:
        s = draws[rid] = straggler_slow(cfg, rid)
        if s > cfg.straggler_reissue:
            reissue.append(rid)
        else:
            kept_slow = max(kept_slow, s)
    return kept_slow, reissue, draws


def context_dim(telemetry_context: bool = False) -> int:
    """LinUCB context dimension for a SimConfig's feature flags (policies
    sized with this stay consistent with :func:`telemetry_features`)."""
    return CTX_DIM + (N_TELEMETRY_FEATURES if telemetry_context else 0)


def telemetry_features(queue_depth_norm: float,
                       batch_occupancy: float) -> np.ndarray:
    """Live-runtime features appended to the context vector when
    ``SimConfig.telemetry_context`` is on: normalized queued-work depth and
    the running batch-slot fill fraction (1.0 for the unbatched sequential
    runtime)."""
    return np.array(
        [
            np.clip(queue_depth_norm, 0.0, 1.0),
            np.clip(batch_occupancy, 0.0, 1.0),
        ],
        dtype=np.float32,
    )
