"""The parts the serving engines stand on, port against the JAX package on
the CPU: the event queue (``runtime/events.py``), the micro-batch
aggregator (``runtime/batching.py``), the runtime telemetry
(``runtime/telemetry.py``), the serving context (``serving/context.py``)
and the synthetic workload (``serving/workload.py``); and the engine-free
cases of ``tests/test_runtime.py``, ``tests/test_runtime_properties.py``
and ``tests/test_event_loop_fixes.py`` run on the port.

Both packages get the same calls on seeded numpy inputs; every comparison
is exact (pop orders, batches, exported telemetry, straggler draws, masks,
quality tables, picks).  Seeded sweeps stand in for the reference's
hypothesis cases.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import context as jctx
from repro.core import policies as jpol
from repro.serving import arms as jarms
from repro.serving import context as jsctx
from repro.serving import workload as jwork
from repro.serving.engine import SimConfig
from repro.serving.obs.export import \
    export_runtime_telemetry as jexport_runtime_telemetry
from repro.serving.runtime import batching as jbatch
from repro.serving.runtime import events as jevents
from repro.serving.runtime import telemetry as jtel
from repro_torch.core import context as tctx
from repro_torch.core import policies as tpol
from repro_torch.serving import arms as tarms
from repro_torch.serving import context as sctx
from repro_torch.serving import workload
from repro_torch.serving.obs import export_runtime_telemetry
from repro_torch.serving.runtime import (DEVICE, EDGE, EventQueue,
                                         MicroBatchAggregator, WorkItem,
                                         batch_key_for, bucketize)
from repro_torch.serving.runtime.telemetry import RuntimeTelemetry

SPACES = {
    "table2": (jarms.build_action_space, tarms.build_action_space),
    "cascade": (jarms.cascade_action_space, tarms.cascade_action_space),
    "dag": (jarms.dag_action_space, tarms.dag_action_space),
}


def _request(module, rid, rng=None):
    """A ``Request`` of ``module`` (the port's or the reference's
    ``core/context``), drawn from ``rng`` or fixed."""
    if rng is None:
        return module.Request(rid=rid, arrival=0.0, complexity=0.5,
                              wants_text=False, rtt_ms=80.0, battery=0.9,
                              pref_speed=0.5, prompt_seed=rid)
    return module.Request(
        rid=rid, arrival=float(rng.exponential(9.0)),
        complexity=float(rng.uniform()), wants_text=bool(rng.uniform() < 0.3),
        rtt_ms=float(rng.uniform(10, 500)), battery=float(rng.uniform()),
        pref_speed=float(rng.uniform()), prompt_seed=int(rng.integers(1 << 20)))


def _item(rid, arm_idx, phase="edge", steps=5):
    arm = tarms.ARMS[arm_idx]
    pool = arm.edge_pool if phase == "edge" else arm.device_pool
    return WorkItem(_request(tctx, rid), arm_idx, phase, pool, steps)


def _both_items(rid, arm_idx, phase, steps):
    """The same work item in both packages."""
    arm = jarms.ARMS[arm_idx]
    pool = arm.edge_pool if phase == EDGE else arm.device_pool
    return (WorkItem(_request(tctx, rid), arm_idx, phase, pool, steps),
            jevents.WorkItem(_request(jctx, rid), arm_idx, phase, pool,
                             steps))


# ---------------------------------------------------------------------------
# the engine-free cases of tests/test_runtime.py, on the port
# ---------------------------------------------------------------------------


def test_bucketize():
    assert [bucketize(n) for n in (1, 2, 3, 4, 5, 8)] == [1, 2, 4, 4, 8, 8]
    with pytest.raises(ValueError):
        bucketize(9)
    for n in range(1, 9):
        for buckets in ((1, 2, 4, 8), (2, 8), (8,)):
            assert bucketize(n, buckets) == jbatch.bucketize(n, buckets)


def test_executor_uses_the_runtime_buckets():
    from repro_torch.serving import executor
    from repro_torch.serving.runtime import batching

    assert executor.bucketize is batching.bucketize
    assert executor.DEFAULT_BUCKETS is batching.DEFAULT_BUCKETS
    assert batching.DEFAULT_BUCKETS == jbatch.DEFAULT_BUCKETS


def test_aggregator_coalesces_only_matching_keys():
    agg = MicroBatchAggregator("sd3l", linger_s=0.25)
    for rid in range(3):
        agg.push(_item(rid, 6), now=0.0)  # s=5 relay arm
    for rid in range(3, 5):
        agg.push(_item(rid, 7), now=0.0)  # s=10 relay arm: another program
    assert agg.depth() == 5
    items, bucket = agg.next_batch(now=10.0)  # past linger
    assert [it.rid for it in items] == [0, 1, 2]
    assert bucket == 4
    assert len({batch_key_for(it) for it in items}) == 1
    items2, bucket2 = agg.next_batch(now=10.0)
    assert [it.rid for it in items2] == [3, 4] and bucket2 == 2
    assert agg.depth() == 0


def test_aggregator_lingers_then_flushes():
    agg = MicroBatchAggregator("sd3l", linger_s=0.25)
    agg.push(_item(0, 6), now=1.0)
    assert agg.next_batch(now=1.05) is None  # young sub-maximal batch waits
    assert agg.flush_deadline() == pytest.approx(1.25)
    assert agg.next_batch(now=1.05, force=True) is not None  # forced flush
    agg.push(_item(1, 6), now=2.0)
    assert agg.next_batch(now=2.3) is not None  # linger expired: dispatch


def test_aggregator_full_batch_bypasses_lingering_older_key():
    agg = MicroBatchAggregator("sd3l", linger_s=0.25)
    agg.push(_item(0, 6), now=0.0)  # older key, 1 item, still lingering
    for rid in range(1, 9):
        agg.push(_item(rid, 7), now=0.01)  # newer key fills the 8-bucket
    items, bucket = agg.next_batch(now=0.02)
    assert [it.rid for it in items] == list(range(1, 9)) and bucket == 8
    assert agg.next_batch(now=0.02) is None  # old key still lingers
    assert agg.next_batch(now=0.02, force=True) is not None


def test_aggregator_caps_batch_at_largest_bucket():
    agg = MicroBatchAggregator("sd3l")
    for rid in range(11):
        agg.push(_item(rid, 6), now=0.0)
    items, bucket = agg.next_batch(now=5.0)
    assert len(items) == 8 and bucket == 8
    assert agg.depth() == 3
    with pytest.raises(ValueError, match="pushed to"):
        agg.push(_item(11, 6, phase="device"), now=5.0)


# ---------------------------------------------------------------------------
# seeded sweeps, port against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_event_queue_pop_order_equals_reference(seed):
    """Pushes at few distinct times (many ties), reserved seq bands pushed
    lazily, pops interleaved: the same events in the same order."""
    rng = np.random.default_rng(seed)
    port, ref = EventQueue(), jevents.EventQueue()
    kinds = (jevents.ARRIVE, jevents.BATCH_DONE, jevents.FLUSH,
             jevents.DEVICE_READY, jevents.STRAGGLER, jevents.AUTOSCALE)
    popped, ref_popped, pending = [], [], []
    for step in range(400):
        u = rng.uniform()
        if u < 0.08:
            n = int(rng.integers(1, 6))
            base = port.reserve(n)
            assert base == ref.reserve(n)
            pending += [(float(rng.integers(0, 20)), base + i)
                        for i in range(n)]
        elif u < 0.2 and pending:
            t, seq = pending.pop(int(rng.integers(len(pending))))
            port.push_at(t, seq, jevents.ARRIVE, ("reserved", seq))
            ref.push_at(t, seq, jevents.ARRIVE, ("reserved", seq))
        elif u < 0.65:
            t = float(rng.integers(0, 20)) / 4
            kind = kinds[int(rng.integers(len(kinds)))]
            port.push(t, kind, step)
            ref.push(t, kind, step)
        elif port:
            popped.append(port.pop())
            ref_popped.append(ref.pop())
        assert len(port) == len(ref) and bool(port) == bool(ref)
    while port:
        popped.append(port.pop())
        ref_popped.append(ref.pop())
    assert not ref and popped == ref_popped and popped
    assert (port.n_pushed, port.n_popped, port.peak_size) == \
        (ref.n_pushed, ref.n_popped, ref.peak_size)


def test_event_queue_ties_pop_in_push_order():
    q = EventQueue()
    for i in range(5):
        q.push(1.0, jevents.FLUSH, i)
    base = q.reserve(2)
    q.push(1.0, jevents.ARRIVE, "late")
    q.push_at(1.0, base + 1, jevents.ARRIVE, "reserved-1")
    q.push_at(1.0, base, jevents.ARRIVE, "reserved-0")
    q.push(0.5, jevents.ARRIVE, "first")
    assert [q.pop()[2] for _ in range(len(q))] == [
        "first", 0, 1, 2, 3, 4, "reserved-0", "reserved-1", "late"]
    from repro_torch.serving.runtime import events

    names = ("ARRIVE", "BATCH_DONE", "DEVICE_READY", "FLUSH", "REPLICA_FAIL",
             "REPLICA_RECOVER", "STRAGGLER", "STRAGGLER_PARTIAL", "AUTOSCALE",
             "EDGE", "DEVICE")
    assert [getattr(events, n) for n in names] == \
        [getattr(jevents, n) for n in names]
    assert (EDGE, DEVICE) == (events.EDGE, events.DEVICE)


@pytest.mark.parametrize("seed", range(6))
def test_aggregator_batches_equal_reference(seed):
    """Seeded enqueues on a few arms of one pool, dispatches at random
    times, some forced, some buckets non-default: the same batches."""
    rng = np.random.default_rng(seed)
    pool = "sdxl"
    arm_ids = [a.idx for a in jarms.ARMS if a.edge_pool == pool]
    buckets = ((1, 2, 4, 8), (2, 4), (1, 3, 6))[seed % 3]
    linger = (0.25, 0.0, 1.0)[seed % 3]
    port = MicroBatchAggregator(pool, buckets=buckets, linger_s=linger)
    ref = jbatch.MicroBatchAggregator(pool, buckets=buckets, linger_s=linger)
    now, rid, batches = 0.0, 0, []
    for _ in range(300):
        now += float(rng.exponential(0.1))
        if rng.uniform() < 0.6:
            arm = arm_ids[int(rng.integers(len(arm_ids)))]
            a, b = _both_items(rid, arm, EDGE, int(rng.integers(1, 30)))
            port.push(a, now)
            ref.push(b, now)
            rid += 1
        else:
            force = bool(rng.uniform() < 0.3)
            got, want = port.next_batch(now, force), ref.next_batch(now, force)
            assert (got is None) == (want is None)
            if got is not None:
                assert [it.rid for it in got[0]] == \
                    [it.rid for it in want[0]] and got[1] == want[1]
                assert all(it.enqueue_t == jt.enqueue_t
                           for it, jt in zip(*(x[0] for x in (got, want))))
                batches.append(got[1])
        assert port.depth() == ref.depth()
        assert port.pending_steps() == ref.pending_steps()
        assert port.flush_deadline() == ref.flush_deadline()
    assert batches


@pytest.mark.parametrize("seed", range(3))
def test_runtime_telemetry_export_equals_reference(seed):
    rng = np.random.default_rng(seed)
    port, ref = RuntimeTelemetry(), jtel.RuntimeTelemetry()
    pools = list(tarms.POOL_REPLICAS)
    for _ in range(2000):
        pool = pools[int(rng.integers(len(pools)))]
        op = int(rng.integers(8))
        args = {
            0: ("record_depth", (pool, float(rng.uniform(0, 100)),
                                 int(rng.integers(0, 20)))),
            1: ("record_batch", (pool, int(rng.integers(1, 9)), 8,
                                 float(rng.exponential(2.0)),
                                 bool(rng.integers(2)))),
            2: ("record_transfer", (pool, int(rng.integers(1, 5000)),
                                    int(rng.integers(1, 9)))),
            3: ("record_failure", (pool, bool(rng.integers(2)))),
            4: ("record_autoscale_tick", ()),
            5: ("record_scale", (pool, bool(rng.integers(2)))),
            6: ("record_straggler", (bool(rng.integers(2)),
                                     bool(rng.integers(2)))),
            7: ("record_reissue", (pool, int(rng.integers(0, 8)),
                                   bool(rng.integers(2)))),
        }[op]
        getattr(port, args[0])(*args[1])
        getattr(ref, args[0])(*args[1])
    out = export_runtime_telemetry(port)
    assert out == jexport_runtime_telemetry(ref) and set(out) == set(pools)
    assert port.faults.as_dict() == ref.faults.as_dict()
    assert port.autoscale.as_dict() == ref.autoscale.as_dict()
    for p in pools:
        assert port.pools[p].occupancy == ref.pools[p].occupancy
        assert port.pools[p].mean_batch == ref.pools[p].mean_batch
        assert port.pools[p].depth.summary() == ref.pools[p].depth.summary()


# ---------------------------------------------------------------------------
# serving/context.py
# ---------------------------------------------------------------------------

#: SimConfig field sets; the port's functions get a plain namespace with
#: the fields, the reference's its own SimConfig
CONFIGS = [
    dict(),
    dict(seed=7, max_queue=2, straggler_prob=0.3, straggler_factor=6.0,
         straggler_reissue=2.5, straggler_mode="batch",
         fail_replica=("sdxl", 1, 10.0, 40.0)),
    dict(seed=123, max_queue=8, straggler_prob=1.0, straggler_factor=2.0,
         straggler_reissue=3.0,
         fail_replica=(("vega", 0, 5.0, 9.0), ("vega", 1, 6.0, 50.0)),
         pool_replicas={"sdxl": 3, "vega": 1, "sd3l": 2, "sd3m": 4,
                        "ssd1b": 1, "sd3lt": 2}),
    dict(seed=2**20, straggler_prob=0.05, straggler_factor=50.0,
         straggler_reissue=1.0, telemetry_context=True),
]


def _configs(fields):
    ref = SimConfig(**fields)
    return SimpleNamespace(**dataclasses.asdict(ref)), ref


@pytest.mark.parametrize("fields", CONFIGS,
                         ids=lambda f: f"seed{f.get('seed', 0)}")
def test_context_functions_equal_reference(fields):
    cfg, ref = _configs(fields)
    assert sctx.backlog_horizon(cfg) == jsctx.backlog_horizon(ref)
    inv = sctx.pool_inventory(cfg)
    assert inv == jsctx.pool_inventory(ref)
    assert list(inv) == list(jsctx.pool_inventory(ref)) == \
        list(tarms.POOL_REPLICAS)
    assert sctx.failure_schedule(cfg) == jsctx.failure_schedule(ref)
    assert sctx.straggler_mode(cfg) == jsctx.straggler_mode(ref)
    rids = list(range(200)) + [10_000, 2**31 - 1]
    draws = [sctx.straggler_slow(cfg, r) for r in rids]
    assert draws == [jsctx.straggler_slow(ref, r) for r in rids]
    for start in (0, 50, 150):
        batch = rids[start:start + 8]
        assert sctx.partition_stragglers(cfg, batch) == \
            jsctx.partition_stragglers(ref, batch)
    tel = fields.get("telemetry_context", False)
    assert sctx.context_dim(tel) == jsctx.context_dim(tel)


def test_context_pure_functions_equal_reference():
    rng = np.random.default_rng(0)
    assert sctx.POOL_GROUPS == jsctx.POOL_GROUPS
    assert sctx.STRAGGLER_MODES == jsctx.STRAGGLER_MODES
    for pool in tarms.POOL_REPLICAS:
        assert sctx.pool_key(pool) == jsctx.pool_key(pool)
    for _ in range(50):
        occ = {p: float(rng.uniform()) for p in tarms.POOL_REPLICAS}
        assert sctx.aggregate_occupancy(occ) == jsctx.aggregate_occupancy(occ)
    for q, b in ((0.3, 0.7), (-1.0, 2.0), (1.5, -0.5), (0.0, 1.0)):
        out = sctx.telemetry_features(q, b)
        want = jsctx.telemetry_features(q, b)
        assert out.dtype == want.dtype == np.float32
        assert np.array_equal(out, want)


def test_context_rejects_what_the_reference_rejects():
    for bad in (dict(straggler_mode="sometimes"),
                dict(pool_replicas={"sdxl": 2}),
                dict(pool_replicas={**tarms.POOL_REPLICAS, "vega": 0})):
        cfg, ref = _configs(bad)
        for fn, jfn in ((sctx.straggler_mode, jsctx.straggler_mode),
                        (sctx.pool_inventory, jsctx.pool_inventory)):
            try:
                jfn(ref)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    fn(cfg)
                assert str(got.value) == str(e)
            else:
                assert fn(cfg) == jfn(ref)


@pytest.mark.parametrize("space", list(SPACES))
def test_fallback_avail_equals_reference(space):
    jspace, tspace = (f() for f in SPACES[space])
    pools = sorted({p for a in tspace for p in a.program.pools})
    rng = np.random.default_rng(len(pools))
    for _ in range(200):
        alive = {p: int(rng.integers(0, 3)) * int(rng.uniform() < 0.7)
                 for p in pools}
        out = sctx.fallback_avail(tspace, alive)
        assert np.array_equal(out, jsctx.fallback_avail(jspace, alive))
    dead = {p: 0 for p in pools}
    assert sctx.fallback_avail(tspace, dead).all()


def test_fallback_all_pools_dead_degrades_gracefully():
    avail = sctx.fallback_avail(
        tarms.ARMS, {p: 0 for p in {p for a in tarms.ARMS
                                    for p in a.program.pools}})
    assert avail.all()


@pytest.mark.parametrize("seed", range(5))
def test_straggler_slow_is_request_intrinsic(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        prob = float(rng.choice([0.0, 1.0, rng.uniform()]))
        factor = float(rng.uniform(1.0, 50.0))
        cfg = SimpleNamespace(seed=int(rng.integers(0, 2**20)),
                              straggler_prob=prob, straggler_factor=factor)
        rid = int(rng.integers(0, 10_000))
        a = sctx.straggler_slow(cfg, rid)
        assert a == sctx.straggler_slow(cfg, rid)  # deterministic
        assert a in (1.0, float(factor))
        if prob == 0.0:
            assert a == 1.0
        assert a == jsctx.straggler_slow(
            SimConfig(seed=cfg.seed, straggler_prob=prob,
                      straggler_factor=factor), rid)


# ---------------------------------------------------------------------------
# serving/workload.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("space", list(SPACES))
def test_synthetic_quality_table_equals_reference(space):
    jspace, tspace = (f() for f in SPACES[space])
    reqs = [_request(tctx, i, np.random.default_rng(i)) for i in range(24)]
    jreqs = [_request(jctx, i, np.random.default_rng(i)) for i in range(24)]
    out = workload.synthetic_quality_table(reqs, arms=tspace)
    want = jwork.synthetic_quality_table(jreqs, arms=jspace)
    assert out.shape == want.shape == (24, len(tspace))
    assert out.dtype == want.dtype == object
    assert all(a == b for a, b in zip(out.ravel(), want.ravel()))
    if space == "table2":
        default = workload.synthetic_quality_table(reqs)
        assert all(a == b for a, b in zip(default.ravel(), want.ravel()))


def test_cycle_policy_picks_equal_reference():
    port, ref = workload.CyclePolicy(), jwork.CyclePolicy()
    assert isinstance(port, tpol.Policy) and port.name == ref.name == "Cycle"
    rng = np.random.default_rng(3)
    for _ in range(60):
        k = int(rng.choice([11, 15]))
        avail = rng.uniform(size=k) < 0.5
        ctx = rng.uniform(size=8).astype(np.float32)
        assert port.select(ctx, avail) == ref.select(ctx, avail)
    port.update(ctx, 0, 1.0)  # a no-op, as the base class's
    assert isinstance(ref, jpol.Policy)
