"""The sequential serving engine, the port against the JAX package on the
CPU (``repro_torch/serving/engine.py`` against ``repro/serving/engine.py``,
``runtime="sequential"``).

Each case builds the same ``SimConfig`` in both packages, draws each
package's requests with its own ``make_requests`` and serves them over
each package's ``serving/workload.py::synthetic_quality_table``.

Tolerances:
* uncompressed (``runtime_cfg=None``, the reference's default for this
  engine): every ``Record`` field, the fault counters, ``engine.trace``
  and the tracer's Chrome export equal bit for bit;
* compressed (``RuntimeConfig()``, int8 handoffs): arms, ``t_total``,
  ``wait_s``, contexts, fault counters and each DAG Select's decision
  exact.  Quality values and rewards within ``COMPRESSED_RTOL`` of
  ``max(|ref|, 1)``, each Select's deviation and bound (percent) within
  ``SELECT_PCT_RTOL`` of it.  The cause is the int8 round trip's measured
  error (``HandoffTransport.handoff_error``), which differs across
  frameworks in its last bits: 2.6e-7 relative for XL and 6.8e-7 for F3
  here (``tests/test_torch_transport.py`` holds it at 1e-5).  Read over
  every compressed case of this file: quality and reward 8.4e-8 at most
  (a reward; quality values 9.3e-9), so the bound 5e-7 is 6x the reading;
  Select percentages 5.1e-7, so 2e-6 is 3.9x;
* RISE draws its sampled arms from a ``torch.Generator``, not
  ``jax.random``, so it is held by replay: the reference's RISE serves the
  stream, and its arms go through the port's engine into a port
  ``RisePolicy`` (``ReplayPolicy``, which checks that each forced pick
  is the port's own).  The records are then equal as above,
  the counts exact, ``A`` within 1 ulp per update of each arm and on its
  diagonal only (the reference jits the update, and XLA fuses the
  diagonal's ``c_i·c_i + λ`` into one multiply-add), and ``b`` exact
  uncompressed and within 1 ulp per update compressed (its rewards differ
  in their last bits).  Read: ``A`` 1 ulp at most (after up to 31 updates
  of an arm), ``b`` 0 in all four streams.

Then the reference's engine cases (``tests/test_serving.py``,
``test_event_loop_fixes.py``, ``test_runtime_properties.py``,
``test_program_ir.py``, ``test_obs.py``, ``test_dag.py``), their
sequential and their continuous halves, each written once over a package
and run on both, their observables compared; and the engine's guards.
The continuous runtime's own suite is ``tests/test_torch_runtime.py``.
"""
from __future__ import annotations

import dataclasses
import json
import tempfile
import warnings
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import context as jcore_ctx
from repro.core import policies as jpol
from repro.core import program as jprog
from repro.core import reward as jrew
from repro.launch import serve as jserve
from repro.serving import arms as jarms
from repro.serving import context as jsctx
from repro.serving import engine as je
from repro.serving import latency as jlat
from repro.serving import obs as jobs
from repro.serving import runtime as jrt
from repro.serving.runtime import engine as jrteng
from repro.serving import workload as jwork
from repro_torch.core import context as tcore_ctx
from repro_torch.core import policies as tpol
from repro_torch.core import program as tprog
from repro_torch.core import reward as trew
from repro_torch.launch import serve as tserve
from repro_torch.serving import arms as tarms
from repro_torch.serving import context as tsctx
from repro_torch.serving import engine as te
from repro_torch.serving import latency as tlat
from repro_torch.serving import obs as tobs
from repro_torch.serving import runtime as trt
from repro_torch.serving.runtime import engine as trteng
from repro_torch.serving import workload as twork

torch.set_num_threads(1)



class ReplayPolicy:
    """Serves another run's arms in order, each asserted available, and
    feeds every update to ``inner``, a port RisePolicy.  Where ``inner``
    is in its forced branch (an available arm pulled fewer than ``n_min``
    times), the replayed arm must be ``inner``'s own pick; ``forced``
    counts those decisions.  Its sampled picks are not compared: the two
    packages draw from different generators."""

    name = "Replay"

    def __init__(self, seq, inner):
        self.seq, self.inner, self.arms = list(seq), inner, inner.arms
        self.i = self.forced = 0

    def select(self, ctx, avail):
        arm = self.seq[self.i]
        assert avail[arm], (self.i, arm)
        counts = self.inner.state.counts.cpu().numpy()
        mask = np.asarray(self.inner._mask(avail), bool)
        if (mask & (counts < self.inner.p.n_min)).any():
            assert self.inner.select(ctx, avail) == arm, (self.i, arm)
            self.forced += 1
        self.i += 1
        return arm

    def update(self, ctx, arm, reward):
        self.inner.update(ctx, arm, reward)


def _joins(tracer) -> list:
    """Every DAG join's (rid, name, accepted, winner), in trace order."""
    return [(tr.rid, s.name, s.meta.get("accepted"), s.meta.get("winner"))
            for tr in tracer.requests.values() for s in tr.spans
            if s.kind == "join"]


COMPRESSED_RTOL = 5e-7
SELECT_PCT_RTOL = 2e-6


def _first_avail(base):
    class FirstAvailPolicy(base):
        """Lowest-index available arm (``tests/test_event_loop_fixes.py``):
        deterministic and sensitive to the availability mask."""

        name = "FirstAvail"

        def select(self, ctx, avail):
            for i, ok in enumerate(avail):
                if ok:
                    return int(i)
            return 0

    return FirstAvailPolicy


# each package's modules, and the keywords its device-holding
# constructors take (the port's run on the card unless told otherwise)
REF = SimpleNamespace(
    eng=je, pol=jpol, arms=jarms, work=jwork, obs=jobs, rt=jrt, sctx=jsctx,
    lat=jlat, ctx=jcore_ctx, rew=jrew, rteng=jrteng, serve=jserve, dev={},
    FirstAvail=_first_avail(jpol.Policy))
PORT = SimpleNamespace(
    eng=te, pol=tpol, arms=tarms, work=twork, obs=tobs, rt=trt, sctx=tsctx,
    lat=tlat, ctx=tcore_ctx, rew=trew, rteng=trteng, serve=tserve,
    dev={"device": "cpu"}, FirstAvail=_first_avail(tpol.Policy))

SPACES = ("table2", "cascade", "dag")


def _space(P, name):
    return {"table2": P.arms.build_action_space,
            "cascade": P.arms.cascade_action_space,
            "dag": P.arms.dag_action_space}[name]()


DEAD_VEGA = [("vega", 0, 0.0, np.inf), ("vega", 1, 0.0, np.inf)]

# (SimConfig fields, engine keywords, policy) of each stream
SCENARIOS = {
    "mu9": (dict(n_requests=40, seed=3), {}, "greedy"),
    "mu1": (dict(n_requests=60, mean_interarrival=1.0, seed=4), {}, "cycle"),
    "straggler_item": (dict(n_requests=50, mean_interarrival=2.0, seed=5,
                            straggler_prob=0.3, straggler_factor=6.0), {},
                       "cycle"),
    "straggler_batch": (dict(n_requests=50, mean_interarrival=2.0, seed=6,
                             straggler_prob=0.15, straggler_factor=6.0,
                             straggler_mode="batch"), {}, "cycle"),
    "outage": (dict(n_requests=60, mean_interarrival=1.0, seed=7,
                    fail_replica=("sdxl", 0, 10.0, 40.0)), {}, "greedy"),
    "dead_pool": (dict(n_requests=24, mean_interarrival=1.0, seed=5,
                       max_queue=0, fail_replica=DEAD_VEGA), {}, "greedy"),
    "telemetry_context": (dict(n_requests=40, mean_interarrival=1.5, seed=8,
                               telemetry_context=True), {}, "cycle"),
    "pool_replicas": (dict(n_requests=50, mean_interarrival=1.0, seed=9,
                           pool_replicas={**tarms.POOL_REPLICAS, "sdxl": 1,
                                          "vega": 3}), {}, "greedy"),
    "static_reward": (dict(n_requests=40, mean_interarrival=2.0, seed=10),
                      {"dynamic_reward": False}, "cycle"),
}


def _policy(P, name):
    return {"cycle": P.work.CyclePolicy, "greedy": P.pol.GreedyPolicy,
            "rr": P.pol.RoundRobinPolicy}[name]()


def _engine(P, policy, qt, cfg, runtime="sequential", **kw):
    """``P``'s engine, sequential unless told otherwise (the port's on the
    CPU)."""
    return P.eng.ServingEngine(policy, qt, cfg, runtime=runtime, **P.dev,
                               **kw)


def _serve_one(P, space, sim_kw, eng_kw, policy, compress):
    arms = _space(P, space)
    cfg = P.eng.SimConfig(**sim_kw)
    reqs = P.eng.make_requests(cfg)
    qt = P.work.synthetic_quality_table(reqs, arms)
    pol = policy if not isinstance(policy, str) else _policy(P, policy)
    eng = _engine(P, pol, qt, cfg, arms=arms,
                  runtime_cfg=P.rt.RuntimeConfig() if compress else None,
                  **eng_kw)
    return eng.run(reqs), eng


def _serve(space, sim_kw, eng_kw=None, policy="cycle", compress=False):
    """The same stream served by both packages' sequential engines.
    Returns ((records, engine) of the reference, of the port)."""
    return tuple(_serve_one(P, space, sim_kw, eng_kw or {}, policy, compress)
                 for P in (REF, PORT))


def _assert_exact_fields(jrecs, trecs):
    assert len(jrecs) == len(trecs)
    for a, b in zip(jrecs, trecs):
        assert (a.rid, a.arm, a.t_total, a.wait_s) == \
            (b.rid, b.arm, b.t_total, b.wait_s)
        assert type(b.t_total) is type(a.t_total)
        assert np.array_equal(a.ctx, b.ctx) and a.ctx.dtype == b.ctx.dtype


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(a), 1.0)


def _worst_rel(jrecs, trecs) -> float:
    """The largest ``|port − ref| / max(|ref|, 1)`` over every reward and
    quality value."""
    worst = 0.0
    for a, b in zip(jrecs, trecs):
        assert a.quality.keys() == b.quality.keys()
        worst = max([worst, _rel(a.reward, b.reward)]
                    + [_rel(a.quality[k], b.quality[k]) for k in a.quality])
    return worst


# ---------------------------------------------------------------------------
# the request stream and the pools
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sim_kw,seed0", [
    (dict(), 0),
    (dict(n_requests=37, mean_interarrival=1.0, seed=10), 50_000),
    (dict(n_requests=60, seed=20), 90_000),
    (dict(n_requests=25, mean_interarrival=0.3, seed=123), 7),
])
def test_make_requests_equals_reference(sim_kw, seed0):
    jr = je.make_requests(je.SimConfig(**sim_kw), seed0=seed0)
    tr = te.make_requests(te.SimConfig(**sim_kw), seed0=seed0)
    assert len(tr) == len(jr) == je.SimConfig(**sim_kw).n_requests
    for a, b in zip(jr, tr):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert [type(v) for v in dataclasses.asdict(a).values()] == \
            [type(v) for v in dataclasses.asdict(b).values()]


def test_sim_and_runtime_configs_equal_reference():
    assert dataclasses.asdict(te.SimConfig()) == \
        dataclasses.asdict(je.SimConfig())
    j_fields = dataclasses.fields(jrt.RuntimeConfig)
    t_fields = dataclasses.fields(trt.RuntimeConfig)
    assert [f.name for f in t_fields] == [f.name for f in j_fields]
    assert len(t_fields) == 9
    assert dataclasses.asdict(trt.RuntimeConfig()) == \
        dataclasses.asdict(jrt.RuntimeConfig())


_POOLS = list(tarms.POOL_REPLICAS)
_times = st.floats(0.0, 60.0)
_outage = st.tuples(st.sampled_from(_POOLS), st.integers(0, 2), _times,
                    st.one_of(st.floats(0.0, 40.0), st.just(np.inf)))
_acquire = st.tuples(st.sampled_from(_POOLS), _times, st.floats(0.0, 15.0))


@settings(max_examples=60, deadline=None)
@given(outages=st.lists(_outage, max_size=4),
       ops=st.lists(_acquire, min_size=1, max_size=30),
       extra=st.booleans())
def test_pools_equal_reference(outages, ops, extra):
    """A drawn sequence of ``acquire`` calls (failover, and the wait for
    the earliest recovery when a whole pool is out), with ``n_alive``,
    ``occupancy`` and ``backlog`` of every pool read before each."""
    outages = [(p, i, t, t + d) for p, i, t, d in outages]
    kw = dict(fail_replica=outages or None,
              pool_replicas=({**tarms.POOL_REPLICAS, "sdxl": 3, "sd3m": 1}
                             if extra else None))
    jp, tp = je.Pools(je.SimConfig(**kw)), te.Pools(te.SimConfig(**kw))
    assert tp.inventory == jp.inventory and tp.schedule == jp.schedule
    for pool, ready, duration in ops:
        for p in tp.inventory:
            assert tp.n_alive(p, ready) == jp.n_alive(p, ready)
            assert tp.occupancy(p, ready) == jp.occupancy(p, ready)
            assert tp.backlog(p, ready) == jp.backlog(p, ready)
        assert tp.acquire(pool, ready, duration) == \
            jp.acquire(pool, ready, duration)
        assert tp.free_at == jp.free_at


# ---------------------------------------------------------------------------
# records: bit for bit uncompressed, within the round trip's error
# compressed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("space", SPACES)
def test_records_uncompressed_bit_for_bit(space, scenario):
    sim_kw, eng_kw, policy = SCENARIOS[scenario]
    (jrecs, jeng), (trecs, teng) = _serve(space, sim_kw, eng_kw, policy)
    _assert_exact_fields(jrecs, trecs)
    for a, b in zip(jrecs, trecs):
        assert a.reward == b.reward and type(b.reward) is type(a.reward)
        assert a.quality == b.quality
    assert teng.fault_counters.as_dict() == jeng.fault_counters.as_dict()
    assert teng.trace == jeng.trace
    assert json.dumps(tobs.to_chrome_trace(teng.tracer)) == \
        json.dumps(jobs.to_chrome_trace(jeng.tracer))
    assert teng.n_arms == jeng.n_arms == len(_space(PORT, space))
    fc = teng.fault_counters
    if scenario.startswith("straggler"):
        assert fc.stragglers_injected > 0
    if scenario in ("outage", "dead_pool"):
        assert fc.replica_failures > 0
    if scenario == "dead_pool":
        assert all("vega" not in _space(PORT, space)[r.arm].program.pools
                   for r in trecs)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("space", SPACES)
def test_records_compressed(space, scenario):
    sim_kw, eng_kw, policy = SCENARIOS[scenario]
    (jrecs, jeng), (trecs, teng) = _serve(space, sim_kw, eng_kw, policy,
                                          compress=True)
    _assert_exact_fields(jrecs, trecs)
    worst = _worst_rel(jrecs, trecs)
    assert worst <= COMPRESSED_RTOL, worst
    assert teng.fault_counters.as_dict() == jeng.fault_counters.as_dict()
    assert _joins(teng.tracer) == _joins(jeng.tracer)
    for fam in ("XL", "F3"):
        err, ref = (e.transport.handoff_error(fam) for e in (teng, jeng))
        assert err > 0.0 and abs(err - ref) <= 1e-5 * ref


def test_dag_select_rejects_as_the_reference_does():
    """Every request on the first speculative arm: its Select rejects
    above a complexity of about 0.98, and both engines take the same
    decisions (the deviation and its bound scale alike with the measured
    round-trip error, so only the last bits of the error differ)."""
    def fixed(P):
        class Fixed(P.pol.Policy):
            def select(self, ctx, avail):
                return 11
        return Fixed()

    (jrecs, jeng), (trecs, teng) = (
        _serve_one(P, "dag", dict(n_requests=150, seed=17), {}, fixed(P),
                   True) for P in (REF, PORT))
    _assert_exact_fields(jrecs, trecs)
    assert _worst_rel(jrecs, trecs) <= COMPRESSED_RTOL
    got = [acc for _, name, acc, _ in _joins(teng.tracer)
           if name.startswith("join:select")]
    assert len(got) == 150 and set(got) == {True, False}
    assert _joins(teng.tracer) == _joins(jeng.tracer)


# ---------------------------------------------------------------------------
# RISE by replay
# ---------------------------------------------------------------------------


def _ulps(a, b) -> np.ndarray:
    a, b = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
            for x in (a, b))
    return np.abs(a - b)


@pytest.mark.parametrize("space,sim_kw,ctx_dim,compress", [
    ("table2", dict(n_requests=80, mean_interarrival=1.5, seed=12), 8, False),
    ("dag", dict(n_requests=60, mean_interarrival=1.0, seed=13), 8, False),
    ("table2", dict(n_requests=60, mean_interarrival=1.0, seed=14,
                    telemetry_context=True, straggler_prob=0.2,
                    straggler_factor=6.0), 10, False),
    ("cascade", dict(n_requests=70, mean_interarrival=2.0, seed=15), 8, True),
])
def test_rise_by_replay(space, sim_kw, ctx_dim, compress):
    jspace, tspace = _space(REF, space), _space(PORT, space)
    jrise = jpol.RisePolicy(seed=0, arms=jspace, ctx_dim=ctx_dim)
    (jrecs, jeng) = _serve_one(REF, space, sim_kw, {}, jrise, compress)
    trise = tpol.RisePolicy(seed=0, arms=tspace, ctx_dim=ctx_dim,
                            device="cpu")
    replay = ReplayPolicy([r.arm for r in jrecs], trise)
    (trecs, teng) = _serve_one(PORT, space, sim_kw, {}, replay, compress)
    assert replay.i == len(jrecs) and replay.forced == 3 * len(tspace)
    _assert_exact_fields(jrecs, trecs)
    if compress:
        assert _worst_rel(jrecs, trecs) <= COMPRESSED_RTOL
    else:
        for a, b in zip(jrecs, trecs):
            assert a.reward == b.reward and a.quality == b.quality
    assert teng.fault_counters.as_dict() == jeng.fault_counters.as_dict()
    counts = np.asarray(jrise.state.counts)
    np.testing.assert_array_equal(trise.state.counts.numpy(), counts)
    assert counts.sum() == len(jrecs) and (counts > 3).sum() > 1
    db = _ulps(trise.state.b.numpy(), jrise.state.b)
    assert (db.max(axis=1) <= (counts if compress else 0)).all()
    d = _ulps(trise.state.A.numpy(), jrise.state.A)
    assert not d[:, ~np.eye(ctx_dim, dtype=bool)].any()
    assert (d.reshape(len(counts), -1).max(axis=1) <= counts).all()


# ---------------------------------------------------------------------------
# summarize, graph_quality and the helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("compress", [False, True])
def test_summarize_equals_reference(space, compress):
    (jrecs, _), (trecs, teng) = _serve(
        space, dict(n_requests=60, mean_interarrival=1.0, seed=15),
        compress=compress)
    for n_arms in (None, teng.n_arms):
        js, ts = je.summarize(jrecs, n_arms), te.summarize(trecs, n_arms)
        assert ts.keys() == js.keys()
        assert ts["arm_histogram"] == js["arm_histogram"]
        assert len(ts["arm_histogram"]) == max(n_arms or tarms.N_ARMS,
                                               1 + max(r.arm for r in trecs))
        for k, v in js.items():
            if k == "arm_histogram":
                continue
            if compress:
                assert _rel(v, ts[k]) <= COMPRESSED_RTOL, (k, v, ts[k])
            else:
                assert ts[k] == v, (k, v, ts[k])
    for a, b in zip(jrecs, trecs):
        x, y = je._quality_part(a), te._quality_part(b)
        assert x == y or (compress and _rel(x, y) <= COMPRESSED_RTOL)


@pytest.mark.parametrize("compress", [False, True])
def test_graph_quality_equals_reference(compress):
    jt = jrt.HandoffTransport(jrt.TransportConfig(compress=compress))
    tt = trt.HandoffTransport(trt.TransportConfig(compress=compress),
                              device="cpu")
    q0 = {"clip": 0.31, "ir": -0.42, "pick": 0.21, "aes": 5.2, "ocr": 0.1}
    jspace, tspace = jarms.dag_action_space(), tarms.dag_action_space()
    seen = set()
    for ja, ta in zip(jspace, tspace):
        jplan, tplan = (jprog.compile_plan(jprog.as_graph(ja.program)),
                        tprog.compile_plan(tprog.as_graph(ta.program)))
        for complexity in (0.05, 0.5, 0.99):
            for base_pct in (0.3, 4.0):
                jd = {nid: jprog.select_outcome(jplan, nid, complexity,
                                                base_pct)
                      for nid in jplan.selects}
                td = {nid: tprog.select_outcome(tplan, nid, complexity,
                                                base_pct)
                      for nid in tplan.selects}
                assert td == jd
                seen |= {acc for acc, _, _ in td.values()}
                a = je.graph_quality(jt, jplan, ja, jd, base_pct, q0)
                b = te.graph_quality(tt, tplan, ta, td, base_pct, q0)
                sink = tplan.nodes[tplan.index[tplan.sink]].kind
                if compress and sink != "select":
                    assert all(_rel(a[k], b[k]) <= COMPRESSED_RTOL
                               for k in a)
                else:
                    assert b == a
    assert seen == {True, False}
    for ja, ta in zip(jspace, tspace):
        tp, jp = te._static_plan(ta), je._static_plan(ja)
        assert (tp is None) == (jp is None)
        if tp is not None:
            assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        for p in ta.program.pools:
            assert te._pool_key(p) == je._pool_key(p)


# ---------------------------------------------------------------------------
# the reference's sequential cases, each written once over a package and
# run on both; every case returns its observables, which must be equal
# (``exact``) or, from compressed runs, within COMPRESSED_RTOL (``approx``,
# quality and reward) and SELECT_PCT_RTOL (``select_pct``, each Select's
# deviation and bound)
# ---------------------------------------------------------------------------


def _records(recs) -> list:
    return [(r.rid, r.arm, r.reward, r.t_total, r.wait_s) for r in recs]


def _watch_forced(policy):
    """Counts the decisions a RisePolicy takes in its forced branch until
    its first sampled one (the reference's and the port's forced picks
    are the same function of the counts and the mask; its sampled ones
    come from different generators).  Returns a list that holds the
    count."""
    prefix, select = [0, True], policy.select

    def watched(ctx, avail):
        counts = np.asarray(policy.state.counts)
        mask = np.asarray(policy._mask(avail), bool)
        prefix[1] = prefix[1] and bool((mask & (counts < policy.p.n_min))
                                       .any())
        prefix[0] += prefix[1]
        return select(ctx, avail)

    policy.select = watched
    return prefix


# tests/test_serving.py: its structured quality table and run_policy, on
# the sequential runtime


def _serving_table(P, n, **sim_kw):
    reqs = P.eng.make_requests(P.eng.SimConfig(n_requests=n, seed=3,
                                               **sim_kw))
    qt = np.empty((n, P.arms.N_ARMS), dtype=object)
    for i, r in enumerate(reqs):
        for a in P.arms.ARMS:
            base = 0.55 + (0.1 * (a.relay_step or 0) / 25.0)
            fam_bonus = 0.05 if a.family == "F3" else 0.0
            ocr = 0.0
            if r.wants_text:
                ocr = 0.75 if a.family == "F3" else 0.08
            qt[i, a.idx] = {"clip": base + fam_bonus, "ir": base,
                            "pick": 0.2 + 0.03 * base, "aes": 5.0 + base,
                            "ocr": ocr}
    return reqs, qt


def _run_policy(P, policy, n=150, **sim_kw):
    cfg = P.eng.SimConfig(n_requests=n, seed=3, **sim_kw)
    reqs, qt = _serving_table(P, n, mean_interarrival=cfg.mean_interarrival)
    recs = _engine(P, policy, qt, cfg).run(reqs)
    return recs, P.eng.summarize(recs)


def _rise(P, **kw):
    return P.pol.RisePolicy(seed=0, **P.dev, **kw)


def _forced_records(P, n, **kw):
    """RISE over ``_run_policy``'s stream; returns the records of its
    forced prefix and the summary."""
    policy = _rise(P, **kw)
    prefix = _watch_forced(policy)
    recs, s = _run_policy(P, policy, n=n)
    assert prefix[0] >= 3 * P.arms.N_ARMS
    return _records(recs[:prefix[0]]), s, recs


def case_engine_runs_and_reports(P):
    recs, s = _run_policy(P, P.pol.RoundRobinPolicy())
    assert len(recs) == 150
    assert s["mean_latency_s"] > 0
    assert len(s["arm_histogram"]) == P.arms.N_ARMS
    assert all(np.isfinite(r.reward) for r in recs)
    return {"exact": (_records(recs), s)}


def case_rise_beats_round_robin(P):
    forced, s_rise, _ = _forced_records(P, 250)
    rr, s_rr = _run_policy(P, P.pol.RoundRobinPolicy(), n=250)
    assert s_rise["total_reward"] > s_rr["total_reward"]
    return {"exact": (forced, _records(rr))}


def case_rise_routes_text_to_f3(P):
    forced, _, recs = _forced_records(P, 300)
    text_arms = [r.arm for r in recs[100:] if r.ctx[1] > 0.5]
    f3_frac = np.mean([P.arms.ARMS[a].family == "F3" for a in text_arms])
    assert f3_frac > 0.5, f"only {f3_frac:.0%} of text requests on F3"
    return {"exact": forced}


def case_queueing_adds_wait_under_load(P):
    _, s_fast = _run_policy(P, P.pol.RoundRobinPolicy(), n=100)
    _, s_slow = _run_policy(P, P.pol.RoundRobinPolicy(), n=100,
                            mean_interarrival=1.0)
    assert s_slow["mean_latency_s"] > s_fast["mean_latency_s"]
    return {"exact": (s_fast, s_slow)}


def case_replica_failover(P):
    recs, _ = _run_policy(P, P.pol.RoundRobinPolicy(), n=120,
                          fail_replica=("sdxl", 0, 100.0, 500.0))
    assert len(recs) == 120
    assert all(r.t_total > 0 for r in recs)
    return {"exact": _records(recs)}


def case_straggler_reissue_bounds_latency(P):
    _, s0 = _run_policy(P, P.pol.GreedyPolicy(), n=100)
    _, s1 = _run_policy(P, P.pol.GreedyPolicy(), n=100, straggler_prob=0.3,
                        straggler_factor=10.0)
    assert s1["p95_latency_s"] < s0["p95_latency_s"] * 6
    return {"exact": (s0, s1)}


def case_ppo_sac_train_and_run(P):
    reqs, qt = _serving_table(P, 120)
    rng = np.random.default_rng(0)
    ctxs = np.stack([
        P.ctx.context_vector(r, {"vega": rng.uniform(), "sdxl": rng.uniform(),
                                 "sd3": rng.uniform()})
        for r in reqs
    ])

    def reward_fn(i, arm):
        a = P.arms.ARMS[arm]
        lb = P.lat.arm_latency(a, P.eng._static_plan(a), reqs[i].rtt_ms)
        return P.rew.compute_reward(P.rew.RewardInputs(
            quality=qt[i, arm], t_total=lb.total, m_vram=P.lat.arm_vram(a),
            l_dev=float(ctxs[i][5:].max()),
            c_txt=ctxs[i][1], c_pref=ctxs[i][4], c_bat=ctxs[i][3],
        ))

    for cls in (P.pol.PPOPolicy, P.pol.SACPolicy):
        p = cls(seed=0, **P.dev)
        p.train_offline(ctxs, reward_fn, epochs=3)
        arm = p.select(ctxs[0], np.ones(P.arms.N_ARMS, bool))
        assert 0 <= arm < P.arms.N_ARMS
    rewards = [[reward_fn(i, a) for a in range(P.arms.N_ARMS)]
               for i in range(len(reqs))]
    return {"exact": (ctxs.tolist(), rewards)}


def case_ablation_variants_construct(P):
    out = []
    for kw in (dict(use_context=False), dict(forced_exploration=False),
               dict(fixed_relay_step=15)):
        policy = _rise(P, **kw)
        prefix = _watch_forced(policy)
        recs, s = _run_policy(P, policy, n=60)
        assert np.isfinite(s["total_reward"])
        out.append(_records(recs[:prefix[0]]))
    assert out[1] == []  # no forced branch
    return {"exact": out}


def case_serve_no_compress_resolves(P):
    """``test_serve_no_compress_resolves_for_both_runtimes``:
    ``launch/serve.py``'s ``resolve_runtime_config`` sets
    ``compress_handoff`` for either runtime, and the engine's transport
    follows it."""
    out = []
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for runtime in ("sequential", "continuous"):
            for no_compress in (True, False):
                rc = P.serve.resolve_runtime_config(runtime,
                                                    no_compress=no_compress)
                assert rc.compress_handoff is (not no_compress)
                assert rc.profiler is None
                eng = _engine(P, P.work.CyclePolicy(), None,
                              P.eng.SimConfig(), runtime=runtime,
                              runtime_cfg=rc)
                assert eng.transport.cfg.compress is (not no_compress)
                out.append((dataclasses.asdict(rc),
                            dataclasses.asdict(eng.transport.cfg)))
        rc = P.serve.resolve_runtime_config("continuous", False, profile=True)
        assert isinstance(rc.profiler, P.obs.EventLoopProfiler)
    return {"exact": out}


# tests/test_event_loop_fixes.py


def _dead_vega(P):
    cfg = P.eng.SimConfig(n_requests=24, mean_interarrival=1.0, seed=5,
                          max_queue=0, fail_replica=DEAD_VEGA)
    reqs = P.eng.make_requests(cfg)
    return cfg, reqs, P.work.synthetic_quality_table(reqs)


def case_fallback_avoids_dead_pools(P):
    cfg, reqs, qt = _dead_vega(P)
    recs = _engine(P, P.FirstAvail(), qt, cfg).run(reqs)
    assert len(recs) == cfg.n_requests
    assert all(np.isfinite(r.t_total) for r in recs)
    for r in recs:
        assert "vega" not in P.arms.ARMS[r.arm].program.pools
    return {"exact": _records(recs)}


def case_fallback_regression_old_behavior_loses_requests(P):
    cfg, reqs, qt = _dead_vega(P)
    ones = lambda arms, alive: np.ones(len(arms), dtype=bool)
    with mock.patch.object(P.eng, "fallback_avail", ones):
        recs = _engine(P, P.FirstAvail(), qt, cfg).run(reqs)
    lost = [r.rid for r in recs if not np.isfinite(r.t_total)]
    assert lost
    return {"exact": lost}


# tests/test_runtime_properties.py


def case_occupancy_features(P):
    """The sequential half of ``test_occupancy_features_identical_across_
    runtimes``: a seeded sweep of its hypothesis range (every replica busy
    or free)."""
    cfg = P.eng.SimConfig()
    eng = _engine(P, P.work.CyclePolicy(), None, cfg)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(40):
        busy = {p: list(rng.uniform(size=n) < 0.5)
                for p, n in P.arms.POOL_REPLICAS.items()}
        pools = P.eng.Pools(cfg)
        for p, flags in busy.items():
            pools.free_at[p] = [10.0 if f else 0.0 for f in flags]
        occ = eng._occupancies(pools, 5.0)
        expected = P.sctx.aggregate_occupancy(
            {p: float(np.mean(flags)) for p, flags in busy.items()})
        assert occ == pytest.approx(expected)
        assert set(occ) == {"vega", "sdxl", "sd3"}
        out.append(occ)
    return {"exact": out}


# tests/test_program_ir.py


def case_linucb_decisions_identical_on_fig6_workload(P):
    A = P.arms
    legacy = [A.Arm(0, A.standalone_program("XL", "small"),
                    "vega-standalone")]
    for i, s in enumerate(A.RELAY_STEPS):
        legacy.append(A.Arm(1 + i, A.relay_program("XL", s),
                            f"sdxl+vega@s={s}"))
    for i, s in enumerate(A.RELAY_STEPS):
        legacy.append(A.Arm(6 + i, A.relay_program("F3", s),
                            f"sd35L+M@s={s}"))
    cfg = P.eng.SimConfig(n_requests=80, mean_interarrival=2.0, seed=10)
    reqs = P.eng.make_requests(cfg, seed0=50_000)
    runs, forced = {}, None
    for name, arms in (("builder", A.build_action_space()),
                       ("handrolled", tuple(legacy))):
        qt = P.work.synthetic_quality_table(reqs, arms=arms)
        policy = _rise(P, arms=arms)
        prefix = _watch_forced(policy)
        recs = _engine(P, policy, qt, cfg, arms=arms).run(reqs)
        runs[name] = {r.rid: r for r in recs}
        forced = _records(recs[:prefix[0]])
    a, b = runs["builder"], runs["handrolled"]
    assert sorted(a) == sorted(b)
    for rid in a:
        assert a[rid].arm == b[rid].arm
        assert a[rid].reward == b[rid].reward
    return {"exact": forced}


# tests/test_obs.py (compressed: its RuntimeConfig keeps the default)


def _traced_run(P, n=40, profiler=None, **sim_kw):
    cfg = P.eng.SimConfig(n_requests=n, mean_interarrival=1.5, seed=9,
                          **sim_kw)
    reqs = P.eng.make_requests(cfg)
    qt = P.work.synthetic_quality_table(reqs)
    eng = _engine(P, P.work.CyclePolicy(), qt, cfg,
                  runtime_cfg=P.rt.RuntimeConfig(profiler=profiler))
    return eng, sorted(eng.run(reqs), key=lambda r: r.rid)


def case_tracer_spans_tile_lifetime(P):
    eng, recs = _traced_run(P, straggler_prob=0.25, straggler_factor=6.0)
    assert eng.tracer.coverage() == 1.0
    assert P.obs.attribution_residual(eng.tracer) < 1e-6
    for r in recs:
        assert eng.tracer.requests[r.rid].t_total == \
            pytest.approx(r.t_total, abs=1e-6)
    return {"exact": ([(r.rid, r.arm, r.t_total, r.wait_s) for r in recs],
                      eng.trace),
            "approx": [r.reward for r in recs]}


def case_chrome_trace_dag_branch_flows(P):
    """The sequential half of ``test_chrome_trace_dag_branch_flows``."""
    arms = P.arms.dag_action_space()
    cfg = P.eng.SimConfig(n_requests=24, mean_interarrival=1.2, seed=5)
    reqs = P.eng.make_requests(cfg)
    qt = P.work.synthetic_quality_table(reqs, arms=arms)
    eng = _engine(P, P.work.CyclePolicy(), qt, cfg, arms=arms,
                  runtime_cfg=P.rt.RuntimeConfig(trace=True))
    eng.run(reqs)
    trace = P.obs.to_chrome_trace(eng.tracer)
    assert P.obs.validate_chrome_trace(trace) == []
    events = [(e["ph"], e["name"], e.get("ts"), e.get("dur"))
              for e in trace["traceEvents"]]
    return {"exact": (events, _joins(eng.tracer))}


def case_profiler_ignored_by_sequential_engine(P):
    prof = P.obs.EventLoopProfiler()
    eng, recs = _traced_run(P, profiler=prof, n=10)
    assert prof.n_events == 0  # no event loop to profile
    return {"exact": [(r.rid, r.arm, r.t_total) for r in recs]}


# tests/test_dag.py


def _dag_join_outcomes(tracer):
    out = {}
    for rid, tr in tracer.requests.items():
        joins = [(s.name, s.meta.get("accepted"), s.meta.get("winner"),
                  s.meta.get("deviation_pct"), s.meta.get("bound_pct"))
                 for s in tr.spans if s.kind == "join"]
        if joins:
            out[rid] = sorted(joins)
    return out


def _case_dag_sequential(seed):
    def case(P):
        """The sequential half of ``test_runtime_parity_on_dag_action_
        space``: the 15 DAG arms and an always-reject speculation under
        CyclePolicy, stragglers on, compressed; both Select outcomes occur,
        and the spans tile ``t_total``."""
        arms = P.arms.dag_action_space()
        arms = arms + (P.arms.Arm(
            len(arms),
            P.arms.speculative_program("XL", 20, 10, bound_pct=0.0),
            "XL@s=20|spec=10|reject"),)
        cfg = P.eng.SimConfig(n_requests=60, mean_interarrival=1.2,
                              seed=seed, straggler_prob=0.15,
                              straggler_factor=6.0)
        reqs = P.eng.make_requests(cfg)
        qt = P.work.synthetic_quality_table(reqs, arms=arms)
        eng = _engine(P, P.work.CyclePolicy(), qt, cfg, arms=arms,
                      runtime_cfg=P.rt.RuntimeConfig(trace=True))
        recs = eng.run(reqs)
        outs = _dag_join_outcomes(eng.tracer)
        flags = {acc for joins in outs.values() for (_, acc, _, _, _) in joins
                 if acc is not None}
        assert outs and flags == {True, False}
        assert eng.tracer.coverage() == 1.0
        assert P.obs.attribution_residual(eng.tracer) < 1e-6
        exact = {rid: [j[:3] for j in joins] for rid, joins in outs.items()}
        pct = [x for joins in outs.values() for j in joins for x in j[3:]
               if x is not None]
        return {"exact": (exact, [(r.rid, r.arm, r.t_total) for r in recs],
                          eng.fault_counters.as_dict()),
                "approx": [q for r in recs
                           for q in (r.reward, *r.quality.values())],
                "select_pct": pct}
    return case


CASES = {
    "serving::engine_runs_and_reports": case_engine_runs_and_reports,
    "serving::rise_beats_round_robin": case_rise_beats_round_robin,
    "serving::rise_routes_text_to_f3": case_rise_routes_text_to_f3,
    "serving::queueing_adds_wait_under_load":
        case_queueing_adds_wait_under_load,
    "serving::replica_failover": case_replica_failover,
    "serving::straggler_reissue_bounds_latency":
        case_straggler_reissue_bounds_latency,
    "serving::ppo_sac_train_and_run": case_ppo_sac_train_and_run,
    "serving::ablation_variants_construct": case_ablation_variants_construct,
    "serving::serve_no_compress_resolves": case_serve_no_compress_resolves,
    "event_loop_fixes::fallback_avoids_dead_pools":
        case_fallback_avoids_dead_pools,
    "event_loop_fixes::fallback_regression_old_behavior_loses_requests":
        case_fallback_regression_old_behavior_loses_requests,
    "runtime_properties::occupancy_features": case_occupancy_features,
    "program_ir::linucb_decisions_identical_on_fig6_workload":
        case_linucb_decisions_identical_on_fig6_workload,
    "obs::tracer_spans_tile_lifetime": case_tracer_spans_tile_lifetime,
    "obs::chrome_trace_dag_branch_flows": case_chrome_trace_dag_branch_flows,
    "obs::profiler_ignored_by_sequential_engine":
        case_profiler_ignored_by_sequential_engine,
    "dag::runtime_parity_seed3": _case_dag_sequential(3),
    "dag::runtime_parity_seed11": _case_dag_sequential(11),
}


def _compare(case):
    ref, port = case(REF), case(PORT)
    assert ref.keys() == port.keys()
    assert port["exact"] == ref["exact"]
    for key, tol in (("approx", COMPRESSED_RTOL),
                     ("select_pct", SELECT_PCT_RTOL)):
        if key in ref:
            assert len(port[key]) == len(ref[key]) > 0
            worst = max(_rel(a, b) for a, b in zip(ref[key], port[key]))
            assert worst <= tol, (key, worst)


@pytest.mark.parametrize("case", list(CASES))
def test_reference_sequential_case(case):
    _compare(CASES[case])


# ---------------------------------------------------------------------------
# the continuous halves of the same reference cases (runtime="continuous",
# compressed unless a case says otherwise: its RuntimeConfig keeps the
# default).  Records come in completion order; the cases sort them by rid.
# ---------------------------------------------------------------------------


def _by_rid(recs) -> list:
    return sorted(recs, key=lambda r: r.rid)


def _timing(recs) -> list:
    """(rid, arm, t_total, wait_s) of each record, by rid: what the
    round trip's error cannot move."""
    return [(r.rid, r.arm, r.t_total, r.wait_s) for r in _by_rid(recs)]


def _rewards_quality(recs) -> list:
    return [q for r in _by_rid(recs) for q in (r.reward, *r.quality.values())]


def _profile_counts(rep) -> dict:
    """An ``EventLoopProfiler`` report without its wall clocks."""
    return {"events": rep["events"], "stale": rep["stale_events"],
            "heap": rep["heap_ops"],
            "per_type": {k: v["count"]
                         for k, v in rep["per_event_type"].items()}}


def _cont(P, policy, qt, cfg, **kw):
    return _engine(P, policy, qt, cfg, runtime="continuous", **kw)


# tests/test_event_loop_fixes.py


def ccase_fallback_avoids_dead_pools(P):
    cfg, reqs, qt = _dead_vega(P)
    recs = _cont(P, P.FirstAvail(), qt, cfg).run(reqs)
    assert len(recs) == cfg.n_requests
    assert all(np.isfinite(r.t_total) for r in recs)
    for r in recs:
        assert "vega" not in P.arms.ARMS[r.arm].program.pools
    return {"exact": _timing(recs), "approx": _rewards_quality(recs)}


def ccase_fallback_regression_old_behavior_loses_requests(P):
    """The monkeypatched pre-fix fallback on ``P``'s runtime module: the
    work routed through the dead pool never finishes."""
    cfg, reqs, qt = _dead_vega(P)
    ones = lambda arms, alive: np.ones(len(arms), dtype=bool)
    with mock.patch.object(P.rteng, "fallback_avail", ones):
        recs = _cont(P, P.FirstAvail(), qt, cfg).run(reqs)
    assert len(recs) < cfg.n_requests
    return {"exact": _timing(recs)}


def _bursty(P):
    cfg = P.eng.SimConfig(n_requests=600, mean_interarrival=0.02, seed=3,
                          straggler_prob=0.2, straggler_factor=6.0)
    reqs = P.eng.make_requests(cfg)
    return cfg, reqs, P.work.synthetic_quality_table(reqs)


def _profiled_run(P, cfg, reqs, qt, **kw):
    prof = P.obs.EventLoopProfiler()
    eng = _cont(P, P.work.CyclePolicy(), qt, cfg,
                runtime_cfg=P.rt.RuntimeConfig(profiler=prof, **kw))
    return eng, eng.run(reqs), prof.report()


def ccase_stale_flushes_are_skipped_not_handled(P):
    cfg, reqs, qt = _bursty(P)
    _, recs, rep = _profiled_run(P, cfg, reqs, qt)
    n_stale = sum(rep["stale_events"].values())
    assert rep["stale_events"].get("flush", 0) > 0
    assert rep["heap_ops"]["pops"] - rep["events"] == n_stale
    assert rep["events"] < rep["heap_ops"]["pops"]
    recs0 = _cont(P, P.work.CyclePolicy(), qt, cfg).run(reqs)
    assert [(r.rid, r.arm, r.t_total, r.wait_s) for r in recs] == \
        [(r.rid, r.arm, r.t_total, r.wait_s) for r in recs0]
    return {"exact": (_timing(recs), _profile_counts(rep))}


def ccase_at_most_one_live_flush_per_pool(P):
    cfg, reqs, qt = _bursty(P)
    _, _, rep = _profiled_run(P, cfg, reqs, qt)
    handled = rep["per_event_type"].get("flush", {}).get("count", 0)
    stale = rep["stale_events"].get("flush", 0)
    non_flush = sum(v["count"] for k, v in rep["per_event_type"].items()
                    if k != "flush")
    assert handled + stale == rep["heap_ops"]["pushes"] - non_flush
    return {"exact": _profile_counts(rep)}


# tests/test_runtime_properties.py


def ccase_occupancy_features(P):
    """The continuous half of ``test_occupancy_features_identical_across_
    runtimes``: the runtime's scalar ``_occupancies`` over hand-set pools,
    a seeded sweep of its hypothesis range."""
    cfg = P.eng.SimConfig()
    rng = np.random.default_rng(0)
    out = []
    for _ in range(40):
        busy = {p: list(rng.uniform(size=n) < 0.5)
                for p, n in P.arms.POOL_REPLICAS.items()}
        rt = P.rteng.ContinuousRuntime(P.work.CyclePolicy(), None, cfg,
                                       **P.dev)
        rt.pools = {
            p: P.rteng._PoolState(
                n=n, free=[i for i in range(n) if not busy[p][i]],
                busy_until=[10.0 if busy[p][i] else 0.0 for i in range(n)],
                agg=P.rt.MicroBatchAggregator(p))
            for p, n in P.arms.POOL_REPLICAS.items()
        }
        occ = rt._occupancies(5.0)
        expected = P.sctx.aggregate_occupancy(
            {p: float(np.mean(flags)) for p, flags in busy.items()})
        assert occ == pytest.approx(expected)
        assert set(occ) == {"vega", "sdxl", "sd3"}
        out.append(occ)
    return {"exact": out}


# tests/test_program_ir.py


def ccase_linucb_decisions_identical_on_fig6_workload(P):
    """RISE over the builder's space and the hand-rolled one, continuous:
    equal records within the package; across packages the arms of the
    forced prefix (the decisions before RISE's first sampled one, which
    see only completions of earlier requests)."""
    A = P.arms
    legacy = [A.Arm(0, A.standalone_program("XL", "small"),
                    "vega-standalone")]
    for i, s in enumerate(A.RELAY_STEPS):
        legacy.append(A.Arm(1 + i, A.relay_program("XL", s),
                            f"sdxl+vega@s={s}"))
    for i, s in enumerate(A.RELAY_STEPS):
        legacy.append(A.Arm(6 + i, A.relay_program("F3", s),
                            f"sd35L+M@s={s}"))
    cfg = P.eng.SimConfig(n_requests=80, mean_interarrival=2.0, seed=10)
    reqs = P.eng.make_requests(cfg, seed0=50_000)
    runs, forced = {}, None
    for name, arms in (("builder", A.build_action_space()),
                       ("handrolled", tuple(legacy))):
        qt = P.work.synthetic_quality_table(reqs, arms=arms)
        policy = _rise(P, arms=arms)
        prefix = _watch_forced(policy)
        recs = _cont(P, policy, qt, cfg, arms=arms).run(reqs)
        runs[name] = {r.rid: r for r in recs}
        assert prefix[0] >= 3 * len(arms)
        forced = [r.arm for r in _by_rid(recs)[:prefix[0]]]
    a, b = runs["builder"], runs["handrolled"]
    assert sorted(a) == sorted(b)
    for rid in a:
        assert a[rid].arm == b[rid].arm
        assert a[rid].reward == b[rid].reward
        assert a[rid].quality == b[rid].quality
        assert a[rid].t_total == b[rid].t_total
    return {"exact": forced}


# tests/test_obs.py


def _ctraced(P, n=40, trace=True, profiler=None, **sim_kw):
    cfg = P.eng.SimConfig(n_requests=n, mean_interarrival=1.5, seed=9,
                          **sim_kw)
    reqs = P.eng.make_requests(cfg)
    qt = P.work.synthetic_quality_table(reqs)
    eng = _cont(P, P.work.CyclePolicy(), qt, cfg,
                runtime_cfg=P.rt.RuntimeConfig(profiler=profiler,
                                               trace=trace))
    return eng, _by_rid(eng.run(reqs))


def ccase_tracer_spans_tile_lifetime(P):
    eng, recs = _ctraced(P, straggler_prob=0.25, straggler_factor=6.0)
    assert eng.tracer.coverage() == 1.0
    assert P.obs.attribution_residual(eng.tracer) < 1e-6
    for r in recs:
        assert eng.tracer.requests[r.rid].t_total == \
            pytest.approx(r.t_total, abs=1e-6)
    return {"exact": (_timing(recs), eng.trace),
            "approx": _rewards_quality(recs)}


def ccase_tracing_off_is_bit_identical(P):
    kw = dict(straggler_prob=0.3, straggler_factor=8.0)
    eng_on, on = _ctraced(P, trace=True, **kw)
    eng_off, off = _ctraced(P, trace=False, **kw)
    assert [r.arm for r in on] == [r.arm for r in off]
    assert [r.t_total for r in on] == [r.t_total for r in off]
    assert [r.reward for r in on] == [r.reward for r in off]
    assert eng_on.fault_counters.as_dict() == eng_off.fault_counters.as_dict()
    assert len(eng_on.tracer) > 0 and len(eng_off.tracer) == 0
    return {"exact": (_timing(on), eng_on.fault_counters.as_dict()),
            "approx": _rewards_quality(on)}


def ccase_chrome_trace_schema_and_flows(P):
    eng, _ = _ctraced(P, straggler_prob=0.25, straggler_factor=6.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "t.json"
        trace = P.obs.write_chrome_trace(eng.tracer, str(path),
                                         meta={"k": "v"})
        on_disk = json.loads(path.read_text())
    assert P.obs.validate_chrome_trace(trace) == []
    assert P.obs.validate_chrome_trace(on_disk) == []
    assert trace["otherData"] == {"k": "v"}
    evs = trace["traceEvents"]
    assert {"M", "X", "s", "f", "i"} <= {e["ph"] for e in evs}
    for fid in {e["id"] for e in evs if e["ph"] in ("s", "t", "f")}:
        assert sum(1 for e in evs if e.get("id") == fid
                   and e["ph"] == "s") == 1
        assert sum(1 for e in evs if e.get("id") == fid
                   and e["ph"] == "f") == 1
    return {"exact": json.dumps(on_disk)}


def ccase_chrome_trace_dag_branch_flows(P):
    """The continuous half of ``test_chrome_trace_dag_branch_flows``."""
    arms = P.arms.dag_action_space()
    cfg = P.eng.SimConfig(n_requests=48, mean_interarrival=1.2, seed=5)
    reqs = P.eng.make_requests(cfg)
    qt = P.work.synthetic_quality_table(reqs, arms=arms)
    eng = _cont(P, P.work.CyclePolicy(), qt, cfg, arms=arms,
                runtime_cfg=P.rt.RuntimeConfig(trace=True))
    eng.run(reqs)
    trace = P.obs.to_chrome_trace(eng.tracer)
    assert P.obs.validate_chrome_trace(trace) == []
    evs = trace["traceEvents"]
    assert "relay" in {e["args"]["name"] for e in evs if e["ph"] == "M"}
    assert any(e["ph"] == "i" and e.get("cat") == "branch" for e in evs)
    joins = [e for e in evs if e["ph"] == "X" and e.get("cat") == "join"]
    assert joins and all("winner" in e["args"] for e in joins)
    fids = {e["id"] for e in evs if e["ph"] in ("s", "t", "f")}
    branch = {f for f in fids if isinstance(f, str) and "/" in f}
    assert {f.split("/", 1)[1] for f in branch} >= {"spec", "ref"}
    assert any(e["ph"] == "X" and e["args"].get("offpath") for e in evs)
    events = [(e["ph"], e["name"], e.get("ts"), e.get("dur")) for e in evs]
    return {"exact": (events, _joins(eng.tracer))}


def ccase_spans_jsonl_roundtrip(P):
    eng, recs = _ctraced(P, n=12)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "spans.jsonl"
        n_lines = P.obs.write_spans_jsonl(eng.tracer, str(path))
        lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == n_lines
    assert {x["rid"] for x in lines if x["type"] == "request"} == \
        {r.rid for r in recs}
    return {"exact": lines}


def ccase_introspection_from_engine_records(P):
    eng, recs = _ctraced(P, n=30)
    intro = P.obs.SchedulerIntrospection.from_records(recs, eng.n_arms)
    assert int(intro.pulls.sum()) == len(recs)
    assert intro.cumulative_regret() >= 0.0
    return {"exact": intro.pulls.tolist(),
            "approx": [intro.cumulative_regret()]}


def ccase_profiler_counts_and_bit_identity(P):
    kw = dict(straggler_prob=0.2, straggler_factor=6.0)
    prof = P.obs.EventLoopProfiler()
    _, recs_p = _ctraced(P, profiler=prof, **kw)
    _, recs_0 = _ctraced(P, **kw)
    assert _timing(recs_p) == _timing(recs_0)
    rep = prof.report()
    assert rep["events"] > 0 and rep["loop_wall_s"] > 0
    assert {"arrive", "batch_done"} <= set(rep["per_event_type"])
    assert sum(v["count"] for v in rep["per_event_type"].values()) == \
        rep["events"]
    assert rep["heap_ops"]["pushes"] == rep["heap_ops"]["pops"] == \
        rep["events"]
    return {"exact": (_timing(recs_p), _profile_counts(rep))}


# tests/test_dag.py


def _case_dag_continuous(seed):
    def case(P):
        """The continuous half of ``test_runtime_parity_on_dag_action_
        space``: the sequential and the continuous runtime of one package
        take the same arms, quality, fault counters and Select outcomes,
        and spans tile ``t_total`` on both."""
        arms = P.arms.dag_action_space()
        arms = arms + (P.arms.Arm(
            len(arms),
            P.arms.speculative_program("XL", 20, 10, bound_pct=0.0),
            "XL@s=20|spec=10|reject"),)
        cfg = P.eng.SimConfig(n_requests=60, mean_interarrival=1.2,
                              seed=seed, straggler_prob=0.15,
                              straggler_factor=6.0)
        reqs = P.eng.make_requests(cfg)
        qt = P.work.synthetic_quality_table(reqs, arms=arms)
        runs = {}
        for runtime in ("sequential", "continuous"):
            eng = _engine(P, P.work.CyclePolicy(), qt, cfg, runtime=runtime,
                          arms=arms, runtime_cfg=P.rt.RuntimeConfig(trace=True))
            runs[runtime] = (eng, {r.rid: r for r in eng.run(reqs)})
        (eng_s, rs), (eng_c, rc) = runs["sequential"], runs["continuous"]
        assert sorted(rs) == sorted(rc)
        for rid in rs:
            assert rs[rid].arm == rc[rid].arm
            assert rs[rid].quality == rc[rid].quality
        assert eng_s.fault_counters.as_dict() == eng_c.fault_counters.as_dict()
        js, jc = (_dag_join_outcomes(e.tracer) for e in (eng_s, eng_c))
        assert js and js == jc
        flags = {acc for joins in jc.values() for (_, acc, _, _, _) in joins
                 if acc is not None}
        assert flags == {True, False}
        for eng in (eng_s, eng_c):
            assert eng.tracer.coverage() == 1.0
            assert P.obs.attribution_residual(eng.tracer) < 1e-6
        exact = {rid: [j[:3] for j in joins] for rid, joins in jc.items()}
        pct = [x for joins in jc.values() for j in joins for x in j[3:]
               if x is not None]
        return {"exact": (exact, _timing(rc.values()),
                          eng_c.fault_counters.as_dict()),
                "approx": _rewards_quality(rc.values()),
                "select_pct": pct}
    return case


def ccase_dag_tracing_off_is_bit_identical(P):
    arms = P.arms.dag_action_space()
    cfg = P.eng.SimConfig(n_requests=40, mean_interarrival=1.2, seed=7)
    reqs = P.eng.make_requests(cfg)
    qt = P.work.synthetic_quality_table(reqs, arms=arms)
    runs = []
    for trace in (True, False):
        eng = _cont(P, P.work.CyclePolicy(), qt, cfg, arms=arms,
                    runtime_cfg=P.rt.RuntimeConfig(trace=trace))
        runs.append(_by_rid(eng.run(reqs)))
    on, off = runs
    assert [r.arm for r in on] == [r.arm for r in off]
    assert [r.t_total for r in on] == [r.t_total for r in off]
    assert [r.quality for r in on] == [r.quality for r in off]
    assert [r.reward for r in on] == [r.reward for r in off]
    return {"exact": _timing(on), "approx": _rewards_quality(on)}


def ccase_legacy_arms_unperturbed_inside_dag_space(P):
    def fixed(k):
        class Fixed(P.pol.Policy):
            name = "Fixed"

            def select(self, ctx, avail):
                return k
        return Fixed()

    cfg = P.eng.SimConfig(n_requests=30, mean_interarrival=1.5, seed=13)
    reqs = P.eng.make_requests(cfg)
    exact, approx = [], []
    for k in (0, 3, 8):  # standalone, XL relay, F3 relay
        runs = []
        for arms in (P.arms.build_action_space(), P.arms.dag_action_space()):
            qt = P.work.synthetic_quality_table(reqs, arms=arms)
            runs.append(_by_rid(_cont(P, fixed(k), qt, cfg,
                                      arms=arms).run(reqs)))
        legacy, dag = runs
        assert [r.t_total for r in legacy] == [r.t_total for r in dag]
        assert [r.quality for r in legacy] == [r.quality for r in dag]
        assert [r.reward for r in legacy] == [r.reward for r in dag]
        exact.append(_timing(legacy))
        approx += _rewards_quality(legacy)
    return {"exact": exact, "approx": approx}


CONTINUOUS_CASES = {
    "event_loop_fixes::fallback_avoids_dead_pools":
        ccase_fallback_avoids_dead_pools,
    "event_loop_fixes::fallback_regression_old_behavior_loses_requests":
        ccase_fallback_regression_old_behavior_loses_requests,
    "event_loop_fixes::stale_flushes_are_skipped_not_handled":
        ccase_stale_flushes_are_skipped_not_handled,
    "event_loop_fixes::at_most_one_live_flush_per_pool":
        ccase_at_most_one_live_flush_per_pool,
    "runtime_properties::occupancy_features": ccase_occupancy_features,
    "program_ir::linucb_decisions_identical_on_fig6_workload":
        ccase_linucb_decisions_identical_on_fig6_workload,
    "obs::tracer_spans_tile_lifetime": ccase_tracer_spans_tile_lifetime,
    "obs::tracing_off_is_bit_identical": ccase_tracing_off_is_bit_identical,
    "obs::chrome_trace_schema_and_flows": ccase_chrome_trace_schema_and_flows,
    "obs::chrome_trace_dag_branch_flows": ccase_chrome_trace_dag_branch_flows,
    "obs::spans_jsonl_roundtrip": ccase_spans_jsonl_roundtrip,
    "obs::introspection_from_engine_records":
        ccase_introspection_from_engine_records,
    "obs::profiler_counts_and_bit_identity":
        ccase_profiler_counts_and_bit_identity,
    "dag::runtime_parity_seed3": _case_dag_continuous(3),
    "dag::runtime_parity_seed11": _case_dag_continuous(11),
    "dag::tracing_off_is_bit_identical":
        ccase_dag_tracing_off_is_bit_identical,
    "dag::legacy_arms_unperturbed_inside_dag_space":
        ccase_legacy_arms_unperturbed_inside_dag_space,
}


@pytest.mark.parametrize("case", list(CONTINUOUS_CASES))
def test_reference_continuous_case(case):
    _compare(CONTINUOUS_CASES[case])


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def _guard_engine(**kw):
    cfg = te.SimConfig(n_requests=4)
    kw = {"runtime": "sequential", "device": "cpu", **kw}
    return te.ServingEngine(kw.pop("policy", twork.CyclePolicy()), None, cfg,
                            **kw)


def test_continuous_is_the_default_runtime():
    eng = te.ServingEngine(twork.CyclePolicy(), None, te.SimConfig(),
                           device="cpu")
    assert eng.runtime == "continuous" and eng.telemetry is None
    cfg = te.SimConfig(n_requests=6, seed=1)
    reqs = te.make_requests(cfg)
    eng = te.ServingEngine(twork.CyclePolicy(),
                           twork.synthetic_quality_table(reqs), cfg,
                           device="cpu")
    recs = eng.run(reqs)
    assert sorted(r.rid for r in recs) == list(range(6))
    assert isinstance(eng.telemetry, trt.RuntimeTelemetry)
    assert eng.fault_counters is eng.telemetry.faults
    assert eng.tracer.coverage() == 1.0 and sorted(eng.trace) == \
        list(range(6))


def test_continuous_guards(monkeypatch):
    with pytest.raises(ValueError, match="unknown runtime"):
        _guard_engine(runtime="Continuous")
    with pytest.raises(ValueError, match="policy sized for 11 arms"):
        _guard_engine(runtime="continuous",
                      policy=tpol.RisePolicy(device="cpu"),
                      arms=tarms.cascade_action_space())
    cfg = te.SimConfig(n_requests=2, straggler_mode="bogus")
    with pytest.raises(ValueError, match="unknown straggler_mode"):
        te.ServingEngine(twork.CyclePolicy(), None, cfg, runtime="continuous",
                         device="cpu").run(te.make_requests(cfg))
    rt = trt.ContinuousRuntime(twork.CyclePolicy(), None, te.SimConfig(),
                               device="cpu")
    assert rt.transport.device.type == "cpu" and rt.transport.cfg.compress
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.ServingEngine(twork.CyclePolicy(), None, te.SimConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trt.ContinuousRuntime(twork.CyclePolicy(), None, te.SimConfig())


def test_unknown_runtime_and_policy_size_raise():
    with pytest.raises(ValueError, match="unknown runtime"):
        _guard_engine(runtime="batched")
    with pytest.raises(ValueError, match="policy sized for 11 arms"):
        _guard_engine(policy=tpol.RisePolicy(device="cpu"),
                      arms=tarms.cascade_action_space())
    with pytest.raises(ValueError, match="unknown straggler_mode"):
        cfg = te.SimConfig(n_requests=2, straggler_mode="bogus")
        te.ServingEngine(twork.CyclePolicy(), None, cfg, runtime="sequential",
                         device="cpu").run(te.make_requests(cfg))


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.ServingEngine(twork.CyclePolicy(), None, te.SimConfig(),
                         runtime="sequential")
    eng = _guard_engine(runtime_cfg=trt.RuntimeConfig())
    assert eng.device.type == "cpu" and eng.transport.device.type == "cpu"
    assert eng.transport.cfg.compress is True
    assert _guard_engine().transport.cfg.compress is False


def test_runtime_cfg_maps_to_the_transport_and_ignores_the_rest():
    prof = tobs.EventLoopProfiler()
    rc = trt.RuntimeConfig(compress_handoff=True, bw_mbps=7.5,
                           quality_sensitivity=2.0, profiler=prof,
                           buckets=(1,), linger_s=9.0, trace=False,
                           autoscaler=object())
    eng = _guard_engine(runtime_cfg=rc)
    assert (eng.transport.cfg.compress, eng.transport.cfg.bw_mbps,
            eng.transport.cfg.quality_sensitivity) == (True, 7.5, 2.0)
    cfg = te.SimConfig(n_requests=10, seed=2)
    reqs = te.make_requests(cfg)
    qt = twork.synthetic_quality_table(reqs)
    run = lambda rc: te.ServingEngine(
        twork.CyclePolicy(), qt, cfg, runtime="sequential", runtime_cfg=rc,
        device="cpu").run(reqs)
    a = run(rc)
    b = run(trt.RuntimeConfig(compress_handoff=True, bw_mbps=7.5,
                              quality_sensitivity=2.0))
    assert _records(a) == _records(b)
    assert prof.n_events == 0


def test_engine_holds_no_tensor():
    """The records' fields are host numbers, and RISE's select returns a
    Python int."""
    cfg = te.SimConfig(n_requests=12, seed=1)
    reqs = te.make_requests(cfg)
    eng = te.ServingEngine(tpol.RisePolicy(device="cpu"),
                           twork.synthetic_quality_table(reqs), cfg,
                           runtime="sequential",
                           runtime_cfg=trt.RuntimeConfig(), device="cpu")
    for r in eng.run(reqs):
        assert type(r.arm) is int and type(r.reward) is float
        assert type(r.t_total) is float and isinstance(r.ctx, np.ndarray)
        assert all(type(v) is float for v in r.quality.values())
