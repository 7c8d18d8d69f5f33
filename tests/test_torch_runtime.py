"""The continuous-batching runtime, the port against the JAX package on the
CPU (``repro_torch/serving/runtime/engine.py::ContinuousRuntime`` against
``repro/serving/runtime/engine.py``, through each package's
``ServingEngine(runtime="continuous")`` or directly).

Each case builds the same ``SimConfig`` in both packages, draws each
package's requests with its own ``make_requests`` and serves them over
each package's ``serving/workload.py::synthetic_quality_table``.  Records
come in completion order; both packages must give the same order.

Tolerances:
* uncompressed (``RuntimeConfig(compress_handoff=False)``): every
  ``Record`` field in completion order, the fault counters, the
  telemetry export, ``engine.trace`` and the tracer's Chrome export equal
  bit for bit;
* compressed (the default ``RuntimeConfig()``): arms, ``t_total``,
  ``wait_s``, contexts, fault counters, the telemetry export and each DAG
  Select's decision exact; quality values and rewards within
  ``COMPRESSED_RTOL`` of ``max(|ref|, 1)``, Select percentages within
  ``SELECT_PCT_RTOL`` (both from ``tests/test_torch_engine.py``).  The
  cause is the int8 round trip's measured error
  (``HandoffTransport.handoff_error``), which differs across frameworks
  in its last bits.  Read over every compressed case of this file and the
  continuous cases of ``tests/test_torch_engine.py``: quality and reward
  8.38e-8 at most (a reward), so the bound 5e-7 is 6x the reading;
  Select percentages 5.12e-7 against 2e-6 (3.9x);
* RISE by replay (``ReplayPolicy`` of ``tests/test_torch_engine.py``):
  the reference's RISE serves the stream, its decisions in order go
  through the port's runtime into a port ``RisePolicy``, whose updates
  arrive in the runtime's completion order.  Records as above, counts
  exact, ``A`` within 1 ulp per update of an arm on its diagonal only,
  ``b`` exact uncompressed and within 1 ulp per update compressed.

Then every test of ``tests/test_runtime_parity.py`` and the engine cases
of ``tests/test_runtime.py``, each written once over a package and run on
both, their observables compared; the stepping interface (``begin``,
``step``, ``peek_time``, ``idle``, ``inject``, ``load_snapshot``), and
the AUTOSCALE branch under a scripted autoscaler given to both and under
each package's ``ReplicaAutoscaler``.
"""
from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.serving.fleet import autoscale as jautoscale
from repro_torch.serving.fleet import autoscale as tautoscale
from test_torch_engine import (COMPRESSED_RTOL, PORT, REF, SCENARIOS,
                               SPACES, ReplayPolicy, _assert_exact_fields,
                               _by_rid, _compare, _cont, _engine, _joins,
                               _policy, _rewards_quality, _space, _timing,
                               _ulps, _worst_rel)

torch.set_num_threads(1)

REGIMES = {
    "clean": {},
    "stragglers": dict(straggler_prob=0.3, straggler_factor=8.0),
    "replica_failure": dict(fail_replica=("sdxl", 0, 50.0, 400.0)),
    "degraded": dict(straggler_prob=0.25, straggler_factor=6.0,
                     fail_replica=("sd3l", 1, 30.0, 300.0)),
}


def _table(P, cfg, arms=None):
    reqs = P.eng.make_requests(cfg)
    return reqs, P.work.synthetic_quality_table(reqs, arms)


def _serve_one(P, space, sim_kw, eng_kw, policy, compress):
    arms = _space(P, space)
    cfg = P.eng.SimConfig(**sim_kw)
    reqs, qt = _table(P, cfg, arms)
    pol = policy if not isinstance(policy, str) else _policy(P, policy)
    eng = _cont(P, pol, qt, cfg, arms=arms,
                runtime_cfg=P.rt.RuntimeConfig(compress_handoff=compress),
                **eng_kw)
    return eng.run(reqs), eng


def _serve(space, sim_kw, eng_kw=None, policy="cycle", compress=False):
    return tuple(_serve_one(P, space, sim_kw, eng_kw or {}, policy, compress)
                 for P in (REF, PORT))


def _telemetry(eng) -> dict:
    t = eng.telemetry
    return {"summary": t.summary(), "faults": t.faults.as_dict(),
            "autoscale": t.autoscale.as_dict()}


# ---------------------------------------------------------------------------
# records: bit for bit uncompressed, within the round trip's error
# compressed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("space", SPACES)
def test_records_uncompressed_bit_for_bit(space, scenario):
    sim_kw, eng_kw, policy = SCENARIOS[scenario]
    (jrecs, jeng), (trecs, teng) = _serve(space, sim_kw, eng_kw, policy)
    _assert_exact_fields(jrecs, trecs)  # completion order included
    for a, b in zip(jrecs, trecs):
        assert a.reward == b.reward and type(b.reward) is type(a.reward)
        assert a.quality == b.quality
    assert teng.fault_counters.as_dict() == jeng.fault_counters.as_dict()
    assert _telemetry(teng) == _telemetry(jeng)
    assert teng.trace == jeng.trace
    assert json.dumps(PORT.obs.to_chrome_trace(teng.tracer)) == \
        json.dumps(REF.obs.to_chrome_trace(jeng.tracer))
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
    assert _telemetry(teng) == _telemetry(jeng)
    assert _joins(teng.tracer) == _joins(jeng.tracer)
    assert teng.trace == jeng.trace


@pytest.mark.parametrize("space,sim_kw,ctx_dim,compress", [
    ("table2", dict(n_requests=80, mean_interarrival=1.5, seed=12), 8, False),
    ("dag", dict(n_requests=60, mean_interarrival=1.0, seed=13), 8, False),
    ("table2", dict(n_requests=60, mean_interarrival=1.0, seed=14,
                    telemetry_context=True, straggler_prob=0.2,
                    straggler_factor=6.0), 10, False),
    ("cascade", dict(n_requests=70, mean_interarrival=2.0, seed=15), 8, True),
])
def test_rise_by_replay(space, sim_kw, ctx_dim, compress):
    """The reference's RISE on the reference runtime; its decisions, in
    the order it took them, replayed into a port RisePolicy through the
    port's runtime, which feeds the updates in its completion order."""
    jspace, tspace = _space(REF, space), _space(PORT, space)
    jrise = REF.pol.RisePolicy(seed=0, arms=jspace, ctx_dim=ctx_dim)
    picks, select = [], jrise.select

    def recorded(ctx, avail):
        picks.append(select(ctx, avail))
        return picks[-1]

    jrise.select = recorded
    jrecs, jeng = _serve_one(REF, space, sim_kw, {}, jrise, compress)
    trise = PORT.pol.RisePolicy(seed=0, arms=tspace, ctx_dim=ctx_dim,
                                device="cpu")
    replay = ReplayPolicy(picks, trise)
    trecs, teng = _serve_one(PORT, space, sim_kw, {}, replay, compress)
    assert replay.i == len(jrecs) and replay.forced >= 3 * len(tspace)
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
# the stepping interface: begin / step / peek_time / idle, inject,
# load_snapshot, the AUTOSCALE branch
# ---------------------------------------------------------------------------


STEP_CASES = {
    "straggler_item": ("table2", SCENARIOS["straggler_item"][0]),
    "straggler_batch": ("cascade", SCENARIOS["straggler_batch"][0]),
    "outage": ("table2", SCENARIOS["outage"][0]),
    "dag": ("dag", dict(n_requests=50, mean_interarrival=1.0, seed=21,
                        straggler_prob=0.2, straggler_factor=6.0)),
}


def _runtime(P, space, sim_kw, rt_kw=None):
    """``P``'s ContinuousRuntime over Cycle, uncompressed unless ``rt_kw``
    says otherwise, so that every observable is held bit for bit."""
    arms = _space(P, space)
    cfg = P.eng.SimConfig(**sim_kw)
    reqs, qt = _table(P, cfg, arms)
    rt_cfg = P.rt.RuntimeConfig(**{"compress_handoff": False, **(rt_kw or {})})
    rt = P.rteng.ContinuousRuntime(P.work.CyclePolicy(), qt, cfg, rt_cfg,
                                   arms=arms, **P.dev)
    return rt, reqs


def _observed(P, rt) -> dict:
    return {"timing": _timing(rt.records),
            "order": [r.rid for r in rt.records],
            "values": _rewards_quality(rt.records),
            "faults": rt.fault_counters.as_dict(),
            "telemetry": rt.telemetry.summary(),
            "chrome": json.dumps(P.obs.to_chrome_trace(rt.tracer))}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_run_equals_begin_and_steps(case):
    """``run`` ≡ ``begin`` then ``step`` until ``idle``: the same records
    in the same order, counters, telemetry and spans, in both packages and
    across them; ``peek_time`` is each step's timestamp."""
    space, sim_kw = STEP_CASES[case]
    out = {}
    for name, P in (("ref", REF), ("port", PORT)):
        rt, reqs = _runtime(P, space, sim_kw)
        rt.run(reqs)
        ran = _observed(P, rt)
        rt, reqs = _runtime(P, space, sim_kw)
        rt.begin(reqs)
        times = []
        while not rt.idle():
            t = rt.peek_time()
            assert rt.step() == t
            times.append(t)
        assert rt.step() is None and rt.peek_time() is None
        assert times == sorted(times)
        assert _observed(P, rt) == ran
        out[name] = (ran, times)
    assert out["port"] == out["ref"]


def _fleet_drive(P, space, sim_kw):
    """Half the stream through ``begin``, the rest through ``inject`` at
    its arrival as a fleet router would (step while the next event is
    earlier), with ``load_snapshot`` read before every injection."""
    rt, reqs = _runtime(P, space, sim_kw)
    reqs = sorted(reqs, key=lambda r: r.arrival)
    rt.begin(reqs[0::2])
    snaps = []
    for req in reqs[1::2]:
        while rt.peek_time() is not None and rt.peek_time() < req.arrival:
            rt.step()
        snaps.append(rt.load_snapshot(req.arrival))
        rt.inject(req)
    while rt.step() is not None:
        pass
    assert rt.idle()
    return rt, snaps


@pytest.mark.parametrize("case", ["straggler_item", "outage", "dag"])
def test_inject_and_load_snapshot_equal_reference(case):
    space, sim_kw = STEP_CASES[case]
    (jrt, jsnaps), (trt, tsnaps) = (_fleet_drive(P, space, sim_kw)
                                    for P in (REF, PORT))
    assert len(trt.records) == sim_kw["n_requests"]
    assert _observed(PORT, trt) == _observed(REF, jrt)
    assert tsnaps == jsnaps
    assert {k for s in tsnaps for k in s} == {
        "occupancy", "avail_frac", "backlog_s", "queued", "inflight",
        "capacity"}
    assert any(s["queued"] or s["inflight"] for s in tsnaps)
    # reading the snapshot never perturbs the run: a plain run with the
    # same admissions gives the same records
    rt2, _ = _fleet_drive(PORT, space, sim_kw)
    assert _observed(PORT, rt2) == _observed(PORT, trt)


class ScriptedAutoscaler:
    """A fixed plan, by tick: scale ``sdxl`` down at the first tick, ``vega``
    down at the second, both back up at the fourth and sixth; every view
    it is shown is kept.  Duck-typed as the runtime reads an autoscaler:
    ``cfg.interval_s`` and ``decide(now, views)``."""

    PLAN = {0: [("sdxl", -1)], 1: [("vega", -1), ("sd3m", 0)],
            3: [("sdxl", +1)], 5: [("vega", +1), ("sdxl", +1)]}

    def __init__(self, interval_s: float = 4.0):
        self.cfg = SimpleNamespace(interval_s=interval_s)
        self.seen = []

    def decide(self, now, views):
        self.seen.append((now, views))
        return self.PLAN.get(len(self.seen) - 1, [])


@pytest.mark.parametrize("space,sim_kw", [
    ("table2", dict(n_requests=60, mean_interarrival=0.8, seed=31)),
    ("table2", dict(n_requests=60, mean_interarrival=0.8, seed=32,
                    straggler_prob=0.2, straggler_factor=6.0,
                    fail_replica=("vega", 1, 5.0, 30.0))),
    ("dag", dict(n_requests=50, mean_interarrival=1.0, seed=33)),
])
def test_autoscale_branch_equals_reference(space, sim_kw):
    out = {}
    for name, P in (("ref", REF), ("port", PORT)):
        scaler = ScriptedAutoscaler()
        rt, reqs = _runtime(P, space, sim_kw, {"autoscaler": scaler})
        rt.run(reqs)
        assert len(rt.records) == sim_kw["n_requests"]
        out[name] = (_observed(P, rt), rt.telemetry.autoscale.as_dict(),
                     scaler.seen)
    assert out["port"] == out["ref"]
    auto = out["port"][1]
    assert auto["scale_downs"] == 2 and auto["scale_ups"] >= 1
    assert auto["ticks"] == len(out["port"][2]) > 5
    # the autoscaler's actions never reach the fault counters
    want = 1 if "fail_replica" in sim_kw else 0
    assert out["port"][0]["faults"]["replica_failures"] == want


@pytest.mark.parametrize("space,sim_kw", [
    ("table2", dict(n_requests=80, mean_interarrival=0.5, seed=34)),
    ("dag", dict(n_requests=60, mean_interarrival=1.0, seed=35,
                 straggler_prob=0.2, straggler_factor=6.0)),
    ("cascade", dict(n_requests=60, mean_interarrival=0.7, seed=36)),
])
def test_replica_autoscaler_equals_reference(space, sim_kw):
    """The fleet's own autoscaler (``serving/fleet/autoscale.py``), each
    package's, on the AUTOSCALE branch: thresholds low enough that pools
    scale both ways; records, counters, telemetry and spans equal, and
    the controller's streak and cooldown state after the run."""
    kw = dict(interval_s=2.0, up_backlog_s=4.0, down_occupancy=0.5,
              up_sustain=1, down_sustain=2, cooldown_s=4.0)
    out = {}
    for name, P, F in (("ref", REF, jautoscale), ("port", PORT, tautoscale)):
        scaler = F.ReplicaAutoscaler(F.AutoscaleConfig(**kw))
        rt, reqs = _runtime(P, space, sim_kw, {"autoscaler": scaler})
        rt.run(reqs)
        assert len(rt.records) == sim_kw["n_requests"]
        out[name] = (_observed(P, rt), rt.telemetry.autoscale.as_dict(),
                     scaler._up_streak, scaler._down_streak,
                     scaler._last_action)
    assert out["port"] == out["ref"]
    auto = out["port"][1]
    assert auto["scale_ups"] > 0 and auto["scale_downs"] > 0


# ---------------------------------------------------------------------------
# tests/test_runtime_parity.py, each test written once over a package and
# run on both
# ---------------------------------------------------------------------------


def _parity_run(P, cfg, reqs, qt, runtime, compress):
    rt_cfg = P.rt.RuntimeConfig(compress_handoff=compress) \
        if runtime == "continuous" else None
    eng = _engine(P, P.work.CyclePolicy(), qt, cfg, runtime=runtime,
                  runtime_cfg=rt_cfg)
    return eng, {r.rid: r for r in eng.run(reqs)}


def _transport(P, compress):
    return P.rt.HandoffTransport(P.rt.TransportConfig(compress=compress),
                                 **P.dev)


def _parity(P, regime, compress, mode):
    cfg = P.eng.SimConfig(n_requests=120, mean_interarrival=1.5, seed=11,
                          straggler_mode=mode, **REGIMES[regime])
    reqs, qt = _table(P, cfg)
    eng_seq, rec_seq = _parity_run(P, cfg, reqs, qt, "sequential", compress)
    eng_cont, rec_cont = _parity_run(P, cfg, reqs, qt, "continuous",
                                     compress)
    rids = {r.rid for r in reqs}
    assert set(rec_seq) == rids and set(rec_cont) == rids
    assert [rec_seq[i].arm for i in sorted(rids)] == \
        [rec_cont[i].arm for i in sorted(rids)]
    transport = _transport(P, compress)
    for i in sorted(rids):
        arm = P.arms.ARMS[rec_seq[i].arm]
        assert rec_seq[i].quality == qt[i, arm.idx]
        expected = transport.quality_delta(arm.family, qt[i, arm.idx])
        assert rec_cont[i].quality == pytest.approx(expected)
    assert eng_seq.fault_counters.as_dict() == \
        eng_cont.fault_counters.as_dict()
    fc = eng_cont.fault_counters
    if "straggler_prob" in REGIMES[regime]:
        assert fc.stragglers_injected > 0
        assert fc.stragglers_reissued == fc.stragglers_injected
        if mode == "item":
            assert fc.reissued_per_item == fc.stragglers_reissued
            assert fc.reissued_whole_batch == 0
        else:
            assert fc.reissued_whole_batch == fc.stragglers_reissued
            assert fc.reissued_per_item == 0
    else:
        assert fc.stragglers_injected == fc.stragglers_reissued == 0
    if "fail_replica" in REGIMES[regime]:
        assert fc.replica_failures == 1 and fc.replica_recoveries == 1
    else:
        assert fc.replica_failures == fc.replica_recoveries == 0
    cont = list(rec_cont.values())
    values = [q for r in cont for q in (r.reward, *r.quality.values())]
    obs = {"exact": (_timing(rec_seq.values()), _timing(cont),
                     fc.as_dict())}
    if compress:
        obs["approx"] = values
    else:
        obs["exact"] += (values,)
    return obs


@pytest.mark.parametrize("mode", ["item", "batch"])
@pytest.mark.parametrize("compress", [True, False], ids=["int8", "raw"])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_runtime_parity(regime, compress, mode):
    _compare(lambda P: _parity(P, regime, compress, mode))


def _span_parity(P, regime, mode):
    cfg = P.eng.SimConfig(n_requests=120, mean_interarrival=1.5, seed=11,
                          straggler_mode=mode, **REGIMES[regime])
    reqs, qt = _table(P, cfg)
    eng_seq, _ = _parity_run(P, cfg, reqs, qt, "sequential", True)
    eng_cont, _ = _parity_run(P, cfg, reqs, qt, "continuous", True)
    assert eng_seq.tracer.coverage() == eng_cont.tracer.coverage() == 1.0
    out = []
    for rid in sorted(r.rid for r in reqs):
        structure = P.obs.span_structure(eng_cont.tracer, rid)
        assert P.obs.span_structure(eng_seq.tracer, rid) == structure
        arm = P.arms.ARMS[eng_seq.tracer.requests[rid].arm_idx]
        n_segs = sum(1 for s in eng_seq.tracer.requests[rid].spans
                     if s.kind == "segment")
        assert n_segs == arm.program.n_segments
        out.append(structure)
    return {"exact": out}


@pytest.mark.parametrize("mode", ["item", "batch"])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_span_structure_parity(regime, mode):
    _compare(lambda P: _span_parity(P, regime, mode))


def _attribution(P, runtime):
    cfg = P.eng.SimConfig(n_requests=120, mean_interarrival=1.5, seed=11,
                          **REGIMES["degraded"])
    reqs, qt = _table(P, cfg)
    eng, recs = _parity_run(P, cfg, reqs, qt, runtime, True)
    assert P.obs.attribution_residual(eng.tracer) < 1e-6
    out = []
    for rid, rec in sorted(recs.items()):
        tr = eng.tracer.requests[rid]
        assert tr.complete
        assert tr.t_total == pytest.approx(rec.t_total, abs=1e-6)
        assert tr.attributed_s() == pytest.approx(rec.t_total, abs=1e-6)
        out.append((tr.t_total, tr.attributed_s()))
    return {"exact": out}


@pytest.mark.parametrize("runtime", ["sequential", "continuous"])
def test_attribution_sums_to_t_total(runtime):
    _compare(lambda P: _attribution(P, runtime))


def _sequential_prices(P):
    cfg = P.eng.SimConfig(n_requests=24, mean_interarrival=500.0, seed=3)
    reqs, qt = _table(P, cfg)
    runs = {}
    for compress in (False, True):
        eng = _engine(P, P.work.CyclePolicy(), qt, cfg, runtime="sequential",
                      runtime_cfg=P.rt.RuntimeConfig(
                          compress_handoff=compress))
        runs[compress] = {r.rid: r for r in eng.run(reqs)}
    transport = _transport(P, True)
    deltas = []
    for rid, r_raw in runs[False].items():
        r_c = runs[True][rid]
        assert r_c.arm == r_raw.arm
        arm = P.arms.ARMS[r_c.arm]
        delta = arm.n_hops * (
            P.lat.transfer_time(arm.family, reqs[rid].rtt_ms,
                                compressed=False)
            - P.lat.transfer_time(arm.family, reqs[rid].rtt_ms,
                                  compressed=True))
        assert r_raw.t_total - r_c.t_total == pytest.approx(delta)
        assert (delta == 0.0) if arm.family is None else (delta > 0.0)
        assert r_c.quality == pytest.approx(
            transport.quality_delta(arm.family, qt[rid, r_c.arm]))
        assert r_raw.quality == qt[rid, r_raw.arm]
        deltas.append((rid, r_raw.t_total, r_c.t_total, delta))
    return {"exact": deltas,
            "approx": [q for r in runs[True].values()
                       for q in r.quality.values()]}


def test_sequential_prices_compressed_handoff():
    _compare(_sequential_prices)


def _latency_parity(P, compress):
    cfg = P.eng.SimConfig(n_requests=33, mean_interarrival=1000.0, seed=5)
    reqs, qt = _table(P, cfg)
    runs = {}
    for runtime in ("sequential", "continuous"):
        rt_cfg = P.rt.RuntimeConfig(compress_handoff=compress, linger_s=0.0)
        eng = _engine(P, P.work.CyclePolicy(), qt, cfg, runtime=runtime,
                      runtime_cfg=rt_cfg)
        runs[runtime] = {r.rid: r for r in eng.run(reqs)}
    seq, cont = runs["sequential"], runs["continuous"]
    assert sorted(seq) == sorted(cont)
    for rid in seq:
        assert seq[rid].arm == cont[rid].arm
        assert seq[rid].t_total == pytest.approx(cont[rid].t_total)
        assert seq[rid].quality == pytest.approx(cont[rid].quality)
        assert seq[rid].reward == pytest.approx(cont[rid].reward)
    obs = {"exact": (_timing(seq.values()), _timing(cont.values()))}
    values = _rewards_quality(cont.values())
    if compress:
        obs["approx"] = values
    else:
        obs["exact"] += (values,)
    return obs


@pytest.mark.parametrize("compress", [True, False], ids=["int8", "raw"])
def test_latency_model_parity_under_compression(compress):
    _compare(lambda P: _latency_parity(P, compress))


def test_continuous_is_default_runtime():
    for P in (REF, PORT):
        eng = P.eng.ServingEngine(P.work.CyclePolicy(), None,
                                  P.eng.SimConfig(), **P.dev)
        assert eng.runtime == "continuous"
        assert _engine(P, P.work.CyclePolicy(), None, P.eng.SimConfig(),
                       runtime="sequential").runtime == "sequential"


def _reissue_caps(P, mode):
    def p95(**fault_kw):
        cfg = P.eng.SimConfig(n_requests=150, mean_interarrival=2.0, seed=7,
                              straggler_mode=mode, **fault_kw)
        reqs, qt = _table(P, cfg)
        recs = _cont(P, P.work.CyclePolicy(), qt, cfg).run(reqs)
        return float(np.percentile([r.t_total for r in recs], 95))

    base = p95()
    capped = p95(straggler_prob=0.3, straggler_factor=50.0)
    mild = p95(straggler_prob=0.3, straggler_factor=2.5)
    assert capped < base * 6
    if mode == "batch":
        assert capped == pytest.approx(mild, rel=0.35)
    else:
        assert capped <= mild
    return {"exact": (base, capped, mild)}


@pytest.mark.parametrize("mode", ["item", "batch"])
def test_straggler_reissue_caps_latency_continuous(mode):
    _compare(lambda P: _reissue_caps(P, mode))


def _partial_vs_whole(P):
    runs = {}
    for mode in ("item", "batch"):
        cfg = P.eng.SimConfig(n_requests=200, mean_interarrival=1.0, seed=13,
                              straggler_prob=0.3, straggler_factor=10.0,
                              straggler_mode=mode)
        reqs, qt = _table(P, cfg)
        eng = _cont(P, P.work.CyclePolicy(), qt, cfg)
        runs[mode] = (eng, {r.rid: r for r in eng.run(reqs)})
    (eng_i, rec_i), (eng_b, rec_b) = runs["item"], runs["batch"]
    rids = sorted(rec_i)
    assert rids == sorted(rec_b)
    assert [rec_i[i].arm for i in rids] == [rec_b[i].arm for i in rids]
    assert all(rec_i[i].quality == rec_b[i].quality for i in rids)
    fi, fb = eng_i.fault_counters, eng_b.fault_counters
    assert fi.stragglers_injected == fb.stragglers_injected > 0
    assert fi.stragglers_reissued == fb.stragglers_reissued > 0
    assert fi.reissued_per_item == fi.stragglers_reissued
    assert fb.reissued_whole_batch == fb.stragglers_reissued
    p95_i = np.percentile([rec_i[i].t_total for i in rids], 95)
    p95_b = np.percentile([rec_b[i].t_total for i in rids], 95)
    assert p95_i < p95_b
    pools_i = eng_i.telemetry.pools.values()
    items_i = sum(p.reissued_items for p in pools_i)
    items_b = sum(p.reissued_items for p in eng_b.telemetry.pools.values())
    assert items_i == fi.stragglers_reissued and items_b >= items_i
    assert sum(p.reissued_partial_batches for p in pools_i) > 0
    assert sum(p.reissued_batches for p in pools_i) == 0
    return {"exact": (_timing(rec_i.values()), _timing(rec_b.values()),
                      fi.as_dict(), fb.as_dict(), items_i, items_b)}


def test_partial_reissue_beats_whole_batch_tail():
    _compare(_partial_vs_whole)


@pytest.mark.parametrize("runtime", ["sequential", "continuous"])
def test_unknown_straggler_mode_rejected(runtime):
    for P in (REF, PORT):
        cfg = P.eng.SimConfig(n_requests=5, straggler_mode="speculative")
        reqs, qt = _table(P, cfg)
        with pytest.raises(ValueError, match="straggler_mode"):
            _engine(P, P.work.CyclePolicy(), qt, cfg,
                    runtime=runtime).run(reqs)


def _failure_shifts_load(P):
    cfg = P.eng.SimConfig(n_requests=100, mean_interarrival=1.0, seed=5,
                          fail_replica=("sdxl", 1, 20.0, np.inf))
    reqs, qt = _table(P, cfg)
    eng = _cont(P, P.work.CyclePolicy(), qt, cfg)
    recs = eng.run(reqs)
    assert len(recs) == len(reqs)
    assert eng.telemetry.pools["sdxl"].failures == 1
    assert eng.fault_counters.replica_failures == 1
    assert eng.fault_counters.replica_recoveries == 0
    return {"exact": (_timing(recs), _telemetry(eng))}


def test_replica_failure_shifts_load_to_twin():
    _compare(_failure_shifts_load)


def _spy(P):
    class Spy(P.work.CyclePolicy):
        def __init__(self):
            super().__init__()
            self.ctxs, self.masks = [], []

        def select(self, ctx, avail):
            self.ctxs.append(np.array(ctx))
            self.masks.append(np.array(avail))
            return super().select(ctx, avail)

    return Spy()


def _telemetry_context(P):
    d = P.sctx.context_dim(telemetry_context=True)
    assert d == 10
    seen = []
    for runtime in ("sequential", "continuous"):
        cfg = P.eng.SimConfig(n_requests=60, mean_interarrival=1.0, seed=2,
                              telemetry_context=True)
        reqs, qt = _table(P, cfg)
        spy = _spy(P)
        _engine(P, spy, qt, cfg, runtime=runtime).run(reqs)
        assert all(c.shape == (d,) for c in spy.ctxs)
        tail = np.array([c[8:] for c in spy.ctxs])
        assert np.all(tail >= 0.0) and np.all(tail <= 1.0)
        if runtime == "continuous":
            assert tail[:, 0].max() > 0.0
        seen.append(np.array(spy.ctxs).tolist())
    cfg = P.eng.SimConfig(n_requests=40, mean_interarrival=1.0, seed=2,
                          telemetry_context=True)
    reqs, qt = _table(P, cfg)
    rise = P.pol.RisePolicy(seed=0, ctx_dim=d, **P.dev)
    recs = _cont(P, rise, qt, cfg).run(reqs)
    assert len(recs) == 40 and all(np.isfinite(r.reward) for r in recs)
    return {"exact": seen}


def test_telemetry_context_features():
    _compare(_telemetry_context)


# ---------------------------------------------------------------------------
# tests/test_runtime.py's engine cases
# ---------------------------------------------------------------------------


def _run_engine(P, policy, n, mu, rt_cfg=None, seed=3, runtime="continuous"):
    cfg = P.eng.SimConfig(n_requests=n, mean_interarrival=mu, seed=seed)
    reqs, qt = _table(P, cfg)
    eng = _engine(P, policy, qt, cfg, runtime=runtime, runtime_cfg=rt_cfg)
    return eng, reqs, eng.run(reqs)


def _two_phase_ordering(P):
    eng, _, recs = _run_engine(P, P.pol.RoundRobinPolicy(), 80, 2.0)
    assert len(recs) == 80
    saw_relay = 0
    for rid, tr in eng.trace.items():
        assert tr["done"] >= tr["arrival"]
        if "edge_start" in tr:
            saw_relay += 1
            assert tr["arrival"] <= tr["edge_start"] <= tr["edge_done"]
            assert tr["device_enqueue"] == pytest.approx(
                tr["edge_done"] + tr["transfer_s"])
            assert tr["device_start"] >= tr["device_enqueue"] - 1e-9
            assert tr["done"] >= tr["device_start"]
            assert tr["transfer_bytes"] > 0
        else:
            assert tr["device_start"] >= tr["arrival"]
    assert saw_relay > 20
    return {"exact": (eng.trace, _timing(recs)),
            "approx": _rewards_quality(recs)}


def _compatible_with_summarize(P):
    _, _, recs = _run_engine(P, P.pol.RoundRobinPolicy(), 60, 2.0)
    s = P.eng.summarize(recs)
    assert np.isfinite(s["total_reward"])
    assert 0.0 <= s["text_fraction"] <= 1.0
    assert len(s["arm_histogram"]) == P.arms.N_ARMS
    return {"exact": {k: s[k] for k in ("arm_histogram", "text_fraction",
                                        "mean_latency_s", "p95_latency_s",
                                        "time_reward")},
            "approx": [v for k, v in sorted(s.items())
                       if k != "arm_histogram"]}


def _unknown_runtime(P):
    with pytest.raises(ValueError):
        P.eng.ServingEngine(P.pol.RoundRobinPolicy(), None, P.eng.SimConfig(),
                            runtime="warp", **P.dev)
    return {"exact": None}


def _doubles_throughput(P):
    def throughput(runtime):
        _, reqs, recs = _run_engine(P, P.work.CyclePolicy(), 300, 0.25,
                                    runtime=runtime)
        done = max(r.t_total + reqs[r.rid].arrival for r in recs)
        arms = [r.arm for r in _by_rid(recs)]
        return len(recs) / (done - reqs[0].arrival), arms

    th_seq, arms_seq = throughput("sequential")
    th_cont, arms_cont = throughput("continuous")
    assert arms_seq == arms_cont
    assert th_cont >= 2.0 * th_seq
    return {"exact": (th_seq, th_cont, arms_cont)}


def _per_request_context(P):
    spy = _spy(P)
    _run_engine(P, spy, 50, 1.0)
    assert len(spy.ctxs) == 50
    assert all(c.shape == (8,) for c in spy.ctxs)
    assert all(m.shape == (P.arms.N_ARMS,) for m in spy.masks)
    return {"exact": (np.array(spy.ctxs).tolist(),
                      np.array(spy.masks).tolist())}


def _telemetry_export(P):
    eng, _, _ = _run_engine(P, P.work.CyclePolicy(), 120, 0.5)
    tel = P.obs.export_runtime_telemetry(eng.telemetry)
    assert set(tel) == {"sd3l", "sd3m", "sdxl", "vega"}
    for t in tel.values():
        assert 0.0 < t["batch_occupancy"] <= 1.0
        assert t["n_batches"] > 0 and t["mean_queue_depth"] >= 0.0
    assert tel["sdxl"]["bytes_transferred"] > 0
    assert tel["sd3l"]["bytes_transferred"] > 0
    assert tel["vega"]["bytes_transferred"] == 0
    eng_raw, _, _ = _run_engine(
        P, P.work.CyclePolicy(), 120, 0.5,
        rt_cfg=P.rt.RuntimeConfig(compress_handoff=False))
    raw = P.obs.export_runtime_telemetry(eng_raw.telemetry)
    assert tel["sd3l"]["bytes_transferred"] < \
        raw["sd3l"]["bytes_transferred"] / 1.9
    assert P.obs.export_runtime_telemetry(None) == {}
    return {"exact": (tel, raw)}


def _backpressure(P):
    spy = _spy(P)
    _run_engine(P, spy, 250, 0.2)
    masked = sum(int(not m.all()) for m in spy.masks)
    assert masked > 0
    return {"exact": (masked, np.array(spy.masks).tolist())}


RUNTIME_CASES = {
    "two_phase_ordering": _two_phase_ordering,
    "records_compatible_with_summarize": _compatible_with_summarize,
    "unknown_runtime_rejected": _unknown_runtime,
    "continuous_runtime_doubles_throughput": _doubles_throughput,
    "policy_sees_per_request_context": _per_request_context,
    "telemetry_export": _telemetry_export,
    "backpressure_steers_availability": _backpressure,
}


@pytest.mark.parametrize("case", list(RUNTIME_CASES))
def test_reference_runtime_case(case):
    _compare(RUNTIME_CASES[case])


def test_device_follows_the_caller():
    """The runtime's transport runs where the caller says: the CPU here,
    the card by default (which this machine has not)."""
    rt, reqs = _runtime(PORT, "table2", dict(n_requests=8, seed=1),
                        {"compress_handoff": True})
    assert rt.transport.device.type == "cpu"
    rt.run(reqs)
    assert set(rt.transport._fidelity) == {"XL", "F3"}
    assert all(type(r.reward) is float and type(r.t_total) is float
               for r in rt.records)
