"""The fleet, the port against the JAX package on the CPU
(``repro_torch/serving/fleet/{topology,router,autoscale,engine}.py``
against ``repro/serving/fleet/``).  The federated merge's own cases are
``tests/test_torch_federated.py``.

Each case builds the same configuration in both packages, draws each
package's requests with its own ``make_requests`` and serves them over
each package's ``serving/workload.py::synthetic_quality_table``; the
port's runtimes run their transports on the CPU.

Tolerances:
* the router and the autoscaler are host Python on host numbers: every
  pick and every action equal, over seeded sweeps of snapshot and view
  sequences;
* uncompressed (``RuntimeConfig(compress_handoff=False)``): every
  ``Record`` field, ``per_cluster`` in completion order, the
  assignments, each cluster's telemetry (pool stats, fault and autoscale
  counters) and ``cumulative_reward`` equal bit for bit;
* compressed (the default ``RuntimeConfig()``): the same but quality
  values and rewards, which are within ``COMPRESSED_RTOL`` of
  ``max(|ref|, 1)`` (``tests/test_torch_engine.py``: the int8 round
  trip's measured error differs across frameworks in its last bits);
  ``cumulative_reward`` within ``COMPRESSED_RTOL`` per request;
* a one-cluster fleet equals the port's standalone runtime bit for bit,
  compressed or not (the same transport prices both);
* federated RISE by replay: the reference's ``FederatedRisePolicy`` on
  each cluster, its picks in decision order replayed through the port's
  fleet into port ``FederatedRisePolicy`` instances (``FedReplay``
  forwards the ``state`` and ``take_delta`` the federation reads and
  writes).  Records as above, ``n_gossips`` equal, and in the
  federation's base, every cluster's live state and every cluster's
  pending delta: counts exact, ``A`` exact off its diagonal and within
  ``FED_ULPS`` on it (the reference jits its update, and XLA fuses the
  diagonal's ``c_i·c_i + λ`` into one multiply-add), ``b`` exact
  uncompressed and within ``FED_ULPS`` compressed (its rewards differ in
  their last bits).  Read over both replay cases, after 3 to 50 updates
  of an arm across the fleet: the diagonal of ``A`` 2 ulps at most,
  ``b`` 0 uncompressed and 2 compressed; so ``FED_ULPS`` is 4, twice the
  reading.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.serving import fleet as jfleet
from repro.serving.fleet import engine as jfleng
from repro_torch.serving import fleet as tfleet
from repro_torch.serving.fleet import engine as tfleng
from test_torch_engine import (COMPRESSED_RTOL, PORT, REF, ReplayPolicy,
                               _rel, _rewards_quality, _timing, _ulps)

torch.set_num_threads(1)

FREF = SimpleNamespace(**vars(REF), fleet=jfleet, fleng=jfleng)
FPORT = SimpleNamespace(**vars(PORT), fleet=tfleet, fleng=tfleng)

FED_ULPS = 4  # twice the largest reading (see the docstring)

# benchmarks/bench_fleet.py's scenario: three heterogeneous clusters (the
# testbed inventory, one replica per pool, four per pool), one
# fleet-wide stream at μ = 1.0 s, gossip every 30 simulated seconds
HEAVY_MU = 1.0
GOSSIP_PERIOD_S = 30.0
BENCH_STREAM = dict(n_requests=200, mean_interarrival=HEAVY_MU, seed=23)
POOLS = ("sdxl", "ssd1b", "vega", "sd3l", "sd3lt", "sd3m")
REGIONS = ("east", "west", "south")


def _bench_clusters(P) -> tuple:
    return (
        P.fleet.ClusterSpec("edge-a", region="east"),
        P.fleet.ClusterSpec("edge-b", region="west",
                            pool_replicas=dict.fromkeys(POOLS, 1)),
        P.fleet.ClusterSpec("edge-c", region="south",
                            pool_replicas=dict.fromkeys(POOLS, 4)),
    )


def region_of(req) -> str:
    """bench_fleet's home region of a request (rid round-robin)."""
    return REGIONS[req.rid % len(REGIONS)]


def _fleet_engine(P, fleet, cfg, qt, policies, **kw):
    """``P``'s FleetEngine (the port's transports on the CPU)."""
    return P.fleet.FleetEngine(fleet, cfg, qt, policies, **P.dev, **kw)


def _stream(P, sim_kw):
    cfg = P.eng.SimConfig(**sim_kw)
    reqs = P.eng.make_requests(cfg)
    return cfg, reqs, P.work.synthetic_quality_table(reqs)


def _telemetry(tel) -> dict:
    return {"summary": tel.summary(), "faults": tel.faults.as_dict(),
            "autoscale": tel.autoscale.as_dict()}


def _fields(rec) -> tuple:
    """Every field of a Record, its context as bytes and dtype."""
    return (rec.rid, rec.arm, rec.reward, rec.t_total, rec.quality,
            rec.ctx.tobytes(), str(rec.ctx.dtype), rec.wait_s,
            type(rec.reward), type(rec.t_total))


def _compare(case):
    """A case written over a package, run on both: its ``exact``
    observables equal, its ``approx`` floats within ``COMPRESSED_RTOL``."""
    ref, port = case(FREF), case(FPORT)
    assert ref.keys() == port.keys()
    assert port["exact"] == ref["exact"]
    if "approx" in ref:
        assert len(port["approx"]) == len(ref["approx"]) > 0
        worst = max(_rel(a, b) for a, b in zip(ref["approx"], port["approx"]))
        assert worst <= COMPRESSED_RTOL, worst


def _fleet_out(res) -> dict:
    """What a fleet run returns besides its floats' last bits: each
    cluster's completion order with timing, the assignments, telemetry
    and gossips."""
    return {"per_cluster": [[(r.rid, r.arm, r.t_total, r.wait_s,
                              r.ctx.tobytes()) for r in recs]
                            for recs in res.per_cluster],
            "records": _timing(res.records),
            "assignments": res.assignments,
            "telemetry": [_telemetry(t) for t in res.telemetry],
            "n_gossips": res.n_gossips}


# ---------------------------------------------------------------------------
# tests/test_fleet.py's autoscaling, routing and fleet-engine cases, each
# written once over a package and run on both
# ---------------------------------------------------------------------------


def _view(backlog=0.0, occ=1.0, depth=0, alive=2, parked=0, total=2):
    return {"n_alive": alive, "n_parked": parked, "n_total": total,
            "depth": depth, "backlog_s": backlog, "occupancy": occ}


def case_hysteresis_no_flapping(P):
    """Backlog oscillating above/below the threshold every tick never
    sustains a streak, so the controller stays quiet forever."""
    cfg = P.fleet.AutoscaleConfig(interval_s=1.0, up_backlog_s=10.0,
                                  down_occupancy=0.2, up_sustain=2,
                                  down_sustain=2, cooldown_s=0.0)
    sc = P.fleet.ReplicaAutoscaler(cfg)
    acts = []
    for tick in range(40):
        v = (_view(backlog=50.0, occ=1.0) if tick % 2 == 0
             else _view(backlog=0.0, occ=0.0, depth=0, parked=0))
        acts += sc.decide(float(tick), {"sdxl": v})
    assert acts == []
    return {"exact": acts}


def case_sustained_backlog_and_cooldown(P):
    cfg = P.fleet.AutoscaleConfig(interval_s=1.0, up_backlog_s=10.0,
                                  up_sustain=2, cooldown_s=5.0)
    sc = P.fleet.ReplicaAutoscaler(cfg)
    acts = []
    for tick in range(12):
        acts += [(tick, a) for a in sc.decide(
            float(tick), {"sdxl": _view(backlog=99.0, alive=1, parked=1)})]
    assert [t for t, _ in acts] == [1, 6, 11]
    assert all(a == ("sdxl", +1) for _, a in acts)
    return {"exact": acts}


def case_scale_down_respects_min_replicas(P):
    cfg = P.fleet.AutoscaleConfig(interval_s=1.0, down_occupancy=0.5,
                                  down_sustain=1, cooldown_s=0.0,
                                  min_replicas=1)
    sc = P.fleet.ReplicaAutoscaler(cfg)
    got = [sc.decide(0.0, {"p": _view(occ=0.0, alive=2)}),
           sc.decide(1.0, {"p": _view(occ=0.0, alive=1)})]
    assert got == [[("p", -1)], []]
    return {"exact": got}


def case_scale_up_only_revives_parked(P):
    cfg = P.fleet.AutoscaleConfig(interval_s=1.0, up_backlog_s=1.0,
                                  up_sustain=1, cooldown_s=0.0)
    sc = P.fleet.ReplicaAutoscaler(cfg)
    got = [sc.decide(0.0, {"p": _view(backlog=999.0, parked=0)}),
           sc.decide(1.0, {"p": _view(backlog=999.0, alive=1, parked=1)})]
    assert got == [[], [("p", +1)]]
    return {"exact": got}


def case_runtime_autoscale_integration(P):
    """An idle-ish workload triggers scale-downs through the REPLICA_FAIL
    event path; every request is served and the fault counters stay
    untouched (compressed: the default RuntimeConfig)."""
    cfg, reqs, qt = _stream(P, dict(n_requests=60, mean_interarrival=6.0,
                                    seed=3))
    sc = P.fleet.ReplicaAutoscaler(P.fleet.AutoscaleConfig(
        interval_s=2.0, down_occupancy=0.6, down_sustain=2, cooldown_s=4.0))
    rt = P.rteng.ContinuousRuntime(P.work.CyclePolicy(), qt, cfg,
                                   P.rt.RuntimeConfig(autoscaler=sc),
                                   **P.dev)
    recs = rt.run(reqs)
    assert len(recs) == cfg.n_requests
    a = rt.telemetry.autoscale
    assert a.ticks > 0 and a.scale_downs > 0
    zeroes = {k: 0 for k in rt.fault_counters.as_dict()}
    assert rt.fault_counters.as_dict() == zeroes
    for st in rt.pools.values():
        assert st.scaled_down <= st.failed
    return {"exact": {"timing": _timing(recs), "telemetry":
                      _telemetry(rt.telemetry),
                      "parked": {p: sorted(st.scaled_down)
                                 for p, st in rt.pools.items()}},
            "approx": _rewards_quality(recs)}


def case_runtime_without_autoscaler(P):
    cfg, reqs, qt = _stream(P, dict(n_requests=30, mean_interarrival=4.0,
                                    seed=5))
    rt = P.rteng.ContinuousRuntime(P.work.CyclePolicy(), qt, cfg,
                                   P.rt.RuntimeConfig(), **P.dev)
    rt.run(reqs)
    auto = rt.telemetry.autoscale.as_dict()
    assert auto == {"ticks": 0, "scale_ups": 0, "scale_downs": 0,
                    "scale_ups_by_pool": {}, "scale_downs_by_pool": {}}
    return {"exact": auto}


def _snap(queued=0, inflight=0, capacity=12):
    return {"occupancy": {}, "avail_frac": 1.0, "backlog_s": {},
            "queued": queued, "inflight": inflight, "capacity": capacity}


def _three(P, router="least_loaded", **kw):
    C = P.fleet.ClusterSpec
    return P.fleet.FleetConfig(clusters=(
        C("a", region="east"), C("b", region="west"), C("c", region="east"),
    ), router=router, **kw)


def case_least_loaded_ties_by_index(P):
    r = P.fleet.WorkloadRouter(_three(P))
    got = [r.route(None, [_snap(queued=5), _snap(queued=1),
                          _snap(queued=9)]),
           r.route(None, [_snap(), _snap(), _snap()]),
           P.fleet.load_score(_snap(capacity=0)),
           r.route(None, [_snap(capacity=0), _snap(queued=99)])]
    assert got == [1, 0, float("inf"), 1]
    return {"exact": got}


def case_locality_prefers_home_until_spill(P):
    r = P.fleet.WorkloadRouter(_three(P, "locality", spill_score=0.5))
    near = [_snap(queued=3, capacity=12), _snap(), _snap()]
    far = [_snap(queued=30, capacity=12), _snap(queued=2), _snap(queued=9)]
    got = [r.route(None, near, region="east"),
           r.route(None, far, region="east"),
           r.route(None, far, region="west"),
           r.route(None, far, region=None)]
    assert got == [0, 1, 1, 1]
    return {"exact": got}


def case_weighted_smooth_and_proportional(P):
    C = P.fleet.ClusterSpec
    r = P.fleet.WorkloadRouter(P.fleet.FleetConfig(
        clusters=(C("a", weight=3.0), C("b", weight=1.0)), router="weighted"))
    picks = [r.route(None, [_snap(), _snap()]) for _ in range(8)]
    assert picks.count(0) == 6 and picks.count(1) == 2
    assert picks[:4] == [0, 0, 1, 0]
    return {"exact": picks}


def case_fleet_config_validation(P):
    C, F = P.fleet.ClusterSpec, P.fleet.FleetConfig
    errors = []
    for kw in (dict(clusters=()),
               dict(clusters=(C("x"), C("x"))),
               dict(clusters=(C("x"),), router="magic"),
               dict(clusters=(C("x"),), gossip_period_s=0.0)):
        with pytest.raises(ValueError) as e:
            F(**kw)
        errors.append(str(e.value))
    for what, msg in zip(("at least one", "duplicate", "unknown router",
                          "must be positive"), errors):
        assert what in msg
    fleet = F(clusters=(C("x", pool_replicas={"sdxl": 3}), C("y"),
                        C("z", weight=0.5)))
    return {"exact": {"errors": errors, "weights": fleet.weights(),
                      "n": fleet.n_clusters,
                      "policies": P.fleet.ROUTER_POLICIES}}


def case_single_cluster_matches_standalone(P):
    """A fleet of one is the standalone runtime (the reference's case, on
    its golden workload shape, compressed)."""
    cfg, reqs, qt = _stream(P, dict(n_requests=120, mean_interarrival=1.5,
                                    seed=11))
    solo = P.rteng.ContinuousRuntime(P.work.CyclePolicy(), qt, cfg,
                                     P.rt.RuntimeConfig(), **P.dev)
    recs_a = sorted(solo.run(reqs), key=lambda r: r.rid)
    eng = _fleet_engine(P, P.fleet.FleetConfig(
        clusters=(P.fleet.ClusterSpec("solo"),)), cfg, qt,
        [P.work.CyclePolicy()])
    recs_b = eng.run(reqs).records
    assert [_fields(r) for r in recs_a] == [_fields(r) for r in recs_b]
    return {"exact": _timing(recs_b), "approx": _rewards_quality(recs_b)}


def case_fleet_serves_every_request_and_spreads(P):
    cfg, reqs, qt = _stream(P, dict(n_requests=90, mean_interarrival=1.0,
                                    seed=7))
    C = P.fleet.ClusterSpec
    fleet = P.fleet.FleetConfig(clusters=(C("a"), C("b"), C("c")))
    res = _fleet_engine(P, fleet, cfg, qt,
                        [P.work.CyclePolicy() for _ in range(3)]).run(reqs)
    assert len(res.records) == cfg.n_requests
    assert sorted(res.assignments) == [r.rid for r in res.records]
    assert set(res.assignments.values()) == {0, 1, 2}
    assert res.per_cluster[0] and res.per_cluster[1]
    return {"exact": _fleet_out(res), "approx": _rewards_quality(res.records)}


def case_gossip_requires_federated_policies(P):
    cfg, _, qt = _stream(P, dict(n_requests=5, seed=1))
    C = P.fleet.ClusterSpec
    fleet = P.fleet.FleetConfig(clusters=(C("a"), C("b")),
                                gossip_period_s=10.0)
    with pytest.raises(ValueError, match="FederatedRisePolicy") as e:
        _fleet_engine(P, fleet, cfg, qt,
                      [P.work.CyclePolicy(), P.work.CyclePolicy()])
    return {"exact": str(e.value)}


def case_federated_run_gossips_and_serves(P):
    """Each package's own RISE draws (the port's from a torch generator),
    so only what holds whatever the draws is compared."""
    cfg, reqs, qt = _stream(P, dict(n_requests=80, mean_interarrival=1.0,
                                    seed=13))
    C = P.fleet.ClusterSpec
    fleet = P.fleet.FleetConfig(clusters=(C("a"), C("b")),
                                gossip_period_s=15.0)
    pols = [P.fleet.FederatedRisePolicy(seed=s, **P.dev) for s in (1, 14)]
    res = _fleet_engine(P, fleet, cfg, qt, pols).run(reqs)
    assert len(res.records) == cfg.n_requests
    assert res.n_gossips >= 1
    assert float(np.sum(np.asarray(pols[0].state.counts))) >= res.n_gossips
    return {"exact": {"served": sorted(r.rid for r in res.records),
                      "gossiped": res.n_gossips >= 1}}


def case_cluster_seed_stride(P):
    cfg, _, qt = _stream(P, dict(n_requests=5, seed=42))
    C = P.fleet.ClusterSpec
    eng = _fleet_engine(P, P.fleet.FleetConfig(clusters=(C("a"), C("b"))),
                        cfg, qt, [P.work.CyclePolicy(), P.work.CyclePolicy()])
    seeds = [rt.cfg.seed for rt in eng.runtimes]
    assert seeds == [42, 42 + P.fleng.SEED_STRIDE]
    return {"exact": {"seeds": seeds, "stride": P.fleng.SEED_STRIDE,
                      "profilers": [rt.rt.profiler for rt in eng.runtimes]}}


CASES = {
    "hysteresis_no_flapping": case_hysteresis_no_flapping,
    "sustained_backlog_and_cooldown": case_sustained_backlog_and_cooldown,
    "scale_down_respects_min_replicas": case_scale_down_respects_min_replicas,
    "scale_up_only_revives_parked": case_scale_up_only_revives_parked,
    "runtime_autoscale_integration": case_runtime_autoscale_integration,
    "runtime_without_autoscaler": case_runtime_without_autoscaler,
    "least_loaded_ties_by_index": case_least_loaded_ties_by_index,
    "locality_prefers_home_until_spill":
        case_locality_prefers_home_until_spill,
    "weighted_smooth_and_proportional": case_weighted_smooth_and_proportional,
    "fleet_config_validation": case_fleet_config_validation,
    "single_cluster_matches_standalone":
        case_single_cluster_matches_standalone,
    "fleet_serves_every_request_and_spreads":
        case_fleet_serves_every_request_and_spreads,
    "gossip_requires_federated_policies":
        case_gossip_requires_federated_policies,
    "federated_run_gossips_and_serves": case_federated_run_gossips_and_serves,
    "cluster_seed_stride": case_cluster_seed_stride,
}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_fleet_case(case):
    _compare(CASES[case])


# ---------------------------------------------------------------------------
# seeded sweeps: the router's picks and the autoscaler's actions
# ---------------------------------------------------------------------------


def _random_clusters(P, rng, n):
    specs = []
    for k in range(n):
        inv = ({p: int(rng.integers(0, 5)) for p in POOLS}
               if rng.random() < 0.4 else None)
        weight = float(rng.uniform(0.1, 5.0)) if rng.random() < 0.5 else None
        specs.append(P.fleet.ClusterSpec(
            f"c{k}", pool_replicas=inv, weight=weight,
            region=str(rng.choice(REGIONS + ("north",)))))
    return tuple(specs)


@pytest.mark.parametrize("policy", ["least_loaded", "locality", "weighted"])
@pytest.mark.parametrize("seed", range(6))
def test_router_sweep_equals_reference(policy, seed):
    """Random fleets (1-5 clusters, regions shared or not, explicit and
    default weights, spill thresholds) and 300 random snapshot sequences
    with small integer loads, so that scores tie often and dead clusters
    (capacity 0) occur: every pick and every score equal."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    state = rng.bit_generator.state
    routers = []
    for P in (FREF, FPORT):
        rng.bit_generator.state = state  # both packages get one fleet
        fleet = P.fleet.FleetConfig(
            clusters=_random_clusters(P, rng, n), router=policy,
            spill_score=float(rng.uniform(0.2, 3.0)))
        routers.append(P.fleet.WorkloadRouter(fleet))
    jr, tr = routers
    assert tr.fleet.weights() == jr.fleet.weights()
    assert tr._home == jr._home
    picks = []
    for _ in range(300):
        snaps = [_snap(queued=int(rng.integers(0, 6)),
                       inflight=int(rng.integers(0, 6)),
                       capacity=int(rng.integers(0, 4)))
                 for _ in range(n)]
        region = [*REGIONS, "north", None][int(rng.integers(0, 5))]
        assert [FPORT.fleet.load_score(s) for s in snaps] == \
            [FREF.fleet.load_score(s) for s in snaps]
        got = tr.route(None, snaps, region=region)
        assert got == jr.route(None, snaps, region=region)
        picks.append(got)
    assert tr._wrr_current == jr._wrr_current
    if n > 1:
        assert len(set(picks)) > 1


@pytest.mark.parametrize("seed", range(8))
def test_autoscaler_sweep_equals_reference(seed):
    """Random thresholds and 200 ticks of per-pool views in regimes that
    last a few ticks each (busy: backlog over the threshold; idle:
    occupancy under it and an empty queue; mixed: anything; a fifth of
    the views on a threshold exactly), each action
    applied to the pool it names (alive and parked counts move as the
    runtime would move them): every action and the streak and cooldown
    state equal after every tick."""
    rng = np.random.default_rng(100 + seed)
    kw = dict(interval_s=float(rng.uniform(0.5, 5.0)),
              up_backlog_s=float(rng.uniform(1.0, 30.0)),
              down_occupancy=float(rng.uniform(0.05, 0.8)),
              up_sustain=int(rng.integers(1, 4)),
              down_sustain=int(rng.integers(1, 5)),
              cooldown_s=float(rng.choice([0.0, rng.uniform(0.0, 20.0)])),
              min_replicas=int(rng.integers(0, 3)))
    kw["max_replicas"] = (None if rng.random() < 0.5
                          else kw["min_replicas"] + int(rng.integers(1, 4)))
    jsc, tsc = (P.fleet.ReplicaAutoscaler(P.fleet.AutoscaleConfig(**kw))
                for P in (FREF, FPORT))
    pools = list(POOLS[:int(rng.integers(1, 5))])
    total = {p: kw["min_replicas"] + int(rng.integers(1, 4)) for p in pools}
    alive = dict(total)
    regime = {p: ("mixed", 0) for p in pools}
    ups = downs = 0
    for tick in range(200):
        now = tick * kw["interval_s"] + float(rng.uniform(0.0, 0.01))
        views = {}
        for p in pools:
            kind, left = regime[p]
            if left == 0:
                kind = ("busy", "idle", "mixed")[int(rng.integers(0, 3))]
                left = int(rng.integers(1, 9))
            regime[p] = (kind, left - 1)
            up = kw["up_backlog_s"]
            backlog = {"busy": up * float(rng.uniform(1.0, 2.0)),
                       "idle": up * float(rng.uniform(0.0, 0.5)),
                       "mixed": up * float(rng.uniform(0.0, 2.0))}[kind]
            occ = (kw["down_occupancy"] * float(rng.uniform(0.0, 1.0))
                   if kind == "idle" else float(rng.random()))
            if rng.random() < 0.2:  # on a threshold exactly
                backlog, occ = ((up, occ) if kind != "idle"
                                else (backlog, kw["down_occupancy"]))
            depth = 0 if kind == "idle" else int(rng.integers(0, 3))
            views[p] = {"n_alive": alive[p], "n_parked": total[p] - alive[p],
                        "n_total": total[p], "depth": depth,
                        "backlog_s": backlog, "occupancy": occ}
        acts = tsc.decide(now, views)
        assert acts == jsc.decide(now, views)
        for p, d in acts:
            alive[p] += d
            ups, downs = ups + (d > 0), downs + (d < 0)
        assert (tsc._up_streak, tsc._down_streak, tsc._last_action) == \
            (jsc._up_streak, jsc._down_streak, jsc._last_action)
    assert ups > 0 and downs > 0


# ---------------------------------------------------------------------------
# the one-cluster fleet, and bench_fleet's scenario
# ---------------------------------------------------------------------------


def _solo(P, compress):
    """The reference's golden-shape workload served by a one-cluster fleet
    and by the standalone runtime."""
    cfg, reqs, qt = _stream(P, dict(n_requests=120, mean_interarrival=1.5,
                                    seed=11))
    rt_cfg = P.rt.RuntimeConfig(compress_handoff=compress)
    solo = P.rteng.ContinuousRuntime(P.work.CyclePolicy(), qt, cfg, rt_cfg,
                                     **P.dev)
    solo.run(reqs)
    res = _fleet_engine(P, P.fleet.FleetConfig(
        clusters=(P.fleet.ClusterSpec("solo"),)), cfg, qt,
        [P.work.CyclePolicy()], rt_cfg=rt_cfg).run(reqs)
    return solo, res


@pytest.mark.parametrize("compress", [False, True])
def test_single_cluster_fleet_bit_for_bit(compress):
    """The port's one-cluster fleet equals the port's standalone runtime
    bit for bit (every Record field in completion order, telemetry,
    spans), and the reference's fleet bit for bit uncompressed."""
    (jsolo, jres), (tsolo, tres) = _solo(FREF, compress), _solo(FPORT,
                                                                compress)
    assert [_fields(r) for r in tres.per_cluster[0]] == \
        [_fields(r) for r in tsolo.records]
    assert _telemetry(tres.telemetry[0]) == _telemetry(tsolo.telemetry)
    assert tres.telemetry[0] is not tsolo.telemetry
    # the reference holds the same equality of its own
    assert [r.t_total for r in jres.per_cluster[0]] == \
        [r.t_total for r in jsolo.records]
    assert _fleet_out(tres) == _fleet_out(jres)
    if compress:
        assert max(_rel(a, b) for a, b in zip(
            _rewards_quality(jres.records),
            _rewards_quality(tres.records))) <= COMPRESSED_RTOL
    else:
        assert [_fields(r) for r in tres.records] == \
            [_fields(r) for r in jres.records]


def _bench(P, router, autoscale, compress):
    cfg, reqs, qt = _stream(P, BENCH_STREAM)
    fleet = P.fleet.FleetConfig(clusters=_bench_clusters(P), router=router)
    eng = _fleet_engine(
        P, fleet, cfg, qt, [P.work.CyclePolicy() for _ in range(3)],
        rt_cfg=P.rt.RuntimeConfig(compress_handoff=compress),
        autoscale=P.fleet.AutoscaleConfig() if autoscale else None,
        region_of=region_of)
    return eng.run(reqs)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("autoscale", [False, True])
@pytest.mark.parametrize("router", ["least_loaded", "locality", "weighted"])
def test_bench_fleet_scenario(router, autoscale, compress):
    """bench_fleet's 200 requests (seed 23, μ = 1.0) over its three
    clusters under Cycle: uncompressed everything bit for bit, compressed
    within ``COMPRESSED_RTOL``."""
    jres, tres = (_bench(P, router, autoscale, compress)
                  for P in (FREF, FPORT))
    assert len(tres.records) == BENCH_STREAM["n_requests"]
    assert _fleet_out(tres) == _fleet_out(jres)
    assert len(set(tres.assignments.values())) == 3
    scaled = [t.autoscale.as_dict()["ticks"] for t in tres.telemetry]
    assert all(scaled) if autoscale else not any(scaled)
    if compress:
        worst = max(_rel(a, b) for a, b in zip(
            _rewards_quality(jres.records), _rewards_quality(tres.records)))
        assert worst <= COMPRESSED_RTOL, worst
        assert abs(tres.cumulative_reward() - jres.cumulative_reward()) <= \
            COMPRESSED_RTOL * len(tres.records)
    else:
        assert [_fields(r) for r in tres.records] == \
            [_fields(r) for r in jres.records]
        assert [[_fields(r) for r in c] for c in tres.per_cluster] == \
            [[_fields(r) for r in c] for c in jres.per_cluster]
        assert tres.cumulative_reward() == jres.cumulative_reward()
        assert type(tres.cumulative_reward()) is float


def _counting(P):
    """A ``FederatedRisePolicy`` that picks as ``CyclePolicy`` does and
    keeps, for each decision, the pulls its state holds then: a decision
    taken before a gossip sees fewer than one taken after it."""

    class CountingCycle(P.fleet.FederatedRisePolicy):
        def __init__(self, seed):
            super().__init__(seed=seed, **P.dev)
            self.i, self.seen = 0, []

        def select(self, ctx, avail):
            self.seen.append(float(np.asarray(self.state.counts).sum()))
            self.i += 1
            return (self.i - 1) % len(avail)

    return CountingCycle


def _tied(P, router, gossip):
    """bench_fleet's stream cut to 80 requests, each odd request moved to
    its predecessor's arrival and the first request at or after the first
    gossip tick moved onto it: an arrival tied with a queued ARRIVE, and
    a gossip tick tied with an arrival."""
    cfg, reqs, qt = _stream(P, dict(BENCH_STREAM, n_requests=80))
    for i in range(1, len(reqs), 2):
        reqs[i].arrival = reqs[i - 1].arrival
    tick = reqs[0].arrival + gossip
    j = next(i for i, r in enumerate(reqs) if r.arrival >= tick)
    reqs[j].arrival = tick
    pols = [_counting(P)(seed=13 * k) for k in range(3)]
    fleet = P.fleet.FleetConfig(clusters=_bench_clusters(P), router=router,
                                gossip_period_s=gossip)
    res = _fleet_engine(P, fleet, cfg, qt, pols,
                        rt_cfg=P.rt.RuntimeConfig(compress_handoff=False),
                        region_of=region_of).run(reqs)
    return res, [p.seen for p in pols]


@pytest.mark.parametrize("router", ["least_loaded", "weighted"])
def test_exact_time_ties_break_as_the_reference(router):
    """Ties the reference calls measure-zero, made on purpose: an arrival
    routes before an event at its own time (so it does not see a tied
    arrival still queued), and a gossip tick runs before both; both
    packages break them alike."""
    (jres, jseen), (tres, tseen) = (_tied(P, router, 15.0)
                                    for P in (FREF, FPORT))
    assert _fleet_out(tres) == _fleet_out(jres)
    assert [_fields(r) for r in tres.records] == \
        [_fields(r) for r in jres.records]
    assert tseen == jseen and tres.n_gossips == jres.n_gossips > 1


def test_fleet_device_follows_the_caller():
    """The clusters' transports run where the caller says: the CPU here,
    the card by default, which this machine has not, so the default
    raises instead of falling back."""
    cfg, reqs, qt = _stream(FPORT, dict(n_requests=6, seed=2))
    C = FPORT.fleet.ClusterSpec
    fleet = FPORT.fleet.FleetConfig(clusters=(C("a"), C("b")))
    eng = _fleet_engine(FPORT, fleet, cfg, qt,
                        [FPORT.work.CyclePolicy() for _ in range(2)])
    assert [rt.transport.device.type for rt in eng.runtimes] == ["cpu"] * 2
    assert len(eng.run(reqs).records) == 6
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            FPORT.fleet.FleetEngine(fleet, cfg, qt,
                                    [FPORT.work.CyclePolicy()] * 2)


# ---------------------------------------------------------------------------
# federated RISE by replay
# ---------------------------------------------------------------------------


class FedReplay(ReplayPolicy):
    """A ``ReplayPolicy`` over a port ``FederatedRisePolicy`` that the
    federation can drive: ``state`` reads and writes the inner policy's,
    ``take_delta`` is the inner policy's."""

    @property
    def state(self):
        return self.inner.state

    @state.setter
    def state(self, value):
        self.inner.state = value

    def take_delta(self):
        return self.inner.take_delta()


def _recorded(policy) -> list:
    """Keeps ``policy``'s picks in decision order."""
    picks, select = [], policy.select

    def select_and_keep(ctx, avail):
        picks.append(select(ctx, avail))
        return picks[-1]

    policy.select = select_and_keep
    return picks


def _fed_run(P, pols, router, autoscale, compress):
    cfg, reqs, qt = _stream(P, BENCH_STREAM)
    fleet = P.fleet.FleetConfig(clusters=_bench_clusters(P), router=router,
                                gossip_period_s=GOSSIP_PERIOD_S)
    eng = _fleet_engine(
        P, fleet, cfg, qt, pols,
        rt_cfg=P.rt.RuntimeConfig(compress_handoff=compress),
        autoscale=P.fleet.AutoscaleConfig() if autoscale else None,
        region_of=region_of)
    return eng, eng.run(reqs)


def _within_ulps(port_state, ref_state, compress) -> None:
    """Counts exact, ``A`` off its diagonal exact, its diagonal within
    ``FED_ULPS``; ``b`` exact uncompressed, within ``FED_ULPS``
    compressed."""
    np.testing.assert_array_equal(port_state.counts.numpy(),
                                  np.asarray(ref_state.counts))
    dA = _ulps(port_state.A.numpy(), ref_state.A)
    assert not dA[:, ~np.eye(dA.shape[1], dtype=bool)].any()
    assert dA.max() <= FED_ULPS, dA.max()
    db = _ulps(port_state.b.numpy(), ref_state.b)
    assert db.max() <= (FED_ULPS if compress else 0), db.max()


@pytest.mark.parametrize("router,autoscale,compress", [
    ("least_loaded", False, False),
    ("locality", True, True),
])
def test_federated_fleet_by_replay(router, autoscale, compress):
    """bench_fleet's federated fleet: three ``FederatedRisePolicy`` (seeds
    0, 13, 26), gossip every 30 s.  The reference serves the stream; each
    cluster's picks, in decision order, are replayed through the port's
    fleet into port policies."""
    jpols = [FREF.fleet.FederatedRisePolicy(seed=13 * k) for k in range(3)]
    picks = [_recorded(p) for p in jpols]
    jeng, jres = _fed_run(FREF, jpols, router, autoscale, compress)
    replays = [FedReplay(picks[k], FPORT.fleet.FederatedRisePolicy(
        seed=13 * k, device="cpu")) for k in range(3)]
    teng, tres = _fed_run(FPORT, replays, router, autoscale, compress)
    assert [r.i for r in replays] == [len(p) for p in picks]
    assert sum(r.forced for r in replays) >= 11
    assert tres.n_gossips == jres.n_gossips > 1
    assert _fleet_out(tres) == _fleet_out(jres)
    if compress:
        worst = max(_rel(a, b) for a, b in zip(
            _rewards_quality(jres.records), _rewards_quality(tres.records)))
        assert worst <= COMPRESSED_RTOL, worst
    else:
        assert [_fields(r) for r in tres.records] == \
            [_fields(r) for r in jres.records]
    _within_ulps(teng.federation.base, jeng.federation.base, compress)
    for tp, jp in zip(replays, jpols):
        _within_ulps(tp.inner.state, jp.state, compress)
        _within_ulps(tp.inner.delta, jp.delta, compress)
    assert float(jeng.federation.base.counts.sum()) < len(jres.records)
