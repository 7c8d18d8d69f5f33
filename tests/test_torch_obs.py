"""The port's observability layer (``repro_torch.serving.obs``) against the
JAX package's (``repro.serving.obs``) on the CPU, and the engine-free cases
of ``tests/test_obs.py`` run on the port.

Both tracers are fed the same span sequences (linear relays, an N-hop
cascade with a re-issue marker, a DAG branch/join with an off-path branch,
and seeded random requests).  Exact equality: the spans' ``as_dict`` lists,
``span_structure``, ``legacy_view``, the Chrome trace JSON, the JSONL lines
and ``validate_chrome_trace``'s errors on the same corruptions; the
reservoirs' samples; the scheduler introspection and ``linucb_snapshot``
(fp64 numpy in both).  ``latency_attribution`` and
``attribution_residual`` within 1e-12.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.core import policies as jpol
from repro.serving import obs as jobs
from repro.serving.obs import stats as jstats
from repro.serving.runtime.events import EventQueue as JEventQueue
from repro_torch.core import policies as tpol
from repro_torch.serving import obs
from repro_torch.serving.arms import ARMS
from repro_torch.serving.context import context_dim
from repro_torch.serving.obs import (DepthSeries, EventLoopProfiler,
                                     ReservoirSample, SchedulerIntrospection,
                                     SpanTracer, StreamingQuantiles,
                                     attribution_residual,
                                     latency_attribution, linucb_snapshot,
                                     scheduler_report, span_structure,
                                     to_chrome_trace, validate_chrome_trace,
                                     write_chrome_trace, write_spans_jsonl)
from repro_torch.serving.obs.stats import attribution_by_kind
from repro_torch.serving.runtime.events import EventQueue
from repro_torch.training.checkpoint import linucb_state_from_jax

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# span sequences fed to both tracers
# ---------------------------------------------------------------------------


def _linear(tr, rid=0, t=1.0):
    """The reference's manual lifecycle: a 2-hop relay."""
    tr.start_request(rid, t, 3, "XL@10")
    tr.enqueue(rid, "edge", t)
    tr.start_segment(rid, "edge", t + 1.0, "sdxl", replica=1, batch=7)
    tr.end_segment(rid, t + 4.0)
    tr.hop(rid, 0, t + 4.0, t + 4.5, 1000, compressed=True, pool="sdxl")
    tr.enqueue(rid, "device", t + 4.5)
    tr.start_segment(rid, "device", t + 5.0, "vega")
    tr.end_segment(rid, t + 7.0)
    tr.end_request(rid, t + 7.0)


def _cascade(tr, rid=1):
    """An N-hop cascade with a straggler re-issue marker and a segment
    whose optional meta is None (filtered out)."""
    tr.start_request(rid, 2.0, 9, "sd35L+M+S")
    t = 2.0
    for k, (seg, pool) in enumerate((("edge", "sd3l"), ("mid1", "sd3m"),
                                     ("device", "vega"))):
        tr.enqueue(rid, seg, t)
        tr.start_segment(rid, seg, t + 0.25, pool, replica=k % 2,
                         batch=None, bucket=4)
        if seg == "mid1":
            tr.reissue(rid, t + 0.5, partial=True)
        tr.end_segment(rid, t + 2.0, slow=1.5)
        t += 2.0
        if seg != "device":
            tr.hop(rid, k, t, t + 0.125, 512, compressed=k == 0, pool=pool)
            t += 0.125
    tr.end_request(rid, t)


def _dag(tr, rid=2):
    """The reference's DAG case: a Select whose ref branch loses, with a
    late span of the resolved-away branch."""
    tr.start_request(rid, 0.0, 11, "sdxl+vega@s=20|spec=10")
    tr.enqueue(rid, "edge", 0.0)
    tr.start_segment(rid, "edge", 0.0, "sdxl")
    tr.end_segment(rid, 4.0, name="edge")
    tr.branch_point(rid, "edge", 4.0, ("spec", "ref"))
    tr.hop(rid, ":edge->device~spec", 4.0, 4.5, 500, True, pool="sdxl",
           branch="spec")
    tr.enqueue(rid, "edge+", 4.0, branch="ref")
    tr.start_segment(rid, "edge+", 4.0, "sdxl")
    tr.enqueue(rid, "device~spec", 4.5, branch="spec")
    tr.start_segment(rid, "device~spec", 4.5, "vega")
    tr.end_segment(rid, 7.0, name="device~spec")
    tr.hop(rid, ":device~spec->select", 7.0, 7.0, 0, False, branch="spec")
    tr.end_segment(rid, 8.0, name="edge+")
    tr.mark_offpath(rid, "ref")
    tr.join(rid, "select", 7.0, 8.0, winner="device~spec", accepted=True,
            deviation_pct=1.5, bound_pct=2.0, ignored=None)
    tr.end_request(rid, 8.0)
    tr.hop(rid, ":edge+->device", 8.0, 8.5, 500, True, pool="sdxl",
           branch="ref")


def _merge(tr, rid=3):
    """An ensemble: two branches into a Merge, the slower one critical,
    the other marked off the path; and a request left open."""
    tr.start_request(rid, 1.0, 14, "sdxl+vega@s=10&mid")
    tr.enqueue(rid, "edge", 1.0)
    tr.start_segment(rid, "edge", 1.5, "sdxl")
    tr.end_segment(rid, 3.0, name="edge")
    tr.branch_point(rid, "edge", 3.0, ("a", "b"))
    for br, pool, dur in (("a", "vega", 2.0), ("b", "ssd1b", 3.0)):
        tr.hop(rid, f":edge->{br}", 3.0, 3.25, 256, True, pool="sdxl",
               branch=br)
        tr.enqueue(rid, br, 3.25, branch=br)
        tr.start_segment(rid, br, 3.5, pool)
        tr.end_segment(rid, 3.5 + dur, name=br)
    tr.mark_offpath(rid, "a")
    tr.join(rid, "merge", 6.5, 7.0, winner="b")
    tr.end_request(rid, 7.0)
    tr.start_request(rid + 1, 7.5, 0, "vega")
    tr.enqueue(rid + 1, "device", 7.5)


def _random(tr, seed, n=12):
    """Seeded random linear requests with jittered queue, service and hop
    times; some straggle."""
    rng = np.random.default_rng(seed)
    for rid in range(100, 100 + n):
        t = float(rng.exponential(2.0))
        tr.start_request(rid, t, int(rng.integers(11)), f"arm{rid % 5}")
        n_seg = int(rng.integers(1, 4))
        for k in range(n_seg):
            name = "device" if k == n_seg - 1 else ("edge" if k == 0
                                                    else f"mid{k}")
            pool = ("vega", "sdxl", "sd3l", "sd3m")[int(rng.integers(4))]
            tr.enqueue(rid, name, t)
            t += float(rng.exponential(0.3))
            tr.start_segment(rid, name, t, pool,
                             replica=int(rng.integers(2)),
                             batch=int(rng.integers(50)))
            if rng.uniform() < 0.2:
                tr.reissue(rid, t + 0.1, partial=bool(rng.integers(2)))
            t += float(rng.exponential(1.5))
            tr.end_segment(rid, t)
            if k < n_seg - 1:
                dt = float(rng.exponential(0.2))
                tr.hop(rid, k, t, t + dt, int(rng.integers(1, 4096)),
                       compressed=bool(rng.integers(2)), pool=pool)
                t += dt
        tr.end_request(rid, t)


SEQUENCES = {
    "linear": lambda tr: _linear(tr),
    "cascade": lambda tr: _cascade(tr),
    "dag": lambda tr: _dag(tr),
    "merge": lambda tr: _merge(tr),
    "random": lambda tr: _random(tr, 0),
    "all": lambda tr: [f(tr) for f in (_linear, _cascade, _dag, _merge)]
    + [_random(tr, 1)],
}


def _pair(name):
    """The same span sequence fed to the port's and the reference's
    tracer."""
    port, ref = SpanTracer(), jobs.SpanTracer()
    SEQUENCES[name](port)
    SEQUENCES[name](ref)
    return port, ref


# ---------------------------------------------------------------------------
# the engine-free cases of tests/test_obs.py, on the port
# ---------------------------------------------------------------------------


def test_tracer_manual_lifecycle():
    tr = SpanTracer()
    _linear(tr)
    t = tr.requests[0]
    assert t.complete and t.t_total == 7.0
    assert t.attributed_s() == pytest.approx(7.0)
    assert tr.coverage() == 1.0
    assert span_structure(tr, 0) == [
        ("segment", "edge"), ("hop", "hop0"), ("segment", "device")]
    legacy = tr.legacy_view()[0]
    assert legacy["edge_start"] == 2.0 and legacy["edge_done"] == 5.0
    assert legacy["device_enqueue"] == 5.5  # post-hop queue only
    assert "edge_enqueue" not in legacy
    assert legacy["transfer_s"] == pytest.approx(0.5)
    assert legacy["transfer_bytes"] == 1000
    assert legacy["done"] == 8.0


def test_tracer_dag_branch_join_offpath():
    tr = SpanTracer()
    _dag(tr)
    t = tr.requests[2]
    segs = {s.name: s for s in t.spans if s.kind == "segment"}
    assert segs["edge+"].meta["branch"] == "ref"
    assert segs["edge+"].meta.get("offpath") is True
    assert segs["device~spec"].meta["branch"] == "spec"
    assert "offpath" not in segs["device~spec"].meta
    # sticky: the late span of the resolved-away branch is flagged
    assert t.spans[-1].meta["offpath"] is True
    j = next(s for s in t.spans if s.kind == "join")
    assert j.meta == {"winner": "device~spec", "accepted": True,
                      "deviation_pct": 1.5, "bound_pct": 2.0}
    assert t.attributed_s() == pytest.approx(t.t_total)
    assert all(k in ("segment", "hop") for k, _ in span_structure(tr, 2))


def test_reservoir_quantiles_bounded_and_accurate():
    rng = np.random.default_rng(0)
    xs = rng.exponential(2.0, size=50_000)
    q = StreamingQuantiles(capacity=1024, seed=1)
    for x in xs:
        q.add(x)
    s = q.summary()
    assert s["count"] == xs.size
    assert s["mean"] == pytest.approx(float(xs.mean()))
    assert s["max"] == pytest.approx(float(xs.max()))
    assert s["p50"] == pytest.approx(float(np.quantile(xs, 0.5)), rel=0.15)
    assert s["p95"] == pytest.approx(float(np.quantile(xs, 0.95)), rel=0.15)
    assert q.reservoir.nbytes == 1024 * 8
    q2 = StreamingQuantiles(capacity=1024, seed=1)
    for x in xs:
        q2.add(x)
    assert np.array_equal(q.reservoir.values(), q2.reservoir.values())
    # the reference's reservoir, fed the same stream, keeps the same samples
    ref = jstats.StreamingQuantiles(capacity=1024, seed=1)
    for x in xs:
        ref.add(x)
    assert np.array_equal(q.reservoir.values(), ref.reservoir.values())
    assert q.summary() == ref.summary()


def test_reservoir_private_rng_does_not_touch_global_streams():
    rng_before = np.random.default_rng(123).integers(0, 1 << 30, 4).tolist()
    np_state = np.random.get_state()
    torch_state = torch.random.get_rng_state()
    r = ReservoirSample(capacity=8, seed=0)
    for i in range(1000):
        r.add(float(i))
    assert np.random.default_rng(123).integers(
        0, 1 << 30, 4).tolist() == rng_before
    after = np.random.get_state()
    assert after[0] == np_state[0] and np.array_equal(after[1], np_state[1])
    assert after[2:] == np_state[2:]
    assert torch.equal(torch.random.get_rng_state(), torch_state)


@pytest.mark.parametrize("capacity", [1, 8, 1024])
def test_reservoir_samples_equal_reference(capacity):
    xs = np.random.default_rng(capacity).normal(size=3000)
    port = ReservoirSample(capacity=capacity, seed=7)
    ref = jstats.ReservoirSample(capacity=capacity, seed=7)
    for x in xs:
        port.add(float(x))
        ref.add(float(x))
    assert np.array_equal(port.values(), ref.values())
    assert port.quantile(0.9) == ref.quantile(0.9)


def test_depth_series_exact_moments():
    d = DepthSeries(capacity=16)
    for t, depth in enumerate([0, 1, 3, 2, 7, 1]):
        d.add(float(t), depth)
    assert d.n == 6
    assert d.mean == pytest.approx(14 / 6)
    assert d.max == 7


def test_pool_stats_depth_is_bounded():
    from repro_torch.serving.runtime.telemetry import (PoolStats,
                                                       RuntimeTelemetry)

    assert not hasattr(PoolStats(), "depth_samples")
    tel = RuntimeTelemetry()
    for i in range(10_000):
        tel.record_depth("vega", float(i), i % 13)
    p = tel.pools["vega"]
    assert p.depth.n == 10_000
    assert p.depth._q.reservoir.nbytes <= 1024 * 8
    s = tel.summary()["vega"]
    assert s["mean_queue_depth"] == pytest.approx(
        np.mean([i % 13 for i in range(10_000)]))
    assert s["max_queue_depth"] == 12
    assert 0 <= s["p95_queue_depth"] <= 12


def test_scheduler_introspection_regret():
    intro = SchedulerIntrospection(3)
    for arm, r in [(0, 1.0), (1, 0.5), (0, 1.0), (2, 0.0), (1, 0.5)]:
        intro.record(arm, r)
    assert intro.best_arm == 0
    assert intro.cumulative_regret() == pytest.approx(
        (1.0 - 1.0) * 2 + (1.0 - 0.5) * 2 + (1.0 - 0.0))
    curve = intro.regret_curve()
    assert curve[-1][1] == pytest.approx(intro.cumulative_regret())
    assert all(b[1] >= a[1] - 1e-12 for a, b in zip(curve, curve[1:]))
    s = intro.summary(labels=["a", "b", "c"])
    assert s["per_arm"][0]["pulls"] == 2
    assert s["per_arm"][2]["label"] == "c"


def test_linucb_snapshot_reads_policy_state():
    d = context_dim(False)
    pol = tpol.RisePolicy(seed=0, ctx_dim=d, device="cpu")
    assert linucb_snapshot(object()) == {}  # non-LinUCB → empty
    rng = np.random.default_rng(0)
    for _ in range(80):
        ctx = rng.uniform(size=d).astype(np.float32)
        arm = pol.select(ctx, np.ones(len(pol.arms), bool))
        pol.update(ctx, arm, float(rng.uniform()))
    snap = linucb_snapshot(pol)
    assert snap["ctx_dim"] == d
    assert sum(snap["pulls"]) == 80
    assert len(snap["confidence_width_at_ctx"]) == snap["n_arms"]
    assert all(w > 0 for w in snap["confidence_width_at_ctx"])
    widths, pulls = snap["confidence_width_at_ctx"], snap["pulls"]
    assert widths[pulls.index(max(pulls))] < widths[pulls.index(min(pulls))]


# ---------------------------------------------------------------------------
# the port against the reference on the same spans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_tracer_views_equal_reference(name):
    port, ref = _pair(name)
    assert [s.as_dict() for s in port.spans()] == \
        [s.as_dict() for s in ref.spans()]
    assert port.legacy_view() == ref.legacy_view()
    assert port.coverage() == ref.coverage() and len(port) == len(ref)
    assert [t.rid for t in port.completed()] == \
        [t.rid for t in ref.completed()]
    for rid in port.requests:
        for kinds in ((obs.SEGMENT, obs.HOP, obs.REISSUE),
                      (obs.SEGMENT, obs.HOP, obs.QUEUE, "join", "branch")):
            assert span_structure(port, rid, kinds) == \
                jobs.span_structure(ref, rid, kinds)
        assert port.requests[rid].attributed_s() == \
            ref.requests[rid].attributed_s()


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_chrome_trace_and_jsonl_equal_reference(name, tmp_path):
    port, ref = _pair(name)
    meta = {"run": name, "seed": 3}
    out = write_chrome_trace(port, str(tmp_path / "port.json"), meta=meta)
    jobs.write_chrome_trace(ref, str(tmp_path / "ref.json"), meta=meta)
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    assert json.dumps(out) == json.dumps(jobs.to_chrome_trace(ref, meta))
    assert validate_chrome_trace(out) == []
    n = write_spans_jsonl(port, str(tmp_path / "port.jsonl"))
    assert n == jobs.write_spans_jsonl(ref, str(tmp_path / "ref.jsonl"))
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "ref.jsonl").read_text()


def test_spans_jsonl_roundtrip(tmp_path):
    port, _ = _pair("all")
    path = tmp_path / "spans.jsonl"
    n_lines = write_spans_jsonl(port, str(path))
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == n_lines
    reqs = [x for x in lines if x["type"] == "request"]
    assert {x["rid"] for x in reqs} == set(port.requests)
    spans = [{k: v for k, v in x.items() if k != "type"}
             for x in lines if x["type"] == "span"]
    want = [s.as_dict() for rid in sorted(port.requests)
            for s in port.requests[rid].spans]
    assert spans == want


def _corruptions(trace):
    """The corruptions of the reference's ``test_chrome_validator_catches_*``
    cases (and two more: a missing key, a negative ts), each with a message
    it must raise."""
    out = [({"foo": 1}, "traceEvents"), ({"traceEvents": []}, "non-empty")]

    def copy():
        return json.loads(json.dumps(trace))

    bad = copy()
    next(e for e in bad["traceEvents"] if e["ph"] == "X")["dur"] = -1.0
    out.append((bad, "dur"))
    bad = copy()
    bad["traceEvents"] = bad["traceEvents"][::-1]
    out.append((bad, "unsorted"))
    bad = copy()
    bad["traceEvents"] = [e for e in bad["traceEvents"] if e["ph"] != "f"]
    out.append((bad, "finishes"))
    bad = copy()
    del bad["traceEvents"][-1]["pid"]
    out.append((bad, "missing keys"))
    bad = copy()
    bad["traceEvents"][0]["ts"] = -5
    out.append((bad, "invalid ts"))
    evs = trace["traceEvents"]
    if any(e["ph"] == "i" for e in evs):
        bad = copy()
        del next(e for e in bad["traceEvents"] if e["ph"] == "i")["s"]
        out.append((bad, "instant scope"))
    if any(e.get("cat") == "join" for e in evs):
        bad = copy()
        del next(e for e in bad["traceEvents"]
                 if e.get("cat") == "join")["args"]["winner"]
        out.append((bad, "args.winner"))
    branch = [e["id"] for e in evs
              if e["ph"] == "s" and isinstance(e["id"], str)]
    if branch:
        trunk = branch[0].split("/", 1)[0]
        bad = copy()
        bad["traceEvents"] = [
            e for e in bad["traceEvents"]
            if not (e.get("ph") in ("s", "t", "f") and str(e["id"]) == trunk)]
        out.append((bad, "no trunk flow"))
    return out


@pytest.mark.parametrize("name", ["linear", "cascade", "dag", "all"])
def test_validator_errors_equal_reference(name):
    port, _ = _pair(name)
    trace = to_chrome_trace(port)
    cases = _corruptions(trace)
    if name in ("dag", "all"):
        assert {"instant scope", "args.winner", "no trunk flow"} <= \
            {want for _, want in cases}
    for bad, want in cases:
        errors = validate_chrome_trace(bad)
        assert errors == jobs.validate_chrome_trace(bad)
        assert any(want in msg for msg in errors), (want, errors)


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_attribution_equal_reference(name):
    port, ref = _pair(name)
    att, ref_att = latency_attribution(port), jobs.latency_attribution(ref)
    assert list(att) == list(ref_att)
    for key, d in att.items():
        assert list(d) == list(ref_att[key])
        for k, v in d.items():
            assert v == pytest.approx(ref_att[key][k], abs=1e-12, rel=0)
    assert abs(attribution_residual(port)
               - jobs.attribution_residual(ref)) <= 1e-12
    assert attribution_residual(port) <= 1e-12
    kinds, ref_kinds = attribution_by_kind(port), jstats.attribution_by_kind(ref)
    assert list(kinds) == list(ref_kinds)
    assert all(abs(kinds[k] - ref_kinds[k]) <= 1e-12 for k in kinds)
    if name in ("linear", "cascade", "random"):  # no off-path spans
        shares = sum(v["share"] for k, v in att.items() if k != "_overall")
        assert shares == pytest.approx(1.0, abs=1e-9)


# ---------------------------------------------------------------------------
# scheduler introspection and the LinUCB snapshot against the reference
# ---------------------------------------------------------------------------


def _records(seed, n, n_arms):
    rng = np.random.default_rng(seed)
    return [SimpleNamespace(rid=int(rid), arm=int(rng.integers(n_arms)),
                            reward=float(rng.normal()))
            for rid in rng.permutation(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_introspection_equals_reference(seed):
    recs = _records(seed, 300 + seed, 11)
    port = SchedulerIntrospection.from_records(recs, 11)
    ref = jobs.SchedulerIntrospection.from_records(recs, 11)
    labels = [a.label for a in ARMS]
    assert port.summary(labels) == ref.summary(labels)
    assert port.regret_curve() == ref.regret_curve()
    assert port.regret_curve(7) == ref.regret_curve(7)
    assert port.cumulative_regret() >= 0.0


def _trained_reference(seed, steps=60):
    """The reference's RisePolicy after ``steps`` seeded decisions."""
    pol = jpol.RisePolicy(seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        ctx = rng.uniform(size=8).astype(np.float32)
        arm = pol.select(ctx, rng.uniform(size=len(pol.arms)) < 0.8)
        pol.update(ctx, arm, float(rng.normal()))
    return pol


@pytest.mark.parametrize("seed", [0, 3])
def test_linucb_snapshot_equals_reference(seed):
    ref = _trained_reference(seed)
    ref_state = jax.tree.map(np.asarray, ref.state)
    port = tpol.RisePolicy(seed=seed, device="cpu")
    port.state = linucb_state_from_jax(*ref_state, device="cpu")
    # carried across and cast back to fp32: the reference's bits
    for a, b in zip(port.state, ref_state):
        assert np.array_equal(a.numpy().view(np.int32),
                              np.asarray(b, np.float32).view(np.int32))
    ctx = np.random.default_rng(seed + 10).uniform(size=8)
    for c in (None, ctx):
        assert linucb_snapshot(port, c) == jobs.linucb_snapshot(ref, c)
    recs = _records(seed, 60, len(port.arms))
    out = scheduler_report(port, recs, port.arms)
    assert out == jobs.scheduler_report(ref, recs, ref.arms)
    json.dumps(out)
    assert scheduler_report(tpol.RoundRobinPolicy(), recs, port.arms) == \
        jobs.scheduler_report(jpol.RoundRobinPolicy(), recs, ref.arms)


# ---------------------------------------------------------------------------
# the event-loop profiler, the exporter's CLI
# ---------------------------------------------------------------------------


def test_profiler_counts_equal_reference():
    profs = {"port": EventLoopProfiler(), "ref": jobs.EventLoopProfiler()}
    queues = {"port": EventQueue(), "ref": JEventQueue()}
    rng = np.random.default_rng(4)
    kinds = ("arrive", "batch_done", "flush", "device_ready")
    script = [(kinds[int(rng.integers(4))], float(rng.exponential(1e-4)),
               rng.uniform() < 0.1) for _ in range(500)]
    for key, prof in profs.items():
        evq = queues[key]
        prof.start()
        for i, (kind, _, _) in enumerate(script):
            evq.push(float(i % 37), kind)
        while evq:
            _, kind, _ = evq.pop()
        for kind, wall, stale in script:
            if stale:
                prof.record_stale(kind)
            else:
                prof.record(kind, wall)
        prof.stop(evq)
    rep, ref = profs["port"].report(), profs["ref"].report()
    assert rep["events"] == ref["events"] == sum(not s for *_, s in script)
    assert rep["stale_events"] == ref["stale_events"]
    assert rep["heap_ops"] == ref["heap_ops"] == {
        "pushes": 500, "pops": 500, "peak_size": 500}
    assert {k: v["count"] for k, v in rep["per_event_type"].items()} == \
        {k: v["count"] for k, v in ref["per_event_type"].items()}
    for k, v in rep["per_event_type"].items():
        assert v["wall_s"] == ref["per_event_type"][k]["wall_s"]
    assert sum(v["share"] for v in rep["per_event_type"].values()) == \
        pytest.approx(1.0)
    assert rep["loop_wall_s"] > 0 and rep["events_per_s"] > 0
    assert EventLoopProfiler().report()["loop_wall_s"] == 0.0


def test_export_cli_validates_written_trace(tmp_path):
    port, _ = _pair("all")
    good = tmp_path / "trace.json"
    trace = write_chrome_trace(port, str(good))
    bad = tmp_path / "bad.json"
    trace["traceEvents"] = trace["traceEvents"][::-1]
    bad.write_text(json.dumps(trace))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    runs = {p: subprocess.run([sys.executable, "-m",
                               "repro_torch.serving.obs.export", str(p)],
                              env=env, capture_output=True, text=True,
                              timeout=60) for p in (good, bad)}
    assert runs[good].returncode == 0, runs[good].stderr
    assert runs[good].stdout.startswith(f"ok: {good}")
    assert runs[bad].returncode == 1
    assert "SCHEMA:" in runs[bad].stdout and "unsorted" in runs[bad].stdout
    assert obs.export_runtime_telemetry(None) == {}
