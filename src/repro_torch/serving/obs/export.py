"""Trace exporters: Chrome trace-event JSON (Perfetto-loadable) and JSONL (a
copy of ``repro/serving/obs/export.py``: the same spans give the same JSON).

Chrome trace layout (https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU):

* one *process* (pid) per replica pool, named after the pool, plus a
  ``wire`` process for inter-segment latent transfers and a ``queue``
  thread (tid 999) per pool for aggregator wait spans;
* every span is a complete event (``ph: "X"``) with microsecond ``ts`` /
  ``dur`` on the simulated clock;
* each request is a *flow* (``ph: "s"/"t"/"f"``, ``id`` = request id)
  threading its segment and hop spans across pools — Perfetto draws the
  relay arrows edge → wire → device;
* zero-length reissue markers become instant events (``ph: "i"``).

DAG programs add a ``relay`` control process and split the request into
*per-branch flow tracks*: the trunk keeps the integer request id, each
named branch gets its own flow (``id`` = ``"<rid>/<branch>"``) that starts
at the branch's first span and terminates on the merge/select join span —
so Perfetto draws the fan-out and the join arrows separately per branch.
Branch-point markers become instant events (``ph: "i"``, cat ``branch``)
and join-resolution spans become ``X`` events (cat ``join``) carrying the
select outcome (winner, accepted, deviation vs bound) in ``args``.

:func:`validate_chrome_trace` is the schema gate CI runs on emitted
traces: required keys, non-negative durations, events sorted by ``ts``,
every flow id resolving (one ``s``, one terminating ``f``, ``f`` not
before ``s``), instant events carrying a scope, join events carrying
their outcome, and every branch flow anchored to a trunk flow.

Also home to :func:`export_runtime_telemetry`: the benchmark/dashboard-
facing summary of a runtime telemetry object.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.serving.obs.tracer import (BRANCH, HOP, JOIN, QUEUE, REISSUE,
                                      SEGMENT, SpanTracer)

_QUEUE_TID = 999  # per-pool aggregator-wait track
_US = 1e6  # simulated seconds → trace microseconds


def _pids(tracer: SpanTracer) -> Dict[str, int]:
    """Stable pool → pid mapping (sorted pools, then the wire process,
    then — only when DAG spans exist — the relay control process)."""
    pools = sorted({
        s.pool for s in tracer.spans() if s.pool is not None
    })
    pids = {p: i + 1 for i, p in enumerate(pools)}
    pids["wire"] = len(pools) + 1
    if any(s.kind in (BRANCH, JOIN) for s in tracer.spans()):
        pids["relay"] = len(pools) + 2
    return pids


def to_chrome_trace(tracer: SpanTracer,
                    meta: Optional[dict] = None) -> dict:
    """Convert a finished tracer into a Chrome trace-event JSON object."""
    pids = _pids(tracer)
    events: List[dict] = []
    for pool, pid in pids.items():
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "ts": 0,
                       "args": {"name": pool if pool != "wire"
                                else "wire (latent handoffs)"}})
    for tr in tracer.requests.values():
        # (pid, tid, ts) flow anchors: the trunk keeps the legacy integer
        # request id; each DAG branch threads its own "<rid>/<branch>" flow
        tracks: Dict[object, List[dict]] = {tr.rid: []}
        closed: set = set()
        for s in tr.spans:
            if s.kind == SEGMENT:
                pid = pids[s.pool]
                tid = int(s.meta.get("replica") or 0)
            elif s.kind == HOP:
                pid, tid = pids["wire"], 0
            elif s.kind == QUEUE:
                pid = pids[s.pool] if s.pool is not None else 0
                tid = _QUEUE_TID
            elif s.kind == JOIN:
                pid, tid = pids["relay"], 0
            elif s.kind == BRANCH:
                events.append({
                    "ph": "i", "name": s.name, "cat": "branch",
                    "pid": pids["relay"], "tid": 0, "ts": s.t0 * _US,
                    "s": "p", "args": {"rid": s.rid, **s.meta},
                })
                continue
            else:  # REISSUE marker
                pid = pids.get(s.pool, 0) if s.pool else 0
                events.append({
                    "ph": "i", "name": "reissue", "cat": "fault",
                    "pid": pid, "tid": 0, "ts": s.t0 * _US, "s": "g",
                    "args": {"rid": s.rid, **s.meta},
                })
                continue
            ts = s.t0 * _US
            events.append({
                "ph": "X", "name": s.name, "cat": s.kind,
                "pid": pid, "tid": tid, "ts": ts,
                "dur": max(s.dur, 0.0) * _US,
                "args": {"rid": s.rid, "arm": tr.arm_idx, **s.meta},
            })
            if s.kind == QUEUE:
                continue
            anchor = {"pid": pid, "tid": tid, "ts": ts}
            if s.kind == JOIN:
                # the join resolves the fan-out: terminate every branch
                # flow still open on the join anchor, and thread the trunk.
                # Anchor at the *resolution* instant t1 — the winner's
                # arrival t0 can precede a slow losing branch's dispatch,
                # but resolution bounds every branch span from above.
                anchor = {"pid": pid, "tid": tid, "ts": s.t1 * _US}
                for key, anchors in tracks.items():
                    if key == tr.rid or key in closed or not anchors:
                        continue
                    anchors.append(anchor)
                    closed.add(key)
                tracks[tr.rid].append(anchor)
                continue
            branch = s.meta.get("branch")
            key = tr.rid if branch is None else f"{tr.rid}/{branch}"
            if key in closed:
                continue  # late span of a resolved-away branch: drawn, unthreaded
            tracks.setdefault(key, []).append(anchor)
        # requests as flows: arrows threading each track's anchors
        for key in sorted(tracks, key=str):
            flow = tracks[key]
            if len(flow) < 2:
                continue  # single-span track: no arrow to draw
            for i, anchor in enumerate(flow):
                ph = "s" if i == 0 else ("f" if i == len(flow) - 1 else "t")
                ev = {"ph": ph, "name": "request", "cat": "relay",
                      "id": key, **anchor}
                if ph == "f":
                    ev["bp"] = "e"  # bind to the enclosing slice
                events.append(ev)
    events.sort(key=lambda e: (e["ts"], e.get("ph") != "M"))
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if meta:
        trace["otherData"] = meta
    return trace


def write_chrome_trace(tracer: SpanTracer, path: str,
                       meta: Optional[dict] = None) -> dict:
    """Serialize :func:`to_chrome_trace` to ``path`` (open the file at
    chrome://tracing or https://ui.perfetto.dev); returns the trace dict."""
    trace = to_chrome_trace(tracer, meta)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def write_spans_jsonl(tracer: SpanTracer, path: str) -> int:
    """One JSON object per span (plus a request envelope line each), for
    programmatic analysis; returns the number of lines written."""
    n = 0
    with open(path, "w") as f:
        for tr in sorted(tracer.requests.values(), key=lambda t: t.rid):
            f.write(json.dumps({
                "type": "request", "rid": tr.rid, "arm": tr.arm_idx,
                "arm_label": tr.arm_label, "arrival": tr.arrival,
                "done": tr.done,
            }) + "\n")
            n += 1
            for s in tr.spans:
                f.write(json.dumps({"type": "span", **s.as_dict()}) + "\n")
                n += 1
    return n


# ---------------------------------------------------------------------------
# schema validation (the CI gate on emitted traces)
# ---------------------------------------------------------------------------

_REQUIRED = {"ph", "name", "pid", "tid", "ts"}


def validate_chrome_trace(trace: dict) -> List[str]:
    """Validate an emitted Chrome trace object; returns a list of schema
    violations (empty ⇒ valid).  Checked: top-level shape, required keys
    per event, non-negative ``ts``/``dur``, events sorted by ``ts``, flow
    resolution (every flow id — integer trunk or ``"rid/branch"`` — has
    exactly one ``s`` and one ``f``, with the finish not before the
    start), instant events carrying a scope, join events carrying their
    resolution outcome, and every branch flow anchored to a trunk flow of
    the same request."""
    errors: List[str] = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["top-level object must carry a traceEvents list"]
    events = trace["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["traceEvents must be a non-empty list"]
    flows: Dict[object, Dict[str, list]] = {}
    last_ts = None
    for i, ev in enumerate(events):
        missing = _REQUIRED - set(ev)
        if missing:
            errors.append(f"event {i} missing keys {sorted(missing)}")
            continue
        ts = ev["ts"]
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i} has invalid ts {ts!r}")
            continue
        if last_ts is not None and ts < last_ts:
            errors.append(f"event {i} unsorted: ts {ts} < previous {last_ts}")
        last_ts = ts
        if ev["ph"] == "X":
            if "dur" not in ev or ev["dur"] < 0:
                errors.append(f"event {i} ('X') needs a non-negative dur")
            if ev.get("cat") == "join" and "winner" not in ev.get("args", {}):
                errors.append(f"event {i} (join) needs args.winner")
        elif ev["ph"] == "i":
            if "s" not in ev:
                errors.append(f"event {i} ('i') needs an instant scope 's'")
        elif ev["ph"] in ("s", "t", "f"):
            if "id" not in ev:
                errors.append(f"event {i} flow phase {ev['ph']!r} needs id")
            else:
                flows.setdefault(ev["id"], {"s": [], "t": [], "f": []})[
                    ev["ph"]].append(ts)
    for fid, phases in sorted(flows.items(), key=lambda kv: str(kv[0])):
        if len(phases["s"]) != 1:
            errors.append(f"flow {fid}: {len(phases['s'])} starts (need 1)")
        if len(phases["f"]) != 1:
            errors.append(f"flow {fid}: {len(phases['f'])} finishes (need 1)")
        if phases["s"] and phases["f"] and phases["f"][0] < phases["s"][0]:
            errors.append(f"flow {fid}: finish before start")
        if isinstance(fid, str) and "/" in fid:
            trunk = fid.split("/", 1)[0]
            if not any(str(other) == trunk for other in flows):
                errors.append(f"branch flow {fid}: no trunk flow {trunk}")
    return errors


# ---------------------------------------------------------------------------
# runtime telemetry export
# ---------------------------------------------------------------------------


def export_runtime_telemetry(telemetry) -> Dict[str, dict]:
    """Per-pool runtime telemetry export (queue depth, batch occupancy,
    bytes transferred) from a ``repro_torch.serving.runtime`` telemetry
    object — the benchmark/dashboard-facing view of the continuous-batching
    engine."""
    if telemetry is None:
        return {}
    return telemetry.summary()


def main(argv=None) -> int:
    """CLI validator: ``python -m repro_torch.serving.obs.export trace.json``
    exits non-zero (listing violations) on a schema-invalid trace."""
    import argparse

    ap = argparse.ArgumentParser(description="validate a Chrome trace JSON")
    ap.add_argument("trace", help="path to a trace-event JSON file")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        trace = json.load(f)
    errors = validate_chrome_trace(trace)
    if errors:
        for e in errors:
            print(f"SCHEMA: {e}")
        return 1
    n = len(trace["traceEvents"])
    print(f"ok: {args.trace} ({n} events, schema-valid)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
