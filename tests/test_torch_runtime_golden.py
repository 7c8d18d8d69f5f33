"""The port's continuous runtime against the golden captures of
``tests/golden/``, bit for bit (``repro_torch/serving/runtime/engine.py``;
the reference's own lock is ``tests/test_golden_bitidentity.py``).

* ``runtime_records.json``: 4 fault regimes × 2 straggler modes of 120
  requests under Cycle — per-request arms, the exact bit patterns of
  ``t_total`` and ``wait_s`` (``float.hex``), the fault counters and each
  request's span structure.
* ``profile_workload_{quick,heavy,scale}.sha256``: the SHA-256 of the
  record stream (arm, ``t_total`` hex, ``wait_s`` hex per request) on the
  event-loop profile's workload of 300, 2,000 and 100,000 requests —
  μ = 1.5 s, stragglers, an sdxl outage — with the profiler attached, as
  ``benchmarks/profile_event_loop.py`` hashes it.  The digest and the
  workload are copied here, not imported from the benchmark.

The runtime is host numpy on the simulated clock, so no device enters
these records: they hold on the CPU and on the card alike.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import pytest

from repro_torch.serving.engine import ServingEngine, SimConfig, make_requests
from repro_torch.serving.obs.profiler import EventLoopProfiler
from repro_torch.serving.obs.tracer import span_structure
from repro_torch.serving.runtime import RuntimeConfig
from repro_torch.serving.runtime.engine import ARRIVAL_WINDOW
from repro_torch.serving.workload import CyclePolicy, synthetic_quality_table

GOLDEN_DIR = Path(__file__).parent / "golden"

REGIMES = {
    "clean": {},
    "stragglers": dict(straggler_prob=0.3, straggler_factor=8.0),
    "replica_failure": dict(fail_replica=("sdxl", 0, 50.0, 400.0)),
    "degraded": dict(straggler_prob=0.25, straggler_factor=6.0,
                     fail_replica=("sd3l", 1, 30.0, 300.0)),
}


@pytest.mark.parametrize("mode", ["item", "batch"])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_records_equal_golden_capture(regime, mode):
    golden = json.loads(
        (GOLDEN_DIR / "runtime_records.json").read_text())[f"{regime}/{mode}"]
    cfg = SimConfig(n_requests=120, mean_interarrival=1.5, seed=11,
                    straggler_mode=mode, **REGIMES[regime])
    reqs = make_requests(cfg)
    qt = synthetic_quality_table(reqs)
    eng = ServingEngine(CyclePolicy(), qt, cfg, runtime="continuous",
                        device="cpu")
    recs = sorted(eng.run(reqs), key=lambda r: r.rid)
    assert len(recs) == cfg.n_requests
    assert [r.arm for r in recs] == golden["arms"]
    assert [float(r.t_total).hex() for r in recs] == golden["t_total_hex"]
    assert [float(r.wait_s).hex() for r in recs] == golden["wait_hex"]
    assert eng.fault_counters.as_dict() == golden["faults"]
    for rid_s, want in golden["span_structure"].items():
        got = [list(x) for x in span_structure(eng.tracer, int(rid_s))]
        assert got == want, f"span structure drifted for rid {rid_s}"


# the event-loop profile's workload (benchmarks/profile_event_loop.py)
HEAVY_MU = 1.5
PROFILE_MODES = {"quick": 300, "heavy": 2000, "scale": 100_000}


def record_digest(recs) -> str:
    """SHA-256 over the exact bit patterns of the record stream — one
    flipped mantissa bit anywhere changes the digest."""
    payload = json.dumps(
        [[r.arm, float(r.t_total).hex(), float(r.wait_s).hex()]
         for r in recs]
    )
    return hashlib.sha256(payload.encode()).hexdigest()


@pytest.mark.parametrize("mode", list(PROFILE_MODES))
def test_profile_workload_digest_equals_golden(mode):
    cfg = SimConfig(
        n_requests=PROFILE_MODES[mode], mean_interarrival=HEAVY_MU, seed=7,
        straggler_prob=0.2, straggler_factor=6.0,
        fail_replica=("sdxl", 0, 100.0, 900.0),
    )
    reqs = make_requests(cfg)
    qt = synthetic_quality_table(reqs)
    prof = EventLoopProfiler()
    eng = ServingEngine(CyclePolicy(), qt, cfg, runtime="continuous",
                        runtime_cfg=RuntimeConfig(profiler=prof),
                        device="cpu")
    recs = sorted(eng.run(reqs), key=lambda r: r.rid)
    assert len(recs) == cfg.n_requests
    golden = (GOLDEN_DIR / f"profile_workload_{mode}.sha256").read_text()
    assert record_digest(recs) == golden.strip()
    rep = prof.report()
    assert rep["heap_ops"]["pops"] - rep["events"] == \
        sum(rep["stale_events"].values())
    # streaming arrivals keep the heap bounded by the arrival window and
    # the in-flight events, whatever the workload's size (read 268, 271
    # and 272 at 300, 2,000 and 20,000 requests)
    assert ARRIVAL_WINDOW < rep["heap_ops"]["peak_size"] < 2 * ARRIVAL_WINDOW
