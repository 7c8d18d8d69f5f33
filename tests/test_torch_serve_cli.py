"""The serving driver's policy half, the port against the JAX package on
the CPU (``repro_torch/launch/serve.py::main`` against
``repro/launch/serve.py::main``): the trained families from
``results/ckpts/``, the quality table on real latents, the scheduler on the
continuous runtime, the summary.

Each package draws its own initial noise (the port does not reproduce
``jax.random``'s bits), so the port's ``Executor.noise`` is replaced here
by the reference's draw for the same (arm, seeds), as
``tests/test_torch_executor.py::test_quality_table_on_reference_noise``
does.  Then:

* ``arm_histogram``, ``text_fraction`` and the latency keys
  (``mean_latency_s``, ``p95_latency_s``, ``time_reward``) and the runtime
  telemetry are exact: the simulated clock never sees a latent;
* the quality keys and the rewards within ``SUMMARY_RTOL`` of
  ``max(|ref|, 1)``: the latents agree to about 1e-5 relative
  (``test_torch_executor.py``), the quality oracles amplify that, and the
  int8 round trip's error differs in its last bits.  Read: 4.3e-7 (the
  largest over the nine keys, ``total_reward``; 4 requests under RR), so
  the bound 4e-6 is 9.3x the reading.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.launch import serve as tserve
from repro_torch.serving import executor as texec
from repro_torch.serving.obs import validate_chrome_trace

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CKPTS = REPO / "results" / "ckpts"
ARGS = ["--requests", "4", "--policy", "rr", "--runtime", "continuous"]
SUMMARY_RTOL = 4e-6
EXACT_KEYS = ("arm_histogram", "text_fraction", "mean_latency_s",
              "p95_latency_s", "time_reward", "runtime_telemetry")


def reference_noise(self, arm, seeds, per_sample):
    """The reference executor's ``quality_table`` draw: one key per batch,
    from its first seed and the arm (``generate``)."""
    key = jax.random.PRNGKey(int(seeds[0]) * 7919 + arm.idx)
    return torch.from_numpy(np.array(
        jax.random.normal(key, (len(seeds), 8, 8, 4))))


def _port_main(argv, monkeypatch):
    monkeypatch.setattr(texec.Executor, "noise", reference_noise)
    return tserve.main(argv + ["--device", "cpu", "--ckpt-dir", str(CKPTS)])


@pytest.fixture(scope="module")
def reference_summary():
    cwd = os.getcwd()
    os.chdir(REPO)  # the reference reads results/ckpts relative to it
    try:
        return jserve.main(ARGS)
    finally:
        os.chdir(cwd)


def test_summary_equals_reference(reference_summary, monkeypatch):
    ref = reference_summary
    port = _port_main(ARGS, monkeypatch)
    assert port.keys() == ref.keys()
    assert "event_loop_profile" not in port
    assert sum(port["arm_histogram"]) == 4
    for k in EXACT_KEYS:
        assert port[k] == ref[k], k
    worst = max(abs(port[k] - ref[k]) / max(abs(ref[k]), 1.0)
                for k in ref if k not in EXACT_KEYS)
    assert worst <= SUMMARY_RTOL, worst


def test_train_steps_trains_writes_and_serves(tmp_path):
    """A ``--ckpt-dir`` without checkpoints: ``main`` trains both families
    for ``--train-steps`` steps, writes their checkpoints, and serves."""
    summary = tserve.main(["--ckpt-dir", str(tmp_path), "--train-steps", "2",
                           "--requests", "4", "--device", "cpu",
                           "--policy", "rr"])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "diffusion_F3.ckpt", "diffusion_XL.ckpt"]
    assert sum(summary["arm_histogram"]) == 4
    assert np.isfinite(summary["total_reward"])


def test_telemetry_context_refused_for_offline_baselines(capsys):
    for main in (jserve.main, tserve.main):
        with pytest.raises(SystemExit) as err:
            main(["--telemetry-context", "--policy", "ppo"])
        assert err.value.code == 2
        assert "incompatible with the offline PPO/SAC" in \
            capsys.readouterr().err


def test_trace_out_and_profile(tmp_path, monkeypatch):
    """``--trace-out`` writes a Chrome trace the port's validator accepts
    (and a ``.jsonl`` path span records); ``--profile`` adds the event
    loop's report to the summary without moving a record."""
    trace = tmp_path / "trace.json"
    out = tmp_path / "summary.json"
    prof = _port_main(ARGS + ["--trace-out", str(trace), "--profile",
                              "--out", str(out)], monkeypatch)
    assert validate_chrome_trace(json.loads(trace.read_text())) == []
    assert json.loads(out.read_text()) == json.loads(json.dumps(prof))
    rep = prof.pop("event_loop_profile")
    assert rep["events"] > 0 and {"arrive", "batch_done"} <= \
        set(rep["per_event_type"])
    spans = tmp_path / "spans.jsonl"
    plain = _port_main(ARGS + ["--trace-out", str(spans)], monkeypatch)
    assert plain == prof
    lines = [json.loads(x) for x in spans.read_text().splitlines()]
    assert {x["rid"] for x in lines if x["type"] == "request"} == \
        set(range(4))
