"""End-to-end serving driver (port of ``repro/launch/serve.py``; the
paper's kind: multi-tenant diffusion service).  Trains or loads the two
relay families, precomputes the arm-quality table for the workload on
real latents, and runs the chosen scheduler against the Poisson request
stream with pool queueing, on the continuous-batching runtime by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 200
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 4 \\
      --policy rr --device cpu

The families come from ``--ckpt-dir`` (the in-repo checkpoints by
default); a family whose checkpoint is missing is trained there for
``--train-steps`` steps first (``diffusion/train.py::get_or_train_families``).
Training, the policy, the ``Executor`` and the engine run on ``--device``
(the card unless told otherwise).  Prints the JSON summary of the served
records.

:func:`serve` is the tensor half on its own: the per-arm quality report
of ``quality_table`` over the 11 arms or their compressed twins.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.diffusion.families import load_families
from repro_torch.diffusion.train import get_or_train_families
from repro_torch.kernels import build
from repro_torch.serving.arms import build_action_space
from repro_torch.serving.executor import Executor


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(requests: int = 8, *, seed: int = 0, compressed: bool = False,
          device=None, ckpt_dir: str = "results/ckpts") -> dict:
    """Run ``quality_table`` over the 11 arms (``compressed``: the 10
    compressed twins of the relay arms) and summarize it: per arm the mean
    of each quality metric and the wall time per request (generation and
    scoring, ending in a device synchronize).  Request ``i`` takes prompt
    seed ``seed + i``."""
    dev = resolve_device(device)
    ex = Executor(load_families(ckpt_dir, device=dev),
                  arms=build_action_space(compress=compressed), device=dev)
    arms = [a for a in ex.arms if a.program.is_relay or not compressed]
    seeds = np.arange(seed, seed + requests)
    build.reset_launches()
    rows = []
    for arm in arms:
        _sync(dev)
        t0 = time.perf_counter()
        col = ex.quality_table(seeds, arms=[arm])[:, arm.idx]
        _sync(dev)
        dt = time.perf_counter() - t0
        rows.append({
            "arm": arm.label,
            "quality": {k: float(np.mean([m[k] for m in col]))
                        for k in col[0]},
            "ms_per_request": dt * 1e3 / requests,
        })
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "requests": requests,
        "compressed": compressed,
        "arms": rows,
        "kernel_launches": dict(build.LAUNCHES),
    }


def resolve_runtime_config(runtime: str, no_compress: bool,
                           profile: bool = False):
    """RuntimeConfig for the chosen runtime.

    Both runtimes consume the transport knobs: the sequential engine
    prices inter-segment hops (and applies the measured quality delta)
    through the same :class:`HandoffTransport` the continuous runtime
    uses, so ``--no-compress`` is meaningful either way.  The batching
    knobs (buckets, linger) and the event-loop profiler apply to the
    continuous runtime only."""
    from repro_torch.serving.runtime import RuntimeConfig

    profiler = None
    if profile:
        from repro_torch.serving.obs.profiler import EventLoopProfiler

        profiler = EventLoopProfiler()
    return RuntimeConfig(compress_handoff=not no_compress, profiler=profiler)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--train-steps", type=int, default=1500,
                    help="training steps of each net when a family's "
                         "checkpoint is missing from --ckpt-dir")
    ap.add_argument("--mu", type=float, default=9.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", default="rise",
                    choices=["rise", "rr", "greedy", "ppo", "sac"])
    ap.add_argument("--runtime", default="continuous",
                    choices=["sequential", "continuous"],
                    help="continuous (default) = micro-batched discrete-event "
                         "runtime with compressed latent handoff and fault "
                         "injection; sequential = paper-faithful blocking loop")
    ap.add_argument("--no-compress", action="store_true",
                    help="disable int8 latent handoff compression "
                         "(hop pricing + quality delta, both runtimes)")
    ap.add_argument("--telemetry-context", action="store_true",
                    help="append live runtime telemetry (queue depth, batch "
                         "occupancy) to the LinUCB context vector")
    ap.add_argument("--straggler-prob", type=float, default=0.0,
                    help="fraction of edge-phase requests slowed by the "
                         "straggler model")
    ap.add_argument("--straggler-factor", type=float, default=6.0,
                    help="slowdown multiplier of a straggling request")
    ap.add_argument("--straggler-mode", default="item",
                    choices=["item", "batch"],
                    help="mitigation: 'item' (default) re-runs only the "
                         "straggling samples on the twin replica "
                         "(partial-batch re-execution); 'batch' re-issues "
                         "the whole micro-batch")
    ap.add_argument("--trace-out", default="",
                    help="write the per-request relay span trace as Chrome "
                         "trace-event JSON (open in Perfetto / "
                         "chrome://tracing); '.jsonl' suffix emits span "
                         "records instead")
    ap.add_argument("--profile", action="store_true",
                    help="wall-clock event-loop profiler for the continuous "
                         "runtime (event counts, per-event-type handler "
                         "time, heap ops); report lands in the summary")
    ap.add_argument("--device", default="cuda",
                    help="where the policy, the executor and the transport "
                         "run (cuda or cpu)")
    ap.add_argument("--ckpt-dir", default="results/ckpts",
                    help="the trained families' checkpoints (missing ones "
                         "are trained and written here)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.telemetry_context and args.policy in ("ppo", "sac"):
        ap.error("--telemetry-context is incompatible with the offline "
                 "PPO/SAC baselines (their nets are trained on the fixed "
                 "8-dim context); rr/greedy ignore the extra dims and rise "
                 "sizes its state to the widened context")

    from repro_torch.core import policies as pol
    from repro_torch.serving.context import context_dim
    from repro_torch.serving.engine import (ServingEngine, SimConfig,
                                            make_requests, summarize)

    dev = resolve_device(args.device)
    print("loading/training relay families...")
    fams = get_or_train_families(args.ckpt_dir, steps=args.train_steps,
                                 verbose=True, device=dev)
    ex = Executor(fams, device=dev)

    cfg = SimConfig(n_requests=args.requests, mean_interarrival=args.mu,
                    seed=args.seed, telemetry_context=args.telemetry_context,
                    straggler_prob=args.straggler_prob,
                    straggler_factor=args.straggler_factor,
                    straggler_mode=args.straggler_mode)
    reqs = make_requests(cfg)
    seeds = np.array([r.prompt_seed for r in reqs])
    print(f"precomputing quality table for {len(reqs)} requests × "
          f"{len(ex.arms)} arms...")
    qt = ex.quality_table(seeds)

    d = context_dim(args.telemetry_context)
    policy = {
        "rise": lambda: pol.RisePolicy(seed=args.seed, ctx_dim=d, device=dev),
        "rr": pol.RoundRobinPolicy,
        "greedy": pol.GreedyPolicy,
        "ppo": lambda: pol.PPOPolicy(seed=args.seed, device=dev),
        "sac": lambda: pol.SACPolicy(seed=args.seed, device=dev),
    }[args.policy]()

    runtime_cfg = resolve_runtime_config(args.runtime, args.no_compress,
                                         profile=args.profile)
    engine = ServingEngine(policy, qt, cfg, executor=ex, runtime=args.runtime,
                           runtime_cfg=runtime_cfg, device=dev)
    records = engine.run(reqs)
    summary = summarize(records)
    if engine.telemetry is not None:
        from repro_torch.serving.obs.export import export_runtime_telemetry

        summary["runtime_telemetry"] = export_runtime_telemetry(
            engine.telemetry)
    if args.trace_out:
        from repro_torch.serving.obs.export import (write_chrome_trace,
                                                    write_spans_jsonl)

        writer = (write_spans_jsonl if args.trace_out.endswith(".jsonl")
                  else write_chrome_trace)
        writer(engine.tracer, args.trace_out)
        print(f"trace ({engine.tracer.coverage():.1%} of completed requests) "
              f"-> {args.trace_out}")
    if args.profile and runtime_cfg.profiler is not None:
        summary["event_loop_profile"] = runtime_cfg.profiler.report()
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
