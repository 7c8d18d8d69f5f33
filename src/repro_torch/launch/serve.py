"""Serve the relay action space on real latents and report its quality
(the tensor half of ``repro/launch/serve.py``: families → Executor →
``quality_table``; the simulated scheduler is not ported yet).

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 --compressed

Request ``i`` takes prompt seed ``seed + i``.  Prints a JSON summary: per
arm the mean of each quality metric and the wall time per request
(generation and scoring, ending in a device synchronize).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.diffusion.families import load_families
from repro_torch.kernels import build
from repro_torch.serving.arms import build_action_space
from repro_torch.serving.executor import Executor


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(requests: int = 8, *, seed: int = 0, compressed: bool = False,
          device=None, ckpt_dir: str = "results/ckpts") -> dict:
    """Run ``quality_table`` over the 11 arms (``compressed``: the 10
    compressed twins of the relay arms) and summarize it."""
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compressed", action="store_true",
                    help="serve the int8-handoff twins of the relay arms")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="results/ckpts")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    summary = serve(args.requests, seed=args.seed, compressed=args.compressed,
                    device=args.device,
                    ckpt_dir=args.ckpt_dir)
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
