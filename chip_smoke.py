#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card.

  python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on any
mismatch:

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   from ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. each of the four CUDA kernels against its plain PyTorch version on the
   card — main-path shapes (R = 4·{1, 8} wire rows of L = 64), ragged
   shapes, one HBM-sized shape (R = 8192, L = 4096); fp32 and bf16; ddim
   and rf; guidance 1.0 and 3.5 — payloads, scales and stepped rows
   exact;
3. the main path: the trained families on the card, ``generate_bucketed``
   for 8 requests on each of the 11 raw arms and of the 10 compressed
   twins (fused and unfused boundaries, which must agree), then
   ``quality_table``; every kernel must have launched on this path; a
   request re-run alone and in a pair agrees with its row of 8 to 1e-4;
4. card against CPU: 2 requests per family on the same host-drawn noise;
5. times: per-arm ms per request (host clock around a synchronized
   run) and the device's busy share of one run; the launch floor (an
   empty kernel); per kernel, the device time per call (profiler) and the
   time per back-to-back call (CUDA events) beside the plain version's,
   the library call's, the byte/operation bound and the floor (that bound
   or the empty kernel's time, whichever is larger).

Prints a ``kernels`` JSON line, the card's line, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CKPTS = REPO / "results" / "ckpts"
# H100 SXM (NVIDIA data sheet): HBM3 rate and fp32 rate outside the
# tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
MAIN_ROWS, WIRE_LEN = 4 * 8, 64  # 8 requests x 4 latent channels, 8x8
RAW_RTOL, COMPRESSED_RTOL = 1e-4, 1e-3
KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "fused_cfg_step_quant": ("src/repro_torch/csrc/fused_sampler.cu",
                             "src/repro/kernels/fused_sampler/kernel.py:126"),
    "fused_cfg_step_dequant": ("src/repro_torch/csrc/fused_sampler.cu",
                               "src/repro/kernels/fused_sampler/kernel.py:166"),
    "quant_int8": ("src/repro_torch/csrc/quant.cu",
                   "src/repro/kernels/quant/kernel.py:36"),
    "dequant_int8": ("src/repro_torch/csrc/quant.cu",
                     "src/repro/kernels/quant/kernel.py:60"),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(10):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int = 50) -> float:
    """Device time of one call of ``fn``: the durations of the kernels it
    launched, from the profiler (CUPTI), over ``iters`` calls.  Raises
    when the profiler records no device activity."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    check(us > 0, "the profiler recorded no device time")
    return us / 1e3 / iters


def busy(fn, wall_ms: float) -> dict:
    """Device time of the kernels of one call of ``fn`` (profiled run),
    and its share of ``wall_ms``, the same call's unprofiled wall time
    (the profiler stretches the wall time of the run it traces)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    check(busy_ms > 0, "the profiler recorded no device time")
    return {"device_busy_ms": busy_ms, "wall_ms": wall_ms,
            "busy_share": busy_ms / wall_ms}


def timed(fn) -> dict:
    """``ms``: device time per call (profiler); ``call_ms``: CUDA-event
    time per call over back-to-back calls, which includes the host's
    launch overhead when the host is slower than the device."""
    return {"ms": device_ms(fn), "call_ms": time_ms(fn)}


def work(name: str, rows: int, length: int, esize: int, guidance: float):
    """(bytes, fp32 ops) the function needs at one shape: each input read
    once, each output written once; guidance 1.0 never reads eps_u."""
    n, scales = rows * length, 4 * rows
    eps_reads = 1 if guidance == 1.0 else 2
    cfg_ops = 0 if guidance == 1.0 else 3
    return {
        # x, eps in; q, s out; step (6 ops) + quantize (4 ops) per element
        "fused_cfg_step_quant": ((1 + eps_reads) * n * esize + 8 + n + scales,
                                 n * (10 + cfg_ops)),
        # q, s, eps in; stepped rows out; dequantize + step per element
        "fused_cfg_step_dequant": (n + scales + eps_reads * n * esize + 8
                                   + n * esize, n * (7 + cfg_ops)),
        "quant_int8": (n * esize + n + scales, 4 * n),
        "dequant_int8": (n + scales + 4 * n, n),
    }[name]


def bound(name, rows, length, esize, guidance):
    nbytes, ops = work(name, rows, length, esize, guidance)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.diffusion.families import load_families
    from repro_torch.diffusion import synth
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_sampler import ops as fops
    from repro_torch.kernels.fused_sampler import ref as fref
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.quant import ref as qref
    from repro_torch.serving.arms import build_action_space
    from repro_torch.serving.executor import Executor

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({build.library_path().name})")
    for line in build.build_log_path().read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 2. each kernel against its plain version ------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {name: 0.0 for name in KERNELS}

    def note(name, a, b):
        err = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
        max_err[name] = max(max_err[name], err)
        check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b),
              f"{name} differs from its plain version (max |err| {err})")

    shapes = [(4, WIRE_LEN), (MAIN_ROWS, WIRE_LEN), (13, 17), (3, 33),
              (1, 5), (3, 1500), (8192, 4096)]
    n_cases = 0
    for rows, length in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x, ec, eu = (torch.randn(rows, length, generator=gen, device=dev)
                         .to(dtype) for _ in range(3))
            q, s = qops.quant_int8(x)
            qr, sr = qref.quant_int8_ref(x)
            note("quant_int8", q, qr)
            note("quant_int8", s, sr)
            note("dequant_int8", qops.dequant_int8(q, s),
                 qref.dequant_int8_ref(q, s))
            for mode, cf in (("ddim", [0.4, 0.6]), ("rf", [-0.02, 0.0])):
                coeffs = torch.tensor(cf, device=dev)
                for g in (1.0, 3.5):
                    q, s = fops.fused_cfg_step_quant(x, ec, eu, coeffs,
                                                     guidance=g, mode=mode)
                    qr, sr = fref.fused_cfg_step_quant_ref(
                        x, ec, eu, coeffs, guidance=g, mode=mode)
                    note("fused_cfg_step_quant", q, qr)
                    note("fused_cfg_step_quant", s, sr)
                    note("fused_cfg_step_dequant",
                         fops.fused_cfg_step_dequant(q, s, ec, eu, coeffs,
                                                     guidance=g, mode=mode),
                         fref.fused_cfg_step_dequant_ref(
                             q, s, ec, eu, coeffs, guidance=g, mode=mode))
                    n_cases += 1
    torch.cuda.synchronize()
    print(f"kernels equal their plain versions: {n_cases} boundary cases, "
          f"{len(shapes)} shapes x fp32/bf16")

    # ---- 3. the main path ------------------------------------------------
    fams = load_families(CKPTS, device=dev)
    raw_arms = build_action_space()
    twins = [a for a in build_action_space(compress=True) if a.program.is_relay]
    ex_raw = Executor(fams, arms=raw_arms, device=dev)
    ex_fused = Executor(fams, arms=build_action_space(compress=True),
                        device=dev)
    ex_unfused = Executor(fams, arms=build_action_space(compress=True),
                          fused_boundary=False, device=dev)
    seeds = np.arange(8)

    def served(ex, arm):
        out = ex.generate_bucketed(arm, seeds)
        check(out.shape == (8, 8, 8, 4) and np.isfinite(out).all(),
              f"{arm.label}: output shape {out.shape} or non-finite values")
        return out

    build.reset_launches()
    for arm in raw_arms:
        served(ex_raw, arm)
    boundary_gap = 0.0
    for arm in twins:
        out_f, out_u = served(ex_fused, arm), served(ex_unfused, arm)
        gap = float(np.linalg.norm(out_f - out_u) / np.linalg.norm(out_u))
        boundary_gap = max(boundary_gap, gap)
        check(gap <= 1e-6, f"{arm.label}: fused vs unfused rel {gap}")
    tables = [ex_raw.quality_table(seeds),
              ex_fused.quality_table(seeds, arms=twins)]
    launches = dict(build.LAUNCHES)
    print(f"main path launches: {json.dumps(launches)}")
    check(all(launches[k] > 0 for k in KERNELS),
          f"a kernel never launched on the main path: {launches}")
    for table, arms in zip(tables, (raw_arms, twins)):
        for arm in arms:
            for m in table[:, arm.idx]:
                check(np.isfinite(list(m.values())).all(),
                      f"{arm.label}: non-finite quality {m}")
    print(f"fused vs unfused compressed arms: max rel diff {boundary_gap:.3e}")

    # a lone request re-run (one row) and a pair (two rows) against their
    # rows of the 8-request run: equal to rounding, not bit for bit, since
    # cuBLAS and cuDNN choose their kernels by batch size
    lone = {}
    for ex, arm in ((ex_raw, raw_arms[3]), (ex_raw, raw_arms[8]),
                    (ex_fused, twins[2])):
        full = ex.generate_bucketed(arm, seeds)
        lone[arm.label] = {}
        for what, subset in (("one_row", [5]), ("bucket_of_two", [5, 6])):
            rerun = ex.generate_bucketed(arm, seeds, subset=subset)
            ref = full[subset]
            lone[arm.label][what] = float(np.abs(rerun - ref).max())
            rel = float(np.linalg.norm(rerun - ref) / np.linalg.norm(ref))
            check(rel <= RAW_RTOL, f"{arm.label}: {what} re-run rel {rel}")
    print(f"lone request vs its row of 8, max |diff|: {json.dumps(lone)}")

    # ---- 4. card against CPU on the same host-drawn noise ------------------
    cpu_fams = load_families(CKPTS, device="cpu")
    worst = {}
    for compress in (False, True):
        space = build_action_space(compress=compress)
        ex_gpu = ex_fused if compress else ex_raw
        ex_cpu = Executor(cpu_fams, arms=space, device="cpu")
        for idx in (3, 8):  # s=15 relay of XL and of F3
            arm = space[idx]
            noise = ex_gpu.noise(arm, seeds[:2], per_sample=True)
            _, _, cond = synth.batch(seeds[:2], arm.family)
            a = ex_gpu.run(arm, noise, cond).cpu().numpy()
            b = ex_cpu.run(arm, noise, cond).numpy()
            rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
            worst[arm.label] = rel
            check(rel <= (COMPRESSED_RTOL if compress else RAW_RTOL),
                  f"{arm.label}: card vs CPU rel {rel}")
    print(f"card vs CPU rel diff: {json.dumps(worst)}")

    # ---- 5. times --------------------------------------------------------
    arm_ms = {}
    for ex, arms in ((ex_raw, raw_arms), (ex_fused, twins)):
        for arm in arms:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ex.generate_bucketed(arm, seeds)
            torch.cuda.synchronize()
            arm_ms[arm.label] = (time.perf_counter() - t0) * 1e3 / len(seeds)
    print(f"ms per request (8-request bucket): {json.dumps(arm_ms)}")
    shares = {arm.label: busy(lambda: ex.generate_bucketed(arm, seeds),
                              arm_ms[arm.label] * len(seeds))
              for ex, arm in ((ex_raw, raw_arms[3]), (ex_raw, raw_arms[8]),
                              (ex_fused, twins[2]))}
    print(f"device busy share of one 8-request run (profiled device time "
          f"over the unprofiled wall time above): {json.dumps(shares)}")

    # the floor every launch pays: a kernel that does nothing, launched
    # by the same path as the four
    empty = timed(lambda: build.launch_empty(dev))
    print(f"empty kernel: {json.dumps(empty)}")

    def kernel_rows(rows, length):
        x, ec, eu = (torch.randn(rows, length, generator=gen, device=dev)
                     for _ in range(3))
        coeffs = torch.tensor([0.4, 0.6], device=dev)
        q, s = qops.quant_int8(x)
        calls = {
            "fused_cfg_step_quant": (
                lambda: fops.fused_cfg_step_quant(x, ec, ec, coeffs),
                lambda: fref.fused_cfg_step_quant_ref(x, ec, ec, coeffs,
                                                      guidance=1.0,
                                                      mode="ddim"),
                None),
            "fused_cfg_step_dequant": (
                lambda: fops.fused_cfg_step_dequant(q, s, ec, ec, coeffs),
                lambda: fref.fused_cfg_step_dequant_ref(q, s, ec, ec, coeffs,
                                                        guidance=1.0,
                                                        mode="ddim"),
                None),
            "quant_int8": (lambda: qops.quant_int8(x),
                           lambda: qref.quant_int8_ref(x), None),
            # one PyTorch call computes q*s in fp32: int8 x fp32 promotes
            "dequant_int8": (lambda: qops.dequant_int8(q, s),
                             lambda: qref.dequant_int8_ref(q, s),
                             lambda: torch.mul(q, s)),
        }
        out = {}
        for name, (kern, plain, lib) in calls.items():
            b_ms, b_by = bound(name, rows, length, 4, 1.0)
            k, p = timed(kern), timed(plain)
            # the least device time of one launch: the byte or operation
            # bound, or the empty kernel's time where that is larger
            floor_ms, floor_by = max((b_ms, b_by), (empty["ms"], "launch"))
            out[name] = {
                "ms": k["ms"], "plain_ms": p["ms"],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": timed(lib)["ms"] if lib is not None else None,
                "call_ms": k["call_ms"], "plain_call_ms": p["call_ms"],
                "floor_ms": floor_ms, "floor_by": floor_by,
            }
        return out

    main_times = kernel_rows(MAIN_ROWS, WIRE_LEN)
    hbm_times = kernel_rows(8192, 4096)
    print(f"kernel times at R=8192, L=4096 fp32 ddim g=1: "
          f"{json.dumps(hbm_times)}")
    kernels = [{
        "name": name, "route": "cuda", "source": src, "replaces": tpu,
        "launches": launches[name], "max_abs_err": max_err[name],
        **main_times[name],
    } for name, (src, tpu) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
