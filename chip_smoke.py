#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card.

  python3 chip_smoke.py

It drives the port's main paths — the diffusion relay executor, the LM
prefix relay at ``qwen3-4b`` width and the same relay at
``recurrentgemma-9b`` width — and holds every CUDA kernel against its
plain PyTorch version.  Phases, each failing the run (non-zero exit, no
result line) on any mismatch:

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   from ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel),
   with ``-Xptxas -v``'s registers, stack and spills of every flash
   kernel;
2. each of the four boundary kernels against its plain PyTorch version on
   the card — main-path shapes (R = 4·{1, 8} wire rows of L = 64), ragged
   shapes, one HBM-sized shape (R = 8192, L = 4096); fp32 and bf16; ddim
   and rf; guidance 1.0 and 3.5 — payloads, scales and stepped rows
   exact; and the interior sampler step (``fused_cfg_step``) bit for bit
   at the relay's latents (8, 8, 8, 4) and a straggler's (1, 8, 8, 4),
   ragged shapes and (8192, 4096); fp32 and bf16; ddim (``ddim_coeffs(0.4,
   0.6)``) and rf; guidance 1.0 and 3.5; eps_u its own tensor and eps_c
   itself;
3. the diffusion main path: the trained families on the card,
   ``generate_bucketed`` for 8 requests on each of the 11 raw arms and of
   the 10 compressed twins (fused and unfused boundaries, which must
   agree bit for bit), then ``quality_table``; every diffusion
   kernel must have launched on this path, the interior step exactly
   once per step of each F3 call but a fused hop's two boundary steps
   (50 raw and unfused, 48 fused) and never on XL; a request re-run alone
   and in a pair (``subset=``) equals its rows of 8 bit for bit;
4. diffusion card against CPU: 2 requests per family on the same
   host-drawn noise; then F3's s = 15 relay guided (g = 3.5, an
   unconditional input of zeros) through ``execute_program``, raw, int8
   unfused and int8 fused, card against CPU, with exact interior-step
   launches, two net calls a step, equal bytes, and latents that differ
   from the unguided relay's;
5. diffusion times: per-arm ms per request (host clock around a
   synchronized run) and the device's busy share of one run; the launch
   floor (an empty kernel); per kernel, the device time per call
   (profiler) and the time per back-to-back call (CUDA events) beside the
   plain version's, the library call's, the byte/operation bound and the
   floor (that bound or the empty kernel's time, whichever is larger); the
   interior step at the path's shape (unguided and guided) and at (8192,
   4096) in fp32 and bf16, its library time the pair lerp + add;
6. flash attention against its plain version on the card (tolerances at
   ``FLASH_TOL``), each case run twice and equal to itself bit for bit:
   the five shapes of ``tests/test_kernels.py`` in fp32 and bf16, and in
   bf16 the LM paths' shapes in the model's strided layout — ``qwen3-4b``
   decode (q (8, 32, 1, 128) over a cache of 128, kv_len 1, 37, 128, and
   over caches of 2048 and 4096, kv_len 1, 37, T: split KV, whole splits
   empty at 37), scoring (S = T = 128, causal) and S = T = 4096 causal;
   ``recurrentgemma-9b`` (MQA at head dim 256) decode (q (8, 16, 1, 256)
   over a ring of 128, kv_len 1, 37, 128), full rings of 16 and 2048
   slots and the ring of 2048 at kv_len 37, scoring (S = T = 128, causal,
   window 2048), and fp32 cases at head dim 256; scoring at S = 70
   (ragged tiles) at head dims 128 and 256, plain and with a window of 24;
7. flash attention's times per shape (both models' decode and scoring,
   4096, the two long-cache decodes, in the model's layout): the
   kernel's, the plain version's and SDPA's beside the bound;
11. the RG-LRU scan against its plain version, bit for bit: the path's
    shape (8, 128, 4096), ragged shapes, S = 1 and (1, 4096, 4096); then
    its times at (8, 128, 4096) and (1, 4096, 4096) beside the plain
    version's, the bound and the launch floor (run here, before the LM
    paths' long runs, as the profiler needs);
8. the LM main path: ``qwen3-4b`` (36 layers, bf16) as the large model and
   its 9-layer cut as the small one, random weights from seeded
   generators; 8 prompts of 64 tokens decode 64 new tokens large-only,
   relayed at s = 32, and small-only, then ``sequence_logprob`` of each
   under the large model; flash attention must launch in both the decode
   calls and the scoring forward, as many times as there are layer calls,
   every decode call on the decode kernel and every scoring call on the
   scoring kernel (none on the CUDA-core one), and the handoff bytes must
   follow the reference's formula;
9. LM card against CPU on the same weights: full width, 2 layers, fp32,
   2 prompts of 16 tokens: teacher-forced logits and ``sequence_logprob``
   within 1e-5 relative, and an 8-token relay's tokens equal up to the
   first step whose top-2 margin does not exceed ten times the logit
   difference (a tie, reported as one); then full width, 4 layers, bf16
   (the main path's dtype): every layer's attention output at every
   decode step and in the scoring forward, the bf16 caches and the logits
   within ``LM_BF16_RTOL`` of the CPU's;
10. LM times: ms per new token of each model and ms per relay request,
    and the busy share of one relay run; then the ``qwen3-4b`` models are
    freed;
12. the RecurrentGemma main path: ``recurrentgemma-9b`` (38 layers, bf16)
    as the large model and its 11-layer cut as the small one, random
    weights from seeded generators, the same prompts, large-only, relayed
    at s = 32 and small-only, then ``sequence_logprob`` of each under the
    large model; exact launch counts: the RG-LRU scan never in decode and
    once per recurrent layer (26) per scored batch, flash attention once
    per attention layer (12 and 3) per decode step (decode kernel) and 12
    times per scored batch (scoring kernel);
13. RecurrentGemma card against CPU on the same weights, at full width
    with 5 layers (one super-block and the remainder, the depth
    ``make_reduced`` keeps) and, for this check only, the window cut to 16
    so that the ring wraps inside a 32-token run: fp32 as in phase 9
    (logits and ``sequence_logprob`` within 1e-5, relay tokens up to the
    first tie), and bf16: every layer's mixer output at every decode step
    and in the scoring forward, the ``h``/``conv`` states and the rings
    after every step, and the logits, within ``RG_BF16_RTOL``;
14. RecurrentGemma times, as phase 10.

The phases run in the order 1-7, 11, 8-10, 12-14.  Every profiled time
comes from a session whose kernel records are complete (see
:func:`profiled`); the profiled phases run before the LM paths' long
unprofiled runs where they can.

Prints a ``kernels`` JSON line, the card's line, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
CKPTS = REPO / "results" / "ckpts"
# H100 SXM (NVIDIA data sheet): HBM3 rate, fp32 rate outside the tensor
# cores and dense bf16 tensor-core rate, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
MAIN_ROWS, WIRE_LEN = 4 * 8, 64  # 8 requests x 4 latent channels, 8x8
RAW_RTOL, COMPRESSED_RTOL = 1e-4, 1e-3
# LM paths: 8 prompts of 64 tokens, 64 new tokens, relays at s
LM_BATCH, LM_PROMPT, LM_TOTAL, LM_SPLITS = 8, 64, 64, (32,)
LM_SMALL_LAYERS = 9
RG_NAME, RG_SMALL_LAYERS = "recurrentgemma-9b", 11
# phase 13: one super-block (R, R, A) and the remainder (R, R); the
# window cut to 16, for the check only, so that the ring wraps in a run of
# 16 prompt tokens and 16 new ones
RG_CHECK_LAYERS, RG_CHECK_WINDOW = 5, 16
# RG-LRU scan shapes (B, S, R): the path's, ragged ones, S = 1, a long one
RGLRU_SHAPES = [(LM_BATCH, LM_PROMPT + LM_TOTAL, 4096), (3, 70, 70),
                (1, 1, 5), (2, 1, 33), (1, 4096, 4096)]
LM_RTOL = 1e-5  # card against CPU, fp32 logits (norm-wise relative)
MARGIN_FACTOR = 10.0  # a greedy step is a tie below 10x the logit gap
# flash attention against its plain version, (atol, rtol): fp32 at
# tests/test_kernels.py's TOL; bf16 to one bf16 ulp (rtol 8e-3 > 2^-7, the
# largest ulp/|x|) over an atol of 1e-4 for outputs near zero.  Both round
# one fp32 result to bf16, so they differ by at most one ulp: the largest
# bf16 error the card showed under the older 4e-2 was 9.8e-4, one ulp at
# |x| in [0.125, 0.25) (14 cases, H100 80GB HBM3, 700 W)
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 8e-3)}
# full width, 4 layers, bf16, card against CPU on the same weights:
# norm-wise relative error of each attention output, cache and logit row,
# about five bf16 epsilons (2^-8); a wrong cache write or read moves an
# attention output by O(1)
LM_BF16_LAYERS, LM_BF16_RTOL = 4, 2e-2
# recurrentgemma-9b at full width, 5 layers, window 16, bf16, card against
# CPU, norm-wise as above: 2.3x the largest reading (RG-LRU block outputs
# 1.09e-2 in decode and 1.01e-2 in scoring; attention 6.7e-3, logits
# 7.2e-3, h and conv states 7.3e-3 and 6.3e-3, rings 3.8e-3; H100 80GB
# HBM3, 700 W), and 2.5x under the weakest fault that
# tests/test_torch_recurrentgemma.py injects (an h not carried moves the
# mixer outputs by 0.063)
RG_BF16_RTOL = 2.5e-2
# the interior step's cases in phase 2: the relay's latents (8 requests, a
# straggler's 1), ragged shapes and one HBM-sized shape
STEP_SHAPES = [(8, 8, 8, 4), (1, 8, 8, 4), (13, 17), (2, 5, 7, 3), (1, 5),
               (8192, 4096)]
RF_DT = -0.02  # an rf step's coefficient in the kernel checks
GUIDANCE = 3.5  # phase 4's guided relay and the guided kernel cases
DIFFUSION_KERNELS = ("fused_cfg_step", "fused_cfg_step_quant",
                     "fused_cfg_step_dequant", "quant_int8", "dequant_int8")
KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "fused_cfg_step": ("src/repro_torch/csrc/fused_sampler.cu",
                       "src/repro/kernels/fused_sampler/kernel.py:48"),
    "fused_cfg_step_quant": ("src/repro_torch/csrc/fused_sampler.cu",
                             "src/repro/kernels/fused_sampler/kernel.py:126"),
    "fused_cfg_step_dequant": ("src/repro_torch/csrc/fused_sampler.cu",
                               "src/repro/kernels/fused_sampler/kernel.py:166"),
    "quant_int8": ("src/repro_torch/csrc/quant.cu",
                   "src/repro/kernels/quant/kernel.py:36"),
    "dequant_int8": ("src/repro_torch/csrc/quant.cu",
                     "src/repro/kernels/quant/kernel.py:60"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:78"),
    "rglru_scan": ("src/repro_torch/csrc/rglru.cu",
                   "src/repro/kernels/rglru/kernel.py:37"),
}


# the profiler's name of each counted kernel: the three flash kernels share
# the prefix (flash_fwd_kernel, flash_fwd_decode_kernel,
# flash_fwd_scoring_kernel)
KERNEL_SYMBOLS = {"flash_attention": "flash_impl::flash_fwd",
                  "rglru_scan": "rglru_scan_kernel"}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def flash_ptxas(log: str) -> list:
    """``-Xptxas -v``'s report of each kernel of ``flash_attention.cu`` in
    the build log: its name and template arguments, registers, stack and
    spills."""
    section = log.split("== flash_attention.cu", 1)[-1].split("\n== ", 1)[0]
    out, name = [], None
    for line in section.splitlines():
        entry = re.search(r"Compiling entry function '\w*?(flash_fwd_\w*?kernel)I(\w*?)EEEv",
                          line)
        if entry:
            args = (entry.group(2).replace("13__nv_bfloat16", "bf16, ")
                    .replace("Li", ""))
            name = f"{entry.group(1)}<{'fp32, ' + args[1:] if args.startswith('f') else args}>"
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spills}")
            name = None
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(min(10, iters)):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def profiled(run, calls: int = 1, counted: str = None, records: int = None,
             attempts: int = 3):
    """Device time (µs) of the kernels ``run()`` launches, from the
    profiler (CUPTI), and the profiler's averages by kernel.

    The session must hold every kernel record: ``run`` makes ``calls``
    calls that launch the same kernels, so the number recorded must be a
    multiple of ``calls`` (with ``records``, the kernels one call
    launches, exactly ``records * calls``); with ``counted`` (a kernel of
    ``build.LAUNCHES``), the records of that kernel must number its
    launches during ``run``.  On the H100 machine CUPTI has dropped
    records (all of them, or some at a session's end) in a process that
    had already run many profiled or unprofiled launches; such a session
    is repeated, up to ``attempts`` times in all, and then this raises."""
    from repro_torch.kernels import build

    symbol = KERNEL_SYMBOLS.get(counted)
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        before = build.LAUNCHES[counted] if counted else 0
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        us = sum(e.self_device_time_total for e in averages)
        n = sum(e.count for e in averages if e.self_device_time_total > 0)
        complete = us > 0 and n % calls == 0
        if records:
            complete = complete and n == records * calls
        if counted:
            launched = build.LAUNCHES[counted] - before
            recorded = sum(e.count for e in averages if symbol in e.key)
            complete = complete and recorded == launched
        if complete:
            return us, averages
        print(f"profiler: {n} kernels, {us} us recorded for {calls} calls "
              f"(session {attempt} of {attempts})", file=sys.stderr)
        time.sleep(1.0)
    raise RuntimeError("check failed: the profiler lost device records")


def device_ms(fn, iters: int = 50, records: int = None) -> float:
    """Device time of one call of ``fn``: the durations of the kernels it
    launched, from the profiler, over ``iters`` calls."""
    for _ in range(min(5, iters)):
        fn()

    def run():
        for _ in range(iters):
            fn()
    return profiled(run, calls=iters, records=records)[0] / 1e3 / iters


def busy(fn, wall_ms: float, counted: str = None) -> dict:
    """Device time of the kernels of one call of ``fn`` (profiled run),
    and its share of ``wall_ms``, the same call's unprofiled wall time
    (the profiler stretches the wall time of the run it traces); the five
    kernels with the most device time in that run; with ``counted``, the
    device time of that kernel's records."""
    us, averages = profiled(fn, counted=counted)
    top = sorted(averages, key=lambda e: -e.self_device_time_total)[:5]
    out = {"device_busy_ms": us / 1e3, "wall_ms": wall_ms,
           "busy_share": us / 1e3 / wall_ms,
           "top_kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3
                              for e in top}}
    if counted:
        out[f"{counted}_ms"] = sum(
            e.self_device_time_total for e in averages
            if KERNEL_SYMBOLS[counted] in e.key) / 1e3
    return out


def timed(fn, iters: int = 200, records: int = None) -> dict:
    """``ms``: device time per call (profiler); ``call_ms``: CUDA-event
    time per call over back-to-back calls, which includes the host's
    launch overhead when the host is slower than the device."""
    return {"ms": device_ms(fn, min(50, iters), records),
            "call_ms": time_ms(fn, iters)}


def host_timed(fn):
    """``(fn(), host ms)`` around a synchronized call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


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


def flash_work(b, h, kv, s, t, d, causal, window, kv_len, esize):
    """(bytes, operations) one flash-attention call needs at these inputs:
    q read and the output written once, each key and value that some
    query attends read once; 4·D operations (two multiply-adds) per
    attended (query, key) pair."""
    q_pos, k_pos = np.arange(s)[:, None], np.arange(t)[None, :]
    mask = k_pos < kv_len
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    keys = int(mask.any(axis=0).sum())
    nbytes = esize * (2 * b * h * s * d + 2 * b * kv * keys * d)
    return nbytes, 4 * d * b * h * int(mask.sum())


def flash_bound(work, dtype):
    nbytes, ops = work
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash_inputs(gen, dev, b, h, kv, s, t, d, dtype, model_layout=False):
    """q (b, h, s, d), k and v (b, kv, t, d); with ``model_layout``, the
    strided views the LM path passes: (b, s, h, d) projections and a
    (b, t, kv, d) cache, each seen through ``.transpose(1, 2)``."""
    if not model_layout:
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((b, h, s, d), (b, kv, t, d), (b, kv, t, d))]
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            .transpose(1, 2)
            for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]


def check_flash(gen, dev) -> float:
    """Phase 6: the kernels against their plain version, each case run
    twice and equal to itself bit for bit; returns max |err|."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    # (b, h, kv, s, t, d, causal, window, cap, kv_len, dtype, model layout)
    cases = [(b, h, kv, s, t, d, c, w, cap, None, dt, False)
             for (b, h, kv, s, t, d, c, w, cap) in (
                 (2, 4, 2, 64, 64, 32, True, None, None),
                 (1, 4, 4, 40, 40, 16, True, None, 50.0),
                 (2, 8, 2, 32, 96, 32, False, None, None),
                 (1, 4, 1, 64, 64, 32, True, 16, None),
                 (1, 2, 2, 16, 128, 64, True, None, None))
             for dt in (torch.float32, torch.bfloat16)]
    steps = LM_PROMPT + LM_TOTAL
    cases += [(LM_BATCH, 32, 8, 1, steps, 128, False, None, None, kl,
               torch.bfloat16, True) for kl in (1, 37, steps)]
    cases.append((LM_BATCH, 32, 8, steps, steps, 128, True, None, None, None,
                  torch.bfloat16, True))
    cases.append((1, 32, 8, 4096, 4096, 128, True, None, None, None,
                  torch.bfloat16, True))
    # recurrentgemma-9b: 16 query heads over 1 KV head of 256; ring
    # decode, full rings (as after a wrap) of phase 13's 16 slots and the
    # window's 2048, scoring inside the window; and fp32 at head dim 256
    for dt in (torch.bfloat16, torch.float32):
        cases += [(LM_BATCH, 16, 1, 1, steps, 256, False, None, None, kl, dt,
                   True) for kl in ((1, 37, steps) if dt == torch.bfloat16
                                    else (37,))]
        cases.append((LM_BATCH, 16, 1, steps, steps, 256, True, 2048, None,
                      None, dt, True))
    cases += [(LM_BATCH, 16, 1, 1, w, 256, False, None, None, w,
               torch.bfloat16, True) for w in (RG_CHECK_WINDOW, 2048)]
    # decode over long caches, split over KV: kv_len 37 leaves whole
    # splits empty; the ring of 2048 as it fills
    cases += [(LM_BATCH, 32, 8, 1, t, 128, False, None, None, kl,
               torch.bfloat16, True) for t in (2048, 4096)
              for kl in (1, 37, t)]
    cases.append((LM_BATCH, 16, 1, 1, 2048, 256, False, None, None, 37,
                  torch.bfloat16, True))
    # scoring at S = 70 (ragged tiles), plain and with a window shorter
    # than S, at both tensor-core head dims the paths use
    cases += [(2, h, kv, 70, 70, d, True, w, None, None, torch.bfloat16,
               True) for h, kv, d in ((32, 8, 128), (16, 1, 256))
              for w in (None, 24)]
    worst, used = 0.0, {}
    for (b, h, kv, s, t, d, causal, window, cap, kv_len, dtype,
         layout) in cases:
        q, k, v = flash_inputs(gen, dev, b, h, kv, s, t, d, dtype, layout)
        kw = dict(causal=causal, window=window, softcap=cap, kv_len=kv_len)
        out = flash_attention(q, k, v, **kw)
        again = flash_attention(q, k, v, **kw)
        ref = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        check(torch.equal(out, again),
              f"flash_attention {(b, h, kv, s, t, d, causal, window, cap, kv_len)} "
              f"{dtype}: two calls differ")
        diff = (out.double() - ref.double()).abs()
        err = float(diff.max())
        worst = max(worst, err)
        atol, rtol = FLASH_TOL[dtype]
        # the largest share of its tolerance that an element uses
        share = float((diff / (atol + rtol * ref.double().abs())).max())
        used[str(dtype)] = max(used.get(str(dtype), 0.0), share)
        check(share <= 1.0 and out.dtype == dtype
              and torch.isfinite(out).all(),
              f"flash_attention {(b, h, kv, s, t, d, causal, window, cap, kv_len)} "
              f"{dtype}: max |err| {err}, {share:.3f} of (atol {atol}, "
              f"rtol {rtol})")
    print(f"flash_attention equals its plain version: {len(cases)} cases "
          f"(each twice, bit-identical), max |err| {worst:.3e}, largest "
          f"share of the tolerance used {json.dumps(used)}")
    return worst


def guided_relay(dev, fam_card, fam_cpu, noise, cond) -> dict:
    """Phase 4, guidance: F3's s = 15 relay through ``execute_program``
    over ``make_program(..., guidance=3.5)`` with an unconditional input,
    raw, int8 unfused and int8 fused, on the card and on the CPU from the
    same host noise; and the same relays unguided.  The unconditional
    input is zeros of the conditioning's shape: a test input, not the
    families' null prompt."""
    from repro_torch.core.program import make_program
    from repro_torch.core.relay import execute_program
    from repro_torch.diffusion.families import role_fn, role_params
    from repro_torch.kernels import build

    spec = fam_card.spec
    cond = torch.as_tensor(cond, dtype=torch.float32)
    uncond = torch.zeros_like(cond)
    s = 15
    route = [("large", "p0", s), ("small", "p1", None)]
    net_calls = [0]

    def counting(fn):
        def call(*args):
            net_calls[0] += 1
            return fn(*args)
        return call

    res, table = {}, {}
    for mode in ("raw", "unfused", "fused"):
        compress = mode != "raw"
        for where, fam in (("card", fam_card), ("cpu", fam_cpu)):
            place = dev if where == "card" else torch.device("cpu")
            models = {r: (counting(role_fn(fam, r)), role_params(fam, r))
                      for r in ("large", "small")}
            for g in (GUIDANCE, 1.0):
                prog = make_program(spec, route, guidance=g, compress=compress)
                net_calls[0] = 0
                before = build.LAUNCHES["fused_cfg_step"]
                with torch.inference_mode():
                    out, info = execute_program(
                        spec, prog, models, noise.to(place), cond.to(place),
                        uncond=uncond.to(place), fused_boundary=mode == "fused")
                res[mode, where, g] = {
                    "out": out.cpu(), "bytes": info["transfer_bytes"],
                    "launches": build.LAUNCHES["fused_cfg_step"] - before,
                    "net_calls": net_calls[0]}
        steps = prog.total_steps
        want_launches = steps - (2 if mode == "fused" else 0)
        card, cpu = res[mode, "card", GUIDANCE], res[mode, "cpu", GUIDANCE]
        plain = res[mode, "card", 1.0]
        rel = norm_rel(card["out"], cpu["out"])
        plain_rel = norm_rel(plain["out"], res[mode, "cpu", 1.0]["out"])
        moved = norm_rel(card["out"], plain["out"])
        table[mode] = {"card_vs_cpu_rel": rel, "unguided_card_vs_cpu_rel":
                       plain_rel, "guided_vs_unguided_rel": moved,
                       "bytes": card["bytes"], "launches": card["launches"],
                       "net_calls": card["net_calls"]}
        tol = COMPRESSED_RTOL if compress else RAW_RTOL
        check(rel <= tol and plain_rel <= tol,
              f"guided F3 relay ({mode}): card vs CPU rel {rel} "
              f"({plain_rel} unguided)")
        check(card["bytes"] == cpu["bytes"] == plain["bytes"],
              f"guided F3 relay ({mode}): bytes {card['bytes']}, "
              f"CPU {cpu['bytes']}, unguided {plain['bytes']}")
        check(card["launches"] == plain["launches"] == want_launches,
              f"guided F3 relay ({mode}): {card['launches']} interior-step "
              f"launches ({plain['launches']} unguided), want {want_launches}")
        # both nets on every step when guided, the conditional one alone
        # at g = 1
        check(card["net_calls"] == cpu["net_calls"] == 2 * steps
              and plain["net_calls"] == steps,
              f"guided F3 relay ({mode}): {card['net_calls']} net calls "
              f"({plain['net_calls']} unguided) over {steps} steps")
        check(bool(torch.isfinite(card["out"]).all()) and moved > 0.5,
              f"guided F3 relay ({mode}): guided vs unguided rel {moved}")
    print(f"guided F3 relay (s={s}, g={GUIDANCE}, uncond = zeros, 2 requests):"
          f" {json.dumps(table)}")
    return table


def step_times(dev, gen, floor_ms) -> dict:
    """Phase 5: the interior step's times, rf: at the path's shape as the
    relay calls it (fp32, g = 1, eps_u is eps_c), guided there (g = 3.5,
    eps_u its own tensor), and guided at (8192, 4096) in fp32 and bf16;
    beside the plain version's, the bound and the launch floor.  No single
    PyTorch call computes the step: the library time is the pair
    ``torch.lerp`` (the combine) and ``torch.add(alpha=)`` (the update)."""
    from repro_torch.kernels.fused_sampler import ops as fops
    from repro_torch.kernels.fused_sampler import ref as fref

    rows = {}
    for name, shape, dtype, g in (
            ("path", (8, 8, 8, 4), torch.float32, 1.0),
            ("path_guided", (8, 8, 8, 4), torch.float32, GUIDANCE),
            ("hbm_fp32", (8192, 4096), torch.float32, GUIDANCE),
            ("hbm_bf16", (8192, 4096), torch.bfloat16, GUIDANCE)):
        x, ec, eu = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for _ in range(3))
        if g == 1.0:
            eu = ec  # the relay's call: the unconditional net is not run
        kw = dict(guidance=g, c1=RF_DT, c2=0.0, mode="rf")
        kern = timed(lambda: fops.fused_cfg_step(x, ec, eu, **kw), records=1)
        plain = timed(lambda: fref.fused_cfg_step_ref(x, ec, eu, **kw))
        lib = timed(lambda: torch.add(x, torch.lerp(eu, ec, g), alpha=RF_DT),
                    records=2)
        # each distinct input read once, x' written once; the combine's
        # subtract, multiply and add and the update's multiply and add
        n, esize = x.numel(), x.element_size()
        reads = 2 if eu is ec else 3
        t_bytes = (reads + 1) * n * esize / HBM_BYTES_PER_S
        t_ops = 5 * n / FP32_OPS_PER_S
        b_ms = max(t_bytes, t_ops) * 1e3
        b_by = "bytes" if t_bytes >= t_ops else "operations"
        f_ms, f_by = max((b_ms, b_by), (floor_ms, "launch"))
        rows[name] = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                      "guidance": g, "ms": kern["ms"],
                      "call_ms": kern["call_ms"], "plain_ms": plain["ms"],
                      "plain_call_ms": plain["call_ms"],
                      "library_ms": lib["ms"], "library_call_ms": lib["call_ms"],
                      "bound_ms": b_ms, "bound_by": b_by,
                      "floor_ms": f_ms, "floor_by": f_by}
    print(f"fused_cfg_step times, rf (library: lerp + add, two calls): "
          f"{json.dumps(rows)}")
    return rows


def mixer_layers(cfg, mixer: str) -> int:
    """The number of layers of ``cfg`` whose mixer is ``mixer``."""
    from repro_torch.models import transformer as tr

    return sum(spec.mixer == mixer for spec in tr.layer_specs(cfg))


def lm_main_path(dev, name: str, small_layers: int, seeds=(1, 2)):
    """Phases 8 and 12: the large model ``name`` and its ``small_layers``
    cut; returns the models, their configs, the prompts and the path's
    launches.  Flash attention launches once per attention layer per
    decode step and per scored batch; the RG-LRU scan never in decode and
    once per recurrent layer per scored batch."""
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tr
    from repro_torch.serving.lm_relay import (greedy_decode, relay_decode,
                                              sequence_logprob)
    from repro_torch.training.data import DataConfig, TokenPipeline

    cfg_l = configs.get_config(name)
    cfg_s = cfg_l.replace(n_layers=small_layers)
    t0 = time.perf_counter()
    large = tr.init_model(cfg_l, torch.Generator(device=dev)
                          .manual_seed(seeds[0]), dev)
    small = tr.init_model(cfg_s, torch.Generator(device=dev)
                          .manual_seed(seeds[1]), dev)
    torch.cuda.synchronize()
    print(f"{name} models: large {cfg_l.n_layers} layers "
          f"{cm.count_params(large) / 1e9:.3f} B params, small "
          f"{cfg_s.n_layers} layers {cm.count_params(small) / 1e9:.3f} B, "
          f"{cfg_l.dtype}, drawn in {time.perf_counter() - t0:.1f} s")
    prompt = TokenPipeline(DataConfig(
        vocab_size=cfg_l.vocab_size, seq_len=LM_PROMPT,
        global_batch=LM_BATCH)).batch(999)[0]

    build.reset_launches()
    flash_ops.reset_variant_launches()
    runs = {}
    seq, ms = host_timed(lambda: greedy_decode(large, cfg_l, prompt, LM_TOTAL))
    runs["large-only"] = (LM_TOTAL, 0, seq, ms)
    for s in LM_SPLITS:
        (seq, info), ms = host_timed(lambda: relay_decode(
            large, cfg_l, small, cfg_s, prompt, s, LM_TOTAL))
        want = LM_BATCH * (LM_PROMPT + s) * 4  # 4 bytes a token
        check(info["transfer_bytes"] == want and info["edge_tokens"] == s
              and info["node_tokens"] == {"n00": s, "n01": LM_TOTAL - s},
              f"relay s={s}: info {info}, transfer bytes want {want}")
        runs[f"relay s={s}"] = (s, LM_TOTAL - s, seq, ms)
    seq, ms = host_timed(lambda: greedy_decode(small, cfg_s, prompt, LM_TOTAL))
    runs["small-only"] = (0, LM_TOTAL, seq, ms)
    decode = dict(build.LAUNCHES)
    # decode steps (prompt + new tokens) of each model over all runs
    steps_l = sum(LM_PROMPT + e for e, _, _, _ in runs.values() if e)
    steps_s = sum(LM_PROMPT + LM_TOTAL for _, d, _, _ in runs.values() if d)
    want_decode = {"flash_attention": mixer_layers(cfg_l, "attn") * steps_l
                   + mixer_layers(cfg_s, "attn") * steps_s, "rglru_scan": 0}
    got = {k: decode[k] for k in want_decode}
    check(got == want_decode, f"{name}: launches in decode {got}, want "
          f"{want_decode}")
    # every bf16 flash call of the path on a tensor-core kernel
    variants = dict(flash_ops.VARIANT_LAUNCHES)
    want_variants = {"simt": 0, "decode": want_decode["flash_attention"],
                     "scoring": 0}
    check(variants == want_variants, f"{name}: flash kernels in decode "
          f"{variants}, want {want_variants}")

    logp = {run: sequence_logprob(large, cfg_l, r[2])
            for run, r in runs.items()}
    scoring = {k: build.LAUNCHES[k] - decode[k] for k in want_decode}
    want_scoring = {
        "flash_attention": mixer_layers(cfg_l, "attn") * len(runs),
        "rglru_scan": mixer_layers(cfg_l, "rglru") * len(runs)}
    check(scoring == want_scoring, f"{name}: launches in scoring "
          f"{scoring}, want {want_scoring}")
    want_variants["scoring"] = want_scoring["flash_attention"]
    check(flash_ops.VARIANT_LAUNCHES == want_variants, f"{name}: flash "
          f"kernels after scoring {flash_ops.VARIANT_LAUNCHES}, want "
          f"{want_variants}")
    launches = dict(build.LAUNCHES)

    ref = runs["large-only"][2]
    prompt_t = torch.from_numpy(prompt).to(dev)
    for run, (e, _, seq, _) in runs.items():
        check(seq.shape == (LM_BATCH, LM_PROMPT + LM_TOTAL)
              and seq.dtype == prompt_t.dtype
              and bool(((seq >= 0) & (seq < cfg_l.vocab_size)).all())
              and torch.equal(seq[:, :LM_PROMPT], prompt_t),
              f"{run}: sequence {tuple(seq.shape)} out of range or prompt lost")
        check(np.isfinite(logp[run]), f"{run}: logp {logp[run]}")
        # the relay's large segment is the large-only decode's prefix
        check(torch.equal(seq[:, :LM_PROMPT + e], ref[:, :LM_PROMPT + e]),
              f"{run}: large-model prefix differs from large-only")
    print(f"{name} main path launches: decode {json.dumps(got)}, "
          f"scoring {json.dumps(scoring)}; flash kernels "
          f"{json.dumps(want_variants)}")
    print(f"{'config':12s} {'edge':>5s} {'dev':>5s} {'logp(large)':>12s} "
          f"{'wall ms':>9s}")
    for run, (e, d, _, ms) in runs.items():
        print(f"{run:12s} {e:5d} {d:5d} {logp[run]:12.4f} {ms:9.1f}")
    return large, small, cfg_l, cfg_s, prompt, launches


def rg_check_config(cfg):
    """Phase 13's configuration: ``cfg`` at full width, ``RG_CHECK_LAYERS``
    layers, each local-attention window cut to ``RG_CHECK_WINDOW`` (for
    this check only: at the model's 2048 a 32-token run never wraps the
    ring)."""
    def cut(specs):
        return tuple(dataclasses.replace(
            spec, window=RG_CHECK_WINDOW if spec.window else None)
            for spec in specs)
    return cfg.replace(n_layers=RG_CHECK_LAYERS, pattern=cut(cfg.pattern),
                       remainder=cut(cfg.remainder))


def lm_card_vs_cpu(dev, prompt, cfg, seeds=(3, 4), s=4, total=8) -> dict:
    """Phases 9 and 13, fp32: ``cfg`` in fp32 (full width, cut in depth),
    the same weights on both; a relay of ``total`` new tokens at ``s``
    after 16 tokens of 2 prompts."""
    from repro_torch.models import transformer as tr
    from repro_torch.serving.lm_relay import relay_decode, sequence_logprob

    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 products
    cfg = cfg.replace(dtype="float32")
    models = {role: tr.init_model(cfg, torch.Generator(device=dev)
                                  .manual_seed(seed), dev)
              for role, seed in zip(("large", "small"), seeds)}
    p2 = prompt[:2, :16]
    places = {"card": dev, "cpu": torch.device("cpu")}
    out = {}
    for name, where in places.items():
        for m in models.values():
            m.to(where)
        seq, info = relay_decode(models["large"], cfg, models["small"], cfg,
                                 p2, s, total, device=where)
        out[name] = {"seq": seq.cpu(), "info": info}
    # logits of both devices on the card's tokens
    seq = out["card"]["seq"]
    for name in ("cpu", "card"):
        where = places[name]
        for m in models.values():
            m.to(where)
        out[name]["logits"] = {
            role: tr.model_fwd(m, cfg, {"tokens": seq.to(where).long()})
            .float().cpu() for role, m in models.items()}
        out[name]["logp"] = sequence_logprob(models["large"], cfg, seq,
                                             device=where)
    card, cpu = out["card"], out["cpu"]
    rel = {role: float(torch.linalg.norm(card["logits"][role]
                                         - cpu["logits"][role])
                       / torch.linalg.norm(cpu["logits"][role]))
           for role in models}
    check(max(rel.values()) <= LM_RTOL, f"LM card vs CPU logits rel {rel}")
    lp_rel = abs(card["logp"] - cpu["logp"]) / abs(cpu["logp"])
    check(lp_rel <= LM_RTOL, f"LM card vs CPU logp rel {lp_rel}")
    check(card["info"] == cpu["info"], "LM card vs CPU relay info differs")
    # tokens, up to the first tie: position j was chosen by the logits at
    # j - 1 of the model whose segment holds it
    p = p2.shape[1]
    tie, margins = None, []
    for j in range(p, p + total):
        role = "large" if j < p + s else "small"
        lc, lh = (x["logits"][role][:, j - 1, :cfg.vocab_size]
                  for x in (card, cpu))
        top2 = torch.topk(lc, 2).values
        margin = top2[:, 0] - top2[:, 1]
        gap = (lc - lh).abs().amax(-1)
        margins.append(float(margin.min()))
        if bool((margin <= MARGIN_FACTOR * gap).any()):
            tie = j
            break
    upto = p + total if tie is None else tie
    check(torch.equal(card["seq"][:, :upto], cpu["seq"][:, :upto]),
          f"LM card vs CPU tokens differ before position {upto}")
    result = {"logits_rel": rel, "logp_rel": lp_rel,
              "tokens_equal_upto": upto, "tie_at": tie,
              "min_margin": min(margins)}
    print(f"{cfg.name} card vs CPU ({cfg.n_layers} layers, fp32): "
          f"{json.dumps(result)}")
    del models
    return result


def norm_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in fp64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def lm_bf16_card_vs_cpu(dev, prompt, cfg, tol: float, seed: int = 6,
                        n_new: int = 8) -> dict:
    """Phases 9 and 13, bf16: ``cfg`` (full width, cut in depth) in the
    main path's dtype, the same weights on the card and the CPU (the plain
    path).  The card greedy-decodes ``n_new`` tokens after 16 of a prompt;
    both devices then feed those tokens one by one through ``decode_step``
    (the bf16 caches written and read as on the main path) and once
    through ``model_fwd`` (the scoring forward).  Each layer's mixer
    output (attention or RG-LRU block) at each step and in the scoring
    forward, every cache tensor (K/V, or the ``h`` and ``conv`` states)
    after each step, and the logits are held card against CPU within
    ``tol``, norm-wise.  The mixer outputs are compared on their own: with
    random weights the tied logits are dominated by the current token's
    own embedding, so a wrong cache read or state carry would move them
    little."""
    from repro_torch.models import attention as attn
    from repro_torch.models import recurrent as rec
    from repro_torch.models import transformer as tr
    from repro_torch.serving.lm_relay import greedy_decode

    model = tr.init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                          dev)
    seq = greedy_decode(model, cfg, prompt[:2, :16], n_new, device=dev)
    b, n = seq.shape
    originals, seen = {"attn": attn.gqa_fwd, "rglru": rec.rglru_block_fwd}, []

    def host(x):  # a copy on the host: the caches change in place
        return x.to("cpu", torch.float32, copy=True)

    def recording(kind):  # every layer's mixer output
        def fwd(*args, **kw):
            y, c = originals[kind](*args, **kw)
            seen.append((kind, host(y)))
            return y, c
        return fwd

    def by_kind(records, prefix):
        out = {}
        for kind, y in records:
            out.setdefault(f"{prefix}_{kind}", []).append(y)
        return out

    out = {}
    attn.gqa_fwd, rec.rglru_block_fwd = recording("attn"), recording("rglru")
    try:
        for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
            model.to(where)
            toks = seq.to(where)
            cache = tr.init_model_cache(cfg, b, n, device=where)
            res = {"logits": []}
            with torch.no_grad():
                for t in range(n):
                    lg, cache = tr.decode_step(model, cfg, cache,
                                               toks[:, t:t + 1], t)
                    res["logits"].append(host(lg[:, 0, :cfg.vocab_size]))
                    for c in cache["layers"]:
                        for key, x in c.items():
                            res.setdefault(f"cache_{key}", []).append(host(x))
                res.update(by_kind(seen, "decode"))
                seen.clear()
                scoring = tr.model_fwd(model, cfg, {"tokens": toks})
            res.update(by_kind(seen, "scoring"))
            res["scoring_logits"] = [host(scoring[:, j, :cfg.vocab_size])
                                     for j in range(n)]
            out[name] = res
            seen.clear()
    finally:
        attn.gqa_fwd, rec.rglru_block_fwd = originals["attn"], originals["rglru"]
    del model
    card, cpu = out["card"], out["cpu"]
    kinds = {"attn": mixer_layers(cfg, "attn"),
             "rglru": mixer_layers(cfg, "rglru")}
    check(all(len(card.get(f"decode_{k}", ())) == n * m
              and len(card.get(f"scoring_{k}", ())) == m
              for k, m in kinds.items() if m)
          and card.keys() == cpu.keys(), f"bf16 {cfg.name}: mixer calls recorded")
    rel = {key: max(norm_rel(a, c) for a, c in zip(card[key], cpu[key]))
           for key in sorted(card)}
    print(f"{cfg.name} card vs CPU ({cfg.n_layers} layers, bf16, {b} prompts "
          f"of {n} tokens), largest norm-wise relative error per step and "
          f"layer: {json.dumps(rel)}")
    check(max(rel.values()) <= tol,
          f"bf16 {cfg.name} card vs CPU over {tol}: {rel}")
    return rel


def flash_times(dev, floor_ms) -> dict:
    """Phase 7: flash attention's times per shape, bf16."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(device=dev).manual_seed(5)
    steps = LM_PROMPT + LM_TOTAL
    shapes = {
        # (b, h, kv, s, t, d, causal, window, kv_len, iters)
        "decode": (LM_BATCH, 32, 8, 1, steps, 128, False, None, steps, 200),
        "scoring": (LM_BATCH, 32, 8, steps, steps, 128, True, None, None,
                    100),
        "s4096": (1, 32, 8, 4096, 4096, 128, True, None, None, 10),
        # recurrentgemma-9b: the ring decode and the windowed scoring call
        "rg_decode": (LM_BATCH, 16, 1, 1, steps, 256, False, None, steps,
                      200),
        "rg_scoring": (LM_BATCH, 16, 1, steps, steps, 256, True, 2048, None,
                       100),
        # decode over long caches: qwen3-4b at 4096, the ring of 2048
        "decode_t4096": (LM_BATCH, 32, 8, 1, 4096, 128, False, None, 4096,
                         50),
        "rg_decode_t2048": (LM_BATCH, 16, 1, 1, 2048, 256, False, None, 2048,
                            100),
    }
    rows = {}
    for name, (b, h, kv, s, t, d, causal, window, kv_len,
               iters) in shapes.items():
        q, k, v = flash_inputs(gen, dev, b, h, kv, s, t, d, torch.bfloat16,
                               model_layout=True)
        # a window of at least s keys changes nothing for SDPA's causal mask
        kw = dict(causal=causal, window=window, kv_len=kv_len)
        kl = t if kv_len is None else kv_len
        k_l, v_l = k[:, :, :kl], v[:, :, :kl]
        kern = timed(lambda: flash_attention(q, k, v, **kw), iters)
        plain = timed(lambda: flash_attention_ref(q, k, v, **kw), iters)
        lib = timed(lambda: F.scaled_dot_product_attention(
            q, k_l, v_l, is_causal=causal, enable_gqa=True), iters)
        b_ms, b_by = flash_bound(flash_work(b, h, kv, s, t, d, causal,
                                            window, kl, 2), torch.bfloat16)
        f_ms, f_by = max((b_ms, b_by), (floor_ms, "launch"))
        rows[name] = {"shape": [b, h, kv, s, t, d, causal, kl],
                      "ms": kern["ms"], "call_ms": kern["call_ms"],
                      "plain_ms": plain["ms"],
                      "plain_call_ms": plain["call_ms"],
                      "library_ms": lib["ms"], "library_call_ms": lib["call_ms"],
                      "bound_ms": b_ms, "bound_by": b_by,
                      "floor_ms": f_ms, "floor_by": f_by}
    print(f"flash_attention times, bf16 (b, h, kv, s, t, d, causal, "
          f"kv_len): "
          f"{json.dumps(rows)}")
    return rows


def rglru_inputs(gen, dev, shape):
    """Decays a in [0.3, 0.999) and inputs b ~ N(0, 0.2²), as
    ``tests/test_kernels.py`` draws them."""
    a = torch.rand(shape, generator=gen, device=dev) * 0.699 + 0.3
    return a, torch.randn(shape, generator=gen, device=dev) * 0.2


def check_rglru(gen, dev) -> float:
    """Phase 11: the scan against its plain version, bit for bit."""
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rglru.ref import rglru_scan_ref

    worst = 0.0
    for shape in RGLRU_SHAPES:
        a, b = rglru_inputs(gen, dev, shape)
        out, ref = rglru_scan(a, b), rglru_scan_ref(a, b)
        torch.cuda.synchronize()
        err = float((out.double() - ref.double()).abs().max())
        worst = max(worst, err)
        check(out.dtype == torch.float32 and torch.equal(out, ref),
              f"rglru_scan {shape} differs from its plain version "
              f"(max |err| {err})")
    print(f"rglru_scan equals its plain version bit for bit: "
          f"{json.dumps(RGLRU_SHAPES)}")
    return worst


def rglru_times(dev, floor_ms) -> dict:
    """Phase 11: the scan's times at the path's shape and a long one.  No
    single PyTorch call computes the recurrence (a cumprod/cumsum form
    underflows), so there is no library time."""
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rglru.ref import rglru_scan_ref

    gen = torch.Generator(device=dev).manual_seed(7)
    rows = {}
    # (shape, iters of the kernel, iters of the plain loop)
    for name, shape, iters, plain_iters in (
            ("scoring", RGLRU_SHAPES[0], 200, 20),
            ("long", (1, 4096, 4096), 20, 1)):
        a, b = rglru_inputs(gen, dev, shape)
        kern = timed(lambda: rglru_scan(a, b), iters, records=1)
        # the plain loop launches a fill, then a product, a sum and a copy
        # per step: the profiler has lost the last of 36,867 such records
        # in one session, so each session's count is checked exactly
        plain = timed(lambda: rglru_scan_ref(a, b), plain_iters,
                      records=3 * shape[1] + 1)
        n = int(np.prod(shape))
        # a and b read once, h written once; a multiply and an add each
        t_bytes, t_ops = 3 * 4 * n / HBM_BYTES_PER_S, 2 * n / FP32_OPS_PER_S
        b_ms = max(t_bytes, t_ops) * 1e3
        b_by = "bytes" if t_bytes >= t_ops else "operations"
        f_ms, f_by = max((b_ms, b_by), (floor_ms, "launch"))
        rows[name] = {"shape": list(shape), "ms": kern["ms"],
                      "call_ms": kern["call_ms"], "plain_ms": plain["ms"],
                      "plain_call_ms": plain["call_ms"], "library_ms": None,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "floor_ms": f_ms, "floor_by": f_by}
    print(f"rglru_scan times (B, S, R): {json.dumps(rows)}")
    return rows


def lm_times(large, small, cfg_l, cfg_s, prompt) -> dict:
    """Phases 10 and 14: ms per new token, per relay request, and the busy
    share of one relay run."""
    from repro_torch.serving.lm_relay import greedy_decode, relay_decode

    _, large_ms = host_timed(lambda: greedy_decode(large, cfg_l, prompt, LM_TOTAL))
    _, small_ms = host_timed(lambda: greedy_decode(small, cfg_s, prompt, LM_TOTAL))
    s = LM_SPLITS[len(LM_SPLITS) // 2]
    relay = lambda: relay_decode(large, cfg_l, small, cfg_s, prompt,  # noqa: E731
                                 s, LM_TOTAL)
    _, relay_ms = host_timed(relay)
    times = {
        "large_ms_per_new_token": large_ms / LM_TOTAL,
        "small_ms_per_new_token": small_ms / LM_TOTAL,
        "large_ms_per_decode_step": large_ms / (LM_PROMPT + LM_TOTAL),
        "small_ms_per_decode_step": small_ms / (LM_PROMPT + LM_TOTAL),
        f"relay_s{s}_ms_per_request": relay_ms / LM_BATCH,
        f"relay_s{s}_ms_per_batch": relay_ms,
        f"busy_relay_s{s}": busy(relay, relay_ms, counted="flash_attention"),
    }
    print(f"{cfg_l.name} times ({LM_BATCH} prompts of {LM_PROMPT}, "
          f"{LM_TOTAL} new tokens): {json.dumps(times)}")
    return times


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
    log = build.build_log_path().read_text()
    for line in log.split("== flash_attention.cu", 1)[0].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    flash = flash_ptxas(log)
    check(len(flash) == 14, f"ptxas reported {len(flash)} flash kernels, "
          f"want 14 (8 CUDA-core, 3 decode, 3 scoring)")
    for line in flash:
        print(f"  ptxas {line}")

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
    # the interior step: ddim (affine coefficients) and rf, g = 1 and 3.5,
    # eps_u its own tensor or eps_c itself (as the relay passes it)
    step_coeffs = {"ddim": fref.ddim_coeffs(0.4, 0.6), "rf": (RF_DT, 0.0)}
    step_cases = 0
    for shape in STEP_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, ec, eu = (torch.randn(shape, generator=gen, device=dev)
                         .to(dtype) for _ in range(3))
            for mode, (c1, c2) in step_coeffs.items():
                for g in (1.0, GUIDANCE):
                    for e_u in (eu, ec):
                        kw = dict(guidance=g, c1=c1, c2=c2, mode=mode)
                        note("fused_cfg_step",
                             fops.fused_cfg_step(x, ec, e_u, **kw),
                             fref.fused_cfg_step_ref(x, ec, e_u, **kw))
                        step_cases += 1
    torch.cuda.synchronize()
    print(f"kernels equal their plain versions: {n_cases} boundary cases, "
          f"{len(shapes)} shapes x fp32/bf16; {step_cases} interior-step "
          f"cases over {json.dumps(STEP_SHAPES)}")

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

    def interior_steps(ex, arm):
        """Launches of the interior step in one run of the arm's program:
        every step of an rf (F3) program but a fused hop's emit and consume
        steps, none of a ddim (XL) one."""
        prog = arm.program
        if fams[prog.family].spec.kind != "rf":
            return 0
        fused_hops = (sum(h.compress for h in prog.handoffs)
                      if ex.fused_boundary else 0)
        return prog.total_steps - 2 * fused_hops

    step_launches = {}

    def served(ex, arm):
        before = build.LAUNCHES["fused_cfg_step"]
        out = ex.generate_bucketed(arm, seeds)
        got = build.LAUNCHES["fused_cfg_step"] - before
        key = arm.label + ("" if ex.fused_boundary else "|unfused")
        step_launches[key] = got
        check(got == interior_steps(ex, arm),
              f"{key}: {got} interior-step launches, want "
              f"{interior_steps(ex, arm)}")
        check(out.shape == (8, 8, 8, 4) and np.isfinite(out).all(),
              f"{arm.label}: output shape {out.shape} or non-finite values")
        return out

    build.reset_launches()
    for arm in raw_arms:
        served(ex_raw, arm)
    for arm in twins:
        out_f, out_u = served(ex_fused, arm), served(ex_unfused, arm)
        check(np.array_equal(out_f, out_u),
              f"{arm.label}: fused vs unfused differ by "
              f"{float(np.abs(out_f - out_u).max())}")
    tables = [ex_raw.quality_table(seeds),
              ex_fused.quality_table(seeds, arms=twins)]
    launches = dict(build.LAUNCHES)
    print(f"main path launches: {json.dumps(launches)}")
    check(all(launches[k] > 0 for k in DIFFUSION_KERNELS),
          f"a kernel never launched on the diffusion path: {launches}")
    for table, arms in zip(tables, (raw_arms, twins)):
        for arm in arms:
            for m in table[:, arm.idx]:
                check(np.isfinite(list(m.values())).all(),
                      f"{arm.label}: non-finite quality {m}")
    print(f"interior-step launches per 8-request call: "
          f"{json.dumps(step_launches)}")
    print(f"fused vs unfused compressed arms: bit-identical on all "
          f"{len(twins)}")

    # straggler re-runs: a lone request (one row) and a pair (two rows)
    # against their rows of the 8-request run, bit for bit (the re-run
    # repeats the full call's bucket, rows and filler)
    lone = {}
    for ex, arm in ((ex_raw, raw_arms[3]), (ex_raw, raw_arms[8]),
                    (ex_fused, twins[2]), (ex_fused, twins[7])):
        full = ex.generate_bucketed(arm, seeds)
        lone[arm.label] = {}
        for what, subset in (("one_row", [5]), ("two_rows", [6, 2])):
            rerun = ex.generate_bucketed(arm, seeds, subset=subset)
            ref = full[subset]
            lone[arm.label][what] = float(np.abs(rerun - ref).max())
            check(np.array_equal(rerun, ref),
                  f"{arm.label}: {what} re-run differs from its rows by "
                  f"{lone[arm.label][what]}")
    print(f"straggler re-runs vs their rows of 8, max |diff|: "
          f"{json.dumps(lone)}")

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
    guided_relay(dev, fams["F3"], cpu_fams["F3"],
                 ex_raw.noise(raw_arms[8], seeds[:2], per_sample=True),
                 synth.batch(seeds[:2], "F3")[2])

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
    step_rows = step_times(dev, gen, empty["ms"])

    # ---- 6, 7, 11. flash attention and the RG-LRU scan ---------------------
    max_err["flash_attention"] = check_flash(gen, dev)
    flash_rows = flash_times(dev, empty["ms"])
    max_err["rglru_scan"] = check_rglru(gen, dev)
    rglru_rows = rglru_times(dev, empty["ms"])

    # ---- 8-10. the qwen3-4b LM path ---------------------------------------
    from repro_torch import configs

    large, small, cfg_l, cfg_s, prompt, qwen_launches = lm_main_path(
        dev, "qwen3-4b", LM_SMALL_LAYERS)
    lm_card_vs_cpu(dev, prompt, cfg_l.replace(n_layers=2))
    lm_bf16_card_vs_cpu(dev, prompt, cfg_l.replace(n_layers=LM_BF16_LAYERS),
                        LM_BF16_RTOL)
    lm_times(large, small, cfg_l, cfg_s, prompt)
    del large, small
    torch.cuda.empty_cache()

    # ---- 12-14. the recurrentgemma-9b LM path ----------------------------
    large, small, cfg_l, cfg_s, prompt, rg_launches = lm_main_path(
        dev, RG_NAME, RG_SMALL_LAYERS, seeds=(11, 12))
    rg_check = rg_check_config(configs.get_config(RG_NAME))
    lm_card_vs_cpu(dev, prompt, rg_check, seeds=(13, 14), s=8, total=16)
    lm_bf16_card_vs_cpu(dev, prompt, rg_check, RG_BF16_RTOL, seed=15,
                        n_new=16)
    lm_times(large, small, cfg_l, cfg_s, prompt)
    del large, small

    launches["flash_attention"] = (qwen_launches["flash_attention"]
                                   + rg_launches["flash_attention"])
    launches["rglru_scan"] = rg_launches["rglru_scan"]
    # the rows of the shapes launched most on the LM paths: qwen3-4b's
    # decode, and the RG-LRU scan's scoring shape
    main_times["flash_attention"] = {
        k: v for k, v in flash_rows["decode"].items() if k != "shape"}
    main_times["rglru_scan"] = {
        k: v for k, v in rglru_rows["scoring"].items() if k != "shape"}
    main_times["fused_cfg_step"] = {
        k: v for k, v in step_rows["path"].items()
        if k not in ("shape", "dtype", "guidance")}

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
