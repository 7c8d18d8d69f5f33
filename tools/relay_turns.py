"""Host time of the port's LM relay, two checkouts in turns on one card.

  python tools/relay_turns.py OLD_CHECKOUT NEW_CHECKOUT [--rounds 2]

Each turn is a child process in one checkout (run from its root with
``PYTHONPATH=<checkout>/src``, so that it builds and loads its own
kernels).  For ``qwen3-4b`` and ``recurrentgemma-9b`` it draws the large
model and its cut as ``chip_smoke.py``'s phases 8 and 12 do (the same
seeds and layer counts, 8 prompts of 64 tokens), warms up with a 4-token
decode, then times what phases 10 and 14 time: the large model's greedy
decode of 64 new tokens (``large_ms_per_decode_step``, over the 128 decode
steps) and the relay at s = 32 (``relay_s32_ms_per_batch``); and the
flash wrapper's mean time per call over back-to-back decode calls at
``qwen3-4b``'s decode shape (``flash_call_us``, CUDA events).  The turns
run old, new, new, old for each round; the script prints the card's name
and power limit, one JSON line per turn and, last, each checkout's median
of every number.  Needs one card and no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys, time
import torch
from repro_torch import configs
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import transformer as tr
from repro_torch.serving.lm_relay import greedy_decode, relay_decode
from repro_torch.training.data import DataConfig, TokenPipeline

BATCH, PROMPT, TOTAL, SPLIT = 8, 64, 64, 32
ARCHS = (("qwen3-4b", 9, (1, 2)), ("recurrentgemma-9b", 11, (11, 12)))
dev = torch.device("cuda")
build.library()


def ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


out = {}
for name, small_layers, (s1, s2) in ARCHS:
    cfg_l = configs.get_config(name)
    cfg_s = cfg_l.replace(n_layers=small_layers)
    large = tr.init_model(cfg_l, torch.Generator(device=dev).manual_seed(s1),
                          dev)
    small = tr.init_model(cfg_s, torch.Generator(device=dev).manual_seed(s2),
                          dev)
    prompt = TokenPipeline(DataConfig(vocab_size=cfg_l.vocab_size,
                                      seq_len=PROMPT,
                                      global_batch=BATCH)).batch(999)[0]
    greedy_decode(large, cfg_l, prompt, 4)
    large_ms = ms(lambda: greedy_decode(large, cfg_l, prompt, TOTAL))
    relay_ms = ms(lambda: relay_decode(large, cfg_l, small, cfg_s, prompt,
                                       SPLIT, TOTAL))
    out[name] = {"large_ms_per_decode_step": large_ms / (PROMPT + TOTAL),
                 f"relay_s{SPLIT}_ms_per_batch": relay_ms}
    del large, small
    torch.cuda.empty_cache()

g = torch.Generator(device=dev).manual_seed(0)
q = torch.randn(BATCH, 1, 32, 128, generator=g, device=dev,
                dtype=torch.bfloat16).transpose(1, 2)
k = torch.randn(BATCH, PROMPT + TOTAL, 8, 128, generator=g, device=dev,
                dtype=torch.bfloat16).transpose(1, 2)
call = lambda: flash_attention(q, k, k, causal=False, kv_len=37)  # noqa: E731
for _ in range(10):
    call()
start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
torch.cuda.synchronize()
start.record()
for _ in range(2000):
    call()
stop.record()
torch.cuda.synchronize()
out["flash_call_us"] = start.elapsed_time(stop) / 2000 * 1e3
print(json.dumps(out))
"""


def turn(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    run = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, env=env,
                         capture_output=True, text=True, check=False)
    if run.returncode != 0:
        sys.stderr.write(run.stderr)
        raise SystemExit(f"{tree}: turn failed ({run.returncode})")
    return json.loads(run.stdout.strip().splitlines()[-1])


def leaves(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    seen = {"old": [], "new": []}
    for _ in range(args.rounds):
        for tag in ("old", "new", "new", "old"):
            got = leaves(turn(getattr(args, tag).resolve()))
            seen[tag].append(got)
            print(json.dumps({"turn": tag, **got}))
    print(json.dumps({tag: {k: statistics.median(r[k] for r in runs)
                            for k in runs[0]}
                      for tag, runs in seen.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
