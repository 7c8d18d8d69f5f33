"""End-to-end LM training driver on one device (port of
``repro/launch/train.py``).

A real training loop on the card (the CPU with ``--device cpu``):
reduced configurations unless ``--full``; the deterministic token
pipeline; AdamW; periodic asynchronous checkpoints in the reference's
format, so either package resumes the other's; checkpoint-resume; a
heartbeat and straggler monitor.  A configuration that reads a context
(``whisper-medium``'s frames, ``llama-3.2-vision-11b``'s patches) trains
on a zero fp32 context of its shape, as the reference's driver feeds it.
Weights are drawn from a
``torch.Generator`` seeded 0 (the reference's ``jax.random`` bits are not
reproduced).  The flags are the reference's, plus ``--device`` (CUDA
unless named; no fallback to the CPU).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --steps 60
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --resume ...
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="results/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full", action="store_true", help="full (non-reduced) config")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import configs
    from repro_torch.configs.base import make_reduced
    from repro_torch.device import keep_fp32, resolve_device
    from repro_torch.models import transformer as tr
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import train_step as ts
    from repro_torch.training.data import DataConfig, TokenPipeline
    from repro_torch.training.fault import HeartbeatMonitor, StragglerDetector
    from repro_torch.training.optimizer import OptConfig, adamw_init

    cfg = configs.get_config(args.arch)
    if not args.full:
        cfg = make_reduced(cfg)
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps, warmup_steps=5)

    device = resolve_device(args.device)
    keep_fp32(device)
    model = tr.init_model(cfg, torch.Generator(device=device).manual_seed(0),
                          device)
    opt_state = adamw_init(dict(model.named_parameters()), opt_cfg)
    start_step = 0

    ckpt_dir = Path(args.ckpt_dir) / args.arch
    if args.resume:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            flat, meta = ckpt.restore(
                ckpt_dir / f"step_{last:08d}.ckpt",
                ckpt.lm_state_to_jax(model, opt_state, cfg))
            opt_state = ckpt.lm_state_from_jax(flat, model, cfg)
            start_step = meta["step"]
            print(f"resumed from step {start_step}")

    data = TokenPipeline(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   global_batch=args.batch)
    )
    step_fn = ts.make_train_step(cfg, opt_cfg, remat=False)

    hb = HeartbeatMonitor(timeout_s=120.0)
    sd = StragglerDetector()
    losses = []
    pending_ckpt = None
    for step in range(start_step, args.steps):
        toks, labels = data.batch(step)
        batch = {"tokens": torch.from_numpy(toks).to(device),
                 "labels": torch.from_numpy(labels).to(device)}
        if cfg.ctx_dim:
            batch["ctx"] = torch.zeros((args.batch, cfg.ctx_len, cfg.ctx_dim),
                                       device=device)
        if cfg.encoder is not None:
            batch["ctx"] = torch.zeros(
                (args.batch, cfg.encoder.n_frames, cfg.encoder.d_model),
                device=device)
        t0 = time.time()
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        hb.beat("worker0")
        sd.record("worker0", dt)
        losses.append(loss)
        if (step + 1) % args.log_every == 0:
            print(f"step {step+1}: loss {loss:.4f} ({dt*1000:.0f} ms) "
                  f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.2f}")
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            if pending_ckpt is not None:
                pending_ckpt.join()
            pending_ckpt = ckpt.save_async(
                ckpt_dir, ckpt.lm_state_to_jax(model, opt_state, cfg),
                {"step": step + 1, "arch": args.arch}, step=step + 1,
            )
    if pending_ckpt is not None:
        pending_ckpt.join()
    print(f"done: loss {losses[0]:.4f} → {losses[-1]:.4f} "
          f"(ckpts in {ckpt_dir})")
    return losses


if __name__ == "__main__":
    main()
