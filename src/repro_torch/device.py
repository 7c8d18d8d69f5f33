"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default) and
    absent: the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def keep_fp32(device) -> None:
    """On CUDA, turn off TF32 for convolutions and matrix products.

    cuDNN runs fp32 convolutions in TF32 by default, and TF32 keeps about
    3 decimal digits; the port is held to the fp32 reference, so every
    entry point that runs the denoisers on the card (the executor,
    training, the acceleration baselines) calls this first.  Does nothing
    on another device."""
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
