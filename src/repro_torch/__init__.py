"""PyTorch/CUDA port of the RISE relay executor.

Mirrors ``repro``'s module names (``core/schedules.py``,
``core/boundary.py``, ``serving/executor.py``, ...) so each port module
sits beside its JAX counterpart.  The JAX package stays the reference;
this package imports ``torch`` and never ``jax`` or ``repro``.

Entry points run on CUDA unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).  On a CUDA tensor the kernel
wrappers under :mod:`repro_torch.kernels` launch the hand-written CUDA
kernels from ``csrc/``; on a CPU tensor they run the plain PyTorch version.
"""
