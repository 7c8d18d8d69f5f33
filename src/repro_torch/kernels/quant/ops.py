"""Wrappers of the row-wise int8 kernels: the CUDA kernels from
``csrc/quant.cu`` on CUDA tensors, the plain version (``ref.py``) on CPU
tensors.  Replaces ``repro/kernels/quant/ops.py``."""
from __future__ import annotations

import torch

from repro_torch.analysis import roofline as rl
from repro_torch.kernels import build
from repro_torch.kernels.quant.ref import dequant_int8_ref, quant_int8_ref


@rl.declares("quant_int8", lambda x: (*rl.boundary_work(
    "quant_int8", *build.rows_of(x), x.element_size(), 1.0), True))
def quant_int8(x: torch.Tensor):
    """Row-wise symmetric int8 over the last dim of ``x`` (fp32 or bf16,
    contiguous): returns ``(q int8 shaped like x, s fp32 (..., 1))``."""
    if build.on_cpu(x):
        return quant_int8_ref(x)
    build.check(x, "x", build.FLOAT_DTYPES)
    length = x.shape[-1]
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    if q.numel():
        build.launch("quant_int8", x.device, x.data_ptr(), build.dtype_code(x),
                     q.data_ptr(), s.data_ptr(), q.numel() // length, length)
    return q, s


@rl.declares("dequant_int8", lambda q, s: (*rl.boundary_work(
    "dequant_int8", *build.rows_of(q), 4, 1.0), True))
def dequant_int8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """q·s in fp32 for int8 rows ``q`` (..., L) and scales ``s`` (..., 1)."""
    if build.on_cpu(q, s):
        return dequant_int8_ref(q, s)
    build.check(q, "q", (torch.int8,))
    build.check(s, "s", (torch.float32,), shape=q.shape[:-1] + (1,))
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if out.numel():
        build.launch("dequant_int8", q.device, q.data_ptr(), s.data_ptr(),
                     out.data_ptr(), out.numel() // q.shape[-1], q.shape[-1])
    return out
