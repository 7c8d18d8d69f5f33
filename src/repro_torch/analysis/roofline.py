"""Roofline terms of a step on one H100, from a cost count of torch's own
(port of ``repro/analysis/roofline.py``).

The reference derives its terms from compiled XLA HLO text and corrects
``while`` bodies for their trip counts.  Eager torch runs every iteration
of a loop as its own ops, so the port counts what runs instead:
:class:`CostCounter`, a ``TorchDispatchMode``, sees every aten op of the
code run under it (a backward's included) and counts

* **flops** of products (mm, bmm, addmm, baddbmm, convolutions,
  attention) by the formulas of ``torch.utils.flop_counter``: 2·M·N·K, as
  the reference's dot flops.  Elementwise flops are not counted (the
  reference: dots dominate ≫10×).  Products with an fp32 result are also
  counted apart (``"flops fp32"`` in the summary's ``raw``): the H100 runs
  them at :data:`PEAK_FLOPS_FP32`;
* **bytes accessed**: each op's tensor operands plus its results, at their
  element sizes.  Views, ``empty`` and other metadata ops count 0.

Each hand-written kernel declares its own work (:func:`declares` on its
entry point in ``kernels/*/ops.py``): under a counter, the call counts the
kernel's ``(bytes, operations)`` once (its operations as flops) and none
of the aten ops it runs, the plain version's on the CPU or the wrapper's
allocations on the card.  So a step counts the same work on the CPU and
on the card.  A kernel's work is the formula its bound takes: each input
read once, each output written once (:func:`boundary_work`,
:func:`step_work`, :func:`flash_work`, :func:`scan_work`).

Hardware constants: H100 SXM (NVIDIA data sheet, 700 W): HBM3 at 3.35
TB/s, 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s fp32 outside
them, NVLink 450 GB/s each way.  The collective term reads 0 until the
counter counts c10d collectives (ROADMAP item 11(c2)).
"""
from __future__ import annotations

import collections
import functools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

HBM_BW = 3.35e12
PEAK_FLOPS = 989e12
PEAK_FLOPS_FP32 = 67e12
NVLINK_BW = 450e9

aten = torch.ops.aten
#: ops that move no data: allocation without a write, shape and stride
#: queries, and views the schema does not mark as such
_NO_DATA = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.empty_permuted, aten._unsafe_view,
    aten.resize_, aten.set_, aten.lift_fresh, aten.size, aten.sym_size,
    aten.stride, aten.sym_stride, aten.numel, aten.sym_numel, aten.dim,
    aten.storage_offset, aten.sym_storage_offset, aten.is_contiguous,
    aten.is_same_size, aten.is_strides_like_format,
    aten.is_non_overlapping_and_dense, aten._has_compatible_shallow_copy_type,
    torch.ops.prim.device, torch.ops.prim.layout,
}


@dataclass
class CostSummary:
    """Attribute view of a cost count (the reference's view of XLA's
    ``compiled.cost_analysis()``; here :meth:`CostCounter.summary`)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    raw: dict = field(default_factory=dict)


def cost_summary(cost) -> CostSummary:
    """Normalize a cost (dict, list-of-dicts, None or an existing
    :class:`CostSummary`) into a :class:`CostSummary`."""
    if isinstance(cost, CostSummary):
        return cost
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    cost = dict(cost or {})
    return CostSummary(
        flops=float(cost.get("flops", 0.0) or 0.0),
        bytes_accessed=float(cost.get("bytes accessed", 0.0) or 0.0),
        raw=cost,
    )


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class CostCounter(TorchDispatchMode):
    """``with CostCounter() as c: step(...)``: the flops and bytes of every
    aten op run inside, and the work each hand-written kernel declares
    (see the module docstring).  ``by_op`` holds ``[calls, flops, bytes]``
    by op name (``kernel:<name>`` for a declared kernel call)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_fp32 = 0
        self.bytes = 0
        self.by_op = collections.defaultdict(lambda: [0, 0, 0])
        self._held = 0

    def _add(self, name: str, flops: int, nbytes: int, fp32: bool) -> None:
        self.flops += flops
        self.flops_fp32 += flops if fp32 else 0
        self.bytes += nbytes
        row = self.by_op[name]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._held:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and packet not in _NO_DATA:
            # a composite op seen whole (as under inference_mode) counts
            # as the ops it decomposes into, as they would run
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if (packet in _NO_DATA or func.is_view
                or torch.Tag.inplace_view in func.tags):
            return out
        flops = 0
        fp32 = False
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
            first = next(t for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor))
            fp32 = first.dtype in (torch.float32, torch.float64)
        self._add(str(packet), flops, _nbytes((args, kwargs)) + _nbytes(out),
                  fp32)
        return out

    def declare(self, name: str, nbytes: int, ops: int, fp32: bool) -> None:
        """Count one call of the kernel ``name``: ``nbytes`` and ``ops``."""
        self._add(f"kernel:{name}", int(ops), int(nbytes), fp32)

    def summary(self) -> CostSummary:
        return cost_summary({"flops": self.flops,
                             "bytes accessed": self.bytes,
                             "flops fp32": self.flops_fp32})


def declares(name: str, work):
    """Decorator of a kernel's entry point: under every active
    :class:`CostCounter`, a call counts ``work(*args, **kwargs)``, a
    ``(bytes, operations, fp32)`` triple (``fp32``: the operations run at
    the fp32 rate), once, and none of the aten ops the call runs.  With no
    counter active, ``work`` is not evaluated."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            counters = [m for m in _get_current_dispatch_mode_stack()
                        if isinstance(m, CostCounter)]
            if not counters:
                return fn(*args, **kwargs)
            nbytes, ops, fp32 = work(*args, **kwargs)
            for c in counters:
                if not c._held:  # a kernel's own work holds what it calls
                    c.declare(name, nbytes, ops, fp32)
                c._held += 1
            try:
                return fn(*args, **kwargs)
            finally:
                for c in counters:
                    c._held -= 1
        return call
    return wrap


# ---------------------------------------------------------------------------
# The hand-written kernels' work: each input read once, each output written
# once (chip_smoke.py's bounds take the same formulas)
# ---------------------------------------------------------------------------


def boundary_work(name: str, rows: int, length: int, esize: int,
                  guidance: float):
    """(bytes, fp32 ops) a boundary kernel needs at one shape: each input
    read once, each output written once; guidance 1.0 never reads
    eps_u."""
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


def step_work(n: int, esize: int, reads: int):
    """(bytes, fp32 ops) of the interior step over ``n`` values: each of
    its ``reads`` distinct inputs read once (2 where eps_u is eps_c), x'
    written once; the combine's subtract, multiply and add and the
    update's multiply and add."""
    return (reads + 1) * n * esize, 5 * n


def flash_work(b, h, kv, s, t, d, causal, window, kv_len, esize):
    """(bytes, operations) one flash-attention call needs at these inputs:
    q read and the output written once, each key and value that some
    query attends read once; 4·D operations (two multiply-adds) per
    attended (query, key) pair."""
    q_pos, k_pos = np.arange(s)[:, None], np.arange(t)[None, :]
    mask = np.broadcast_to(k_pos < kv_len, (s, t))
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    keys = int(mask.any(axis=0).sum())
    nbytes = esize * (2 * b * h * s * d + 2 * b * kv * keys * d)
    return nbytes, 4 * d * b * h * int(mask.sum())


def scan_work(n: int):
    """(bytes, fp32 ops) of the RG-LRU scan over ``n`` values: a and b
    read once, h written once; a multiply and an add each."""
    return 3 * 4 * n, 2 * n


def bound(work, dtype=torch.float32):
    """``(ms, "bytes" | "operations")``: the least time of ``work``, a
    (bytes, ops) pair, on one H100: the larger of bytes over
    :data:`HBM_BW` and ops over the peak of ``dtype`` (bf16 on the tensor
    cores, anything else at :data:`PEAK_FLOPS_FP32`)."""
    nbytes, ops = work
    t_bytes = nbytes / HBM_BW
    t_ops = ops / (PEAK_FLOPS if dtype == torch.bfloat16 else PEAK_FLOPS_FP32)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------


def analyze(cost, n_chips: int, *, model_flops: Optional[float] = None) -> dict:
    """The reference's roofline record from a cost count (a
    :class:`CostSummary`, or what :func:`cost_summary` normalizes), per
    device, with the H100's constants.  A count's ``raw["flops fp32"]``
    part of the flops runs at :data:`PEAK_FLOPS_FP32`, the rest at
    :data:`PEAK_FLOPS`.  No collective is counted yet (ROADMAP item
    11(c2)), so the collective term over :data:`NVLINK_BW` reads 0."""
    c = cost_summary(cost)
    flops, nbytes = c.flops, c.bytes_accessed
    fp32 = float(c.raw.get("flops fp32", 0.0) or 0.0)
    coll_bytes = 0.0
    t_compute = (flops - fp32) / PEAK_FLOPS + fp32 / PEAK_FLOPS_FP32
    t_memory = nbytes / HBM_BW
    t_coll = coll_bytes / NVLINK_BW
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    out = {
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": nbytes,
        "coll_bytes_per_chip": coll_bytes,
        "coll_counts": {},
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "raw_cost_flops": flops,
        "raw_cost_bytes": nbytes,
    }
    if model_flops:
        out["model_flops_total"] = model_flops
        out["useful_flops_ratio"] = model_flops / max(flops * n_chips, 1.0)
        bound_s = max(t_compute, t_memory, t_coll)
        ideal = model_flops / (n_chips * PEAK_FLOPS)
        out["roofline_fraction"] = ideal / max(bound_s, 1e-12)
    return out


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D for training, 2·N_active·D for inference.
    ``shape``: anything with ``kind`` ("train", "prefill" or "decode"),
    ``global_batch`` and ``seq_len``, as the reference's ``ShapeSpec``."""
    from repro_torch.analysis.params import active_params

    n_act = active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_act * tokens
