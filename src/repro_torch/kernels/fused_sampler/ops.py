"""Wrappers of the sampler-step kernels of ``csrc/fused_sampler.cu``: the
CUDA kernels on CUDA tensors, the plain versions (``ref.py``) on CPU
tensors.  Replaces ``repro/kernels/fused_sampler/ops.py``:

* :func:`fused_cfg_step` — the interior step over a latent of any shape
  (nothing is padded);
* :func:`fused_cfg_step_quant` / :func:`fused_cfg_step_dequant` — the
  fused int8 boundaries over wire rows ``(..., L)`` (rows = per-sample
  channel slices, L = H·W).  Their ``coeffs`` is the (2,) fp32 vector of
  :func:`repro_torch.core.samplers.step_coeffs` on the operands' device:
  the kernels read it through a pointer, so no host sync is needed.

The emit launches what :func:`emit_plan` says (see ``csrc/fused_sampler.cu``
for the routes)."""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.analysis import roofline as rl
from repro_torch.kernels import build
from repro_torch.kernels.fused_sampler.ref import (fused_cfg_step_dequant_ref,
                                                    fused_cfg_step_quant_ref,
                                                    fused_cfg_step_ref)


@rl.declares("fused_cfg_step", lambda x, eps_c, eps_u, **kw: (*rl.step_work(
    x.numel(), x.element_size(), 2 if eps_u is eps_c else 3), True))
def fused_cfg_step(x, eps_c, eps_u, *, guidance: float = 1.0, c1: float = 1.0,
                   c2: float = 0.0, mode: str = "ddim"):
    """One interior sampler step: ε̂ = ε_u + g·(ε_c − ε_u), then "ddim" x′ =
    c1·x + c2·ε̂ or "rf" x′ = x + c1·ε̂, in fp32; returns a new tensor in
    x's dtype.  x, ε_c and ε_u share one shape and dtype (fp32 or bf16)
    and are contiguous; ε_u may be the same tensor as ε_c."""
    if mode not in build.MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {tuple(build.MODES)}")
    build.check(x, "x", build.FLOAT_DTYPES)
    build.check(eps_c, "eps_c", (x.dtype,), shape=x.shape)
    build.check(eps_u, "eps_u", (x.dtype,), shape=x.shape)
    if build.on_cpu(x, eps_c, eps_u):
        return fused_cfg_step_ref(x, eps_c, eps_u, guidance=guidance,
                                  mode=mode, c1=c1, c2=c2)
    out = torch.empty_like(x)
    if out.numel():
        build.launch(
            "fused_cfg_step", x.device, x.data_ptr(), eps_c.data_ptr(),
            eps_u.data_ptr(), build.dtype_code(x), float(guidance),
            float(c1), float(c2), build.MODES[mode], out.data_ptr(),
            out.numel(),
        )
    return out


def _check_common(eps_c, eps_u, coeffs, shape):
    build.check(eps_c, "eps_c", build.FLOAT_DTYPES, shape=shape)
    build.check(eps_u, "eps_u", (eps_c.dtype,), shape=shape)
    build.check(coeffs, "coeffs", (torch.float32,))
    if coeffs.numel() != 2:
        raise ValueError(f"coeffs: expected 2 values, got {coeffs.numel()}")


#: the emit's routes, in the kernel's numbering
EMIT_ROUTES = ("rows", "cluster", "two_pass")
#: longest row of the rows route: 32 lanes of ROW_VALUES values
ROW_MAX = 1024
#: most values a rows-route lane holds in registers
ROW_VALUES = 32
#: threads of a rows-route CTA, and of a cluster-route CTA
ROW_THREADS, CLUSTER_THREADS = 128, 256
#: CTAs of a cluster, at most (the portable limit)
MAX_CLUSTER = 8
#: CTAs the cluster size aims at: two 256-thread CTAs on each of the
#: H100's 132 SMs, all resident at once (one wave)
WAVE_CTAS = 2 * 132
#: shared memory a CTA may use on the H100 (227 KB)
SMEM_PER_CTA = 232_448
#: most stepped fp32 values a cluster-route CTA stages (224 KiB); a row
#: whose chunks exceed it over MAX_CLUSTER CTAs takes the two-pass route
STAGE_MAX = 57_344


@dataclasses.dataclass(frozen=True)
class EmitPlan:
    """How the emit kernel runs one call.

    ``vec``: elements per load (16 bytes when every pointer and the row
    pitch allow, else 8, 4, 2 bytes or one element).  ``per_thread``: the
    row's values each thread steps (rows: held in registers; cluster:
    staged in shared memory; two-pass: stepped twice).  ``threads``:
    lanes per row (rows) or threads per CTA (cluster routes).
    ``cluster``: CTAs per row.  ``onchip_bytes``: the stepped values one
    CTA holds on chip."""
    route: str
    vec: int
    per_thread: int
    threads: int
    cluster: int
    onchip_bytes: int


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=256)
def _emit_plan(rows: int, length: int, esize: int, align: int) -> EmitPlan:
    vec = max(1, align // esize)
    if length <= ROW_MAX:
        # the fewest values a lane: a whole warp per row where the row
        # fills it, loads no wider than a lane's share
        per_lane = _pow2(-(-length // 32))
        vec = min(vec, per_lane)
        group = _pow2(-(-length // per_lane))
        return EmitPlan("rows", vec, per_lane, group, 1,
                        ROW_THREADS * per_lane * 4)
    nvec = length // vec
    # double the cluster while the CTAs stay within one wave and each
    # thread keeps at least two vectors, then until a chunk fits on chip
    cluster = 1
    while (cluster < MAX_CLUSTER and rows * cluster * 2 <= WAVE_CTAS
           and nvec // (2 * cluster) >= 2 * CLUSTER_THREADS):
        cluster *= 2
    while cluster < MAX_CLUSTER and -(-nvec // cluster) * vec > STAGE_MAX:
        cluster *= 2
    chunk = -(-nvec // cluster)  # vectors a CTA takes
    per_thread = -(-chunk // CLUSTER_THREADS) * vec
    if chunk * vec > STAGE_MAX:
        return EmitPlan("two_pass", vec, per_thread, CLUSTER_THREADS, cluster, 0)
    return EmitPlan("cluster", vec, per_thread, CLUSTER_THREADS, cluster,
                    chunk * vec * 4)


def emit_plan(rows: int, length: int, dtype: torch.dtype, ptrs) -> EmitPlan:
    """The emit's launch plan for ``rows`` rows of ``length`` values of
    ``dtype`` whose operands start at the addresses ``ptrs`` (those the
    kernel reads): a pure function of these, so a CPU test can check it.

    * ``rows`` (length ≤ :data:`ROW_MAX`): each row on a group of 1–32
      lanes, each lane holding the fewest values that 32 lanes allow: at
      the wire rows (L = 64) a warp of 2 values a lane, which beat a half
      warp of 4 (``chip_smoke.py`` phase 5 times both).
    * ``cluster``: a cluster of 1–:data:`MAX_CLUSTER` CTAs per row, sized
      so that rows × cluster fills about one wave of :data:`WAVE_CTAS`
      CTAs (each thread keeping at least two vectors) and each CTA's chunk
      fits :data:`STAGE_MAX`.
    * ``two_pass``: rows longer than :data:`MAX_CLUSTER` × :data:`STAGE_MAX`
      values, on a cluster of :data:`MAX_CLUSTER`."""
    esize = dtype.itemsize
    align = 16
    while align > esize and (any(p % align for p in ptrs)
                             or length * esize % align):
        align //= 2
    return _emit_plan(rows, length, esize, align)


@rl.declares("fused_cfg_step_quant",
             lambda x, eps_c, eps_u, coeffs, guidance=1.0, **kw: (
                 *rl.boundary_work("fused_cfg_step_quant", *build.rows_of(x),
                                   x.element_size(), guidance), True))
def fused_cfg_step_quant(x, eps_c, eps_u, coeffs, *, guidance: float = 1.0,
                         mode: str = "ddim"):
    """Emit boundary: the step's output is written straight as the wire
    payload ``(q int8 shaped like x, s fp32 (..., 1))``; the stepped
    latent never reaches memory.  On CUDA tensors it launches the kernel
    as :func:`emit_plan` says."""
    if mode not in build.MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {tuple(build.MODES)}")
    if build.on_cpu(x, eps_c, eps_u, coeffs):
        return fused_cfg_step_quant_ref(x, eps_c, eps_u, coeffs,
                                        guidance=guidance, mode=mode)
    build.check(x, "x", build.FLOAT_DTYPES)
    _check_common(eps_c, eps_u, coeffs, x.shape)
    if eps_c.dtype != x.dtype:
        raise TypeError(f"eps_c: dtype {eps_c.dtype}, expected x's {x.dtype}")
    length = x.shape[-1]
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    if q.numel():
        rows = q.numel() // length
        read = (x, eps_c) if guidance == 1.0 else (x, eps_c, eps_u)
        p = emit_plan(rows, length, x.dtype, [t.data_ptr() for t in read])
        build.launch(
            "fused_cfg_step_quant", x.device, x.data_ptr(), eps_c.data_ptr(),
            eps_u.data_ptr(), build.dtype_code(x), coeffs.data_ptr(),
            float(guidance), build.MODES[mode], q.data_ptr(), s.data_ptr(),
            rows, length, EMIT_ROUTES.index(p.route), p.vec, p.per_thread,
            p.threads, p.cluster,
        )
    return q, s


@rl.declares("fused_cfg_step_dequant",
             lambda q, s, eps_c, eps_u, coeffs, guidance=1.0, **kw: (
                 *rl.boundary_work("fused_cfg_step_dequant", *build.rows_of(q),
                                   eps_c.element_size(), guidance), True))
def fused_cfg_step_dequant(q, s, eps_c, eps_u, coeffs, *,
                           guidance: float = 1.0, mode: str = "ddim"):
    """Consume boundary: the step reads the int8 payload ``(q, s)`` as its
    latent operand (dequantized in registers); returns the stepped rows in
    ε_c's dtype."""
    if mode not in build.MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {tuple(build.MODES)}")
    if build.on_cpu(q, s, eps_c, eps_u, coeffs):
        return fused_cfg_step_dequant_ref(q, s, eps_c, eps_u, coeffs,
                                          guidance=guidance, mode=mode)
    build.check(q, "q", (torch.int8,))
    build.check(s, "s", (torch.float32,), shape=q.shape[:-1] + (1,))
    _check_common(eps_c, eps_u, coeffs, q.shape)
    out = torch.empty(q.shape, dtype=eps_c.dtype, device=q.device)
    if out.numel():
        build.launch(
            "fused_cfg_step_dequant", q.device, q.data_ptr(), s.data_ptr(),
            eps_c.data_ptr(), eps_u.data_ptr(), build.dtype_code(eps_c),
            coeffs.data_ptr(), float(guidance), build.MODES[mode],
            out.data_ptr(), out.numel() // q.shape[-1], q.shape[-1],
        )
    return out
