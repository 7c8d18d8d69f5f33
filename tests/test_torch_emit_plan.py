"""The emit's launch plan (``fused_sampler/ops.py::emit_plan``) and its
plain version at long rows.

* The plan, for each shape class the kernel serves — the relay's wire rows
  (R = 4 and 32, L = 64), ragged and boundary lengths (L = 1, 5, 63, 65,
  1023, 1024, 1025, 1500), SDXL- and SD3.5-size latent rows (32 and 128
  rows of 16,384), an HBM-sized call (8192, 4096) and the longest rows (a
  cluster of 8 full, and one value past it): the route, a cluster of 1–8
  CTAs that divides the grid and covers the row, the load width against
  the alignment of every pointer and of the row pitch, the values a
  thread holds, and the on-chip bytes against the 227 KB a CTA may use.
  The CUDA kernel itself runs only on the card
  (``tests/test_torch_cuda_kernels.py``).
* The emit's plain version against the Pallas kernel in interpret mode and
  the jitted JAX oracle at long rows, (4, 4096) and (32, 16384), with
  ``test_torch_kernels.py``'s stepped-payload tolerance: ints equal but
  for counted ±1 tie flips (at most 1 %), scales within 1e-6 relative.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_sampler import ops as jfops
from repro.kernels.fused_sampler import ref as jfref
from repro_torch.kernels.fused_sampler import ops as fops
from test_torch_kernels import assert_stepped_payload

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ALIGNED = (1 << 20, 1 << 21, 1 << 22)  # three 16-byte-aligned bases
# (rows, L, route) of every shape class the kernel serves
CASES = [
    (4, 64, "rows"), (32, 64, "rows"),
    (3, 1, "rows"), (3, 5, "rows"), (3, 63, "rows"), (3, 65, "rows"),
    (3, 1023, "rows"), (3, 1024, "rows"),
    (3, 1025, "cluster"), (3, 1500, "cluster"),
    (32, 16384, "cluster"), (128, 16384, "cluster"), (8192, 4096, "cluster"),
    (1, fops.MAX_CLUSTER * fops.STAGE_MAX, "cluster"),
    (1, fops.MAX_CLUSTER * fops.STAGE_MAX + 1, "two_pass"),
]


def _check(plan, rows, length, esize, ptrs):
    assert plan.route in fops.EMIT_ROUTES
    # loads: every base pointer and the row pitch are multiples of a load
    width = plan.vec * esize
    assert plan.vec in (1, 2, 4, 8) and width <= 16
    assert all(p % width == 0 for p in ptrs) and length * esize % width == 0
    assert plan.per_thread % plan.vec == 0
    assert 0 <= plan.onchip_bytes <= fops.SMEM_PER_CTA
    if plan.route == "rows":
        # one group of 1-32 lanes covers the row, in registers
        assert plan.cluster == 1 and length <= fops.ROW_MAX
        assert plan.threads in (1, 2, 4, 8, 16, 32)
        assert plan.per_thread <= fops.ROW_VALUES
        assert plan.threads * plan.per_thread >= length
        return
    # a cluster of 1-8 CTAs per row (the grid is rows x cluster CTAs, so
    # the cluster divides it); the chunks cover the row, none is empty
    assert length > fops.ROW_MAX and plan.threads == fops.CLUSTER_THREADS
    assert plan.cluster in (1, 2, 4, 8)
    nvec = length // plan.vec
    chunk = -(-nvec // plan.cluster)
    assert chunk * plan.cluster >= nvec and chunk * (plan.cluster - 1) < nvec
    assert plan.per_thread == -(-chunk // plan.threads) * plan.vec
    staged = chunk * plan.vec * 4
    if plan.route == "cluster":  # the chunk is staged in shared memory
        assert plan.onchip_bytes == staged <= fops.STAGE_MAX * 4
    else:  # two-pass: a cluster of 8 would not hold the row on chip
        assert plan.cluster == fops.MAX_CLUSTER and staged > fops.STAGE_MAX * 4
        assert plan.onchip_bytes == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,length,route", CASES)
def test_emit_plan_routes(rows, length, route, dtype):
    plan = fops.emit_plan(rows, length, dtype, ALIGNED)
    assert plan.route == route
    _check(plan, rows, length, dtype.itemsize, ALIGNED)
    # a pure function of the shapes, the dtype and the pointers' alignment
    assert fops.emit_plan(rows, length, dtype, [p + 4096 for p in ALIGNED]) == plan


@pytest.mark.parametrize("rows,length,cluster", [
    (32, 16384, 8), (128, 16384, 2), (8192, 4096, 1), (1, 65536, 8),
    (3, 1500, 1), (1, 2048, 1)])
def test_emit_plan_cluster_fills_one_wave(rows, length, cluster):
    """The cluster grows while rows × cluster stays within one wave and
    each thread keeps two vectors (fp32, 16-byte loads)."""
    plan = fops.emit_plan(rows, length, torch.float32, ALIGNED)
    assert plan.route == "cluster" and plan.cluster == cluster
    assert rows * cluster <= max(rows, fops.WAVE_CTAS)


@pytest.mark.parametrize("dtype,offset,vec", [
    (torch.float32, 0, 4), (torch.float32, 8, 2), (torch.float32, 4, 1),
    (torch.bfloat16, 0, 8), (torch.bfloat16, 8, 4), (torch.bfloat16, 4, 2),
    (torch.bfloat16, 2, 1)])
def test_emit_plan_load_width_follows_the_pointers(dtype, offset, vec):
    """16-byte loads only when every operand's base allows them: a slice
    ``x[1:]`` of a flat buffer (``offset`` bytes off 16) takes narrower
    loads, down to one element."""
    for which in range(3):
        ptrs = [p + (offset if i == which else 0) for i, p in enumerate(ALIGNED)]
        plan = fops.emit_plan(32, 16384, dtype, ptrs)
        assert plan.vec == vec
        _check(plan, 32, 16384, dtype.itemsize, ptrs)


@pytest.mark.parametrize("length,esize_vec", [
    (16386, {4: 2, 2: 2}), (16385, {4: 1, 2: 1}), (16388, {4: 4, 2: 4})])
def test_emit_plan_load_width_follows_the_row_pitch(length, esize_vec):
    """Rows start at multiples of L·elsize: an odd L loads one element at
    a time, L ≡ 2 (mod 4) at most 8 bytes (fp32) or 4 (bf16), L ≡ 4 (mod
    8) 16 bytes (fp32) or 8 (bf16)."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = fops.emit_plan(8, length, dtype, ALIGNED)
        assert plan.vec == esize_vec[dtype.itemsize]
        _check(plan, 8, length, dtype.itemsize, ALIGNED)


def test_emit_plan_rows_route_takes_a_warp_per_wire_row():
    """At the relay's wire rows (L = 64) each row takes a whole warp, two
    values a lane, loaded 8 bytes (fp32) or 4 bytes (bf16) at a time."""
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (4, 32):
            plan = fops.emit_plan(rows, 64, dtype, ALIGNED)
            assert (plan.route, plan.threads, plan.per_thread, plan.vec) == \
                ("rows", 32, 2, 2)


_jit_quant_step_ref = jax.jit(jfref.fused_cfg_step_quant_ref,
                              static_argnames=("guidance", "mode"))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["ddim", "rf"])
@pytest.mark.parametrize("guidance", [1.0, 3.5])
@pytest.mark.parametrize("shape", [(4, 4096), (32, 16384)])
def test_emit_plain_matches_pallas_long_rows(shape, guidance, mode, dtype):
    rng = np.random.default_rng(sum(shape))
    jd, td = DTYPES[dtype]
    arrs = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    x, ec, eu = (jnp.asarray(a).astype(jd) for a in arrs)
    tx, tec, teu = (torch.from_numpy(a).to(td) for a in arrs)
    cf = np.asarray([0.4, 0.6] if mode == "ddim" else [-0.02, 0.0], np.float32)
    q, s = fops.fused_cfg_step_quant(tx, tec, teu, torch.from_numpy(cf),
                                     guidance=guidance, mode=mode)
    assert q.dtype == torch.int8 and q.shape == shape
    assert s.dtype == torch.float32 and s.shape == (shape[0], 1)
    qk, sk = jfops.fused_cfg_step_quant(x, ec, eu, jnp.asarray(cf),
                                        guidance=guidance, mode=mode,
                                        block_r=16, interpret=True)
    assert_stepped_payload(q, s, qk, sk)
    qo, so = _jit_quant_step_ref(x, ec, eu, jnp.asarray(cf).reshape(1, 2),
                                 guidance=guidance, mode=mode)
    assert_stepped_payload(q, s, qo, so)
