"""The port's CUDA kernels against their plain PyTorch versions on the
card: the interior sampler step, the boundary and quant kernels and the
RG-LRU scan bit for bit (stepped latents, payload ints, scales, stepped
rows, recurrent states) — the emit on each route of its launch plan
(``ops.emit_plan``), each load width, all-zero and subnormal rows —
flash attention
within ``FLASH_TOL`` (fp32 at
``tests/test_kernels.py``'s ``TOL``, bf16 to one ulp) and bf16 flash
attention bit for bit run to run.  Imports no JAX,
so it runs on a machine with only PyTorch and the CUDA toolkit.  It also
holds the executor's straggler re-run to its rows of the full call, bit
for bit, on the card:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

It holds the scheduler's card-side checks too: the handoff transport's
launches and error, LinUCB card against CPU bit for bit, the federation
against ``centralized_reference`` bit for bit.

Without a card every test skips (the kernels have no CPU build)."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import linucb
from repro_torch.core.policies import RisePolicy
from repro_torch.diffusion.families import load_families
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.fused_sampler.ops import (emit_plan, fused_cfg_step,
                                                   fused_cfg_step_dequant,
                                                   fused_cfg_step_quant)
from repro_torch.kernels.fused_sampler.ref import (ddim_coeffs,
                                                   fused_cfg_step_dequant_ref,
                                                   fused_cfg_step_quant_ref,
                                                   fused_cfg_step_ref)
from repro_torch.kernels.quant.ops import dequant_int8, quant_int8
from repro_torch.kernels.quant.ref import dequant_int8_ref, quant_int8_ref
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.kernels.rglru.ref import rglru_scan_ref
from repro_torch.serving.arms import build_action_space
from repro_torch.serving.executor import Executor
from repro_torch.serving.fleet import (FederatedRisePolicy, LinUCBFederation,
                                       centralized_reference)
from repro_torch.serving.runtime import HandoffTransport

CKPTS = Path(__file__).resolve().parents[1] / "results" / "ckpts"

# main-path wire rows (4 channels x batch 1 and 8, L = 8*8), ragged rows,
# and a row longer than one warp holds (the block-per-row kernel)
SHAPES = [(4, 64), (32, 64), (13, 17), (1, 5), (3, 1500)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
COEFFS = {"ddim": [0.4, 0.6], "rf": [-0.02, 0.0]}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(DTYPES[dtype]).to(device) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", sorted(COEFFS))
@pytest.mark.parametrize("guidance", [1.0, 3.5])
@pytest.mark.parametrize("shape", SHAPES)
def test_boundary_kernels_equal_plain(cuda_device, shape, guidance, mode,
                                      dtype):
    x, ec, eu = _inputs(shape, dtype, cuda_device, 5)
    cf = torch.tensor(COEFFS[mode], device=cuda_device)
    q, s = fused_cfg_step_quant(x, ec, eu, cf, guidance=guidance, mode=mode)
    qr, sr = fused_cfg_step_quant_ref(x, ec, eu, cf, guidance=guidance,
                                      mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(q, qr) and torch.equal(s, sr)
    out = fused_cfg_step_dequant(q, s, ec, eu, cf, guidance=guidance,
                                 mode=mode)
    ref = fused_cfg_step_dequant_ref(q, s, ec, eu, cf, guidance=guidance,
                                     mode=mode)
    torch.cuda.synchronize()
    assert out.dtype == ec.dtype and torch.equal(out, ref)


# the emit's routes (ops.emit_plan): the relay's wire rows (R = 4 and 32,
# L = 64) and ragged and boundary lengths on the rows route; L = 1025 and
# 1500 and SDXL- and SD3.5-size latent rows (32 and 128 rows of 16,384) on
# the cluster route; the longest row a cluster of 8 holds on chip, and one
# value longer (the two-pass route)
EMIT_SHAPES = [(4, 64), (32, 64), (3, 1), (3, 5), (3, 63), (3, 65), (3, 1023),
               (3, 1024), (3, 1025), (3, 1500), (32, 16384), (128, 16384),
               (1, 458_752), (1, 458_753)]
EMIT_ROUTE = {1024: "rows", 458_752: "cluster", 458_753: "two_pass"}


def _emit_equal(x, ec, eu, mode, guidance, device):
    cf = torch.tensor(COEFFS[mode], device=device)
    before = build.LAUNCHES["fused_cfg_step_quant"]
    q, s = fused_cfg_step_quant(x, ec, eu, cf, guidance=guidance, mode=mode)
    qr, sr = fused_cfg_step_quant_ref(x, ec, eu, cf, guidance=guidance,
                                      mode=mode)
    torch.cuda.synchronize()
    assert build.LAUNCHES["fused_cfg_step_quant"] == before + 1
    assert torch.equal(q, qr) and torch.equal(s, sr)
    return q, s


@pytest.mark.cuda
@pytest.mark.parametrize("alias", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", sorted(COEFFS))
@pytest.mark.parametrize("guidance", [1.0, 3.5])
@pytest.mark.parametrize("shape", EMIT_SHAPES)
def test_emit_equals_plain(cuda_device, shape, guidance, mode, dtype, alias):
    """q and s bit for bit, one launch a call; ``alias`` passes ε_u as ε_c
    itself."""
    x, ec, eu = _inputs(shape, dtype, cuda_device, 8)
    plan = emit_plan(*shape, x.dtype, [x.data_ptr(), ec.data_ptr()])
    if shape[1] in EMIT_ROUTE:
        assert plan.route == EMIT_ROUTE[shape[1]]
    _emit_equal(x, ec, ec if alias else eu, mode, guidance, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,offset", [("f32", 1), ("f32", 2), ("bf16", 1),
                                          ("bf16", 2), ("bf16", 4)])
@pytest.mark.parametrize("shape", [(8, 64), (4, 1500), (8, 16384), (5, 17)])
def test_emit_narrow_loads_equal_plain(cuda_device, shape, dtype, offset):
    """Slices ``buf[offset:]`` of flat buffers, whose bases lie 2, 4 or 8
    bytes off 16, and an odd L take the narrow-load plans."""
    n = shape[0] * shape[1]
    bufs = _inputs((n + offset,), dtype, cuda_device, 9)
    x, ec, eu = (b[offset:].view(shape) for b in bufs)
    esize = x.element_size()
    plan = emit_plan(*shape, x.dtype, [t.data_ptr() for t in (x, ec, eu)])
    assert plan.vec * esize < 16
    for mode in sorted(COEFFS):
        for guidance in (1.0, 3.5):
            _emit_equal(x, ec, eu, mode, guidance, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(4, 64), (4, 1500), (4, 16384)])
def test_emit_zero_and_subnormal_rows(cuda_device, shape, dtype):
    """An all-zero row takes scale 1.0 and q = 0; a row of subnormal
    magnitude sends both IEEE divisions (x̂0 and the quantize) down their
    slow path."""
    x, ec, eu = _inputs(shape, dtype, cuda_device, 10)
    for t in (x, ec, eu):
        t[0] = 0
        t[1] *= 1e-39
    assert 0 < float(x[1].float().abs().max()) < torch.finfo(torch.float32).tiny
    for mode in sorted(COEFFS):
        for guidance in (1.0, 3.5):
            q, s = _emit_equal(x, ec, eu, mode, guidance, cuda_device)
            assert float(s[0, 0]) == 1.0 and not q[0].any()
            assert 0 < float(s[1, 0]) < torch.finfo(torch.float32).tiny


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_quant_kernels_equal_plain(cuda_device, shape, dtype):
    x, _, _ = _inputs(shape, dtype, cuda_device, 6)
    x[0] = 0  # an all-zero row takes scale 1.0
    q, s = quant_int8(x)
    qr, sr = quant_int8_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert float(s[0, 0]) == 1.0
    assert torch.equal(dequant_int8(q, s), dequant_int8_ref(q, s))


@pytest.mark.cuda
def test_wrappers_refuse_bad_operands(cuda_device):
    x = torch.zeros(4, 64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        quant_int8(x.t())
    with pytest.raises(TypeError, match="dtype"):
        quant_int8(x.half())
    with pytest.raises(ValueError, match="on the CPU or all on CUDA"):
        fused_cfg_step_quant(x, x, x, torch.zeros(2))
    with pytest.raises(ValueError, match="shape"):
        fused_cfg_step_quant(x, x, x[:2], torch.zeros(2, device=cuda_device))


# the relay's latents (8 requests and a straggler's 1), ragged shapes
STEP_SHAPES = [(8, 8, 8, 4), (1, 8, 8, 4), (13, 17), (2, 5, 7, 3), (1, 5)]
STEP_COEFFS = {"ddim": ddim_coeffs(0.4, 0.6), "rf": (-0.02, 0.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("alias", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", sorted(STEP_COEFFS))
@pytest.mark.parametrize("guidance", [1.0, 3.5])
@pytest.mark.parametrize("shape", STEP_SHAPES)
def test_fused_cfg_step_equals_plain(cuda_device, shape, guidance, mode,
                                     dtype, alias):
    """One launch, bit for bit; ``alias`` passes ε_u as ε_c itself."""
    x, ec, eu = _inputs(shape, dtype, cuda_device, 7)
    eu = ec if alias else eu
    c1, c2 = STEP_COEFFS[mode]
    before = build.LAUNCHES["fused_cfg_step"]
    out = fused_cfg_step(x, ec, eu, guidance=guidance, c1=c1, c2=c2,
                         mode=mode)
    ref = fused_cfg_step_ref(x, ec, eu, guidance=guidance, c1=c1, c2=c2,
                             mode=mode)
    torch.cuda.synchronize()
    assert build.LAUNCHES["fused_cfg_step"] == before + 1
    assert out.dtype == x.dtype and torch.equal(out, ref)


@pytest.mark.cuda
def test_fused_cfg_step_refuses_bad_operands(cuda_device):
    x = torch.zeros(8, 8, 8, 4, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fused_cfg_step(x, x.transpose(1, 2), x)
    with pytest.raises(ValueError, match="on the CPU or all on CUDA"):
        fused_cfg_step(x, x, x.cpu())
    with pytest.raises(TypeError, match="dtype"):
        fused_cfg_step(x, x.to(torch.bfloat16), x)


@pytest.mark.cuda
@pytest.mark.parametrize("idx,compress", [(3, False), (8, False), (8, True)])
def test_subset_rerun_equals_full_rows(cuda_device, idx, compress):
    """A straggler re-run of 1 and of 2 rows equals its rows of the
    8-request run bit for bit (XL and F3 relays, an F3 fused twin)."""
    ex = Executor(load_families(CKPTS, device=cuda_device), device=cuda_device)
    arm = build_action_space(compress=compress)[idx]
    seeds = np.arange(8)
    full = ex.generate_bucketed(arm, seeds)
    for subset in ([5], [6, 2]):
        np.testing.assert_array_equal(
            ex.generate_bucketed(arm, seeds, subset=subset), full[subset])


# (atol, rtol): fp32 at tests/test_kernels.py's TOL; bf16 to one bf16 ulp
# (rtol 8e-3 > 2^-7) over an atol of 1e-4, as chip_smoke.py holds it
FLASH_TOL = {"f32": (2e-5, 2e-5), "bf16": (1e-4, 8e-3)}
FLASH_CASES = [
    # tests/test_kernels.py:52-58: (b, h, kv, s, t, d, causal, window, cap)
    (2, 4, 2, 64, 64, 32, True, None, None, None),
    (1, 4, 4, 40, 40, 16, True, None, 50.0, None),
    (2, 8, 2, 32, 96, 32, False, None, None, None),
    (1, 4, 1, 64, 64, 32, True, 16, None, None),
    (1, 2, 2, 16, 128, 64, True, None, None, None),
    # qwen3-4b decode at cache_pos 36 over a cache of 128, and scoring
    (8, 32, 8, 1, 128, 128, False, None, None, 37),
    (2, 32, 8, 70, 70, 128, True, None, None, None),
    # head dim 256 with everything on
    (1, 4, 2, 33, 200, 256, True, 24, 30.0, 150),
    # recurrentgemma-9b (MQA at head dim 256): ring decode, a wrapped ring
    # of 16 slots, scoring inside the window of 2048
    (8, 16, 1, 1, 128, 256, False, None, None, 37),
    (2, 16, 1, 1, 16, 256, False, None, None, 16),
    (2, 16, 1, 70, 70, 256, True, 2048, None, None),
    # decode over long caches (split KV): qwen3-4b at T = 2048 and 4096,
    # kv_len 37 leaving whole splits empty; recurrentgemma-9b's full ring
    (8, 32, 8, 1, 2048, 128, False, None, None, 37),
    (8, 32, 8, 1, 4096, 128, False, None, None, 4096),
    (8, 16, 1, 1, 2048, 256, False, None, None, 37),
    (8, 16, 1, 1, 2048, 256, False, None, None, 2048),
    # scoring with a window shorter than S (whole tiles skipped), and the
    # smallest tensor-core head dim, non-causal over a ragged kv_len
    (2, 32, 8, 70, 70, 128, True, 24, None, None),
    (2, 16, 1, 70, 70, 256, True, 24, None, None),
    (2, 8, 2, 100, 100, 64, False, None, None, 77),
    # cross-attention (non-causal, S != T): head dim 64 at a group of 1
    # and 128 at a group of 4, S 3 and 16 over T 37 and 100
    *[(b, h, kv, s, t, d, False, None, None, None)
      for (b, h, kv, d) in ((2, 2, 2, 64), (1, 8, 2, 128))
      for s in (3, 16) for t in (37, 100)],
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window,cap,kv_len", FLASH_CASES)
def test_flash_attention_matches_plain(cuda_device, b, h, kv, s, t, d, causal,
                                       window, cap, kv_len, dtype):
    rng = np.random.default_rng(s + t)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(DTYPES[dtype]).to(cuda_device)
               for shape in ((b, h, s, d), (b, kv, t, d), (b, kv, t, d)))
    kw = dict(causal=causal, window=window, softcap=cap, kv_len=kv_len)
    out = flash_attention(q, k, v, **kw)
    ref = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == ref.shape
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window,cap,kv_len", FLASH_CASES)
def test_flash_attention_bf16_is_deterministic(cuda_device, b, h, kv, s, t, d,
                                               causal, window, cap, kv_len):
    """Two calls give the same bits: the decode kernel merges its splits
    in split order, with no floating-point atomics."""
    rng = np.random.default_rng(s * t)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(torch.bfloat16).to(cuda_device)
               for shape in ((b, h, s, d), (b, kv, t, d), (b, kv, t, d)))
    kw = dict(causal=causal, window=window, softcap=cap, kv_len=kv_len)
    assert torch.equal(flash_attention(q, k, v, **kw),
                       flash_attention(q, k, v, **kw))


@pytest.mark.cuda
def test_flash_attention_takes_the_models_strided_layout(cuda_device):
    """(B, S, H, D) tensors seen as (B, H, S, D) go in without a copy; the
    output is a view of a (B, S, H, D) buffer."""
    rng = np.random.default_rng(1)
    qm, km, vm = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                  .to(cuda_device) for shape in ((2, 50, 8, 64),
                                                 (2, 50, 2, 64), (2, 50, 2, 64)))
    out = flash_attention(qm.transpose(1, 2), km.transpose(1, 2),
                          vm.transpose(1, 2))
    ref = flash_attention_ref(qm.transpose(1, 2), km.transpose(1, 2),
                              vm.transpose(1, 2))
    assert out.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


# (B, S, R): recurrentgemma-9b's scoring shape, ragged widths, one step,
# one channel, a long sequence
RGLRU_SHAPES = [(8, 128, 4096), (3, 70, 70), (1, 1, 5), (2, 1, 33),
                (1, 9, 1), (1, 4096, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RGLRU_SHAPES)
def test_rglru_scan_equals_plain(cuda_device, shape):
    rng = np.random.default_rng(sum(shape))
    a = torch.from_numpy(rng.uniform(0.3, 0.999, size=shape)
                         .astype(np.float32)).to(cuda_device)
    b = torch.from_numpy((rng.normal(size=shape) * 0.2)
                         .astype(np.float32)).to(cuda_device)
    out = rglru_scan(a, b)
    ref = rglru_scan_ref(a, b)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.equal(out, ref)


@pytest.mark.cuda
def test_rglru_scan_refuses_bad_operands(cuda_device):
    a = torch.zeros(2, 8, 4, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a.transpose(0, 1), a.transpose(0, 1))
    with pytest.raises(ValueError, match="on the CPU or all on CUDA"):
        rglru_scan(a, a.cpu())
    with pytest.raises(ValueError, match="shape"):
        rglru_scan(a, a[:, :4])


# ---------------------------------------------------------------------------
# the scheduler on the card (chip_smoke.py phase 16's checks)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_handoff_transport_on_the_card(cuda_device):
    """The round trip on the card: one quant and one dequant launch per
    family on the first call, none on a cached one; within 1e-6 of the
    CPU's error."""
    card = HandoffTransport(device=cuda_device)
    cpu = HandoffTransport(device="cpu")
    for fam in ("XL", "F3"):
        build.reset_launches()
        err = card.handoff_error(fam)
        assert build.LAUNCHES["quant_int8"] == build.LAUNCHES["dequant_int8"] == 1
        build.reset_launches()
        assert card.handoff_error(fam) == err
        assert not any(build.LAUNCHES.values())
        assert err == pytest.approx(cpu.handoff_error(fam), rel=1e-6)
    build.reset_launches()
    HandoffTransport(device=cuda_device).warm(["XL", None], boundary=True)
    assert (build.LAUNCHES["fused_cfg_step_quant"]
            == build.LAUNCHES["fused_cfg_step_dequant"] == 2)


@pytest.mark.cuda
def test_linucb_card_equals_cpu(cuda_device):
    """200 updates bit for bit, scores within 1e-5 of the largest, the
    forced branch equal."""
    rng = np.random.default_rng(0)
    card, cpu = (RisePolicy(seed=3, device=d) for d in (cuda_device, "cpu"))
    for _ in range(200):
        c = rng.random(8).astype(np.float32)
        arm, r = int(rng.integers(11)), float(rng.normal())
        card.update(c, arm, r)
        cpu.update(c, arm, r)
    for a, b in zip(card.state, cpu.state):
        assert torch.equal(a.cpu(), b)
    c = torch.from_numpy(rng.random(8).astype(np.float32))
    s_card = linucb.scores(card.state, c.to(cuda_device), card.p).cpu()
    s_cpu = linucb.scores(cpu.state, c, cpu.p)
    assert float((s_card - s_cpu).abs().max()) <= 1e-5 * float(s_cpu.abs().max())
    fresh = RisePolicy(seed=3, device=cuda_device)
    counts = np.array([3, 1, 0, 2, 0, 5, 3, 3, 1, 0, 4], np.float32)
    fresh.state = fresh.state._replace(counts=torch.from_numpy(counts)
                                       .to(cuda_device))
    avail = np.ones(11, bool)
    avail[2] = False
    assert fresh.select(np.ones(8, np.float32), avail) == 4


@pytest.mark.cuda
def test_federation_on_the_card(cuda_device):
    pols = [FederatedRisePolicy(seed=5, device=cuda_device) for _ in range(3)]
    fed = LinUCBFederation(pols)
    rng = np.random.default_rng(6)
    obs = []
    for _ in range(5):
        for p in pols:
            o = (int(rng.integers(11)), rng.random(8).astype(np.float32),
                 float(rng.normal()))
            p.update(o[1], o[0], o[2])
            obs.append(o)
        merged = fed.gossip()
    central = centralized_reference(obs, 11, 8, device=cuda_device)
    assert all(torch.equal(a, b) for a, b in zip(merged, central))
    assert all(torch.equal(a, b) for a, b in zip(merged, fed.gossip()))
