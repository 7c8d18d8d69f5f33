"""The port's analysis layer (``repro_torch/analysis``) against the JAX
package's (``repro/analysis``) on the CPU.

* ``params.py``: ``total_params``, ``active_params``, ``kv_cache_bytes``
  and ``min_bytes_estimate`` equal integers for all ten configurations;
  the analytic count within the reference's 12 % of the port's
  ``init_model`` (reduced configurations, read 0.14–2.8 %).
* ``roofline.py``: ``cost_summary`` and ``model_flops_estimate`` equal;
  :class:`CostCounter` exact on one product and on Python loops (the
  counterparts of the reference's trip-count tests); its product flops of
  a reduced forward against the reference's dot flops (``parse_hlo`` with
  ``_exec_counts`` on the jitted forward) within the reference's own 5 %
  for ``xlstm-1.3b`` and ``deepseek-v3-671b`` (read equal); for
  ``qwen3-4b`` the reference's count less the port's is 4·D per masked
  (query, key) pair per head, exactly: the reference multiplies every
  pair, the flash kernel's declared work only the attended ones.
* Each of the seven kernel wrappers, on CPU tensors under the counter,
  counts its declared work exactly and none of its plain version's ops.
* The port's device-specific branch in an LM train step's count: the
  flash kernel writes its output as (B, S, H, D), so the attention's
  ``out.transpose(1, 2).reshape(...)`` is a view on the card and a copy
  of the plain version's (B, H, S, D) output on the CPU.  Emulated here,
  the count falls by exactly that copy (``chip_smoke.py`` phase 21 (d)
  holds the card to the same difference, beside torch's own branch in
  ``F.one_hot``, which checks a CPU tensor's classes only).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.analysis import params as jparams
from repro.analysis import roofline as jrf
from repro.configs.base import SHAPES, applicable_shapes
from repro.configs.base import make_reduced as jmake_reduced
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.analysis import params
from repro_torch.analysis import roofline as rl
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.fused_sampler import ops as fops
from repro_torch.kernels.quant import ops as qops
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.models import transformer as tr
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts

torch.set_num_threads(1)

NAMES = sorted(jconfigs.list_archs())
#: the reference's own tolerances (tests/test_analysis.py)
PARAM_RTOL, FLOPS_RTOL = 0.12, 0.05
#: (batch, seq) pairs of kv_cache_bytes
CACHE_SHAPES = [(1, 1), (2, 16), (8, 4096), (128, 32768)]
ROWS, SEQ = 2, 16


def test_the_port_registers_the_reference_configurations():
    assert sorted(configs.list_archs()) == NAMES and len(NAMES) == 10


@pytest.mark.parametrize("name", NAMES)
def test_param_counts_equal_the_reference(name):
    cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
    assert params.total_params(cfg) == jparams.total_params(jcfg)
    assert params.active_params(cfg) == jparams.active_params(jcfg)
    for b, s in CACHE_SHAPES:
        assert (params.kv_cache_bytes(cfg, b, s)
                == jparams.kv_cache_bytes(jcfg, b, s)), (b, s)
    for shape in SHAPES.values():
        assert (params.min_bytes_estimate(cfg, shape)
                == jparams.min_bytes_estimate(jcfg, shape)), shape.name
    assert (params.min_bytes_estimate(cfg, SHAPES["train_4k"], 4.0)
            == jparams.min_bytes_estimate(jcfg, SHAPES["train_4k"], 4.0))


@pytest.mark.parametrize("name", NAMES)
def test_model_flops_estimate_equals_the_reference(name):
    cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
    shapes = applicable_shapes(jcfg)
    assert shapes
    for shape in shapes:
        assert (rl.model_flops_estimate(cfg, shape)
                == jrf.model_flops_estimate(jcfg, shape)), shape.name


@pytest.mark.parametrize("name", NAMES)
def test_param_formula_matches_init(name):
    """The analytic count against the parameters ``init_model`` makes
    (reduced), within the reference's tolerance for its own init."""
    cfg = configs.make_reduced(configs.get_config(name))
    model = tr.init_model(cfg, torch.Generator().manual_seed(0), "meta")
    actual = sum(p.numel() for p in model.parameters())
    analytic = params.total_params(cfg)
    assert abs(actual - analytic) / actual < PARAM_RTOL, (actual, analytic)


@pytest.mark.parametrize("cost", [
    {"flops": 3.0, "bytes accessed": 5.0, "utilization": 1.0},
    [{"flops": 7.0, "bytes accessed": 11.0}],
    [], None, {}, {"flops": None, "bytes accessed": 2.0}],
    ids=["dict", "list", "empty_list", "none", "empty_dict", "none_field"])
def test_cost_summary_normalizes_as_the_reference(cost):
    a, b = rl.cost_summary(cost), jrf.cost_summary(cost)
    assert (a.flops, a.bytes_accessed, a.raw) == (b.flops, b.bytes_accessed,
                                                  b.raw)
    assert rl.cost_summary(a) is a and jrf.cost_summary(b) is b


def test_one_matmul_is_exact():
    m, k, n = 8, 16, 4
    a, b = torch.randn(m, k), torch.randn(k, n, dtype=torch.float64)
    with rl.CostCounter() as c:
        a @ b.float()
        a.bfloat16() @ b.bfloat16()
    s = c.summary()
    assert s.flops == 2 * (2 * m * n * k)
    assert s.raw["flops fp32"] == 2 * m * n * k  # the bf16 product is not
    # the two casts of b (read fp64, write fp32 / bf16), a's cast, and the
    # two products' operands and results
    casts = (k * n * (8 + 4)) + (k * n * (8 + 2)) + m * k * (4 + 2)
    products = (m * k + k * n + m * n) * 4 + (m * k + k * n + m * n) * 2
    assert s.bytes_accessed == casts + products
    assert c.by_op["aten.mm"] == [2, s.flops, products]


def test_views_and_allocations_count_nothing():
    x = torch.randn(4, 6)
    with rl.CostCounter() as c:
        # one copy: the transpose cannot be seen flat without it
        y = x.t().reshape(24)[4:].view(5, 4).unsqueeze(0).expand(2, 5, 4)
        torch.empty(100)
        torch.empty_like(x)
    assert c.flops == 0 and y.shape == (2, 5, 4)
    assert dict(c.by_op) == {"aten.clone": [1, 0, 2 * 24 * 4]}


def test_a_loop_counts_every_iteration():
    """Eager torch runs every iteration: 8 products count 8 times, a
    nested 4 x 3 loop 12 times (the reference needs ``_exec_counts`` for
    its ``while`` bodies)."""
    m = 32
    x, w = torch.zeros(m, m), torch.zeros(m, m)
    with rl.CostCounter() as c:
        h = x
        for _ in range(8):
            h = torch.tanh(h @ w)
    assert c.flops == 8 * 2 * m ** 3
    with rl.CostCounter() as c:
        h = x
        for _ in range(4):
            g = h
            for _ in range(3):
                g = g @ w
            h = g
    assert c.flops == 12 * 2 * m ** 3 and c.by_op["aten.mm"][0] == 12


def test_a_backward_is_counted():
    x = torch.randn(8, 16, requires_grad=True)
    w = torch.randn(16, 4, requires_grad=True)
    with rl.CostCounter() as c:
        (x @ w).sum().backward()
    # the forward's product, then dx = g @ w^T and dw = x^T @ g
    assert c.flops == 3 * 2 * 8 * 16 * 4


def test_analyze_takes_the_h100_constants():
    assert (rl.HBM_BW, rl.PEAK_FLOPS, rl.PEAK_FLOPS_FP32) == (3.35e12, 989e12,
                                                              67e12)
    rec = rl.analyze({"flops": 989e12, "bytes accessed": 3.35e12}, 1,
                     model_flops=989e12)
    assert set(rec) >= {"hlo_flops_per_chip", "hlo_bytes_per_chip",
                        "coll_bytes_per_chip", "t_compute_s", "t_memory_s",
                        "t_collective_s", "dominant", "useful_flops_ratio",
                        "roofline_fraction"}
    assert rec["t_compute_s"] == 1.0 and rec["t_memory_s"] == 1.0
    assert rec["t_collective_s"] == 0.0
    assert rec["useful_flops_ratio"] == 1.0 and rec["roofline_fraction"] == 1.0
    # the fp32 part at the fp32 rate; memory-bound when bytes dominate
    rec = rl.analyze(rl.cost_summary({"flops": 2 * 67e12, "bytes accessed": 0.0,
                                      "flops fp32": 67e12}), 1)
    assert rec["t_compute_s"] == 1.0 + 67 / 989 and rec["dominant"] == "compute"
    assert rl.analyze({"flops": 1.0, "bytes accessed": 1e9}, 1)[
        "dominant"] == "memory"
    assert rl.analyze(None, 1)["dominant"] in ("compute", "memory",
                                               "collective")


def _reference_dot_flops(name: str) -> float:
    """The reference's dot flops of its jitted reduced forward over
    (ROWS, SEQ) tokens: ``parse_hlo`` with ``_exec_counts``."""
    jcfg = jmake_reduced(jconfigs.get_config(name))
    p = jax.eval_shape(lambda: jtr.init_model(jax.random.PRNGKey(0), jcfg))
    toks = jax.ShapeDtypeStruct((ROWS, SEQ), jnp.int32)
    comp = jax.jit(lambda p, t: jtr.model_fwd(p, jcfg, {"tokens": t})[0]
                   ).lower(p, toks).compile()
    comps, edges = jrf.parse_hlo(comp.as_text())
    counts = jrf._exec_counts(comps, edges)
    return sum(st.dot_flops * counts[c] for c, st in comps.items())


def _port_count(name: str) -> rl.CostCounter:
    cfg = configs.make_reduced(configs.get_config(name))
    model = tr.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (ROWS, SEQ))
    with torch.no_grad(), rl.CostCounter() as c:
        tr.model_fwd(model, cfg, {"tokens": torch.from_numpy(toks)})
    return c


@pytest.mark.parametrize("name", ["xlstm-1.3b", "deepseek-v3-671b"])
def test_product_flops_match_the_reference_dot_flops(name):
    """No kernel on these paths: every product is an aten op.  xLSTM's
    sLSTM is the reference's ``lax.scan`` (trip-corrected there) and the
    port's Python loop; deepseek's MLA and MoE experts are plain products
    on both.  Read equal on both."""
    want, c = _reference_dot_flops(name), _port_count(name)
    assert abs(c.flops - want) / want <= FLOPS_RTOL, (c.flops, want)
    assert not [k for k in c.by_op if k.startswith("kernel:")]


def test_flash_counts_attended_pairs_only():
    """``qwen3-4b``: the reference's attention multiplies every (query,
    key) pair (``repro/models/attention.py``'s two einsums, 2·D each), the
    flash kernel's declared work only the attended ones (4·D each).  The
    reference's dot flops less the port's product flops are 4·D per masked
    pair per head and row, exactly (read 61,440 at 2 x 16 tokens)."""
    name = "qwen3-4b"
    cfg = configs.make_reduced(configs.get_config(name))
    want, c = _reference_dot_flops(name), _port_count(name)
    pos = np.arange(SEQ)
    masked = 0
    for spec in tr.layer_specs(cfg):
        if spec.mixer != "attn":
            continue
        keep = pos[None, :] <= pos[:, None]
        if spec.window:
            keep &= pos[None, :] > pos[:, None] - spec.window
        masked += int((~keep).sum())
    assert masked
    assert want - c.flops == 4 * cfg.head_dim * masked * cfg.n_heads * ROWS
    assert c.by_op["kernel:flash_attention"][0] == sum(
        spec.mixer == "attn" for spec in tr.layer_specs(cfg))


def _kernel_cases():
    """(name, call, (bytes, ops)) of each wrapper on CPU tensors."""
    g = torch.Generator().manual_seed(0)
    rows, length = 6, 40

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    x, ec, eu = (rand(rows, length, dtype=torch.bfloat16) for _ in range(3))
    coeffs = torch.tensor([0.4, 0.6])
    q, s = qops.quant_int8(rand(rows, length))
    a, b = torch.rand(2, 9, 5, generator=g), rand(2, 9, 5)
    fq, fk, fv = rand(2, 4, 7, 16), rand(2, 2, 11, 16), rand(2, 2, 11, 16)
    return [
        ("fused_cfg_step",
         lambda: fops.fused_cfg_step(x, ec, ec, c1=-0.02, mode="rf"),
         rl.step_work(rows * length, 2, 2)),
        ("fused_cfg_step",
         lambda: fops.fused_cfg_step(x, ec, eu, guidance=3.5, c1=-0.02,
                                     mode="rf"),
         rl.step_work(rows * length, 2, 3)),
        ("fused_cfg_step_quant",
         lambda: fops.fused_cfg_step_quant(x, ec, eu, coeffs, guidance=3.5),
         rl.boundary_work("fused_cfg_step_quant", rows, length, 2, 3.5)),
        ("fused_cfg_step_dequant",
         lambda: fops.fused_cfg_step_dequant(q, s, ec, ec, coeffs),
         rl.boundary_work("fused_cfg_step_dequant", rows, length, 2, 1.0)),
        ("quant_int8", lambda: qops.quant_int8(x),
         rl.boundary_work("quant_int8", rows, length, 2, 1.0)),
        ("dequant_int8", lambda: qops.dequant_int8(q, s),
         rl.boundary_work("dequant_int8", rows, length, 4, 1.0)),
        ("flash_attention",
         lambda: flash_ops.flash_attention(fq, fk, fv, window=3, kv_len=9),
         rl.flash_work(2, 4, 2, 7, 11, 16, True, 3, 9, 4)),
        ("rglru_scan", lambda: rglru_scan(a, b), rl.scan_work(2 * 9 * 5)),
    ]


@pytest.mark.parametrize("case", range(8), ids=[
    "fused_cfg_step", "fused_cfg_step_guided", "fused_cfg_step_quant",
    "fused_cfg_step_dequant", "quant_int8", "dequant_int8",
    "flash_attention", "rglru_scan"])
def test_each_kernel_counts_its_declared_work(case):
    """On CPU tensors the wrapper runs the plain version; under the
    counter it counts its kernel's work alone, once."""
    name, call, (nbytes, ops) = _kernel_cases()[case]
    with rl.CostCounter() as c:
        call()
    assert dict(c.by_op) == {f"kernel:{name}": [1, ops, nbytes]}
    assert (c.flops, c.bytes, c.flops_fp32) == (ops, nbytes, ops)


def test_declared_flash_is_counted_once_and_its_backward_as_aten_ops():
    """Under autograd the forward counts the declared work; the backward,
    the plain version's VJP, counts as the aten ops it runs."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g).requires_grad_()
               for shape in ((1, 2, 5, 8), (1, 1, 5, 8), (1, 1, 5, 8)))
    with rl.CostCounter() as c:
        out = flash_ops.flash_attention(q, k, v)
    assert [n for n in c.by_op] == ["kernel:flash_attention"]
    with rl.CostCounter() as c:
        out.sum().backward()
    assert "kernel:flash_attention" not in c.by_op and c.by_op["aten.bmm"]


def _train_step_count(cfg, model) -> rl.CostCounter:
    c = opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    step = ts.make_train_step(cfg, c, remat=False)
    state = opt.adamw_init(dict(model.named_parameters()), c)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (2, ROWS, SEQ))
    batch = {k: torch.from_numpy(t) for k, t in zip(("tokens", "labels"),
                                                    toks)}
    with rl.CostCounter() as counter:
        step(model, state, batch)
    return counter


def test_flash_output_layout_explains_the_device_byte_difference(
        monkeypatch):
    """The card's flash kernel writes (B, S, H, D) and returns its (B, H,
    S, D) view; emulated on the CPU (the plain version's output copied
    into that layout inside the declared call), a reduced ``qwen3-4b``
    train step counts the same flops and, per flash call of its forward,
    2·B·S·H·D·4 bytes fewer: the copy the attention's reshape makes of the
    plain version's (B, H, S, D) output."""
    cfg = configs.make_reduced(configs.get_config("qwen3-4b"))
    model = tr.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    cpu = _train_step_count(cfg, model)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(before[n])
    plain = flash_ops._forward

    def card_layout(q, k, v, *args):
        out = plain(q, k, v, *args)
        b, h, s, d = out.shape
        return torch.empty((b, s, h, d)).transpose(1, 2).copy_(out)

    monkeypatch.setattr(flash_ops, "_forward", card_layout)
    card = _train_step_count(cfg, model)
    calls = sum(spec.mixer == "attn" for spec in tr.layer_specs(cfg))
    assert card.by_op["kernel:flash_attention"][0] == calls
    assert card.flops == cpu.flops
    assert cpu.bytes - card.bytes == calls * 2 * ROWS * SEQ * (
        cfg.n_heads * cfg.head_dim) * 4
    assert cpu.by_op["aten.clone"][2] - card.by_op["aten.clone"][2] == (
        cpu.bytes - card.bytes)


def test_rows_of():
    assert build.rows_of(torch.zeros(3, 4, 5)) == (12, 5)
    assert build.rows_of(torch.zeros(3, 0)) == (0, 0)


#: the ``kernels`` line's ``bound_ms`` as ``chip_smoke.py`` printed it
#: before its formulas moved here (H100 80GB HBM3, 700 W), at each row's
#: shape: the interior step at (8, 8, 8, 4) fp32 with eps_u = eps_c, the
#: boundaries at R = 32, L = 64 fp32 g = 1, flash at qwen3-4b's decode
#: (8, 32, 8, 1, 128, 128, bf16), the scan at (8, 128, 4096)
KERNELS_LINE_BOUND_MS = {
    "fused_cfg_step": 7.3361194029850746e-06,
    "fused_cfg_step_quant": 5.542686567164179e-06,
    "fused_cfg_step_dequant": 5.542686567164179e-06,
    "quant_int8": 3.0949253731343282e-06,
    "dequant_int8": 3.0949253731343282e-06,
    "flash_attention": 0.001291157014925373,
    "rglru_scan": 0.015024372537313433,
}


@pytest.mark.parametrize("name", sorted(KERNELS_LINE_BOUND_MS))
def test_bounds_print_what_chip_smoke_printed(name):
    if name == "fused_cfg_step":
        got = rl.bound(rl.step_work(8 * 8 * 8 * 4, 4, 2))
    elif name == "flash_attention":
        got = rl.bound(rl.flash_work(8, 32, 8, 1, 128, 128, False, None, 128,
                                     2), torch.bfloat16)
    elif name == "rglru_scan":
        got = rl.bound(rl.scan_work(8 * 128 * 4096))
    else:
        got = rl.bound(rl.boundary_work(name, 32, 64, 4, 1.0))
    assert got == (KERNELS_LINE_BOUND_MS[name], "bytes")
