"""The port's DAG relay execution against the reference, on the toy nets of
``tests/test_dag.py`` and on the trained families: the Eq. 1 speculation
model, the DAG arms, ``execute_graph`` and the executor's graph pipeline,
on the same numpy inputs (the executor fed the reference executor's own
noise).  The ``tests/test_dag.py`` cases that need no serving runtime are
copied here as cases run against the port: chain ≡ linear and the shared
pipeline cache, canonical compilation of shuffled declarations, the
speculative plan, forced reject, forced accept and the merge, and
bit-identical re-runs of the DAG arms; each that runs nets runs on both.

Tolerances (fp32 on the CPU in both frameworks):
* latents within 1e-4 relative when every hop is raw and 1e-3 when one
  is compressed (an int8 payload flips ±1 at a rounding tie, as in
  ``test_torch_relay.py``);
* bytes on the wire exact; the speculation model's floats exact;
* Select decisions equal unless the deviation lies within 1e-4 of its
  bound (a tie), and deviations and bounds within 1e-5 relative (the
  reference itself drifts by ~2e-7 between runs);
* within the port, bit for bit: a chain graph and its linear program,
  shuffled declarations, a rejected speculation and the reference chain,
  an accepted one and the speculative chain, the merge and the mean of
  its branch chains, fused and unfused boundaries, a ``subset=`` re-run
  and its rows.
"""
from __future__ import annotations

import importlib.util
from dataclasses import astuple
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import program as jprog
from repro.core import relay as jrelay
from repro.diffusion import families as jfam
from repro.serving import arms as jarms
from repro.serving.executor import Executor as JExecutor
from repro_torch.core import program as tprog
from repro_torch.core import relay as trelay
from repro_torch.core.program import (GraphEdge, GraphNode, RelayGraph,
                                      compile_plan, linear_graph,
                                      make_program)
from repro_torch.diffusion import families as tfam
from repro_torch.diffusion import synth
from repro_torch.serving import arms as tarms
from repro_torch.serving.executor import Executor
from test_torch_executor import reference_family

# one no-write-into-input recorder, shared with the card's phase 15
_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)
SharedInputs = chip_smoke.SharedInputs

# tiny tensors: one thread each, or the parallel test workers oversubscribe
# the cores many times over
torch.set_num_threads(1)

CKPTS = Path(__file__).resolve().parents[1] / "results" / "ckpts"
RAW_RTOL, COMPRESSED_RTOL = 1e-4, 1e-3
DEV_RTOL, TIE = 1e-5, 1e-4
NETS = ("toy", "trained")


def _jtoy(params, x, t, cond):
    return 0.5 * x + 0.05 * jnp.tanh(x)


def _jtoy_mid(params, x, t, cond):
    return 0.45 * x + 0.05 * jnp.tanh(x)


def _ttoy(params, x, t, cond):
    return 0.5 * x + 0.05 * torch.tanh(x)


def _ttoy_mid(params, x, t, cond):
    return 0.45 * x + 0.05 * torch.tanh(x)


def _toy_families(specs, fn, mid_fn):
    return {name: SimpleNamespace(spec=specs[name](), large_fn=fn,
                                  small_fn=fn, mid_fn=mid_fn,
                                  large_params=None, small_params=None,
                                  mid_params=None)
            for name in ("XL", "F3")}


@pytest.fixture(scope="module")
def trained():
    return ({fam: reference_family(fam, with_mid=True) for fam in ("XL", "F3")},
            tfam.load_families(CKPTS, with_mid=True, device="cpu"))


@pytest.fixture(params=NETS)
def nets(request):
    """(name, reference families, port families)."""
    if request.param == "toy":
        return ("toy", _toy_families(jfam.SPECS, _jtoy, _jtoy_mid),
                _toy_families(tfam.SPECS, _ttoy, _ttoy_mid))
    return ("trained",) + request.getfixturevalue("trained")


def _models(fams, family, role_fn, role_params):
    fam = fams[family]
    return {r: (role_fn(fam, r), role_params(fam, r))
            for r in ("large", "mid", "small")}


class Inputs:
    """One family's coordinator inputs for both frameworks: the families'
    role models, a seeded latent and the synthetic prompts' conditioning
    (which the toy nets ignore)."""

    def __init__(self, nets, family, seed, n=2):
        _, fams_j, fams_t = nets
        self.spec_j, self.spec_t = fams_j[family].spec, fams_t[family].spec
        self.models_j = _models(fams_j, family, jfam.role_fn, jfam.role_params)
        self.models_t = _models(fams_t, family, tfam.role_fn, tfam.role_params)
        self.x = np.random.default_rng(seed).normal(
            size=(n, 8, 8, 4)).astype(np.float32)
        self.cond = synth.batch(np.arange(n) + 20 + seed,
                                family)[2].astype(np.float32)

    def port(self, graph, coordinator=None, **kw):
        run = coordinator or trelay.execute_graph
        return run(self.spec_t, graph, self.models_t,
                   torch.from_numpy(self.x), torch.from_numpy(self.cond), **kw)

    def reference(self, graph, **kw):
        out, info = jrelay.execute_graph(
            self.spec_j, graph, self.models_j, jnp.asarray(self.x),
            jnp.asarray(self.cond), **kw)
        return np.asarray(out), info


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _dev_close(a, b):
    assert float(a) == pytest.approx(float(b), rel=DEV_RTOL, abs=1e-9)


def assert_joins_match(joins_t, joins_j):
    """Join records equal the reference's: a Merge's inputs; a Select's
    bound and deviation within 1e-5 relative, its decision equal unless
    the deviation ties the bound."""
    assert len(joins_t) == len(joins_j)
    for jt, jj in zip(joins_t, joins_j):
        assert (jt["node"], jt["kind"]) == (jj["node"], jj["kind"])
        if jt["kind"] == "merge":
            assert jt["inputs"] == jj["inputs"]
            continue
        _dev_close(jt["bound_pct"], jj["bound_pct"])
        _dev_close(jt["deviation_pct"], jj["deviation_pct"])
        if abs(jj["deviation_pct"] - jj["bound_pct"]) > TIE * jj["bound_pct"]:
            assert (jt["winner"], jt["accepted"]) == \
                (jj["winner"], jj["accepted"])


def assert_matches_reference(out_t, info_t, out_j, info_j, compressed):
    assert out_t.shape == out_j.shape
    assert _rel(out_t.numpy(), out_j) <= (COMPRESSED_RTOL if compressed
                                          else RAW_RTOL)
    assert info_t["transfer_bytes"] == info_j["transfer_bytes"]
    assert [h["transfer_bytes"] for h in info_t["hops"]] == \
        [h["transfer_bytes"] for h in info_j["hops"]]
    assert [h["edge"] for h in info_t["hops"]] == \
        [h["edge"] for h in info_j["hops"]]
    for ht, hj in zip(info_t["hops"], info_j["hops"]):
        _dev_close(ht["deviation_pct"], hj["deviation_pct"])
    _dev_close(info_t["handoff_deviation_pct"], info_j["handoff_deviation_pct"])
    assert info_t["phases"] == info_j["phases"]
    assert info_t["segment_steps"] == info_j["segment_steps"]
    assert_joins_match(info_t["joins"], info_j["joins"])


def _both(make, *args, **kw):
    """(port graph, reference graph) from the same builder of each arms
    module (``make`` is the builder's name)."""
    return getattr(tarms, make)(*args, **kw), getattr(jarms, make)(*args, **kw)


# ---------------------------------------------------------------------------
# the DAG arms and the speculation model
# ---------------------------------------------------------------------------


def _graph_tuple(g):
    if isinstance(g, (tprog.RelayGraph, jprog.RelayGraph)):
        return (g.family, tuple(astuple(n) for n in g.nodes),
                tuple(astuple(e) for e in g.edges))
    return (g.family, tuple(astuple(s) for s in g.segments),
            tuple(astuple(h) for h in g.handoffs))


def test_dag_arms_equal_reference():
    """Labels, order, programs (segments, sigma-matched entries, handoff
    sigmas, Select bounds), pools and compiled plans of the 15-arm DAG
    space and the 17-arm cascade space equal the reference's."""
    for space in ("dag_action_space", "cascade_action_space"):
        port, ref = getattr(tarms, space)(), getattr(jarms, space)()
        assert [(a.idx, a.label) for a in port] == \
            [(a.idx, a.label) for a in ref]
        for a_t, a_j in zip(port, ref):
            assert _graph_tuple(a_t.program) == _graph_tuple(a_j.program)
            assert tarms.pools_used(a_t) == jarms.pools_used(a_j)
            assert (a_t.family, a_t.relay_step, a_t.edge_pool,
                    a_t.device_pool, a_t.n_hops) == \
                (a_j.family, a_j.relay_step, a_j.edge_pool, a_j.device_pool,
                 a_j.n_hops)
            assert a_t.program.shape_key() == a_j.program.shape_key()
    assert len(tarms.dag_action_space()) == 15
    assert tarms.POOL_REPLICAS == jarms.POOL_REPLICAS
    assert (tarms.DEFAULT_SPECULATIVE, tarms.DEFAULT_ENSEMBLES,
            tarms.DEFAULT_CASCADES) == (jarms.DEFAULT_SPECULATIVE,
                                        jarms.DEFAULT_ENSEMBLES,
                                        jarms.DEFAULT_CASCADES)
    for a_t, a_j in zip(tarms.dag_action_space()[11:],
                        jarms.dag_action_space()[11:]):
        p_t, p_j = compile_plan(a_t.program), jprog.compile_plan(a_j.program)
        assert (p_t.order, p_t.groups, p_t.source, p_t.sink, p_t.is_chain) \
            == (p_j.order, p_j.groups, p_j.source, p_j.sink, p_j.is_chain)
        assert {k: astuple(v) for k, v in p_t.selects.items()} == \
            {k: astuple(v) for k, v in p_j.selects.items()}
    with pytest.raises(ValueError, match="s_spec"):
        tarms.speculative_program("XL", 10, 10)


def test_speculation_model_equals_reference():
    """The Eq. 1 speculation model gives the reference's floats exactly."""
    assert (tprog.SPEC_GAMMA, tprog.SPEC_DECAY, tprog.SPEC_BOUND_REL) == \
        (jprog.SPEC_GAMMA, jprog.SPEC_DECAY, jprog.SPEC_BOUND_REL)
    rng = np.random.default_rng(0)
    for _ in range(200):
        base, gap, cx = (float(v) for v in rng.uniform(0, [3, 1, 1]))
        verify = int(rng.integers(0, 30))
        assert tprog.speculative_deviation_pct(base, gap, verify, cx) == \
            jprog.speculative_deviation_pct(base, gap, verify, cx)
    for family, s, s_spec in tarms.DEFAULT_SPECULATIVE:
        for bound in (None, 0.0, 2.5, 1e9):
            g_t, g_j = _both("speculative_program", family, s, s_spec,
                             bound_pct=bound)
            p_t, p_j = compile_plan(g_t), jprog.compile_plan(g_j)
            node_t = p_t.nodes[p_t.index["select"]]
            node_j = p_j.nodes[p_j.index["select"]]
            for base, cx in [(0.4, 0.05), (0.4, 0.95), (1.5, 0.5),
                             (0.01, 0.0), (0.6546850562095643, 0.3)]:
                assert tprog.select_outcome(p_t, "select", cx, base) == \
                    jprog.select_outcome(p_j, "select", cx, base)
                assert tprog.select_bound_pct(node_t, base) == \
                    jprog.select_bound_pct(node_j, base)


def test_speculative_deviation_model_properties():
    base = 0.4
    dev = tprog.speculative_deviation_pct
    # contracts toward the base as the candidate refines (Fig. 2 decay)
    devs = [dev(base, 0.5, v, 0.5) for v in range(6)]
    assert all(b < a for a, b in zip(devs, devs[1:]))
    assert devs[1] == pytest.approx(devs[0] * tprog.SPEC_DECAY)
    # grows with skipped-step fraction and prompt complexity
    assert dev(base, 0.8, 0, 0.5) > dev(base, 0.2, 0, 0.5)
    assert dev(base, 0.5, 0, 0.9) > dev(base, 0.5, 0, 0.1)
    # zero gap or zero complexity: no inflation at verify time 0
    assert dev(base, 0.0, 0, 0.7) == base
    assert dev(base, 0.7, 0, 0.0) == base
    assert dev(base, 0.5, 0, 0.5) == base * (1 + tprog.SPEC_GAMMA * 0.5 * 0.5)


def test_select_outcome_matches_model_and_bound_modes():
    plan = compile_plan(tarms.speculative_program("XL", 20, 10))
    sel = plan.selects["select"]
    node = plan.nodes[plan.index["select"]]
    for base, cx in [(0.4, 0.05), (0.4, 0.95), (1.5, 0.5), (0.01, 0.0)]:
        acc, dev, bound = tprog.select_outcome(plan, "select", cx, base)
        assert dev == tprog.speculative_deviation_pct(
            base, sel.gap_frac, sel.verify_steps, cx)
        assert bound == tprog.select_bound_pct(node, base) == \
            tprog.SPEC_BOUND_REL * base
        assert acc == (dev <= bound)
        assert tprog.select_outcome(plan, "select", cx, base) == \
            (acc, dev, bound)
    plan2 = compile_plan(tarms.speculative_program("XL", 20, 10,
                                                   bound_pct=2.5))
    assert tprog.select_outcome(plan2, "select", 0.5, 0.4)[2] == 2.5


def test_speculative_plan_structure():
    """The compiled speculative twin-hop: canonical order with the source
    first, the select metadata derived from the graph."""
    plan = compile_plan(tarms.speculative_program("XL", 20, 10))
    assert plan.order == ("edge", "device~spec", "edge+", "device", "select")
    assert plan.order[0] == plan.source == "edge"
    assert plan.sink == "select"
    assert not plan.is_chain
    sel = plan.selects["select"]
    assert sel.reference == "device" and sel.candidates == ("device~spec",)
    assert sel.gate == "edge+"
    assert sel.skip_on_accept == frozenset({"device"})
    assert sel.gap_frac == pytest.approx((20 - 10) / 20)
    ds = plan.graph.node("device~spec").segment
    d = plan.graph.node("device").segment
    assert sel.verify_steps == d.start - ds.start > 0


# ---------------------------------------------------------------------------
# execute_graph
# ---------------------------------------------------------------------------

CHAINS = {
    "XL_relay_10": ("XL", [("large", "sdxl", 10), ("small", "vega", None)]),
    "F3_relay_25": ("F3", [("large", "sd3l", 25), ("small", "sd3m", None)]),
    "XL_cascade_10_15": ("XL", [("large", "sdxl", 10), ("mid", "ssd1b", 15),
                                ("small", "vega", None)]),
}
MODES = ("raw", "unfused", "fused")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_chain_graph_equals_linear_program(nets, chain, mode):
    """execute_graph over the bridged chain is execute_program's op
    sequence: the same bits, bytes and deviation; and both within the
    tolerances of the reference's execute_graph."""
    family, route = CHAINS[chain]
    fused = mode == "fused"
    prog = make_program(tfam.SPECS[family](), route, compress=mode != "raw")
    graph = linear_graph(prog)
    assert compile_plan(graph).is_chain
    assert graph.shape_key() == prog.shape_key()
    inp = Inputs(nets, family, seed=len(chain))
    lin, info_l = inp.port(prog, trelay.execute_program, fused_boundary=fused)
    dag, info_g = inp.port(graph, fused_boundary=fused)
    assert torch.equal(dag, lin)
    assert info_g["transfer_bytes"] == info_l["transfer_bytes"]
    assert torch.equal(info_g["handoff_deviation_pct"],
                       info_l["handoff_deviation_pct"])
    assert info_g["joins"] == []
    j_prog = jprog.make_program(jfam.SPECS[family](), route,
                                compress=mode != "raw")
    out_j, info_j = inp.reference(jprog.linear_graph(j_prog),
                                  fused_boundary=fused)
    assert_matches_reference(dag, info_g, out_j, info_j, mode != "raw")


GRAPHS = {
    "XL_spec_20_10": ("speculative_program", "XL", 20, 10),
    "F3_spec_20_10": ("speculative_program", "F3", 20, 10),
    "XL_ensemble_10": ("ensemble_program", "XL", 10),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_shuffled_declarations_compile_identically(nets, name):
    """Seeded node/edge shuffles compile to the identical canonical order,
    groups, edge order and shape key, and run to the same bits; the run
    is within the tolerances of the reference's."""
    g, g_j = _both(*GRAPHS[name])
    plan = compile_plan(g)
    inp = Inputs(nets, g.family, seed=3)
    ref, ref_info = inp.port(g)
    for seed in (0, 1, 2, 3):
        rng = np.random.default_rng(seed)
        nodes, edges = list(g.nodes), list(g.edges)
        rng.shuffle(nodes)
        rng.shuffle(edges)
        shuffled = RelayGraph(g.family, tuple(nodes), tuple(edges))
        plan_s = compile_plan(shuffled)
        assert plan_s.order == plan.order
        assert plan_s.groups == plan.groups
        assert plan_s.edge_order == plan.edge_order
        assert shuffled.shape_key() == g.shape_key()
        out, info = inp.port(shuffled)
        assert torch.equal(out, ref)
        assert info["joins"] == ref_info["joins"]
    assert_matches_reference(ref, ref_info, *inp.reference(g_j), True)


def _sub_chain(g, keep):
    """The nodes ``keep`` of a DAG and the edges among them, as a chain."""
    nodes = tuple(GraphNode(n.nid, segment=n.segment) for n in g.nodes
                  if n.nid in keep)
    edges = tuple(GraphEdge(e.src, e.dst, e.handoff) for e in g.edges
                  if e.src in keep and e.dst in keep)
    return RelayGraph(g.family, nodes, edges)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("case", ["reject", "accept", "merge"])
def test_select_and_merge_semantics(nets, case, fused):
    """bound_pct = 0 forces a reject: bitwise the reference chain (edge →
    edge+ → device, its compressed hop included).  A huge bound forces an
    accept: bitwise the speculative chain (edge → device~spec).  The
    ensemble's Merge is bitwise the mean of its two branch chains.  Each
    within the tolerances of the reference's execute_graph."""
    if case == "merge":
        g, g_j = _both("ensemble_program", "XL", 10)
    else:
        g, g_j = _both("speculative_program", "XL", 20, 10,
                       bound_pct=0.0 if case == "reject" else 1e9)
    inp = Inputs(nets, "XL", seed={"reject": 4, "accept": 5, "merge": 6}[case])
    out, info = inp.port(g, fused_boundary=fused)
    (j,) = info["joins"]
    if case == "merge":
        a, _ = inp.port(_sub_chain(g, ("edge", "device")),
                        fused_boundary=fused)
        b, _ = inp.port(_sub_chain(g, ("edge", "refine")),
                        fused_boundary=fused)
        assert torch.equal(out, (a + b) / 2.0)
        assert j["kind"] == "merge" and j["inputs"] == ["device", "refine"]
    elif case == "reject":
        ref, _ = inp.port(_sub_chain(g, ("edge", "edge+", "device")),
                          fused_boundary=fused)
        assert torch.equal(out, ref)
        assert j["accepted"] is False and j["winner"] == "device"
        assert j["deviation_pct"] > j["bound_pct"] == 0.0
    else:
        cand, _ = inp.port(_sub_chain(g, ("edge", "device~spec")),
                           fused_boundary=fused)
        assert torch.equal(out, cand)
        assert j["accepted"] is True and j["winner"] == "device~spec"
        assert j["deviation_pct"] <= j["bound_pct"]
    assert_matches_reference(out, info,
                             *inp.reference(g_j, fused_boundary=fused), True)


def test_execute_graph_fused_equals_unfused_and_traces(nets):
    """Fused and unfused boundaries give the same bits on every DAG arm;
    capture_traj records one trajectory per segment node."""
    for arm in tarms.dag_action_space()[11:]:
        inp = Inputs(nets, arm.program.family, seed=arm.idx)
        out_u, info_u = inp.port(arm.program, capture_traj=True)
        out_f, info_f = inp.port(arm.program, fused_boundary=True)
        assert torch.equal(out_u, out_f), arm.label
        assert info_u["transfer_bytes"] == info_f["transfer_bytes"]
        assert info_u["joins"] == info_f["joins"]
        assert [t.shape[0] for t in info_u["trajs"]] == \
            info_u["segment_steps"]
        assert [h["x_out"] is None for h in info_f["hops"]] == \
            [True] * len(info_f["hops"])


# ---------------------------------------------------------------------------
# the executor's graph pipeline
# ---------------------------------------------------------------------------


def _reference_noise(ex_j, arm_j, seeds):
    """The reference executor's per-sample noise and conditioning for the
    padded bucket of ``seeds`` (as its ``generate_bucketed`` draws them)."""
    b = 1 << max(len(seeds) - 1, 0).bit_length()
    seeds = np.concatenate([seeds, np.repeat(seeds[-1:], b - len(seeds))])
    _, _, cond = synth.batch(seeds, arm_j.family)
    base = jax.random.PRNGKey(arm_j.idx * 7919)
    keys = jax.vmap(lambda s: jax.random.fold_in(base, s))(
        jnp.asarray(seeds, jnp.int32))
    noise = ex_j._noise_fn((8, 8, 4), True)(keys, jnp.asarray(cond))
    return torch.from_numpy(np.array(noise)), cond


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_dag_arms_execute_and_rerun_bit_identically(nets, fused):
    """DAG arms run through the graph pipeline with the bucketed-seeding
    contract of linear arms: a ``subset=`` re-run equals its rows bit for
    bit (the Select is decided once over the whole bucket, which the
    re-run repeats); on the reference executor's noise, the pipeline is
    within the tolerances of the reference executor."""
    _, fams_j, fams_t = nets
    arms_t, arms_j = tarms.dag_action_space(), jarms.dag_action_space()
    ex = Executor(fams_t, arms=arms_t, fused_boundary=fused, device="cpu")
    ex_j = JExecutor(fams_j, arms=arms_j, fused_boundary=fused)
    seeds = np.arange(5) + 11
    for arm, arm_j in zip(arms_t[11:], arms_j[11:]):
        out = ex.generate_bucketed(arm, seeds)
        assert out.shape == (5, 8, 8, 4) and np.isfinite(out).all()
        part = ex.generate_bucketed(arm, seeds, subset=[0, 2])
        np.testing.assert_array_equal(part, out[[0, 2]], err_msg=arm.label)
        out_j = ex_j.generate_bucketed(arm_j, seeds)
        noise, cond = _reference_noise(ex_j, arm_j, seeds)
        out_t = ex.run(arm, noise, cond).numpy()[:5]
        assert _rel(out_t, out_j) <= COMPRESSED_RTOL, arm.label


def test_fused_and_unfused_pipelines_give_the_same_bits(nets):
    _, _, fams_t = nets
    arms = tarms.dag_action_space()
    ex_f = Executor(fams_t, arms=arms, device="cpu")
    ex_u = Executor(fams_t, arms=arms, fused_boundary=False, device="cpu")
    seeds = np.arange(3) + 40
    for arm in arms[11:]:
        np.testing.assert_array_equal(ex_f.generate_bucketed(arm, seeds),
                                      ex_u.generate_bucketed(arm, seeds),
                                      err_msg=arm.label)


def test_pipeline_equals_execute_graph(nets):
    """The graph pipeline and execute_graph agree bit for bit on a forced
    reject, a forced accept and the merge (where the two coordinators'
    path-deviation accounting cannot differ in the output)."""
    _, _, fams_t = nets
    graphs = [tarms.speculative_program("XL", 20, 10, bound_pct=b)
              for b in (0.0, 1e9)] + [tarms.ensemble_program("XL", 10)]
    arms = tuple(tarms.Arm(k, g, f"g{k}") for k, g in enumerate(graphs))
    for fused in (False, True):
        ex = Executor(fams_t, arms=arms, fused_boundary=fused, device="cpu")
        for arm in arms:
            inp = Inputs(nets, "XL", seed=9)
            out, _ = inp.port(arm.program, fused_boundary=fused)
            assert torch.equal(ex.run(arm, torch.from_numpy(inp.x),
                                      inp.cond), out), arm.label


def test_chain_graph_arms_share_executor_cache(nets):
    """An arm wrapping a chain RelayGraph normalizes to the linear program
    inside the executor: the same bits and not one extra pipeline (the 11
    arms have 3 shapes)."""
    _, _, fams_t = nets
    twins = tuple(tarms.Arm(a.idx, linear_graph(a.program), a.label)
                  for a in tarms.ARMS)
    ex = Executor(fams_t, arms=tarms.ARMS + twins, device="cpu")
    seeds = np.arange(4) + 100
    for legacy in tarms.ARMS:
        ex.generate_bucketed(legacy, seeds)
    assert len(ex._pipelines) == 3
    for legacy, twin in zip(tarms.ARMS, twins):
        np.testing.assert_array_equal(ex.generate_bucketed(twin, seeds),
                                      ex.generate_bucketed(legacy, seeds),
                                      err_msg=legacy.label)
    assert len(ex._pipelines) == 3


def test_quality_table_and_generate_on_dag_arms(trained, monkeypatch):
    """``generate`` and ``quality_table`` over the DAG arms, on the
    reference's batch noise, against the reference executor."""
    fams_j, fams_t = trained
    arms_t, arms_j = tarms.dag_action_space(), jarms.dag_action_space()
    seeds = np.arange(3) + 50
    qt_j = JExecutor(fams_j, arms=arms_j).quality_table(seeds,
                                                        arms=arms_j[11:])
    ex = Executor(fams_t, arms=arms_t, device="cpu")

    def reference_noise(arm, seeds, per_sample):  # generate()'s batch key
        key = jax.random.PRNGKey(int(seeds[0]) * 7919 + arm.idx)
        return torch.from_numpy(np.array(
            jax.random.normal(key, (len(seeds), 8, 8, 4))))

    monkeypatch.setattr(ex, "noise", reference_noise)
    qt_t = ex.quality_table(seeds, arms=arms_t[11:])
    for i in range(len(seeds)):
        for arm in arms_t[11:]:
            m_t, m_j = qt_t[i, arm.idx], qt_j[i, arm.idx]
            assert m_t.keys() == m_j.keys()
            for k in m_t:
                assert m_t[k] == pytest.approx(m_j[k], rel=1e-3, abs=1e-4), k
        assert qt_t[i, 0] is None
    gen = ex.generate(arms_t[12], seeds)
    assert gen.shape == (3, 8, 8, 4) and np.isfinite(gen).all()


# ---------------------------------------------------------------------------
# shared inputs and validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_shared_inputs_keep_their_bits(nets, fused):
    """No segment function, hop or merge writes into its input.  The
    ensemble's edge output — one payload both branches consume (fused), or
    one latent both hops round-trip (unfused) — keeps its bits after every
    consumer has run, in execute_graph and in the executor's pipeline; and
    one initial latent, fed to the source nodes of several plans in turn
    (a plan has one source), keeps its bits through all of them."""
    _, _, fams_t = nets
    g = tarms.ensemble_program("XL", 10)
    inp = Inputs(nets, "XL", seed=7)
    x0 = torch.from_numpy(inp.x)
    before = x0.clone()
    kind = "payload" if fused else "latent"
    with SharedInputs() as rec:
        inp.port(g, fused_boundary=fused)
    assert rec.readers(kind) == 2
    ex = Executor(fams_t, arms=(tarms.Arm(0, g, "ens"),),
                  fused_boundary=fused, device="cpu")
    with SharedInputs() as rec:
        ex.run(ex.arms[0], x0, inp.cond)
    assert rec.readers(kind) == 2
    spec = tarms.speculative_program("XL", 20, 10)
    for plan in (spec, _sub_chain(spec, ("edge", "edge+", "device")),
                 _sub_chain(spec, ("edge", "device~spec"))):
        inp.port(plan, fused_boundary=fused)
    assert torch.equal(x0, before)


def test_validation_errors(nets):
    """The reference's refusals: too few steps to consume and emit a
    fused boundary (execute_graph and the pipeline, before any cache
    hit), a mid node on a family without mid weights, and capture_traj
    with fused_boundary."""
    _, _, fams_t = nets
    hop = tprog.Handoff(1.0, 1.0, compress=True)
    seg = tprog.RelaySegment
    short = RelayGraph("XL", (
        GraphNode("a", segment=seg("large", "sdxl", 0, 10)),
        GraphNode("b", segment=seg("mid", "ssd1b", 10, 11)),
        GraphNode("c", segment=seg("small", "vega", 12, 25)),
        GraphNode("d", segment=seg("small", "vega", 8, 25)),
        GraphNode("m", kind=tprog.MERGE_NODE),
    ), (GraphEdge("a", "b", hop), GraphEdge("b", "c", hop),
        GraphEdge("a", "d", hop), GraphEdge("c", "m"), GraphEdge("d", "m")))
    inp = Inputs(nets, "XL", seed=1)
    with pytest.raises(ValueError, match="graph node b has too few steps "
                       "to both consume and emit a fused boundary"):
        inp.port(short, fused_boundary=True)
    inp.port(short)  # unfused, a 1-step node is fine
    ok = tarms.ensemble_program("XL", 10)
    ex = Executor(fams_t, arms=(tarms.Arm(0, ok, "ok"),
                                tarms.Arm(1, short, "short")), device="cpu")
    ex.generate_bucketed(ex.arms[0], np.arange(2))
    with pytest.raises(ValueError, match="graph node b has too few steps"):
        ex.generate_bucketed(ex.arms[1], np.arange(2))
    Executor(fams_t, arms=ex.arms, fused_boundary=False,
             device="cpu").generate_bucketed(ex.arms[1], np.arange(2))
    with pytest.raises(ValueError, match="incompatible with capture_traj"):
        inp.port(ok, fused_boundary=True, capture_traj=True)
    if nets[0] == "trained":
        from dataclasses import replace

        no_mid = {k: replace(f, mid_params=None) for k, f in fams_t.items()}
        with pytest.raises(ValueError, match="no trained mid-size stage"):
            Executor(no_mid, arms=ex.arms, device="cpu").generate_bucketed(
                ex.arms[0], np.arange(2))
