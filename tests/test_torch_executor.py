"""The port's ``Executor`` against the reference executor on the trained
families: pipelines fed the reference executor's own noise, raw and
compressed (fused and unfused) arms of both families; ``quality_table``
on the same noise; and the port's own contracts — per-sample noise makes
``generate_bucketed`` rows independent of bucket and companions, so a
``subset=`` re-run equals the full call's rows bit for bit.

Tolerances as in ``test_torch_relay.py``: final latents within 1e-4
relative for raw arms and 1e-3 for compressed ones (counted int8 tie
flips at the boundary); quality metrics within 1e-3 relative.
"""
from __future__ import annotations

from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.program import make_program as j_make_program
from repro.diffusion import families as jfam
from repro.models import diffusion_nets as jdn
from repro.serving import arms as jarms
from repro.serving.executor import Executor as JExecutor
from repro.training import checkpoint as jck
from repro_torch.core.program import make_program
from repro_torch.diffusion import families as tfam
from repro_torch.diffusion import synth
from repro_torch.launch.serve import serve
from repro_torch.serving import arms as tarms
from repro_torch.serving.executor import Executor, bucketize

# tiny tensors: one thread each, or the parallel test workers oversubscribe
# the cores many times over
torch.set_num_threads(1)

CKPTS = Path(__file__).resolve().parents[1] / "results" / "ckpts"
RAW_RTOL, COMPRESSED_RTOL = 1e-4, 1e-3
# the s=15 relay of each family (index in the 11-arm space), raw and
# compressed with fused and unfused boundaries
ARM_CASES = [(idx, mode) for idx in (3, 8)
             for mode in ("raw", "fused", "unfused")]


def reference_family(fam, with_mid=False):
    """The reference family, its weights read by the JAX package's own
    checkpoint code (``repro.training.checkpoint.restore``)."""
    def like(role):
        return jax.eval_shape(lambda: jdn.init_net(
            jax.random.PRNGKey(0), jfam.NET_CONFIGS[(fam, role)]))

    pair, _ = jck.restore(CKPTS / f"diffusion_{fam}.ckpt",
                          {"large": like("large"), "small": like("small")})
    mid = None
    if with_mid:
        mid = jck.restore(CKPTS / f"diffusion_{fam}_mid.ckpt",
                          {"mid": like("mid")})[0]["mid"]
    return jfam.make_family(fam, pair["large"], pair["small"], mid_params=mid)


@pytest.fixture(scope="module")
def families():
    return ({fam: reference_family(fam, with_mid=True) for fam in ("XL", "F3")},
            tfam.load_families(CKPTS, with_mid=True, device="cpu"))


def _arms(idx, compress):
    """(reference arm, port arm) of one action-space slot."""
    a_j = jarms.ARMS[idx]
    if compress:
        prog = a_j.program
        a_j = jarms.Arm(idx, j_make_program(
            jarms._spec(prog.family),
            [(s.model, s.pool, s.steps) for s in prog.segments[:-1]]
            + [(prog.segments[-1].model, prog.segments[-1].pool, None)],
            compress=True), a_j.label)
    return a_j, tarms.build_action_space(compress=compress)[idx]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("idx,mode", ARM_CASES)
def test_pipeline_on_reference_noise(families, idx, mode):
    ref, port = families
    compress, fused = mode != "raw", mode != "unfused"
    a_j, a_t = _arms(idx, compress)
    seeds = np.arange(4) + 30
    ex_j = JExecutor(ref, fused_boundary=fused)
    out_j = ex_j.generate_bucketed(a_j, seeds)
    # the reference executor's own per-sample noise for those seeds
    _, _, cond = synth.batch(seeds, a_j.family)
    base = jax.random.PRNGKey(a_j.idx * 7919)
    keys = jax.vmap(lambda s: jax.random.fold_in(base, s))(
        jnp.asarray(seeds, jnp.int32))
    noise = ex_j._noise_fn((8, 8, 4), True)(keys, jnp.asarray(cond))
    ex_t = Executor(port, fused_boundary=fused, device="cpu")
    out_t = ex_t.run(a_t, torch.from_numpy(np.array(noise)), cond)
    assert out_t.shape == out_j.shape
    assert _rel(out_t, out_j) <= (COMPRESSED_RTOL if compress else RAW_RTOL)


@pytest.mark.parametrize("fam", ["XL", "F3"])
def test_cascade_on_reference_noise(families, fam):
    """A compressed 3-hop L→M→S cascade (two fused boundaries, the mid
    segment consuming and emitting) against the reference executor."""
    ref, port = families
    route = [("large", "p0", 10), ("mid", "p1", 10), ("small", "p2", None)]
    a_j = jarms.Arm(11, j_make_program(jarms._spec(fam), route,
                                       compress=True), "cascade")
    a_t = tarms.Arm(11, make_program(tfam.SPECS[fam](), route, compress=True),
                    "cascade")
    seeds = np.arange(2) + 60
    ex_j = JExecutor(ref, arms=jarms.cascade_action_space())
    out_j = ex_j.generate_bucketed(a_j, seeds)
    _, _, cond = synth.batch(seeds, fam)
    base = jax.random.PRNGKey(a_j.idx * 7919)
    keys = jax.vmap(lambda s: jax.random.fold_in(base, s))(
        jnp.asarray(seeds, jnp.int32))
    noise = ex_j._noise_fn((8, 8, 4), True)(keys, jnp.asarray(cond))
    out_t = Executor(port, device="cpu").run(
        a_t, torch.from_numpy(np.array(noise)), cond)
    assert _rel(out_t, out_j) <= COMPRESSED_RTOL


def test_quality_table_on_reference_noise(families, monkeypatch):
    ref, port = families
    seeds = np.arange(3) + 50
    arms = [0, 3, 8]
    qt_j = JExecutor(ref).quality_table(seeds, arms=[jarms.ARMS[i]
                                                     for i in arms])
    ex_t = Executor(port, device="cpu")

    def reference_noise(arm, seeds, per_sample):  # generate()'s batch key
        key = jax.random.PRNGKey(int(seeds[0]) * 7919 + arm.idx)
        return torch.from_numpy(np.array(
            jax.random.normal(key, (len(seeds), 8, 8, 4))))

    monkeypatch.setattr(ex_t, "noise", reference_noise)
    qt_t = ex_t.quality_table(seeds, arms=[ex_t.arms[i] for i in arms])
    for i in range(len(seeds)):
        for a in arms:
            m_t, m_j = qt_t[i, a], qt_j[i, a]
            assert m_t.keys() == m_j.keys()
            for k in m_t:
                assert m_t[k] == pytest.approx(m_j[k], rel=1e-3, abs=1e-4), k
        assert qt_t[i, 1] is None  # unfilled column


def test_fused_and_unfused_executors_give_the_same_bits(families):
    port = families[1]
    ex_f = Executor(port, device="cpu")
    ex_u = Executor(port, fused_boundary=False, device="cpu")
    seeds = np.arange(2) + 5
    for arm in tarms.build_action_space(compress=True)[1::5]:
        np.testing.assert_array_equal(ex_f.generate_bucketed(arm, seeds),
                                      ex_u.generate_bucketed(arm, seeds))


def test_bucketed_rows_independent_of_bucket_and_companions(families):
    ex = Executor(families[1], device="cpu")
    arm = tarms.build_action_space(compress=True)[2]
    seeds = np.asarray([3, 9, 4, 17, 8])
    full = ex.generate_bucketed(arm, seeds)
    assert full.shape == (5, 8, 8, 4)
    np.testing.assert_array_equal(
        ex.generate_bucketed(arm, seeds, subset=[1, 3]), full[[1, 3]])
    np.testing.assert_array_equal(ex.generate_bucketed(arm, seeds[4:]),
                                  full[4:])
    with pytest.raises(ValueError, match="empty subset"):
        ex.generate_bucketed(arm, seeds, subset=[])
    # per-batch noise follows seeds[0]; per-sample noise each sample's seed
    assert torch.equal(ex.noise(arm, [9, 1], per_sample=True)[0],
                       ex.noise(arm, [9], per_sample=True)[0])
    assert torch.equal(ex.noise(arm, [9, 1], per_sample=False)[0],
                       ex.noise(arm, [9], per_sample=False)[0])


@pytest.mark.parametrize("subset", [[5], [6, 2], [7, 0, 3]])
@pytest.mark.parametrize("idx,compress", [(3, False), (8, False), (3, True),
                                          (8, True)])
def test_subset_rerun_equals_full_rows(families, idx, compress, subset):
    """The straggler re-issue: a ``subset=`` re-run of an 8-request
    micro-batch returns its rows of the full call bit for bit, for subsets
    of 1, 2 and 3 rows in any order, on the XL and F3 relays, raw and
    fused int8."""
    ex = Executor(families[1], device="cpu")
    arm = tarms.build_action_space(compress=compress)[idx]
    seeds = np.asarray([3, 9, 4, 17, 8, 11, 2, 30])
    full = ex.generate_bucketed(arm, seeds)
    part = ex.generate_bucketed(arm, seeds, subset=subset)
    assert part.shape == (len(subset), 8, 8, 4)
    np.testing.assert_array_equal(part, full[subset])


def test_executor_validation(families, monkeypatch):
    port = families[1]
    spec = port["XL"].spec
    bad = tarms.Arm(0, make_program(spec, [("large", "a", 10), ("mid", "b", 1),
                                           ("small", "c", None)],
                                    compress=True), "bad")
    with pytest.raises(ValueError, match="too few steps"):
        Executor(port, device="cpu").generate_bucketed(bad, np.asarray([1]))
    no_mid = {k: replace(f, mid_params=None) for k, f in port.items()}
    with pytest.raises(ValueError, match="mid-size"):
        Executor(no_mid, fused_boundary=False,
                 device="cpu").generate_bucketed(bad, np.asarray([1]))
    ex = Executor(port, arms=tarms.ARMS[:2], device="cpu")
    with pytest.raises(ValueError, match="action space"):
        ex.quality_table(np.arange(1), arms=[tarms.ARMS[5]])
    assert bucketize(3) == 4
    with pytest.raises(ValueError, match="largest bucket"):
        bucketize(9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Executor(port)


def test_serve_summary_on_cpu():
    out = serve(1, device="cpu", compressed=True, ckpt_dir=str(CKPTS))
    assert out["device"] == "cpu" and out["compressed"]
    assert [a["arm"] for a in out["arms"]] == [
        a.label for a in tarms.build_action_space(compress=True)[1:]]
    for row in out["arms"]:
        assert set(row["quality"]) == {"clip", "ir", "pick", "aes", "ocr"}
        assert np.isfinite(list(row["quality"].values())).all()
