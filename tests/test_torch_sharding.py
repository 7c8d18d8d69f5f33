"""The port's sharding rules (``repro_torch.distributed.sharding``)
against the reference's (``repro/distributed/sharding.py``), without
processes: the rule tables, every parameter's and cache leaf's spec of
the ten configurations at full size on four meshes, the ZeRO-1 and batch
specs, ``placements`` of tuple axes, the grouped head padding and the
pipeline's bubble fraction.

The port's shapes come from its own model and caches built on the
``meta`` device (its initializers run there, drawing nothing); the
reference's from ``jax.eval_shape`` of its ``init_model`` and
``init_lm_cache``.  Leaves are matched through ``lm_tree_from_jax``'s
names; a leaf of the reference's stacked blocks carries a leading
``n_repeats`` axis, which its spec leaves unsharded (the rank rule), so
the port's unrolled leaf must have that spec without its first entry.
"""
from __future__ import annotations

import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import sharding as jsh
from repro.distributed.pipeline_parallel import bubble_fraction as jbubble
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.pipeline_parallel import bubble_fraction
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tr
from repro_torch.training import checkpoint as ck

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x4": {"data": 2, "model": 4},
    "2x2x4": {"pod": 2, "data": 2, "model": 4},
}
CACHE_BATCH, CACHE_LEN = 32, 1024


def _mesh(name):
    """A stand-in mesh: the rules read only its name -> size ``shape``."""
    shape = MESHES[name]
    return types.SimpleNamespace(shape=dict(shape),
                                 mesh_dim_names=tuple(shape))


def _norm(spec, rank: int) -> tuple:
    """A spec as a tuple of ``rank`` entries (trailing None filled in)."""
    spec = tuple(spec)
    return spec + (None,) * (rank - len(spec))


@pytest.fixture(scope="module")
def shapes():
    """Per configuration: the port's parameter and cache shapes (meta),
    the reference's stacked shapes, both keyed by the port's names."""
    out = {}
    for name in configs.list_archs():
        cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
        model = tr.init_model(cfg, torch.Generator(), "meta")
        params = {n: tuple(p.shape) for n, p in model.named_parameters()}
        cache = tr.init_lm_cache(cfg, CACHE_BATCH, CACHE_LEN, device="meta")
        caches = {f"layers.{i}.{k}": tuple(v.shape)
                  for i, layer in enumerate(cache["layers"])
                  for k, v in layer.items()}
        jparams = jax.eval_shape(
            lambda: jtr.init_model(jax.random.PRNGKey(0), jcfg))
        jcache = jax.eval_shape(
            lambda: jtr.init_lm_cache(jcfg, CACHE_BATCH, CACHE_LEN))
        out[name] = (cfg, jcfg, params, caches, jparams, jcache)
    return out


def test_rule_tables_are_the_reference():
    assert sh.PARAM_RULES == jsh.PARAM_RULES
    assert sh.CACHE_RULES == jsh.CACHE_RULES
    assert list(sh.PARAM_RULES) == list(jsh.PARAM_RULES)


def _expected(jspecs: dict, jshapes: dict, shapes: dict) -> dict:
    """The reference's spec of each port leaf: its stacked spec without
    the leading (unsharded) repeat axis where the reference stacks it."""
    out = {}
    for n, shape in shapes.items():
        jshape = tuple(jshapes[n].shape)
        spec = _norm(jspecs[n], len(jshape))
        if len(jshape) == len(shape) + 1:
            assert spec[0] is None, (n, spec)
            spec = spec[1:]
        else:
            assert jshape == shape, (n, jshape, shape)
        out[n] = spec
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_pspecs_match_reference(shapes, mesh):
    m = _mesh(mesh)
    sharded = 0
    for name, (cfg, jcfg, params, _, jparams, _) in shapes.items():
        jspecs = ck.model_tree_from_jax(jsh.param_pspecs(jparams, m), jcfg,
                                        unstack=False)
        jshapes = ck.model_tree_from_jax(jparams, jcfg, unstack=False)
        assert set(jspecs) == set(params), name
        want = _expected(jspecs, jshapes, params)
        got = sh.param_pspecs(params, m, cfg)
        for n, shape in params.items():
            assert _norm(got[n], len(shape)) == want[n], (name, n)
            sharded += any(a is not None for a in want[n])
    assert sharded > 100  # the meshes do shard most weights


@pytest.mark.parametrize("prefer_seq", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_pspecs_match_reference(shapes, mesh, prefer_seq):
    m = _mesh(mesh)
    for name, (cfg, jcfg, _, caches, _, jcache) in shapes.items():
        jspecs = ck.lm_tree_from_jax(
            jsh.cache_pspecs(jcache, m, prefer_seq=prefer_seq), jcfg,
            unstack=False)
        jshapes = ck.lm_tree_from_jax(jcache, jcfg, unstack=False)
        assert set(jspecs) == set(caches), name
        want = _expected(jspecs, jshapes, caches)
        got = sh.cache_pspecs(caches, m, prefer_seq=prefer_seq, cfg=cfg)
        for n, shape in caches.items():
            assert _norm(got[n], len(shape)) == want[n], (name, n)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero_and_data_pspecs_match_reference(shapes, mesh):
    """ZeRO-1 on each port leaf (its own spec and shape) and the batch
    spec, function for function.  The reference places its stacked
    moments, where the data dim may land on the repeat axis; the port's
    layers are unrolled, so it is held on the unrolled leaves."""
    m = _mesh(mesh)
    for name, (cfg, jcfg, params, _, _, _) in shapes.items():
        specs = sh.param_pspecs(params, m, cfg)
        for n, shape in params.items():
            jspec = jsh.zero_pspec(jax.sharding.PartitionSpec(*specs[n]),
                                   shape, m)
            got = sh.zero_pspec(specs[n], shape, m)
            assert _norm(got, len(shape)) == _norm(jspec, len(shape)), n
    for ndim in (1, 2, 3, 4):
        assert tuple(sh.data_pspec(m, ndim)) == tuple(jsh.data_pspec(m, ndim))
    assert sh.batch_axes(m) == jsh.batch_axes(m)


def test_placements_of_tuple_axes():
    from torch.distributed.tensor import Replicate, Shard

    m = _mesh("2x2x4")
    assert sh.placements(sh.P(("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements(sh.P(None, "model"), m) == (
        Replicate(), Replicate(), Shard(1))
    assert sh.placements(sh.P(), m) == (Replicate(),) * 3
    assert sh.placements(sh.data_pspec(m, 3), m) == (
        Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError):  # major to minor against the mesh
        sh.placements(sh.P(("data", "pod")), m)


@pytest.mark.parametrize("h,kv,pad_to", [(32, 8, 48), (40, 8, 48), (4, 2, 6),
                                         (6, 1, 8)])
def test_pad_heads_grouped_bit_for_bit(h, kv, pad_to):
    rng = np.random.default_rng(h + kv)
    wq = rng.normal(size=(16, h, 8)).astype(np.float32)
    wo = rng.normal(size=(h, 8, 16)).astype(np.float32)
    jq, jo = jattn.pad_heads_grouped(wq, wo, kv, pad_to)
    q, o = attn.pad_heads_grouped(torch.from_numpy(wq), torch.from_numpy(wo),
                                  kv, pad_to)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))


@pytest.mark.parametrize("name", ["qwen3-4b", "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("tp", [3, 5, 6, 16])
def test_head_padding_rule(name, tp):
    """``pad_to``: the reference's rule (``attention.py:104-110``)."""
    cfg = configs.get_config(name).replace(attn_head_padding=True)
    got = attn.head_padding(cfg, types.SimpleNamespace(shape={"model": tp}))
    if cfg.n_heads % tp == 0:
        assert got is None
        return
    want = tp * (-(-cfg.n_heads // tp))
    while want % cfg.n_kv_heads or want % tp:
        want += 1
    assert got == want and got % tp == 0 and got % cfg.n_kv_heads == 0


@pytest.mark.parametrize("stages,micro", [(2, 6), (4, 6), (4, 1), (8, 32)])
def test_bubble_fraction(stages, micro):
    assert bubble_fraction(stages, micro) == jbubble(stages, micro)
