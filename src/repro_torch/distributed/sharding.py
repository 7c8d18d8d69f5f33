"""Logical sharding rules (port of ``repro/distributed/sharding.py``):
each parameter's, cache leaf's and optimizer moment's placement on a
device mesh.

Rules are keyed by a leaf's name and given as an ordered list of
candidates; the first candidate whose every sharded dimension divides
evenly is used, else the leaf is replicated.  ``PARAM_RULES`` and
``CACHE_RULES`` are the reference's, candidates in its order.

A spec (:class:`P`) names, per tensor dim, the mesh dim that shards it
(``None``: not sharded), or a tuple of mesh dims that shard it together,
major to minor, as a JAX ``PartitionSpec``.  A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` whose dims are named
from ``pod``/``data``/``model``/``stage``; the rules read only its dims'
sizes (:func:`mesh_shape`), so they also take any object whose ``shape``
maps a dim's name to its size.

The reference stacks a layer pattern's leaves on a leading ``n_repeats``
axis and leaves that axis unsharded (the rank rule in ``_resolve``: a
candidate one dim short is taken to skip the stacked axis); the port's
layers are unrolled, so given the config, a leaf of the reference's
stacked body (``layers.i`` below ``n_repeats * len(pattern)``, every
``encoder.layers.i``) is resolved against its stacked shape and takes
that spec without its leading ``None``, and a remainder layer's leaf is
resolved as it is, as the reference resolves its unstacked ``rem``.  :func:`placements` turns a
spec into DTensor placements, and :func:`distribute` places a module's
parameters.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import torch

# "B" is replaced by the mesh's batch axes ("pod", "data") / ("data",)
_B = "B"

# name -> ordered candidates; each candidate is a tuple over dims
PARAM_RULES = {
    "embed": [("model", None)],
    "lm_head": [(None, "model")],
    "wq": [(None, "model", None), (None, None, "model")],
    "wk": [(None, "model", None), (None, None, "model")],
    "wv": [(None, "model", None), (None, None, "model")],
    "wo": [("model", None, None), (None, "model", None)],
    "w_gate": [(None, "model")],
    "w_up": [(None, "model")],
    "w_down": [("model", None)],
    "router": [(None, None)],
    "we_gate": [("model", None, None)],
    "we_up": [("model", None, None)],
    "we_down": [("model", None, None)],
    # MLA
    "w_dq": [(None, "model")],
    "w_uq": [(None, "model", None), (None, None, "model")],
    "w_dkv": [(None, None)],  # small; avoids resharding at the latent split
    "w_uk": [(None, "model", None)],
    "w_uv": [(None, "model", None)],
    # recurrent
    "w_x": [(None, "model")],
    "w_g": [(None, "model")],
    "conv_w": [(None, "model")],
    "conv_b": [("model",)],
    "w_a": [(None, "model")],
    "b_a": [("model",)],
    "w_i": [(None, "model")],
    "b_i": [("model",)],
    "lam": [("model",)],
    "w_out": [("model", None)],
    "w_if": [(None, None)],
    "b_if": [(None,)],
    # mLSTM block-diagonal per-head projections: shard the output dim
    "wq_h": [(None, None, "model")],
    "wk_h": [(None, None, "model")],
    "wv_h": [(None, None, "model")],
    "gn_scale": [("model",)],
    # sLSTM stays local to each shard (sequential scan) -> replicated
    "w_gates": [(None, None)],
    "r_gates": [(None, None, None, None)],
    "b_gates": [(None,)],
    "ctx_proj": [(None, None)],
    "mtp_proj": [(None, "model")],
}

CACHE_RULES = {
    "k": [(_B, None, "model", None), (_B, "model", None, None),
          (None, "model", None, None)],
    "v": [(_B, None, "model", None), (_B, "model", None, None),
          (None, "model", None, None)],
    "c_kv": [(_B, None, "model"), (_B, "model", None), (None, "model", None)],
    "k_rope": [(_B, None, None)],
    "h": [(_B, "model"), (_B, None, "model"), (None, "model")],
    "conv": [(_B, None, "model")],
    "C": [(_B, None, "model", None), (None, None, "model", None)],
    "n": [(_B, None, "model"), (None, None, "model")],
    "m": [(_B, None), (None, None)],
    "c": [(_B, None, "model"), (None, None, "model")],
}

# flash-decoding layout of ``cache_pspecs(prefer_seq=True)``
_SEQ_FIRST = {
    "k": [(_B, "model", None, None), (_B, None, "model", None)],
    "v": [(_B, "model", None, None), (_B, None, "model", None)],
    "c_kv": [(_B, "model", None), (_B, None, "model")],
    "k_rope": [(_B, "model", None), (_B, None, None)],
}


class P(tuple):
    """A partition spec: one entry per tensor dim, a mesh dim's name, a
    tuple of names (major to minor) or ``None``; trailing dims left out
    are unsharded, as in a JAX ``PartitionSpec``, which also stores a
    one-name tuple as the name."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def mesh_shape(mesh) -> Dict[str, int]:
    """``{dim name: size}`` of a DeviceMesh, or ``mesh.shape`` of an
    object whose shape is already such a mapping; :class:`TypeError` for
    anything else."""
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        return dict(shape)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None or shape is None:
        raise TypeError(f"{type(mesh).__name__} is not a mesh: a DeviceMesh "
                        f"with named dims, or an object whose shape maps a "
                        f"dim's name to its size")
    return dict(zip(names, shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _axis_size(mesh, ax) -> int:
    if ax is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(ax, tuple):
        return int(math.prod(shape[a] for a in ax))
    return shape[ax]


def _fits(mesh, cand: Sequence, shape: Tuple[int, ...]) -> bool:
    if len(cand) != len(shape):
        return False
    return all(d % _axis_size(mesh, ax) == 0 for d, ax in zip(shape, cand))


def _resolve(mesh, cands, shape, name: str) -> P:
    ba = batch_axes(mesh)
    for cand in cands:
        cand = tuple(ba if ax == _B else ax for ax in cand)
        # a stacked scan axis (the reference's) -> prepend None
        if len(cand) == len(shape) - 1:
            cand = (None,) + cand
        if _fits(mesh, cand, shape):
            return P(*cand)
    return P()  # replicate


def _leaf_name(name: str) -> str:
    return name.rsplit(".", 1)[-1].rsplit("/", 1)[-1]


def stacked_repeats(name: str, cfg) -> int:
    """The size of the reference's stacked axis over the port's leaf
    ``name`` (its parameter or flat cache name), 0 where the reference
    does not stack it (a remainder layer, a top-level leaf)."""
    if cfg is None:
        return 0
    parts = name.split(".")
    if parts[0] == "encoder" and parts[1:2] == ["layers"]:
        return cfg.encoder.n_layers
    if parts[0] == "layers" and int(parts[1]) < cfg.n_repeats * len(
            cfg.pattern):
        return cfg.n_repeats
    return 0


def _resolve_leaf(mesh, cands, shape, name: str, repeats: int) -> P:
    """:func:`_resolve` of an unrolled leaf: against its stacked shape
    when the reference stacks it (``repeats``), its first entry (the
    stacked axis, left unsharded by the rank rule) dropped."""
    if not repeats:
        return _resolve(mesh, cands, shape, name)
    spec = tuple(_resolve(mesh, cands, (repeats,) + tuple(shape), name))
    if not spec:
        return P()
    if spec[0] is not None:
        raise ValueError(f"{name}: {spec} shards the stacked layer axis")
    return P(*spec[1:])


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def param_pspecs(params: Mapping[str, object], mesh,
                 cfg=None) -> Dict[str, P]:
    """``{name: P}`` for ``{name: tensor or shape}`` (a module's
    ``named_parameters()``, or shapes alone): each leaf by the rule of its
    last name component, unknown names (the norms) replicated.  With the
    model's ``cfg``, a leaf the reference stacks is resolved as stacked
    (module docstring)."""
    out = {}
    for name, leaf in dict(params).items():
        leaf_name = _leaf_name(name)
        if leaf_name in PARAM_RULES:
            out[name] = _resolve_leaf(mesh, PARAM_RULES[leaf_name],
                                      _shape(leaf), leaf_name,
                                      stacked_repeats(name, cfg))
        else:
            out[name] = P()
    return out


def cache_pspecs(cache: Mapping[str, object], mesh, *,
                 prefer_seq: bool = False, cfg=None) -> Dict[str, P]:
    """``{name: P}`` for a flat cache ``{"layers.3.k": tensor or shape}``
    (``cfg`` as :func:`param_pspecs` takes it).  ``prefer_seq``: shard
    the cache's sequence axis on "model" instead of heads or latent (the
    flash-decoding layout)."""
    out = {}
    for name, leaf in dict(cache).items():
        leaf_name = _leaf_name(name)
        rules = (_SEQ_FIRST if prefer_seq and leaf_name in _SEQ_FIRST
                 else CACHE_RULES)
        if leaf_name in rules:
            out[name] = _resolve_leaf(mesh, rules[leaf_name], _shape(leaf),
                                      leaf_name, stacked_repeats(name, cfg))
        else:
            out[name] = P()
    return out


def zero_pspec(spec: P, shape: Tuple[int, ...], mesh,
               axis: str = "data") -> P:
    """ZeRO-1: also shard one unsharded dim of an optimizer-state leaf on
    ``axis`` (the first dim that divides evenly)."""
    mshape = mesh_shape(mesh)
    if axis not in mshape:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (d, ax) in enumerate(zip(shape, parts)):
        if ax is None and d % mshape[axis] == 0 and d >= mshape[axis]:
            parts[i] = axis
            return P(*parts)
    return spec


def data_pspec(mesh, ndim: int) -> P:
    """Batch-sharded activation spec: (B, ...) -> P(batch_axes, None, ...)."""
    return P(batch_axes(mesh), *([None] * (ndim - 1)))


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(i)`` where the spec names it at tensor dim ``i``,
    ``Replicate()`` elsewhere.  A tuple entry shards its one tensor dim
    over all its mesh dims, the first the major one, as JAX lays out
    ``P(("pod", "data"))``; DTensor nests shards of one tensor dim in
    mesh-dim order, so the tuple's dims must appear in the mesh in the
    same order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, ax in enumerate(spec):
        axes = ax if isinstance(ax, tuple) else (ax,)
        pos = [names.index(a) for a in axes if a is not None]
        if pos != sorted(pos):
            raise ValueError(f"{spec}: mesh dims {axes} are not in the "
                             f"mesh's order {tuple(names)}")
        for j in pos:
            out[j] = Shard(i)
    return tuple(out)


def distribute_tensor(t: torch.Tensor, mesh, spec: P):
    """``t`` (the same full tensor on every rank) as a DTensor placed by
    ``spec``: each rank keeps its own block, no collective."""
    from torch.distributed.tensor import distribute_tensor as dist_t

    return dist_t(t, mesh, placements(spec, mesh), src_data_rank=None)


def distribute(module: torch.nn.Module, mesh, specs=None,
               cfg=None) -> Dict[str, P]:
    """Place ``module``'s parameters on ``mesh`` in place: each becomes a
    DTensor parameter (``requires_grad`` kept) placed by its spec in
    ``specs`` (``{name: P}``, by default :func:`param_pspecs` with
    ``cfg``).  Every rank must hold the same full weights.  Returns the
    specs."""
    named = dict(module.named_parameters())
    specs = param_pspecs(named, mesh, cfg) if specs is None else specs
    for name, p in named.items():
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        dt = distribute_tensor(p.detach(), mesh, specs[name])
        setattr(mod, leaf, torch.nn.Parameter(dt, requires_grad=p.requires_grad))
    return specs
