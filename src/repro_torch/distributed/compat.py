"""``shard_map`` and the collectives of a shard-mapped body, over
``torch.distributed`` (port of ``repro/distributed/compat.py``, the
reference's ``shard_map``/``pvary`` shims).

:func:`shard_map` runs ``f`` on each rank's local blocks of its DTensor
arguments (``torch.distributed.tensor.experimental.local_map``), the
blocks given by the reference's ``in_specs``/``out_specs`` (partition
specs, :class:`repro_torch.distributed.sharding.P`, over the mesh's
named dims).  Inside, :func:`psum`, :func:`pmean`, :func:`ppermute` and
:func:`axis_index` name a mesh dim as the reference's ``jax.lax``
collectives name an axis.

Gradients follow ``shard_map``'s transpose: an input replicated over a
mesh dim gets the sum of every rank's cotangent there (its DTensor
gradient is ``Partial``), :func:`psum`'s cotangent passes through
unchanged (its output and cotangent are the same on every rank of the
axis), :func:`pmean`'s is divided by the axis size, and
:func:`ppermute`'s goes back along the inverse permutation.  A value
computed identically on every rank of an axis and returned replicated
passes through :func:`invariant`, which divides its cotangent by the
axis size so that the sum over the axis counts it once (the reference's
varying-type tracking does this without a marker).

:func:`psum` is an ``all_reduce`` over each named mesh dim in turn, in
the block's dtype (gloo's reduction order, not rank order; gloo's ring
ends with every rank holding the same bits).

The one-card transport: ranks that share one card cannot use NCCL (it
refuses two ranks on one device), so their group is gloo.  Gloo carries
the collectives on CUDA tensors, but not a send or a receive: it writes
from the device pointer and fails ("writev ... Bad address"), or aborts
the process (``tools/gloo_cuda_probe.py`` on an H100, torch 2.11).  So
:func:`ppermute`, given a CUDA tensor in a gloo group, sends and receives
a host copy and copies the result back; each such copy (to the host, or
back) adds one to ``HOST_COPIES``.  The compute stays on the card.
DTensor's own gather (a ``Shard`` redistributed to ``Replicate``) crashed
such a group (SIGSEGV, the same probe), so a DTensor is gathered by
:func:`_gather` instead, wherever :func:`replicated` or :func:`shard_map`
turns a sharded dim into a replicated one (:class:`_Gathered`,
differentiable: its cotangent is reduce-scattered back to the shard).
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.distributed.sharding import P, mesh_shape, placements

Axis = Union[str, Tuple[str, ...]]

#: copies between a CUDA tensor and the host made by :func:`ppermute`
HOST_COPIES = {"to_host": 0, "to_device": 0}


def reset_host_copies() -> None:
    for k in HOST_COPIES:
        HOST_COPIES[k] = 0


def _axes(axis: Axis) -> Tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def axis_size(mesh, axis: Axis) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in _axes(axis):
        n *= shape[a]
    return n


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along the mesh dim ``axis``."""
    return mesh.get_local_rank(axis)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    HOST_COPIES["to_host"] += 1
    return t.cpu()


def _to_device(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    HOST_COPIES["to_device"] += 1
    return host.to(like.device)


def _gather(t: torch.Tensor, group) -> list:
    """Every rank's ``t`` in ``group``, in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def _all_reduce(t: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
    """The sum of ``t`` over ``axis`` (a new tensor), one mesh dim after
    another."""
    out = t
    for a in _axes(axis):
        if mesh_shape(mesh)[a] > 1:
            if out is t:
                out = t.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(out, group=mesh.get_group(a))
    return out


# ``reduce_scatter_single`` is ``reduce_scatter_tensor``'s newer name
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


def _reduce_scatter_dim(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of ``g`` over ``group``'s ranks, this rank's block of it
    along ``dim`` (``reduce_scatter``)."""
    n = dist.get_world_size(group)
    full = g.movedim(dim, 0).contiguous()
    out = full.new_empty((full.shape[0] // n,) + full.shape[1:])
    _reduce_scatter(out, full, group=group)
    return out.movedim(0, dim)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, scale):
        ctx.scale = scale
        out = _all_reduce(x, mesh, axis)
        return out if scale == 1.0 else out * scale

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.scale == 1.0 else g * ctx.scale), None, None, None


class _Invariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def psum(x: torch.Tensor, axis: Axis, mesh) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (``jax.lax.psum``)."""
    return _Psum.apply(x, mesh, axis, 1.0)


def pmean(x: torch.Tensor, axis: Axis, mesh) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``axis`` (``jax.lax.pmean``): the
    sum times 1/n."""
    n = axis_size(mesh, axis)
    return _Psum.apply(x, mesh, axis, 1.0 / n) if n > 1 else x


def invariant(x: torch.Tensor, axis: Axis, mesh) -> torch.Tensor:
    """``x`` unchanged; its cotangent divided by the size of ``axis``
    (see the module's docstring)."""
    n = axis_size(mesh, axis)
    return _Invariant.apply(x, n) if n > 1 else x


def _permute(x: torch.Tensor, axis: str, perm, mesh) -> torch.Tensor:
    """``x`` sent along ``perm`` ((source, destination) pairs of
    coordinates on ``axis``); a rank no pair sends to gets zeros."""
    group = mesh.get_group(axis)
    me = axis_index(mesh, axis)
    ranks = dist.get_process_group_ranks(group)
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    src = _to_host(x) if staged else x.contiguous()
    out = torch.zeros_like(src)
    ops = []
    for a, b in perm:
        if a == me and b != me:
            ops.append(dist.P2POp(dist.isend, src, ranks[b], group))
        if b == me and a != me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[a], group))
        if a == me == b:
            out.copy_(src)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _to_device(out, x) if staged else out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm, mesh):
        ctx.axis, ctx.perm, ctx.mesh = axis, perm, mesh
        return _permute(x, axis, perm, mesh)

    @staticmethod
    def backward(ctx, g):
        inverse = [(b, a) for a, b in ctx.perm]
        return _permute(g, ctx.axis, inverse, ctx.mesh), None, None, None


def ppermute(x: torch.Tensor, axis: str, perm: Sequence[Tuple[int, int]],
             mesh) -> torch.Tensor:
    """``jax.lax.ppermute``: rank ``a`` of ``axis`` sends ``x`` to rank
    ``b`` for each pair ``(a, b)`` of ``perm``."""
    return _Ppermute.apply(x, axis, tuple(perm), mesh)


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _grad_placements(spec: P, mesh) -> tuple:
    """``Shard`` where ``spec`` shards, ``Partial`` (the cotangents
    summed) on the mesh dims it replicates over."""
    from torch.distributed.tensor import Partial, Replicate

    return tuple(Partial() if isinstance(pl, Replicate) else pl
                 for pl in placements(spec, mesh))


def shard_map(f, *, mesh, in_specs, out_specs):
    """``f`` on each rank's local blocks: ``in_specs`` one spec (or a tree
    of specs matching the argument's tree, e.g. a dict) per positional
    argument, ``out_specs`` one spec or a tuple of specs per output.  A
    plain tensor argument is the global value, the same on every rank:
    each rank takes its block (no collective).  A DTensor argument placed
    otherwise than its spec is redistributed to it first (DTensor's
    collectives).  The outputs are DTensors placed by ``out_specs``."""
    from torch.distributed.tensor.experimental import local_map

    flat_specs, _ = pytree.tree_flatten(tuple(in_specs), is_leaf=_is_spec)
    multi = isinstance(out_specs, tuple) and not _is_spec(out_specs)
    outs = out_specs if multi else (out_specs,)
    # local_map reads a tuple as one placement list per output
    out_pl = tuple(list(placements(s, mesh)) for s in outs)

    def call(*args):
        flat, tree = pytree.tree_flatten(args)
        if len(flat) != len(flat_specs):
            raise ValueError(f"{len(flat)} argument leaves, "
                             f"{len(flat_specs)} specs")
        in_pl = tuple(placements(s, mesh) if isinstance(a, torch.Tensor)
                      else None for a, s in zip(flat, flat_specs))
        flat = [_placed(a, mesh, pl) if pl is not None else a
                for a, pl in zip(flat, in_pl)]
        grad_pl = tuple(_grad_placements(s, mesh) if isinstance(
            a, torch.Tensor) else None for a, s in zip(flat, flat_specs))

        def body(*flat_local):
            return f(*pytree.tree_unflatten(list(flat_local), tree))

        mapped = local_map(body, out_placements=out_pl if multi else out_pl[0],
                           in_placements=in_pl, in_grad_placements=grad_pl,
                           device_mesh=mesh)
        return mapped(*flat)

    return call


class _Gathered(torch.autograd.Function):
    """The whole of a local block along ``dims`` ((mesh dim, tensor dim)
    pairs, in mesh-dim order) by :func:`_gather`, the last mesh dim
    first, so that shards of one tensor dim nest as DTensor nests them.
    Backward, each gathered mesh dim in turn from the first: this rank's
    block of the cotangent, reduce-scattered over the dim's ranks where
    ``reduce`` (each rank holds its own contribution), else sliced (each
    rank holds the sum already)."""

    @staticmethod
    def forward(ctx, local, mesh, dims, reduce):
        ctx.mesh, ctx.dims, ctx.reduce = mesh, dims, reduce
        out = local
        for j, i in reversed(dims):
            out = torch.cat(_gather(out.contiguous(), mesh.get_group(j)),
                            dim=i)
        return out

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        for j, i in ctx.dims:
            if ctx.reduce:
                g = _reduce_scatter_dim(g, mesh.get_group(j), i)
            else:
                g = g.chunk(mesh.size(j), dim=i)[mesh.get_local_rank(j)]
        return g.contiguous(), None, None, None


def _local_chunk(t: torch.Tensor, mesh, pl: tuple) -> torch.Tensor:
    """This rank's block of the global ``t`` under placements ``pl`` (a
    differentiable slice; shards of one dim nest in mesh-dim order)."""
    from torch.distributed.tensor import Shard

    for j, p in enumerate(pl):
        if isinstance(p, Shard):
            n = mesh.size(j)
            t = t.chunk(n, dim=p.dim)[mesh.get_local_rank(j)]
    return t


def _placed(t: torch.Tensor, mesh, pl: tuple):
    """``t`` as a DTensor with placements ``pl``: a plain tensor is the
    global value (each rank keeps its block, no collective; gradients
    flow back to it), a DTensor is redistributed if it is placed
    otherwise, the mesh dims it shards and ``pl`` replicates gathered by
    :class:`_Gathered` first."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return DTensor.from_local(_local_chunk(t, mesh, pl), mesh, pl,
                                  run_check=False)
    if tuple(t.placements) == tuple(pl):
        return t
    dims = tuple((j, p.dim) for j, (p, q) in enumerate(zip(t.placements, pl))
                 if isinstance(p, Shard) and isinstance(q, Replicate))
    if dims:
        # the cotangent reaching from_local's backward is summed there
        local = _Gathered.apply(t.to_local(), mesh, dims, False)
        now = [Replicate() if any(j == k for k, _ in dims) else p
               for j, p in enumerate(t.placements)]
        t = DTensor.from_local(local, mesh, now, run_check=False)
    return t if tuple(t.placements) == tuple(pl) else t.redistribute(mesh, pl)


def placed(t: torch.Tensor, mesh, spec: P):
    """``t`` (a plain tensor, the same on every rank, or a DTensor) as a
    DTensor placed by ``spec``."""
    return _placed(t, mesh, placements(spec, mesh))


def replicated(t: torch.Tensor, mesh) -> torch.Tensor:
    """The whole of ``t`` as a plain tensor on every rank: a DTensor
    gathered where it is sharded (:class:`_Gathered`), a plain tensor as
    it is.  Its cotangent is taken as each rank's own share over the
    gathered mesh dims (summed there) and as the whole over the others,
    as a plain tensor's cotangent comes back from :func:`shard_map`
    (DTensor sums a replicated input's there)."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    if not isinstance(t, DTensor):
        return t
    if any(isinstance(p, Partial) for p in t.placements):
        raise ValueError(f"{t.placements}: a partial sum is not gathered here")
    dims = tuple((j, p.dim) for j, p in enumerate(t.placements)
                 if isinstance(p, Shard))
    return _Gathered.apply(t.to_local(), mesh, dims, True)
