"""GPipe-style pipeline parallelism over a ``stage`` mesh dim (port of
``repro/distributed/pipeline_parallel.py``).

Each stage owns a contiguous slice of layers (stacked on a leading axis).
Microbatches stream through: at step t, stage p runs microbatch (t − p)
and passes its activations to stage p+1 with ``ppermute``.  After P − 1
warm-up steps the pipeline is full; the total is n_micro + P − 1 steps
(bubble fraction (P − 1)/(n_micro + P − 1), :func:`bubble_fraction`).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.distributed import compat
from repro_torch.distributed.sharding import P, placements


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_apply(layer_fn: Callable, stage_params, x: torch.Tensor, mesh,
                   *, axis: str = "stage") -> torch.Tensor:
    """``layer_fn(layer_params, h) -> h`` applied layer after layer with
    the layers split over the ``axis`` mesh dim: ``stage_params`` a tree
    whose leaves are (n_stages, layers_per_stage, ...) (the same on every
    rank, or DTensors split on dim 0 over ``axis``), ``x`` (n_micro,
    micro_batch, d) the microbatched input.  The reference's schedule:
    every stage runs at each of the n_micro + P − 1 steps, stage 0
    ingests microbatch t, the last stage emits microbatch t − P + 1 into
    its output, every stage sends its activations to stage p+1 after each
    step (a ring, as the reference's permutation), and the output —
    zeros on the other stages — is summed over ``axis`` so that every
    rank returns it."""
    n_stages = compat.axis_size(mesh, axis)
    n_micro = x.shape[0]
    sid = compat.axis_index(mesh, axis)
    pl = placements(P(axis), mesh)

    def local(leaf):
        block = (leaf.to_local() if hasattr(leaf, "to_local")
                 else compat._local_chunk(leaf, mesh, pl))
        return block[0]

    layers = pytree.tree_map(local, stage_params)
    n_layers = pytree.tree_leaves(layers)[0].shape[0]

    def run_stage(h):
        for i in range(n_layers):
            h = layer_fn(pytree.tree_map(lambda w: w[i], layers), h)
        return h

    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    buf = torch.zeros_like(x[0])
    out = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        h_in = x[t] if sid == 0 and t < n_micro else buf
        h_out = run_stage(h_in)
        emit = t - (n_stages - 1)
        if sid == n_stages - 1 and emit >= 0:
            out = out.index_copy(0, torch.tensor([emit], device=x.device),
                                 h_out[None])
        buf = compat.ppermute(h_out, axis, perm, mesh)
    # the other stages hold zeros: the sum broadcasts the last stage's
    return compat.psum(out, axis, mesh)
