"""Compressed collectives (port of ``repro/distributed/compression.py``):
a mean over a mesh dim carried in int8 with error feedback.

The quantizers live in :mod:`repro_torch.quantization`; the historical
quantizer names of this module raise :class:`ImportError` that says where
they went, as the reference's do.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.distributed import compat
from repro_torch.quantization import fused_error_feedback_step, get_quantizer

_MOVED = (
    "quant_rowwise", "dequant_rowwise", "quant_error",
    "quant_log8", "dequant_log8", "LOG8_RANGE",
    "latent_roundtrip_int8", "latent_roundtrip",
)


def __getattr__(name: str):
    if name in _MOVED:
        raise ImportError(
            f"repro_torch.distributed.compression.{name} was removed after "
            f"its deprecation cycle; import repro_torch.quantization.{name} "
            f"instead")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def compressed_psum(tree, mesh, axis: str = "pod", error_state=None,
                    quantizer="rowwise"):
    """Mean-reduce a tree of tensors over the mesh dim ``axis`` in int8
    with error feedback: ``(reduced tree, new error state)``.

    Each rank holds its own leaves (plain tensors).  It runs
    :func:`repro_torch.quantization.fused_error_feedback_step` on (leaf +
    carried error) with ``quantizer`` — on CUDA tensors with the rowwise
    quantizer, the ``quant_int8`` and ``dequant_int8`` kernels, one launch
    each per leaf — and keeps the residual as its new error; the
    reconstructions are summed over ``axis`` by one all-reduce
    (:func:`repro_torch.distributed.compat.psum`) and divided by the
    axis size, so every rank gets the same mean.  The error state starts
    at zeros (fp32) when ``error_state`` is None."""
    qz = get_quantizer(quantizer)
    n = compat.axis_size(mesh, axis)
    flat, treedef = pytree.tree_flatten(tree)
    errs = ([x.new_zeros(x.shape, dtype=torch.float32) for x in flat]
            if error_state is None
            else pytree.tree_leaves(error_state))
    out, new_errs = [], []
    for x, err in zip(flat, errs):
        _, rec, new_err = fused_error_feedback_step(x, err, qz)
        out.append(compat.psum(rec, axis, mesh) / n)
        new_errs.append(new_err)
    return (pytree.tree_unflatten(out, treedef),
            pytree.tree_unflatten(new_errs, treedef))
