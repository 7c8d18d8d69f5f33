"""Reader and writer of the reference's checkpoint format
(``repro/training/checkpoint.py``) and the weight carry-over between its
parameter trees and the port's modules.

A checkpoint is msgpack of ``{"meta": {...}, "arrays": {key: {"dtype",
"shape", "data"}}}`` with keys the ``/``-joined parameter-tree paths
(``"large/down/0/conv1"``) in the tree's flatten order; ``None`` leaves
(the UNet's identity ``skip``) are absent.  The decoder and encoder below
cover the msgpack types those files use, so the port needs no msgpack
package; :func:`save` writes the bytes the reference's ``save`` writes.
"""
from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

# fixed-width msgpack formats: type byte -> (kind, payload width or
# struct code of the value)
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
_INTS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
         0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}


def _decode(buf: bytes, pos: int):
    """Decode one msgpack object at ``pos``; returns ``(value, next pos)``."""
    b = buf[pos]
    pos += 1
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f:
        return _container("map", b & 0x0f, buf, pos)
    if 0x90 <= b <= 0x9f:
        return _container("array", b & 0x0f, buf, pos)
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if b == 0xc0:
        return None, pos
    if b in _INTS:
        code = _INTS[b]
        return struct.unpack_from(code, buf, pos)[0], pos + struct.calcsize(code)
    if b in _SIZED:
        kind, code = _SIZED[b]
        n = struct.unpack_from(code, buf, pos)[0]
        pos += struct.calcsize(code)
        if kind == "bin":
            return bytes(buf[pos:pos + n]), pos + n
        if kind == "str":
            return buf[pos:pos + n].decode("utf-8"), pos + n
        return _container(kind, n, buf, pos)
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at {pos - 1}")


def _container(kind: str, n: int, buf: bytes, pos: int):
    if kind == "array":
        out = []
        for _ in range(n):
            v, pos = _decode(buf, pos)
            out.append(v)
        return out, pos
    out = {}
    for _ in range(n):
        k, pos = _decode(buf, pos)
        out[k], pos = _decode(buf, pos)
    return out, pos


def unpackb(data: bytes):
    """Decode a msgpack document (the subset the checkpoints use)."""
    value, end = _decode(data, 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes after msgpack")
    return value


def _head(out: bytearray, n: int, fix: Optional[int], fix_max: int,
          sized) -> None:
    """A msgpack length header: the fix form while ``n`` fits it, else the
    smallest of ``sized`` ((type byte, struct code), narrowest first)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for byte, code in sized:
        if n < 1 << (8 * struct.calcsize(code)):
            out.append(byte)
            out += struct.pack(code, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _encode(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif isinstance(obj, bool):
        raise TypeError("bool is not in the checkpoint format")
    elif isinstance(obj, int):
        if -32 <= obj <= 0x7f:  # a positive or negative fixint
            out += struct.pack(">b" if obj < 0 else ">B", obj)
            return
        # the narrowest uint (0xcc-0xcf) or int (0xd0-0xd3) that holds it
        for byte in range(0xcc, 0xd0) if obj > 0 else range(0xd0, 0xd4):
            try:
                packed = struct.pack(_INTS[byte], obj)
            except struct.error:
                continue
            out.append(byte)
            out += packed
            return
        raise ValueError(f"int {obj} does not fit msgpack")
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xa0, 0x1f,
              ((0xd9, ">B"), (0xda, ">H"), (0xdb, ">I")))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _head(out, len(obj), None, 0,
              ((0xc4, ">B"), (0xc5, ">H"), (0xc6, ">I")))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 0x0f, ((0xdc, ">H"), (0xdd, ">I")))
        for v in obj:
            _encode(v, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 0x0f, ((0xde, ">H"), (0xdf, ">I")))
        for k, v in obj.items():
            _encode(k, out)
            _encode(v, out)
    else:
        raise TypeError(f"{type(obj).__name__} is not in the checkpoint "
                        "format")


def packb(obj) -> bytes:
    """Encode ``obj`` (None, int, str, bytes, lists and dicts of them) as
    ``msgpack.packb`` does: the narrowest form of each value, dicts in
    their insertion order."""
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def save(path, flat: Dict[str, np.ndarray], meta: Optional[dict] = None
         ) -> Path:
    """Write ``flat`` (``{"large/down/0/conv1": ndarray, ...}`` in the
    reference's flatten order, as :func:`params_to_jax` gives) as the
    reference's ``save`` does: the same payload, written to a ``.tmp``
    file and moved over ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "meta": meta or {},
        "arrays": {k: {"dtype": str(a.dtype), "shape": list(a.shape),
                       "data": np.ascontiguousarray(a).tobytes()}
                   for k, a in flat.items()},
    }
    tmp = path.with_suffix(".tmp")
    tmp.write_bytes(packb(payload))
    os.replace(tmp, path)
    return path


def load_flat(path) -> Dict[str, np.ndarray]:
    """``{"large/down/0/conv1": ndarray, ...}`` from a checkpoint file."""
    payload = unpackb(Path(path).read_bytes())
    return {
        k: np.frombuffer(v["data"], dtype=v["dtype"]).reshape(v["shape"])
        for k, v in payload["arrays"].items()
    }


def subtree(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """The entries under ``prefix/``, with the prefix stripped."""
    head = prefix + "/"
    return {k[len(head):]: v for k, v in flat.items() if k.startswith(head)}


def params_from_jax(flat: Dict[str, np.ndarray], cfg) -> Dict[str, torch.Tensor]:
    """State dict of the port's denoiser for one net's flat reference
    parameters: ``/`` paths become ``.`` names, UNet conv kernels go from
    HWIO to OIHW, dense weights stay ``(cin, cout)`` for ``x @ W``."""
    out = {}
    for key, a in flat.items():
        t = torch.tensor(np.array(a, dtype=np.float32))
        if cfg.kind == "unet" and t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        out[key.replace("/", ".")] = t
    return out


def _flatten_key(name: str) -> tuple:
    """A parameter path's place in the reference's flatten order: a dict's
    keys sorted, a list's items by index."""
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def params_to_jax(state_dict, cfg) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: one net's flat reference
    parameters (fp32 numpy on the host) from the port's state dict, ``.``
    names as ``/`` paths, UNet conv kernels from OIHW back to HWIO, in the
    reference's flatten order (``jax.tree_util.tree_flatten_with_path``)."""
    out = {}
    for name in sorted(state_dict, key=_flatten_key):
        t = state_dict[name].detach().to("cpu", torch.float32)
        if cfg.kind == "unet" and t.ndim == 4:
            t = t.permute(2, 3, 1, 0)
        out[name.replace(".", "/")] = np.ascontiguousarray(t.numpy())
    return out


def lm_params_from_jax(params_np: dict, cfg) -> Dict[str, torch.Tensor]:
    """State dict of the port's LM (``models/transformer.py::LM``) for the
    reference's parameter tree ``params_np`` (numpy leaves, as
    ``jax.tree.map(np.asarray, params)`` gives).  The super-block stacks
    are unstacked: leaf ``params["lm"]["blocks"][j][...][r]`` becomes layer
    ``r * len(pattern) + j``, the remainder follows.  Weights keep the
    einsum layouts (``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo``
    (H, hd, d), ``w_gate``/``w_up`` (d, f), ``w_down`` (f, d); an RG-LRU
    block's ``rglru`` leaves ``w_x``, ``w_g``, ``w_a``, ``w_i``, ``w_out``,
    ``conv_w``, ``conv_b``, ``b_a``, ``b_i``, ``lam`` by name), in fp32;
    ``load_state_dict`` casts them to each parameter's dtype, so ``lam``
    stays fp32 in a bf16 model."""
    lm = params_np["lm"]
    n_pat = len(cfg.pattern)
    out = {"embed": lm["embed"], "final_norm": lm["final_norm"]}
    if "lm_head" in lm:
        out["lm_head"] = lm["lm_head"]

    def put(prefix: str, tree, index=None) -> None:
        for key, val in tree.items():
            if isinstance(val, dict):
                put(f"{prefix}.{key}", val, index)
            else:
                out[f"{prefix}.{key}"] = val if index is None else val[index]

    for j, block in enumerate(lm["blocks"]):
        for r in range(cfg.n_repeats):
            put(f"layers.{r * n_pat + j}", block, r)
    for i, layer in enumerate(lm.get("rem", ())):
        put(f"layers.{cfg.n_repeats * n_pat + i}", layer)
    return {k: torch.tensor(np.asarray(v, dtype=np.float32))
            for k, v in out.items()}


def linucb_state_from_jax(A, b, counts, device):
    """The reference's ``LinUCBState`` (its fields as numpy: ``A`` (K, d,
    d), ``b`` (K, d), ``counts`` (K,)) as the port's, fp32 on ``device``."""
    from repro_torch.core.linucb import LinUCBState

    return LinUCBState(*(torch.tensor(np.asarray(x, dtype=np.float32),
                                      device=device) for x in (A, b, counts)))


def mlp_params_from_jax(layers, module) -> None:
    """Copy the reference's MLP parameters ``[{"w": (a, b), "b": (b,)},
    ...]`` (numpy leaves) into the port's ``core/policies.py::MLP``
    ``module`` in place.  The port's ``w[i]`` is the reference's ``"w"``
    itself, (fan_in, fan_out), not its transpose: both compute ``x @ w +
    b``."""
    if len(layers) != len(module.w):
        raise ValueError(f"{len(layers)} layers for an MLP of {len(module.w)}")
    with torch.no_grad():
        for layer, w, b in zip(layers, module.w, module.b):
            w.copy_(torch.tensor(np.asarray(layer["w"], dtype=np.float32)))
            b.copy_(torch.tensor(np.asarray(layer["b"], dtype=np.float32)))
