"""Reader and writer of the reference's checkpoint format
(``repro/training/checkpoint.py``) and the weight carry-over between its
parameter trees and the port's modules.

A checkpoint is msgpack of ``{"meta": {...}, "arrays": {key: {"dtype",
"shape", "data"}}}`` with keys the ``/``-joined parameter-tree paths
(``"large/down/0/conv1"``) in the tree's flatten order; ``None`` leaves
(the UNet's identity ``skip``) are absent.  The decoder and encoder below
cover the msgpack types those files use, so the port needs no msgpack
package; :func:`save` writes the bytes the reference's ``save`` writes.

The LM trainer's checkpoint is the reference's ``(params, opt_state)``
pair: keys ``0/lm/blocks/0/attn/wq``, ``1/count``, ``1/m/lm/...``, with
each pattern slot's layers stacked on a leading ``n_repeats`` axis, and
``0/encoder/...``, ``1/m/encoder/...`` for a model with an encoder, its
layers stacked the same way (:func:`lm_state_to_jax`,
:func:`lm_state_from_jax`), so a file written by either package restores
in the other.  Writes are atomic; with ``step``
they are versioned (``step_%08d.ckpt``) under a ``latest`` symlink.
"""
from __future__ import annotations

import os
import struct
import threading
from pathlib import Path
from typing import Dict, Mapping, Optional

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


def _pack_array(a) -> dict:
    """A numpy array or tensor as the format's ``{"dtype", "shape",
    "data"}``; bf16 under the name numpy's ``bfloat16`` extension type
    (the reference's) gives it."""
    if isinstance(a, torch.Tensor):
        a = _whole(a).detach().to("cpu").contiguous()
        if a.dtype == torch.bfloat16:
            return {"dtype": "bfloat16", "shape": list(a.shape),
                    "data": a.view(torch.int16).numpy().tobytes()}
        a = a.numpy()
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": np.ascontiguousarray(a).tobytes()}


def _whole(a: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value (a collective: every rank calls it), a
    tensor as it is.  The gather is ``compat.replicated``'s, not DTensor's
    ``full_tensor``, whose Shard -> Replicate crashed a gloo group on CUDA
    tensors."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import compat

    if not isinstance(a, DTensor):
        return a
    with torch.no_grad():
        return compat.replicated(a, a.device_mesh)


def _sharded(flat: Mapping[str, object]) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(a, DTensor) for a in flat.values())


def _unpack_tensor(d: dict) -> torch.Tensor:
    if d["dtype"] == "bfloat16":
        t = torch.frombuffer(bytearray(d["data"]), dtype=torch.bfloat16)
        return t.reshape(d["shape"])
    a = np.frombuffer(d["data"], dtype=d["dtype"]).reshape(d["shape"])
    return torch.from_numpy(a.copy())


def save(path, flat: Mapping[str, object], meta: Optional[dict] = None, *,
         step: Optional[int] = None) -> Path:
    """Write ``flat`` (``{"large/down/0/conv1": array, ...}``, numpy arrays
    or tensors, in the reference's flatten order, as :func:`params_to_jax`
    or :func:`flatten` gives it) as the reference's ``save`` does: the same
    payload, written to a ``.tmp`` file and moved over ``path``.  With
    ``step``, ``path`` is a directory: the file is ``step_%08d.ckpt``
    there, and the ``latest`` symlink moves to it (also atomically).

    DTensors (a sharded model's) are saved whole, independent of the mesh
    they live on, as the reference saves its sharded arrays: every rank
    calls ``save`` (the gathers are collectives), rank 0 writes, and the
    ranks meet at a barrier after the write."""
    import torch.distributed as dist

    path = Path(path)
    if step is not None:
        path = path / f"step_{step:08d}.ckpt"
    sharded = _sharded(flat)
    payload = {
        "meta": meta or {},
        "arrays": {k: _pack_array(a) for k, a in flat.items()},
    }
    if sharded and dist.get_rank() != 0:
        dist.barrier()
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_bytes(packb(payload))
    os.replace(tmp, path)
    if step is not None:
        latest = path.parent / "latest"
        tmp_l = path.parent / ".latest.tmp"
        if tmp_l.exists() or tmp_l.is_symlink():
            tmp_l.unlink()
        tmp_l.symlink_to(path.name)
        os.replace(tmp_l, latest)
    if sharded:
        dist.barrier()
    return path


def save_async(path, flat: Mapping[str, object], meta: Optional[dict] = None,
               *, step: Optional[int] = None) -> threading.Thread:
    """Copy ``flat`` to host memory now, write it (:func:`save`) in a
    background thread; join the returned thread before the next save."""
    host = {k: (v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor)
                else np.array(v, copy=True)) for k, v in flat.items()}
    t = threading.Thread(target=save, args=(path, host, meta),
                         kwargs={"step": step}, daemon=True)
    t.start()
    return t


def restore(path, like: Mapping[str, torch.Tensor], *, mesh=None,
            placements=None):
    """``({key: tensor}, meta)`` for every key of ``like`` (``{key:
    tensor}`` giving each array's shape and dtype), read from ``path`` (a
    directory means its ``latest``), each cast to ``like``'s dtype, on the
    CPU.  Raises :class:`KeyError` for a missing key and
    :class:`ValueError` for a shape that differs, as the reference's
    ``restore``.

    With ``mesh`` and ``placements`` (``{key: spec}``, a
    :class:`repro_torch.distributed.sharding.P` or DTensor placements)
    each array is placed on ``mesh`` as a DTensor, on the mesh's device
    type: every rank keeps its own block of the whole array, whatever
    mesh wrote it (the reference's reshard-on-load)."""
    path = Path(path)
    if path.is_dir():
        path = path / "latest"
    payload = unpackb(path.read_bytes())
    arrays = payload["arrays"]
    out = {}
    for key, ref in like.items():
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        t = _unpack_tensor(arrays[key]).to(ref.dtype)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: ckpt {tuple(t.shape)} vs expected "
                             f"{tuple(ref.shape)}")
        out[key] = t
    if mesh is not None and placements is not None:
        out = {k: _place(t, mesh, placements[k]) for k, t in out.items()}
    return out, payload["meta"]


def _place(t: torch.Tensor, mesh, spec):
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import compat, sharding

    pl = (sharding.placements(spec, mesh)
          if isinstance(spec, sharding.P) else tuple(spec))
    local = compat._local_chunk(t, mesh, pl).contiguous()
    return DTensor.from_local(local.to(mesh.device_type), mesh, pl,
                              run_check=False)


def latest_step(ckpt_dir) -> Optional[int]:
    """The largest ``step`` of the ``step_%08d.ckpt`` files in
    ``ckpt_dir``, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(int(p.stem.split("_")[1])
                   for p in ckpt_dir.glob("step_*.ckpt"))
    return steps[-1] if steps else None


def flatten(tree, prefix: str = "") -> dict:
    """The leaves of a nested tree of dicts, lists and tuples under their
    ``/``-joined paths, in ``jax.tree_util``'s flatten order: a dict's keys
    sorted, a sequence's items by index; ``None`` is an empty subtree."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, val in items:
        out.update(flatten(val, f"{prefix}/{key}" if prefix else str(key)))
    return out


def unflatten(flat: Mapping[str, object]):
    """The inverse of :func:`flatten`: nested dicts, a dict whose keys are
    ``"0"`` … ``"n-1"`` becoming a list."""
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        *heads, last = key.split("/")
        for part in heads:
            node = node.setdefault(part, {})
        node[last] = val

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


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


def _is_leaf(val) -> bool:
    """A leaf of an LM tree: an array, or an int8 moment ``{"q", "s"}``."""
    return not isinstance(val, dict) or set(val) == {"q", "s"}


#: the leaves of an LM tree outside its layers (an encoder tree has the
#: final norm alone)
TOP_LEVEL = ("ctx_proj", "embed", "final_norm", "lm_head", "mtp_norm",
             "mtp_proj")


def lm_tree_from_jax(lm: dict, cfg, *, unstack: bool = True
                     ) -> Dict[str, object]:
    """``{port parameter name: leaf}`` for the reference's ``params["lm"]``
    tree ``lm`` (or a moment tree of the same shape; leaves numpy arrays,
    tensors or ``{"q", "s"}`` pairs of them).  The super-block stacks are
    unstacked: leaf ``lm["blocks"][j][...][r]`` becomes layer ``r *
    len(pattern) + j``, the remainder follows.  With ``unstack=False``
    each of those layers names the whole stacked leaf."""
    n_pat = len(cfg.pattern)
    out = {k: lm[k] for k in TOP_LEVEL if k in lm}

    def pick(val, index):
        if index is None:
            return val
        if isinstance(val, dict):
            return {k: v[index] for k, v in val.items()}
        return val[index]

    def put(prefix: str, tree, index=None) -> None:
        for key, val in tree.items():
            if _is_leaf(val):
                out[f"{prefix}.{key}"] = pick(val, index)
            else:
                put(f"{prefix}.{key}", val, index)

    for j, block in enumerate(lm["blocks"]):
        for r in range(cfg.n_repeats):
            put(f"layers.{r * n_pat + j}", block, r if unstack else None)
    for i, layer in enumerate(lm.get("rem", ())):
        put(f"layers.{cfg.n_repeats * n_pat + i}", layer)
    return out


def lm_tree_to_jax(named: Mapping[str, object], cfg) -> dict:
    """The inverse of :func:`lm_tree_from_jax`: the reference's
    ``params["lm"]`` tree (``embed``, ``blocks`` — one dict per pattern
    slot, each leaf the slot's layers stacked on a leading ``n_repeats``
    axis — ``final_norm``, ``lm_head`` when untied, ``ctx_proj`` with a
    context projection, ``mtp_norm`` and ``mtp_proj`` with an MTP head,
    ``rem`` when the config has a remainder) of ``named`` (port parameter
    name → tensor or ``{"q", "s"}`` pair).  Names under ``encoder.`` are
    not the LM's: :func:`model_tree_to_jax` stacks them."""
    n_pat = len(cfg.pattern)
    n_body = cfg.n_repeats * n_pat
    lm: dict = {k: named[k] for k in TOP_LEVEL if k in named}
    slots = [dict() for _ in range(n_pat)]
    rem = [dict() for _ in range(len(cfg.remainder))]
    for name, val in named.items():
        parts = name.split(".")
        if parts[0] != "layers":
            continue
        i = int(parts[1])
        if i < n_body:
            node = slots[i % n_pat]
            for part in parts[2:-1]:
                node = node.setdefault(part, {})
            node.setdefault(parts[-1], []).append(val)  # in repeat order
        else:
            node = rem[i - n_body]
            for part in parts[2:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = val

    def stack(node):
        if isinstance(node, list):
            if isinstance(node[0], dict):
                return {k: torch.stack([v[k] for v in node]) for k in node[0]}
            return torch.stack(node)
        return {k: stack(v) for k, v in node.items()}

    lm["blocks"] = tuple(stack(slot) for slot in slots)
    if rem:
        lm["rem"] = tuple(rem)
    return lm


def _encoder_cfg(cfg):
    from repro_torch.models.transformer import encoder_cfg

    return encoder_cfg(cfg)


def model_tree_from_jax(params: dict, cfg, *, unstack: bool = True
                        ) -> Dict[str, object]:
    """``{port parameter name: leaf}`` for the reference's whole
    parameter tree ``params`` (``{"lm", "encoder"}``, or a moment tree of
    the same shape): :func:`lm_tree_from_jax` of ``params["lm"]``, and,
    for a config with an encoder, of ``params["encoder"]`` (its ``blocks``
    stacked on the encoder's ``n_layers`` axis, its ``final_norm``) under
    ``encoder.``: leaf ``blocks[0][...][r]`` is ``encoder.layers.{r}``."""
    out = lm_tree_from_jax(params["lm"], cfg, unstack=unstack)
    if cfg.encoder is not None:
        enc = lm_tree_from_jax(params["encoder"], _encoder_cfg(cfg),
                               unstack=unstack)
        out.update({f"encoder.{k}": v for k, v in enc.items()})
    return out


def model_tree_to_jax(named: Mapping[str, object], cfg) -> dict:
    """The inverse of :func:`model_tree_from_jax`: the reference's
    ``{"lm", "encoder"}`` tree (``"encoder"`` only for a config with an
    encoder) of ``named``."""
    tree = {"lm": lm_tree_to_jax(named, cfg)}
    if cfg.encoder is not None:
        head = "encoder."
        tree["encoder"] = lm_tree_to_jax(
            {n[len(head):]: v for n, v in named.items() if n.startswith(head)},
            _encoder_cfg(cfg))
    return tree


def lm_leaf_ranks(named: Mapping[str, torch.Tensor], cfg) -> Dict[str, int]:
    """Each port parameter's name and the rank of its leaf in the
    reference's tree as :func:`model_tree_to_jax` stacks it: a pattern
    layer's leaf carries the leading ``n_repeats`` axis, and an encoder
    layer's its ``n_layers`` axis; a remainder layer's and the top-level
    ones do not.  AdamW decays a leaf of rank 2 or more
    (``training/optimizer.py``), so it decays an encoder layer's norm
    vectors, as the reference's does."""
    meta = {n: torch.empty(p.shape, device="meta") for n, p in named.items()}
    leaves = model_tree_from_jax(model_tree_to_jax(meta, cfg), cfg,
                                 unstack=False)
    return {n: leaves[n].dim() for n in named}


def lm_params_from_jax(params_np: dict, cfg) -> Dict[str, torch.Tensor]:
    """State dict of the port's LM (``models/transformer.py::LM``, its
    ``encoder`` included) for the reference's parameter tree ``params_np``
    (numpy leaves, as ``jax.tree.map(np.asarray, params)`` gives),
    unstacked by :func:`model_tree_from_jax`.  Weights keep the einsum layouts (``wq`` (d,
    H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d),
    ``w_gate``/``w_up`` (d, f), ``w_down`` (f, d); an RG-LRU block's
    ``rglru`` leaves ``w_x``, ``w_g``, ``w_a``, ``w_i``, ``w_out``,
    ``conv_w``, ``conv_b``, ``b_a``, ``b_i``, ``lam`` by name; an mLSTM's
    ``mlstm`` leaves ``w_up``, ``conv_w``, ``conv_b``, ``wq_h``/``wk_h``/
    ``wv_h`` (NH, DH, DH), ``w_if``, ``b_if``, ``gn_scale``, ``w_down``
    and an sLSTM's ``slstm`` leaves ``w_gates``, ``r_gates`` (NH, 4, DH,
    DH), ``b_gates``, ``gn_scale``, ``w_out``, by name; a MoE's
    ``router`` (d, E), ``we_gate``/``we_up`` (E, d, f), ``we_down`` (E, f,
    d) and ``shared`` MLP; MLA's ``w_dq``, ``w_uq`` (q_rank, H, qk),
    ``w_dkv``, ``w_uk``/``w_uv`` (kv_rank, H, .), ``wo`` (H, v, d) and its
    two norms), in fp32; ``load_state_dict`` casts them to each
    parameter's dtype, so ``lam``, ``router`` and the xLSTM's gate
    weights and biases (``w_if``, ``b_if``, ``w_gates``, ``r_gates``,
    ``b_gates``) stay fp32 in a bf16 model."""
    return {k: torch.tensor(np.asarray(v, dtype=np.float32))
            for k, v in model_tree_from_jax(params_np, cfg).items()}


def lm_state_to_jax(model, opt_state: dict, cfg) -> Dict[str, torch.Tensor]:
    """The flat checkpoint of the LM trainer's ``(params, opt_state)``
    pair as the reference's ``launch/train.py`` saves it: ``0/lm/...``
    (and ``0/encoder/...``) the parameters, ``1/count``, ``1/m/lm/...``
    and ``1/v/lm/...`` (and ``encoder``) the AdamW state (``.../q`` and
    ``.../s`` for int8 moments), blocks stacked, in the reference's
    flatten order; tensors detached, on their devices."""
    params = {n: p.detach() for n, p in model.named_parameters()}
    return flatten((
        model_tree_to_jax(params, cfg),
        {"count": opt_state["count"],
         "m": model_tree_to_jax(opt_state["m"], cfg),
         "v": model_tree_to_jax(opt_state["v"], cfg)}))


def lm_state_from_jax(flat: Mapping[str, torch.Tensor], model, cfg) -> dict:
    """Load the flat ``(params, opt_state)`` checkpoint ``flat`` (as
    :func:`restore` reads it against :func:`lm_state_to_jax`'s keys) into
    ``model``'s parameters in place; returns the optimizer state, on the
    model's device."""
    params, opt = unflatten(flat)
    dev = model.device
    named = model_tree_from_jax(params, cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(named[name])

    def moments(tree):
        return {n: ({k: t.to(dev) for k, t in v.items()}
                    if isinstance(v, dict) else v.to(dev))
                for n, v in model_tree_from_jax(tree, cfg).items()}

    return {"m": moments(opt["m"]), "v": moments(opt["v"]),
            "count": opt["count"].to(dev)}


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
