"""Build, load and launch the port's CUDA kernels.

The sources in ``repro_torch/csrc/*.cu`` are compiled for ``sm_90a`` on
first use: one ``nvcc -c`` per source (with its own flags from
:data:`SOURCES`), all started together, then one link into a shared
library with a plain C interface, loaded with ``ctypes``.  The library
lands in ``<repo>/build/kernels/`` under a name keyed by a hash of the
sources and flags, so a changed source rebuilds and
an unchanged one loads the cached library.  A failed build or launch
raises; nothing falls back to the plain versions.

Every launcher takes the device index first and the stream last, and
returns ``cudaGetLastError()``; :func:`launch` raises if that is not 0
and counts the launch in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: each source with its flags on top of NVCC_FLAGS.  The boundary kernels
#: and the RG-LRU scan promise their plain versions' bits: those round
#: after every operation (and one ulp in a stepped value can flip an int8
#: at a rounding tie), so no FMA contraction.  Flash attention promises a
#: tolerance and keeps nvcc's default FMAs.
SOURCES = {
    "quant.cu": ("--fmad=false",),
    "fused_sampler.cu": ("--fmad=false",),
    "flash_attention.cu": (),
    "rglru.cu": ("--fmad=false",),
}
HEADERS = ("rowquant.cuh",)
# IEEE division and square root everywhere (no fast math)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signature of each launcher, between the leading device index and the
# trailing stream
SIGNATURES = {
    # x, eps_c, eps_u, dtype, guidance, c1, c2, mode, out, n
    "fused_cfg_step": (_P, _P, _P, _I, _F, _F, _F, _I, _P, _LL),
    # x, dtype, q, s, rows, len
    "quant_int8": (_P, _I, _P, _P, _LL, _I),
    # q, s, out, rows, len
    "dequant_int8": (_P, _P, _P, _LL, _I),
    # x, eps_c, eps_u, dtype, coeffs, guidance, mode, q, s, rows, len, then
    # the plan (fused_sampler/ops.py::emit_plan): route, vec, per_thread,
    # threads, cluster
    "fused_cfg_step_quant": (_P, _P, _P, _I, _P, _F, _I, _P, _P, _LL, _I,
                             _I, _I, _I, _I, _I),
    # q, s, eps_c, eps_u, dtype, coeffs, guidance, mode, out, rows, len
    "fused_cfg_step_dequant": (_P, _P, _P, _P, _I, _P, _F, _I, _P, _LL, _I),
    # q, k, v, o, dtype, B, H, KV, S, T, D, (b, h, s) element strides of
    # q, k, v and o, causal, window, softcap, scale, kv_len, variant,
    # split_len, splits, split scratch, split counters
    "flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        *(_LL,) * 12, _I, _I, _F, _F, _I, _I, _I, _I, _P,
                        _P),
    # a, b, h, B, S, R
    "rglru_scan": (_P, _P, _P, _I, _I, _I),
}
#: launches per kernel since the last :func:`reset_launches`
LAUNCHES = {name: 0 for name in SIGNATURES}
FLOAT_DTYPES = (torch.float32, torch.bfloat16)
MODES = {"ddim": 0, "rf": 1}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (*SOURCES, *HEADERS):
        h.update(name.encode())
        h.update(" ".join(SOURCES.get(name, ())).encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    return BUILD_DIR / f"libreprotorch_{_digest()}.so"


def build_log_path() -> Path:
    return BUILD_DIR / f"nvcc_{_digest()}.log"


def build() -> Path:
    """Compile the sources (if the cached library is missing) and return
    the library's path.  ``nvcc``'s output, ``-Xptxas -v``'s register and
    spill counts included, is kept in :func:`build_log_path`."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for src, flags in SOURCES.items():
            obj = tmp / (Path(src).stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *flags, "-c", str(CSRC / src), "-o",
                 str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        log = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src}\n{out}")
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        tmp_lib = tmp / lib.name
        link = subprocess.run(
            [nvcc, "-shared", *(str(obj) for _, obj, _ in procs),
             "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        build_log_path().write_text("\n".join(log))
        os.replace(tmp_lib, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, f"repro_{name}")
                fn.argtypes = (_I, *args, _P)
                fn.restype = _I
            lib.repro_cuda_error_string.argtypes = (_I,)
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            lib.repro_empty.argtypes = (_I, _P)
            lib.repro_empty.restype = _I
            _lib = lib
    return _lib


def _raise_on(err: int, name: str) -> None:
    if err:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on ``device``'s current stream; raise if the
    launch was refused, else count it."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    _raise_on(getattr(lib, f"repro_{name}")(device.index or 0, *args, stream),
              name)
    LAUNCHES[name] += 1


def launch_empty(device: torch.device) -> None:
    """Launch a kernel that does nothing, by the same path as the kernels
    but uncounted: the launch-latency floor, for measurement."""
    stream = torch.cuda.current_stream(device).cuda_stream
    _raise_on(library().repro_empty(device.index or 0, stream), "empty")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the CPU (the wrapper then runs the
    plain version), False if every one is on CUDA; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel operands must all be on the CPU or all on "
                     f"CUDA, got {sorted(kinds)}")


def rows_of(x: torch.Tensor) -> tuple:
    """``(rows, L)`` of ``x`` seen as rows over its last dim."""
    length = x.shape[-1]
    return (x.numel() // length if length else 0), length


def check(t: torch.Tensor, name: str, dtypes, shape=None) -> None:
    """Validate a kernel operand: dtype, contiguity and (optionally) shape."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernels take contiguous tensors")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def dtype_code(t: torch.Tensor) -> int:
    return FLOAT_DTYPES.index(t.dtype)
