"""Build and bind the hand-written CUDA kernels of ``eventad_tpu_torch/csrc``.

All ``*.cu`` sources compile with ``nvcc`` for ``sm_90a`` (one ``nvcc -c``
per source, all started together, then one link) into one shared library
with a plain C interface, under ``eventad_tpu_torch/build/`` (named by a
digest of the sources and flags, so an edited source rebuilds), at the first
launch of any kernel.  The library is loaded with ``ctypes``: every
pointer and the stream are ``c_void_p`` (a host array too, passed as its
ctypes array), every size a ``c_int``, and every
entry returns ``cudaGetLastError()``, which :func:`launch` turns into an
exception.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
# C entry points: name -> argument types (the stream is always last)
SIGNATURES = {
    "eventad_event_graph_search":
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "eventad_upsample_rows":
        [_P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P],
    "eventad_level0_block":
        [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
         _I, _I, _I, _I, _P, _P],
    "eventad_fused_spline_conv":
        [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "eventad_fused_plan": [_I, _I, _I, _I, _I, _P, _P],
    "eventad_bilinear_sample":
        [_P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P, _I, _I, _I, _P, _I,
         _P],
    "eventad_shift_block":
        [_P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P,
         _I, _P, _I, _I, _I, _I, _P, _P],
    "eventad_shift_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "eventad_gather_window_rows":
        [_P, _P, _P, _I, _I, _I, _I, _U, _I, _P, _P],
    "eventad_scatter_window_rows":
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "eventad_pool_graph": [_P] * 16,
    "eventad_postprocess": [_P] * 8,
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libeventad_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compiles (once per source digest) and loads the kernel library.
    ``library.build_seconds`` holds the compile time of this process (0.0
    when the library was already built)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    out = library_path()
    library.build_seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        failed = [p.returncode for p in procs if p.returncode != 0]
        if not failed:
            res = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                 *map(str, objs)], capture_output=True, text=True)
            logs.append(res.stdout + res.stderr)
            failed = [res.returncode] if res.returncode != 0 else []
        for obj in objs:
            obj.unlink(missing_ok=True)
        library.build_seconds = time.perf_counter() - t0
        (BUILD_DIR / "nvcc.log").write_text("".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n"
                               f"{''.join(logs)[-4000:]}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.eventad_error_string.argtypes = [ctypes.c_int]
    lib.eventad_error_string.restype = ctypes.c_char_p
    return lib


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (None -> NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def launch(name: str, *args) -> None:
    """Calls a C entry on the current stream; raises if the launch failed."""
    lib = library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({lib.eventad_error_string(err).decode()})")


def require(t: torch.Tensor, name: str, *, dtype, shape=None) -> None:
    """Wrapper argument check: CUDA, dtype, shape and contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
