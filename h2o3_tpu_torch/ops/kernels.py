"""Build, bind and launch the hand-written CUDA kernels of the port.

``csrc/hist_binned.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use, and bound with
``ctypes``. The library lands in ``h2o3_tpu_torch/_build/`` under a name
that carries a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads the library already there.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with torch on the tensors' device, launches on the current
stream, raises when the launch returns a CUDA error, and adds one to its
entry in ``LAUNCHES``. They take CUDA tensors only: the dispatchers in
``ops/hist_adaptive.py`` send CPU tensors to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "hist_binned.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches per kernel; a run sets these to 0 before the path it measures
LAUNCHES = {"binned_level": 0, "binned_route_only": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                           "kernels are built at first use on a CUDA host")
    return path


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libh2o3_hist_binned_{h.hexdigest()[:16]}.so"


def build() -> ctypes.CDLL:
    """Compile (when the hashed library is missing) and load the kernel
    library; later calls return the loaded library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True)
            so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{proc.stderr[-4000:]}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.h2o3_binned_level.argtypes = [
            _VP, _INT, _VP, _VP, _VP, _LL, _INT, _INT, _INT, _INT, _INT,
            _INT, _VP, _VP, _VP]
        lib.h2o3_binned_level.restype = _INT
        lib.h2o3_binned_route_only.argtypes = [
            _VP, _INT, _VP, _VP, _LL, _INT, _INT, _INT, _INT, _VP, _VP]
        lib.h2o3_binned_route_only.restype = _INT
        _lib = lib
        return lib


def build_log() -> str:
    """The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) from the build of the current library, if this host built
    it."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(codes, nid, tables, n_prev: int, W: int):
    from h2o3_tpu_torch.ops.hist_adaptive import code_dtype
    if codes.device.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on "
                         f"{codes.device}")
    if W not in (16, 32, 64, 128, 256):
        raise ValueError(f"unsupported lane width W={W}")
    if codes.dim() != 2:
        raise ValueError(f"codes must be [rows, F], got {tuple(codes.shape)}")
    rows, F = codes.shape
    dev = codes.device
    _check("codes", codes, code_dtype(W), (rows, F), dev)
    _check("nid", nid, torch.int32, (rows,), dev)
    _check("tables", tables, torch.int32, (4, max(n_prev, 1)), dev)
    return rows, F, dev


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def binned_level(codes: torch.Tensor, nid: torch.Tensor, ghw: torch.Tensor,
                 tables: torch.Tensor, n_prev: int, n_nodes: int,
                 level_base: int, W: int, bf16: bool):
    """Launch the fused route + histogram level kernel. Same contract as
    ``hist_adaptive.binned_level_plain``; ``tables`` is int32
    [4, max(n_prev, 1)] (feat, split_bin, na_left, can)."""
    rows, F, dev = _check_common(codes, nid, tables, n_prev, W)
    _check("ghw", ghw, torch.float32, (3, rows), dev)
    lib = build()
    nid_out = torch.empty_like(nid)
    hist = torch.zeros((3, n_nodes, F, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.h2o3_binned_level(
            codes.data_ptr(), codes.element_size(), nid.data_ptr(),
            ghw.data_ptr(), tables.data_ptr(), rows, F, W, n_prev, n_nodes,
            level_base, int(bf16), nid_out.data_ptr(), hist.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "binned_level")
    LAUNCHES["binned_level"] += 1
    return nid_out, hist


def binned_route_only(codes: torch.Tensor, nid: torch.Tensor,
                      tables: torch.Tensor, n_prev: int, level_base: int,
                      W: int) -> torch.Tensor:
    """Launch the deepest-level route kernel. Same contract as
    ``hist_adaptive.binned_route_only_plain``."""
    if n_prev < 1:
        raise ValueError("binned_route_only needs a previous level")
    rows, F, dev = _check_common(codes, nid, tables, n_prev, W)
    lib = build()
    nid_out = torch.empty_like(nid)
    with torch.cuda.device(dev):
        rc = lib.h2o3_binned_route_only(
            codes.data_ptr(), codes.element_size(), nid.data_ptr(),
            tables.data_ptr(), rows, F, W, n_prev, level_base,
            nid_out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "binned_route_only")
    LAUNCHES["binned_route_only"] += 1
    return nid_out
