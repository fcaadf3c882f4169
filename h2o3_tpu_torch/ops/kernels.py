"""Build, bind and launch the hand-written CUDA kernels of the port.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface at first use (one
``nvcc`` per source, all started together), and bound with ``ctypes``.
The libraries land in ``h2o3_tpu_torch/_build/`` under names that carry
one hash of all the sources (``*.cu`` and ``*.cuh``) and the flags, so an
edited source rebuilds and an unchanged tree loads the libraries already
there.

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
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches per kernel; a run sets these to 0 before the path it measures
LAUNCHES = {"binned_level": 0, "binned_route_only": 0,
            "adaptive_level": 0, "adaptive_route_only": 0}

_lock = threading.Lock()
_libs: Optional[Dict[str, ctypes.CDLL]] = None
_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures: library stem -> {function: argtypes}; every function
# returns a cudaError_t as int
_SIGNATURES = {
    "hist_binned": {
        "h2o3_binned_level": [_VP, _INT, _VP, _VP, _VP, _LL, _INT, _INT,
                              _INT, _INT, _INT, _INT, _VP, _VP, _VP],
        "h2o3_binned_route_only": [_VP, _INT, _VP, _VP, _LL, _INT, _INT,
                                   _INT, _INT, _VP, _VP],
    },
    "hist_adaptive": {
        "h2o3_adaptive_level": [_VP, _INT, _VP, _VP, _VP, _VP, _VP, _LL,
                                _INT, _INT, _INT, _INT, _INT, _INT, _VP,
                                _VP, _VP],
        "h2o3_adaptive_route_only": [_VP, _INT, _VP, _VP, _LL, _INT, _INT,
                                     _INT, _VP, _VP],
    },
}


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


def sources() -> Dict[str, Path]:
    """The kernel sources, by library stem."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_paths() -> Dict[str, Path]:
    """Where each library for the current sources and flags lives."""
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:16]
    return {stem: BUILD_DIR / f"libh2o3_{stem}_{tag}.so"
            for stem in sources()}


def build() -> Dict[str, ctypes.CDLL]:
    """Compile (where a hashed library is missing, every source at once)
    and load the kernel libraries; later calls return the loaded
    libraries, by stem."""
    global _libs
    with _lock:
        if _libs is not None:
            return _libs
        paths, srcs = library_paths(), sources()
        todo = {s: so for s, so in paths.items() if not so.exists()}
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for stem, so in todo.items():
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                procs[stem] = (tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[stem])],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
            failed = []
            for stem, (tmp, proc) in procs.items():
                out, err = proc.communicate()
                todo[stem].with_suffix(".log").write_text(out + err)
                if proc.returncode != 0:
                    failed.append(f"{srcs[stem].name} "
                                  f"({proc.returncode}):\n{err[-4000:]}")
                else:
                    os.replace(tmp, todo[stem])
            if failed:
                raise RuntimeError("nvcc failed: " + "\n".join(failed))
        libs = {}
        for stem, so in paths.items():
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in _SIGNATURES.get(stem, {}).items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _INT
            libs[stem] = lib
        _libs = libs
        return libs


def build_log() -> str:
    """The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) from the build of the current libraries, if this host built
    them."""
    logs = []
    for stem, so in library_paths().items():
        log = so.with_suffix(".log")
        if log.exists():
            logs.append(f"== {stem}\n{log.read_text()}")
    return "\n".join(logs)


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


def _check_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {t.device}")


def _check_W(W: int) -> None:
    if W not in (16, 32, 64, 128, 256):
        raise ValueError(f"unsupported lane width W={W}")


def _check_common(codes, nid, tables, n_prev: int, W: int):
    from h2o3_tpu_torch.ops.hist_adaptive import code_dtype
    _check_cuda(codes)
    _check_W(W)
    if codes.dim() != 2:
        raise ValueError(f"codes must be [rows, F], got {tuple(codes.shape)}")
    rows, F = codes.shape
    dev = codes.device
    _check("codes", codes, code_dtype(W), (rows, F), dev)
    _check("nid", nid, torch.int32, (rows,), dev)
    _check("tables", tables, torch.int32, (4, max(n_prev, 1)), dev)
    return rows, F, dev


def _check_adaptive(x, nid, tables, n_prev: int, layout: str):
    from h2o3_tpu_torch.ops.hist_adaptive import rows_features
    _check_cuda(x)
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    rows, F = rows_features(x, layout)
    dev = x.device
    _check("x", x, torch.float32, tuple(x.shape), dev)
    _check("nid", nid, torch.int32, (rows,), dev)
    _check("tables", tables, torch.float32, (4, max(n_prev, 1)), dev)
    return rows, F, dev


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def binned_level(codes: torch.Tensor, nid: torch.Tensor, ghw: torch.Tensor,
                 tables: torch.Tensor, n_prev: int, n_nodes: int,
                 level_base: int, W: int, bf16: bool):
    """Launch the fused route + histogram level kernel. Same contract as
    ``hist_adaptive.binned_level_plain``; ``tables`` is int32
    [4, max(n_prev, 1)] (feat, split_bin, na_left, can)."""
    rows, F, dev = _check_common(codes, nid, tables, n_prev, W)
    _check("ghw", ghw, torch.float32, (3, rows), dev)
    lib = build()["hist_binned"]
    nid_out = torch.empty_like(nid)
    hist = torch.zeros((3, n_nodes, F, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.h2o3_binned_level(
            codes.data_ptr(), codes.element_size(), nid.data_ptr(),
            ghw.data_ptr(), tables.data_ptr(), rows, F, W, n_prev, n_nodes,
            level_base, int(bf16), nid_out.data_ptr(), hist.data_ptr(),
            _stream(dev))
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
    lib = build()["hist_binned"]
    nid_out = torch.empty_like(nid)
    with torch.cuda.device(dev):
        rc = lib.h2o3_binned_route_only(
            codes.data_ptr(), codes.element_size(), nid.data_ptr(),
            tables.data_ptr(), rows, F, W, n_prev, level_base,
            nid_out.data_ptr(), _stream(dev))
    _raise_on(rc, "binned_route_only")
    LAUNCHES["binned_route_only"] += 1
    return nid_out


def adaptive_level(x: torch.Tensor, nid: torch.Tensor, ghw: torch.Tensor,
                   tables: torch.Tensor, lo: torch.Tensor, inv: torch.Tensor,
                   n_prev: int, n_nodes: int, level_base: int, W: int,
                   bf16: bool, layout: str):
    """Launch the adaptive route + re-bin + histogram level kernel. Same
    contract as ``hist_adaptive.adaptive_level_plain``; ``tables`` is
    float32 [4, max(n_prev, 1)] (feat, thr, na_left, can), ``lo``/``inv``
    float32 [n_nodes, F]."""
    rows, F, dev = _check_adaptive(x, nid, tables, n_prev, layout)
    _check_W(W)
    _check("ghw", ghw, torch.float32, (3, rows), dev)
    _check("lo", lo, torch.float32, (n_nodes, F), dev)
    _check("inv", inv, torch.float32, (n_nodes, F), dev)
    lib = build()["hist_adaptive"]
    nid_out = torch.empty_like(nid)
    hist = torch.zeros((3, n_nodes, F, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.h2o3_adaptive_level(
            x.data_ptr(), int(layout == "f_rows"), nid.data_ptr(),
            ghw.data_ptr(), tables.data_ptr(), lo.data_ptr(), inv.data_ptr(),
            rows, F, W, n_prev, n_nodes, level_base, int(bf16),
            nid_out.data_ptr(), hist.data_ptr(), _stream(dev))
    _raise_on(rc, "adaptive_level")
    LAUNCHES["adaptive_level"] += 1
    return nid_out, hist


def adaptive_route_only(x: torch.Tensor, nid: torch.Tensor,
                        tables: torch.Tensor, n_prev: int, level_base: int,
                        layout: str) -> torch.Tensor:
    """Launch the adaptive deepest-level route kernel. Same contract as
    ``hist_adaptive.adaptive_route_only_plain``."""
    if n_prev < 1:
        raise ValueError("adaptive_route_only needs a previous level")
    rows, F, dev = _check_adaptive(x, nid, tables, n_prev, layout)
    lib = build()["hist_adaptive"]
    nid_out = torch.empty_like(nid)
    with torch.cuda.device(dev):
        rc = lib.h2o3_adaptive_route_only(
            x.data_ptr(), int(layout == "f_rows"), nid.data_ptr(),
            tables.data_ptr(), rows, F, n_prev, level_base,
            nid_out.data_ptr(), _stream(dev))
    _raise_on(rc, "adaptive_route_only")
    LAUNCHES["adaptive_route_only"] += 1
    return nid_out
