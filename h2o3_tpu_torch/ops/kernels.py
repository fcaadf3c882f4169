"""Build, bind and launch the hand-written CUDA kernels of the port.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface at first use (one
``nvcc`` per source, all started together), and bound with ``ctypes``.
The libraries land in ``h2o3_tpu_torch/_build/`` under names that carry
one hash of all the sources (``*.cu`` and ``*.cuh``) and the flags, so an
edited source rebuilds and an unchanged tree loads the libraries already
there.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, and the scratch workspace whose size the library reports for the
shapes, with torch on the tensors' device, launches on the current
stream, raises when the launch returns a CUDA error, and adds one to its
entry in ``LAUNCHES``. They take CUDA tensors only: the dispatchers in
``ops/hist_adaptive.py`` and ``ops/histogram.py`` send CPU tensors to the
plain versions.
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
            "binned_level_i8": 0, "adaptive_level": 0,
            "adaptive_route_only": 0, "adaptive_level_i8": 0,
            "leaf_totals": 0, "segment_totals": 0, "global_hist": 0}

_lock = threading.Lock()
_libs: Optional[Dict[str, ctypes.CDLL]] = None
_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures: library stem -> {function: argtypes}; every function
# returns a cudaError_t as int
_SIGNATURES = {
    "hist_binned": {
        "h2o3_binned_level_workspace": [_INT, _LL, _INT, _INT, _INT, _INT,
                                        _INT, _INT],
        "h2o3_binned_level": [_VP, _INT, _VP, _VP, _VP, _LL, _INT, _INT,
                              _INT, _INT, _INT, _INT, _INT, _VP, _VP, _VP,
                              _VP],
        "h2o3_binned_route_only": [_VP, _INT, _VP, _VP, _LL, _INT, _INT,
                                   _INT, _INT, _VP, _VP],
        "h2o3_binned_level_picks": [_LL, _INT, _INT, _INT, _INT],
        "h2o3_binned_level_i8_workspace": [_INT, _LL, _INT, _INT, _INT,
                                           _INT, _INT, _INT],
        "h2o3_binned_level_i8": [_VP, _INT, _VP, _VP, _INT, _VP, _VP, _LL,
                                 _INT, _INT, _INT, _INT, _INT, _INT, _VP,
                                 _VP, _VP, _VP],
        "h2o3_binned_level_i8_picks": [_INT, _LL, _INT, _INT, _INT, _INT,
                                       _INT],
    },
    "hist_adaptive": {
        "h2o3_adaptive_level": [_VP, _INT, _VP, _VP, _VP, _VP, _VP, _LL,
                                _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                                _VP, _VP, _VP, _VP],
        "h2o3_adaptive_level_workspace": [_INT, _LL, _INT, _INT, _INT, _INT,
                                          _INT, _INT, _INT],
        "h2o3_adaptive_level_picks": [_INT, _LL, _INT, _INT, _INT, _INT],
        "h2o3_adaptive_level_atomics": [_VP, _VP, _VP, _VP, _VP, _VP, _LL,
                                        _INT, _INT, _INT, _INT, _INT, _INT,
                                        _VP, _VP, _VP, _VP],
        "h2o3_group_rows_workspace": [_LL, _INT],
        "h2o3_group_rows": [_VP, _VP, _VP, _INT, _LL, _INT, _VP, _VP, _VP,
                            _VP],
        "h2o3_adaptive_route_only": [_VP, _INT, _VP, _VP, _LL, _INT, _INT,
                                     _INT, _VP, _VP],
        "h2o3_adaptive_level_i8_workspace": [_INT, _LL, _INT, _INT, _INT,
                                             _INT, _INT, _INT],
        "h2o3_adaptive_level_i8": [_VP, _INT, _VP, _VP, _INT, _VP, _VP, _VP,
                                   _VP, _LL, _INT, _INT, _INT, _INT, _INT,
                                   _INT, _VP, _VP, _VP, _VP],
        "h2o3_adaptive_level_i8_picks": [_INT, _LL, _INT, _INT, _INT, _INT,
                                         _INT],
        "h2o3_leaf_totals_workspace": [_LL, _INT],
        "h2o3_leaf_totals": [_VP, _VP, _VP, _VP, _LL, _INT, _INT, _INT, _INT,
                             _VP, _VP, _VP, _VP],
        "h2o3_segment_totals": [_VP, _VP, _LL, _INT, _INT, _VP, _VP, _VP],
    },
    "hist_global": {
        "h2o3_global_hist_workspace": [_INT, _LL, _INT, _INT, _INT, _INT,
                                       _VP],
        "h2o3_global_hist": [_VP, _INT, _VP, _VP, _LL, _INT, _INT, _INT,
                             _INT, _VP, _VP, _VP],
        "h2o3_global_hist_form": [_VP, _INT, _VP, _VP, _LL, _INT, _INT,
                                  _INT, _INT, _INT, _VP, _VP, _VP],
    },
}
# the workspace queries return a byte count (-1: shapes refused); the
# form queries (*_picks) a form code (LEVEL_FORMS), every other function a
# cudaError_t, as int
_RETURNS_BYTES = ("h2o3_binned_level_workspace",
                  "h2o3_binned_level_i8_workspace",
                  "h2o3_adaptive_level_workspace",
                  "h2o3_adaptive_level_i8_workspace",
                  "h2o3_group_rows_workspace", "h2o3_leaf_totals_workspace",
                  "h2o3_global_hist_workspace")


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
                getattr(lib, fn).restype = (_LL if fn in _RETURNS_BYTES
                                            else _INT)
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


def _check_qs(q, scales, rows: int, dev) -> int:
    """The int8 masses of ``quantize_ghw_i8``: q int8 [3·terms, rows]
    (terms 1 or 2), scales float32 [3]; at most ``I8_MAX_ROWS`` rows, so
    that int32 sums cannot overflow. Returns terms."""
    from h2o3_tpu_torch.ops.hist_adaptive import I8_MAX_ROWS
    if q.dim() != 2 or q.shape[0] not in (3, 6):
        raise ValueError(f"q must be [3 or 6, rows], got {tuple(q.shape)}")
    _check("q", q, torch.int8, (q.shape[0], rows), dev)
    _check("scales", scales, torch.float32, (3,), dev)
    if rows > I8_MAX_ROWS:
        raise ValueError(f"{rows} rows exceed the int8 levels' "
                         f"{I8_MAX_ROWS}-row cap (int32 sums)")
    return q.shape[0] // 3


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# The forms of the levels (binned_level, adaptive_level and their int8
# instances; the C entries' form argument, csrc/level_wide.cuh
# LevelForm): the kernel's pick from the shapes (level_form,
# i8_level_form), or one forced by name. "grouped" is the tensor-core
# node-grouped body (W <= 32), "wide" the scatter over rows grouped by
# parent (float levels at W = 32 and up, int8 ones at W = 64 and up),
# "tiled" the tiled body.
LEVEL_FORMS = {"picked": -1, "tiled": 0, "grouped": 1, "wide": 2}
_FORM_NAMES = {v: k for k, v in LEVEL_FORMS.items()}


def _form_code(form) -> int:
    """A form's code; True and False stand for "grouped" and "tiled"."""
    if isinstance(form, bool):
        return int(form)
    if form not in LEVEL_FORMS:
        raise ValueError(f"unknown level form {form!r}; expected one of "
                         f"{sorted(LEVEL_FORMS)}")
    return LEVEL_FORMS[form]


def _binned_level(codes, nid, ghw, tables, n_prev: int, n_nodes: int,
                  level_base: int, W: int, bf16: bool, form: int):
    rows, F, dev = _check_common(codes, nid, tables, n_prev, W)
    _check("ghw", ghw, torch.float32, (3, rows), dev)
    lib = build()["hist_binned"]
    nid_out = torch.empty_like(nid)
    hist = torch.zeros((3, n_nodes, F, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        # the grouped form's grouping and block partials (none for the
        # tiled body); -1: a forced grouped form that does not fit, which
        # its launch refuses
        ws = _workspace(max(lib.h2o3_binned_level_workspace(
            codes.element_size(), rows, F, W, n_prev, n_nodes, int(bf16),
            form), 0), "binned_level", dev)
        rc = lib.h2o3_binned_level(
            codes.data_ptr(), codes.element_size(), nid.data_ptr(),
            ghw.data_ptr(), tables.data_ptr(), rows, F, W, n_prev, n_nodes,
            level_base, int(bf16), form, nid_out.data_ptr(), hist.data_ptr(),
            ws.data_ptr(), _stream(dev))
    _raise_on(rc, "binned_level")
    LAUNCHES["binned_level"] += 1
    return nid_out, hist


def binned_level(codes: torch.Tensor, nid: torch.Tensor, ghw: torch.Tensor,
                 tables: torch.Tensor, n_prev: int, n_nodes: int,
                 level_base: int, W: int, bf16: bool):
    """Launch the fused route + histogram level kernel. Same contract as
    ``hist_adaptive.binned_level_plain``; ``tables`` is int32
    [4, max(n_prev, 1)] (feat, split_bin, na_left, can). The kernel
    picks its form from the shapes (``csrc/level_wide.cuh``
    ``level_form``): rows grouped by parent, then one-hot products on the
    tensor cores below W = 64 and the wide body's fixed-order scatter at
    W = 64, 128, 256, both summed in a fixed order; the tiled body where
    neither takes the shapes."""
    return _binned_level(codes, nid, ghw, tables, n_prev, n_nodes,
                         level_base, W, bf16, -1)


def binned_level_form(codes: torch.Tensor, nid: torch.Tensor,
                      ghw: torch.Tensor, tables: torch.Tensor, n_prev: int,
                      n_nodes: int, level_base: int, W: int, bf16: bool,
                      form):
    """``binned_level`` with one form of the kernel forced, by name
    (``LEVEL_FORMS``: "grouped", "wide", "tiled"; True and False stand
    for "grouped" and "tiled"). A grouped form where the shapes do not fit
    it, or at a W it has no instance for (the wide body below W = 32),
    raises. For the tests and ``chip_smoke.py``'s timing of the forms;
    the training path calls ``binned_level``."""
    return _binned_level(codes, nid, ghw, tables, n_prev, n_nodes,
                         level_base, W, bf16, _form_code(form))


def binned_level_picks(rows: int, F: int, W: int, n_prev: int,
                       n_nodes: int) -> str:
    """The name of the form ``binned_level`` takes at these shapes (the
    kernel's rule, ``level_form``); builds the libraries."""
    return _FORM_NAMES[build()["hist_binned"].h2o3_binned_level_picks(
        rows, F, W, n_prev, n_nodes)]


def _binned_level_i8(codes, nid, q, scales, tables, n_prev: int,
                     n_nodes: int, level_base: int, W: int, form: int):
    rows, F, dev = _check_common(codes, nid, tables, n_prev, W)
    terms = _check_qs(q, scales, rows, dev)
    lib = build()["hist_binned"]
    nid_out = torch.empty_like(nid)
    hist = torch.empty((3, n_nodes, F, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        # a grouped form's grouping and block partials, or the tiled
        # body's int32 sums; -1: a forced grouped form that does not fit
        # or has no instance at W, which its launch refuses
        ws = _workspace(max(lib.h2o3_binned_level_i8_workspace(
            codes.element_size(), rows, F, W, n_prev, n_nodes, terms, form),
            0), "binned_level_i8", dev)
        rc = lib.h2o3_binned_level_i8(
            codes.data_ptr(), codes.element_size(), nid.data_ptr(),
            q.data_ptr(), terms, scales.data_ptr(), tables.data_ptr(), rows,
            F, W, n_prev, n_nodes, level_base, form, nid_out.data_ptr(),
            hist.data_ptr(), ws.data_ptr(), _stream(dev))
    _raise_on(rc, "binned_level_i8")
    LAUNCHES["binned_level_i8"] += 1
    return nid_out, hist


def binned_level_i8(codes: torch.Tensor, nid: torch.Tensor, q: torch.Tensor,
                    scales: torch.Tensor, tables: torch.Tensor, n_prev: int,
                    n_nodes: int, level_base: int, W: int):
    """Launch the packed level kernel on int8 fixed-point masses. Same
    contract as ``hist_adaptive.binned_level_i8_plain``. The kernel picks
    its form from the shapes (``csrc/level_wide.cuh`` ``i8_level_form``):
    rows grouped by parent, then int8 one-hot products on the tensor
    cores (W <= 32) or the wide body's integer scatter (W = 64, 128,
    256), merged and flushed in one pass; or the tiled body with its
    flush. Every form gives the same bits."""
    return _binned_level_i8(codes, nid, q, scales, tables, n_prev, n_nodes,
                            level_base, W, -1)


def binned_level_i8_form(codes: torch.Tensor, nid: torch.Tensor,
                         q: torch.Tensor, scales: torch.Tensor,
                         tables: torch.Tensor, n_prev: int, n_nodes: int,
                         level_base: int, W: int, form):
    """``binned_level_i8`` with one form of the kernel forced, by name as
    in ``binned_level_form`` ("grouped" at W <= 32, "wide" at W = 64,
    128, 256, "tiled"). A grouped form where the shapes do not fit it, or
    at a W it has no instance for, raises. For the tests and
    ``chip_smoke.py``; the training path calls ``binned_level_i8``."""
    return _binned_level_i8(codes, nid, q, scales, tables, n_prev, n_nodes,
                            level_base, W, _form_code(form))


def binned_level_i8_picks(rows: int, F: int, W: int, n_prev: int,
                          n_nodes: int, terms: int) -> str:
    """The name of the form ``binned_level_i8`` takes at these shapes
    (the kernel's rule, ``i8_level_form``; int8 codes, int16 at W = 256);
    builds the libraries."""
    from h2o3_tpu_torch.ops.hist_adaptive import code_dtype
    return _FORM_NAMES[build()["hist_binned"].h2o3_binned_level_i8_picks(
        code_dtype(W).itemsize, rows, F, W, n_prev, n_nodes, terms)]


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


def _workspace(nbytes: int, name: str, dev) -> torch.Tensor:
    if nbytes < 0:
        raise ValueError(f"{name}: shapes refused by the kernel")
    return torch.empty(max(nbytes, 1), dtype=torch.uint8, device=dev)


def _adaptive_level(x, nid, ghw, tables, lo, inv, n_prev: int, n_nodes: int,
                    level_base: int, W: int, bf16: bool, layout: str,
                    atomics: bool, form: int = -1):
    rows, F, dev = _check_adaptive(x, nid, tables, n_prev, layout)
    _check_W(W)
    _check("ghw", ghw, torch.float32, (3, rows), dev)
    _check("lo", lo, torch.float32, (n_nodes, F), dev)
    _check("inv", inv, torch.float32, (n_nodes, F), dev)
    lib = build()["hist_adaptive"]
    feat_major = int(layout == "f_rows")
    nid_out = torch.empty_like(nid)
    hist = torch.zeros((3, n_nodes, F, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        # -1: a grouped form forced where it does not fit (or in
        # [F, rows]), which its launch refuses; the ablation raises here
        nbytes = lib.h2o3_adaptive_level_workspace(
            feat_major, rows, F, W, n_prev, n_nodes, int(bf16),
            int(atomics), form)
        ws = _workspace(nbytes if atomics or form < 0 else max(nbytes, 0),
                        "adaptive_level", dev)
        args = (x.data_ptr(), nid.data_ptr(), ghw.data_ptr(),
                tables.data_ptr(), lo.data_ptr(), inv.data_ptr(), rows, F, W,
                n_prev, n_nodes, level_base, int(bf16))
        out = (nid_out.data_ptr(), hist.data_ptr(), ws.data_ptr(),
               _stream(dev))
        if atomics:
            rc = lib.h2o3_adaptive_level_atomics(*args, *out)
        else:
            rc = lib.h2o3_adaptive_level(args[0], feat_major, *args[1:],
                                         form, *out)
    _raise_on(rc, "adaptive_level")
    LAUNCHES["adaptive_level"] += 1
    return nid_out, hist


def adaptive_level(x: torch.Tensor, nid: torch.Tensor, ghw: torch.Tensor,
                   tables: torch.Tensor, lo: torch.Tensor, inv: torch.Tensor,
                   n_prev: int, n_nodes: int, level_base: int, W: int,
                   bf16: bool, layout: str):
    """Launch the adaptive route + re-bin + histogram level. Same
    contract as ``hist_adaptive.adaptive_level_plain``; ``tables`` is
    float32 [4, max(n_prev, 1)] (feat, thr, na_left, can), ``lo``/``inv``
    float32 [n_nodes, F]. In ``"rows_f"`` (K8) the rows are grouped by
    parent first and the histogram is a tensor-core one-hot product below
    W = 64 and the wide body's fixed-order scatter at W = 64, 128, 256,
    both summed in a fixed order (``csrc/level_wide.cuh``
    ``level_form``); ``"f_rows"`` (K5) takes the tiled body."""
    return _adaptive_level(x, nid, ghw, tables, lo, inv, n_prev, n_nodes,
                           level_base, W, bf16, layout, False)


def adaptive_level_form(x: torch.Tensor, nid: torch.Tensor,
                        ghw: torch.Tensor, tables: torch.Tensor,
                        lo: torch.Tensor, inv: torch.Tensor, n_prev: int,
                        n_nodes: int, level_base: int, W: int, bf16: bool,
                        layout: str, form):
    """``adaptive_level`` with one form of the kernel forced, by name as
    in ``binned_level_form``. A grouped form in ``"f_rows"`` or where the
    shapes do not fit it raises. For the tests and ``chip_smoke.py``; the
    training path calls ``adaptive_level``."""
    return _adaptive_level(x, nid, ghw, tables, lo, inv, n_prev, n_nodes,
                           level_base, W, bf16, layout, False,
                           _form_code(form))


def adaptive_level_picks(rows: int, F: int, W: int, n_prev: int,
                         n_nodes: int, layout: str = "rows_f") -> str:
    """The name of the form ``adaptive_level`` takes at these shapes (the
    kernel's rule, ``level_form``); builds the libraries."""
    return _FORM_NAMES[build()["hist_adaptive"].h2o3_adaptive_level_picks(
        int(layout == "f_rows"), rows, F, W, n_prev, n_nodes)]


def adaptive_level_atomics(x: torch.Tensor, nid: torch.Tensor,
                           ghw: torch.Tensor, tables: torch.Tensor,
                           lo: torch.Tensor, inv: torch.Tensor, n_prev: int,
                           n_nodes: int, level_base: int, W: int,
                           bf16: bool):
    """``adaptive_level`` in ``"rows_f"`` with the grouped kernel's
    shared float atomics in place of its tensor-core products: the
    ablation the design was measured against, for the tests and
    ``chip_smoke.py``; no path calls it."""
    return _adaptive_level(x, nid, ghw, tables, lo, inv, n_prev, n_nodes,
                           level_base, W, bf16, "rows_f", True)


def group_rows(keys: torch.Tensor, n_groups: int, ghw=None, q=None):
    """Launch the row grouping of the node-grouped kernels alone (the
    level and histogram wrappers run it inside their launch): ``keys``
    int32 [rows], a key outside [0, n_groups) leaves its row out; ``ghw``
    float32 [3, rows], or ``q`` int8 [3·terms, rows] (terms 1 or 2), or
    neither. Returns (offsets int32 [n_groups + 1], rec: per kept row, key
    0's first and each key's in ascending row order, rows past
    offsets[-1] unwritten): float32 [rows, 4], its id (int32 bits) and its
    (g, h, w), zeros without ghw; with ``q`` the int8 records, int32
    [rows, 2] at one term and [rows, 4] at two, as
    ``common.pack_i8_records_plain`` packs them. Its plain version,
    ``common.group_rows_plain``, gives the ids alone. It counts in no
    ``LAUNCHES`` entry: inside a level or histogram launch it is part of
    that kernel's one count."""
    _check_cuda(keys)
    rows = keys.shape[0]
    dev = keys.device
    _check("keys", keys, torch.int32, (rows,), dev)
    if ghw is not None:
        _check("ghw", ghw, torch.float32, (3, rows), dev)
    terms = 0
    if q is not None:
        if ghw is not None:
            raise ValueError("group_rows takes ghw or q, not both")
        if q.dim() != 2 or q.shape[0] not in (3, 6):
            raise ValueError(f"q must be [3 or 6, rows], got "
                             f"{tuple(q.shape)}")
        _check("q", q, torch.int8, (q.shape[0], rows), dev)
        terms = q.shape[0] // 3
    lib = build()["hist_adaptive"]
    offsets = torch.empty(n_groups + 1, dtype=torch.int32, device=dev)
    if terms:
        rec = torch.empty((max(rows, 1), 2 * terms), dtype=torch.int32,
                          device=dev)
    else:
        rec = torch.empty((max(rows, 1), 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        ws = _workspace(lib.h2o3_group_rows_workspace(rows, n_groups),
                        "group_rows", dev)
        rc = lib.h2o3_group_rows(
            keys.data_ptr(), 0 if ghw is None else ghw.data_ptr(),
            0 if q is None else q.data_ptr(), terms, rows, n_groups,
            offsets.data_ptr(), rec.data_ptr(), ws.data_ptr(), _stream(dev))
    _raise_on(rc, "group_rows")
    return offsets, rec[:rows]


def _adaptive_level_i8(x, nid, q, scales, tables, lo, inv, n_prev: int,
                       n_nodes: int, level_base: int, W: int, layout: str,
                       form: int):
    rows, F, dev = _check_adaptive(x, nid, tables, n_prev, layout)
    _check_W(W)
    terms = _check_qs(q, scales, rows, dev)
    _check("lo", lo, torch.float32, (n_nodes, F), dev)
    _check("inv", inv, torch.float32, (n_nodes, F), dev)
    lib = build()["hist_adaptive"]
    feat_major = int(layout == "f_rows")
    nid_out = torch.empty_like(nid)
    hist = torch.empty((3, n_nodes, F, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        # as in _binned_level_i8; -1 also for a grouped form forced in
        # [F, rows]
        ws = _workspace(max(lib.h2o3_adaptive_level_i8_workspace(
            feat_major, rows, F, W, n_prev, n_nodes, terms, form), 0),
            "adaptive_level_i8", dev)
        rc = lib.h2o3_adaptive_level_i8(
            x.data_ptr(), feat_major, nid.data_ptr(), q.data_ptr(), terms,
            scales.data_ptr(), tables.data_ptr(), lo.data_ptr(),
            inv.data_ptr(), rows, F, W, n_prev, n_nodes, level_base, form,
            nid_out.data_ptr(), hist.data_ptr(), ws.data_ptr(), _stream(dev))
    _raise_on(rc, "adaptive_level_i8")
    LAUNCHES["adaptive_level_i8"] += 1
    return nid_out, hist


def adaptive_level_i8(x: torch.Tensor, nid: torch.Tensor, q: torch.Tensor,
                      scales: torch.Tensor, tables: torch.Tensor,
                      lo: torch.Tensor, inv: torch.Tensor, n_prev: int,
                      n_nodes: int, level_base: int, W: int, layout: str):
    """Launch the adaptive level kernel on int8 fixed-point masses. Same
    contract as ``hist_adaptive.adaptive_level_i8_plain``. The kernel
    picks its form from the shapes (``csrc/level_wide.cuh``
    ``i8_level_form``): in ``"rows_f"`` the node-grouped int8 forms
    (tensor-core at W <= 32, wide at W = 64, 128, 256) or the tiled body;
    in ``"f_rows"`` the tiled body."""
    return _adaptive_level_i8(x, nid, q, scales, tables, lo, inv, n_prev,
                              n_nodes, level_base, W, layout, -1)


def adaptive_level_i8_form(x: torch.Tensor, nid: torch.Tensor,
                           q: torch.Tensor, scales: torch.Tensor,
                           tables: torch.Tensor, lo: torch.Tensor,
                           inv: torch.Tensor, n_prev: int, n_nodes: int,
                           level_base: int, W: int, layout: str, form):
    """``adaptive_level_i8`` with one form of the kernel forced, by name
    as in ``binned_level_i8_form``. A grouped form in ``"f_rows"``, where
    the shapes do not fit it or at a W it has no instance for raises. For
    the tests and ``chip_smoke.py``; the training path calls
    ``adaptive_level_i8``."""
    return _adaptive_level_i8(x, nid, q, scales, tables, lo, inv, n_prev,
                              n_nodes, level_base, W, layout,
                              _form_code(form))


def adaptive_level_i8_picks(rows: int, F: int, W: int, n_prev: int,
                            n_nodes: int, terms: int,
                            layout: str = "rows_f") -> str:
    """The name of the form ``adaptive_level_i8`` takes at these shapes
    (the kernel's rule, ``i8_level_form``); builds the libraries."""
    return _FORM_NAMES[build()["hist_adaptive"].h2o3_adaptive_level_i8_picks(
        int(layout == "f_rows"), rows, F, W, n_prev, n_nodes, terms)]


def _totals_workspace(lib, rows: int, n_nodes: int, name: str, dev):
    if not 1 <= n_nodes <= 4096:
        raise ValueError(f"{name}: n_nodes {n_nodes} outside [1, 4096]")
    return _workspace(lib.h2o3_leaf_totals_workspace(rows, n_nodes), name,
                      dev)


def leaf_totals(x: torch.Tensor, nid: torch.Tensor, ghw: torch.Tensor,
                tables: torch.Tensor, n_prev: int, n_nodes: int,
                level_base: int):
    """Launch the leaf-totals kernel. Same contract as
    ``hist_adaptive.leaf_totals_plain`` (x [rows, F] float32); returns
    (nid', totals [3, n_nodes] float32), summed in a fixed order."""
    rows, F, dev = _check_adaptive(x, nid, tables, n_prev, "rows_f")
    _check("ghw", ghw, torch.float32, (3, rows), dev)
    lib = build()["hist_adaptive"]
    nid_out = torch.empty_like(nid)
    totals = torch.zeros((3, n_nodes), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        ws = _totals_workspace(lib, rows, n_nodes, "leaf_totals", dev)
        rc = lib.h2o3_leaf_totals(
            x.data_ptr(), nid.data_ptr(), ghw.data_ptr(), tables.data_ptr(),
            rows, F, n_prev, n_nodes, level_base, nid_out.data_ptr(),
            totals.data_ptr(), ws.data_ptr(), _stream(dev))
    _raise_on(rc, "leaf_totals")
    LAUNCHES["leaf_totals"] += 1
    return nid_out, totals


def segment_totals(nid: torch.Tensor, ghw: torch.Tensor, n_nodes: int,
                   level_base: int) -> torch.Tensor:
    """Launch the leaf-totals kernel's instance without a route: the
    (g, h, w) sums of the rows whose ``nid`` lies in ``[level_base,
    level_base + n_nodes)``, per node, in a fixed order. Same contract as
    ``common.segment_totals_plain``; returns totals [3, n_nodes]
    float32."""
    _check_cuda(nid)
    rows = nid.shape[0]
    dev = nid.device
    _check("nid", nid, torch.int32, (rows,), dev)
    _check("ghw", ghw, torch.float32, (3, rows), dev)
    lib = build()["hist_adaptive"]
    totals = torch.zeros((3, n_nodes), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        ws = _totals_workspace(lib, rows, n_nodes, "segment_totals", dev)
        rc = lib.h2o3_segment_totals(
            nid.data_ptr(), ghw.data_ptr(), rows, n_nodes, level_base,
            totals.data_ptr(), ws.data_ptr(), _stream(dev))
    _raise_on(rc, "segment_totals")
    LAUNCHES["segment_totals"] += 1
    return totals


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


def _global_hist(codes: torch.Tensor, seg: torch.Tensor, ghw: torch.Tensor,
                 n_nodes: int, n_bins1: int, bf16: bool,
                 grouped: Optional[bool]) -> torch.Tensor:
    _check_cuda(codes)
    if codes.dim() != 2:
        raise ValueError(f"codes must be [rows, F], got {tuple(codes.shape)}")
    if codes.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"codes has dtype {codes.dtype}, expected uint8 or "
                        f"int32")
    if n_nodes < 1 or n_bins1 < 1:
        raise ValueError(f"n_nodes {n_nodes} and n_bins1 {n_bins1} must be "
                         f">= 1")
    rows, F = codes.shape
    dev = codes.device
    _check("codes", codes, codes.dtype, (rows, F), dev)
    _check("seg", seg, torch.int32, (rows,), dev)
    _check("ghw", ghw, torch.float32, (3, rows), dev)
    lib = build()["hist_global"]
    hist = torch.zeros((3, n_nodes, F, n_bins1), dtype=torch.float32,
                       device=dev)
    form = -1 if grouped is None else int(grouped)
    args = (codes.data_ptr(), codes.element_size(), seg.data_ptr(),
            ghw.data_ptr(), rows, F, n_nodes, n_bins1, int(bf16))
    with torch.cuda.device(dev):
        # the grouped form's grouping and per-block partials, or the
        # global-atomics form's float64 sums (hist_global.cu)
        picked = ctypes.c_int(0)
        nbytes = lib.h2o3_global_hist_workspace(
            codes.element_size(), rows, F, n_nodes, n_bins1, form,
            ctypes.byref(picked))
        # -1: a forced grouped form that does not fit; its launch refuses
        ws = _workspace(max(nbytes, 0), "global_hist", dev)
        if grouped is None:
            rc = lib.h2o3_global_hist(*args, ws.data_ptr(), hist.data_ptr(),
                                      _stream(dev))
        else:
            rc = lib.h2o3_global_hist_form(*args, form, ws.data_ptr(),
                                           hist.data_ptr(), _stream(dev))
    _raise_on(rc, "global_hist")
    LAUNCHES["global_hist"] += 1
    return hist


def global_hist(codes: torch.Tensor, seg: torch.Tensor, ghw: torch.Tensor,
                n_nodes: int, n_bins1: int, bf16: bool) -> torch.Tensor:
    """Launch the global-sketch histogram kernel. Same contract as
    ``histogram.build_histograms_plain``: codes [rows, F] uint8 or int32
    in [0, n_bins1), seg int32 [rows] (outside [0, n_nodes) = excluded),
    ghw float32 [3, rows]; returns hist [3, n_nodes, F, n_bins1]
    float32. The kernel picks its form from the shapes: node-grouped
    shared partials wherever a (node, feature) cell fits shared memory,
    global atomics beyond."""
    return _global_hist(codes, seg, ghw, n_nodes, n_bins1, bf16, None)


def global_hist_form(codes: torch.Tensor, seg: torch.Tensor,
                     ghw: torch.Tensor, n_nodes: int, n_bins1: int,
                     bf16: bool, shared: bool) -> torch.Tensor:
    """``global_hist`` with one form of the kernel forced: ``shared``
    True, the node-grouped shared partials (raises where a cell does not
    fit shared memory); False, global atomics. For the tests and
    ``chip_smoke.py``'s timing of both forms; the training path calls
    ``global_hist``."""
    return _global_hist(codes, seg, ghw, n_nodes, n_bins1, bf16,
                        bool(shared))
