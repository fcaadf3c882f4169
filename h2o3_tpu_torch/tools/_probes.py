"""Build, bind and launch the probe kernels (``tools/csrc/probes.cu``).

The source is compiled with ``ops/kernels.py``'s machinery (nvcc for
``sm_90a``, one nvcc per part, all started together, into
``h2o3_tpu_torch/_build/`` under a hash of it and of the headers it
includes) at the first launch, apart from the training path's libraries.
Part 0 holds P1 (``mxu_probe``), P5 (``gather_probe``, ``onehot_probe``)
and the tiled body's knock-outs; parts 1-4 the knock-outs of the grouped
float, grouped int8, wide float and wide int8 bodies.

Each wrapper takes CUDA tensors only (the tool modules send CPU tensors to
the plain versions beside them), checks them, allocates its outputs and
workspace, launches on the current stream, raises when the launch returns
a CUDA error, and adds one to its entry in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import torch

from h2o3_tpu_torch.ops import kernels

CSRC = Path(__file__).resolve().parent / "csrc"
PARTS = 5

# launches per probe kernel; a run sets these to 0 before the path it reads
LAUNCHES = {"mxu_probe": 0, "gather_probe": 0, "onehot_probe": 0,
            "level_knockout": 0}

# The knock-outs (csrc/level_common.cuh Ablate), by name.
ABLATES = {"none": 0, "route": 1, "ranges": 2, "bins": 3, "adds": 4,
           "walk": 5, "gather": 6}


@dataclass(frozen=True)
class Body:
    """A probed level body: its code in probes.cu, the probes part that
    holds it, the level it runs (``kind`` "adaptive": raw x and ranges;
    "packed": codes), its lane width, masses ("float": bf16-rounded (g, h,
    w); "i8": one int8 term), layout, the form of the training path's
    wrapper that runs the same instance, and the knock-outs it takes."""
    code: int
    part: int
    kind: str
    W: int
    mass: str
    layout: str
    form: str
    ablates: tuple


_ADAPTIVE = ("none", "route", "ranges", "bins", "adds")
_PACKED = ("none", "route", "bins", "adds")
BODIES = {
    "tiled_adaptive": Body(0, 0, "adaptive", 32, "float", "f_rows", "tiled",
                           _ADAPTIVE),
    "grouped_adaptive": Body(1, 1, "adaptive", 32, "float", "rows_f",
                             "grouped", _ADAPTIVE),
    "grouped_packed": Body(2, 1, "packed", 16, "float", "rows_f", "grouped",
                           _PACKED),
    "grouped_i8_adaptive": Body(3, 2, "adaptive", 32, "i8", "rows_f",
                                "grouped", _ADAPTIVE),
    "grouped_i8_packed": Body(4, 2, "packed", 16, "i8", "rows_f", "grouped",
                              _PACKED),
    "wide_adaptive": Body(5, 3, "adaptive", 64, "float", "rows_f", "wide",
                          _ADAPTIVE + ("walk", "gather")),
    "wide_packed": Body(6, 3, "packed", 256, "float", "rows_f", "wide",
                        _PACKED + ("walk", "gather")),
    "wide_i8_adaptive": Body(7, 4, "adaptive", 64, "i8", "rows_f", "wide",
                             _ADAPTIVE + ("gather",)),
    "wide_i8_packed": Body(8, 4, "packed", 256, "i8", "rows_f", "wide",
                           _PACKED + ("gather",)),
}
# rows the gather knock-out needs: producer p reads row p (p < 256)
GATHER_MIN_ROWS = 256

_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LEVEL = {
    "h2o3_probe_level_workspace": [_INT, _LL, _INT, _INT, _INT],
    "h2o3_probe_level": [_INT, _INT, _INT, _VP, _VP, _VP, _VP, _VP, _VP,
                         _VP, _VP, _LL, _INT, _INT, _INT, _INT, _INT, _VP,
                         _VP, _VP, _VP],
}
_SIGNATURES = {f"probes_p{k}": dict(_LEVEL) for k in range(PARTS)}
_SIGNATURES["probes_p0"].update({
    "h2o3_mxu_probe": [_VP, _VP, _INT, _INT, _INT, _INT, _INT, _VP, _VP],
    "h2o3_gather_probe": [_VP, _INT, _INT, _VP, _LL, _INT, _VP, _VP],
})
_RETURNS_BYTES = ("h2o3_probe_level_workspace",)

_lock = threading.Lock()
_libs: Optional[Dict[str, ctypes.CDLL]] = None


def _targets():
    src = CSRC / "probes.cu"
    return {f"probes_p{k}": (src, (f"-DH2O3_PROBE_PART={k}",))
            for k in range(PARTS)}


def _hashed():
    return [*kernels.CSRC.glob("*.cu*"), *CSRC.glob("*.cu*")]


def library_paths() -> Dict[str, Path]:
    """Where each probes library for the current sources lives."""
    return kernels.target_paths(_targets(), _hashed())


def build() -> Dict[str, ctypes.CDLL]:
    """Compile (where missing, every part at once) and load the probes
    libraries; later calls return the loaded ones, by stem."""
    global _libs
    with _lock:
        if _libs is None:
            _libs = kernels.build_libraries(_targets(), _hashed(),
                                            _SIGNATURES, _RETURNS_BYTES)
        return _libs


def build_log() -> str:
    """The compiler's report of the probes libraries, where this host
    built them."""
    return kernels.library_log(library_paths())


def _lib(part: int) -> ctypes.CDLL:
    return build()[f"probes_p{part}"]


def _cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: CUDA kernel called with a tensor on "
                         f"{t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ------------------------------------------------------------------ P1


def mxu_probe(L: torch.Tensor, R: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """``n_tiles · L @ R.T`` on the tensor cores, issued ``n_tiles``
    times from registers: L [M, K], R [FW, K], both bfloat16 (float32
    out) or both int8 (int32 out, exact); K · itemsize a multiple of 512
    bytes, FW of 64."""
    for name, t in (("L", L), ("R", R)):
        _cuda(name, t)
        if t.dtype not in (torch.bfloat16, torch.int8) or t.dim() != 2:
            raise TypeError(f"{name} must be a 2-D bfloat16 or int8 tensor")
    if R.dtype != L.dtype or R.shape[1] != L.shape[1]:
        raise ValueError("L and R must share dtype and K")
    M, K = L.shape
    FW = R.shape[0]
    elem = L.element_size()
    if FW % 64 or (K * elem) % 512 or n_tiles < 0:
        raise ValueError(f"mxu_probe: FW {FW} (a multiple of 64) or K bytes "
                         f"{K * elem} (of 512) refused")
    dev = L.device
    odt = torch.float32 if elem == 2 else torch.int32
    out = torch.zeros((M, FW), dtype=odt, device=dev)
    with torch.cuda.device(dev):
        rc = _lib(0).h2o3_mxu_probe(L.data_ptr(), R.data_ptr(), elem, M, FW,
                                    K, n_tiles, out.data_ptr(), _stream(dev))
    _raise_on(rc, "mxu_probe")
    LAUNCHES["mxu_probe"] += 1
    return out


# ------------------------------------------------------------------ P5


def gather_probe(tab: torch.Tensor, idx: torch.Tensor,
                 onehot: bool) -> torch.Tensor:
    """``tab[:, idx]`` (an index outside [0, N) gives 0): tab float32
    [S, N], idx int32 [rows]; ``onehot`` False, the shared-memory gather
    (exact); True, the bf16 one-hot product (exact for the bf16-rounded
    table; S <= 64, N <= 32). Returns out float32 [S, rows]."""
    _cuda("tab", tab)
    _cuda("idx", idx)
    if tab.dtype != torch.float32 or tab.dim() != 2:
        raise TypeError("tab must be float32 [S, N]")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError("idx must be int32 [rows]")
    S, N = tab.shape
    rows = idx.shape[0]
    dev = tab.device
    out = torch.empty((S, rows), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib(0).h2o3_gather_probe(tab.data_ptr(), S, N, idx.data_ptr(),
                                       rows, int(onehot), out.data_ptr(),
                                       _stream(dev))
    name = "onehot_probe" if onehot else "gather_probe"
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


# --------------------------------------------------------- the knock-outs


@dataclass
class LevelInputs:
    """One level's operands: ``vals`` x float32 ([rows, F]; the tiled
    body [F, rows]) or codes [rows, F] (int8; int16 at W = 256); nid int32
    [rows]; ghw float32 [3, rows] (float masses) or q int8 [3, rows] and
    scales float32 [3] (int8); tables float32 (adaptive) or int32 (packed)
    [4, max(n_prev, 1)]; lo, inv float32 [n_nodes, F] (adaptive)."""
    vals: torch.Tensor
    nid: torch.Tensor
    tables: torch.Tensor
    n_prev: int
    n_nodes: int
    level_base: int
    ghw: Optional[torch.Tensor] = None
    q: Optional[torch.Tensor] = None
    scales: Optional[torch.Tensor] = None
    lo: Optional[torch.Tensor] = None
    inv: Optional[torch.Tensor] = None

    def rows_features(self, body: Body):
        r, f = self.vals.shape
        return (f, r) if body.layout == "f_rows" else (r, f)


def _level_call(body_name: str, ablate: str, what: int, inp: LevelInputs):
    body = BODIES[body_name]
    if ablate not in body.ablates:
        raise ValueError(f"{body_name} takes the knock-outs {body.ablates}, "
                         f"not {ablate!r}")
    rows, F = inp.rows_features(body)
    if ablate == "gather" and rows < GATHER_MIN_ROWS:
        raise ValueError(f"the gather knock-out reads rows 0..255: {rows} "
                         f"rows")
    for name in ("vals", "nid", "tables", "ghw", "q", "scales", "lo", "inv"):
        t = getattr(inp, name)
        if t is not None:
            _cuda(name, t)
    if body.mass == "i8":
        if inp.q is None or tuple(inp.q.shape) != (3, rows) or \
                inp.q.dtype != torch.int8 or inp.scales is None:
            raise ValueError("an int8 body takes q int8 [3, rows] and "
                             "scales")
    elif inp.ghw is None or tuple(inp.ghw.shape) != (3, rows):
        raise ValueError("a float body takes ghw float32 [3, rows]")
    if body.kind == "adaptive" and (inp.lo is None or inp.inv is None):
        raise ValueError("an adaptive body takes lo and inv")
    dev = inp.vals.device
    lib = _lib(body.part)
    nbytes = lib.h2o3_probe_level_workspace(body.code, rows, F, inp.n_prev,
                                            inp.n_nodes)
    ws = kernels._workspace(nbytes, body_name, dev)
    return body, rows, F, dev, lib, ws


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _launch(body, what, ablate, inp, rows, F, dev, lib, ws, nid_out, hist):
    with torch.cuda.device(dev):
        return lib.h2o3_probe_level(
            body.code, ABLATES[ablate], what, inp.vals.data_ptr(),
            inp.nid.data_ptr(), _ptr(inp.ghw), _ptr(inp.q), _ptr(inp.scales),
            inp.tables.data_ptr(), _ptr(inp.lo), _ptr(inp.inv), rows, F,
            inp.n_prev, inp.n_nodes, inp.level_base, 1, nid_out.data_ptr(),
            hist.data_ptr(), ws.data_ptr(), _stream(dev))


def level_knockout(body_name: str, ablate: str, inp: LevelInputs):
    """One level of body ``body_name`` (``BODIES``) under knock-out
    ``ablate`` ("none" is the production instance), bf16-rounded float
    masses. Same contract as ``kern_ablate.knockout_plain``: returns
    (nid' int32 [rows], hist float32 [3, n_nodes, F, W])."""
    body, rows, F, dev, lib, ws = _level_call(body_name, ablate, 0, inp)
    nid_out = torch.empty_like(inp.nid)
    hist = torch.zeros((3, inp.n_nodes, F, body.W), dtype=torch.float32,
                       device=dev)
    rc = _launch(body, 0, ablate, inp, rows, F, dev, lib, ws, nid_out, hist)
    _raise_on(rc, f"{body_name} {ablate}")
    LAUNCHES["level_knockout"] += 1
    return nid_out, hist


def level_phases(body_name: str, inp: LevelInputs):
    """Two launches that time a grouped body's phases alone at the
    level's shapes, for the attribution: ``group()``, the level's grouping
    pass (its keys, records and the untouched rows' nid'); ``merge()``, the
    merge of the blocks' partials that the last ``group()`` or level left
    in the shared workspace (run ``level()`` once first, so that the
    partials are the level's). Returns (level, group, merge) callables on
    one workspace; none counts in ``LAUNCHES``."""
    body, rows, F, dev, lib, ws = _level_call(body_name, "none", 0, inp)
    if body.form == "tiled":
        raise ValueError("the tiled body has no grouping or merge")
    nid_out = torch.empty_like(inp.nid)
    hist = torch.zeros((3, inp.n_nodes, F, body.W), dtype=torch.float32,
                       device=dev)

    def run(what):
        def go():
            if what == 0 and body.mass == "float":
                hist.zero_()
            rc = _launch(body, what, "none", inp, rows, F, dev, lib, ws,
                         nid_out, hist)
            _raise_on(rc, f"{body_name} phase {what}")
        return go
    return run(0), run(1), run(2)
