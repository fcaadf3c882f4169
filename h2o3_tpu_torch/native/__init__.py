"""ctypes binding of the port's native CSV tokenizer, built at first use.

``fast_csv.cpp`` here is the port's own copy of the JAX package's
tokenizer (the same code; two comments that named the reference's
change history are reworded). ``lib()`` compiles it with g++ for the
portable baseline of the host's architecture into
``h2o3_tpu_torch/_build/`` under a name that carries a hash of the
source, the flags and the architecture, the way ``ops/kernels.py``
builds the CUDA sources; the compiler writes a file of its own (process
and thread in its name) and ``os.replace`` puts it in place, so
processes that build at once cannot tear it. A failed build raises with the compiler's
message: the port has no quiet fallback for a missing toolchain.

Zero-copy contract: every entry point takes any buffer numpy can view
(bytes, memoryview, an mmap slice) and hands the C scans a raw pointer
into it, so a byte-range worker tokenizes the file's page cache in
place. ctypes releases the GIL for the whole C call, so a thread pool
scales the scan across cores.

``parse_bytes`` returns column-major cell arrays carved out of a
thread-local scratch arena that is reused across calls: a caller
finishes (copies out or consumes) every returned array before the same
thread calls ``parse_bytes`` again, as ``ingest/chunk.py``
``encode_chunk_native`` does within one call. A range the scan declines
comes back as a reason string (``DECLINE_REASONS``: ``ragged_rows``,
``unterminated_quote``, ``trailing_after_quote``; or ``empty_range``),
and the parse re-reads only that range with the Python tokenizer,
counting it by reason.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
SRC = _DIR / "fast_csv.cpp"
BUILD_DIR = _DIR.parent / "_build"
COMPILER = "g++"
# no -march=native: a build stays valid on every host of the architecture
# (the scan measured no faster with it)
FLAGS = ("-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB = None

# csv_parse reason codes -> the names the parse counts declines by
DECLINE_REASONS = {1: "ragged_rows", 2: "unterminated_quote",
                   3: "trailing_after_quote"}


def library_path() -> Path:
    """Where the library for this source, these flags and this
    architecture lives."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join((COMPILER,) + FLAGS).encode())
    h.update(platform.machine().encode())
    return BUILD_DIR / f"libfastcsv_{h.hexdigest()[:16]}.so"


def build(so: Path) -> None:
    """Compile ``fast_csv.cpp`` into ``so``; raises with the compiler's
    message when the compiler cannot run or fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [COMPILER, *FLAGS, "-o", str(tmp), str(SRC)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native CSV tokenizer: '{COMPILER}' could not "
                           f"run ({e})") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native CSV tokenizer: '{COMPILER}' exited {r.returncode} "
            f"compiling {SRC.name}:\n{r.stderr.strip()[-4000:]}")
    os.replace(tmp, so)


def lib() -> ctypes.CDLL:
    """The loaded tokenizer library, built first where it is missing."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = library_path()
        if not so.exists():
            build(so)
        L = ctypes.CDLL(str(so))
        LL, VP = ctypes.c_longlong, ctypes.c_void_p
        pLL = ctypes.POINTER(ctypes.c_longlong)
        pI = ctypes.POINTER(ctypes.c_int)
        pD = ctypes.POINTER(ctypes.c_double)
        pU8 = ctypes.POINTER(ctypes.c_ubyte)
        L.csv_parse.restype = LL
        L.csv_parse.argtypes = [VP, LL, ctypes.c_char, ctypes.c_char, LL, LL,
                                VP, pLL, pI, pD, pU8, pLL, pLL]
        L.csv_chunk_bounds.restype = LL
        L.csv_chunk_bounds.argtypes = [VP, LL, ctypes.c_char, ctypes.c_char,
                                       pLL, LL, pLL]
        L.csv_enum_encode.restype = LL
        L.csv_enum_encode.argtypes = [VP, pLL, pI, LL, pI, pLL, LL]
        L.csv_gather_tokens.restype = None
        L.csv_gather_tokens.argtypes = [VP, pLL, pI, LL, LL, VP]
        L.csv_match_any.restype = None
        L.csv_match_any.argtypes = [VP, pLL, pI, LL, VP, pLL, pI, LL, pU8]
        L.csv_numeric_stats.restype = None
        L.csv_numeric_stats.argtypes = [pD, LL, pLL, LL, LL, LL, pD, pD, pU8]
        L.csv_count_rows.restype = LL
        L.csv_count_rows.argtypes = [VP, LL, ctypes.c_char, ctypes.c_char]
        L.csv_enum_encode_full.restype = LL
        L.csv_enum_encode_full.argtypes = [VP, pLL, pI, LL, VP, VP, pLL, pI,
                                           LL, LL, ctypes.c_int, pI, pLL,
                                           pU8]
        _LIB = L
        return L


def _as_u8(data) -> np.ndarray:
    """Zero-copy uint8 view of any buffer; it borrows the caller's
    buffer, which stays alive across the native call."""
    return np.frombuffer(data, dtype=np.uint8)


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _byte(s: str) -> bytes:
    return s.encode()[0:1]


# thread-local scratch arenas: the csv_parse output arrays (grown to the
# high-water cell count) and the token gather buffer, reused across calls
_TLS = threading.local()


def _scratch(ncells: int):
    bufs = getattr(_TLS, "bufs", None)
    if bufs is None or bufs[0].size < ncells:
        n = max(ncells, 1)
        bufs = (np.empty(n, np.int64), np.empty(n, np.int32),
                np.empty(n, np.float64), np.empty(n, np.uint8))
        _TLS.bufs = bufs
    return bufs


def _gather_arena(nbytes: int) -> np.ndarray:
    buf = getattr(_TLS, "gather", None)
    if buf is None or buf.size < nbytes:
        buf = np.empty(max(nbytes, 1 << 16), np.uint8)
        _TLS.gather = buf
    return buf


def parse_bytes(data, sep: str, quote: str, ncols: int, want_offsets=None):
    """Tokenise a CSV buffer in one quote-aware C pass; every row is
    checked against ``ncols``.

    Returns ``(starts, lens, vals, ok, esc)``, arrays of shape
    ``[ncols, nrows]`` (column-major), or a decline-reason string.
    ``esc`` (None when the scan saw no ``""`` escape) marks cells whose
    raw bytes still carry RFC-4180 escapes. ``want_offsets`` (uint8 per
    column, None = all) suppresses the starts/lens writes of columns
    whose offsets are never read (float64 columns: their value is
    ``vals``); those slices hold garbage. All five arrays are views into
    this thread's arena."""
    L = lib()
    if ncols <= 0:
        return "empty_range"
    buf = _as_u8(data)
    # quoted newlines only lower the row count below newlines + 1, so the
    # arena never overflows
    cap = int(np.count_nonzero(buf == 0x0A)) + 1
    c = int(ncols)
    want_ptr = 0
    if want_offsets is not None:
        want_offsets = np.ascontiguousarray(want_offsets, dtype=np.uint8)
        want_ptr = want_offsets.ctypes.data
    starts, lens, vals, ok = (a[:cap * c] for a in _scratch(cap * c))
    reason = ctypes.c_longlong(0)
    esc_count = ctypes.c_longlong(0)
    got = L.csv_parse(buf.ctypes.data, buf.size, _byte(sep),
                      _byte(quote or '"'), cap, c, want_ptr,
                      _ptr(starts, ctypes.c_longlong),
                      _ptr(lens, ctypes.c_int),
                      _ptr(vals, ctypes.c_double),
                      _ptr(ok, ctypes.c_ubyte), ctypes.byref(reason),
                      ctypes.byref(esc_count))
    if got < 0:
        return DECLINE_REASONS.get(int(reason.value), "ragged_rows")
    if got == 0:
        return "empty_range"
    r = int(got)
    if int(esc_count.value):
        esc = (ok & 0x80).astype(bool).reshape(c, cap)[:, :r]
        np.bitwise_and(ok, 0x7F, out=ok)
    else:
        esc = None
    return (starts.reshape(c, cap)[:, :r], lens.reshape(c, cap)[:, :r],
            vals.reshape(c, cap)[:, :r], ok.reshape(c, cap)[:, :r], esc)


def chunk_bounds(data, sep: str, quote: str, targets) -> np.ndarray:
    """Quote-safe range boundaries: for each ascending byte target, the
    offset just past the first newline at or after it that lies outside
    any quoted field. May be shorter than ``targets`` where the tail
    targets fall past the last such newline."""
    L = lib()
    buf = _as_u8(data)
    t = np.ascontiguousarray(targets, dtype=np.int64)
    out = np.empty(max(len(t), 1), np.int64)
    got = L.csv_chunk_bounds(buf.ctypes.data, buf.size, _byte(sep),
                             _byte(quote or '"'), _ptr(t, ctypes.c_longlong),
                             len(t), _ptr(out, ctypes.c_longlong))
    return out[:max(int(got), 0)]


def enum_encode(data, starts, lens, max_card: int):
    """Dictionary-encode one column's cells: ``(codes int32, uniq_rows
    int64)`` where ``uniq_rows[k]`` is the row whose cell first used id
    ``k``, or None above ``max_card`` distinct cells."""
    L = lib()
    buf = _as_u8(data)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    n = len(starts)
    max_card = min(max_card, n)
    codes = np.empty(n, np.int32)
    uniq = np.empty(max(max_card, 1), np.int64)
    card = L.csv_enum_encode(buf.ctypes.data, _ptr(starts, ctypes.c_longlong),
                             _ptr(lens, ctypes.c_int), n,
                             _ptr(codes, ctypes.c_int),
                             _ptr(uniq, ctypes.c_longlong), max_card)
    if card < 0:
        return None
    return codes, uniq[:card]


def _pack_patterns(pats):
    """Byte patterns (NA strings) concatenated: ``(buf, offs, lens)``."""
    bs = [p if isinstance(p, bytes) else str(p).encode("utf-8")
          for p in pats]
    offs = np.zeros(max(len(bs), 1), np.int64)
    lens = np.zeros(max(len(bs), 1), np.int32)
    o = 0
    for k, b in enumerate(bs):
        offs[k] = o
        lens[k] = len(b)
        o += len(b)
    return b"".join(bs) or b"\0", offs, lens


def gather_tokens(data, starts, lens, width=None) -> np.ndarray:
    """The cells' bytes as an ``S{width}`` array: a view into this
    thread's gather arena, consumed before the next gather."""
    L = lib()
    buf = _as_u8(data)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    n = len(starts)
    if n == 0:
        return np.empty(0, dtype="S1")
    if width is None:
        width = max(int(lens.max()), 1)
    out = _gather_arena(n * width)[:n * width]
    L.csv_gather_tokens(buf.ctypes.data, _ptr(starts, ctypes.c_longlong),
                        _ptr(lens, ctypes.c_int), n, width, out.ctypes.data)
    return out.view(f"S{width}")


def match_any(data, starts, lens, patterns) -> np.ndarray:
    """Per cell: its bytes equal one of ``patterns`` (the NA test,
    without making tokens)."""
    L = lib()
    buf = _as_u8(data)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    n = len(starts)
    out = np.zeros(n, np.uint8)
    if n and patterns:
        pat_buf, offs, plens = _pack_patterns(patterns)
        pat = np.frombuffer(pat_buf, np.uint8)
        L.csv_match_any(buf.ctypes.data, _ptr(starts, ctypes.c_longlong),
                        _ptr(lens, ctypes.c_int), n, pat.ctypes.data,
                        _ptr(offs, ctypes.c_longlong),
                        _ptr(plens, ctypes.c_int), len(patterns),
                        _ptr(out, ctypes.c_ubyte))
    return out.view(bool)


def numeric_stats(vals, col_stride: int, col_idx, r0: int, nrows: int):
    """Copy the selected numeric columns out of the parse arena and
    reduce them in one GIL-free pass: ``(block [k, nrows] float64,
    finite |max| per column (-inf when none), all-finite per column)``."""
    L = lib()
    col_idx = np.ascontiguousarray(col_idx, dtype=np.int64)
    k = len(col_idx)
    block = np.empty((k, nrows), np.float64)
    fmax = np.empty(k, np.float64)
    allfin = np.empty(k, np.uint8)
    L.csv_numeric_stats(_ptr(vals, ctypes.c_double), col_stride,
                        _ptr(col_idx, ctypes.c_longlong), k, r0, nrows,
                        _ptr(block, ctypes.c_double),
                        _ptr(fmax, ctypes.c_double),
                        _ptr(allfin, ctypes.c_ubyte))
    return block, fmax, allfin.view(bool)


def enum_encode_full(data, starts, lens, nas, max_card: int, na_code: int,
                     esc=None):
    """Dictionary build, ``""``-unescape, NA map, sorted-domain dedupe and
    the final code remap in one GIL-free call: ``(codes int32, dom_rows
    int64, dom_esc bool)``, entry ``k`` of the last two locating a cell
    of the k-th sorted label. None above ``max_card`` labels or at a
    label that is not UTF-8 (whose sort order bytes cannot give)."""
    L = lib()
    buf = _as_u8(data)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    n = len(starts)
    nas = list(nas or ())
    max_card = min(max_card, max(n, 1))
    codes = np.empty(n, np.int32)
    dom_rows = np.empty(max_card + 1, np.int64)
    dom_esc = np.empty(max_card + 1, np.uint8)
    esc_ptr = 0
    if esc is not None:
        esc = np.ascontiguousarray(esc, dtype=np.uint8)
        esc_ptr = esc.ctypes.data
    pat_buf, offs, plens = _pack_patterns(nas)
    pat = np.frombuffer(pat_buf, np.uint8)
    card = L.csv_enum_encode_full(
        buf.ctypes.data, _ptr(starts, ctypes.c_longlong),
        _ptr(lens, ctypes.c_int), n, esc_ptr, pat.ctypes.data,
        _ptr(offs, ctypes.c_longlong), _ptr(plens, ctypes.c_int), len(nas),
        max_card, na_code, _ptr(codes, ctypes.c_int),
        _ptr(dom_rows, ctypes.c_longlong), _ptr(dom_esc, ctypes.c_ubyte))
    if card < 0:
        return None
    return codes, dom_rows[:card], dom_esc[:card].view(bool)
