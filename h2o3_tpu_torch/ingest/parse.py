"""Two-phase CSV parse: guess the setup, then parse into a Frame.

Counterpart of ``h2o3_tpu/ingest/parse.py`` for CSV (H2O's
``ParseSetup.guessSetup`` and ``ParseDataset``). ``parse_setup`` samples
the head of the first file and guesses the separator, the header and the
column types. ``parse`` maps each file, cuts a large one into
newline-aligned byte ranges (quote-aware where the head holds the quote
character) and tokenizes the ranges on a thread pool with the native
tokenizer (``native/fast_csv.cpp``; ctypes releases the GIL). Each range
comes back as typed columns with chunk-local enum domains
(``ingest/chunk.py``); the merge unions the domains and remaps the codes,
and ``Frame.from_typed_columns`` copies each dtype group to the device
in one transfer.

A range the native scan declines (ragged rows, an unterminated quote,
bytes after a closing quote) is read again, alone, with the Python
tokenizer; so is every range of a setup with a numeric NA string, which
the native scan cannot express. The native scan matches the Python
tokenizer on every token class it accepts, so a column may mix the two
across its ranges. Each such range is counted by reason in
``LAST_PROFILE["fallback_reasons"]``.
"""
from __future__ import annotations

import concurrent.futures as cf
import csv
import io
import math
import mmap
import os
import re
import time
import urllib.parse
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from h2o3_tpu_torch import _device, native
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.vec import T_ENUM, T_INT, T_REAL, T_STR, T_TIME
from h2o3_tpu_torch.ingest.chunk import (SKIPPED, _skipped_set,
                                         encode_chunk_native,
                                         encode_token_column, merge_columns)

DEFAULT_NA_STRINGS = {"", "NA", "N/A", "na", "NaN", "nan", "null", "NULL",
                      "None", "?"}
_SEP_CANDIDATES = [",", "\t", ";", "|", " "]

# stage timings and range counts of the most recent parse()
LAST_PROFILE: Dict[str, object] = {}

_FORMATS = {".arff": "arff", ".svm": "svmlight", ".svmlight": "svmlight",
            ".parquet": "parquet", ".pq": "parquet", ".orc": "orc",
            ".avro": "avro", ".xls": "xls", ".xlsx": "xls"}
_COMPRESSION_MAGIC = {b"\x1f\x8b": "gzip", b"\x28\xb5\x2f\xfd": "zstd",
                      b"BZh": "bzip2", b"\xfd7zXZ\x00": "xz",
                      b"PK\x03\x04": "zip"}


@dataclass
class ParseSetup:
    separator: str = ","
    header: bool = True
    column_names: List[str] = field(default_factory=list)
    column_types: List[str] = field(default_factory=list)
    na_strings: set = field(default_factory=lambda: set(DEFAULT_NA_STRINGS))
    skipped_columns: List[int] = field(default_factory=list)
    quotechar: str = '"'


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


_INT_RE = re.compile(r"[+-]?\d+\Z")


def _is_int(tok: str) -> bool:
    # lexical: float() is exact only to 2^53, so a wide integer token is
    # neither typed nor valued through it
    return _INT_RE.match(tok.strip()) is not None


def _looks_time(tok: str) -> bool:
    if len(tok) < 8 or tok[4:5] != "-":
        return False
    try:
        np.datetime64(tok)
        return True
    except ValueError:
        return False


def _local_path(path: str) -> str:
    """The local path of a CSV input; ``NotImplementedError``, naming its
    ROADMAP.md item (queue 1), for an input the port does not read yet: a
    remote URI, a format other than CSV or a compressed file."""
    scheme = urllib.parse.urlparse(path).scheme
    if scheme == "file":
        path = urllib.parse.urlparse(path).path
    elif len(scheme) > 1:
        raise NotImplementedError(
            f"{scheme}:// inputs are not ported yet (ROADMAP.md, queue 1, "
            f"item B4: persist_uri.py)")
    fmt = _FORMATS.get(os.path.splitext(path)[1].lower())
    if fmt:
        raise NotImplementedError(
            f"{fmt} files are not ported yet (ROADMAP.md, queue 1, item B3: "
            f"formats.py); the port reads CSV")
    with open(path, "rb") as f:
        head = f.read(8)
    for magic, kind in _COMPRESSION_MAGIC.items():
        if head.startswith(magic):
            raise NotImplementedError(
                f"{kind}-compressed input {os.path.basename(path)} is not "
                f"ported yet (ROADMAP.md, queue 1, item B2: compress.py)")
    return path


def _read_head(path: str, nbytes: int = 1 << 16) -> str:
    with open(path, "rb") as f:
        raw = f.read(nbytes)
    txt = raw.decode("utf-8", errors="replace")
    # drop a possibly truncated last line
    if len(raw) == nbytes and "\n" in txt:
        txt = txt[: txt.rfind("\n")]
    return txt


def guess_separator(sample: str) -> str:
    lines = [ln for ln in sample.splitlines() if ln.strip()][:50]
    best, best_score = ",", -1
    for sep in _SEP_CANDIDATES:
        counts = [len(next(csv.reader([ln], delimiter=sep, quotechar='"')))
                  for ln in lines]
        if not counts:
            continue
        ncol = max(set(counts), key=counts.count)
        score = sum(c == ncol for c in counts) * 1000 + ncol
        if ncol > 1 and score > best_score:
            best, best_score = sep, score
    return best


def _guess_col_type(tokens: List[str], na_strings) -> str:
    vals = [t for t in tokens if t.strip() not in na_strings]
    if not vals:
        return T_REAL
    if all(_is_number(v) for v in vals):
        return T_INT if all(_is_int(v) for v in vals) else T_REAL
    if all(_looks_time(v) for v in vals):
        return T_TIME
    return T_ENUM


_TYPE_NAMES = {"numeric": T_REAL, "categorical": T_ENUM, "factor": T_ENUM,
               "string": T_STR, "time": T_TIME, "int": T_INT, "real": T_REAL,
               "enum": T_ENUM}


def parse_setup(paths: Union[str, Sequence[str]],
                separator: Optional[str] = None,
                header: Optional[bool] = None,
                column_names: Optional[Sequence[str]] = None,
                column_types: Optional[Sequence[str]] = None,
                na_strings: Optional[Sequence[str]] = None) -> ParseSetup:
    """Phase 1: sample the first file's head and guess the setup."""
    if isinstance(paths, str):
        paths = [paths]
    first_path = _local_path(paths[0])
    sample = _read_head(first_path)
    sep = separator or guess_separator(sample)
    nas = (set(na_strings) if na_strings is not None
           else set(DEFAULT_NA_STRINGS))
    rows = [r for r in csv.reader(io.StringIO(sample), delimiter=sep,
                                  quotechar='"') if r]
    if not rows:
        raise ValueError(f"empty file: {paths[0]}")
    first = rows[0]
    if header is None:
        # a header where some column's first cell is a bare string over a
        # numeric or time body
        def tok_class(tok):
            t = tok.strip()
            if t in nas:
                return None
            if _is_number(t):
                return "num"
            if _looks_time(t):
                return "time"
            return "str"

        data_rows = rows[1:50]
        header = False
        for i, c in enumerate(first):
            if tok_class(c) != "str":
                continue
            body = [tok_class(r[i]) for r in data_rows if i < len(r)]
            body = [b for b in body if b is not None]
            if body and all(b in ("num", "time") for b in body):
                header = True
                break
        if not data_rows:
            header = all(not _is_number(c) for c in first)
    ncol = len(first)
    names = list(first) if header else [f"C{i + 1}" for i in range(ncol)]
    if column_names:
        names = list(column_names)
    body = (rows[1:] if header else rows)[:1000]
    types = [_guess_col_type([r[i] for r in body if i < len(r)], nas)
             for i in range(ncol)]
    for i, t in enumerate(column_types or ()):
        if t:
            types[i] = _TYPE_NAMES.get(t, t)
    return ParseSetup(separator=sep, header=bool(header), column_names=names,
                      column_types=types, na_strings=nas)


def _parse_csv_text(text: str, setup: ParseSetup, skip_header: bool):
    """The Python tokenizer (csv.reader, quote-correct): per-column lists
    of stripped tokens, None for NA strings."""
    reader = csv.reader(io.StringIO(text), delimiter=setup.separator,
                        quotechar=setup.quotechar)
    rows = [r for r in reader if r]
    if skip_header and rows:
        rows = rows[1:]
    ncol = len(setup.column_names)
    cols = [[None] * len(rows) for _ in range(ncol)]
    nas = setup.na_strings
    skipped = _skipped_set(setup)
    active = [ci for ci in range(ncol) if ci not in skipped]
    for ri, r in enumerate(rows):
        for ci in active:
            tok = r[ci].strip() if ci < len(r) else ""
            cols[ci][ri] = None if tok in nas else tok
    return cols


_PARALLEL_PARSE_BYTES = 16 << 20   # byte-range fan-out from 16 MB
_TARGET_RANGE_BYTES = 32 << 20     # preferred range size of a large file
_MIN_RANGE_BYTES = 2 << 20         # never a range under this
_QUOTE_PROBE_BYTES = 8 << 20       # how far the range cut looks for quotes


def ingest_workers() -> int:
    """Parse fan-out width: ``H2O3_INGEST_WORKERS``, else every core."""
    env = os.environ.get("H2O3_INGEST_WORKERS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return max(1, os.cpu_count() or 4)


def _range_count(size: int, workers: int) -> int:
    """At least one range a worker, growing toward ranges of
    ``_TARGET_RANGE_BYTES`` (at most four a worker), never a range under
    ``_MIN_RANGE_BYTES`` (or the fan-out threshold, where a test lowers
    it)."""
    n = max(workers, min(4 * workers, size // _TARGET_RANGE_BYTES))
    floor = max(1, min(_MIN_RANGE_BYTES, _PARALLEL_PARSE_BYTES))
    return int(max(1, min(n, max(1, size // floor))))


def _byte_ranges(mm, n_chunks: int, setup: ParseSetup,
                 force_quote_scan: bool = False) -> List[tuple]:
    """Row-aligned byte ranges of a mapped file. Where the head
    (``_QUOTE_PROBE_BYTES``) holds the quote character, or the caller
    forces it, one native pass places the cuts at newlines outside quoted
    fields; otherwise the cuts are the first newlines after the targets.
    A quote first seen past the probe can make such a cut fall inside a
    quoted field: ``parse`` then sees a declined range and cuts the file
    again with the full pass."""
    size = len(mm)
    if n_chunks <= 1 or size == 0:
        return [(0, size)]
    targets = [size * i // n_chunks for i in range(1, n_chunks)]
    quote = setup.quotechar or '"'
    if force_quote_scan or mm.find(quote.encode()[0:1], 0,
                                   min(size, _QUOTE_PROBE_BYTES)) != -1:
        bounds = [int(b) for b in native.chunk_bounds(
            mm, setup.separator, quote, targets)]
    else:
        bounds = []
        for t in targets:
            pos = mm.find(b"\n", t)
            bounds.append(size if pos < 0 else pos + 1)
    edges = [0] + sorted({b for b in bounds if 0 < b < size}) + [size]
    return [(edges[i], edges[i + 1]) for i in range(len(edges) - 1)
            if edges[i + 1] > edges[i]]


def _na_strings_native_safe(setup: ParseSetup) -> bool:
    """The native scan makes every non-numeric token of a numeric column
    NaN, which equals the Python path only where no NA string is itself a
    number (a sentinel such as '-999' needs the token path)."""
    for s in (setup.na_strings or ()):
        try:
            v = float(s)
        except ValueError:
            continue
        if not math.isnan(v):
            return False
    return True


def _encode_range_python(buf, start: int, end: int, setup: ParseSetup,
                         skip_header: bool):
    """One byte range through the Python tokenizer, into the same typed
    chunk as the native path."""
    text = bytes(buf[start:end]).decode("utf-8", errors="replace")
    tokens = _parse_csv_text(text, setup, skip_header=skip_header)
    skipped = _skipped_set(setup)
    return [SKIPPED if j in skipped else encode_token_column(toks, vt)
            for j, (toks, vt) in enumerate(zip(tokens, setup.column_types))]


def _tokenize_native(jobs, setup: ParseSetup, workers: int):
    """Native encode of every job ``(path, buf, start, end, skip_header)``
    on a thread pool: (typed columns or None per job, decline reason by
    job)."""
    def one(job):
        _p, buf, s, e, skip = job
        return encode_chunk_native(memoryview(buf)[s:e], setup, skip)

    if len(jobs) == 1:
        outs = [one(jobs[0])]
    else:
        with cf.ThreadPoolExecutor(max_workers=min(len(jobs),
                                                   workers)) as ex:
            outs = list(ex.map(one, jobs))
    reasons = {k: o for k, o in enumerate(outs) if isinstance(o, str)}
    return [None if isinstance(o, str) else o for o in outs], reasons


def parse(paths: Union[str, Sequence[str]],
          setup: Optional[ParseSetup] = None, device=None,
          key: Optional[str] = None) -> Frame:
    """Phase 2: parse CSV files into one Frame on ``device`` (the
    ``init`` default, else ``cuda``). Files of ``_PARALLEL_PARSE_BYTES``
    or more are mapped and cut into byte ranges that a thread pool
    tokenizes in place; the job order is the row order."""
    dev = _device.resolve(device)
    if isinstance(paths, str):
        paths = [paths]
    paths = [_local_path(p) for p in paths]
    setup = setup or parse_setup(paths)
    maps, mm_by_path = [], {}
    try:
        nw = ingest_workers()
        t_all0 = time.perf_counter()
        jobs = []
        for p in paths:
            size = os.path.getsize(p)
            if size >= _PARALLEL_PARSE_BYTES:
                f = open(p, "rb")
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                try:
                    mm.madvise(mmap.MADV_WILLNEED)
                except (AttributeError, OSError):
                    pass
                maps.append((f, mm))
                mm_by_path[p] = mm
                jobs += [(p, mm, s, e, setup.header and s == 0)
                         for s, e in _byte_ranges(mm, _range_count(size, nw),
                                                  setup)]
            else:
                with open(p, "rb") as f:
                    jobs.append((p, f.read(), 0, size, setup.header))
        scan_s = time.perf_counter() - t_all0
        t0 = time.perf_counter()
        native_ok = _na_strings_native_safe(setup)
        if native_ok:
            results, reasons = _tokenize_native(jobs, setup, nw)
            late = _late_quote_paths(jobs, reasons, mm_by_path, setup)
            if late:
                # cut the files whose first quote lies past the probe again
                # with the quote-aware pass, and tokenize every range again
                jobs = [j for p in paths for j in _rejob(
                    p, jobs, mm_by_path, setup, nw, p in late)]
                results, reasons = _tokenize_native(jobs, setup, nw)
        else:
            results = [None] * len(jobs)
            reasons = {k: "numeric_na_sentinel" for k in range(len(jobs))}
        todo = [k for k, r in enumerate(results) if r is None]
        for k in todo:
            _p, buf, s, e, skip = jobs[k]
            results[k] = _encode_range_python(buf, s, e, setup, skip)
        t1 = time.perf_counter()
        skipped = _skipped_set(setup)
        cols = merge_columns(results, setup.column_types, skipped)
        t2 = time.perf_counter()
        fr = Frame.from_typed_columns(
            [n for i, n in enumerate(setup.column_names) if i not in skipped],
            [c for c in cols if c is not None], device=dev,
            key=key or os.path.basename(paths[0]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        fb: Dict[str, int] = {}
        for k in todo:
            fb[reasons[k]] = fb.get(reasons[k], 0) + 1
        LAST_PROFILE.clear()
        LAST_PROFILE.update({
            "rows": fr.nrow, "chunks": len(jobs), "bytes": sum(
                e - s for _p, _b, s, e, _k in jobs),
            "native": bool(native_ok and not todo),
            "native_ranges": len(jobs) - len(todo),
            "fallback_ranges": len(todo), "fallback_reasons": fb,
            "workers": nw, "scan_s": scan_s, "tokenize_encode_s": t1 - t0,
            "merge_s": t2 - t1, "device_put_s": t3 - t2})
        return fr
    finally:
        for f, mm in maps:
            try:
                mm.close()
            except BufferError:
                pass       # a view still borrows the map; the GC closes it
            f.close()


def _late_quote_paths(jobs, reasons, mm_by_path, setup) -> set:
    """Mapped files with a declined range whose first quote lies past the
    probe window: their cuts were placed blind to quotes."""
    if not reasons:
        return set()
    qb = (setup.quotechar or '"').encode()[0:1]
    declined = {jobs[k][0] for k in reasons}
    return {p for p, mm in mm_by_path.items() if p in declined
            and mm.find(qb, 0, min(len(mm), _QUOTE_PROBE_BYTES)) == -1
            and mm.find(qb, _QUOTE_PROBE_BYTES) != -1}


def _rejob(path, jobs, mm_by_path, setup, nw, quote_scan: bool):
    if path not in mm_by_path:
        return [j for j in jobs if j[0] == path]
    mm = mm_by_path[path]
    return [(path, mm, s, e, setup.header and s == 0)
            for s, e in _byte_ranges(mm, _range_count(len(mm), nw), setup,
                                     force_quote_scan=quote_scan)]


def import_file(path: Union[str, Sequence[str]],
                destination_frame: Optional[str] = None,
                header: Optional[bool] = None, sep: Optional[str] = None,
                col_names: Optional[Sequence[str]] = None,
                col_types: Optional[Sequence[str]] = None,
                na_strings: Optional[Sequence[str]] = None,
                device=None) -> Frame:
    """One-shot import of a CSV file or a list of CSV files with one
    schema (``h2o.import_file``), onto ``device`` (the ``init`` default,
    else ``cuda``). Other formats, compressed files and remote URIs raise
    ``NotImplementedError`` naming their ROADMAP.md item."""
    dev = _device.resolve(device)
    paths = [path] if isinstance(path, str) else list(path)
    setup = parse_setup(paths, separator=sep, header=header,
                        column_names=col_names, column_types=col_types,
                        na_strings=na_strings)
    return parse(paths, setup, device=dev, key=destination_frame)
