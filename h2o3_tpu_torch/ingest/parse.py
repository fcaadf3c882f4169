"""Two-phase parse: guess the setup, then parse into a Frame.

Counterpart of ``h2o3_tpu/ingest/parse.py`` (H2O's
``ParseSetup.guessSetup`` and ``ParseDataset``). ``parse_setup`` samples
the head of the first file (the inflated head of a compressed one) and
guesses the separator, the header and the column types. ``parse`` maps
each file, or inflates a gzip or zstd file into one host buffer
(``ingest/compress.py``), cuts a large buffer into newline-aligned byte
ranges (quote-aware where the head holds the quote character) and
tokenizes the ranges on a thread pool with the native tokenizer
(``native/fast_csv.cpp``; ctypes releases the GIL). Each range comes
back as typed columns with chunk-local enum domains
(``ingest/chunk.py``). With streaming on (``H2O3_INGEST_STREAM``: "1",
"0", or "auto", on for a ``cuda`` frame), each range's numeric, time and
enum columns go to the device as soon as the range is encoded
(``ingest/stream.py``) and the rest merge on the host; without it the
merge unions the domains and remaps the codes, and
``Frame.from_typed_columns`` copies each dtype group to the device in
one transfer.

A range the native scan declines (ragged rows, an unterminated quote,
bytes after a closing quote) is read again, alone, with the Python
tokenizer; so is every range of a setup with a numeric NA string, which
the native scan cannot express. The native scan matches the Python
tokenizer on every token class it accepts, so a column may mix the two
across its ranges. Each such range is counted by reason in
``LAST_PROFILE["fallback_reasons"]``, and a compressed input that
inflates serially (a single-stream gzip) by reason in
``LAST_PROFILE["degrade_reasons"]``.

``import_file`` takes what the JAX package's does: a path, a list of
paths or a URI (``ingest/persist_uri.py``); CSV, compressed or not, and
the formats of ``ingest/formats.py``, a list of those joined by
``_rbind``.
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
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from h2o3_tpu_torch import _device, native
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.vec import (T_ENUM, T_INT, T_REAL, T_STR, T_TIME,
                                      Vec)
from h2o3_tpu_torch.ingest import compress
from h2o3_tpu_torch.ingest.chunk import (SKIPPED, EncodedColumn, _merge_enum,
                                         _merge_numeric, _skipped_set,
                                         encode_chunk_native,
                                         encode_token_column, merge_column)
from h2o3_tpu_torch.ingest.persist_uri import localize
from h2o3_tpu_torch.ingest.stream import ChunkDeviceStreamer, prepack_chunk

DEFAULT_NA_STRINGS = {"", "NA", "N/A", "na", "NaN", "nan", "null", "NULL",
                      "None", "?"}
_SEP_CANDIDATES = [",", "\t", ";", "|", " "]

# stage timings and range counts of the most recent parse()
LAST_PROFILE: Dict[str, object] = {}

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


def _read_head(path: str, nbytes: int = 1 << 16) -> str:
    with open(path, "rb") as f:
        raw = f.read(nbytes)
    if compress.detect_bytes(raw[:8]):
        # a compressed input: the setup guess reads the inflated head
        raw = compress.head_bytes(path, nbytes)
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
    sample = _read_head(localize(paths[0]))
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


def _stream_on(dev: torch.device) -> bool:
    """``H2O3_INGEST_STREAM``: "0" off, "1" on, "auto" (the default) on
    for a ``cuda`` frame."""
    env = os.environ.get("H2O3_INGEST_STREAM", "auto")
    if env in ("0", "false", ""):
        return False
    if env == "1":
        return True
    return dev.type == "cuda"


def _encode_range_native(buf, start: int, end: int, setup: ParseSetup,
                         skip_header: bool, pack_cols=None):
    """One byte range on the native tokenizer, over a borrowed view of
    the file's map or buffer: ``(typed columns, the streaming pack or
    None)``, or the decline reason. ``pack_cols`` has the worker build
    the range's float32 pack here, on the pool."""
    out = encode_chunk_native(memoryview(buf)[start:end], setup,
                              skip_header)
    if isinstance(out, str):
        return out
    return out, (prepack_chunk(pack_cols, out) if pack_cols else None)


def _tokenize_native(jobs, setup: ParseSetup, workers: int, stream_cols,
                     dev: torch.device):
    """Native encode of every job ``(path, buf, start, end, skip_header)``
    on a thread pool: (typed columns or None per job, decline reason by
    job, the streamer or None). With ``stream_cols`` and more than one
    job, this thread hands each finished range to a
    ``ChunkDeviceStreamer`` as it comes (keyed by its index, which is
    row order)."""
    results: List[Optional[list]] = [None] * len(jobs)
    reasons: Dict[int, str] = {}
    if len(jobs) == 1:
        _p, buf, s, e, skip = jobs[0]
        out = _encode_range_native(buf, s, e, setup, skip)
        if isinstance(out, str):
            reasons[0] = out
        else:
            results[0] = out[0]
        return results, reasons, None
    strm = (ChunkDeviceStreamer(stream_cols, list(setup.column_types), dev)
            if stream_cols else None)
    with cf.ThreadPoolExecutor(max_workers=min(len(jobs), workers)) as ex:
        futs = {ex.submit(_encode_range_native, buf, s, e, setup, skip,
                          stream_cols or None): k
                for k, (_p, buf, s, e, skip) in enumerate(jobs)}
        for fu in cf.as_completed(futs):
            k = futs[fu]
            out = fu.result()
            if isinstance(out, str):
                reasons[k] = out
                continue
            results[k], pack = out
            if strm is not None:
                strm.add(k, results[k], pack)
    return results, reasons, strm


def _job_list(paths, setup: ParseSetup, nw: int, maps, mm_by_path,
              comp_info):
    """The parse's jobs in row order: a file of ``_PARALLEL_PARSE_BYTES``
    or more is mapped, or inflated when it is compressed, and cut into
    byte ranges; a smaller one is one job."""
    jobs = []
    for p in paths:
        if compress.detect(p):
            # one contiguous inflated buffer takes the map's place
            data, info = compress.decompress_path(p, nw)
            comp_info.append(info)
            size = len(data)
            if size >= _PARALLEL_PARSE_BYTES:
                mm_by_path[p] = data
                jobs += [(p, data, s, e, setup.header and s == 0)
                         for s, e in _byte_ranges(data,
                                                  _range_count(size, nw),
                                                  setup)]
            else:
                jobs.append((p, data, 0, size, setup.header))
            continue
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
    return jobs


def parse(paths: Union[str, Sequence[str]],
          setup: Optional[ParseSetup] = None, device=None,
          key: Optional[str] = None) -> Frame:
    """Phase 2: parse CSV files, compressed or not, into one Frame on
    ``device`` (the ``init`` default, else ``cuda``). Large inputs are
    cut into byte ranges that a thread pool tokenizes in place; the job
    order is the row order."""
    dev = _device.resolve(device)
    if isinstance(paths, str):
        paths = [paths]
    paths = [localize(p) for p in paths]
    setup = setup or parse_setup(paths)
    maps, mm_by_path, comp_info = [], {}, []
    try:
        nw = ingest_workers()
        t_all0 = time.perf_counter()
        jobs = _job_list(paths, setup, nw, maps, mm_by_path, comp_info)
        scan_s = time.perf_counter() - t_all0
        t0 = time.perf_counter()
        native_ok = _na_strings_native_safe(setup)
        skipped = _skipped_set(setup)
        active = [i for i in range(len(setup.column_names))
                  if i not in skipped]
        stream_cols = ([i for i in active if setup.column_types[i] in
                        (T_REAL, T_INT, T_TIME, T_ENUM)]
                       if _stream_on(dev) else [])
        streamer, discarded = None, 0
        if native_ok:
            results, reasons, streamer = _tokenize_native(
                jobs, setup, nw, stream_cols, dev)
            late = _late_quote_paths(jobs, reasons, mm_by_path, setup)
            if late:
                # cut the files whose first quote lies past the probe again
                # with the quote-aware pass, and tokenize every range again
                if streamer is not None:
                    streamer.discard()
                    discarded += streamer.discarded_bytes
                jobs = [j for p in paths for j in _rejob(
                    p, jobs, mm_by_path, setup, nw, p in late)]
                results, reasons, streamer = _tokenize_native(
                    jobs, setup, nw, stream_cols, dev)
        else:
            results = [None] * len(jobs)
            reasons = {k: "numeric_na_sentinel" for k in range(len(jobs))}
        todo = [k for k, r in enumerate(results) if r is None]
        for k in todo:
            _p, buf, s, e, skip = jobs[k]
            results[k] = _encode_range_python(buf, s, e, setup, skip)
            if streamer is not None:
                streamer.add(k, results[k])   # joins the stream late
        t1 = time.perf_counter()
        hidden_put_s = streamer.add_seconds if streamer is not None else 0.0
        names = [setup.column_names[i] for i in active]
        pos = {i: j for j, i in enumerate(active)}
        vec_map = streamer.assemble() if streamer is not None else {}
        tm = time.perf_counter()
        cols = [None if i in vec_map else merge_column(
            [cr[i] for cr in results], setup.column_types[i])
            for i in active]
        merge_s = time.perf_counter() - tm
        fr = Frame.from_typed_columns(
            names, cols, device=dev, key=key or os.path.basename(paths[0]),
            preset={pos[i]: v for i, v in vec_map.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        put_s = hidden_put_s + (t3 - t1 - merge_s)
        h2d = 0
        if dev.type == "cuda":
            h2d = (streamer.h2d_bytes if streamer is not None else 0) + sum(
                4 * fr.nrow for c in cols
                if c is not None and c.vtype != T_STR)
        fb: Dict[str, int] = {}
        for k in todo:
            fb[reasons[k]] = fb.get(reasons[k], 0) + 1
        degrade: Dict[str, int] = {}
        for info in comp_info:
            if info.get("reason"):
                degrade[info["reason"]] = degrade.get(info["reason"], 0) + 1
        LAST_PROFILE.clear()
        LAST_PROFILE.update({
            "rows": fr.nrow, "chunks": len(jobs), "bytes": sum(
                e - s for _p, _b, s, e, _k in jobs),
            "native": bool(native_ok and not todo),
            "native_ranges": len(jobs) - len(todo),
            "fallback_ranges": len(todo), "fallback_reasons": fb,
            "degrade_reasons": degrade,
            "compressed": comp_info or None,
            "decompress_s": sum(c["inflate_s"] for c in comp_info),
            "workers": nw, "scan_s": scan_s,
            "tokenize_encode_s": t1 - t0 - hidden_put_s,
            "merge_s": merge_s, "device_put_s": put_s,
            "streamed": streamer is not None,
            "h2d_overlap_ratio": (hidden_put_s / put_s if streamer is not None
                                  and put_s > 0 else None),
            "add_seconds": hidden_put_s,
            "assemble_seconds": (streamer.assemble_seconds
                                 if streamer is not None else 0.0),
            "h2d_bytes": h2d, "h2d_discarded_bytes": discarded,
            "ring_allocs": (streamer.ring_allocs if streamer is not None
                            else 0),
            "fallback_cols": (sorted(setup.column_names[i]
                                     for i in streamer.fallback_cols)
                              if streamer is not None else [])})
        return fr
    finally:
        for f, mm in maps:
            try:
                mm.close()
            except BufferError:
                pass       # a view still borrows the map; the GC closes it
            f.close()


def _late_quote_paths(jobs, reasons, mm_by_path, setup) -> set:
    """Cut files (mapped or inflated) with a declined range whose first
    quote lies past the probe window: their cuts were placed blind to
    quotes."""
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
    """One-shot import (``h2o.import_file``) onto ``device`` (the
    ``init`` default, else ``cuda``): a path, a URI or a list of them.
    A remote URI is localized first; the first file's extension picks
    the parser (``formats.sniff_format``): CSV, gzip or zstd compressed
    or not, through ``parse_setup`` and ``parse``; ARFF, SVMLight,
    Parquet, ORC, Avro and xlsx through ``formats.FORMAT_PARSERS``, a
    list of those joined row-wise by ``_rbind``."""
    from h2o3_tpu_torch.ingest.formats import FORMAT_PARSERS, sniff_format
    dev = _device.resolve(device)
    paths = ([localize(path)] if isinstance(path, str)
             else [localize(p) for p in path])
    fmt = sniff_format(paths[0])
    if fmt != "csv":
        fr = FORMAT_PARSERS[fmt](paths[0], device=dev, key=destination_frame)
        for p in paths[1:]:
            fr = _rbind(fr, FORMAT_PARSERS[fmt](p, device=dev))
        if destination_frame:
            fr.key = destination_frame
        return fr
    setup = parse_setup(paths, separator=sep, header=header,
                        column_names=col_names, column_types=col_types,
                        na_strings=na_strings)
    return parse(paths, setup, device=dev, key=destination_frame)


def _rbind(a: Frame, b: Frame) -> Frame:
    """Two frames of one schema, row-wise (a multi-file import). Enum
    columns union their domains and remap the codes (``_merge_enum``,
    NA codes masked); wide ints stay exact (``_merge_numeric``); time
    stays time; a column whose types differ between the files becomes
    an enum of its labels. Raises ``ValueError`` where the names
    differ."""
    if a.names != b.names:
        raise ValueError("multi-file import needs identical schemas")
    dev = a.device

    def num_chunk(v):
        d = v.to_numpy()
        if d.dtype == np.int64:        # the exact wide-int host copy
            return EncodedColumn(T_INT, d.astype(np.float64), exact=d)
        return EncodedColumn(v.type, d)

    vecs = []
    for n in a.names:
        va, vb = a.vec(n), b.vec(n)
        if va.type == T_ENUM and vb.type == T_ENUM:
            col = _merge_enum([
                EncodedColumn(T_ENUM, v.to_numpy().astype(np.int32),
                              domain=list(v.domain or ()))
                for v in (va, vb)])
            vecs.append(Vec.from_numpy(col.data, dev, vtype=col.vtype,
                                       domain=col.domain))
        elif va.type == T_STR and vb.type == T_STR:
            data = np.concatenate([va.to_strings(), vb.to_strings()])
            vecs.append(Vec.from_numpy(np.asarray(data, dtype=object), dev,
                                       vtype=T_STR))
        elif va.type == T_TIME and vb.type == T_TIME:
            ms = np.concatenate([va.to_numpy(), vb.to_numpy()])
            vecs.append(Vec.from_numpy(ms.astype(np.int64), dev,
                                       vtype=T_TIME))
        elif va.is_numeric and vb.is_numeric:
            vt = T_REAL if T_REAL in (va.type, vb.type) else T_INT
            col = _merge_numeric([num_chunk(va), num_chunk(vb)], vt)
            vecs.append(Vec.from_numpy(col.data, dev, vtype=col.vtype))
        else:
            data = np.concatenate([np.asarray(va.to_strings(), dtype=object),
                                   np.asarray(vb.to_strings(), dtype=object)])
            vecs.append(Vec.from_numpy(data, dev))
    return Frame(list(a.names), vecs, key=a.key)
