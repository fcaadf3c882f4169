"""Chunk-local columnar encode: each byte range becomes typed columns.

Counterpart of ``h2o3_tpu/ingest/chunk.py``. A byte-range worker returns
finished typed numpy columns (never Python token lists): numeric float64
(with an exact int64 shadow for integers past 2^53), time int64 epoch
milliseconds, enum int32 codes against a sorted chunk-local domain, and
strings as object arrays. ``merge_column`` unions one column's chunk
domains and remaps each chunk's codes through a lookup table (H2O's
PackedDomains pass); an NA code (-1) is masked out of every such lookup,
never clamped into it.

Per-cell Python loops survive only on rare edges (malformed time tokens,
the wide-int re-parse); the hot paths are the native tokenizer
(``native/fast_csv.cpp``), its hash dictionary and vectorised numpy over
the cells' (starts, lens) offsets.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np

from h2o3_tpu_torch import native
from h2o3_tpu_torch.frame.vec import (ENUM_NA, T_ENUM, T_INT, T_REAL, T_STR,
                                      T_TIME, TIME_NA)

# enum cardinality above which a column becomes a string column
MAX_ENUM_CARDINALITY = 1_000_000

# |v| >= 2^53 no longer round-trips exactly through float64
_EXACT_F64_BOUND = float(1 << 53)


def _skipped_set(setup) -> frozenset:
    return frozenset(getattr(setup, "skipped_columns", ()) or ())


@dataclass
class EncodedColumn:
    """One column of one chunk, typed.

    ``data`` by vtype: real/int float64 (NA = NaN); int with ``exact``
    set: the float64 view plus an exact int64 shadow (values past 2^53);
    time int64 epoch ms (NA = ``TIME_NA``); enum int32 codes (NA = -1)
    against the sorted ``domain``; string an object array of str/None.
    ``fmax`` is the finite |max| of a numeric column where the encoder
    already reduced it."""
    vtype: str
    data: np.ndarray
    domain: Optional[List[str]] = None
    exact: Optional[np.ndarray] = None
    fmax: Optional[float] = None


# placeholder for a skipped column: never encoded, never merged
SKIPPED = EncodedColumn(T_STR, np.empty(0, dtype=object))


def _lut_remap(lut: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """``lut[codes]`` where ``codes >= 0``, ``ENUM_NA`` elsewhere."""
    out = np.full(len(codes), ENUM_NA, dtype=np.int32)
    ok = codes >= 0
    out[ok] = lut[codes[ok]]
    return out


def _unescape(tok: str) -> str:
    """Collapse RFC-4180 ``""`` escapes (the cells the tokenizer flagged),
    as csv.reader does."""
    return tok.replace('""', '"')


def _codes_from_labels(codes: np.ndarray, labels: List[str],
                       nas) -> EncodedColumn:
    """Finish a dictionary encode: NA labels map to the NA code, the rest
    rank against the sorted chunk domain. Distinct byte tokens can meet
    after decoding or unescaping, so the domain dedupes decoded labels."""
    keep = sorted({lab for lab in labels if lab not in nas})
    rank = {lab: k for k, lab in enumerate(keep)}
    if labels:
        lut = np.fromiter(
            (ENUM_NA if lab in nas else rank[lab] for lab in labels),
            dtype=np.int32, count=len(labels))
        out = _lut_remap(lut, codes)
    else:
        out = np.full(len(codes), ENUM_NA, dtype=np.int32)
    return EncodedColumn(T_ENUM, out, domain=keep)


def _label(data, start: int, length: int, errors: str = "strict") -> str:
    return bytes(data[start:start + length]).decode("utf-8", errors=errors)


def _encode_enum_offsets(data, starts: np.ndarray, lens: np.ndarray, nas,
                         max_card: int, esc: Optional[np.ndarray] = None
                         ) -> Optional[EncodedColumn]:
    """Enum column from (starts, lens), or None past ``max_card`` labels
    (the column then becomes a string column). One GIL-free call builds
    the dictionary, unescapes, maps NA, sorts the domain and remaps;
    where it declines (a label that is not UTF-8), the plain dictionary
    encode and a decoded-label sort finish it."""
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    has_esc = esc is not None and bool(esc.any())
    full = native.enum_encode_full(data, starts, lens, nas, max_card,
                                   ENUM_NA, esc=esc if has_esc else None)
    if full is not None:
        codes, dom_rows, dom_esc = full
        domain = []
        for r, e in zip(dom_rows.tolist(), dom_esc.tolist()):
            lab = _label(data, starts[r], lens[r])
            domain.append(_unescape(lab) if e else lab)
        return EncodedColumn(T_ENUM, codes, domain=domain)
    res = native.enum_encode(data, starts, lens,
                             max_card + len(nas or ()) + 1)
    if res is None:
        return None
    codes, uniq_rows = res
    labels = []
    for r in uniq_rows:
        lab = _label(data, starts[r], lens[r], errors="replace")
        labels.append(_unescape(lab) if has_esc and esc[r] else lab)
    col = _codes_from_labels(codes, labels, nas)
    return col if len(col.domain) <= max_card else None


def _decode_str_offsets(data, starts: np.ndarray, lens: np.ndarray, nas,
                        esc: Optional[np.ndarray] = None) -> np.ndarray:
    """Object array of str (None for NA strings) from (starts, lens)."""
    isna = native.match_any(data, starts, lens,
                            [s.encode("utf-8") for s in (nas or ())])
    toks = native.gather_tokens(data, starts, lens)
    try:
        out = np.char.decode(toks, "utf-8").astype(object)
    except UnicodeDecodeError:
        out = np.array([t.decode("utf-8", errors="replace") for t in toks],
                       dtype=object)
    if esc is not None:
        for i in np.flatnonzero(esc):
            out[i] = _unescape(out[i])
    out[isna] = None
    return out


def _time_from_u(u: np.ndarray, isna: np.ndarray) -> Optional[np.ndarray]:
    """Vectorised datetime parse of a U array to int64 ms (NaT =
    ``TIME_NA``), or None when a malformed token needs the per-cell
    path."""
    try:
        u = np.where(isna, np.array("NaT", dtype="U3"), u)
        return u.astype("datetime64[ms]").astype(np.int64)
    except ValueError:
        return None


def _time_per_cell(tokens) -> np.ndarray:
    ms = np.full(len(tokens), TIME_NA, dtype=np.int64)
    for i, t in enumerate(tokens):
        if t is not None:
            try:
                ms[i] = np.datetime64(t, "ms").astype(np.int64)
            except ValueError:
                pass
    return ms


def _fast_iso_dates(toks: np.ndarray,
                    isna: np.ndarray) -> Optional[np.ndarray]:
    """``YYYY-MM-DD`` to epoch ms straight off the token bytes (Hinnant's
    days-from-civil). None unless every non-NA token is a valid
    zero-padded ISO date, so that wherever it answers it equals
    ``astype('datetime64[ms]')``."""
    if toks.dtype.itemsize != 10 or len(toks) == 0:
        return None
    act = ~isna
    if not act.any():
        return np.full(len(toks), TIME_NA, dtype=np.int64)
    b = toks.view(np.uint8).reshape(len(toks), 10)[act]
    dig = (b >= 48) & (b <= 57)
    if not (dig[:, [0, 1, 2, 3, 5, 6, 8, 9]].all()
            and (b[:, 4] == 45).all() and (b[:, 7] == 45).all()):
        return None
    v = b.astype(np.int64) - 48
    year = v[:, 0] * 1000 + v[:, 1] * 100 + v[:, 2] * 10 + v[:, 3]
    month = v[:, 5] * 10 + v[:, 6]
    day = v[:, 8] * 10 + v[:, 9]
    if ((month < 1) | (month > 12)).any():
        return None
    leap = (year % 4 == 0) & ((year % 100 != 0) | (year % 400 == 0))
    mdays = np.array([0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                     dtype=np.int64)[month]
    mdays = np.where((month == 2) & leap, 29, mdays)
    if ((day < 1) | (day > mdays)).any():
        return None
    y = year - (month <= 2)
    era = y // 400
    yoe = y - era * 400
    doy = (153 * ((month + 9) % 12) + 2) // 5 + day - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    days = era * 146097 + doe - 719468
    out = np.full(len(toks), TIME_NA, dtype=np.int64)
    out[act] = days * 86400000
    return out


def _encode_time_offsets(data, starts, lens, nas) -> np.ndarray:
    isna = native.match_any(data, starts, lens,
                            [s.encode("utf-8") for s in (nas or ())])
    toks = native.gather_tokens(data, starts, lens)
    ms = _fast_iso_dates(toks, isna)
    if ms is not None:
        return ms
    try:
        u = toks.astype("U")
    except UnicodeDecodeError:
        u = None
    if u is not None:
        ms = _time_from_u(u, isna)
        if ms is not None:
            return ms
    dec = [None if isna[i] else toks[i].decode("utf-8", errors="replace")
           for i in range(len(toks))]
    return _time_per_cell(dec)


def _exact_int_from_tokens(tokens) -> Optional[np.ndarray]:
    """Exact int64 parse of a wide-int column, or None when a cell is NA,
    not an integer or outside int64 (the column then stays float64)."""
    out = np.empty(len(tokens), dtype=np.int64)
    for i, t in enumerate(tokens):
        if t is None:
            return None
        try:
            v = int(t)
        except ValueError:
            return None
        if not (-(1 << 63) <= v < (1 << 63)):
            return None
        out[i] = v
    return out


def _maybe_exact(vals: np.ndarray, vtype: str,
                 tokens_fn) -> Optional[np.ndarray]:
    """The exact re-parse runs only where an int column holds finite
    values at or above 2^53 and no NA."""
    if vtype != T_INT or vals.size == 0:
        return None
    if not np.isfinite(vals).all():
        return None
    if not np.any(np.abs(vals) >= _EXACT_F64_BOUND):
        return None
    return _exact_int_from_tokens(tokens_fn())


def encode_chunk_native(data, setup, skip_header: bool
                        ) -> Union[List[EncodedColumn], str]:
    """Native-tokenizer encode of one byte range: one C scan gives
    column-major offsets and eagerly parsed doubles (zero copy over an
    mmap view), then each column finishes as a typed numpy array. Returns
    a decline-reason string where the scan declines; the caller re-reads
    only this range with the Python tokenizer."""
    skipped = _skipped_set(setup)
    # offsets are read back only for the columns that decode tokens
    # (enum, string, time) or may need the wide-int re-parse (int)
    want = np.fromiter(
        (0 if (j in skipped or vt == T_REAL) else 1
         for j, vt in enumerate(setup.column_types)),
        dtype=np.uint8, count=len(setup.column_types))
    out = native.parse_bytes(data, setup.separator, setup.quotechar or '"',
                             ncols=len(setup.column_types),
                             want_offsets=want)
    if isinstance(out, str):
        return out
    starts, lens, vals, _ok, esc = out
    r0 = 1 if skip_header else 0
    nas = setup.na_strings if setup.na_strings is not None else set()
    # the numeric columns leave the arena in one GIL-free gather that also
    # reduces finite |max| and all-finite per column
    num_idx = [j for j, vt in enumerate(setup.column_types)
               if j not in skipped and vt in (T_REAL, T_INT)]
    num_pos = {j: t for t, j in enumerate(num_idx)}
    if num_idx:
        block, colmax, allfin = native.numeric_stats(
            vals, vals.strides[0] // vals.itemsize, num_idx, r0,
            vals.shape[1] - r0)
    cols: List[EncodedColumn] = []
    for j, vt in enumerate(setup.column_types):
        if j in skipped:
            cols.append(SKIPPED)
            continue
        if vt in (T_REAL, T_INT):
            t = num_pos[j]
            v = block[t]
            exact = None
            if (vt == T_INT and v.size and allfin[t]
                    and colmax[t] >= _EXACT_F64_BOUND):
                # every cell of an all-finite column is numeric ASCII text
                exact = _exact_int_from_tokens(np.char.decode(
                    native.gather_tokens(data, starts[j, r0:],
                                         lens[j, r0:]), "utf-8").tolist())
            cols.append(EncodedColumn(vt, v, exact=exact,
                                      fmax=float(colmax[t])))
            continue
        s, ln = starts[j, r0:], lens[j, r0:]
        esc_j = esc[j, r0:] if esc is not None else None
        if vt == T_TIME:
            cols.append(EncodedColumn(T_TIME,
                                      _encode_time_offsets(data, s, ln, nas)))
        elif vt == T_ENUM:
            col = _encode_enum_offsets(data, s, ln, nas,
                                       MAX_ENUM_CARDINALITY, esc=esc_j)
            if col is None:
                col = EncodedColumn(T_STR, _decode_str_offsets(
                    data, s, ln, nas, esc=esc_j))
            cols.append(col)
        else:
            cols.append(EncodedColumn(T_STR, _decode_str_offsets(
                data, s, ln, nas, esc=esc_j)))
    return cols


def encode_token_column(tokens: Sequence[Optional[str]],
                        vtype: str) -> EncodedColumn:
    """Python-tokenizer encode of one column (None = NA, the tokenizer
    already applied the NA strings), into the same typed chunk as the
    native path."""
    n = len(tokens)
    if vtype in (T_REAL, T_INT):
        u = np.array([t if t is not None else "nan" for t in tokens],
                     dtype="U")
        try:
            vals = u.astype(np.float64) if n else np.empty(0, np.float64)
        except ValueError:
            vals = np.full(n, np.nan, dtype=np.float64)
            for i, t in enumerate(tokens):
                if t is not None:
                    try:
                        vals[i] = float(t)
                    except ValueError:
                        pass                      # a stray token is NA
        exact = _maybe_exact(vals, vtype, lambda: list(tokens))
        return EncodedColumn(vtype, vals, exact=exact)
    if vtype == T_TIME:
        isna = np.array([t is None for t in tokens], dtype=bool)
        u = np.array([t if t is not None else "NaT" for t in tokens],
                     dtype="U")
        ms = _time_from_u(u, isna) if n else np.empty(0, np.int64)
        if ms is None:
            ms = _time_per_cell(tokens)
        return EncodedColumn(T_TIME, ms)
    if vtype == T_ENUM:
        isna = np.array([t is None for t in tokens], dtype=bool)
        u = np.array([t if t is not None else "" for t in tokens], dtype="U")
        uniq = np.unique(u[~isna]) if (~isna).any() else np.empty(0, "U1")
        if len(uniq) <= MAX_ENUM_CARDINALITY:
            codes = np.searchsorted(uniq, u).astype(np.int32)
            codes[isna] = ENUM_NA
            return EncodedColumn(T_ENUM, codes,
                                 domain=[str(x) for x in uniq])
    return EncodedColumn(T_STR, np.array(list(tokens), dtype=object))


def _chunk_to_strings(col: EncodedColumn) -> np.ndarray:
    if col.vtype == T_STR:
        return col.data
    dom = np.array(list(col.domain) + [None], dtype=object)
    return dom[np.where(col.data < 0, len(col.domain), col.data)]


def _concat(parts):
    return np.concatenate(parts) if len(parts) > 1 else parts[0]


def _merge_numeric(chunks: List[EncodedColumn],
                   vtype: str) -> EncodedColumn:
    if vtype == T_INT and any(c.exact is not None for c in chunks):
        exacts = []
        for c in chunks:
            if c.exact is not None:
                exacts.append(c.exact)
                continue
            f = c.data
            if (f.size == 0 or (np.isfinite(f).all()
                                and np.all(f == np.round(f))
                                and np.all(np.abs(f) < _EXACT_F64_BOUND))):
                exacts.append(f.astype(np.int64))
            else:
                exacts = None
                break
        if exacts is not None:
            return EncodedColumn(T_INT, _concat(exacts))
        # wide ints beside NAs or strays have no exact form: the column
        # becomes real rather than silently munged
        vtype = T_REAL
    return EncodedColumn(vtype, _concat([c.data for c in chunks]))


def _merge_enum(chunks: List[EncodedColumn]) -> EncodedColumn:
    if any(c.vtype == T_STR for c in chunks):
        return EncodedColumn(T_STR, _concat(
            [_chunk_to_strings(c) for c in chunks]))
    union = sorted(set().union(*(c.domain for c in chunks)))
    if len(union) > MAX_ENUM_CARDINALITY:
        return EncodedColumn(T_STR, _concat(
            [_chunk_to_strings(c) for c in chunks]))
    gidx = {lab: k for k, lab in enumerate(union)}
    parts = []
    for c in chunks:
        if c.domain == union:
            parts.append(c.data)
            continue
        lut = np.fromiter((gidx[lab] for lab in c.domain), dtype=np.int32,
                          count=len(c.domain))
        parts.append(_lut_remap(lut, c.data))
    return EncodedColumn(T_ENUM, _concat(parts), domain=union)


def merge_column(chunks: List[EncodedColumn], vt: str) -> EncodedColumn:
    """Union one column's chunk-local pieces: enum domain union and remap,
    numeric and time concatenation, wide-int exactness across chunks."""
    if vt in (T_REAL, T_INT):
        return _merge_numeric(chunks, vt)
    if vt == T_ENUM:
        return _merge_enum(chunks)
    return EncodedColumn(vt if vt == T_TIME else T_STR,
                         _concat([c.data for c in chunks]))

