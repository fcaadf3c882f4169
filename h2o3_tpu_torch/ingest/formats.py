"""Parsers of the formats beyond CSV.

Counterpart of ``h2o3_tpu/ingest/formats.py`` (H2O's ``ParserProvider``
SPI: ``ARFFParser``, ``SVMLightParser``, ``XlsxParser`` and the
h2o-parsers modules for Parquet, ORC and Avro). ARFF and SVMLight are
host tokenizers; Parquet and ORC decode through ``pyarrow`` into numpy
columns; Avro object container files (null and deflate codecs, flat
records) and xlsx workbooks (``zipfile`` and ``ElementTree``) are read
with the standard library. Each builds its Frame with the port's
``Vec.from_numpy`` on the requested device, the same columns as the JAX
package's. Legacy BIFF ``.xls`` is refused, as there, for want of
``xlrd``.
"""
from __future__ import annotations

import csv
import json
import os
import re
import struct
import xml.etree.ElementTree as ET
import zipfile
import zlib
from datetime import datetime, timezone
from typing import Dict, List, Optional

import numpy as np

from h2o3_tpu_torch import _device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.vec import T_ENUM, Vec


def sniff_format(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".arff":
        return "arff"
    if ext in (".svm", ".svmlight"):
        return "svmlight"
    if ext in (".parquet", ".pq"):
        return "parquet"
    if ext == ".orc":
        return "orc"
    if ext == ".avro":
        return "avro"
    if ext in (".xls", ".xlsx"):
        return "xls"
    return "csv"


# -------------------------------------------------------------------- ARFF

_ARFF_ATTR = re.compile(r"@attribute\s+('(?:[^']*)'|\"(?:[^\"]*)\"|\S+)\s+"
                        r"(.+)", re.IGNORECASE)


def parse_arff(path: str, device=None, key: Optional[str] = None) -> Frame:
    """ARFF (H2O's ``ARFFParser``): the @attribute lines give the
    columns (numeric, nominal, string, date); @data is CSV with ``?`` as
    NA. Nominal columns keep their declared level order; dates become
    epoch milliseconds (UTC), real-typed as in the JAX package."""
    dev = _device.resolve(device)
    names: List[str] = []
    kinds: List[str] = []          # numeric | nominal | string | date
    domains: List[Optional[List[str]]] = []
    data_lines: List[str] = []
    in_data = False
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("%"):
                continue
            if in_data:
                data_lines.append(line)
                continue
            low = line.lower()
            if low.startswith("@relation"):
                continue
            if low.startswith("@data"):
                in_data = True
                continue
            m = _ARFF_ATTR.match(line)
            if m:
                nm = m.group(1).strip("'\"")
                spec = m.group(2).strip()
                names.append(nm)
                if spec.startswith("{"):
                    kinds.append("nominal")
                    levels = [t.strip().strip("'\"")
                              for t in spec.strip("{}").split(",")]
                    domains.append(levels)
                elif spec.lower() in ("numeric", "real", "integer"):
                    kinds.append("numeric")
                    domains.append(None)
                elif spec.lower().startswith("date"):
                    kinds.append("date")
                    domains.append(None)
                else:
                    kinds.append("string")
                    domains.append(None)
    if not names:
        raise ValueError(f"{path}: no @attribute declarations found")
    ncol = len(names)
    cols: List[List[Optional[str]]] = [[] for _ in range(ncol)]
    for row in csv.reader(data_lines):
        if len(row) != ncol:
            row = (row + [None] * ncol)[:ncol]
        for i, tok in enumerate(row):
            t = tok.strip().strip("'\"") if tok is not None else None
            cols[i].append(None if t in (None, "?", "") else t)
    vecs = []
    for i in range(ncol):
        col = cols[i]
        if kinds[i] == "numeric":
            arr = np.asarray([np.nan if t is None else float(t)
                              for t in col])
            vecs.append(Vec.from_numpy(arr, device=dev))
        elif kinds[i] == "date":
            # epoch milliseconds in UTC; a numeric token is taken as
            # epoch milliseconds already
            def _epoch(t):
                if t is None:
                    return np.nan
                for fmt in ("%Y-%m-%d %H:%M:%S", "%Y-%m-%d",
                            "%m/%d/%Y", "%Y-%m-%dT%H:%M:%S"):
                    try:
                        dt = datetime.strptime(t, fmt).replace(
                            tzinfo=timezone.utc)
                        return dt.timestamp() * 1e3
                    except ValueError:
                        continue
                try:
                    return float(t)
                except ValueError:
                    return np.nan

            arr = np.asarray([_epoch(t) for t in col])
            vecs.append(Vec.from_numpy(arr, device=dev))
        elif kinds[i] == "nominal":
            dom = domains[i]
            lut = {lvl: j for j, lvl in enumerate(dom)}
            codes = np.asarray([-1 if t is None else lut.get(t, -1)
                                for t in col], np.int32)
            vecs.append(Vec.from_numpy(codes, vtype=T_ENUM,
                                       domain=tuple(dom), device=dev))
        else:
            arr = np.asarray([t if t is not None else None for t in col],
                             dtype=object)
            vecs.append(Vec.from_numpy(arr, device=dev))
    return Frame(names, vecs, key=key or os.path.basename(path))


# ---------------------------------------------------------------- SVMLight

def parse_svmlight(path: str, device=None,
                   key: Optional[str] = None) -> Frame:
    """SVMLight (H2O's ``SVMLightParser``): ``target idx:value ...``
    rows, 1-based indices, an absent feature is 0 (not NA); densified
    into float32 columns C2.. beside the target C1."""
    dev = _device.resolve(device)
    targets: List[float] = []
    rows: List[Dict[int, float]] = []
    max_idx = 0
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            targets.append(float(parts[0]))
            d: Dict[int, float] = {}
            for p in parts[1:]:
                k, _, v = p.partition(":")
                if k == "qid":     # optional ranking-group token
                    continue
                idx = int(k)
                if idx < 1:
                    raise ValueError(
                        f"{path}: svmlight indices are 1-based, got {idx}")
                d[idx - 1] = float(v)
                max_idx = max(max_idx, idx)
            rows.append(d)
    n = len(rows)
    X = np.zeros((n, max_idx), np.float32)
    for r, d in enumerate(rows):
        for j, v in d.items():
            X[r, j] = v
    names = ["C1"] + [f"C{j + 2}" for j in range(max_idx)]
    vecs = [Vec.from_numpy(np.asarray(targets, np.float64), device=dev)]
    vecs += [Vec.from_numpy(X[:, j], device=dev) for j in range(max_idx)]
    return Frame(names, vecs, key=key or os.path.basename(path))


# ------------------------------------------------------------ arrow-backed

def _arrow_table_to_frame(table, device=None,
                          key: Optional[str] = None) -> Frame:
    """A pyarrow table's columns: dictionary columns as enums, strings as
    enums of their labels, booleans, timestamps and dates (as int64) and
    every number as float64 values, as the JAX package reads them."""
    import pyarrow as pa
    dev = _device.resolve(device)
    names = []
    vecs = []
    for cname in table.column_names:
        col = table.column(cname)
        typ = col.type
        names.append(cname)
        if pa.types.is_dictionary(typ):
            combined = col.combine_chunks()
            if isinstance(combined, pa.ChunkedArray):
                combined = combined.chunk(0)
            dom = [str(v) for v in combined.dictionary.to_pylist()]
            idx = combined.indices.to_numpy(zero_copy_only=False)
            codes = np.where(np.isnan(idx.astype(np.float64)), -1,
                             idx).astype(np.int32) \
                if idx.dtype.kind == "f" else idx.astype(np.int32)
            vecs.append(Vec.from_numpy(codes, vtype=T_ENUM,
                                       domain=tuple(dom), device=dev))
        elif (pa.types.is_string(typ) or pa.types.is_large_string(typ)):
            vals = np.asarray(col.to_pylist(), dtype=object)
            vecs.append(Vec.from_numpy(vals, device=dev))
        elif pa.types.is_boolean(typ):
            arr = col.to_numpy(zero_copy_only=False).astype(np.float64)
            vecs.append(Vec.from_numpy(arr, device=dev))
        elif pa.types.is_timestamp(typ) or pa.types.is_date(typ):
            arr = col.cast(pa.int64()).to_numpy(zero_copy_only=False)
            vecs.append(Vec.from_numpy(arr.astype(np.float64), device=dev))
        else:
            arr = col.to_numpy(zero_copy_only=False)
            vecs.append(Vec.from_numpy(np.asarray(arr, np.float64),
                                       device=dev))
    return Frame(names, vecs, key=key)


def parse_parquet(path: str, device=None,
                  key: Optional[str] = None) -> Frame:
    import pyarrow.parquet as pq
    table = pq.read_table(path)
    return _arrow_table_to_frame(table, device=device,
                                 key=key or os.path.basename(path))


def parse_orc(path: str, device=None, key: Optional[str] = None) -> Frame:
    import pyarrow.orc as po
    table = po.ORCFile(path).read()
    return _arrow_table_to_frame(table, device=device,
                                 key=key or os.path.basename(path))


class _AvroReader:
    """An Avro object container file decoder on the standard library
    (H2O's ``AvroParser``, which flattens a record's top-level fields
    into columns the same way): the null and deflate codecs, flat record
    schemas of primitives, unions (nullable ones) and enums; a nested
    record, array, map or fixed raises."""

    MAGIC = b"Obj\x01"

    def __init__(self, buf: bytes):
        self.b = buf
        self.pos = 0

    def _long(self) -> int:
        # zigzag varint
        shift, acc = 0, 0
        while True:
            byte = self.b[self.pos]
            self.pos += 1
            acc |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)

    def _bytes(self) -> bytes:
        n = self._long()
        out = self.b[self.pos:self.pos + n]
        self.pos += n
        return out

    def _raw(self, n: int) -> bytes:
        out = self.b[self.pos:self.pos + n]
        self.pos += n
        return out

    def read_header(self):
        if self._raw(4) != self.MAGIC:
            raise ValueError("not an Avro object container file")
        meta = {}
        while True:
            n = self._long()
            if n == 0:
                break
            if n < 0:          # block with byte-size prefix
                self._long()
                n = -n
            for _ in range(n):
                k = self._bytes().decode()
                meta[k] = self._bytes()
        self.sync = self._raw(16)
        self.codec = meta.get("avro.codec", b"null").decode()
        self.schema = json.loads(meta["avro.schema"].decode())
        if self.schema.get("type") != "record":
            raise NotImplementedError(
                "only record-schema avro files parse to frames")
        return self.schema

    def _decode_value(self, typ):
        if isinstance(typ, dict):
            t = typ.get("type")
            if t == "enum":
                return typ["symbols"][self._long()]
            if t in ("record", "array", "map", "fixed"):
                raise NotImplementedError(
                    f"nested avro type '{t}' is not tabular")
            typ = t
        if isinstance(typ, list):            # union
            branch = typ[self._long()]
            return self._decode_value(branch)
        if typ == "null":
            return None
        if typ == "boolean":
            v = self.b[self.pos]
            self.pos += 1
            return bool(v)
        if typ in ("int", "long"):
            return self._long()
        if typ == "float":
            return struct.unpack("<f", self._raw(4))[0]
        if typ == "double":
            return struct.unpack("<d", self._raw(8))[0]
        if typ == "string":
            return self._bytes().decode()
        if typ == "bytes":
            return self._bytes()
        raise NotImplementedError(f"avro type '{typ}'")

    def records(self):
        fields = self.schema["fields"]
        while self.pos < len(self.b):
            n_obj = self._long()
            n_bytes = self._long()
            block = self._raw(n_bytes)
            if self._raw(16) != self.sync:
                raise ValueError("avro sync marker mismatch")
            if self.codec == "deflate":
                block = zlib.decompress(block, -15)
            elif self.codec != "null":
                raise NotImplementedError(
                    f"avro codec '{self.codec}' (null/deflate supported)")
            sub = _AvroReader(block)
            for _ in range(n_obj):
                yield {f["name"]: sub._decode_value(f["type"])
                       for f in fields}


def parse_avro(path: str, device=None, key: Optional[str] = None) -> Frame:
    """An Avro object container file's records: string and bytes fields
    as enums of their labels (None as NA), every other field as float64
    values (None as NaN)."""
    dev = _device.resolve(device)
    with open(path, "rb") as f:
        rd = _AvroReader(f.read())
    try:
        rd.read_header()
        records = list(rd.records())
    except (IndexError, KeyError) as e:
        raise ValueError(f"{path}: truncated or malformed avro "
                         f"container file") from e
    if not records:
        raise ValueError(f"{path}: empty avro file")
    names = [f["name"] for f in rd.schema["fields"]]
    cols = {}
    for n in names:
        vals = [r.get(n) for r in records]
        if any(isinstance(v, (str, bytes)) for v in vals):
            cols[n] = np.asarray(
                ["" if v is None
                 else (v.decode("utf-8", "replace")
                       if isinstance(v, bytes) else str(v))
                 for v in vals])
        else:
            cols[n] = np.asarray([np.nan if v is None else float(v)
                                  for v in vals])
    fr = Frame.from_numpy(cols, device=dev)
    fr.key = key or os.path.basename(path)
    return fr


def parse_xls(path: str, device=None, key: Optional[str] = None) -> Frame:
    """An xlsx workbook's first sheet (H2O's ``XlsxParser``): a zip of
    XML parts, read with ``zipfile`` and ``ElementTree``; the first row
    names the columns, a column of numbers is float64, any other an enum
    of its labels. Legacy BIFF ``.xls`` raises: it needs ``xlrd``."""
    dev = _device.resolve(device)
    if path.lower().endswith(".xls"):
        raise NotImplementedError(
            "legacy BIFF .xls needs the optional 'xlrd' package, which "
            "this image does not carry; convert to .xlsx or csv")
    ns = {"m": ("http://schemas.openxmlformats.org/spreadsheetml/2006/"
                "main")}
    with zipfile.ZipFile(path) as z:
        shared = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.findall("m:si", ns):
                shared.append("".join(t.text or ""
                                      for t in si.iter(
                                          "{%s}t" % ns["m"])))
        sheets = sorted(n for n in z.namelist()
                        if re.match(r"xl/worksheets/sheet\d*\.xml$", n))
        if not sheets:
            raise ValueError(f"{path}: xlsx archive has no worksheet "
                             f"part (xl/worksheets/sheet*.xml)")
        root = ET.fromstring(z.read(sheets[0]))
    rows = []
    for row in root.iter("{%s}row" % ns["m"]):
        cells = {}
        seq = 0
        for c in row.findall("m:c", ns):
            # c/@r is optional in OOXML: without it, the next column
            ref = c.get("r") or ""
            mref = re.match(r"([A-Z]+)", ref)
            if mref:
                ci = 0
                for ch in mref.group(1):
                    ci = ci * 26 + (ord(ch) - 64)
            else:
                ci = seq + 1
            seq = ci
            v = c.find("m:v", ns)
            raw = v.text if v is not None else None
            if c.get("t") == "s" and raw is not None:
                try:
                    raw = shared[int(raw)]
                except (ValueError, IndexError) as e:
                    # a shared-string index that is not an int or lies
                    # past the table is a corrupt archive, not a value
                    raise ValueError(
                        f"{path}: malformed xlsx (shared-string index "
                        f"{raw!r} in cell {ref or seq}: {e})") from e
            elif c.get("t") == "inlineStr":
                raw = "".join(t.text or "" for t in c.iter(
                    "{%s}t" % ns["m"]))
            cells[ci - 1] = raw
        rows.append(cells)
    if not rows or all(not r for r in rows):
        # a sheet of empty <row> elements is as empty as no rows
        raise ValueError(f"{path}: empty sheet")
    ncol = max(max(r) for r in rows if r) + 1
    header = [str(rows[0].get(i, f"C{i + 1}")) for i in range(ncol)]
    body = rows[1:]
    cols = {}
    for i, name in enumerate(header):
        vals = [r.get(i) for r in body]
        try:
            cols[name] = np.asarray(
                [np.nan if v in (None, "") else float(v) for v in vals])
        except (TypeError, ValueError):
            cols[name] = np.asarray(["" if v is None else str(v)
                                     for v in vals])
    fr = Frame.from_numpy(cols, device=dev)
    fr.key = key or os.path.basename(path)
    return fr


FORMAT_PARSERS = {
    "arff": parse_arff,
    "svmlight": parse_svmlight,
    "parquet": parse_parquet,
    "orc": parse_orc,
    "avro": parse_avro,
    "xls": parse_xls,
}
