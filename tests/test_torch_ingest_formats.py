"""The formats beyond CSV, the port against the JAX package: the same
ARFF, SVMLight, Parquet, ORC, Avro (null and deflate codecs) or xlsx
file through ``h2o3_tpu_torch.import_file(..., device="cpu")`` and
``h2o3_tpu.import_file`` gives the same frame bit for bit; so does a list
of such files (``_rbind``: enum domains unioned, wide ints exact, time
kept, mixed types through labels); a truncated or unsupported file
raises as it does there (legacy ``.xls``: ``test_torch_ingest.py``).
The files are written by hand from the format specs (the cases
of ``tests/test_formats.py`` and ``tests/test_formats2.py``)."""
import importlib
import json
import struct
import zipfile
import zlib

import numpy as np
import pytest

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu_torch.ingest import formats as tformats
from test_torch_ingest import WIDE, assert_same_frame
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

jparse = importlib.import_module("h2o3_tpu.ingest.parse")
tparse = importlib.import_module("h2o3_tpu_torch.ingest.parse")


# ------------------------------------------------------------ writers

def _arff(tmp_path, name="t.arff", levels=("setosa", "versicolor",
                                           "virginica"), rows=None):
    rows = rows or ["5.1, setosa, 'hello', 2020-01-02, 'b c'",
                    "4.9, virginica, world, 2021-03-04 05:06:07, a",
                    "?, versicolor, ?, ?, ?",
                    "1e3, setosa, 'x y', 1577923200000, 'b c'"]
    p = tmp_path / name
    p.write_text("% comment\n@RELATION test\n"
                 "@ATTRIBUTE sepal_len NUMERIC\n"
                 f"@ATTRIBUTE species {{{', '.join(levels)}}}\n"
                 "@ATTRIBUTE note STRING\n"
                 "@ATTRIBUTE 'when' DATE \"yyyy-MM-dd HH:mm:ss\"\n"
                 "@ATTRIBUTE \"quoted nom\" {'a', 'b c'}\n"
                 "@DATA\n" + "\n".join(rows) + "\n")
    return str(p)


def _svmlight(tmp_path, name="t.svm", text=None):
    p = tmp_path / name
    p.write_text(text or "1 1:0.5 3:2.0\n-1 2:1.5  # comment\n"
                 "1 qid:3 1:1.0 2:-1.0 3:0.25\n\n0 4:7\n")
    return str(p)


def _parquet(tmp_path, name="t.parquet", cats=("a", "b", "c"), seed=0,
             n=500, orc=False):
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    num = rng.normal(size=n)
    num[::37] = np.nan
    cols = {
        "num": num,
        "int": rng.integers(0, 100, n),
        "big": np.arange(n, dtype=np.int64) + (1 << 30),
        "cat": pa.array(np.array(cats, dtype=object)[
            rng.integers(0, len(cats), n)]).dictionary_encode(),
        "txt": [None if i % 11 == 0 else f"s{i % 40}" for i in range(n)],
        "flag": rng.random(n) < 0.3,
        "when": pa.array((np.arange(n) * 3_600_000).astype("datetime64[ms]")),
    }
    if orc:
        import pyarrow.orc as po
        del cols["cat"]                   # ORC has no dictionary type
        p = str(tmp_path / name.replace(".parquet", ".orc"))
        po.write_table(pa.table(cols), p)
        return p
    import pyarrow.parquet as pq
    p = str(tmp_path / name)
    pq.write_table(pa.table(cols), p)
    return p


def _zz(n: int) -> bytes:
    """Avro's zigzag varint."""
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _avstr(s: str) -> bytes:
    raw = s.encode()
    return _zz(len(raw)) + raw


AVRO_SCHEMA = {"type": "record", "name": "row", "fields": [
    {"name": "a", "type": "double"},
    {"name": "b", "type": "long"},
    {"name": "s", "type": {"type": "enum", "name": "col",
                           "symbols": ["red", "blue"]}},
    {"name": "m", "type": ["null", "double"]},
    {"name": "w", "type": ["null", "string"]},
    {"name": "f", "type": "float"},
    {"name": "ok", "type": "boolean"}]}


def _avro_row(a, b, s, m, w, f, ok):
    body = struct.pack("<d", a) + _zz(b) + _zz(s)
    body += _zz(0) if m is None else _zz(1) + struct.pack("<d", m)
    body += _zz(0) if w is None else _zz(1) + _avstr(w)
    return body + struct.pack("<f", f) + bytes([ok])


def _avro(tmp_path, codec=b"null", name=None, schema=AVRO_SCHEMA,
          words=("x", "y"), blocks=2):
    rows = [(1.5, 7, 0, None, words[0], 0.25, 1),
            (-2.25, -3, 1, 9.5, None, -1.5, 0),
            (0.0, 40, 0, None, words[1], 3.0, 1),
            (1e300, -(1 << 40), 1, 2.0, words[0], 0.0, 0)]
    sync = b"0123456789abcdef"
    buf = bytearray(b"Obj\x01")
    meta = {"avro.schema": json.dumps(schema).encode(), "avro.codec": codec}
    buf += _zz(len(meta))
    for k, v in meta.items():
        buf += _avstr(k) + _zz(len(v)) + v
    buf += _zz(0) + sync
    per = (len(rows) + blocks - 1) // blocks
    for lo in range(0, len(rows), per):
        part = rows[lo:lo + per]
        payload = b"".join(_avro_row(*r) for r in part)
        if codec == b"deflate":
            co = zlib.compressobj(9, zlib.DEFLATED, -15)
            payload = co.compress(payload) + co.flush()
        buf += _zz(len(part)) + _zz(len(payload)) + payload + sync
    p = tmp_path / (name or f"t_{codec.decode()}.avro")
    p.write_bytes(bytes(buf))
    return str(p)


_SHEET = """<?xml version="1.0"?>
<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">
<sheetData>
<row r="1"><c r="A1" t="s"><v>0</v></c><c r="B1" t="s"><v>1</v></c>
<c r="C1" t="s"><v>2</v></c><c r="D1" t="inlineStr"><is><t>w</t></is></c></row>
<row r="2"><c r="A2"><v>1.5</v></c><c r="B2" t="s"><v>3</v></c>
<c r="C2"><v>10</v></c><c t="inlineStr"><is><t>in</t></is></c></row>
<row r="3"><c r="A3"><v>-2</v></c><c r="B3" t="s"><v>{cat}</v></c></row>
<row r="4"><c r="A4"><v>1e30</v></c><c r="C4"><v>16777217</v></c></row>
</sheetData></worksheet>"""
_SHARED = """<?xml version="1.0"?>
<sst xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">
<si><t>num</t></si><si><t>cat</t></si><si><t>z</t></si>
<si><t>dog</t></si><si><t>cat</t></si><si><r><t>ze</t></r><r><t>bra</t></r></si></sst>"""


def _xlsx(tmp_path, name="t.xlsx", cat=4):
    p = tmp_path / name
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("xl/worksheets/sheet1.xml", _SHEET.format(cat=cat))
        z.writestr("xl/sharedStrings.xml", _SHARED)
        z.writestr("[Content_Types].xml", "<Types/>")
    return str(p)


WRITERS = {
    "arff": _arff,
    "svmlight": _svmlight,
    "parquet": _parquet,
    "orc": lambda tp: _parquet(tp, orc=True),
    "avro_null": lambda tp: _avro(tp, b"null"),
    "avro_deflate": lambda tp: _avro(tp, b"deflate"),
    "xlsx": _xlsx,
}


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_format_import_matches_jax(tmp_path, fmt):
    path = WRITERS[fmt](tmp_path)
    fr = th2o.import_file(path, device="cpu")
    assert_same_frame(fr, jh2o.import_file(path))
    assert fr.device.type == "cpu" and fr.nrow > 0
    assert fr.key == path.rsplit("/", 1)[1]


def test_format_values(tmp_path):
    """What the parsers read, beyond agreeing with the JAX package."""
    fr = th2o.import_file(_arff(tmp_path), device="cpu")
    assert fr.names == ["sepal_len", "species", "note", "when",
                        "quoted nom"]
    assert fr.vec("species").domain == ("setosa", "versicolor", "virginica")
    assert list(fr.vec("species").to_strings()) == [
        "setosa", "virginica", "versicolor", "setosa"]
    assert list(fr.vec("quoted nom").to_strings()) == ["b c", "a", None,
                                                      "b c"]
    when = fr.vec("when").to_numpy()
    assert when[0] == 1577923200000 == when[3] and np.isnan(when[2])
    fr = th2o.import_file(_svmlight(tmp_path), device="cpu")
    assert fr.ncol == 5
    np.testing.assert_array_equal(fr.vec("C3").to_numpy(),
                                  [0, 1.5, -1, 0], strict=False)
    fr = th2o.import_file(_avro(tmp_path), device="cpu")
    assert list(fr.vec("s").to_strings()) == ["red", "blue", "red", "blue"]
    assert list(fr.vec("w").to_strings()) == ["x", None, "y", "x"]
    fr = th2o.import_file(_xlsx(tmp_path), device="cpu")
    assert fr.names == ["num", "cat", "z", "w"]
    assert list(fr.vec("cat").to_strings()) == ["dog", "cat", None]
    assert list(fr.vec("w").to_strings()) == ["in", None, None]


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_two_file_list_matches_jax(tmp_path, fmt):
    """A list of two files with different enum levels: one frame whose
    domains are the union, as the JAX package's ``_rbind`` gives it."""
    a = WRITERS[fmt](_sub(tmp_path, "a"))
    if fmt == "arff":
        b = _arff(_sub(tmp_path, "b"), levels=("versicolor", "iris",
                                                "setosa", "virginica"),
                  rows=["2.5, iris, new, 2019-01-01, a"])
    elif fmt in ("parquet", "orc"):
        b = _parquet(_sub(tmp_path, "b"), cats=("d", "a", "e"), seed=5,
                     n=120, orc=fmt == "orc")
    elif fmt.startswith("avro"):
        b = _avro(_sub(tmp_path, "b"), codec=fmt.split("_")[1].encode(),
                  words=("z", "x"), blocks=1)
    elif fmt == "xlsx":
        b = _xlsx(_sub(tmp_path, "b"), cat=5)
    else:
        b = _svmlight(_sub(tmp_path, "b"), text="2 1:1 4:9\n-1 2:4 3:1\n")
    fr = th2o.import_file([a, b], device="cpu", destination_frame="both")
    jfr = jh2o.import_file([a, b], destination_frame="both")
    assert_same_frame(fr, jfr)
    assert fr.key == "both"
    one = th2o.import_file(a, device="cpu")
    assert fr.nrow == one.nrow + th2o.import_file(b, device="cpu").nrow


def _sub(tmp_path, name):
    d = tmp_path / name
    d.mkdir(exist_ok=True)
    return d


def _csv_frames(tmp_path, texts, col_types=None):
    out = []
    for k, t in enumerate(texts):
        p = tmp_path / f"f{k}.csv"
        p.write_text(t)
        out.append((th2o.import_file(str(p), device="cpu",
                                     col_types=col_types),
                    jh2o.import_file(str(p), col_types=col_types)))
    return out


RBIND = {
    # tests/test_ingest_pipeline.py:164, :177, :436
    "enum_union": ["g,x\nred,1\nblue,2\nred,3\n",
                   "g,x\ngreen,4\nred,5\nNA,6\n"],
    "wide_int": ["k\n%d\n%d\n" % (WIDE, WIDE + 2), "k\n5\n6\n"],
    "time": ["t\n2020-01-01\n2020-01-02\n", "t\n2021-05-05\nNA\n"],
    # int and real, string columns, mixed enum and number
    "int_real": ["x,s\n1,a\n2,b\n", "x,s\n2.5,c\nNA,a\n"],
    "strings": ["s\n" + "".join(f"v{i}\n" for i in range(5)),
                "s\nw\nNA\n"],
    "mixed_types": ["g,x\nred,1\nblue,2\n", "g,x\n1,3\n2,4\n"],
    "big_real": ["x\n16777217\n3\n", "x\n0.5\n16777219\n"],
}


@pytest.mark.parametrize("case", sorted(RBIND))
def test_rbind_matches_jax(tmp_path, case):
    (ta, ja), (tb, jb) = _csv_frames(
        tmp_path, RBIND[case], ["string"] if case == "strings" else None)
    t = tparse._rbind(ta, tb)
    j = jparse._rbind(ja, jb)
    assert_same_frame(t, j)
    if case == "enum_union":
        assert t.vec("g").domain == ("blue", "green", "red")
        assert list(t.vec("g").to_strings()) == ["red", "blue", "red",
                                                 "green", "red", None]
    if case == "wide_int":
        assert list(t.vec("k").to_numpy()) == [WIDE, WIDE + 2, 5, 6]
    if case == "time":
        assert t.vec("t").type == "time" and t.vec("t").na_count() == 1


def test_rbind_schema_mismatch_raises(tmp_path):
    (ta, ja), (tb, jb) = _csv_frames(tmp_path, ["a,b\n1,2\n", "a,c\n1,2\n"])
    for rbind, a, b in ((tparse._rbind, ta, tb), (jparse._rbind, ja, jb)):
        with pytest.raises(ValueError, match="identical schemas"):
            rbind(a, b)
    a = _arff(_sub(tmp_path, "a"))
    b = str(_sub(tmp_path, "b") / "other.arff")
    with open(b, "w") as f:
        f.write("@relation r\n@attribute q numeric\n@data\n1\n")
    for imp in (lambda: th2o.import_file([a, b], device="cpu"),
                lambda: jh2o.import_file([a, b])):
        with pytest.raises(ValueError, match="identical schemas"):
            imp()


@pytest.mark.parametrize("case", ["magic_only", "bad_magic", "empty",
                                  "nested", "codec", "sync"])
def test_bad_avro_raises_as_jax(tmp_path, case):
    p = tmp_path / f"{case}.avro"
    if case == "magic_only":
        p.write_bytes(b"Obj\x01")
    elif case == "bad_magic":
        p.write_bytes(b"NotAvro!" * 4)
    elif case == "empty":
        p = tmp_path / "x" / "empty.avro"
        p.parent.mkdir()
        src = _avro(tmp_path)
        raw = open(src, "rb").read()
        p.write_bytes(raw[:raw.index(b"0123456789abcdef") + 16])
    elif case == "nested":
        schema = dict(AVRO_SCHEMA, fields=AVRO_SCHEMA["fields"] + [
            {"name": "r", "type": {"type": "array", "items": "long"}}])
        p = tmp_path / "x" / "nested.avro"
        p.parent.mkdir()
        p.write_bytes(open(_avro(tmp_path, schema=schema), "rb").read())
    elif case == "codec":
        src = _avro(tmp_path, codec=b"snappy")
        p = tmp_path / src.rsplit("/", 1)[1]
    else:
        raw = bytearray(open(_avro(tmp_path), "rb").read())
        raw[-3] ^= 0xFF                      # the last block's sync
        p.write_bytes(bytes(raw))
    errs = []
    for imp in (lambda: th2o.import_file(str(p), device="cpu"),
                lambda: jh2o.import_file(str(p))):
        with pytest.raises((ValueError, NotImplementedError)) as e:
            imp()
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("case", ["svm_zero_index", "arff_no_attrs",
                                  "xlsx_no_sheet", "xlsx_empty",
                                  "xlsx_bad_shared"])
def test_bad_files_raise_as_jax(tmp_path, case):
    if case == "svm_zero_index":
        path = _svmlight(tmp_path, text="1 0:1.0\n")
    elif case == "arff_no_attrs":
        path = str(tmp_path / "t.arff")
        open(path, "w").write("@relation r\n@data\n1,2\n")
    else:
        path = str(tmp_path / "t.xlsx")
        sheet = {"xlsx_no_sheet": None,
                 "xlsx_empty": "<worksheet xmlns=\"http://schemas."
                 "openxmlformats.org/spreadsheetml/2006/main\"><sheetData>"
                 "<row r=\"1\"/></sheetData></worksheet>",
                 "xlsx_bad_shared": _SHEET.format(cat=99)}[case]
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("xl/sharedStrings.xml", _SHARED)
            if sheet:
                z.writestr("xl/worksheets/sheet1.xml", sheet)
    errs = []
    for imp in (lambda: th2o.import_file(path, device="cpu"),
                lambda: jh2o.import_file(path)):
        with pytest.raises(ValueError) as e:
            imp()
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("name,fmt", [
    ("a.arff", "arff"), ("a.ARFF", "arff"), ("a.svm", "svmlight"),
    ("a.svmlight", "svmlight"), ("a.parquet", "parquet"), ("a.pq",
                                                           "parquet"),
    ("a.orc", "orc"), ("a.avro", "avro"), ("a.xls", "xls"),
    ("a.xlsx", "xls"), ("a.csv", "csv"), ("a.csv.gz", "csv"),
    ("a.txt", "csv"), ("a", "csv")])
def test_sniff_format_matches_jax(name, fmt):
    from h2o3_tpu.ingest.formats import sniff_format
    assert tformats.sniff_format(name) == sniff_format(name) == fmt
    assert set(tformats.FORMAT_PARSERS) == {"arff", "svmlight", "parquet",
                                            "orc", "avro", "xls"}


def test_formats_run_on_the_cuda_default_only_when_asked(tmp_path,
                                                         monkeypatch):
    import torch
    from h2o3_tpu_torch import _device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_device, "_default", None)
    path = _arff(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th2o.import_file(path)
    assert th2o.import_file(path, device="cpu").device.type == "cpu"
