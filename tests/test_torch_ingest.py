"""CSV ingest of the port against the JAX package's: the same file
through ``h2o3_tpu_torch.import_file(..., device="cpu")`` and
``h2o3_tpu.import_file`` gives the same names, types, domains, enum
codes, NA masks, float32 device values and host copies (float64, exact
int64, time in int64 ms), bit for bit. The cases are those of
``tests/test_ingest_pipeline.py``; each runs through the port's native
tokenizer and its Python tokenizer, over one byte range and over many.
Also: declined ranges are counted by reason, the chunk merge masks NA
codes, and legacy ``.xls`` is refused as the JAX package refuses it."""
import importlib

import numpy as np
import pytest
import torch

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu.ingest import chunk as jchunk
from h2o3_tpu_torch import _device
from h2o3_tpu_torch.ingest import chunk as tchunk
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

jparse = importlib.import_module("h2o3_tpu.ingest.parse")
tparse = importlib.import_module("h2o3_tpu_torch.ingest.parse")


def _mixed_csv(nrow=200, quotes=True):
    """int, real, enum, time and string-like columns with NA sentinels in
    each, and quoted fields with embedded commas."""
    rng = np.random.default_rng(7)
    lines = ["id,score,city,seen,note"]
    cities = ["ames", "berlin", "cairo",
              "delhi,town" if quotes else "delhitown"]
    for i in range(nrow):
        idv = "NA" if i % 31 == 7 else str(i + 1)
        score = "NaN" if i % 17 == 3 else f"{rng.normal():.6f}"
        c = cities[int(rng.integers(0, len(cities)))]
        city = f'"{c}"' if (quotes and "," in c) else c
        seen = "" if i % 23 == 5 else f"2021-{1 + i % 12:02d}-{1 + i % 28:02d}"
        lines.append(f"{idv},{score},{city},{seen},n{i % 5}")
    return "\n".join(lines) + "\n"


def _enum_parity_csv():
    """NA labels, labels recurring across ranges, labels over 64 KiB, a
    quoted one among them."""
    big_a = "L" * (70 * 1024)
    big_b = "M" * (66 * 1024) + ",tail"
    labels = ["alpha", "beta", "NA", '"q,uoted"']
    lines = ["g,x"]
    for i in range(600):
        lab = (big_a if i == 3 else f'"{big_b}"' if i == 590
               else labels[i % len(labels)])
        lines.append(f"{lab},{i}")
    return "\n".join(lines) + "\n"


def _parallel_matrix_csv():
    lines = ["g,x"]
    for i in range(400):
        kind = i % 5
        lines.append([f'"a,{i}\nb",{i}', f'"q""{i}""",{i}',
                      f" pad{i % 7} ,{i}", '"NA",%d' % i,
                      f"plain{i % 11},{i}"][kind])
    return "\n".join(lines) + "\n"


def _poisoned_csv():
    lines = [f"{i},tok{i % 13}" for i in range(1, 800)]
    lines[500] = "9,extra,cells,beyond,the,schema"   # ragged: declined
    return "x,s\n" + "\n".join(lines) + "\n"


WIDE = (1 << 53) + 1

# case -> (files, import_file keywords, decline reason the native path
# must count, or None where every range must stay native)
CASES = {
    # the tokenizer parity matrix (test_ingest_pipeline.py:249)
    "quoted_embedded_delimiter": (
        ['g,x\n"a,b",1\nplain,2\n"c,d,e",3\n"a,b",4\n'], {}, None),
    "quoted_embedded_newline": (
        ['g,x\n"line1\nline2",1\nplain,2\n"a\nb\nc",3\n'], {}, None),
    "escaped_quotes": (
        ['g,x\n"he said ""hi""",1\n"""lead",2\n"trail""",3\nplain,4\n'], {},
        None),
    "long_numerics": (
        ["x,y\n" + "0." + "1" * 70 + ",1\n" + "9" * 80 + "e-70,2\n3,3\n"],
        {}, None),
    "unicode_whitespace": (
        ["g,x\n padded ,1\n　wide　,2\n ascii , 3 \n"], {}, None),
    "na_inside_quotes": (['g,x\n"NA",1\n"na",2\nreal,3\n"",4\n'], {}, None),
    "crlf_lf_mixed": (["g,x\r\na,1\r\nb,2\nc,3\r\nd,4\n"], {}, None),
    "quoted_numeric_cells": (['x,y\n"1.5",1\n"2e3",2\n" 7 ",3\n'], {}, None),
    "parallel_matrix": ([_parallel_matrix_csv()], {}, None),
    # quoted fields and NA sentinels (:106), unquoted (:63)
    "mixed_quoted": ([_mixed_csv()], {}, None),
    "mixed_unquoted": ([_mixed_csv(quotes=False)], {}, None),
    # the numeric NA sentinel (:116): no native range at all
    "numeric_na_sentinel": (["a,b\n1,-999\n-999,2\n3,4\n"],
                            {"na_strings": ["-999"]}, "numeric_na_sentinel"),
    # wide ints (:140, :152)
    "wide_int_exact": (["k,v\n%d,1\n%d,2\n%d,3\n" % (WIDE, WIDE + 2, -WIDE)],
                       {}, None),
    "wide_int_with_na": (["k\n%d\nNA\n7\n" % WIDE], {}, None),
    # an all-NA numeric column (:189)
    "all_na_numeric": (["a,b\nNA,1\nNA,2\nNA,3\n"], {}, None),
    # the rbind enum union (:164), wide ints across files (:176), time
    # across files (:436)
    "rbind_enum_union": (["g,x\nred,1\nblue,2\nred,3\n",
                          "g,x\ngreen,4\nred,5\nNA,6\n"], {}, None),
    "rbind_wide_int": (["k\n%d\n%d\n" % (WIDE, WIDE + 2), "k\n5\n6\n"], {},
                       None),
    "rbind_time": (["t\n2020-01-01\n2020-01-02\n", "t\n2021-05-05\nNA\n"],
                   {}, None),
    # enum encode parity (:472)
    "enum_encode_parity": ([_enum_parity_csv()], {}, None),
    # the range-scoped fallback (:301)
    "range_scoped_fallback": ([_poisoned_csv()], {}, "ragged_rows"),
}


def _write(tmp_path, case):
    paths = []
    for k, text in enumerate(CASES[case][0]):
        p = tmp_path / f"{case}_{k}.csv"
        p.write_bytes(text.encode("utf-8"))
        paths.append(str(p))
    return paths


_JAX_FRAMES = {}


def _jax_frame(tmp_path, case, ranges):
    """The JAX package's frame of ``case`` on its native tokenizer, over
    one range a file or over the same many ranges as the port (the range
    cuts decide a type: a wide-int column with an NA stays int where both
    fall in one range, and becomes real where they do not); parsed once
    per module."""
    if (case, ranges) not in _JAX_FRAMES:
        paths = _write(tmp_path, case)
        with pytest.MonkeyPatch.context() as mp:
            if ranges == "many_ranges":
                mp.setattr(jparse, "_PARALLEL_PARSE_BYTES", 1)
            _JAX_FRAMES[case, ranges] = jh2o.import_file(
                paths if len(paths) > 1 else paths[0], **CASES[case][1])
    return _JAX_FRAMES[case, ranges]


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({2: np.int16, 4: np.int32, 8: np.int64}[a.itemsize])


def _not_na(vtype: str, data: np.ndarray) -> np.ndarray:
    """The rows of a column's device values that are not NA (code -1 in
    an enum column, NaN elsewhere)."""
    return data >= 0 if vtype == "enum" else ~np.isnan(data)


def assert_same_frame(t, j):
    """Names, types, domains; device values (float32 or int32 codes) and
    NA masks; host copies (strings, float64, int64, time ms), bit for
    bit."""
    assert t.names == j.names
    assert t.nrow == j.nrow
    for n in j.names:
        tv, jv = t.vec(n), j.vec(n)
        assert tv.type == jv.type, n
        assert tv.domain == jv.domain, n
        if jv.type == "string":
            assert tv.data is None
            assert list(tv.host_data) == list(jv.host_data), n
            continue
        jd = np.asarray(jv.data)[:j.nrow]
        td = tv.data.numpy()
        assert td.dtype == jd.dtype, n
        np.testing.assert_array_equal(_bits(td), _bits(jd), err_msg=n)
        # the JAX package's own NA mask where j is its frame
        j_ok = (np.asarray(jv.valid_mask())[:j.nrow]
                if hasattr(jv, "valid_mask") else _not_na(jv.type, jd))
        np.testing.assert_array_equal(_not_na(tv.type, td), j_ok,
                                      err_msg=n)
        if jv.host_data is None:
            assert tv.host_data is None, n
        else:
            assert tv.host_data.dtype == jv.host_data.dtype, n
            np.testing.assert_array_equal(_bits(tv.host_data),
                                          _bits(jv.host_data), err_msg=n)


def _decline_every_range(monkeypatch):
    """The native scan declines every range, so that each goes through
    the Python tokenizer by the parse's own per-range fallback."""
    monkeypatch.setattr(tparse, "encode_chunk_native",
                        lambda *a: "declined_by_test")


def _port_import(paths, kw):
    return th2o.import_file(paths if len(paths) > 1 else paths[0],
                            device="cpu", **kw)


@pytest.mark.parametrize("ranges", ["one_range", "many_ranges"])
@pytest.mark.parametrize("tokenizer", ["native", "python"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_import_file_matches_jax(tmp_path, monkeypatch, case, tokenizer,
                                 ranges):
    # eight workers: the JAX package cuts max(workers, data shards) ranges,
    # and the suite's mesh has eight devices
    monkeypatch.setenv("H2O3_INGEST_WORKERS", "8")
    jfr = _jax_frame(tmp_path, case, ranges)
    paths = _write(tmp_path, case)
    kw, reason = CASES[case][1], CASES[case][2]
    if ranges == "many_ranges":
        monkeypatch.setattr(tparse, "_PARALLEL_PARSE_BYTES", 1)
    if tokenizer == "python":
        _decline_every_range(monkeypatch)
    fr = _port_import(paths, kw)
    prof = dict(tparse.LAST_PROFILE)
    assert_same_frame(fr, jfr)
    if ranges == "many_ranges" and sum(len(t) for t in CASES[case][0]) > 200:
        assert prof["chunks"] > 1
    if tokenizer == "python":
        assert prof["native_ranges"] == 0
        assert prof["fallback_ranges"] == prof["chunks"]
        assert set(prof["fallback_reasons"]) <= {"declined_by_test",
                                                 "numeric_na_sentinel"}
    elif reason is None:
        assert prof["native"] and prof["fallback_ranges"] == 0, prof
    else:
        assert reason in prof["fallback_reasons"], prof
        if ranges == "many_ranges" and reason == "ragged_rows":
            # only the poisoned range is read again; its neighbours stay
            assert prof["native_ranges"] >= prof["chunks"] - 2, prof


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c][2] is None))
def test_native_and_python_tokenizers_agree_in_the_port(tmp_path,
                                                        monkeypatch, case):
    paths = _write(tmp_path, case)
    monkeypatch.setattr(tparse, "_PARALLEL_PARSE_BYTES", 1)
    native = _port_import(paths, CASES[case][1])
    assert tparse.LAST_PROFILE["native"]
    _decline_every_range(monkeypatch)
    python = _port_import(paths, CASES[case][1])
    assert not tparse.LAST_PROFILE["native"]
    assert_same_frame(python, native)


def test_values_of_the_quoted_and_na_case(tmp_path):
    p = tmp_path / "mixed.csv"
    p.write_text(_mixed_csv())
    fr = th2o.import_file(str(p), device="cpu")
    assert fr.types == {"id": "int", "score": "real", "city": "enum",
                        "seen": "time", "note": "enum"}
    assert "delhi,town" in fr.vec("city").domain
    assert fr.vec("id").na_count() == sum(1 for i in range(200)
                                          if i % 31 == 7)
    assert fr.vec("seen").na_count() == sum(1 for i in range(200)
                                            if i % 23 == 5)
    codes = fr.vec("city").to_numpy()
    assert codes.min() >= -1 and codes.max() < fr.vec("city").cardinality


@pytest.mark.parametrize("has_na", [False, True])
def test_merge_enum_masks_na_codes(has_na):
    """The union remap of chunks whose domains differ: an NA code stays NA
    (masked out of the lookup), as the JAX merge gives it."""
    a = ([0, 1, -1, 1] if has_na else [0, 1, 1, 0], ["red", "zed"])
    b = ([1, -1, 0] if has_na else [1, 0, 0], ["blue", "red"])
    out = {}
    for mod in (tchunk, jchunk):
        chunks = [mod.EncodedColumn("enum", np.array(c, np.int32),
                                    domain=list(d)) for c, d in (a, b)]
        out[mod] = mod._merge_enum(chunks)
    t, j = out[tchunk], out[jchunk]
    assert t.domain == j.domain == ["blue", "red", "zed"]
    np.testing.assert_array_equal(t.data, j.data)
    assert (t.data == -1).sum() == (2 if has_na else 0)
    lut = tchunk._lut_remap(np.array([5, 6], np.int32),
                            np.array([1, -1, 0], np.int32))
    np.testing.assert_array_equal(lut, [6, -1, 5])


def test_legacy_xls_is_refused_with_the_jax_message(tmp_path):
    """Legacy BIFF ``.xls`` is the one input both packages refuse, for
    want of ``xlrd``, with the same message; every other input reads
    (``test_torch_ingest_compress.py``, ``_formats.py``, ``_remote.py``)."""
    p = tmp_path / "old.xls"
    p.write_bytes(b"\xd0\xcf\x11\xe0junk")
    msgs = []
    for imp in (lambda: th2o.import_file(str(p), device="cpu"),
                lambda: jh2o.import_file(str(p))):
        with pytest.raises(NotImplementedError, match="xlrd") as e:
            imp()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_import_file_raises_without_cuda(tmp_path, monkeypatch):
    p = tmp_path / "a.csv"
    p.write_text("a,b\n1,2\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_device, "_default", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th2o.import_file(str(p))
    assert th2o.import_file(str(p), device="cpu").device.type == "cpu"


def test_parse_setup_matches_jax(tmp_path):
    p = tmp_path / "mixed.csv"
    p.write_text(_mixed_csv())
    t, j = th2o.parse_setup(str(p)), jparse.parse_setup(str(p))
    assert (t.separator, t.header, t.column_names, t.column_types,
            t.na_strings) == (j.separator, j.header, j.column_names,
                              j.column_types, j.na_strings)
    q = tmp_path / "semi.txt"
    q.write_text("1;2.5;x\n3;4.5;y\n")
    t, j = th2o.parse_setup(str(q)), jparse.parse_setup(str(q))
    assert (t.separator, t.header, t.column_names, t.column_types) == \
        (j.separator, j.header, j.column_names, j.column_types) == \
        (";", False, ["C1", "C2", "C3"], ["int", "real", "enum"])
