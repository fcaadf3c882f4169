"""Compressed CSV inputs of the port against the JAX package's: the same
gzip (multi-member and single-stream) or zstd (store-mode and
entropy-coded) file through ``h2o3_tpu_torch.import_file(...,
device="cpu")`` and ``h2o3_tpu.import_file`` gives the same frame bit
for bit, over one byte range and over many; the profile names the
inflate and its degrade; ``parse_setup`` reads the inflated head; a
transient read error is retried."""
import gzip
import importlib
import logging
import sys

import pytest

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu.ingest import compress as jcompress
from h2o3_tpu_torch.ingest import compress as tcompress
from test_torch_ingest import _mixed_csv, assert_same_frame
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

jparse = importlib.import_module("h2o3_tpu.ingest.parse")
tparse = importlib.import_module("h2o3_tpu_torch.ingest.parse")


def _text(nrow=1500):
    return _mixed_csv(nrow).encode()


def _zstd_entropy(data: bytes, frame_bytes: int) -> bytes:
    import zstandard
    c = zstandard.ZstdCompressor(level=3)
    return b"".join(c.compress(data[s:s + frame_bytes])
                    for s in range(0, len(data), frame_bytes))


WRITERS = {
    "gzip_members": lambda d: tcompress.gzip_compress_members(d, 4096),
    "gzip_single": lambda d: gzip.compress(d, 6, mtime=0),
    "zstd_store": lambda d: tcompress.zstd_compress_store(d, 4096),
    "zstd_entropy": lambda d: _zstd_entropy(d, 4096),
}
# what each kind must report: (format, parallel, degrade reason)
EXPECT = {"gzip_members": ("gzip", True, None),
          "gzip_single": ("gzip", False, "gzip_single_stream"),
          "zstd_store": ("zstd", True, None),
          "zstd_entropy": ("zstd", True, None)}


def _write(tmp_path, kind, data=None):
    p = tmp_path / f"{kind}.csv.{'gz' if kind.startswith('gzip') else 'zst'}"
    p.write_bytes(WRITERS[kind](data if data is not None else _text()))
    return str(p)


@pytest.mark.parametrize("ranges", ["one_range", "many_ranges"])
@pytest.mark.parametrize("kind", sorted(WRITERS))
def test_compressed_import_matches_jax(tmp_path, monkeypatch, kind, ranges):
    monkeypatch.setenv("H2O3_INGEST_WORKERS", "8")
    path = _write(tmp_path, kind)
    if ranges == "many_ranges":
        monkeypatch.setattr(jparse, "_PARALLEL_PARSE_BYTES", 1)
        monkeypatch.setattr(tparse, "_PARALLEL_PARSE_BYTES", 1)
    jfr = jh2o.import_file(path)
    jprof = dict(jparse.LAST_PROFILE)
    fr = th2o.import_file(path, device="cpu")
    prof = dict(tparse.LAST_PROFILE)
    assert_same_frame(fr, jfr)
    assert prof["chunks"] == jprof["chunks"]
    assert prof["chunks"] == (1 if ranges == "one_range" else 8)
    fmt, parallel, reason = EXPECT[kind]
    (info,) = prof["compressed"]
    (jinfo,) = jprof["compressed"]
    for k in ("format", "members", "parallel", "reason", "ratio"):
        assert info[k] == jinfo[k], k
    assert (info["format"], info["parallel"], info["reason"]) == \
        (fmt, parallel, reason)
    assert prof["degrade_reasons"] == ({reason: 1} if reason else {})
    assert prof["decompress_s"] == info["inflate_s"] > 0
    assert info["compressed_bytes"] == len(open(path, "rb").read())
    plain = tmp_path / "plain.csv"
    plain.write_bytes(_text())
    assert_same_frame(fr, th2o.import_file(str(plain), device="cpu"))


@pytest.mark.parametrize("kind", sorted(WRITERS))
def test_parse_setup_reads_the_inflated_head(tmp_path, kind):
    path = _write(tmp_path, kind)
    plain = tmp_path / "plain.csv"
    plain.write_bytes(_text())
    t, j = th2o.parse_setup(path), jparse.parse_setup(path)
    p = th2o.parse_setup(str(plain))
    for s in (j, p):
        assert (t.separator, t.header, t.column_names, t.column_types,
                t.na_strings) == (s.separator, s.header, s.column_names,
                                  s.column_types, s.na_strings)


@pytest.mark.parametrize("nbytes", [1, 100, 5000, 1 << 20])
@pytest.mark.parametrize("kind", sorted(WRITERS))
def test_head_bytes_matches_jax(tmp_path, kind, nbytes):
    path = _write(tmp_path, kind)
    head = tcompress.head_bytes(path, nbytes)
    assert head == jcompress.head_bytes(path, nbytes) == _text()[:nbytes]


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("member_bytes", [1, 1000, 1 << 20])
def test_writers_match_jax_and_round_trip(member_bytes, workers):
    data = _text(300)
    gz = tcompress.gzip_compress_members(data, member_bytes, workers=workers)
    assert gz == jcompress.gzip_compress_members(data, member_bytes)
    zs = tcompress.zstd_compress_store(data, member_bytes)
    assert zs == jcompress.zstd_compress_store(data, member_bytes)
    for blob in (gz, zs):
        out, info = tcompress.decompress_bytes(blob, workers)
        assert out == data
        assert info == jcompress.decompress_bytes(blob, workers)[1]


def test_empty_inputs_round_trip():
    for blob in (tcompress.gzip_compress_members(b""),
                 tcompress.zstd_compress_store(b"")):
        assert tcompress.decompress_bytes(blob)[0] == b""
    with pytest.raises(ValueError, match="not gzip or zstd"):
        tcompress.decompress_bytes(b"plain,text\n")


def test_magic_hit_inside_a_member_degrades_serially():
    """A candidate member offset that is not a member start fails its
    slice's decode, and the file inflates serially instead, with the
    JAX package's reason."""
    data = _text(300)
    gz = gzip.compress(data, 6, mtime=0)
    fake = gz[:10] + b"\x1f\x8b\x08\x00" + b"\x00" * 6
    blob = gzip.compress(data[:50], 6, mtime=0) + gz
    j_out, j_info = jcompress.decompress_bytes(blob, 4)
    t_out, t_info = tcompress.decompress_bytes(blob, 4)
    assert t_out == j_out == data[:50] + data
    assert t_info == j_info
    # a gzip header planted inside a member's stored bytes
    raw = data[:200] + fake + data[200:]
    blob = gzip.compress(raw, 0, mtime=0)
    t_out, t_info = tcompress.decompress_bytes(blob, 4)
    assert t_out == raw
    assert t_info == jcompress.decompress_bytes(blob, 4)[1]
    assert t_info["reason"] in ("gzip_member_misdetect", "gzip_single_stream")


def test_entropy_coded_zstd_without_the_module_raises_jax_message(
        tmp_path, monkeypatch):
    path = _write(tmp_path, "zstd_entropy")
    monkeypatch.setitem(sys.modules, "zstandard", None)
    msgs = []
    for fn in (jcompress.decompress_path, tcompress.decompress_path):
        with pytest.raises(RuntimeError, match="zstandard") as e:
            fn(path, 2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(RuntimeError, match="zstandard"):
        th2o.import_file(path, device="cpu")
    # store-mode frames need no module
    store = _write(tmp_path, "zstd_store")
    assert tcompress.decompress_path(store, 2)[0] == _text()


def test_decompress_path_retries_a_transient_error(tmp_path, monkeypatch,
                                                   caplog):
    path = _write(tmp_path, "gzip_members")
    real = tcompress.decompress_bytes
    calls = []

    def flaky(raw, workers=1):
        calls.append(len(raw))
        if len(calls) == 1:
            raise OSError("connection reset by peer")
        return real(raw, workers)

    monkeypatch.setattr(tcompress, "decompress_bytes", flaky)
    with caplog.at_level(logging.WARNING, logger="h2o3_tpu_torch"):
        data, info = tcompress.decompress_path(path, 2)
    assert data == _text() and len(calls) == 2
    assert info["parallel"] and info["path"] == path
    assert any("ingest.decompress: transient failure (OSError)" in r.message
               and r.name == "h2o3_tpu_torch" for r in caplog.records)
    # a missing file fails the same way every attempt: no retry
    calls.clear()
    with pytest.raises(FileNotFoundError):
        tcompress.decompress_path(str(tmp_path / "missing.gz"), 2)
    assert calls == []


def test_single_stream_gzip_over_many_ranges_counts_its_degrade_once(
        tmp_path, monkeypatch):
    path = _write(tmp_path, "gzip_single")
    monkeypatch.setattr(tparse, "_PARALLEL_PARSE_BYTES", 1)
    fr = th2o.import_file([path, path], device="cpu")
    prof = dict(tparse.LAST_PROFILE)
    assert fr.nrow == 3000
    assert prof["degrade_reasons"] == {"gzip_single_stream": 2}
    assert prof["fallback_reasons"] == {} and prof["native"]
    assert len(prof["compressed"]) == 2
