"""Inputs by URI and SQL tables, the port against the JAX package: a
``file://`` URI and an ``http://`` URL served by a local ``http.server``
thread on 127.0.0.1 import to the local file's frame bit for bit; the
download lands through a temporary file renamed into place, is retried
after a transient failure and not after a 4xx, and is cached; object
stores go through ``pyarrow.fs`` (a local filesystem stands in for the
remote one). ``import_sql_table`` on ``sqlite3`` in key-range and
single-fetch mode gives the JAX package's frame (the cases of
``tests/test_sql_se.py``)."""
import functools
import http.server
import logging
import os
import sqlite3
import sys
import threading
import urllib.error

import numpy as np
import pytest

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu.ingest import persist_uri as jpersist
from h2o3_tpu.ingest.sql import import_sql_table as j_import_sql_table
from h2o3_tpu_torch.ingest import compress as tcompress
from h2o3_tpu_torch.ingest import persist_uri as tpersist
from test_torch_ingest import _mixed_csv, assert_same_frame
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    d = tmp_path / "cache"
    monkeypatch.setattr(tpersist, "_CACHE_DIR", str(d))
    monkeypatch.setattr(jpersist, "_CACHE_DIR", str(tmp_path / "jcache"))
    return d


@pytest.fixture
def served(tmp_path):
    """A directory served over HTTP on 127.0.0.1: (dir, base URL, the
    request paths seen)."""
    root = tmp_path / "www"
    root.mkdir()
    seen = []

    class Handler(http.server.SimpleHTTPRequestHandler):
        def do_GET(self):
            seen.append(self.path)
            return super().do_GET()

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(Handler, directory=str(root)))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield root, f"http://127.0.0.1:{srv.server_address[1]}", seen
    finally:
        srv.shutdown()
        srv.server_close()
        t.join()


def _files(root):
    text = _mixed_csv(400).encode()
    (root / "m.csv").write_bytes(text)
    (root / "m.csv.gz").write_bytes(
        tcompress.gzip_compress_members(text, 2048))
    return ["m.csv", "m.csv.gz"]


@pytest.mark.parametrize("name", ["m.csv", "m.csv.gz"])
def test_file_uri_imports_the_local_file(tmp_path, name):
    _files(tmp_path)
    local = th2o.import_file(str(tmp_path / "m.csv"), device="cpu")
    fr = th2o.import_file(f"file://{tmp_path / name}", device="cpu")
    assert_same_frame(fr, local)
    assert_same_frame(fr, jh2o.import_file(f"file://{tmp_path / name}"))
    assert tpersist.localize(f"file://{tmp_path}/x") == f"{tmp_path}/x"
    assert tpersist.localize("rel/x.csv") == "rel/x.csv"


@pytest.mark.parametrize("name", ["m.csv", "m.csv.gz"])
def test_http_url_imports_the_served_file(served, cache, name):
    root, base, seen = served
    _files(root)
    local = th2o.import_file(str(root / "m.csv"), device="cpu")
    url = f"{base}/{name}"
    fr = th2o.import_file(url, device="cpu")
    assert_same_frame(fr, local)
    assert_same_frame(fr, jh2o.import_file(url))
    assert seen.count(f"/{name}") == 2          # the port, then the JAX
    cached = tpersist._cache_path(url)
    assert os.path.exists(cached) and cached.startswith(str(cache))
    assert os.path.basename(cached).endswith(f"_{name}")
    assert_same_frame(th2o.import_file(url, device="cpu"), local)
    assert seen.count(f"/{name}") == 2          # the cached copy
    assert [f for f in os.listdir(cache) if f.endswith(".part")] == []
    # a list of URLs, one of them by file://
    both = th2o.import_file([url, f"file://{root / 'm.csv'}"], device="cpu")
    assert both.nrow == 2 * local.nrow


def test_transient_download_failure_is_retried_and_renamed(served, cache,
                                                           monkeypatch,
                                                           caplog):
    root, base, _seen = served
    _files(root)
    real = tpersist.urllib.request.urlretrieve
    tmps = []

    def flaky(url, tmp):
        tmps.append(tmp)
        if len(tmps) == 1:
            with open(tmp, "wb") as f:
                f.write(b"id,sc")                  # a partial download
            raise ConnectionResetError("connection reset by peer")
        return real(url, tmp)

    monkeypatch.setattr(tpersist.urllib.request, "urlretrieve", flaky)
    url = f"{base}/m.csv"
    with caplog.at_level(logging.WARNING, logger="h2o3_tpu_torch"):
        path = tpersist.localize(url)
    assert len(tmps) == 2 and tmps[0] != tmps[1]
    assert all(t.endswith(".part") and os.path.dirname(t) == str(cache)
               for t in tmps)
    assert not any(os.path.exists(t) for t in tmps)
    assert open(path, "rb").read() == (root / "m.csv").read_bytes()
    assert any("persist.localize: transient failure (ConnectionResetError)"
               in r.message for r in caplog.records)


def test_missing_url_is_not_retried(served, cache, monkeypatch):
    _root, base, seen = served
    with pytest.raises(urllib.error.HTTPError) as e:
        th2o.import_file(f"{base}/absent.csv", device="cpu")
    assert e.value.code == 404
    assert seen == ["/absent.csv"]
    assert not os.path.exists(tpersist._cache_path(f"{base}/absent.csv"))


def test_object_store_uri_reads_through_pyarrow_fs(tmp_path, cache,
                                                   monkeypatch):
    from pyarrow import fs as pafs
    _files(tmp_path)
    asked = []

    def local_fs(uri):
        asked.append(uri)
        return pafs.LocalFileSystem(), str(tmp_path / "m.csv.gz")

    monkeypatch.setattr(tpersist, "_remote_fs", local_fs)
    fr = th2o.import_file("s3://bucket/data/m.csv.gz", device="cpu")
    assert asked == ["s3://bucket/data/m.csv.gz"]
    assert_same_frame(fr, th2o.import_file(str(tmp_path / "m.csv"),
                                           device="cpu"))
    th2o.import_file("s3://bucket/data/m.csv.gz", device="cpu")
    assert len(asked) == 1                     # cached


@pytest.mark.parametrize("uri", ["ftp://host/a.csv", "weird://x"])
def test_unsupported_scheme_raises_as_jax(uri):
    msgs = []
    for localize in (tpersist.localize, jpersist.localize):
        with pytest.raises(ValueError, match="unsupported URI scheme") as e:
            localize(uri)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("uri", ["s3://b/k.csv", "gs://b/k.csv",
                                 "hdfs://nn:9000/k.csv"])
def test_object_store_without_pyarrow_raises_as_jax(monkeypatch, uri):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    msgs = []
    for remote_fs in (tpersist._remote_fs, jpersist._remote_fs):
        with pytest.raises(NotImplementedError, match="backend unavailable"
                           ) as e:
            remote_fs(uri)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------ SQL

def _make_db(path, n=500, null_keys=0):
    con = sqlite3.connect(path)
    cur = con.cursor()
    cur.execute("CREATE TABLE t (id INTEGER, x REAL, label TEXT, k INTEGER)")
    rng = np.random.default_rng(0)
    rows = [(None if i < null_keys else i, float(rng.normal()),
             None if i % 17 == 4 else ("a" if i % 3 else "b"),
             None if i % 11 == 2 else int(rng.integers(-5, 5)))
            for i in range(n)]
    cur.executemany("INSERT INTO t VALUES (?,?,?,?)", rows)
    con.commit()
    con.close()
    return rows


@pytest.mark.parametrize("mode,n,chunks,null_keys", [
    ("key_range", 500, 4, 0), ("key_range", 97, 3, 5),
    ("key_range", 10, 64, 0), ("single_fetch", 97, 3, 0)])
def test_import_sql_table_matches_jax(tmp_path, mode, n, chunks, null_keys):
    db = str(tmp_path / "t.db")
    rows = _make_db(db, n, null_keys)
    key = "id" if mode == "key_range" else None
    fr = th2o.import_sql_table(lambda: sqlite3.connect(db), "t",
                               key_column=key, fetch_chunks=chunks,
                               device="cpu")
    jfr = j_import_sql_table(lambda: sqlite3.connect(db), "t",
                             key_column=key, fetch_chunks=chunks)
    assert_same_frame(fr, jfr)
    assert fr.nrow == len(rows) and fr.key == "t"
    assert fr.names == ["id", "x", "label", "k"]
    assert fr.types == {"id": "real", "x": "real", "label": "enum",
                        "k": "real"}
    order = np.argsort(fr.vec("x").to_numpy(), kind="stable")
    want = np.sort(np.asarray([r[1] for r in rows], np.float32))
    np.testing.assert_array_equal(fr.vec("x").to_numpy()[order], want)
    assert fr.vec("label").na_count() == sum(r[2] is None for r in rows)
    assert fr.vec("id").na_count() == null_keys


def test_import_sql_table_columns_and_empty_table(tmp_path):
    db = str(tmp_path / "t.db")
    _make_db(db, 50)
    fr = th2o.import_sql_table(lambda: sqlite3.connect(db), "t",
                               columns=["x", "id"], key_column="id",
                               device="cpu")
    assert fr.names == ["x", "id"] and fr.nrow == 50
    con = sqlite3.connect(db)
    con.execute("CREATE TABLE e (id INTEGER, x REAL)")
    con.commit()
    con.close()
    fr = th2o.import_sql_table(lambda: sqlite3.connect(db), "e",
                               key_column="id", device="cpu")
    assert fr.nrow == 0 and fr.names == ["id", "x"]


def test_import_sql_table_warns_on_a_row_count_mismatch(tmp_path, caplog):
    db = str(tmp_path / "t.db")
    _make_db(db, 40)
    calls = []

    def factory():
        con = sqlite3.connect(db)
        calls.append(con)
        if len(calls) == 2:       # the first fetch: a row appears
            con.execute("INSERT INTO t VALUES (1000, 0.5, 'a', 1)")
            con.commit()
        return con

    with caplog.at_level(logging.WARNING, logger="h2o3_tpu_torch"):
        fr = th2o.import_sql_table(factory, "t", device="cpu")
    assert fr.nrow == 41
    assert any("fetched 41 rows but COUNT(*)=40" in r.getMessage()
               and r.name == "h2o3_tpu_torch" for r in caplog.records)
