"""Inputs by URI: a local copy of a remote object.

Counterpart of ``h2o3_tpu/ingest/persist_uri.py`` (H2O's
``PersistManager``, which routes file, S3, GCS, HDFS and HTTP by
scheme). ``import_file`` sends every path through ``localize``: a
``file://`` URI or a plain path is the file itself; an ``http(s)://``
object is downloaded with the standard library, and an ``s3://``,
``gs://`` or ``hdfs://`` one through ``pyarrow.fs``, into a cache file
named by a hash of the URI; the parsers then read the local copy. A
download goes to a process-unique temporary file and is renamed into
place, so a partial download never lands at the cache path, and a
transient failure is retried (``resilience.retry_transient``). The JAX
module's fault-injection site waits for ROADMAP.md queue 1, item 19.
"""
from __future__ import annotations

import hashlib
import os
import tempfile
import urllib.parse
import urllib.request

from h2o3_tpu_torch.resilience import is_transient_io, retry_transient

_CACHE_DIR = os.path.join(tempfile.gettempdir(), "h2o3_tpu_torch_persist")


def _cache_path(uri: str) -> str:
    os.makedirs(_CACHE_DIR, exist_ok=True)
    h = hashlib.sha1(uri.encode()).hexdigest()[:16]
    base = os.path.basename(urllib.parse.urlparse(uri).path) or "object"
    return os.path.join(_CACHE_DIR, f"{h}_{base}")


def _fill_cache(out: str, download_to) -> None:
    """``download_to(tmp)`` into a process-unique temporary file, then an
    atomic rename to ``out``; each attempt (a transient failure is
    retried) starts from its own temporary file, which never survives."""
    def attempt():
        fd, tmp = tempfile.mkstemp(dir=_CACHE_DIR, suffix=".part")
        os.close(fd)
        try:
            download_to(tmp)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    retry_transient(attempt, site="persist.localize",
                    classify=is_transient_io, base_delay_s=0.2)


def _remote_fs(uri: str):
    """(filesystem, path) of an object-store URI through ``pyarrow.fs``;
    ``NotImplementedError`` where pyarrow or the backend is absent.
    ``H2O3_PERSIST_ANONYMOUS=1`` asks for unsigned access."""
    p = urllib.parse.urlparse(uri)
    scheme = p.scheme.lower()
    anon = os.environ.get("H2O3_PERSIST_ANONYMOUS", "") == "1"
    try:
        from pyarrow import fs as pafs
        if scheme == "s3":
            # an explicit region: construction does no network lookup
            return (pafs.S3FileSystem(
                region=os.environ.get("AWS_DEFAULT_REGION", "us-east-1"),
                anonymous=anon),
                p.netloc + p.path)
        if scheme in ("gs", "gcs"):
            return (pafs.GcsFileSystem(anonymous=anon),
                    p.netloc + p.path)
        if scheme == "hdfs":
            return (pafs.HadoopFileSystem(
                p.hostname or "default", p.port or 8020),
                p.path)
    except (OSError, ImportError) as e:
        raise NotImplementedError(
            f"{scheme}:// backend unavailable in this environment "
            f"(pyarrow.fs: {e})") from e
    raise ValueError(f"no remote filesystem for scheme '{scheme}'")


def localize(uri: str) -> str:
    """A local path for ``uri``, downloading it first where it is
    remote (once: the cache file is reused)."""
    scheme = urllib.parse.urlparse(uri).scheme.lower()
    if scheme in ("", "file"):
        return uri[len("file://"):] if uri.startswith("file://") else uri
    if scheme in ("http", "https"):
        out = _cache_path(uri)
        if not os.path.exists(out):
            _fill_cache(out, lambda tmp: urllib.request.urlretrieve(
                uri, tmp))
        return out
    if scheme in ("s3", "gs", "gcs", "hdfs"):
        out = _cache_path(uri)
        if not os.path.exists(out):
            f, path = _remote_fs(uri)

            def download(tmp, _f=f, _path=path):
                with _f.open_input_stream(_path) as src, \
                        open(tmp, "wb") as dst:
                    while True:
                        block = src.read(8 << 20)
                        if not block:
                            break
                        dst.write(block)
            _fill_cache(out, download)
        return out
    raise ValueError(f"unsupported URI scheme '{scheme}' in {uri}")
