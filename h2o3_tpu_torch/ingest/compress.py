"""Compressed CSV inputs (gzip, zstd) inflated to one host buffer.

Counterpart of ``h2o3_tpu/ingest/compress.py``. The parse works on byte
ranges of one host buffer, so this module hands ``ingest/parse.py`` the
decompressed bytes and gets out of the way: the range planner, the quote
discovery, the native tokenizer and the range-scoped fallback run on the
result unchanged.

Member-parallel where the format allows it:

- **gzip**: a multi-member file (bgzip, pigz output concatenated,
  ``gzip_compress_members``) is a row of independent deflate streams.
  Member offsets come from a validated magic scan and each worker
  inflates its own slice (zlib frees the GIL and checks each member's
  CRC32, so a magic hit inside compressed data fails to decode instead
  of corrupting: the file then inflates serially, and says why). A
  single-member file has nothing to split: one serial inflate, reason
  ``gzip_single_stream``.
- **zstd**: the frame headers carry exact sizes, so the members come
  from a header walk. Frames decode in parallel. Store-mode frames (raw
  and RLE blocks, what ``zstd_compress_store`` writes) decode without
  any module; entropy-coded frames need the optional ``zstandard``
  module and raise without it.

Reads go through ``resilience.retry_transient``, so a transient storage
error is retried. The JAX module's fault-injection site waits for
ROADMAP.md queue 1, item 19.
"""
from __future__ import annotations

import time
import zlib
from typing import List, Optional, Tuple

GZIP_MAGIC = b"\x1f\x8b"
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"          # LE 0xFD2FB528
_ZSTD_MAGIC_LE = 0xFD2FB528
_ZSTD_SKIP_LO, _ZSTD_SKIP_HI = 0x184D2A50, 0x184D2A5F


def detect_bytes(head: bytes) -> Optional[str]:
    """Compression format from magic bytes (extension-blind, like the
    reference's ZipUtil sniff) — ``"gzip"``, ``"zstd"`` or None."""
    if head[:2] == GZIP_MAGIC:
        return "gzip"
    if head[:4] == ZSTD_MAGIC:
        return "zstd"
    if len(head) >= 8:
        magic = int.from_bytes(head[:4], "little")
        if _ZSTD_SKIP_LO <= magic <= _ZSTD_SKIP_HI:
            return "zstd"                 # leading skippable frame
    return None


def detect(path: str) -> Optional[str]:
    try:
        with open(path, "rb") as f:
            return detect_bytes(f.read(8))
    except OSError:
        return None


# ------------------------------------------------------------------ gzip

_GZ_XFL_OK = (0, 2, 4)                    # values real writers emit


def _gzip_member_offsets(raw: bytes) -> List[int]:
    """Candidate member start offsets: validated magic hits. Validation
    (CM=deflate, reserved FLG bits zero, plausible XFL) prunes most
    magic bytes that occur INSIDE compressed data; survivors that are
    still false positives fail their CRC during the parallel decode and
    the caller falls back to the serial whole-stream path."""
    offs, i, n = [0], 0, len(raw)
    while True:
        i = raw.find(GZIP_MAGIC, i + 1)
        if i < 0 or i + 10 > n:
            return offs
        if (raw[i + 2] == 8 and raw[i + 3] & 0xE0 == 0
                and raw[i + 8] in _GZ_XFL_OK):
            offs.append(i)


def _gzip_inflate_slice(raw: bytes, start: int, end: int) -> bytes:
    """Inflate the complete gzip member(s) in ``raw[start:end)``. Raises
    ``zlib.error`` when the slice does not hold whole members (a
    mis-detected boundary) — the poison-safety contract."""
    out, pos = [], start
    while pos < end:
        d = zlib.decompressobj(31)        # gzip wrapper, CRC verified
        chunk = d.decompress(raw[pos:end])
        chunk += d.flush()
        if not d.eof:
            raise zlib.error("member extends past the slice boundary")
        out.append(chunk)
        pos = end - len(d.unused_data)
        if d.unused_data and not d.unused_data.startswith(GZIP_MAGIC):
            raise zlib.error("trailing garbage after gzip member")
    return b"".join(out)


def _gzip_decompress(raw: bytes, workers: int) -> Tuple[bytes, dict]:
    offs = _gzip_member_offsets(raw)
    info = {"format": "gzip", "members": len(offs), "parallel": False,
            "reason": None}
    if len(offs) > 1:
        import concurrent.futures as cf
        edges = offs + [len(raw)]
        slices = list(zip(edges[:-1], edges[1:]))
        try:
            with cf.ThreadPoolExecutor(
                    max_workers=min(len(slices), max(workers, 1))) as ex:
                parts = list(ex.map(
                    lambda se: _gzip_inflate_slice(raw, se[0], se[1]),
                    slices))
            info["parallel"] = True
            return b"".join(parts), info
        except zlib.error:
            # a magic hit inside compressed data mis-split a member —
            # every CRC seam catches it; degrade to the serial path
            info["members"] = 1
            info["reason"] = "gzip_member_misdetect"
    elif info["reason"] is None:
        info["reason"] = "gzip_single_stream"
    return _gzip_inflate_slice(raw, 0, len(raw)), info


# ------------------------------------------------------------------ zstd

def _zstd_walk_frame(raw: bytes, off: int):
    """Walk ONE frame starting at ``off`` using only header-carried
    sizes. Returns ``(end_off, blocks, skippable)`` where ``blocks`` is
    ``[(kind, payload_off, size), ...]`` (kind: 0 raw / 1 RLE /
    2 entropy-coded). Raises ValueError on malformed headers."""
    n = len(raw)
    if off + 4 > n:
        raise ValueError("truncated zstd magic")
    magic = int.from_bytes(raw[off:off + 4], "little")
    if _ZSTD_SKIP_LO <= magic <= _ZSTD_SKIP_HI:
        if off + 8 > n:
            raise ValueError("truncated skippable frame")
        size = int.from_bytes(raw[off + 4:off + 8], "little")
        return off + 8 + size, [], True
    if magic != _ZSTD_MAGIC_LE:
        raise ValueError(f"bad zstd magic at {off}")
    fhd = raw[off + 4]
    if fhd & 0x08:
        raise ValueError("reserved FHD bit set")
    single = (fhd >> 5) & 1
    pos = off + 5 + (0 if single else 1)                 # window byte
    pos += (0, 1, 2, 4)[fhd & 3]                         # dictionary id
    pos += ((1 if single else 0), 2, 4, 8)[fhd >> 6]     # content size
    blocks = []
    while True:
        if pos + 3 > n:
            raise ValueError("truncated block header")
        bh = int.from_bytes(raw[pos:pos + 3], "little")
        pos += 3
        last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        if btype == 3:
            raise ValueError("reserved block type")
        blocks.append((btype, pos, bsize))
        pos += 1 if btype == 1 else bsize
        if last:
            break
    if (fhd >> 2) & 1:
        pos += 4                                         # xxh64 checksum
    if pos > n:
        raise ValueError("frame overruns the buffer")
    return pos, blocks, False


def _zstd_decode_frame(raw: bytes, off: int, end: int, blocks) -> bytes:
    """Decode one walked frame: raw/RLE blocks in pure Python;
    entropy-coded blocks through the optional ``zstandard`` module."""
    if any(k == 2 for k, _, _ in blocks):
        try:
            import zstandard
        except ImportError:
            raise RuntimeError(
                "entropy-coded zstd frame needs the optional 'zstandard' "
                "module (only store-mode raw/RLE frames decode without "
                "it); re-compress with zstd_compress_store or install "
                "zstandard") from None
        return zstandard.ZstdDecompressor().decompress(
            raw[off:end], max_output_size=1 << 31)
    out = []
    for kind, p, size in blocks:
        if kind == 0:
            out.append(raw[p:p + size])
        else:                             # RLE: one byte, repeated
            out.append(raw[p:p + 1] * size)
    return b"".join(out)


def _zstd_decompress(raw: bytes, workers: int) -> Tuple[bytes, dict]:
    frames, off = [], 0
    while off < len(raw):
        end, blocks, skippable = _zstd_walk_frame(raw, off)
        if not skippable:
            frames.append((off, end, blocks))
        off = end
    info = {"format": "zstd", "members": len(frames),
            "parallel": len(frames) > 1,
            "reason": "zstd_single_frame" if len(frames) <= 1 else None}
    if len(frames) > 1 and workers > 1:
        import concurrent.futures as cf
        with cf.ThreadPoolExecutor(
                max_workers=min(len(frames), workers)) as ex:
            parts = list(ex.map(
                lambda f: _zstd_decode_frame(raw, f[0], f[1], f[2]),
                frames))
    else:
        parts = [_zstd_decode_frame(raw, o, e, b) for o, e, b in frames]
    return b"".join(parts), info


# ------------------------------------------------------------ front door

def decompress_bytes(raw: bytes, workers: int = 1) -> Tuple[bytes, dict]:
    kind = detect_bytes(raw[:8])
    if kind == "gzip":
        return _gzip_decompress(raw, workers)
    if kind == "zstd":
        return _zstd_decompress(raw, workers)
    raise ValueError("buffer is not gzip or zstd compressed")


def decompress_path(path: str, workers: int = 1) -> Tuple[bytes, dict]:
    """Read and inflate a whole compressed file into one contiguous
    buffer (the range planner then cuts it). A transient read error is
    retried (``resilience.retry_transient``). The info dict says the
    format, the member count, whether the inflate ran member-parallel,
    the degrade reason where it did not, the ratio, the path and the
    inflate's seconds."""
    from h2o3_tpu_torch import resilience

    def _read_and_inflate() -> Tuple[bytes, dict]:
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            raw = f.read()
        data, info = decompress_bytes(raw, workers)
        info["ratio"] = round(len(data) / max(len(raw), 1), 2)
        info["compressed_bytes"] = len(raw)
        info["inflate_s"] = time.perf_counter() - t0
        return data, info

    data, info = resilience.retry_transient(
        _read_and_inflate, site="ingest.decompress",
        classify=resilience.is_transient_io)
    info["path"] = path
    return data, info


def head_bytes(path: str, nbytes: int) -> bytes:
    """First ``nbytes`` of the DECOMPRESSED stream (parse_setup's
    sampling head). gzip streams incrementally; zstd decodes leading
    frames until enough bytes accumulate."""
    kind = detect(path)
    if kind == "gzip":
        import gzip
        with gzip.open(path, "rb") as f:
            return f.read(nbytes)
    with open(path, "rb") as f:
        raw = f.read()
    out, off = b"", 0
    while off < len(raw) and len(out) < nbytes:
        end, blocks, skippable = _zstd_walk_frame(raw, off)
        if not skippable:
            out += _zstd_decode_frame(raw, off, end, blocks)
        off = end
    return out[:nbytes]


# --------------------------------------------- writers (tests / bench)

def gzip_compress_members(data: bytes, member_bytes: int = 1 << 20,
                          workers: int = 1) -> bytes:
    """Multi-member gzip (the pigz/bgzip concatenation shape): each
    ``member_bytes`` slice becomes an independent member, so ingest can
    inflate members in parallel. ``mtime=0`` keeps output deterministic;
    ``workers`` threads compress the members (zlib frees the GIL), with
    the same bytes as one."""
    import gzip
    if not data:
        return gzip.compress(data, 6, mtime=0)
    starts = range(0, len(data), member_bytes)

    def one(s):
        return gzip.compress(data[s:s + member_bytes], 6, mtime=0)

    if workers <= 1:
        return b"".join(map(one, starts))
    import concurrent.futures as cf
    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        return b"".join(ex.map(one, starts))


def zstd_compress_store(data: bytes, frame_bytes: int = 1 << 20) -> bytes:
    """Store-mode zstd writer: single-segment frames of raw blocks (no
    entropy coding, so `_zstd_decode_frame` round-trips it without the
    ``zstandard`` module). FHD 0xA0 = 4-byte content size +
    single-segment; raw block headers are ``size<<3 | type<<1 | last``."""
    frames = []
    for s in range(0, max(len(data), 1), frame_bytes):
        seg = data[s:s + frame_bytes]
        hdr = ZSTD_MAGIC + bytes([0xA0]) + len(seg).to_bytes(4, "little")
        blocks = []
        blk = 1 << 16                     # <= the 128 KiB block ceiling
        if not seg:
            blocks.append((1).to_bytes(3, "little"))      # empty last raw
        for b in range(0, len(seg), blk):
            piece = seg[b:b + blk]
            last = 1 if b + blk >= len(seg) else 0
            blocks.append(((len(piece) << 3) | last).to_bytes(3, "little")
                          + piece)
        frames.append(hdr + b"".join(blocks))
    return b"".join(frames)
