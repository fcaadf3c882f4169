"""``import_file`` onto the card gives the frame it gives on the CPU: the
same types, domains, device values bit for bit and host copies, streamed
(the default on the card: per-range copies from a ring of pinned
buffers) or not, from a CSV or a 1 MiB-member gzip. Needs a CUDA device
(marked ``gpu``); imports nothing of JAX, so that it runs where JAX is
absent."""
import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th2o
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

CSV = ('id,score,city,seen,note,big\n'
       '1,0.5,ames,2021-01-02,"a ""b""",16777217\n'
       'NA,NaN,"delhi,town",,n2,16777219\n'
       '3,-1.25,berlin,2021-03-04,NA,3\n')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest -m gpu tests/test_torch_ingest_cuda.py)")
    return torch.device("cuda")


def _bits(a):
    return a.view({4: np.int32, 8: np.int64}[a.itemsize])


@pytest.mark.gpu
def test_cuda_frame_equals_the_cpu_frame(cuda, tmp_path):
    p = tmp_path / "mixed.csv"
    p.write_text(CSV)
    on_card = th2o.import_file(str(p), device=cuda)
    on_cpu = th2o.import_file(str(p), device="cpu")
    assert on_card.device.type == "cuda"
    assert on_card.types == on_cpu.types
    assert on_cpu.vec("big").host_data is not None
    for n in on_cpu.names:
        a, b = on_card.vec(n), on_cpu.vec(n)
        assert a.domain == b.domain
        if b.data is None:
            assert list(a.host_data) == list(b.host_data)
            continue
        assert a.data.device.type == "cuda"
        np.testing.assert_array_equal(_bits(a.data.cpu().numpy()),
                                      _bits(b.data.numpy()))
        if b.host_data is None:
            assert a.host_data is None
        else:
            np.testing.assert_array_equal(_bits(a.host_data),
                                          _bits(b.host_data))


def _assert_same(on_card, on_cpu):
    assert on_card.names == on_cpu.names and on_card.types == on_cpu.types
    for n in on_cpu.names:
        a, b = on_card.vec(n), on_cpu.vec(n)
        assert a.domain == b.domain, n
        if b.data is None:
            assert list(a.host_data) == list(b.host_data), n
            continue
        assert a.data.device.type == "cuda", n
        np.testing.assert_array_equal(_bits(a.data.cpu().numpy()),
                                      _bits(b.data.numpy()), err_msg=n)
        assert (a.host_data is None) == (b.host_data is None), n
        if b.host_data is not None:
            np.testing.assert_array_equal(_bits(a.host_data),
                                          _bits(b.host_data), err_msg=n)


def _streamed_csv(nrow=60_000):
    """Numeric, wide-int, big-integral, time and enum columns whose
    chunk-local domains differ by region, with NA cells in each."""
    rng = np.random.default_rng(5)
    regions = [("ames", "berlin"), ("cairo", "delhi"), ("essen", "fargo")]
    lines = ["id,e,x,t,big,wide,s"]
    for i in range(nrow):
        pair = regions[min(i * 3 // nrow, 2)]
        e = "" if i % 97 == 13 else pair[int(rng.integers(0, 2))]
        t = "" if i % 89 == 3 else f"2020-{1 + i % 12:02d}-{1 + i % 28:02d}"
        x = "NA" if i % 71 == 5 else f"{rng.normal():.6f}"
        lines.append(f"{i},{e},{x},{t},{(1 << 25) + i},{(1 << 53) + i},"
                     f"s{i % 7}")
    return "\n".join(lines) + "\n"


@pytest.mark.gpu
@pytest.mark.parametrize("ranges", [8, 40])
def test_streamed_cuda_import_equals_cpu_import(cuda, tmp_path, monkeypatch,
                                                ranges):
    """Streamed onto the card (the default there) against the CPU's
    unstreamed parse: every column bit for bit. At 40 ranges the parse
    has more ranges than the staging ring has slots, so each slot is
    reused, after its copy's event."""
    from h2o3_tpu_torch.ingest import parse, stream
    p = tmp_path / "s.csv"
    p.write_text(_streamed_csv())
    monkeypatch.setattr(parse, "_PARALLEL_PARSE_BYTES", 1)
    monkeypatch.setenv("H2O3_INGEST_WORKERS", str(ranges))
    monkeypatch.setenv("H2O3_INGEST_STREAM", "0")
    on_cpu = th2o.import_file(str(p), device="cpu")
    monkeypatch.setenv("H2O3_INGEST_STREAM", "auto")
    on_card = th2o.import_file(str(p), device=cuda)
    prof = dict(parse.LAST_PROFILE)
    assert prof["streamed"] and prof["chunks"] == ranges
    assert prof["fallback_cols"] == ["wide"]
    assert prof["h2d_bytes"] > 0 and prof["add_seconds"] > 0
    assert 1 <= prof["ring_allocs"] <= 2 * stream.RING_SLOTS
    _assert_same(on_card, on_cpu)
    monkeypatch.setenv("H2O3_INGEST_STREAM", "0")
    _assert_same(th2o.import_file(str(p), device=cuda), on_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("stream", ["0", "1"])
def test_string_and_host_merged_columns_on_the_card(cuda, tmp_path,
                                                    monkeypatch, stream):
    """A string column (host only) beside streamed and host-merged
    columns: one frame on the card, equal to the CPU's."""
    from h2o3_tpu_torch.ingest import parse
    p = tmp_path / "s.csv"
    p.write_text(_streamed_csv(20_000))
    monkeypatch.setattr(parse, "_PARALLEL_PARSE_BYTES", 1)
    monkeypatch.setenv("H2O3_INGEST_STREAM", stream)
    types = [None] * 6 + ["string"]
    on_card = th2o.import_file(str(p), device=cuda, col_types=types)
    assert on_card.types["s"] == "string"
    assert on_card.device == on_card.vec("x").data.device
    _assert_same(on_card, th2o.import_file(str(p), device="cpu",
                                           col_types=types))


@pytest.mark.gpu
def test_ring_slot_is_refilled_only_after_its_copy(cuda, monkeypatch):
    """Many chunks through a one-slot ring: each chunk's copy lands
    intact although the next chunk overwrites the same pinned buffer."""
    from h2o3_tpu_torch.ingest import chunk, stream
    monkeypatch.setattr(stream, "RING_SLOTS", 1)
    s = stream.ChunkDeviceStreamer([0], ["real"], cuda)
    parts = [np.arange(k * 100_000, (k + 1) * 100_000, dtype=np.float64)
             for k in range(12)]
    for k in (3, 0, 11, 1, 2, 4, 5, 6, 7, 8, 9, 10):
        s.add(k, [chunk.EncodedColumn("real", parts[k])])
    v = s.assemble()[0]
    assert s.ring_allocs == 1
    np.testing.assert_array_equal(v.data.cpu().numpy(),
                                  np.concatenate(parts).astype(np.float32))


@pytest.mark.gpu
def test_one_mib_member_gzip_equals_its_csv(cuda, tmp_path):
    from h2o3_tpu_torch.ingest import compress, parse
    text = _streamed_csv(200_000).encode()
    p = tmp_path / "s.csv"
    p.write_bytes(text)
    gz = tmp_path / "s.csv.gz"
    gz.write_bytes(compress.gzip_compress_members(text, 1 << 20, workers=4))
    from_csv = th2o.import_file(str(p), device=cuda)
    from_gz = th2o.import_file(str(gz), device=cuda)
    (info,) = parse.LAST_PROFILE["compressed"]
    assert info["parallel"] and info["members"] == -(-len(text) // (1 << 20))
    _assert_same(from_gz, th2o.import_file(str(p), device="cpu"))
    _assert_same(from_csv, th2o.import_file(str(gz), device="cpu"))
