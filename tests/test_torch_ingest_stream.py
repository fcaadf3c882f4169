"""Streamed ingest (``H2O3_INGEST_STREAM``) of the port: a streamed parse
gives the unstreamed parse's frame and the JAX package's streamed parse's
frame bit for bit, for numeric, time and enum columns across ranges
whose chunk-local domains and NA codes differ, for the columns that take
the host merge (an enum cardinality blow-out, wide ints) and for a range
the Python tokenizer reads again, which joins the stream late. On the
CPU the streamer assembles on the host; ``tests/test_torch_ingest_cuda.py``
runs the card's copies."""
import importlib

import numpy as np
import pytest
import torch

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu.ingest import chunk as jchunk
from h2o3_tpu.ingest import stream as jstream
from h2o3_tpu_torch.ingest import chunk as tchunk
from h2o3_tpu_torch.ingest import stream as tstream
from test_torch_ingest import WIDE, _mixed_csv, assert_same_frame
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

jparse = importlib.import_module("h2o3_tpu.ingest.parse")
tparse = importlib.import_module("h2o3_tpu_torch.ingest.parse")


def _region_enum_csv(nrow=6000):
    """An enum column whose labels depend on the row's region (each third
    sees another pair, and some cells are NA), so that ranges encode
    different chunk-local code spaces; a numeric and a time column beside
    it."""
    rng = np.random.default_rng(11)
    regions = [("ames", "berlin"), ("cairo", "delhi"), ("essen", "fargo")]
    lines = ["id,e,x,t"]
    for i in range(nrow):
        pair = regions[min(i * len(regions) // nrow, len(regions) - 1)]
        e = "" if i % 97 == 13 else pair[int(rng.integers(0, 2))]
        t = "" if i % 89 == 3 else f"2020-{1 + i % 12:02d}-{1 + i % 28:02d}"
        lines.append(f"{i},{e},{rng.normal():.5f},{t}")
    return "\n".join(lines) + "\n"


def _blowout_csv():
    return "id,e\n" + "".join(f"{i},lab{i % 600:04d}\n"
                              for i in range(4000))


def _wide_csv():
    rows = [f"{WIDE + 2 * i},{i % 5},{(1 << 25) + i}" for i in range(400)]
    return "k,s,big\n" + "\n".join(rows) + "\n"


def _poisoned_csv():
    lines = [f"{i},{i * 0.5},c{i % 9}" for i in range(1, 800)]
    lines[400] = "9,1,overflow,extra"                # ragged: declined
    return "a,b,c\n" + "\n".join(lines) + "\n"


# case -> (text, MAX_ENUM_CARDINALITY or None, columns the host merge
# must take)
CASES = {
    "region_enum": (_region_enum_csv(), None, []),
    "mixed": (_mixed_csv(600), None, []),
    "cardinality_blowout": (_blowout_csv(), 128, ["e"]),
    "wide_int": (_wide_csv(), None, ["k"]),
    "late_python_range": (_poisoned_csv(), None, []),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_parse_matches_unstreamed_and_jax(tmp_path, monkeypatch,
                                                   case):
    text, card, fallback = CASES[case]
    p = tmp_path / f"{case}.csv"
    p.write_text(text)
    monkeypatch.setenv("H2O3_INGEST_WORKERS", "8")
    if card is not None:
        monkeypatch.setattr(jchunk, "MAX_ENUM_CARDINALITY", card)
        monkeypatch.setattr(tchunk, "MAX_ENUM_CARDINALITY", card)
    monkeypatch.setattr(jparse, "_PARALLEL_PARSE_BYTES", 1 << 12)
    monkeypatch.setattr(tparse, "_PARALLEL_PARSE_BYTES", 1 << 12)
    monkeypatch.setenv("H2O3_INGEST_STREAM", "0")
    plain = th2o.import_file(str(p), device="cpu")
    assert not tparse.LAST_PROFILE["streamed"]
    monkeypatch.setenv("H2O3_INGEST_STREAM", "1")
    jfr = jh2o.import_file(str(p))
    assert jparse.LAST_PROFILE["streamed"]
    fr = th2o.import_file(str(p), device="cpu")
    prof = dict(tparse.LAST_PROFILE)
    assert prof["streamed"] and prof["chunks"] > 1
    assert prof["fallback_cols"] == fallback
    assert prof["h2d_bytes"] == 0 and prof["ring_allocs"] == 0
    assert prof["add_seconds"] > 0 and prof["assemble_seconds"] > 0
    assert 0 < prof["h2d_overlap_ratio"] < 1
    assert_same_frame(fr, plain)
    assert_same_frame(fr, jfr)
    if case == "late_python_range":
        assert prof["fallback_reasons"] == {"ragged_rows": 1}
        assert prof["native_ranges"] == prof["chunks"] - 1
    if case == "region_enum":
        assert fr.vec("e").domain == ("ames", "berlin", "cairo", "delhi",
                                      "essen", "fargo")


@pytest.mark.parametrize("env,device,streams", [
    ("auto", "cpu", False), ("0", "cpu", False), ("false", "cpu", False),
    ("1", "cpu", True), ("auto", "cuda", True), ("0", "cuda", False)])
def test_stream_switch(monkeypatch, env, device, streams):
    monkeypatch.setenv("H2O3_INGEST_STREAM", env)
    assert tparse._stream_on(torch.device(device)) is streams


def test_single_range_and_string_columns_do_not_stream(tmp_path,
                                                       monkeypatch):
    p = tmp_path / "m.csv"
    p.write_text(_mixed_csv(300))
    monkeypatch.setenv("H2O3_INGEST_STREAM", "1")
    th2o.import_file(str(p), device="cpu")
    assert not tparse.LAST_PROFILE["streamed"]     # one range
    monkeypatch.setattr(tparse, "_PARALLEL_PARSE_BYTES", 1)
    fr = th2o.import_file(str(p), device="cpu", col_types=[
        None, None, "string"])
    assert tparse.LAST_PROFILE["streamed"]
    assert fr.vec("city").type == "string"
    assert list(fr.vec("city").host_data[:3]) == list(
        jh2o.import_file(str(p), col_types=[None, None, "string"]).vec(
            "city").host_data[:3])


def test_late_quote_recut_discards_the_stream(tmp_path, monkeypatch):
    """A range declined for a quote past the probe window has its file
    cut again; the first round's stream is discarded and the second
    streams every range."""
    discards = []

    class Recorder(tstream.ChunkDeviceStreamer):
        def discard(self):
            discards.append(len(self._chunks))
            super().discard()

    monkeypatch.setattr(tparse, "ChunkDeviceStreamer", Recorder)
    monkeypatch.setattr(tparse, "_QUOTE_PROBE_BYTES", 256)
    monkeypatch.setattr(tparse, "_PARALLEL_PARSE_BYTES", 1)
    monkeypatch.setenv("H2O3_INGEST_STREAM", "1")
    lines = ["g,x"] + [f"plain{i % 7},{i}" for i in range(60)]
    lines.append('"multi\nline\nfield",999')
    lines += [f"tail{i % 5},{i}" for i in range(40)]
    p = tmp_path / "latequote.csv"
    p.write_text("\n".join(lines) + "\n")
    fr = th2o.import_file(str(p), device="cpu")
    prof = dict(tparse.LAST_PROFILE)
    assert len(discards) == 1 and discards[0] > 0
    assert prof["streamed"] and prof["native"] and prof["chunks"] > 1
    assert "multi\nline\nfield" in fr.vec("g").domain
    monkeypatch.setattr(tparse, "_PARALLEL_PARSE_BYTES", 1 << 30)
    monkeypatch.setenv("H2O3_INGEST_STREAM", "0")
    assert_same_frame(fr, th2o.import_file(str(p), device="cpu"))


@pytest.mark.parametrize("doms", [
    [["a", "b"], ["a", "b"]],
    [["b", "c"], ["a"], [], ["a", "c", "d"]]])
def test_enum_remap_table_matches_jax_and_masks_na(doms):
    union = sorted(set().union(*doms))
    t_lut, t_base = tstream.ChunkDeviceStreamer._enum_remap_aux(union, doms)
    j_lut, j_base = jstream.ChunkDeviceStreamer._enum_remap_aux(
        None, union, doms)
    if j_lut is None:
        assert t_lut is None and t_base is None
        return
    np.testing.assert_array_equal(t_lut, j_lut)
    np.testing.assert_array_equal(t_base, j_base)
    # every NA code (-1) reads its section's slot 0
    assert (t_lut[t_base] == -1).all()


def test_prepack_matches_jax():
    rng = np.random.default_rng(3)
    n = 50
    cols = [
        tchunk.EncodedColumn("real", rng.normal(size=n)),
        tchunk.EncodedColumn("int", np.arange(n, dtype=np.float64)
                             + (1 << 26), fmax=float((1 << 26) + n - 1)),
        tchunk.EncodedColumn("time", np.where(
            np.arange(n) % 7 == 0, np.iinfo(np.int64).min,
            np.arange(n) * 86_400_000)),
        tchunk.EncodedColumn("enum", np.where(np.arange(n) % 5 == 0, -1,
                                              np.arange(n) % 3).astype(
                                                  np.int32),
                             domain=["x", "y", "z"]),
        tchunk.EncodedColumn("string", np.array(["s"] * n, dtype=object))]
    jcols = [jchunk.EncodedColumn(c.vtype, c.data, domain=c.domain,
                                  fmax=c.fmax) for c in cols]
    ids = [0, 1, 2, 3, 4]
    t = tstream.prepack_chunk(ids, cols)
    j = jstream.prepack_chunk(ids, jcols)
    np.testing.assert_array_equal(t.mat.view(np.int32), j.mat.view(np.int32))
    np.testing.assert_array_equal(t.fmax, j.fmax)


def test_assemble_after_discard_raises():
    s = tstream.ChunkDeviceStreamer([0], ["real"], torch.device("cpu"))
    s.add(0, [tchunk.EncodedColumn("real", np.ones(3))])
    s.discard()
    s.add(1, [tchunk.EncodedColumn("real", np.ones(3))])   # ignored
    with pytest.raises(RuntimeError, match="after discard"):
        s.assemble()
