"""The port's Frame and Vec against the JAX package's on the same file:
rollups and percentiles, ``split_frame(ratios, seed)`` assigning the same
rows, ``rows``, ``head`` and the column operations, ``vecs``,
``rename``, ``to_dict`` and ``summary``; string columns reach the model
builders' matrix as NaN."""
import numpy as np
import pytest

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu_torch.frame.vec import Vec
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)


def _csv(tmp_path, nrow=300):
    """real with NaN and ±inf, int, enum with NA, time with NA, a string
    column (forced), an integral column past 2^24 (a host copy)."""
    rng = np.random.default_rng(11)
    lines = ["x,k,g,t,s,big"]
    for i in range(nrow):
        x = ("NA" if i % 13 == 2 else "inf" if i == 5 else "-inf" if i == 9
             else f"{rng.normal() * 3:.5f}")
        k = str(int(rng.integers(-50, 50)))
        g = "NA" if i % 29 == 4 else f"lvl{int(rng.integers(0, 6))}"
        t = "" if i % 31 == 1 else f"2020-{1 + i % 12:02d}-{1 + i % 27:02d}"
        s = f"id{i}"
        big = str(16_777_217 + 2 * int(rng.integers(0, 1000)))
        lines.append(",".join([x, k, g, t, s, big]))
    p = tmp_path / "frame.csv"
    p.write_text("\n".join(lines) + "\n")
    kw = dict(col_types=[None, None, None, None, "string", None])
    return (th2o.import_file(str(p), device="cpu", **kw),
            jh2o.import_file(str(p), **kw))


@pytest.fixture
def frames(tmp_path):
    return _csv(tmp_path)


def _bits(a):
    return a.view({4: np.int32, 8: np.int64}[a.itemsize])


def _same_columns(t, j):
    assert t.names == j.names and t.nrow == j.nrow
    assert t.types == j.types
    for n in j.names:
        tv, jv = t.vec(n), j.vec(n)
        assert tv.domain == jv.domain, n
        if jv.type == "string":
            assert list(tv.to_numpy()) == list(jv.to_numpy()), n
            continue
        np.testing.assert_array_equal(_bits(tv.data.numpy()),
                                      _bits(np.asarray(jv.data)[:j.nrow]),
                                      err_msg=n)
        tn, jn = tv.to_numpy(), jv.to_numpy()
        assert tn.dtype == jn.dtype, n
        np.testing.assert_array_equal(_bits(tn), _bits(jn), err_msg=n)


EXACT = ("rows", "na_count", "nz_count", "pinfs", "ninfs", "is_const")


@pytest.mark.parametrize("col", ["x", "k", "g", "t", "s", "big"])
def test_rollups_match_jax(frames, col):
    t, j = frames
    rt, rj = t.vec(col).rollups(), j.vec(col).rollups()
    assert set(rt) == set(rj)
    for key in EXACT + (("cardinality",) if "cardinality" in rj else ()):
        assert rt[key] == rj[key], key
    # min/max pick one value; the float32 sums behind mean and sigma add in
    # another order than XLA's (1e-5: "big" sums 300 values near 2^24,
    # where a float32 sum's last bit is worth 512)
    for key in ("min", "max"):
        np.testing.assert_array_equal(rt[key], rj[key])
    for key in ("mean", "sigma"):
        np.testing.assert_allclose(rt[key], rj[key], rtol=1e-5, atol=0)
    assert t.vec(col).na_count() == rj["na_count"]


@pytest.mark.parametrize("col", ["x", "k", "g", "t", "big"])
def test_percentiles_match_jax(frames, col):
    t, j = frames
    pt, pj = t.vec(col).percentiles(), j.vec(col).percentiles()
    assert pt.dtype == np.float32 and pt.shape == pj.shape
    np.testing.assert_allclose(pt, pj, rtol=1e-6, atol=1e-6)
    probs = (0.0, 0.5, 1.0)
    np.testing.assert_allclose(t.vec(col).percentiles(probs),
                               j.vec(col).percentiles(probs), rtol=1e-6)


@pytest.mark.parametrize("ratios,seed", [((0.75,), 42), ((0.5, 0.3), 7),
                                         ((0.2, 0.3, 0.5), 1)])
def test_split_frame_assigns_the_same_rows(frames, ratios, seed):
    t, j = frames
    tparts, jparts = t.split_frame(list(ratios), seed=seed), \
        j.split_frame(list(ratios), seed=seed)
    assert len(tparts) == len(jparts)
    assert sum(p.nrow for p in tparts) == t.nrow
    for tp, jp in zip(tparts, jparts):
        _same_columns(tp, jp)


def test_rows_head_and_selection(frames):
    t, j = frames
    _same_columns(t.head(), j.head())
    _same_columns(t.head(7), j.head(7))
    assert t.head(1000).nrow == t.nrow
    idx = np.array([3, 0, 299, 5, 5])
    _same_columns(t.rows(idx), j.rows(idx))
    mask = np.arange(t.nrow) % 3 == 1
    _same_columns(t[mask], j[mask])
    _same_columns(t[10:20], j[10:20])
    _same_columns(t[["g", "x"]], j[["g", "x"]])
    _same_columns(t["t"], j["t"])
    _same_columns(t.drop(["s", "k"]), j.drop(["s", "k"]))
    _same_columns(t.drop("big").cbind(t[["big"]]),
                  j.drop("big").cbind(j[["big"]]))
    with pytest.raises(TypeError):
        t[3.5]


def test_to_numpy_and_the_model_matrix(frames):
    t, j = frames
    np.testing.assert_array_equal(t.to_numpy(), j.to_numpy())
    m = t.as_matrix(["x", "s", "g"]).numpy()
    jm = np.asarray(j.as_matrix(["x", "s", "g"]))[:t.nrow]
    np.testing.assert_array_equal(_bits(m), _bits(jm))
    assert np.isnan(m[:, 1]).all()               # a string column is NaN
    assert t.vec("s").data is None and t.vec("s").device.type == "cpu"


def test_vec_conversions_match_jax(frames):
    t, j = frames
    f_t, f_j = t.vec("k").asfactor(), j.vec("k").asfactor()
    assert f_t.domain == f_j.domain
    np.testing.assert_array_equal(f_t.to_numpy(), f_j.to_numpy())
    s_t, s_j = t.vec("s").asfactor(), j.vec("s").asfactor()
    assert s_t.type == s_j.type == "enum" and s_t.domain == s_j.domain
    np.testing.assert_array_equal(s_t.to_numpy(), s_j.to_numpy())


@pytest.mark.parametrize("arr", [
    np.array([1, 2, 3], np.int64), np.array([1.5, np.nan, 3.0]),
    np.array([(1 << 53) + 1, 5], np.int64), np.array([True, False]),
    np.array([16_777_217.0, 3.0], np.float32),
    np.array(["b", None, "a", "b"], dtype=object)])
def test_vec_from_numpy_types_like_jax(arr):
    tv = Vec.from_numpy(arr, "cpu")
    jv = jh2o.Vec.from_numpy(arr)
    assert tv.type == jv.type and tv.domain == jv.domain
    np.testing.assert_array_equal(_bits(tv.data.numpy()),
                                  _bits(np.asarray(jv.data)[:len(arr)]))
    assert (tv.host_data is None) == (jv.host_data is None)
    if jv.host_data is not None:
        np.testing.assert_array_equal(_bits(tv.host_data),
                                      _bits(jv.host_data))


def test_vecs_rename_to_dict_and_summary_match_jax(frames):
    """A8 on the frame: the columns in order, a renamed frame sharing
    them, the host columns by name (bit for bit) and the rollups by name
    (exact counts, mean and sigma within rtol 1e-5, as above)."""
    t, j = frames
    assert [v.type for v in t.vecs] == [v.type for v in j.vecs]
    assert all(a is b for a, b in zip(t.vecs, [t.vec(n) for n in t.names]))
    mapping = {"x": "x_renamed", "g": "group"}
    tr, jr = t.rename(mapping), j.rename(mapping)
    assert tr.names == jr.names and t.names == j.names
    assert tr.vec("group") is t.vec("g")
    td, jd = t.to_dict(), j.to_dict()
    assert list(td) == list(jd)
    for n in jd:
        if jd[n].dtype == object:
            assert list(td[n]) == list(jd[n]), n
        else:
            assert td[n].dtype == jd[n].dtype, n
            np.testing.assert_array_equal(_bits(td[n]), _bits(jd[n]),
                                          err_msg=n)
    ts, js = t.summary(), j.summary()
    assert list(ts) == list(js)
    for n in js:
        for key in EXACT:
            assert ts[n][key] == js[n][key], (n, key)
        for key in ("mean", "sigma"):
            np.testing.assert_allclose(ts[n][key], js[n][key], rtol=1e-5,
                                       atol=0)
