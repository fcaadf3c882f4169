"""The port's EasyPredict row API (h2o3_tpu_torch.genmodel) against the
JAX package's: the domain lookup tables, ``rows_to_matrix`` on unknown
string and int-coded levels under both policies, invalid numbers, None
and missing columns (arrays equal), and ``EasyPredictModelWrapper`` on a
GBM carried across with ``GBMModel.from_jax_arrays``."""
import jax
import numpy as np
import pytest

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu import genmodel as jgen
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as JaxGBM
from h2o3_tpu.parallel.mesh import current_mesh, make_mesh, set_mesh
from h2o3_tpu_torch import genmodel as tgen
from h2o3_tpu_torch.models.gbm import GBMModel
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

COLS = ["c", "x", "d"]
DOMS = {"c": ("a", "b", "c"), "d": ("lo", "hi")}
ROWS = [{"c": "b", "x": 1.5, "d": "hi"},
        {"c": "zz", "x": None},                 # unknown label, missing d
        {"c": 7, "x": 2.0, "d": 1},             # int code out of range
        {"c": 2.0, "x": "3.5", "d": 0.0},       # valid int codes
        {"c": 1.5, "x": 4.0, "d": -1},          # non-integral, negative
        {"c": float("nan"), "x": float("inf")},  # numeric NA level
        {"x": -0.0, "d": "HI"},                 # missing c, unknown case
        {}]


@pytest.fixture(autouse=True, scope="module")
def _one_jax_device():
    old = current_mesh()
    set_mesh(make_mesh(n_data=1, devices=jax.devices()[:1]))
    yield
    set_mesh(old)


def test_build_domain_luts_matches_jax():
    doms = {**DOMS, "e": (), "f": ("1", "2", "10")}
    cols = COLS + ["e", "f", "g"]
    assert tgen.build_domain_luts(cols, doms) == \
        jgen.build_domain_luts(cols, doms)


@pytest.mark.parametrize("convert_unknown", [True, False])
def test_rows_to_matrix_matches_jax(convert_unknown):
    if not convert_unknown:
        for r in ROWS:
            kw = dict(convert_unknown_categorical_levels_to_na=False)
            try:
                want = jgen.rows_to_matrix([r], COLS, DOMS, **kw)
            except ValueError as e:
                with pytest.raises(ValueError, match="unknown categorical"):
                    tgen.rows_to_matrix([r], COLS, DOMS, **kw)
                assert "unknown categorical" in str(e)
                continue
            np.testing.assert_array_equal(
                tgen.rows_to_matrix([r], COLS, DOMS, **kw), want)
        return
    seen_t, seen_j = {}, {}
    got = tgen.rows_to_matrix(ROWS, COLS, DOMS, unknown_seen=seen_t)
    want = jgen.rows_to_matrix(ROWS, COLS, DOMS, unknown_seen=seen_j)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert seen_t == seen_j == {"c": 3, "d": 2}


def test_rows_to_matrix_invalid_numbers_and_padded_out_match_jax():
    rows = [{"x": "nope", "c": "a"}, {"x": "1e3"}, {"x": [1]}]
    with pytest.raises((TypeError, ValueError)):
        jgen.rows_to_matrix(rows, COLS, DOMS)
    with pytest.raises((TypeError, ValueError)):
        tgen.rows_to_matrix(rows, COLS, DOMS)
    got = tgen.rows_to_matrix(rows, COLS, DOMS,
                              convert_invalid_numbers_to_na=True)
    want = jgen.rows_to_matrix(rows, COLS, DOMS,
                               convert_invalid_numbers_to_na=True)
    np.testing.assert_array_equal(got, want)
    # a padded float32 buffer: the first n rows reset, the rest untouched
    out_t = np.full((5, 3), 9.0, np.float32)
    out_j = out_t.copy()
    tgen.rows_to_matrix(ROWS[:3], COLS, DOMS, out=out_t)
    jgen.rows_to_matrix(ROWS[:3], COLS, DOMS, out=out_j)
    np.testing.assert_array_equal(out_t, out_j)
    assert (out_t[3:] == 9.0).all()


def test_rows_to_matrix_unknown_int_codes_honor_policy():
    cols = ["c", "x"]
    doms = {"c": ("a", "b", "c")}
    seen = {}
    m = tgen.rows_to_matrix([{"c": "b", "x": 1.5},
                             {"c": "zz", "x": None},        # unknown label
                             {"c": 7, "x": 2.0},            # int code OOB
                             {"c": 2.0, "x": "3.5"},        # valid int code
                             {"c": 1.5, "x": 4.0}],         # non-integral
                            cols, doms, unknown_seen=seen)
    assert m[0, 0] == 1.0 and m[0, 1] == 1.5
    assert np.isnan(m[1, 0]) and np.isnan(m[1, 1])
    assert np.isnan(m[2, 0])                 # OOB int code → NA
    assert m[3, 0] == 2.0 and m[3, 1] == 3.5
    assert np.isnan(m[4, 0])                 # non-integral code → NA
    assert seen == {"c": 3}
    with pytest.raises(ValueError, match="unknown categorical"):
        tgen.rows_to_matrix([{"c": 7}], cols, doms,
                            convert_unknown_categorical_levels_to_na=False)


def _frame_cols(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    num = rng.normal(size=n).astype(np.float32)
    num2 = rng.uniform(-2, 2, size=n).astype(np.float32)
    carrier = rng.integers(0, 3, size=n)
    logit = num * 1.2 - num2 + (carrier == 0) * 0.8
    y = rng.random(n) < 1 / (1 + np.exp(-logit))
    num[rng.random(n) < 0.05] = np.nan
    return {"dist": num, "hour": num2,
            "carrier": np.array(["AA", "UA", "DL"], dtype=object)[carrier],
            "delayed": np.where(y, "YES", "NO").astype(object)}


@pytest.fixture(scope="module")
def carried():
    """A JAX GBM and the port's copy of it (from_jax_arrays), on the
    CPU, and rows of its training frame."""
    cols = _frame_cols()
    jm = JaxGBM(ntrees=6, max_depth=3, seed=1, min_rows=1.0).train(
        y="delayed", training_frame=jh2o.Frame.from_numpy(cols)).model
    meta = {"dist_name": jm.dist_name, "n_bins": jm.n_bins,
            "max_depth": jm.max_depth, "ntrees_built": jm.ntrees_built,
            "nclasses": jm.nclasses, "names": jm.feature_names,
            "response_domain": jm.response_domain,
            "is_cat": jm.feature_is_cat, "cat_domains": jm.cat_domains}
    tm = GBMModel.from_jax_arrays(jm._save_arrays(), meta, device="cpu")
    rows = [{"dist": None if np.isnan(cols["dist"][i])
             else float(cols["dist"][i]),
             "hour": float(cols["hour"][i]),
             "carrier": cols["carrier"][i]} for i in range(40)]
    rows[3]["carrier"] = "??"            # unknown level
    del rows[5]["hour"]                  # missing column
    rows[7]["carrier"] = 1               # int-coded level
    return jm, tm, rows


def test_easypredict_predict_row_matches_jax(carried):
    jm, tm, rows = carried
    jw = jgen.EasyPredictModelWrapper(jm)
    tw = tgen.EasyPredictModelWrapper(tm)
    assert tw.columns == jw.columns
    for r in rows:
        want = jw.predict_row(r)
        got = tw.predict_row(r)
        assert got["label"] == want["label"], r
        assert set(got["classProbabilities"]) == \
            set(want["classProbabilities"])
        for k, p in want["classProbabilities"].items():
            assert abs(got["classProbabilities"][k] - p) <= 1e-6, (r, k)
    assert tw.unknown_categorical_levels_seen == \
        jw.unknown_categorical_levels_seen == {"carrier": 1}


def test_easypredict_row_matches_rows_to_matrix(carried):
    _jm, tm, rows = carried
    wrap = tgen.EasyPredictModelWrapper(tm)
    batch = tgen.rows_to_matrix(rows, wrap.columns, wrap.cat_domains)
    for i, r in enumerate(rows):
        assert np.array_equal(wrap._row_to_array(r), batch[i],
                              equal_nan=True)
    assert wrap.unknown_categorical_levels_seen == {"carrier": 1}


def test_easypredict_row_equals_the_ports_predict(carried):
    """One row scored alone equals the same row in a frame's predict, bit
    for bit (float32 input, the tree-order margin)."""
    _jm, tm, rows = carried
    wrap = tgen.EasyPredictModelWrapper(tm)
    fr_cols = {c: np.array([r.get(c) for r in rows], dtype=object)
               for c in ("carrier",)}
    fr_cols["dist"] = np.array([np.nan if r.get("dist") is None
                                else r["dist"] for r in rows], np.float32)
    fr_cols["hour"] = np.array([r.get("hour", np.nan) for r in rows],
                               np.float32)
    fr_cols["carrier"] = np.array(
        [r["carrier"] if isinstance(r["carrier"], str)
         else tm.cat_domains["carrier"][r["carrier"]] for r in rows],
        dtype=object)
    pred = tm.predict(th2o.Frame.from_numpy(fr_cols, device="cpu"))
    p_yes = pred.vec("pYES").to_numpy()
    for i, r in enumerate(rows):
        got = wrap.predict_row(r)
        assert got["classProbabilities"]["YES"] == float(p_yes[i]), i


def test_easypredict_refusals():
    class M:
        feature_names = ["a"]
        cat_domains = {}
        response_domain = None
        nclasses = 1
    with pytest.raises(ValueError, match="TreeSHAP"):
        tgen.EasyPredictModelWrapper(M(), enable_contributions=True)
    with pytest.raises(NotImplementedError, match="item 16"):
        tgen.EasyPredictModelWrapper(M(), enable_leaf_assignment=True)
