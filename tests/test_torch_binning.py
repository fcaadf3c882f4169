"""Parity of the port's binning (h2o3_tpu_torch.ops.binning) with the JAX
package's device sketch: edges bit-equal, codes and packed codes equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.ops import binning as jbin
from h2o3_tpu_torch.ops import binning as tbin

ROWS = 3000


def _matrix(seed=0):
    """Columns with NaN, +-inf, a constant, all-NA, heavy ties and a
    categorical code column."""
    rng = np.random.default_rng(seed)
    X = np.empty((ROWS, 7), np.float32)
    X[:, 0] = rng.normal(size=ROWS)
    X[rng.random(ROWS) < 0.03, 0] = np.nan
    X[:, 1] = rng.exponential(size=ROWS) * 100.0
    X[rng.random(ROWS) < 0.02, 1] = np.inf
    X[rng.random(ROWS) < 0.02, 1] = -np.inf
    X[rng.random(ROWS) < 0.05, 1] = np.nan
    X[:, 2] = 3.25
    X[:, 3] = np.nan
    X[:, 4] = rng.integers(0, 5, ROWS)
    X[:, 5] = rng.uniform(-1e6, 1e6, ROWS)
    X[:, 6] = rng.integers(0, 9, ROWS)
    X[rng.random(ROWS) < 0.04, 6] = np.nan
    is_cat = [False] * 6 + [True]
    return X, is_cat


@pytest.mark.parametrize("histogram_type",
                         ["quantiles_global", "uniform_adaptive"])
@pytest.mark.parametrize("nbins", [14, 20, 200])
def test_edges_and_codes_match_jax(histogram_type, nbins):
    X, is_cat = _matrix()
    names = [f"c{i}" for i in range(X.shape[1])]
    jb = jbin.bin_matrix_device(jnp.asarray(X), names, is_cat, ROWS,
                                nbins=nbins, histogram_type=histogram_type,
                                with_t=False)
    tb = tbin.bin_matrix_device(torch.as_tensor(X), names, is_cat,
                                nbins=nbins, histogram_type=histogram_type)
    assert tb.n_bins == jb.n_bins
    assert len(tb.edges) == len(jb.edges)
    for f, (a, b) in enumerate(zip(tb.edges, jb.edges)):
        assert a.dtype == b.dtype == np.float32, f
        np.testing.assert_array_equal(a, b, err_msg=f"feature {f}")
    np.testing.assert_array_equal(tb.codes.numpy(),
                                  np.asarray(jb.codes.rm))
    tp = tbin.pack_codes(tb)
    jp = jbin.pack_codes(jb)
    assert tp.W == jp.W
    assert tp.rm.dtype == (torch.int8 if jp.W <= 128 else torch.int16)
    np.testing.assert_array_equal(tp.rm.numpy(), np.asarray(jp.rm))


def test_pack_codes_for_new_frame_matches_jax():
    X, is_cat = _matrix(seed=1)
    names = [f"c{i}" for i in range(X.shape[1])]
    jb = jbin.bin_matrix_device(jnp.asarray(X), names, is_cat, ROWS,
                                nbins=14, with_t=False)
    tb = tbin.bin_matrix_device(torch.as_tensor(X), names, is_cat, nbins=14)
    X2, _ = _matrix(seed=2)
    X2[:5] = np.inf                 # +inf lands in the shared lane max_e
    got = tbin.pack_codes_for(torch.as_tensor(X2), tb)
    want = jbin.pack_codes_for(jnp.asarray(X2), jb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_digitize_na_and_inf_lanes():
    edges = [np.array([0.0, 1.0], np.float32), np.array([5.0], np.float32)]
    X = torch.tensor([[np.nan, 5.0], [np.inf, -np.inf], [1.0, np.inf]],
                     dtype=torch.float32)
    codes = tbin.digitize_with_edges(X, edges, 14).numpy()
    want = np.asarray(jbin.digitize_with_edges(np.asarray(X), edges, 14))
    np.testing.assert_array_equal(codes, want)
    assert codes[0, 0] == 14                 # NaN -> the NA bin
    assert codes[1, 0] == codes[2, 1] == 2   # +inf -> lane max_e
