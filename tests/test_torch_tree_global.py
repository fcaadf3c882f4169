"""Parity of the port's global-sketch grower (h2o3_tpu_torch.models.tree.
grow_tree) with the JAX package's ``grow_tree``, compiled as its trainer
runs it: the same unpacked codes (uint8 at 14 bins, int32 at 300, NA =
bin n_bins) and (g, h, w) give the same splits, routing and leaf ids, and
values within float32 summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.models import tree as jtree
from h2o3_tpu_torch.models import tree as ttree
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)


def _inputs(rows, F, n_bins, dtype, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, n_bins, size=(rows, F))
    codes[rng.random((rows, F)) < 0.05] = n_bins           # NA
    signal = (codes[:, 0] / n_bins * 12 - 0.5 * codes[:, 1] / n_bins * 12
              + rng.normal(size=rows))
    p = 1.0 / (1.0 + np.exp(-0.3 * signal))
    g = (p - (rng.random(rows) < p)).astype(np.float32)
    h = np.maximum(p * (1 - p), 1e-9).astype(np.float32)
    w = np.ones(rows, np.float32)
    w[rng.random(rows) < 0.1] = 0.0
    return codes.astype(dtype), g * w, h * w, w


@pytest.mark.parametrize("n_bins,dtype", [(14, np.uint8), (300, np.int32)])
@pytest.mark.parametrize("depth", [0, 1, 4])
def test_grow_tree_matches_jax(n_bins, dtype, depth):
    codes, g, h, w = _inputs(3000, 5, n_bins, dtype, depth + n_bins)
    F = codes.shape[1]
    kw = dict(max_depth=depth, n_bins=n_bins, n_features=F, min_rows=1.0,
              histogram_precision="float32")
    jc, tc = jtree.TreeConfig(**kw), ttree.TreeConfig(**kw)
    jt, jnid = jax.jit(lambda c, a, b, x: jtree.grow_tree(
        c, a, b, x, jc, jnp.ones(F, bool)))(
        jnp.asarray(codes), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w))
    tt, tnid = ttree.grow_tree(torch.as_tensor(codes), torch.as_tensor(g),
                               torch.as_tensor(h), torch.as_tensor(w), tc)
    if depth:
        assert bool(tt["is_split"].any())
    for k in ("feat", "split_bin", "na_left", "is_split"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(tnid.numpy(), np.asarray(jnid))
    for k in ("value", "node_w", "gain"):
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)

