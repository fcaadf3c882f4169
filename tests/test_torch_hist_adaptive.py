"""Parity of the port's adaptive-bin level functions with the JAX
package: the plain adaptive_level / adaptive_route_only, in both feature
layouts, against the scatter references (adaptive_level_xla /
route_only_xla) and the Pallas kernels run in interpret mode (K5/K6 on
[F, rows], K8/K9 on [rows, F]). The CUDA kernels are held against the
plain versions in tests/test_torch_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.ops import hist_adaptive as jha
from h2o3_tpu_torch.ops import hist_adaptive as tha
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)


def _inputs(rows=3000, F=6, W=16, N=4, seed=0, int_ghw=True):
    """Level inputs as numpy: raw features with NaN, nid in the previous
    level's window, (g, h, w), the previous level's raw-threshold split
    tables and per-(node, feature) ranges (feature 2 narrowed so that
    |lo| >> span, as deep levels make it)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, F)).astype(np.float32)
    x[rng.random((rows, F)) < 0.06] = np.nan
    x[:, 2] = 1000.0 + 0.01 * rng.random(rows).astype(np.float32)
    n_prev, base = N // 2, N - 1
    m = max(n_prev, 1)
    nid = (base - n_prev + rng.integers(0, m, rows)).astype(np.int32)
    if int_ghw:
        # integer mass: every float32 sum is exact in any order
        g = rng.integers(-8, 9, rows).astype(np.float32)
        h = rng.integers(0, 4, rows).astype(np.float32)
    else:
        g = rng.normal(size=rows).astype(np.float32)
        h = (rng.random(rows) * 0.25).astype(np.float32)
    ghw = np.stack([g, h, np.ones(rows, np.float32)])
    thr = rng.normal(size=m).astype(np.float32)
    feat = rng.integers(0, F, m).astype(np.float32)
    feat[0], thr[0] = 2.0, 1000.005        # a split on the narrowed feature
    tables = (feat, thr, (rng.random(m) < 0.5).astype(np.float32),
              (rng.random(m) < 0.8).astype(np.float32))
    lo = np.tile(rng.normal(size=(1, F)).astype(np.float32) - 3, (N, 1))
    lo[:, 2] = 1000.0
    inv = np.full((N, F), (W - 2) / 6.0, np.float32)
    inv[:, 2] = (W - 2) / 0.01
    return x, nid, ghw, tables, lo, inv, n_prev, base


def _torch_args(x, nid, ghw, tables, lo, inv, layout):
    xt = torch.as_tensor(x if layout == "rows_f" else x.T.copy())
    return (xt, torch.as_tensor(nid), torch.as_tensor(ghw),
            tha.make_adaptive_tables(*(torch.as_tensor(t) for t in tables))
            .contiguous(), torch.as_tensor(lo), torch.as_tensor(inv))


def _jax_args(nid, ghw, tables, lo, inv):
    return (jnp.asarray(nid), jnp.asarray(ghw),
            tuple(jnp.asarray(t) for t in tables), jnp.asarray(lo),
            jnp.asarray(inv))


@pytest.mark.parametrize("layout", ["rows_f", "f_rows"])
@pytest.mark.parametrize("W", [16, 32])
@pytest.mark.parametrize("N", [1, 4, 8])
def test_adaptive_level_plain_matches_xla(layout, W, N):
    x, nid, ghw, tables, lo, inv, n_prev, base = _inputs(W=W, N=N,
                                                         seed=W + N)
    targs = _torch_args(x, nid, ghw, tables, lo, inv, layout)
    nid_t, hist_t = tha.adaptive_level_plain(*targs, n_prev, N, base, W,
                                             layout=layout)
    jn, jg, jt, jlo, jinv = _jax_args(nid, ghw, tables, lo, inv)
    nid_x, hist_x = jha.adaptive_level_xla(jnp.asarray(x), jn, jg, jt, jlo,
                                           jinv, n_prev, N, base, W)
    np.testing.assert_array_equal(nid_t.numpy(), np.asarray(nid_x))
    assert hist_t.shape == (3, N, x.shape[1], W)
    np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_x))


@pytest.mark.parametrize("layout", ["rows_f", "f_rows"])
@pytest.mark.parametrize("W", [16, 32])
@pytest.mark.parametrize("bf16", [False, True])
def test_adaptive_level_plain_matches_pallas_interpret(layout, W, bf16):
    """Against the TPU kernels themselves (interpret mode): K5 for
    [F, rows], K8 for [rows, F]; float32 contraction at bf16=False, the
    bf16 one-hot product at bf16=True."""
    N = 4
    x, nid, ghw, tables, lo, inv, n_prev, base = _inputs(
        rows=2048, W=W, N=N, seed=11 + W, int_ghw=False)
    targs = _torch_args(x, nid, ghw, tables, lo, inv, layout)
    nid_t, hist_t = tha.adaptive_level_plain(*targs, n_prev, N, base, W,
                                             bf16=bf16, layout=layout)
    jn, jg, jt, jlo, jinv = _jax_args(nid, ghw, tables, lo, inv)
    mxu = jnp.bfloat16 if bf16 else jnp.float32
    if layout == "f_rows":
        nid_p, hist_p = jha.adaptive_level_tpu_t(
            jnp.asarray(x.T.copy()), jn, jg, jt, jlo, jinv, n_prev, N, base,
            W, tile=1024, interpret=True, mxu_dtype=mxu)
    else:
        nid_p, hist_p = jha.adaptive_level_tpu(
            jnp.asarray(x), jn, jg, jt, jlo, jinv, n_prev, N, base, W,
            tile=1024, interpret=True, mxu_dtype=mxu)
    np.testing.assert_array_equal(nid_t.numpy(), np.asarray(nid_p))
    np.testing.assert_allclose(hist_t.numpy(), np.asarray(hist_p),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "layout,rows,N,tile",
    [pytest.param("rows_f", 2048, 16, 1024, id="rows_f"),
     pytest.param("f_rows", 2048, 16, 1024, id="f_rows"),
     # a row count that is not a multiple of 4 (the kernel's ragged quad)
     pytest.param("rows_f", 3069, 16, 1023, id="rows_f-ragged"),
     pytest.param("f_rows", 3069, 16, 1023, id="f_rows-ragged"),
     # n_prev = 1
     pytest.param("rows_f", 2048, 2, 1024, id="rows_f-n_prev=1"),
     pytest.param("f_rows", 2048, 2, 1024, id="f_rows-n_prev=1")])
def test_adaptive_route_only_plain_matches_xla_and_pallas(layout, rows, N,
                                                          tile):
    x, nid, _ghw, tables, lo, inv, n_prev, base = _inputs(rows=rows, N=N,
                                                          seed=5)
    targs = _torch_args(x, nid, _ghw, tables, lo, inv, layout)
    got = tha.adaptive_route_only_plain(targs[0], targs[1], targs[3],
                                        n_prev, base, layout=layout)
    jn, _jg, jt, _lo, _inv = _jax_args(nid, _ghw, tables, lo, inv)
    want = jha.route_only_xla(jnp.asarray(x), jn, jt, n_prev, base)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if layout == "f_rows":
        pal = jha.route_only_tpu_t(jnp.asarray(x.T.copy()), jn, jt, n_prev,
                                   base, tile=tile, interpret=True)
    else:
        pal = jha.route_only_tpu(jnp.asarray(x), jn, jt, n_prev, base,
                                 tile=tile, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


@pytest.mark.parametrize("layout", ["rows_f", "f_rows"])
def test_nan_inf_and_zero_span_bins_match_the_cpu_reference(layout):
    """NaN takes the NA lane; ±inf clips to the end bins; on a zero-span
    node (inv = 0) (±inf - lo) * 0 is NaN and the row takes bin 0, as
    the JAX package's CPU reference does."""
    W, N = 16, 2
    x, nid, ghw, tables, lo, inv, n_prev, base = _inputs(W=W, N=N, seed=9)
    tables = tables[:3] + (np.ones(1, np.float32),)   # every row routes
    rows = x.shape[0]
    x[:, 4] = 2.5                              # constant over finite rows
    x[0::7, 4] = np.inf
    x[3::7, 4] = -np.inf
    x[5::11, 4] = np.nan
    x[1::5, 0] = np.inf                        # inf on a live range
    x[2::5, 0] = -np.inf
    lo[:, 4], inv[:, 4] = 2.5, 0.0             # zero span
    targs = _torch_args(x, nid, ghw, tables, lo, inv, layout)
    nid_t, hist_t = tha.adaptive_level_plain(*targs, n_prev, N, base, W,
                                             layout=layout)
    jn, jg, jt, jlo, jinv = _jax_args(nid, ghw, tables, lo, inv)
    nid_x, hist_x = jha.adaptive_level_xla(jnp.asarray(x), jn, jg, jt, jlo,
                                           jinv, n_prev, N, base, W)
    np.testing.assert_array_equal(nid_t.numpy(), np.asarray(nid_x))
    np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_x))
    w4 = hist_t[2, :, 4, :].sum(0)
    n_na = int(np.isnan(x[:, 4]).sum())
    assert w4[W - 1] == n_na                   # NaN -> NA lane
    assert w4[0] == rows - n_na                # finite and ±inf -> bin 0
    w0 = hist_t[2, :, 0, :].sum(0)
    assert w0[W - 2] >= (np.isposinf(x[:, 0])).sum()


def test_tpu_kernel_drops_what_the_cpu_reference_puts_in_bin_0():
    """The JAX package disagrees with itself on an infinite value in a
    zero-span feature: its CPU reference bins the NaN product at 0, its
    TPU kernel (here in interpret mode) drops the row from that feature.
    The port follows the CPU reference."""
    W, N = 16, 2
    x, nid, ghw, tables, lo, inv, n_prev, base = _inputs(rows=2048, W=W,
                                                         N=N, seed=9)
    tables = tables[:3] + (np.ones(1, np.float32),)
    x[:, 4] = 2.5
    x[0::7, 4] = np.inf
    lo[:, 4], inv[:, 4] = 2.5, 0.0
    n_inf = int(np.isinf(x[:, 4]).sum())
    jn, jg, jt, jlo, jinv = _jax_args(nid, ghw, tables, lo, inv)
    _n, hist_x = jha.adaptive_level_xla(jnp.asarray(x), jn, jg, jt, jlo,
                                        jinv, n_prev, N, base, W)
    _n, hist_p = jha.adaptive_level_tpu_t(
        jnp.asarray(x.T.copy()), jn, jg, jt, jlo, jinv, n_prev, N, base, W,
        tile=1024, interpret=True, mxu_dtype=jnp.float32)
    targs = _torch_args(x, nid, ghw, tables, lo, inv, "rows_f")
    _n, hist_t = tha.adaptive_level_plain(*targs, n_prev, N, base, W)
    w_cpu = np.asarray(hist_x)[2, :, 4, :].sum()
    w_tpu = np.asarray(hist_p)[2, :, 4, :].sum()
    assert w_cpu - w_tpu == n_inf
    assert float(hist_t[2, :, 4, :].sum()) == w_cpu


def test_bf16_rounds_each_mass_before_the_add():
    x, nid, ghw, tables, lo, inv, n_prev, base = _inputs(N=2, seed=3,
                                                         int_ghw=False)
    xt, tn, tg, tt, tlo, tinv = _torch_args(x, nid, ghw, tables, lo, inv,
                                            "rows_f")
    args = (n_prev, 2, base, 16)
    _n, h32 = tha.adaptive_level_plain(xt, tn, tg, tt, tlo, tinv, *args)
    rounded = tg.to(torch.bfloat16).to(torch.float32)
    _n, hr = tha.adaptive_level_plain(xt, tn, rounded, tt, tlo, tinv, *args)
    _n, h16 = tha.adaptive_level_plain(xt, tn, tg, tt, tlo, tinv, *args,
                                       bf16=True)
    assert torch.equal(h16, hr)
    assert not torch.equal(h16, h32)


def test_layouts_agree_and_unknown_layout_raises():
    x, nid, ghw, tables, lo, inv, n_prev, base = _inputs(N=4, seed=2)
    a = _torch_args(x, nid, ghw, tables, lo, inv, "rows_f")
    b = _torch_args(x, nid, ghw, tables, lo, inv, "f_rows")
    na, ha = tha.adaptive_level_plain(*a, n_prev, 4, base, 16)
    nb, hb = tha.adaptive_level_plain(*b, n_prev, 4, base, 16,
                                      layout="f_rows")
    assert torch.equal(na, nb) and torch.equal(ha, hb)
    with pytest.raises(ValueError, match="unknown layout"):
        tha.adaptive_level_plain(*a, n_prev, 4, base, 16, layout="rows")
