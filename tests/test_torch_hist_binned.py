"""Parity of the port's packed-code level functions with the JAX
package: the plain binned_level / binned_route_only against the scatter
references (binned_level_xla / binned_route_only_xla) and the Pallas
kernel run in interpret mode. The CUDA kernels are held against the
plain versions in tests/test_torch_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.ops import hist_adaptive as jha
from h2o3_tpu_torch.ops import hist_adaptive as tha


def _inputs(rows=4096, F=7, W=16, N=4, seed=0, int_ghw=True):
    """Level inputs as numpy: codes [rows, F] (NA = W-1), nid in the
    previous level's window, (g, h, w) and the previous level's split
    tables."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, W - 1, size=(rows, F)).astype(np.int32)
    codes[rng.random((rows, F)) < 0.07] = W - 1
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
    tables = (rng.integers(0, F, m).astype(np.float32),
              rng.integers(1, W - 1, m).astype(np.float32),
              (rng.random(m) < 0.5).astype(np.float32),
              (rng.random(m) < 0.8).astype(np.float32))
    return codes, nid, ghw, tables, n_prev, base


def _torch_args(codes, nid, ghw, tables, W, device="cpu"):
    return (torch.as_tensor(codes.astype(np.int8 if W <= 128 else np.int16),
                            device=device),
            torch.as_tensor(nid, device=device),
            torch.as_tensor(ghw, device=device),
            tha.make_tables(*(torch.as_tensor(t) for t in tables))
            .to(device).contiguous())


def _jax_args(codes, nid, ghw, tables):
    return (jnp.asarray(codes), jnp.asarray(nid), jnp.asarray(ghw),
            tuple(jnp.asarray(t) for t in tables))


@pytest.mark.parametrize("W", [16, 32])
@pytest.mark.parametrize("N", [1, 4, 8])
@pytest.mark.parametrize("int_ghw", [True, False])
def test_binned_level_plain_matches_xla(W, N, int_ghw):
    codes, nid, ghw, tables, n_prev, base = _inputs(
        W=W, N=N, seed=W + N, int_ghw=int_ghw)
    tc, tn, tg, tt = _torch_args(codes, nid, ghw, tables, W)
    nid_t, hist_t = tha.binned_level_plain(tc, tn, tg, tt, n_prev, N, base,
                                           W)
    jc, jn, jg, jt = _jax_args(codes, nid, ghw, tables)
    nid_x, hist_x = jha.binned_level_xla(jc, jn, jg, jt, n_prev, N, base, W)
    np.testing.assert_array_equal(nid_t.numpy(), np.asarray(nid_x))
    assert hist_t.shape == (3, N, codes.shape[1], W)
    if int_ghw:
        np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_x))
    else:
        np.testing.assert_allclose(hist_t.numpy(), np.asarray(hist_x),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("W", [16, 32])
@pytest.mark.parametrize("bf16", [False, True])
def test_binned_level_plain_matches_pallas_interpret(W, bf16):
    """Against the TPU kernel itself (interpret mode): float32 contraction
    at bf16=False, the bf16 one-hot product at bf16=True."""
    N = 4
    codes, nid, ghw, tables, n_prev, base = _inputs(W=W, N=N, seed=11 + W,
                                                    int_ghw=False)
    tc, tn, tg, tt = _torch_args(codes, nid, ghw, tables, W)
    nid_t, hist_t = tha.binned_level_plain(tc, tn, tg, tt, n_prev, N, base,
                                           W, bf16=bf16)
    jct = jnp.asarray(codes.T.astype(np.int8))
    _c, jn, jg, jt = _jax_args(codes, nid, ghw, tables)
    nid_p, hist_p = jha.binned_level_tpu_t(
        jct, jn, jg, jt, n_prev, N, base, W, tile=1024, interpret=True,
        mxu_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    np.testing.assert_array_equal(nid_t.numpy(), np.asarray(nid_p))
    np.testing.assert_allclose(hist_t.numpy(), np.asarray(hist_p),
                               rtol=1e-5, atol=1e-4)


def test_bf16_rounds_each_mass_before_the_add():
    codes, nid, ghw, tables, n_prev, base = _inputs(W=16, N=2, seed=3,
                                                    int_ghw=False)
    tc, tn, tg, tt = _torch_args(codes, nid, ghw, tables, 16)
    _n, h32 = tha.binned_level_plain(tc, tn, tg, tt, n_prev, 2, base, 16)
    rounded = tg.to(torch.bfloat16).to(torch.float32)
    _n, hr = tha.binned_level_plain(tc, tn, rounded, tt, n_prev, 2, base, 16)
    _n, h16 = tha.binned_level_plain(tc, tn, tg, tt, n_prev, 2, base, 16,
                                     bf16=True)
    assert torch.equal(h16, hr)
    assert not torch.equal(h16, h32)


@pytest.mark.parametrize("W", [16, 32, 256])
def test_binned_route_only_plain_matches_xla(W):
    codes, nid, _ghw, tables, n_prev, base = _inputs(W=W, N=16, seed=5)
    tc, tn, _tg, tt = _torch_args(codes, nid, _ghw, tables, W)
    got = tha.binned_route_only_plain(tc, tn, tt, n_prev, base, W)
    jc, jn, _jg, jt = _jax_args(codes, nid, _ghw, tables)
    want = jha.binned_route_only_xla(jc, jn, jt, n_prev, base, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pick_w_and_code_dtype_match_jax():
    for nbins in (2, 14, 15, 20, 30, 31, 62, 126, 127, 200, 254):
        assert tha.pick_W(nbins) == jha.pick_W(nbins)
        W = tha.pick_W(nbins)
        assert (tha.code_dtype(W) == torch.int8) == \
            (jha.code_dtype(W) == jnp.int8)
    with pytest.raises(ValueError):
        tha.pick_W(255)


@pytest.mark.parametrize("W,N", [(16, 32), (32, 1), (64, 8), (128, 32),
                                 (256, 1), (256, 8), (256, 32)])
@pytest.mark.parametrize("bf16", [False, True])
def test_binned_level_plain_matches_pallas_interpret_levels(W, N, bf16):
    """The plain version (which the CUDA kernel's grouped and tiled forms
    are held against) against the TPU kernel in interpret mode at the
    lane widths and levels the grouped form's tests cover."""
    codes, nid, ghw, tables, n_prev, base = _inputs(
        rows=2048, F=5, W=W, N=N, seed=N + W, int_ghw=False)
    tc, tn, tg, tt = _torch_args(codes, nid, ghw, tables, W)
    nid_t, hist_t = tha.binned_level_plain(tc, tn, tg, tt, n_prev, N, base,
                                           W, bf16=bf16)
    jct = jnp.asarray(codes.T.astype(np.int8 if W <= 128 else np.int16))
    _c, jn, jg, jt = _jax_args(codes, nid, ghw, tables)
    nid_p, hist_p = jha.binned_level_tpu_t(
        jct, jn, jg, jt, n_prev, N, base, W, tile=1024, interpret=True,
        mxu_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    np.testing.assert_array_equal(nid_t.numpy(), np.asarray(nid_p))
    np.testing.assert_allclose(hist_t.numpy(), np.asarray(hist_p),
                               rtol=1e-5, atol=1e-4)
