"""The node-grouped kernels' pieces on the CPU: the row grouping
(``common.group_rows_plain``) against numpy's stable argsort, the port's
three-term bf16 split against the JAX package's ``_split3_bf16``, and
torch models of the two redesigned kernels held against the plain
versions: the float [rows, F] adaptive level (K8) as one-hot products of
bf16-valued operands grouped by parent, and the global-sketch histogram
(K11) as per-span partials merged in slot order. The CUDA kernels are
held against the plain versions in tests/test_torch_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.ops import hist_adaptive as jha
from h2o3_tpu_torch.ops import hist_adaptive as tha
from h2o3_tpu_torch.ops.common import group_rows_plain, split3_bf16
from h2o3_tpu_torch.ops.histogram import build_histograms_plain


# ------------------------------------------------------------ grouping


@pytest.mark.parametrize("rows,G,seed", [(5000, 7, 0), (4096, 1, 1),
                                         (3000, 64, 2), (1, 3, 3),
                                         (0, 2, 4), (2000, 300, 5)])
def test_group_rows_plain_matches_stable_argsort(rows, G, seed):
    rng = np.random.default_rng(seed)
    # out-of-range keys on both sides; with G = 300 > rows / 10 many
    # groups stay empty, and group 1 is emptied on purpose
    keys = rng.integers(-2, G + 2, rows).astype(np.int32)
    keys[keys == 1] = G
    offsets, idx = group_rows_plain(torch.as_tensor(keys), G)
    kept = (keys >= 0) & (keys < G)
    want = np.argsort(np.where(kept, keys, G), kind="stable")[:kept.sum()]
    counts = np.bincount(keys[kept], minlength=G)
    assert offsets.dtype == torch.int32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(offsets.numpy(),
                                  np.concatenate([[0], np.cumsum(counts)]))
    np.testing.assert_array_equal(idx.numpy()[:kept.sum()], want)
    assert (idx.numpy()[kept.sum():] == -1).all()
    if G > 1:
        assert offsets[1] == offsets[2]          # the emptied group


# --------------------------------------------------------- the bf16 split


def _split_inputs():
    rng = np.random.default_rng(7)
    tiny = np.float32(np.finfo(np.float32).tiny)
    normals = rng.normal(size=2000).astype(np.float32) * \
        np.float32(10.0) ** rng.integers(-30, 30, 2000).astype(np.float32)
    subnormals = (rng.random(500) * tiny).astype(np.float32) * \
        np.where(rng.random(500) < 0.5, -1, 1).astype(np.float32)
    bits = rng.integers(0, 2 ** 23, 200, dtype=np.uint32)   # raw subnormals
    raw = bits.view(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, 3.3e38, -3.3e38,
                        3.4028235e38, 1e-45, -1e-45, 1.0, -1.0],
                       dtype=np.float32)
    return np.concatenate([normals, subnormals, raw, special])


def test_split3_matches_jax_bit_for_bit():
    """All three terms equal JAX's bit for bit wherever no subnormal
    arises: zeros, infinities, large values, and normals down to 2^-102
    (below it t - hi can fall under float32's normal range). There the
    JAX package's CPU backend, like a TPU, flushes subnormal results to
    zero (its mid and lo terms become 0), while the port keeps IEEE
    subnormals, in torch and in the kernel (nvcc without -ftz), so that
    its terms still recombine exactly (next test); the high term, a
    rounding with no arithmetic, stays bit-equal on subnormals too."""
    t = _split_inputs()
    ours = split3_bf16(torch.as_tensor(t)).numpy()
    ref = np.asarray(jha._split3_bf16(jnp.asarray(t), axis=0)
                     .astype(jnp.float32)).reshape(3, -1)
    nan_o, nan_r = np.isnan(ours), np.isnan(ref)
    np.testing.assert_array_equal(nan_o, nan_r)   # inf - inf, both sides
    safe = (np.abs(t) >= 2.0 ** -102) | (t == 0)
    assert safe.sum() > 2000 and (~safe).sum() > 700
    for k in range(3):
        keep = safe & ~nan_o[k]
        np.testing.assert_array_equal(ours[k].view(np.uint32)[keep],
                                      ref[k].view(np.uint32)[keep])
    np.testing.assert_array_equal(ours[0].view(np.uint32)[~safe],
                                  ref[0].view(np.uint32)[~safe])


def test_split3_terms_recombine_exactly():
    t = _split_inputs()
    hi, mid, lo = split3_bf16(torch.as_tensor(t))
    # every finite t whose bf16 rounding stays finite (past ~3.39e38 the
    # high term rounds to inf, in JAX as here)
    ok = torch.isfinite(hi)
    assert int(ok.sum()) > 2500
    back = hi + (mid / 256.0 + lo / 65536.0)
    # equal values (-0.0 comes back as +0.0, the one bit pattern that
    # differs)
    assert torch.equal(back[ok], torch.as_tensor(t)[ok])
    for term in (hi, mid, lo):
        v = term[ok]
        assert torch.equal(v.to(torch.bfloat16).to(torch.float32), v)


# -------------------------------------------- model of the grouped K8


def _grouped_level_model(x, nid, ghw, tables, lo, inv, n_prev, N, base, W,
                         bf16, span=192, chunk=64):
    """What csrc/hist_adaptive.cu's grouped level computes, in torch: rows
    grouped by parent (ParentKey), spans of a group's rows as blocks,
    chunks of 64 rows routed and binned under the child's range, the
    histogram as one-hot x mass products of bf16-valued operands (one
    term at bf16, three at float32) added per chunk into float32, the
    blocks' [3, 2, F, W] partials summed per node in block order."""
    rows, F = x.shape
    prev_base = base - n_prev
    G = n_prev + N
    lp = nid - prev_base
    lpc = lp.clamp(0, max(n_prev, 1) - 1).long()
    routed = (n_prev > 0) & (lp >= 0) & (lp < n_prev) & (tables[3][lpc] > 0.5)
    ln = nid - base
    direct = (ln >= 0) & (ln < N)
    key = torch.where(routed, lp, torch.where(direct, n_prev + ln, -1))
    offsets, idx = group_rows_plain(key.to(torch.int32), G)
    nid_out = nid.clone()
    blocks = []                                   # (group, [3, 2, F, W])
    for k in range(G):
        members = idx[offsets[k]:offsets[k + 1]].long()
        parent = k < n_prev
        c0 = 2 * (prev_base + k) + 1 - base if parent else k - n_prev
        for s0 in range(0, len(members), span):
            part = torch.zeros(3, 2, F, W)
            for ch in range(s0, min(s0 + span, len(members)), chunk):
                r = members[ch:min(ch + chunk, s0 + span, len(members))]
                slot = torch.zeros(len(r), dtype=torch.long)
                if parent:
                    f = int(tables[0][k].clamp(0, F - 1))
                    v = x[r, f]
                    right = torch.where(torch.isnan(v), tables[2][k] < 0.5,
                                        v >= tables[1][k]).long()
                    nid_out[r] = (2 * (prev_base + k) + 1 + right).int()
                    slot = right
                node = c0 + slot
                live = (node >= 0) & (node < N)
                nodec = node.clamp(0, N - 1)
                t = (x[r] - lo[nodec]) * inv[nodec]
                t = torch.where(torch.isnan(t), 0.0, t)
                bins = torch.floor(torch.clamp(t, 0.0, float(W - 2))).long()
                bins = torch.where(torch.isnan(x[r]), W - 1, bins)
                onehot = (bins[:, :, None] == torch.arange(W)).float()
                m = ghw[:, r]
                terms = (m.to(torch.bfloat16).float()[None] if bf16
                         else split3_bf16(m))
                sums = []
                for term in terms:               # [3, rows]
                    cols = torch.zeros(len(r), 2, 3)
                    cols[torch.arange(len(r)), slot] = term.t()
                    cols = cols * live[:, None, None]
                    # exact products, float32 sums: [F, W, 2, 3]
                    sums.append(torch.einsum("rfw,rsc->fwsc", onehot, cols))
                if bf16:
                    chunk_sum = sums[0]
                else:
                    chunk_sum = sums[0] + (sums[1] * (1.0 / 256.0)
                                           + sums[2] * (1.0 / 65536.0))
                part += chunk_sum.permute(3, 2, 0, 1)
            blocks.append((k, part))
    hist = torch.zeros(3, N, F, W)
    for j in range(N):
        cid = base + j
        srcs = []
        if n_prev > 0 and cid >= 1 and 0 <= (cid - 1) // 2 - prev_base < n_prev:
            srcs.append(((cid - 1) // 2 - prev_base, (cid - 1) % 2))
        srcs.append((n_prev + j, 0))
        for k, s in srcs:
            for kb, part in blocks:
                if kb == k:
                    hist[:, j] += part[:, s]
    return nid_out, hist


def _level_inputs(rows, F, W, N, seed, int_ghw):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, F)).astype(np.float32)
    x[rng.random((rows, F)) < 0.06] = np.nan
    n_prev, base = N // 2, N - 1
    m = max(n_prev, 1)
    nid = (base - n_prev + rng.integers(0, m, rows)).astype(np.int32)
    nid[rng.random(rows) < 0.05] = 10 ** 6      # rows off every window
    can = rng.random(m) < 0.8
    can[0] = True                               # at least one split
    if int_ghw:
        g = rng.integers(-8, 9, rows).astype(np.float32)
        h = rng.integers(0, 4, rows).astype(np.float32)
    else:
        g = rng.normal(size=rows).astype(np.float32)
        h = (rng.random(rows) * 0.25).astype(np.float32)
    ghw = np.stack([g, h, np.ones(rows, np.float32)])
    lo = (rng.normal(size=(N, F)) - 2.5).astype(np.float32)
    inv = (rng.uniform(0.5, 2.0, size=(N, F)) * (W - 2) / 5).astype(np.float32)
    tables = tha.make_adaptive_tables(
        torch.as_tensor(rng.integers(0, F, m)),
        torch.as_tensor(rng.normal(size=m).astype(np.float32)),
        torch.as_tensor(rng.random(m) < 0.5), torch.as_tensor(can))
    return (torch.as_tensor(x), torch.as_tensor(nid), torch.as_tensor(ghw),
            tables, torch.as_tensor(lo), torch.as_tensor(inv), n_prev, base)


@pytest.mark.parametrize("W,N", [(16, 1), (32, 2), (32, 8), (64, 4)])
@pytest.mark.parametrize("bf16", [False, True])
def test_grouped_level_model_matches_plain(W, N, bf16):
    x, nid, ghw, t, lo, inv, n_prev, base = _level_inputs(2500, 5, W, N,
                                                          W + N, False)
    nid_m, hist_m = _grouped_level_model(x, nid, ghw, t, lo, inv, n_prev, N,
                                         base, W, bf16)
    nid_p, hist_p = tha.adaptive_level_plain(x, nid, ghw.double(), t, lo,
                                             inv, n_prev, N, base, W, bf16)
    _n, mass = tha.adaptive_level_plain(x, nid, ghw.double().abs(), t, lo,
                                        inv, n_prev, N, base, W, bf16)
    assert torch.equal(nid_m, nid_p)
    # the kernels' float tolerance: 1e-4 + 1e-5 x the bin's absolute mass
    assert bool(((hist_m.double() - hist_p).abs()
                 <= 1e-4 + 1e-5 * mass).all())


@pytest.mark.parametrize("N", [1, 4])
def test_grouped_level_model_integer_mass_bit_equal(N):
    x, nid, ghw, t, lo, inv, n_prev, base = _level_inputs(2000, 4, 16, N, N,
                                                          True)
    nid_m, hist_m = _grouped_level_model(x, nid, ghw, t, lo, inv, n_prev, N,
                                         base, 16, False)
    nid_p, hist_p = tha.adaptive_level_plain(x, nid, ghw, t, lo, inv, n_prev,
                                             N, base, 16)
    assert torch.equal(nid_m, nid_p)
    assert torch.equal(hist_m, hist_p)


def test_float32_split_keeps_float32_accuracy():
    """Three bf16 terms sum to within float32 accuracy of the unrounded
    masses; one bf16 term (the bf16 histogram) is ~2^8 times further."""
    x, nid, ghw, t, lo, inv, n_prev, base = _level_inputs(2500, 5, 32, 2,
                                                          11, False)
    _n, exact = tha.adaptive_level_plain(x, nid, ghw.double(), t, lo, inv,
                                         n_prev, 2, base, 32)
    _n, f32 = _grouped_level_model(x, nid, ghw, t, lo, inv, n_prev, 2, base,
                                   32, False)
    _n, b16 = _grouped_level_model(x, nid, ghw, t, lo, inv, n_prev, 2, base,
                                   32, True)
    e32 = float((f32.double() - exact).abs().max())
    e16 = float((b16.double() - exact).abs().max())
    # float32 sums over ~1000 rows a bin: ~1e-5; bf16 masses: ~1e-2
    assert e32 < 1e-4 and e16 > 30 * e32


# ------------------------------------------- model of the grouped K11


def _grouped_hist_model(codes, seg, ghw, N, B1, bf16, span=300):
    """What csrc/hist_global.cu's grouped form computes, in torch: rows
    grouped by node, a float32 partial per span of a node's rows, and
    each cell's partials summed in span order."""
    offsets, idx = group_rows_plain(seg, N)
    F = codes.shape[1]
    out = torch.zeros(3, N, F, B1)
    for j in range(N):
        members = idx[offsets[j]:offsets[j + 1]].long()
        for s0 in range(0, len(members), span):
            r = members[s0:s0 + span]
            part = build_histograms_plain(codes[r], torch.zeros(len(r),
                                                                dtype=torch.int32),
                                          ghw[:, r].contiguous(), 1, B1,
                                          bf16)
            out[:, j] += part[:, 0]
    return out


@pytest.mark.parametrize("B1,N", [(15, 1), (15, 8), (301, 4)])
@pytest.mark.parametrize("bf16", [False, True])
def test_grouped_hist_model_matches_plain(B1, N, bf16):
    rng = np.random.default_rng(B1 + N)
    rows, F = 4000, 4
    codes = rng.integers(0, B1, size=(rows, F)).astype(np.int32)
    seg = rng.integers(-1, N + 1, rows).astype(np.int32)
    ghw = np.stack([rng.normal(size=rows), rng.random(rows) * 0.25,
                    np.ones(rows)]).astype(np.float32)
    c, s, g = (torch.as_tensor(codes), torch.as_tensor(seg),
               torch.as_tensor(ghw))
    got = _grouped_hist_model(c, s, g, N, B1, bf16)
    want = build_histograms_plain(c, s, g.double(), N, B1, bf16)
    mass = build_histograms_plain(c, s, g.double().abs(), N, B1, bf16)
    assert bool(((got.double() - want).abs() <= 1e-4 + 1e-5 * mass).all())
    gi = torch.as_tensor(rng.integers(-8, 9, (3, rows)).astype(np.float32))
    assert torch.equal(_grouped_hist_model(c, s, gi, N, B1, False),
                       build_histograms_plain(c, s, gi, N, B1))
