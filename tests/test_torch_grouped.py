"""The node-grouped kernels' pieces on the CPU: the row grouping
(``common.group_rows_plain``) against numpy's stable argsort, the int8
grouping records (``common.pack_i8_records_plain``), the port's
three-term bf16 split against the JAX package's ``_split3_bf16``, and
models of the redesigned kernels held against the plain versions: the
grouped level body (csrc/level_grouped.cuh) as one-hot products of
bf16-valued operands grouped by parent, for the float [rows, F] adaptive
level (K8) and the packed level (K1/K3); its int8 instance (K7, K4) with
the kernel's PRMT one-hot selectors and m16n8k32 fragment layouts,
bit-equal to the plain int8 levels and to the TPU kernels in interpret
mode; and the global-sketch histogram (K11) as per-span partials merged
in slot order, with its fixed in-block order (record order per feature,
a bin's lanes summed in lane order). The CUDA kernels are held against
the plain versions in tests/test_torch_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.ops import hist_adaptive as jha
from h2o3_tpu_torch.ops import hist_adaptive as tha
from h2o3_tpu_torch.ops.common import (flush_i8, group_rows_plain,
                                       pack_i8_records_plain, split3_bf16)
from h2o3_tpu_torch.ops.histogram import build_histograms_plain
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)


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


# ------------------------------------- model of the grouped K8 and K1/K3


def _grouped_model(nid, ghw, can, route, bins_of, n_prev, N, base, W, F,
                   bf16, span=192, chunk=64):
    """What csrc/level_grouped.cuh computes, in torch, for a bin source
    given by two functions: ``route(r, k)``, the side (0 left, 1 right)
    of parent k's rows ``r``, and ``bins_of(r, node)``, their bins
    [len(r), F] under their level-local nodes (a bin outside [0, W) adds
    nothing). Rows grouped by parent (``can`` [n_prev]: which parents
    split), spans of a group's rows as blocks, chunks of 64 rows routed
    and binned, the histogram as one-hot x mass products of bf16-valued
    operands (one term at bf16, three at float32) added per chunk into
    float32, the blocks' [3, 2, F, W] partials summed per node in block
    order."""
    prev_base = base - n_prev
    G = n_prev + N
    lp = nid - prev_base
    lpc = lp.clamp(0, max(n_prev, 1) - 1).long()
    routed = (n_prev > 0) & (lp >= 0) & (lp < n_prev) & can[lpc]
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
                    slot = route(r, k)
                    nid_out[r] = (2 * (prev_base + k) + 1 + slot).int()
                node = c0 + slot
                live = (node >= 0) & (node < N)
                bins = bins_of(r, node.clamp(0, N - 1))
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
        lp = (cid - 1) // 2 - prev_base
        if n_prev > 0 and cid >= 1 and 0 <= lp < n_prev:
            srcs.append((lp, (cid - 1) % 2))
        srcs.append((n_prev + j, 0))
        for k, s in srcs:
            for kb, part in blocks:
                if kb == k:
                    hist[:, j] += part[:, s]
    return nid_out, hist


def _adaptive_src(x, tables, lo, inv, n_prev, W):
    """K8's bin source (AdaptiveBins) for the models: which parents split,
    the route by raw threshold, the bins under the child's range."""
    F = x.shape[1]

    def route(r, k):
        f = int(tables[0][k].clamp(0, F - 1))
        v = x[r, f]
        return torch.where(torch.isnan(v), tables[2][k] < 0.5,
                           v >= tables[1][k]).long()

    def bins_of(r, node):
        t = (x[r] - lo[node]) * inv[node]
        t = torch.where(torch.isnan(t), 0.0, t)
        bins = torch.floor(torch.clamp(t, 0.0, float(W - 2))).long()
        return torch.where(torch.isnan(x[r]), W - 1, bins)

    return tables[3][:max(n_prev, 1)] > 0.5, route, bins_of


def _binned_src(codes, tables, n_prev, W):
    """K1's bin source (CodeBins) for the models: routed by the code of
    the split feature against split_bin (NA = W-1 right unless na_left),
    the code itself the bin."""
    F = codes.shape[1]
    c = codes.long()

    def route(r, k):
        f = int(tables[0][k].clamp(0, F - 1))
        v = c[r, f]
        return torch.where(v == W - 1, tables[2][k] == 0,
                           v >= tables[1][k]).long()

    return tables[3][:max(n_prev, 1)] != 0, route, lambda r, node: c[r]


def _grouped_level_model(x, nid, ghw, tables, lo, inv, n_prev, N, base, W,
                         bf16, span=192, chunk=64):
    """The grouped K8 (AdaptiveBins): routed by raw threshold, binned
    under the child's range."""
    can, route, bins_of = _adaptive_src(x, tables, lo, inv, n_prev, W)
    return _grouped_model(nid, ghw, can, route, bins_of, n_prev, N, base, W,
                          x.shape[1], bf16, span, chunk)


def _grouped_binned_model(codes, nid, ghw, tables, n_prev, N, base, W, bf16,
                          span=192, chunk=64):
    """The grouped K1/K3 (CodeBins): the code is the bin."""
    can, route, bins_of = _binned_src(codes, tables, n_prev, W)
    return _grouped_model(nid, ghw, can, route, bins_of, n_prev, N, base, W,
                          codes.shape[1], bf16, span, chunk)


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


# ------------------------------------------ model of the grouped K1/K3


def _binned_inputs(rows, F, W, N, seed, int_ghw):
    """Packed codes (NA = W-1, and a few codes outside [0, W) that add
    nothing), nid in the previous level's window with 5% of the rows off
    every window, (g, h, w), int32 split tables."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, W - 1, size=(rows, F))
    codes[rng.random((rows, F)) < 0.06] = W - 1
    n_prev, base = N // 2, N - 1
    m = max(n_prev, 1)
    nid = (base - n_prev + rng.integers(0, m, rows)).astype(np.int32)
    nid[rng.random(rows) < 0.05] = 10 ** 6
    can = rng.random(m) < 0.8
    can[0] = True
    if int_ghw:
        g = rng.integers(-8, 9, rows).astype(np.float32)
        h = rng.integers(0, 4, rows).astype(np.float32)
    else:
        g = rng.normal(size=rows).astype(np.float32)
        h = (rng.random(rows) * 0.25).astype(np.float32)
    ghw = np.stack([g, h, np.ones(rows, np.float32)])
    tables = tha.make_tables(torch.as_tensor(rng.integers(0, F, m)),
                             torch.as_tensor(rng.integers(1, W - 1, m)),
                             torch.as_tensor(rng.random(m) < 0.5),
                             torch.as_tensor(can))
    return (torch.as_tensor(codes).to(tha.code_dtype(W)),
            torch.as_tensor(nid), torch.as_tensor(ghw), tables, n_prev, base)


@pytest.mark.parametrize("W", [16, 32, 256])
@pytest.mark.parametrize("N", [1, 8, 32])
@pytest.mark.parametrize("bf16", [False, True])
def test_grouped_binned_model_matches_plain(W, N, bf16):
    """The grouped K1/K3 within the kernels' float tolerance of the plain
    version accumulated in float64 (the plain version is held against the
    TPU kernel in interpret mode in tests/test_torch_hist_binned.py)."""
    c, nid, ghw, t, n_prev, base = _binned_inputs(1500, 5, W, N, W + N,
                                                  False)
    nid_m, hist_m = _grouped_binned_model(c, nid, ghw, t, n_prev, N, base,
                                          W, bf16)
    nid_p, hist_p = tha.binned_level_plain(c, nid, ghw.double(), t, n_prev,
                                           N, base, W, bf16)
    _n, mass = tha.binned_level_plain(c, nid, ghw.double().abs(), t, n_prev,
                                      N, base, W, bf16)
    assert torch.equal(nid_m, nid_p)
    assert bool(((hist_m.double() - hist_p).abs()
                 <= 1e-4 + 1e-5 * mass).all())


@pytest.mark.parametrize("W,N", [(16, 1), (16, 32), (32, 8), (256, 8),
                                 (32, 1), (64, 32), (128, 4), (256, 32)])
def test_grouped_binned_model_integer_mass_bit_equal(W, N):
    c, nid, ghw, t, n_prev, base = _binned_inputs(1500, 4, W, N, 3 * N + W,
                                                  True)
    nid_m, hist_m = _grouped_binned_model(c, nid, ghw, t, n_prev, N, base,
                                          W, False)
    nid_p, hist_p = tha.binned_level_plain(c, nid, ghw, t, n_prev, N, base,
                                           W)
    assert torch.equal(nid_m, nid_p)
    assert torch.equal(hist_m, hist_p)


def test_grouped_binned_model_leaves_out_codes_outside_the_lanes():
    """A code outside [0, W) (negative int8) adds nothing in the grouped
    form, as in the tiled body and the plain version's masked add."""
    c, nid, ghw, t, n_prev, base = _binned_inputs(600, 3, 16, 2, 5, True)
    c[::7, 1] = -3
    _n, hist_m = _grouped_binned_model(c, nid, ghw, t, n_prev, 2, base, 16,
                                       False)
    keep = c[:, 1] >= 0
    _n, hist_k = tha.binned_level_plain(c[keep], nid[keep], ghw[:, keep],
                                        t, n_prev, 2, base, 16)
    assert torch.equal(hist_m[:, :, 1], hist_k[:, :, 1])


# ---------------------------------- model of the wide K1 and K8 (W >= 64)


def _slot_merge(parts, warps=8):
    """merge_slots_kernel's order over one cell's source blocks ``parts``
    (in source, then block order): warp w sums blocks w, w + 8, ... of
    each source into one float32 sum, the warps' sums are added in warp
    order, and that total is added into the zeroed output."""
    s = [np.zeros_like(parts[0]) if parts else None for _ in range(warps)]
    if not parts:
        return None
    for i, p in enumerate(parts):
        s[i % warps] = s[i % warps] + p
    t = np.zeros_like(parts[0])
    for w in range(warps):
        t = t + s[w]
    return np.zeros_like(t) + t


def _wide_model(nid, ghw, can, route, bins_of, n_prev, N, base, W, F, bf16,
                span=192, chunk=64, fs=3):
    """What csrc/level_wide.cuh computes, in float32 and in its order, for
    a bin source given as in ``_grouped_model``: rows grouped by parent
    (ParentKey), spans of a group's records as blocks (``span`` records,
    whole chunks), feature slices of ``fs`` features, chunks of
    ``chunk`` records; per feature, 32 records at a time, each (child,
    bin) key's masses summed in lane (record) order and added into the
    cell; every other cell adds 0.0, which changes nothing. The blocks'
    [3, 2, F, W] partials are merged per cell in merge_slots_kernel's
    order (``_slot_merge``), the parent's group at the child's side
    first, then the node's direct group."""
    prev_base = base - n_prev
    G = n_prev + N
    lp = nid - prev_base
    lpc = lp.clamp(0, max(n_prev, 1) - 1).long()
    routed = (n_prev > 0) & (lp >= 0) & (lp < n_prev) & can[lpc]
    ln = nid - base
    direct = (ln >= 0) & (ln < N)
    key = torch.where(routed, lp, torch.where(direct, n_prev + ln, -1))
    offsets, idx = group_rows_plain(key.to(torch.int32), G)
    nid_out = nid.clone()
    m = ghw.to(torch.bfloat16).float() if bf16 else ghw.float()
    m = m.numpy()
    blocks = {k: [] for k in range(G)}
    for k in range(G):
        members = idx[offsets[k]:offsets[k + 1]].long()
        parent = k < n_prev
        c0 = 2 * (prev_base + k) + 1 - base if parent else k - n_prev
        for s0 in range(0, len(members), span):
            r = members[s0:s0 + span]
            slot = torch.zeros(len(r), dtype=torch.long)
            if parent:
                slot = route(r, k)
                nid_out[r] = (2 * (prev_base + k) + 1 + slot).int()
            node = c0 + slot
            live = (node >= 0) & (node < N)
            bins = bins_of(r, node.clamp(0, N - 1))
            keys = torch.where(live[:, None] & (bins >= 0) & (bins < W),
                               slot[:, None] * W + bins, -1).numpy()
            mr = m[:, r.numpy()]
            part = np.zeros((3, F, 2 * W), np.float32)
            for f0 in range(0, F, fs):                 # feature slices
                fi = np.arange(f0, min(f0 + fs, F))
                for c in range(0, len(r), chunk):
                    for j0 in range(c, min(c + chunk, len(r)), 32):
                        j1 = min(j0 + 32, c + chunk, len(r))
                        tmp = np.zeros((3, len(fi), 2 * W), np.float32)
                        for j in range(j0, j1):        # lane order
                            kf = keys[j, fi]
                            ok = kf >= 0
                            sel = np.arange(len(fi))[ok]
                            tmp[:, sel, kf[ok]] = (tmp[:, sel, kf[ok]]
                                                   + mr[:, j][:, None])
                        part[:, fi] = part[:, fi] + tmp
            # [3, F, 2, W] -> the slot layout [3, 2, F, W]
            blocks[k].append(part.reshape(3, F, 2, W).transpose(0, 2, 1, 3))
    hist = np.zeros((3, N, F, W), np.float32)
    for j in range(N):
        cid = base + j
        parts = []
        lpj = (cid - 1) // 2 - prev_base
        if n_prev > 0 and cid >= 1 and 0 <= lpj < n_prev:
            parts += [p[:, (cid - 1) % 2] for p in blocks[lpj]]
        parts += [p[:, 0] for p in blocks[n_prev + j]]
        if parts:
            hist[:, j] = _slot_merge(parts)
    return nid_out, torch.as_tensor(hist)


def _wide_case(kind, W, N, int_ghw, seed, bf16, rows=1800, F=4):
    """One level's inputs (packed codes, int16 at W = 256, or raw
    features), run through the wide model. Returns (nid_m, hist_m,
    plain): ``plain(ghw)`` is the plain version of the level on masses
    ``ghw``, and ghw the level's masses."""
    if kind == "binned":
        c, nid, ghw, t, n_prev, base = _binned_inputs(rows, F, W, N, seed,
                                                      int_ghw)
        assert c.dtype == (torch.int16 if W == 256 else torch.int8)
        can, route, bins_of = _binned_src(c, t, n_prev, W)

        def plain(g):
            return tha.binned_level_plain(c, nid, g, t, n_prev, N, base, W,
                                          bf16)
    else:
        x, nid, ghw, t, lo, inv, n_prev, base = _level_inputs(
            rows, F, W, N, seed, int_ghw)
        can, route, bins_of = _adaptive_src(x, t, lo, inv, n_prev, W)

        def plain(g):
            return tha.adaptive_level_plain(x, nid, g, t, lo, inv, n_prev,
                                            N, base, W, bf16)
    nid_m, hist_m = _wide_model(nid, ghw, can, route, bins_of, n_prev, N,
                                base, W, F, bf16)
    return nid_m, hist_m, ghw, plain


@pytest.mark.parametrize("kind", ["binned", "adaptive"])
@pytest.mark.parametrize("W", [64, 128, 256])
@pytest.mark.parametrize("N", [1, 8, 32])
@pytest.mark.parametrize("bf16", [False, True])
def test_wide_model_matches_plain(kind, W, N, bf16):
    """The wide body's order within the kernels' float tolerance of the
    plain version accumulated in float64 (float32 masses added unrounded,
    bf16 masses rounded at staging)."""
    nid_m, hist_m, ghw, plain = _wide_case(kind, W, N, False, 5 * W + N,
                                           bf16)
    nid_p, hist_p = plain(ghw.double())
    _n, mass = plain(ghw.double().abs())
    assert torch.equal(nid_m, nid_p)
    assert float(mass.sum()) > 0
    assert bool(((hist_m.double() - hist_p).abs()
                 <= 1e-4 + 1e-5 * mass).all())


@pytest.mark.parametrize("kind", ["binned", "adaptive"])
@pytest.mark.parametrize("W", [64, 128, 256])
@pytest.mark.parametrize("N", [1, 8, 32])
def test_wide_model_integer_mass_bit_equal(kind, W, N):
    nid_m, hist_m, ghw, plain = _wide_case(kind, W, N, True, 3 * N + W,
                                           False)
    nid_p, hist_p = plain(ghw)
    assert torch.equal(nid_m, nid_p)
    assert torch.equal(hist_m, hist_p)


@pytest.mark.parametrize("W", [64, 256])
def test_wide_model_leaves_out_codes_outside_the_lanes(W):
    """A code outside [0, W) (negative int8 / int16) adds nothing in the
    wide form, as in the other forms and the plain version's masked
    add."""
    c, nid, ghw, t, n_prev, base = _binned_inputs(900, 3, W, 2, 5, True)
    c[::7, 1] = -3
    can, route, bins_of = _binned_src(c, t, n_prev, W)
    _n, hist_m = _wide_model(nid, ghw, can, route, bins_of, n_prev, 2, base,
                             W, 3, False)
    keep = c[:, 1] >= 0
    _n, hist_k = tha.binned_level_plain(c[keep], nid[keep], ghw[:, keep],
                                        t, n_prev, 2, base, W)
    assert torch.equal(hist_m[:, :, 1], hist_k[:, :, 1])
    _n, hist_all = tha.binned_level_plain(c.clamp(0), nid, ghw, t, n_prev,
                                          2, base, W)
    assert torch.equal(hist_m[:, :, 0], hist_all[:, :, 0])


def test_slot_merge_order():
    """The merge adds each warp's blocks, then the warps in order: with
    masses whose float32 sum depends on the order, its result is that
    order's and not the block order's."""
    parts = [np.float32(v) for v in
             (1e8, 1.0, -1e8, 1.0, 3.0, 0.5, 0.25, 7.0, 1.0, 1.0)]
    want = [np.float32(0)] * 8
    for i, p in enumerate(parts):
        want[i % 8] = np.float32(want[i % 8] + p)
    t = np.float32(0)
    for w in want:
        t = np.float32(t + w)
    got = _slot_merge([np.array(p) for p in parts])
    assert got == t
    seq = np.float32(0)
    for p in parts:
        seq = np.float32(seq + p)
    assert got != seq


# ------------------------- model of the int8 wide K4 and K7 (W >= 64)

_WIDE_TWO_PER_SM = (233472 - 2 * 1024) // 2   # kWideTwoPerSm


def _wide_smem(fs, W, ranges, planes, stage_bytes, walk):
    """csrc/level_wide.cuh ``wide_smem``: the partial (4-byte sums, to 16
    bytes), two chunks' staged masses, the children's ranges, two chunks'
    keys, the walking consumers' tags."""
    stride = 2 * W + 1
    return ((planes * fs * stride + 3) // 4 * 16 + 2 * 256 * stage_bytes
            + (16 * fs if ranges else 0) + 2 * fs * 256 * 2
            + (min(fs, 8) * 2 * W if walk else 0))


def _wide_plan_fs(F, W, ranges, terms=0):
    """``plan_wide``'s features a slice: as many as let two blocks share
    an SM; ``terms`` 0 is the float mass (three planes, a float4 staged a
    record, tags), 1 or 2 the int8 mass (3·terms planes, the q words
    staged, no walk)."""
    planes, stage, walk = ((3, 16, True) if terms == 0
                           else (3 * terms, 4 * terms, False))
    slices = 1
    while slices < F and _wide_smem(-(-F // slices), W, ranges, planes,
                                    stage, walk) > _WIDE_TWO_PER_SM:
        slices += 1
    return -(-F // slices)


@pytest.mark.parametrize("W,terms,ranges,fs", [
    (256, 0, False, 14), (128, 0, False, 14), (64, 0, False, 28),
    (256, 1, False, 14), (256, 2, False, 7), (128, 2, False, 14),
    (64, 1, True, 28), (64, 2, True, 14), (256, 2, True, 7)])
def test_wide_plan_slices(W, terms, ranges, fs):
    """The wide body's slices at 28 features: the float mass and the int8
    one at one term take 6,156 bytes a feature at W = 256, so 14 features
    a slice keep two blocks an SM; two terms double the planes (7)."""
    assert _wide_plan_fs(28, W, ranges, terms) == fs
    planes, stage = (3, 16) if terms == 0 else (3 * terms, 4 * terms)
    assert _wide_smem(fs, W, ranges, planes, stage,
                      terms == 0) <= _WIDE_TWO_PER_SM


def _wide_i8_model(nid, q, scales, can, route, bins_of, n_prev, N, base, W,
                   F, fs, span=512, chunk=256):
    """What csrc/level_wide.cuh computes with the int8 mass (I8Mass), in
    numpy: rows grouped by parent (``can``: which parents split), the
    grouping pass's int8 records (row id, then the q bytes), spans of a
    group's records as blocks, each with slices of ``fs`` features;
    chunks of 256 records routed (``route(r, k)``: the side of parent k's
    rows r) and keyed child * W + bin (``bins_of(r, node)``; no key off
    the window or outside [0, W)), each record's 3·terms q bytes,
    sign-extended one by one, added into its cells of an int32 partial
    [3·terms][fs][2W + 1] (integer sums: any order). Each (span, slice)
    block writes its features into its span's slot of the flat buffer
    [b][3·terms][2][F][W], and the merge (GroupedSrc over the slots, in
    bstart's spans) sums a cell's slots, the parent's group at the
    child's side and then the node's direct group, and flushes to float32
    as MergeFlushI8 does."""
    P = q.shape[0]
    terms = P // 3
    prev_base = base - n_prev
    G = n_prev + N
    lp = nid - prev_base
    lpc = lp.clamp(0, max(n_prev, 1) - 1).long()
    routed = (n_prev > 0) & (lp >= 0) & (lp < n_prev) & can[lpc]
    ln = nid - base
    direct = (ln >= 0) & (ln < N)
    key = torch.where(routed, lp, torch.where(direct, n_prev + ln, -1))
    offsets, idx = group_rows_plain(key.to(torch.int32), G)
    recs = pack_i8_records_plain(q, idx[:int(offsets[-1])]).numpy()
    nid_out = nid.clone()
    fw = F * W
    bstride = 2 * P * fw
    bstart, spans = [], []
    for k in range(G):
        o0, o1 = int(offsets[k]), int(offsets[k + 1])
        bstart.append(len(spans))
        spans += [(k, s0, min(s0 + span, o1)) for s0 in range(o0, o1, span)]
    bstart.append(len(spans))
    part = np.zeros(max(len(spans), 1) * bstride, np.int64)
    for b, (k, s0, s1) in enumerate(spans):
        rc = recs[s0:s1]
        r = torch.as_tensor(rc[:, 0].astype(np.int64))
        parent = k < n_prev
        c0 = 2 * (prev_base + k) + 1 - base if parent else k - n_prev
        side = torch.zeros(len(r), dtype=torch.long)
        if parent:
            side = route(r, k)
            nid_out[r] = (2 * (prev_base + k) + 1 + side).int()
        node = c0 + side
        live = ((node >= 0) & (node < N)).numpy()
        bins = bins_of(r, node.clamp(0, N - 1)).numpy()
        keys = np.where(live[:, None] & (bins >= 0) & (bins < W),
                        side.numpy()[:, None] * W + bins, -1)
        m = np.stack([_rec_mass(rc, p) for p in range(P)]).astype(np.int64)
        for f0 in range(0, F, fs):                   # the span's slices
            ft = min(fs, F - f0)
            s_hist = np.zeros((P, fs, 2 * W + 1), np.int64)
            for c in range(0, len(r), chunk):
                for fl in range(ft):
                    kf = keys[c:c + chunk, f0 + fl]
                    ok = kf >= 0
                    for p in range(P):
                        np.add.at(s_hist[p, fl], kf[ok],
                                  m[p, c:c + chunk][ok])
            assert np.abs(s_hist).max(initial=0) < 2 ** 31
            # pb[(cs * F + f0 + fl) * W + bin], cs = plane * 2 + child
            for cs in range(2 * P):
                for fl in range(ft):
                    o = b * bstride + (cs * F + f0 + fl) * W
                    part[o:o + W] = s_hist[cs >> 1, fl,
                                           (cs & 1) * W:(cs & 1) * W + W]
    total = np.zeros((P, N * fw), np.int64)
    for plane in range(P):
        for j in range(N):
            cid = base + j
            srcs = []
            lpj = (cid - 1) // 2 - prev_base
            if n_prev > 0 and cid >= 1 and 0 <= lpj < n_prev:
                srcs.append((lpj, (2 * plane + (cid - 1) % 2) * fw))
            srcs.append((n_prev + j, 2 * plane * fw))
            for g, o in srcs:
                for b in range(bstart[g], bstart[g + 1]):
                    total[plane, j * fw:(j + 1) * fw] += \
                        part[b * bstride + o:b * bstride + o + fw]
    assert np.abs(total).max(initial=0) < 2 ** 31
    # MergeFlushI8: s_c * f32(t0), or s_c * (256 * f32(t0) + f32(t1))
    t = total.astype(np.float32).reshape(3, terms, N, F, W)
    v = t[:, 0] if terms == 1 else np.float32(256.0) * t[:, 0] + t[:, 1]
    s = scales.numpy().astype(np.float32).reshape(3, 1, 1, 1)
    return nid_out, torch.as_tensor((s * v).astype(np.float32))


def _wide_i8_case(kind, W, N, terms, seed, rows=1300, F=5, fs=2):
    """A level's inputs (rows off every window; packed codes, int16 at
    W = 256, or raw features) with q from quantize_ghw_i8; returns the
    int8 wide model's and the plain int8 level's (nid, hist)."""
    if kind == "binned":
        c, nid, ghw, t, n_prev, base = _binned_inputs(rows, F, W, N, seed,
                                                      False)
        can, route, bins_of = _binned_src(c, t, n_prev, W)
        q, s = tha.quantize_ghw_i8(ghw, terms)
        plain = tha.binned_level_i8_plain(c, nid, q, s, t, n_prev, N, base,
                                          W)
    else:
        x, nid, ghw, t, lo, inv, n_prev, base = _level_inputs(
            rows, F, W, N, seed, False)
        can, route, _b = _adaptive_src(x, t, lo, inv, n_prev, W)

        def bins_of(r, node):
            return tha.adaptive_bins_plain(x[r], node.int(), lo, inv, N, 0,
                                           W)
        q, s = tha.quantize_ghw_i8(ghw, terms)
        plain = tha.adaptive_level_i8_plain(x, nid, q, s, t, lo, inv, n_prev,
                                            N, base, W)
    model = _wide_i8_model(nid, q, s, can, route, bins_of, n_prev, N, base,
                           W, F, fs)
    return model, plain


@pytest.mark.parametrize("kind", ["binned", "adaptive"])
@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("W", [64, 128, 256])
@pytest.mark.parametrize("N", [1, 8, 32])
def test_wide_i8_model_matches_plain_bit_for_bit(kind, terms, W, N):
    """The int8 wide body (slices, the slot layout, the merge and its
    flush) gives the plain int8 level's nid and histogram bit for bit."""
    (nid_m, hist_m), (nid_p, hist_p) = _wide_i8_case(kind, W, N, terms,
                                                     13 * W + N + terms)
    assert torch.equal(nid_m, nid_p)
    assert hist_m.dtype == torch.float32
    assert float(hist_p.abs().sum()) > 0
    assert torch.equal(hist_m, hist_p)


@pytest.mark.parametrize("terms", [1, 2])
def test_wide_i8_model_leaves_out_codes_outside_the_lanes(terms):
    """A code outside [0, W) (negative, or past the lanes of int16 codes)
    adds nothing in the int8 wide form, as in the other forms; the other
    features see every row."""
    W = 256
    c, nid, ghw, t, n_prev, base = _binned_inputs(900, 3, W, 2, 5, False)
    c[::7, 1] = -3
    c[3::11, 1] = 300
    q, s = tha.quantize_ghw_i8(ghw, terms)
    can, route, bins_of = _binned_src(c, t, n_prev, W)
    _n, hist_m = _wide_i8_model(nid, q, s, can, route, bins_of, n_prev, 2,
                                base, W, 3, 2)
    keep = (c[:, 1] >= 0) & (c[:, 1] < W)
    _n, hist_k = tha.binned_level_i8_plain(c[keep], nid[keep], q[:, keep], s,
                                           t, n_prev, 2, base, W)
    assert torch.equal(hist_m[:, :, 1], hist_k[:, :, 1])
    # the same routes (feature 1 may be the split feature), codes in lanes
    c_in = c.clone()
    c_in[:, 1] = torch.where(c[:, 1] < 0, 0, torch.where(c[:, 1] >= W, W - 2,
                                                        c[:, 1]))
    _n, hist_all = tha.binned_level_i8_plain(c_in, nid, q, s, t, n_prev, 2,
                                             base, W)
    assert torch.equal(hist_m[:, :, 0], hist_all[:, :, 0])
    assert torch.equal(hist_m[:, :, 2], hist_all[:, :, 2])


# ----------------------------------- model of K11's fixed in-block order


def _fixed_order_hist_model(codes, seg, ghw, N, B1, bf16, span=700,
                            chunk=512):
    """What csrc/hist_global.cu's grouped form adds within a block, in
    float32 and in its order: rows grouped by node, spans of a node's
    rows as blocks; per chunk of 512 records and per feature, 32 records
    at a time, the records of each bin summed in record (lane) order and
    added into the bin; the blocks' partials summed in span order."""
    offsets, idx = group_rows_plain(seg, N)
    F = codes.shape[1]
    c = codes.numpy().astype(np.int64)
    m = ghw.numpy().astype(np.float32)
    if bf16:
        m = ghw.to(torch.bfloat16).float().numpy()
    out = np.zeros((3, N, F, B1), np.float32)
    for j in range(N):
        members = idx[offsets[j]:offsets[j + 1]].long().numpy()
        for s0 in range(0, len(members), span):
            part = np.zeros((3, F, B1), np.float32)
            rows = members[s0:s0 + span]
            for c0 in range(0, len(rows), chunk):
                for f in range(F):
                    for j0 in range(c0, min(c0 + chunk, len(rows)), 32):
                        batch = rows[j0:min(j0 + 32, c0 + chunk, len(rows))]
                        cb = c[batch, f]
                        for b in np.unique(cb[(cb >= 0) & (cb < B1)]):
                            s = np.zeros(3, np.float32)
                            for r in batch[cb == b]:
                                s = s + m[:, r]
                            part[:, f, b] = part[:, f, b] + s
            out[:, j] += part
    return torch.as_tensor(out)


@pytest.mark.parametrize("B1,N", [(15, 1), (15, 8), (301, 4), (257, 2)])
@pytest.mark.parametrize("bf16", [False, True])
def test_fixed_order_hist_model_matches_plain(B1, N, bf16):
    rng = np.random.default_rng(3 * B1 + N)
    rows, F = 3000, 3
    codes = rng.integers(0, B1, size=(rows, F)).astype(np.int32)
    seg = rng.integers(-1, N + 1, rows).astype(np.int32)
    ghw = np.stack([rng.normal(size=rows), rng.random(rows) * 0.25,
                    np.ones(rows)]).astype(np.float32)
    c, s, g = (torch.as_tensor(codes), torch.as_tensor(seg),
               torch.as_tensor(ghw))
    got = _fixed_order_hist_model(c, s, g, N, B1, bf16)
    want = build_histograms_plain(c, s, g.double(), N, B1, bf16)
    mass = build_histograms_plain(c, s, g.double().abs(), N, B1, bf16)
    assert bool(((got.double() - want).abs() <= 1e-4 + 1e-5 * mass).all())
    gi = torch.as_tensor(rng.integers(-8, 9, (3, rows)).astype(np.float32))
    assert torch.equal(_fixed_order_hist_model(c, s, gi, N, B1, False),
                       build_histograms_plain(c, s, gi, N, B1))


# ------------------------------------ model of the grouped K7 and K4 (int8)


def _prmt(lo, hi, sel):
    """PTX ``prmt.b32`` in its default mode, elementwise on int64 arrays
    of 32-bit values: byte i of the result is byte (nibble i & 7) of
    {hi, lo} (lo the bytes 0..3), or, where nibble i has its msb set,
    that byte's sign replicated over all eight bits."""
    src = np.stack(np.broadcast_arrays(
        *[(lo >> (8 * j)) & 0xFF for j in range(4)],
        *[(hi >> (8 * j)) & 0xFF for j in range(4)], sel))[:8]
    out = np.zeros(np.shape(src[0]), np.int64)
    for i in range(4):
        n = (sel >> (4 * i)) & 0xF
        byte = np.take_along_axis(src, (n & 7)[None], 0)[0]
        byte = np.where(n & 8, np.where(byte & 0x80, 0xFF, 0), byte)
        out |= byte << (8 * i)
    return out


def _selectors(bins, W):
    """The int8 body's bin buffer of one chunk: for bins [chunk, F] (any
    value outside [0, W) adds nothing), per (feature, m-tile, quad of 4
    rows) a word whose bits 15:0 hold each row's nibble in the m-tile's
    lower octet and 31:16 in its upper: the bin's place in the octet, or
    8 where the bin lies outside it."""
    F, MT = bins.shape[1], W // 16
    sel = np.full((F, MT, bins.shape[0] // 4), 0x88888888, np.int64)
    for i in range(4):
        b = bins[i::4].T                                # [F, quads]
        ok = (b >= 0) & (b < W)
        d = ((b & 7) ^ 8) << ((b & 8) * 2 + 4 * i)
        for p in range(MT):
            sel[:, p] ^= np.where(ok & (b >> 4 == p), d, 0)
    return sel


def _swar_selectors(bins, W):
    """The int8 body's bin buffer of one chunk for byte codes, as its SWAR
    path builds it: per (feature, quad) the four rows' code bytes (0xFF
    for a row that adds nothing), per m-tile XORed with 16·mt; a byte
    below 16 gives its low nibble to the lower octet's half and that
    nibble ^ 8 to the upper's, any other byte bit 3 in both."""
    F, MT = bins.shape[1], W // 16
    byte = np.where(bins == -1, 0xFF, bins & 0xFF)     # [chunk, F]
    x = sum(byte[i::4].T.astype(np.int64) << (8 * i) for i in range(4))
    sel = np.zeros((F, MT, bins.shape[0] // 4), np.int64)
    for p in range(MT):
        xp = x ^ (0x10101010 * p)
        h = (xp >> 4) & 0x0F0F0F0F
        out = ((h + 0x07070707) | h) & 0x08080808
        n = xp & 0x0F0F0F0F
        lo, hi = n | out, (n ^ 0x08080808) | out
        ylo, yhi = lo | (lo >> 4), hi | (hi >> 4)
        sel[:, p] = (ylo & 0xFF) | ((ylo >> 8) & 0xFF00) | \
            ((yhi & 0xFF) << 16) | ((yhi & 0xFF0000) << 8)
    return sel


def _rec_mass(recs, p):
    """q[p] of int8 records (``pack_i8_records_plain``), as the kernel's
    ``QRec::mass`` reads it: byte p % 4 of word 1 + p // 4."""
    w = recs[:, 1 + p // 4].astype(np.int64) & 0xFFFFFFFF
    return ((w >> (8 * (p % 4))) & 0xFF).astype(np.uint8).astype(np.int8)


_LANE = np.arange(32)
_G8, _T4 = _LANE >> 2, _LANE & 3
# each lane's one-hot table: byte g8 of {hi, lo} is 1
_TLO = np.where(_G8 < 4, 1 << (8 * np.minimum(_G8, 3)), 0).astype(np.int64)
_THI = np.where(_G8 < 4, 0, 1 << (8 * np.maximum(_G8 - 4, 0))).astype(
    np.int64)


def _chunk_products(sel, frag, NT):
    """One chunk's int8 products as the kernel's warps form them: per unit
    (feature, m-tile) and k-step, the A fragment (16 bins x 32 rows) from
    four PRMTs of each lane's two selector words, the B fragment (32 rows
    x 8 columns) of each term from the staged bytes in lane order, the
    s8 x s8 -> s32 product, read back in the C fragment's layout. Returns
    [F, MT, NT, 32 lanes, 4] int64."""
    F, MT = sel.shape[:2]
    out = np.zeros((F, MT, NT, 32, 4), np.int64)
    for ks in range(sel.shape[2] // 8):
        wa = sel[:, :, ks * 8 + _T4]                   # [F, MT, 32]
        wb = sel[:, :, ks * 8 + 4 + _T4]
        regs = [_prmt(_TLO, _THI, wa & 0xFFFF), _prmt(_TLO, _THI, wa >> 16),
                _prmt(_TLO, _THI, wb & 0xFFFF), _prmt(_TLO, _THI, wb >> 16)]
        A = np.zeros((F, MT, 16, 32), np.int64)
        for j, reg in enumerate(regs):
            for i in range(4):
                byte = ((reg >> (8 * i)) & 0xFF).astype(np.uint8)
                A[:, :, _G8 + 8 * (j & 1), _T4 * 4 + i + 16 * (j >> 1)] = \
                    byte.astype(np.int8)
        for n in range(NT):
            B = np.zeros((32, 8), np.int64)
            for reg in range(2):
                words = frag[((ks * NT + n) * 32 + _LANE) * 2 + reg]
                for i in range(4):
                    B[_T4 * 4 + i + 16 * reg, _G8] = words[:, i]
            D = A @ B                                   # [F, MT, 16, 8]
            for e in range(4):
                out[:, :, n, :, e] += D[:, :, _G8 + (e >> 1) * 8,
                                        2 * _T4 + (e & 1)]
    return out


def _grouped_i8_model(nid, q, scales, can, route, bins_of, n_prev, N, base,
                      W, F, span=256, chunk=128, swar=False):
    """What csrc/level_grouped.cuh computes with its int8 mass policy
    (I8Mass), in numpy: rows grouped by parent (``can``: which parents
    split), int8 records from the grouping pass, spans of a group's
    records as blocks, chunks of 128 records routed (``route(r, k)``: the
    side of parent k's rows r), their masses staged as bytes in the B
    fragments' lane order (one n-tile per term), their bins
    (``bins_of(r, node)``) as PRMT selectors, the chunk's m16n8k32 s8
    products added into int32 registers, the blocks' [3·terms, 2, F, W]
    int32 partials summed per node and flushed to float32. ``swar``: the
    selectors of byte codes as the kernel's SWAR path builds them (a row
    that adds nothing: bin -1, byte 0xFF)."""
    NT = q.shape[0] // 3
    MT = W // 16
    prev_base = base - n_prev
    G = n_prev + N
    lp = nid - prev_base
    lpc = lp.clamp(0, max(n_prev, 1) - 1).long()
    routed = (n_prev > 0) & (lp >= 0) & (lp < n_prev) & can[lpc]
    ln = nid - base
    direct = (ln >= 0) & (ln < N)
    key = torch.where(routed, lp, torch.where(direct, n_prev + ln, -1))
    offsets, idx = group_rows_plain(key.to(torch.int32), G)
    recs = pack_i8_records_plain(q, idx[:int(offsets[-1])]).numpy()
    nid_out = nid.clone()
    blocks = []
    for k in range(G):
        o0, o1 = int(offsets[k]), int(offsets[k + 1])
        parent = k < n_prev
        c0 = 2 * (prev_base + k) + 1 - base if parent else k - n_prev
        for s0 in range(o0, o1, span):
            acc = np.zeros((F, MT, NT, 32, 4), np.int64)
            for ch in range(s0, min(s0 + span, o1), chunk):
                rc = recs[ch:min(ch + chunk, s0 + span, o1)]
                r = torch.as_tensor(rc[:, 0].astype(np.int64))
                side = torch.zeros(len(r), dtype=torch.long)
                if parent:
                    side = route(r, k)
                    nid_out[r] = (2 * (prev_base + k) + 1 + side).int()
                node = c0 + side
                live = ((node >= 0) & (node < N)).numpy()
                slot = np.where(live, side.numpy(), -1)
                # -1: a row that adds nothing (past the span, or its child
                # off the window); a live code of -1 is kept apart as 255
                # would be its byte anyway
                bins = np.full((chunk, F), -1, np.int64)
                bins[:len(r)] = np.where(
                    live[:, None], bins_of(r, node.clamp(0, N - 1)).numpy(),
                    -1)
                frag = np.zeros((chunk // 32 * NT * 64, 4),
                                np.int64)               # [words, bytes]
                t = np.arange(len(r))
                ks, kk = t >> 5, t & 31
                t4, reg, byte = (kk & 15) >> 2, kk >> 4, kk & 3
                for n in range(NT):
                    for col in range(8):
                        val = np.zeros(len(r), np.int64)
                        if col < 6:
                            val = np.where(slot == col // 3,
                                           _rec_mass(rc, (col % 3) * NT + n),
                                           0)
                        word = ((ks * NT + n) * 32 + col * 4 + t4) * 2 + reg
                        frag[word, byte] = val
                sel = (_swar_selectors if swar else _selectors)(bins, W)
                acc += _chunk_products(sel, frag, NT)
            part = np.zeros((3 * NT, 2, F, W), np.int64)
            for e in range(4):
                col = 2 * _T4 + (e & 1)
                keep = col < 6
                row = _G8 + (e >> 1) * 8
                for n in range(NT):
                    for mt in range(MT):
                        part[((col % 3) * NT + n)[keep], (col // 3)[keep], :,
                             mt * 16 + row[keep]] = \
                            acc[:, mt, n, keep, e].T
            # the kernel's int32 partial holds it exactly
            assert np.abs(part).max(initial=0) < 2 ** 31
            blocks.append((k, part))
    total = np.zeros((3 * NT, N, F, W), np.int64)
    for j in range(N):
        cid = base + j
        srcs = []
        lpj = (cid - 1) // 2 - prev_base
        if n_prev > 0 and cid >= 1 and 0 <= lpj < n_prev:
            srcs.append((lpj, (cid - 1) % 2))
        srcs.append((n_prev + j, 0))
        for kk_, sd in srcs:
            for kb, part in blocks:
                if kb == kk_:
                    total[:, j] += part[:, sd]
    return nid_out, flush_i8(torch.as_tensor(total), scales)


def _grouped_i8_level_model(x, nid, q, scales, tables, lo, inv, n_prev, N,
                            base, W):
    """The grouped K7 (AdaptiveBins): routed by raw threshold, binned
    under the child's range."""
    F = x.shape[1]

    def route(r, k):
        f = int(tables[0][k].clamp(0, F - 1))
        v = x[r, f]
        return torch.where(torch.isnan(v), tables[2][k] < 0.5,
                           v >= tables[1][k]).long()

    def bins_of(r, node):
        return tha.adaptive_bins_plain(x[r], node.int(), lo, inv, N, 0, W)

    can = tables[3][:max(n_prev, 1)] > 0.5
    return _grouped_i8_model(nid, q, scales, can, route, bins_of, n_prev, N,
                             base, W, F)


def _grouped_i8_binned_model(codes, nid, q, scales, tables, n_prev, N, base,
                             W):
    """The grouped K4 (CodeBins): the code of the split feature against
    split_bin, the code itself the bin."""
    F = codes.shape[1]
    c = codes.long()

    def route(r, k):
        f = int(tables[0][k].clamp(0, F - 1))
        v = c[r, f]
        return torch.where(v == W - 1, tables[2][k] == 0,
                           v >= tables[1][k]).long()

    can = tables[3][:max(n_prev, 1)] != 0
    return _grouped_i8_model(nid, q, scales, can, route, lambda r, node: c[r],
                             n_prev, N, base, W, F,
                             swar=codes.dtype == torch.int8)


def _i8_case(kind, W, N, terms, seed, rows=1300, F=3):
    """A level's inputs (rows off every window) with q from
    quantize_ghw_i8; returns (model, plain) results."""
    if kind == "binned":
        c, nid, ghw, t, n_prev, base = _binned_inputs(rows, F, W, N, seed,
                                                      False)
        q, s = tha.quantize_ghw_i8(ghw, terms)
        return (_grouped_i8_binned_model(c, nid, q, s, t, n_prev, N, base, W),
                tha.binned_level_i8_plain(c, nid, q, s, t, n_prev, N, base,
                                          W))
    x, nid, ghw, t, lo, inv, n_prev, base = _level_inputs(rows, F, W, N,
                                                          seed, False)
    q, s = tha.quantize_ghw_i8(ghw, terms)
    return (_grouped_i8_level_model(x, nid, q, s, t, lo, inv, n_prev, N, base,
                                    W),
            tha.adaptive_level_i8_plain(x, nid, q, s, t, lo, inv, n_prev, N,
                                        base, W))


@pytest.mark.parametrize("kind", ["binned", "adaptive"])
@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("W", [16, 32, 256])
@pytest.mark.parametrize("N", [1, 8, 32])
def test_grouped_i8_model_matches_plain_bit_for_bit(kind, terms, W, N):
    """The int8 grouped body (its selectors, fragments and flush) gives
    the plain int8 level's nid and histogram bit for bit."""
    (nid_m, hist_m), (nid_p, hist_p) = _i8_case(kind, W, N, terms,
                                                7 * W + N + terms)
    assert torch.equal(nid_m, nid_p)
    assert hist_m.dtype == torch.float32
    assert torch.equal(hist_m, hist_p)


@pytest.mark.parametrize("kind", ["binned", "adaptive"])
@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("W,N", [(16, 8), (32, 1)])
def test_grouped_i8_model_matches_pallas_interpret(kind, terms, W, N):
    """The int8 grouped body against the TPU kernels (``_kernel_bt_i8``,
    ``_kernel_t_i8``) run in interpret mode on the same inputs."""
    rng = np.random.default_rng(11 * W + N + terms)
    rows, F = 2048, 4
    n_prev, base = N // 2, N - 1
    m = max(n_prev, 1)
    nid = (base - n_prev + rng.integers(0, m, rows)).astype(np.int32)
    nid[rng.random(rows) < 0.05] = base + N + 7
    ghw = np.stack([rng.normal(size=rows), rng.random(rows) * 0.25,
                    np.ones(rows)]).astype(np.float32)
    feat = rng.integers(0, F, m).astype(np.float32)
    nal = (rng.random(m) < 0.5).astype(np.float32)
    can = (rng.random(m) < 0.8).astype(np.float32)
    can[0] = 1.0
    qj, sj = jha.quantize_ghw_i8(jnp.asarray(ghw), terms=terms)
    q, s = tha.quantize_ghw_i8(torch.as_tensor(ghw), terms)
    if kind == "binned":
        codes = rng.integers(0, W - 1, size=(rows, F)).astype(np.int8)
        codes[rng.random((rows, F)) < 0.07] = W - 1
        tab = (feat, rng.integers(1, W - 1, m).astype(np.float32), nal, can)
        nid_j, hist_j = jha.binned_level_tpu_i8(
            jnp.asarray(codes.T.copy()), jnp.asarray(nid), qj, sj,
            tuple(jnp.asarray(v) for v in tab), n_prev, N, base, W,
            tile=1024, interpret=True)
        nid_m, hist_m = _grouped_i8_binned_model(
            torch.as_tensor(codes), torch.as_tensor(nid), q, s,
            tha.make_tables(*(torch.as_tensor(v) for v in tab)), n_prev, N,
            base, W)
    else:
        x = rng.normal(size=(rows, F)).astype(np.float32)
        x[rng.random((rows, F)) < 0.06] = np.nan
        tab = (feat, rng.normal(size=m).astype(np.float32), nal, can)
        lo = (rng.normal(size=(N, F)) - 3).astype(np.float32)
        inv = np.full((N, F), (W - 2) / 6.0, np.float32)
        nid_j, hist_j = jha.adaptive_level_tpu_i8(
            jnp.asarray(x.T.copy()), jnp.asarray(nid), qj, sj,
            tuple(jnp.asarray(v) for v in tab), jnp.asarray(lo),
            jnp.asarray(inv), n_prev, N, base, W, tile=1024, interpret=True)
        nid_m, hist_m = _grouped_i8_level_model(
            torch.as_tensor(x), torch.as_tensor(nid), q, s,
            tha.make_adaptive_tables(*(torch.as_tensor(v) for v in tab)),
            torch.as_tensor(lo), torch.as_tensor(inv), n_prev, N, base, W)
    np.testing.assert_array_equal(nid_m.numpy(), np.asarray(nid_j))
    np.testing.assert_array_equal(hist_m.numpy(), np.asarray(hist_j))


@pytest.mark.parametrize("W", [16, 256])
def test_grouped_i8_model_leaves_out_codes_outside_the_lanes(W):
    """A code outside [0, W) (negative, or past the lanes of int16 codes)
    adds nothing in the int8 grouped form: its selector nibbles are all 8,
    which match no lane."""
    c, nid, ghw, t, n_prev, base = _binned_inputs(900, 3, W, 2, 5, False)
    c[::7, 1] = -3
    if W == 256:
        c[3::11, 1] = 300
    q, s = tha.quantize_ghw_i8(ghw, 1)
    _n, hist_m = _grouped_i8_binned_model(c, nid, q, s, t, n_prev, 2, base, W)
    keep = (c[:, 1] >= 0) & (c[:, 1] < W)
    _n, hist_k = tha.binned_level_i8_plain(c[keep], nid[keep], q[:, keep], s,
                                           t, n_prev, 2, base, W)
    assert torch.equal(hist_m[:, :, 1], hist_k[:, :, 1])


@pytest.mark.parametrize("build", ["nibbles", "swar"])
def test_prmt_model_one_hot_exact(build):
    """The one-hot selector against every lane: each of the 16 bins of an
    m-tile, and 'nothing' (nibble 8; for byte codes any byte outside the
    m-tile: -1 and 16..255), gives 1 on exactly the lane pair (g8, half)
    of its bin and 0 elsewhere."""
    make = _selectors if build == "nibbles" else _swar_selectors
    others = [-1] if build == "nibbles" else [-1, 16, 31, 127, 128, 144,
                                               253, 255]
    for b in list(range(16)) + others:
        sel = make(np.full((128, 1), b), 16)[0, 0, 0]
        lo = _prmt(_TLO, _THI, np.full(32, sel & 0xFFFF))
        hi = _prmt(_TLO, _THI, np.full(32, sel >> 16))
        for half, reg in ((0, lo), (1, hi)):
            want = np.where((b >= 0) & (_G8 + 8 * half == b), 0x01010101, 0)
            np.testing.assert_array_equal(reg, want)


@pytest.mark.parametrize("terms", [1, 2])
def test_pack_i8_records_round_trip(terms):
    """The int8 grouping records keep every q byte, negative ones and the
    two-term low byte b over all of [-128, 127] included, after the row
    id."""
    rng = np.random.default_rng(terms)
    rows = 700
    ghw = np.stack([rng.normal(size=rows), rng.random(rows),
                    np.ones(rows)]).astype(np.float32)
    ghw[0, :3] = [-1e3, 1e3, 0.0]                  # at amax, both signs
    q, _s = tha.quantize_ghw_i8(torch.as_tensor(ghw), terms)
    if terms == 2:
        # every b value and the a extremes occur
        q[1, :256] = torch.arange(-128, 128, dtype=torch.int8)
        q[0, :2] = torch.tensor([-127, 127], dtype=torch.int8)
        assert int(q[1::2].min()) == -128 and int(q[1::2].max()) == 127
    else:
        q[0, :3] = torch.tensor([-127, 127, -1], dtype=torch.int8)
    idx = torch.as_tensor(rng.permutation(rows)[:500].astype(np.int32))
    recs = pack_i8_records_plain(q, idx)
    assert recs.dtype == torch.int32 and recs.shape == (500, 2 * terms)
    assert torch.equal(recs[:, 0], idx)
    got = np.stack([_rec_mass(recs.numpy(), p) for p in range(3 * terms)])
    np.testing.assert_array_equal(got, q[:, idx.long()].numpy())
    if terms == 2:
        assert not recs[:, 3].any()               # the pad word
