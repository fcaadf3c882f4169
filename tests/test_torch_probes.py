"""The port's probe tools (h2o3_tpu_torch/tools, P1-P6) on the CPU.

Each probe's plain version is held against the JAX package's TPU probe
(tools/kern_*.py), its kernel body run by pl.pallas_call in interpret mode
with the tool's own block specs at a small size (the tool module's TILE and
ROWS set for it); each knock-out's plain version is held against the
function it is defined to compute (numpy loops, tools/kern_ablate.py); and
each entry point runs with --device cpu and raises without a card and
without it; the checks that the tools and chip_smoke.py make of the
kernels' outputs on the timed inputs and of the knock-outs' SASS refuse
what they should. The kernels themselves run on the card (chip_smoke.py
phase 9).
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from h2o3_tpu.ops.hist_adaptive import _pack_tables, _split3_bf16
from h2o3_tpu_torch.ops.hist_adaptive import (binned_level_plain,
                                              make_adaptive_tables,
                                              make_tables)
from h2o3_tpu_torch.tools import (kern_ablate, kern_ablate_t,
                                  kern_gather_probe, kern_mxu_probe,
                                  kern_variants)
from h2o3_tpu_torch.tools._probes import BODIES, LevelInputs
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

F, W, N = 28, 32, 32


def _bf16_close(hk, hp, mass):
    """Float32 histograms of bf16-rounded masses, summed in other orders:
    each bin within 1e-4 + 1e-5 x its absolute mass."""
    assert np.all(np.abs(np.asarray(hk, np.float64) - hp)
                  <= 1e-4 + 1e-5 * mass)


def _adaptive_case(rows, seed, nan=True):
    """x [rows, F] (5% NaN), nid in the previous window, (g, 1, 1),
    tables (feat, thr, na_left, can) and ranges, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, F)).astype(np.float32)
    if nan:
        x[rng.random((rows, F)) < 0.05] = np.nan
    n_prev = N // 2
    nid = (N - 1 - n_prev + rng.integers(0, n_prev, rows)).astype(np.int32)
    ghw = np.stack([rng.normal(size=rows).astype(np.float32),
                    np.ones(rows, np.float32), np.ones(rows, np.float32)])
    t4 = np.stack([rng.integers(0, F, n_prev).astype(np.float32),
                   rng.normal(size=n_prev).astype(np.float32),
                   (rng.random(n_prev) < 0.5).astype(np.float32),
                   (rng.random(n_prev) < 0.9).astype(np.float32)])
    lo = np.full((N, F), -4.0, np.float32)
    inv = np.full((N, F), (W - 2) / 8.0, np.float32)
    return x, nid, ghw, t4, lo, inv


# ------------------------------------------------------------------- P5


def _gather_call(kern, mod, rows):
    return pl.pallas_call(
        kern, grid=(rows // mod.TILE,),
        in_specs=[pl.BlockSpec((2 * mod.F, mod.N), lambda r: (0, 0)),
                  pl.BlockSpec((1, mod.TILE), lambda r: (0, r))],
        out_specs=pl.BlockSpec((2 * mod.F, mod.TILE), lambda r: (0, r)),
        out_shape=jax.ShapeDtypeStruct((2 * mod.F, rows), jnp.float32),
        interpret=True)


def test_p5_gather_and_onehot_match_the_tpu_kernels(monkeypatch):
    jmod = importlib.import_module("tools.kern_gather_probe")
    rows = 1024
    monkeypatch.setattr(jmod, "TILE", 256)
    monkeypatch.setattr(jmod, "ROWS", rows)
    tab, idx = kern_gather_probe.operands(rows, "cpu")
    jt, ji = jnp.asarray(tab.numpy()), jnp.asarray(idx.numpy())[None, :]
    jg = np.asarray(_gather_call(jmod.kern_gather, jmod, rows)(jt, ji))
    jm = np.asarray(_gather_call(jmod.kern_matmul, jmod, rows)(jt, ji))
    pg = kern_gather_probe.lookup(tab, idx, False).numpy()
    pm = kern_gather_probe.lookup(tab, idx, True).numpy()
    assert np.array_equal(pg, jg)           # the lane gather: exact
    assert np.array_equal(pm, jm)           # bf16 table x one-hot: bit-equal
    assert np.array_equal(pg, tab.numpy()[:, idx.numpy()])
    assert 0 < np.abs(pm - pg).max() < 1e-2  # the bf16 rounding of the table


def test_p5_plain_versions_zero_outside_the_table():
    tab = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 0.5
    idx = torch.tensor([0, 2, -1, 3, 1], dtype=torch.int32)
    want = torch.tensor([[0.5, 2.5, 0, 0, 1.5], [3.5, 5.5, 0, 0, 4.5]])
    assert torch.equal(kern_gather_probe.gather_plain(tab, idx), want)
    assert torch.equal(kern_gather_probe.onehot_plain(tab, idx), want)


# ------------------------------------------------------------------- P1


@pytest.mark.parametrize("dt", ["bf16", "i8"])
@pytest.mark.parametrize("M", [6, 24])
def test_p1_plain_matches_the_tpu_contraction(dt, M):
    """The TPU kernel's closure lives inside the timed run, so its plain
    reference: dot_general with the body's preferred_element_type, times
    n_tiles. int8 exact; bf16 within float32 summation order."""
    n_tiles, tile, fw = 7, 512, 64
    L, R = kern_mxu_probe.operands(M, fw, tile, dt, "cpu")
    got = kern_mxu_probe.mxu(L, R, n_tiles)
    jl = jnp.asarray(L.float().numpy() if dt == "bf16" else L.numpy())
    jr = jnp.asarray(R.float().numpy() if dt == "bf16" else R.numpy())
    if dt == "bf16":
        jl, jr = jl.astype(jnp.bfloat16), jr.astype(jnp.bfloat16)
    pet = jnp.int32 if dt == "i8" else jnp.float32
    ref = np.asarray(jax.lax.dot_general(
        jl, jr, (((1,), (1,)), ((), ())), preferred_element_type=pet)
        * n_tiles)
    if dt == "i8":
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), ref)
    else:
        mass = n_tiles * (np.abs(L.double().numpy())
                          @ np.abs(R.double().numpy()).T)
        assert np.all(np.abs(got.double().numpy() - ref) <= 1e-6 * mass)


# ------------------------------------------------------------------- P2


def _p2_call(jmod, ablate, rows):
    tile = jmod.TILE
    return pl.pallas_call(
        jmod.make_kernel(ablate), grid=(rows // tile,),
        in_specs=[pl.BlockSpec((tile, F), lambda r: (r, 0)),
                  pl.BlockSpec((1, tile), lambda r: (0, r)),
                  pl.BlockSpec((3, tile), lambda r: (0, r)),
                  pl.BlockSpec((12, N // 2), lambda r: (0, 0)),
                  pl.BlockSpec((N, 6 * F), lambda r: (0, 0))],
        out_specs=[pl.BlockSpec((1, tile), lambda r: (0, r)),
                   pl.BlockSpec((3 * N, F * W), lambda r: (0, 0))],
        out_shape=[jax.ShapeDtypeStruct((1, rows), jnp.int32),
                   jax.ShapeDtypeStruct((3 * N, F * W), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((3 * N, F * W), jnp.float32)],
        interpret=True)


def _inputs(x, nid, ghw, t4, lo, inv, layout="rows_f"):
    tables = make_adaptive_tables(*[torch.from_numpy(t) for t in t4])
    return LevelInputs(vals=torch.from_numpy(x if layout == "rows_f"
                                             else np.ascontiguousarray(x.T)),
                       nid=torch.from_numpy(nid), tables=tables,
                       n_prev=N // 2, n_nodes=N, level_base=N - 1,
                       ghw=torch.from_numpy(ghw), lo=torch.from_numpy(lo),
                       inv=torch.from_numpy(inv))


@pytest.mark.parametrize("ablate,port", [("none", "none"),
                                         ("loinv", "ranges")])
def test_p2_plain_matches_the_tpu_level(monkeypatch, ablate, port):
    """make_kernel("none") against the plain level; its "loinv" (the
    ranges knocked out) against the port's ranges knock-out, whose ranges
    (per node and feature here) become the same constants."""
    jmod = importlib.import_module("tools.kern_ablate")
    rows = 2048
    monkeypatch.setattr(jmod, "ROWS", rows)
    monkeypatch.setattr(jmod, "TILE", 512)
    x, nid, ghw, t4, lo, inv = _adaptive_case(rows, 11)
    rng = np.random.default_rng(3)
    if port == "ranges":   # other ranges: the knock-out must not read them
        lo = (lo + 0.5 * rng.random(lo.shape)).astype(np.float32)
        inv = (inv * (1 + 0.1 * rng.random(inv.shape))).astype(np.float32)
    loinv = _split3_bf16(jnp.asarray(np.concatenate([lo, inv], 1)), axis=1)
    tabs = _split3_bf16(jnp.asarray(t4), axis=0)
    jn, jh = _p2_call(jmod, ablate, rows)(
        jnp.asarray(x), jnp.asarray(nid)[None, :], jnp.asarray(ghw), tabs,
        loinv)
    inp = _inputs(x, nid, ghw, t4, lo, inv)
    pn, ph = kern_ablate.knockout("grouped_adaptive", port, inp)
    assert np.array_equal(pn.numpy(), np.asarray(jn)[0])
    inp.ghw = inp.ghw.double().abs()
    mass = kern_ablate.knockout_plain("grouped_adaptive", port, inp)[1]
    _bf16_close(np.asarray(jh), ph.reshape(3 * N, F * W).double().numpy(),
                mass.reshape(3 * N, F * W).numpy())


# ------------------------------------------------------------------- P3


def test_p3_plain_matches_the_tpu_packed_level():
    jmod = importlib.import_module("tools.kern_ablate")
    rows, tile, LW = 2048, 512, 16
    rng = np.random.default_rng(5)
    ct = rng.integers(0, LW - 1, size=(F, rows)).astype(np.int8)
    ct[rng.random((F, rows)) < 0.05] = LW - 1
    n_prev = N // 2
    nid = (N - 1 - n_prev + rng.integers(0, n_prev, rows)).astype(np.int32)
    ghw = np.stack([rng.normal(size=rows).astype(np.float32),
                    np.ones(rows, np.float32), np.ones(rows, np.float32)])
    t4 = [rng.integers(0, F, n_prev), rng.integers(1, LW - 1, n_prev),
          (rng.random(n_prev) < 0.5), (rng.random(n_prev) < 0.9)]
    tabs = _pack_tables(tuple(jnp.asarray(t.astype(np.float32))
                              for t in t4))
    call = pl.pallas_call(
        jmod.make_packed_kernel("none", tile, rows // tile),
        grid=(rows // tile,),
        in_specs=[pl.BlockSpec((F, tile), lambda r: (0, r)),
                  pl.BlockSpec((1, tile), lambda r: (0, r)),
                  pl.BlockSpec((3, tile), lambda r: (0, r)),
                  pl.BlockSpec((12, n_prev), lambda r: (0, 0))],
        out_specs=[pl.BlockSpec((1, tile), lambda r: (0, r)),
                   pl.BlockSpec((3 * N, F * LW), lambda r: (0, 0))],
        out_shape=[jax.ShapeDtypeStruct((1, rows), jnp.int32),
                   jax.ShapeDtypeStruct((3 * N, F * LW), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((3 * N, F * LW), jnp.float32)],
        interpret=True)
    jn, jh = call(jnp.asarray(ct), jnp.asarray(nid)[None, :],
                  jnp.asarray(ghw), tabs)
    codes = torch.from_numpy(np.ascontiguousarray(ct.T))
    tables = make_tables(*[torch.from_numpy(np.asarray(t)) for t in t4])
    inp = LevelInputs(vals=codes, nid=torch.from_numpy(nid), tables=tables,
                      n_prev=n_prev, n_nodes=N, level_base=N - 1,
                      ghw=torch.from_numpy(ghw))
    pn, ph = kern_ablate.knockout("grouped_packed", "none", inp)
    assert np.array_equal(pn.numpy(), np.asarray(jn)[0])
    _n, mass = binned_level_plain(codes, inp.nid,
                                  torch.from_numpy(ghw).double().abs(),
                                  tables, n_prev, N, N - 1, LW, True)
    _bf16_close(np.asarray(jh), ph.reshape(3 * N, F * LW).double().numpy(),
                mass.reshape(3 * N, F * LW).numpy())


# ------------------------------------------------------------------- P4


def test_p4_plain_matches_the_tpu_transposed_level(monkeypatch):
    jmod = importlib.import_module("tools.kern_ablate_t")
    rows, tile = 2048, 512
    monkeypatch.setattr(jmod, "ROWS", rows)
    monkeypatch.setattr(jmod, "TILE", tile)
    x, nid, ghw, t4, lo, inv = _adaptive_case(rows, 13)
    xt = np.ascontiguousarray(x.T)
    tabs = _split3_bf16(jnp.asarray(t4), axis=0)
    loinv = _split3_bf16(jnp.asarray(np.concatenate([lo.T, inv.T], 0)),
                         axis=0)
    call = pl.pallas_call(
        jmod.make_kernel("full"), grid=(rows // tile,),
        in_specs=[pl.BlockSpec((F, tile), lambda r: (0, r)),
                  pl.BlockSpec((1, tile), lambda r: (0, r)),
                  pl.BlockSpec((3, tile), lambda r: (0, r)),
                  pl.BlockSpec((12, N // 2), lambda r: (0, 0)),
                  pl.BlockSpec((6 * F, N), lambda r: (0, 0))],
        out_specs=[pl.BlockSpec((1, tile), lambda r: (0, r)),
                   pl.BlockSpec((3 * N, F * W), lambda r: (0, 0))],
        out_shape=[jax.ShapeDtypeStruct((1, rows), jnp.int32),
                   jax.ShapeDtypeStruct((3 * N, F * W), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((3 * N, F * W), jnp.float32)],
        interpret=True)
    jn, jh = call(jnp.asarray(xt), jnp.asarray(nid)[None, :],
                  jnp.asarray(ghw), tabs, loinv)
    inp = _inputs(x, nid, ghw, t4, lo, inv, "f_rows")
    pn, ph = kern_ablate.knockout("tiled_adaptive", "none", inp)
    assert np.array_equal(pn.numpy(), np.asarray(jn)[0])
    inp.ghw = inp.ghw.double().abs()
    mass = kern_ablate.knockout_plain("tiled_adaptive", "none", inp)[1]
    _bf16_close(np.asarray(jh), ph.reshape(3 * N, F * W).double().numpy(),
                mass.reshape(3 * N, F * W).numpy())


# ------------------------------------------------------------------- P6


@pytest.mark.parametrize("variant", ["base", "noroute", "noloinv"])
def test_p6_plain_matches_the_tpu_variants(variant):
    """The JAX probe's variants: base is the plain level, noloinv the
    port's ranges knock-out; its noroute routes no row, the plain level of
    parents that cannot split (the port's own no-route knock-out sends
    every row left instead)."""
    jmod = importlib.import_module("tools.kern_variants")
    rows, tile = 2048, 512
    x, nid, ghw, t4, lo, inv = _adaptive_case(rows, 17)
    rng = np.random.default_rng(7)
    lo = (lo + 0.5 * rng.random(lo.shape)).astype(np.float32)
    n_prev = N // 2
    kern = functools.partial(
        jmod._kernel, n_prev=n_prev, n_nodes=N, F=F, W=W, tile=tile,
        n_row_tiles=rows // tile, level_base=N - 1,
        mxu_dtype=jnp.bfloat16, variant=variant)
    call = pl.pallas_call(
        kern, grid=(rows // tile,),
        in_specs=[pl.BlockSpec((tile, F), lambda r: (r, 0)),
                  pl.BlockSpec((1, tile), lambda r: (0, r)),
                  pl.BlockSpec((3, tile), lambda r: (0, r)),
                  pl.BlockSpec((4, n_prev), lambda r: (0, 0)),
                  pl.BlockSpec((N, 2 * F), lambda r: (0, 0))],
        out_specs=[pl.BlockSpec((1, tile), lambda r: (0, r)),
                   pl.BlockSpec((3 * N, F * W), lambda r: (0, 0))],
        out_shape=[jax.ShapeDtypeStruct((1, rows), jnp.int32),
                   jax.ShapeDtypeStruct((3 * N, F * W), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((3 * N, F * W), jnp.float32)],
        interpret=True)
    jn, jh = call(jnp.asarray(x), jnp.asarray(nid)[None, :],
                  jnp.asarray(ghw), jnp.asarray(t4),
                  jnp.asarray(np.concatenate([lo, inv], 1)))
    if variant == "noroute":
        t4 = t4.copy()
        t4[3] = 0.0
    inp = _inputs(x, nid, ghw, t4, lo, inv)
    name = "noloinv" if variant == "noloinv" else "grouped"
    pn, ph = kern_variants.variant(name, inp)
    assert np.array_equal(pn.numpy(), np.asarray(jn)[0])
    mass = kern_variants.variant_plain(name, inp, inp.ghw.double().abs())[1]
    _bf16_close(np.asarray(jh), ph.reshape(3 * N, F * W).double().numpy(),
                mass.reshape(3 * N, F * W).numpy())


# ------------------------------------- the knock-outs' defined functions


def _bf16(v):
    return float(torch.tensor(v, dtype=torch.float32).to(torch.bfloat16))


def _reference(body_name, ablate, inp):
    """The knock-out's function by its definition, in numpy loops."""
    body = BODIES[body_name]
    Wb = body.W
    vals = inp.vals.numpy()
    if body.layout == "f_rows":
        vals = vals.T
    rows, Fv = vals.shape
    nid = inp.nid.numpy()
    t = inp.tables.numpy()
    prev_base = inp.level_base - inp.n_prev
    adaptive = body.kind == "adaptive"
    lo = inp.lo.numpy() if adaptive else None
    inv = inp.inv.numpy() if adaptive else None
    can = (t[3] > 0.5) if adaptive else (t[3] != 0)
    # the gather knock-out's rows: a group's records in row order, a
    # record's producer its place in the group mod 256
    src = np.arange(rows)
    if ablate == "gather":
        seen = {}
        for r in range(rows):
            lp = nid[r] - prev_base
            ln = nid[r] - inp.level_base
            key = (lp if inp.n_prev and 0 <= lp < inp.n_prev and can[lp]
                   else inp.n_prev + ln if 0 <= ln < inp.n_nodes else None)
            if key is not None:
                src[r] = seen.get(key, 0) % 256
                seen[key] = seen.get(key, 0) + 1
    out = nid.copy()
    if body.mass == "i8":
        acc = np.zeros((3, inp.n_nodes, Fv, Wb), np.int64)
        mass = inp.q.numpy().astype(np.int64)
    else:
        acc = np.zeros((3, inp.n_nodes, Fv, Wb), np.float64)
        mass = np.array([[_bf16(v) for v in row]
                         for row in inp.ghw.numpy()])
    for r in range(rows):
        n = int(nid[r])
        v = vals[src[r]]
        lp = n - prev_base
        if inp.n_prev and 0 <= lp < inp.n_prev and can[lp]:
            right = 0
            if ablate != "route":
                f = int(min(max(int(t[0, lp]), 0), Fv - 1))
                if adaptive:
                    right = (int(t[2, lp] < 0.5) if np.isnan(v[f])
                             else int(v[f] >= t[1, lp]))
                else:
                    right = (int(t[2, lp] == 0) if v[f] == Wb - 1
                             else int(v[f] >= t[1, lp]))
            n = 2 * n + 1 + right
        out[r] = n
        ln = n - inp.level_base
        if not 0 <= ln < inp.n_nodes or ablate == "adds":
            continue
        for f in range(Fv):
            if ablate == "bins":
                b = (r + f) % (Wb - 1)
            elif adaptive:
                lo_, inv_ = ((-4.0, (Wb - 2) / 8.0) if ablate == "ranges"
                             else (lo[ln, f], inv[ln, f]))
                if np.isnan(v[f]):
                    b = Wb - 1
                else:
                    u = np.float32(np.float32(v[f] - np.float32(lo_))
                                   * np.float32(inv_))
                    b = int(np.floor(min(max(u, 0.0), Wb - 2.0)))
            else:
                b = int(v[f])
            acc[:, ln, f, b] += mass[:, r]
    if body.mass == "i8":
        hist = (inp.scales.numpy()[:, None, None, None]
                * acc.astype(np.float32))
    else:
        hist = acc
    return out, hist


_CASES = [(b, a) for b, body in BODIES.items() for a in body.ablates]


@pytest.mark.parametrize("body_name,ablate", _CASES,
                         ids=[f"{b}-{a}" for b, a in _CASES])
def test_knockout_plain_is_its_defined_function(body_name, ablate):
    inp = kern_ablate.level_inputs(body_name, 600, 5, 4, 21, "cpu",
                                   int_ghw=True)
    pn, ph = kern_ablate.knockout_plain(body_name, ablate, inp)
    rn, rh = _reference(body_name, ablate, inp)
    assert np.array_equal(pn.numpy(), rn)
    assert np.array_equal(ph.double().numpy(), rh.astype(np.float64))


def test_knockouts_change_what_they_say():
    """On the same inputs each knock-out's plain version differs from the
    level's where its phase matters: route and bins move mass, ranges
    re-bins, adds zeroes the histogram, gather re-reads rows."""
    for body_name in ("grouped_adaptive", "wide_packed"):
        inp = kern_ablate.level_inputs(body_name, 600, 5, 4, 23, "cpu")
        base = kern_ablate.knockout_plain(body_name, "none", inp)
        for ab in BODIES[body_name].ablates:
            if ab in ("none", "walk"):
                continue
            n, h = kern_ablate.knockout_plain(body_name, ab, inp)
            assert not torch.equal(h, base[1]), (body_name, ab)
            if ab == "adds":
                assert torch.equal(n, base[0]) and not h.any()


def test_parent_nid_feeds_back_the_same_level():
    inp = kern_ablate.level_inputs("grouped_adaptive", 500, 5, 8, 3, "cpu")
    nid2, _h = kern_ablate.knockout_plain("grouped_adaptive", "none", inp)
    assert torch.equal(kern_ablate.parent_nid(nid2, inp.level_base,
                                              inp.n_prev), inp.nid)


# ------------------------------------------------------- entry points


_TOOLS = [(kern_mxu_probe, ["6", "--rows", "2048", "--tile", "512"]),
          (kern_gather_probe, ["--rows", "1000"]),
          (kern_ablate, ["--rows", "600", "--reps", "1"]),
          (kern_ablate, ["--levels", "1,2", "--rows", "600", "--reps", "1"]),
          (kern_ablate_t, ["--rows", "600", "--reps", "1"]),
          (kern_variants, ["--rows", "600", "--reps", "1"])]


@pytest.mark.parametrize("tool,argv", _TOOLS,
                         ids=[f"{t.__name__.split('.')[-1]}-{i}"
                              for i, (t, _a) in enumerate(_TOOLS)])
def test_entry_point_runs_on_the_cpu(tool, argv, capsys):
    res = tool.main(["--device", "cpu", *argv])
    assert res
    assert "CPU: the plain" in capsys.readouterr().out


@pytest.mark.parametrize("tool", [kern_mxu_probe, kern_gather_probe,
                                  kern_ablate, kern_ablate_t, kern_variants])
def test_entry_point_raises_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tool.main([])


def test_kernel_wrappers_refuse_cpu_tensors():
    from h2o3_tpu_torch.tools import _probes
    inp = kern_ablate.level_inputs("grouped_adaptive", 300, 5, 4, 1, "cpu")
    with pytest.raises(ValueError, match="CUDA kernel"):
        _probes.level_knockout("grouped_adaptive", "none", inp)
    L, R = kern_mxu_probe.operands(6, 64, 512, "bf16", "cpu")
    with pytest.raises(ValueError, match="CUDA kernel"):
        _probes.mxu_probe(L, R, 1)
    tab, idx = kern_gather_probe.operands(100, "cpu")
    with pytest.raises(ValueError, match="CUDA kernel"):
        _probes.gather_probe(tab, idx, True)


def test_every_body_has_an_instance_rule():
    """Each knock-out a body names is one the kernels take (ranges where
    the bins need them, walk on the float wide body, gather on the wide
    body)."""
    for body in BODIES.values():
        assert ("ranges" in body.ablates) == (body.kind == "adaptive")
        assert ("walk" in body.ablates) == (body.form == "wide"
                                            and body.mass == "float")
        assert ("gather" in body.ablates) == (body.form == "wide")


# ------------------------------------- the checks on the timed inputs


@pytest.mark.parametrize("body_name", ["grouped_adaptive", "wide_i8_packed"])
def test_check_knockout_holds_and_refuses(body_name):
    """check_knockout passes the plain version's own output and refuses a
    nid off by one row or a histogram bin moved (beyond the float
    tolerance; by any amount on int8 masses)."""
    inp = kern_ablate.level_inputs(body_name, 700, 5, 4, 31, "cpu")
    for ab in ("none", "route", "adds"):
        out = kern_ablate.knockout_plain(body_name, ab, inp)
        assert kern_ablate.check_knockout(body_name, ab, inp, out) == 0.0
    nid, hist = kern_ablate.knockout_plain(body_name, "none", inp)
    bad_nid = nid.clone()
    bad_nid[7] += 1
    with pytest.raises(AssertionError, match="nid differs in 1 rows"):
        kern_ablate.check_knockout(body_name, "none", inp, (bad_nid, hist))
    bad = hist.clone().view(-1)
    i = bad.abs().argmax()
    bad[i] = (bad[i] + 1e-3 if BODIES[body_name].mass == "float" else
              torch.nextafter(bad[i], bad[i] + 1))    # one ulp
    bad = bad.view(hist.shape)
    with pytest.raises(AssertionError, match="histogram|beyond"):
        kern_ablate.check_knockout(body_name, "none", inp, (nid, bad))


def test_timed_level_checks_its_first_output_on_the_timed_inputs():
    """The first hook gets the warm-up's output on the inputs as given
    (nid not yet fed back), once."""
    inp = kern_ablate.level_inputs("grouped_packed", 400, 5, 8, 5, "cpu")
    nid0 = inp.nid.clone()
    seen = []

    def first(out):
        assert torch.equal(inp.nid, nid0)
        seen.append(kern_ablate.check_knockout("grouped_packed", "bins",
                                               inp, out))
    kern_ablate.timed_level(
        lambda i: kern_ablate.knockout("grouped_packed", "bins", i), inp,
        torch.device("cpu"), 3, first)
    assert seen == [0.0]
    assert torch.equal(inp.nid, nid0)


def test_attribute_runs_only_the_knockouts_asked():
    cpu = torch.device("cpu")
    res = kern_ablate.attribute("tiled_adaptive", 300, 5, 4, cpu, 3, 1,
                                extras=False, ablates=["route", "adds"])
    assert set(res["ms"]) == set(res["errs"]) == {"none", "route", "adds"}
    with pytest.raises(ValueError, match="knock-outs"):
        kern_ablate.attribute("grouped_packed", 300, 5, 4, cpu, 3, 1,
                              extras=False, ablates=["ranges"])


def test_p1_and_p5_checks_refuse_a_wrong_output():
    L, R = kern_mxu_probe.operands(6, 64, 512, "i8", "cpu")
    out = kern_mxu_probe.mxu(L, R, 3)
    assert kern_mxu_probe.check(L, R, 3, out) == 0.0
    out[0, 0] += 1
    with pytest.raises(AssertionError, match="not exact"):
        kern_mxu_probe.check(L, R, 3, out)
    L, R = kern_mxu_probe.operands(6, 64, 512, "bf16", "cpu")
    out = kern_mxu_probe.mxu(L, R, 3)
    assert kern_mxu_probe.check(L, R, 3, out) < 1e-3
    out[1, 2] += 1.0
    with pytest.raises(AssertionError, match="beyond"):
        kern_mxu_probe.check(L, R, 3, out)
    tab, idx = kern_gather_probe.operands(500, "cpu")
    for onehot in (False, True):
        out = kern_gather_probe.lookup(tab, idx, onehot)
        assert kern_gather_probe.check(tab, idx, onehot, out) == 0.0
        out[3, 9] = out[3, 9] + 1e-3
        with pytest.raises(AssertionError, match="not bit-equal"):
            kern_gather_probe.check(tab, idx, onehot, out)


# ------------------------------------- chip_smoke's SASS check of them


def _sass_names():
    """A mangled-like function name for every knock-out instance of
    every body, as chip_smoke.check_probe_sass parses them."""
    import chip_smoke
    from h2o3_tpu_torch.tools._probes import ABLATES
    names = {}
    for b, body in BODIES.items():
        for ab in body.ablates:
            if body.form == "tiled":
                fn = "_ZN4h2o321adaptive_level_kernelILi32ELb1ELi0E"
            else:
                src = ("AdaptiveBins" if body.kind == "adaptive" else
                       "CodeBins")
                mass = ("I8Mass" if body.mass == "i8" else
                        "FloatMass" if body.form == "grouped" else
                        "WideFloat")
                fn = f"_ZN4h2o3level_{body.form}_kernelIN{src}N{mass}E"
            names[(b, ab)] = f"{fn}LNS_6AblateE{ABLATES[ab]}EEEv"
    return chip_smoke, names


def _sass_counts(names, lds=40, mma=16):
    by_fn = {}
    for (b, ab), name in names.items():
        c = {"LDS": lds - 5, "LDS.128": 5}
        if BODIES[b].form == "grouped" and ab != "adds":
            c["HMMA.16816.F32.BF16"] = mma
        by_fn[name] = c
    return by_fn


def test_check_probe_sass_passes_kept_work_and_owned_loads():
    chip_smoke, names = _sass_names()
    by_fn = _sass_counts(names)
    # a phase's own loads may go: the wide body's lo and inv under ranges
    by_fn[names[("wide_adaptive", "ranges")]]["LDS"] -= 32
    by_fn[names[("wide_adaptive", "adds")]]["LDS"] += 30
    chip_smoke.check_probe_sass(by_fn)


@pytest.mark.parametrize("case", ["lost_load", "lost_mma", "adds_mma",
                                  "missing"])
def test_check_probe_sass_refuses_dropped_work(case):
    chip_smoke, names = _sass_names()
    by_fn = _sass_counts(names)
    if case == "lost_load":      # loads no phase of route owns
        by_fn[names[("wide_packed", "route")]]["LDS"] -= 1
        match = "shared loads"
    elif case == "lost_mma":
        by_fn[names[("grouped_packed", "bins")]]["HMMA.16816.F32.BF16"] = 8
        match = "tensor-core products"
    elif case == "adds_mma":
        by_fn[names[("grouped_adaptive", "adds")]]["HMMA.16816.F32.BF16"] = 2
        match = "tensor-core products"
    else:
        del by_fn[names[("tiled_adaptive", "bins")]]
        match = "missing"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_probe_sass(by_fn)
