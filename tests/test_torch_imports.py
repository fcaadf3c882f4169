"""The port stands alone: no JAX and nothing of h2o3_tpu in
h2o3_tpu_torch or chip_smoke.py; entry points run on CUDA unless the
CPU is asked for; a CUDA tensor never reaches a plain version."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th2o
from h2o3_tpu_torch import _device
from h2o3_tpu_torch.ops import hist_adaptive as tha
from h2o3_tpu_torch.ops import kernels

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "h2o3_tpu")


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources():
    return sorted((ROOT / "h2o3_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for mod in _imported(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_import_leaves_jax_out():
    code = ("import sys; import h2o3_tpu_torch, h2o3_tpu_torch.estimators, "
            "h2o3_tpu_torch.ops.binning; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'h2o3_tpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_device, "_default", None)
    X = np.zeros((4, 2), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th2o.Frame.from_numpy(X)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th2o.upload_numpy(X, device="cuda")
    assert th2o.Frame.from_numpy(X, device="cpu").device.type == "cpu"
    assert th2o.init(device="cpu").type == "cpu"
    assert th2o.Frame.from_numpy(X).device.type == "cpu"


class _FakeCuda:
    """Stands in for a CUDA tensor in the dispatch check."""
    class device:
        type = "cuda"
    shape = (8, 2)


def test_dispatch_sends_cuda_to_the_kernel_only(monkeypatch):
    calls = []

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("binned_level_plain", "binned_route_only_plain",
                 "adaptive_level_plain", "adaptive_route_only_plain",
                 "binned_level_i8_plain", "adaptive_level_i8_plain",
                 "leaf_totals_plain"):
        monkeypatch.setattr(tha, name, refuse)
    for name in ("binned_level", "binned_route_only", "adaptive_level",
                 "adaptive_route_only", "binned_level_i8",
                 "adaptive_level_i8", "leaf_totals"):
        monkeypatch.setattr(kernels, name,
                            lambda *a, _n=name: calls.append(_n))
    t = _FakeCuda()
    tha.binned_level(t, t, t, t, 1, 2, 1, 16)
    tha.binned_route_only(t, t, t, 1, 1, 16)
    tha.adaptive_level(t, t, t, t, t, t, 1, 2, 1, 16, False, "f_rows")
    tha.adaptive_route_only(t, t, t, 1, 1, "rows_f")
    qs = (torch.zeros((6, 8), dtype=torch.int8), t)
    tha.binned_level(t, t, t, t, 1, 2, 1, 16, True, qs)
    tha.adaptive_level(t, t, t, t, t, t, 1, 2, 1, 16, True, "rows_f", qs)
    tha.leaf_totals(t, t, t, t, 1, 2, 1)
    assert calls == ["binned_level", "binned_route_only", "adaptive_level",
                     "adaptive_route_only", "binned_level_i8",
                     "adaptive_level_i8", "leaf_totals"]
    meta = torch.empty((8, 2), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tha.binned_level(meta, meta, meta, meta, 0, 1, 0, 16)
    xm = torch.empty((8, 2), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tha.adaptive_level(xm, xm, xm, xm, xm, xm, 0, 1, 0, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        tha.adaptive_route_only(xm, xm, xm, 1, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        tha.leaf_totals(xm, xm, xm, xm, 1, 2, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        tha.binned_level(meta, meta, meta, meta, 0, 1, 0, 16, True,
                         (torch.zeros((3, 8), dtype=torch.int8), xm))


def test_segment_totals_dispatch_sends_cuda_to_the_kernel_only(monkeypatch):
    from h2o3_tpu_torch.ops import common

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    calls = []
    monkeypatch.setattr(common, "segment_totals_plain", refuse)
    monkeypatch.setattr(kernels, "segment_totals",
                        lambda *a: calls.append("segment_totals"))
    t = _FakeCuda()
    common.segment_totals(t, t, 2, 1)
    assert calls == ["segment_totals"]
    xm = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        common.segment_totals(xm, xm, 2, 1)


def test_kernel_wrappers_refuse_cpu_tensors():
    codes = torch.zeros((8, 2), dtype=torch.int8)
    nid = torch.zeros(8, dtype=torch.int32)
    tables = torch.zeros((4, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.binned_level(codes, nid, torch.zeros((3, 8)), tables, 0, 1,
                             0, 16, False)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.binned_route_only(codes, nid, tables, 1, 1, 16)
    x = torch.zeros((8, 2), dtype=torch.float32)
    ftab = torch.zeros((4, 1), dtype=torch.float32)
    rng = torch.zeros((1, 2), dtype=torch.float32)
    q = torch.zeros((3, 8), dtype=torch.int8)
    scales = torch.ones(3)
    for layout in ("rows_f", "f_rows"):
        with pytest.raises(ValueError, match="CUDA kernel"):
            kernels.adaptive_level(x, nid, torch.zeros((3, 8)), ftab, rng,
                                   rng, 0, 1, 0, 16, False, layout)
        with pytest.raises(ValueError, match="CUDA kernel"):
            kernels.adaptive_route_only(x, nid, ftab, 1, 1, layout)
        with pytest.raises(ValueError, match="CUDA kernel"):
            kernels.adaptive_level_i8(x, nid, q, scales, ftab, rng, rng, 0,
                                      1, 0, 16, layout)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.binned_level_i8(codes, nid, q, scales, tables, 0, 1, 0, 16)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.leaf_totals(x, nid, torch.zeros((3, 8)), ftab, 1, 2, 1)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.segment_totals(nid, torch.zeros((3, 8)), 2, 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest --noconftest -m gpu tests/test_torch_kernels.py tests/test_torch_imports.py)")
    return torch.device("cuda")


def _launches(**nonzero):
    out = {k: 0 for k in kernels.LAUNCHES}
    out.update(nonzero)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("params,i8,launches", [
    (dict(nbins=14, histogram_type="quantiles_global"), "0",
     _launches(binned_level=6, binned_route_only=2, segment_totals=2)),
    (dict(nbins=20, packed_codes=False), "0",
     _launches(adaptive_level=6, adaptive_route_only=2)),
    (dict(nbins=1024, histogram_type="quantiles_global"), "0",
     _launches(global_hist=6, segment_totals=2)),
    # H2O3_HIST_I8 at bf16: every level of a depth-3 tree at one term
    (dict(nbins=14, histogram_type="quantiles_global",
          histogram_precision="bfloat16"), "1",
     _launches(binned_level_i8=6, binned_route_only=2, segment_totals=2)),
    (dict(nbins=20, packed_codes=False, histogram_precision="bfloat16"),
     "1", _launches(adaptive_level_i8=6, adaptive_route_only=2)),
    # at float32 histograms the switch is not read
    (dict(nbins=14, histogram_type="quantiles_global",
          histogram_precision="float32"), "1",
     _launches(binned_level=6, binned_route_only=2, segment_totals=2))])
def test_cuda_training_launches_the_kernels(cuda, monkeypatch, params, i8,
                                            launches):
    monkeypatch.setenv("H2O3_HIST_I8", i8)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(20_000, 5)).astype(np.float32)
    y = (X[:, 0] + rng.normal(size=20_000) > 0).astype(np.float32)
    cols = {f"f{i}": X[:, i] for i in range(5)}
    cols["label"] = y
    fr = th2o.Frame.from_numpy(cols, device=cuda)
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    H2OGradientBoostingEstimator(
        ntrees=2, max_depth=3, distribution="bernoulli", **params).train(
        y="label", training_frame=fr)
    assert kernels.LAUNCHES == launches


def test_level_form_names():
    """The float levels' forms by name, as the C entries number them
    (csrc/level_wide.cuh LevelForm); True and False keep meaning the
    tensor-core grouped and the tiled body; an unknown name raises before
    any launch."""
    assert kernels.LEVEL_FORMS == {"picked": -1, "tiled": 0, "grouped": 1,
                                   "wide": 2}
    assert kernels._form_code("wide") == 2
    assert kernels._form_code(True) == 1 and kernels._form_code(False) == 0
    with pytest.raises(ValueError, match="unknown level form"):
        kernels._form_code("fastest")
    text = (ROOT / "h2o3_tpu_torch" / "csrc" / "level_wide.cuh").read_text()
    for name, code in (("kPickForm", -1), ("kTiledForm", 0),
                       ("kTensorForm", 1), ("kWideForm", 2)):
        assert f"{name} = {code}," in text
    assert text.count(" = ", text.index("enum LevelForm"),
                      text.index("};", text.index("enum LevelForm"))) == 4
