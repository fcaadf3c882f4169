"""The port stands alone: no JAX and nothing of h2o3_tpu in
h2o3_tpu_torch or chip_smoke.py; the native tokenizer builds from the
port's own source into the port's build directory; entry points run on
CUDA unless the CPU is asked for; a CUDA tensor never reaches a plain
version."""
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
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

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


def test_sources_cover_every_model_module():
    """The no-JAX rule above reads every module of the port, the XGBoost
    estimator, the random forest, the GLM, the streamed trainer's chunks
    and the memory budget among them."""
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for mod in ("drf", "gbm", "glm", "model_base", "metrics", "streaming",
                "tree", "xgboost"):
        assert f"h2o3_tpu_torch/models/{mod}.py" in names
    assert "h2o3_tpu_torch/memman.py" in names


INGEST_MODULES = ("h2o3_tpu_torch/resilience.py", "h2o3_tpu_torch/log.py",
                  "h2o3_tpu_torch/ingest/compress.py",
                  "h2o3_tpu_torch/ingest/stream.py",
                  "h2o3_tpu_torch/ingest/formats.py",
                  "h2o3_tpu_torch/ingest/persist_uri.py",
                  "h2o3_tpu_torch/ingest/sql.py")


def test_sources_cover_every_ingest_module():
    """The no-JAX rule reads the ingest modules (compressed inputs,
    streaming, formats, URIs, SQL) and the retry and log modules."""
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert set(INGEST_MODULES) <= names


def test_import_leaves_jax_out():
    mods = ", ".join(m[:-3].replace("/", ".") for m in INGEST_MODULES)
    code = ("import sys; import h2o3_tpu_torch, h2o3_tpu_torch.estimators, "
            f"h2o3_tpu_torch.models.xgboost, h2o3_tpu_torch.ops.binning, "
            f"h2o3_tpu_torch.models.glm, h2o3_tpu_torch.ops.glm_cd, "
            f"h2o3_tpu_torch.memman, h2o3_tpu_torch.models.streaming, "
            f"{mods}; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'h2o3_tpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


SERVE_MODULES = ("h2o3_tpu_torch/genmodel.py",
                 "h2o3_tpu_torch/telemetry/__init__.py",
                 "h2o3_tpu_torch/telemetry/registry.py",
                 "h2o3_tpu_torch/serve/__init__.py",
                 "h2o3_tpu_torch/serve/batcher.py",
                 "h2o3_tpu_torch/serve/circuit.py",
                 "h2o3_tpu_torch/serve/codec.py",
                 "h2o3_tpu_torch/serve/lanes.py",
                 "h2o3_tpu_torch/serve/registry.py",
                 "h2o3_tpu_torch/serve/service.py",
                 "h2o3_tpu_torch/serve/stats.py")


def test_sources_cover_every_serving_module():
    """The no-JAX rule reads the scoring and serving modules: the
    EasyPredict row API, the metrics registry and serve/."""
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert set(SERVE_MODULES) <= names


def test_serving_import_leaves_jax_out():
    code = ("import sys; import h2o3_tpu_torch.serve as s, "
            "h2o3_tpu_torch.genmodel as g, h2o3_tpu_torch.telemetry; "
            "from h2o3_tpu_torch.models.model_base import Model; "
            "api = ('deploy', 'undeploy', 'deployment', 'deployments', "
            "'predict_rows', 'predict_columnar', 'stats', 'shutdown_all', "
            "'circuit_states'); "
            "assert all(callable(getattr(s, n)) for n in api); "
            "assert all(callable(getattr(g, n)) for n in ('rows_to_matrix', "
            "'build_domain_luts', 'EasyPredictModelWrapper')); "
            "assert callable(Model.deploy) and callable(Model.predict_rows); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'h2o3_tpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_deploy_of_a_cuda_model_raises_without_cuda(monkeypatch):
    """serve.deploy runs where the model lives: a model on cuda without a
    CUDA device raises, as the other entry points do, and nothing is
    deployed."""
    from h2o3_tpu_torch import serve
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    rng = np.random.default_rng(0)
    fr = th2o.Frame.from_numpy({"a": rng.normal(size=200).astype(np.float32),
                                "y": (rng.random(200) < 0.5).astype(
                                    np.float32)}, device="cpu")
    m = H2OGradientBoostingEstimator(ntrees=2, max_depth=2,
                                     distribution="bernoulli").train(
        y="y", training_frame=fr).model
    m.device = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.deploy("cuda_model", model=m)
    assert serve.deployment("cuda_model") is None


def test_tokenizer_build_stays_in_the_port(monkeypatch):
    """Building the tokenizer compiles only the port's copy of
    fast_csv.cpp (the JAX package's code, comment for comment but for two
    that named the reference's change history) and writes only under
    h2o3_tpu_torch/_build/; the JAX package's library and its hash
    sidecar are byte-unchanged."""
    from h2o3_tpu_torch import native
    ref = ROOT / "h2o3_tpu" / "native"
    theirs = {p: p.read_bytes() for p in (ref / "libfastcsv.so",
                                          ref / "libfastcsv.so.srchash")}
    assert native.SRC == ROOT / "h2o3_tpu_torch" / "native" / "fast_csv.cpp"
    ours = native.SRC.read_text().splitlines()
    theirs_src = (ref / "fast_csv.cpp").read_text().splitlines()
    assert len(ours) == len(theirs_src)
    differ = [(a, b) for a, b in zip(ours, theirs_src) if a != b]
    assert [a for a, _b in differ] == [
        "// Scope: separator-delimited rows, '\\n'/'\\r\\n'",
        "// ---- nogil encode plane " + "-" * 45]
    assert all(b.startswith("// ") for _a, b in differ)
    assert native.library_path().parent == ROOT / "h2o3_tpu_torch" / "_build"
    calls = []
    run = subprocess.run

    def record(cmd, *a, **k):
        calls.append(list(cmd))
        return run(cmd, *a, **k)

    monkeypatch.setattr(native.subprocess, "run", record)
    so = native.BUILD_DIR / f"libfastcsv_buildtest_{os.getpid()}.so"
    try:
        native.build(so)
        import ctypes
        assert hasattr(ctypes.CDLL(str(so)), "csv_parse")
    finally:
        so.unlink(missing_ok=True)
    assert len(calls) == 1
    cmd = calls[0]
    assert cmd[0] == native.COMPILER == "g++"
    assert [a for a in cmd if a.endswith((".cpp", ".cc", ".c"))] == \
        [str(native.SRC)]
    out = Path(cmd[cmd.index("-o") + 1])
    assert out.parent == native.BUILD_DIR and out.suffix == ".tmp"
    assert not any("h2o3_tpu/" in a for a in cmd)
    assert {p: p.read_bytes() for p in theirs} == theirs


def test_failed_tokenizer_build_raises(monkeypatch, tmp_path):
    """No toolchain, or a source the compiler refuses: the build raises
    with the compiler's message (the port has no quiet fallback)."""
    from h2o3_tpu_torch import native
    so = tmp_path / "lib.so"
    monkeypatch.setattr(native, "COMPILER", "no-such-compiler-h2o3")
    with pytest.raises(RuntimeError, match="could not run"):
        native.build(so)
    monkeypatch.setattr(native, "COMPILER", "g++")
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC", bad)
    with pytest.raises(RuntimeError, match="exited 1 compiling bad.cpp"):
        native.build(so)
    assert not so.exists()


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


@pytest.mark.parametrize("case", ["floor_cpu", "floor_no_prev",
                                  "form_cpu", "form_unknown",
                                  "floor_f_rows_cpu", "floor_layout",
                                  "column_cpu", "level_form_unknown"])
def test_measurement_wrappers_refuse_bad_calls(case):
    """The route's loads-only floor (K9's, and K6's in [F, rows]), the
    forced forms of segment_totals and the column form of adaptive_level
    (for chip_smoke.py and the tests) refuse CPU tensors, a missing
    previous level, an unknown layout and an unknown form before anything
    is built."""
    nid = torch.zeros(8, dtype=torch.int32)
    x = torch.zeros((8, 2), dtype=torch.float32)
    ftab = torch.zeros((4, 1), dtype=torch.float32)
    ghw = torch.zeros((3, 8))
    rng = torch.zeros((1, 2), dtype=torch.float32)
    call, err = {
        "floor_cpu": (lambda: kernels.adaptive_route_floor(x, nid, ftab, 1,
                                                           1), "CUDA kernel"),
        "floor_no_prev": (lambda: kernels.adaptive_route_floor(
            x, nid, ftab, 0, 1), "previous level"),
        "form_cpu": (lambda: kernels.segment_totals_form(nid, ghw, 2, 1,
                                                         "lanes"),
                     "CUDA kernel"),
        "form_unknown": (lambda: kernels.segment_totals_form(nid, ghw, 2, 1,
                                                             "rows"),
                         "unknown totals form"),
        "floor_f_rows_cpu": (lambda: kernels.adaptive_route_floor(
            x.t().contiguous(), nid, ftab, 1, 1, "f_rows"), "CUDA kernel"),
        "floor_layout": (lambda: kernels.adaptive_route_floor(
            x, nid, ftab, 1, 1, "cols"), "unknown layout"),
        "column_cpu": (lambda: kernels.adaptive_level_form(
            x.t().contiguous(), nid, ghw, ftab, rng, rng, 0, 1, 0, 16, False,
            "f_rows", "column"), "CUDA kernel"),
        "level_form_unknown": (lambda: kernels.adaptive_level_form(
            x.t().contiguous(), nid, ghw, ftab, rng, rng, 0, 1, 0, 16, False,
            "f_rows", "columns"), "unknown level form")}[case]
    with pytest.raises(ValueError, match=err):
        call()


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
                                   "wide": 2, "column": 3}
    assert kernels._form_code("wide") == 2
    assert kernels._form_code(True) == 1 and kernels._form_code(False) == 0
    with pytest.raises(ValueError, match="unknown level form"):
        kernels._form_code("fastest")
    text = (ROOT / "h2o3_tpu_torch" / "csrc" / "level_wide.cuh").read_text()
    for name, code in (("kPickForm", -1), ("kTiledForm", 0),
                       ("kTensorForm", 1), ("kWideForm", 2),
                       ("kColumnForm", 3)):
        assert f"{name} = {code}," in text
    assert text.count(" = ", text.index("enum LevelForm"),
                      text.index("};", text.index("enum LevelForm"))) == 5


def _tool_sources():
    return sorted((ROOT / "h2o3_tpu_torch" / "tools").glob("*.py"))


@pytest.mark.parametrize("path", _tool_sources(),
                         ids=lambda p: p.name)
def test_probe_tools_import_no_jax_reference_or_tpu_tools(path):
    """The probe tools stand alone: no jax, nothing of h2o3_tpu and
    nothing of the JAX package's tools/ (whose probes they port)."""
    for mod in _imported(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN + ("tools",), f"{path.name} imports {mod}"


def test_probe_tools_import_leaves_jax_out():
    mods = ", ".join(f"h2o3_tpu_torch.tools.{p.stem}"
                     for p in _tool_sources())
    code = (f"import sys; import {mods}; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'h2o3_tpu', 'tools')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    # __init__, _probes, five probe tools and the multi-process worker
    assert len(_tool_sources()) == 8
