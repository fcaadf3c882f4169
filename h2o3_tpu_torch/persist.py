"""Model persistence — ``save_model`` / ``load_model``, the model half of
``h2o3_tpu/persist.py``.

A model artifact is one zip holding ``meta.json`` (parameters, feature
and domain metadata, output, metrics) and ``arrays.npz`` (the model's
arrays), written through per-algorithm hooks (``Model._save_arrays``,
``_save_extra_meta``, ``_restore``). The layout and its keys are the JAX
package's, so that either package loads what the other wrote. The class
registry covers the algorithms the port trains (gbm, drf, glm; xgboost
trains a GBM model); any other algo raises ``ValueError``, as the JAX package
does for an algo it does not know. Frames (``save_frame``,
``export_file``, ``load_frame``) wait for ROADMAP.md item 18.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

FORMAT_VERSION = 1

# algo -> model class, filled at the first lookup (the model modules
# import this one)
_MODEL_CLASSES: Dict[str, Any] = {}


def register_model_class(algo: str, cls) -> None:
    _MODEL_CLASSES[algo] = cls


def _model_class(algo: str):
    if not _MODEL_CLASSES:
        from h2o3_tpu_torch.models import drf, gbm, glm  # noqa: F401
    if algo not in _MODEL_CLASSES:
        raise ValueError(f"no registered model class for algo '{algo}'")
    return _MODEL_CLASSES[algo]


def _json_safe(obj):
    """JSON-serialisable Python: numpy and torch values as lists and
    scalars; objects of other types dropped (None)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()
                if _is_safe(v)}
    return None


def _is_safe(v) -> bool:
    return isinstance(v, (type(None), bool, int, float, str, list, tuple,
                          dict, np.ndarray, np.integer, np.floating,
                          torch.Tensor))


def _metric_classes():
    from h2o3_tpu_torch.models import metrics as mm
    return {"regression": mm.ModelMetricsRegression,
            "binomial": mm.ModelMetricsBinomial,
            "multinomial": mm.ModelMetricsMultinomial}


def _metrics_to_meta(m) -> Optional[Dict]:
    if m is None:
        return None
    kind = {cls: k for k, cls in _metric_classes().items()}.get(type(m))
    if kind is None:
        return None
    return {"kind": kind, "fields": _json_safe(dataclasses.asdict(m))}


def _metrics_from_meta(meta: Optional[Dict]):
    if meta is None or meta.get("kind") not in _metric_classes():
        return None
    cls = _metric_classes()[meta["kind"]]
    f = dict(meta["fields"])
    for k in ("confusion_matrix", "hit_ratios"):
        if f.get(k) is not None:
            f[k] = np.asarray(f[k])
    names = {fl.name for fl in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in f.items() if k in names})


def model_to_meta(model) -> Dict:
    """A model's JSON-safe metadata, in the JAX package's keys."""
    return {
        "format_version": FORMAT_VERSION,
        "algo": model.algo,
        "key": model.key,
        "params": _json_safe(model.params),
        "feature_names": model.feature_names,
        "feature_is_cat": model.feature_is_cat,
        "cat_domains": {k: list(v) for k, v in model.cat_domains.items()},
        "response": model.response,
        "response_domain": (list(model.response_domain)
                            if model.response_domain else None),
        "nclasses": model.nclasses,
        "output": _json_safe(model.output),
        "training_frame_key": getattr(model, "training_frame_key", None),
        "scoring_history": _json_safe(model.scoring_history),
        "training_metrics": _metrics_to_meta(model.training_metrics),
        "validation_metrics": _metrics_to_meta(model.validation_metrics),
        "cross_validation_metrics": _metrics_to_meta(
            model.cross_validation_metrics),
        "extra": _json_safe(model._save_extra_meta()),
    }


def model_from_meta(meta: Dict, arrays: Dict, device=None):
    """The inverse of ``model_to_meta`` and ``_save_arrays``: a live
    model on ``device`` (the card unless the CPU is asked for)."""
    model = _model_class(meta["algo"])._restore(meta, arrays, device)
    model.training_metrics = _metrics_from_meta(meta.get("training_metrics"))
    model.validation_metrics = _metrics_from_meta(
        meta.get("validation_metrics"))
    model.cross_validation_metrics = _metrics_from_meta(
        meta.get("cross_validation_metrics"))
    model.scoring_history = meta.get("scoring_history") or []
    model.training_frame_key = meta.get("training_frame_key")
    return model


def save_model(model, path: str = ".", force: bool = False,
               filename: Optional[str] = None) -> str:
    """Write a model artifact and return its path (h2o.save_model's
    signature): ``path`` a directory (the file is named ``filename`` or
    the model's key) or the file itself. The zip is written beside its
    final name and renamed over it, so that a killed write never leaves
    a truncated artifact under that name. ``arrays.npz`` is stored, not
    deflated: float arrays gain a few percent from deflate and a 10M-row
    resume margin would spend seconds on it (either package reads either
    member form)."""
    if os.path.isdir(path) or not os.path.splitext(path)[1]:
        os.makedirs(path, exist_ok=True)
        out = os.path.join(path, filename or model.key)
    else:
        out = path
    if os.path.exists(out) and not force:
        raise FileExistsError(f"{out} exists (pass force=True to overwrite)")
    meta = model_to_meta(model)
    arrays = {k: np.asarray(v) for k, v in model._save_arrays().items()}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with zipfile.ZipFile(out + ".tmp", "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("meta.json", json.dumps(meta))
        zf.writestr("arrays.npz", buf.getvalue(),
                    compress_type=zipfile.ZIP_STORED)
    os.replace(out + ".tmp", out)
    return out


def load_model(path: str, device=None):
    """Read a model artifact back into a live model on ``device``
    (h2o.load_model; the card unless the CPU is asked for). Reads retry
    transient I/O errors as the JAX package's do."""
    from h2o3_tpu_torch.resilience import is_transient_io, retry_transient

    def _read():
        with zipfile.ZipFile(path, "r") as zf:
            return (json.loads(zf.read("meta.json")),
                    dict(np.load(io.BytesIO(zf.read("arrays.npz")))))

    meta, arrays = retry_transient(_read, site="persist.load_model",
                                   classify=is_transient_io)
    if meta.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(f"artifact format {meta['format_version']} is newer "
                         f"than this build ({FORMAT_VERSION})")
    return model_from_meta(meta, arrays, device)
