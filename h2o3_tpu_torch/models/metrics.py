"""Model metrics: computed on the scores' device, finished on the host.

Counterpart of the regression and binomial parts of
``h2o3_tpu/models/metrics.py``. The AUC curve is exact (device sort,
host chord rule) up to ``_EXACT_SWEEP_ROWS`` rows; above that it uses an
order-preserving 2^17-bucket histogram of the float32 score bits, so
nothing O(n) crosses to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

_AUC_BIN_BITS = 17
_AUC_BINS = 1 << _AUC_BIN_BITS
_EXACT_SWEEP_ROWS = 200_000


def _host(*ts):
    return [t.cpu().numpy() for t in ts]


# ---------------------------------------------------------------- regression


def _regression_kernel(pred, actual, w):
    tot = w.sum()
    err = actual - pred
    mse = (w * err * err).sum() / tot
    mae = (w * err.abs()).sum() / tot
    both_pos = (actual >= 0) & (pred >= 0)
    sle = torch.where(both_pos,
                      (torch.log1p(pred) - torch.log1p(actual)) ** 2, 0.0)
    rmsle_ok = both_pos.all()
    rmsle = torch.sqrt((w * sle).sum() / tot)
    mean_a = (w * actual).sum() / tot
    ss_tot = (w * (actual - mean_a) ** 2).sum()
    r2 = 1.0 - (w * err * err).sum() / torch.clamp(ss_tot, min=1e-30)
    return mse, mae, rmsle, rmsle_ok, r2, mean_a


@dataclass
class ModelMetricsRegression:
    mse: float
    rmse: float
    mae: float
    rmsle: float
    r2: float
    mean_residual_deviance: float
    nobs: int

    def to_dict(self) -> Dict:
        return {"MSE": self.mse, "RMSE": self.rmse, "mae": self.mae,
                "rmsle": self.rmsle, "r2": self.r2,
                "mean_residual_deviance": self.mean_residual_deviance,
                "nobs": self.nobs}


def make_regression_metrics(pred, actual, weights=None,
                            deviance=None) -> ModelMetricsRegression:
    pred = pred.to(torch.float32)
    actual = actual.to(torch.float32)
    w = torch.ones_like(actual) if weights is None else weights.float()
    mse, mae, rmsle, rmsle_ok, r2, _ = _host(
        *_regression_kernel(pred, actual, w))
    mse = float(mse)
    return ModelMetricsRegression(
        mse=mse, rmse=float(np.sqrt(mse)), mae=float(mae),
        rmsle=float(rmsle) if bool(rmsle_ok) else float("nan"),
        r2=float(r2),
        mean_residual_deviance=(float(deviance) if deviance is not None
                                else mse),
        nobs=int(pred.shape[0]))


# ------------------------------------------------------------------ binomial


def _sorted_sweep_kernel(score, y, w):
    """Descending stable sort plus cumulative weighted TP/FP."""
    order = torch.argsort(-score, stable=True)
    s = score[order]
    tp = torch.cumsum((w * y)[order], dim=0)
    fp = torch.cumsum((w * (1.0 - y))[order], dim=0)
    return s, tp, fp


def _binned_curve_kernel(score, y, w):
    """Order-preserving float32-bit bucketisation into 2^17 bins plus
    scatter-add histograms: negatives flip all bits, positives set the
    sign bit, so unsigned keys follow score order."""
    s32 = score.to(torch.float32)
    bits = s32.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where((bits >> 31) == 1, (~bits) & 0xFFFFFFFF,
                      bits | 0x80000000)
    b = key >> (32 - _AUC_BIN_BITS)
    hp = torch.zeros(_AUC_BINS, dtype=torch.float32,
                     device=score.device).index_add_(0, b, w * y)
    hn = torch.zeros(_AUC_BINS, dtype=torch.float32,
                     device=score.device).index_add_(0, b, w * (1.0 - y))
    smax = torch.full((_AUC_BINS,), -torch.inf, dtype=torch.float32,
                      device=score.device).scatter_reduce_(
                          0, b, s32, reduce="amax", include_self=True)
    return hp, hn, smax


def auc_device(score, y, w):
    """Scalar AUC on the device from the 2^17-bucket curve (empty buckets
    add zero-width chords)."""
    hp, hn, _ = _binned_curve_kernel(score, y, w)
    tp = torch.cumsum(hp.flip(0), dim=0)
    fp = torch.cumsum(hn.flip(0), dim=0)
    P, N = tp[-1], fp[-1]
    z = torch.zeros(1, dtype=tp.dtype, device=tp.device)
    tp_prev = torch.cat([z, tp[:-1]])
    fp_prev = torch.cat([z, fp[:-1]])
    return ((fp - fp_prev) * (tp + tp_prev)).sum() * 0.5 \
        / torch.clamp(P * N, min=1e-30)


def _binary_curve(prob, y, w):
    """(sb, tpb, fpb, P, N, auc, aucpr): descending score thresholds with
    cumulative weighted TP/FP at tie-run boundaries, the chord-rule AUC
    and the step-interpolated PR AUC."""
    n = int(prob.shape[0])
    if n <= _EXACT_SWEEP_ROWS:
        s, tp, fp = _host(*_sorted_sweep_kernel(prob, y, w))
        is_b = np.concatenate([s[1:] != s[:-1], [True]])
        sb, tpb, fpb = s[is_b], tp[is_b], fp[is_b]
    else:
        hp, hn, smax = _host(*_binned_curve_kernel(prob, y, w))
        occ = np.isfinite(smax) & ((hp > 0) | (hn > 0))
        sb = smax[occ][::-1]
        tpb = np.cumsum(hp[occ][::-1])
        fpb = np.cumsum(hn[occ][::-1])
    P = float(tpb[-1]) if len(tpb) else 0.0
    N = float(fpb[-1]) if len(fpb) else 0.0
    tp_prev = np.concatenate([[0.0], tpb[:-1]])
    fp_prev = np.concatenate([[0.0], fpb[:-1]])
    auc = float(((fpb - fp_prev) * (tpb + tp_prev)).sum()
                * 0.5 / max(P * N, 1e-30))
    prec = tpb / np.maximum(tpb + fpb, 1e-30)
    rec = tpb / max(P, 1e-30)
    rec_prev = tp_prev / max(P, 1e-30)
    aucpr = float(((rec - rec_prev) * prec).sum())
    return sb, tpb, fpb, P, N, auc, aucpr


def _logloss_kernel(p, y, w):
    eps = 1e-7  # f32-safe: 1-1e-15 rounds to 1.0f -> log1p(-1) = -inf
    p = torch.clamp(p, eps, 1.0 - eps)
    return -(w * (y * torch.log(p) + (1.0 - y) * torch.log1p(-p))).sum() \
        / w.sum()


@dataclass
class ModelMetricsBinomial:
    auc: float
    aucpr: float
    logloss: float
    mse: float
    rmse: float
    gini: float
    mean_per_class_error: float
    r2: float
    f1_threshold: float
    max_f1: float
    confusion_matrix: np.ndarray  # [[tn, fp], [fn, tp]] at max-F1 threshold
    accuracy: float
    nobs: int
    thresholds_and_metric_scores: Optional[dict] = None

    def to_dict(self) -> Dict:
        return {"AUC": self.auc, "pr_auc": self.aucpr,
                "logloss": self.logloss, "MSE": self.mse, "RMSE": self.rmse,
                "Gini": self.gini,
                "mean_per_class_error": self.mean_per_class_error,
                "r2": self.r2, "max_f1": self.max_f1,
                "f1_threshold": self.f1_threshold,
                "cm": self.confusion_matrix.tolist(),
                "accuracy": self.accuracy, "nobs": self.nobs}


def _threshold_columns(thr, tp, fp, P, N):
    """Per-threshold metric columns; tp/fp are cumulative weighted counts
    predicting positive at score >= thr."""
    fn = P - tp
    tn = N - fp
    tot = max(P + N, 1e-30)
    precision = tp / np.maximum(tp + fp, 1e-30)
    recall = tp / max(P, 1e-30)
    specificity = tn / max(N, 1e-30)
    fpr = fp / max(N, 1e-30)
    fnr = fn / max(P, 1e-30)
    accuracy = (tp + tn) / tot
    f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-30)
    f2 = 5 * precision * recall / np.maximum(4 * precision + recall, 1e-30)
    f0point5 = (1.25 * precision * recall
                / np.maximum(0.25 * precision + recall, 1e-30))
    mcc_den = np.sqrt(np.maximum(
        (tp + fp) * (tp + fn) * (tn + fp) * (tn + fn), 1e-30))
    mcc = (tp * tn - fp * fn) / mcc_den
    return {
        "threshold": thr, "f1": f1, "f2": f2, "f0point5": f0point5,
        "accuracy": accuracy, "precision": precision, "recall": recall,
        "specificity": specificity, "absolute_mcc": np.abs(mcc),
        "min_per_class_accuracy": np.minimum(recall, specificity),
        "mean_per_class_accuracy": 0.5 * (recall + specificity),
        "tns": tn, "fns": fn, "fps": fp, "tps": tp,
        "tnr": specificity, "fnr": fnr, "fpr": fpr, "tpr": recall,
    }


_MAX_CRITERIA = ["f1", "f2", "f0point5", "accuracy", "precision", "recall",
                 "specificity", "absolute_mcc", "min_per_class_accuracy",
                 "mean_per_class_accuracy"]


def _gains_lift_from_curve(sb, tpb, fpb, Pf, Nf, groups: int = 16):
    """Gains/lift table from the boundary curve (cum weight = tp + fp)."""
    W = Pf + Nf
    if not (0.0 < Pf < W) or len(sb) == 0:
        return None
    cum_w = tpb + fpb
    edges = np.searchsorted(cum_w, W * np.arange(1, groups + 1) / groups,
                            side="left")
    edges = np.unique(np.minimum(edges, len(cum_w) - 1))
    cw = cum_w[edges]
    cy = tpb[edges]
    lo_w = np.concatenate([[0.0], cw[:-1]])
    lo_y = np.concatenate([[0.0], cy[:-1]])
    grp_w = np.maximum(cw - lo_w, 1e-30)
    grp_y = cy - lo_y
    rate = Pf / W
    return {
        "cumulative_data_fraction": (cw / W).tolist(),
        "lower_threshold": np.asarray(sb)[edges].tolist(),
        "lift": (grp_y / grp_w / rate).tolist(),
        "cumulative_lift": (cy / np.maximum(cw, 1e-30) / rate).tolist(),
        "response_rate": (grp_y / grp_w).tolist(),
        "cumulative_response_rate": (cy / np.maximum(cw, 1e-30)).tolist(),
        "capture_rate": (grp_y / Pf).tolist(),
        "cumulative_capture_rate": (cy / Pf).tolist(),
        "gain": (100.0 * (grp_y / grp_w / rate - 1.0)).tolist(),
        "cumulative_gain": (100.0 * (cy / np.maximum(cw, 1e-30)
                                     / rate - 1.0)).tolist(),
        "kolmogorov_smirnov": float(np.max(np.abs(
            tpb / max(Pf, 1e-30) - fpb / max(Nf, 1e-30)))),
    }


def make_binomial_metrics(prob, actual, weights=None) -> ModelMetricsBinomial:
    """prob = P(class 1) and actual in {0, 1}, as tensors on one device."""
    prob = prob.to(torch.float32)
    y = actual.to(torch.float32)
    w = torch.ones_like(y) if weights is None else weights.float()
    n = int(prob.shape[0])
    sb, tpb, fpb, Pf, Nf, auc, aucpr = _binary_curve(prob, y, w)
    ll = float(_logloss_kernel(prob, y, w))
    reg = _regression_kernel(prob, y, w)
    mse = float(reg[0])
    r2 = float(reg[4])
    fnb = Pf - tpb
    tnb = Nf - fpb
    prec = tpb / np.maximum(tpb + fpb, 1e-30)
    rec = tpb / max(Pf, 1e-30)
    f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-30)
    bi = int(np.argmax(f1))
    cm = np.array([[tnb[bi], fpb[bi]], [fnb[bi], tpb[bi]]])
    per_class_err = 0.5 * (fpb[bi] / max(Nf, 1e-30) + fnb[bi] / max(Pf, 1e-30))
    acc = (tpb[bi] + tnb[bi]) / max(Pf + Nf, 1e-30)
    n_b = len(sb)
    if n_b > 400:
        keep = np.unique(np.round(np.linspace(0, n_b - 1, 400)).astype(int))
    else:
        keep = np.arange(n_b)
    table = _threshold_columns(sb[keep], tpb[keep], fpb[keep], Pf, Nf)
    table = {k: np.asarray(v).tolist() for k, v in table.items()}
    full = _threshold_columns(sb, tpb, fpb, Pf, Nf)
    max_crit = {}
    for c in _MAX_CRITERIA:
        i = int(np.argmax(full[c]))
        ti = min(int(np.searchsorted(keep, i)), len(keep) - 1)
        max_crit[c] = {"threshold": float(sb[i]), "value": float(full[c][i]),
                       "idx": ti}
    table["max_criteria_and_metric_scores"] = max_crit
    table["gains_lift"] = _gains_lift_from_curve(sb, tpb, fpb, Pf, Nf)
    return ModelMetricsBinomial(
        auc=auc, aucpr=aucpr, logloss=ll, mse=mse, rmse=float(np.sqrt(mse)),
        gini=2 * auc - 1, mean_per_class_error=float(per_class_err), r2=r2,
        f1_threshold=float(sb[bi]), max_f1=float(f1[bi]),
        confusion_matrix=cm, accuracy=float(acc), nobs=n,
        thresholds_and_metric_scores=table)
