"""Model metrics: computed on the scores' device, finished on the host.

Counterpart of the regression, binomial and multinomial parts of
``h2o3_tpu/models/metrics.py``. The AUC curve is exact (device sort,
host chord rule) up to ``_EXACT_SWEEP_ROWS`` rows; above that it uses an
order-preserving 2^17-bucket histogram of the float32 score bits, so
nothing O(n) crosses to the host. The bucket sums and ``auc_device`` add
in a fixed order (no float atomics), so they repeat bit for bit. The
multinomial aggregates (confusion matrix, hit positions, one-vs-rest
AUCs on the same bucket curve) are plain reductions too, fetched in one
host copy.
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


def _run_scan(vals, keys=None):
    """Inclusive sums of ``vals`` [n, C] down the rows, restarted where
    ``keys`` (sorted; None: one run) changes, in a fixed order: a
    Hillis-Steele scan, whose step k adds row i-k into row i. Elementwise
    adds only, so the same inputs give the same bits on every device and
    in every call (no atomics, no scan whose association follows the
    schedule)."""
    n = vals.shape[0]
    k = 1
    while k < n:
        add = vals[:-k]
        if keys is not None:
            add = torch.where((keys[k:] == keys[:-k])[:, None], add, 0.0)
        vals = torch.cat([vals[:k], vals[k:] + add])
        k *= 2
    return vals


def _fixed_sum(x):
    """Sum of a power-of-two-long vector by halving, in a fixed order."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x[0]


def _bucket_sums(b, vals, n_buckets=_AUC_BINS):
    """Per-bucket sums [n_buckets, C] of ``vals`` [n, C] over bucket ids
    ``b`` in [0, n_buckets), in a fixed order: a stable sort groups each
    bucket's rows in row order, a run-restarted scan sums them, and each
    run's last row is written to its bucket (one writer a bucket)."""
    bs, order = torch.sort(b, stable=True)
    run = _run_scan(vals[order], bs)
    last = torch.ones_like(bs, dtype=torch.bool)
    last[:-1] = bs[1:] != bs[:-1]
    out = torch.zeros((n_buckets, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    out[bs[last]] = run[last]
    return out


def _binned_curve_kernel(score, y, w):
    """Order-preserving float32-bit bucketisation into 2^17 bins plus
    per-bucket sums of w·y and w·(1-y) in a fixed order (negatives flip
    all bits, positives set the sign bit, so unsigned keys follow score
    order) and each bucket's largest score."""
    s32 = score.to(torch.float32)
    bits = s32.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where((bits >> 31) == 1, (~bits) & 0xFFFFFFFF,
                      bits | 0x80000000)
    b = key >> (32 - _AUC_BIN_BITS)
    h = _bucket_sums(b, torch.stack([w * y, w * (1.0 - y)], dim=1))
    smax = torch.full((_AUC_BINS,), -torch.inf, dtype=torch.float32,
                      device=score.device).scatter_reduce_(
                          0, b, s32, reduce="amax", include_self=True)
    return h[:, 0], h[:, 1], smax


def _curve_aucs(hp, hn):
    """The chord-rule AUC and the step PR AUC of a 2^17-bucket curve
    (per-bucket positive and negative weights in ascending score order),
    each carried in float64 in a fixed order and rounded once to
    float32."""
    cum = _run_scan(torch.stack([hp, hn], dim=1).flip(0).double())
    tp, fp = cum[:, 0], cum[:, 1]
    P, N = tp[-1], fp[-1]
    z = torch.zeros(1, dtype=tp.dtype, device=tp.device)
    tp_prev = torch.cat([z, tp[:-1]])
    fp_prev = torch.cat([z, fp[:-1]])
    auc = _fixed_sum((fp - fp_prev) * (tp + tp_prev)) * 0.5 \
        / torch.clamp(P * N, min=1e-30)
    prec = tp / torch.clamp(tp + fp, min=1e-30)
    rec = tp / torch.clamp(P, min=1e-30)
    rec_prev = tp_prev / torch.clamp(P, min=1e-30)
    aucpr = _fixed_sum((rec - rec_prev) * prec)
    return auc.to(torch.float32), aucpr.to(torch.float32)


def auc_device(score, y, w):
    """Scalar float32 AUC on the device from the 2^17-bucket curve (empty
    buckets add zero-width chords). Every float sum comes in a fixed
    order, so the same inputs give the same bits in every call: the
    early-stopping rule reads it. The float32 bucket sums are carried
    through the curve and the chord sum in float64 and rounded once at
    the end, where a float32 pass drifts by a few units in the last
    place with the order of its adds."""
    return _curve_aucs(*_binned_curve_kernel(score, y, w)[:2])[0]


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


# --------------------------------------------------------------- multinomial


def _multinomial_kernel(probs, y, w):
    """The multinomial aggregates on the scores' device: logloss, argmax
    error, the confusion matrix [K, K] (weights summed in a fixed order
    over the key y·K + pred), one-vs-all MSE (1 - p_actual) and the hit-position
    histogram (each row's position of its true class in the stable
    descending sort of its probabilities, counted over rows in a fixed
    order)."""
    eps = 1e-7  # f32-safe: 1-1e-15 rounds to 1.0f -> log1p(-1) = -inf
    rows, K = probs.shape
    yl = y.long()
    # y is a class code >= 0 (the specs give an NA response code 0 and
    # weight 0), so the gather needs no mask
    py = probs.gather(1, yl[:, None])[:, 0]
    wsum = w.sum()
    ll = -(w * torch.log(torch.clamp(py, eps, 1.0))).sum() / wsum
    pred = torch.argmax(probs, dim=1)
    err = (w * (pred != yl)).sum() / wsum
    cm = _bucket_sums(yl * K + pred, w[:, None], K * K).reshape(K, K)
    mse = (w * (1.0 - py) ** 2).sum() / wsum
    ranks = torch.argsort(-probs, dim=1, stable=True)
    pos = torch.argmax((ranks == yl[:, None]).to(torch.int32), dim=1)
    # times the float32 reciprocal of the row count, not divided by it:
    # XLA rewrites the JAX package's division by a constant so
    hitpos = _bucket_sums(pos, torch.ones_like(w)[:, None], K)[:, 0] \
        * torch.tensor(1.0 / rows, dtype=torch.float32, device=w.device)
    return ll, err, cm, mse, hitpos


def _ovr_auc_kernel(probs, y, w):
    """One-vs-rest AUC and PR AUC per class on the device, each class
    column through the 2^17-bucket curve of ``auc_device``: [K] AUCs,
    [K] PR AUCs (NaN for a class with no positives or no negatives under
    the weights) and [K] class weights."""
    wtot = w.sum()
    aucs, prs, prev = [], [], []
    for k in range(probs.shape[1]):
        yk = (y == k).to(torch.float32)
        hp, hn, _ = _binned_curve_kernel(probs[:, k], yk, w)
        auc, aucpr = _curve_aucs(hp, hn)
        aucs.append(auc)
        prs.append(aucpr)
        prev.append((w * yk).sum())
    per_auc, per_pr, prevalence = (torch.stack(aucs), torch.stack(prs),
                                   torch.stack(prev))
    bad = (prevalence <= 0) | (prevalence >= wtot)
    nan = torch.full_like(per_auc, float("nan"))
    return (torch.where(bad, nan, per_auc), torch.where(bad, nan, per_pr),
            prevalence)


def _auc_table(pa, pp, pv) -> dict:
    """Per-class OVR AUCs with their macro and prevalence-weighted means,
    from the host copies of ``_ovr_auc_kernel``'s outputs."""
    pa = np.asarray(pa, np.float64)
    pp = np.asarray(pp, np.float64)
    pv = np.asarray(pv, np.float64)
    pv = pv / max(pv.sum(), 1e-30)
    ok = ~np.isnan(pa)
    macro = float(pa[ok].mean()) if ok.any() else float("nan")
    weighted = float((pa[ok] * pv[ok]).sum() / max(pv[ok].sum(), 1e-30)) \
        if ok.any() else float("nan")
    macro_pr = float(pp[ok].mean()) if ok.any() else float("nan")
    weighted_pr = float((pp[ok] * pv[ok]).sum() / max(pv[ok].sum(), 1e-30)) \
        if ok.any() else float("nan")
    return {"per_class_auc": [float(v) for v in pa],
            "per_class_aucpr": [float(v) for v in pp],
            "macro_auc": macro, "weighted_auc": weighted,
            "macro_aucpr": macro_pr, "weighted_aucpr": weighted_pr}


def multinomial_auc_table(probs, y, w, max_classes=20) -> Optional[dict]:
    """One-vs-rest AUC per class and the macro and weighted averages
    (hex/MultinomialAUC.java's default); None above ``max_classes``."""
    if int(probs.shape[1]) > max_classes:
        return None
    pa, pp, pv = _host(*_ovr_auc_kernel(probs.to(torch.float32), y,
                                        w.to(torch.float32)))
    return _auc_table(pa, pp, pv)


@dataclass
class ModelMetricsMultinomial:
    logloss: float
    mse: float
    rmse: float
    mean_per_class_error: float
    error: float
    confusion_matrix: np.ndarray
    hit_ratios: np.ndarray
    nobs: int
    auc: Optional[float] = None          # macro one-vs-rest
    aucpr: Optional[float] = None
    auc_table: Optional[dict] = None     # per-class OVR auc/aucpr + means

    def to_dict(self) -> Dict:
        return {"logloss": self.logloss, "MSE": self.mse, "RMSE": self.rmse,
                "mean_per_class_error": self.mean_per_class_error,
                "error": self.error, "cm": self.confusion_matrix.tolist(),
                "hit_ratios": self.hit_ratios.tolist(), "nobs": self.nobs,
                "AUC": self.auc, "pr_auc": self.aucpr}


def make_multinomial_metrics(probs, actual, weights=None,
                             max_auc_classes: int = 20
                             ) -> ModelMetricsMultinomial:
    """Every aggregate computed on the scores' device and fetched in one
    host copy of O(K^2) numbers (the confusion matrix, the hit histogram,
    the OVR AUC scalars); the [n, K] probabilities never cross."""
    probs = probs.to(torch.float32)
    y = actual.to(torch.int32)
    w = (torch.ones(probs.shape[0], dtype=torch.float32,
                    device=probs.device)
         if weights is None else weights.to(torch.float32))
    K = int(probs.shape[1])
    ll, err, cm, mse, hitpos = _multinomial_kernel(probs, y, w)
    parts = [torch.stack([ll, err, mse]), cm.reshape(-1), hitpos]
    with_auc = K <= max_auc_classes
    if with_auc:
        parts += list(_ovr_auc_kernel(probs, y, w))
    h = torch.cat([t.to(torch.float64) for t in parts]).cpu().numpy()
    ll, err, mse = (float(v) for v in h[:3])
    cm = h[3:3 + K * K].reshape(K, K).astype(np.float32)
    hitpos = h[3 + K * K: 3 + K * K + K]
    row_tot = cm.sum(axis=1)
    per_class = np.where(row_tot > 0,
                         1.0 - np.diag(cm) / np.maximum(row_tot, 1e-30), 0.0)
    present = row_tot > 0
    mpce = float(per_class[present].mean()) if present.any() else 0.0
    # hit ratio @k: the share of rows whose true class ranks in the top k
    hr = np.cumsum(hitpos)[: min(K, 10)]
    auct = None
    if with_auc:
        o = 3 + K * K + K
        auct = _auc_table(h[o:o + K], h[o + K:o + 2 * K],
                          h[o + 2 * K:o + 3 * K])
    return ModelMetricsMultinomial(
        logloss=ll, mse=mse, rmse=float(np.sqrt(mse)),
        mean_per_class_error=mpce, error=err, confusion_matrix=cm,
        hit_ratios=hr, nobs=int(probs.shape[0]),
        auc=None if auct is None else auct["macro_auc"],
        aucpr=None if auct is None else auct["macro_aucpr"],
        auc_table=auct)
