"""GBM — gradient boosting on packed bin codes, adaptive bins or the
unpacked global sketch.

Counterpart of ``h2o3_tpu/models/gbm.py``: the in-memory trainer
(``_train_dense``) and the per-iteration body of its boosting chunk, as
a Python loop. The trainer takes the JAX package's path for the same
parameters (``models/tree.py`` holds the rule): packed codes, binned once
per train by the global sketch (``packed_codes`` 'auto' or True on every
device); per-node adaptive bins on the raw features
(``packed_codes=False``, and the fallback where packing cannot hold the
bins); or the global sketch's codes unpacked, where neither holds them
(more than 254 bins) or ``quantiles_global`` is asked for without
packing. An iteration of a one-margin family grows one tree: (g, h) from
the distribution at the current margin (which carries
``offset_column``: the offset enters the margin, not the trees), and the
tree's leaf values folded back into the margin through the leaf ids the
grower already routed. A multinomial iteration grows K trees, all from
the softmax of the margin at its start, each folded into its class's
column. With a validation frame each tree is also walked over the
validation rows in the path's own representation. With early stopping
or a ``score_tree_interval`` the loop scores every interval of
iterations (validation rows where there are some) with one
device-to-host copy of the interval's scalars, and stops where
``ScoreKeeper`` says so; it builds no tree past the stop. Trees are
fetched to the host once, at the end.

Sampling (``sample_rate``, ``sample_rate_per_class``, the column rates,
``histogram_type="random"``) draws from the port's copy of the JAX
package's generator (``ops/random.py``) with the same keys: iteration
i's key is ``fold_in(key, i)``, split into the row and the column key,
and the K trees of a multinomial iteration share its sample, its
column mask and its key. Rates of 1 make no draw.

Parameters the port does not support yet raise ``NotImplementedError``
naming the ROADMAP.md item that brings them; none is silently ignored.
The reference's compatibility-only parameters (``GBM_COMPAT_PARAMS``)
are accepted, as the JAX package accepts them, with a warning at
``train()`` for each one set away from its default.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from h2o3_tpu_torch import _device
from h2o3_tpu_torch.models.distributions import (get_distribution,
                                                 offset_adjusted_f0, sigmoid,
                                                 softmax, weighted_median,
                                                 weighted_quantile)
from h2o3_tpu_torch.models.metrics import auc_device
from h2o3_tpu_torch.models.model_base import (BUILDER_PARAMS, Model,
                                              ModelBuilder, ScoreKeeper,
                                              TrainingSpec, compute_metrics)
from h2o3_tpu_torch.models.tree import (ADAPTIVE_HIST_TYPES,
                                        adaptive_feasible, adaptive_setup,
                                        binned_feasible,
                                        bins_to_thresholds_stacked,
                                        grow_tree, grow_tree_adaptive,
                                        grow_tree_binned,
                                        packed_bins_upper_bound,
                                        packed_codes_requested,
                                        predict_binned, predict_raw_margin,
                                        predict_raw_tree, tree_config,
                                        tree_sample)
from h2o3_tpu_torch.log import warn
from h2o3_tpu_torch.ops.binning import (bin_matrix_device,
                                        digitize_with_edges, pack_codes,
                                        pack_codes_for, packed_codes_record)
from h2o3_tpu_torch.ops.random import fold_in, split, train_key

# feature layout of the adaptive level kernels on the training path:
# "rows_f" ([rows, F], the training matrix as it is) or "f_rows"
# ([F, rows], one more copy of the features)
ADAPTIVE_LAYOUT = "rows_f"

# the JAX package's GBM_DEFAULTS without its TPU kernel switch
GBM_DEFAULTS: Dict = dict(
    ntrees=50, max_depth=5, min_rows=10.0, learn_rate=0.1,
    learn_rate_annealing=1.0, sample_rate=1.0, sample_rate_per_class=None,
    col_sample_rate=1.0, col_sample_rate_per_tree=1.0,
    col_sample_rate_change_per_level=1.0, nbins=20, nbins_cats=1024,
    distribution="auto", tweedie_power=1.5, quantile_alpha=0.5,
    huber_alpha=0.9, min_split_improvement=1e-5,
    seed=-1, stopping_rounds=0, stopping_metric="auto",
    stopping_tolerance=1e-3, score_tree_interval=0, reg_lambda=0.0,
    checkpoint=None, in_training_checkpoints_dir=None,
    in_training_checkpoints_tree_interval=1,
    max_abs_leafnode_pred=1e30, histogram_type="uniform_adaptive",
    monotone_constraints=None, interaction_constraints=None,
    histogram_precision="auto", packed_codes="auto",
    # read by the JAX trainer through params.get (xgboost-style L1)
    reg_alpha=0.0,
)

# the reference's GBM parameters that the JAX package accepts for API
# compatibility and does not act on (h2o3_tpu/models/compat_params.py):
# merged into every estimator's parameters; train() warns for each one
# set away from its default
GBM_COMPAT_PARAMS: Dict = dict(
    max_confusion_matrix_size=20, nbins_top_level=1024, r2_stopping=None,
    build_tree_one_node=False, pred_noise_bandwidth=0.0,
    categorical_encoding="auto", custom_distribution_func=None,
    check_constant_response=True, auto_rebalance=True,
)

# the JAX package's refusal of an offset on a multinomial train
MULTINOMIAL_OFFSET = ("offset_column is not supported for multinomial GBM "
                      "(matching hex/tree/gbm/GBM.java offset restrictions)")

# parameters of the JAX GBM (and DRF) the port refuses until the named
# ROADMAP.md item (queue 1) lands: (name, predicate on its value, item)
UNSUPPORTED = (
    ("checkpoint", lambda v: v is not None, "item A3, checkpoints"),
    ("in_training_checkpoints_dir", bool, "item A3, checkpoints"),
    ("monotone_constraints", bool, "item A5, constraints"),
    ("interaction_constraints", bool, "item A5, constraints"),
    ("nfolds", lambda v: int(v or 0) > 1,
     "item A7, cross-validation, class balancing and calibration"),
    ("fold_column", bool,
     "item A7, cross-validation, class balancing and calibration"),
    ("balance_classes", bool,
     "item A7, cross-validation, class balancing and calibration"),
    ("calibrate_model", bool,
     "item A7, cross-validation, class balancing and calibration"),
)
# the refused keys that are no default of the estimators
REFUSED_ONLY = {"nfolds", "fold_column", "balance_classes",
                "calibrate_model"}
# keys the JAX GBM accepts outside its defaults and never reads (DRF's
# mtries): accepted, with no effect on the trees, as there
_IGNORED = {"mtries"}


def refuse_params(algo: str, params: Dict, known, unsupported) -> None:
    """Raise ValueError on a parameter outside ``known``, and
    NotImplementedError naming its ROADMAP.md item on one that a row of
    ``unsupported`` refuses."""
    unknown = sorted(set(params) - set(known))
    if unknown:
        raise ValueError(f"{algo}: unknown parameter(s) {unknown}")
    for name, refused, item in unsupported:
        if name in params and refused(params[name]):
            raise NotImplementedError(
                f"{algo}: {name}={params[name]!r} is not ported yet "
                f"(ROADMAP.md queue 1, {item})")


def check_params(params: Dict) -> None:
    """Raise on a parameter the port does not know or does not support
    yet."""
    refuse_params("gbm", params,
                  set(GBM_DEFAULTS) | BUILDER_PARAMS | REFUSED_ONLY
                  | _IGNORED | set(GBM_COMPAT_PARAMS), UNSUPPORTED)


def valid_walk(X, bm, pc, max_depth: int):
    """The validation rows' walk of one tree, made once per train: the
    validation matrix in the training path's representation (packed
    codes with NA in lane W-1, the global sketch's codes with NA =
    n_bins, or the raw features on the adaptive path) and a function of
    a grown tree returning its leaf value per validation row."""
    if bm is None:
        return lambda tree: predict_raw_tree(X, tree, max_depth)[0]
    if pc is not None:
        codes, na_bin = pack_codes_for(X, bm, pc.W), pc.W - 1
    else:
        codes = digitize_with_edges(X, bm.edges, bm.n_bins)
        na_bin = bm.n_bins
    return lambda tree: predict_binned(codes, tree, max_depth, na_bin)[0]


def score_entry(margin, sc_spec: TrainingSpec, dist, built: int,
                want_auc: bool = False) -> Dict:
    """An interval's scoring-history entry (the JAX package's
    ``_score_entry_dev`` and ``_score_entry_fetch``): the scalars stay on
    the device until one copy to the host. For K classes ([rows, K]
    margins, ``dist`` None) ntrees, logloss and deviance = logloss; for
    one margin a row ntrees and deviance, plus for bernoulli logloss
    (deviance / 2) and, where the stopping metric is the AUC, the AUC,
    and for gaussian mse and rmse."""
    w = sc_spec.w
    if dist is None:
        eps = 1e-7  # f32-safe: 1-1e-15 rounds to 1.0f -> log1p(-1) = -inf
        probs = softmax(margin)
        py = torch.clamp(probs.gather(1, sc_spec.y.long()[:, None])[:, 0],
                         eps, 1.0)
        ll = float(-(w * torch.log(py)).sum() / w.sum())
        return {"ntrees": built, "logloss": ll, "deviance": ll}
    yf = sc_spec.y.to(torch.float32)
    mu = dist.predict(margin)
    vals = [dist.deviance(w, yf, mu)]
    if dist.name == "bernoulli" and want_auc:
        vals.append(auc_device(mu, yf, w))
    h = torch.stack(vals).cpu().tolist()
    dev = h[0]
    entry = {"ntrees": built, "deviance": dev}
    if dist.name == "gaussian":
        entry["mse"] = dev
        entry["rmse"] = float(np.sqrt(max(dev, 0)))
    if dist.name == "bernoulli":
        entry["logloss"] = dev / 2.0
        if want_auc:
            entry["auc"] = h[1]
    return entry


def variable_importances(names, feat: np.ndarray, gain: np.ndarray) -> Dict:
    """The split gains of a tree stack ([T, M] feat and gain) summed per
    feature, in the JAX package's table: variables by falling
    importance, relative, scaled to the largest and as a share."""
    vi = np.zeros(len(names))
    live = feat >= 0
    np.add.at(vi, feat[live], gain[live])
    order = np.argsort(-vi)
    rel = vi / vi.max() if vi.max() > 0 else vi
    return {"variable": [names[i] for i in order],
            "relative_importance": vi[order].tolist(),
            "scaled_importance": rel[order].tolist(),
            "percentage": (vi[order] / vi.sum() if vi.sum() > 0
                           else vi[order]).tolist()}


def path_grower(spec: TrainingSpec, p: Dict, mtries: int = 0,
                random_adapts: bool = True):
    """The JAX package's path rule (its GBM's ``_train_dense``, and its
    DRF's, which passes ``mtries`` and sends ``histogram_type="random"``
    to the sketch: ``random_adapts`` False) and the chosen path's
    set-up. Returns (cfg, grow(g, h, w, col_mask, key) -> (tree, nid),
    bm, pc): bm and pc None on the adaptive path, pc None on the
    global-sketch path (unpacked codes)."""
    hist_type = (p.get("histogram_type") or "uniform_adaptive").lower()
    depth = int(p["max_depth"])

    def adaptive():
        cfg, root_lo, root_hi, nb_f = adaptive_setup(spec, p, depth,
                                                     mtries)
        x = (spec.X if ADAPTIVE_LAYOUT == "rows_f"
             else spec.X.t().contiguous())

        def grow(g, h, w, col_mask, key):
            return grow_tree_adaptive(x, g, h, w, cfg, root_lo, root_hi,
                                      nb_f=nb_f, col_mask=col_mask,
                                      layout=ADAPTIVE_LAYOUT, key=key)
        return cfg, grow, None, None

    packed_req = packed_codes_requested(p) and hist_type != "random"
    feasible = adaptive_feasible(spec, p, depth)
    can_adapt = hist_type in ADAPTIVE_HIST_TYPES and feasible
    if packed_req and can_adapt and not binned_feasible(
            packed_bins_upper_bound(spec, p), spec.n_features, depth):
        # packing cannot hold the categorical domains' bins: adaptive
        # bins, without paying for the sketch
        packed_req = False
    if not packed_req and (can_adapt or random_adapts
                           and hist_type == "random" and feasible):
        return adaptive()
    bm = bin_matrix_device(spec.X, spec.names, spec.is_cat,
                           nbins=max(int(p["nbins"]), 2),
                           nbins_cats=int(p["nbins_cats"]),
                           histogram_type=hist_type)
    if packed_req and binned_feasible(bm.n_bins, spec.n_features,
                                      depth):
        pc = pack_codes(bm)
        bm.codes = None                # the packed codes replace them
        cfg = tree_config(p, depth, bm.n_bins, spec.n_features, mtries)
        return (cfg, lambda g, h, w, cm, key: grow_tree_binned(
            pc.rm, g, h, w, cfg, cm, key), bm, pc)
    if packed_req and can_adapt:
        # the sketch's bin count is past the packed lanes
        return adaptive()
    # the global sketch, unpacked: uint8 or int32 codes, NA = n_bins
    codes = bm.codes
    cfg = tree_config(p, depth, bm.n_bins, spec.n_features, mtries)
    return (cfg, lambda g, h, w, cm, key: grow_tree(codes, g, h, w, cfg,
                                                      cm, key), bm, None)


class GBMModel(Model):
    algo = "gbm"

    def __init__(self, key, params, names, nclasses, dist_name, f0,
                 trees_host, edges, n_bins, max_depth, ntrees_built,
                 device, response=None, response_domain=None, is_cat=None,
                 cat_domains=None):
        super().__init__(key, params, names, nclasses, response=response,
                         response_domain=response_domain, is_cat=is_cat,
                         cat_domains=cat_domains)
        self.dist_name = dist_name
        # one margin a row (f0 a scalar) or K class margins (f0 [K], the
        # tree stack in (tree, class) order)
        self.f0 = np.array(f0, np.float32)
        self._K = nclasses if nclasses > 2 else 1
        # on the device once: predict adds no host copy, so that it can
        # be captured in a CUDA graph
        self._f0 = torch.tensor(self.f0, device=device)
        self.edges = edges
        self.n_bins = n_bins
        self.max_depth = max_depth
        self.ntrees_built = ntrees_built
        self.device = device
        self.trees = trees_host               # host arrays [T, M]
        self._feat = torch.tensor(trees_host["feat"], device=device).long()
        self._thr = torch.tensor(trees_host["thr"], device=device)
        self._na_left = torch.tensor(trees_host["na_left"],
                                     device=device).bool()
        self._is_split = torch.tensor(trees_host["is_split"],
                                      device=device).bool()
        self._value = torch.tensor(trees_host["value"], device=device)

    @classmethod
    def from_jax_arrays(cls, arrays: Dict[str, np.ndarray], meta: Dict,
                        device=None) -> "GBMModel":
        """A model from the JAX package's ``GBMModel._save_arrays()``
        dict (feat, thr, na_left, is_split, value, node_w, f0, edge_i;
        f0 [K] and the trees in (tree, class) order for K > 2 classes)
        and ``meta`` (dist_name, n_bins, max_depth, ntrees_built,
        nclasses, names, response_domain; optional is_cat and
        cat_domains, which ``predict`` needs to remap the enum codes of a
        frame with other domains, and offset_column and tweedie_power,
        the training parameters that predict reads)."""
        params = {k: meta[k] for k in ("offset_column", "tweedie_power")
                  if meta.get(k) is not None}
        n_edges = sum(1 for k in arrays if k.startswith("edge_"))
        trees = {k: np.asarray(arrays[k]) for k in
                 ("feat", "thr", "na_left", "is_split", "value")}
        if "node_w" in arrays:
            trees["node_w"] = np.asarray(arrays["node_w"])
        return cls(f"gbm_{id(arrays) & 0xffffff:x}", params, meta["names"],
                   int(meta["nclasses"]), meta["dist_name"],
                   np.asarray(arrays["f0"], np.float32), trees,
                   [np.asarray(arrays[f"edge_{i}"]) for i in range(n_edges)],
                   int(meta["n_bins"]), int(meta["max_depth"]),
                   int(meta["ntrees_built"]), _device.resolve(device),
                   response_domain=meta.get("response_domain"),
                   is_cat=meta.get("is_cat"),
                   cat_domains=meta.get("cat_domains"))

    def _margin_matrix(self, X: torch.Tensor,
                       offset: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        if offset is not None:
            offset = offset.to(self.device)
        return predict_raw_margin(X, self._f0, self._feat, self._thr,
                                  self._na_left, self._is_split,
                                  self._value, self.max_depth,
                                  offset=offset if self._K == 1 else None)

    def _predict_matrix(self, X: torch.Tensor,
                        offset: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        margin = self._margin_matrix(X.to(self.device), offset=offset)
        if self.nclasses <= 1:
            return get_distribution(
                self.dist_name,
                float(self.params.get("tweedie_power", 1.5))
            ).predict(margin)
        if self.nclasses == 2:
            p1 = sigmoid(margin)
            return torch.stack([1.0 - p1, p1], dim=1)
        return softmax(margin)


class H2OGradientBoostingEstimator(ModelBuilder):
    algo = "gbm"
    compat_params = GBM_COMPAT_PARAMS

    def __init__(self, **params):
        check_params(params)
        merged = dict(GBM_DEFAULTS)
        merged.update(GBM_COMPAT_PARAMS)
        merged.update(params)
        super().__init__(**merged)

    def _distribution(self, spec: TrainingSpec) -> str:
        d = (self.params.get("distribution") or "auto").lower()
        if d in ("auto", ""):
            if spec.nclasses == 2:
                return "bernoulli"
            if spec.nclasses > 2:
                return "multinomial"
            return "gaussian"
        return d

    def _dist(self, dist_name: str, huber_delta=1.0):
        """The family of a one-margin train: for ``custom``, an instance
        given as custom_distribution_func wins over the registry."""
        if str(dist_name).lower().startswith("custom"):
            cdf = self.params.get("custom_distribution_func")
            if cdf is not None and not isinstance(cdf, str):
                return get_distribution(cdf)
        return get_distribution(dist_name,
                                float(self.params.get("tweedie_power", 1.5)),
                                float(self.params.get("quantile_alpha", 0.5)),
                                huber_delta)

    def _huber_delta(self, spec: TrainingSpec):
        """The huber transition point, computed once: the huber_alpha
        weighted quantile of |r - median(r)| for the offset-adjusted
        response r, at least 1e-10; a 0-d tensor on the device."""
        r = spec.y.to(torch.float32)
        if spec.offset is not None:
            r = r - spec.offset
        med = weighted_median(r, spec.w)
        q = weighted_quantile(torch.abs(r - med), spec.w,
                              float(self.params.get("huber_alpha", 0.9)))
        return torch.clamp(q.to(torch.float32), min=1e-10)

    def _classification(self):
        d = (self.params.get("distribution") or "").lower()
        if d in ("bernoulli", "binomial", "multinomial"):
            return True
        if d and d != "auto":
            return False
        return None

    def _train_impl(self, spec: TrainingSpec,
                    valid: Optional[TrainingSpec] = None) -> GBMModel:
        p = self.params
        dist_name = self._distribution(spec)
        K = spec.nclasses if spec.nclasses > 2 else 1
        if spec.offset is not None and K > 1:
            raise NotImplementedError(MULTINOMIAL_OFFSET)
        dev = spec.device
        t_bin0 = time.monotonic()
        cfg, grow, bm, pc = path_grower(spec, p)
        t_bin = time.monotonic() - t_bin0

        w = spec.w
        dist = None
        if K == 1:
            delta = self._huber_delta(spec) if dist_name == "huber" else 1.0
            dist = self._dist(dist_name, delta)
            y = spec.y.to(torch.float32)
            if spec.offset is not None:
                # the initial margin on the offset-adjusted scale; the
                # offset enters the margin, not the trees
                f0 = offset_adjusted_f0(dist, y, w, spec.offset)
            else:
                f0 = dist.init_f0(y, w)
            f0 = torch.as_tensor(f0, dtype=torch.float32, device=dev)
            margin = f0.expand(spec.nrow).contiguous()
            if spec.offset is not None:
                margin = margin + spec.offset
        else:
            # log class priors; one fixed-order sum a class
            y = spec.y.long()
            pri = torch.stack([(w * (y == k)).sum() for k in range(K)])
            f0 = torch.log(torch.clamp(pri / w.sum(), min=1e-9))
            margin = f0.expand(spec.nrow, K).contiguous()
        ntrees = int(p["ntrees"])
        if ntrees < 1:
            raise ValueError(f"gbm: ntrees must be >= 1, got {ntrees}")
        # sampling (A4): a key a train, one row sample and column mask an
        # iteration, as the JAX package draws them
        key = train_key(p.get("seed", -1))
        rate = float(np.float32(p["sample_rate"]))
        col_rate = float(np.float32(float(p["col_sample_rate"])
                                    * float(p["col_sample_rate_per_tree"])))
        srpc = self.validate_sample_rate_per_class(spec)
        rates = None
        if srpc is not None:
            if float(p.get("sample_rate", 1.0)) < 1.0:
                warn("sample_rate is ignored when sample_rate_per_class "
                     "is specified (hex/tree/SharedTree.java:210)")
            rates = torch.tensor(srpc, dtype=torch.float32, device=dev)
        y_codes = spec.y if spec.nclasses > 1 else None
        anneal = float(p["learn_rate_annealing"])
        task = ("binomial" if spec.nclasses == 2
                else "multinomial" if K > 1 else "regression")
        keeper = ScoreKeeper(p.get("stopping_rounds", 0),
                             p.get("stopping_metric"),
                             p.get("stopping_tolerance", 1e-3), task)
        # the JAX loop's cadence: an entry after every ``interval``
        # iterations and after the last (partial) chunk, when early
        # stopping or an explicit score_tree_interval asks for scoring
        interval = max(int(p.get("score_tree_interval") or 5), 1)
        score_each = (keeper.rounds > 0
                      or int(p.get("score_tree_interval") or 0) > 0)
        chunk = interval if score_each else min(ntrees, 50)
        sc_spec = valid if valid is not None else spec
        want_auc = keeper.metric == "auc"
        walk = None
        if valid is not None:
            walk = valid_walk(valid.X, bm, pc, cfg.max_depth)
            vmargin = f0.expand((valid.nrow,) + tuple(f0.shape)).contiguous()
            if valid.offset is not None and K == 1:
                vmargin = vmargin + valid.offset
        trees: List[dict] = []
        built = 0                      # iterations: K trees each
        score_s = 0.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_loop0 = time.monotonic()
        lr_chunk = float(p["learn_rate"])
        while built < ntrees:
            c = min(chunk, ntrees - built)
            # within a chunk the rate is annealed in float32, across
            # chunks in float64, as the JAX chunk body and its driver do
            lr = np.float32(lr_chunk)
            for _ in range(c):
                key_t = fold_in(key, built)
                key_r, key_c = split(key_t)
                wt, col_mask = tree_sample(key_r, key_c, w, y_codes, rate,
                                           rates, col_rate, spec.n_features)
                if K == 1:
                    g, h = dist.grad_hess(margin, y)
                    tree, nid = grow(g * wt, h * wt, wt, col_mask, key_t)
                    margin = margin + float(lr) * tree["value"][nid.long()]
                    if walk is not None:
                        vmargin = vmargin + float(lr) * walk(tree)
                    trees.append(tree)
                else:
                    # the K trees of an iteration share the softmax of
                    # the margin at its start
                    prob = softmax(margin)
                    for k in range(K):
                        pk = prob[:, k]
                        g = pk - (y == k).to(torch.float32)
                        h = torch.clamp(pk * (1.0 - pk), min=1e-9)
                        tree, nid = grow(g * wt, h * wt, wt, col_mask,
                                         key_t)
                        margin[:, k] += float(lr) * tree["value"][nid.long()]
                        if walk is not None:
                            vmargin[:, k] += float(lr) * walk(tree)
                        trees.append(tree)
                built += 1
                lr = np.float32(lr * np.float32(anneal))
            lr_chunk *= anneal ** c
            if score_each:
                t_s0 = time.monotonic()
                keeper.record(score_entry(
                    vmargin if valid is not None else margin, sc_spec,
                    dist, built, want_auc))
                score_s += time.monotonic() - t_s0
                # the JAX loop checks before it commits a further chunk:
                # the last chunk stands whatever the rule says
                if built < ntrees and keeper.should_stop():
                    break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_loop = time.monotonic() - t_loop0

        t_fin0 = time.monotonic()
        model = self._finalize(spec, dist_name, f0, trees, bm, cfg, dev, K,
                               built)
        model.scoring_history = keeper.history
        model.training_metrics = self._metrics_from_margin(margin, spec,
                                                           dist)
        if valid is not None:
            model.validation_metrics = self._metrics_from_margin(
                vmargin, valid, dist)
        t_fin = time.monotonic() - t_fin0
        model.output["training_loop_seconds"] = t_loop
        model.output["train_profile"] = {"bin_s": t_bin, "loop_s": t_loop,
                                         "score_s": score_s,
                                         "finalize_s": t_fin}
        model.output["packed_codes"] = packed_codes_record(
            pc, bm.n_bins if pc is not None else None)
        if dist is not None and dist.name == "huber":
            # the transition point the trees were grown with
            model.output["huber_delta"] = float(dist.delta)
        return model

    def _finalize(self, spec, dist_name, f0, trees, bm, cfg, dev, K, built):
        """One fetch of the stacked trees ([built·K, M] in (iteration,
        class) order), raw thresholds (unbinned from the sketch paths'
        split bins; the adaptive grower's as they are), leaf values scaled
        by their iteration's learning rate, variable importances summed
        over every tree."""
        keys = ("feat", "na_left", "is_split", "value", "gain", "node_w",
                "thr" if bm is None else "split_bin")
        th = {k: torch.stack([t[k] for t in trees]).cpu().numpy()
              for k in keys}
        lr0 = float(self.params["learn_rate"])
        anneal = float(self.params["learn_rate_annealing"])
        lrs = lr0 * anneal ** np.repeat(np.arange(built), K)
        trees_host = {
            "feat": th["feat"], "na_left": th["na_left"],
            "is_split": th["is_split"],
            "value": (th["value"].astype(np.float64)
                      * lrs[:, None]).astype(np.float32),
            "node_w": th["node_w"]}
        if bm is None:
            edges = []
            trees_host["thr"] = th["thr"]
        else:
            edges = bm.edges
            trees_host["split_bin"] = th["split_bin"]
            trees_host["thr"] = bins_to_thresholds_stacked(
                th["split_bin"], th["feat"], edges)
        model = GBMModel(self._model_key(), self.params, spec.names,
                         spec.nclasses, dist_name, f0.cpu().numpy(),
                         trees_host, edges, cfg.n_bins, cfg.max_depth,
                         built, dev, response=spec.response,
                         response_domain=spec.response_domain,
                         is_cat=spec.is_cat, cat_domains=spec.cat_domains)
        model.output["variable_importances"] = variable_importances(
            spec.names, th["feat"], th["gain"])
        return model

    def _metrics_from_margin(self, margin, spec, dist):
        if spec.nclasses == 2:
            p1 = sigmoid(margin)
            probs = torch.stack([1.0 - p1, p1], dim=1)
            return compute_metrics(probs, spec.y, spec.w, 2)
        if dist is None:
            return compute_metrics(softmax(margin), spec.y, spec.w,
                                   spec.nclasses)
        mu = dist.predict(margin)
        dev = float(dist.deviance(spec.w, spec.y.to(torch.float32), mu))
        return compute_metrics(mu, spec.y, spec.w, 1, deviance=dev)
