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

Checkpoints (A3): ``checkpoint`` continues a live model or an artifact
(``persist.save_model``) up to ``ntrees`` in all, and
``in_training_checkpoints_dir`` writes ``<key>_t<n>.zip`` every
``in_training_checkpoints_tree_interval`` trees (the loop's chunks then
end on that cadence unless interval scoring sets them), each carrying
the exact float32 training margin: a train resumed from one builds the
uninterrupted train's trees bit for bit. Tree i draws from
``fold_in(key, i)`` with i counted over the whole model, prior trees
included. Monotone and interaction constraints (A5) ride into the
growers as ``mono`` [F] and ``sets`` [S, F].

A parameter the port does not know raises ``ValueError``; a keyed-store
reference as ``checkpoint`` raises ``NotImplementedError`` naming
ROADMAP.md item 18. The reference's compatibility-only parameters
(``GBM_COMPAT_PARAMS``) are accepted, as the JAX package accepts them,
with a warning at ``train()`` for each one set away from its default.

Out of core (ROADMAP.md item 13): a frame whose design matrix passes the
device budget (``memman``) trains streamed (``_train_streaming``, the
JAX package's): binned once on the host, then each tree over row chunks
(``models/streaming.py``) with the same kernels. The JAX package's
streamed trainer refuses a multinomial response, a validation frame, an
offset, ``sample_rate_per_class``, a per-level column rate, huber and the
constraints, and so does the port's. A dense train that runs out of the
card's memory degrades to the streamed trainer with a warning
(``_degrade_to_streaming``); where that refuses the configuration, the
out-of-memory error is raised again.
"""
from __future__ import annotations

import os
import time
import traceback
from dataclasses import replace
from typing import Dict, List, Optional

import numpy as np
import torch

from h2o3_tpu_torch import _device
from h2o3_tpu_torch.models.distributions import (get_distribution,
                                                 offset_adjusted_f0, sigmoid,
                                                 softmax, weighted_median,
                                                 weighted_quantile)
from h2o3_tpu_torch.models.metrics import auc_device
from h2o3_tpu_torch.models.model_base import (BALANCE_DEFAULTS,
                                              BUILDER_PARAMS,
                                              CALIBRATION_DEFAULTS,
                                              DKV_REFUSED, Model,
                                              ModelBuilder, ScoreKeeper,
                                              TrainingSpec, compute_metrics,
                                              persist_in_training_ckpt)
from h2o3_tpu_torch.models.tree import (ADAPTIVE_HIST_TYPES,
                                        adaptive_feasible, adaptive_setup,
                                        binned_feasible,
                                        bins_to_thresholds_stacked,
                                        grow_tree, grow_tree_adaptive,
                                        grow_tree_adaptive_streamed,
                                        grow_tree_binned,
                                        grow_tree_binned_streamed,
                                        levels_per_pass,
                                        packed_bins_upper_bound,
                                        packed_codes_requested,
                                        predict_binned, predict_raw_margin,
                                        predict_raw_tree, tree_config,
                                        tree_sample)
from h2o3_tpu_torch.log import warn
from h2o3_tpu_torch.ops.binning import (PackedCodes, _edges_host,
                                        bin_matrix_device,
                                        digitize_codes_host,
                                        digitize_with_edges, pack_codes,
                                        pack_codes_for, packed_codes_record)
from h2o3_tpu_torch.ops.random import (fold_in, prng_key, split, train_key,
                                       uniform_below)
from h2o3_tpu_torch.persist import register_model_class
from h2o3_tpu_torch.resilience import is_oom

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

# keys the JAX GBM accepts outside its defaults and never reads (DRF's
# mtries): accepted, with no effect on the trees, as there
_IGNORED = {"mtries"}


def refuse_params(algo: str, params: Dict, known) -> None:
    """Raise ValueError on a parameter outside ``known``."""
    unknown = sorted(set(params) - set(known))
    if unknown:
        raise ValueError(f"{algo}: unknown parameter(s) {unknown}")


def check_params(params: Dict) -> None:
    """Raise on a parameter the port does not know."""
    refuse_params("gbm", params,
                  set(GBM_DEFAULTS) | BUILDER_PARAMS | set(BALANCE_DEFAULTS)
                  | set(CALIBRATION_DEFAULTS) | _IGNORED
                  | set(GBM_COMPAT_PARAMS))


def spec_signature(spec: TrainingSpec) -> np.ndarray:
    """The JAX package's fingerprint of the data a resume state belongs
    to: (nrow, Σy, Σw), the sums float32 on the device, as float64 on
    the host. A saved margin or OOB state is applied only where it
    matches."""
    sums = torch.stack([spec.y.to(torch.float32).sum(),
                        spec.w.to(torch.float32).sum()]).cpu().tolist()
    return np.array([float(spec.nrow), sums[0], sums[1]], np.float64)


def resolve_checkpoint_source(ckpt, model_cls, label: str, device):
    """``checkpoint=``: a live model of ``model_cls`` or the path of an
    artifact, loaded onto ``device``. A string that names no file would
    be a keyed-store key, which waits for ROADMAP.md item 18."""
    if isinstance(ckpt, model_cls):
        return ckpt
    if isinstance(ckpt, str):
        if not os.path.isfile(ckpt):
            raise NotImplementedError(
                f"checkpoint={ckpt!r} names no artifact file; a model key "
                f"{DKV_REFUSED}")
        from h2o3_tpu_torch.persist import load_model
        prior = load_model(ckpt, device=device)
    else:
        raise ValueError(
            f"checkpoint must be a {label} model or an artifact path, got "
            f"{type(ckpt).__name__}")
    if not isinstance(prior, model_cls):
        raise ValueError(
            f"checkpoint resolves to a {getattr(prior, 'algo', '?')} "
            f"model — {label} can only continue from its own kind")
    return prior


def check_checkpoint(prior, spec: TrainingSpec, params: Dict) -> None:
    """The JAX package's compatibility refusals of a checkpoint (max
    depth, tree count, features, response classes and domains, enum
    domains); the GBM also refuses another distribution."""
    if prior.max_depth != int(params["max_depth"]):
        raise ValueError("checkpoint max_depth differs")
    if int(params["ntrees"]) <= prior.ntrees_built:
        raise ValueError(
            f"ntrees ({params['ntrees']}) must exceed the checkpoint's "
            f"ntrees_built ({prior.ntrees_built})")
    if list(prior.feature_names) != list(spec.names):
        raise ValueError(
            f"checkpoint feature set {prior.feature_names} differs from "
            f"the training spec's {spec.names} — the prior trees' feature "
            f"indices would address the wrong columns")
    if prior.nclasses != spec.nclasses:
        raise ValueError(
            f"checkpoint has {prior.nclasses} response classes but the "
            f"training frame has {spec.nclasses}")
    prd = tuple(prior.response_domain) if prior.response_domain else None
    srd = tuple(spec.response_domain) if spec.response_domain else None
    if prd != srd:
        raise ValueError(
            f"checkpoint response domain {prior.response_domain} differs "
            f"from the training frame's {spec.response_domain}")
    pcd = {k: tuple(v) for k, v in prior.cat_domains.items()}
    scd = {k: tuple(v) for k, v in spec.cat_domains.items()}
    if pcd != scd:
        raise ValueError(
            "checkpoint categorical domains differ from the training "
            "frame's — prior trees' enum-code splits would misroute")


def resume_rows(arr, spec: TrainingSpec, K: int, sig, what: str):
    """A saved per-row resume state ([rows] or [rows, K]) as float32 on
    the spec's device, or None (with the JAX package's warning) where it
    belongs to other data or has another shape. An artifact of the JAX
    package holds its padded rows: the first ``nrow`` are the frame's."""
    a = np.asarray(arr)
    sig_ok = sig is None or np.array_equal(np.asarray(sig),
                                           spec_signature(spec))
    tail = () if K == 1 else (K,)
    if a.shape[1:] == tail and a.shape[0] >= spec.nrow and sig_ok:
        return torch.as_tensor(a[:spec.nrow], dtype=torch.float32,
                               device=spec.device)
    if not sig_ok:
        warn(f"checkpoint {what} belongs to different training data — "
             f"recomputing from trees")
    else:
        warn(f"checkpoint {what} shape {a.shape} != expected "
             f"{(spec.nrow,) + tail} — recomputing from trees")
    return None


def constraint_arrays(p: Dict, spec: TrainingSpec):
    """``monotone_constraints`` ({column: +1/-1}) and
    ``interaction_constraints`` ([[column, ...], ...]) as the growers'
    ``mono`` [F] int32 and ``sets`` [S, F] bool on the spec's device
    (None where unset), with the JAX package's refusals: a column that
    is no training feature, a monotone constraint on an enum column."""
    F = spec.n_features
    mono = sets = None
    mc = p.get("monotone_constraints") or {}
    if mc:
        host = np.zeros(F, np.int32)
        for cname, direction in dict(mc).items():
            if cname not in spec.names:
                raise ValueError(
                    f"monotone_constraints column '{cname}' is not a "
                    f"training feature {list(spec.names)}")
            if spec.is_cat[spec.names.index(cname)]:
                raise ValueError(
                    f"monotone constraint on categorical column "
                    f"'{cname}' is not supported (reference restricts "
                    f"constraints to numeric columns)")
            host[spec.names.index(cname)] = int(direction)
        mono = torch.as_tensor(host, device=spec.device)
    ic = p.get("interaction_constraints") or None
    if ic:
        host = np.zeros((len(ic), F), bool)
        for si, group in enumerate(ic):
            for cname in group:
                if cname not in spec.names:
                    raise ValueError(
                        f"interaction_constraints column '{cname}' is "
                        f"not a training feature")
                host[si, spec.names.index(cname)] = True
        sets = torch.as_tensor(host, device=spec.device)
    return mono, sets


def merge_prior_trees(prior_trees: Dict, trees_host: Dict) -> Dict:
    """A continued model's tree stack: the prior's trees, then the new
    ones (keys both carry; ``node_w`` only where both have it)."""
    return {k: np.concatenate([np.asarray(prior_trees[k]), v])
            for k, v in trees_host.items() if k in prior_trees}


def merged_importances(names, feat, gain, prior) -> Dict:
    """Variable importances of the new trees, plus, for a continued
    model, the prior's relative importances by name (added after the
    new gains, as in the JAX package)."""
    pv = (prior.output.get("variable_importances") if prior is not None
          else None)
    extra = None
    if pv:
        lut = {n: i for i, n in enumerate(names)}
        extra = [(lut[n], g) for n, g in zip(pv["variable"],
                                             pv["relative_importance"])
                 if n in lut]
    return variable_importances(names, feat, gain, extra)


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


def variable_importances(names, feat: np.ndarray, gain: np.ndarray,
                         extra=None) -> Dict:
    """The split gains of a tree stack ([T, M] feat and gain) summed per
    feature, then ``extra`` ((index, gain) pairs) added, in the JAX
    package's table: variables by falling importance, relative, scaled
    to the largest and as a share."""
    vi = np.zeros(len(names))
    live = feat >= 0
    np.add.at(vi, feat[live], gain[live])
    for i, g in extra or ():
        vi[i] += g
    order = np.argsort(-vi)
    rel = vi / vi.max() if vi.max() > 0 else vi
    return {"variable": [names[i] for i in order],
            "relative_importance": vi[order].tolist(),
            "scaled_importance": rel[order].tolist(),
            "percentage": (vi[order] / vi.sum() if vi.sum() > 0
                           else vi[order]).tolist()}


def path_grower(spec: TrainingSpec, p: Dict, mtries: int = 0,
                random_adapts: bool = True, mono=None, sets=None):
    """The JAX package's path rule (its GBM's ``_train_dense``, and its
    DRF's, which passes ``mtries`` and sends ``histogram_type="random"``
    to the sketch: ``random_adapts`` False) and the chosen path's
    set-up. ``mono`` and ``sets`` are the GBM's constraints
    (``constraint_arrays``), passed to every tree. Returns (cfg,
    grow(g, h, w, col_mask, key) -> (tree, nid), bm, pc): bm and pc None
    on the adaptive path, pc None on the global-sketch path (unpacked
    codes)."""
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
                                      layout=ADAPTIVE_LAYOUT, key=key,
                                      mono=mono, sets=sets)
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
            pc.rm, g, h, w, cfg, cm, key, mono, sets), bm, pc)
    if packed_req and can_adapt:
        # the sketch's bin count is past the packed lanes
        return adaptive()
    # the global sketch, unpacked: uint8 or int32 codes, NA = n_bins
    codes = bm.codes
    cfg = tree_config(p, depth, bm.n_bins, spec.n_features, mtries)
    return (cfg, lambda g, h, w, cm, key: grow_tree(
        codes, g, h, w, cfg, cm, key, mono, sets), bm, None)


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

    # -- persistence (persist.save_model / load_model) ------------------

    def _save_arrays(self) -> Dict[str, np.ndarray]:
        """The JAX package's arrays: the stacked trees, f0, node_w, the
        sketch's edges and, in an in-training checkpoint, the resume
        state (the float32 training margin and the data's signature)."""
        d = {k: np.asarray(self.trees[k]) for k in
             ("feat", "thr", "na_left", "is_split", "value")}
        d["f0"] = np.asarray(self.f0)
        if self.trees.get("node_w") is not None:
            d["node_w"] = np.asarray(self.trees["node_w"])
        for attr in ("resume_margin", "resume_sig"):
            v = getattr(self, "_" + attr, None)
            if v is not None:
                d[attr] = np.asarray(v)
        for i, e in enumerate(self.edges):
            d[f"edge_{i}"] = np.asarray(e)
        return d

    def _save_extra_meta(self) -> Dict:
        return {"dist_name": self.dist_name, "n_bins": self.n_bins,
                "max_depth": self.max_depth,
                "ntrees_built": self.ntrees_built,
                "n_edges": len(self.edges)}

    @classmethod
    def _restore(cls, meta: Dict, arrays: Dict, device=None) -> "GBMModel":
        """A model from an artifact of either package, through
        ``from_jax_arrays``, with the artifact's base state and resume
        state."""
        ex = meta["extra"]
        flat = dict(ex, names=meta["feature_names"],
                    nclasses=meta["nclasses"],
                    response_domain=meta.get("response_domain"),
                    is_cat=meta["feature_is_cat"],
                    cat_domains=meta.get("cat_domains"))
        m = cls.from_jax_arrays(arrays, flat, device)._restore_base(meta)
        m._resume_margin = arrays.get("resume_margin")
        m._resume_sig = arrays.get("resume_sig")
        return m

    def varimp(self, use_pandas=False):
        """The variable importances: split gains summed per feature
        (``output["variable_importances"]``)."""
        return self.output.get("variable_importances")

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
    supports_streaming = True

    def __init__(self, **params):
        check_params(params)
        merged = dict(GBM_DEFAULTS)
        merged.update(GBM_COMPAT_PARAMS)
        merged.update(BALANCE_DEFAULTS)
        merged.update(CALIBRATION_DEFAULTS)
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

    def _resolve_checkpoint(self, dist_name: str, spec: TrainingSpec):
        """``checkpoint``: the prior model whose trees this train
        continues (``ntrees`` counts them), or None; the JAX package's
        refusals of one that does not fit."""
        ckpt = self.params.get("checkpoint")
        if not ckpt:
            return None
        prior = resolve_checkpoint_source(ckpt, GBMModel, "GBM",
                                          spec.device)
        if prior.dist_name != dist_name:
            raise ValueError(
                f"checkpoint distribution '{prior.dist_name}' != "
                f"'{dist_name}' (checkpoint params must match — "
                f"hex/ModelBuilder checkpoint contract)")
        check_checkpoint(prior, spec, self.params)
        return prior

    def _prior_margin(self, prior: GBMModel, spec: TrainingSpec, K: int):
        """The margin to resume from: an in-training checkpoint's exact
        float32 margin (the uninterrupted train's bits; it carries the
        offset), else the prior's trees summed again over the frame
        (without the offset). Returns (margin, includes_offset)."""
        rm = getattr(prior, "_resume_margin", None)
        if rm is not None:
            m = resume_rows(rm, spec, K, getattr(prior, "_resume_sig", None),
                            "resume margin")
            if m is not None:
                return m, True
        return prior._margin_matrix(spec.X).to(spec.device), False

    def _write_in_training_checkpoint(self, model: GBMModel, margin,
                                      ckpt_dir, spec: TrainingSpec):
        """An in-training checkpoint: the partial model with its exact
        float32 training margin and the data's signature."""
        model._resume_margin = margin.cpu().numpy().astype(np.float32)
        model._resume_sig = spec_signature(spec)
        return persist_in_training_ckpt(model, self.algo, ckpt_dir)

    def _train_impl(self, spec: TrainingSpec,
                    valid: Optional[TrainingSpec] = None) -> GBMModel:
        dist_name = self._distribution(spec)
        if spec.stream:
            return self._train_streaming(spec, valid, dist_name)
        try:
            return self._train_dense(spec, valid, dist_name)
        except Exception as e:  # noqa: BLE001 — classified below
            if not is_oom(e):
                raise
            cause = e
        return self._degrade_to_streaming(spec, valid, dist_name, cause)

    def _degrade_to_streaming(self, spec: TrainingSpec, valid, dist_name,
                              cause: BaseException) -> GBMModel:
        """The dense train ran out of device memory: train streamed
        instead, from the design matrix brought back to the host (the
        JAX package's graceful degradation). The failed train's frames
        and torch's cached blocks are let go first, or the retry can run
        out too. Where the streamed trainer refuses the configuration,
        the out-of-memory error is raised again, the refusal chained."""
        warn("%s: device OOM during dense training (%s: %s) — degrading "
             "to the streamed resident-window path", self.algo,
             type(cause).__name__, cause)
        # the traceback holds the failed train's tensors
        traceback.clear_frames(cause.__traceback__)
        host_spec = replace(spec, X=None, X_host=spec.X.cpu().numpy(),
                            stream=True)
        if spec.device.type == "cuda":
            torch.cuda.empty_cache()
        try:
            return self._train_streaming(host_spec, valid, dist_name)
        except NotImplementedError as e2:
            warn("%s: streamed fallback unavailable (%s) — re-raising the "
                 "device OOM", self.algo, e2)
            raise cause from e2

    def _train_dense(self, spec: TrainingSpec, valid: Optional[TrainingSpec],
                     dist_name: str) -> GBMModel:
        p = self.params
        K = spec.nclasses if spec.nclasses > 2 else 1
        if spec.offset is not None and K > 1:
            raise NotImplementedError(MULTINOMIAL_OFFSET)
        dev = spec.device
        mono, sets = constraint_arrays(p, spec)
        t_bin0 = time.monotonic()
        cfg, grow, bm, pc = path_grower(spec, p, mono=mono, sets=sets)
        t_bin = time.monotonic() - t_bin0
        prior = self._resolve_checkpoint(dist_name, spec)

        w = spec.w
        dist = None
        prior_has_offset = False
        if K == 1:
            delta = self._huber_delta(spec) if dist_name == "huber" else 1.0
            dist = self._dist(dist_name, delta)
            y = spec.y.to(torch.float32)
            if prior is not None:
                f0 = torch.as_tensor(prior.f0, dtype=torch.float32,
                                     device=dev)
                margin, prior_has_offset = self._prior_margin(prior, spec, 1)
            else:
                if spec.offset is not None:
                    # the initial margin on the offset-adjusted scale; the
                    # offset enters the margin, not the trees
                    f0 = offset_adjusted_f0(dist, y, w, spec.offset)
                else:
                    f0 = dist.init_f0(y, w)
                f0 = torch.as_tensor(f0, dtype=torch.float32, device=dev)
                margin = f0.expand(spec.nrow).contiguous()
            if spec.offset is not None and not prior_has_offset:
                margin = margin + spec.offset
        else:
            y = spec.y.long()
            if prior is not None:
                f0 = torch.as_tensor(prior.f0, dtype=torch.float32,
                                     device=dev)
                margin = self._prior_margin(prior, spec, K)[0]
            else:
                # log class priors; one fixed-order sum a class
                pri = torch.stack([(w * (y == k)).sum() for k in range(K)])
                f0 = torch.log(torch.clamp(pri / w.sum(), min=1e-9))
                margin = f0.expand(spec.nrow, K).contiguous()
        ntrees = int(p["ntrees"])
        if ntrees < 1:
            raise ValueError(f"gbm: ntrees must be >= 1, got {ntrees}")
        start_trees = prior.ntrees_built if prior is not None else 0
        ntrees_new = ntrees - start_trees
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
        chunk = interval if score_each else min(ntrees_new, 50)
        # in-training checkpoints: chunks end on the checkpoint cadence,
        # unless interval scoring sets them (the JAX loop's rule)
        ckpt_dir = p.get("in_training_checkpoints_dir")
        ckpt_interval = max(int(
            p.get("in_training_checkpoints_tree_interval", 1) or 1), 1)
        if ckpt_dir and not score_each:
            chunk = max(min(chunk, ckpt_interval), 1)
        if ckpt_dir and ntrees_new / ckpt_interval > 50:
            warn("gbm: in_training_checkpoints_tree_interval=%d means ~%d "
                 "checkpoint commits, each fetching all committed trees "
                 "and writing a full artifact — consider a larger interval",
                 ckpt_interval, int(ntrees_new / ckpt_interval))
        sc_spec = valid if valid is not None else spec
        want_auc = keeper.metric == "auc"
        walk = None
        if valid is not None:
            walk = valid_walk(valid.X, bm, pc, cfg.max_depth)
            if prior is not None:
                vmargin = prior._margin_matrix(valid.X).to(dev)
            else:
                vmargin = f0.expand(
                    (valid.nrow,) + tuple(f0.shape)).contiguous()
            if valid.offset is not None and K == 1:
                vmargin = vmargin + valid.offset
        trees: List[dict] = []
        built = 0                      # iterations: K trees each
        since_ckpt = 0
        commits: List[Dict] = []
        score_s = 0.0

        def commit():
            # advisory: a failed commit is logged, the train goes on
            t0 = time.monotonic()
            try:
                m = self._finalize(spec, dist_name, f0, trees, bm, cfg, dev,
                                   K, built, prior, start_trees)
                m.scoring_history = list(keeper.history)
                path = self._write_in_training_checkpoint(m, margin,
                                                          ckpt_dir, spec)
            except Exception as e:  # noqa: BLE001 — advisory only
                warn("%s: in-training checkpoint commit failed: %s",
                     self.algo, e)
                return
            commits.append({"trees": start_trees + built, "path": path,
                             "seconds": time.monotonic() - t0,
                             "bytes": (os.path.getsize(path) if path
                                       else None)})

        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_loop0 = time.monotonic()
        lr_chunk = float(p["learn_rate"]) * anneal ** start_trees
        while built < ntrees_new:
            c = min(chunk, ntrees_new - built)
            # within a chunk the rate is annealed in float32, across
            # chunks in float64, as the JAX chunk body and its driver do
            lr = np.float32(lr_chunk)
            for _ in range(c):
                # the key of the tree's index in the whole model
                key_t = fold_in(key, start_trees + built)
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
            since_ckpt += c
            if score_each:
                t_s0 = time.monotonic()
                keeper.record(score_entry(
                    vmargin if valid is not None else margin, sc_spec,
                    dist, start_trees + built, want_auc))
                score_s += time.monotonic() - t_s0
                # the JAX loop checks before it commits a further chunk:
                # the last chunk stands whatever the rule says, and a
                # stopped train writes no checkpoint of its last chunk
                if built < ntrees_new and keeper.should_stop():
                    break
            if ckpt_dir and (since_ckpt >= ckpt_interval
                             or built >= ntrees_new):
                commit()
                since_ckpt = 0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_loop = time.monotonic() - t_loop0

        t_fin0 = time.monotonic()
        model = self._finalize(spec, dist_name, f0, trees, bm, cfg, dev, K,
                               built, prior, start_trees)
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
        if commits:
            model.output["checkpoints"] = commits
        if dist is not None and dist.name == "huber":
            # the transition point the trees were grown with
            model.output["huber_delta"] = float(dist.delta)
        return model

    def _refuse_streaming(self, spec: TrainingSpec, valid, dist_name):
        """What the JAX package's streamed trainer refuses, with its
        exception type and words."""
        p = self.params
        if spec.nclasses > 2:
            raise NotImplementedError(
                "multinomial GBM is not supported in streaming "
                "(memory-pressure) mode; raise H2O3_DEVICE_BUDGET_BYTES "
                "or reduce the frame")
        if valid is not None:
            raise NotImplementedError(
                "validation_frame is not supported in streaming mode")
        if spec.offset is not None:
            raise NotImplementedError(
                "offset_column is not supported in streaming mode")
        if p.get("sample_rate_per_class"):
            raise NotImplementedError(
                "sample_rate_per_class is not supported in streaming mode")
        if float(p.get("col_sample_rate_change_per_level", 1.0)
                 or 1.0) != 1.0:
            raise NotImplementedError(
                "col_sample_rate_change_per_level is not supported in "
                "streaming mode")
        if dist_name == "huber":
            raise NotImplementedError(
                "huber distribution is not supported in streaming mode "
                "(its delta re-estimation needs the dense path)")
        if p.get("monotone_constraints") or p.get("interaction_constraints"):
            raise NotImplementedError(
                "monotone/interaction constraints are not supported in "
                "streaming mode")

    def _train_streaming(self, spec: TrainingSpec, valid, dist_name: str
                         ) -> GBMModel:
        """The memory-pressure train (the JAX package's
        ``_train_streaming``): the design matrix stays on the host
        (``spec.X_host``), is binned there once (packed codes, where
        packing holds the bins) or kept as float32 features (adaptive
        bins), and every tree streams its row chunks through the level
        kernels (``models/streaming.StreamedChunks``). The chunks are
        ``budget / (4·F·bytes a value)`` rows, at least 16384. Tree t
        draws from ``fold_in(PRNGKey(seed), t)`` (seed -1 -> 0), its
        rows from that key and its columns from ``fold_in(key_t, 1)``,
        counted over the whole model, prior trees included. A checkpoint
        resumes from its exact float32 margin, or from the prior's trees
        summed chunk by chunk; in-training checkpoints carry the margin.
        A cancel seen between levels ends the train at the committed
        trees."""
        from h2o3_tpu_torch import memman
        from h2o3_tpu_torch.models.streaming import (StreamCancelled,
                                                     StreamedChunks)
        self._refuse_streaming(spec, valid, dist_name)
        p = self.params
        dist = self._dist(dist_name)
        dev = spec.device
        rows, F = spec.nrow, spec.n_features
        depth = int(p["max_depth"])
        X_host = np.ascontiguousarray(spec.X_host[:rows], dtype=np.float32)
        y_host = spec.y.to(torch.float32).cpu().numpy()
        w_host = spec.w.to(torch.float32).cpu().numpy()
        budget = memman.manager().budget
        t_bin0 = time.monotonic()
        # packed codes binned once on the host (the edge rules first: a
        # bin count packing cannot hold builds no code matrix)
        hist_type = (p.get("histogram_type") or "uniform_adaptive").lower()
        packed = packed_codes_requested(p) and hist_type != "random"
        if packed:
            try:
                edges, n_bins_eff = _edges_host(
                    X_host, rows, spec.is_cat, max(int(p["nbins"]), 2),
                    int(p.get("nbins_cats", 1024)), hist_type)
                packed = binned_feasible(n_bins_eff, F, depth)
            except ValueError:
                packed = False
        W = None
        if packed:
            x_stream, W = digitize_codes_host(X_host, edges, n_bins_eff)
            cfg = tree_config(p, depth, n_bins_eff, F)
        else:
            cfg, root_lo, root_hi, nb_f = adaptive_setup(spec, p, depth)
            x_stream = X_host
        t_bin = time.monotonic() - t_bin0
        itemsize = int(x_stream.dtype.itemsize)
        chunk_rows = int(max(min(budget // max(F * itemsize * 4, 1), rows),
                             16384))
        prior = self._resolve_checkpoint(dist_name, spec)
        start_trees = prior.ntrees_built if prior is not None else 0
        margin0 = None
        if prior is not None:
            f0 = float(np.asarray(prior.f0).reshape(-1)[0])
            rm = getattr(prior, "_resume_margin", None)
            m = (resume_rows(rm, spec, 1, getattr(prior, "_resume_sig", None),
                             "resume margin") if rm is not None else None)
            if m is not None:
                margin0 = m.cpu().numpy()
            else:
                # the prior's trees summed chunk by chunk: the whole host
                # matrix never goes to the device at once
                margin0 = np.empty(rows, np.float32)
                for s0 in range(0, rows, chunk_rows):
                    e0 = min(s0 + chunk_rows, rows)
                    margin0[s0:e0] = prior._margin_matrix(torch.as_tensor(
                        X_host[s0:e0], device=dev)).cpu().numpy()
        else:
            f0 = float(dist.init_f0(spec.y.to(torch.float32), spec.w))
        ntrees_new = int(p["ntrees"]) - start_trees
        if ntrees_new < 1:
            raise ValueError(f"gbm: ntrees must be >= 1, got {p['ntrees']}")
        anneal = float(p.get("learn_rate_annealing", 1.0) or 1.0)
        lr = float(p["learn_rate"]) * anneal ** start_trees
        col_rate = (float(p.get("col_sample_rate", 1.0))
                    * float(p.get("col_sample_rate_per_tree", 1.0)))
        rate = float(p.get("sample_rate", 1.0))
        seed = int(p.get("seed", -1) or -1)
        key = prng_key(seed if seed != -1 else 0)
        chunks = StreamedChunks(x_stream, y_host, w_host, f0, chunk_rows,
                                dev, padded_rows=rows, margin0=margin0,
                                packed_W=W)
        trees: List[dict] = []
        commits: List[Dict] = []

        def build_model(done) -> GBMModel:
            th = {k: np.stack([t[k] for t in done]) for k in done[0]
                  if k != "gain"}
            th["value"] = th["value"].astype(np.float32)
            if prior is not None:
                th = merge_prior_trees(prior.trees, th)
            m = GBMModel(self._model_key(), p, spec.names, spec.nclasses,
                         dist_name, np.float32(f0), th, [], cfg.n_bins,
                         cfg.max_depth, start_trees + len(done), dev,
                         response=spec.response,
                         response_domain=spec.response_domain,
                         is_cat=spec.is_cat, cat_domains=spec.cat_domains)
            m.output["variable_importances"] = merged_importances(
                spec.names, np.stack([t["feat"] for t in done]),
                np.stack([t["gain"] for t in done]), prior)
            return m

        ckpt_dir = p.get("in_training_checkpoints_dir")
        ckpt_interval = max(int(
            p.get("in_training_checkpoints_tree_interval", 1) or 1), 1)

        def commit():
            # advisory: a failed commit is logged, the train goes on
            t_c0 = time.monotonic()
            try:
                m = build_model(trees)
                path = self._write_in_training_checkpoint(
                    m, torch.from_numpy(chunks.gather_margin()), ckpt_dir,
                    spec)
            except Exception as e:  # noqa: BLE001 — advisory only
                warn("%s: streamed in-training checkpoint commit failed: "
                     "%s", self.algo, e)
                return
            commits.append({"trees": start_trees + len(trees),
                            "path": path,
                            "seconds": time.monotonic() - t_c0,
                            "bytes": (os.path.getsize(path) if path
                                      else None)})

        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        since_ckpt = 0
        for t in range(ntrees_new):
            # the key of the tree's index in the whole model
            tkey = fold_in(key, start_trees + t)
            col_mask = (uniform_below(fold_in(tkey, 1), F, col_rate, dev)
                        if col_rate < 1.0 else None)
            lr32 = float(np.float32(lr))
            try:
                if packed:
                    tree = grow_tree_binned_streamed(
                        chunks, dist, lr32, cfg, edges, key=tkey,
                        sample_rate=rate, col_mask=col_mask)
                else:
                    tree = grow_tree_adaptive_streamed(
                        chunks, dist, lr32, cfg, root_lo, root_hi, nb_f,
                        key=tkey, sample_rate=rate, col_mask=col_mask)
            except StreamCancelled:
                # a cancel lands before a tree's leaf pass: its margins
                # are those of the committed trees
                break
            # leaf values scaled by the tree's rate in float64, rounded
            # once to float32 (the dense finalize's product)
            tree["value"] = tree["value"].astype(np.float64) * lr
            trees.append(tree)
            since_ckpt += 1
            lr *= anneal
            if ckpt_dir and since_ckpt >= ckpt_interval \
                    and len(trees) < ntrees_new:
                commit()
                since_ckpt = 0
        if not trees:
            raise StreamCancelled(
                "cancelled before the first streamed tree completed")
        margin = torch.as_tensor(chunks.gather_margin(), device=dev)
        t_loop = time.monotonic() - t0
        t_fin0 = time.monotonic()
        if ckpt_dir:
            commit()
        model = build_model(trees)
        model.training_metrics = self._metrics_from_margin(margin, spec,
                                                           dist)
        T = len(trees)
        model.output["training_loop_seconds"] = t_loop
        model.output["streamed"] = True
        model.output["packed_codes"] = packed_codes_record(
            PackedCodes(torch.from_numpy(x_stream[:0]), W) if packed
            else None, cfg.n_bins)
        lpp = levels_per_pass(cfg.max_depth, F, W) if packed else 1
        model.output["levels_per_dispatch"] = int(
            lpp if chunks.C == 1 else 1)
        sp = chunks.profile()
        sp["trees"] = T
        sp["levels_per_pass"] = int(lpp)
        # the steady traffic a tree, without the once-a-train window
        sp["h2d_bytes_per_tree"] = (sp["h2d_bytes"]
                                    - sp["h2d_resident_bytes"]) / T
        model.output["stream_profile"] = sp
        if commits:
            model.output["checkpoints"] = commits
        model.output["train_profile"] = {
            "bin_s": t_bin, "loop_s": t_loop, "score_s": 0.0,
            "finalize_s": time.monotonic() - t_fin0}
        return model

    def _finalize(self, spec, dist_name, f0, trees, bm, cfg, dev, K, built,
                  prior=None, tree_offset=0):
        """One fetch of the stacked trees ([built·K, M] in (iteration,
        class) order), raw thresholds (unbinned from the sketch paths'
        split bins; the adaptive grower's as they are), leaf values scaled
        by their iteration's learning rate (counted over the whole model),
        variable importances summed over every tree; a continued model's
        prior trees first."""
        keys = ("feat", "na_left", "is_split", "value", "gain", "node_w",
                "thr" if bm is None else "split_bin")
        th = {k: torch.stack([t[k] for t in trees]).cpu().numpy()
              for k in keys}
        lr0 = float(self.params["learn_rate"])
        anneal = float(self.params["learn_rate_annealing"])
        lrs = lr0 * anneal ** np.repeat(
            np.arange(tree_offset, tree_offset + built), K)
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
        if prior is not None:
            trees_host = merge_prior_trees(prior.trees, trees_host)
        model = GBMModel(self._model_key(), self.params, spec.names,
                         spec.nclasses, dist_name, f0.cpu().numpy(),
                         trees_host, edges, cfg.n_bins, cfg.max_depth,
                         tree_offset + built, dev, response=spec.response,
                         response_domain=spec.response_domain,
                         is_cat=spec.is_cat, cat_domains=spec.cat_domains)
        model.output["variable_importances"] = merged_importances(
            spec.names, th["feat"], th["gain"], prior)
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


register_model_class("gbm", GBMModel)
register_model_class("xgboost", GBMModel)
