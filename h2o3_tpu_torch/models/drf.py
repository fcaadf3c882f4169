"""DRF — distributed random forest on the GBM's tree growers.

Counterpart of ``h2o3_tpu/models/drf.py`` (H2O's DRF): independent trees,
each on a row sample (``sample_rate``, 0.632 by default, or
``sample_rate_per_class``), a per-tree column mask
(``col_sample_rate_per_tree``) and per-node column subsets of ``mtries``
columns (``floor(sqrt F)`` for classification, ``F // 3`` for
regression by default), drawn with the JAX package's keys from the
port's copy of its generator (``ops/random.py``): tree i's key is
``fold_in(key, i)``, split three ways into the row, the column and the
subset key, the last folded with the class for each of a multinomial's
K trees. Leaf values come from the growers' Newton step with
``(g, h) = (-y·w, w)``: the weighted mean of the (class-indicator)
response. The path is the GBM's rule (packed codes, adaptive bins or
the global sketch; ``histogram_type="random"`` takes the sketch, as in
the JAX package).

Every row that a tree did not sample adds that tree's leaf value to its
out-of-bag sums; the training metrics are those of the out-of-bag means
(in-bag predictions where no row was out of bag, ``sample_rate=1``), and
``output["oob_metrics"]`` says which. A prediction is the mean over the
trees, the leaf values added in tree order; classification probabilities
are clipped to [0, 1] and, for K classes, normalised. The JAX package
draws its trees in chunks of up to 25 under one executable; the keys
depend on the tree's index alone, so the port's loop over single trees
draws the same samples.

Checkpoints (A3) as the GBM's: a continued forest draws tree i from
``fold_in(key, i)`` over the whole forest, and an in-training
checkpoint (``<key>_t<n>.zip`` every
``in_training_checkpoints_tree_interval`` trees, and one of the
finished forest) carries the out-of-bag sums, so that a forest resumed
from it equals the uninterrupted one in trees and out-of-bag metrics.
Class balancing, calibration and cross-validation (A7) come from the
builder (``models/model_base.py``).

The reference's compatibility-only parameters (``DRF_COMPAT_PARAMS``)
are accepted, as the JAX package accepts them, with a warning at
``train()`` for each one set away from its default. Refused as in the
JAX package: ``offset_column``, ``max_depth`` past 16,
``staged_predict_proba``, and a frame past the device budget (the
forest has no streamed path). Not ported yet: contributions (item 16).
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.log import warn
from h2o3_tpu_torch.models.gbm import (check_checkpoint,
                                       merge_prior_trees,
                                       merged_importances, path_grower,
                                       refuse_params,
                                       resolve_checkpoint_source,
                                       resume_rows, spec_signature,
                                       spmd_record)
from h2o3_tpu_torch.models.model_base import (BALANCE_DEFAULTS,
                                              BUILDER_PARAMS,
                                              CALIBRATION_DEFAULTS, Model,
                                              ModelBuilder, RowShards,
                                              TrainingSpec,
                                              compute_metrics,
                                              persist_in_training_ckpt)
from h2o3_tpu_torch.models.tree import (bins_to_thresholds_stacked,
                                        predict_raw_mean, tree_sample)
from h2o3_tpu_torch.ops.binning import packed_codes_record
from h2o3_tpu_torch.ops.random import fold_in, split, train_key
from h2o3_tpu_torch.parallel import shardstats
from h2o3_tpu_torch.parallel.mesh import current_mesh
from h2o3_tpu_torch.persist import register_model_class

MAX_DEPTH_CAP = 16

# the JAX package's DRF_DEFAULTS without its TPU kernel switch
DRF_DEFAULTS: Dict = dict(
    ntrees=50, max_depth=10, min_rows=1.0, nbins=20, nbins_cats=1024,
    mtries=-1, sample_rate=0.632, sample_rate_per_class=None,
    col_sample_rate_per_tree=1.0, col_sample_rate_change_per_level=1.0,
    min_split_improvement=1e-5, seed=-1, histogram_type="uniform_adaptive",
    score_tree_interval=0, stopping_rounds=0, stopping_metric="auto",
    stopping_tolerance=1e-3, reg_lambda=0.0,
    checkpoint=None, in_training_checkpoints_dir=None,
    in_training_checkpoints_tree_interval=1,
    histogram_precision="auto", packed_codes="auto",
)

# the reference's DRF parameters that the JAX package accepts for API
# compatibility and does not act on (h2o3_tpu/models/compat_params.py):
# merged into every estimator's parameters; train() warns for each one
# set away from its default
DRF_COMPAT_PARAMS: Dict = dict(
    max_confusion_matrix_size=20, nbins_top_level=1024, r2_stopping=None,
    build_tree_one_node=False, binomial_double_trees=False,
    categorical_encoding="auto", distribution="auto",
    check_constant_response=True,
)

# the JAX package's refusals
OFFSET_REFUSED = ("DRF does not support offset_column "
                  "(matching hex/tree/drf/DRF.java)")
STAGED_REFUSED = ("staged_predict_proba is not supported for DRF "
                  "(GBM/XGBoost only, hex/Model.java)")


def default_mtries(mtries, n_features: int, nclasses: int) -> int:
    """``mtries``, or where it is -1 (0, None) the reference's default:
    floor(sqrt F) for classification, F // 3 for regression, at least
    1; at most F."""
    m = int(mtries or -1)
    if m <= 0:
        m = (max(1, int(np.sqrt(n_features))) if nclasses > 1
             else max(1, n_features // 3))
    return min(m, n_features)


class DRFModel(Model):
    algo = "drf"

    def __init__(self, key, params, names, nclasses, trees_host, edges,
                 n_bins, max_depth, ntrees_built, device, response=None,
                 response_domain=None, is_cat=None, cat_domains=None):
        super().__init__(key, params, names, nclasses, response=response,
                         response_domain=response_domain, is_cat=is_cat,
                         cat_domains=cat_domains)
        self.edges = edges
        self.n_bins = n_bins
        self.max_depth = max_depth
        self.ntrees_built = ntrees_built
        self.device = device
        self.trees = trees_host               # host arrays [T·K, M]
        self._K = nclasses if nclasses > 2 else 1
        # the sum's starting point, on the device once (capture-safe)
        self._zero = (torch.zeros((), dtype=torch.float32, device=device)
                      if self._K == 1 else
                      torch.zeros(self._K, dtype=torch.float32,
                                  device=device))
        self._feat = torch.tensor(trees_host["feat"], device=device).long()
        self._thr = torch.tensor(trees_host["thr"], device=device)
        self._na_left = torch.tensor(trees_host["na_left"],
                                     device=device).bool()
        self._is_split = torch.tensor(trees_host["is_split"],
                                      device=device).bool()
        self._value = torch.tensor(trees_host["value"], device=device)

    def _predict_matrix(self, X: torch.Tensor,
                        offset: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        mean = predict_raw_mean(X.to(self.device), self._zero, self._feat,
                                self._thr, self._na_left, self._is_split,
                                self._value, self.max_depth)
        if self.nclasses <= 1:
            return mean
        if self.nclasses == 2:
            p1 = torch.clamp(mean, 0.0, 1.0)
            return torch.stack([1.0 - p1, p1], dim=1)
        pc = torch.clamp(mean, 0.0, 1.0)
        return pc / torch.clamp(pc.sum(dim=1, keepdim=True), min=1e-12)

    # -- persistence (persist.save_model / load_model) ------------------

    def _save_arrays(self) -> Dict[str, np.ndarray]:
        """The JAX package's arrays: the stacked trees, node_w, the
        sketch's edges and, in an in-training checkpoint, the resume
        state (the out-of-bag sums and counts, the data's signature)."""
        d = {k: np.asarray(self.trees[k]) for k in
             ("feat", "thr", "na_left", "is_split", "value")}
        if self.trees.get("node_w") is not None:
            d["node_w"] = np.asarray(self.trees["node_w"])
        for attr in ("resume_oob_num", "resume_oob_cnt", "resume_sig"):
            v = getattr(self, "_" + attr, None)
            if v is not None:
                d[attr] = np.asarray(v)
        for i, e in enumerate(self.edges):
            d[f"edge_{i}"] = np.asarray(e)
        return d

    def _save_extra_meta(self) -> Dict:
        return {"n_bins": self.n_bins, "max_depth": self.max_depth,
                "ntrees_built": self.ntrees_built,
                "n_edges": len(self.edges)}

    @classmethod
    def _restore(cls, meta: Dict, arrays: Dict, device=None) -> "DRFModel":
        from h2o3_tpu_torch import _device
        ex = meta["extra"]
        trees = {k: np.asarray(arrays[k]) for k in
                 ("feat", "thr", "na_left", "is_split", "value", "node_w")
                 if k in arrays}
        m = cls(meta["key"], meta["params"] or {}, meta["feature_names"],
                int(meta["nclasses"]), trees,
                [np.asarray(arrays[f"edge_{i}"])
                 for i in range(ex["n_edges"])],
                int(ex["n_bins"]), int(ex["max_depth"]),
                int(ex["ntrees_built"]), _device.resolve(device),
                response=meta["response"])._restore_base(meta)
        for attr in ("resume_oob_num", "resume_oob_cnt", "resume_sig"):
            setattr(m, "_" + attr, arrays.get(attr))
        return m

    def staged_predict_proba(self, frame):
        raise ValueError(STAGED_REFUSED)

    def predict_contributions(self, frame):
        raise NotImplementedError(
            "drf: predict_contributions is not ported yet (ROADMAP.md "
            "queue 1, item 16, treeshap)")

    def varimp(self, use_pandas=False):
        return self.output.get("variable_importances")


class H2ORandomForestEstimator(ModelBuilder):
    algo = "drf"
    compat_params = DRF_COMPAT_PARAMS

    def __init__(self, **params):
        refuse_params("drf", params,
                      set(DRF_DEFAULTS) | BUILDER_PARAMS
                      | set(BALANCE_DEFAULTS) | set(CALIBRATION_DEFAULTS)
                      | set(DRF_COMPAT_PARAMS))
        merged = dict(DRF_DEFAULTS)
        merged.update(DRF_COMPAT_PARAMS)
        merged.update(BALANCE_DEFAULTS)
        merged.update(CALIBRATION_DEFAULTS)
        merged.update(params)
        super().__init__(**merged)

    def _resolve_checkpoint(self, spec: TrainingSpec):
        """``checkpoint``: the prior forest this train continues, or
        None; the JAX package's refusals of one that does not fit."""
        ckpt = self.params.get("checkpoint")
        if not ckpt:
            return None
        prior = resolve_checkpoint_source(ckpt, DRFModel, "DRF",
                                          spec.device)
        check_checkpoint(prior, spec, self.params)
        return prior

    def _resume_oob(self, prior, spec: TrainingSpec, K: int):
        """The out-of-bag sums and counts to resume from: the prior's
        saved ones where they fit this frame, else zeros (the JAX
        package's warning: the metrics then cover the new trees
        only)."""
        dev = spec.device
        if prior is not None:
            rn = getattr(prior, "_resume_oob_num", None)
            rc = getattr(prior, "_resume_oob_cnt", None)
            sig = getattr(prior, "_resume_sig", None)
            if rn is not None and rc is not None:
                num = resume_rows(rn, spec, K, sig, "OOB sums")
                cnt = resume_rows(rc, spec, 1, sig, "OOB counts")
                if num is not None and cnt is not None:
                    return num, cnt
            warn("drf checkpoint carries no OOB resume state — training "
                 "metrics will reflect only the new trees")
        return (torch.zeros((spec.nrow,) if K == 1 else (spec.nrow, K),
                            dtype=torch.float32, device=dev),
                torch.zeros(spec.nrow, dtype=torch.float32, device=dev))

    def _commit(self, spec, trees, bm, cfg, dev, built, prior, start,
                oob_num, oob_cnt, ckpt_dir, commits: List[Dict]) -> None:
        """An in-training checkpoint with the out-of-bag state; a failed
        commit is logged and the train goes on."""
        t0 = time.monotonic()
        try:
            m = self._finalize(spec, trees, bm, cfg, dev, built, prior, start)
            m._resume_oob_num = oob_num.cpu().numpy().astype(np.float32)
            m._resume_oob_cnt = oob_cnt.cpu().numpy().astype(np.float32)
            m._resume_sig = spec_signature(spec)
            path = persist_in_training_ckpt(m, self.algo, ckpt_dir)
        except Exception as e:  # noqa: BLE001 — advisory only
            warn("drf: in-training checkpoint commit failed: %s", e)
            return
        commits.append({"trees": start + built, "path": path,
                        "seconds": time.monotonic() - t0,
                        "bytes": os.path.getsize(path) if path else None})

    def _train_impl(self, spec: TrainingSpec,
                    valid: Optional[TrainingSpec] = None) -> DRFModel:
        p = self.params
        if spec.offset is not None:
            raise NotImplementedError(OFFSET_REFUSED)
        K = spec.nclasses if spec.nclasses > 2 else 1
        depth = int(p["max_depth"])
        if depth > MAX_DEPTH_CAP:
            raise ValueError(
                f"max_depth {depth} exceeds the static-tree cap "
                f"{MAX_DEPTH_CAP} (complete-binary-array trees; the "
                f"reference's default 20 relies on dynamic node allocation)")
        ntrees = int(p["ntrees"])
        if ntrees < 1:
            raise ValueError(f"drf: ntrees must be >= 1, got {ntrees}")
        F = spec.n_features
        mtries = default_mtries(p.get("mtries", -1), F, spec.nclasses)
        dev = spec.device
        # the rows over the mesh's data shards (one block: as they are)
        rows = RowShards(current_mesh(), spec.nrow, dev)
        t_bin0 = time.monotonic()
        cfg, grow, bm, pc = path_grower(spec, p, rows, mtries,
                                        random_adapts=False)
        t_bin = time.monotonic() - t_bin0

        prior = self._resolve_checkpoint(spec)
        start = prior.ntrees_built if prior is not None else 0
        ntrees_new = ntrees - start
        ckpt_dir = p.get("in_training_checkpoints_dir")
        ckpt_interval = max(int(
            p.get("in_training_checkpoints_tree_interval", 1) or 1), 1)
        chunk = max(min(ntrees_new, 25, ckpt_interval), 1)
        since = boundary = 0
        commits: List[Dict] = []
        key = train_key(p.get("seed", -1))
        rate = float(np.float32(p["sample_rate"]))
        col_rate = float(np.float32(p.get("col_sample_rate_per_tree", 1.0)))
        srpc = self.validate_sample_rate_per_class(spec)
        rates = (torch.tensor(srpc, dtype=torch.float32, device=dev)
                 if srpc is not None else None)
        # per-shard row state (pad rows: weight 0, never out of bag)
        w_s = rows.split(spec.w, 0.0)
        y_codes = rows.split(spec.y, 0) if spec.nclasses > 1 else None
        y_s = rows.split(spec.y, 0)
        ys_s = [[yj.to(torch.float32)] if K == 1 else
                [(yj == k).to(torch.float32) for k in range(K)]
                for yj in y_s]
        oob_num, oob_cnt = self._resume_oob(prior, spec, K)
        oob_num_s = rows.split(oob_num, 0.0)
        oob_cnt_s = rows.split(oob_cnt, 0.0)
        live_s = [wj > 0 for wj in w_s]
        trees = []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        steps = shardstats.recorder(rows.mesh, self.algo)
        with shardstats.recording(steps):
            t_loop0 = time.monotonic()
            for i in range(start, ntrees):
                # the key of the tree's index in the whole forest
                key_r, key_c, key_m = split(fold_in(key, i), 3)
                wt_s, col_mask = tree_sample(key_r, key_c, w_s, y_codes,
                                             rate, rates, col_rate, F,
                                             rows.ids)
                # rows the tree did not sample: weight > 0, sampled 0
                oob_s = [lw & (wt == 0) for lw, wt in zip(live_s, wt_s)]
                preds = [[] for _ in wt_s]
                for k in range(len(ys_s[0])):
                    tree, nid_s = grow(
                        [-(ys[k] * wt) for ys, wt in zip(ys_s, wt_s)], wt_s,
                        wt_s, col_mask, key_m if K == 1 else fold_in(key_m, k))
                    vals = [tree["value"].to(d) for d in rows.devices]
                    for j, (v, nid) in enumerate(zip(vals, nid_s)):
                        preds[j].append(v[nid.long()])
                    trees.append(tree)
                for j, (oob, pj) in enumerate(zip(oob_s, preds)):
                    if K == 1:
                        oob_num_s[j] = oob_num_s[j] + torch.where(oob, pj[0],
                                                                  0.0)
                    else:
                        oob_num_s[j] = oob_num_s[j] + torch.where(
                            oob[:, None], torch.stack(pj, dim=1), 0.0)
                    oob_cnt_s[j] = oob_cnt_s[j] + oob.to(torch.float32)
                built = i + 1 - start
                # the JAX loop's cadence: chunks of min(25, interval) trees;
                # at a chunk's end a commit once the interval is full, but
                # for the last chunk (the finished forest's commit is below)
                if ckpt_dir and (built % chunk == 0 or built == ntrees_new):
                    since += built - boundary
                    boundary = built
                    if since >= ckpt_interval and built < ntrees_new:
                        self._commit(spec, trees, bm, cfg, dev, built, prior,
                                     start, rows.gather(oob_num_s),
                                     rows.gather(oob_cnt_s), ckpt_dir,
                                     commits)
                        since = 0
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t_loop = time.monotonic() - t_loop0
        oob_num, oob_cnt = rows.gather(oob_num_s), rows.gather(oob_cnt_s)

        t_fin0 = time.monotonic()
        model = self._finalize(spec, trees, bm, cfg, dev, ntrees_new, prior,
                               start)
        if ckpt_dir:
            # the finished forest's artifact, with its out-of-bag state
            self._commit(spec, trees, bm, cfg, dev, ntrees_new, prior,
                         start, oob_num, oob_cnt, ckpt_dir, commits)
            model.output["checkpoints"] = commits
        self._oob_metrics(model, spec, K, oob_num, oob_cnt)
        if valid is not None:
            model.validation_metrics = compute_metrics(
                model._predict_matrix(valid.X), valid.y, valid.w,
                spec.nclasses)
        t_fin = time.monotonic() - t_fin0
        model.output["training_loop_seconds"] = t_loop
        model.output["train_profile"] = {"bin_s": t_bin, "loop_s": t_loop,
                                         "finalize_s": t_fin}
        model.output["packed_codes"] = packed_codes_record(
            pc, bm.n_bins if pc is not None else None)
        model.output["mtries"] = mtries
        model.output["spmd"] = spmd_record(
            rows, steps.summary() if steps is not None else None)
        return model

    def _oob_metrics(self, model, spec, K, oob_num, oob_cnt):
        """The training metrics: those of the out-of-bag means over the
        rows some tree left out (weight > 0), or, where there is no such
        row (``sample_rate=1``), of the in-bag predictions."""
        live = (oob_cnt > 0) & (spec.w > 0)
        if not bool(live.any()):
            model.training_metrics = compute_metrics(
                model._predict_matrix(spec.X), spec.y, spec.w,
                spec.nclasses)
            model.output["oob_metrics"] = False
            return
        y, w = spec.y[live], spec.w[live]
        if K == 1:
            pred = oob_num[live] / oob_cnt[live]
            if spec.nclasses == 2:
                p1 = torch.clamp(pred, 0.0, 1.0)
                model.training_metrics = compute_metrics(
                    torch.stack([1.0 - p1, p1], dim=1), y, w, 2)
            else:
                model.training_metrics = compute_metrics(pred, y, w, 1)
        else:
            pk = torch.clamp(oob_num[live] / oob_cnt[live][:, None], 0.0,
                             1.0)
            pk = pk / torch.clamp(pk.sum(dim=1, keepdim=True), min=1e-12)
            model.training_metrics = compute_metrics(pk, y, w, K)
        model.output["oob_metrics"] = True

    def _finalize(self, spec, trees, bm, cfg, dev, built, prior=None,
                  start=0) -> DRFModel:
        """One fetch of the stacked trees ([T·K, M] in (tree, class)
        order), raw thresholds (unbinned from the sketch paths' split
        bins), variable importances summed over every tree; a continued
        forest's prior trees first."""
        keys = ("feat", "na_left", "is_split", "value", "gain", "node_w",
                "thr" if bm is None else "split_bin")
        th = {k: torch.stack([t[k] for t in trees]).cpu().numpy()
              for k in keys}
        trees_host = {k: th[k] for k in ("feat", "na_left", "is_split",
                                         "value", "node_w")}
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
        model = DRFModel(self._model_key(), self.params, spec.names,
                         spec.nclasses, trees_host, edges, cfg.n_bins,
                         cfg.max_depth, start + built, dev,
                         response=spec.response,
                         response_domain=spec.response_domain,
                         is_cat=spec.is_cat, cat_domains=spec.cat_domains)
        model.output["variable_importances"] = merged_importances(
            spec.names, th["feat"], th["gain"], prior)
        return model


register_model_class("drf", DRFModel)
