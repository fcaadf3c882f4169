"""One process of a mesh across processes: the port's counterpart of
the JAX package's ``tools/multihost_worker.py``.

    python -m h2o3_tpu_torch.tools.multihost_worker <process_id> \\
        <num_processes> <port> [--device cuda|cpu] [--backend gloo|nccl] \\
        [--rows N] [--trees T]

Every process runs the same program: ``h2o3_tpu_torch.init(
distributed=True)`` forms the process group over
``tcp://localhost:<port>`` (NCCL on cuda, gloo on the CPU, unless
``--backend`` says otherwise: several processes on one card need gloo),
the mesh spans every process's devices on the data axis, and each
process builds the same frame (``frame_columns``, from a fixed seed: the
single-program path, each process keeping its own data shards' rows)
and trains a packed GBM whose level histograms and leaf totals are
reduced across the processes. Trees are replicated, so every process
prints the same digest (``DIGEST <hex>``), and it is the digest of the
same train on an in-process mesh of the same shape
(``train_digest``).
"""
from __future__ import annotations

import argparse
import hashlib

import numpy as np

PARAMS = dict(max_depth=5, nbins=14, histogram_type="quantiles_global",
              distribution="bernoulli", min_rows=1.0, seed=7,
              histogram_precision="float32", score_tree_interval=0)


def frame_columns(rows: int, F: int = 8, seed: int = 100):
    """The worker's frame: a logistic signal over ``F`` features with 3%
    NaNs, the same in every process."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, F)).astype(np.float32)
    logit = X[:, 0] * 1.5 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    y = (rng.random(rows) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    X[rng.random(X.shape) < 0.03] = np.nan
    cols = {f"f{i}": X[:, i] for i in range(F)}
    cols["label"] = y
    return cols


def digest(model) -> str:
    """A hash of the trees' splits and values and the training AUC's
    float64 bits."""
    h = hashlib.sha256()
    for key in ("feat", "split_bin", "na_left", "is_split", "value"):
        h.update(np.ascontiguousarray(model.trees[key]).tobytes())
    h.update(np.float64(model.training_metrics.auc).tobytes())
    return h.hexdigest()[:32]


def train(device: str, rows: int, trees: int):
    """The packed GBM on the worker's frame, on the current mesh."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.models.gbm import H2OGradientBoostingEstimator
    fr = h2o.Frame.from_numpy(frame_columns(rows), device=device)
    return H2OGradientBoostingEstimator(ntrees=trees, **PARAMS).train(
        y="label", training_frame=fr).model


def train_digest(n_data: int, device: str, rows: int, trees: int,
                 devices=None) -> str:
    """The digest of the same train on an in-process (n_data, 1) mesh of
    ``devices`` (``device`` repeated where None)."""
    from h2o3_tpu_torch.parallel import mesh
    old = mesh._MESH
    mesh.set_mesh(mesh.make_mesh(n_data=n_data,
                                 devices=devices or [device] * n_data))
    try:
        return digest(train(device, rows, trees))
    finally:
        mesh.set_mesh(old)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("process_id", type=int)
    ap.add_argument("num_processes", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--trees", type=int, default=3)
    a = ap.parse_args(argv)
    import torch.distributed as dist
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.parallel.mesh import current_mesh
    h2o.init(device=a.device, distributed=True,
             coordinator_address=f"localhost:{a.port}",
             num_processes=a.num_processes, process_id=a.process_id,
             backend=a.backend)
    try:
        mesh = current_mesh()
        model = train(a.device, a.rows, a.trees)
        d = digest(model)
        print(f"proc {a.process_id}/{a.num_processes} "
              f"backend={dist.get_backend()} coordinator="
              f"{h2o.is_coordinator()} mesh={mesh.shape} "
              f"spmd={model.output['spmd']} digest={d}", flush=True)
        print(f"DIGEST {d}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
