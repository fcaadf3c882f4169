"""h2o3_tpu_torch — the PyTorch/CUDA port of ``h2o3_tpu``.

A second package beside the JAX one, held against it by parity tests.
Plain tensor code is PyTorch; every TPU kernel on a ported path is a
hand-written CUDA kernel for Hopper (``csrc/``, built at first use by
``ops/kernels.py``), each beside a plain PyTorch version that serves CPU
tensors. Entry points run on ``cuda`` unless the caller asks for the CPU
(``init(device="cpu")`` or ``device="cpu"`` per frame); without a CUDA
device and without that request they raise.

The port covers import (``import_file``: CSV through the port's own copy
of the native tokenizer, gzip and zstd inputs, ARFF, SVMLight, Parquet,
ORC, Avro and xlsx, lists of files and remote URIs; ``import_sql_table``
from a DB-API connection; numeric, time and enum columns streamed to
the card a byte range at a time) and training the GBM (every family,
multinomial, offsets, row and column sampling on the JAX package's own
random bits), the XGBoost estimator over it and the random forest
(``H2ORandomForestEstimator``), on packed bin codes, on per-node
adaptive bins (H2O's ``UniformAdaptive``) or on the unpacked global
sketch (more than 254 bins), with a validation frame, interval scoring
and early stopping, training and validation metrics (out of bag for
the forest) and ``predict``, and serving a
trained model's rows (``Model.deploy``, ``h2o3_tpu_torch.serve``: one
CUDA graph of the predict a batch bucket, a micro-batcher) and the
EasyPredict row API (``h2o3_tpu_torch.genmodel``). Models save and load
(``save_model``, ``load_model``: the JAX package's artifact) and
continue from a checkpoint; the GBM takes monotone and interaction
constraints; the builders cross-validate, balance classes and
calibrate. A frame whose design matrix passes the device budget
(``memman``) trains the GBM and XGBoost out of core, row chunks
streamed through the card (``models/streaming.py``). The GBM, XGBoost
and the forest train on a ('data', 'model') mesh (``parallel/``: rows
over data shards, the split search over model shards, one process or
several), the trees of the JAX package's mesh of the same shape. The
dense GLM (``H2OGeneralizedLinearEstimator``: every family and link,
Cholesky IRLSM, coordinate descent on a CUDA kernel, L-BFGS, lambda
search, multinomial and ordinal) trains, predicts, saves and serves on
the frame's device. ROADMAP.md queues the rest.
"""
from h2o3_tpu_torch._device import init, is_coordinator
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.ingest.parse import import_file, parse_setup
from h2o3_tpu_torch.ingest.sql import import_sql_table
from h2o3_tpu_torch.parallel.mesh import current_mesh, make_mesh, set_mesh
from h2o3_tpu_torch.persist import load_model, save_model

__version__ = "0.1.0"

__all__ = ["Frame", "Vec", "current_mesh", "import_file",
           "import_sql_table", "init", "is_coordinator", "load_model",
           "make_mesh", "parse_setup", "save_model", "set_mesh",
           "upload_numpy"]


def upload_numpy(data, names=None, device=None) -> Frame:
    """``Frame.from_numpy`` under the h2o client's name."""
    return Frame.from_numpy(data, names=names, device=device)
