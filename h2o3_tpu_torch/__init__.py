"""h2o3_tpu_torch — the PyTorch/CUDA port of ``h2o3_tpu``.

A second package beside the JAX one, held against it by parity tests.
Plain tensor code is PyTorch; every TPU kernel on a ported path is a
hand-written CUDA kernel for Hopper (``csrc/``, built at first use by
``ops/kernels.py``), each beside a plain PyTorch version that serves CPU
tensors. Entry points run on ``cuda`` unless the caller asks for the CPU
(``init(device="cpu")`` or ``device="cpu"`` per frame); without a CUDA
device and without that request they raise.

The port covers training a bernoulli or gaussian GBM on packed bin
codes or on per-node adaptive bins (H2O's ``UniformAdaptive``), its
training metrics and ``predict``; ROADMAP.md queues the rest.
"""
from h2o3_tpu_torch._device import init
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.vec import Vec

__version__ = "0.1.0"

__all__ = ["Frame", "Vec", "init", "upload_numpy"]


def upload_numpy(data, names=None, device=None) -> Frame:
    """``Frame.from_numpy`` under the h2o client's name."""
    return Frame.from_numpy(data, names=names, device=device)
