"""Device resolution for the PyTorch/CUDA port.

Every entry point runs on ``cuda`` unless the caller asks for the CPU:
``h2o3_tpu_torch.init(device=...)`` sets the process default and
``Frame.from_numpy(..., device=...)`` overrides it per frame. Without a
CUDA device and without an explicit ``"cpu"`` the entry points raise —
they never carry on quietly on the host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

_default: Optional[torch.device] = None


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the argument, else the
    ``init`` default, else ``cuda``. Raises when that is a CUDA device
    and no CUDA device is present."""
    dev = torch.device(device) if device is not None else (
        _default if _default is not None else torch.device("cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "h2o3_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' (or h2o3_tpu_torch.init("
            "device='cpu')) to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def init(device: DeviceLike = None) -> torch.device:
    """Set the process-wide default device (``None`` = ``cuda``) and
    return it, resolved."""
    global _default
    dev = resolve(device)
    _default = dev
    return dev
