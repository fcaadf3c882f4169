"""Counter-based random draws: the port's copy of the part of
``jax.random`` that the JAX package's samplers use, bit for bit.

The JAX package draws every sampling mask from ``jax.random`` with its
default generator, threefry2x32, in its partitionable form
(``jax_threefry_partitionable``, on by default) and 32-bit integers. All
of it is integer arithmetic on a counter, so it gives the same bits on
the card, on the CPU and in JAX:

- a key is two uint32 words; ``prng_key(seed)`` is ``PRNGKey(seed)``:
  the seed wrapped to 32 bits, hi word 0 (JAX's ``threefry_seed`` of a
  32-bit seed);
- ``fold_in(key, d)`` is threefry2x32(key, (0, d));
- ``split(key, n)[i]`` is threefry2x32(key, (0, i));
- ``uniform(key, shape)``: for flat (row-major) index ``i``, the two
  words of threefry2x32(key, (i >> 32, i & 0xffffffff)) XORed, shifted
  right by 9, OR 0x3F800000, read as a float32, minus 1.

Element ``i`` depends on ``i`` alone, so a draw over the JAX package's
padded rows, cut to the real rows, equals the port's unpadded draw.

Keys are Python ints on the host: deriving one is a single block of the
cipher, computed there. The draws over tensors have a plain version,
threefry2x32 on int64 tensors masked to 32 bits, for CPU tensors, and a
hand-written CUDA kernel (``csrc/threefry.cu``, launched through
``ops/kernels.py``) for CUDA tensors; the kernel replaces no TPU kernel
(XLA fuses the JAX draw into one pass, which plain torch would spend
some hundred element-wise launches on).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import torch

from h2o3_tpu_torch.ops import kernels

M32 = 0xFFFFFFFF
# threefry2x32's rotations, alternating between the two groups of four,
# and the key schedule's parity constant
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[int, int]


def _threefry(k0, k1, x0, x1, mask):
    """threefry2x32's 20 rounds on two counter words, as Python ints or
    int64 tensors; ``mask`` keeps every sum to 32 bits."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & mask
    x1 = (x1 + ks[1]) & mask
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & mask
            x1 = ((x1 << r) & mask) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & mask
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & mask
    return x0, x1


def threefry2x32(key: Key, x0: int, x1: int) -> Key:
    """One block of the cipher on the host."""
    return _threefry(key[0], key[1], x0 & M32, x1 & M32, M32)


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` as the JAX package runs it (32-bit
    integers): the seed wrapped to 32 bits in the lo word, hi word 0."""
    return (0, int(seed) & M32)


def train_key(seed) -> Key:
    """The key of a train, by the JAX estimators' rule: a seed of -1,
    0 or None takes ``int(time.time() * 1e3) % 2**31``."""
    s = int(seed or -1)
    if s == -1:
        s = int(time.time() * 1e3) % (2 ** 31)
    return prng_key(s)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key, 0, int(data))


def split(key: Key, n: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, n)``."""
    return tuple(threefry2x32(key, 0, i) for i in range(n))


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def uniform_plain(key: Key, shape: Sequence[int], device) -> torch.Tensor:
    """Plain version of ``uniform``: threefry2x32 on int64 tensors."""
    i = torch.arange(_numel(shape), dtype=torch.int64, device=device)
    y0, y1 = _threefry(key[0], key[1], i >> 32, i & M32, M32)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    return u.reshape(tuple(shape))


def sample_weights_plain(key: Key, w: torch.Tensor, rate: float = 1.0,
                         y: Optional[torch.Tensor] = None,
                         rates: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version of ``sample_weights``."""
    u = uniform_plain(key, w.shape, w.device)
    if rates is None:
        keep = u < rate
    else:
        # an explicit clamp: a code outside [0, K) never indexes from the
        # end (its row has weight 0 anyway)
        c = y.long().clamp(0, rates.shape[0] - 1)
        keep = u < rates[c]
    return w * keep.to(w.dtype)


def uniform(key: Key, shape: Sequence[int], device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1) on
    ``device``; the plain version on the CPU, the kernel on the card."""
    device = torch.device(device)
    if device.type == "cpu":
        return uniform_plain(key, shape, device)
    if device.type == "cuda":
        return kernels.threefry_uniform(key, tuple(shape), device)
    raise ValueError(f"uniform: unsupported device {device}")


def uniform_below(key: Key, n: int, thr: float, device) -> torch.Tensor:
    """``jax.random.uniform(key, (n,)) < thr``: a bool mask [n]."""
    return uniform(key, (n,), device) < thr


def sample_weights(key: Key, w: torch.Tensor, rate: float = 1.0,
                   y: Optional[torch.Tensor] = None,
                   rates: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A row sample in one pass: ``w * (uniform(key, w.shape) < thr)``,
    ``thr`` the scalar ``rate``, or with ``rates`` (float32 [K]) the rate
    of each row's class ``rates[y]`` (``y`` int32 codes, clamped into
    [0, K)). float32 [rows] on ``w``'s device."""
    if w.device.type == "cpu":
        return sample_weights_plain(key, w, rate, y, rates)
    if w.device.type == "cuda":
        return kernels.threefry_sample(key, w, rate, y, rates)
    raise ValueError(f"sample_weights: unsupported device {w.device}")


def level_subset(key: Key, d: int, n_nodes: int, col_mask: torch.Tensor,
                 m: int) -> torch.Tensor:
    """The per-node column subsets of level ``d`` (DRF's ``mtries``, and
    ``col_sample_rate_change_per_level``), as the JAX growers draw them:
    ``u = uniform(fold_in(key, d), (N, F))``, columns outside
    ``col_mask`` set to 2.0, and each node keeps the columns whose draw
    is at most its ``m``-th smallest. Returns bool [N, F]."""
    F = col_mask.shape[0]
    u = uniform(fold_in(key, d), (n_nodes, F), col_mask.device)
    u = torch.where(col_mask[None, :], u, 2.0)
    kth = torch.sort(u, dim=1).values[:, min(m, F) - 1]
    return (u <= kth[:, None]) & col_mask[None, :]
