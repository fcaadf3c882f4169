"""Cyclic coordinate descent of the elastic net on a Gram: the GLM's
penalized IRLS solve (the JAX package's ``_cd_elastic_net``).

``cd_elastic_net`` minimises ½βᵀGβ − bᵀβ + λ₁|β|₁ + ½λ₂|β|₂² over the
coordinates ``pen_mask`` marks (0 for the intercept), coordinate by
coordinate, ``n_sweeps`` times, keeping Gb = G·β as it goes (glmnet's
covariance updates). A non-negativity flag (``non_negative`` on the
penalized coordinates, or ``nn_mask``'s) and box bounds (``lo``, ``hi``)
project each new coordinate.

CPU tensors go to the plain version below; CUDA tensors to the
hand-written kernel (``csrc/glm_cd.cu`` through ``ops/kernels.py``), one
thread block a solve, which rounds each product and sum as the plain
version does. The plain version is the kernel's arithmetic written in
torch, a few 0-d operations a coordinate: it serves the CPU and the
tests, and nothing on the card's path.
"""
from __future__ import annotations

from typing import Optional

import torch

from h2o3_tpu_torch.ops import kernels


def cd_elastic_net(G: torch.Tensor, b: torch.Tensor, beta0: torch.Tensor,
                   lam_l1: float, lam_l2: float, pen_mask: torch.Tensor,
                   n_sweeps: int = 10, non_negative: bool = False,
                   nn_mask: Optional[torch.Tensor] = None,
                   lo: Optional[torch.Tensor] = None,
                   hi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """beta [P] after ``n_sweeps`` cyclic sweeps from ``beta0``: the
    plain version on the CPU, the kernel on a CUDA device (it raises
    where it cannot launch)."""
    fn = cd_elastic_net_plain if G.device.type == "cpu" \
        else kernels.cd_elastic_net
    return fn(G, b, beta0, lam_l1, lam_l2, pen_mask, n_sweeps,
              non_negative=non_negative, nn_mask=nn_mask, lo=lo, hi=hi)


def cd_elastic_net_plain(G: torch.Tensor, b: torch.Tensor,
                         beta0: torch.Tensor, lam_l1: float, lam_l2: float,
                         pen_mask: torch.Tensor, n_sweeps: int = 10,
                         non_negative: bool = False,
                         nn_mask: Optional[torch.Tensor] = None,
                         lo: Optional[torch.Tensor] = None,
                         hi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic in torch, on any device: each coordinate's
    update from Gb[j], the column G[:, j] added into Gb times the
    coordinate's change, one rounding an operation. The per-coordinate
    constants (λ₁·pen, the divisor G[j, j] + λ₂·pen + 1e-12) are formed
    once, elementwise, as the JAX package forms them per coordinate."""
    dt = torch.float32
    dev = G.device
    P = G.shape[0]
    lam1 = torch.tensor(float(lam_l1), dtype=dt, device=dev)
    lam2 = torch.tensor(float(lam_l2), dtype=dt, device=dev)
    d = torch.diagonal(G)
    l1 = lam1 * pen_mask
    den = d + lam2 * pen_mask + 1e-12
    flag = None
    if nn_mask is not None:
        flag = nn_mask > 0
    elif non_negative:
        flag = pen_mask > 0
    Gt = G.t()
    beta = beta0.clone()
    Gb = G @ beta0
    for _ in range(int(n_sweeps)):
        for j in range(P):
            gj = Gb[j] - d[j] * beta[j]
            rho = b[j] - gj
            bj = torch.sign(rho) * torch.clamp(torch.abs(rho) - l1[j],
                                               min=0.0)
            bj = bj / den[j]
            if flag is not None:
                bj = torch.where(flag[j], torch.clamp(bj, min=0.0), bj)
            if lo is not None:
                bj = torch.clamp(torch.clamp(bj, min=lo[j]), max=hi[j])
            delta = bj - beta[j]
            Gb = Gb + Gt[j] * delta
            beta[j] = bj
    return beta
