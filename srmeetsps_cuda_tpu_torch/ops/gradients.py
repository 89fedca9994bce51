"""Masked forward-difference-with-backward-fallback gradients.

Port of ``srmeetsps_cuda_tpu/ops/gradients.py``. The reference's sparse
``Dx``/``Dy`` (``make_gradient``, SRPS.cu:10-71) prefer a forward difference
to the next masked neighbour and fall back to a backward one; pixels with
neither get a zero row. Here they are two-point stencils gated by
mask-derived fields (x = columns ``j``, y = rows ``i``):

  fwd_x(i,j) = mask(i,j) & mask(i,j+1)             -> z(i,j+1)-z(i,j)
  bwd_x(i,j) = ~fwd_x & mask(i,j) & mask(i,j-1)    -> z(i,j)-z(i,j-1)
  fwd_y(i,j) = mask(i,j) & mask(i+1,j)             -> z(i+1,j)-z(i,j)
  bwd_y(i,j) = ~fwd_y & mask(i,j) & mask(i-1,j)    -> z(i,j)-z(i-1,j)

Out-of-bounds neighbours read as zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


def shift(a: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """``out[i, j] = a[i + di, j + dj]``, zero where that lies outside."""
    h, w = a.shape[-2:]
    out = a
    if di:
        k = abs(di)
        body = out[..., k:, :] if di > 0 else out[..., :h - k, :]
        out = F.pad(body, (0, 0, 0, k) if di > 0 else (0, 0, k, 0))
    if dj:
        k = abs(dj)
        body = out[..., :, k:] if dj > 0 else out[..., :, :w - k]
        out = F.pad(body, (0, k) if dj > 0 else (k, 0))
    return out


class GradientMasks(NamedTuple):
    """The reference's forward-else-backward choice per pixel and axis
    (SRPS.cu:29-48), as float32 0/1 fields."""

    fwd_x: torch.Tensor
    bwd_x: torch.Tensor
    fwd_y: torch.Tensor
    bwd_y: torch.Tensor

    @staticmethod
    def from_mask(mask: torch.Tensor) -> "GradientMasks":
        m = mask != 0
        fwd_x = m & shift(m, 0, 1)
        bwd_x = m & shift(m, 0, -1) & ~fwd_x
        fwd_y = m & shift(m, 1, 0)
        bwd_y = m & shift(m, -1, 0) & ~fwd_y
        f32 = lambda b: b.to(torch.float32)  # noqa: E731
        return GradientMasks(f32(fwd_x), f32(bwd_x), f32(fwd_y), f32(bwd_y))


def grad_x(z: torch.Tensor, gm: GradientMasks) -> torch.Tensor:
    """``Dx @ z`` on the dense grid."""
    return gm.fwd_x * (shift(z, 0, 1) - z) + gm.bwd_x * (z - shift(z, 0, -1))


def grad_y(z: torch.Tensor, gm: GradientMasks) -> torch.Tensor:
    """``Dy @ z`` on the dense grid."""
    return gm.fwd_y * (shift(z, 1, 0) - z) + gm.bwd_y * (z - shift(z, -1, 0))


def grad_x_t(y: torch.Tensor, gm: GradientMasks) -> torch.Tensor:
    """``Dx^T @ y``: each row scatters +1 to its chosen neighbour and -1
    to itself (forward) or the mirror (backward); the adjoint gathers."""
    fy = gm.fwd_x * y
    by = gm.bwd_x * y
    return shift(fy, 0, -1) - fy + by - shift(by, 0, 1)


def grad_y_t(y: torch.Tensor, gm: GradientMasks) -> torch.Tensor:
    """``Dy^T @ y``."""
    fy = gm.fwd_y * y
    by = gm.bwd_y * y
    return shift(fy, -1, 0) - fy + by - shift(by, 1, 0)
