"""Depth-hole inpainting: diffusion substitute for ``cv::INPAINT_TELEA``.

Port of ``srmeetsps_cuda_tpu/pre/inpaint.py``. Missing LR depth (pixels
where any frame reported 0) is filled by a coarse-to-fine pyramid seed
followed by Jacobi relaxation of the masked harmonic equation
(SRPS.cu:129-133 runs Telea's fast marching with radius 16 instead).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.gradients import shift


def _conv3(x: torch.Tensor) -> torch.Tensor:
    """Zero-padded 3x3 correlation with [[.5, 1, .5], [1, 0, 1], [.5, 1, .5]],
    as shifted adds (a cuDNN convolution would run in TF32 by default)."""
    edges = shift(x, 0, 1) + shift(x, 0, -1) + shift(x, 1, 0) + shift(x, -1, 0)
    corners = (shift(x, 1, 1) + shift(x, 1, -1) + shift(x, -1, 1)
               + shift(x, -1, -1))
    return edges + 0.5 * corners


def _down2(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape
    ph, pw = h % 2, w % 2
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph))
    h2, w2 = x.shape
    return x.reshape(h2 // 2, 2, w2 // 2, 2).sum(dim=(1, 3))


def _up2(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    up = x.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    return up[:h, :w]


def inpaint_diffusion(img: torch.Tensor, holes: torch.Tensor,
                      iters: int = 256) -> torch.Tensor:
    """Fill ``holes`` (bool or 0/1, 1 = missing) in ``img``; known pixels
    are kept exactly, holes get a smooth harmonic extension."""
    img = img.to(torch.float32)
    known = 1.0 - holes.to(torch.float32)
    h, w = img.shape

    levels = []
    num, den = img * known, known
    size = max(h, w)
    while size > 1:
        levels.append((num, den))
        num, den = _down2(num), _down2(den)
        size = (size + 1) // 2
    fill = num / torch.clamp(den, min=1e-20)
    for num_l, den_l in reversed(levels):
        hl, wl = num_l.shape
        fill = _up2(fill, hl, wl)
        fill = torch.where(den_l > 0, num_l / torch.clamp(den_l, min=1e-20),
                           fill)
    known_b = known > 0
    u = torch.where(known_b, img, fill)
    for _ in range(iters):
        u = torch.where(known_b, img, _conv3(u) / 6.0)
    return u
