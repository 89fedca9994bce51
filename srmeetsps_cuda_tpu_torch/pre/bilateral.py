"""Bilateral filter matching ``cv::bilateralFilter(src, dst, -1, 2, 2)``.

Port of ``srmeetsps_cuda_tpu/pre/bilateral.py`` (SRPS.cu:135-140): window
radius ``round(1.5 * sigma_space)`` restricted to the disk, true Gaussian
weights, BORDER_REFLECT_101 padding (``F.pad(mode="reflect")``, which
needs a batch and a channel axis).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def bilateral_filter(img: torch.Tensor, sigma_color: float = 2.0,
                     sigma_space: float = 2.0, radius: int | None = None
                     ) -> torch.Tensor:
    if radius is None:
        radius = int(round(sigma_space * 1.5))
    img = img.to(torch.float32)
    pad = F.pad(img[None, None], (radius,) * 4, mode="reflect")[0, 0]
    h, w = img.shape
    gc = -0.5 / (sigma_color * sigma_color)
    gs = -0.5 / (sigma_space * sigma_space)

    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    for di in range(-radius, radius + 1):
        for dj in range(-radius, radius + 1):
            if di * di + dj * dj > radius * radius + 1e-9:
                continue
            shifted = pad[di + radius:di + radius + h, dj + radius:dj + radius + w]
            sw = math.exp(gs * (di * di + dj * dj))
            wgt = sw * torch.exp(gc * (shifted - img) ** 2)
            num = num + wgt * shifted
            den = den + wgt
    return num / den
