"""LR-depth preprocessing pipeline (reference SRPS.cu:117-149)."""

from __future__ import annotations

import torch

from .. import trace as tracing
from ..config import SolverConfig
from ..ops.grid import mean_across_frames
from .bilateral import bilateral_filter
from .inpaint import inpaint_diffusion
from .resize import resize_bicubic

__all__ = [
    "bilateral_filter",
    "inpaint_diffusion",
    "resize_bicubic",
    "preprocess_depth",
]


def preprocess_depth(z0: torch.Tensor, h: int, w: int,
                     cfg: SolverConfig = SolverConfig()):
    """Mean -> inpaint -> max-normalise -> bilateral -> bicubic upsample.

    Args:
      z0: (n, h/sf, w/sf) raw LR depth frames (0 = missing), on the
        device the solve runs on.
      h, w: HR output size.

    Returns:
      (zs, z_init): the smoothed LR depth (h/sf, w/sf) and the bicubic HR
      initial depth (h, w).
    """
    with tracing.span("srps.prepare.mean"):
        zs_mean, holes = mean_across_frames(z0.to(torch.float32))
    iters = (cfg.inpaint_iters if cfg.inpaint_iters is not None
             else 2 * cfg.inpaint_radius ** 2)
    with tracing.span("srps.prepare.inpaint"):
        zs = inpaint_diffusion(zs_mean, holes, iters=iters)
    with tracing.span("srps.prepare.bilateral"):
        mx = torch.max(zs)
        mx = torch.where(mx == 0, torch.ones_like(mx), mx)
        zs_f = bilateral_filter(zs / mx, cfg.bilateral_sigma_color,
                                cfg.bilateral_sigma_space) * mx
    with tracing.span("srps.prepare.bicubic", factor=h // zs_f.shape[-2]):
        z_init = resize_bicubic(zs_f, h, w)
    return zs_f, z_init
