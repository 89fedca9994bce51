"""Bicubic resize matching ``cv::resize(..., INTER_CUBIC)``.

Port of ``srmeetsps_cuda_tpu/pre/resize.py`` (SRPS.cu:146-149): Keys cubic
kernel with A = -0.75, half-pixel centres, replicate clamping at the
borders, applied as two dense interpolation-matrix GEMMs in full float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_A = -0.75  # OpenCV's bicubic coefficient


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """Keys weights of the 4 taps at offsets (-1, 0, 1, 2) for the
    fractional position t in [0, 1) (OpenCV interpolateCubic)."""
    A = _A
    w = np.empty(t.shape + (4,), np.float64)
    w[..., 0] = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    w[..., 1] = ((A + 2) * t - (A + 3)) * t * t + 1
    w[..., 2] = ((A + 2) * (1 - t) - (A + 3)) * (1 - t) * (1 - t) + 1
    w[..., 3] = 1.0 - w[..., 0] - w[..., 1] - w[..., 2]
    return w


@functools.lru_cache(maxsize=32)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) bicubic interpolation matrix with replicate
    border clamping."""
    scale = n_in / n_out
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    w = _cubic_weights(t)
    W = np.zeros((n_out, n_in), np.float64)
    for tap in range(4):
        idx = np.clip(i0 - 1 + tap, 0, n_in - 1)
        np.add.at(W, (dst.astype(np.int64), idx), w[..., tap])
    return W.astype(np.float32)


def resize_bicubic(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize the trailing (h, w) dims of ``img`` to (out_h, out_w)."""
    h, w = img.shape[-2:]
    Wh = torch.from_numpy(_interp_matrix(h, out_h)).to(img.device)
    Ww = torch.from_numpy(_interp_matrix(w, out_w)).to(img.device)
    out = torch.matmul(Wh, img.to(torch.float32))
    return torch.matmul(out, Ww.T)
