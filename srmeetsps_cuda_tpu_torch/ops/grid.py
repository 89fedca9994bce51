"""Dense-grid operators replacing the reference's sparse matrices.

Port of ``srmeetsps_cuda_tpu/ops/grid.py``. The reference's down-sampling
operator ``D`` (Utilities.cpp:201-220) and its mask-filtered version ``KT``
(SRPS.cu:170-193) are structured operators on the regular image grid, so
state stays as dense ``(h, w)`` tensors (zeros outside the mask) and the
operators are reshapes and reductions.

Arrays are row-major ``(h, w)``: axis 0 is the image row ``i``, axis 1 the
column ``j`` (the reference's column-major linear index is ``i + j*h``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def box_downsample(z: torch.Tensor, sf: int) -> torch.Tensor:
    """sf x sf box mean over aligned tiles (the reference's ``D``), on
    ``(..., h, w)`` with ``h % sf == w % sf == 0``."""
    *lead, h, w = z.shape
    if h % sf or w % sf:
        raise ValueError(f"box_downsample: ({h},{w}) not divisible by sf={sf}")
    s = z.reshape(*lead, h // sf, sf, w // sf, sf).sum(dim=(-3, -1))
    return s / float(sf * sf)


def box_upsample_adjoint(u: torch.Tensor, sf: int) -> torch.Tensor:
    """``D^T u``: each LR value replicated into its tile, scaled 1/sf^2."""
    up = u.repeat_interleave(sf, dim=-2).repeat_interleave(sf, dim=-1)
    return up / float(sf * sf)


def tilesum(v: torch.Tensor, sf: int) -> torch.Tensor:
    """Per aligned sf x sf tile sum, replicated to every pixel of the tile
    (the semantics of ``pallas_cg._tilesum``)."""
    if sf == 1:
        return v
    *lead, h, w = v.shape
    s = v.reshape(*lead, h // sf, sf, w // sf, sf).sum(dim=(-3, -1))
    return s.repeat_interleave(sf, dim=-2).repeat_interleave(sf, dim=-1)


def lr_mask(mask: torch.Tensor, sf: int) -> torch.Tensor:
    """``D @ mask`` with entries ``< 1`` zeroed (SRPS.cu:110-111): an LR
    pixel is kept iff all sf x sf HR pixels under it are masked."""
    m = box_downsample(mask.to(torch.float32), sf)
    return (m >= 1.0).to(torch.float32)


def resample_masked(z: torch.Tensor, masks: torch.Tensor, sf: int) -> torch.Tensor:
    """``KT @ z``: masked box down-sampling."""
    return box_downsample(z, sf) * masks


def resample_masked_t(u: torch.Tensor, mask: torch.Tensor, masks: torch.Tensor,
                      sf: int) -> torch.Tensor:
    """``KT^T @ u``, supported on the HR mask."""
    return box_upsample_adjoint(u * masks, sf) * mask


def meshgrid_camera(h: int, w: int, cx: float, cy: float,
                    device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``xx = j - cx``, ``yy = i - cy`` (devicecalls.cu:151-158)."""
    jj = torch.arange(w, dtype=torch.float32, device=device).expand(h, w)
    ii = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    cx_t = torch.tensor(cx, dtype=torch.float32, device=device)
    cy_t = torch.tensor(cy, dtype=torch.float32, device=device)
    return jj - cx_t, ii - cy_t


def mean_across_frames(z0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel mean of the LR depth frames, with hole flags.

    Mirrors ``mean_across_channels`` (devicecalls.cu:95-110) and its quirk:
    zeros add nothing to the numerator, but the denominator is the full
    frame count ``n``. A pixel is flagged if any frame is zero there."""
    n = z0.shape[0]
    mean = z0.sum(dim=0) / float(n)
    holes = (z0 == 0.0).any(dim=0)
    return mean, holes


def masked_select_colmajor(arr, mask) -> np.ndarray:
    """Masked values in the reference's column-major scan order (host
    numpy; SRPS.cu:231,239,246)."""
    a = np.asarray(arr)
    m = np.asarray(mask) != 0
    return a.T[m.T]


def masked_scatter_colmajor(values, mask) -> np.ndarray:
    """Inverse of :func:`masked_select_colmajor`: dense (h, w) from packed."""
    m = np.asarray(mask) != 0
    out = np.zeros(m.shape, dtype=np.asarray(values).dtype)
    out.T[m.T] = values
    return out


def pad_to_multiple(arr: torch.Tensor, mh: int, mw: int, value: float = 0.0):
    """Pad the trailing two dims at their far ends up to multiples of
    ``(mh, mw)``. Returns ``(padded, (h, w))`` with the original size."""
    h, w = arr.shape[-2:]
    ph = (-h) % mh
    pw = (-w) % mw
    if ph == 0 and pw == 0:
        return arr, (h, w)
    return F.pad(arr, (0, pw, 0, ph), value=value), (h, w)
