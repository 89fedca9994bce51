"""Sparse-operator triplet dumps, the reference's golden debug channel.

The port's copy of ``srmeetsps_cuda_tpu/io/sparse_dump.py`` (numpy only).
The reference can dump any sparse operator as a MAT file holding the COO
triplets ``ii/jj/kk`` and the scalars ``rows/cols`` (``write_MAT_sparse``,
Utilities.cpp:85-122), which MATLAB reads as ``sparse(ii+1, jj+1, kk)``.
The port has no stored sparse matrices (its operators are dense-grid
stencils and resamples), so this module rebuilds the same triplets from
the problem's own fields, the ``GradientMasks`` and the LR mask, copied to
the host with ``writers.to_host``.

Index conventions are the reference's: pixels are scanned in column-major
order (linear index ``i + j*h``), masked-space indices come from that scan
restricted to the mask (SRPS.cu:151-168), and indices are written 0-based.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .writers import _mat_version, save_sparse_mat, to_host


def _colmajor_masked_index(mask: np.ndarray) -> np.ndarray:
    """index_in_masked_matrix (SRPS.cu:160-168): for each column-major
    linear pixel index, its position among the masked pixels (meaningless
    where unmasked)."""
    m = (np.asarray(mask) != 0).T.ravel()
    return np.cumsum(m) - 1


def _canon(ii, jj, kk) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Triplets sorted by (row, col). The reference's nnz order is a build
    artifact and MATLAB's ``sparse()`` ignores order, so dumps are sorted
    for direct diffing."""
    order = np.lexsort((jj, ii))
    return (ii[order].astype(np.int32), jj[order].astype(np.int32),
            kk[order].astype(np.float32))


def gradient_coo(gm, mask):
    """COO triplets of ``Dx`` and ``Dy`` over masked-index space, from the
    forward/backward selection fields (SRPS.cu:23-71): a forward difference
    puts +1 at the next masked neighbour and -1 at the pixel, a backward
    one +1 at the pixel and -1 at the previous. Returns ((ii, jj, kk) of
    Dx, the same of Dy, npix)."""
    mask = to_host(mask)
    h, _ = mask.shape
    midx = _colmajor_masked_index(mask)
    npix = int((mask != 0).sum())

    def mp(i, j):
        return midx[i + j * h]

    def axis_coo(fwd, bwd, di, dj):
        fi, fj = np.nonzero(to_host(fwd) != 0)
        bi, bj = np.nonzero(to_host(bwd) != 0)
        rows = np.concatenate([mp(fi, fj), mp(fi, fj),
                               mp(bi, bj), mp(bi, bj)])
        cols = np.concatenate([mp(fi + di, fj + dj), mp(fi, fj),
                               mp(bi, bj), mp(bi - di, bj - dj)])
        vals = np.concatenate([np.ones_like(fi, np.float32),
                               -np.ones_like(fi, np.float32),
                               np.ones_like(bi, np.float32),
                               -np.ones_like(bi, np.float32)])
        return _canon(rows, cols, vals)

    dx = axis_coo(gm.fwd_x, gm.bwd_x, 0, 1)
    dy = axis_coo(gm.fwd_y, gm.bwd_y, 1, 0)
    return dx, dy, npix


def downsample_coo(h: int, w: int, sf: int):
    """COO triplets of the full-grid box-downsampling matrix ``D``
    (Utilities.cpp:201-220): one row per LR pixel, sf*sf entries of 1/sf^2
    over its HR tile, column-major index space. Returns (ii, jj, kk, rows,
    cols)."""
    hl, wl = h // sf, w // sf
    il, jl = np.meshgrid(np.arange(hl), np.arange(wl), indexing="ij")
    rows = (il + jl * hl).ravel()
    k, jx = np.meshgrid(np.arange(sf), np.arange(sf), indexing="ij")
    # HR column-major indices of the tile under each LR pixel.
    hr = ((il[..., None, None] * sf + k)
          + (jl[..., None, None] * sf + jx) * h)
    rows = np.repeat(rows, sf * sf)
    cols = hr.reshape(hl * wl, sf * sf).ravel()
    vals = np.full(rows.shape, 1.0 / (sf * sf), np.float32)
    return _canon(rows, cols, vals) + (hl * wl, h * w)


def kt_coo(mask, masks, sf: int):
    """COO triplets of ``KT``: ``D`` restricted to masked LR rows and
    masked HR columns, values 1/sf^2 (SRPS.cu:170-193), npixs x npix in
    masked-index spaces. Returns (ii, jj, kk, rows, cols)."""
    mask, masks = to_host(mask), to_host(masks)
    h, w = mask.shape
    ii, jj, kk, _, _ = downsample_coo(h, w, sf)
    m_hr = (mask != 0).T.ravel()
    m_lr = (masks != 0).T.ravel()
    keep = m_lr[ii] & m_hr[jj]
    midx_lr = _colmajor_masked_index(masks)
    midx_hr = _colmajor_masked_index(mask)
    return (_canon(midx_lr[ii[keep]], midx_hr[jj[keep]], kk[keep])
            + (int(m_lr.sum()), int(m_hr.sum())))


def dump_operators(dirpath: str, prob, sf: int, fmt: str = "mat"):
    """Write D.mat, Dx.mat, Dy.mat and KT.mat triplet files (the
    reference's WRITE_MAT_FROM_DEVICE_SPARSE channel, Utilities.h:84-96):
    MAT v5 for ``fmt="mat5"``, which needs no h5py, else MAT 7.3, the
    container the JAX package always writes."""
    version = _mat_version(fmt)
    mask = to_host(prob.mask)
    h, w = mask.shape
    os.makedirs(dirpath, exist_ok=True)
    dx, dy, npix = gradient_coo(prob.gm, mask)
    for name, tri in (("Dx", dx + (npix, npix)), ("Dy", dy + (npix, npix)),
                      ("D", downsample_coo(h, w, sf)),
                      ("KT", kt_coo(mask, prob.masks, sf))):
        save_sparse_mat(os.path.join(dirpath, f"{name}.mat"), *tri,
                        version=version)
