"""Seeded synthetic datasets for runs without the Mitten fixture.

Lambertian renders of a smooth surface under random directional lights, in
the form of tests/test_e2e.py::synthetic_data, at any geometry: the
photometric stereo data are consistent with a known depth, so a solve on
them is well conditioned and its depth can be scored against the truth.
"""

from __future__ import annotations

import numpy as np

from .image_loader import ProblemData

FOCAL = 1216.73  # bench.py's Mitten-geometry intrinsics


def lambertian_dataset(h: int, w: int, sf: int, n: int, c: int, seed: int = 0):
    """Returns ``(ProblemData, z_true)``: n images of c channels at (h, w),
    n noisy LR depth frames at (h/sf, w/sf) with a hole, depth in mm."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    z_true = (1000.0 + 40.0 * np.sin(2 * np.pi * 2 * xx / w)
              + 30.0 * np.cos(2 * np.pi * 1.5 * yy / h)).astype(np.float32)
    r = 0.42 * min(h, w)
    mask = (((yy - h / 2) ** 2 + ((xx - w / 2) * 0.9) ** 2) < r * r)
    mask = mask.astype(np.float32)
    cx, cy = w / 2 - 0.5, h / 2 - 0.5
    zx = np.gradient(z_true, axis=1)
    zy = np.gradient(z_true, axis=0)
    n1, n2 = FOCAL * zx, FOCAL * zy
    n3 = -z_true - (xx - cx) * zx - (yy - cy) * zy
    nrm = np.sqrt(n1 ** 2 + n2 ** 2 + n3 ** 2)
    N = np.stack([n1 / nrm, n2 / nrm, n3 / nrm, np.ones_like(z_true)])
    rho = (0.4 + 0.3 * rng.random((c, 1, 1))).astype(np.float32)
    I = np.empty((n, c, h, w), np.float32)
    for i in range(n):
        s = np.array([0.2, 0.2, -0.9, 0.3]) + 0.2 * rng.standard_normal(4)
        shade = np.tensordot(s.astype(np.float32), N, axes=1)
        I[i] = np.clip(rho * shade[None], 0, None)
    z0 = np.stack([z_true[::sf, ::sf] + 0.5 * rng.standard_normal(
        (h // sf, w // sf)) for _ in range(n)]).astype(np.float32)
    z0[0, 10:14, 20:26] = 0.0
    K = np.array([[FOCAL, 0, cx], [0, FOCAL, cy], [0, 0, 1]], np.float32)
    return ProblemData(I=I, K=K, mask=mask, sf=sf, z0=z0), z_true
