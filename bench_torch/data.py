"""Seeded Lambertian captures, drawn on the device.

A capture is what a 3-D capture rig hands the solver: n RGB images of one
object under n unknown directional lights, n noisy low-resolution depth
frames, the object's mask and the camera's intrinsics. The scene is the
one of ``srmeetsps_cuda_tpu_torch/io/synthetic.py::lambertian_dataset``:
a smooth surface at about 1 m, an elliptical mask, lights around (0.2,
0.2, -0.9, 0.3) with jitter, one albedo per channel, LR depth noise of 0.5
mm and one hole in frame 0. The photometric data are consistent with the
surface, so a solve runs its real number of outer iterations.

Here the surface's phases, the lights, the albedo and the noise are drawn
from a ``torch.Generator`` on the device, one capture after another, so
the captures of a pool differ and the same seed gives the same pool. The
benchmark draws a configuration's pool from the configuration's fixed
content seed: how many outer iterations a capture takes (5 to 11) follows
its content, so a pool of its own for every run would change the work
from run to run. Each capture is moved to host arrays once, as a rig
hands them over.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Capture(NamedTuple):
    """Host arrays of one capture, in the fields of the port's
    ``ProblemData``: I (n, c, h, w), K (3, 3), mask (h, w), sf, z0 (n,
    h/sf, w/sf) in mm with 0 where a frame has no depth."""

    I: np.ndarray
    K: np.ndarray
    mask: np.ndarray
    sf: int
    z0: np.ndarray


def draw_capture(gen: torch.Generator, h: int, w: int, sf: int, n: int,
                 c: int, fx: float, fy: float, device) -> dict:
    """One capture as device tensors, drawn from ``gen``."""
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand(2 + c + 4 * n, generator=gen, **f32)
    phase_x, phase_y = (2 * math.pi * u[:2]).unbind()
    rho = 0.4 + 0.3 * u[2:2 + c]
    lights = torch.tensor([0.2, 0.2, -0.9, 0.3], **f32) + 0.2 * torch.randn(
        n, 4, generator=gen, **f32)
    yy = torch.arange(h, **f32)[:, None].expand(h, w)
    xx = torch.arange(w, **f32)[None, :].expand(h, w)
    z = (1000.0 + 40.0 * torch.sin(2 * math.pi * 2 * xx / w + phase_x)
         + 30.0 * torch.cos(2 * math.pi * 1.5 * yy / h + phase_y))
    r = 0.42 * min(h, w)
    mask = (((yy - h / 2) ** 2 + ((xx - w / 2) * 0.9) ** 2) < r * r).float()
    cx, cy = w / 2 - 0.5, h / 2 - 0.5
    zy, zx = torch.gradient(z)
    n1, n2 = fx * zx, fy * zy
    n3 = -z - (xx - cx) * zx - (yy - cy) * zy
    nrm = torch.sqrt(n1 * n1 + n2 * n2 + n3 * n3)
    N = torch.stack([n1 / nrm, n2 / nrm, n3 / nrm, torch.ones_like(z)])
    shade = torch.einsum("nk,khw->nhw", lights, N)  # (n, h, w)
    I = torch.clamp(rho[None, :, None, None] * shade[:, None], min=0.0)
    z0 = z[::sf, ::sf][None] + 0.5 * torch.randn(
        n, h // sf, w // sf, generator=gen, **f32)
    z0[0, 10:14, 20:26] = 0.0
    K = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], **f32)
    return dict(I=I, K=K, mask=mask, z0=z0, z_true=z)


def make_pool(seed: int, count: int, h: int, w: int, sf: int, n: int, c: int,
              fx: float, fy: float, device) -> list[Capture]:
    """``count`` distinct captures from ``seed``, as host arrays."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    pool = []
    for _ in range(count):
        t = draw_capture(gen, h, w, sf, n, c, fx, fy, device)
        host = {k: v.cpu().numpy() for k, v in t.items() if k != "z_true"}
        pool.append(Capture(I=host["I"], K=host["K"], mask=host["mask"],
                            sf=sf, z0=host["z0"]))
        del t
    return pool


def crop(cap: Capture, h: int, w: int) -> Capture:
    """The centred (h, w) crop of a capture, its principal point at the
    crop's centre, as contiguous host arrays. The offsets are multiples of
    sf, so the LR frames crop with the image."""
    H, W = cap.mask.shape
    sf = cap.sf
    if (H - h) % (2 * sf) or (W - w) % (2 * sf) or h > H or w > W:
        raise ValueError(f"crop ({h}, {w}) of ({H}, {W}) at sf {sf}")
    i0, j0 = (H - h) // 2, (W - w) // 2
    K = cap.K.copy()
    K[0, 2] -= j0
    K[1, 2] -= i0
    c = np.ascontiguousarray
    return Capture(I=c(cap.I[:, :, i0:i0 + h, j0:j0 + w]), K=K,
                   mask=c(cap.mask[i0:i0 + h, j0:j0 + w]), sf=sf,
                   z0=c(cap.z0[:, i0 // sf:(i0 + h) // sf,
                               j0 // sf:(j0 + w) // sf]))
