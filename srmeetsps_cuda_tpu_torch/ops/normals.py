"""Surface normals from the masked depth gradient.

Port of ``srmeetsps_cuda_tpu/ops/normals.py`` (``cuda_based_normal_init``,
devicecalls.cu:171-223):

  n = (fx * zx, fy * zy, -z - xx*zx - yy*zy)
  dz = max(1e-10, |n|)
  N  = (n / dz, mask)

The fourth component is the mask (1 on masked pixels, 0 outside), so dense
masked reductions stay exact. ``dz`` is returned separately because the
depth linearisation divides by the previous iterate's ``dz``.
"""

from __future__ import annotations

import torch

DZ_EPS = 1e-10


def normals_from_depth(z, zx, zy, xx, yy, mask, fx: float, fy: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(N, dz)`` with ``N: (4, h, w)`` and ``dz: (h, w)``."""
    n1 = fx * zx
    n2 = fy * zy
    n3 = -z - xx * zx - yy * zy
    dz = torch.clamp(torch.sqrt(n1 * n1 + n2 * n2 + n3 * n3), min=DZ_EPS)
    N = torch.stack([n1 / dz, n2 / dz, n3 / dz, mask], dim=0)
    return N, dz
