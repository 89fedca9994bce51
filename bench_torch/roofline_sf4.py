"""The depth CG's work and its least time on one H100 at sf = 4.

At sf <= 2 the KT^T KT term of the depth operator folds into the 9
stencil planes (``roofline.py`` counts that work). At sf = 4 its tile
mates lie up to 3 pixels apart, so it stays out of the planes: each
matvec adds ``ktw * tilesum(v)`` over the aligned 4 x 4 tiles
(``csrc/stencil_cg.cu``, phase A and the prologue). Counted from the
kernel's arithmetic, each value computed once, over the mask's pixels:

* a CG iteration: the 27 operations of ``roofline.py`` (the 9-point
  matvec 17, two dots and three vector updates 10), the multiply-add of
  ``ktw`` into the matvec (2) and the tile's sum, 15 additions shared by
  its 16 pixels: 27 + 2 + 15 / 16 per pixel;
* the prologue: ``roofline.py``'s 150 less the 9 additions that fold
  ``ktw`` into the planes at sf = 2 (not made at sf = 4), with M x0's
  tile term added (2 + 15 / 16).

The bytes are ``roofline.py``'s 19 float32 planes a pixel: the planes
read once and the result written once are the same at every sf (``ktw``,
the resample weight, is one of them; the kernel streams it again in
every iteration at sf = 4, which is its design's traffic, not a least).

The least time is the larger of operations over the float32 peak and
bytes over the memory bandwidth, at ``roofline.py``'s peaks.
"""

from __future__ import annotations

from bench_torch.roofline import PEAK_BYTES_PER_S, PEAK_F32_FLOPS, PLANES

TILE_SUM = 15 / 16  # the 4 x 4 tile's additions, a pixel
OPS_PROLOGUE = 150 - 9 + 2 + TILE_SUM
OPS_PER_ITER = 27 + 2 + TILE_SUM


def cg_ops(pixels: int, iterations: int) -> float:
    return float(pixels) * (OPS_PROLOGUE + OPS_PER_ITER * iterations)


def cg_bytes(pixels: int) -> float:
    return float(pixels) * PLANES * 4


def least_seconds(pixels: int, iterations: int) -> tuple[float, str]:
    """The least time of one sf = 4 CG solve and what bounds it."""
    t_ops = cg_ops(pixels, iterations) / PEAK_F32_FLOPS
    t_bytes = cg_bytes(pixels) / PEAK_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
