"""The depth CG's work and its least time on one H100.

The work is that of the CG the problem needs, whatever kernel computes it,
counted over the pixels of the mask (a pixel outside it is zero in every
field and needs no work):

* operations: about 150 per pixel to fold the operator into its 9-point
  stencil and form the warm-start residual, then 27 per pixel per CG
  iteration (the 9-point matvec, two dots and three vector updates);
* bytes: the solve's inputs read once and its outputs written once, 19
  float32 planes per pixel (the 6 Gram fields, the 3 rhs fields, the 4
  gradient masks, the resample weight and the LR data plane, the start
  and the two energy planes in; the result out).

The least time is the larger of operations over the float32 peak and bytes
over the memory bandwidth (NVIDIA's H100 SXM data sheet, at its 700 W power
limit).
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
OPS_PROLOGUE = 150
OPS_PER_ITER = 27
PLANES = 19


def cg_ops(pixels: int, iterations: int) -> float:
    return float(pixels) * (OPS_PROLOGUE + OPS_PER_ITER * iterations)


def cg_bytes(pixels: int) -> float:
    return float(pixels) * PLANES * 4


def least_seconds(pixels: int, iterations: int) -> tuple[float, str]:
    """The least time of one CG solve and what bounds it."""
    t_ops = cg_ops(pixels, iterations) / PEAK_F32_FLOPS
    t_bytes = cg_bytes(pixels) / PEAK_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
