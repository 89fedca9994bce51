"""Depth-hole inpainting: diffusion substitute for ``cv::INPAINT_TELEA``.

Port of ``srmeetsps_cuda_tpu/pre/inpaint.py``. Missing LR depth (pixels
where any frame reported 0) is filled by a coarse-to-fine pyramid seed
followed by Jacobi relaxation of the masked harmonic equation
(SRPS.cu:129-133 runs Telea's fast marching with radius 16 instead).

The relaxation runs in ``csrc/inpaint.cu`` for a CUDA tensor
(:func:`relax_cuda`: the sweeps in passes of :func:`sweeps_per_pass`, one
launch a pass, bit for bit :func:`relax_plain` on the card) and as the
plain PyTorch loop for a CPU one.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import trace as tracing
from ..ops.gradients import shift

def _conv3(x: torch.Tensor) -> torch.Tensor:
    """Zero-padded 3x3 correlation with [[.5, 1, .5], [1, 0, 1], [.5, 1, .5]],
    as shifted adds (a cuDNN convolution would run in TF32 by default)."""
    edges = shift(x, 0, 1) + shift(x, 0, -1) + shift(x, 1, 0) + shift(x, -1, 0)
    corners = (shift(x, 1, 1) + shift(x, 1, -1) + shift(x, -1, 1)
               + shift(x, -1, -1))
    return edges + 0.5 * corners


def _down2(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape
    ph, pw = h % 2, w % 2
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph))
    h2, w2 = x.shape
    return x.reshape(h2 // 2, 2, w2 // 2, 2).sum(dim=(1, 3))


def _up2(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    up = x.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    return up[:h, :w]


def pyramid_fill(img: torch.Tensor, known: torch.Tensor) -> torch.Tensor:
    """The relaxation's start in the holes: at each pixel the mean of the
    known (float 0/1) pixels of ``img`` in the finest pyramid cell around
    it that holds one."""
    h, w = img.shape
    levels = []
    num, den = img * known, known
    size = max(h, w)
    while size > 1:
        levels.append((num, den))
        num, den = _down2(num), _down2(den)
        size = (size + 1) // 2
    fill = num / torch.clamp(den, min=1e-20)
    for num_l, den_l in reversed(levels):
        hl, wl = num_l.shape
        fill = _up2(fill, hl, wl)
        fill = torch.where(den_l > 0, num_l / torch.clamp(den_l, min=1e-20),
                           fill)
    return fill


def relax_plain(u: torch.Tensor, img: torch.Tensor, known_b: torch.Tensor,
                iters: int) -> torch.Tensor:
    """``iters`` Jacobi sweeps of the masked harmonic equation from ``u``,
    ``img`` kept where ``known_b``."""
    for _ in range(iters):
        u = torch.where(known_b, img, _conv3(u) / 6.0)
    return u


def _library():
    """The built kernel library with its C signatures declared."""
    from .. import native

    lib = native.load("inpaint")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.srps_inpaint.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    lib.srps_inpaint.restype = ci
    lib.srps_inpaint_sweeps_per_pass.argtypes = []
    lib.srps_inpaint_sweeps_per_pass.restype = ci
    return lib


def sweeps_per_pass() -> int:
    """The sweeps one launch of ``csrc/inpaint.cu`` runs (the last of a
    relaxation runs what is left): a relaxation of ``iters`` sweeps is
    ceil(iters / this) launches. Builds the library on first use."""
    return int(_library().srps_inpaint_sweeps_per_pass())


def relax_cuda(u: torch.Tensor, known_b: torch.Tensor,
               iters: int) -> torch.Tensor:
    """:func:`relax_plain` in ``csrc/inpaint.cu``, one launch a pass of
    :func:`sweeps_per_pass` sweeps: ``u`` (float32, CUDA, contiguous,
    equal to the image where ``known_b``) is the first of its two buffers
    and may be overwritten. Counts the launches as ``"inpaint"`` in the
    launch registry (``trace.launched``)."""
    if u.device.type != "cuda":
        raise ValueError(f"the inpaint kernel runs on cuda, not {u.device}")
    if u.dtype != torch.float32 or u.dim() != 2 or not u.is_contiguous():
        raise ValueError("u must be a contiguous float32 (h, w) tensor")
    if (known_b.dtype != torch.bool or known_b.shape != u.shape
            or known_b.device != u.device or not known_b.is_contiguous()):
        raise ValueError("known_b must be a contiguous bool tensor like u")
    h, w = u.shape
    b = u.clone()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        passes = _library().srps_inpaint(
            u.data_ptr(), b.data_ptr(), known_b.data_ptr(), h, w, int(iters),
            stream)
    if passes < 0:
        raise RuntimeError(f"inpaint kernel launch failed: CUDA error "
                           f"{-passes}")
    tracing.launched("inpaint", passes)
    return b if passes % 2 else u


def inpaint_diffusion(img: torch.Tensor, holes: torch.Tensor,
                      iters: int = 256) -> torch.Tensor:
    """Fill ``holes`` (bool or 0/1, 1 = missing) in ``img``; known pixels
    are kept exactly, holes get a smooth harmonic extension. The sweeps run
    in the CUDA kernel for a CUDA ``img``, in PyTorch for a CPU one."""
    img = img.to(torch.float32)
    known = 1.0 - holes.to(torch.float32)
    known_b = known > 0
    u = torch.where(known_b, img, pyramid_fill(img, known))
    if u.device.type == "cpu":
        return relax_plain(u, img, known_b, iters)
    return relax_cuda(u, known_b, iters)
