"""The inpaint's Jacobi relaxation in ``csrc/inpaint.cu`` against the plain
PyTorch loop (``pre/inpaint.py``).

On the CPU: the kernel's scheme (tiles, halos of K pixels, passes of up to
K sweeps alternating between two buffers) modelled in PyTorch for the
kernel's tile and K and for smaller ones, bit for bit the plain loop. On a
CUDA card (marked ``cuda``, skipped without one): the kernel bit for bit
the plain loop on the card at the main path's LR grids and odd ones, holes
on the border, in the corners, larger than a tile and its halo, none and
all, and sweep counts around K, with ceil(sweeps / K) launches, K as the
kernel's library reports it. This file imports no JAX, so it runs on a
card's machine too: ``python -m pytest --noconftest
tests/test_torch_inpaint_kernel.py``.
"""

import math

import numpy as np
import pytest
import torch

from srmeetsps_cuda_tpu_torch import trace as tracing
from srmeetsps_cuda_tpu_torch.pre import inpaint as ik

# csrc/inpaint.cu's tile and sweeps a pass, for the hole patterns and the
# CPU model; the card tests read K from the kernel's library.
TILE, K = 32, 16
# The LR grids of the benchmark's cells (960 x 1280 and its mixed crops,
# 1088 x 1920 at sf 2; 960 x 1280 at sf 4) and two odd ones.
LR_SHAPES = [(480, 640), (544, 960), (456, 608), (448, 576), (432, 544),
             (240, 320), (97, 131), (1, 7)]
PATTERNS = ["random", "border", "large", "none", "all"]


def holes_of(pattern: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    """A bool hole mask: ``random`` (5% and a 4 x 6 block, as the
    benchmark's frame 0 has), ``border`` (the edge rows and columns and a
    5 x 5 block in each corner), ``large`` (a square wider than a tile and
    the widest halo), ``none`` or ``all``."""
    rng = np.random.default_rng(seed)
    holes = np.zeros((h, w), bool)
    if pattern == "random":
        holes = rng.random((h, w)) < 0.05
        holes[10:14, 20:26] = True
    elif pattern == "border":
        holes[0, :] = holes[-1, :] = True
        holes[:, 0] = holes[:, -1] = True
        for rows in (slice(0, 5), slice(h - 5, h)):
            for cols in (slice(0, 5), slice(w - 5, w)):
                holes[rows, cols] = True
    elif pattern == "large":
        side = TILE + 2 * K + 5
        holes[h // 5:h // 5 + side, w // 5:w // 5 + side] = True
    elif pattern == "all":
        holes[:] = True
    elif pattern != "none":
        raise ValueError(pattern)
    return holes


def start(h: int, w: int, holes: np.ndarray, device="cpu", seed: int = 0):
    """(u0, img, known_b) of ``inpaint_diffusion`` on a seeded depth."""
    rng = np.random.default_rng(seed + 1)
    img = torch.from_numpy(
        (800.0 + 50.0 * rng.random((h, w))).astype(np.float32)).to(device)
    known = 1.0 - torch.from_numpy(holes).to(device).to(torch.float32)
    known_b = known > 0
    return torch.where(known_b, img, ik.pyramid_fill(img, known)), img, known_b


# -- the scheme (CPU) ---------------------------------------------------------


def plan(iters: int, k: int) -> list:
    """The sweeps of each pass: ceil(iters / k) passes, the last of
    ``iters mod k`` where that is not 0."""
    full, rest = divmod(iters, k)
    return [k] * full + ([rest] if rest else [])


def blocked_model(u, known_b, iters, tile, k):
    """``csrc/inpaint.cu``'s scheme in PyTorch: per pass, every tile's
    square (the tile and k pixels a side, a fixed 0 outside the image)
    swept in place, the tile written to the other buffer."""
    h, w = u.shape
    R = tile + 2 * k
    src, dst = u.clone(), u.clone()
    tiles = [(ti, tj) for ti in range(-(-h // tile))
             for tj in range(-(-w // tile))]
    for sweeps in plan(iters, k):
        for ti, tj in tiles:
            i0, j0 = ti * tile - k, tj * tile - k
            si, sj = max(i0, 0), max(j0, 0)
            ei, ej = min(i0 + R, h), min(j0 + R, w)
            sq = torch.zeros(R, R)
            fixed = torch.ones(R, R, dtype=torch.bool)
            sq[si - i0:ei - i0, sj - j0:ej - j0] = src[si:ei, sj:ej]
            fixed[si - i0:ei - i0, sj - j0:ej - j0] = known_b[si:ei, sj:ej]
            for _ in range(sweeps):
                sq = torch.where(fixed, sq, ik._conv3(sq) / 6.0)
            bi, bj = min(tile, h - ti * tile), min(tile, w - tj * tile)
            dst[ti * tile:ti * tile + bi, tj * tile:tj * tile + bj] = \
                sq[k:k + bi, k:k + bj]
        src, dst = dst, src
    return src


@pytest.mark.parametrize("tile,k", [(TILE, K), (8, 3), (5, 1)])
@pytest.mark.parametrize("pattern", ["random", "border", "large", "all"])
@pytest.mark.parametrize("shape", [(70, 100), (33, 31), (1, 7)])
def test_blocked_scheme_is_the_plain_loop(shape, pattern, tile, k):
    holes = holes_of(pattern, *shape)
    u, img, known_b = start(*shape, holes)
    for iters in (0, 1, k - 1, k, k + 1, 3 * k + 2):
        want = ik.relax_plain(u, img, known_b, iters)
        got = blocked_model(u, known_b, iters, tile, k)
        assert torch.equal(got, want), iters


def test_cpu_path_is_the_plain_loop():
    holes = holes_of("random", 40, 70)
    u, img, known_b = start(40, 70, holes)
    got = ik.inpaint_diffusion(img, torch.from_numpy(holes), iters=24)
    assert torch.equal(got, ik.relax_plain(u, img, known_b, 24))


def test_relax_cuda_refuses_cpu_tensors():
    u, _, known_b = start(8, 9, holes_of("random", 8, 9))
    with pytest.raises(ValueError, match="cuda"):
        ik.relax_cuda(u, known_b, 4)


# -- the kernel on the card --------------------------------------------------


def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def kernel_vs_loop(shape, pattern, iters, dev):
    holes = holes_of(pattern, *shape)
    u, img, known_b = start(*shape, holes, dev)
    want = ik.relax_plain(u, img, known_b, iters)
    before = tracing.launch_counts().get("inpaint", 0)
    got = ik.relax_cuda(u.clone(), known_b, iters)
    torch.cuda.synchronize()
    assert tracing.launch_counts().get("inpaint", 0) - before == math.ceil(
        iters / ik.sweeps_per_pass())
    assert torch.equal(got, want), (shape, pattern, iters)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("shape", LR_SHAPES)
def test_cuda_kernel_bit_equal_512_sweeps(shape, pattern):
    kernel_vs_loop(shape, pattern, 512, card())


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [0, 1, K - 1, K, K + 1, 2 * K + 3])
@pytest.mark.parametrize("shape", [(480, 640), (97, 131), (1, 7)])
def test_cuda_kernel_bit_equal_around_k(shape, iters):
    dev = card()
    for pattern in ("random", "large", "border", "all"):
        kernel_vs_loop(shape, pattern, iters, dev)


@pytest.mark.cuda
def test_cuda_kernel_sweeps_per_pass():
    """The library's K is the one the scheme's model and the hole patterns
    (a square wider than a tile and its halo) assume."""
    card()
    assert ik.sweeps_per_pass() == K


@pytest.mark.cuda
def test_cuda_inpaint_counts_passes():
    """The launch registry counts the inpaint kernel's launches as
    ``"inpaint"``, under a profiler and inside the ``.inpaint`` span as
    anywhere."""
    dev = card()
    h, w = 480, 640
    holes = np.zeros((h, w), bool)
    holes[10:14, 20:26] = True
    holes[300:340, 500:600] = True
    img = torch.full((h, w), 900.0, device=dev)
    hole_t = torch.from_numpy(holes).to(dev)
    before = tracing.launch_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("srps.prepare.inpaint"):
            ik.inpaint_diffusion(img, hole_t, iters=512)
    after = tracing.launch_counts()
    assert after.pop("inpaint") - before.pop("inpaint", 0) == math.ceil(
        512 / ik.sweeps_per_pass())
    assert after == before


@pytest.mark.cuda
def test_cuda_kernel_refuses_negative_sweeps():
    dev = card()
    u, _, known_b = start(8, 9, holes_of("random", 8, 9), dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ik.relax_cuda(u, known_b, -1)


@pytest.mark.cuda
def test_cuda_inpaint_close_to_cpu():
    """The card divides by 6 as a product with the float 1/6, the CPU
    truly: the two agree to float32 rounding."""
    dev = card()
    holes = holes_of("random", 97, 131)
    _, img, _ = start(97, 131, holes)
    cpu = ik.inpaint_diffusion(img, torch.from_numpy(holes), iters=64)
    gpu = ik.inpaint_diffusion(img.to(dev), torch.from_numpy(holes).to(dev),
                               iters=64).cpu()
    np.testing.assert_allclose(gpu.numpy(), cpu.numpy(), rtol=1e-5)
