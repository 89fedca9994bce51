"""The port's dense-grid operators against the JAX package's, on the same
seeded inputs. Pure elementwise work and tiny sums: rtol 1e-6 / atol 1e-6."""

import numpy as np
import pytest
import torch

from conftest import random_mask
from srmeetsps_cuda_tpu.ops import gradients as jgrad
from srmeetsps_cuda_tpu.ops import grid as jgrid
from srmeetsps_cuda_tpu.ops import normals as jnorm
from srmeetsps_cuda_tpu_torch.ops import gradients as tgrad
from srmeetsps_cuda_tpu_torch.ops import grid as tgrid
from srmeetsps_cuda_tpu_torch.ops import normals as tnorm

TOL = dict(rtol=1e-6, atol=1e-6)
T = torch.from_numpy


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.fixture(params=[(24, 16, 2), (20, 32, 4), (9, 13, 1)],
                ids=lambda p: f"{p[0]}x{p[1]}sf{p[2]}")
def grid_case(request, rng):
    h, w, sf = request.param
    mask = random_mask(rng, h, w)
    z = rng.standard_normal((h, w)).astype(np.float32) * mask
    return h, w, sf, mask, z


def test_box_downsample_and_adjoint(grid_case, rng):
    h, w, sf, mask, z = grid_case
    _close(tgrid.box_downsample(T(z), sf), jgrid.box_downsample(z, sf))
    u = rng.standard_normal((h // sf, w // sf)).astype(np.float32)
    _close(tgrid.box_upsample_adjoint(T(u), sf),
           jgrid.box_upsample_adjoint(u, sf))


def test_lr_mask_and_masked_resampling(grid_case, rng):
    h, w, sf, mask, z = grid_case
    masks = np.array(jgrid.lr_mask(mask, sf))
    _close(tgrid.lr_mask(T(mask), sf), masks)
    _close(tgrid.resample_masked(T(z), T(masks), sf),
           jgrid.resample_masked(z, masks, sf))
    u = rng.standard_normal(masks.shape).astype(np.float32)
    _close(tgrid.resample_masked_t(T(u), T(mask), T(masks), sf),
           jgrid.resample_masked_t(u, mask, masks, sf))


def test_tilesum_is_box_sum_replicated(grid_case):
    h, w, sf, mask, z = grid_case
    want = np.asarray(jgrid.box_upsample_adjoint(
        jgrid.box_downsample(z, sf), sf)) * sf ** 4
    _close(tgrid.tilesum(T(z), sf), want)


def test_meshgrid_camera():
    xx, yy = tgrid.meshgrid_camera(7, 5, 2.5, 3.25)
    jx, jy = jgrid.meshgrid_camera(7, 5, 2.5, 3.25)
    _close(xx, jx)
    _close(yy, jy)


def test_mean_across_frames_divides_by_n(rng):
    z0 = rng.random((3, 6, 8)).astype(np.float32) + 0.5
    z0[0, 1, 2] = 0.0
    z0[:, 4, 4] = 0.0
    mean, holes = tgrid.mean_across_frames(T(z0))
    jmean, jholes = jgrid.mean_across_frames(z0)
    _close(mean, jmean)
    np.testing.assert_array_equal(holes.numpy(), np.asarray(jholes))
    assert mean[1, 2] == pytest.approx((z0[1, 1, 2] + z0[2, 1, 2]) / 3)


def test_masked_colmajor_select_and_scatter(grid_case):
    h, w, sf, mask, z = grid_case
    packed = tgrid.masked_select_colmajor(z, mask)
    np.testing.assert_array_equal(packed, jgrid.masked_select_colmajor(z, mask))
    np.testing.assert_array_equal(tgrid.masked_scatter_colmajor(packed, mask),
                                  z * (mask != 0))


@pytest.mark.parametrize("di,dj", [(0, 1), (0, -1), (1, 0), (-1, 0), (2, -3)])
def test_shift_reads_zero_outside(di, dj, rng):
    a = rng.standard_normal((5, 7)).astype(np.float32)
    want = np.zeros_like(a)
    for i in range(5):
        for j in range(7):
            if 0 <= i + di < 5 and 0 <= j + dj < 7:
                want[i, j] = a[i + di, j + dj]
    np.testing.assert_array_equal(tgrad.shift(T(a), di, dj).numpy(), want)


def test_gradient_masks(grid_case):
    h, w, sf, mask, z = grid_case
    got = tgrad.GradientMasks.from_mask(T(mask))
    want = jgrad.GradientMasks.from_mask(mask)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


def test_gradients_and_adjoints(grid_case, rng):
    h, w, sf, mask, z = grid_case
    tgm = tgrad.GradientMasks.from_mask(T(mask))
    jgm = jgrad.GradientMasks.from_mask(mask)
    y = rng.standard_normal((h, w)).astype(np.float32)
    for tf, jf, arg in [(tgrad.grad_x, jgrad.grad_x, z),
                        (tgrad.grad_y, jgrad.grad_y, z),
                        (tgrad.grad_x_t, jgrad.grad_x_t, y),
                        (tgrad.grad_y_t, jgrad.grad_y_t, y)]:
        _close(tf(T(arg), tgm), jf(arg, jgm))


@pytest.mark.parametrize("axis", ["x", "y"])
def test_adjoint_identity(grid_case, rng, axis):
    """<D u, v> = <u, D^T v> in float64."""
    h, w, sf, mask, z = grid_case
    gm = tgrad.GradientMasks(*(m.double() for m in
                               tgrad.GradientMasks.from_mask(T(mask))))
    D, Dt = ((tgrad.grad_x, tgrad.grad_x_t) if axis == "x"
             else (tgrad.grad_y, tgrad.grad_y_t))
    u = torch.from_numpy(rng.standard_normal((h, w)))
    v = torch.from_numpy(rng.standard_normal((h, w)))
    lhs = float(torch.sum(D(u, gm) * v))
    rhs = float(torch.sum(u * Dt(v, gm)))
    assert lhs == pytest.approx(rhs, rel=1e-12, abs=1e-12)


def test_normals_from_depth(grid_case, rng):
    h, w, sf, mask, z = grid_case
    z = (z + 50.0) * mask
    tgm = tgrad.GradientMasks.from_mask(T(mask))
    jgm = jgrad.GradientMasks.from_mask(mask)
    xx, yy = np.asarray(jgrid.meshgrid_camera(h, w, w / 2, h / 2))
    tz = T(z)
    N, dz = tnorm.normals_from_depth(
        tz, tgrad.grad_x(tz, tgm), tgrad.grad_y(tz, tgm), T(xx), T(yy),
        T(mask), 500.0, 505.0)
    jN, jdz = jnorm.normals_from_depth(
        z, jgrad.grad_x(z, jgm), jgrad.grad_y(z, jgm), xx, yy, mask,
        500.0, 505.0)
    _close(N, jN)
    _close(dz, jdz)
    np.testing.assert_array_equal(N[3].numpy(), mask)
    assert tnorm.DZ_EPS == jnorm.DZ_EPS
