"""The port's LR-depth preprocessing against the JAX package's on the same
seeded inputs. rtol 1e-5: f32 exp and matmul summation order differ."""

import numpy as np
import pytest
import torch

from srmeetsps_cuda_tpu.config import SolverConfig as JConfig
from srmeetsps_cuda_tpu.pre import bilateral as jbil
from srmeetsps_cuda_tpu.pre import inpaint as jinp
from srmeetsps_cuda_tpu.pre import preprocess_depth as jpreprocess
from srmeetsps_cuda_tpu.pre import resize as jres
from srmeetsps_cuda_tpu_torch.config import SolverConfig
from srmeetsps_cuda_tpu_torch.pre import bilateral as tbil
from srmeetsps_cuda_tpu_torch.pre import inpaint as tinp
from srmeetsps_cuda_tpu_torch.pre import preprocess_depth
from srmeetsps_cuda_tpu_torch.pre import resize as tres

TOL = dict(rtol=1e-5, atol=1e-5)
T = torch.from_numpy


def _lr_depth(rng, n=4, h=12, w=17):
    yy, xx = np.mgrid[0:h, 0:w]
    base = (80 + 3 * np.sin(xx / 3.0) + 2 * np.cos(yy / 4.0)).astype(np.float32)
    z0 = np.stack([base + 0.1 * rng.standard_normal((h, w)).astype(np.float32)
                   for _ in range(n)])
    z0[0, 2:5, 3:7] = 0.0
    z0[2, 9, 14] = 0.0
    return z0


def test_conv3_matches_lax_conv(rng):
    x = rng.standard_normal((9, 11)).astype(np.float32)
    np.testing.assert_allclose(tinp._conv3(T(x)).numpy(),
                               np.asarray(jinp._conv3(x)), **TOL)


@pytest.mark.parametrize("shape", [(12, 17), (16, 16)])
def test_inpaint_matches(rng, shape):
    img = rng.random(shape).astype(np.float32) + 1.0
    holes = rng.random(shape) < 0.2
    holes[3:7, 4:9] = True
    got = tinp.inpaint_diffusion(T(img), T(holes), iters=20).numpy()
    want = np.asarray(jinp.inpaint_diffusion(img, holes, iters=20))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[~holes], img[~holes])


def test_bilateral_matches(rng):
    img = rng.random((13, 18)).astype(np.float32)
    np.testing.assert_allclose(tbil.bilateral_filter(T(img)).numpy(),
                               np.asarray(jbil.bilateral_filter(img)), **TOL)


@pytest.mark.parametrize("out", [(24, 34), (48, 68), (12, 17)])
def test_resize_matches(rng, out):
    img = rng.random((12, 17)).astype(np.float32) * 100
    np.testing.assert_allclose(
        tres.resize_bicubic(T(img), *out).numpy(),
        np.asarray(jres.resize_bicubic(img, *out)), rtol=1e-5, atol=1e-4)


def test_preprocess_depth_matches(rng):
    z0 = _lr_depth(rng)
    zs, z_init = preprocess_depth(T(z0), 24, 34, SolverConfig(inpaint_iters=16))
    jzs, jz_init = jpreprocess(z0, 24, 34, JConfig(inpaint_iters=16))
    np.testing.assert_allclose(zs.numpy(), np.asarray(jzs), **TOL)
    np.testing.assert_allclose(z_init.numpy(), np.asarray(jz_init), **TOL)
