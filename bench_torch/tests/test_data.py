"""The seeded captures against the port's ``lambertian_dataset``."""

import numpy as np
import pytest
import torch

from bench_torch import data
from srmeetsps_cuda_tpu_torch.config import RuntimeConfig, SolverConfig
from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
from srmeetsps_cuda_tpu_torch.runtime import solver

H, W, SF, N, C = 96, 128, 2, 20, 3


@pytest.fixture(scope="module")
def pool():
    return data.make_pool(2 ** 33 + 7, 2, H, W, SF, N, C, 1216.73, 1216.73,
                          torch.device("cpu"))


def test_shapes_mask_depth_and_hole(pool):
    ref, z_true = lambertian_dataset(H, W, SF, N, C, seed=0)
    for cap in pool:
        assert cap.I.shape == (N, C, H, W) and cap.z0.shape == (N, H // 2,
                                                                W // 2)
        assert cap.I.dtype == cap.z0.dtype == np.float32
        np.testing.assert_array_equal(cap.mask, ref.mask)
        np.testing.assert_allclose(cap.K, ref.K)
        assert (cap.I >= 0).all() and cap.I.max() < 2 * ref.I.max()
        # The surface at about 1 m, +-70 mm and 0.5 mm noise, as the port's generator's.
        z = cap.z0[1:]
        assert 1000 - 73 < z.min() and z.max() < 1000 + 73
        assert abs(z.mean() - z_true.mean()) < 40
        # One hole, in frame 0 alone.
        holes = np.argwhere(cap.z0 == 0)
        assert set(holes[:, 0]) == {0} and len(holes) == 4 * 6
    # The seed's phases make the captures differ.
    assert np.abs(pool[0].z0[1:] - pool[1].z0[1:]).max() > 1.0


def test_same_seed_same_pool(pool):
    again = data.make_pool(2 ** 33 + 7, 1, H, W, SF, N, C, 1216.73, 1216.73,
                           torch.device("cpu"))
    np.testing.assert_array_equal(again[0].I, pool[0].I)
    np.testing.assert_array_equal(again[0].z0, pool[0].z0)


def test_crop_keeps_the_camera_centred(pool):
    c = data.crop(pool[0], 88, 112)
    assert c.mask.shape == (88, 112) and c.z0.shape == (N, 44, 56)
    assert c.K[0, 2] == 112 / 2 - 0.5 and c.K[1, 2] == 88 / 2 - 0.5
    np.testing.assert_array_equal(c.I, pool[0].I[:, :, 4:92, 8:120])
    with pytest.raises(ValueError):
        data.crop(pool[0], 90, 112)  # an offset that is not a multiple of sf


def test_solve_runs_its_real_number_of_outer_iterations(pool):
    # The port's bench inputs (uniform noise) stop after 2 outer
    # iterations; a consistent Lambertian capture runs more.
    counts = []
    for cap in pool:
        final, _ = solver.solve(cap, SolverConfig(),
                                RuntimeConfig(fused_outer_loop=True),
                                device=torch.device("cpu"), verbose=False)
        counts.append(final.iteration)
    print("outer iterations", counts)
    assert min(counts) >= 5
