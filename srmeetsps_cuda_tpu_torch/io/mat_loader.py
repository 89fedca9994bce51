"""MATLAB ``.mat`` dataset reader and writer (reference
``MatFileDataHandler``, Utilities.cpp:159-199), the same contract as
``srmeetsps_cuda_tpu/io/mat_loader.py``.

Variables: ``I`` (h x w x c x n double), ``K`` (3x3), ``mask`` (h x w
uint8), ``sf`` (scalar), ``z0`` (h/sf x w/sf [x m]). MAT v5 needs scipy;
MAT 7.3 (HDF5) imports h5py at first use. MATLAB's column-major dims are
transposed to the row-major ``(n, c, h, w)`` convention.
"""

from __future__ import annotations

import numpy as np

from .image_loader import ProblemData

_VARS = ("I", "K", "mask", "sf", "z0")


def _load_vars_v5(path):
    import scipy.io as sio

    m = sio.loadmat(path)
    return {k: m[k] for k in _VARS}


def _load_vars_v73(path):
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        for k in _VARS:
            a = np.asarray(f[k])
            out[k] = a.transpose(range(a.ndim)[::-1])
    return out


def load_mat_dataset(path: str) -> ProblemData:
    try:
        v = _load_vars_v5(path)
    except (NotImplementedError, ValueError):
        v = _load_vars_v73(path)
    I = np.asarray(v["I"], np.float32)  # (h, w, c, n)
    if I.ndim == 3:
        I = I[..., None]
    I = np.moveaxis(I, (0, 1, 2, 3), (2, 3, 1, 0))
    z0 = np.asarray(v["z0"], np.float32)
    if z0.ndim == 2:
        z0 = z0[..., None]
    return ProblemData(
        I=I,
        K=np.asarray(v["K"], np.float32).reshape(3, 3),
        mask=np.asarray(v["mask"], np.float32),
        sf=int(np.asarray(v["sf"]).ravel()[0]),
        z0=np.moveaxis(z0, -1, 0),
    )


def save_mat_dataset(path: str, data: ProblemData, fmt: str = "mat73"):
    """Write ``data`` as a MATLAB dataset; ``fmt`` is ``mat73`` (HDF5) or
    ``mat5`` (scipy). I, K and z0 are doubles, as the reference reads them
    (Utilities.cpp:124-131)."""
    out = {
        "I": np.moveaxis(np.asarray(data.I, np.float64), (0, 1, 2, 3),
                         (3, 2, 0, 1)),
        "K": np.asarray(data.K, np.float64),
        "mask": (np.asarray(data.mask) != 0).astype(np.uint8),
        "sf": np.float64(data.sf),
        "z0": np.moveaxis(np.asarray(data.z0, np.float64), 0, -1),
    }
    if fmt == "mat5":
        import scipy.io as sio

        sio.savemat(path, out)
        return
    from .writers import save_mat73

    save_mat73(path, out)
