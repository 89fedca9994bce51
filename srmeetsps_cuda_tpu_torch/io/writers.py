"""Result dumps, checkpoints and visualizations.

Port of ``srmeetsps_cuda_tpu/io/writers.py``. The reference dumps
``s.mat/rho.mat/z.mat/N.mat`` every outer iteration (SRPS.cu:330-333;
Utilities.cpp:46-122: variable ``x``, masked pixels packed in column-major
order) and shows normals and albedo in OpenCV windows (SRPS.cu:319-327).
Here: MAT 7.3 (h5py, imported at first use), MAT v5 (scipy) or npz with
the same packing, and PNG snapshots (Pillow, imported at first use).
Tensors are copied to the host first.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..ops.grid import masked_select_colmajor

_MAT73_CLASS = {
    np.dtype(np.float64): b"double",
    np.dtype(np.float32): b"single",
    np.dtype(np.int32): b"int32",
    np.dtype(np.int64): b"int64",
    np.dtype(np.uint8): b"uint8",
}


def to_host(a) -> np.ndarray:
    """A tensor on any device, or an array-like, as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_mat73(path: str, variables: dict):
    """HDF5-based MAT 7.3 file (the reference's ``MAT_FT_MAT73``): a
    512-byte userblock with the MATLAB header, one transposed dataset per
    variable with a ``MATLAB_class`` attribute."""
    import h5py

    with h5py.File(path, "w", userblock_size=512) as f:
        for name, arr in variables.items():
            a = np.atleast_2d(np.asarray(arr))
            cls = _MAT73_CLASS.get(a.dtype)
            if cls is None:
                raise TypeError(f"unsupported MAT 7.3 dtype: {a.dtype}")
            d = f.create_dataset(name, data=a.T)
            d.attrs.create("MATLAB_class", np.bytes_(cls))
    text = ("MATLAB 7.3 MAT-file, Platform: posix, Created on: "
            + time.strftime("%a %b %d %H:%M:%S %Y")
            + " HDF5 schema 1.00 .").encode()[:116]
    header = text.ljust(116, b" ") + b"\x00" * 8 + b"\x00\x02" + b"IM"
    with open(path, "r+b") as f:
        f.write(header.ljust(512, b"\x00"))


def save_vector_mat(path: str, data: np.ndarray, version: str = "7.3"):
    """One packed vector under the variable name ``x``."""
    x = np.asarray(data).reshape(-1, 1)
    if version == "7.3":
        save_mat73(path, {"x": x})
        return
    import scipy.io as sio

    sio.savemat(path, {"x": x})


def _mat_version(fmt: str) -> str:
    return "5" if fmt == "mat5" else "7.3"


def dump_preprocessing(dirpath: str, zs, z, mask, fmt: str = "mat"):
    """``zs_init.mat`` (the full LR grid, SRPS.cu:143) and ``z_init.mat``
    (the masked HR initial depth, SRPS.cu:250)."""
    os.makedirs(dirpath, exist_ok=True)
    v = _mat_version(fmt)
    save_vector_mat(os.path.join(dirpath, "zs_init.mat"),
                    to_host(zs).T.ravel(), version=v)
    save_vector_mat(os.path.join(dirpath, "z_init.mat"),
                    masked_select_colmajor(to_host(z), to_host(mask)),
                    version=v)


def dump_state(dirpath: str, state, mask, fmt: str = "mat", tag: str = ""):
    """Dump s/rho/z/N with the reference's column-major masked packing.
    ``fmt``: ``mat`` (MAT 7.3), ``mat5`` or ``npz``."""
    os.makedirs(dirpath, exist_ok=True)
    mask = to_host(mask)
    z = masked_select_colmajor(to_host(state.z), mask)
    rho = np.stack([masked_select_colmajor(c, mask) for c in to_host(state.rho)])
    N = np.stack([masked_select_colmajor(k, mask) for k in to_host(state.N)])
    s = to_host(state.s)
    if fmt in ("mat", "mat5"):
        v = _mat_version(fmt)
        # s flattens as (n, c, 4) row-major, the reference's d_s layout.
        save_vector_mat(os.path.join(dirpath, f"s{tag}.mat"), s.reshape(-1),
                        version=v)
        save_vector_mat(os.path.join(dirpath, f"rho{tag}.mat"),
                        rho.reshape(-1), version=v)
        save_vector_mat(os.path.join(dirpath, f"z{tag}.mat"), z, version=v)
        save_vector_mat(os.path.join(dirpath, f"N{tag}.mat"), N.reshape(-1),
                        version=v)
    else:
        np.savez(os.path.join(dirpath, f"state{tag}.npz"), s=s, rho=rho, z=z,
                 N=N)


def save_checkpoint(path: str, state, iteration: int):
    """Full-resolution resumable checkpoint, in the JAX package's format."""
    np.savez(
        path,
        z=to_host(state.z),
        rho=to_host(state.rho),
        s=to_host(state.s),
        N=to_host(state.N),
        dz=to_host(state.dz),
        energy=to_host(state.energy),
        last_energy=to_host(state.last_energy),
        iteration=iteration,
    )


def load_checkpoint(path: str) -> dict:
    """Accepts the checkpoint file or a dump directory holding
    ``checkpoint.npz``."""
    if os.path.isdir(path):
        path = os.path.join(path, "checkpoint.npz")
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def _to_u8(a):
    return np.clip(a * 255.0, 0, 255).astype(np.uint8)


def normals_image(N, mask) -> np.ndarray:
    """0.5 +/- 0.5 encoding, min-max normalised (Utilities.cpp:280-298)."""
    N = to_host(N)
    mask = to_host(mask) != 0
    img = np.zeros(mask.shape + (3,), np.float32)
    img[..., 0] = np.clip(0.5 + 0.5 * N[0], 0, 1)
    img[..., 1] = np.clip(0.5 + 0.5 * N[1], 0, 1)
    img[..., 2] = np.clip(0.5 - 0.5 * N[2], 0, 1)
    img *= mask[..., None]
    lo, hi = img.min(), img.max()
    if hi > lo:
        img = (img - lo) / (hi - lo)
    return _to_u8(img)


def albedo_image(rho, mask) -> np.ndarray:
    """Median + 5 sigma clamp per channel (Utilities.cpp:242-278)."""
    rho = to_host(rho)
    mask = to_host(mask) != 0
    img = np.zeros(mask.shape + (rho.shape[0],), np.float32)
    for c in range(rho.shape[0]):
        vals = rho[c][mask]
        med = np.median(vals)
        std = float(np.sqrt(np.mean(vals ** 2) - np.mean(vals) ** 2))
        img[..., c] = np.clip(np.minimum(rho[c], med + 5 * std), 0, 1) * mask
    return _to_u8(img)


def bone_colormap_lut() -> np.ndarray:
    """256x3 uint8 LUT of the *bone* colormap (cv::COLORMAP_BONE)."""
    x = np.linspace(0.0, 1.0, 256)
    r = np.where(x < 0.75, 7.0 * x / 8.0, (11.0 * x - 3.0) / 8.0)
    g = np.where(x < 0.375, 7.0 * x / 8.0,
                 np.where(x < 0.75, (29.0 * x - 3.0) / 24.0,
                          7.0 * x / 8.0 + 0.125))
    b = np.where(x < 0.375, 29.0 * x / 24.0, 7.0 * x / 8.0 + 0.125)
    return _to_u8(np.stack([r, g, b], axis=-1))


def depth_image(z, mask) -> np.ndarray:
    """Negated, min-max normalised over the mask, bone-colormapped
    (Utilities.cpp:300-320)."""
    z = to_host(z)
    mask = to_host(mask) != 0
    vals = -z[mask]
    lo, hi = vals.min(), vals.max()
    g = np.zeros(mask.shape, np.float32)
    if hi > lo:
        g[mask] = (-z[mask] - lo) / (hi - lo)
    img = bone_colormap_lut()[np.clip(g * 255.0, 0, 255).astype(np.uint8)]
    img[~mask] = 0
    return img


def save_png(path: str, img_u8: np.ndarray):
    from PIL import Image

    Image.fromarray(img_u8).save(path)


def save_visualizations(dirpath: str, state, mask, tag: str = ""):
    os.makedirs(dirpath, exist_ok=True)
    save_png(os.path.join(dirpath, f"normals{tag}.png"),
             normals_image(state.N, mask))
    save_png(os.path.join(dirpath, f"albedo{tag}.png"),
             albedo_image(state.rho, mask))
    save_png(os.path.join(dirpath, f"depth{tag}.png"),
             depth_image(state.z, mask))
