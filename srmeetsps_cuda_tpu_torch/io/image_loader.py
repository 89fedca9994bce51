"""Image-folder dataset loader (reference ``ImageDataHandler``,
Utilities.cpp:349-395), the same contract as
``srmeetsps_cuda_tpu/io/image_loader.py``:

  RGB/*.png    n 8-bit colour images (decoded /255, RGB order)
  mask.png     8-bit grayscale, nonzero = masked
  Depth/*.png  n 16-bit depth maps, value = min_z + (png/65535)*(max_z-min_z)
  K.txt        3 CSV rows of the intrinsics K, then one line "sf,min_z,max_z"

Files are sorted lexicographically (``cv::glob`` order). Decoding uses
Pillow, imported at first use.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np


@dataclasses.dataclass
class ProblemData:
    """Loaded problem inputs (host arrays)."""

    I: np.ndarray  # (n, c, h, w) float32 in [0, 1]
    K: np.ndarray  # (3, 3) float32
    mask: np.ndarray  # (h, w) float32, nonzero = masked
    sf: int
    z0: np.ndarray  # (m, h/sf, w/sf) float32, 0 = missing


def _decode_png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def _read_k_file(path: str):
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    K = np.zeros((3, 3), np.float32)
    for i in range(3):
        K[i, :] = [float(v) for v in lines[i].split(",")]
    sf_s, min_z_s, max_z_s = lines[3].split(",")
    return K, int(float(sf_s)), float(min_z_s), float(max_z_s)


def load_image_dataset(folder: str) -> ProblemData:
    rgb_files = sorted(glob.glob(os.path.join(folder, "RGB", "*")))
    if not rgb_files:
        raise FileNotFoundError(f"no RGB images under {folder}/RGB")
    imgs = []
    for f in rgb_files:
        a = _decode_png(f)
        if a.ndim == 2:
            a = np.stack([a] * 3, axis=-1)
        imgs.append(a[..., :3].astype(np.float32) / 255.0)
    I = np.moveaxis(np.stack(imgs), -1, 1)  # (n, c, h, w)

    K, sf, min_z, max_z = _read_k_file(os.path.join(folder, "K.txt"))

    mask_raw = _decode_png(os.path.join(folder, "mask.png"))
    if mask_raw.ndim == 3:
        mask_raw = mask_raw[..., 0]
    mask = mask_raw.astype(np.float32) / 255.0

    depth_files = sorted(glob.glob(os.path.join(folder, "Depth", "*")))
    z0 = np.stack([
        min_z + (_decode_png(f).astype(np.float32) / 65535.0) * (max_z - min_z)
        for f in depth_files])

    h, w = mask.shape
    if z0.shape[1:] != (h // sf, w // sf):
        raise ValueError(
            f"depth shape {z0.shape[1:]} != (h/sf, w/sf) = {(h // sf, w // sf)}")
    return ProblemData(I=I, K=K, mask=mask, sf=sf, z0=z0)
