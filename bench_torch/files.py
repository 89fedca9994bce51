"""Captures as the upstream's dataset folders, written by the benchmark.

The layout that the upstream ``ImageDataHandler`` reads
(Utilities.cpp:349-395), and the port's
``io/image_loader.py::load_image_dataset`` alike:

  RGB/00.png ...    n 8-bit RGB images, h x w
  Depth/00.png ...  n 16-bit grey depth frames, h/sf x w/sf
  mask.png          8-bit grey, 255 on the object
  K.txt             three CSV rows of K, then ``sf,min_z,max_z``

A capture is quantised as a rig's files hold it: each image value is
round(255 I + noise), clipped to 0..255, the noise Gaussian of
``noise_dn`` grey levels drawn on the device from a generator seeded by
the configuration's content seed (an assumed read noise: noiseless
renders would compress far better than camera frames do); each depth
round(z / max_z * 65535) over [0, max_z]. The quantised values, as
float32 the loader's way (I8 / 255, min_z + d16 / 65535 * (max_z -
min_z)), are the captures whose answers are checked: a decoder that
reads a file wrong parts from them.

Pillow writes the PNGs at zlib level 1 (OpenCV ``imwrite``'s default),
one capture a task on as many threads as the host has cores; the noise
is drawn on the main thread, one capture at a time, so the device holds
no more than one capture's images.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import data as bdata

KEYS = {"noise_dn", "max_z_mm"}
ZLIB_LEVEL = 1


def noisy_images(cap: bdata.Capture, gen: torch.Generator, noise_dn: float,
                 device) -> np.ndarray:
    """The capture's images as its RGB files hold them: (n, h, w, 3)
    uint8, round(255 I + noise) clipped to 0..255."""
    noise = torch.randn(cap.I.shape, generator=gen, dtype=torch.float32,
                        device=device)
    noise.mul_(noise_dn).add_(torch.from_numpy(cap.I).to(device), alpha=255.0)
    i8 = noise.round_().clamp_(0, 255).to(torch.uint8)
    return i8.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def write_capture(root: str, cap: bdata.Capture, images: np.ndarray,
                  max_z: float) -> tuple[bdata.Capture, list[int]]:
    """Writes the capture's folder at ``root``; returns the capture it
    holds, in float32 as the loader makes it, and each PNG's bytes."""
    depth = np.clip(np.rint(cap.z0.astype(np.float64) * (65535.0 / max_z)),
                    0, 65535).astype(np.uint16)
    mask = np.where(cap.mask > 0, 255, 0).astype(np.uint8)
    files = {"mask.png": mask}
    for sub, stack in (("RGB", images), ("Depth", depth)):
        os.makedirs(os.path.join(root, sub))
        width = max(2, len(str(len(stack) - 1)))
        files.update({os.path.join(sub, f"{i:0{width}d}.png"): a
                      for i, a in enumerate(stack)})
    sizes = []
    for name, a in files.items():
        path = os.path.join(root, name)
        _save(a, path)
        sizes.append(os.path.getsize(path))
    with open(os.path.join(root, "K.txt"), "w") as f:
        f.write(k_text(cap.K, cap.sf, max_z))
    captured = bdata.Capture(
        I=np.ascontiguousarray(np.moveaxis(images, -1, 1), np.float32)
        / 255.0,
        K=cap.K, mask=mask.astype(np.float32) / 255.0, sf=cap.sf,
        z0=0.0 + (depth.astype(np.float32) / 65535.0) * (max_z - 0.0))
    return captured, sizes


def _save(arr: np.ndarray, path: str):
    from PIL import Image

    Image.fromarray(arr).save(path, compress_level=ZLIB_LEVEL)


def k_text(K: np.ndarray, sf: int, max_z: float) -> str:
    rows = [",".join(repr(float(v)) for v in row) for row in K]
    return "\n".join(rows + [f"{sf},0,{max_z:g}"]) + "\n"


def build_decoder() -> str:
    """The port's PNG decoder: builds ``native/libpngio.so`` (``make -C
    native``) where it is absent; ``"native"`` where the library loads,
    else ``"pillow"`` (where libpng's headers are missing the build fails
    and the loader decodes with Pillow)."""
    from srmeetsps_cuda_tpu_torch.io import native_loader

    lib = native_loader.LIB_PATH
    if not os.path.exists(lib) and os.path.exists(
            os.path.join(os.path.dirname(lib), "Makefile")):
        subprocess.run(["make", "-C", os.path.dirname(lib)],
                       capture_output=True, timeout=300, check=False)
        native_loader.load_library.cache_clear()
    return "pillow" if native_loader.load_library() is None else "native"


class Folders:
    """The captures of a pool as dataset folders in a temporary directory
    (removed with this object, or at exit); ``paths[k]`` is capture k's
    folder, ``captures[k]`` what it holds, ``decoder`` the loader's
    decoder."""

    def __init__(self, pool: list, params: dict, content_seed: int, device):
        if set(params) != KEYS:
            raise ValueError(f"files takes the keys {sorted(KEYS)}")
        t0 = time.perf_counter()
        self.decoder = build_decoder()
        self.build_s = time.perf_counter() - t0
        self._tmp = tempfile.TemporaryDirectory(prefix="bench_torch_serve_")
        max_z = float(params["max_z_mm"])
        gen = torch.Generator(device=device)
        gen.manual_seed((int(content_seed) + 1) % (1 << 63))
        self.paths = [os.path.join(self._tmp.name, f"capture_{k:03d}")
                      for k in range(len(pool))]
        with ThreadPoolExecutor(max_workers=os.cpu_count()) as ex:
            futures = [ex.submit(write_capture, root, cap,
                                 noisy_images(cap, gen, params["noise_dn"],
                                              device), max_z)
                       for root, cap in zip(self.paths, pool)]
            written = [f.result() for f in futures]
        self.captures = [c for c, _ in written]
        self.files = sum(len(sizes) for _, sizes in written)
        self.png_bytes = sum(sum(sizes) for _, sizes in written)
        self.write_s = time.perf_counter() - t0 - self.build_s

    def close(self):
        self._tmp.cleanup()
