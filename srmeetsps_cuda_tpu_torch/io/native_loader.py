"""ctypes binding of the native PNG decoder (``native/pngio.cpp``).

The port's own binding of the library the JAX package binds
(``srmeetsps_cuda_tpu/io/native_loader.py``): ``native/libpngio.so``, a
small libpng decoder built by ``make -C native``. :func:`decode_png`
returns None when the library is not built, and the image loader then
decodes with Pillow.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np

LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native", "libpngio.so")


@functools.lru_cache(maxsize=None)
def load_library(path: str = LIB_PATH) -> Optional[ctypes.CDLL]:
    """The library at ``path`` with its signatures declared, or None when
    there is no loadable library there."""
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.pngio_read_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),  # width
        ctypes.POINTER(ctypes.c_int),  # height
        ctypes.POINTER(ctypes.c_int),  # channels
        ctypes.POINTER(ctypes.c_int),  # bit depth
    ]
    lib.pngio_read_info.restype = ctypes.c_int
    lib.pngio_decode.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.pngio_decode.restype = ctypes.c_int
    return lib


def decode_png(path: str, lib_path: str = LIB_PATH) -> Optional[np.ndarray]:
    """The PNG at ``path`` as (h, w) or (h, w, channels) uint8 or uint16,
    decoded by the library at ``lib_path``; None when it is not built."""
    lib = load_library(lib_path)
    if lib is None:
        return None
    w, h, c, bd = (ctypes.c_int() for _ in range(4))
    rc = lib.pngio_read_info(path.encode(), ctypes.byref(w), ctypes.byref(h),
                             ctypes.byref(c), ctypes.byref(bd))
    if rc != 0:
        raise IOError(f"pngio: cannot read {path} (rc={rc})")
    dtype = np.uint16 if bd.value == 16 else np.uint8
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
    out = np.empty(shape, dtype)
    rc = lib.pngio_decode(path.encode(), out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise IOError(f"pngio: decode failed for {path} (rc={rc})")
    return out
