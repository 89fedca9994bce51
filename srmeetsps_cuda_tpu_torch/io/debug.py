"""Ad-hoc dumps of device buffers, the reference's debug-macro surface.

The port's counterpart of ``srmeetsps_cuda_tpu/io/debug.py``. The reference
has console and MAT dump macros for any device buffer
(``PRINT_FROM_DEVICE``/``PRINT_FROM_DEVICE_INT``, Utilities.h:30-52;
``WRITE_MAT_FROM_DEVICE*``, Utilities.h:55-73) and for sparse operators
(``PRINT_SPARSE_CSR``, Utilities.h:90-102, printed 1-based by
``operator<<``, Utilities.cpp:222-240). Here:

* ``print_from_device`` and ``write_mat_from_device`` take a tensor on any
  device, or an array (float or int: the reference's two dtype-specific
  macros are one function);
* ``print_sync`` stands for the JAX package's ``print_in_jit``, which
  prints a traced value from inside a compiled program. The port runs no
  traced program: it waits for the tensor's device and prints from the
  host;
* ``print_sparse`` and ``print_operator`` print the COO triplets that
  ``sparse_dump`` rebuilds in ``operator<<``'s 1-based ``ii/jj/kk`` format.

``pack=mask`` packs the masked pixels in column-major order, the layout of
the reference's device vectors.
"""

from __future__ import annotations

import sys

import numpy as np

from ..ops.grid import masked_select_colmajor
from . import sparse_dump
from .writers import save_vector_mat, to_host


def _fetch(arr, pack=None) -> np.ndarray:
    """Device to host, flat; optionally packed in masked column-major order
    (the reference's vector layout, SRPS.cu:160-168)."""
    a = to_host(arr)
    if pack is not None:
        a = masked_select_colmajor(a, to_host(pack))
    return a.reshape(-1)


def _fmt(v) -> str:
    if np.issubdtype(np.asarray(v).dtype, np.integer):
        return str(int(v))
    return f"{float(v):g}"


def print_from_device(arr, pack=None, stream=None) -> None:
    """``[v0 v1 ... ];`` console dump: PRINT_FROM_DEVICE /
    PRINT_FROM_DEVICE_INT (Utilities.h:30-52), the dtype kept."""
    stream = stream or sys.stdout
    vals = _fetch(arr, pack)
    stream.write("[" + " ".join(_fmt(v) for v in vals) + " ];\n")


def print_sync(arr, name: str = "", stream=None) -> None:
    """The JAX ``print_in_jit``'s ``[ ... ];`` line, optionally prefixed
    ``name = ``, printed from the host once the tensor's device has
    finished the work queued before it (``to_host`` synchronises)."""
    stream = stream or sys.stdout
    if name:
        stream.write(name + " = ")
    print_from_device(arr, stream=stream)


def write_mat_from_device(arr, filename: str, pack=None) -> None:
    """Any tensor as a MAT 7.3 column vector ``x``: WRITE_MAT_FROM_DEVICE /
    _INT (Utilities.h:55-73): float32 as write_MAT_floats
    (Utilities.cpp:46-63), int32 as write_MAT_ints (Utilities.cpp:65-82)."""
    vals = _fetch(arr, pack)
    if np.issubdtype(vals.dtype, np.integer):
        vals = vals.astype(np.int32)
    else:
        vals = vals.astype(np.float32)
    save_vector_mat(filename, vals)


def print_sparse(ii, jj, kk, rows: int, cols: int, stream=None) -> None:
    """1-based ``ii/jj/kk`` triplets, byte for byte the reference's
    ``operator<<(SparseCOO<float>)`` (Utilities.cpp:222-240)."""
    stream = stream or sys.stdout
    stream.write("ii = [" + " ".join(str(int(i) + 1) for i in ii) + "  ];\n")
    stream.write("jj = [" + " ".join(str(int(j) + 1) for j in jj) + "  ];\n")
    stream.write("kk = [" + " ".join(_fmt(v) for v in kk) + "  ];\n")
    stream.write(f"rows = {int(rows)}, cols = {int(cols)}\n")


def print_operator(which: str, prob, sf: int, stream=None) -> None:
    """PRINT_SPARSE_CSR (Utilities.h:90-102) of ``Dx``, ``Dy``, ``D`` or
    ``KT``, rebuilt from the problem's stencil and resample fields and
    printed 1-based."""
    mask = to_host(prob.mask)
    h, w = mask.shape
    which = which.lower()
    if which in ("dx", "dy"):
        dx, dy, npix = sparse_dump.gradient_coo(prob.gm, mask)
        print_sparse(*(dx if which == "dx" else dy), npix, npix,
                     stream=stream)
    elif which == "d":
        print_sparse(*sparse_dump.downsample_coo(h, w, sf), stream=stream)
    elif which == "kt":
        print_sparse(*sparse_dump.kt_coo(mask, prob.masks, sf),
                     stream=stream)
    else:
        raise ValueError(f"unknown operator {which!r} (Dx/Dy/D/KT)")
