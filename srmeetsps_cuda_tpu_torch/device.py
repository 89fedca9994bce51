"""Explicit device selection and float32 precision policy.

The JAX reference runs every contraction that matters at
``Precision.HIGHEST`` (srps.py:61, 247, 256, 326, 343; pre/resize.py:59-65).
PyTorch on a CUDA card keeps float32 matmuls in full precision by default
but runs float32 convolutions through cuDNN in TF32, which keeps about three
decimal digits; :func:`set_precision` turns TF32 off for both.
"""

from __future__ import annotations

import torch


def set_precision() -> None:
    """Full-precision float32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(cpu: bool = False, ordinal: int = 0) -> torch.device:
    """The device a solve runs on, chosen explicitly.

    ``cpu=True`` selects the CPU, where every kernel runs its plain PyTorch
    version. Otherwise CUDA device ``ordinal`` is required: a machine with
    no usable CUDA device raises instead of dropping to the CPU."""
    set_precision()
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --cpu to run the plain "
            "PyTorch versions on the CPU")
    n = torch.cuda.device_count()
    if not 0 <= ordinal < n:
        raise RuntimeError(f"CUDA device {ordinal} requested, {n} present")
    torch.cuda.set_device(ordinal)
    return torch.device("cuda", ordinal)


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
