"""Explicit device selection, float32 precision policy, and the move of
host arrays to a card.

The JAX reference runs every contraction that matters at
``Precision.HIGHEST`` (srps.py:61, 247, 256, 326, 343; pre/resize.py:59-65).
PyTorch on a CUDA card keeps float32 matmuls in full precision by default
but runs float32 convolutions through cuDNN in TF32, which keeps about three
decimal digits; :func:`set_precision` turns TF32 off for both.

:func:`upload` moves a host array to a CUDA card through a ring of pinned
host slots that the process allocates once per card (:class:`StagingRing`):
a copy from pageable memory is staged by CUDA through one small pinned
buffer, with the host blocked, at a fraction of what the bus carries.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from . import trace as tracing

# The staging ring of a card: STAGE_SLOTS pinned slots of STAGE_CHUNK bytes,
# the fastest of 8-64 MB x 2-3 slots at 324 and 551 MB on an H100 (28 GB/s
# at 551 MB against 5.9 pageable; chip_smoke.py's upload phase).
STAGE_CHUNK = 32 << 20
STAGE_SLOTS = 2

_rings = {}  # CUDA device index -> StagingRing


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
    """Wait for queued work on ``device`` (a no-op on the CPU), counted as
    a host read (``trace.py``)."""
    tracing.count("host_reads")
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StagingRing:
    """Pinned host slots through which host arrays cross to a CUDA card.

    Chunk k of an array waits for the last copy out of slot k mod S (the
    slot's event), is copied into the slot by ATen's intra-op threads and
    leaves it by an asynchronous copy on the destination's current stream,
    so the host fills one slot while the copy out of the one before runs.
    The slots are allocated once and held for the life of the ring."""

    def __init__(self, chunk_bytes: int = STAGE_CHUNK,
                 slots: int = STAGE_SLOTS):
        self.slots = [torch.empty(chunk_bytes // 4, dtype=torch.float32,
                                  pin_memory=True) for _ in range(slots)]
        self.done = [torch.cuda.Event() for _ in range(slots)]
        self.next = 0
        self.lock = threading.Lock()

    def copy(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """Queue the copy of the flat float32 host tensor ``src`` into the
        flat device tensor ``dst`` of its size; returns once the last
        chunk's copy is queued, with every byte of ``src`` read. While a
        profiler records, the host's time in the slots' fills is counted
        as ``h2d_fill_ns``."""
        step = self.slots[0].numel()
        stream = torch.cuda.current_stream(dst.device)
        timed = tracing.live()
        fill_ns = 0
        with self.lock:
            for start in range(0, src.numel(), step):
                k = self.next
                self.next = (k + 1) % len(self.slots)
                stop = min(start + step, src.numel())
                slot = self.slots[k][:stop - start]
                self.done[k].synchronize()
                if timed:
                    t0 = time.perf_counter_ns()
                slot.copy_(src[start:stop])
                if timed:
                    fill_ns += time.perf_counter_ns() - t0
                dst[start:stop].copy_(slot, non_blocking=True)
                self.done[k].record(stream)
        if timed:
            tracing.count("h2d_fill_ns", fill_ns)


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """The C-contiguous float32 host array ``a`` as a tensor on the CUDA
    ``device``, moved through the card's staging ring (made at the card's
    first upload). The copy is ordered on the current stream before any
    later work there, and ``a`` may be overwritten as soon as this
    returns."""
    dst = torch.empty(a.shape, dtype=torch.float32, device=device)
    idx = dst.device.index
    ring = _rings.get(idx) or _rings.setdefault(idx, StagingRing())
    ring.copy(torch.from_numpy(a).reshape(-1), dst.view(-1))
    return dst
