"""Solver, runtime and CLI-preference containers.

The defaults are the reference binary's hard-coded constants, the same
values as ``srmeetsps_cuda_tpu.config`` (a test holds the two together):

- outer loop: tolerance 5e-3, at most 10 iterations (SRPS.cu:85-86);
- depth CG: tol 1e-9 on the *squared* residual, cap 100, which admits
  101 iterations (devicecalls.cu:230-231);
- depth data weight lambda = 1 (devicecalls.cu:644);
- preprocessing: inpaint radius 16, bilateral sigma 2/2 (SRPS.cu:133,139).

The TPU-only switches of the JAX config (Pallas routing, VMEM residency)
have no counterpart: on a CUDA device the depth CG always runs a
hand-written kernel (the stencil CG with the energy tracked inside it, the
JAX default kernel_energy, or the Chronopoulos-Gear CG), on the CPU its
plain PyTorch version. The bf16 image stack is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver constants. Defaults match the reference binary exactly."""

    tolerance: float = 5e-3
    max_iterations: int = 10
    cg_tol: float = 1e-9
    cg_max_iter: int = 100
    lam: float = 1.0
    inpaint_radius: int = 16
    bilateral_sigma_color: float = 2.0
    bilateral_sigma_space: float = 2.0
    # None = 2 * inpaint_radius**2 diffusion sweeps (512 at radius 16).
    inpaint_iters: Optional[int] = None
    # Jacobi-preconditioned depth CG: the plain CPU path only so far.
    jacobi_preconditioner: bool = False
    # "pipe" = standard CG (csrc/stencil_cg.cu); "cgs" = Chronopoulos-Gear
    # CG, one sweep and one reduction per iteration (csrc/cgs_cg.cu).
    cg_variant: str = "pipe"


@dataclasses.dataclass(frozen=True)
class Preferences:
    """CLI preferences of the reference ``Preferences`` struct
    (Utilities.h:224-230): ``block_x``/``block_y`` are the thread-block
    shape of the stencil CG kernels."""

    block_x: int = 256
    block_y: int = 4


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Run-level options of a solve: dumps, metrics, resume, loop mode."""

    dump_iterations: bool = False
    dump_dir: str = "."
    dump_format: str = "mat"  # "mat" (MAT 7.3 HDF5) | "mat5" | "npz"
    save_visualizations: bool = False
    metrics_jsonl: Optional[str] = None
    resume_from: Optional[str] = None
    # The whole outer loop without per-phase host timing: one host read
    # (the stop test) per outer iteration.
    fused_outer_loop: bool = False
    # Multi-object solves: "stream" (lanes through the single solve, one
    # after another), "lockstep" (one lane-batched CG launch per outer
    # iteration) or "auto" (stream on one device).
    batch_mode: str = "auto"


DEFAULT_SOLVER = SolverConfig()
DEFAULT_PREFS = Preferences()
