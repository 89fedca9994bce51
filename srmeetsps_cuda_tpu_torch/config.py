"""Solver, runtime and CLI-preference containers.

The defaults are the reference binary's hard-coded constants, the same
values as ``srmeetsps_cuda_tpu.config`` (a test holds the two together):

- outer loop: tolerance 5e-3, at most 10 iterations (SRPS.cu:85-86);
- depth CG: tol 1e-9 on the *squared* residual, cap 100, which admits
  101 iterations (devicecalls.cu:230-231);
- depth data weight lambda = 1 (devicecalls.cu:644);
- preprocessing: inpaint radius 16, bilateral sigma 2/2 (SRPS.cu:133,139).

On a CUDA device the depth CG always runs a hand-written kernel, on the
CPU its plain PyTorch version. ``cg_operator`` stands for the JAX config's
Pallas routing switches (``pallas_vmem_resident``, ``pallas_fused_loop``):
the default is the stencil CG with the energy tracked inside it, the JAX
default path; ``"direct"`` and ``"direct_host_r0"`` run the direct
mask-gated matvec CG of the JAX package's streaming and two-call routes.
VMEM residency itself has no counterpart (the H100 has no residency gate),
and ``use_pallas`` none either (nor the CLI's ``--pallas``/``--no-pallas``).
``image_dtype="bfloat16"`` stores the masked image stack in bf16; every
contraction over it upcasts one pixel chunk at a time and accumulates in
float32, and the lighting ``s`` stays float32, as in the JAX package.
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
    # Jacobi-preconditioned depth CG (stencil_cg with invd = 1 / diag M):
    # scaled at sf <= 2, in-sweep PCG at sf = 4, on every path and variant.
    jacobi_preconditioner: bool = False
    # Storage dtype of the masked image stack, "float32" or "bfloat16":
    # bf16 halves the bytes of the two per-iteration passes over I (the
    # lighting ATb and the s-moments J), which still accumulate in f32.
    image_dtype: str = "float32"
    # "pipe" = standard CG (csrc/stencil_cg.cu); "cgs" = Chronopoulos-Gear
    # CG, one sweep and one reduction per iteration (csrc/cgs_cg.cu).
    cg_variant: str = "pipe"
    # How the depth CG applies M (models/srps.py::depth_cg):
    # "stencil" = the 9-plane stencil CG (csrc/stencil_cg.cu), the JAX
    #   default on grids it holds resident;
    # "direct" = the direct mask-gated matvec CG with r0 built in the kernel
    #   and the energy tracked (csrc/direct_cg.cu), the JAX route under
    #   pallas_vmem_resident=False and on grids too large to hold resident
    #   (bench.py's 4K); with cg_variant="cgs" and no Jacobi the CGS kernel
    #   runs, as in the JAX package;
    # "direct_host_r0" = the same CG given r0 = rhs - M z built by torch ops,
    #   the energy evaluated at the result: pallas_fused_loop=False (and the
    #   single-buffer kernel of cg_pallas_fused).
    cg_operator: str = "stencil"


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
    # Live cv2 windows per outer iteration (SRPS.cu:319-327); without a
    # display or a GUI cv2 the viewer disables itself (io/liveview.py).
    live_view: bool = False
    metrics_jsonl: Optional[str] = None
    resume_from: Optional[str] = None
    # D/Dx/Dy/KT as ii/jj/kk triplet MAT files in dump_dir
    # (io/sparse_dump.py; the reference's sparse golden channel).
    dump_operators: bool = False
    # Check after each phase of every outer iteration that its output is
    # finite, and raise FloatingPointError naming the first phase that is
    # not (one host read per phase).
    nan_check: bool = False
    # Write a torch.profiler trace of the solve into this directory.
    profile_dir: Optional[str] = None
    # The whole outer loop without per-phase host timing: one host read
    # (the stop test) per outer iteration.
    fused_outer_loop: bool = False
    # Multi-object solves: "stream" (lanes through the single solve, one
    # after another), "lockstep" (one lane-batched CG launch per outer
    # iteration) or "auto" (stream on one device).
    batch_mode: str = "auto"


DEFAULT_SOLVER = SolverConfig()
DEFAULT_PREFS = Preferences()
