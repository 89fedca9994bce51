"""srmeetsps_cuda_tpu_torch — the PyTorch + CUDA port of srmeetsps_cuda_tpu.

Depth super-resolution meets uncalibrated photometric stereo: joint
estimation of high-resolution depth, per-channel albedo and per-image
first-order spherical-harmonic lighting from multi-illumination images
plus a low-resolution depth map, by alternating masked least squares.

The JAX package ``srmeetsps_cuda_tpu`` is the reference this port is held
against; it is never imported here. The layout mirrors it module by
module (``ops/``, ``pre/``, ``solve/``, ``models/``, ``runtime/``, ``io/``,
``cli.py``, ``parallel/``). Plain tensor code is PyTorch; the depth CGs,
which the JAX package runs as Pallas TPU kernels, are hand-written CUDA
kernels (``csrc/stencil_cg.cu`` and ``csrc/cgs_cg.cu``, wrapped by
``solve/stencil_cg.py`` and ``solve/cgs_cg.py``).
"""

__version__ = "0.1.0"

from .config import Preferences, RuntimeConfig, SolverConfig  # noqa: F401
