"""Depth linear solvers: generic CG, the stencil CG and the
Chronopoulos-Gear CG kernels."""
