"""Depth linear solvers: generic CG and the stencil CG kernel."""
