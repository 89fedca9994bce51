"""Containers of the JAX package as the port's, and back, through numpy.

:func:`problem_from_numpy` and :func:`state_from_numpy` take an object with
the fields of ``srmeetsps_cuda_tpu``'s ``SRPSProblem``/``SRPSState`` (the
NamedTuples themselves, or a mapping), read each field with ``np.asarray``
and build the port's container on ``device``. Nothing of JAX is imported:
its arrays convert through the numpy array protocol. The TPU-padded
``z0up`` planes are not read; the port builds its unpadded energy planes
from ``masks`` and ``z0s``. :func:`to_numpy` goes the other way.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .models.srps import SRPSProblem, SRPSState
from .ops.gradients import GradientMasks
from .solve.stencil_cg import energy_planes


def _field(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def problem_from_numpy(prob, device) -> SRPSProblem:
    t = lambda k: _tensor(_field(prob, k), device)  # noqa: E731
    mask, masks, z0s = t("mask"), t("masks"), t("z0s")
    sf = mask.shape[0] // masks.shape[0]
    return SRPSProblem(
        I=t("I"), mask=mask, masks=masks, z0s=z0s, xx=t("xx"), yy=t("yy"),
        fx=float(np.asarray(_field(prob, "fx"))),
        fy=float(np.asarray(_field(prob, "fy"))),
        gm=GradientMasks(*(_tensor(m, device) for m in _field(prob, "gm"))),
        SI2=t("SI2"), z0t=t("z0t"), ktw=t("ktw"),
        z0u=energy_planes(masks, z0s, sf))


def state_from_numpy(state, device) -> SRPSState:
    t = lambda k: _tensor(_field(state, k), device)  # noqa: E731
    return SRPSState(
        z=t("z"), rho=t("rho"), s=t("s"), N=t("N"), dz=t("dz"),
        energy=t("energy"), last_energy=t("last_energy"),
        iteration=int(np.asarray(_field(state, "iteration"))),
        cg_iters=_tensor(_field(state, "cg_iters"), device, torch.int32))


def to_numpy(container) -> dict:
    """Field name -> numpy array (``gm`` -> a list of the 4 masks; host
    ints and floats as 0-d arrays)."""
    out = {}
    for name, v in container._asdict().items():
        if isinstance(v, tuple):
            out[name] = [x.detach().cpu().numpy() for x in v]
        elif isinstance(v, torch.Tensor):
            out[name] = v.detach().cpu().numpy()
        else:
            out[name] = np.asarray(v)
    return out
