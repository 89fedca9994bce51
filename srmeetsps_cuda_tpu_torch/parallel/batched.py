"""Multi-object solves: B objects of one grid size in one call.

Port of ``srmeetsps_cuda_tpu/parallel/batched.py`` (BASELINE.md
configuration 4). Two execution forms:

* **stream** (:func:`solve_batched_streaming`): each lane runs the
  single-problem fused solve (``srps.solve_fused``) in turn on the same
  stream, so each lane is bit for bit its solo solve.
* **lockstep** (:func:`solve_batched`): all lanes advance one outer
  iteration together, with the depth CG of every lane in **one**
  lane-batched launch per outer iteration (``stencil_cg``, with a stacked
  ``invd`` under Jacobi, or ``cgs_cg`` for the Chronopoulos-Gear
  variant). Lanes that have stopped
  are frozen with ``torch.where`` and the loop runs until every lane has
  stopped; the energy trace has shape (B, max_iterations + 2).

Lighting, s-moments, albedo, the depth operator, the depth energy of the
CGS variant and the normals run lane by lane through the single-problem
functions of ``models/srps.py``, on views of the stacked state. With the
CG kernel's lanes bit for bit equal to its B = 1 launches, this keeps each
lockstep lane bit-identical to its solo solve on the card. Stacked tensors
would merge those ~250 small operations per lane into ~250 per batch; that
is later work.

Stacked containers are the single-problem NamedTuples with a leading lane
axis on every tensor; the host scalars ``fx``, ``fy`` (problem) and
``iteration`` (state) become (B,) tensors.
"""

from __future__ import annotations

import math

import torch

from ..config import SolverConfig
from ..models import srps
from ..ops.gradients import GradientMasks


def _stack(values):
    v = values[0]
    if isinstance(v, GradientMasks):
        return GradientMasks(*(torch.stack(m) for m in zip(*values)))
    if isinstance(v, torch.Tensor):
        return torch.stack(values)
    dtype = torch.int32 if isinstance(v, int) else torch.float32
    return torch.tensor(values, dtype=dtype)


def stack_problems(problems) -> srps.SRPSProblem:
    """Stack equally shaped problems along a new leading lane axis."""
    return srps.SRPSProblem(*(_stack(list(f)) for f in zip(*problems)))


def stack_states(states) -> srps.SRPSState:
    """Stack states along a new leading lane axis."""
    return srps.SRPSState(*(_stack(list(f)) for f in zip(*states)))


def _lane(value, b: int, scalar):
    if isinstance(value, GradientMasks):
        return GradientMasks(*(m[b] for m in value))
    if scalar is not None:
        return scalar(value[b])
    return value[b]


def lane(stacked, b: int):
    """Lane ``b`` of a stacked problem or state, as the single-problem
    container (tensor fields are views)."""
    scalars = {"fx": float, "fy": float, "iteration": int}
    return type(stacked)(*(
        _lane(v, b, scalars.get(k)) for k, v in stacked._asdict().items()))


def unstack(stacked) -> list:
    """All lanes of a stacked problem or state (its first field, ``I`` or
    ``z``, is a tensor with the lane axis)."""
    return [lane(stacked, b) for b in range(stacked[0].shape[0])]


def solve_batched_streaming(states, probs, sf: int, cfg: SolverConfig,
                            block=(256, 4)):
    """Each lane through the single-problem fused solve, one after another
    on the current stream. ``states``/``probs``: per-lane sequences or
    stacked containers. Returns (list of final states, list of energy
    traces), one per lane, each bit for bit its solo solve."""
    if isinstance(states, srps.SRPSState):
        states, probs = unstack(states), unstack(probs)
    results = [srps.solve_fused(st, pb, sf, cfg, block)
               for st, pb in zip(states, probs)]
    return [r[0] for r in results], [r[1] for r in results]


def resolve_batch_mode(mode: str = "auto") -> str:
    """"auto" is stream on one device (or none: the CPU) and lockstep when
    several CUDA devices are visible, as in the JAX package."""
    if mode == "auto":
        return "stream" if torch.cuda.device_count() <= 1 else "lockstep"
    if mode in ("stream", "lockstep"):
        return mode
    raise ValueError(f"unknown batch mode {mode!r}")


def solve_batch(states, probs, sf: int, cfg: SolverConfig, mode: str = "auto",
                block=(256, 4)):
    """Route a batch to its execution form (:func:`resolve_batch_mode`).
    ``states``/``probs``: per-lane sequences or stacked containers.
    Returns (list of final states, list of energy traces), one per lane."""
    if resolve_batch_mode(mode) == "stream":
        return solve_batched_streaming(states, probs, sf, cfg, block)
    if not isinstance(states, srps.SRPSState):
        states, probs = stack_states(list(states)), stack_problems(list(probs))
    final, trace = solve_batched(states, probs, sf, cfg, block)
    return unstack(final), list(trace)


def _iteration_lockstep(states: srps.SRPSState, probs: srps.SRPSProblem,
                        lanes: list, sf: int, cfg: SolverConfig, block):
    """One outer iteration of every lane; the depth CG of all lanes is one
    launch (``srps.depth_cg`` on the stacked operator)."""
    lam = cfg.lam
    ss, moms, rhos, ops = [], [], [], []
    for b, pb in enumerate(lanes):
        s = srps.estimate_lighting(pb, states.rho[b], states.N[b],
                                   states.s[b])
        mom = srps.s_moments(pb, s)
        rho = srps.estimate_albedo(pb, mom, states.N[b], states.rho[b])
        ss.append(s)
        moms.append(mom)
        rhos.append(rho)
        ops.append(srps.build_depth_operator(pb, mom, rho, states.dz[b], lam))
    op = srps.DepthOperator(*(torch.stack(f) for f in zip(*ops)))
    z, energy, iters = srps.depth_cg(states.z, op, probs, sf, cfg, block,
                                     lanes=list(zip(ops, lanes)))
    N, dz = (torch.stack(t) for t in zip(*(
        srps.depth_normals(z[b], pb) for b, pb in enumerate(lanes))))
    return srps.SRPSState(
        z=z, rho=torch.stack(rhos), s=torch.stack(ss), N=N, dz=dz,
        energy=energy, last_energy=states.energy,
        iteration=states.iteration + 1, cg_iters=iters)


def _freeze(stopped: torch.Tensor, old: srps.SRPSState,
            new: srps.SRPSState) -> srps.SRPSState:
    """``new`` where a lane runs on, ``old`` where it has stopped."""
    def pick(o, n):
        keep = stopped.reshape((-1,) + (1,) * (n.dim() - 1))
        return torch.where(keep, o, n)

    return srps.SRPSState(*(pick(o, n) for o, n in zip(old, new)))


def solve_batched(states: srps.SRPSState, probs: srps.SRPSProblem, sf: int,
                  cfg: SolverConfig, block=(256, 4)):
    """Solve the B lanes of stacked ``states``/``probs`` in lockstep.
    Returns (final stacked state, energy trace (B, max_iterations + 2),
    NaN after each lane's last iteration). One host read per outer
    iteration: whether every lane has stopped."""
    B = states.z.shape[0]
    lanes = unstack(probs)
    trace_len = cfg.max_iterations + 2
    dev = states.z.device
    trace = torch.full((B, trace_len), math.nan, dtype=torch.float32,
                       device=dev)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    states = states._replace(iteration=states.iteration.to(dev))
    for it in range(trace_len):
        if bool(stopped.all()):
            break
        merged = _freeze(stopped, states,
                         _iteration_lockstep(states, probs, lanes, sf, cfg,
                                             block))
        trace[:, it] = torch.where(stopped, trace[:, it], merged.energy)
        stopped = stopped | srps.should_stop(merged, cfg)
        states = merged
    return states, trace
