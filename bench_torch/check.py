"""The comparison that decides ``correct``.

For each capture that the check samples, the program's answer (its z_init,
final z, rho, s and N, energy trace and CG iterations) is held against
the plain reference (``reference.py``) run on the same host arrays for as
many outer iterations as the program ran. The stopping rule is held by
applying the reference's rule to the program's own energy trace: it has to
stop where the program stopped. Each number is the worst over the sampled
captures (every lane of a batch) and has its limit in the configuration's
file; a number a configuration gives no limit is printed and not held
(``PERF.md`` says why for each).
"""

from __future__ import annotations

import numpy as np

from .reference import stop_count

# Name -> what it measures (each the worst over the sampled captures).
NUMBERS = {
    "zinit_mm": "max |z_init - ref| on the mask, mm (preprocessing)",
    "z_mm": "max |z - ref| on the mask after the last iteration, mm (depth CG)",
    "z_rms_mm": "root mean square of z - ref on the mask, mm (depth CG)",
    "rho": "max |rho - ref| on the mask (albedo)",
    "s": "max |s - ref| over max |ref s| (lighting)",
    "N": "max |N - ref| of the unit normal's components on the mask (normals)",
    "energy": "max over iterations of |E - ref E| over ref E of iteration 1",
    "stop": "captures whose iteration count is not where the rule stops on "
            "their own energy trace",
    "cg_iters": "max |CG iterations - ref| over the outer iterations",
}


def compare(prog: dict, ref: dict, cfg: dict) -> dict:
    """The numbers of one capture. ``prog`` has the keys of
    ``Reference.solve``'s result (``cg`` may hold the last outer
    iteration's count alone)."""
    m = ref["mask"] > 0
    gap = lambda a, b: float(np.max(np.abs(np.asarray(a, np.float64)  # noqa: E731
                                           - np.asarray(b, np.float64))))
    on = lambda a: np.asarray(a)[..., m]  # noqa: E731
    e_p = np.asarray(prog["energies"], np.float64)
    e_r = np.asarray(ref["energies"], np.float64)
    n = min(len(e_p), len(e_r))
    cg_p, cg_r = list(prog["cg"]), list(ref["cg"])
    cg_r = cg_r[-len(cg_p):]
    return {
        "zinit_mm": gap(on(prog["z_init"]), on(ref["z_init"])),
        "z_mm": gap(on(prog["z"]), on(ref["z"])),
        "z_rms_mm": float(np.sqrt(np.mean(np.square(
            on(prog["z"]).astype(np.float64) - on(ref["z"]))))),
        "rho": gap(on(prog["rho"]), on(ref["rho"])),
        "s": gap(prog["s"], ref["s"]) / float(np.max(np.abs(ref["s"]))),
        "N": gap(on(np.asarray(prog["N"])[:3]), on(np.asarray(ref["N"])[:3])),
        "energy": (float(np.max(np.abs(e_p[:n] - e_r[:n])) / abs(e_r[0]))
                   if len(e_p) == len(e_r) else float("inf")),
        "stop": float(stop_count(list(e_p), cfg) != len(e_p)),
        "cg_iters": float(max(abs(a - b) for a, b in zip(cg_p, cg_r))),
    }


def worst(readings: list[dict]) -> dict:
    """Each number's worst over the captures; ``stop`` is their count."""
    out = {}
    for k in NUMBERS:
        vals = [r[k] for r in readings]
        out[k] = float(sum(vals)) if k == "stop" else float(max(vals))
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: [number, limit]})``: every number that the
    configuration gives a limit is held to it (a NaN fails); the others
    are printed beside None. A configuration with no limit is never
    correct."""
    table = {k: [numbers[k], limits.get(k)] for k in NUMBERS}
    held = [(v, lim) for v, lim in table.values() if lim is not None]
    ok = bool(held) and all(v <= lim for v, lim in held)
    return ok, table
