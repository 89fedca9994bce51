"""The traffic generator: whole captures through the port's entry points.

A traffic mix (``traffic/<mix>.json``) is data that this one generator
reads. Every mix is a closed loop of one client: the next request goes
out when the last one's results are back (the port's entry points are
synchronous calls in one process). Its keys:

* ``batch``: captures per request: the pool falls into groups of
  ``batch`` consecutive captures, and each pass over the pool serves its
  groups in an order drawn from the seed;
* ``entry``: ``"solve"``, the single solve the CLI and the ``--serve``
  loop run (``runtime.solver.solve`` with the fused outer loop), batch 1;
  ``"serve"``, the calls that ``--serve --dstype images`` makes for a
  request of one location (``cli._loader("images")`` on the capture's
  dataset folder, then that solve), batch 1; or ``"lockstep"``, the
  multi-object path (``runtime.solver.prepare`` per capture, then
  ``parallel.batched.solve_batch(mode="lockstep")``);
* ``crops`` (optional): ``[h, w]`` grids; pool capture k is cropped to
  ``crops[k % len(crops)]`` about its centre, and zero-padded back by
  ``prepare(pad_to=...)`` to its batch's largest grid;
* ``files`` (``"serve"``): the data a rig writes, which ``files.py``
  writes each pool capture as, a dataset folder, in set-up: the images'
  read noise ``noise_dn`` and the depth range's top ``max_z_mm``; the
  answers are checked against what the folders hold.

A capture's latency runs from its host arrays (``"serve"``: its folder's
path) to z, rho, s and N in host memory. The client keeps, for each pool
item, one of its answers in the window, chosen from the seed, and hands
the check a sample of the pool items, drawn from the seed.
"""

from __future__ import annotations

import random
import time
from typing import NamedTuple

import numpy as np

from . import data as bdata
from . import files as bfiles

ENTRIES = ("solve", "serve", "lockstep")


class Record(NamedTuple):
    start: float
    end: float
    iterations: list  # outer iterations of each lane
    items: list  # pool item of each lane


class Client:
    """Runs one mix's requests on a pool of captures."""

    def __init__(self, mix: dict, pool: list, solver_cfg, device, seed: int,
                 *, content_seed: int):
        if set(mix) - {"batch", "entry", "crops", "files"} or \
                mix["entry"] not in ENTRIES or \
                ("files" in mix) != (mix["entry"] == "serve"):
            raise ValueError(f"unsupported traffic {mix}")
        self.batch = int(mix.get("batch", 1))
        self.entry = mix["entry"]
        if (self.entry == "lockstep") == (self.batch == 1):
            raise ValueError("entries 'solve' and 'serve' take batch 1, "
                             "'lockstep' more")
        crops = mix.get("crops")
        if len(pool) % self.batch or (crops and len(pool) % len(crops)):
            raise ValueError("the pool must hold whole batches and rounds "
                             "of crops")
        self.captures = ([bdata.crop(c, *crops[k % len(crops)])
                          for k, c in enumerate(pool)] if crops else pool)
        self.folders = None
        if self.entry == "serve":
            self.folders = bfiles.Folders(self.captures, mix["files"],
                                          content_seed, device)
            self.captures = self.folders.captures
        self.pixels = [int(np.count_nonzero(c.mask)) for c in self.captures]
        self.cfg = solver_cfg
        self.device = device
        self.rng = random.Random(seed)
        self.order: list[int] = []  # the groups left in this pass
        self.zinit = []  # device z_init of each prepare call, in order
        self.kept: dict[int, dict] = {}
        self.seen: dict[int, int] = {}
        self.tracer = None

    # -- the program's entry points ------------------------------------------

    def probe_prepare(self):
        """A wrapper of ``runtime.solver.prepare`` that keeps each call's
        initial depth (state.z) on the device; returns (module, original)
        to restore."""
        from srmeetsps_cuda_tpu_torch.runtime import solver

        orig = solver.prepare

        def prepare(*args, **kw):
            out = orig(*args, **kw)
            self.zinit.append(out[1].z)
            return out
        solver.prepare = prepare
        return solver, orig

    def group(self, item: int) -> list:
        """The pool items of ``item``'s request."""
        g = item // self.batch
        return list(range(g * self.batch, (g + 1) * self.batch))

    def pad_to(self, items):
        shapes = [self.captures[i].mask.shape for i in items]
        if len(set(shapes)) == 1:
            return None
        return (max(s[0] for s in shapes), max(s[1] for s in shapes))

    def request(self) -> Record:
        """One request: the next ``batch`` captures, solved, back on the
        host."""
        from srmeetsps_cuda_tpu_torch.config import RuntimeConfig
        from srmeetsps_cuda_tpu_torch.parallel import batched
        from srmeetsps_cuda_tpu_torch.runtime import solver

        if not self.order:
            self.order = list(range(len(self.captures) // self.batch))
            self.rng.shuffle(self.order)
        items = self.group(self.order.pop() * self.batch)
        if self.tracer is not None:
            self.tracer.lanes = self.batch
            self.tracer.pixels = [self.pixels[i] for i in items]
        self.zinit.clear()
        t0 = time.perf_counter()
        if self.entry != "lockstep":
            cap = (self.load(items[0]) if self.entry == "serve"
                   else self.captures[items[0]])
            final, metrics = solver.solve(
                cap, self.cfg,
                RuntimeConfig(fused_outer_loop=True), device=self.device,
                verbose=False)
            lanes = [_host(final)]
            t1 = time.perf_counter()
            recs = [m for m in metrics if "energy" in m]
            lanes[0].update(energies=[m["energy"] for m in recs],
                            cg=[m["cg_iterations"] for m in recs])
            iters = [final.iteration]
        else:
            pad = self.pad_to(items)
            pairs = [solver.prepare(self.captures[i], self.cfg, self.device,
                                    pad_to=pad) for i in items]
            finals, traces = batched.solve_batch(
                [s for _, s in pairs], [p for p, _ in pairs],
                int(self.captures[items[0]].sf), self.cfg, mode="lockstep")
            lanes = [_host(f) for f in finals]
            t1 = time.perf_counter()
            iters = [int(f.iteration) for f in finals]
            for lane, f, tr in zip(lanes, finals, traces):
                tr = tr.cpu().numpy()
                lane.update(energies=[float(e) for e in tr[np.isfinite(tr)]],
                            cg=[int(f.cg_iters)])
        for b, (i, lane) in enumerate(zip(items, lanes)):
            lane.update(iterations=iters[b], pad_to=self.pad_to(items),
                        z_init_dev=self.zinit[b])
            self.keep(i, lane)
        self.zinit.clear()
        return Record(t0, t1, iters, items)

    def load(self, item: int):
        """The port's loader on ``item``'s folder, as ``--serve --dstype
        images`` calls it."""
        from srmeetsps_cuda_tpu_torch import cli

        return cli._loader("images")(self.folders.paths[item])

    def keep(self, item: int, answer: dict):
        """Reservoir choice, from the seed, of one answer per pool item."""
        k = self.seen.get(item, 0) + 1
        self.seen[item] = k
        if self.rng.randrange(k) == 0:
            self.kept[item] = answer

    def run(self, seconds: float = None, requests: int = None) -> list:
        """Requests in a closed loop until ``seconds`` have passed (each
        request starts inside the window and runs to its end), or
        ``requests`` of them."""
        out = []
        t0 = time.perf_counter()
        while True:
            if requests is not None and len(out) >= requests:
                break
            if seconds is not None and out and \
                    time.perf_counter() - t0 >= seconds:
                break
            out.append(self.request())
        return out

    def answers(self, count: int) -> list:
        """``count`` of the kept answers, their pool items drawn from the
        seed, their initial depth moved to the host."""
        out = []
        items = sorted(self.kept)
        for item in sorted(self.rng.sample(items, min(count, len(items)))):
            a = dict(self.kept[item])
            z = a.pop("z_init_dev")
            a["z_init"] = z.cpu().numpy()
            a["item"] = item
            out.append(a)
        self.kept.clear()
        return out


def _host(state) -> dict:
    """z, rho, s and N of a final state, in host memory."""
    return {k: getattr(state, k).cpu().numpy() for k in ("z", "rho", "s", "N")}
