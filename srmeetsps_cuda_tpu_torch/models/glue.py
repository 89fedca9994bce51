"""How the outer iteration's glue runs, decided here alone.

The glue is all of an outer iteration but the depth CG's launch: on the
card some 500 small kernels a lane, each a host launch, around 2.3 ms of
device work at 960 x 1280. Its shapes are fixed for a whole solve, and it
reads nothing back to the host, so where the graphs engage
(:func:`engages`) a solve captures it once and replays it:

* the first outer iteration runs eagerly (``"eager"``): it sets up
  cuBLAS and the caching allocator outside any capture, and its results
  become the solve's state buffers;
* the second (``"capture"``) records each half of the glue into a graph
  and replays it: graph A, lighting, s-moments, albedo and the depth
  operator, which ends by writing s and rho into the state's buffers;
  graph B, the normals, which ends by writing N and dz into them. The CG
  runs between them as the eager call it always is (its cooperative
  launch is not captured), and its depth is copied into the buffer of z;
* every later one (``"replay"``) launches the two graphs.

Elsewhere a solve's :class:`Glue` stays ``"eager"``. Its callers run each
half and the CG's depth through it alike in every mode; it alone writes
the state back (a lockstep batch's stopped lanes kept). The graphs hold
the eager path's kernels in its order: a solve's results are the eager
solve's, bit for bit. The state handed on from an iteration is made of
the buffers, which the next iteration overwrites: a caller that keeps an
iterate keeps a copy (``srps.snapshot``).

The graphs of every solve share one memory pool for the process, so that
after the first capture a capture finds its memory in the pool. A lockstep
batch (``parallel/batched.py``) and ``srps.solve_fused`` called directly
free their graphs (:meth:`Glue.close`) when the solve ends.

The single solve (``runtime/solver.py::solve``) keeps them instead: a card
holds one :class:`Kept`, the graphs that a single solve captured with the
problem and state tensors they read, under a key of everything a capture
bakes in beyond those tensors (``srps.capture_key``: the grid, sf, the
image dtype and the Python scalars the glue reads). The next solve of
that key builds its problem into the kept problem's tensors
(``srps.build_problem(..., into=)``), copies its initial state into the
kept state's (:meth:`Kept.load`) and replays from its first outer
iteration. So between solves the card holds the problem, the state, graph
A's outputs (the depth operator) and the graphs' pool. A solve of another
key frees the kept one (:func:`kept`) before it prepares and captures its
own; a solve that fails frees it too (:func:`drop`). A caller keeps a copy
of the final state (``srps.snapshot``): the next solve overwrites the kept
one.
"""

from __future__ import annotations

import contextlib

import torch

from .. import trace as tracing

_pools = {}  # device index -> (pool handle, the graph that holds it, ...)
_streams = {}  # device index -> the capture stream
_kept = {}  # device -> the Kept single solve of that device


def engages(device: torch.device, check) -> bool:
    """Whether a solve's glue runs from graphs: on a CUDA device, and
    without a per-phase ``check`` (a host read after each phase)."""
    return device.type == "cuda" and check is None


def for_solve(device: torch.device, check=None):
    """The :class:`Glue` of a solve on ``device``: eager throughout where
    the graphs do not engage (:func:`engages`)."""
    return Glue(device, engages(device, check))


def write_into(state, fields, values, stopped=None):
    """Write the first ``len(fields)`` of ``values`` into ``state``'s
    tensors of those names (of a lockstep batch, but for the lanes that
    have ``stopped``); returns the rest of ``values``."""
    for name, v in zip(fields, values):
        old = getattr(state, name)
        if stopped is None:
            old.copy_(v)
        else:
            keep = stopped.reshape((-1,) + (1,) * (v.dim() - 1))
            torch.where(keep, old, v, out=old)
    return values[len(fields):]


def _pool(device: torch.device):
    """The process's graph memory pool on ``device``. A pool lives while a
    graph captured into it does (in the caching allocators of both device
    and pinned host memory): once the last is freed, a capture into the
    pool fails. So the pool is made with a graph of one kernel that the
    process keeps and never replays."""
    idx = _index(device)
    got = _pools.get(idx)
    if got is None:
        pool = torch.cuda.graph_pool_handle()
        keep = torch.cuda.CUDAGraph()
        cell = torch.zeros(1, device=device)
        with torch.cuda.stream(_stream(device)):
            keep.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                cell.add_(1.0)
            finally:
                keep.capture_end()
        got = _pools[idx] = (pool, keep, cell)
    return got[0]


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _stream(device: torch.device) -> torch.cuda.Stream:
    idx = _index(device)
    stream = _streams.get(idx)
    if stream is None:
        stream = _streams[idx] = torch.cuda.Stream(idx)
    return stream


class Glue:
    """The glue of one solve: :attr:`mode` is what the next outer
    iteration does, always ``"eager"`` unless ``engaged``."""

    def __init__(self, device: torch.device, engaged: bool = True):
        self.device = device
        self.engaged = engaged
        self.warm = False
        self.graphs = {}  # name -> (CUDAGraph, what the capture returned)

    @property
    def mode(self) -> str:
        if not self.warm:
            return "eager"
        return "replay" if len(self.graphs) == 2 else "capture"

    @contextlib.contextmanager
    def iteration(self, **attrs):
        """The span ``srps.iteration`` of one outer iteration (``attrs``,
        and the mode as ``glue``); counts in ``glue_replays`` the lanes
        (``attrs["lanes"]``, else 1) it replays. Its end moves the mode."""
        mode = self.mode
        with tracing.span("srps.iteration", **attrs, glue=mode):
            tracing.count("glue_replays",
                          attrs.get("lanes", 1) if mode == "replay" else 0)
            yield
        self.warm = self.engaged

    def run(self, name: str, state, fields, fn, stopped=None) -> tuple:
        """Half ``name`` of the glue, ``fn()``: its values, the new state's
        ``fields`` first. From the graph ``name``, which ends by writing
        them into ``state``'s (:func:`write_into`), ``state``'s tensors."""
        if self.mode == "eager":
            return fn()
        rest = self.replay(name, lambda: write_into(state, fields, fn(),
                                                    stopped))
        return tuple(getattr(state, f) for f in fields) + tuple(rest)

    def depth(self, state, z, stopped=None):
        """The CG's depth ``z``, from the graphs on written into
        ``state.z`` (:func:`write_into`), which graph B reads."""
        if self.mode == "eager":
            return z
        write_into(state, ("z",), (z,), stopped)
        return state.z

    def replay(self, name: str, fn):
        """Replay the graph ``name``, capturing ``fn`` into it first if it
        has none; returns what ``fn`` returned at the capture (tensors the
        replays write)."""
        got = self.graphs.get(name)
        with torch.cuda.device(self.device):
            if got is None:
                got = self.graphs[name] = self._capture(fn)
            got[0].replay()
        return got[1]

    def _capture(self, fn):
        graph = torch.cuda.CUDAGraph()
        pool = _pool(self.device)
        main = torch.cuda.current_stream(self.device)
        side = _stream(self.device)
        side.wait_stream(main)
        # cuBLAS holds a workspace (32 MiB on an H100) for each stream it
        # has run on; the capture's would be held beside the caller's.
        # Dropping the held ones before the capture lets it make its own
        # in the pool, and after it leaves that one to the graph alone, so
        # that the device holds one workspace at a time, as the eager glue
        # does. The graphs of a solve run one after another on one stream.
        torch._C._cuda_clearCublasWorkspaces()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                graph.capture_end()
        torch._C._cuda_clearCublasWorkspaces()
        main.wait_stream(side)
        return graph, out

    def close(self) -> None:
        """Free the graphs and their outputs (their memory stays in the
        pool for the next solve's capture)."""
        self.graphs.clear()


class Kept:
    """A card's single solve kept across solves of one ``key``: its
    :class:`Glue` (:attr:`glue`), and the problem and the final state of
    its last solve (:attr:`prob`, :attr:`state`; None before a solve of the
    key has ended), whose tensors the graphs read."""

    def __init__(self, device: torch.device, key):
        self.key = key
        self.glue = Glue(device)
        self.prob = None
        self.state = None

    def load(self, state):
        """``state`` in the kept state's tensors: its z, rho, s, N and dz
        copied into them, the rest of it as it is. ``state`` keeps its own
        tensors. Before the key's first solve has ended, ``state``."""
        if self.state is None:
            return state
        return state._replace(**{
            f: getattr(self.state, f).copy_(getattr(state, f))
            for f in ("z", "rho", "s", "N", "dz")})


def _slot(device: torch.device):
    return ("cuda", _index(device)) if device.type == "cuda" else str(device)


def kept(device: torch.device, key) -> Kept:
    """The :class:`Kept` solve of ``key`` on ``device``: the one the device
    holds if it has that key, else a new one that replaces it, the old
    one's graphs and tensors freed first."""
    got = _kept.get(_slot(device))
    if got is None or got.key != key:
        drop(device)
        got = _kept[_slot(device)] = Kept(device, key)
    return got


def drop(device: torch.device) -> None:
    """Free the kept solve of ``device``, if it holds one."""
    got = _kept.pop(_slot(device), None)
    if got is not None:
        got.glue.close()
