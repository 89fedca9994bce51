"""Small shapes for runs of the harness on the CPU."""

import pytest
import torch

from bench_torch import run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
CROPS = [[96, 128], [92, 120], [88, 112], [84, 104]]


def small(cell_name, pool=4):
    """``(cell, conf, mix)`` of a cell at 96 x 128, its crops shrunk
    alike: n, c, sf, the solver and the limits stay the configuration's."""
    cell = run.find_cell(BENCH, cell_name)
    conf = run.load_json(run.HERE / "configs" / f"{cell['config']}.json")
    conf.update(grid=[96, 128], pool=pool)
    mix = run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    if "crops" in mix:
        mix["crops"] = CROPS
    return cell, conf, mix


def run_small(cell_name, seed=7, seconds=0.5, trace=False, pool=4):
    cell, conf, mix = small(cell_name, pool)
    return run.run_cell(BENCH, cell, seed, seconds, trace,
                        torch.device("cpu"), conf=conf, mix=mix,
                        log=lambda _: None)


@pytest.fixture(autouse=True)
def one_thread():
    # Several test workers share the machine; their OpenMP threads would
    # otherwise contend.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
