"""The check catches what it is for: the control (the reference in TF32,
in the program's place) and faults planted under the timed path come out
as not correct, at a size the CPU holds. A sound run at the same size
comes out correct (test_rehearsal.py). Each cell is held to its own
configuration's limits."""

import dataclasses

import numpy as np
import pytest
import torch

from bench_torch import check
from bench_torch.control import control_readings
from bench_torch.tests.conftest import BENCH, run_small, small
from srmeetsps_cuda_tpu_torch.io import image_loader
from srmeetsps_cuda_tpu_torch.models import srps
from srmeetsps_cuda_tpu_torch.parallel import batched


def unchanged(monkeypatch):
    """Each outer iteration returns its state unchanged (but counted)."""
    def step(state, *a, **k):
        return state._replace(iteration=state.iteration + 1,
                              last_energy=state.energy)
    monkeypatch.setattr(srps, "srps_iteration", step)
    monkeypatch.setattr(batched, "_iteration_lockstep",
                        lambda states, *a, **k: step(states))


def half_images(monkeypatch):
    """The s-moments over half of the images, scaled to the whole count
    (the mean taken over the rest)."""
    orig = srps.s_moments

    def s_moments(prob, s):
        n = s.shape[0] // 2
        half = prob._replace(I=prob.I[:, :n].contiguous())
        G, J = orig(half, s[:n])
        return srps.SMoments(2 * G, 2 * J)
    monkeypatch.setattr(srps, "s_moments", s_moments)


def half_lanes(monkeypatch):
    """A lockstep batch solves its first half of lanes and hands their
    answers out twice."""
    orig = batched.solve_batch

    def solve_batch(states, probs, *a, **k):
        h = len(states) // 2
        finals, traces = orig(list(states)[:h], list(probs)[:h], *a, **k)
        return finals * 2, traces * 2
    monkeypatch.setattr(batched, "solve_batch", solve_batch)


def altered(monkeypatch):
    """One masked pixel of each depth solve's answer moved by 0.5 mm."""
    orig = srps.depth_cg

    def depth_cg(z, op, prob, *a, **k):
        z_new, energy, iters = orig(z, op, prob, *a, **k)
        z_new = z_new.clone()
        mask = prob.mask[0] if prob.mask.dim() == 3 else prob.mask
        i, j = (int(t) for t in torch.nonzero(mask)[len(torch.nonzero(mask))
                                                     // 2])
        z_new[..., i, j] += 0.5
        return z_new, energy, iters
    monkeypatch.setattr(srps, "depth_cg", depth_cg)


def stop_early(monkeypatch):
    """The stopping rule's cap off by half: the solve stops after 5 outer
    iterations where the rule runs on."""
    orig = srps.should_stop

    def should_stop(state, cfg):
        return orig(state, cfg) | (torch.as_tensor(state.iteration) >= 5)
    monkeypatch.setattr(srps, "should_stop", should_stop)


def cg_short(monkeypatch):
    """Each depth CG capped at 50 iterations, not the configuration's
    100."""
    orig = srps.depth_cg

    def depth_cg(z, op, prob, sf, cfg, *a, **k):
        return orig(z, op, prob, sf,
                    dataclasses.replace(cfg, cg_max_iter=50), *a, **k)
    monkeypatch.setattr(srps, "depth_cg", depth_cg)


FAULTS = {"unchanged": unchanged, "half_images": half_images,
          "half_lanes": half_lanes, "altered": altered,
          "stop_early": stop_early, "cg_short": cg_short}
# The exact numbers and the faults that read on them: the control moves
# neither (test_control_is_not_correct), these faults do.
EXACT = {"stop_early": "stop", "cg_short": "cg_iters"}
# Every cell, each against its own configuration's limits; a batch-1 mix
# has no lanes to hand out twice.
CELLS = [w["name"] for w in BENCH["workloads"]]
CASES = [(c, f) for c in CELLS for f in FAULTS
         if f != "half_lanes" or small(c)[2]["batch"] > 1]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run_small(cell, seed=11)
    assert res["correct"] is False
    failed = [k for k, (v, lim) in res["checks"].items()
              if lim is not None and not v <= lim]
    print(fault, cell, "fails", failed)
    assert failed
    if fault in EXACT:
        assert EXACT[fault] in failed


def depth_swapped(monkeypatch):
    """Each 16-bit depth frame decoded with its two bytes swapped."""
    orig = image_loader._decode_png

    def decode(path):
        a = orig(path)
        return a.byteswap() if a.dtype == np.uint16 else a
    monkeypatch.setattr(image_loader, "_decode_png", decode)


def images_unscaled(monkeypatch):
    """The images' grey levels taken for intensities: not scaled by
    1/255."""
    orig = image_loader.load_image_dataset

    def load(folder):
        got = orig(folder)
        got.I = got.I * np.float32(255)
        return got
    monkeypatch.setattr(image_loader, "load_image_dataset", load)


DECODER_FAULTS = {"depth_swapped": depth_swapped,
                  "images_unscaled": images_unscaled}
# The cells whose requests are dataset folders read by the port's loader.
FOLDER_CELLS = [c for c in CELLS if small(c)[2]["entry"] == "serve"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in FOLDER_CELLS
                                        for f in DECODER_FAULTS])
def test_decoder_fault_is_not_correct(cell, fault, monkeypatch):
    DECODER_FAULTS[fault](monkeypatch)
    res = run_small(cell, seed=11)
    failed = [k for k, (v, lim) in res["checks"].items()
              if lim is not None and not v <= lim]
    print(fault, cell, "fails", failed)
    assert res["correct"] is False and failed


@pytest.mark.parametrize("cell", ["mitten_sf2.interactive", "hd_sf2.interactive",
                                  "mitten_sf2.mixed4", "mitten_sf2.serve"])
def test_control_is_not_correct(cell):
    c, conf, mix = small(cell, pool=4)
    numbers = control_readings(c, 2 ** 31 + 9, torch.device("cpu"),
                               conf=conf, mix=mix)
    ok, table = check.verdict(numbers, conf["limits"])
    print("control", cell, table)
    assert not ok
