"""The dataset folders that the ``serve`` mix writes: read back by the
port's loader, with Pillow and with the native decoder, they hold the
quantised captures bit for bit; and the client's ``serve`` entry solves
a folder as the port's ``--serve`` loop does."""

import io
import json
import sys

import numpy as np
import pytest
import torch

from bench_torch import data, files, run
from bench_torch.drive import Client
from bench_torch.tests.conftest import small
from srmeetsps_cuda_tpu_torch.io import image_loader, native_loader

CPU = torch.device("cpu")


def folders(pool=2, h=48, w=64, n=4):
    _, conf, mix = small("mitten_sf2.serve", pool=pool)
    caps = data.make_pool(conf["content_seed"], pool, h, w, conf["sf"], n,
                          conf["c"], conf["fx"], conf["fy"], CPU)
    return files.Folders(caps, mix["files"], conf["content_seed"], CPU), caps


@pytest.fixture(params=["pillow", "native"])
def decoder(request, monkeypatch):
    if request.param == "pillow":
        monkeypatch.setattr(native_loader, "load_library", lambda *a: None)
    elif files.build_decoder() != "native":
        pytest.skip("native/libpngio.so does not build here (no libpng)")
    return request.param


def test_folders_read_back_bit_for_bit(decoder):
    f, caps = folders()
    try:
        assert f.files == 2 * (2 * 4 + 1) and f.png_bytes > 0
        for path, want, cap in zip(f.paths, f.captures, caps):
            got = image_loader.load_image_dataset(path)
            for k in ("I", "K", "mask", "z0"):
                a, b = getattr(got, k), getattr(want, k)
                assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
                assert np.array_equal(a, b), k
            assert got.sf == want.sf == cap.sf
            # Quantised, not altered: within half a level and the noise.
            assert np.abs(want.I - cap.I).max() < 6 / 255
            assert np.abs(want.z0 - cap.z0).max() <= 0.5 * 9870 / 65535 + 1e-3
            assert np.array_equal(want.mask, cap.mask)
    finally:
        f.close()


def test_same_seed_same_bytes():
    a, _ = folders(pool=1)
    b, _ = folders(pool=1)
    try:
        for name in ("RGB/00.png", "Depth/03.png", "mask.png", "K.txt"):
            with open(f"{a.paths[0]}/{name}", "rb") as fa, \
                    open(f"{b.paths[0]}/{name}", "rb") as fb:
                assert fa.read() == fb.read(), name
    finally:
        a.close()
        b.close()


def test_serve_entry_solves_as_the_serve_loop(monkeypatch, capsys):
    from srmeetsps_cuda_tpu_torch import cli
    from srmeetsps_cuda_tpu_torch.config import SolverConfig
    from srmeetsps_cuda_tpu_torch.runtime import solver

    _, conf, mix = small("mitten_sf2.serve", pool=1)
    assert run.solver_config(conf) == SolverConfig()  # the CLI's defaults
    pool = data.make_pool(conf["content_seed"], 1, 48, 64, conf["sf"], 4,
                          conf["c"], conf["fx"], conf["fy"], CPU)
    solved = []
    orig = solver.solve

    def solve(*a, **k):
        final, metrics = orig(*a, **k)
        solved.append((int(final.iteration), float(final.energy)))
        return final, metrics
    monkeypatch.setattr(solver, "solve", solve)

    client = Client(mix, pool, run.solver_config(conf), CPU, 5,
                    content_seed=conf["content_seed"])
    mod, orig_prepare = client.probe_prepare()
    try:
        rec = client.run(requests=1)[0]
    finally:
        mod.prepare = orig_prepare
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        client.folders.paths[0] + "\nquit\n"))
    capsys.readouterr()
    assert cli.main(["--serve", "--dstype", "images", "--cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    answer = next(ln for ln in lines if "dsloc" in ln)
    client.folders.close()
    assert solved[0] == solved[1]
    assert rec.iterations == [answer["iterations"]] == [solved[0][0]]
    assert answer["final_energy"] == solved[0][1]
