"""The generator makes the same windows and perturbations from the same
seed, and others from another seed."""

import numpy as np
import pytest
import torch

from vilo_bench import fleet, scene, spec
from vilo_bench.frozen import factors as fac


def windows(cell, seed):
    sims = scene.Simulation(cell.cfg, cell.traffic, seed, workers=0).result()
    return scene.build_windows(cell.cfg, cell.traffic, sims, "cpu")


def leaves(tree):
    out = []
    fac.map_tensors(lambda x: out.append(x), tree)
    return out


def test_same_seed_same_windows_other_seed_others(small):
    cell = spec.load_cell("fleet-f32-dense", small)
    seed = 2 ** 31 + 12345           # seeds beyond 32 signed bits
    a, b, c = windows(cell, seed), windows(cell, seed), windows(cell, seed + 1)
    assert a[2] == b[2]
    for i in (0, 1):
        assert all(torch.equal(x, y)
                   for x, y in zip(leaves(a[i]), leaves(b[i])))
    assert not torch.equal(a[0].f_pts, c[0].f_pts)
    assert a[0].f_pts.shape[:2] == (len(cell.traffic["segments"]), 16)


def test_batches_draw_fresh_reproducible_perturbations(small):
    cell = spec.load_cell("fleet-f64-dense", small)
    _, truths, _ = windows(cell, 5)
    truths = fleet.replicate(truths, 8, truths.p.shape[0])
    p0 = fleet.perturbed(truths, cell.traffic, 5, 0)
    assert torch.equal(p0.p, fleet.perturbed(truths, cell.traffic, 5, 0).p)
    assert not torch.equal(p0.p, fleet.perturbed(truths, cell.traffic, 5, 1).p)
    assert torch.equal(p0.q, truths.q) and not p0.ba.any()
    assert torch.equal(fleet.sample_rows(64, 8, 5, 0),
                       fleet.sample_rows(64, 8, 5, 0))


def test_worker_processes_simulate_the_same_segments(small):
    cell = spec.load_cell("fleet-f32-dim", small)
    seed = 2 ** 31 + 7
    a = scene.Simulation(cell.cfg, cell.traffic, seed, workers=2).result()
    b = scene.Simulation(cell.cfg, cell.traffic, seed, workers=0).result()
    same = lambda u, v: (u is None and v is None) or np.array_equal(u, v)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        assert all(same(x[k], y[k]) for k in x
                   if isinstance(x[k], np.ndarray))
        for fx, fy in zip(x["features"], y["features"], strict=True):
            assert fx.keys() == fy.keys()
            assert all(same(u, v) for k in fx
                       for u, v in zip(fx[k], fy[k], strict=True))


@pytest.mark.parametrize("key", sorted(scene.LAYOUT))
def test_a_window_layout_the_program_lacks_is_refused(small, key):
    cell = spec.load_cell("fleet-f32-dense", small)
    cfg = dict(cell.cfg, **{key: cell.cfg[key] + 1})
    with pytest.raises(ValueError, match=key):
        scene.Simulation(cfg, cell.traffic, 1, workers=0)
