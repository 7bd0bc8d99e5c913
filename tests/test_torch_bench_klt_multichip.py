"""The port's `evals/bench_klt.py` and `evals/multichip_scaling.py` against
the JAX package, on the CPU.

bench_klt: the JAX driver's inputs (:41-51: default_rng(0) texture,
upsampled and blurred twice, its 3 px roll, uniform points) at 160x120 with
N = 20 points and B = 2 streams; the port's inputs against them, then the
per-stream program `one` (:58-62: both pyramids and forward-backward LK,
under vmap) on the same images in both packages: tracked positions within
1e-3 px (f32 in both packages, summed in another order), status equal.

multichip_scaling: the worker's solve (:343-354: production options,
batch axis spread over the mesh) on a 2-entry CPU mesh, B = 4 windows of
the 2 s sequence (keyframes 2 camera frames apart) at F = 32, 3 LM
iterations, f64, against the JAX package's vmapped `solve_window`:
positions within 1e-8 m. The driver's rows carry the JAX worker's keys; a
mesh size that cannot run is a row with "error".
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberus_tpu.data import SimConfig, simulate
from cerberus_tpu.ops import factors as jfac
from cerberus_tpu.ops import klt as jklt
from cerberus_tpu.ops import solver as jsolver
from cerberus_tpu_torch.data.window_builder import build_window_from_sim
from cerberus_tpu_torch.evals import bench_klt, measure, multichip_scaling
from cerberus_tpu_torch.ops.solver import SolveOptions
from cerberus_tpu_torch.parallel.mesh import make_mesh
from test_torch_profile import jax_make_batch, to_jax
from torch_port_util import assert_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N, B = 120, 160, 20, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Thousands of small ops: one intra-op thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_klt_inputs():
    """JAX evals/bench_klt.py:41-51 at H x W, N points, B streams."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, size=(B, H // 4, W // 4)).astype(np.float32)
    img0 = jnp.asarray(np.repeat(np.repeat(base, 4, 1), 4, 2))
    img0 = jax.vmap(lambda im: jklt._sep_blur(jklt._sep_blur(im)))(img0)
    img1 = jnp.roll(img0, 3, axis=2)
    pts = jnp.asarray(rng.uniform([30, 30], [W - 30, H - 30], size=(B, N, 2)),
                      jnp.float32)
    return img0, img1, pts, jnp.ones((B, N), bool)


def test_bench_klt_tracks_as_jax():
    jin = jax_klt_inputs()
    tin = bench_klt.make_inputs(B, torch.device("cpu"), H=H, W=W, N=N)
    for name, got, want in zip(("img0", "img1", "pts", "valid"), tin, jin):
        assert_close(f"bench_klt input {name}", got.numpy(), want, 0, 1e-3)

    def one(i0, i1, p, v):      # :58-62, with the LKResult kept
        res = jklt.lk_track_fb(jklt.build_pyramid(i0, bench_klt.LEVELS),
                               jklt.build_pyramid(i1, bench_klt.LEVELS), p, v)
        return res.pts, res.status

    pts, status = jax.jit(jax.vmap(one))(*jin)
    res = bench_klt.track_batch(*(torch.as_tensor(np.asarray(x))
                                  for x in jin))
    status = np.asarray(status)
    np.testing.assert_array_equal(res.status.numpy(), status)
    assert status.sum() > 0.9 * B * N
    assert_close("bench_klt one pts (tracked)", res.pts.numpy()[status],
                 np.asarray(pts)[status], 0, 1e-3)
    # the timed scalar: the tracked positions' sum and the tracked count
    want = float(np.asarray(pts).sum()) + status.sum()
    got = float(bench_klt.batch_scalar(*(torch.as_tensor(np.asarray(x))
                                         for x in jin)))
    assert_close("bench_klt timed value", got, want, 0, 1e-3 * B * N)


@pytest.fixture(scope="module")
def problem():
    sim = simulate(SimConfig(duration=2.0, speed=0.5, seed=3))
    data, truth, _ = build_window_from_sim(sim, kf_stride=2, start_cam=2,
                                           F=32, device="cpu")
    return data, truth


def test_multichip_mesh_solve_matches_jax(problem):
    data, truth = problem
    jstates, jdatas = jax_make_batch(to_jax(data, jfac.WindowData),
                                     to_jax(truth, jfac.WindowState), 4)
    p = jax.jit(jax.vmap(lambda s, d: jsolver.solve_window(
        s, d, jsolver.SolveOptions(max_iters=3))[0].p))(jstates, jdatas)
    states, datas = measure.make_batch(problem, 4)
    st = multichip_scaling.solve_on_mesh(states, datas,
                                         make_mesh(2, device="cpu"),
                                         SolveOptions(max_iters=3))
    assert_close("multichip_scaling 2-entry mesh p", st.p.numpy(), p, 0,
                 1e-8)


def jax_row_keys():
    """The keys of the row the JAX worker prints (evals/multichip_scaling.py
    :363-365), read from its source."""
    with open(os.path.join(ROOT, "evals", "multichip_scaling.py")) as f:
        tree = ast.parse(f.read())
    worker = next(n.value.value for n in ast.walk(tree)
                  if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "_WORKER")
    worker = worker % {"repo": ROOT}     # as the driver fills it in (:377)
    rows = [n for n in ast.walk(ast.parse(worker)) if isinstance(n, ast.Dict)
            and any(getattr(k, "value", None) == "windows_per_s"
                    for k in n.keys)]
    return {k.value for k in rows[0].keys}


def test_multichip_rows_have_the_jax_keys(problem):
    out = multichip_scaling.main(["--device", "cpu", "--devices", "1,2",
                                  "--batch-per-device", "1", "--reps", "1"],
                                 problem=problem)
    keys = jax_row_keys()
    assert keys == {"n", "batch", "windows_per_s", "latency_ms", "platform"}
    for n, row in zip((1, 2), out["rows"]):
        assert set(row) == keys | {"speedup_vs_1dev"}
        assert row["n"] == n and row["batch"] == n and row["platform"] == "cpu"
        assert np.isfinite(row["windows_per_s"]) and row["latency_ms"] > 0
    assert {"rows", "note", "solver"} <= set(out)
    assert "no scaling" in out["note"]
    assert out["_launches"] == {"1": {"calls": 2, "by_shape": {}},
                                "2": {"calls": 2, "by_shape": {}}}


def test_multichip_size_that_cannot_run_is_an_error_row():
    """One card more than there are (here: none, with --device cuda) runs
    in its own process and fails there; the row says so and holds no
    number."""
    n = torch.cuda.device_count() + 1 if torch.cuda.is_available() else 1
    row, launches = multichip_scaling.run_size(n, n, "cuda", 1)
    assert set(row) == {"n", "error"} and row["n"] == n and launches is None
    assert "CUDA" in row["error"] or "present" in row["error"]
