"""The solver's other paths, its batched solve's switches and the package
surface of the port, against the JAX package.

The window is tests/test_structured.py's (5 s, seed 3, 150 landmarks,
kf_stride 2, start_cam 2, F = 40), f64 on the CPU, perturbed as there
(numpy seed 1 for the structured-against-dense case, 3 for the
Schur-against-full case). On CPU tensors every Cholesky solve is the lane
kernel's plain version. Tolerances: against the JAX package those of
tests/test_torch_solver.py (cost rtol 1e-8, p and q rtol 1e-7 / atol 1e-9:
the port sums in another order than XLA in every iteration, and each LM
accept decision compares costs); the port's own paths against each other
those of tests/test_structured.py. The JAX `structured=False` path compiles
a dense jacfwd, so its solves run 3 iterations.
"""

import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberus_tpu.config import EstimatorConfig as jConfig
from cerberus_tpu.data import SimConfig, simulate
from cerberus_tpu.data.window_builder import build_window_from_sim as jbuild
from cerberus_tpu.ops import lane_cholesky as jlc
from cerberus_tpu.ops import preintegration as jpre
from cerberus_tpu.ops import solver as jsolver
from cerberus_tpu.ops import structured as jstruct
from cerberus_tpu_torch import device as tdevice
from cerberus_tpu_torch.ops import factors as tfac
from cerberus_tpu_torch.ops import lane_cholesky as tlc
from cerberus_tpu_torch.ops import preintegration as tpre
from cerberus_tpu_torch.ops import solver as tsolver
from torch_port_util import assert_close, assert_rel, to_port

ROOT = Path(__file__).resolve().parent.parent
ITERS = 3
# (structured, schur, project_gauge) by name; x: schur has no effect when
# structured is False
OPTIONS = {"TTT": (True, True, True), "TFT": (True, False, True),
           "FxT": (False, True, True), "TTF": (True, True, False),
           "FxF": (False, True, False)}
# numpy seed of the perturbation: test_structured.py's
# test_structured_solver_matches_dense (1) for the dense-J paths, its
# test_schur_full_solve_matches_nonschur (3) for the structured ones
SEED = {"TTT": 3, "TFT": 3, "TTF": 3, "FxT": 1, "FxF": 1}


def _opts(name, module, max_iters):
    s, c, g = OPTIONS[name]
    return module.SolveOptions(max_iters=max_iters, structured=s, schur=c,
                               project_gauge=g)


@pytest.fixture(scope="module")
def window():
    sim = simulate(SimConfig(duration=5.0, speed=0.5, seed=3,
                             n_landmarks=150))
    data, truth, _ = jbuild(sim, jConfig(), kf_stride=2, start_cam=2, F=40)

    def init(seed):
        rng = np.random.default_rng(seed)
        st = truth._replace(
            p=truth.p + jnp.asarray(rng.normal(size=(11, 3)) * 0.03),
            ba=jnp.zeros_like(truth.ba), bg=jnp.zeros_like(truth.bg))
        return st, to_port(st, data)

    return data, {seed: init(seed) for seed in (1, 3)}


def _port_solve(window, name, max_iters):
    _, inits = window
    _, (tst, tdata) = inits[SEED[name]]
    return tsolver.solve_window(tst, tdata,
                                _opts(name, tsolver, max_iters))


@pytest.mark.parametrize("name", ["TFT", "FxT", "TTF", "FxF"])
def test_solve_window_options_match_jax(window, name):
    data, inits = window
    st, _ = inits[SEED[name]]
    opts = _opts(name, jsolver, ITERS)
    jst, jinfo = jax.jit(lambda s, d: jsolver.solve_window(s, d, opts))(
        st, data)
    tlc.LAUNCHES.clear()
    got, info = _port_solve(window, name, ITERS)
    assert not tlc.LAUNCHES       # CPU tensors: the plain version, no kernel
    key = f"solver.solve_window[{name}]"
    assert_close(f"{key}.cost0", info.cost0.numpy(), jinfo.cost0, 1e-8, 0)
    assert_close(f"{key}.cost", info.cost.numpy(), jinfo.cost, 1e-8, 0)
    assert int(info.accepted) == int(jinfo.accepted)
    assert_close(f"{key}.p", got.p.numpy(), jst.p, 1e-7, 1e-9)
    assert_close(f"{key}.q", got.q.numpy(), jst.q, 1e-7, 1e-9)
    assert float(info.cost) < float(info.cost0)


def test_damped_solve_matches_jax(window):
    """The full (222 + F)-dim damped solve on the window's structured H and
    b at the perturbed state, at test_structured.py's three lambdas."""
    data, inits = window
    st, _ = inits[3]
    H, b, _ = jax.jit(jstruct.build_normal_equations)(st, data)
    assert H.shape == (262, 262)
    opts = jsolver.SolveOptions()
    tH, tb = (torch.as_tensor(np.asarray(x))[None] for x in (H, b))
    for lam in (1e-4, 1e-1, 1e2):
        want = jsolver._damped_solve(H, b, jnp.asarray(lam, H.dtype), opts)
        got = tsolver._damped_solve(
            tH, tb, torch.tensor([lam], dtype=torch.float64),
            tsolver.SolveOptions())
        assert np.isfinite(np.asarray(want)).all()
        assert_rel(f"solver._damped_solve[lam={lam:g}]", got[0].numpy(),
                   want, 1e-10)


@pytest.mark.parametrize("name,p_atol,cost_rtol",
                         [("TFT", 1e-8, 1e-9), ("FxT", 1e-6, 1e-6)])
def test_full_solve_matches_schur(window, name, p_atol, cost_rtol):
    """The port's full-system paths against its Schur path, 6 iterations:
    TFT as test_structured.py's test_schur_full_solve_matches_nonschur, FxT
    as its test_structured_solver_matches_dense."""
    got, info = _port_solve(window, name, 6)
    _, inits = window
    _, (tst, tdata) = inits[SEED[name]]
    want, winfo = tsolver.solve_window(tst, tdata,
                                       tsolver.SolveOptions(max_iters=6))
    assert_close(f"solver.solve_window[{name} vs TTT].p", got.p.numpy(),
                 want.p.numpy(), 0, p_atol)
    assert_close(f"solver.solve_window[{name} vs TTT].cost",
                 info.cost.numpy(), winfo.cost.numpy(), cost_rtol, 0)


def _batch(window, B=2):
    _, inits = window
    _, (tst, tdata) = inits[3]
    states = tfac.map_tensors(lambda x: torch.stack([x] * B), tst)
    states = states._replace(
        p=states.p + 0.01 * torch.arange(B, dtype=torch.float64)[:, None,
                                                                   None])
    datas = tfac.map_tensors(lambda x: x.expand((B,) + x.shape), tdata)
    return states, datas


def test_lane_chol_false_matches_default(window):
    """lane_chol=False (the library route) against None (on CPU tensors
    the plain version) over a whole batched solve."""
    states, datas = _batch(window)
    opts = tsolver.SolveOptions(max_iters=ITERS)
    st, info = tsolver.solve_window_batched(states, datas, opts)
    lib_st, lib_info = tsolver.solve_window_batched(states, datas, opts,
                                                    lane_chol=False)
    for name, got, want in (("cost", lib_info.cost, info.cost),
                            ("p", lib_st.p, st.p), ("q", lib_st.q, st.q)):
        assert_rel(f"solver.solve_window_batched[lane_chol=False].{name}",
                   got.numpy(), want.numpy(), 1e-10)
    assert torch.equal(lib_info.accepted, info.accepted)


def test_lane_chol_true_and_full_paths_refused(window):
    """lane_chol=True asks for the kernel, which CPU tensors do not reach;
    the batched solve runs the production options only, as in JAX."""
    states, datas = _batch(window)
    opts = tsolver.SolveOptions(max_iters=1)
    with pytest.raises(ValueError, match="CUDA"):
        tsolver.solve_window_batched(states, datas, opts, lane_chol=True)
    for off in ("structured", "schur", "project_gauge"):
        with pytest.raises(ValueError, match="production"):
            tsolver.solve_window_batched(states, datas,
                                         opts._replace(**{off: False}))


def test_gemm_precision(window):
    """On the CPU "high" computes what "highest" does; any other name
    raises; the TF32 flags come back as they were."""
    states, datas = _batch(window)
    opts = tsolver.SolveOptions(max_iters=2)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    hi = tsolver.solve_window_batched(states, datas, opts)
    high = tsolver.solve_window_batched(states, datas, opts,
                                        gemm_precision="high")
    for a, b in zip(hi[0] + hi[1], high[0] + high[1]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="medium"):
        tsolver.solve_window_batched(states, datas, opts,
                                     gemm_precision="medium")
    with tdevice.matmul_precision("high"):
        assert torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags


@pytest.mark.parametrize("B,n", [(3, 37), (2, 262)])
def test_lane_cholesky_solve_ref_matches_jax(B, n):
    """The library route against the JAX package's, and against the
    kernel's plain version, on SPD systems as test_lane_cholesky.py makes
    them."""
    rng = np.random.default_rng(n)
    J = rng.normal(size=(B, n + 5, n))
    A = np.swapaxes(J, 1, 2) @ J + 0.5 * np.eye(n)
    b = rng.normal(size=(B, n))
    want = np.asarray(jlc.lane_cholesky_solve_ref(jnp.asarray(A),
                                                  jnp.asarray(b)))
    tA, tb = torch.as_tensor(A), torch.as_tensor(b)
    got = tlc.lane_cholesky_solve_ref(tA, tb)
    assert_rel(f"lane_cholesky.lane_cholesky_solve_ref[{B},{n}]",
               got.numpy(), want, 1e-10)
    assert_rel(f"lane_cholesky.lane_cholesky_solve_ref[{B},{n}] vs plain",
               got.numpy(), tlc.lane_cholesky_solve_plain(tA, tb).numpy(),
               1e-10)


def test_quat_mul_assoc_matches_jax():
    rng = np.random.default_rng(0)
    q, p = rng.normal(size=(2, 7, 4))
    want = np.asarray(jpre.quat_mul_assoc(jnp.asarray(q), jnp.asarray(p)))
    got = tpre.quat_mul_assoc(torch.as_tensor(q), torch.as_tensor(p))
    assert_close("preintegration.quat_mul_assoc", got.numpy(), want, 1e-12,
                 1e-15)


def _public_names(init: Path):
    """{name: the JAX module it comes from} of what a JAX __init__.py
    exports: its imported names and its own public definitions, read with
    ast (no JAX import)."""
    pkg = ".".join(init.parent.relative_to(ROOT).parts)
    names = {}
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                names[alias.asname or alias.name] = node.module
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names[node.name] = pkg
        elif isinstance(node, ast.Assign):
            names.update((t.id, pkg) for t in node.targets
                         if isinstance(t, ast.Name))
    return {k: v for k, v in names.items() if not k.startswith("_")}


JAX_INITS = sorted((ROOT / "cerberus_tpu").rglob("__init__.py"))


@pytest.mark.parametrize(
    "init", JAX_INITS,
    ids=[str(p.parent.relative_to(ROOT)) for p in JAX_INITS])
def test_package_exports_match_jax(init):
    """Every name a JAX package __init__ exports is exported by the port's
    counterpart, as the same object as in the port's source module."""
    names = _public_names(init)
    assert names, init
    pkg = ".".join(init.parent.relative_to(ROOT).parts)
    port = importlib.import_module(pkg.replace("cerberus_tpu",
                                               "cerberus_tpu_torch", 1))
    for name, src in names.items():
        assert hasattr(port, name), f"{port.__name__} lacks {name}"
        source = importlib.import_module(src.replace(
            "cerberus_tpu", "cerberus_tpu_torch", 1))
        assert getattr(port, name) is getattr(source, name), name
