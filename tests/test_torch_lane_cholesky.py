"""The port's lane-Cholesky solve: its plain version against the JAX
package's Pallas kernel (interpret mode, as tests/test_lane_cholesky.py runs
it on the CPU) and against its XLA reference.

SPD inputs as tests/test_lane_cholesky.py makes them (J^T J + 0.5 I from a
numpy seed). Tolerances, as max |x - x_ref| / max |x_ref|: 1e-10 in f64 (two
Cholesky solves of a matrix with condition ~1e3 differ by roundoff only),
2e-3 in f32 (test_lane_cholesky.py's bound for the TPU kernel at f32).
The kernel's own tests need the card and live in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberus_tpu.ops.lane_cholesky import (LANES, lane_cholesky_solve as
                                            j_lane_solve,
                                            lane_cholesky_solve_ref)
from cerberus_tpu_torch.ops import lane_cholesky as tlc


def _spd(seed, B, n, dtype):
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(B, n + 5, n)).astype(dtype)
    A = np.einsum("bij,bik->bjk", J, J) + 0.5 * np.eye(n, dtype=dtype)
    b = rng.normal(size=(B, n)).astype(dtype)
    return A, b


def _rel_err(x, want):
    x, want = np.asarray(x, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(x - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-10), ("float32", 2e-3)])
@pytest.mark.parametrize("n", [16, 37, 222])
def test_plain_matches_jax_kernel_and_ref(n, dtype, tol):
    A, b = _spd(n, LANES, n, dtype)
    x = tlc.lane_cholesky_solve_plain(torch.as_tensor(A), torch.as_tensor(b))
    assert x.dtype == torch.float32 if dtype == "float32" else torch.float64
    want_kernel = j_lane_solve(jnp.asarray(A), jnp.asarray(b), interpret=True)
    want_ref = lane_cholesky_solve_ref(jnp.asarray(A), jnp.asarray(b))
    for label, want in (("pallas_interpret", want_kernel), ("ref", want_ref)):
        err = _rel_err(x.numpy(), want)
        print(f"PORT_DIFF lane_cholesky.plain_vs_{label}[{dtype},n={n}] "
              f"max_rel={err:.3e}")
        assert err < tol


def test_cholesky_plain_factor():
    A, _ = _spd(1, 3, 29, "float64")
    L = tlc.cholesky_plain(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=1e-12,
                               atol=1e-12)
    assert np.all(np.triu(L, 1) == 0)
    bad = A.copy()
    bad[0, 5, 5] = -1.0                   # not SPD: NaN, as LAPACK gives
    assert np.isnan(tlc.cholesky_plain(torch.as_tensor(bad)).numpy()[0]).any()


def test_wrapper_on_cpu_runs_plain_version():
    A, b = _spd(2, 5, 24, "float64")          # any B: no lane multiple
    before = tlc.LAUNCHES
    x = tlc.lane_cholesky_solve(torch.as_tensor(A), torch.as_tensor(b))
    assert tlc.LAUNCHES == before
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b[..., None])[..., 0],
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shapes", [((2, 4, 5), (2, 4)), ((2, 4, 4), (2, 5)),
                                    ((4, 4), (4,)), ((2, 4, 4), (3, 4))])
def test_wrapper_rejects_bad_shapes(shapes):
    a_shape, b_shape = shapes
    with pytest.raises(ValueError):
        tlc.lane_cholesky_solve(torch.zeros(a_shape), torch.zeros(b_shape))


def test_smem_limit_bounds_n():
    """The largest n whose tiles stay resident in a block's shared memory:
    320 in f32 (10 x 11 / 2 tiles of 32 x 32), 224 in f64 (14 x 15 / 2 tiles
    of 16 x 16); above it the tiles are streamed, with less shared memory."""
    assert tlc.smem_bytes(222) == 116_480
    assert tlc.smem_bytes(222, torch.float64) == 218_624
    for dtype, largest in ((torch.float32, 320), (torch.float64, 224)):
        assert tlc.tile_plan(largest, dtype).resident
        assert tlc.smem_bytes(largest, dtype) <= tlc.SMEM_LIMIT
        assert not tlc.tile_plan(largest + 1, dtype).resident
        assert tlc.smem_bytes(largest + 1, dtype) < tlc.smem_bytes(largest, dtype)


F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("n,dtype,want", [
    # the path shape: f32 (batched, solve_window) and f64 (streaming)
    (222, F32, (32, 224, True, False, 28 * 4096 + 2 * 224 * 4, 0)),
    (222, F64, (16, 224, True, False, 105 * 2048 + 2 * 224 * 8, 0)),
    # the largest resident n of each dtype
    (320, F32, (32, 320, True, False, 55 * 4096 + 2 * 320 * 4, 0)),
    (224, F64, (16, 224, True, False, 218_624, 0)),
    # streamed: the triangle in a workspace, two panels in shared memory
    (238, F64, (16, 240, False, True, 2 * 15 * 2048 + 2 * 240 * 8, 120 * 256)),
    (384, F32, (32, 384, False, True, 2 * 12 * 4096 + 2 * 384 * 4, 78 * 1024)),
    # streamed, two panels (2 x 57 tiles) over the limit too
    (1800, F32, (32, 1824, False, False, 2 * 1824 * 4, 57 * 58 // 2 * 1024)),
    (1, F32, (32, 32, True, False, 4096 + 2 * 32 * 4, 0)),
])
def test_tile_plan_pins_layout(n, dtype, want):
    assert tuple(tlc.tile_plan(n, dtype)) == want


@pytest.mark.parametrize("dtype", [F32, F64])
def test_tile_plan_every_n_fits(dtype):
    """Every n up to 2000 gets a layout that fits a block; nothing an
    earlier layout took (f32 n <= 240, f64 n <= 238) is refused."""
    for n in range(1, 2001):
        p = tlc.tile_plan(n, dtype)
        assert p.n_pad % p.nb == 0 and n <= p.n_pad < n + p.nb
        assert p.smem_bytes <= tlc.SMEM_LIMIT
        nt = p.n_pad // p.nb
        assert p.work_elems == (0 if p.resident
                                else nt * (nt + 1) // 2 * p.nb * p.nb)
        work, args = tlc.launch_args(n, dtype, 2, "cpu")
        assert args == (p.nb, int(p.resident), int(p.panel_in_smem),
                        p.smem_bytes)
        assert (work is None) == p.resident
        if work is not None:
            assert tuple(work.shape) == (2, p.work_elems)
            assert work.dtype == dtype


def test_launch_args_refuses_what_no_block_holds():
    """Only an n whose two vectors exceed a block's shared memory is
    refused (f32 n > 29,056), as the column kernel refused it."""
    tlc.launch_args(29_056, F32, 1, "meta")
    with pytest.raises(ValueError):
        tlc.launch_args(29_057, F32, 1, "meta")
