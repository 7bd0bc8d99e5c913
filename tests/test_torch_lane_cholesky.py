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
    before = dict(tlc.LAUNCHES)
    x = tlc.lane_cholesky_solve(torch.as_tensor(A), torch.as_tensor(b))
    assert dict(tlc.LAUNCHES) == before
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


# the f64 cluster body (csrc/cluster_cholesky.cuh): one thread-block
# cluster per system for f64 systems one block would stream
# rank r keeps block-columns r and r + 16 of 24: 24 - r + max(8 - r, 0)
# tiles, then the panel buffer (23 tiles and 16 entries), one tile and two
# 384-entry vectors
_RANKS16 = tuple(8 * (t * 256 + 23 * 256 + 16 + 256 + 2 * 384)
                 for t in (32, 30, 28, 26, 24, 22, 20, 18, 16, 15, 14, 13,
                           12, 11, 10, 9))


@pytest.mark.parametrize("B,n,want", [
    # the solver's full (222 + F)-dim system, F = 160: 24 block-columns
    # over 16 ranks, rank 0 keeping columns 0 and 16 (24 + 8 tiles)
    (1, 382, (16, 384, 16, _RANKS16, 120_960, 2 * (23 * 256 + 16))),
    (8, 382, (16, 384, 16, _RANKS16, 120_960, 2 * (23 * 256 + 16))),
])
def test_solve_plan_pins_the_cluster_layout(B, n, want):
    assert tuple(tlc.solve_plan(n, F64, B)) == want


@pytest.mark.parametrize("B,n,dtype", [
    (1, 222, F64), (128, 222, F64), (128, 222, F32), (128, 382, F32),
    (1, 382, F32), (128, 382, F64), (1, 224, F64)])
def test_solve_plan_keeps_the_one_block_plans(B, n, dtype):
    """f64 systems resident in one block, f32 systems, and f64 batches too
    large for the card's SMs at once stay on the one-block body."""
    assert tlc.solve_plan(n, dtype, B) == tlc.tile_plan(n, dtype)


def test_cluster_batch_rule():
    """A batch goes to the cluster body when its clusters fit the card at
    once (B * cluster <= 132 SMs), with the first of CLUSTER_SIZES that
    does: 16 blocks up to B = 8, 8 up to 16, 4 up to 33."""
    sizes = {}
    for B in range(1, 40):
        p = tlc.solve_plan(382, F64, B)
        sizes[B] = p.cluster if isinstance(p, tlc.ClusterPlan) else None
        if sizes[B]:
            assert B * p.cluster <= tlc.SM_COUNT
    assert {B for B, c in sizes.items() if c == 16} == set(range(1, 9))
    assert {B for B, c in sizes.items() if c == 8} == set(range(9, 17))
    assert {B for B, c in sizes.items() if c == 4} == set(range(17, 34))
    assert {B for B, c in sizes.items() if c is None} == set(range(34, 40))


@pytest.mark.parametrize("cluster", [4, 8, 16])
def test_cluster_tiles_cover_the_triangle_once(cluster):
    """Every tile of the triangle lives in exactly one rank, block-column J
    in rank J % cluster, each column from its diagonal tile down at the
    offset csrc/cluster_cholesky.cuh::column_offset computes; every rank's
    bytes fit a block's shared memory wherever the plan routes here."""
    nb = tlc.CLUSTER_NB
    for n in range(225, 641, 7):
        nt = -(-n // nb)
        seen = []
        for r in range(cluster):
            tiles = tlc.cluster_tiles(nt, cluster, r)
            assert all(J % cluster == r for _, J in tiles)
            for j, J in enumerate(range(r, nt, cluster)):
                assert tiles.index((J, J)) == j * (nt - r) \
                    - cluster * j * (j - 1) // 2
            seen += tiles
        assert sorted(seen) == sorted((I, J) for J in range(nt)
                                      for I in range(J, nt))
        p = tlc.cluster_plan(n, cluster)
        assert p.smem_bytes == max(p.rank_bytes) == p.rank_bytes[0]
        if tlc.solve_plan(n, F64, 1) == p:
            assert p.smem_bytes <= tlc.SMEM_LIMIT


def test_every_routed_n_fits():
    """Every f64 n the plan sends to the cluster body, at B = 1 and 33,
    fits: each rank's bytes within a block's shared memory."""
    routed = 0
    for n in range(1, 1001):
        for B in (1, 33):
            p = tlc.solve_plan(n, F64, B)
            if isinstance(p, tlc.ClusterPlan):
                routed += 1
                assert n > 224 and B * p.cluster <= tlc.SM_COUNT
                assert all(b <= tlc.SMEM_LIMIT for b in p.rank_bytes)
                assert p.n_pad % p.nb == 0 and n <= p.n_pad < n + p.nb
    assert routed > 500
