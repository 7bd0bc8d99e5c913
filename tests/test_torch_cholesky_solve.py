"""The port's damped Cholesky solve (`ops/cholesky_solve.py`, counterpart of
`cerberus_tpu/ops/pallas_kernels.py::cholesky_solve`) against the JAX
package, on the CPU, where the port's wrapper runs its plain version.

  * f32 against the Pallas kernel in interpret mode, at
    tests/test_pallas_kernels.py's shapes (n = 128, 256, 384 with B = 3;
    n = 222 with B = 2, a scalar lam) and tolerance (rtol = atol = 2e-3:
    both sides factor in f32, in another order);
  * f64 against the damped f64 `jnp.linalg.solve` at 1e-10 relative (two
    exact methods, roundoff apart on these well-conditioned systems).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberus_tpu.ops.pallas_kernels import cholesky_solve as pallas_solve
from cerberus_tpu_torch.ops.cholesky_solve import (cholesky_solve,
                                                   cholesky_solve_plain)
from cerberus_tpu_torch.ops.lane_cholesky import SMEM_LIMIT, tile_plan
from torch_port_util import assert_close, assert_rel


def make_spd(rng, B, n, dtype=np.float32):
    """SPD systems as tests/test_pallas_kernels.py makes them."""
    A = rng.normal(size=(B, n, n)).astype(dtype)
    return np.einsum("bij,bkj->bik", A, A) + n * np.eye(n, dtype=dtype)


def damped_solve_ref(H, b, lam):
    """x = -(H + diag(lam diag(H) + 1e-12))^-1 b with jnp.linalg.solve."""
    dd = lam[:, None] * jnp.diagonal(H, axis1=1, axis2=2) + 1e-12
    Hd = H + jax.vmap(jnp.diag)(dd)
    return jax.vmap(lambda A, bb: -jnp.linalg.solve(A, bb))(Hd, b)


@pytest.mark.parametrize("B,n,scalar_lam", [(3, 128, False), (3, 256, False),
                                             (3, 384, False), (2, 222, True)])
def test_matches_pallas_kernel_f32(B, n, scalar_lam):
    rng = np.random.default_rng(n)
    H = make_spd(rng, B, n)
    b = rng.normal(size=(B, n)).astype(np.float32)
    lam = np.float32(1e-4) if scalar_lam else np.full(B, 1e-4, np.float32)
    want = np.asarray(pallas_solve(jnp.asarray(H), jnp.asarray(b),
                                   jnp.asarray(lam), interpret=True))
    got = cholesky_solve(torch.as_tensor(H), torch.as_tensor(b),
                         torch.as_tensor(lam))
    assert got.dtype == torch.float32
    assert_close(f"cholesky_solve f32 n={n}", got.numpy(), want, 2e-3, 2e-3)


@pytest.mark.parametrize("B,n", [(3, 128), (2, 222), (3, 384)])
def test_matches_damped_linalg_solve_f64(B, n):
    rng = np.random.default_rng(100 + n)
    H = make_spd(rng, B, n, np.float64)
    b = rng.normal(size=(B, n))
    lam = rng.uniform(1e-5, 1e-2, B)
    want = np.asarray(damped_solve_ref(jnp.asarray(H), jnp.asarray(b),
                                       jnp.asarray(lam)))
    got = cholesky_solve_plain(torch.as_tensor(H), torch.as_tensor(b),
                               torch.as_tensor(lam))
    assert_rel(f"cholesky_solve f64 n={n}", got.numpy(), want, 1e-10)


def test_rejects_bad_shapes():
    H = torch.eye(4, dtype=torch.float64)[None].repeat(2, 1, 1)
    with pytest.raises(ValueError):
        cholesky_solve(H, torch.ones(2, 3, dtype=torch.float64), 1e-4)
    with pytest.raises(ValueError):
        cholesky_solve(H, torch.ones(2, 4, dtype=torch.float64),
                       torch.ones(3, dtype=torch.float64))


@pytest.mark.parametrize("n,resident,smem", [
    (128, True, 10 * 4096 + 2 * 128 * 4),
    (222, True, 28 * 4096 + 2 * 224 * 4),
    (256, True, 36 * 4096 + 2 * 256 * 4),
    (383, False, 2 * 12 * 4096 + 2 * 384 * 4),
    (384, False, 2 * 12 * 4096 + 2 * 384 * 4),
    (385, False, 2 * 13 * 4096 + 2 * 416 * 4),
])
def test_tile_plan_of_the_kernel_shapes(n, resident, smem):
    """The layout of the kernel at the TPU kernel's tested shapes and at
    n = 383, 385: 32-wide f32 tiles, resident in shared memory up to
    n = 320, else the triangle streamed from a workspace (nt(nt+1)/2 tiles
    of 4 KB: 319,488 B at n = 384, over a block's limit) with two panels in
    shared memory."""
    p = tile_plan(n, torch.float32)
    nt = -(-n // 32)
    assert (p.nb, p.n_pad, p.resident, p.smem_bytes) == (32, 32 * nt,
                                                          resident, smem)
    assert p.panel_in_smem == (not resident)
    assert p.smem_bytes <= SMEM_LIMIT
    tri_bytes = nt * (nt + 1) // 2 * 4096
    assert (tri_bytes + 2 * nt * 32 * 4 <= SMEM_LIMIT) == resident
    assert p.work_elems == (0 if resident else tri_bytes // 4)
