"""The projection rows' wrapper on the CPU (`ops/proj_rows.py`): CPU
tensors take the plain jacrev version and launch nothing; the custom op's
vmap rule makes a vmapped call one call over the batch that equals a loop
of single-window calls, with an argument vmap does not map and under two
nested vmaps; a single-window call equals a batch of one; the CUDA route's
checks refuse what the kernel does not take before any launch; the pairs
that the kernel counts as read (`torch_port_util.proj_read_pairs`) are
those whose plain rows are not zero, and the routes' row gap
(`torch_port_util.rows_gap`) sees a zero row that is not. (The kernel
itself runs on the card only: tests/test_torch_cuda.py.)"""

import pytest
import torch
from torch.func import vmap
from torch.profiler import ProfilerActivity, profile

from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.ops import proj_rows as pr
from cerberus_tpu_torch.utils import profiling
from torch_port_util import proj_inputs, proj_read_pairs, rows_gap

B, F = 4, 16


@pytest.fixture(scope="module")
def windows():
    return proj_inputs(B, F)[:2]


def one(tree, b):
    return fac.map_tensors(lambda x: x[b], tree)


def assert_rows_equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-13, atol=1e-13)


def test_cpu_tensors_take_the_plain_version(windows):
    st, d = one(windows[0], 0), one(windows[1], 0)
    pr.LAUNCHES.clear()
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        r, J = pr.proj_rows(st, d)
    assert not pr.LAUNCHES and "proj.kernel_pairs" not in profiling.counters()
    want = pr.proj_rows_plain(*pr._inputs(st, d))
    assert torch.equal(r, want[0]) and torch.equal(J, want[1])
    assert r.shape == (F, 11, 4) and J.shape == (F, 11, 4, pr.PROJ_TAN)


def test_vmapped_call_equals_a_loop_of_single_window_calls(windows):
    st, d = windows
    loop = [pr.proj_rows(one(st, b), one(d, b)) for b in range(B)]
    want = tuple(torch.stack(x) for x in zip(*loop))
    assert_rows_equal(vmap(pr.proj_rows)(st, d), want)
    # data shared by every window: an argument vmap does not map
    shared = [pr.proj_rows(one(st, b), one(d, 0)) for b in range(B)]
    assert_rows_equal(vmap(pr.proj_rows, in_dims=(0, None))(st, one(d, 0)),
                      tuple(torch.stack(x) for x in zip(*shared)))
    # two nested vmaps over (2, B / 2) windows
    split = lambda t: fac.map_tensors(
        lambda x: x.reshape((2, B // 2) + x.shape[1:]), t)
    nested = vmap(vmap(pr.proj_rows))(split(st), split(d))
    assert_rows_equal(tuple(x.reshape((B,) + x.shape[2:]) for x in nested),
                      want)


def test_single_window_call_equals_a_batch_of_one(windows):
    st, d = one(windows[0], 2), one(windows[1], 2)
    r, J = pr.proj_rows(st, d)
    r1, J1 = pr.proj_rows_op(*(x[None] for x in pr._inputs(st, d)))
    assert torch.equal(r, r1[0]) and torch.equal(J, J1[0])
    rv, Jv = vmap(pr.proj_rows)(*(fac.map_tensors(lambda x: x[None], t)
                                  for t in (st, d)))
    assert_rows_equal((rv[0], Jv[0]), (r, J))


def test_cuda_route_refuses_what_the_kernel_does_not_take(windows):
    """The CUDA route's checks run before the kernel is loaded, so they
    refuse on any device."""
    st, d = windows
    args = pr._inputs(st, d)
    with pytest.raises(TypeError):
        pr._proj_rows_cuda(*(x.half() if x.is_floating_point() else x
                             for x in args))
    with pytest.raises(TypeError):
        pr._proj_rows_cuda(*pr._inputs(st, d._replace(
            f_start=d.f_start.long())))
    with pytest.raises(TypeError):
        pr._proj_rows_cuda(*pr._inputs(st._replace(depth=st.depth.float()),
                                       d))
    with pytest.raises(ValueError):
        pr._proj_rows_cuda(*pr._inputs(st, d._replace(
            f_pts=d.f_pts[:, :, :10])))
    with pytest.raises(ValueError):
        pr._proj_rows_cuda(*pr._inputs(st._replace(depth=st.depth[0]), d))


def test_read_pairs_are_the_pairs_with_rows(windows):
    """A pair reads its values where a camera's mask is on: exactly the
    pairs whose plain rows are not all zero (every case of `proj_inputs`
    among them: a slot not valid, an observation, a slot's stereo and an
    anchor missing)."""
    st, d = windows
    r, J = vmap(pr.proj_rows)(st, d)
    nonzero = (r != 0).any(-1) | (J != 0).any(-1).any(-1)
    assert 0 < proj_read_pairs(d) == int(nonzero.sum()) < r[..., 0].numel()
    assert proj_read_pairs(one(d, 1)) == int(nonzero[1].sum())


def test_rows_gap_refuses_rows_zero_in_one_route_only(windows):
    st, d = one(windows[0], 0), one(windows[1], 0)
    r, J = pr.proj_rows(st, d)
    assert rows_gap((r, J), (r, J)) == 0.0
    assert rows_gap((r, J * (1 + 1e-6)), (r, J)) == pytest.approx(1e-6)
    dead = (r == 0).all(-1) & (J == 0).all(-1).all(-1)
    r2 = r.clone()
    r2[dead.nonzero()[0].tolist()] = 1.0
    with pytest.raises(AssertionError):
        rows_gap((r2, J), (r, J))

