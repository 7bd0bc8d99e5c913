"""The port's 4-DoF pose graph against the JAX package, f64 on the CPU.

Inputs: tests/test_posegraph.py's drifting square loop (41 nodes), padded
with masked edges and nodes as PoseGraph pads them, and small PoseGraph
scripts that grow the node pool, detect a loop by feature overlap, prune
an outlier edge and roll an optimize back.

Tolerances, and why:
  * optimize_pose_graph: 1e-10 relative — the same Gauss-Newton, whose H and
    b the port sums per edge (scatter) where JAX multiplies out a one-hot
    matrix, so they differ by summation order only;
  * the closed-form Jacobian against torch.func.jacfwd, and the scatter H,
    b against the one-hot form: 1e-13 relative;
  * PoseGraph driven by the same calls: every guard decision equal (stats,
    edges kept), states within 1e-10 relative;
  * an .npz saved by one package and loaded by the other: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberus_tpu.loop import posegraph as jpg
from cerberus_tpu_torch.loop import posegraph as tpg
from test_posegraph import make_square_loop
from torch_port_util import assert_close, assert_rel

CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers at once, and the
    port's many small ops run slower with eight threads contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _square_problem(N_pad, E_pad, loop_w=20.0):
    """The square loop's edges (odometry + one loop edge closing it, two
    more loop edges), padded to N_pad nodes and E_pad edges with masked
    edges (0 -> 0) as PoseGraph pads them."""
    gt_p, gt_yaw, est_p, est_yaw, rels = make_square_loop()
    N = len(gt_p)
    e_i = [k for k in range(N - 1)] + [0, 5, 12]
    e_j = [k + 1 for k in range(N - 1)] + [N - 1, 25, 33]
    rel_p = [r[0] for r in rels] + [gt_p[N - 1] - gt_p[0]]
    rel_yaw = [r[1] for r in rels] + [gt_yaw[N - 1] - gt_yaw[0]]
    for i, j in ((5, 25), (12, 33)):
        Ri = tpg._np_rot_z(gt_yaw[i])
        rel_p.append(Ri.T @ (gt_p[j] - gt_p[i]) + 1.5)
        rel_yaw.append(gt_yaw[j] - gt_yaw[i] - 0.05)
    E = len(e_i)
    pad = lambda a, n, shape=(): np.concatenate(
        [np.asarray(a, np.float64), np.zeros((n - len(a),) + shape)])
    p = pad(est_p, N_pad, (3,))
    yaw = pad(est_yaw, N_pad)
    ei = np.zeros(E_pad, np.int32)
    ej = np.zeros(E_pad, np.int32)
    ei[:E], ej[:E] = e_i, e_j
    w = pad(np.concatenate([np.full(N - 1, 10.0), np.full(3, loop_w)]), E_pad)
    mask = np.arange(E_pad) < E
    robust = mask & ((ej - ei) != 1)
    return (p, yaw, ei, ej, pad(rel_p, E_pad, (3,)), pad(rel_yaw, E_pad), w,
            mask, robust)


@pytest.mark.parametrize("robust_kind", ["cauchy", "huber"])
@pytest.mark.parametrize("robust", [False, True], ids=["plain", "e_robust"])
def test_optimize_pose_graph_matches_jax(robust_kind, robust):
    args = _square_problem(64, 128)
    e_robust = args[-1] if robust else None
    kw = dict(iters=6, robust_kind=robust_kind)
    jp, jy = jpg.optimize_pose_graph(*map(jnp.asarray, args[:-1]),
                                     None if e_robust is None
                                     else jnp.asarray(e_robust), **kw)
    tp, ty = tpg.optimize_pose_graph(*args[:-1], e_robust, **kw, **CPU)
    name = f"optimize_pose_graph[{robust_kind},{'robust' if robust else 'plain'}]"
    assert_rel(name + ".p", tp.numpy(), np.asarray(jp), 1e-10)
    assert_rel(name + ".yaw", ty.numpy(), np.asarray(jy), 1e-10)
    if robust:      # the robust weights act on these inputs
        plain, _ = tpg.optimize_pose_graph(*args[:-1], None, **kw, **CPU)
        assert float((plain - tp).abs().max()) > 1e-4
    # padded nodes and the gauge node stay where they were
    assert np.array_equal(tp.numpy()[41:], args[0][41:])
    assert np.array_equal(tp.numpy()[0], args[0][0])


def _edge_residual(delta, p, yaw, i, j, rel_p, rel_yaw):
    """JAX `_edge_residual` in torch ops, for torch.func.jacfwd."""
    yi = yaw[i] + delta[3]
    c, s = torch.cos(yi), torch.sin(yi)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    RiT = torch.stack([c, s, z, -s, c, z, z, z, o]).reshape(3, 3)
    r_p = RiT @ (p[j] + delta[4:7] - p[i] - delta[0:3]) - rel_p
    dy = yaw[j] + delta[7] - yi - rel_yaw
    dy = torch.atan2(torch.sin(dy), torch.cos(dy))
    return torch.cat([r_p, dy[None]])


def test_closed_form_jacobian_matches_jacfwd():
    p, yaw, ei, ej, rel_p, rel_yaw, *_ = map(torch.as_tensor,
                                             _square_problem(41, 43))
    yaw = yaw + torch.linspace(-3.0, 3.0, len(yaw), dtype=torch.float64)
    r, J = tpg._edge_residual_jacobian(p, yaw, ei.long(), ej.long(), rel_p,
                                       rel_yaw)
    zero = torch.zeros(8, dtype=torch.float64)
    want = torch.stack([torch.func.jacfwd(_edge_residual)(
        zero, p, yaw, int(i), int(j), rel_p[k], rel_yaw[k])
        for k, (i, j) in enumerate(zip(ei, ej))])
    want_r = torch.stack([_edge_residual(zero, p, yaw, int(i), int(j),
                                         rel_p[k], rel_yaw[k])
                          for k, (i, j) in enumerate(zip(ei, ej))])
    assert_rel("posegraph.jacobian", J.numpy(), want.numpy(), 1e-13)
    assert_rel("posegraph.residual", r.numpy(), want_r.numpy(), 1e-13)


def test_scatter_assembly_matches_one_hot():
    p, yaw, ei, ej, rel_p, rel_yaw, w, mask, _ = map(
        torch.as_tensor, _square_problem(64, 128))
    ei, ej = ei.long(), ej.long()
    r, J = tpg._edge_residual_jacobian(p, yaw, ei, ej, rel_p, rel_yaw)
    s = torch.where(mask, w, torch.zeros_like(w))
    J, r = J * s[:, None, None], r * s[:, None]
    N, E = p.shape[0], ei.shape[0]
    H, b = tpg._normal_equations(J, r, ei, ej, N)
    # the JAX package's one-hot form
    Ei = torch.nn.functional.one_hot(ei, N).to(torch.float64)
    Ej = torch.nn.functional.one_hot(ej, N).to(torch.float64)
    A = (torch.einsum("eab,en->eanb", J[..., 0:4], Ei)
         + torch.einsum("eab,en->eanb", J[..., 4:8], Ej)).reshape(E * 4,
                                                                  4 * N)
    assert_rel("posegraph.H scatter vs one-hot", H.numpy(), (A.T @ A).numpy(),
               1e-13)
    assert_rel("posegraph.b scatter vs one-hot", b.numpy(),
               (A.T @ r.reshape(-1)).numpy(), 1e-13)


def _script_grow_detect_prune(make):
    """A walk out and back: node pool 8 grown to 32, a loop found by
    feature overlap, optimized; then a wrong loop measurement pruned."""
    pg = make(capacity_nodes=8, capacity_edges=16, min_overlap=5, min_gap=8)
    home = set(range(100, 130))
    for k in range(20):
        ids = home if k < 3 else set(range(1000 + 40 * k, 1030 + 40 * k))
        pg.add_keyframe(np.array([0.5 * k, 0.02 * k * k, 0.0]), 0.01 * k,
                        ids)
    pg.add_keyframe(np.array([0.3, 0.3, 0.0]), 0.05, home)
    pg.optimize(iters=4)
    pg.add_loop_edge(4, 19, rel_p=np.array([3.0, -2.0, 0.5]), rel_yaw=1.0,
                     weight=10.0)
    pg.optimize()
    return pg


def _script_rollback(make):
    """Long steps, a weak chain and one loop edge with a large yaw error:
    one GN iteration overshoots and the guard rolls it back."""
    pg = make(capacity_nodes=8, capacity_edges=16, auto_detect=False,
              seq_weight=3.0)
    for k in range(12):
        pg.add_keyframe(np.array([3.0 * k, 2 * np.sin(k), 0]), 0.3 * k)
    pg.add_loop_edge(0, 11, rel_p=np.array([-13.37, -13.61, -3.52]),
                     rel_yaw=2.22, weight=1.0)
    pg.prune_chi2 = 1e9
    pg.optimize(iters=1)
    return pg


@pytest.mark.parametrize("script", [_script_grow_detect_prune,
                                    _script_rollback],
                         ids=["grow-detect-prune", "rollback"])
def test_posegraph_matches_jax(script):
    jg = script(jpg.PoseGraph)
    tg = script(lambda **kw: tpg.PoseGraph(**kw, **CPU))
    assert tg.stats == jg.stats
    assert (tg.n, tg.Nc, tg.n_loop_edges) == (jg.n, jg.Nc, jg.n_loop_edges)
    if script is _script_rollback:
        assert jg.stats["rollbacks"] == 1
    else:
        assert jg.Nc == 32 and jg.stats["pruned_edges"] == 1
        assert jg.stats["optimizes"] >= 2
    assert [e[:2] for e in tg.edges] == [e[:2] for e in jg.edges]
    for k, (te, je) in enumerate(zip(tg.edges, jg.edges)):
        np.testing.assert_array_equal(np.asarray(te[2]), np.asarray(je[2]))
        assert te[3:] == je[3:], k
    name = f"PoseGraph[{script.__name__}]"
    assert_rel(name + ".p", tg.p, jg.p, 1e-10)
    assert_rel(name + ".yaw", tg.yaw, jg.yaw, 1e-10)
    assert_close(name + ".p_odo", tg.p_odo, jg.p_odo, 0, 0)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_npz_carries_the_graph_across(tmp_path, direction):
    """A graph saved by one package loads in the other with every array and
    edge equal. The loaded graph (a 512-node pool, as load_pose_graph makes
    it) then optimizes as the source does (a 16-node pool: padding changes
    nothing) — checked on the port's side of each direction, since the JAX
    package's one-hot assembly at 512 nodes costs ~1 s a GN iteration."""
    def build(pg):
        for k in range(12):
            pg.add_keyframe(np.array([0.5 * k, 0.05 * k, 0]), 0.02 * k)
        pg.add_loop_edge(1, 11, rel_p=np.array([5.0, 0.4, 0]), rel_yaw=0.2,
                         weight=20.0)
        return pg

    small = dict(capacity_nodes=16, capacity_edges=16, auto_detect=False)
    path = str(tmp_path / "pg.npz")
    if direction == "jax-to-port":
        src = build(jpg.PoseGraph(**small))
        jpg.save_pose_graph(src, path)
        dst = tpg.load_pose_graph(path, **CPU)
    else:
        src = build(tpg.PoseGraph(**small, **CPU))
        tpg.save_pose_graph(src, path)
        dst = jpg.load_pose_graph(path)
    assert (dst.n, dst.n_loop_edges, dst.Nc) == (src.n, 1, 512)
    for a in ("p", "yaw", "p_odo", "yaw_odo"):
        np.testing.assert_array_equal(getattr(dst, a)[:dst.n],
                                      getattr(src, a)[:src.n])
    assert [(e[0], e[1], e[3], e[4]) for e in dst.edges] == \
        [(e[0], e[1], e[3], e[4]) for e in src.edges]
    for de, se in zip(dst.edges, src.edges):
        np.testing.assert_array_equal(de[2], se[2])
    port, other = (dst, src) if direction == "jax-to-port" else (src, None)
    port.optimize(iters=8)
    if other is not None:
        other.optimize(iters=8)
        assert_rel(f"save/load {direction} then optimize .p",
                   port.p[:port.n], other.p[:other.n], 1e-10)
    assert port.stats["optimizes"] == 1
