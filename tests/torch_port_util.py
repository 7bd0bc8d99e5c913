"""Shared helpers of the tests that hold the PyTorch port (cerberus_tpu_torch)
against the JAX package: a JAX window carried to the port as numpy arrays
(cerberus_tpu_torch.convert), and comparisons that report their largest
difference."""

import numpy as np
import torch

from cerberus_tpu_torch import convert


def to_port(state, data, dtype=torch.float64):
    """JAX package (WindowState, WindowData) -> the port's, on the CPU."""
    as_np = lambda nt: type(nt)(*(as_np(x) if isinstance(x, tuple)
                                  else np.asarray(x) for x in nt))
    return convert.window_from_numpy(as_np(state), as_np(data),
                                     device="cpu", dtype=dtype)


def np_tree(nt, prefix=""):
    """Flatten a (port or JAX) NamedTuple, dict or tuple, nested, to
    {path: numpy array}."""
    if isinstance(nt, dict):
        items = nt.items()
    elif isinstance(nt, tuple):
        items = zip(getattr(nt, "_fields", range(len(nt))), nt)
    else:
        return {prefix: np.asarray(nt.detach().cpu() if torch.is_tensor(nt)
                                   else nt)}
    out = {}
    for k, v in items:
        out.update(np_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def assert_close(name, got, want, rtol, atol):
    """np.testing.assert_allclose (NaN fails) that first prints the largest
    difference as `PORT_DIFF <name> max_abs=... max_rel=...` (max_rel:
    max |got - want| over max |want|); `pytest -rP` shows these lines for
    passing tests."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    max_abs = float(np.abs(got - want).max()) if want.size else 0.0
    ref = float(np.abs(want).max()) if want.size else 0.0
    max_rel = max_abs / ref if ref else max_abs
    print(f"PORT_DIFF {name} max_abs={max_abs:.3e} max_rel={max_rel:.3e}")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name,
                               equal_nan=False)


def assert_rel(name, got, want, tol):
    """assert_close at rtol = tol and atol = tol * max(1, max |want|)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert_close(name, got, want, tol, tol * scale)


def proj_inputs(B, F, dtype=torch.float64, device="cpu", seed=0):
    """B perturbed copies of a simulated window at F slots, as the
    projection rows' (state, data), with every case the rows treat apart:
    states q 1e-3 off unit norm, ex0 too, td and the observations' td
    offsets and velocities nonzero, a slot not valid, an observation and a
    whole slot's stereo missing, an anchor not observed, and in window 0 a
    slot whose inverse depth puts it at z = 0 in a frame's left camera (the
    1e-6 clamp). Returns (state, data, (b, f, j) of the clamped pair)."""
    from cerberus_tpu_torch.data.simulator import SimConfig, simulate
    from cerberus_tpu_torch.data.window_builder import build_window_from_sim
    from cerberus_tpu_torch.ops import factors as fac
    from cerberus_tpu_torch.utils import lie

    sim = simulate(SimConfig(duration=3.0, speed=0.5, seed=3,
                             n_landmarks=200))
    data, truth, _ = build_window_from_sim(sim, kf_stride=2, start_cam=2,
                                           F=F, device="cpu")
    rng = np.random.default_rng(seed)
    rand = lambda *shape: torch.as_tensor(rng.normal(size=shape))
    st = fac.map_tensors(lambda x: torch.stack([x] * B), truth)
    d = fac.map_tensors(lambda x: torch.stack([x] * B).clone(), data)
    sign = torch.as_tensor(rng.choice([-1.0, 1.0], size=(B, 11, 1)))
    st = st._replace(p=st.p + 0.02 * rand(B, 11, 3),
                     q=st.q * (1 + 1e-3 * sign), qic=st.qic * (1 - 1e-3),
                     td=st.td + 0.003,
                     depth=st.depth * (1 + 0.05 * rand(B, F)))
    d = d._replace(f_vel=d.f_vel + 0.1 * rand(*d.f_vel.shape),
                   f_vel_r=d.f_vel_r + 0.1 * rand(*d.f_vel_r.shape),
                   f_td=d.f_td + 0.001)
    b = min(B - 1, 1)
    d.f_valid[b, 3] = False
    d.f_obs[b, 4, 5] = False
    d.f_stereo[b, 5, :] = False
    d.f_obs[b, 6, d.f_start[b, 6]] = False

    # window 0, slot 2: the depth at which the point's left camera z in
    # frame j is 0 (z is affine in the depth); its inverse is the state's
    f = 2
    s = int(d.f_start[0, f])
    j = next(k for k in range(11) if k != s and bool(d.f_obs[0, f, k]))
    unit = lambda q: q / q.norm()
    vel = torch.cat([d.f_vel[0, f, s], torch.zeros(1, dtype=torch.float64)])
    a = d.f_pts[0, f, s] - (st.td[0] - d.f_td[0, f, s]) * vel

    def z(depth):
        u = lie.quat_rotate(unit(st.qic[0, 0]), a * depth) + st.tic[0, 0]
        w = lie.quat_rotate(unit(st.q[0, s]), u) + st.p[0, s]
        m = lie.quat_rotate(lie.quat_conj(unit(st.q[0, j])), w - st.p[0, j])
        return lie.quat_rotate(lie.quat_conj(unit(st.qic[0, 0])),
                               m - st.tic[0, 0])[2]

    st.depth[0, f] = (z(0.0) - z(1.0)) / z(0.0)
    to = lambda x: x.to(device, dtype) if x.is_floating_point() \
        else x.to(device)
    return (fac.map_tensors(to, st), fac.map_tensors(to, d), (0, f, j))


def rows_gap(got, want):
    """Largest gap between two routes' projection rows (r, J), each pair's
    row [r, J (26)] over the row's largest entry in `want`, over every
    (window, slot, frame, row); raises where a row zero in `want` is not
    zero in `got`."""
    got = torch.cat([got[0][..., None], got[1]], dim=-1).double()
    want = torch.cat([want[0][..., None], want[1]], dim=-1).double()
    gap = (got - want).abs().amax(dim=-1)
    scale = want.abs().amax(dim=-1)
    if gap[scale == 0].any():
        raise AssertionError("rows zero in one route are not in the other")
    return float((gap[scale > 0] / scale[scale > 0]).max())


def proj_read_pairs(data):
    """Pairs (window, slot, frame) of `data` (a leading batch axis or not)
    with a camera's mask on, the mono one (the anchor observed in a valid
    slot, frame j observed and not the anchor) or the stereo one (the
    anchor observed in a valid slot, frame j's stereo observation): the
    pairs whose values the projection rows' kernel reads."""
    start = data.f_start.long()
    inside = (start >= 0) & (start < 11)
    anchor = data.f_obs.gather(-1, start.clamp(0, 10)[..., None])[..., 0]
    obs_i = (inside & data.f_valid & anchor)[..., None]
    frames = torch.arange(11, device=start.device)
    mono = obs_i & data.f_obs & (frames != start[..., None])
    return int((mono | (obs_i & data.f_stereo)).sum())
