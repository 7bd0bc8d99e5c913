"""Where loop candidates die (port of the JAX repo's `evals/diag_loop.py`):
the loop closer, apart from the estimator, fed GROUND-TRUTH keyframe
poses, ideal feature observations with the true landmark positions, and
the rendered left image of every camera frame of the street circuit, so
that any rejection belongs to the visual matching or PnP stages
themselves. Counts candidates that die at patch matching (few matches),
at world-point availability (few world points) or at RANSAC PnP, and
those that pass, with the match and world-point counts and the PnP
position error.

  * `DiagCloser`: the port's `LoopCloser` with `_try_close` counting;
  * `keyframes`: the stream (time, true pose, observations, left image),
    each frame rendered as a stereo pair as the script renders it;
  * `feed` and `summary`: the run and its analysis.

`DiagCloser._try_close` takes the `seq_consistent` flag that
`LoopCloser.add_keyframe_precomputed` passes; the JAX script's override
does not, so the JAX script stops with a TypeError at the first candidate
that reaches verification. Its `cand -= 1` after a verified candidate
("undo double-counting by the parent call") is kept, so the counts are the
script's: the parent's `_try_close` counts nothing, and `cand` ends short
of the sum of the four outcomes by `pnp_ok`.

The pose graph optimizes on the card unless `--device cpu` is given; with
no card and no `--device cpu` it raises. `--out FILE` writes the results.

    python -m cerberus_tpu_torch.evals.diag_loop [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.data.simulator import (ImageRenderer, SimConfig,
                                               simulate)
from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.estimator import pnp
from cerberus_tpu_torch.evals import diag_util
from cerberus_tpu_torch.loop import descriptors as desc
from cerberus_tpu_torch.loop.closer import LoopCloser


class DiagCloser(LoopCloser):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.st = dict(cand=0, few_matches=0, few_world=0, pnp_fail=0,
                       pnp_ok=0, match_counts=[], world_counts=[],
                       pnp_err=[])

    def _try_close(self, old_idx, rec, sim=1.0, seq_consistent=False):
        self.st["cand"] += 1
        old = self.db[old_idx]
        need = self._required_matches(sim)
        i_new, i_old = desc.match_patches(rec["descs"], rec["ok"],
                                          old["descs"], old["ok"])
        self.st["match_counts"].append(len(i_new))
        if len(i_new) < need:
            self.st["few_matches"] += 1
            self.loops_rejected += 1
            return
        w_old = old["world"][i_old]
        good = ~np.isnan(w_old[:, 0])
        self.st["world_counts"].append(int(good.sum()))
        if good.sum() < need:
            self.st["few_world"] += 1
            self.loops_rejected += 1
            return
        res = pnp.ransac_pnp(w_old[good], rec["uv"][i_new][good],
                             min_inliers=need)
        if res is None:
            self.st["pnp_fail"] += 1
            self.loops_rejected += 1
            return
        self.st["pnp_ok"] += 1
        R_cam, t_cam, inl = res
        R_body = R_cam @ self.ric0.T
        p_body = t_cam - R_body @ self.tic0
        self.st["pnp_err"].append(float(np.linalg.norm(
            p_body - rec["p_odo"])))
        super()._try_close(old_idx, rec, sim=sim,
                           seq_consistent=seq_consistent)
        # the JAX script's "undo double-counting by the parent call"
        self.st["cand"] -= 1


def make_stream(duration=180.0, speed=0.75, seed=77, path="street",
                cfg=None):
    """(simulation, renderer) of the circuit."""
    cfg = cfg or EstimatorConfig()
    sim = simulate(SimConfig(duration=duration, speed=speed, path=path,
                             seed=seed), est_cfg=cfg)
    return sim, ImageRenderer(sim, cfg)


def keyframes(sim, r):
    """Per camera frame: (t, true p, true q, ids, {id: (normalized obs,
    true landmark)}, left image)."""
    lm = sim["landmarks"]
    for i, tc in enumerate(sim["cam_t"]):
        k = int(sim["cam_idx"][i])
        feats = sim["features"][i]
        obs = {int(f): (np.asarray(o0[:2]), lm[int(f)])
               for f, (o0, v0, o1, v1) in feats.items()}
        img0, _ = r.render_stereo(k)
        yield float(tc), sim["p"][k], sim["q"][k], sorted(obs), obs, img0


def feed(closer, frames):
    """Each keyframe into the closer, then `finish`; returns the nodes
    added."""
    n_kf = 0
    for t, p, q, ids, obs, img in frames:
        if closer.add_keyframe(t, p, q, ids, obs, img) >= 0:
            n_kf += 1
    closer.finish()
    return n_kf


def summary(closer, n_kf):
    st = dict(closer.st)
    mc = np.array(st.pop("match_counts") or [0])
    wc = np.array(st.pop("world_counts") or [0])
    pe = np.array(st.pop("pnp_err") or [np.nan])
    return dict(keyframes=n_kf, skipped=closer.kf_skipped, **st,
                match_p50=float(np.percentile(mc, 50)),
                match_p90=float(np.percentile(mc, 90)),
                world_p50=float(np.percentile(wc, 50)),
                world_p90=float(np.percentile(wc, 90)),
                min_matches=closer.min_matches,
                loops_found=closer.loops_found,
                best_sim=float(closer.best_sim),
                pnp_err_p50=float(np.nanmedian(pe)),
                n_loop_edges=closer.pg.n_loop_edges)


def print_summary(s, wall):
    print(f"keyframes {s['keyframes']} skipped {s['skipped']} "
          f"wall {wall:.0f}s")
    print(f"candidates {s['cand']} -> few_matches {s['few_matches']} "
          f"few_world {s['few_world']} pnp_fail {s['pnp_fail']} "
          f"pnp_ok {s['pnp_ok']}")
    print(f"match counts p50/p90: {s['match_p50']:.0f} "
          f"{s['match_p90']:.0f}  (need >= {s['min_matches']})")
    print(f"world counts p50/p90: {s['world_p50']:.0f} "
          f"{s['world_p90']:.0f}")
    print(f"loops_found {s['loops_found']} best_sim {s['best_sim']:.3f} "
          f"pnp pos err p50 {s['pnp_err_p50']:.3f} m")


def run(duration=180.0, speed=0.75, seed=77, path="street", device="cuda"):
    """The circuit's keyframes through a DiagCloser (LoopCloser defaults);
    returns summary's numbers and the wall seconds."""
    cfg = EstimatorConfig()
    sim, r = make_stream(duration, speed, seed, path, cfg)
    closer = DiagCloser(cfg, focal=r.f, cx=r.cx, cy=r.cy, device=device)
    t0 = time.time()
    n_kf = feed(closer, keyframes(sim, r))
    s = summary(closer, n_kf)
    s["wall_s"] = time.time() - t0
    print_summary(s, s["wall_s"])
    return s


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    diag_util.add_device(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = dict(run(device=dev), device=dev.type)
    diag_util.write_out(args.out, res)
    return res


if __name__ == "__main__":
    main()
