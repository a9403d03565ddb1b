#!/usr/bin/env python
"""Debugging harness for the SLAM accuracy gap.

Replays uvio_jax on the reference-dumped streams (like head2head) with
tweakable knobs, and prints per-frame error statistics of both
estimators against groundtruth so divergence events are localizable.

Usage: python benchmarks/slam_debug.py --scenario mono_slam [--max-slam 25]
"""

import argparse
import dataclasses
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def load_frames(out, n_cams):
    cam = np.loadtxt(os.path.join(out, "cam.csv"), delimiter=",")
    frames = []
    t_vals, idx = np.unique(cam[:, 0], return_index=True)
    for t in t_vals[np.argsort(idx)]:
        rows = cam[cam[:, 0] == t]
        per_cam = []
        for c in range(n_cams):
            rc = rows[rows[:, 1] == c]
            per_cam.append((rc[:, 2].astype(np.int64), rc[:, 3:5]))
        frames.append((float(t), per_cam))
    frames.sort(key=lambda f: f[0])
    return frames


def replay(out, cdir, overrides, collect_diag=False, true_map=None):
    from uvio_jax.manager import VioManager
    from uvio_jax.utils.config import load_config
    from uvio_jax.update.representations import landmark_global

    cfg, extras = load_config(cdir)
    cfg = dataclasses.replace(
        cfg, use_static_init=False, use_dynamic_init=False, **overrides
    )
    mgr = VioManager(cfg)
    from functools import partial
    lm_glob = jax.jit(partial(landmark_global, layout=mgr.layout))
    init = np.loadtxt(os.path.join(out, "init.txt"))
    mgr.initialize_with_gt(init[0], init[1:5], init[5:8], init[8:11],
                           init[11:14], init[14:17])
    imu = np.loadtxt(os.path.join(out, "imu.csv"), delimiter=",")
    frames = load_frames(out, len(cfg.cameras))
    est_t, est_q, est_p, diags = [], [], [], []
    fi = 0
    for k in range(imu.shape[0]):
        t = float(imu[k, 0])
        mgr.feed_imu(t, imu[k, 1:4], imu[k, 4:7])
        while fi + 1 < len(frames) and frames[fi + 1][0] <= t:
            ti, obs = frames[fi]
            if ti > float(init[0]):
                mgr.feed_features(ti, obs)
                est_t.append(float(mgr.state.time))
                est_q.append(np.asarray(mgr.state.q))
                est_p.append(np.asarray(mgr.state.p))
                if collect_diag:
                    d = {
                        "n_slam": len(mgr.slam_slot_by_fid),
                        "msckf_used": int(np.asarray(
                            getattr(mgr, "last_msckf_info", {}).get(
                                "num_used", 0))),
                    }
                    if true_map is not None and mgr.slam_slot_by_fid:
                        p_glob, _ = lm_glob(mgr.state)
                        p_glob = np.asarray(p_glob)
                        errs = []
                        for fid, slot in mgr.slam_slot_by_fid.items():
                            pt = true_map.get(fid)
                            if pt is not None:
                                errs.append(
                                    float(np.linalg.norm(p_glob[slot] - pt)))
                        if errs:
                            d["lm_mean"] = float(np.mean(errs))
                            d["lm_max"] = float(np.max(errs))
                    diags.append(d)
            fi += 1
    return (np.asarray(est_t), np.stack(est_q), np.stack(est_p)), diags


def gt_landmarks(out, cfg):
    """Triangulate every feature track with GROUNDTRUTH poses: with 1px
    sim noise this is a near-true landmark map, fid -> p_FinG."""
    import jax.numpy as jnp

    from uvio_jax.cam import models as cam_models
    from uvio_jax.math import quat_to_rot
    from uvio_jax.update.triangulation import triangulate_batch

    gt = np.loadtxt(os.path.join(out, "gt.txt"))
    t_gt = gt[:, 0]
    p_gt = gt[:, 1:4]
    q_gt = gt[:, 4:8]
    R_GtoI = np.asarray(quat_to_rot(jnp.asarray(q_gt)))  # (N,3,3)
    cams = cfg.cameras
    # camera poses per frame index and camera
    R_GtoC = np.zeros((len(t_gt), len(cams), 3, 3))
    p_CinG = np.zeros((len(t_gt), len(cams), 3))
    for c, cc in enumerate(cams):
        R_ItoC = np.asarray(quat_to_rot(jnp.asarray(cc.q_ItoC)))
        R_GtoC[:, c] = np.einsum("ij,njk->nik", R_ItoC, R_GtoI)
        p_CinI = -R_ItoC.T @ cc.p_IinC
        p_CinG[:, c] = p_gt + np.einsum("nji,j->ni", R_GtoI, p_CinI)
    t_index = {round(t, 6): i for i, t in enumerate(t_gt)}

    cam_rows = np.loadtxt(os.path.join(out, "cam.csv"), delimiter=",")
    # undistort every row in one batched call per camera
    uvn_rows = np.zeros((len(cam_rows), 2))
    for c, cc in enumerate(cams):
        sel = cam_rows[:, 1] == c
        if np.any(sel):
            uvn_rows[sel] = np.asarray(
                cam_models.undistort(
                    jnp.asarray(cc.intrinsics), cc.model,
                    jnp.asarray(cam_rows[sel, 3:5]),
                )
            )
    by_fid = {}
    for r, row in enumerate(cam_rows):
        fi = t_index.get(round(row[0], 6))
        if fi is None:
            continue
        by_fid.setdefault(int(row[2]), []).append((fi, int(row[1]), r))

    fids = sorted(by_fid)
    MAXO = 24
    uvn = np.zeros((len(fids), MAXO, 2))
    mask = np.zeros((len(fids), MAXO), bool)
    Rg = np.tile(np.eye(3), (len(fids), MAXO, 1, 1))
    pg = np.zeros((len(fids), MAXO, 3))
    for i, fid in enumerate(fids):
        obs = by_fid[fid]
        if len(obs) > MAXO:  # spread across the whole track
            idx = np.linspace(0, len(obs) - 1, MAXO).astype(int)
            obs = [obs[j] for j in idx]
        for j, (fi, c, r) in enumerate(obs):
            uvn[i, j] = uvn_rows[r]
            mask[i, j] = True
            Rg[i, j] = R_GtoC[fi, c]
            pg[i, j] = p_CinG[fi, c]
    p_f, ok = triangulate_batch(
        jnp.asarray(uvn), jnp.asarray(mask), jnp.asarray(Rg), jnp.asarray(pg)
    )
    p_f, ok = np.asarray(p_f), np.asarray(ok)
    return {fid: p_f[i] for i, fid in enumerate(fids) if ok[i]}


def per_frame_err(est, gt_file, label):
    from uvio_jax.eval.traj import ate, load_tum

    te, qe, pe = est
    tg, qg, pg = load_tum(gt_file)
    r = ate(te, qe, pe, tg, qg, pg, method="se3")
    return te[: len(r["err_pos"])], r["err_pos"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="mono_slam")
    ap.add_argument("--rep", default=None, help="override feat_rep_slam int")
    ap.add_argument("--max-slam", type=int, default=None)
    ap.add_argument("--tag", default="exp")
    args = ap.parse_args()

    out = f"/tmp/h2h/{args.scenario}"
    cdir = f"{out}/config"
    overrides = {}
    if args.rep is not None:
        overrides["feat_rep_slam"] = int(args.rep)
    if args.max_slam is not None:
        overrides["max_slam"] = args.max_slam

    from uvio_jax.utils.config import load_config
    cfg0, _ = load_config(cdir)
    tm = gt_landmarks(out, cfg0)
    print(f"true map: {len(tm)} landmarks triangulated from gt poses")
    est, diags = replay(out, cdir, overrides, collect_diag=True, true_map=tm)
    gt = os.path.join(out, "gt.txt")

    from uvio_jax.eval.traj import ate, load_tum
    tg, qg, pg = load_tum(gt)
    r_ours = ate(est[0], est[1], est[2], tg, qg, pg, method="se3")
    tr, qr, pr = load_tum(os.path.join(out, "ref_est.txt"))
    r_ref = ate(tr, qr, pr, tg, qg, pg, method="se3")
    print(f"[{args.tag}] ours ATE {float(r_ours['rmse_pos']):.4f} m / "
          f"{float(r_ours['rmse_ori_deg']):.3f} deg | "
          f"ref {float(r_ref['rmse_pos']):.4f} m / "
          f"{float(r_ref['rmse_ori_deg']):.3f} deg")

    # per-frame error curves, decimated
    t_t, e_t = per_frame_err(est, gt, "ours")
    t_r, e_r = per_frame_err((tr, qr, pr), gt, "ref")
    n = len(e_t)
    for i in range(0, n, max(1, n // 30)):
        d = diags[i] if i < len(diags) else {}
        print(f"  t={t_t[i]:.2f} ours_err={e_t[i]:.4f} "
              f"ref_err={e_r[min(i, len(e_r)-1)]:.4f} "
              f"n_slam={d.get('n_slam', '?')} msckf={d.get('msckf_used','?')} "
              f"lm_mean={d.get('lm_mean', float('nan')):.3f} "
              f"lm_max={d.get('lm_max', float('nan')):.3f}")


if __name__ == "__main__":
    main()
