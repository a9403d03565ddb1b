"""Replay a vendored recorded stream set through a manager.

A stream directory (`data/streams/{mono,stereo,uwb}`) holds what the
reference's head-to-head program dumped for one scenario: `imu.csv.gz`
(t, w, a), `cam.csv.gz` (t, cam, feature id, u, v), optionally
`uwb.csv.gz` (t, anchor id, range), the groundtruth init `init.txt`,
`gt.txt`, the reference estimator's own `ref_est.txt` and, for UWB,
`uwb_truth.csv` / `anchors_est.txt`. Replaying it with groundtruth init
is the deterministic regression the stream sets exist for.
"""

from __future__ import annotations

import os

import numpy as np


def replay(data_dir: str, cfg, mgr, feed_uwb: bool = False):
    """Feed the stream set in `data_dir` through `mgr` (built from
    `cfg`) in timestamp order, with groundtruth init. Each frame is
    dispatched once the next frame's stamp is reached (the one-frame
    camera buffering of the reference's replay).

    Returns (t (F,), q (F,4), p (F,3)): the state after each frame.
    """
    init = np.loadtxt(os.path.join(data_dir, "init.txt"))
    mgr.initialize_with_gt(init[0], init[1:5], init[5:8], init[8:11],
                           init[11:14], init[14:17])
    imu = np.loadtxt(os.path.join(data_dir, "imu.csv.gz"), delimiter=",")
    cam = np.loadtxt(os.path.join(data_dir, "cam.csv.gz"), delimiter=",")
    uwb_sets = []
    if feed_uwb:
        rows = np.loadtxt(os.path.join(data_dir, "uwb.csv.gz"), delimiter=",")
        tv, idx = np.unique(rows[:, 0], return_index=True)
        for t_u in tv[np.argsort(idx)]:
            rr = rows[rows[:, 0] == t_u]
            uwb_sets.append((float(t_u), {int(a): float(d) for a, d in rr[:, 1:3]}))
        uwb_sets.sort(key=lambda s: s[0])
    frames = []
    tv, idx = np.unique(cam[:, 0], return_index=True)
    for t in tv[np.argsort(idx)]:
        rc = cam[cam[:, 0] == t]
        per_cam = []
        for c in range(len(cfg.cameras)):
            r2 = rc[rc[:, 1] == c]
            per_cam.append((r2[:, 2].astype(np.int64), r2[:, 3:5]))
        frames.append((float(t), per_cam))
    frames.sort(key=lambda f: f[0])

    est_t, est_q, est_p = [], [], []
    fi = ui = 0
    dt_cam = float(getattr(cfg, "camimu_dt", 0.0))
    for k in range(imu.shape[0]):
        t = float(imu[k, 0])
        mgr.feed_imu(t, imu[k, 1:4], imu[k, 4:7])
        while ui < len(uwb_sets) and uwb_sets[ui][0] <= t - dt_cam:
            mgr.feed_uwb(uwb_sets[ui][0], uwb_sets[ui][1])
            ui += 1
        while fi + 1 < len(frames) and frames[fi + 1][0] <= t:
            ti, obs = frames[fi]
            if ti > float(init[0]):
                mgr.feed_features(ti, obs)
                est_t.append(float(mgr.state.time))
                est_q.append(np.asarray(mgr.state.q))
                est_p.append(np.asarray(mgr.state.p))
            fi += 1
    return np.asarray(est_t), np.asarray(est_q), np.asarray(est_p)


def ate_vs_reference(data_dir: str, est_t, est_q, est_p):
    """se3-aligned ATE of an estimate and of the reference's recorded
    `ref_est.txt`, both against `gt.txt`. Returns (ours, ref) dicts."""
    from .traj import ate, load_tum

    tg, qg, pg = load_tum(os.path.join(data_dir, "gt.txt"))
    ours = ate(est_t, est_q, est_p, tg, qg, pg, method="se3")
    tr, qr, pr = load_tum(os.path.join(data_dir, "ref_est.txt"))
    ref = ate(tr, qr, pr, tg, qg, pg, method="se3")
    return ours, ref


def anchor_rms_errors(data_dir: str, mgr):
    """RMS anchor-position error against `uwb_truth.csv`: of the
    manager's final anchor states, and of the reference's recorded
    final anchors (`anchors_est.txt`). Returns (ours, ref) in metres."""
    truth = {}
    with open(os.path.join(data_dir, "uwb_truth.csv")) as f:
        rows = f.read().strip().splitlines()[1:]
    for ln in rows:
        p = [float(x) for x in ln.split(",")]
        truth[int(p[0])] = np.asarray(p[1:4])
    ref_rows = np.atleast_2d(np.loadtxt(os.path.join(data_dir, "anchors_est.txt")))
    ref_err = np.sqrt(np.mean([
        np.linalg.norm(r[1:4] - truth[int(r[0])]) ** 2 for r in ref_rows
    ]))
    anchors_p = np.asarray(mgr.state.anchors_p)
    our_err = np.sqrt(np.mean([
        np.linalg.norm(anchors_p[slot] - truth[aid]) ** 2
        for aid, slot in mgr.anchor_slot_by_id.items()
    ]))
    return float(our_err), float(ref_err)
