"""EuRoC-format dataset reader.

Replaces the reference's ROS bag/subscriber ingestion with a plain
ASL-folder reader (`mav0/imu0/data.csv`, `mav0/cam0/data.csv` +
`data/<stamp>.png`, `mav0/state_groundtruth_estimate0/data.csv`) —
the standard EuRoC MAV / TUM-VI disk layout. Groundtruth loading also
accepts the reference's `ov_data` TUM text files
(`DatasetReader::load_gt_file` equivalent).
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, Optional, Tuple

import numpy as np


class EurocDataset:
    def __init__(self, root: str, cams=("cam0",), imu="imu0"):
        self.root = root
        mav = os.path.join(root, "mav0")
        if os.path.isdir(mav):
            self.base = mav
        else:
            self.base = root
        self.cams = list(cams)
        self.imu_rows = self._read_csv(
            os.path.join(self.base, imu, "data.csv"), numeric=True
        )
        self.cam_rows = {
            c: self._read_csv(os.path.join(self.base, c, "data.csv")) for c in self.cams
        }
        gt_path = os.path.join(self.base, "state_groundtruth_estimate0", "data.csv")
        self.gt_rows = (
            self._read_csv(gt_path, numeric=True) if os.path.exists(gt_path) else []
        )

    @staticmethod
    def _read_csv(path, numeric=False):
        if numeric:
            # native one-pass parser (uvio_jax/native/csv_loader.cpp) for
            # the all-numeric files (IMU, groundtruth); python fallback
            # below handles everything (incl. string filename columns)
            try:
                from ..native import load_csv

                arr = load_csv(path)
            except (FileNotFoundError, ValueError):
                arr = None
            if arr is not None and len(arr):
                return list(arr)
        rows = []
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                rows.append(row)
        return rows

    def imu(self) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
        """(t_s, gyro (3,), accel (3,)) — EuRoC column order w then a."""
        for r in self.imu_rows:
            t = float(r[0]) * 1e-9
            w = np.array([float(r[1]), float(r[2]), float(r[3])])
            a = np.array([float(r[4]), float(r[5]), float(r[6])])
            yield t, w, a

    def images(self, cam="cam0") -> Iterator[Tuple[float, str]]:
        """(t_s, image_path)."""
        for r in self.cam_rows[cam]:
            t = float(r[0]) * 1e-9
            yield t, os.path.join(self.base, cam, "data", r[1].strip())

    def groundtruth(self):
        """(t (N,), q_GtoI JPL (N,4), p (N,3), v (N,3), bg (N,3), ba (N,3)).

        EuRoC gt stores q_ItoG Hamilton [w,x,y,z]; converted to JPL
        q_GtoI [x,y,z,w] (same numbers, reordered — Hamilton q_ItoG and
        JPL q_GtoI represent the same rotation matrix mapping).
        """
        if not self.gt_rows:
            return None
        d = np.array([[float(x) for x in r] for r in self.gt_rows])
        t = d[:, 0] * 1e-9
        q_wxyz = d[:, 4:8]  # Hamilton q_ItoG (w,x,y,z)
        q_jpl = np.concatenate([q_wxyz[:, 1:4], q_wxyz[:, 0:1]], axis=1)
        return {
            "t": t,
            "q_GtoI": q_jpl,
            "p": d[:, 1:4],
            "v": d[:, 8:11],
            "bg": d[:, 11:14],
            "ba": d[:, 14:17],
        }


def run_euroc(dataset_root: str, config_dir: str, out_path: Optional[str] = None,
              max_frames: Optional[int] = None, use_klt: bool = True):
    """End-to-end EuRoC run: config + dataset -> TUM trajectory.

    Returns (t, q, p) arrays; writes TUM file if out_path given.
    (The `ros1_serial_msckf` deterministic offline equivalent.)
    """
    import cv2

    from ..frontend.tracker import KLTTracker
    from ..manager import VioManager
    from ..uwb_manager import UVioConfig, UVioManager
    from .config import load_config

    cfg, extras = load_config(config_dir)
    import dataclasses

    cfg = dataclasses.replace(cfg, use_static_init=True, use_dynamic_init=True)
    mgr = UVioManager(cfg) if isinstance(cfg, UVioConfig) else VioManager(cfg)
    ds = EurocDataset(dataset_root)
    trackers = [
        KLTTracker(
            c.intrinsics, c.model,
            num_features=extras["num_pts"],
            grid=(extras["grid_y"], extras["grid_x"]),
            fast_thresh=extras["fast_threshold"],
            cam_id=i,
        )
        for i, c in enumerate(cfg.cameras[:1])  # mono tracking (stereo rd 2)
    ]

    imu_it = ds.imu()
    img_it = ds.images("cam0")
    next_img = next(img_it, None)
    est_t, est_q, est_p = [], [], []
    frames = 0
    for (t, w, a) in imu_it:
        mgr.feed_imu(t, w, a)
        while next_img is not None and next_img[0] <= t:
            ti, path = next_img
            img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
            if img is not None:
                ids, uvs = trackers[0].feed(ti, img.astype(np.float32))
                mgr.feed_features(ti, [(ids, uvs)])
                if mgr.is_initialized:
                    est_t.append(ti)
                    est_q.append(np.asarray(mgr.state.q))
                    est_p.append(np.asarray(mgr.state.p))
                frames += 1
            next_img = next(img_it, None)
        if max_frames and frames >= max_frames:
            break
    out = (np.asarray(est_t), np.asarray(est_q), np.asarray(est_p))
    if out_path and len(est_t):
        from ..eval.traj import save_tum

        save_tum(out_path, *out)
    return out
