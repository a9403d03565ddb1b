"""Run the estimator on a EuRoC/TUM-VI ASL-format dataset folder.

The `ros1_serial_msckf` equivalent: deterministic offline processing of
a recorded sequence with a reference-style config directory, recording
a TUM trajectory and (if groundtruth is present) printing ATE/RPE.

Usage:
    python examples/run_euroc.py <dataset_root> <config_dir> \
        [--out est.txt] [--max-frames N]

(No dataset images ship in this environment; this entrypoint is for
users with EuRoC/TUM-VI/UVIO recordings on disk.)
"""

import argparse
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset_root")
    ap.add_argument("config_dir")
    ap.add_argument("--out", default="est.txt")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--align", default="se3", choices=["none", "posyaw", "se3", "sim3"])
    args = ap.parse_args()

    import numpy as np

    import uvio_jax  # noqa: F401
    from uvio_jax.utils.euroc import EurocDataset, run_euroc

    t, q, p = run_euroc(
        args.dataset_root, args.config_dir, out_path=args.out,
        max_frames=args.max_frames,
    )
    print(f"processed {len(t)} frames -> {args.out}")
    ds = EurocDataset(args.dataset_root)
    gt = ds.groundtruth()
    if gt is not None and len(t):
        from uvio_jax.eval import ate

        res = ate(t, q, p, gt["t"], gt["q_GtoI"], gt["p"], method=args.align)
        print(
            f"ATE ({args.align}): rmse_pos = {res['rmse_pos']:.4f} m | "
            f"rmse_ori = {res['rmse_ori_deg']:.4f} deg | n = {res['n']}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
