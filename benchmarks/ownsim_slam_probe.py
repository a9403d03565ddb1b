#!/usr/bin/env python
"""Probe: own-sim ATE with/without SLAM across seeds."""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import numpy as np  # noqa: E402

from uvio_jax.eval import ate  # noqa: E402

sys.path.insert(0, os.path.join(REPO, "tests"))
import importlib.util  # noqa: E402

spec = importlib.util.spec_from_file_location(
    "t", os.path.join(REPO, "tests", "test_sim_e2e.py")
)
t = importlib.util.module_from_spec(spec)
spec.loader.exec_module(t)

for seed in [int(s) for s in (sys.argv[1:] or [7, 11, 23, 42])]:
    e0, g0 = t.run_sim(max_slam=0, seed=seed)
    r0 = ate(e0["t"], e0["q"], e0["p"], e0["t"], g0["q"], g0["p"], method="none")
    e1, g1 = t.run_sim(max_slam=20, seed=seed)
    r1 = ate(e1["t"], e1["q"], e1["p"], e1["t"], g1["q"], g1["p"], method="none")
    print(
        f"seed={seed}: noslam pos={r0['rmse_pos']:.4f} ori={r0['rmse_ori_deg']:.4f} | "
        f"slam pos={r1['rmse_pos']:.4f} ori={r1['rmse_ori_deg']:.4f} | "
        f"ratio={r1['rmse_pos'] / r0['rmse_pos']:.3f}",
        flush=True,
    )
