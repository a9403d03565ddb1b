"""Vision frontend tests: FAST, LK, RANSAC kernels and the tracker on
rendered simulator frames (the test_tracking.cpp analogue, with a
quantitative oracle instead of visual inspection)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uvio_jax.frontend.klt import (
    build_pyramid,
    fast_score,
    grid_detect,
    lk_track,
    ransac_fundamental,
)
from uvio_jax.frontend.tracker import KLTTracker

RNG = np.random.default_rng(8)


def blob_image(H=120, W=160, pts=None):
    img = np.full((H, W), 50.0, np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    if pts is None:
        pts = [(40.0, 30.0), (100.0, 80.0), (30.5, 90.25)]
    for (u, v) in pts:
        img += 200.0 * np.exp(-(((xx - u) ** 2 + (yy - v) ** 2) / (2 * 1.5**2)))
    return np.clip(img, 0, 255).astype(np.float32), pts


def test_fast_detects_blobs():
    img, pts = blob_image()
    score = np.asarray(fast_score(jnp.asarray(img), 15.0))
    for (u, v) in pts:
        patch = score[int(v) - 3 : int(v) + 4, int(u) - 3 : int(u) + 4]
        assert patch.max() > 0, (u, v)
    # flat regions produce no corners
    assert score[5:15, 120:150].max() == 0


def test_grid_detect_occupancy():
    img, pts = blob_image()
    score = fast_score(jnp.asarray(img), 15.0)
    uv, ok = grid_detect(score, 4, 4, jnp.zeros((1, 2)), jnp.zeros(1, bool))
    uv, okn = np.asarray(uv), np.asarray(ok)
    assert okn.sum() >= 3
    # occupy the cell of the first blob -> it must not be re-detected
    occ = jnp.asarray([[40.0, 30.0]])
    uv2, ok2 = grid_detect(score, 4, 4, occ, jnp.ones(1, bool))
    cell_w, cell_h = 160 // 4, 120 // 4
    for i in np.nonzero(np.asarray(ok2))[0]:
        cu, cv = np.asarray(uv2)[i]
        assert not (int(cv) // cell_h == 30 // cell_h and int(cu) // cell_w == 40 // cell_w)


def test_lk_recovers_translation():
    img1, pts = blob_image()
    shift = (3.6, -2.2)
    img2, _ = blob_image(pts=[(u + shift[0], v + shift[1]) for (u, v) in pts])
    pyr1 = build_pyramid(jnp.asarray(img1), 3)
    pyr2 = build_pyramid(jnp.asarray(img2), 3)
    uv0 = jnp.asarray(np.array(pts))
    uv1, ok = lk_track(pyr1, pyr2, uv0, jnp.ones(len(pts), bool), half=7)
    assert bool(jnp.all(ok))
    np.testing.assert_allclose(
        np.asarray(uv1), np.asarray(uv0) + np.asarray(shift), atol=0.15
    )


def test_ransac_rejects_outliers():
    N = 60
    # pure-rotation-free geometry: points on a plane, two views
    x1 = RNG.uniform(-0.4, 0.4, (N, 2))
    # simple epipolar geometry: translation along x => v2 = v1 (rectified)
    depth = RNG.uniform(3, 8, N)
    x2 = x1.copy()
    x2[:, 0] += 0.2 / depth  # disparity
    out_idx = RNG.choice(N, 12, replace=False)
    x2[out_idx] += RNG.uniform(0.05, 0.2, (12, 2)) * np.sign(RNG.standard_normal((12, 2)))
    inl = ransac_fundamental(
        jnp.asarray(x1), jnp.asarray(x2), jnp.ones(N, bool), jax.random.PRNGKey(1), 0.005
    )
    inl = np.asarray(inl)
    assert inl.sum() >= N - 20
    assert inl[out_idx].sum() <= 3


@pytest.mark.slow
def test_tracker_on_rendered_sim():
    from uvio_jax.sim import SimParams, Simulator, circle_trajectory

    sim = Simulator(
        SimParams(sim_freq_cam=10.0, num_pts=60, seed=3),
        trajectory=circle_trajectory(duration=12.0),
    )
    cam = sim.params.cameras[0]
    tracker = KLTTracker(cam.intrinsics, cam.model, num_features=120, grid=(6, 8))
    lengths = {}
    prev = {}
    drifts = []
    for i in range(12):
        rc = sim.get_next_cam()
        if rc is None:
            break
        t, _ = rc
        img = sim.render_image(t)
        ids, uvs = tracker.feed(t, img)
        assert len(ids) >= 20, f"frame {i}: too few tracks ({len(ids)})"
        for fid, uv in zip(ids, uvs):
            lengths[fid] = lengths.get(fid, 0) + 1
            if fid in prev:
                drifts.append(np.linalg.norm(uv - prev[fid]))
            prev[fid] = uv
    # tracks persist across frames
    assert max(lengths.values()) >= 8
    # motion is smooth: typical interframe displacement bounded
    assert np.median(drifts) < 30.0


def textured_image(H=160, W=200, shift=(0, 0), seed=4):
    """Deterministic smooth random texture (distinctive local patches,
    unlike identical Gaussian blobs which defeat the ratio test)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (H // 4 + 8, W // 4 + 8)).astype(np.float32)
    import jax.scipy.signal as jss

    up = np.kron(base, np.ones((4, 4), np.float32))
    # integer shift by rolling (subpixel handled by the matcher's patch)
    up = np.roll(up, (int(shift[1]), int(shift[0])), axis=(0, 1))
    return up[:H, :W]


def test_descriptor_matching():
    from uvio_jax.frontend.descriptor import describe, hamming_match

    img = textured_image()
    pts = [(60.0, 60.0), (140.0, 100.0), (90.0, 40.0)]
    uv = jnp.asarray(np.array(pts))
    d1, ok1 = describe(jnp.asarray(img), uv, jnp.ones(3, bool))
    assert bool(jnp.all(ok1))
    shift = (4, -3)
    img2 = textured_image(shift=shift)
    uv2 = uv + jnp.asarray(np.array(shift, np.float64))
    d2, ok2 = describe(jnp.asarray(img2), uv2, jnp.ones(3, bool))
    m = hamming_match(d1, ok1, d2, ok2)
    np.testing.assert_array_equal(np.asarray(m), [0, 1, 2])


@pytest.mark.slow
def test_descriptor_tracker_on_rendered_sim():
    from uvio_jax.frontend.descriptor import DescriptorTracker
    from uvio_jax.sim import SimParams, Simulator, circle_trajectory

    sim = Simulator(
        SimParams(sim_freq_cam=10.0, num_pts=60, seed=3),
        trajectory=circle_trajectory(duration=10.0),
    )
    cam = sim.params.cameras[0]
    tracker = DescriptorTracker(cam.intrinsics, cam.model, grid=(6, 8))
    lengths = {}
    for i in range(8):
        rc = sim.get_next_cam()
        if rc is None:
            break
        t, _ = rc
        img = sim.render_image(t)
        ids, uvs = tracker.feed(t, img)
        assert len(ids) >= 15, f"frame {i}: {len(ids)} tracks"
        for fid in ids:
            lengths[fid] = lengths.get(fid, 0) + 1
    assert max(lengths.values()) >= 6  # persistent tracks across frames


@pytest.mark.slow
def test_stereo_klt_on_rendered_sim():
    """Stereo matching: right-camera obs agree with the true disparity."""
    from uvio_jax.frontend.stereo import StereoKLTTracker
    from uvio_jax.sim import SimCamera, SimParams, Simulator, circle_trajectory

    cams = [SimCamera(), SimCamera(p_IinC=np.array([-0.11, 0.0, 0.0]))]
    sim = Simulator(
        SimParams(sim_freq_cam=10.0, num_pts=60, seed=3, cameras=cams),
        trajectory=circle_trajectory(duration=10.0),
    )
    tr = StereoKLTTracker(
        cams[0].intrinsics, cams[1].intrinsics, cams[0].model,
        num_features=120, grid=(6, 8),
    )
    matched = 0
    for i in range(5):
        rc = sim.get_next_cam()
        if rc is None:
            break
        t, _ = rc
        imgL = sim.render_image(t, cam_idx=0)
        imgR = sim.render_image(t, cam_idx=1)
        (idsL, uvL), (idsR, uvR) = tr.feed(t, imgL, imgR)
        if i == 0:
            continue  # first frame: detection only
        assert len(idsR) >= 10, f"frame {i}: only {len(idsR)} stereo matches"
        # disparity sanity: right-cam u should be shifted consistently
        # with the baseline (positive disparity for p_IinC.x < 0)
        mapL = {k: v for k, v in zip(idsL, uvL)}
        dus = [uvR[j][0] - mapL[idsR[j]][0] for j in range(len(idsR)) if idsR[j] in mapL]
        dus = np.asarray(dus)
        matched += len(dus)
        # baseline 0.11 m, depth 5-10 m, f=458 -> disparity ~ 5..10 px
        assert 2.0 < np.median(np.abs(dus)) < 20.0, np.median(dus)
    assert matched > 30


def test_hist_equalize_matches_cv2():
    """Device-side global equalization vs the reference's cv2 call
    (`TrackKLT.cpp:58-60`)."""
    import cv2
    import jax.numpy as jnp

    from uvio_jax.frontend.klt import hist_equalize

    rng = np.random.default_rng(0)
    # low-contrast image with structure
    img = (80 + 40 * rng.random((64, 96))).astype(np.float32)
    img[20:40, 30:60] += 25
    ours = np.asarray(hist_equalize(jnp.asarray(img)))
    ref = cv2.equalizeHist(np.clip(img, 0, 255).astype(np.uint8)).astype(np.float32)
    assert np.abs(ours - ref).max() <= 1.0 + 1e-6  # rounding-mode slack
    # contrast actually expands
    assert ours.std() > img.std()


def test_grid_detect_per_cell_topn():
    """per_cell>1 returns N distinct corners per free cell
    (`Grider_FAST.h:73` num-per-cell extraction)."""
    import jax.numpy as jnp

    from uvio_jax.frontend.klt import grid_detect

    score = np.zeros((32, 32), np.float32)
    # two strong separated corners in cell (0,0), one in cell (1,1)
    score[4, 4] = 10.0
    score[12, 12] = 8.0
    score[20, 24] = 5.0
    uv, valid = grid_detect(
        jnp.asarray(score), 2, 2, jnp.zeros((1, 2)), jnp.zeros(1, bool),
        per_cell=2,
    )
    uv, valid = np.asarray(uv), np.asarray(valid)
    got = {tuple(map(int, p)) for p in uv[valid]}
    assert (4, 4) in got and (12, 12) in got and (24, 20) in got
    assert valid.sum() == 3
    # adjacent duplicate pixels of one blob are suppressed
    score2 = np.zeros((32, 32), np.float32)
    score2[4, 4] = 10.0
    score2[4, 5] = 9.5
    _, valid2 = grid_detect(
        jnp.asarray(score2), 2, 2, jnp.zeros((1, 2)), jnp.zeros(1, bool),
        per_cell=2,
    )
    assert np.asarray(valid2).sum() == 1


def test_tracker_refills_after_mass_loss():
    """After wiping every track, one frame refills the tracker to (near)
    capacity — per-cell top-N detection (`Grider_FAST.h:73`), not one
    corner per cell per frame."""
    rng = np.random.default_rng(3)
    H, W = 240, 320
    img = np.full((H, W), 60.0, np.float32)
    # dense jittered dot grid: isolated bright pixels are ideal FAST-9
    # corners, one every ~7 px -> far more candidates than capacity
    for y0 in range(8, H - 8, 7):
        for x0 in range(8, W - 8, 7):
            y = y0 + int(rng.integers(-2, 3))
            x = x0 + int(rng.integers(-2, 3))
            img[y, x] = 230.0
    intr = np.array([200.0, 200.0, W / 2, H / 2, 0, 0, 0, 0])
    from uvio_jax.frontend.tracker import KLTTracker

    tr = KLTTracker(intr, num_features=120, grid=(5, 6), histeq="NONE")
    assert tr.per_cell >= 4
    tr.feed(0.0, img)
    full = int(tr.active.sum())  # best-case one-frame fill on this texture
    assert full >= 2 * 5 * 6, full  # > one corner per cell (old per_cell=1 cap)
    tr.feed(0.1, img)
    # mass track loss
    tr.active[:] = False
    tr.ids[:] = -1
    tr.feed(0.2, img)
    refilled = int(tr.active.sum())
    assert refilled >= 0.8 * full, (refilled, full)


def test_descriptor_rotation_invariance():
    """Steered BRIEF survives 30-45 deg in-plane rotation where the
    unsteered variant loses the match (TrackDescriptor's oriented ORB,
    `TrackDescriptor.cpp:355-478`)."""
    from scipy.ndimage import rotate as nd_rotate

    from uvio_jax.frontend.descriptor import describe, hamming_match

    rng = np.random.default_rng(5)
    H = W = 200
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    # smooth it a bit so rotation resampling is benign
    from scipy.ndimage import gaussian_filter

    img = gaussian_filter(img, 2.0) * 4
    c = np.array([100.0, 100.0])
    pts_src = np.array([[100.0, 100.0], [80.0, 120.0], [126.0, 88.0]])

    for deg in (30.0, 45.0):
        rot = nd_rotate(img, deg, reshape=False, order=1)
        th = np.radians(deg)
        # scipy rotates CCW about the center in array (row, col) space;
        # map source (x, y) -> rotated-image coordinates
        R = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
        pts_dst = (pts_src - c) @ R.T + c

        d1o, ok1 = describe(jnp.asarray(img), jnp.asarray(pts_src), jnp.ones(3, bool))
        d2o, ok2 = describe(jnp.asarray(rot), jnp.asarray(pts_dst), jnp.ones(3, bool))
        assert bool(jnp.all(ok1)) and bool(jnp.all(ok2))
        m_o = np.asarray(hamming_match(d1o, ok1, d2o, ok2))

        d1u, _ = describe(jnp.asarray(img), jnp.asarray(pts_src), jnp.ones(3, bool), oriented=False)
        d2u, _ = describe(jnp.asarray(rot), jnp.asarray(pts_dst), jnp.ones(3, bool), oriented=False)
        m_u = np.asarray(hamming_match(d1u, ok1, d2u, ok2))

        # orientation from intensity centroids is noisy on near-isotropic
        # patches, so demand a majority rather than perfection — and a
        # strict win over the unsteered variant at these angles
        n_o = (m_o == np.arange(3)).sum()
        n_u = (m_u == np.arange(3)).sum()
        assert n_o >= 2, (deg, m_o)
        assert n_o > n_u, (deg, m_o, m_u)


@pytest.mark.parametrize("n_free,n_det", [(0, 5), (3, 5), (6, 2), (10, 12)])
def test_refill_targets_rank_matching(n_free, n_det):
    """j-th valid detection -> j-th free slot; the rest fall out of range."""
    from uvio_jax.frontend.klt import refill_targets

    rng = np.random.default_rng(n_free * 31 + n_det)
    N, G = 10, 12
    free = np.zeros(N, bool)
    free[rng.choice(N, n_free, replace=False)] = True
    det_ok = np.zeros(G, bool)
    det_ok[rng.choice(G, n_det, replace=False)] = True
    tgt = np.asarray(refill_targets(jnp.asarray(free), jnp.asarray(det_ok)))
    free_slots = list(np.nonzero(free)[0])
    want = np.full(G, N + 1)
    for j, g in enumerate(np.nonzero(det_ok)[0]):
        if j < len(free_slots):
            want[g] = free_slots[j]
    np.testing.assert_array_equal(tgt, want)
