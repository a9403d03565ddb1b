"""Vision frontend kernels: FAST detection, pyramidal LK tracking,
fundamental-matrix RANSAC — batched JAX, one path on every backend.

Array re-design of `ov_core/src/track/TrackKLT.{h,cpp}` +
`Grider_FAST/Grider_GRID`:

  * grid-bucketed corner detection: FAST-9 corner scores computed for
    every pixel (vectorized circle test), then a per-grid-cell argmax
    with occupancy masking replaces the reference's per-cell OpenCV
    FAST + min-px-dist suppression (`TrackKLT.cpp:395-528`);
  * pyramidal Lucas-Kanade with fixed iteration counts and validity
    masks instead of OpenCV `calcOpticalFlowPyrLK` (`TrackKLT.cpp:858`);
  * 8-point fundamental-matrix RANSAC with a fixed hypothesis count and
    best-hypothesis selection replaces `cv::findFundamentalMat`
    (`TrackKLT.cpp:873`), with the same normalized-coordinate threshold
    convention (2.0/max_focallength).

Images are float32 (H,W) in [0,255]. All shapes static.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# image preprocessing
# ---------------------------------------------------------------------------


def hist_equalize(img: jnp.ndarray) -> jnp.ndarray:
    """Global histogram equalization, jit-safe (the reference calls
    `cv2::equalizeHist` on every frame before tracking,
    `TrackKLT.cpp:58-60`; here it fuses into the device step).

    img float32 (H,W) in [0,255]; same output convention."""
    u8 = jnp.clip(img, 0.0, 255.0).astype(jnp.int32)
    # one-hot formulation: 256 fused compare/reduce passes instead of a
    # scatter-add histogram and a LUT gather (identical output); not yet
    # timed against the scatter form on the GPU
    vals = jnp.arange(256, dtype=jnp.int32)
    eq = u8[None, :, :] == vals[:, None, None]  # (256,H,W)
    hist = jnp.sum(eq, axis=(1, 2), dtype=jnp.int32)
    cdf = jnp.cumsum(hist)
    # cv2 semantics: lut(v) = round((cdf(v) - cdf_min) / (N - cdf_min) * 255)
    # with cdf_min the first nonzero bin's cdf
    nz = hist > 0
    cdf_min = jnp.min(jnp.where(nz, cdf, jnp.iinfo(jnp.int32).max))
    denom = jnp.maximum(u8.size - cdf_min, 1)
    lut = jnp.round((cdf - cdf_min).astype(jnp.float32) / denom * 255.0)
    lut = jnp.clip(lut, 0.0, 255.0)
    return jnp.sum(eq * lut[:, None, None], axis=0)


# ---------------------------------------------------------------------------
# FAST corner scoring
# ---------------------------------------------------------------------------

# Bresenham circle of radius 3 (OpenCV FAST-16 layout), python ints so
# the scoring loop unrolls statically under jit
_CIRCLE = [
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
]


def fast_score(img: jnp.ndarray, thresh: float = 20.0) -> jnp.ndarray:
    """FAST-9 corner score per pixel (0 where not a corner).

    16 shifted copies, arc contiguity via rolled boolean ANDs; XLA fuses
    the rolls and tests into one elementwise pass over the image.

    Score = sum over the contiguous arc of |I_c - I_p| - t (OpenCV-like
    magnitude).
    """
    H, W = img.shape
    center = img
    shifted = []
    for dy, dx in _CIRCLE:
        shifted.append(jnp.roll(img, (-dy, -dx), axis=(0, 1)))
    ring = jnp.stack(shifted)  # (16,H,W)
    diff = ring - center[None]
    brighter = diff > thresh
    darker = diff < -thresh

    def arc9(mask):
        # contiguous run of >=9: AND of 9 consecutive rotations
        acc = mask
        for r in range(1, 9):
            acc = acc & jnp.roll(mask, -r, axis=0)
        return jnp.any(acc, axis=0)

    is_corner = arc9(brighter) | arc9(darker)
    mag = jnp.sum(jnp.where(brighter | darker, jnp.abs(diff) - thresh, 0.0), axis=0)
    score = jnp.where(is_corner, mag, 0.0)
    # kill borders (circle reads wrap via roll)
    score = score.at[:3, :].set(0).at[-3:, :].set(0)
    score = score.at[:, :3].set(0).at[:, -3:].set(0)
    return score


def grid_detect(
    score: jnp.ndarray,
    grid_y: int,
    grid_x: int,
    occupied_uv: jnp.ndarray,
    occupied_mask: jnp.ndarray,
    min_score: float = 1e-3,
    per_cell: int = 1,
):
    """Top-N corners per free grid cell (Grider_GRID semantics; the
    reference extracts `num_features/grid` corners per cell,
    `Grider_FAST.h:73`).

    occupied_uv (N,2) current feature pixels; cells containing an active
    feature are skipped (the reference's per-cell occupancy check).
    Returns (uv (grid_y*grid_x*per_cell, 2) float,
    valid (grid_y*grid_x*per_cell,)).
    """
    H, W = score.shape
    ch, cw = H // grid_y, W // grid_x
    crop = score[: ch * grid_y, : cw * grid_x]
    cells = crop.reshape(grid_y, ch, grid_x, cw).transpose(0, 2, 1, 3).reshape(
        grid_y * grid_x, ch * cw
    )
    best_score, best = jax.lax.top_k(cells, per_cell)  # (G, per_cell)
    cy = best // cw
    cx = best % cw
    gy = (jnp.arange(grid_y * grid_x) // grid_x)[:, None]
    gx = (jnp.arange(grid_y * grid_x) % grid_x)[:, None]
    uv = jnp.stack([gx * cw + cx, gy * ch + cy], axis=-1).astype(score.dtype)

    # occupancy: mark cells containing an active feature
    occ_cell = (
        jnp.clip(occupied_uv[:, 1].astype(jnp.int32) // ch, 0, grid_y - 1) * grid_x
        + jnp.clip(occupied_uv[:, 0].astype(jnp.int32) // cw, 0, grid_x - 1)
    )
    # several features share a cell: `max` is an order-free "any" (a
    # `set` with duplicate indices has no defined winner on the GPU)
    occ = jnp.zeros((grid_y * grid_x,), jnp.int32).at[occ_cell].max(
        occupied_mask.astype(jnp.int32), mode="drop"
    ) > 0
    valid = (best_score > min_score) & ~occ[:, None]
    if per_cell > 1:
        # min-px-dist suppression inside a cell (Grider_FAST's mask
        # check): drop a pick within 2 px Chebyshev of a higher-ranked
        # one — top_k otherwise returns adjacent pixels of one blob
        dyy = jnp.abs(cy[:, :, None] - cy[:, None, :])
        dxx = jnp.abs(cx[:, :, None] - cx[:, None, :])
        close = (dyy <= 2) & (dxx <= 2)
        higher = jnp.tril(jnp.ones((per_cell, per_cell), bool), -1)
        valid = valid & ~jnp.any(close & higher[None], axis=-1)
    G = grid_y * grid_x
    return uv.reshape(G * per_cell, 2), valid.reshape(G * per_cell)


def refill_targets(free: jnp.ndarray, det_ok: jnp.ndarray) -> jnp.ndarray:
    """Slot for each detection when refilling a fixed track pool: the
    j-th valid detection goes to the j-th free slot (rank matching via
    cumsum + one scatter). Detections without a slot get N + 1 (out of
    range, so `.at[tgt].set(..., mode="drop")` ignores them).

    free (N,) bool, det_ok (G,) bool -> (G,) int32."""
    N = free.shape[0]
    free_rank = jnp.cumsum(free) - 1  # (N,) rank among free slots
    det_rank = jnp.cumsum(det_ok) - 1  # (G,) rank among detections
    # occupied slots write out of range and are dropped (clipping them
    # onto one sentinel index would leave its winner undefined)
    slot_rank = jnp.where(free, free_rank, N + 2)
    slot_of_rank = jnp.full((N + 2,), N + 1, jnp.int32).at[slot_rank].set(
        jnp.arange(N, dtype=jnp.int32), mode="drop"
    )
    return jnp.where(det_ok, slot_of_rank[jnp.clip(det_rank, 0, N + 1)], N + 1)


# ---------------------------------------------------------------------------
# image pyramid + Lucas-Kanade
# ---------------------------------------------------------------------------


def build_pyramid(img: jnp.ndarray, levels: int):
    """2x average-pool pyramid, level 0 = full resolution."""
    pyr = [img]
    for _ in range(levels - 1):
        im = pyr[-1]
        H, W = im.shape
        im = im[: H - H % 2, : W - W % 2]
        s = jax.lax.reduce_window(im, 0.0, jax.lax.add, (2, 2), (2, 2), "VALID")
        pyr.append(0.25 * s)
    return pyr


def _bilinear_patch(img, center, half):
    """Extract a (2*half+1)^2 patch at subpixel center via bilinear
    interpolation (dynamic_slice + fractional blend)."""
    size = 2 * half + 1
    cx, cy = center[0], center[1]
    x0 = jnp.floor(cx).astype(jnp.int32) - half
    y0 = jnp.floor(cy).astype(jnp.int32) - half
    fx = cx - jnp.floor(cx)
    fy = cy - jnp.floor(cy)
    H, W = img.shape
    x0c = jnp.clip(x0, 0, W - size - 1)
    y0c = jnp.clip(y0, 0, H - size - 1)
    block = jax.lax.dynamic_slice(img, (y0c, x0c), (size + 1, size + 1))
    top = block[:-1, :-1] * (1 - fx) + block[:-1, 1:] * fx
    bot = block[1:, :-1] * (1 - fx) + block[1:, 1:] * fx
    patch = top * (1 - fy) + bot * fy
    in_bounds = (x0 >= 0) & (y0 >= 0) & (x0 + size + 1 < W) & (y0 + size + 1 < H)
    return patch, in_bounds


def lk_level(img_prev, img_next, uv_prev, uv_guess, valid, half=7, iters=10, min_eig=25.0):
    """One pyramid level of LK for a feature batch.

    uv_prev (N,2) positions in img_prev; uv_guess (N,2) initial guesses
    in img_next. Returns (uv_new (N,2), ok (N,)).
    """

    def one(p_prev, p_guess, v):
        tmpl, ok0 = _bilinear_patch(img_prev, p_prev, half)
        # spatial gradients of the template (central differences)
        gx = 0.5 * (jnp.roll(tmpl, -1, 1) - jnp.roll(tmpl, 1, 1))
        gy = 0.5 * (jnp.roll(tmpl, -1, 0) - jnp.roll(tmpl, 1, 0))
        gx = gx.at[:, 0].set(0).at[:, -1].set(0)
        gy = gy.at[0, :].set(0).at[-1, :].set(0)
        Gxx = jnp.sum(gx * gx)
        Gxy = jnp.sum(gx * gy)
        Gyy = jnp.sum(gy * gy)
        det = Gxx * Gyy - Gxy * Gxy
        eig = 0.5 * (Gxx + Gyy - jnp.sqrt((Gxx - Gyy) ** 2 + 4 * Gxy**2))
        good = det > 1e-6

        def body(_, carry):
            p, okc = carry
            cur, okp = _bilinear_patch(img_next, p, half)
            err = cur - tmpl
            bx = jnp.sum(gx * err)
            by = jnp.sum(gy * err)
            safe_det = jnp.where(good, det, 1.0)
            dx = (Gyy * bx - Gxy * by) / safe_det
            dy = (Gxx * by - Gxy * bx) / safe_det
            p_new = p - jnp.stack([dx, dy])
            return jnp.where(good & okp, p_new, p), okc & okp

        p_final, ok_iter = jax.lax.fori_loop(0, iters, body, (p_guess, ok0))
        # eigenvalue quality gate (cv::goodFeatures-style threshold);
        # coarse levels pass min_eig=0 — they only seed the guess
        ok = v & ok0 & ok_iter & good & (eig >= min_eig)
        return p_final, ok

    return jax.vmap(one)(uv_prev, uv_guess, valid)


def lk_track(pyr_prev, pyr_next, uv_prev, valid, half=7, iters=10,
             coarse_iters=6):
    """Full pyramidal LK: coarse-to-fine with scaled guesses.

    pyr_*: lists from build_pyramid. uv_prev (N,2) level-0 pixels.

    Upper pyramid levels run `coarse_iters` iterations: their residual
    motion after the scaled guess is sub-pixel and Gauss-Newton on the
    quadratic patch model converges in a few steps (OpenCV's
    eps-criterion terminates there just as early); only level 0 runs
    the full `iters` for the final sub-pixel polish.
    """
    L = len(pyr_prev)
    scale = 2.0 ** (L - 1)
    guess = uv_prev / scale
    ok = valid
    for lev in range(L - 1, -1, -1):
        s = 2.0**lev
        uv_l = uv_prev / s
        guess, ok_l = lk_level(
            pyr_prev[lev], pyr_next[lev], uv_l, guess, valid, half,
            iters if lev == 0 else min(iters, coarse_iters),
            25.0 if lev == 0 else 0.0,
        )
        if lev == 0:
            ok = ok & ok_l
        if lev > 0:
            guess = guess * 2.0
    return guess, ok


# ---------------------------------------------------------------------------
# RANSAC (8-point fundamental matrix)
# ---------------------------------------------------------------------------


def _fundamental_8pt(x1, x2):
    """F from 8 normalized correspondences (x (8,2) each)."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, jnp.ones_like(u1)],
        axis=1,
    )
    # nullspace via eigh of A^T A (smallest eigenvector)
    AtA = A.T @ A
    w, V = jnp.linalg.eigh(AtA)
    f = V[:, 0]
    return f.reshape(3, 3)


def _sampson(F, x1, x2):
    ones = jnp.ones((x1.shape[0], 1), x1.dtype)
    X1 = jnp.concatenate([x1, ones], axis=1)
    X2 = jnp.concatenate([x2, ones], axis=1)
    Fx1 = X1 @ F.T
    Ftx2 = X2 @ F
    num = jnp.sum(X2 * Fx1, axis=1) ** 2
    den = Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2
    return num / jnp.maximum(den, 1e-12)


def ransac_fundamental(
    uvn1: jnp.ndarray,
    uvn2: jnp.ndarray,
    valid: jnp.ndarray,
    key: jnp.ndarray,
    thresh: float,
    n_hyp: int = 64,
):
    """Masked batched RANSAC in normalized coordinates.

    Returns inlier mask (N,). Fixed hypothesis count, best-by-inliers
    selection (replaces cv::findFundamentalMat's adaptive loop).
    """
    N = uvn1.shape[0]
    n_valid = jnp.sum(valid)
    # sample among valid indices (with replacement on the weight vector)
    w = valid.astype(jnp.float32) + 1e-9
    idx = jax.random.categorical(
        key, jnp.log(w)[None, None, :].repeat(n_hyp, 0).repeat(8, 1), axis=-1
    )  # (n_hyp, 8)

    def hyp(sample_idx):
        F = _fundamental_8pt(uvn1[sample_idx], uvn2[sample_idx])
        d = _sampson(F, uvn1, uvn2)
        inl = (d < thresh**2) & valid
        return jnp.sum(inl), inl

    counts, masks = jax.vmap(hyp)(idx)
    best = jnp.argmax(counts)
    inliers = masks[best]
    # degenerate protection: if too few valid points, keep all valid
    return jnp.where(n_valid >= 12, inliers, valid)
