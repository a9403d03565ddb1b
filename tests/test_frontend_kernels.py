"""Frontend kernels (`klt.fast_score`, `klt.lk_level`) against
independent numpy references.

The references index with explicit slices and per-feature loops in
float64; the kernels run in float32 with rolls, vmaps and dynamic
slices. Tolerances follow from that: FAST scores sum up to 16 terms of
magnitude <= 255 (f32 rounding ~1e-4 there), LK positions agree to
1e-3 px after 10 Gauss-Newton steps.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from uvio_jax.frontend.klt import _CIRCLE, fast_score, lk_level


def fast_score_np(img, thresh):
    """FAST-9: a contiguous arc of >= 9 of the 16 circle pixels all
    brighter (or all darker) than the centre by more than `thresh`;
    score = sum over the circle of (|I_p - I_c| - t) where it exceeds t.
    Pixels within 3 px of the border score 0."""
    img = np.asarray(img, np.float64)
    H, W = img.shape
    c = img[3:H - 3, 3:W - 3]
    ring = np.stack([img[3 + dy:H - 3 + dy, 3 + dx:W - 3 + dx] for dy, dx in _CIRCLE])
    diff = ring - c[None]
    arc = np.zeros(c.shape, bool)
    for mask in (diff > thresh, diff < -thresh):
        for start in range(16):
            run = np.ones(c.shape, bool)
            for k in range(9):
                run &= mask[(start + k) % 16]
            arc |= run
    mag = np.where(np.abs(diff) > thresh, np.abs(diff) - thresh, 0.0).sum(0)
    out = np.zeros((H, W))
    out[3:H - 3, 3:W - 3] = np.where(arc, mag, 0.0)
    return out


def _patch_np(img, cx, cy, half):
    """Bilinear (2h+1)^2 window at a subpixel centre, or None when the
    (2h+2)^2 support leaves the image."""
    size = 2 * half + 1
    H, W = img.shape
    x0, y0 = int(np.floor(cx)) - half, int(np.floor(cy)) - half
    if x0 < 0 or y0 < 0 or x0 + size + 1 >= W or y0 + size + 1 >= H:
        return None
    fx, fy = cx - np.floor(cx), cy - np.floor(cy)
    b = img[y0:y0 + size + 1, x0:x0 + size + 1]
    top = b[:-1, :-1] * (1 - fx) + b[:-1, 1:] * fx
    bot = b[1:, :-1] * (1 - fx) + b[1:, 1:] * fx
    return top * (1 - fy) + bot * fy


def lk_level_np(img_prev, img_next, uv_prev, uv_guess, valid, half=7, iters=10,
                min_eig=25.0):
    """One LK level, one feature at a time: template gradients by central
    differences (zero on the window border), Gauss-Newton on the
    brightness residual; a feature fails when any window leaves the image,
    the gradient matrix is singular or its small eigenvalue < min_eig."""
    img_prev = np.asarray(img_prev, np.float64)
    img_next = np.asarray(img_next, np.float64)
    out = np.array(uv_guess, np.float64)
    ok = np.zeros(len(uv_prev), bool)
    for i, ((px, py), (gx0, gy0), v) in enumerate(zip(uv_prev, uv_guess, valid)):
        tmpl = _patch_np(img_prev, px, py, half)
        if tmpl is None:
            continue
        gx = np.zeros_like(tmpl)
        gy = np.zeros_like(tmpl)
        gx[:, 1:-1] = 0.5 * (tmpl[:, 2:] - tmpl[:, :-2])
        gy[1:-1, :] = 0.5 * (tmpl[2:, :] - tmpl[:-2, :])
        Gxx, Gxy, Gyy = (gx * gx).sum(), (gx * gy).sum(), (gy * gy).sum()
        det = Gxx * Gyy - Gxy**2
        eig = 0.5 * (Gxx + Gyy - np.sqrt((Gxx - Gyy) ** 2 + 4 * Gxy**2))
        p = np.array([gx0, gy0], np.float64)
        inside = True
        for _ in range(iters):
            cur = _patch_np(img_next, p[0], p[1], half)
            if cur is None:
                inside = False
                break
            if det > 1e-6:
                err = cur - tmpl
                bx, by = (gx * err).sum(), (gy * err).sum()
                p = p - np.array([Gyy * bx - Gxy * by, Gxx * by - Gxy * bx]) / det
        out[i] = p
        ok[i] = bool(v) and inside and det > 1e-6 and eig >= min_eig
    return out, ok


@pytest.mark.parametrize(
    "shape", [(64, 96), (100, 130), (128, 128), (480, 752), (65, 257)]
)
def test_fast_score_matches_numpy(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.uniform(0, 255, shape).astype(np.float32)
    a = np.asarray(fast_score(jnp.asarray(img), 20.0))
    b = fast_score_np(img, 20.0)
    assert np.abs(a - b).max() < 1e-3, np.abs(a - b).max()
    assert (b > 0).sum() > 0  # test images actually produce corners


def test_fast_score_threshold():
    """A synthetic bright dot must be detected at matching thresholds."""
    img = np.zeros((32, 128), np.float32)
    img[16, 64] = 200.0  # isolated bright pixel: ring all darker
    out = np.asarray(fast_score(jnp.asarray(img), 20.0))
    assert out[16, 64] > 0
    np.testing.assert_allclose(out, fast_score_np(img, 20.0), atol=1e-3)
    out_hi = np.asarray(fast_score(jnp.asarray(img), 250.0))
    assert out_hi[16, 64] == 0


def _lk_scene(seed=0, H=120, W=160, N=32, shift=(2, -1)):
    from scipy.signal import convolve2d

    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (H // 4 + 4, W // 4 + 4))
    img1 = np.kron(base, np.ones((4, 4)))[:H, :W]
    img1 = convolve2d(img1, np.ones((3, 3)) / 9, mode="same")
    img2 = np.roll(img1, (shift[1], shift[0]), axis=(0, 1))
    uv = np.stack([rng.uniform(20, W - 20, N), rng.uniform(20, H - 20, N)], 1)
    return img1.astype(np.float32), img2.astype(np.float32), uv.astype(np.float32)


def _lk_both(img1, img2, uv, valid):
    uv1, ok1 = lk_level(
        jnp.asarray(img1), jnp.asarray(img2), jnp.asarray(uv),
        jnp.asarray(uv), jnp.asarray(valid),
    )
    uv2, ok2 = lk_level_np(img1, img2, uv, uv, valid)
    return np.asarray(uv1), np.asarray(ok1), uv2, ok2


def test_lk_level_matches_numpy():
    """Identical ok masks, sub-1e-3-px agreement, true flow recovered."""
    img1, img2, uv = _lk_scene()
    valid = np.ones(len(uv), bool)
    uv1, ok1, uv2, ok2 = _lk_both(img1, img2, uv, valid)
    assert (ok1 == ok2).all()
    assert ok1.sum() >= 24
    assert np.abs(uv1[ok1] - uv2[ok1]).max() < 1e-3
    flow = np.median(uv1[ok1] - uv[ok1], axis=0)
    np.testing.assert_allclose(flow, [2.0, -1.0], atol=0.05)


@pytest.mark.parametrize(
    "H,W",
    [
        (30, 160),   # level shorter than a 40-row search window
                     # (e.g. top pyramid level of a 240-row image)
        (34, 160),   # H % 8 == 2
        (370, 256),  # H % 8 == 2 at full-image scale, bottom-edge features
    ],
)
def test_lk_level_short_and_unaligned_heights(H, W):
    """Features on the bottom edge of the valid window range: the clipped
    dynamic slice must neither read out of range nor accept a feature
    whose window leaves the image."""
    img1, img2, _ = _lk_scene(seed=H, H=max(H, 48), W=W, N=4, shift=(1, 1))
    img1, img2 = img1[:H], img2[:H]
    rng = np.random.default_rng(H)
    uv = np.stack(
        [rng.uniform(20, W - 20, 16), np.linspace(H - 10.0, H - 9.0, 16)], 1
    ).astype(np.float32)
    valid = np.ones(len(uv), bool)
    uv1, ok1, uv2, ok2 = _lk_both(img1, img2, uv, valid)
    assert not np.isnan(uv1).any()
    assert (ok1 == ok2).all()
    if ok1.any():
        assert np.abs(uv1[ok1] - uv2[ok1]).max() < 1e-3


def test_lk_level_border_and_invalid():
    """Features near borders fail cleanly; invalid stay invalid."""
    img1, img2, uv = _lk_scene()
    uv[0] = (2.0, 2.0)      # template window out of bounds
    uv[1] = (157.0, 117.0)  # bottom-right corner
    valid = np.ones(len(uv), bool)
    valid[2] = False
    uv1, ok1, _, ok2 = _lk_both(img1, img2, uv, valid)
    assert not ok1[0] and not ok1[1] and not ok1[2]
    assert (ok1 == ok2).all()
