"""ArUco tracker + histogram preprocessing tests (synthetic tag render)."""

import numpy as np

from uvio_jax.frontend.aruco import ARUCO_ID_BASE, ArucoTracker, histogram_equalize


def render_tag(tag_id=7, size=120, pos=(60, 40), img_hw=(240, 320)):
    import cv2

    d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_6X6_250)
    tag = cv2.aruco.generateImageMarker(d, tag_id, size)
    img = np.full(img_hw, 180, np.uint8)
    y, x = pos
    img[y : y + size, x : x + size] = tag
    return img


def test_aruco_detects_tag_corners():
    img = render_tag(tag_id=7)
    tr = ArucoTracker()
    ids, uvs = tr.feed(0.0, img)
    assert len(ids) == 4
    assert set(ids) == {ARUCO_ID_BASE + 4 * 7 + c for c in range(4)}
    # corners should bound the tag area (pos=(y=60, x=40), size 120)
    assert uvs[:, 0].min() >= 35 and uvs[:, 0].max() <= 165
    assert uvs[:, 1].min() >= 55 and uvs[:, 1].max() <= 185
    # persistent ids on a second frame (shifted tag)
    img2 = render_tag(tag_id=7, pos=(70, 50))
    ids2, uvs2 = tr.feed(0.1, img2)
    assert set(ids2) == set(ids)
    # no tag -> empty, no crash
    ids3, _ = tr.feed(0.2, np.full((240, 320), 128, np.uint8))
    assert len(ids3) == 0


def test_aruco_downsize():
    img = render_tag(tag_id=3, size=160)
    ids_full, uv_full = ArucoTracker().feed(0.0, img)
    ids_half, uv_half = ArucoTracker(downsize=True).feed(0.0, img)
    assert set(ids_full) == set(ids_half)
    m_full = {i: u for i, u in zip(ids_full, uv_full)}
    for i, u in zip(ids_half, uv_half):
        np.testing.assert_allclose(u, m_full[i], atol=2.0)  # half-res quantization


def test_histogram_equalize():
    rng = np.random.default_rng(0)
    img = (40 + 20 * rng.random((60, 80))).astype(np.float32)  # low contrast
    eq = histogram_equalize(img, "HISTOGRAM")
    assert eq.shape == img.shape
    assert eq.max() - eq.min() > 4 * (img.max() - img.min() - 1)
    clahe = histogram_equalize(img, "CLAHE")
    assert clahe.shape == img.shape
    none = histogram_equalize(img, "NONE")
    np.testing.assert_array_equal(none, img)
