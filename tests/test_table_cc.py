"""Sparse table-based connected components (ops/labeling.py).

label_components_table / compact_labels_table must be exactly equal to the
whole-frame image path for any pixel set; detect_from_pixels(use_table=True)
must be exactly equal to the image path end to end. The table path is an
opt-in ('use table cc').
"""

import numpy as np
import pytest


def _random_blob_tables(rng, b, f, h, w, n_blobs=40):
    px_x = np.zeros((b, f), np.int16)
    px_y = np.zeros((b, f), np.int16)
    counts = np.zeros(b, np.int32)
    marker = np.zeros((b, f), np.uint8)
    for i in range(b):
        m = np.zeros((h, w), bool)
        for cx, cy in zip(rng.integers(2, w - 8, n_blobs),
                          rng.integers(2, h - 6, n_blobs)):
            m[cy:cy + rng.integers(2, 5), cx:cx + rng.integers(2, 7)] = True
        ys, xs = np.nonzero(m)
        n = min(len(xs), f)
        px_x[i, :n] = xs[:n]
        px_y[i, :n] = ys[:n]
        counts[i] = n
        marker[i, :n] = rng.random(n) < 0.3
    return px_x, px_y, counts, marker


def test_table_labels_match_image_labels():
    from ysmr_tpu.ops import labeling as lb
    rng = np.random.default_rng(3)
    h, w = 64, 96
    mask = rng.random((h, w)) < 0.25
    ys, xs = np.nonzero(mask)
    f = 2048
    assert len(xs) <= f
    lin = np.full(f, 0, np.int32)
    valid = np.zeros(f, bool)
    lin[:len(xs)] = ys * w + xs
    valid[:len(xs)] = True
    for conn in (4, 8):
        img_labels = np.asarray(lb.label_components(mask, connectivity=conn))
        tab_labels = np.asarray(lb.label_components_table(
            lin, valid, w=w, connectivity=conn, max_iters=64))
        expect = img_labels.reshape(-1)[lin[:len(xs)]]
        np.testing.assert_array_equal(tab_labels[:len(xs)], expect,
                                      err_msg='conn={}'.format(conn))
        assert (tab_labels[len(xs):] == 2 ** 30).all()


@pytest.mark.parametrize('double_threshold', [False, True])
def test_detect_table_equals_image_path(double_threshold):
    from ysmr_tpu.pipeline.detect_pixels import detect_from_pixels
    rng = np.random.default_rng(1)
    b, f, h, w = 4, 2048, 96, 128
    px_x, px_y, counts, marker = _random_blob_tables(rng, b, f, h, w)
    fv = np.ones(b, bool)
    kw = dict(h=h, w=w, max_det=64, max_bh=96, cc_iters=64,
              include_luminosity=False, px_gray=None,
              double_threshold=double_threshold)
    img = detect_from_pixels(px_x, px_y, counts, marker, fv,
                             use_table=False, **kw)
    tab = detect_from_pixels(px_x, px_y, counts, marker, fv,
                             use_table=True, **kw)
    for key in ('det_xy', 'det_info', 'det_valid', 'n_components'):
        np.testing.assert_array_equal(np.asarray(img[key]),
                                      np.asarray(tab[key]), err_msg=key)
