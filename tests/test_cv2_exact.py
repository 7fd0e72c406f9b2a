#!/usr/bin/env python3
"""Bit-exactness tests for the cv2.minAreaRect replica (ops/cv2_exact.py).

Every comparison here is to the LAST BIT (uint32 views of the float32
outputs), against the actual installed cv2 — the same build the reference
pipeline uses. This is what makes reference-identical TRACK_ID numbering
possible (see STATUS.md).
"""
import numpy as np
import pytest

cv2 = pytest.importorskip('cv2')

from ysmr_tpu.ops import cv2_exact as cx


def _bits(v):
    return np.float32(v).view(np.uint32)


def _rect_bits(r):
    return (_bits(r[0][0]), _bits(r[0][1]), _bits(r[1][0]), _bits(r[1][1]),
            _bits(r[2]))


def _random_blob(rng, h=40, w=40):
    img = np.zeros((h, w), np.uint8)
    x, y = w // 2, h // 2
    for _ in range(int(rng.integers(1, 70))):
        img[y, x] = 1
        x = min(max(x + int(rng.integers(-1, 2)), 2), w - 3)
        y = min(max(y + int(rng.integers(-1, 2)), 2), h - 3)
    r = rng.random()
    if r < 0.3:
        img = cv2.dilate(img, np.ones((2, 2), np.uint8))
    elif r < 0.4:
        img = cv2.dilate(img, np.ones((3, 3), np.uint8))
    return img


def test_min_area_rect_bit_exact_random_point_sets():
    rng = np.random.default_rng(42)
    for _ in range(3000):
        n = int(rng.integers(1, 40))
        s = int(rng.integers(2, 60))
        pts = np.unique(rng.integers(0, s, size=(n, 2)), axis=0)
        ref = cv2.minAreaRect(pts.astype(np.int32))
        got = cx.min_area_rect_cv(
            [tuple(p) for p in pts.tolist()])
        # point sets (not contours): feed the same sequence to both
        assert _rect_bits(ref) == _rect_bits(got), pts.tolist()


def test_convex_hull_sequence_matches_cv2():
    rng = np.random.default_rng(3)
    for trial in range(4000):
        kind = trial % 3
        if kind == 0:
            n = int(rng.integers(1, 30))
            pts = rng.integers(0, int(rng.integers(2, 30)),
                               size=(n, 2)).tolist()
        elif kind == 1:
            x, y = 10, 10
            pts = []
            for _ in range(int(rng.integers(3, 25))):
                pts.append([x, y])
                x += int(rng.integers(-2, 3))
                y += int(rng.integers(-2, 3))
        else:
            x0, y0 = int(rng.integers(0, 9)), int(rng.integers(0, 9))
            dx, dy = int(rng.integers(-3, 4)), int(rng.integers(-3, 4))
            pts = [[x0 + k * dx, y0 + k * dy]
                   for k in range(int(rng.integers(2, 12)))]
        for cw in (False, True):
            ref = cv2.convexHull(np.asarray(pts, np.int32), clockwise=cw,
                                 returnPoints=True).reshape(-1, 2)
            idx = cx.convex_hull_cv(pts, clockwise=cw)
            got = np.asarray([pts[i] for i in idx], np.int32).reshape(-1, 2)
            assert np.array_equal(ref, got), (pts, cw)


def test_contour_trace_matches_find_contours():
    rng = np.random.default_rng(11)
    checked = 0
    for _ in range(500):
        h = int(rng.integers(3, 24))
        w = int(rng.integers(3, 24))
        img = (rng.random((h, w)) < rng.uniform(0.2, 0.7)).astype(np.uint8)
        pad = np.zeros((h + 2, w + 2), np.uint8)
        pad[1:-1, 1:-1] = img
        ref, _ = cv2.findContours(pad, cv2.RETR_EXTERNAL,
                                  cv2.CHAIN_APPROX_SIMPLE)
        refset = {tuple(map(tuple, c.reshape(-1, 2).tolist())) for c in ref}
        _, lbl = cv2.connectedComponents(pad, connectivity=8)
        got = set()
        seen = set()
        for y in range(pad.shape[0]):
            for x in range(pad.shape[1]):
                if pad[y, x] and lbl[y, x] not in seen:
                    seen.add(lbl[y, x])
                    got.add(tuple(cx.trace_contour(
                        (lbl == lbl[y, x]).astype(np.uint8), y, x)))
        # RETR_EXTERNAL drops components nested in another component's
        # hole; every cv2 contour must be reproduced exactly
        assert refset <= got
        checked += len(refset)
    assert checked > 1000


def test_full_chain_bit_exact_on_blobs():
    """Component pixels -> contour -> hull -> rect == cv2's own chain."""
    rng = np.random.default_rng(99)
    for trial in range(1500):
        img = _random_blob(rng)
        ys, xs = np.nonzero(img)
        ox = int(rng.integers(0, 1188))
        oy = int(rng.integers(0, 882))
        cont, _ = cv2.findContours(img, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
        assert len(cont) == 1
        c = cont[0].reshape(-1, 2) + np.array([ox, oy])
        ref = cv2.minAreaRect(c.astype(np.int32))
        got = cx.rect_from_component_pixels(xs + ox, ys + oy)
        assert _rect_bits(ref) == _rect_bits(got), trial


def test_degenerate_components():
    for pix in ([(5, 5)],                      # single pixel
                [(5, 5), (6, 5)],              # horizontal pair
                [(5, 5), (5, 6)],              # vertical pair
                [(5, 5), (6, 6)],              # diagonal pair
                [(5, 5), (6, 5), (7, 5)],      # horizontal run
                [(5, 5), (5, 6), (5, 7)],      # vertical run
                [(5, 5), (6, 6), (7, 7)]):     # diagonal run
        xs = np.array([p[0] for p in pix])
        ys = np.array([p[1] for p in pix])
        img = np.zeros((12, 12), np.uint8)
        img[ys, xs] = 1
        cont, _ = cv2.findContours(img, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
        ref = cv2.minAreaRect(cont[0])
        got = cx.rect_from_component_pixels(xs, ys)
        assert _rect_bits(ref) == _rect_bits(got), pix


# ---------------------------------------------------------------------------
# native C++ port (native/cv2_exact.cpp)
# ---------------------------------------------------------------------------

from ysmr_tpu import native


@pytest.mark.usefixtures('native_lib')
def test_native_single_matches_cv2():
    rng = np.random.default_rng(1234)
    for _ in range(5000):
        n = int(rng.integers(1, 40))
        s = int(rng.integers(2, 60))
        pts = np.unique(rng.integers(0, s, size=(n, 2)), axis=0)
        ref = cv2.minAreaRect(pts.astype(np.int32))
        got = native.cv2_min_area_rect_single(pts)
        assert got is not None
        assert _rect_bits(ref) == (_bits(got[0]), _bits(got[1]),
                                   _bits(got[2]), _bits(got[3]),
                                   _bits(got[4])), pts.tolist()


@pytest.mark.usefixtures('native_lib')
def test_native_batch_matches_cv2_full_chain():
    """Frame-batch API: packed pixels + det indices -> cv2-identical rects."""
    rng = np.random.default_rng(77)
    T, F, W, H, MAXD = 6, 4096, 640, 480, 32
    pp = np.zeros((T, F), np.uint32)
    di = np.full((T, F), -1, np.int16)
    counts = np.zeros(T, np.int32)
    refs = {}
    for ti in range(T):
        frame = np.zeros((H, W), np.uint8)
        n_blobs = int(rng.integers(1, MAXD))
        for _ in range(n_blobs):
            img = _random_blob(rng, 30, 30)
            oy = int(rng.integers(0, H - 40))
            ox = int(rng.integers(0, W - 40))
            frame[oy:oy + 30, ox:ox + 30] |= img
        cont, _ = cv2.findContours(frame, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
        # our det order convention: the pipeline already matches the
        # reference's enumeration; here we just build per-component buckets
        _, lbl = cv2.connectedComponents(frame, connectivity=8)
        ys, xs = np.nonzero(frame)
        order = np.lexsort((xs, ys))
        xs, ys = xs[order], ys[order]
        n = len(xs)
        if n > F:
            continue
        counts[ti] = n
        pp[ti, :n] = (ys.astype(np.uint32) * W + xs.astype(np.uint32))
        # map labels to det ids in first-appearance (raster) order
        lab_order = {}
        for la in lbl[ys, xs]:
            if la not in lab_order and len(lab_order) < MAXD:
                lab_order[la] = len(lab_order)
        di[ti, :n] = np.array([lab_order.get(la, -1)
                               for la in lbl[ys, xs]], np.int16)
        for c in cont:
            r = cv2.minAreaRect(c)
            cpts = c.reshape(-1, 2)
            la = lbl[cpts[0][1], cpts[0][0]]
            if la in lab_order:
                refs[(ti, lab_order[la])] = r
    out, valid = native.cv2_rects_batch(pp, counts, di, W, MAXD)
    checked = 0
    for (ti, d), r in refs.items():
        assert valid[ti, d]
        got = out[ti, d]
        assert _rect_bits(r) == (_bits(got[0]), _bits(got[1]), _bits(got[2]),
                                 _bits(got[3]), _bits(got[4])), (ti, d)
        checked += 1
    assert checked > 20
