"""Pixels transfer mode must produce identical detections to the frames path."""

import numpy as np
import pytest

from ysmr_tpu.io.preproc import HostPreprocessor
from ysmr_tpu.ops import preprocess as pp
from ysmr_tpu.pipeline import detect as det
from ysmr_tpu.pipeline.detect_pixels import detect_from_pixels


def _settings(mode_val, white=True, lum=False):
    return {
        'white bacteria on dark background': white,
        'threshold offset for detection': 5,
        'adaptive double threshold': mode_val,
        'max detections per frame': 64,
        'connected components max iterations': 64,
        'include luminosity in tracking calculation': lum,
        'color filter': __import__('cv2').COLOR_BGR2GRAY,
        'max track slots': 64,
        'frames per second': 30.0,
    }


def _blob_frames(rng, t=4, h=96, w=128, n=10):
    import cv2
    frames = np.zeros((t, h, w, 3), np.uint8)
    for k in range(t):
        img = rng.normal(40, 4, (h, w)).clip(0, 255).astype(np.uint8)
        for i in range(n):
            cv2.ellipse(img, (int(rng.integers(8, w - 8)), int(rng.integers(8, h - 8))),
                        (4, 2), int(rng.integers(0, 180)), 0, 360, 200, -1)
        frames[k] = img[..., None]
    return frames


@pytest.mark.parametrize('mode_val', [2.0, 0.0, -1.0])
def test_pixels_equals_frames(rng, mode_val):
    settings = _settings(mode_val)
    frames = _blob_frames(rng)
    t, h, w, _ = frames.shape
    config = det.DetectorConfig(settings, 30.0)
    frame_valid = np.ones(t, bool)
    ts = pp.MovingAverageThreshold(30.0, config.offset, config.white_on_dark) \
        if config.mode == 'mean' else None
    ref = det.detect_batch(frames, frame_valid, config, threshold_state=ts)

    prep = HostPreprocessor(settings, 30.0, max_fg=4096)
    batches = [prep(f) for f in frames]
    # native preprocessor emits the packed uint32 wire format
    packed = np.stack([b['px_packed'] for b in batches])
    counts = np.array([b['count'] for b in batches], np.int32)
    got = detect_from_pixels(None, None, counts, None, frame_valid,
                             px_packed=packed,
                             h=h, w=w, double_threshold=(config.mode == 'adaptive_double'),
                             max_det=config.max_det, max_bh=config.max_bh,
                             cc_iters=config.cc_iters)
    assert np.array_equal(np.asarray(got['det_valid']), np.asarray(ref['det_valid']))
    np.testing.assert_allclose(np.asarray(got['det_xy']), np.asarray(ref['det_xy']),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(got['det_info']), np.asarray(ref['det_info']),
                               atol=1e-3)
    assert np.array_equal(np.asarray(got['n_components']),
                          np.asarray(ref['n_components']))


@pytest.mark.parametrize('mode_val', [2.0, 0.0])
@pytest.mark.parametrize('lum', [False, True])
def test_sorted_compaction_equals_default(rng, mode_val, lum):
    """The sorted-run compaction path (detect_pixels.py, sort_compact)
    must produce identical tables to the scatter/gather compaction,
    including luminosity sums and n_components."""
    settings = _settings(mode_val, lum=lum)
    frames = _blob_frames(rng)
    t, h, w, _ = frames.shape
    config = det.DetectorConfig(settings, 30.0)
    frame_valid = np.ones(t, bool)
    frame_valid[-1] = False  # padded tail frame
    prep = HostPreprocessor(settings, 30.0, max_fg=4096)
    batches = [prep(f) for f in frames]
    kw = dict(h=h, w=w, double_threshold=(config.mode == 'adaptive_double'),
              max_det=config.max_det, max_bh=config.max_bh,
              cc_iters=config.cc_iters, include_luminosity=lum)
    counts = np.array([b['count'] for b in batches], np.int32)
    if lum:
        # lum mode ships split coordinates + the full gray plane (the
        # rect-mean luminosity needs background pixels, ops/luminosity.py)
        args = (np.stack([b['px_x'] for b in batches]),
                np.stack([b['px_y'] for b in batches]), counts,
                np.stack([b['px_marker'] for b in batches]), frame_valid)
        kw['gray_frames'] = np.stack([b['gray'] for b in batches])
    else:
        args = (None, None, counts, None, frame_valid)
        kw['px_packed'] = np.stack([b['px_packed'] for b in batches])
    ref = detect_from_pixels(*args, **kw)
    got = detect_from_pixels(*args, sort_compact=True, **kw)
    assert np.array_equal(np.asarray(got['n_components']),
                          np.asarray(ref['n_components']))
    assert np.array_equal(np.asarray(got['det_valid']),
                          np.asarray(ref['det_valid']))
    np.testing.assert_allclose(np.asarray(got['det_xy']),
                               np.asarray(ref['det_xy']), atol=1e-4)
    np.testing.assert_allclose(np.asarray(got['det_info']),
                               np.asarray(ref['det_info']), atol=1e-3)


@pytest.mark.parametrize('mode_val', [2.0, 0.0])
def test_det_px_idx_and_skip_rect(rng, mode_val):
    """det_px_idx must map every kept wire pixel to its (reverse-raster)
    detection id identically on all three CC paths, and skip_rect must keep
    det_valid/n_components while feeding the host cv2-exact rect chain
    (native.cv2_rects_batch) reference-identical measurements."""
    import cv2

    from ysmr_tpu import native

    settings = _settings(mode_val)
    frames = _blob_frames(rng)
    t, h, w, _ = frames.shape
    config = det.DetectorConfig(settings, 30.0)
    frame_valid = np.ones(t, bool)
    prep = HostPreprocessor(settings, 30.0, max_fg=4096)
    batches = [prep(f) for f in frames]
    packed = np.stack([b['px_packed'] for b in batches])
    counts = np.array([b['count'] for b in batches], np.int32)
    kw = dict(h=h, w=w, double_threshold=(config.mode == 'adaptive_double'),
              max_det=config.max_det, max_bh=config.max_bh,
              cc_iters=config.cc_iters, px_packed=packed,
              return_det_px=True)
    full = detect_from_pixels(None, None, counts, None, frame_valid, **kw)
    det_px = np.asarray(full['det_px_idx'])

    # identical pixel->det mapping on the sorted-compaction and table paths
    srt = detect_from_pixels(None, None, counts, None, frame_valid,
                             sort_compact=True, **kw)
    tbl = detect_from_pixels(None, None, counts, None, frame_valid,
                             use_table=True, **kw)
    assert np.array_equal(np.asarray(srt['det_px_idx']), det_px)
    assert np.array_equal(np.asarray(tbl['det_px_idx']), det_px)

    # skip_rect: same validity/count, zeroed rects, same mapping
    skip = detect_from_pixels(None, None, counts, None, frame_valid,
                              skip_rect=True, **kw)
    assert np.array_equal(np.asarray(skip['det_px_idx']), det_px)
    assert np.array_equal(np.asarray(skip['det_valid']),
                          np.asarray(full['det_valid']))
    assert np.array_equal(np.asarray(skip['n_components']),
                          np.asarray(full['n_components']))
    assert not np.asarray(skip['det_xy']).any()

    # pixel sets grouped by det id == cv2 full-frame components in cv2's
    # findContours enumeration order (reverse raster), and the host rects
    # equal cv2.minAreaRect bit-for-bit
    if not native.available():
        pytest.skip('native library not built')
    rects, rvalid = native.cv2_rects_batch(packed, counts, det_px, w,
                                           config.max_det)
    assert np.array_equal(rvalid, np.asarray(full['det_valid']))
    for k in range(t):
        n_px = counts[k]
        lin = packed[k, :n_px] & 0x7FFFFFFF
        xs, ys = lin % w, lin // w
        ids = det_px[k, :n_px]
        mask = np.zeros((h, w), np.uint8)
        mask[ys[ids >= 0], xs[ids >= 0]] = 255
        contours, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        nc = int(np.asarray(full['n_components'])[k])
        assert len(contours) == nc
        lab = cv2.connectedComponents(mask, connectivity=8)[1]
        for d in range(nc):
            sel = ids == d
            assert sel.any()
            # one cv2 component per det id
            comp_labels = np.unique(lab[ys[sel], xs[sel]])
            assert len(comp_labels) == 1
            (cx, cy), (rw, rh), ang = cv2.minAreaRect(contours[d])
            got = rects[k, d]
            assert got[0] == np.float32(cx) and got[1] == np.float32(cy)
            assert got[2] == np.float32(rw) and got[3] == np.float32(rh)
            assert got[4] == np.float32(ang)
