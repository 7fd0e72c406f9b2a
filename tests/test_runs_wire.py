"""Run-length wire format: native/numpy encoder equivalence, roundtrip to
the pixel wire, device-side expansion equality in detect_from_pixels, and
pipeline-level row identity (reference wire contract: the pixel tables the
device sees are byte-identical to the pixel wire's, so every downstream
semantic — including the wire-order det_px_idx used by the cv2-exact host
rects — is unchanged)."""

import os

import numpy as np
import pandas as pd
import pytest

from ysmr_tpu import native


def _decode_runs(runs, nr):
    px = []
    for u in runs[:nr]:
        u = int(u)
        start = u & 0x3FFFFFF
        marker = (u >> 26) & 1
        ln = u >> 27
        for j in range(ln):
            px.append((start + j) | (marker << 31))
    return np.array(px, np.uint32)


def _random_wire(rng, t, f, h, w, n_blobs=25):
    packed = np.zeros((t, f), np.uint32)
    counts = np.zeros(t, np.int32)
    for ti in range(t):
        img = np.zeros((h, w), np.uint8)
        for _ in range(n_blobs):
            x0 = rng.integers(1, w - 8)
            y0 = rng.integers(1, h - 5)
            img[y0:y0 + rng.integers(2, 4), x0:x0 + rng.integers(2, 7)] = 1
        yy, xx = np.nonzero(img)
        lin = yy * w + xx
        mk = rng.random(len(lin)) < 0.5
        n = min(len(lin), f)
        packed[ti, :n] = lin[:n].astype(np.uint32) | \
            (mk[:n].astype(np.uint32) << 31)
        counts[ti] = n
    return packed, counts


def test_encoder_native_numpy_roundtrip():
    rng = np.random.default_rng(1)
    t, f = 7, 2048
    packed, counts = _random_wire(rng, t, f, 120, 160)
    runs_a = np.zeros((t, f), np.uint32)
    cnt_a = np.zeros(t, np.int32)
    runs_b = np.zeros((t, f), np.uint32)
    cnt_b = np.zeros(t, np.int32)
    rb = native.encode_runs_numpy(packed, counts, runs_b, cnt_b)
    if native.available():
        ra = native.encode_runs_batch(packed, counts, runs_a, cnt_a)
        assert ra == rb
        assert (cnt_a == cnt_b).all()
        for ti in range(t):
            assert (runs_a[ti, :cnt_a[ti]] == runs_b[ti, :cnt_b[ti]]).all()
    for ti in range(t):
        dec = _decode_runs(runs_b[ti], cnt_b[ti])
        assert len(dec) == counts[ti]
        assert (dec == packed[ti, :counts[ti]]).all()


def test_encoder_guards():
    packed = np.zeros((1, 64), np.uint32)
    packed[0, 0] = np.uint32(1 << 26)  # start beyond the 26-bit field
    counts = np.array([1], np.int32)
    out = np.zeros((1, 64), np.uint32)
    cnt = np.zeros(1, np.int32)
    assert native.encode_runs_numpy(packed, counts, out, cnt) == -2
    sparse = (np.arange(64, dtype=np.uint32) * 2)[None, :]  # 64 runs of 1
    assert native.encode_runs_numpy(sparse, np.array([64], np.int32),
                                    np.zeros((1, 8), np.uint32), cnt) == -1
    if native.available():
        assert native.encode_runs_batch(packed, counts, out, cnt) == -2
        assert native.encode_runs_batch(sparse, np.array([64], np.int32),
                                        np.zeros((1, 8), np.uint32),
                                        cnt) == -1


def test_detect_from_pixels_runs_equals_pixels():
    from ysmr_tpu.pipeline.detect_pixels import detect_from_pixels
    rng = np.random.default_rng(3)
    h, w, t, f = 120, 160, 6, 2048
    packed, counts = _random_wire(rng, t, f, h, w)
    runs = np.zeros((t, f), np.uint32)
    rcnt = np.zeros(t, np.int32)
    assert native.encode_runs_numpy(packed, counts, runs, rcnt) > 0
    fv = np.ones(t, bool)
    fv[-1] = False
    kw = dict(h=h, w=w, max_det=64, max_bh=16, cc_iters=32,
              include_luminosity=False)
    for dt in (True, False):
        for rdp in (False, True):
            a = detect_from_pixels(None, None, counts, None, fv,
                                   px_packed=packed, double_threshold=dt,
                                   return_det_px=rdp, **kw)
            b = detect_from_pixels(None, None, counts, None, fv,
                                   px_runs=runs[:, :512], run_counts=rcnt,
                                   expanded_f=f, double_threshold=dt,
                                   return_det_px=rdp, **kw)
            for key in a:
                assert np.array_equal(np.asarray(a[key]),
                                      np.asarray(b[key])), (dt, rdp, key)


@pytest.mark.e2e
def test_pipeline_runs_vs_pixels_rows(tmp_path):
    from tests.test_e2e_parity import make_synthetic_video, _make_settings
    from ysmr_tpu.pipeline.track_bacteria import track_bacteria
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=45)
    out = {}
    for fmt in ('pixels', 'runs'):
        for rects in (True, False):
            d = str(tmp_path / 'w{}{}'.format(fmt, rects))
            os.makedirs(d)
            s = _make_settings(tmp_path, **{'cv2 exact rects': rects})
            s['wire format'] = fmt
            res = track_bacteria(video, settings=dict(s), result_folder=d)
            assert res is not None
            out[(fmt, rects)] = res[0]
    for rects in (True, False):
        pd.testing.assert_frame_equal(out[('pixels', rects)],
                                      out[('runs', rects)])
