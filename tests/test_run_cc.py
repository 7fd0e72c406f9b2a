#!/usr/bin/env python3
"""Run-graph connected components (ops/run_cc.py) vs scipy ground truth.

The run wire is produced by the real encoder (native / numpy fallback), so
these tests also cover the wire-format invariants the device CC relies on
(row-bounded runs, marker splits, 31-pixel splits).
"""

import numpy as np
import pytest
from scipy import ndimage

from ysmr_tpu import native
from ysmr_tpu.ops import run_cc


def _encode(img, marker=None, w=None, r=1024):
    """Mask (+ optional marker subset) -> run wire via the numpy encoder."""
    h, width = img.shape
    w = width if w is None else w
    yy, xx = np.nonzero(img)
    lin = (yy * w + xx).astype(np.uint32)
    mk = np.zeros(len(yy), np.uint32)
    if marker is not None:
        mk = (marker[yy, xx] > 0).astype(np.uint32)
    packed = (lin | (mk << 31)).astype(np.uint32)[None, :]
    f = max(packed.shape[1], 4)
    buf = np.zeros((1, f), np.uint32)
    buf[0, :packed.shape[1]] = packed
    counts = np.array([packed.shape[1]], np.int32)
    runs = np.zeros((1, r), np.uint32)
    rcnt = np.zeros(1, np.int32)
    ret = native.encode_runs_numpy(buf, counts, runs, rcnt, w=w)
    assert ret is not None and ret >= 0
    return runs, rcnt


def _partitions_equal(lab_runs, ref_at_runs):
    m1, m2 = {}, {}
    for a, b in zip(lab_runs, ref_at_runs):
        if m1.setdefault(a, b) != b or m2.setdefault(b, a) != a:
            return False
    return True


@pytest.mark.parametrize('connectivity', [4, 8])
def test_label_runs_fuzz_vs_scipy(connectivity):
    rng = np.random.default_rng(42 + connectivity)
    struct = ndimage.generate_binary_structure(
        2, 2 if connectivity == 8 else 1)
    for _ in range(60):
        h = int(rng.integers(2, 24))
        w = int(rng.integers(2, 40))
        img = rng.random((h, w)) < rng.uniform(0.15, 0.9)
        if not img.any():
            continue
        ref, _ = ndimage.label(img, structure=struct)
        runs, rcnt = _encode(img, w=w)
        lab = np.asarray(run_cc.label_runs(runs, rcnt, w=w,
                                           connectivity=connectivity))[0]
        geo = {k: np.asarray(v)[0] for k, v in
               run_cc.decode_runs(runs, rcnt, w).items()}
        n = int(rcnt[0])
        ref_ids = ref[geo['rows'][:n], geo['xs'][:n]]
        assert _partitions_equal(lab[:n], ref_ids)


def test_keep_marked_runs_matches_binary_propagation():
    rng = np.random.default_rng(7)
    for _ in range(40):
        h = int(rng.integers(3, 24))
        w = int(rng.integers(3, 40))
        img = rng.random((h, w)) < rng.uniform(0.2, 0.8)
        marker = img & (rng.random((h, w)) < 0.15)
        if not img.any():
            continue
        ref = ndimage.binary_propagation(marker, mask=img)
        runs, rcnt = _encode(img, marker=marker.astype(np.uint8) * 255, w=w)
        keep = np.asarray(run_cc.keep_marked_runs(runs, rcnt, w=w))[0]
        geo = {k: np.asarray(v)[0] for k, v in
               run_cc.decode_runs(runs, rcnt, w).items()}
        n = int(rcnt[0])
        ref_keep = ref[geo['rows'][:n], geo['xs'][:n]]
        np.testing.assert_array_equal(keep[:n], ref_keep)


def test_run_cc_components_end_to_end():
    """Ids match the image-path convention: ascending raster rank of the
    kept components' topmost-leftmost pixel; run_comp -1 on dropped runs;
    sorted tables expand to exactly the kept pixels."""
    rng = np.random.default_rng(11)
    for trial in range(30):
        h = int(rng.integers(4, 28))
        w = int(rng.integers(4, 44))
        img = rng.random((h, w)) < rng.uniform(0.25, 0.75)
        marker = img & (rng.random((h, w)) < 0.2)
        if not img.any():
            continue
        kept_img = ndimage.binary_propagation(marker, mask=img)
        ref8, n_ref = ndimage.label(
            kept_img, structure=ndimage.generate_binary_structure(2, 2))
        runs, rcnt = _encode(img, marker=marker.astype(np.uint8) * 255, w=w)
        out = run_cc.run_cc_components(runs, rcnt, w=w, double_threshold=True)
        out = {k: np.asarray(v)[0] for k, v in out.items()}
        assert out['n_components'] == n_ref
        geo = {k: np.asarray(v)[0] for k, v in
               run_cc.decode_runs(runs, rcnt, w).items()}
        n = int(rcnt[0])
        # ascending ids = raster order of each component's first pixel
        firsts = {}
        for i in range(n):
            cid = out['run_comp'][i]
            lin = geo['rows'][i] * w + geo['xs'][i]
            if ref8[geo['rows'][i], geo['xs'][i]] == 0:
                assert cid == -1
                continue
            assert cid >= 0
            firsts.setdefault(cid, lin)
        order = [firsts[k] for k in sorted(firsts)]
        assert order == sorted(order) and len(firsts) == n_ref
        # run_comp partitions agree with scipy labels on kept runs
        kept = out['run_comp'][:n] >= 0
        assert _partitions_equal(
            out['run_comp'][:n][kept],
            ref8[geo['rows'][:n][kept], geo['xs'][:n][kept]])
        # sorted tables: lens sum to kept pixel count; expansion covers the
        # kept pixel set exactly, components contiguous and lin-ascending
        assert out['n_px'] == int(kept_img.sum())
        px = []
        for s, l, c in zip(out['s_start'], out['s_len'], out['s_comp']):
            for k in range(int(l)):
                px.append((int(c), int(s) + k))
        assert len(px) == int(kept_img.sum())
        lins = sorted(p[1] for p in px)
        ref_lins = sorted((yy * w + xx).tolist()
                          for yy, xx in zip(*np.nonzero(kept_img)))
        assert lins == ref_lins
        comps_seen = [p[0] for p in px]
        # components contiguous in the sorted expansion
        boundaries = sum(1 for a, b in zip(comps_seen, comps_seen[1:])
                         if a != b)
        assert boundaries == max(len(set(comps_seen)) - 1, 0)
        # lin ascending within each component
        from collections import defaultdict
        per = defaultdict(list)
        for c, lin in px:
            per[c].append(lin)
        for c, ls in per.items():
            assert ls == sorted(ls)


def test_detect_from_pixels_run_cc_equals_default():
    """detect_from_pixels(use_run_cc=True) is output-identical to the
    pixel-table path on every key, across threshold modes, det_px, and
    skip_rect (the labels change representation, not semantics)."""
    from tests.test_runs_wire import _random_wire
    from ysmr_tpu.pipeline.detect_pixels import detect_from_pixels

    rng = np.random.default_rng(5)
    h, w, t, f = 120, 160, 6, 2048
    packed, counts = _random_wire(rng, t, f, h, w)
    runs = np.zeros((t, f), np.uint32)
    rcnt = np.zeros(t, np.int32)
    assert native.encode_runs_numpy(packed, counts, runs, rcnt, w=w) > 0
    fv = np.ones(t, bool)
    fv[-1] = False
    kw = dict(h=h, w=w, max_det=64, max_bh=16, cc_iters=32,
              include_luminosity=False)
    for dt in (True, False):
        for rdp, skip in ((False, False), (True, False), (True, True)):
            a = detect_from_pixels(None, None, counts, None, fv,
                                   px_packed=packed, double_threshold=dt,
                                   return_det_px=rdp, skip_rect=skip, **kw)
            b = detect_from_pixels(None, None, counts, None, fv,
                                   px_runs=runs[:, :512], run_counts=rcnt,
                                   expanded_f=f, double_threshold=dt,
                                   return_det_px=rdp, skip_rect=skip,
                                   use_run_cc=True, **kw)
            assert set(a) == set(b)
            for key in a:
                assert np.array_equal(np.asarray(a[key]),
                                      np.asarray(b[key])), (dt, rdp, skip,
                                                            key)


def test_det_run_idx_matches_det_px_expansion():
    """The per-RUN det-index readback (det_px_as_runs) host-expanded over
    the run lengths reproduces the per-pixel det_px_idx table exactly —
    the contract that lets host-rect mode fetch ~5x fewer bytes."""
    from tests.test_runs_wire import _random_wire
    from ysmr_tpu.pipeline.detect_pixels import detect_from_pixels
    from ysmr_tpu.pipeline.track_bacteria import _expand_run_det

    rng = np.random.default_rng(11)
    h, w, t, f = 120, 160, 6, 2048
    packed, counts = _random_wire(rng, t, f, h, w)
    runs = np.zeros((t, f), np.uint32)
    rcnt = np.zeros(t, np.int32)
    assert native.encode_runs_numpy(packed, counts, runs, rcnt, w=w) > 0
    fv = np.ones(t, bool)
    fv[-1] = False
    kw = dict(h=h, w=w, max_det=64, max_bh=16, cc_iters=32,
              include_luminosity=False)
    for dt in (True, False):
        a = detect_from_pixels(None, None, counts, None, fv,
                               px_runs=runs[:, :512], run_counts=rcnt,
                               expanded_f=f, double_threshold=dt,
                               return_det_px=True, skip_rect=True,
                               use_run_cc=True, **kw)
        b = detect_from_pixels(None, None, counts, None, fv,
                               px_runs=runs[:, :512], run_counts=rcnt,
                               expanded_f=f, double_threshold=dt,
                               return_det_px=True, skip_rect=True,
                               use_run_cc=True, det_px_as_runs=True, **kw)
        assert 'det_px_idx' not in b and 'det_run_idx' in b
        expanded = _expand_run_det(runs[:, :512], rcnt,
                                   np.asarray(b['det_run_idx']), f)
        assert np.array_equal(expanded, np.asarray(a['det_px_idx']))
        for key in ('det_valid', 'n_components'):
            assert np.array_equal(np.asarray(a[key]), np.asarray(b[key]))


@pytest.mark.e2e
def test_pipeline_run_cc_rows_identical(tmp_path):
    """track_bacteria with 'run cc' on vs off: identical _list.csv rows
    (runs wire, both host-rect modes)."""
    import os
    import pandas as pd
    from tests.test_e2e_parity import make_synthetic_video, _make_settings
    from ysmr_tpu.pipeline.track_bacteria import track_bacteria
    video = make_synthetic_video(str(tmp_path / 'clip.avi'), n_frames=45)
    out = {}
    for mode in ('on', 'off'):
        for rects in (True, False):
            d = str(tmp_path / 'rc{}{}'.format(mode, rects))
            os.makedirs(d)
            s = _make_settings(tmp_path, **{'cv2 exact rects': rects})
            s['wire format'] = 'runs'
            s['run cc'] = mode
            res = track_bacteria(video, settings=dict(s), result_folder=d)
            assert res is not None
            out[(mode, rects)] = res[0]
    for rects in (True, False):
        pd.testing.assert_frame_equal(out[('on', rects)],
                                      out[('off', rects)])


def test_encoder_row_bounded_runs():
    """With w passed, no run crosses a row boundary (device CC invariant)."""
    rng = np.random.default_rng(3)
    w = 13
    img = np.ones((5, w), bool)  # full rows: wraps without the row split
    runs, rcnt = _encode(img, w=w)
    geo = {k: np.asarray(v)[0] for k, v in
           run_cc.decode_runs(runs, rcnt, w).items()}
    n = int(rcnt[0])
    assert ((geo['xs'][:n] + geo['lens'][:n]) <= w).all()
    if native.available():
        yy, xx = np.nonzero(img)
        lin = (yy * w + xx).astype(np.uint32)
        buf = lin[None, :].copy()
        counts = np.array([len(lin)], np.int32)
        runs_n = np.zeros_like(runs)
        rcnt_n = np.zeros(1, np.int32)
        ret = native.encode_runs_batch(buf, counts, runs_n, rcnt_n, w=w)
        assert ret is not None and ret > 0
        np.testing.assert_array_equal(runs_n, runs)
        np.testing.assert_array_equal(rcnt_n, rcnt)
