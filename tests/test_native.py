"""Native C++ component tests (skipped when the library cannot be built)."""

import numpy as np
import pytest

from ysmr_tpu import native


pytestmark = pytest.mark.usefixtures('native_lib')


def test_format_rows_matches_python_repr():
    tid = np.array([0, 3, 123456], np.int64)
    frm = np.array([7, 8, 9], np.int64)
    x = np.array([1.5, 320.829158285524, 2.0])
    y = np.array([-0.25, 1e-7, 922.0])
    w = np.array([4.0, 2.5, 0.1])
    h = np.array([2.0, 5.0, 0.30000000000000004])
    deg = np.array([0.0, 45.5, 89.99999])
    text = native.format_rows(tid, frm, x, y, w, h, deg)
    lines = text.strip().split('\n')
    assert len(lines) == 3
    for i, line in enumerate(lines):
        cells = line.split(',')
        assert cells[0] == str(tid[i])
        assert cells[1] == str(frm[i])
        for j, arr in enumerate([x, y, w, h, deg]):
            assert cells[2 + j] == repr(float(arr[i])), (line, arr[i])
            assert float(cells[2 + j]) == arr[i]  # round-trip exact


def test_format_rows_bytes_matches_str_and_binary_write(tmp_path):
    """The zero-copy bytes path (memoryview over the C buffer) must render
    the same bytes as the str API, and save_list's binary append must
    produce a byte-identical CSV to the former text-mode write."""
    n = 400
    rng = np.random.default_rng(2)
    tid = rng.integers(0, 50, n)
    frm = rng.integers(0, 700, n)
    cols = [rng.uniform(-90, 1228, n) for _ in range(5)]
    raw = native.format_rows_bytes(tid, frm, *cols)
    text = native.format_rows(tid, frm, *cols)
    assert bytes(raw) == text.encode('ascii')

    from ysmr_tpu.utils.csv_io import save_list
    arrays = {k: v for k, v in zip(
        ('TRACK_ID', 'POSITION_T', 'POSITION_X', 'POSITION_Y', 'WIDTH',
         'HEIGHT', 'DEGREES_ANGLE'), (tid, frm, *cols))}
    path = tmp_path / 'x_list.csv'
    path.write_text('HEADER\n')
    save_list(arrays=arrays, path=str(path))
    assert path.read_bytes() == b'HEADER\n' + bytes(raw)


def test_format_rows_with_illumination():
    n = 5
    rng = np.random.default_rng(0)
    args = [np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64)] + \
        [rng.uniform(0, 100, n) for _ in range(6)]
    text = native.format_rows(*args[:7], illumination=args[7])
    lines = text.strip().split('\n')
    assert all(len(line.split(',')) == 8 for line in lines)


def test_min_area_rect_batch_vs_cv2():
    import cv2
    rng = np.random.default_rng(1)
    d, p = 8, 32
    pts = np.zeros((d, p, 2), np.float32)
    valid = np.zeros((d, p), bool)
    for i in range(d):
        n = int(rng.integers(3, p))
        pts[i, :n] = rng.integers(0, 50, (n, 2))
        valid[i, :n] = True
    out = native.min_area_rect_batch(pts, valid)
    for i in range(d):
        ref = cv2.minAreaRect(pts[i][valid[i]].astype(np.int32))
        (rx, ry), (rw, rh), rang = ref
        assert np.hypot(out[i, 0] - rx, out[i, 1] - ry) < 1e-3
        assert sorted([out[i, 2], out[i, 3]]) == pytest.approx(
            sorted([rw, rh]), abs=1e-3)
        # cv2's classic convention: angle in [-90, 0), w along it
        assert -90.0 <= out[i, 4] < 0.0
        if abs(rw - rh) > 1e-2:  # non-tie: full decomposition must agree
            assert out[i, 2] == pytest.approx(rw, abs=1e-3)
            assert out[i, 3] == pytest.approx(rh, abs=1e-3)
            assert out[i, 4] == pytest.approx(rang, abs=0.1)


@pytest.mark.parametrize('mode_id', [0, 1])
@pytest.mark.parametrize('white', [True, False])
@pytest.mark.parametrize('c_mask,c_marker', [(-5.0, -10.0), (-1.5, -3.5),
                                             (2.0, 4.0), (0.0, 0.0)])
@pytest.mark.parametrize('w', [203, 208])
def test_fused_stage2_bit_equals_unfused(rng, mode_id, white, c_mask,
                                         c_marker, w):
    """The fused adaptive-mean stage 2 must reproduce the two-pass path
    bit-for-bit: same count, same packed entries in the same (raster)
    order — including the marker bit and the overflow count semantics.
    w=203 exercises the scalar tail (203 mod 64 = 11 < 16); w=208 lands in
    the 16-wide remainder block of the h-pass (208 mod 64 = 16)."""
    h = 97  # odd height exercises the border rows
    for trial in range(4):
        frame = rng.normal(90, 30, (h, w)).clip(0, 255).astype(np.uint8)
        # a few bright blobs so both mask polarities produce foreground
        for _ in range(12):
            y0, x0 = int(rng.integers(0, h - 6)), int(rng.integers(0, w - 8))
            frame[y0:y0 + 5, x0:x0 + 7] = int(rng.integers(170, 255))
        cap = 4096 if trial < 3 else 32  # last trial forces overflow clamp
        ref = np.zeros(cap, np.uint32)
        native.preprocess_stage1_only(frame, need_mean=True)
        ref_count = native.preprocess_stage2_packed(
            mode_id, white, c_mask, c_marker, 0, ref)
        got = np.zeros(cap, np.uint32)
        native.preprocess_stage1_only(frame, need_mean=False)
        got_count = native.preprocess_stage2_fused(
            mode_id, white, c_mask, c_marker, got)
        assert got_count == ref_count
        n = min(ref_count, cap)
        np.testing.assert_array_equal(got[:n], ref[:n])
