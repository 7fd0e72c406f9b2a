#!/usr/bin/env python3
"""Row-level comparison of a ``_list.csv`` result against a reference one.

Used by the benchmark and the card smoke test to hold a run to the
reference implementation's output for the same clip.
"""

import os

import numpy as np

_RECT_COLUMNS = ('WIDTH', 'HEIGHT', 'DEGREES_ANGLE')
_POSITION_COLUMNS = ('POSITION_X', 'POSITION_Y')


def read_list_csv(path):
    """A ``_list.csv`` (optionally gzipped) sorted by (TRACK_ID, POSITION_T)."""
    import pandas as pd
    df = pd.read_csv(path)
    return df.sort_values(['TRACK_ID', 'POSITION_T'],
                          kind='stable').reset_index(drop=True)


def check_row_parity(our_df, ref_list_csv, atol=1e-9):
    """Compare our tracker rows with the reference's ``_list.csv``.

    Returns (strict_bool, detail dict); (None, None) when the reference file
    is missing. Strict means identical (TRACK_ID, POSITION_T) sequences and
    WIDTH/HEIGHT/DEGREES_ANGLE and positions within ``atol``. The default
    1e-9 only absorbs the reference-side CSV round trip (pandas' float parser
    is ~1 f64 ulp off on ~1 % of values): the host-rect mode measures with
    the bit-exact replica of cv2's minAreaRect chain (native/cv2_exact.cpp)
    and tracks with the reference's float64 filter arithmetic
    (native/tracker64.cpp). The detail quantifies any divergence: row
    counts, the share of rows whose (TRACK_ID, POSITION_T) agree, the first
    mismatching row, and the largest position differences.

    :param our_df: DataFrame sorted by (TRACK_ID, POSITION_T)
    """
    if not (ref_list_csv and os.path.isfile(ref_list_csv)):
        return None, None
    ref = read_list_csv(ref_list_csv)
    return compare_rows(our_df, ref, atol=atol)


def compare_rows(our_df, ref, atol=1e-9):
    """(strict_bool, detail) for two (TRACK_ID, POSITION_T)-sorted frames;
    see :func:`check_row_parity`."""
    detail = {'total_rows': int(ref.shape[0]),
              'row_count_ours': int(our_df.shape[0]),
              'tracks': int(ref['TRACK_ID'].nunique()),
              'tracks_ours': int(our_df['TRACK_ID'].nunique())}
    if our_df.shape[0] != ref.shape[0]:
        return False, detail
    ids_o = our_df['TRACK_ID'].to_numpy(dtype=np.int64)
    ids_r = ref['TRACK_ID'].to_numpy(dtype=np.int64)
    t_o = our_df['POSITION_T'].to_numpy(dtype=np.int64)
    t_r = ref['POSITION_T'].to_numpy(dtype=np.int64)
    mismatch = (ids_o != ids_r) | (t_o != t_r)
    detail['id_mismatch_rows'] = int(mismatch.sum())
    detail['id_agreement'] = float(1.0 - mismatch.mean())
    ok_rows = ~mismatch
    if ok_rows.any():
        same_rect = np.ones(ok_rows.sum(), bool)
        for col in _RECT_COLUMNS:
            diff = np.abs(our_df[col].to_numpy(dtype=float)[ok_rows] -
                          ref[col].to_numpy(dtype=float)[ok_rows])
            same_rect &= diff <= atol
        detail['rect_columns_agreement'] = float(same_rect.mean())
        for col in _POSITION_COLUMNS:
            diff = np.abs(our_df[col].to_numpy(dtype=float)[ok_rows] -
                          ref[col].to_numpy(dtype=float)[ok_rows])
            detail['max_abs_diff_{}'.format(col)] = float(diff.max())
    if mismatch.any():
        detail['first_mismatch_row'] = int(np.nonzero(mismatch)[0][0])
        return False, detail
    ok = detail.get('rect_columns_agreement', 0) == 1.0
    for col in _POSITION_COLUMNS:
        ok = ok and detail['max_abs_diff_{}'.format(col)] <= atol
    return bool(ok), detail
