"""XLA forms of the detect and track operations vs independent oracles.

Row min/argmin of the tracker's distance matrix, whole-frame and pixel-table
connected components, bit-packed marker reconstruction, hull-edge
candidates, rotated extents and the run-graph fixpoint — each against float64
numpy or scipy (tests/oracles.py). tests/test_on_card.py repeats the checks
at full width on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ysmr_tpu.ops import assignment as asg
from ysmr_tpu.ops.labeling import (_hull_edge_angles, _hull_edge_angles_chain)

import oracles


# -- tracker matching --------------------------------------------------------

@pytest.mark.parametrize('k', [2, 3])
@pytest.mark.parametrize('r,c', [(40, 17), (130, 600), (1024, 512)])
def test_row_min_argmin_matches_float64(k, r, c):
    rng = np.random.default_rng(7)
    near_ties = oracles.check_row_min_argmin(*oracles.random_tracks(rng, r, c,
                                                                    k))
    assert near_ties <= max(2, r // 100)


def test_row_min_argmin_all_invalid():
    obj = np.zeros((8, 2), np.float32)
    det = np.zeros((4, 2), np.float32)
    oracles.check_row_min_argmin(obj, np.zeros(8, bool), det,
                                 np.zeros(4, bool))


def _golden_greedy(d):
    """Reference matcher (tracker.py:158-189) as a sequential loop."""
    rows = np.argsort(d.min(axis=1), kind='stable')
    cols = d.argmin(axis=1)[rows]
    used_r, used_c = set(), set()
    out = np.full(d.shape[0], -1, np.int64)
    for row, col in zip(rows, cols):
        if row in used_r or col in used_c or d[row, col] >= asg.BIG:
            continue
        out[row] = col
        used_r.add(row)
        used_c.add(col)
    return out


@pytest.mark.parametrize('r,c', [(40, 17), (130, 600), (1024, 512)])
def test_greedy_assign_matches_sequential_oracle(r, c):
    rng = np.random.default_rng(3)
    obj, ov, det, dv = oracles.random_tracks(rng, r, c, 2)
    d = np.asarray(asg.pairwise_distances(jnp.asarray(obj), jnp.asarray(ov),
                                          jnp.asarray(det), jnp.asarray(dv)))
    got = asg.greedy_assign(jnp.asarray(d), jnp.asarray(ov), jnp.asarray(dv))
    np.testing.assert_array_equal(np.asarray(got['row_to_col']),
                                  _golden_greedy(d))


# -- connected components and reconstruction ---------------------------------

@pytest.mark.parametrize('connectivity', [4, 8])
@pytest.mark.parametrize('h,w', [(96, 256), (96, 128)])
def test_label_components_matches_scipy(connectivity, h, w):
    rng = np.random.default_rng(h + w + connectivity)
    mask, _ = oracles.blob_masks(rng, 1, h, w, n_blobs=14)
    oracles.check_label_components(mask[0], connectivity)


@pytest.mark.parametrize('t,h,w', [(33, 60, 150), (1, 96, 256), (64, 20, 40)])
def test_binary_reconstruct_matches_scipy(t, h, w):
    """Bit-packed reconstruction == binary_propagation, incl. a batch that
    spans two bit planes and an all-background frame."""
    rng = np.random.default_rng(t)
    mask, marker = oracles.blob_masks(rng, t, h, w, n_blobs=6, r_max=4)
    mask[-1] = False
    marker[-1] = False
    oracles.check_binary_reconstruct(mask, marker)


@pytest.mark.parametrize('double', [False, True])
@pytest.mark.parametrize('path', ['scatter', 'sorted', 'runs'])
def test_pixel_path_components_match_scipy(double, path):
    """detect_from_pixels labels (both settings of each device path flag)
    partition the kept pixels exactly as scipy does."""
    rng = np.random.default_rng(11)
    mask, marker = oracles.blob_masks(rng, 3, 96, 160, n_blobs=16)
    oracles.check_pixel_path(mask, marker, double=double, path=path)


# -- hull candidates, rotated extents, minimum-area rectangle ----------------

def _random_tables(rng, d, r, empty_frac=0.15):
    n_rows = rng.integers(1, r + 1, size=d)
    valid = (np.arange(r)[None, :] < n_rows[:, None])
    empty = rng.random(d) < empty_frac
    valid[empty] = False
    min_y = np.where(empty, 1 << 30,
                     rng.integers(0, 900, size=d)).astype(np.int64)
    abs_y = (min_y[:, None] + np.arange(r)).astype(np.int32)
    cx = rng.integers(0, 1200, size=(d, 1))
    half = rng.integers(0, 30, size=(d, r))
    jitter = rng.integers(-5, 6, size=(d, r))
    row_min = (cx + jitter - half).astype(np.int32)
    row_max = np.maximum(row_min, (cx + jitter + half).astype(np.int32))
    big = 1 << 30
    return (np.where(valid, row_min, big).astype(np.int32),
            np.where(valid, row_max, -big).astype(np.int32),
            valid, abs_y)


def _angle_sets_match(row_min, row_max, valid, abs_y):
    args = [jnp.asarray(a) for a in (row_min, row_max, valid, abs_y)]
    a_n, v_n = map(np.asarray, _hull_edge_angles(*args))
    a_c, v_c = map(np.asarray, _hull_edge_angles_chain(*args))
    for comp in range(row_min.shape[0]):
        s_new = np.unique(np.round(a_n[comp][v_n[comp]], 5))
        s_chain = np.unique(np.round(a_c[comp][v_c[comp]], 5))
        assert np.array_equal(s_new, s_chain), comp


@pytest.mark.parametrize('d,r,seed', [(40, 24, 0), (130, 16, 1), (5, 8, 2)])
def test_hull_closed_form_matches_chain(d, r, seed):
    _angle_sets_match(*_random_tables(np.random.default_rng(seed), d, r))


def test_hull_closed_form_collinear_runs():
    """Collinear chains: vertical strip, constant slope, and two collinear
    segments meeting at a vertex."""
    r = 12
    valid = np.ones((3, r), bool)
    abs_y = np.tile(np.arange(r, dtype=np.int32), (3, 1)) + 7
    row_min = np.stack([
        np.full(r, 100, np.int32),
        (100 + 2 * np.arange(r)).astype(np.int32),
        np.where(np.arange(r) < 6, 100 + 3 * np.arange(r),
                 118 - np.arange(r)).astype(np.int32),
    ])
    _angle_sets_match(row_min, row_min + 5, valid, abs_y)


def test_xla_closed_form_matches_chain_oracle():
    """The vectorised membership test must yield the same candidate-angle
    SET as the sequential monotone chain (the original oracle)."""
    _angle_sets_match(*_random_tables(np.random.default_rng(7), 48, 20,
                                      empty_frac=0.1))


@pytest.mark.parametrize('d,p,k', [(40, 12, 7), (130, 32, 96), (8, 2, 1)])
def test_projected_extents_match_float64(d, p, k):
    rng = np.random.default_rng(42)
    pts = rng.uniform(-50, 900, (d, p, 2)).astype(np.float32)
    valid = rng.random((d, p)) < 0.7
    valid[0] = False  # an all-invalid component
    if d > 1:
        valid[1] = True
    ux = rng.integers(1, 40, (d, k)).astype(np.float32)
    uy = rng.integers(0, 40, (d, k)).astype(np.float32)
    oracles.check_projected_extents(pts, valid, ux, uy)


def test_min_area_rect_matches_calipers_oracle():
    rng = np.random.default_rng(5)
    oracles.check_min_area_rect(*oracles.blob_hull_tables(rng, 33, 32))


# -- run-graph fixpoint -------------------------------------------------------

def test_run_fixpoint_fuzz_vs_scipy():
    rng = np.random.default_rng(5)
    for _ in range(12):
        h = int(rng.integers(3, 30))
        w = int(rng.integers(3, 48))
        img = rng.random((h, w)) < rng.uniform(0.2, 0.85)
        if not img.any():
            continue
        marker = img & (rng.random((h, w)) < 0.3)
        oracles.check_run_fixpoint(img, marker)


def test_run_cc_components_vs_scipy():
    rng = np.random.default_rng(9)
    for _ in range(6):
        h = int(rng.integers(4, 24))
        w = int(rng.integers(4, 40))
        img = rng.random((h, w)) < rng.uniform(0.3, 0.7)
        if not img.any():
            continue
        marker = img & (rng.random((h, w)) < 0.25)
        oracles.check_run_cc_components(img, marker)


def test_run_fixpoint_wide_tables():
    """A run table width that is no power of two (R = 333)."""
    rng = np.random.default_rng(3)
    img = rng.random((20, 40)) < 0.6
    marker = img & (rng.random((20, 40)) < 0.2)
    runs, rcnt = oracles.encode_runs(img, marker, r=333)
    assert runs.shape == (1, 333)
    oracles.check_run_fixpoint(img, marker)
