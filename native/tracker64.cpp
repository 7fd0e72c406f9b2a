// Float64 host tracker: CentroidTracker + Gaussian-Sum FIR filter bank.
//
// The tracker is the one stage of the pipeline that is inherently
// sequential, branchy, and tiny-state (a few hundred live tracks, a few
// hundred detections per frame) — a poor fit for an accelerator but microseconds
// of work per frame on a CPU core.  Running it on the host in float64 with
// the reference's arithmetic semantics (ysmr/tracker.py:93-230,
// ysmr/gsff.py:155-347) removes the last source of TRACK_ID divergence:
// the device filter bank runs in double-single float32, whose residual
// (~1e-5 px of stored-position rounding) the mixture weights amplify ~1000x
// at mode transitions, occasionally flipping a near-tie greedy match.  In
// float64 the arithmetic differences vs numpy are ~1e-16 relative — far
// below every observed decision margin.
//
// Semantics replicated (studied from the reference, re-implemented):
//  * greedy matching: rows sorted by per-row min distance, cols by per-row
//    argmin (first occurrence), first-come matching skipping used rows/cols
//    (tracker.py:158-189); distances compared SQUARED — sqrt is monotone, so
//    the ordering, ties, and argmins are identical to euclidean cdist.
//  * ageing/deregistration: unmatched rows age only when rows >= cols; side
//    info zeroed on every miss; deregister when disappeared > max_disappeared
//    (tracker.py:95-107,192-211).  Registration only when cols > rows, in
//    ascending column order (tracker.py:215-217); ids grow monotonically so
//    insertion order == ascending-id order always.
//  * GSFF correct/predict per live object each frame, empty frames included;
//    a coasting object feeds its own stored prediction back as the
//    measurement (tracker.py:219-227).
//  * GSFF (gsff.py): prev_measurements initialised to [m]*n_i[0]; mode grows
//    while len >= n_i[mode] (weights reset uniform and estimates recomputed
//    from the pre-append window on growth); likelihood exp(-0.5*|m-x_hat|^2)
//    floored at likelihood_minimum (inv_cov is the identity); weights
//    updated multiplicatively and renormalised in place; corrected output =
//    sum_i w_i * x_hat_i over the pre-append estimates, prediction = the
//    same over post-append estimates and becomes the stored position.
//
// Compiled with -ffp-contract=off: FMA contraction would change the f64
// rounding vs numpy's non-fused ops (see Makefile).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace {

struct GsffState {
    bool initialized = false;
    int mode = 0;
    // measurement ring, oldest first, capacity n_max + 1
    std::vector<double> prev;  // flattened (x, y) pairs
    std::vector<double> weights;   // size mode
    std::vector<double> x_hat;     // 2 * mode (column-major: [dim + 2*f])
};

struct Track {
    int64_t id;
    double pos[3];
    double info[3];
    double disappeared = 0.0;
    GsffState g;
};

struct EmittedRow {
    int64_t id;
    int64_t frame;
    double x, y, lum;
    double w, h, deg;
};

struct Tracker64 {
    int dims = 2;
    bool use_gsff = true;
    double max_disappeared = 30.0;
    double likelihood_minimum = 1e-20;
    int n_f = 3;
    int n_max = 30;
    std::vector<int> n_i;
    // right-aligned gains, (n_f, 2, 2*n_max) row-major: filter i uses the
    // last 2*n_i[i] columns against the last n_i[i] ring entries
    std::vector<double> gains;
    std::vector<Track> tracks;  // insertion order == ascending id
    int64_t next_id = 0;
    std::vector<EmittedRow> rows;
    // scratch
    std::vector<double> dist2;               // one ROW of squared distances
    std::vector<double> det_x, det_y, det_z; // detection coords, SoA
    std::vector<int> row_order, row_argmin;
    std::vector<double> row_min;
    std::vector<char> row_used, col_used;
};

const double* gain_row(const Tracker64& t, int filt, int dim) {
    return t.gains.data() + ((size_t)filt * 2 + dim) * (2 * t.n_max);
}

// LS estimate for one filter from the last n entries of the ring (Eq. 12).
void lsff_calc(const Tracker64& t, const GsffState& g, int filt,
               double out[2]) {
    const int n = t.n_i[filt];
    const size_t len = g.prev.size() / 2;
    const double* y = g.prev.data() + 2 * (len - (size_t)n);
    const int off = 2 * (t.n_max - n);
    for (int dim = 0; dim < 2; ++dim) {
        const double* gr = gain_row(t, filt, dim) + off;
        double acc = 0.0;
        for (int j = 0; j < 2 * n; ++j) acc += gr[j] * y[j];
        out[dim] = acc;
    }
}

// predict(): recompute estimates from the current ring, return the weighted
// sum under the current weights (gsff.py:204-249).
void gsff_predict(const Tracker64& t, GsffState& g, double out[2]) {
    for (int f = 0; f < g.mode; ++f) {
        double xh[2];
        lsff_calc(t, g, f, xh);
        g.x_hat[0 + 2 * f] = xh[0];
        g.x_hat[1 + 2 * f] = xh[1];
    }
    for (int dim = 0; dim < 2; ++dim) {
        double acc = 0.0;
        for (int f = 0; f < g.mode; ++f)
            acc += g.x_hat[dim + 2 * f] * g.weights[f];
        out[dim] = acc;
    }
}

// correct(): weight update against the pre-append estimates, append the
// measurement, return the weighted corrected position (gsff.py:251-347).
void gsff_correct(const Tracker64& t, GsffState& g, const double m[2],
                  double out[2]) {
    if (!g.initialized) {
        g.initialized = true;
        g.prev.clear();
        for (int k = 0; k < t.n_i[0]; ++k) {
            g.prev.push_back(m[0]);
            g.prev.push_back(m[1]);
        }
    }
    bool new_mode = false;
    if (g.mode < t.n_f) {
        while ((int)(g.prev.size() / 2) >= t.n_i[g.mode]) {
            g.mode += 1;
            new_mode = true;
            if (g.mode >= t.n_f) break;
        }
    }
    if (new_mode) {
        g.weights.assign(g.mode, 1.0 / g.mode);
        g.x_hat.assign(2 * (size_t)g.mode, 0.0);
        double ignored[2];
        gsff_predict(t, g, ignored);  // fill estimates, keep weights
    }
    std::vector<double> lik((size_t)g.mode);
    for (int f = 0; f < g.mode; ++f) {
        const double dx = m[0] - g.x_hat[0 + 2 * f];
        const double dy = m[1] - g.x_hat[1 + 2 * f];
        double l = std::exp(-0.5 * (dx * dx + dy * dy));
        if (!(l >= t.likelihood_minimum)) l = t.likelihood_minimum;
        lik[f] = l;
    }
    g.prev.push_back(m[0]);
    g.prev.push_back(m[1]);
    const size_t cap = 2 * ((size_t)t.n_max + 1);
    if (g.prev.size() > cap)
        g.prev.erase(g.prev.begin(),
                     g.prev.begin() + (std::ptrdiff_t)(g.prev.size() - cap));
    double weight_sum = 0.0;
    for (int f = 0; f < g.mode; ++f) weight_sum += lik[f] * g.weights[f];
    for (int f = 0; f < g.mode; ++f)
        g.weights[f] = lik[f] * g.weights[f] / weight_sum;
    for (int dim = 0; dim < 2; ++dim) {
        double acc = 0.0;
        for (int f = 0; f < g.mode; ++f)
            acc += g.x_hat[dim + 2 * f] * g.weights[f];
        out[dim] = acc;
    }
}

// Iteration order of CPython's `set(range(n)).difference(used_cols)`
// (tracker.py:215-217): the reference registers new objects in the
// ITERATION ORDER OF A SET OF SMALL INTS, which is hash-table slot order —
// NOT ascending once indices wrap the table size.  `set(range(n))` itself
// iterates ascending (after the final resize every element sits at its own
// home slot), so difference() inserts the unmatched columns in ascending
// order into a fresh set; this function replicates CPython's setobject.c
// insertion (LINEAR_PROBES=9 probing, perturb>>=5 jumps, growth at
// fill*5 >= mask*3 to the next power of two > used*4 with clean
// re-insertion in old slot order) and reads the table back in slot order.
// hash(int) == value for the non-negative ints used here.
static std::vector<int64_t> cpython_set_order(
        const std::vector<int64_t>& ascending) {
    const size_t LINEAR_PROBES = 9;
    std::vector<int64_t> table(8, -1);
    size_t mask = 7;
    size_t fill = 0;

    auto insert_clean = [&](int64_t h) {
        size_t perturb = (size_t)h;
        size_t i = (size_t)h & mask;
        while (true) {
            if (table[i] < 0) { table[i] = h; return; }
            if (i + LINEAR_PROBES <= mask) {
                for (size_t j = 1; j <= LINEAR_PROBES; ++j)
                    if (table[i + j] < 0) { table[i + j] = h; return; }
            }
            perturb >>= 5;
            i = (i * 5 + 1 + perturb) & mask;
        }
    };
    for (int64_t h : ascending) {
        insert_clean(h);
        ++fill;
        if (fill * 5 >= mask * 3) {
            const size_t minused = fill > 50000 ? fill * 2 : fill * 4;
            size_t newsize = 8;
            while (newsize <= minused) newsize <<= 1;
            std::vector<int64_t> old = std::move(table);
            table.assign(newsize, -1);
            mask = newsize - 1;
            for (int64_t v : old)
                if (v >= 0) insert_clean(v);
        }
    }
    std::vector<int64_t> out;
    out.reserve(fill);
    for (int64_t v : table)
        if (v >= 0) out.push_back(v);
    return out;
}

void register_track(Tracker64& t, const double* centroid,
                    const double* info) {
    Track tr;
    tr.id = t.next_id++;
    for (int d = 0; d < 3; ++d) tr.pos[d] = d < t.dims ? centroid[d] : 0.0;
    for (int d = 0; d < 3; ++d) tr.info[d] = info[d];
    tr.disappeared = 0.0;
    t.tracks.push_back(std::move(tr));
}

void update_frame(Tracker64& t, int64_t frame, const float* rects,
                  const unsigned char* valid, const float* lum, long D) {
    // gather detections (dense ids: valid in rect order)
    std::vector<double> det;     // dims per det
    std::vector<double> dinfo;   // 3 per det
    det.reserve((size_t)D * t.dims);
    for (long c = 0; c < D; ++c) {
        if (!valid[c]) continue;
        const float* r = rects + 5 * c;
        det.push_back((double)r[0]);
        det.push_back((double)r[1]);
        if (t.dims == 3) det.push_back(lum ? (double)lum[c] : 0.0);
        dinfo.push_back((double)r[2]);
        dinfo.push_back((double)r[3]);
        dinfo.push_back((double)r[4]);
    }
    const long n_det = (long)(det.size() / (size_t)t.dims);
    const long n_obj = (long)t.tracks.size();

    if (n_det == 0) {
        // every live object ages with zeroed side info (tracker.py:95-107)
        for (size_t i = 0; i < t.tracks.size();) {
            Track& tr = t.tracks[i];
            tr.disappeared += 1.0;
            tr.info[0] = tr.info[1] = tr.info[2] = 0.0;
            if (tr.disappeared > t.max_disappeared)
                t.tracks.erase(t.tracks.begin() + (std::ptrdiff_t)i);
            else
                ++i;
        }
    } else if (n_obj == 0) {
        for (long c = 0; c < n_det; ++c)
            register_track(t, det.data() + (size_t)c * t.dims,
                           dinfo.data() + (size_t)c * 3);
    } else {
        // squared distances: ordering/ties identical to euclidean cdist.
        // Only the per-row (min, first-occurrence argmin) is ever consumed,
        // so the O(n_obj * n_det) matrix is never materialized — one row
        // buffer lives in L1 and dense scenes (3000x3000) stay cache-bound.
        // Arithmetic per element matches the -ffp-contract=off scalar form
        // exactly: (dx*dx + dy*dy) [+ dz*dz], mul then add, never fused.
        t.det_x.resize((size_t)n_det);
        t.det_y.resize((size_t)n_det);
        if (t.dims == 3) t.det_z.resize((size_t)n_det);
        for (long c = 0; c < n_det; ++c) {
            t.det_x[(size_t)c] = det[(size_t)c * t.dims + 0];
            t.det_y[(size_t)c] = det[(size_t)c * t.dims + 1];
            if (t.dims == 3) t.det_z[(size_t)c] = det[(size_t)c * t.dims + 2];
        }
        t.dist2.resize((size_t)n_det);
        t.row_min.assign((size_t)n_obj, 0.0);
        t.row_argmin.assign((size_t)n_obj, 0);
        for (long r = 0; r < n_obj; ++r) {
            const double* p = t.tracks[(size_t)r].pos;
            double* dr = t.dist2.data();
            long c = 0;
            double m;
#if defined(__AVX512F__)
            {
                const __m512d px = _mm512_set1_pd(p[0]);
                const __m512d py = _mm512_set1_pd(p[1]);
                const __m512d pz = _mm512_set1_pd(t.dims == 3 ? p[2] : 0.0);
                __m512d vmin = _mm512_set1_pd(INFINITY);
                for (; c + 8 <= n_det; c += 8) {
                    const __m512d dx = _mm512_sub_pd(
                        px, _mm512_loadu_pd(&t.det_x[(size_t)c]));
                    const __m512d dy = _mm512_sub_pd(
                        py, _mm512_loadu_pd(&t.det_y[(size_t)c]));
                    __m512d acc = _mm512_add_pd(_mm512_mul_pd(dx, dx),
                                                _mm512_mul_pd(dy, dy));
                    if (t.dims == 3) {
                        const __m512d dz = _mm512_sub_pd(
                            pz, _mm512_loadu_pd(&t.det_z[(size_t)c]));
                        acc = _mm512_add_pd(acc, _mm512_mul_pd(dz, dz));
                    }
                    _mm512_storeu_pd(dr + c, acc);
                    vmin = _mm512_min_pd(vmin, acc);
                }
                m = _mm512_reduce_min_pd(vmin);
            }
#else
            m = INFINITY;
#endif
            for (; c < n_det; ++c) {  // scalar tail (or full scalar path)
                const double dx = p[0] - t.det_x[(size_t)c];
                double acc = dx * dx;
                const double dy = p[1] - t.det_y[(size_t)c];
                acc += dy * dy;
                if (t.dims == 3) {
                    const double dz = p[2] - t.det_z[(size_t)c];
                    acc += dz * dz;
                }
                dr[c] = acc;
                if (acc < m) m = acc;
            }
            // first-occurrence argmin: the min is bitwise one of the row
            // values (dist2 >= 0, no NaN), so the first equal element is it
            long best = 0;
#if defined(__AVX512F__)
            {
                const __m512d vm = _mm512_set1_pd(m);
                long c2 = 0;
                bool found = false;
                for (; c2 + 8 <= n_det; c2 += 8) {
                    const __mmask8 k = _mm512_cmp_pd_mask(
                        _mm512_loadu_pd(dr + c2), vm, _CMP_EQ_OQ);
                    if (k) {
                        best = c2 + __builtin_ctz((unsigned)k);
                        found = true;
                        break;
                    }
                }
                if (!found)
                    for (; c2 < n_det; ++c2)
                        if (dr[c2] == m) { best = c2; break; }
            }
#else
            for (long c2 = 0; c2 < n_det; ++c2)
                if (dr[c2] == m) { best = c2; break; }
#endif
            t.row_min[(size_t)r] = m;
            t.row_argmin[(size_t)r] = (int)best;
        }
        t.row_order.resize((size_t)n_obj);
        for (long r = 0; r < n_obj; ++r) t.row_order[(size_t)r] = (int)r;
        std::stable_sort(t.row_order.begin(), t.row_order.end(),
                         [&](int a, int b) {
                             return t.row_min[(size_t)a] < t.row_min[(size_t)b];
                         });
        t.row_used.assign((size_t)n_obj, 0);
        t.col_used.assign((size_t)n_det, 0);
        for (long k = 0; k < n_obj; ++k) {
            const int r = t.row_order[(size_t)k];
            const int c = t.row_argmin[(size_t)r];
            if (t.row_used[(size_t)r] || t.col_used[(size_t)c]) continue;
            Track& tr = t.tracks[(size_t)r];
            for (int d = 0; d < t.dims; ++d)
                tr.pos[d] = det[(size_t)c * t.dims + d];
            for (int d = 0; d < 3; ++d) tr.info[d] = dinfo[(size_t)c * 3 + d];
            tr.disappeared = 0.0;
            t.row_used[(size_t)r] = 1;
            t.col_used[(size_t)c] = 1;
        }
        if (n_obj >= n_det) {
            // unmatched rows age, ascending row order (tracker.py:198-211)
            size_t i = 0;
            for (long r = 0; r < n_obj; ++r) {
                if (t.row_used[(size_t)r]) {
                    ++i;
                    continue;
                }
                Track& tr = t.tracks[i];
                tr.disappeared += 1.0;
                tr.info[0] = tr.info[1] = tr.info[2] = 0.0;
                if (tr.disappeared > t.max_disappeared)
                    t.tracks.erase(t.tracks.begin() + (std::ptrdiff_t)i);
                else
                    ++i;
            }
        } else {
            std::vector<int64_t> unmatched;
            for (long c = 0; c < n_det; ++c)
                if (!t.col_used[(size_t)c]) unmatched.push_back(c);
            for (int64_t c : cpython_set_order(unmatched))
                register_track(t, det.data() + (size_t)c * t.dims,
                               dinfo.data() + (size_t)c * 3);
        }
    }

    // GSFF + emission over live objects, insertion order (tracker.py:219-230)
    for (Track& tr : t.tracks) {
        EmittedRow row;
        row.id = tr.id;
        row.frame = frame;
        row.w = tr.info[0];
        row.h = tr.info[1];
        row.deg = tr.info[2];
        row.lum = t.dims == 3 ? tr.pos[2] : 0.0;
        if (t.use_gsff) {
            double corrected[2], predicted[2];
            const double m[2] = {tr.pos[0], tr.pos[1]};
            gsff_correct(t, tr.g, m, corrected);
            gsff_predict(t, tr.g, predicted);
            row.x = corrected[0];
            row.y = corrected[1];
            tr.pos[0] = predicted[0];
            tr.pos[1] = predicted[1];
        } else {
            row.x = tr.pos[0];
            row.y = tr.pos[1];
        }
        t.rows.push_back(row);
    }
}

}  // namespace

extern "C" {

void* tracker64_create(int dims, int use_gsff, double max_disappeared,
                       int n_f, const int* n_i, int n_max,
                       const double* gains, double likelihood_minimum) {
    Tracker64* t = new Tracker64();
    t->dims = dims;
    t->use_gsff = use_gsff != 0;
    t->max_disappeared = max_disappeared;
    t->likelihood_minimum = likelihood_minimum;
    if (use_gsff) {
        t->n_f = n_f;
        t->n_max = n_max;
        t->n_i.assign(n_i, n_i + n_f);
        t->gains.assign(gains, gains + (size_t)n_f * 2 * (2 * (size_t)n_max));
    }
    return t;
}

void tracker64_destroy(void* h) { delete (Tracker64*)h; }

// Run T frames; emitted rows accumulate in the handle until fetched.
// Returns the number of rows now pending.
int64_t tracker64_update_batch(void* h, const float* rects,
                               const unsigned char* valid, const float* lum,
                               long T, long D, int64_t frame0) {
    Tracker64* t = (Tracker64*)h;
    for (long k = 0; k < T; ++k)
        update_frame(*t, frame0 + k, rects + (size_t)k * D * 5,
                     valid + (size_t)k * D,
                     lum ? lum + (size_t)k * D : nullptr, D);
    return (int64_t)t->rows.size();
}

// Copy pending rows into column arrays and clear the pending buffer.
int64_t tracker64_fetch(void* h, int64_t* out_id, int64_t* out_frame,
                        double* out_x, double* out_y, double* out_lum,
                        double* out_w, double* out_h, double* out_deg) {
    Tracker64* t = (Tracker64*)h;
    const int64_t n = (int64_t)t->rows.size();
    for (int64_t i = 0; i < n; ++i) {
        const EmittedRow& r = t->rows[(size_t)i];
        out_id[i] = r.id;
        out_frame[i] = r.frame;
        out_x[i] = r.x;
        out_y[i] = r.y;
        if (out_lum) out_lum[i] = r.lum;
        out_w[i] = r.w;
        out_h[i] = r.h;
        out_deg[i] = r.deg;
    }
    t->rows.clear();
    return n;
}

int64_t tracker64_next_id(void* h) { return ((Tracker64*)h)->next_id; }

// test hook: CPython set iteration order for ascending non-negative ints
void cpython_set_order_probe(const int64_t* in, int64_t n, int64_t* out) {
    std::vector<int64_t> v(in, in + n);
    std::vector<int64_t> res = cpython_set_order(v);
    for (int64_t i = 0; i < n; ++i) out[i] = res[(size_t)i];
}

int64_t tracker64_live_count(void* h) {
    return (int64_t)((Tracker64*)h)->tracks.size();
}

}  // extern "C"
