// Host-side hot loops of the port's data path: per-pixel queue ranks, the
// window slice + rebase of one item, the zoom-out subsample's keep-mask and
// the polarity-balanced subsample.  The same loops as the JAX package's
// native library, with the port's own checks; called through ctypes from
// eventad_tpu_torch/native/__init__.py, whose numpy functions (*_plain) are
// the plain versions the tests hold these against.
//
// Build (done at first use by native/__init__.py):
//   g++ -O3 -shared -fPIC -ffp-contract=off evio.cpp -o libevio_<digest>.so
// -ffp-contract=off keeps zoom_subsample's counter update a product and a
// subtraction, each rounded to f32, as the numpy version computes it: an
// FMA would round once and could keep or drop another event.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Per-pixel recency rank: rank[i] = number of LATER events at pixel
// (x[i], y[i]), the event's slot in the reference's per-pixel FIFO once the
// whole window is inserted (ev_graph.cu:169-212).  One backward pass over a
// dense width x height counter table.  Returns -1, or the index of the first
// event outside [0, width) x [0, height) (then rank_out is not written).
int64_t queue_ranks(
    const int32_t* x, const int32_t* y, int64_t n,
    int32_t width, int32_t height, int32_t* rank_out)
{
    for (int64_t i = 0; i < n; ++i)
        if (x[i] < 0 || x[i] >= width || y[i] < 0 || y[i] >= height)
            return i;
    std::vector<int32_t> cnt((size_t)width * height, 0);
    for (int64_t i = n - 1; i >= 0; --i) {
        int64_t c = (int64_t)y[i] * width + x[i];
        rank_out[i] = cnt[c]++;
    }
    return -1;
}

// The events with t0 <= t < t1 (t sorted) and y < height, their times
// rebased so that the last kept event sits at time_window, polarity {0,1}
// mapped to {-1,+1} (dsec_data.py:124-130).  Writes at most capacity
// events; returns the number written.
int64_t window_rebase(
    const uint16_t* x, const uint16_t* y, const int64_t* t,
    const uint8_t* p, int64_t n,
    int64_t t0, int64_t t1, int64_t time_window, int32_t height,
    int32_t* out_x, int32_t* out_y, int32_t* out_t, int8_t* out_p,
    int64_t capacity)
{
    const int64_t* lo = std::lower_bound(t, t + n, t0);
    const int64_t* hi = std::lower_bound(lo, t + n, t1);
    int64_t i0 = lo - t, i1 = hi - t;
    if (i1 <= i0) return 0;
    // rebase against the last event that survives the y filter (the
    // reference filters first, dsec_data.py:125-128)
    int64_t t_last = 0;
    bool found = false;
    for (int64_t i = i1 - 1; i >= i0; --i) {
        if ((int32_t)y[i] < height) { t_last = t[i]; found = true; break; }
    }
    if (!found) return 0;
    int64_t m = 0;
    for (int64_t i = i0; i < i1 && m < capacity; ++i) {
        if ((int32_t)y[i] >= height) continue;
        out_x[m] = (int32_t)x[i];
        out_y[m] = (int32_t)y[i];
        out_t[m] = (int32_t)(time_window + t[i] - t_last);
        out_p[m] = (int8_t)(2 * (int32_t)p[i] - 1);
        ++m;
    }
    return m;
}

// Polarity-balanced subsample to at most `target` events, in stream order:
// per polarity a rate accumulator (double) keeps an event each time it
// reaches 1.  Positive events are wanted up to target / 2, plus what the
// negative ones cannot fill.  Returns the number written.
int64_t subsample_balanced(
    const int32_t* xi, const int32_t* yi, const int32_t* ti,
    const int8_t* pi, int64_t n, int64_t target,
    int32_t* out_x, int32_t* out_y, int32_t* out_t, int8_t* out_p)
{
    if (n <= target) {
        std::memcpy(out_x, xi, n * sizeof(int32_t));
        std::memcpy(out_y, yi, n * sizeof(int32_t));
        std::memcpy(out_t, ti, n * sizeof(int32_t));
        std::memcpy(out_p, pi, n * sizeof(int8_t));
        return n;
    }
    int64_t n_pos = 0;
    for (int64_t i = 0; i < n; ++i) n_pos += (pi[i] > 0);
    int64_t n_neg = n - n_pos;
    int64_t want_pos = std::min(n_pos, target / 2 + std::max<int64_t>(
        0, target / 2 - n_neg));
    int64_t want_neg = std::min(n_neg, target - want_pos);
    double acc_p = 0, acc_n = 0;
    double rate_p = n_pos ? (double)want_pos / n_pos : 0;
    double rate_n = n_neg ? (double)want_neg / n_neg : 0;
    int64_t m = 0;
    for (int64_t i = 0; i < n && m < target; ++i) {
        bool keep;
        if (pi[i] > 0) { acc_p += rate_p; keep = acc_p >= 1.0;
                         if (keep) acc_p -= 1.0; }
        else           { acc_n += rate_n; keep = acc_n >= 1.0;
                         if (keep) acc_n -= 1.0; }
        if (!keep) continue;
        out_x[m] = xi[i]; out_y[m] = yi[i];
        out_t[m] = ti[i]; out_p[m] = pi[i];
        ++m;
    }
    return m;
}

// Keep-mask of the reference's density-preserving zoom-out subsample
// (augment.py:13-37 on integer positions): a signed f32 polarity counter
// per cell of a (height+1) x (width+1) grid; an event is kept when its
// cell's counter crosses +-threshold, which then moves back by it.  Events
// outside the grid are dropped.  Returns the number kept.
int64_t zoom_subsample(
    const int32_t* x, const int32_t* y, const int8_t* p, int64_t n,
    int32_t width, int32_t height, float threshold, uint8_t* keep)
{
    std::vector<float> count((size_t)(width + 1) * (height + 1), 0.f);
    int64_t kept = 0;
    for (int64_t i = 0; i < n; ++i) {
        keep[i] = 0;
        int32_t xi = x[i], yi = y[i];
        if (xi < 0 || xi > width || yi < 0 || yi > height) continue;
        int64_t c = (int64_t)yi * (width + 1) + xi;
        count[c] += (float)p[i];
        float pol = count[c] > 0.f ? 1.f : -1.f;
        if (pol * count[c] > threshold) {
            count[c] -= pol * threshold;
            keep[i] = 1;
            ++kept;
        }
    }
    return kept;
}

}  // extern "C"
