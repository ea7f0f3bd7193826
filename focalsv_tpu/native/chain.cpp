// Native chaining DP (the host-side scheduling core of seed-chain-extend).
//
// Replaces the Python inner loop of ops/chain.py::_chain_one_strand with the
// same recurrence minimap2 implements in C (chain score with concave gap
// cost over a bounded predecessor window).  Compiled to a shared library and
// called through ctypes; ops/chain.py keeps a pure-numpy fallback.
//
// Build: g++ -O3 -march=native -shared -fPIC chain.cpp -o libfocalsv_native.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// anchors must be pre-sorted by (t, q).  Outputs f (score) and pred (int64,
// -1 = chain start).
void chain_dp(
    const int64_t* t, const int64_t* q, int64_t n,
    int64_t k, int64_t max_pred, int64_t max_gap,
    double* f, int64_t* pred)
{
    const double kd = static_cast<double>(k);
    for (int64_t i = 0; i < n; ++i) {
        f[i] = kd;
        pred[i] = -1;
    }
    for (int64_t i = 1; i < n; ++i) {
        const int64_t j0 = std::max<int64_t>(0, i - max_pred);
        const int64_t ti = t[i], qi = q[i];
        double best = f[i];
        int64_t best_j = -1;
        for (int64_t j = i - 1; j >= j0; --j) {
            const int64_t dt = ti - t[j];
            const int64_t dq = qi - q[j];
            if (dt <= 0 || dq <= 0 || dt > max_gap || dq > max_gap) continue;
            const double match =
                static_cast<double>(std::min(std::min(dq, dt), k));
            const int64_t gap = std::llabs(dt - dq);
            const double cost =
                0.01 * kd * static_cast<double>(gap) + 0.5 * std::log2(static_cast<double>(gap) + 1.0);
            const double sc = f[j] + match - cost;
            if (sc > best) { best = sc; best_j = j; }
        }
        f[i] = best;
        pred[i] = best_j;
    }
}

// Greedy anchor spacing for chain->CIGAR conversion: keep anchors whose
// (t, q) deltas from the last kept anchor are both >= k, so the k-length
// M blocks the CIGAR walk emits never overlap.  Returns the number kept;
// out_idx receives their indices.  (Sequential recurrence -- cheap in C,
// a hot per-anchor Python loop otherwise.)
int64_t space_anchors(
    const int64_t* t, const int64_t* q, int64_t n, int64_t k,
    int64_t* out_idx)
{
    if (n <= 0) return 0;
    int64_t m = 0;
    out_idx[m++] = 0;
    int64_t lt = t[0], lq = q[0];
    for (int64_t i = 1; i < n; ++i) {
        if (t[i] - lt >= k && q[i] - lq >= k) {
            out_idx[m++] = i;
            lt = t[i];
            lq = q[i];
        }
    }
    return m;
}

// Banded affine-gap DP, score-only, unit or affine costs -- used for host
// fallback paths (edit similarity on tiny sequences) when batching to the
// device is not worth the dispatch latency.
int64_t banded_edit_distance(
    const uint8_t* a, int64_t la,
    const uint8_t* b, int64_t lb,
    int64_t band)
{
    // diagonal-band Levenshtein; band must be >= |la - lb| + 1
    const int64_t w = 2 * band + 1;
    const int64_t INF = INT64_C(1) << 40;
    int64_t* prev = new int64_t[w];
    int64_t* cur = new int64_t[w];
    // row 0: D[0][j] = j for j in [0, band]
    for (int64_t kk = 0; kk < w; ++kk) {
        const int64_t j = kk - band;   // j - i offset
        prev[kk] = (j >= 0 && j <= lb) ? j : INF;
    }
    for (int64_t i = 1; i <= la; ++i) {
        for (int64_t kk = 0; kk < w; ++kk) {
            const int64_t j = i + kk - band;
            if (j < 0 || j > lb) { cur[kk] = INF; continue; }
            int64_t v = INF;
            if (j > 0) {
                const int64_t diag = prev[kk];
                if (diag < INF) {
                    const int64_t cost = (a[i - 1] == b[j - 1] && a[i-1] < 4) ? 0 : 1;
                    v = diag + cost;
                }
                if (kk > 0 && cur[kk - 1] < INF)      // left: gap in a
                    v = std::min(v, cur[kk - 1] + 1);
            } else {
                v = i;
            }
            if (kk + 1 < w && prev[kk + 1] < INF)     // up: gap in b
                v = std::min(v, prev[kk + 1] + 1);
            cur[kk] = v;
        }
        std::swap(prev, cur);
    }
    const int64_t kk = lb - la + band;
    int64_t out = (kk >= 0 && kk < w) ? prev[kk] : INF;
    delete[] prev;
    delete[] cur;
    return out;
}

// Banded affine-gap DP with direction bits -- the host fast path for small
// gap-fill alignments inside seed-chain-extend (the ksw2 role in minimap2 /
// hifiasm, reference ksw2_extz2_sse.c).  Semantics are bit-identical to the
// JAX kernel ops/align.py::banded_align_batch (same band-by-diagonal layout,
// same cummax E formulation and tie-breaking), so the caller reuses the same
// traceback.  Large alignments go to the device kernel; this exists because a
// small DP costs less on the host than a device round trip.
//
// dirs is (qn x band) uint8, row i-1 holds DP row i.  Returns the global
// alignment score H[qn][tn] (NEG if the endpoint falls outside the band).
int64_t affine_banded_align(
    const uint8_t* q, int64_t qn,
    const uint8_t* t, int64_t tn,
    int64_t d_lo, int64_t band,
    int64_t match, int64_t mismatch, int64_t gap_open, int64_t gap_extend,
    uint8_t* dirs)
{
    const int64_t NEG = -(INT64_C(1) << 28);
    const int64_t W = band;
    const uint8_t DIR_E_EXT = 0b100, DIR_F_EXT = 0b1000;
    int64_t* h_prev = new int64_t[W];
    int64_t* f_prev = new int64_t[W];
    int64_t* h_cur = new int64_t[W];
    int64_t* f_cur = new int64_t[W];
    for (int64_t k = 0; k < W; ++k) {
        const int64_t j0 = d_lo + k;
        int64_t h0;
        if (j0 == 0) h0 = 0;
        else if (j0 > 0) h0 = gap_open + gap_extend * (j0 - 1);
        else h0 = NEG;
        if (j0 < 0 || j0 > tn) h0 = NEG;
        h_prev[k] = h0;
        f_prev[k] = NEG;
    }
    for (int64_t i = 1; i <= qn; ++i) {
        const uint8_t qc = q[i - 1];
        // running cummax of (g[k'] - ext*k') over k' < k, and g[k-1]
        int64_t a_run = NEG, g_left = NEG;
        uint8_t* drow = dirs + (i - 1) * W;
        for (int64_t k = 0; k < W; ++k) {
            const int64_t j = i + d_lo + k;
            const bool jv = (j >= 1) && (j <= tn);
            const bool jz = (j == 0);
            const uint8_t tc = (j >= 1 && j <= tn) ? t[j - 1] : 255;
            const int64_t sub = (qc == tc && qc < 4) ? match : mismatch;
            const int64_t diag = h_prev[k] + sub;
            const int64_t h_up = (k + 1 < W) ? h_prev[k + 1] : NEG;
            const int64_t f_up = (k + 1 < W) ? f_prev[k + 1] : NEG;
            const int64_t f_open = h_up + gap_open;
            const int64_t f_ext = f_up + gap_extend;
            const int64_t f = std::max(f_open, f_ext);
            const int64_t g = std::max(diag, f);
            const int64_t a_shift = a_run;                 // a[k-1]
            const int64_t e = a_shift + (gap_open - gap_extend)
                              + gap_extend * k;
            int64_t h = std::max(g, e);
            uint8_t d = (h == diag) ? 0 : ((h == e) ? 1 : 2);
            if (f_ext >= f_open) d |= DIR_F_EXT;
            // E-extension bit: cummax at k-1 came from strictly before k-1
            if (a_shift > g_left - gap_extend * (k - 1)) d |= DIR_E_EXT;
            const uint8_t dz = 2 | ((f_ext >= f_open) ? DIR_F_EXT : 0);
            if (jv) { drow[k] = d; }
            else if (jz) { drow[k] = dz; h = f; }
            else { drow[k] = 0; h = NEG; }
            h_cur[k] = h;
            f_cur[k] = (jv || jz) ? f : NEG;
            a_run = std::max(a_run, g - gap_extend * k);
            g_left = g;
        }
        std::swap(h_prev, h_cur);
        std::swap(f_prev, f_cur);
    }
    const int64_t k_end = tn - qn - d_lo;
    const int64_t score = (k_end >= 0 && k_end < W) ? h_prev[k_end] : NEG;
    delete[] h_prev; delete[] f_prev; delete[] h_cur; delete[] f_cur;
    return score;
}

}  // extern "C"
