// Native host tier: C++ kernels for the host-side hot paths of the data
// pipeline (batch and operator building, TU-format dataset parsing).
//
// Everything between disk and the padded device batch (scatter
// accumulations, label sums, arc canonicalisation, text parsing) runs here
// as single-pass C++ over the raw buffers: no f64 temporaries, no
// np.add.at (which dispatches per element group through the ufunc
// machinery).  Each function is bit-identical to the NumPy path that
// gnnkeras_tpu_torch/native.py keeps beside it; the build is ISO C++17
// without -ffast-math, so no multiply-add is contracted.
//
// ABI: plain extern "C" functions over raw pointers, loaded via ctypes.  All
// array arguments are C-contiguous; the Python wrapper
// (gnnkeras_tpu_torch/native.py) enforces dtype/contiguity and takes the
// NumPy path when the compiled library is unavailable or the input is
// ineligible.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// agg_arc[dst[e], :] += w[e] * arc_label[e, :]   (f64 accumulate, f32 out)
// agg_node[dst[e], :] += w[e] * nodes[src[e], :]
// One pass over the edges; replaces two np.add.at calls plus the f64
// astype copies of arc_label/nodes/w (the measured hotspot of
// graph/batch.py:from_graph_object).
void agg_label_sums(
    const int32_t* src, const int32_t* dst, const float* w, int64_t n_arcs,
    const float* arc_label, int64_t da,
    const float* nodes, int64_t dn,
    double* acc_arc,   // (N, da) zero-initialised by caller
    double* acc_node)  // (N, dn) zero-initialised by caller
{
    for (int64_t e = 0; e < n_arcs; ++e) {
        const double we = (double)w[e];
        // no zero-weight skip: 0*NaN must propagate exactly as np.add.at does
        double* oa = acc_arc + (int64_t)dst[e] * da;
        const float* la = arc_label + e * da;
        for (int64_t j = 0; j < da; ++j) oa[j] += we * (double)la[j];
        double* on = acc_node + (int64_t)dst[e] * dn;
        const float* ln = nodes + (int64_t)src[e] * dn;
        for (int64_t j = 0; j < dn; ++j) on[j] += we * (double)ln[j];
    }
}

// Composite per-type gated neighbor-label sums (reference
// CompositeGNN.py:251-253 semantics): for each type t,
//   acc[dst[e], off_t : off_t + d_t] += w[e] * nodes[src[e], :d_t]
// gated by the SOURCE node's type.  type_of[i] in [0, T); dims/offsets give
// each type's slice of the concatenated output (width sum(dims)).
void agg_component_sums(
    const int32_t* src, const int32_t* dst, const float* w, int64_t n_arcs,
    const float* nodes, int64_t dn,
    const int32_t* type_of,        // (N,) source-node type index
    const int64_t* dims,           // (T,) per-type label widths d_t
    const int64_t* offsets,        // (T,) column offset of each type's slice
    int64_t n_types,
    double* acc)                   // (N, sum(dims)) zero-initialised
{
    const int64_t width = offsets[n_types - 1] + dims[n_types - 1];
    for (int64_t e = 0; e < n_arcs; ++e) {
        const double we = (double)w[e];
        const int64_t s = (int64_t)src[e];
        const int32_t t = type_of[s];
        if (t < 0 || t >= n_types) continue;
        const int64_t d_t = dims[t];
        double* out = acc + (int64_t)dst[e] * width + offsets[t];
        const float* ln = nodes + s * dn;
        for (int64_t j = 0; j < d_t; ++j) out[j] += we * (double)ln[j];
    }
}

// Parse a whitespace/comma-separated integer text file (the TU dataset
// format: edge lists "a, b", label columns, graph indicators) into an int64
// buffer.  Returns the number of integers written, or -1 on open failure,
// -(2+offset) on a malformed byte.  Replaces np.loadtxt (which tokenises
// through Python) — ~20x on Mutagenicity_edges.txt.
int64_t parse_ints(const char* path, int64_t* out, int64_t capacity) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    const long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    char* buf = (char*)malloc((size_t)size + 1);
    if (!buf) { fclose(f); return -1; }
    const size_t got = fread(buf, 1, (size_t)size, f);
    fclose(f);
    buf[got] = '\0';
    int64_t count = 0;
    const char* p = buf;
    const char* end = buf + got;
    while (p < end) {
        // skip separators (whitespace, commas)
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r' || *p == ',')) ++p;
        if (p >= end) break;
        bool neg = false;
        if (*p == '-') { neg = true; ++p; }
        else if (*p == '+') ++p;
        if (p >= end || *p < '0' || *p > '9') { free(buf); return -(2 + (int64_t)(p - buf)); }
        int64_t v = 0;
        while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
        if (count >= capacity) { free(buf); return -1; }
        out[count++] = neg ? -v : v;
    }
    free(buf);
    return count;
}

// np.add.at(out_flat, idx, w) over a float32 buffer: NumPy resolves the
// mixed f32/f64 ufunc loop to float64 and casts each result back, i.e.
// out[i] = float(double(out[i]) + w[e]) — for all-f32 inputs the double
// intermediate is still bit-identical (an f32 sum is exact in double and
// the final downcast is the one correctly-rounded step).  Replaces the
// buffered fancy-indexing add.at in the block/strip operator builders
// (ops/{strip,banded,bcsr}.py) — the hot host path of large-graph batch
// construction.
void scatter_add_f32(const int64_t* idx, const double* w, int64_t n, float* out) {
    for (int64_t e = 0; e < n; ++e) {
        float* o = out + idx[e];
        *o = (float)((double)*o + w[e]);
    }
}

// Factor arr (B, R, C) f64 as mask(int8) * scale[b, c]: every column's
// nonzeros must share one exact value (the per-destination aggregation
// weight, reference graph_class.py:105-121).  Single pass — replaces the
// NumPy argmax + full reconstruct-compare (three extra full-array sweeps).
// Returns 1 and fills mask (B*R*C int8) + scale (B*C f32) on success, 0
// when not factorable (mask/scale contents then undefined).
}  // extern "C" (template below cannot carry C linkage)

template <typename T>
static int32_t factor_mask_scale_impl(
    const T* arr, int64_t B, int64_t R, int64_t C,
    int8_t* mask, float* scale) {
    double* col_val = (double*)malloc(sizeof(double) * (size_t)C);
    bool* seen = (bool*)malloc(sizeof(bool) * (size_t)C);
    if (!col_val || !seen) { free(col_val); free(seen); return 0; }
    for (int64_t b = 0; b < B; ++b) {
        for (int64_t c = 0; c < C; ++c) seen[c] = false;
        const T* slab = arr + b * R * C;
        int8_t* mslab = mask + b * R * C;
        for (int64_t r = 0; r < R; ++r) {
            const T* row = slab + r * C;
            int8_t* mrow = mslab + r * C;
            for (int64_t c = 0; c < C; ++c) {
                const double a = (double)row[c];
                if (a != 0.0) {
                    // NaN: NumPy's reconstruct-compare (array_equal) always
                    // fails on NaN, so declare unfactorable for parity
                    if (a != a) { free(col_val); free(seen); return 0; }
                    mrow[c] = 1;
                    if (!seen[c]) { seen[c] = true; col_val[c] = a; }
                    else if (a != col_val[c]) { free(col_val); free(seen); return 0; }
                } else {
                    mrow[c] = 0;
                }
            }
        }
        float* srow = scale + b * C;
        for (int64_t c = 0; c < C; ++c) srow[c] = seen[c] ? (float)col_val[c] : 0.0f;
    }
    free(col_val);
    free(seen);
    return 1;
}

// np.unique(arcs, axis=0) for an (n, c>=2) arc matrix whose first two
// columns are the integral (src, dst) endpoints: sort rows
// lexicographically, drop duplicates (the GraphObject constructor's
// canonicalization, reference graph_class.py:47 — the measured 3.8 s host
// hotspot of the 500k-node batch build; a NumPy lexsort formulation was
// tried and refuted, BASELINE.md round 4).
//
// Strategy: pack (src, dst) into one u64 key (they are integral node ids)
// and std::sort (key, row-index) pairs — the key resolves the order for
// all but parallel arcs, whose ties fall back to elementwise label
// comparison.  Bit-identity with np.unique is GUARANTEED only when no
// value is NaN (np.unique keeps every NaN row; sort position ambiguous)
// and no value is -0.0 (-0.0 == 0.0 makes the kept representative depend
// on sort stability) and src/dst are integral in [0, 2^32) — the kernel
// scans once and returns -1 for ineligible input (caller falls back).
template <typename T>
static int64_t canonical_arcs_impl(const T* rows, int64_t n, int64_t c, T* out) {
    if (n == 0) return 0;
    // eligibility scan
    for (int64_t i = 0; i < n; ++i) {
        const T* r = rows + i * c;
        for (int64_t j = 0; j < c; ++j) {
            const double v = (double)r[j];
            if (v != v) return -1;                      // NaN
            if (v == 0.0 && std::signbit(v)) return -1; // -0.0
        }
        const double s = (double)r[0], d = (double)r[1];
        if (s < 0.0 || s >= 4294967296.0 || s != std::floor(s)) return -1;
        if (d < 0.0 || d >= 4294967296.0 || d != std::floor(d)) return -1;
    }
    struct Entry { uint64_t key; int64_t idx; };
    std::vector<Entry> order((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
        const T* r = rows + i * c;
        order[(size_t)i].key =
            ((uint64_t)(double)r[0] << 32) | (uint64_t)(double)r[1];
        order[(size_t)i].idx = i;
    }
    std::sort(order.begin(), order.end(), [&](const Entry& a, const Entry& b) {
        if (a.key != b.key) return a.key < b.key;
        const T* ra = rows + a.idx * c;
        const T* rb = rows + b.idx * c;
        for (int64_t j = 2; j < c; ++j) {
            if (ra[j] < rb[j]) return true;
            if (ra[j] > rb[j]) return false;
        }
        return false;
    });
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        const T* r = rows + order[(size_t)i].idx * c;
        if (m > 0 && std::memcmp(r, out + (m - 1) * c, sizeof(T) * (size_t)c) == 0)
            continue;  // bitwise equality == value equality (no NaN/-0.0)
        std::memcpy(out + m * c, r, sizeof(T) * (size_t)c);
        ++m;
    }
    return m;
}

extern "C" {

// np.unique for a 1-D int64 key array (values only): sort a copy, dedup.
// Exact for any int64 (no float caveats).  Replaces the three sorted-unique
// key passes of the block/banded operator builders (ops/bcsr.py,
// ops/banded.py) — np.unique's argsort+take was the second-largest host
// cost of the 500k-node batch build after the ctor dedup.
int64_t unique_i64(const int64_t* keys, int64_t n, int64_t* out_vals) {
    if (n == 0) return 0;
    std::vector<int64_t> v(keys, keys + n);
    std::sort(v.begin(), v.end());
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (m == 0 || v[(size_t)i] != out_vals[m - 1]) out_vals[m++] = v[(size_t)i];
    }
    return m;
}

// np.unique(..., return_inverse=True): additionally fills inverse[i] = rank
// of keys[i] in the sorted-unique values.
int64_t unique_i64_inverse(const int64_t* keys, int64_t n,
                           int64_t* out_vals, int64_t* inverse) {
    if (n == 0) return 0;
    struct Entry { int64_t key; int64_t idx; };
    std::vector<Entry> v((size_t)n);
    for (int64_t i = 0; i < n; ++i) { v[(size_t)i].key = keys[i]; v[(size_t)i].idx = i; }
    std::sort(v.begin(), v.end(),
              [](const Entry& a, const Entry& b) { return a.key < b.key; });
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (m == 0 || v[(size_t)i].key != out_vals[m - 1]) out_vals[m++] = v[(size_t)i].key;
        inverse[v[(size_t)i].idx] = m - 1;
    }
    return m;
}

// scatter_add_f32 with the 3-D index flattening fused in (one pass, no
// 4M-element NumPy modulo/flatten temporaries).  Indices must already be
// validated in range [-d, d) per axis (the Python wrapper checks).
void scatter_add_f32_idx3(
    const int64_t* i0, const int64_t* i1, const int64_t* i2,
    const double* w, int64_t n,
    int64_t d0, int64_t d1, int64_t d2, float* out) {
    for (int64_t e = 0; e < n; ++e) {
        int64_t a = i0[e]; if (a < 0) a += d0;
        int64_t b = i1[e]; if (b < 0) b += d1;
        int64_t c = i2[e]; if (c < 0) c += d2;
        float* o = out + (a * d1 + b) * d2 + c;
        *o = (float)((double)*o + w[e]);
    }
}

int64_t canonical_arcs_f64(const double* rows, int64_t n, int64_t c, double* out) {
    return canonical_arcs_impl<double>(rows, n, c, out);
}

int64_t canonical_arcs_f32(const float* rows, int64_t n, int64_t c, float* out) {
    return canonical_arcs_impl<float>(rows, n, c, out);
}

int32_t factor_mask_scale(
    const double* arr, int64_t B, int64_t R, int64_t C, int8_t* mask, float* scale) {
    return factor_mask_scale_impl<double>(arr, B, R, C, mask, scale);
}

int32_t factor_mask_scale_f32(
    const float* arr, int64_t B, int64_t R, int64_t C, int8_t* mask, float* scale) {
    return factor_mask_scale_impl<float>(arr, B, R, C, mask, scale);
}

// Count integers in a file without storing them (sizing pass for parse_ints).
int64_t count_ints(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    const long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    char* buf = (char*)malloc((size_t)size + 1);
    if (!buf) { fclose(f); return -1; }
    const size_t got = fread(buf, 1, (size_t)size, f);
    fclose(f);
    buf[got] = '\0';
    int64_t count = 0;
    bool in_tok = false;
    for (size_t i = 0; i < got; ++i) {
        const char c = buf[i];
        const bool sep = (c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == ',');
        if (!sep && !in_tok) { ++count; in_tok = true; }
        else if (sep) in_tok = false;
    }
    free(buf);
    return count;
}

}  // extern "C"
