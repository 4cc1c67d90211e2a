// Native out-of-core pass-A binner (the port's copy of the JAX package's
// csrc/ooc_binner.cpp, on one uint64 key per row instead of a (hi, lo)
// uint32 pair).
//
// The ooc tier's pass A turns one text chunk's node keys into per-bucket
// row groups (oocore.build_bwt_ooc; the plain version is
// oocore._bin_rows_numpy). This streams the chunk once: separator
// distances via a moving pointer (positions are sequential), row metadata
// inline, destination by binary search over the sampled splitters, then a
// histogram + offset scatter — O(C) total, no sort. The role (and the
// prefix-sum placement trick) mirrors the reference's bucket scatter
// (src/mySort.c:61-110) minus the locks: slots are pre-assigned, so
// placement is race-free.
//
// Parallel: the chunk splits into T contiguous sub-ranges (T from the
// caller, default min(hw, 8)); each thread histograms its range, offsets
// combine as bucket_start[b] + sum of earlier threads' counts (so
// within-bucket rows stay in ascending position order — the output is
// byte-identical for every T), then threads scatter their ranges
// concurrently into disjoint slots. This mirrors the reference's
// fork/join range split (src/mySort.c:127-176) without its per-bucket
// rwlocks.
//
// Outputs are bucket-contiguous arrays; counts[b] gives each bucket's row
// count and the caller slices at the exclusive prefix offsets.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct BinArgs {
    const uint64_t* key;
    int64_t c0;
    const int64_t* sep;
    int64_t n_sep;
    const uint8_t* x2p;
    int64_t N;
    const uint32_t* splitters;
    int64_t nb;
    int64_t shift;
    int64_t k;
};

inline int64_t dest_of(const BinArgs& a, int64_t j) {
    uint32_t topc = static_cast<uint32_t>(a.key[j] >> a.shift);
    return std::upper_bound(a.splitters, a.splitters + (a.nb - 1), topc) -
           a.splitters;
}

void histogram_range(const BinArgs& a, int64_t j0, int64_t j1,
                     int64_t* cnt) {
    int64_t si = std::lower_bound(a.sep, a.sep + a.n_sep, a.c0 + j0) -
                 a.sep;
    for (int64_t j = j0; j < j1; ++j) {
        int64_t pos = a.c0 + j;
        while (si < a.n_sep && a.sep[si] < pos) ++si;
        if (si >= a.n_sep || a.sep[si] - pos < a.k) continue;
        ++cnt[dest_of(a, j)];
    }
}

void scatter_range(const BinArgs& a, int64_t j0, int64_t j1, int64_t* off,
                   uint64_t* out_key, uint16_t* out_k16, int64_t* out_pos) {
    int64_t si = std::lower_bound(a.sep, a.sep + a.n_sep, a.c0 + j0) -
                 a.sep;
    for (int64_t j = j0; j < j1; ++j) {
        int64_t pos = a.c0 + j;
        while (si < a.n_sep && a.sep[si] < pos) ++si;
        if (si >= a.n_sep) break;
        int64_t dist = a.sep[si] - pos;
        if (dist < a.k) continue;
        int64_t b = dest_of(a, j);
        bool head = (pos == 0) || (si > 0 && a.sep[si - 1] == pos - 1);
        uint16_t prev = (pos > 0) ? a.x2p[pos - 1] : 0;
        uint16_t choice = (dist == a.k)
            ? static_cast<uint16_t>(pos + a.k == a.N - 1 ? 5 : 4)
            : static_cast<uint16_t>(a.x2p[pos + a.k]);
        uint16_t bwt_char = (pos == 0) ? 5 : (head ? 4 : prev);
        uint16_t predf = head ? 7 : prev;
        uint16_t k16 = static_cast<uint16_t>(
            (choice << 8) | (bwt_char << 4) |
            (static_cast<uint16_t>(head) << 3) | predf);
        int64_t w = off[b]++;
        out_key[w] = a.key[j];
        out_k16[w] = k16;
        out_pos[w] = pos;
    }
}

}  // namespace

extern "C" {

// Returns the number of valid rows written (== sum of counts).
//  key          uint64[C_real] node keys of positions c0..c0+C_real
//  sep          int64[n_sep] sorted separator positions (global)
//  x2p          uint8[N + pad] 2-bit codes, separators stored as T
//  splitters    uint32[nb-1] sorted c-char-prefix splitters
//  k            node length; split_c = splitter depth in chars
//  n_threads    worker threads; <= 0 takes min(hardware threads, 8)
//  out_*        caller buffers of >= C_real entries each
//  counts       int64[nb], filled by the callee
int64_t debwt_ooc_bin(const uint64_t* key, int64_t c0, int64_t C_real,
                      const int64_t* sep, int64_t n_sep,
                      const uint8_t* x2p, int64_t N,
                      const uint32_t* splitters, int64_t nb,
                      int64_t split_c, int64_t k, int64_t n_threads,
                      uint64_t* out_key, uint16_t* out_k16,
                      int64_t* out_pos, int64_t* counts) {
    BinArgs a{key, c0, sep, n_sep, x2p, N,
              splitters, nb, 2 * (k - split_c), k};

    int64_t T = n_threads;
    if (T <= 0) {
        T = static_cast<int64_t>(std::thread::hardware_concurrency());
        if (T <= 0) T = 1;
        if (T > 8) T = 8;
    }
    if (T > 256) T = 256;
    if (T > C_real) T = std::max<int64_t>(1, C_real);

    // pass 1: per-thread histograms over contiguous ranges
    std::vector<int64_t> cnt(static_cast<size_t>(T) * nb, 0);
    std::vector<int64_t> bounds(T + 1);
    for (int64_t t = 0; t <= T; ++t) bounds[t] = C_real * t / T;
    {
        std::vector<std::thread> ths;
        for (int64_t t = 1; t < T; ++t)
            ths.emplace_back(histogram_range, std::cref(a), bounds[t],
                             bounds[t + 1], cnt.data() + t * nb);
        histogram_range(a, bounds[0], bounds[1], cnt.data());
        for (auto& th : ths) th.join();
    }

    // combined offsets: bucket base + earlier threads' share, so rows
    // stay in ascending position order within each bucket (output is
    // identical for every T)
    int64_t total = 0;
    for (int64_t b = 0; b < nb; ++b) {
        counts[b] = 0;
        for (int64_t t = 0; t < T; ++t) counts[b] += cnt[t * nb + b];
    }
    std::vector<int64_t> off(static_cast<size_t>(T) * nb);
    for (int64_t b = 0; b < nb; ++b) {
        int64_t base = total;
        for (int64_t t = 0; t < T; ++t) {
            off[t * nb + b] = base;
            base += cnt[t * nb + b];
        }
        total += counts[b];
    }

    // pass 2: parallel scatter into disjoint pre-assigned slots
    {
        std::vector<std::thread> ths;
        for (int64_t t = 1; t < T; ++t)
            ths.emplace_back(scatter_range, std::cref(a), bounds[t],
                             bounds[t + 1], off.data() + t * nb,
                             out_key, out_k16, out_pos);
        scatter_range(a, bounds[0], bounds[1], off.data(), out_key,
                      out_k16, out_pos);
        for (auto& th : ths) th.join();
    }
    return total;
}

}  // extern "C"
