// Peak-store builder: one raw file's peaks sorted into the (slot, coarse m/z
// bin, cycle) slab layout that the XIC kernel reads, with bin-edge peaks
// duplicated as ghosts and the int32 cell index beside them.
//
// Host C++17 with a plain C interface (loaded with ctypes by
// rawdata/peakstore.py). A counting sort over the cell key
// (slot * n_bins + bin) * n_cycles + cycle in two passes over the peaks:
//
//   peakstore_count    counts the entries of every cell (a peak's own bin,
//                      then its up-ghost, then its down-ghost) and turns the
//                      counts into cell offsets; returns the stored total;
//   peakstore_scatter  writes each entry at its cell's cursor (with its
//                      peak's scan bin on 4D data) and fills the cell index.
//
// Spectrum s is cycle s / n_slots of slot s % n_slots, so every cell takes
// the entries of one spectrum only. Both passes split the spectra into
// contiguous ranges, one a thread: a thread owns the cells of its spectra,
// needs no atomics, and writes each cell's entries in the spectrum's own
// order (m/z ascending, ghosts in their source peak's place). The output
// does not depend on the thread count.
//
// Bins are computed in float64 and truncated toward zero as numpy's
// astype(int64) does on x86-64 (NaN and values outside int64 become
// INT64_MIN), then clipped to [0, n_bins). The cell index is int32: past
// 2**31 stored peaks its offsets wrap, as numpy's astype(int32) wraps them.

#include <algorithm>
#include <cstdint>
#include <exception>
#include <thread>
#include <vector>

namespace {

inline int64_t trunc_i64(double x) {
  if (!(x > -9.223372036854775808e18 && x < 9.223372036854775808e18)) return INT64_MIN;
  return static_cast<int64_t>(x);
}

struct Grid {
  int64_t n_slots, n_cycles, n_bins;
  double lo, width, ghost;

  int64_t bin(double m) const {
    int64_t b = trunc_i64((m - lo) / width);
    return b < 0 ? 0 : (b >= n_bins ? n_bins - 1 : b);
  }
  int64_t key(int64_t slot, int64_t b, int64_t cycle) const { return (slot * n_bins + b) * n_cycles + cycle; }
};

// The peak's entries in the order they are stored: its own bin, then the
// up-ghost's, then the down-ghost's; a ghost is stored where its bin differs
// from the peak's own. Returns the number of entries (1 to 3).
inline int entries(const Grid& g, double m, int64_t out[3]) {
  const int64_t b = g.bin(m);
  int n = 0;
  out[n++] = b;
  const int64_t up = g.bin(m + g.ghost);
  if (up != b) out[n++] = up;
  const int64_t dn = g.bin(m - g.ghost);
  if (dn != b) out[n++] = dn;
  return n;
}

// Runs parts f(0) to f(nt - 1): f(0) on the calling thread, each other part
// on a thread of its own; a part whose thread cannot be started runs on the
// calling thread after f(0).
template <class F>
void run_parts(int nt, F&& f) {
  std::vector<std::thread> pool;
  std::vector<int> left;
  pool.reserve(size_t(nt > 1 ? nt - 1 : 0));
  for (int t = 1; t < nt; ++t) {
    try {
      pool.emplace_back(f, t);
    } catch (const std::exception&) {
      left.push_back(t);
    }
  }
  f(0);
  for (int t : left) f(t);
  for (auto& th : pool) th.join();
}

// The first of n items of part t when n is split into nt parts.
inline int64_t split(int64_t n, int nt, int t) { return n / nt * t + n % nt * t / nt; }

// Spectra [first[t], first[t + 1]) for part t: ranges of about equal peaks.
std::vector<int64_t> spectrum_ranges(const int64_t* spec_start, int64_t n_spectra, int nt) {
  std::vector<int64_t> first(size_t(nt) + 1, n_spectra);
  const int64_t total = spec_start[n_spectra];
  first[0] = 0;
  for (int t = 1; t < nt; ++t) {
    first[size_t(t)] = std::lower_bound(spec_start, spec_start + n_spectra, split(total, nt, t)) - spec_start;
  }
  return first;
}

int clamp_threads(int threads, int64_t n) {
  if (threads < 1) threads = 1;
  if (n < threads) threads = n > 0 ? int(n) : 1;
  return threads;
}

}  // namespace

extern "C" {

// cell_off: n_cells + 1 entries, zero on entry; on return cell_off[c] is the
// first stored entry of cell c and cell_off[n_cells] the stored total, which
// is also returned (-1 when a thread could not be set up).
int64_t peakstore_count(const float* mz, const int64_t* spec_start, int64_t n_spectra, int64_t n_slots,
                        int64_t n_cycles, double bin_mz_min, double bin_width, int64_t n_bins, double ghost,
                        int64_t* cell_off, int threads) {
  try {
    const Grid g{n_slots, n_cycles, n_bins, bin_mz_min, bin_width, ghost};
    const int nt = clamp_threads(threads, n_spectra);
    const std::vector<int64_t> first = spectrum_ranges(spec_start, n_spectra, nt);
    int64_t* counts = cell_off + 1;
    run_parts(nt, [&](int t) {
      int64_t e[3];
      for (int64_t s = first[size_t(t)]; s < first[size_t(t) + 1]; ++s) {
        const int64_t slot = s % n_slots, cycle = s / n_slots;
        for (int64_t i = spec_start[s]; i < spec_start[s + 1]; ++i) {
          const int n = entries(g, double(mz[i]), e);
          for (int k = 0; k < n; ++k) ++counts[g.key(slot, e[k], cycle)];
        }
      }
    });
    // the counts to offsets: each part sums its block of cells, then adds
    // the blocks before it while it scans its own
    const int64_t n_cells = n_slots * n_bins * n_cycles;
    const int ns = clamp_threads(threads, n_cells / (1 << 16));
    std::vector<int64_t> block(size_t(ns) + 1, 0);
    run_parts(ns, [&](int t) {
      int64_t sum = 0;
      for (int64_t c = split(n_cells, ns, t); c < split(n_cells, ns, t + 1); ++c) sum += counts[c];
      block[size_t(t) + 1] = sum;
    });
    for (int t = 0; t < ns; ++t) block[size_t(t) + 1] += block[size_t(t)];
    run_parts(ns, [&](int t) {
      int64_t run = block[size_t(t)];
      for (int64_t c = split(n_cells, ns, t); c < split(n_cells, ns, t + 1); ++c) {
        run += counts[c];
        counts[c] = run;
      }
    });
    return cell_off[n_cells];
  } catch (const std::exception&) {
    return -1;
  }
}

// Writes every entry at its cell's place and the cell index cell_start
// (n_slots * n_bins rows of n_cycles + 1 offsets, the last the row's end).
// scanbin may be null (3D data): out_scanbin is then 0. Returns 0, or -1
// when a thread could not be set up.
int peakstore_scatter(const float* mz, const float* intensity, const int32_t* scanbin,
                      const int64_t* spec_start, int64_t n_spectra, int64_t n_slots, int64_t n_cycles,
                      double bin_mz_min, double bin_width, int64_t n_bins, double ghost, const int64_t* cell_off,
                      float* out_mz, float* out_int, uint8_t* out_ghost, int32_t* out_scanbin, int32_t* cell_start,
                      int threads) {
  try {
    const Grid g{n_slots, n_cycles, n_bins, bin_mz_min, bin_width, ghost};
    const int nt = clamp_threads(threads, n_spectra);
    const std::vector<int64_t> first = spectrum_ranges(spec_start, n_spectra, nt);
    // per part: each bin's cursor within the current spectrum's cells, set
    // at the spectrum's first entry in that bin
    const size_t nb = size_t(n_bins);
    std::vector<std::vector<int64_t>> cursor(size_t(nt), std::vector<int64_t>(nb, 0));
    std::vector<std::vector<int64_t>> owner(size_t(nt), std::vector<int64_t>(nb, -1));
    run_parts(nt, [&](int t) {
      int64_t* cur = cursor[size_t(t)].data();
      int64_t* own = owner[size_t(t)].data();
      int64_t e[3];
      for (int64_t s = first[size_t(t)]; s < first[size_t(t) + 1]; ++s) {
        const int64_t slot = s % n_slots, cycle = s / n_slots;
        for (int64_t i = spec_start[s]; i < spec_start[s + 1]; ++i) {
          const int n = entries(g, double(mz[i]), e);
          for (int k = 0; k < n; ++k) {
            const int64_t b = e[k];
            if (own[b] != s) {
              own[b] = s;
              cur[b] = cell_off[g.key(slot, b, cycle)];
            }
            const int64_t pos = cur[b]++;
            out_mz[pos] = mz[i];
            out_int[pos] = intensity[i];
            out_ghost[pos] = k > 0;
            out_scanbin[pos] = scanbin ? scanbin[i] : 0;
          }
        }
      }
    });
    const int64_t n_rows = n_slots * n_bins;
    const int nr = clamp_threads(threads, n_rows * (n_cycles + 1) / (1 << 16));
    run_parts(nr, [&](int t) {
      for (int64_t r = split(n_rows, nr, t); r < split(n_rows, nr, t + 1); ++r) {
        int32_t* row = cell_start + r * (n_cycles + 1);
        const int64_t* off = cell_off + r * n_cycles;
        for (int64_t c = 0; c <= n_cycles; ++c) row[c] = static_cast<int32_t>(static_cast<uint32_t>(off[c]));
      }
    });
    return 0;
  } catch (const std::exception&) {
    return -1;
  }
}

}  // extern "C"
