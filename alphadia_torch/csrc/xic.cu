// Dense XIC extraction for NVIDIA Hopper (sm_90a), one warp per query.
//
// Replaces ops/xic_pallas.py::_xic_kernel of the JAX package (entry
// extract_xic_pallas). For each query (observation slot, m/z +- ppm, cycle
// window [c0, c0+W), scan-bin window [s_lo, s_hi)) it reads one contiguous
// slab of the sorted peak store, from cell_start[row, c0] to
// cell_start[row, c0+W] clipped to `slab` peaks, and sums per cycle the
// intensity of the peaks inside the m/z and scan windows. With WITH_MZ it
// also sums intensity * (mz - query centre) and returns the weighted mean as
// observed m/z, or as a delta to the query centre (mz_as_delta).
// cycle_stride (a power of two) folds fine per-peak cycles onto the coarse
// cells of a strided cell_start view.
//
// Bound on this card: bytes. A query reads its slab once (16 bytes a peak,
// at most `slab` peaks, none for an empty query), two cell_start offsets,
// and writes W floats per output plane; it does a few flops per byte. So
// the least time is (slab peaks * 16 + B*Q*W*4 per plane) / 3.35 TB/s.
//
// Design against that bound:
// - the packed store holds one float4 (mz, intensity, cycle, scanbin) per
//   peak, so a warp reads 32 consecutive peaks with one coalesced 512-byte
//   load, and every field of a peak arrives together;
// - peaks of a (slot, bin) row are sorted by cycle, so each cycle's cell is
//   a contiguous run of lanes: a segmented warp scan keyed by the cycle
//   sums each run, and its last lane adds the run to a per-warp shared
//   accumulator. No atomics: repeated runs give bit-identical sums;
// - an empty query (invalid slot, or no peaks in the window) writes zeros
//   and leaves at once; most fragment queries are empty;
// - outputs are written coalesced from shared memory, W consecutive floats
//   per query.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

struct XicParams {
  const float4* peaks;  // [n_peaks] (mz, intensity, cycle, scanbin)
  long long n_peaks;
  const int* cell_start;  // [n_slots * n_bins, row_len]
  long long row_len;
  int n_slots, n_bins, n_cycles;
  const int* slot_idx;     // [B, Q], -1 = masked query
  const float* query_mz;   // [B, Q]
  const int* cycle_start;  // [B]
  const int* scan_lo;      // [B] or null
  const int* scan_hi;      // [B] or null (exclusive)
  int B, Q, W, slab, stride_shift;
  float lo_factor, hi_factor;  // 1 -+ tol_ppm * 1e-6, rounded to float
  float bin_mz_min, bin_width;
  int mz_as_delta;
  float* out_int;  // [B, Q, W]
  float* out_mz;   // [B, Q, W] or null
};

template <bool WITH_MZ>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
xic_kernel(const XicParams p) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (q >= (long long)p.B * p.Q) return;  // whole warp leaves together

  const int W = p.W;
  float* acc_i = smem + (long long)warp * W * (WITH_MZ ? 2 : 1);
  float* acc_d = acc_i + W;
  float* out_i = p.out_int + q * W;
  float* out_m = WITH_MZ ? p.out_mz + q * W : nullptr;

  const int b = (int)(q / p.Q);
  const int slot = p.slot_idx[q];
  const float qmz = p.query_mz[q];
  const float qlo = __fmul_rn(qmz, p.lo_factor);
  const float qhi = __fmul_rn(qmz, p.hi_factor);

  // the ghost peaks of the store put the whole ppm window into the bin of
  // the query centre: one row, one slab
  int bin = (int)floorf(__fdiv_rn(__fsub_rn(qmz, p.bin_mz_min), p.bin_width));
  bin = min(max(bin, 0), p.n_bins - 1);
  const int slot_c = min(max(slot, 0), p.n_slots - 1);
  const int* cs = p.cell_start + ((long long)slot_c * p.n_bins + bin) * p.row_len;
  const int c0 = p.cycle_start[b];
  const int r0 = cs[min(max(c0, 0), p.n_cycles)];
  const int r_end = cs[min(max(c0 + W, 0), p.n_cycles)];
  const int slab_len = slot >= 0 ? min(max(r_end - r0, 0), p.slab) : 0;

  if (slab_len == 0) {
    for (int w = lane; w < W; w += 32) {
      out_i[w] = 0.f;
      if (WITH_MZ) out_m[w] = 0.f;
    }
    return;
  }

  for (int w = lane; w < W; w += 32) {
    acc_i[w] = 0.f;
    if (WITH_MZ) acc_d[w] = 0.f;
  }
  __syncwarp();

  const float qc = __fmul_rn(__fadd_rn(qlo, qhi), 0.5f);
  const int s_lo = p.scan_lo ? p.scan_lo[b] : INT_MIN;
  const int s_hi = p.scan_hi ? p.scan_hi[b] : INT_MAX;

  for (int base = 0; base < slab_len; base += 32) {
    const int k = base + lane;
    const bool live = k < slab_len && (long long)r0 + k < p.n_peaks;
    float v = 0.f, d = 0.f;
    int w = INT_MAX;  // lanes past the slab sort after every real cycle
    if (live) {
      const float4 pk = __ldg(&p.peaks[r0 + k]);
      const int cyc = (int)pk.z;  // -1 marks padding
      w = (cyc >= 0 ? (cyc >> p.stride_shift) : -1) - c0;
      const int sb = (int)pk.w;
      const bool ok = pk.x >= qlo && pk.x <= qhi && sb >= s_lo && sb < s_hi;
      if (ok) {
        v = pk.y;
        if (WITH_MZ) d = __fmul_rn(pk.y, __fsub_rn(pk.x, qc));
      }
    }
    // segmented inclusive scan: cycles rise along the lanes, so a lane
    // `off` below with the same cycle means the whole span shares it
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v_up = __shfl_up_sync(kFull, v, off);
      const float d_up = WITH_MZ ? __shfl_up_sync(kFull, d, off) : 0.f;
      const int w_up = __shfl_up_sync(kFull, w, off);
      if (lane >= off && w_up == w) {
        v = __fadd_rn(v, v_up);
        if (WITH_MZ) d = __fadd_rn(d, d_up);
      }
    }
    const int w_next = __shfl_down_sync(kFull, w, 1);
    const bool tail = lane == 31 || w_next != w;
    if (live && tail && w >= 0 && w < W) {
      acc_i[w] = __fadd_rn(acc_i[w], v);
      if (WITH_MZ) acc_d[w] = __fadd_rn(acc_d[w], d);
    }
    __syncwarp();
  }

  for (int w = lane; w < W; w += 32) {
    const float it = acc_i[w];
    out_i[w] = it;
    if (WITH_MZ) {
      float m = 0.f;
      if (it > 0.f) {
        m = __fdiv_rn(acc_d[w], fmaxf(it, 1e-12f));
        if (!p.mz_as_delta) m = __fadd_rn(qc, m);
      }
      out_m[w] = m;
    }
  }
}

}  // namespace

extern "C" int xic_launch(
    const void* peaks, long long n_peaks,
    const void* cell_start, long long row_len,
    int n_slots, int n_bins, int n_cycles,
    const void* slot_idx, const void* query_mz, const void* cycle_start,
    const void* scan_lo, const void* scan_hi,
    int B, int Q, int W, int slab, int stride_shift,
    float lo_factor, float hi_factor, float bin_mz_min, float bin_width,
    int with_mz, int mz_as_delta,
    void* out_int, void* out_mz, void* stream) {
  XicParams p;
  p.peaks = static_cast<const float4*>(peaks);
  p.n_peaks = n_peaks;
  p.cell_start = static_cast<const int*>(cell_start);
  p.row_len = row_len;
  p.n_slots = n_slots;
  p.n_bins = n_bins;
  p.n_cycles = n_cycles;
  p.slot_idx = static_cast<const int*>(slot_idx);
  p.query_mz = static_cast<const float*>(query_mz);
  p.cycle_start = static_cast<const int*>(cycle_start);
  p.scan_lo = static_cast<const int*>(scan_lo);
  p.scan_hi = static_cast<const int*>(scan_hi);
  p.B = B;
  p.Q = Q;
  p.W = W;
  p.slab = slab;
  p.stride_shift = stride_shift;
  p.lo_factor = lo_factor;
  p.hi_factor = hi_factor;
  p.bin_mz_min = bin_mz_min;
  p.bin_width = bin_width;
  p.mz_as_delta = mz_as_delta;
  p.out_int = static_cast<float*>(out_int);
  p.out_mz = static_cast<float*>(out_mz);

  const long long n_queries = (long long)B * Q;
  if (n_queries == 0) return 0;
  const unsigned blocks = (unsigned)((n_queries + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const size_t smem = (size_t)kWarpsPerBlock * W * (with_mz ? 2 : 1) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_mz) {
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(xic_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    }
    xic_kernel<true><<<blocks, kWarpsPerBlock * 32, smem, s>>>(p);
  } else {
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(xic_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    }
    xic_kernel<false><<<blocks, kWarpsPerBlock * 32, smem, s>>>(p);
  }
  return (int)cudaGetLastError();
}
