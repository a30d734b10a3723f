// Dense XIC extraction for NVIDIA Hopper (sm_90a): one warp per group of
// queries, slabs staged into a shared-memory ring by cp.async.
//
// Replaces ops/xic_pallas.py::_xic_kernel of the JAX package (entry
// extract_xic_pallas). For each query (observation slot, m/z +- ppm, cycle
// window [c0, c0+W), scan-bin window [s_lo, s_hi)) it reads one contiguous
// slab of the sorted peak store, from cell_start[row, c0] to
// cell_start[row, c0+W] clipped to `slab` peaks and to the store's end, and
// sums per cycle the intensity of the peaks inside the m/z and scan
// windows. With WITH_MZ it also sums intensity * (mz - query centre) and
// returns the weighted mean as observed m/z, or as a delta to the query
// centre (mz_as_delta). A strided cell_start (the coarse view) folds
// 2**stride_shift fine cycles into one cell.
//
// Bound on this card: bytes. A launch must read each covered peak once (m/z
// and intensity, 8 B; its scan bin under a scan window), the window edges
// and the queries, and write W floats per query and plane; it does a few
// flops per byte. Most queries are masked (slot -1), and the output planes
// are most of the bytes. One query's reads form a chain of three dependent
// round trips (query -> window edges -> slab), so the kernel is bound by
// latency unless many loads are in flight on every SM.
//
// Design against that bound (the measurements behind each choice are in
// PERF.md):
// - lane j of a warp holds query j of the warp's group (up to 32): one load
//   brings the group's slots and m/z, a second its window edges; a masked
//   query's zero rows are stored while the edges are on their way, and an
//   empty one's while the first slabs are, so neither costs more than its
//   stores;
// - the store is a float2 (m/z, intensity) per peak, with two narrow
//   planes: the cycle modulo 2**16 (2 B; a slab spans fewer than 2**16
//   cycles, so (cycle - c0) mod 2**16 is the peak's cell) and the scan bin
//   (2 B), read only under a scan window: 10 B a peak, 12 B with the scan
//   window, where the window's cell offsets would cost 4 B a cell;
// - the group's live slabs are cut into pieces of kPiece peaks, and each
//   piece is copied with cp.async (16 B a lane) into a kDepth-deep ring in
//   shared memory: kDepth - 1 pieces are in flight while one is summed;
// - a lane takes one peak of the piece and adds it, if it matches, into
//   the warp's accumulator row in shared memory (intensity and m/z delta
//   side by side); where two matched peaks of one chunk share a cell they
//   add in rounds, in peak order, so every cell is a sequential sum: no
//   atomics, and repeated runs give bit-identical sums;
// - a finished row is written by all 32 lanes with 4-, 2- or 1-float
//   stores (W a multiple of 128, 64, or else), and zeroed for the next;
// - a launch makes 128 warps for each SM (some four waves of the ~30 warps
//   that the ring's shared memory lets reside), each with as many queries
//   as that takes: warps with fewer queries make more edge loads per query,
//   warps with more sum more pieces one after another;
// - the cell index is int32, or int64 for a store of 2**31 entries or more
//   (rawdata/peakstore.cell_index_dtype): its type is a template parameter
//   (Index), and every offset into the store (the window edges, the slab's
//   clamp to the store's end, a piece's start and aligned start) is held in
//   Index. The int32 instantiation is the kernel as it was before the int64
//   one; the int64 one loads 8 B per window edge instead of 4 and does the
//   same sums in the same order. A width the library was not built for is
//   refused at the launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

// the two tuned constants; a build may override them (-DXIC_DEPTH=...), as
// the sweep in xic_sweep.py does
#ifndef XIC_DEPTH
#define XIC_DEPTH 3
#endif
#ifndef XIC_WARPS_PER_SM
#define XIC_WARPS_PER_SM 128
#endif

constexpr int kWarps = 4;     // warps of one block
constexpr int kPiece = 128;   // peaks of one staged piece
constexpr int kDepth = XIC_DEPTH;  // ring slots of one warp
constexpr int kSlot = 144;    // peaks of a slot: a piece's 8-peak aligned span
static_assert(kSlot >= kPiece + 14 && kSlot % 8 == 0, "a slot holds a piece's aligned span");
static_assert(kSlot / 8 <= 32, "one lane copies each 16 B of a slot's cycle and scan-bin planes");
constexpr unsigned kFull = 0xffffffffu;

struct XicParams {
  const float2* peaks;          // [n_peaks] (mz, intensity)
  const unsigned short* cycle;  // [n_peaks] cycle mod 2**16
  const short* scanbin;         // [n_peaks] or null (no scan window)
  long long n_peaks;            // a multiple of 8
  const void* cell_start;  // [n_slots * n_bins, row_len] of Index
  long long row_len;
  int n_slots, n_bins, n_cycles;
  const int* slot_idx;     // [B, Q], -1 = masked query
  const float* query_mz;   // [B, Q]
  const int* cycle_start;  // [B]
  const int* scan_lo;      // [B] or null
  const int* scan_hi;      // [B] or null (exclusive)
  int B, Q, W, slab, stride_shift;
  int group;                   // queries of one warp, 1..32
  int warp_smem;               // bytes of shared memory of one warp
  float lo_factor, hi_factor;  // 1 -+ tol_ppm * 1e-6, rounded to float
  float bin_mz_min, bin_width;
  int mz_as_delta;
  float* out_int;  // [B, Q, W]
  float* out_mz;   // [B, Q, W] or null
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float observed_mz(float it, float d, float qc, int as_delta) {
  if (!(it > 0.f)) return 0.f;
  const float m = __fdiv_rn(d, fmaxf(it, 1e-12f));
  return as_delta ? m : __fadd_rn(qc, m);
}

// vw consecutive floats (4, 2 or 1, aligned to their width)
__device__ __forceinline__ void store_cells(float* out, const float (&v)[4], int vw) {
  if (vw == 4) {
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  } else if (vw == 2) {
    *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
  } else {
    out[0] = v[0];
  }
}

template <bool WITH_MZ>
__device__ __forceinline__ void add_cell(float* acc, int w, float v, float d) {
  if (WITH_MZ) {
    float2* a = reinterpret_cast<float2*>(acc) + w;
    const float2 x = *a;
    *a = make_float2(__fadd_rn(x.x, v), __fadd_rn(x.y, d));
  } else {
    acc[w] = __fadd_rn(acc[w], v);
  }
}

// cells [w, w + vw) of the row: their intensities and (WITH_MZ) their m/z
// delta sums, with vector loads; the row's cells are left zero
template <bool WITH_MZ>
__device__ __forceinline__ void take_cells(float* acc, int w, int vw, float (&it)[4], float (&d)[4]) {
  constexpr int P = WITH_MZ ? 2 : 1;
  float f[8] = {};
  float* a = acc + P * w;
  const int n = P * vw;
  if (n == 8) {
    const float4 x = reinterpret_cast<float4*>(a)[0], y = reinterpret_cast<float4*>(a)[1];
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w; f[4] = y.x; f[5] = y.y; f[6] = y.z; f[7] = y.w;
    reinterpret_cast<float4*>(a)[0] = reinterpret_cast<float4*>(a)[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else if (n == 4) {
    const float4 x = reinterpret_cast<float4*>(a)[0];
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
    reinterpret_cast<float4*>(a)[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else if (n == 2) {
    const float2 x = reinterpret_cast<float2*>(a)[0];
    f[0] = x.x; f[1] = x.y;
    reinterpret_cast<float2*>(a)[0] = make_float2(0.f, 0.f);
  } else {
    f[0] = a[0];
    a[0] = 0.f;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    it[u] = f[P * u];
    d[u] = WITH_MZ ? f[P * u + 1] : 0.f;
  }
}

// one piece of the group's slabs: query j of the group, peaks
// [start, start + count) of the store, staged from the aligned a0
template <typename Index>
struct Piece {
  int j;
  Index start;
  int count;
  Index a0;
  bool last;  // the query's last piece
};

template <bool WITH_MZ, bool SCAN, typename Index>
__global__ void __launch_bounds__(kWarps * 32)
xic_kernel(const XicParams p) {
  constexpr int kPlanes = WITH_MZ ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_queries = (long long)p.B * p.Q;
  const long long q0 = ((long long)blockIdx.x * kWarps + warp) * p.group;
  if (q0 >= n_queries) return;  // whole warp leaves together

  const int W = p.W;
  unsigned char* base = smem + warp * p.warp_smem;
  float2* ring_pk = reinterpret_cast<float2*>(base);
  unsigned short* ring_cy = reinterpret_cast<unsigned short*>(ring_pk + kDepth * kSlot);
  short* ring_sb = reinterpret_cast<short*>(ring_cy + kDepth * kSlot);
  // the row being summed: per cell its intensity, and with WITH_MZ its
  // intensity-weighted m/z delta beside it
  float* acc = reinterpret_cast<float*>(ring_sb + (SCAN ? kDepth * kSlot : 0));

  // ---- round trip 1: lane j holds query q0 + j -------------------------
  const long long q = q0 + lane;
  const bool mine = lane < p.group && q < n_queries;
  int slot = -1, c0 = 0, s_lo = INT_MIN, s_hi = INT_MAX;
  float qmz = 0.f;
  if (mine) {
    const int b = (int)(q / p.Q);
    slot = __ldg(p.slot_idx + q);
    qmz = __ldg(p.query_mz + q);
    c0 = __ldg(p.cycle_start + b);
    if (SCAN) {
      s_lo = __ldg(p.scan_lo + b);
      s_hi = __ldg(p.scan_hi + b);
    }
  }
  // ---- round trip 2: the window edges of the valid ones ---------------
  // the ghost peaks of the store put the whole ppm window into the bin of
  // the query centre: one row, one slab
  Index r0 = 0, r_end = 0;
  if (slot >= 0) {
    int bin = (int)floorf(__fdiv_rn(__fsub_rn(qmz, p.bin_mz_min), p.bin_width));
    bin = min(max(bin, 0), p.n_bins - 1);
    const Index* cs = static_cast<const Index*>(p.cell_start) +
                      ((long long)min(slot, p.n_slots - 1) * p.n_bins + bin) * p.row_len;
    r0 = __ldg(cs + min(max(c0, 0), p.n_cycles));
    r_end = __ldg(cs + min(max(c0 + W, 0), p.n_cycles));
  }

  // cells a lane writes with one store: a row takes all lanes
  const int vw = (W % 128 == 0) ? 4 : ((W % 64 == 0) ? 2 : 1);
  for (int w = lane; w < kPlanes * W; w += 32) acc[w] = 0.f;
  auto zero_rows = [&](unsigned rows) {
    while (rows) {
      const int j = __ffs(rows) - 1;
      rows &= rows - 1;
      float* out_i = p.out_int + (q0 + j) * W;
      float* out_m = WITH_MZ ? p.out_mz + (q0 + j) * W : nullptr;
      const float z[4] = {0.f, 0.f, 0.f, 0.f};
      for (int w = lane * vw; w < W; w += 32 * vw) {
        store_cells(out_i + w, z, vw);
        if (WITH_MZ) store_cells(out_m + w, z, vw);
      }
    }
  };
  // masked queries' zero rows go out while the window edges are on their way
  zero_rows(__ballot_sync(kFull, mine && slot < 0));
  const int len =
      slot >= 0 ? (int)min((long long)min(max(r_end - r0, (Index)0), (Index)p.slab), max(p.n_peaks - r0, 0LL)) : 0;

  // ---- the live slabs as a list of pieces ------------------------------
  const int n_pieces = (len + kPiece - 1) / kPiece;
  int incl = n_pieces;  // inclusive prefix over the lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  const int excl = incl - n_pieces;
  const int total = __shfl_sync(kFull, incl, 31);

  auto piece = [&](int i) {
    Piece<Index> pc;
    pc.j = __popc(__ballot_sync(kFull, incl <= i));  // first lane whose pieces reach past i
    const int k = i - __shfl_sync(kFull, excl, pc.j);
    const int n = __shfl_sync(kFull, len, pc.j);
    pc.start = __shfl_sync(kFull, r0, pc.j) + (Index)k * kPiece;
    pc.count = min(kPiece, n - k * kPiece);
    pc.a0 = pc.start & ~(Index)7;
    pc.last = (k + 1) * kPiece >= n;
    return pc;
  };
  auto stage = [&](int i) {
    if (i < total) {
      const Piece<Index> pc = piece(i);
      const int span = (int)(((pc.start + pc.count + 7) & ~(Index)7) - pc.a0);  // <= kSlot
      const int s = (i % kDepth) * kSlot;
      for (int c = lane; c < span / 2; c += 32) cp_async16(ring_pk + s + 2 * c, p.peaks + pc.a0 + 2 * c);
      if (lane < span / 8) {
        cp_async16(ring_cy + s + 8 * lane, p.cycle + pc.a0 + 8 * lane);
        if (SCAN) cp_async16(ring_sb + s + 8 * lane, p.scanbin + pc.a0 + 8 * lane);
      }
    }
    cp_async_commit();  // one group per piece, empty past the last
  };

#pragma unroll
  for (int i = 0; i < kDepth - 1; ++i) stage(i);
  // and the empty ones' while the first slabs are on their way
  zero_rows(__ballot_sync(kFull, slot >= 0 && len == 0));
  for (int i = 0; i < total; ++i) {
    stage(i + kDepth - 1);
    cp_async_wait<kDepth - 1>();  // piece i has landed for this lane
    __syncwarp();                 // ... and for every lane
    const Piece<Index> pc = piece(i);
    const int s = (i % kDepth) * kSlot + (int)(pc.start - pc.a0);
    const float mz_q = __shfl_sync(kFull, qmz, pc.j);
    const float qlo = __fmul_rn(mz_q, p.lo_factor);
    const float qhi = __fmul_rn(mz_q, p.hi_factor);
    const float qc = __fmul_rn(__fadd_rn(qlo, qhi), 0.5f);
    const int lo_s = SCAN ? __shfl_sync(kFull, s_lo, pc.j) : INT_MIN;
    const int hi_s = SCAN ? __shfl_sync(kFull, s_hi, pc.j) : INT_MAX;
    // the slab's fine cycles lie in [c0 << shift, (c0 + W) << shift), fewer
    // than 2**16 of them, so their distance to c0's first fine cycle,
    // taken mod 2**16, is exact
    const unsigned c0_fine = (unsigned)(__shfl_sync(kFull, c0, pc.j) * (1 << p.stride_shift));

    for (int c = 0; c < pc.count; c += 32) {
      const int k = c + lane;
      bool ok = false;
      int w = 0;
      float v = 0.f, d = 0.f;
      if (k < pc.count) {
        const float2 pk = ring_pk[s + k];
        w = (int)(((ring_cy[s + k] - c0_fine) & 0xffffu) >> p.stride_shift);
        ok = pk.x >= qlo && pk.x <= qhi && w < W;
        if (SCAN) ok = ok && ring_sb[s + k] >= lo_s && ring_sb[s + k] < hi_s;
        v = pk.y;
        if (WITH_MZ) d = __fmul_rn(pk.y, __fsub_rn(pk.x, qc));
      }
      const unsigned matched = __ballot_sync(kFull, ok);
      if (!matched) continue;
      // the common case, one matched peak per cell: every lane adds at once
      const unsigned below = matched & ((1u << lane) - 1);
      const int w_prev = __shfl_sync(kFull, w, below ? 31 - __clz(below) : lane);
      if (!__any_sync(kFull, ok && below && w_prev == w)) {
        if (ok) add_cell<WITH_MZ>(acc, w, v, d);
        __syncwarp();
        continue;
      }
      // cells rise along the lanes: a lane's run of equal cells starts at
      // the last head at or below it; its rank is the number of matched
      // lanes of its run below it, and rank r adds in round r
      const int w_up = __shfl_up_sync(kFull, w, 1);
      const unsigned heads = __ballot_sync(kFull, lane == 0 || w_up != w);
      const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1;
      const int head = 31 - __clz(heads & upto);
      const int rank = __popc(matched & ((1u << lane) - 1) & ~((1u << head) - 1));
      const int rounds = __reduce_max_sync(kFull, ok ? rank : 0);
      for (int r = 0; r <= rounds; ++r) {
        if (ok && rank == r) add_cell<WITH_MZ>(acc, w, v, d);
        __syncwarp();
      }
    }

    if (pc.last) {  // the query's row is complete: write it, zero the row
      const long long qj = q0 + pc.j;
      float* out_i = p.out_int + qj * W;
      float* out_m = WITH_MZ ? p.out_mz + qj * W : nullptr;
      const int as_delta = p.mz_as_delta;
      for (int w = lane * vw; w < W; w += 32 * vw) {
        float it[4], m[4];
        take_cells<WITH_MZ>(acc, w, vw, it, m);
#pragma unroll
        for (int u = 0; u < 4; ++u) m[u] = observed_mz(it[u], m[u], qc, as_delta);
        store_cells(out_i + w, it, vw);
        if (WITH_MZ) store_cells(out_m + w, m, vw);
      }
    }
    __syncwarp();  // the slot and the row are free for the next piece
  }
}

template <bool WITH_MZ, bool SCAN, typename Index>
int launch(const XicParams& p, unsigned blocks, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(xic_kernel<WITH_MZ, SCAN, Index>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  xic_kernel<WITH_MZ, SCAN, Index><<<blocks, kWarps * 32, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename Index>
int launch_variant(const XicParams& p, bool with_mz, bool scan, unsigned blocks, size_t smem, cudaStream_t s) {
  if (with_mz) {
    return scan ? launch<true, true, Index>(p, blocks, smem, s) : launch<true, false, Index>(p, blocks, smem, s);
  }
  return scan ? launch<false, true, Index>(p, blocks, smem, s) : launch<false, false, Index>(p, blocks, smem, s);
}

}  // namespace

// index_bytes: the cell index's width, 4 (int32) or 8 (int64); any other
// is refused with cudaErrorInvalidValue, before anything is launched
extern "C" int xic_launch(
    const void* peaks, const void* cycle, const void* scanbin, long long n_peaks,
    const void* cell_start, int index_bytes, long long row_len,
    int n_slots, int n_bins, int n_cycles,
    const void* slot_idx, const void* query_mz, const void* cycle_start,
    const void* scan_lo, const void* scan_hi,
    int B, int Q, int W, int slab, int stride_shift,
    float lo_factor, float hi_factor, float bin_mz_min, float bin_width,
    int with_mz, int mz_as_delta,
    void* out_int, void* out_mz, void* stream) {
  if (index_bytes != 4 && index_bytes != 8) return (int)cudaErrorInvalidValue;
  XicParams p;
  p.peaks = static_cast<const float2*>(peaks);
  p.cycle = static_cast<const unsigned short*>(cycle);
  p.scanbin = static_cast<const short*>(scanbin);
  p.n_peaks = n_peaks;
  p.cell_start = cell_start;
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
  if (n_queries == 0 || W <= 0) return 0;
  const bool scan = scan_lo != nullptr;
  const int planes = with_mz ? 2 : 1;
  // ring (float2 + cycle + scan bin per peak) and accumulator rows, 16-B aligned
  p.warp_smem = kDepth * kSlot * (8 + 2 + (scan ? 2 : 0)) + ((planes * W * 4 + 15) & ~15);
  // queries of one warp: XIC_WARPS_PER_SM warps for each SM
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long per_wave = (long long)sms * XIC_WARPS_PER_SM;
  p.group = (int)((n_queries + per_wave - 1) / per_wave);
  p.group = p.group < 1 ? 1 : (p.group > 32 ? 32 : p.group);
  const long long per_block = (long long)kWarps * p.group;
  const unsigned blocks = (unsigned)((n_queries + per_block - 1) / per_block);
  const size_t smem = (size_t)kWarps * p.warp_smem;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (index_bytes == 8) return launch_variant<long long>(p, with_mz, scan, blocks, smem, s);
  return launch_variant<int>(p, with_mz, scan, blocks, smem, s);
}
