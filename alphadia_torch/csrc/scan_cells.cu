// Scan-resolved extraction for NVIDIA Hopper (sm_90a): the 4D path's
// per-mobility-scan-bin XICs and scan profiles, one warp per group of
// queries, slabs staged into a shared-memory ring by cp.async.
//
// Replaces no Pallas kernel: the JAX package computes the two functions with
// XLA (extract_xic_4d and extract_scan_profile of its ops/xic.py), and so
// did the port (ops/xic.py), whose plain versions spread each
// query's whole slab into S one-hot channels and take float64 prefix sums
// over [B, Q, slab, S]. This kernel reads only a query's live window.
//
// For each query (observation slot, m/z +- ppm, cycle window) it reads one
// contiguous slab of the sorted peak store, from cell_start[row, e_0] to
// cell_start[row, e_W] clipped to `slab` peaks and to the store's end, and
// adds each peak inside the m/z window whose scan bin lies in [0, S) to
// the cell (scan bin, w) of its window's cells. Cell w holds the peaks
// between the edges cell_start[row, e_w] and cell_start[row, e_{w+1}]:
// - cells mode, e_w = c0 + w for w in [0, W] (clamped to [0, n_cycles]):
//   out [B, Q, S, W], and with WITH_MZ the summed intensity * (mz - query
//   centre) over the summed intensity, the m/z delta plane;
// - profile mode (cycle_stop given), W = 1 and the edges cycle_start and
//   cycle_stop: out [B, Q, S], the window's intensity per scan bin.
// Cells come from the window edges alone, so a strided cell_start (the
// coarse view, whose cells merge cycles) needs nothing else, and no cycle
// plane is read.
//
// Bound on this card: bytes. A launch must read each covered peak once
// (m/z and intensity, 8 B, and its scan bin, 2 B), a valid query's W+1
// window edges and the queries, and write S*W floats per query and plane;
// it does a few operations per byte. A query's reads form a chain of
// dependent round trips (query -> window edges -> slab), so the kernel is
// bound by latency unless many loads are in flight on every SM.
//
// Design against that bound:
// - lane j of a warp holds query j of the warp's group (up to 32): one load
//   brings the group's slots and m/z, a second the first and last window
//   edge of each; masked queries' zero rows are stored while those are on
//   their way, empty ones' while the first slabs are;
// - the group's live slabs are cut into pieces of kPiece peaks, and each
//   piece is copied with cp.async (16 B a lane) into a kDepth-deep ring in
//   shared memory, kDepth - 1 pieces in flight while one is summed; a
//   query's first piece brings its W+1 window edges into the ring beside
//   it (4 or 8 B a copy), so the edges, too, arrive while the previous
//   query is summed, and each is loaded once;
// - a lane takes one peak of the piece and, if it matches, finds its cell
//   by a binary search of the query's edges (as offsets into its slab) and
//   adds it into the warp's S x W accumulator row in shared memory, in
//   float64 (the plain version's and the reference's precision: both take
//   float64 differences of prefix sums), rounded once to float32 at the
//   end; where matched peaks of one round of 32 share a cell they add in
//   rounds, in peak order, so every cell is a sequential sum: no atomics,
//   and repeated runs give bit-identical sums;
// - a finished row is written by all 32 lanes with 4-, 2- or 1-float
//   stores (S*W a multiple of 4, 2, or else), and zeroed for the next;
// - the accumulator row bounds S*W by shared memory (scan_cells_smem_bytes
//   a warp against the card's opt-in limit of a block); a block has up to
//   kMaxWarps warps, as many as fit, and a launch makes kWaves waves of
//   the warps that can reside, each with as many queries as that
//   takes;
// - the cell index is int32, or int64 for a store of 2**31 entries or more:
//   its type is a template parameter (Index), and every offset into the
//   store is held in Index. A width the library was not built for is
//   refused at the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 4;  // warps of one block, at most
constexpr int kWaves = 4;     // waves of resident warps a launch makes
constexpr int kPiece = 128;   // peaks of one staged piece
constexpr int kDepth = 3;     // ring slots of one warp
constexpr int kSlot = 144;    // peaks of a slot: a piece's 8-peak aligned span
static_assert(kSlot >= kPiece + 14 && kSlot % 8 == 0, "a slot holds a piece's aligned span");
static_assert(kSlot / 8 <= 32, "one lane copies each 16 B of a slot's scan-bin plane");
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr long long align16(long long x) { return (x + 15) & ~15LL; }

// byte offsets of one warp's shared memory: the accumulator planes
// (float64, S*W each), the ring's peaks (float2) and scan bins (i16), the
// ring's window edges (Index, W+1 rounded up to 4 a slot), and the current
// query's edges as offsets into its slab (int, W+1)
struct Layout {
  long long acc, peaks, edges, rel, scan, total;
};

__host__ __device__ inline Layout layout(int S, int W, int planes, int index_bytes) {
  Layout l;
  const long long edge_slot = (long long)((W + 4) & ~3) * index_bytes;
  l.acc = 0;
  l.peaks = align16((long long)planes * S * W * 8);
  l.edges = l.peaks + kDepth * kSlot * 8;
  l.rel = l.edges + align16(kDepth * edge_slot);
  l.scan = l.rel + align16((long long)(W + 1) * 4);
  l.total = l.scan + align16(kDepth * kSlot * 2);
  return l;
}

struct ScanCellsParams {
  const float2* peaks;   // [n_peaks] (mz, intensity)
  const short* scanbin;  // [n_peaks]
  long long n_peaks;     // a multiple of 8
  const void* cell_start;  // [n_slots * n_bins, row_len] of Index
  long long row_len;
  int n_slots, n_bins, n_cycles;
  const int* slot_idx;     // [B, Q], -1 = masked query
  const float* query_mz;   // [B, Q]
  const int* cycle_start;  // [B]
  const int* cycle_stop;   // [B] (profile mode) or null (cells mode)
  int B, Q, S, W, slab;
  int group;  // queries of one warp, 1..32
  int warps;  // warps of one block
  float lo_factor, hi_factor;  // 1 -+ tol_ppm * 1e-6, rounded to float
  float bin_mz_min, bin_width;
  float* out_int;  // [B, Q, S, W]
  float* out_mz;   // [B, Q, S, W] or null
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// one window edge, 4 or 8 B
template <typename Index>
__device__ __forceinline__ void cp_async_edge(Index* smem, const Index* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (sizeof(Index) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// one piece of the group's slabs: query j of the group, peaks
// [start, start + count) of the store, the piece's offset into the query's
// slab, staged from the aligned a0
template <typename Index>
struct Piece {
  int j;
  Index start;
  int offset;
  int count;
  Index a0;
  bool first, last;  // the query's first and last piece
};

template <bool WITH_MZ, typename Index>
__global__ void __launch_bounds__(kMaxWarps * 32)
scan_cells_kernel(const ScanCellsParams p) {
  constexpr int kPlanes = WITH_MZ ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_queries = (long long)p.B * p.Q;
  const long long q0 = ((long long)blockIdx.x * p.warps + warp) * p.group;
  if (q0 >= n_queries) return;  // whole warp leaves together

  const int S = p.S, W = p.W, SW = S * W;
  const Layout lay = layout(S, W, kPlanes, (int)sizeof(Index));
  unsigned char* base = smem + warp * lay.total;
  // the row being summed: per plane its S*W cells, scan bin major
  double* acc_i = reinterpret_cast<double*>(base + lay.acc);
  double* acc_d = acc_i + SW;
  float2* ring_pk = reinterpret_cast<float2*>(base + lay.peaks);
  Index* ring_edge = reinterpret_cast<Index*>(base + lay.edges);
  int* rel = reinterpret_cast<int*>(base + lay.rel);
  short* ring_sb = reinterpret_cast<short*>(base + lay.scan);
  const int edge_slot = (W + 4) & ~3;

  // ---- round trip 1: lane j holds query q0 + j -------------------------
  const long long q = q0 + lane;
  const bool mine = lane < p.group && q < n_queries;
  int slot = -1, c_lo = 0, c_hi = 0;
  float qmz = 0.f;
  if (mine) {
    const int b = (int)(q / p.Q);
    slot = __ldg(p.slot_idx + q);
    qmz = __ldg(p.query_mz + q);
    c_lo = __ldg(p.cycle_start + b);
    c_hi = p.cycle_stop ? __ldg(p.cycle_stop + b) : c_lo + W;
  }
  // ---- round trip 2: the first and last window edge of the valid ones --
  // the ghost peaks of the store put the whole ppm window into the bin of
  // the query centre: one row, one slab
  long long row = 0;
  Index r0 = 0, r_end = 0;
  if (slot >= 0) {
    int bin = (int)floorf(__fdiv_rn(__fsub_rn(qmz, p.bin_mz_min), p.bin_width));
    bin = min(max(bin, 0), p.n_bins - 1);
    row = ((long long)min(slot, p.n_slots - 1) * p.n_bins + bin) * p.row_len;
    const Index* cs = static_cast<const Index*>(p.cell_start) + row;
    r0 = __ldg(cs + min(max(c_lo, 0), p.n_cycles));
    r_end = __ldg(cs + min(max(c_hi, 0), p.n_cycles));
  }

  // cells a lane writes with one store: a row takes all lanes
  const int vw = (SW % 4 == 0) ? 4 : ((SW % 2 == 0) ? 2 : 1);
  for (int c = lane; c < kPlanes * SW; c += 32) acc_i[c] = 0.0;
  auto zero_rows = [&](unsigned rows) {
    while (rows) {
      const int j = __ffs(rows) - 1;
      rows &= rows - 1;
      float* out_i = p.out_int + (q0 + j) * SW;
      float* out_m = WITH_MZ ? p.out_mz + (q0 + j) * SW : nullptr;
      const float z[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = lane * vw; c < SW; c += 32 * vw) {
        store_cells(out_i + c, z, vw);
        if (WITH_MZ) store_cells(out_m + c, z, vw);
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
    pc.offset = k * kPiece;
    pc.start = __shfl_sync(kFull, r0, pc.j) + (Index)pc.offset;
    pc.count = min(kPiece, n - pc.offset);
    pc.a0 = pc.start & ~(Index)7;
    pc.first = k == 0;
    pc.last = pc.offset + kPiece >= n;
    return pc;
  };
  auto stage = [&](int i) {
    if (i < total) {
      const Piece<Index> pc = piece(i);
      const int span = (int)(((pc.start + pc.count + 7) & ~(Index)7) - pc.a0);  // <= kSlot
      const int s = (i % kDepth) * kSlot;
      for (int c = lane; c < span / 2; c += 32) cp_async16(ring_pk + s + 2 * c, p.peaks + pc.a0 + 2 * c);
      if (lane < span / 8) cp_async16(ring_sb + s + 8 * lane, p.scanbin + pc.a0 + 8 * lane);
      if (pc.first) {  // the query's W+1 window edges, as the plain version looks them up
        const Index* cs = static_cast<const Index*>(p.cell_start) + __shfl_sync(kFull, row, pc.j);
        const int lo = __shfl_sync(kFull, c_lo, pc.j), hi = __shfl_sync(kFull, c_hi, pc.j);
        Index* e = ring_edge + (i % kDepth) * edge_slot;
        for (int w = lane; w <= W; w += 32) {
          cp_async_edge(e + w, cs + min(max(w == W ? hi : lo + w, 0), p.n_cycles));
        }
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
    if (pc.first) {  // the query's edges as offsets into its slab, clipped to it
      const Index* e = ring_edge + (i % kDepth) * edge_slot;
      const Index e0 = e[0];
      for (int w = lane; w <= W; w += 32) rel[w] = (int)min(max(e[w] - e0, (Index)0), (Index)p.slab);
      __syncwarp();
    }
    const int s = (i % kDepth) * kSlot + (int)(pc.start - pc.a0);
    const float mz_q = __shfl_sync(kFull, qmz, pc.j);
    const float qlo = __fmul_rn(mz_q, p.lo_factor);
    const float qhi = __fmul_rn(mz_q, p.hi_factor);
    const float qc = __fmul_rn(__fadd_rn(qlo, qhi), 0.5f);

    for (int c = 0; c < pc.count; c += 32) {
      const int k = c + lane;
      bool ok = false;
      int cell = 0;
      float v = 0.f, d = 0.f;
      if (k < pc.count) {
        const float2 pk = ring_pk[s + k];
        const int sb = ring_sb[s + k];
        ok = pk.x >= qlo && pk.x <= qhi && sb >= 0 && sb < S;
        v = pk.y;
        if (WITH_MZ) d = __fmul_rn(pk.y, __fsub_rn(pk.x, qc));
        if (ok) {
          // the last cell whose first edge lies at or before the peak:
          // rel[lo] <= off < rel[hi], and off < len <= rel[W]
          const int off = pc.offset + k;
          int lo = 0, hi = W;
          while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (rel[mid] <= off) lo = mid; else hi = mid;
          }
          cell = sb * W + lo;
        }
      }
      if (!__ballot_sync(kFull, ok)) continue;
      // matched lanes of one cell add in rounds, in lane (= peak) order
      const unsigned peers = __match_any_sync(kFull, ok ? cell : -1 - lane);
      const int rank = __popc(peers & ((1u << lane) - 1));
      const int rounds = __reduce_max_sync(kFull, ok ? rank : 0);
      for (int r = 0; r <= rounds; ++r) {
        if (ok && rank == r) {
          acc_i[cell] = __dadd_rn(acc_i[cell], (double)v);
          if (WITH_MZ) acc_d[cell] = __dadd_rn(acc_d[cell], (double)d);
        }
        __syncwarp();
      }
    }

    if (pc.last) {  // the query's row is complete: write it, zero the row
      const long long qj = q0 + pc.j;
      float* out_i = p.out_int + qj * SW;
      float* out_m = WITH_MZ ? p.out_mz + qj * SW : nullptr;
      for (int c = lane * vw; c < SW; c += 32 * vw) {
        float it[4] = {0.f, 0.f, 0.f, 0.f}, m[4] = {0.f, 0.f, 0.f, 0.f};
        for (int u = 0; u < vw; ++u) {
          it[u] = __double2float_rn(acc_i[c + u]);
          acc_i[c + u] = 0.0;
          if (WITH_MZ) {
            const float dm = __double2float_rn(acc_d[c + u]);
            acc_d[c + u] = 0.0;
            m[u] = it[u] > 0.f ? __fdiv_rn(dm, fmaxf(it[u], 1e-12f)) : 0.f;
          }
        }
        store_cells(out_i + c, it, vw);
        if (WITH_MZ) store_cells(out_m + c, m, vw);
      }
    }
    __syncwarp();  // the slot and the row are free for the next piece
  }
}

template <bool WITH_MZ, typename Index>
int launch(const ScanCellsParams& p, unsigned blocks, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_cells_kernel<WITH_MZ, Index>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  scan_cells_kernel<WITH_MZ, Index><<<blocks, p.warps * 32, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// shared memory one warp needs for S scan bins and W cells
extern "C" long long scan_cells_smem_bytes(int S, int W, int with_mz, int index_bytes) {
  return layout(S, W, with_mz ? 2 : 1, index_bytes).total;
}

// the most shared memory a block of the current device can opt in to
extern "C" int scan_cells_smem_limit() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

// index_bytes: the cell index's width, 4 (int32) or 8 (int64); cycle_stop
// null for cells mode [B, Q, S, W], else profile mode with W = 1. Any other
// width, a W or S below 1, a negative slab, or a warp's shared memory past
// the card's limit is refused with cudaErrorInvalidValue before anything is
// launched
extern "C" int scan_cells_launch(
    const void* peaks, const void* scanbin, long long n_peaks,
    const void* cell_start, int index_bytes, long long row_len,
    int n_slots, int n_bins, int n_cycles,
    const void* slot_idx, const void* query_mz, const void* cycle_start, const void* cycle_stop,
    int B, int Q, int S, int W, int slab,
    float lo_factor, float hi_factor, float bin_mz_min, float bin_width,
    int with_mz, void* out_int, void* out_mz, void* stream) {
  if ((index_bytes != 4 && index_bytes != 8) || S < 1 || W < 1 || slab < 0 || (cycle_stop && W != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  ScanCellsParams p;
  p.peaks = static_cast<const float2*>(peaks);
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
  p.cycle_stop = static_cast<const int*>(cycle_stop);
  p.B = B;
  p.Q = Q;
  p.S = S;
  p.W = W;
  p.slab = slab;
  p.lo_factor = lo_factor;
  p.hi_factor = hi_factor;
  p.bin_mz_min = bin_mz_min;
  p.bin_width = bin_width;
  p.out_int = static_cast<float*>(out_int);
  p.out_mz = static_cast<float*>(out_mz);

  const long long n_queries = (long long)B * Q;
  if (n_queries == 0) return 0;
  const long long warp_smem = scan_cells_smem_bytes(S, W, with_mz, index_bytes);
  int dev = 0, sms = 132, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  const int optin = scan_cells_smem_limit();
  if (warp_smem > optin) return (int)cudaErrorInvalidValue;
  p.warps = (int)(optin / warp_smem);
  p.warps = p.warps > kMaxWarps ? kMaxWarps : p.warps;
  // warps that can reside (the SM keeps 1 KB of its shared memory for each
  // block), kWaves waves of them
  const long long block_smem = p.warps * warp_smem;
  long long blocks_per_sm = per_sm / (block_smem + 1024);
  blocks_per_sm = blocks_per_sm < 1 ? 1 : blocks_per_sm;
  const long long per_wave = (long long)sms * blocks_per_sm * p.warps * kWaves;
  const long long group = (n_queries + per_wave - 1) / per_wave;
  p.group = (int)(group < 1 ? 1 : (group > 32 ? 32 : group));
  const long long per_block = (long long)p.warps * p.group;
  const unsigned blocks = (unsigned)((n_queries + per_block - 1) / per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (index_bytes == 8) {
    return with_mz ? launch<true, long long>(p, blocks, block_smem, s) : launch<false, long long>(p, blocks, block_smem, s);
  }
  return with_mz ? launch<true, int>(p, blocks, block_smem, s) : launch<false, int>(p, blocks, block_smem, s);
}
