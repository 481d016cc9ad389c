// Device code of kernel A (csr_aggregate.cu), which also fills kernel B's
// aggregate: a CSR aggregation whose work split does not depend on how the
// arcs are spread over rows.
//
//     out[d, :] = inv[d] * sum_{e in row d} w[e] * h[src[e], :]
//
// Merge path (Merrill & Garland, "Merge-based parallel sparse matrix-vector
// multiplication", SC 2016). The n row ends and the E arcs form one merged
// list of n + E items: arc j comes before the end of row i when
// j < row_ptr[i+1]. Warp g owns items [g*K, (g+1)*K) and finds where they
// start and stop, (rows ended, arcs consumed), by a 16-ary search in
// row_ptr (a half-warp for each end). A row belongs to the warp that holds
// its first item. A row whose items end within that warp's range or the
// next one's is walked whole by it, so a warp walks at most 2K items; a
// row of 100,000 arcs (a hub node, or the assembly's padding row) is cut
// over many warps instead, and a run of empty rows costs one item each.
//
// A cut row leaves one partial sum in each warp it crosses: a "tail" (the
// row still open where warp g stops) in tail[g], and a "head" (the row
// open where warp g starts and ended in it) in head[g], with the row id in
// head_row[g] (-1 if none). A second pass adds a cut row's partials,
// tail[g_s .. g_e-1] and head[g_e], in a fixed order and writes the row.
// No atomics anywhere: two calls give bitwise-equal results. Weight-0 arcs
// are summed like any other (0 * NaN is NaN, as in the reference).
//
// Lanes own 4 consecutive feature columns (one 16-byte load each; columns
// 32 apart when F is not a multiple of 4), so each gathered row of h is
// read with coalesced transactions; blockIdx.y picks the 128-column slab.
// The warp walks its arcs as one stream across row boundaries: it loads 32
// arc indices and weights at a time, one per lane, broadcasts them with
// shuffles, and keeps kUnroll arcs' loads in flight before their FMAs; the
// row ends and scales of its rows wait in shared memory, read once per
// warp.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kWarp = 32;
constexpr int kCols = 4;                    // columns per lane per slab
constexpr int kPass = kWarp * kCols;        // 128 columns per slab
constexpr int kUnroll = 8;                  // arcs gathered per batch
constexpr int kGatherThreads = 256;         // 8 warps per block
constexpr int kGatherWarps = kGatherThreads / kWarp;
constexpr int kMaxItems = 128;              // K at most (the wrapper's cap)
constexpr int kRows = kMaxItems + 1;        // rows a warp's range touches
constexpr int kFixupWarps = 32;             // warps adding one row's partials
constexpr int kFixupSlots = 8;              // warp slots per fix-up block

struct Split {
  int items;      // merge-path items per warp, K
  int warps;      // warps (and partial slots), ceil((n + E) / K)
};

// The merged items at diagonals d0 (lanes 0-15) and d1 (lanes 16-31): rows
// ended in *i and arcs consumed in *j, with *i + *j == diag. Each half-warp
// probes 16 rows a round for the first i with row_ptr[i+1] > diag - i - 1.
__device__ __forceinline__ void merge_search(const int* __restrict__ row_ptr,
                                             long long d0, long long d1,
                                             int n, int e, int lane, int* i0,
                                             int* j0, int* i1, int* j1) {
  const int half = lane >> 4, k = lane & 15;
  const long long diag = half ? d1 : d0;
  int lo = static_cast<int>(diag > e ? diag - e : 0);
  int hi = static_cast<int>(diag < n ? diag : n);
  while (__any_sync(0xffffffffu, lo < hi)) {
    const int step = (hi - lo + 15) / 16;
    const int i = lo + k * step;
    const bool probe = lo < hi && i < hi;
    const bool stop =
        probe && static_cast<long long>(__ldg(row_ptr + i + 1)) > diag - i - 1;
    const unsigned shift = 16u * half;
    const unsigned stops =
        (__ballot_sync(0xffffffffu, stop) >> shift) & 0xffffu;
    const unsigned probes =
        (__ballot_sync(0xffffffffu, probe) >> shift) & 0xffffu;
    if (lo < hi) {
      if (stops) {                  // the answer is in (probe kf-1, probe kf]
        const int kf = __ffs(stops) - 1;
        hi = lo + kf * step;
        lo = kf ? lo + (kf - 1) * step + 1 : hi;
      } else {                      // past the last probe
        lo += (31 - __clz(probes)) * step + 1;
      }
    }
  }
  *i0 = __shfl_sync(0xffffffffu, lo, 0);
  *i1 = __shfl_sync(0xffffffffu, lo, 16);
  *j0 = static_cast<int>(d0 - *i0);
  *j1 = static_cast<int>(d1 - *i1);
}

// Whether row r's items end within the range of the warp holding its first
// item or the next one's: then that warp walks the row whole.
__device__ __forceinline__ bool walked_whole(const int* __restrict__ row_ptr,
                                             int r, int items) {
  const long long first = static_cast<long long>(r) + __ldg(row_ptr + r);
  const long long last = static_cast<long long>(r) + __ldg(row_ptr + r + 1);
  return last < (first / items + 2) * items;
}

// The feature column of lane's q-th value in the slab at c0: 16-byte
// vectors (4 consecutive columns a lane) when the rows are whole vectors,
// else columns 32 apart (each of the kCols loads a coalesced 128 bytes).
template <bool kVec>
__device__ __forceinline__ int col(int c0, int lane, int q) {
  return kVec ? c0 + kCols * lane + q : c0 + lane + kWarp * q;
}

template <bool kVec>
__device__ __forceinline__ void load_cols(const float* __restrict__ row,
                                          int f, int c0, int lane, bool live,
                                          float v[kCols]) {
  if (kVec) {
    const int c = col<kVec>(c0, lane, 0);
    const float4 x = live && c < f
                         ? __ldg(reinterpret_cast<const float4*>(row + c))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int c = col<kVec>(c0, lane, q);
      v[q] = live && c < f ? __ldg(row + c) : 0.f;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_cols(float* __restrict__ row,
                                           const float acc[kCols], float scale,
                                           int f, int c0, int lane) {
  if (kVec) {
    const int c = col<kVec>(c0, lane, 0);
    if (c < f)
      *reinterpret_cast<float4*>(row + c) =
          make_float4(acc[0] * scale, acc[1] * scale, acc[2] * scale,
                      acc[3] * scale);
  } else {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int c = col<kVec>(c0, lane, q);
      if (c < f) row[c] = acc[q] * scale;
    }
  }
}

// Pass 1: warp `g` of the grid walks its merged items for column slab
// blockIdx.y; kVec when f is a multiple of 4 (rows of whole 16-byte
// vectors).
template <bool kVec>
__device__ __forceinline__ void gather_pass(
    const float* __restrict__ h, const int* __restrict__ src,
    const int* __restrict__ row_ptr, const float* __restrict__ w,
    const float* __restrict__ inv, float* __restrict__ out,
    float* __restrict__ tail, float* __restrict__ head,
    int* __restrict__ head_row, int n, int e, int f, Split split) {
  __shared__ int ends_s[kGatherWarps][kRows];     // row_ptr[i0 + 1 + k]
  __shared__ float invs_s[kGatherWarps][kRows];   // inv[i0 + k]
  const int lane = threadIdx.x % kWarp;
  const int wb = threadIdx.x / kWarp;
  const long long g =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  if (g >= split.warps) return;             // uniform across the warp
  const int c0 = blockIdx.y * kPass;
  const long long d0 = g * split.items;
  const long long total = static_cast<long long>(n) + e;
  const long long d1 = d0 + split.items < total ? d0 + split.items : total;
  int i0, j0, i1, j1;
  merge_search(row_ptr, d0, d1, n, e, lane, &i0, &j0, &i1, &j1);
  int* ends = ends_s[wb];
  float* invs = invs_s[wb];
  for (int k = lane; k < kRows; k += kWarp) {
    ends[k] = i0 + 1 + k <= n ? __ldg(row_ptr + i0 + 1 + k) : e;
    invs[k] = inv != nullptr && i0 + k < n ? __ldg(inv + i0 + k) : 1.f;
  }
  __syncwarp();

  // the rows to finish here, [r, done), over the arcs [j, stop)
  int r = i0, j = j0, head_r = -1;
  if (i0 < i1 && __ldg(row_ptr + i0) < j0) {      // open at d0, ends here
    if (walked_whole(row_ptr, i0, split.items)) {  // by the warp before
      j = ends[0];
      r = i0 + 1;
    } else {
      head_r = i0;
    }
  }
  int done = i1, stop = j1;
  bool open_tail = false;
  if (i1 < n) {
    const int beg = i1 > i0 ? ends[i1 - i0 - 1] : __ldg(row_ptr + i1);
    if (beg < j1) {                               // row i1 has arcs here
      if (beg >= j0 && walked_whole(row_ptr, i1, split.items)) {
        done = i1 + 1;                            // started here: walk it
        stop = ends[i1 - i0];                     // to its end
      } else {
        open_tail = true;
      }
    }
  }

  float acc[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) acc[q] = 0.f;
  auto flush = [&](int row) {
    if (row == head_r)
      store_cols<kVec>(head + g * f, acc, 1.f, f, c0, lane);
    else
      store_cols<kVec>(out + static_cast<long long>(row) * f, acc,
                       invs[row - i0], f, c0, lane);
#pragma unroll
    for (int q = 0; q < kCols; ++q) acc[q] = 0.f;
  };
  // the next 32 arcs' indices and weights load while these are gathered
  int s_next = 0;
  float w_next = 0.f;
  if (j + lane < stop) {
    s_next = __ldg(src + j + lane);
    w_next = __ldg(w + j + lane);
  }
  for (int base = j; base < stop; base += kWarp) {
    const int s = s_next;
    const float we = w_next;
    if (base + kWarp + lane < stop) {
      s_next = __ldg(src + base + kWarp + lane);
      w_next = __ldg(w + base + kWarp + lane);
    }
    const int cnt = min(kWarp, stop - base);   // uniform across the warp
    for (int t = 0; t < cnt; t += kUnroll) {
      float v[kUnroll][kCols], wt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int st = __shfl_sync(0xffffffffu, s, (t + u) & (kWarp - 1));
        wt[u] = __shfl_sync(0xffffffffu, we, (t + u) & (kWarp - 1));
        load_cols<kVec>(h + static_cast<long long>(st) * f, f, c0, lane,
                        t + u < cnt, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (t + u >= cnt) break;
        while (r < done && ends[r - i0] <= base + t + u) flush(r++);
#pragma unroll
        for (int q = 0; q < kCols; ++q) acc[q] = fmaf(wt[u], v[u][q], acc[q]);
      }
    }
  }
  while (r < done) flush(r++);
  if (open_tail) store_cols<kVec>(tail + g * f, acc, 1.f, f, c0, lane);
  if (lane == 0 && blockIdx.y == 0) head_row[g] = head_r;
}

// Pass 2: block b looks at warp slots b*kFixupSlots + s. For a slot g whose
// warp ended a cut row, it adds tail[g_s .. g-1] and then head[g], where
// g_s is the warp holding the row's first item, and writes the row: warp t
// of the block sums the partials t, t + 32, ... in order; the 32 sums
// are added in warp order.
__device__ __forceinline__ void fixup_pass(
    const int* __restrict__ row_ptr, const float* __restrict__ inv,
    const float* __restrict__ tail, const float* __restrict__ head,
    const int* __restrict__ head_row, float* __restrict__ out, int f,
    Split split) {
  __shared__ float part[kFixupWarps][kPass];
  __shared__ int rows[kFixupSlots];
  if (threadIdx.x < kFixupSlots) {
    const int g = blockIdx.x * kFixupSlots + threadIdx.x;
    rows[threadIdx.x] = g < split.warps ? head_row[g] : -1;
  }
  __syncthreads();
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  for (int slot = 0; slot < kFixupSlots; ++slot) {
    const int r = rows[slot];
    if (r < 0) continue;                      // uniform across the block
    const int g = blockIdx.x * kFixupSlots + slot;
    const int gs = static_cast<int>(
        (static_cast<long long>(r) + __ldg(row_ptr + r)) / split.items);
    const int pieces = g - gs + 1;           // tails gs..g-1, then head g
    const float scale = inv ? __ldg(inv + r) : 1.f;
    for (int c0 = 0; c0 < f; c0 += kPass) {
      float acc[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[q] = 0.f;
      // kUnroll partials' loads in flight, then their adds in order
      for (int p0 = warp; p0 < pieces; p0 += kFixupWarps * kUnroll) {
        float v[kUnroll][kCols];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int p = p0 + kFixupWarps * u;
          const float* row =
              p == pieces - 1 ? head + static_cast<long long>(g) * f
                              : tail + static_cast<long long>(gs + p) * f;
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            const int c = c0 + lane + kWarp * q;
            v[u][q] = p < pieces && c < f ? row[c] : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int q = 0; q < kCols; ++q) acc[q] += v[u][q];
      }
#pragma unroll
      for (int q = 0; q < kCols; ++q) part[warp][lane + kWarp * q] = acc[q];
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          float sum = 0.f;
#pragma unroll
          for (int t = 0; t < kFixupWarps; ++t)
            sum += part[t][lane + kWarp * q];
          acc[q] = sum;
        }
        store_cols<false>(out + static_cast<long long>(r) * f, acc, scale,
                          f, c0, lane);
      }
      __syncthreads();
    }
  }
}

// Grids of the two passes (blocks of kGatherThreads and of kFixupWarps
// warps).
inline dim3 gather_grid(Split split, int f) {
  const long long threads = static_cast<long long>(split.warps) * kWarp;
  return dim3(static_cast<unsigned>((threads + kGatherThreads - 1) /
                                    kGatherThreads),
              static_cast<unsigned>((f + kPass - 1) / kPass));
}
inline dim3 fixup_grid(Split split) {
  return dim3(static_cast<unsigned>((split.warps + kFixupSlots - 1) /
                                    kFixupSlots));
}

}  // namespace repro_torch
