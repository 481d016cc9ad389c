// Shared device code of the two aggregation kernels: one warp sums the
// in-arcs of one destination row of a CSR graph into registers.
//
// The arcs of row d are src[row_ptr[d] .. row_ptr[d+1]) with weights w[...].
// Lanes own feature columns c0 + lane + 32*j (j < COLS), so every gathered
// row of h is read with coalesced 128-byte transactions. The warp loads 32
// arc indices and weights at a time, one per lane, and broadcasts them with
// shuffles. Arcs are summed in their CSR order, one f32 FMA each, with no
// atomics: a row's result does not depend on how blocks are scheduled.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kWarp = 32;
constexpr int kCols = 4;                    // columns per lane per pass
constexpr int kPass = kWarp * kCols;        // 128 columns per warp pass

__device__ __forceinline__ void row_sum(const float* __restrict__ h,
                                        const int* __restrict__ src,
                                        const float* __restrict__ w,
                                        int beg, int end, int f, int c0,
                                        int lane, float acc[kCols]) {
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  for (int base = beg; base < end; base += kWarp) {
    const int e = base + lane;
    int s = 0;
    float we = 0.f;
    if (e < end) {
      s = __ldg(src + e);
      we = __ldg(w + e);
    }
    const int cnt = min(kWarp, end - base);   // uniform across the warp
    for (int t = 0; t < cnt; ++t) {
      const int st = __shfl_sync(0xffffffffu, s, t);
      const float wt = __shfl_sync(0xffffffffu, we, t);
      const float* hr = h + static_cast<long long>(st) * f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = c0 + lane + kWarp * j;
        if (c < f) acc[j] = fmaf(wt, __ldg(hr + c), acc[j]);
      }
    }
  }
}

}  // namespace repro_torch
