// CSR neighbour aggregation with a fused mean epilogue:
//
//     out[d, :] = inv[d] * sum_{e in row d} w[e] * h[src[e], :]
//
// Replaces: src/repro/kernels/csr_aggregate.py, _agg_kernel (forward), the
// TPU kernel that turns the scatter into a one-hot [NT,EB]@[EB,FT] matmul
// with an SMEM lo/hi edge-block skip.
//
// Bound on the H100: memory. Each arc costs 4*F bytes of gathered h for
// 2*F flops, far below the card's flop-per-byte balance, so the kernel can
// only be as fast as it reads h and writes out.
//
// Design: the wrapper turns the dst-sorted arc list into a CSR (row_ptr),
// so no one-hot product and no edge-block skip are needed. One warp owns
// one destination row; lanes own feature columns, so each gathered h row is
// read coalesced, and the row sum stays in registers (no atomics, results
// are deterministic). Ragged N, F and E are masked here; nothing is padded.
#include <cuda_runtime.h>

#include "csr_rows.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
csr_aggregate_kernel(const float* __restrict__ h, const int* __restrict__ src,
                     const int* __restrict__ row_ptr,
                     const float* __restrict__ w,
                     const float* __restrict__ inv, float* __restrict__ out,
                     int n, int f) {
  using namespace repro_torch;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (warp >= n) return;                    // uniform across the warp
  const int d = static_cast<int>(warp);
  const int beg = row_ptr[d];
  const int end = row_ptr[d + 1];
  const float scale = inv ? inv[d] : 1.f;
  float* orow = out + static_cast<long long>(d) * f;
  for (int c0 = 0; c0 < f; c0 += kPass) {
    float acc[kCols];
    row_sum(h, src, w, beg, end, f, c0, lane, acc);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = c0 + lane + kWarp * j;
      if (c < f) orow[c] = acc[j] * scale;
    }
  }
}

}  // namespace

extern "C" const char* csr_aggregate_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// h [n,f], src [e], row_ptr [n+1], w [e], inv [n] or null, out [n,f]; all
// f32/int32, contiguous, on the device. Returns cudaGetLastError().
extern "C" int csr_aggregate_f32(const float* h, const int* src,
                                 const int* row_ptr, const float* w,
                                 const float* inv, float* out, int n, int f,
                                 void* stream) {
  if (n > 0 && f > 0) {
    const long long threads = static_cast<long long>(n) * repro_torch::kWarp;
    const unsigned blocks =
        static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    csr_aggregate_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        h, src, row_ptr, w, inv, out, n, f);
  }
  return static_cast<int>(cudaGetLastError());
}
