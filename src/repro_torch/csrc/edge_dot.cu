// Per-arc edge-weight gradient of the CSR aggregation (kernel C):
//
//     dw[e] = inv[dst[e]] * sum_f h[src[e], f] * g[dst[e], f]
//
// Replaces: src/repro/kernels/csr_aggregate.py, _edge_dot_kernel (through
// _edge_dot), the TPU kernel that row-dots two [E, F] operands, h[src] and
// (inv*g)[dst], which the reference first gathers into device memory, and
// carries the [EB] sums across feature-tile grid steps.
//
// Bound on the H100: memory. Each arc costs 8*F bytes of two gathered rows
// for 2*F flops. Counted once, the unique bytes are the two [N, F] tables
// plus src, dst and dw (12 bytes an arc).
//
// Design: the kernel gathers both rows itself, so neither [E, F] operand
// ever exists. One warp owns one arc; lanes own feature columns, so each row
// is read with coalesced 128-byte transactions; the warp's partial sums are
// reduced with shuffles in registers and lane 0 writes dw[e]. No atomics and
// no shared memory: the result does not depend on how blocks are scheduled.
// Arcs come in CSR (destination) order, so neighbouring warps read the same
// g row, which the caches serve. inv is applied after the dot (the reference
// scales g first): one rounding in another place, well inside 3e-5. Ragged
// E and F are masked; nothing is padded.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

__global__ void __launch_bounds__(kThreads)
edge_dot_kernel(const float* __restrict__ h, const float* __restrict__ g,
                const int* __restrict__ src, const int* __restrict__ dst,
                const float* __restrict__ inv, float* __restrict__ out, int e,
                int f) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (warp >= e) return;                    // uniform across the warp
  const int a = static_cast<int>(warp);
  const int s = __ldg(src + a);
  const int d = __ldg(dst + a);
  const float* hr = h + static_cast<long long>(s) * f;
  const float* gr = g + static_cast<long long>(d) * f;
  float acc = 0.f;
#pragma unroll 4
  for (int c = lane; c < f; c += kWarp)
    acc = fmaf(__ldg(hr + c), __ldg(gr + c), acc);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[a] = inv != nullptr ? acc * __ldg(inv + d) : acc;
}

}  // namespace

extern "C" const char* edge_dot_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// h [n,f], g [n,f], src [e], dst [e], inv [n] or null, out [e]; all
// f32/int32, contiguous, on the device. Returns cudaGetLastError().
extern "C" int edge_dot_f32(const float* h, const float* g, const int* src,
                            const int* dst, const float* inv, float* out,
                            int e, int f, void* stream) {
  if (e > 0) {
    const long long threads = static_cast<long long>(e) * kWarp;
    const unsigned blocks =
        static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    edge_dot_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(h, g, src, dst,
                                                           inv, out, e, f);
  }
  return static_cast<int>(cudaGetLastError());
}
