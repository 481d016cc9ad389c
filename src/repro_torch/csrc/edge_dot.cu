// Per-arc edge-weight gradient of the CSR aggregation (kernel C):
//
//     dw[e] = sum_f h[src[e], f] * (inv * g)[dst[e], f]
//
// Replaces: src/repro/kernels/csr_aggregate.py, _edge_dot_kernel (through
// _edge_dot), the TPU kernel that row-dots two [E, F] operands, h[src] and
// (inv*g)[dst], which the reference first gathers into device memory, and
// carries the [EB] sums across feature-tile grid steps.
//
// Bound on the H100: memory. Each arc costs 8*F bytes of two gathered rows
// for 2*F flops, but counted once the unique bytes are the two [N, F]
// tables, inv, and src, dst and dw (12 bytes an arc). The arcs come in CSR
// (destination) order, so g is streamed once in arc order; the h rows are
// read in src order, at random, and come from L2 (a main-path partition's
// h table is 79,344 x 128 f32, 40.6 MB, inside the 50 MB L2).
//
// Design: a CSR row walk. Each warp takes a contiguous span of SPAN arcs
// (no arc needs another's sum, so an equal count is a balanced split; a
// hub row, such as a partition's padding row of 10^5 arcs, spans many
// warps, each of which loads its first row's g itself). Lanes own 4
// feature columns each, 128 columns a pass (one float4 per lane at F =
// 128; wider F takes more passes, which add into dw in pass order; F not a
// multiple of 4 reads 4 scalar columns per lane, lane + 32 i). The warp
// walks its span 8 arcs at a time: the 8 h[src] rows are 8 independent
// loads in flight, and (inv*g)[dst] stays in registers until dst changes,
// when it is loaded again. The 8 partial dots are reduced together by a
// transposing butterfly (4 + 2 + 1 shuffles halve the values while
// summing across lane halves, then 2 more finish one value per lane
// quad): 9 shuffles for 8 arcs instead of 40, after which 8 lanes write 8
// consecutive dw. Columns past F and arcs past E are masked. No atomics,
// and a fixed reduction order: two calls are bitwise equal. inv scales g
// before the dot, as the reference does.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kBatch = 8;        // arcs whose h rows are in flight at once
constexpr int kSpan = 64;        // arcs a warp walks
constexpr int kPass = 128;       // columns a pass

// Four columns of row `row` for this lane, zero past f.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ t,
                                        long long row, int f, int c0,
                                        int lane) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* r = t + row * f;
  if (VEC) {
    const int c = c0 + 4 * lane;
    if (c < f) x = __ldg(reinterpret_cast<const float4*>(r + c));
  } else {
    const int c = c0 + lane;
    if (c < f) x.x = __ldg(r + c);
    if (c + 32 < f) x.y = __ldg(r + c + 32);
    if (c + 64 < f) x.z = __ldg(r + c + 64);
    if (c + 96 < f) x.w = __ldg(r + c + 96);
  }
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

// Sum x[j] over the 32 lanes for all 8 j; lane quad j (lanes 4j..4j+3,
// j = 4*bit4 + 2*bit3 + bit2) ends with the sum for arc j.
__device__ __forceinline__ float butterfly8(float (&x)[kBatch], int lane) {
  const bool u16 = lane & 16, u8 = lane & 8, u4 = lane & 4;
  float y[4], z[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = u16 ? x[i] : x[i + 4];
    const float keep = u16 ? x[i + 4] : x[i];
    y[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = u8 ? y[i] : y[i + 2];
    const float keep = u8 ? y[i + 2] : y[i];
    z[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  float w = (u4 ? z[1] : z[0])
            + __shfl_xor_sync(0xffffffffu, u4 ? z[0] : z[1], 4);
  w += __shfl_xor_sync(0xffffffffu, w, 2);
  w += __shfl_xor_sync(0xffffffffu, w, 1);
  return w;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
edge_dot_kernel(const float* __restrict__ h, const float* __restrict__ g,
                const int* __restrict__ src, const int* __restrict__ dst,
                const float* __restrict__ inv, float* __restrict__ out,
                int e, int f) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long a0 = warp * kSpan;
  if (a0 >= e) return;                      // uniform across the warp
  const int n_arcs = static_cast<int>(min(static_cast<long long>(kSpan),
                                          e - a0));
  // this warp's arcs: lane l holds arcs a0 + l and a0 + 32 + l
  int my_src[kSpan / kWarp], my_dst[kSpan / kWarp];
#pragma unroll
  for (int i = 0; i < kSpan / kWarp; ++i) {
    const int j = i * kWarp + lane;
    my_src[i] = j < n_arcs ? __ldg(src + a0 + j) : 0;
    my_dst[i] = j < n_arcs ? __ldg(dst + a0 + j) : -1;
  }
  // the lane quad that writes arc (j0 + jw) of each batch
  const int jw = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2
                 + ((lane >> 2) & 1);
  int c0 = 0;
  do {                                      // one pass even at f = 0
    int cur = -1;                           // dst whose g row is held
    float4 gv = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j0 = 0; j0 < kSpan; j0 += kBatch) {
      if (j0 < n_arcs) {                    // uniform
        float4 hv[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int s = __shfl_sync(0xffffffffu, my_src[(j0 + j) / kWarp],
                                    (j0 + j) % kWarp);
          hv[j] = j0 + j < n_arcs ? load4<VEC>(h, s, f, c0, lane)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        float part[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int d = __shfl_sync(0xffffffffu, my_dst[(j0 + j) / kWarp],
                                    (j0 + j) % kWarp);
          if (d != cur && d >= 0) {         // uniform: a new row's g
            cur = d;
            gv = load4<VEC>(g, d, f, c0, lane);
            if (inv != nullptr) {
              const float s = __ldg(inv + d);
              gv.x *= s; gv.y *= s; gv.z *= s; gv.w *= s;
            }
          }
          part[j] = dot4(hv[j], gv);
        }
        const float sum = butterfly8(part, lane);
        const int a = j0 + jw;
        if ((lane & 3) == 0 && a < n_arcs) {
          float* o = out + a0 + a;
          *o = c0 == 0 ? sum : *o + sum;
        }
      }
    }
    c0 += kPass;
  } while (c0 < f);
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
    const long long warps = (static_cast<long long>(e) + kSpan - 1) / kSpan;
    const unsigned blocks = static_cast<unsigned>(
        (warps * kWarp + kThreads - 1) / kThreads);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec =
        f % 4 == 0 && ((reinterpret_cast<unsigned long long>(h)
                        | reinterpret_cast<unsigned long long>(g)) & 15) == 0;
    if (vec)
      edge_dot_kernel<true><<<blocks, kThreads, 0, st>>>(h, g, src, dst, inv,
                                                         out, e, f);
    else
      edge_dot_kernel<false><<<blocks, kThreads, 0, st>>>(h, g, src, dst,
                                                          inv, out, e, f);
  }
  return static_cast<int>(cudaGetLastError());
}
