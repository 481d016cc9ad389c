// One fused GCN layer: CSR mean aggregation, dense transform, bias, relu.
//
//     agg[d, :] = inv[d] * sum_{e in row d} w[e] * h[src[e], :]
//     out[d, :] = act(agg[d, :] @ W + b)          act = relu or identity
//
// Replaces: src/repro/kernels/fused_layer.py, _fused_kernel, the TPU kernel
// that streams edge blocks through a one-hot matmul and carries a [NT,FO]
// accumulator across feature-tile grid steps, which relies on the TPU grid
// running in order.
//
// Bound on the H100: at the main path's shapes (F = FO = 128) the dense
// product's 2*N*F*FO f32 flops on the CUDA cores (67 TFLOP/s, no tensor
// cores: f32 parity with the reference rules out TF32) weigh about as much
// as reading h and writing out; the gather of h rows is memory bound.
//
// Design: blocks run in no order on Hopper, so one block owns a tile of
// kTileRows destination rows and does the whole layer for them:
//   1. its 8 warps gather-reduce the tile's arcs (one warp per row, as in
//      csr_aggregate.cu) into a [kTileRows, F] tile in shared memory,
//      scaled by inv; the aggregate never goes to device memory unless the
//      caller asks for it (agg != null, for a backward pass);
//   2. the tile is multiplied by W in K-chunks of kK rows of W staged in
//      shared memory, 4x4 outputs per thread, f32 FMA;
//   3. bias and relu are applied as the outputs are written.
// The tile row stride is F+1 floats, so the two rows a warp reads in the
// product fall in different shared-memory banks. Ragged N, F and FO are
// masked; nothing is padded to lane multiples.
#include <cuda_runtime.h>

#include "csr_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;   // destination rows per block
constexpr int kOutCols = 64;    // output columns per pass of the product
constexpr int kK = 32;          // rows of W staged per chunk
constexpr int kMicro = 4;       // 4x4 outputs per thread

__global__ void __launch_bounds__(kThreads)
fused_gcn_kernel(const float* __restrict__ h, const int* __restrict__ src,
                 const int* __restrict__ row_ptr, const float* __restrict__ w,
                 const float* __restrict__ inv,
                 const float* __restrict__ wmat, const float* __restrict__ b,
                 float* __restrict__ out, float* __restrict__ agg, int n,
                 int f, int fo, int activate) {
  using namespace repro_torch;
  extern __shared__ float smem[];
  const int ld = f + 1;
  float* tile = smem;                        // [kTileRows][ld]
  float* wtile = smem + kTileRows * ld;      // [kK][kOutCols]
  const int row0 = blockIdx.x * kTileRows;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;

  // 1. aggregate the tile's rows into shared memory
  for (int r = warp; r < kTileRows; r += kThreads / kWarp) {
    const int d = row0 + r;
    for (int c0 = 0; c0 < f; c0 += kPass) {
      float acc[kCols];
      if (d < n) {
        row_sum(h, src, w, row_ptr[d], row_ptr[d + 1], f, c0, lane, acc);
        const float scale = inv ? inv[d] : 1.f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[j] *= scale;
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = c0 + lane + kWarp * j;
        if (c < f) {
          tile[r * ld + c] = acc[j];
          if (agg != nullptr && d < n)
            agg[static_cast<long long>(d) * f + c] = acc[j];
        }
      }
    }
  }
  __syncthreads();

  // 2. + 3. out tile = act(tile @ W + b), kOutCols columns per pass
  const int tx = threadIdx.x % 16;           // columns tx + 16*j
  const int ty = threadIdx.x / 16;           // rows 4*ty + i
  for (int n0 = 0; n0 < fo; n0 += kOutCols) {
    float acc[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < f; k0 += kK) {
      for (int i = threadIdx.x; i < kK * kOutCols; i += kThreads) {
        const int k = k0 + i / kOutCols;
        const int c = n0 + i % kOutCols;
        wtile[i] = (k < f && c < fo)
                       ? wmat[static_cast<long long>(k) * fo + c]
                       : 0.f;
      }
      __syncthreads();
      const int kmax = min(kK, f - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        float a[kMicro], bv[kMicro];
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
          a[i] = tile[(ty * kMicro + i) * ld + k0 + kk];
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          bv[j] = wtile[kk * kOutCols + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j)
            acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int d = row0 + ty * kMicro + i;
      if (d >= n) continue;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const int c = n0 + tx + 16 * j;
        if (c < fo) {
          float z = acc[i][j] + b[c];
          if (activate) z = fmaxf(z, 0.f);
          out[static_cast<long long>(d) * fo + c] = z;
        }
      }
    }
  }
}

}  // namespace

extern "C" const char* fused_gcn_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of one block, in bytes, for input width f.
extern "C" int fused_gcn_smem_bytes(int f) {
  return static_cast<int>(sizeof(float)) * (kTileRows * (f + 1) + kK * kOutCols);
}

// h [n,f], src [e], row_ptr [n+1], w [e], inv [n] or null, wmat [f,fo],
// b [fo], out [n,fo], agg [n,f] or null; all f32/int32, contiguous, on the
// device. Returns cudaGetLastError().
extern "C" int fused_gcn_layer_f32(const float* h, const int* src,
                                   const int* row_ptr, const float* w,
                                   const float* inv, const float* wmat,
                                   const float* b, float* out, float* agg,
                                   int n, int f, int fo, int activate,
                                   void* stream) {
  if (n > 0 && fo > 0) {
    const int smem = fused_gcn_smem_bytes(f);
    cudaError_t err = cudaFuncSetAttribute(
        fused_gcn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>((n + kTileRows - 1) / kTileRows);
    fused_gcn_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        h, src, row_ptr, w, inv, wmat, b, out, agg, n, f, fo, activate);
  }
  return static_cast<int>(cudaGetLastError());
}
