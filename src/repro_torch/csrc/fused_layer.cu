// One GCN layer: CSR mean aggregation, dense transform, bias, relu.
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
// product's 2*N*F*FO f32 flops on the CUDA cores (67 TFLOP/s; 40 us at N
// 79,344) weigh more than reading h and writing out (and agg, for a
// backward pass), 85-125 MB or 25-37 us; the gather of h rows is memory
// bound.
//
// Design: the layer is kernel A (csr_aggregate.cu) writing agg, then the
// product of this file; the wrapper (kernels/fused_layer.py) launches both
// on one stream.
//   1. the aggregation is kernel A's merge-path split, so that no warp
//      walks more than 2K merged items whatever the row lengths (the
//      training path's CSRs hold each partition's weight-0 padding arcs, up
//      to a third of its arcs, in one row; graphs have hub nodes). A 64-row
//      tile walked by its own warps waited for its longest row, and a
//      balanced split does not follow tile boundaries, so the product reads
//      the aggregate finished. agg is the caller's output when a backward
//      pass needs it, else scratch;
//   2. the product, f32 FMA on the CUDA cores, each output summed over k in
//      order from 0, as cuBLAS and the CPU path's f32 products round it.
//      On the tensor cores, 3xTF32 (hi = tf32(x), lo = x - hi; lo*hi +
//      hi*lo + hi*hi by mma.sync m16n8k8, each k-step added to f32
//      accumulators) was more accurate than cuBLAS's f32 product and a
//      quarter faster at these shapes, but chip_smoke.py's card-vs-CPU
//      training check (20 epochs of AdamW) failed with it, as it does on
//      the CPU with an f64-exact product (repro_torch/tools/
//      product_rounding.py): that check holds the trajectory to one
//      rounding order (ROADMAP.md, section C). Each block owns a BM-row x
//      128-column output tile (BM 32, 64 or 128, the autotuner's
//      node_tile; 64 untuned) and walks k in chunks of 32: the chunk of
//      agg rows and of W is copied to shared memory by cp.async (16-byte
//      copies) into one of two buffers while the other is multiplied, so
//      shared memory (41, 50 or 68 KB) does not grow with F. Each thread
//      owns 4 rows x 8 columns (128, 256 or 512 threads a block), reading
//      both operands as 16-byte vectors; bias and relu as the outputs are
//      written.
// Ragged N, F and FO are masked (zero-filled in shared memory).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The row tile BM is a template parameter (32, 64 or 128; the autotuner's
// node_tile, repro_torch/kernels/autotune.py). Each output element is summed
// over k in order whatever the tile, so every tile gives bitwise the same
// result; the tile sets the block's threads and shared memory only.
constexpr int kBN = 128;        // output columns per tile (W chunk stride)
constexpr int kBK = 32;         // k per chunk
constexpr int kTR = 4;          // rows per thread (and 8 columns)
// agg chunk row stride, 4 (mod 8) words: the two rows a warp reads at once,
// 4 apart, fall in disjoint banks
constexpr int kLda = kBK + 4;

template <int BM>
struct Tile {
  static constexpr int kThreads = 16 * (BM / kTR);
  static constexpr int kStage = BM * kLda + kBK * kBN;   // floats per buffer
  static constexpr int kSmemBytes =
      2 * kStage * static_cast<int>(sizeof(float));
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// dst[r][c] = src[row0 + r][col0 + c] for r < rows, c < cols, zero where
// row0 + r >= src_rows or col0 + c >= src_cols; 16-byte copies when the
// source rows allow them, over the block's kThreads threads. The caller
// commits the cp.async group.
template <int kThreads>
__device__ __forceinline__ void stage(float* __restrict__ dst, int ld,
                                      const float* __restrict__ src,
                                      int src_ld, int src_rows, int src_cols,
                                      int row0, int col0, int rows,
                                      int cols) {
  const bool vec = src_ld % 4 == 0 && col0 % 4 == 0 && cols % 4 == 0;
  if (vec) {
    const int quads = cols / 4;
    for (int i = threadIdx.x; i < rows * quads; i += kThreads) {
      const int r = i / quads, c = (i % quads) * 4;
      const int gr = row0 + r, gc = col0 + c;
      float* d = dst + r * ld + c;
      if (gr < src_rows && gc + 3 < src_cols) {
        cp_async16(d, src + static_cast<long long>(gr) * src_ld + gc);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          d[u] = (gr < src_rows && gc + u < src_cols)
                     ? src[static_cast<long long>(gr) * src_ld + gc + u]
                     : 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i % cols;
      const int gr = row0 + r, gc = col0 + c;
      if (gr < src_rows && gc < src_cols)
        cp_async4(dst + r * ld + c,
                  src + static_cast<long long>(gr) * src_ld + gc);
      else
        dst[r * ld + c] = 0.f;
    }
  }
}

// Buffer `buf` <- k-chunk k0: agg[row0.., k0..k0+kBK) and W[k0.., n0..].
template <int BM>
__device__ __forceinline__ void stage_chunk(float* __restrict__ buf,
                                            const float* __restrict__ agg,
                                            const float* __restrict__ wmat,
                                            int n, int f, int fo, int row0,
                                            int n0, int k0) {
  constexpr int kThreads = Tile<BM>::kThreads;
  stage<kThreads>(buf, kLda, agg, f, n, f, row0, k0, BM, kBK);
  stage<kThreads>(buf + BM * kLda, kBN, wmat, fo, f, fo, k0, n0, kBK, kBN);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// grid (row tiles, column tiles)
template <int BM>
__global__ void __launch_bounds__(Tile<BM>::kThreads)
fused_gcn_product(const float* __restrict__ agg,
                  const float* __restrict__ wmat, const float* __restrict__ b,
                  float* __restrict__ out, int n, int f, int fo,
                  int activate) {
  constexpr int kStage = Tile<BM>::kStage;
  extern __shared__ float smem[];
  const int tx = threadIdx.x % 16;           // columns 4tx.., 64 + 4tx..
  const int ty = threadIdx.x / 16;           // rows kTR*ty..
  const int row0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int chunks = (f + kBK - 1) / kBK;

  float acc[kTR][8];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (chunks > 0) stage_chunk<BM>(smem, agg, wmat, n, f, fo, row0, n0, 0);
  for (int c = 0; c < chunks; ++c) {
    const float* atile = smem + (c & 1) * kStage;
    const float* wtile = atile + BM * kLda;
    if (c + 1 < chunks) {
      stage_chunk<BM>(smem + ((c + 1) & 1) * kStage, agg, wmat, n, f, fo,
                      row0, n0, (c + 1) * kBK);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int kend = min(kBK, f - c * kBK + 3) / 4 * 4;  // zero-padded to 4
    for (int k0 = 0; k0 < kend; k0 += 4) {
      float a[kTR][4], wv[4][8];
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(
            atile + (kTR * ty + i) * kLda + k0);
        a[i][0] = x.x, a[i][1] = x.y, a[i][2] = x.z, a[i][3] = x.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float4 x = *reinterpret_cast<const float4*>(
              wtile + (k0 + kk) * kBN + 64 * half + 4 * tx);
          wv[kk][4 * half] = x.x, wv[kk][4 * half + 1] = x.y;
          wv[kk][4 * half + 2] = x.z, wv[kk][4 * half + 3] = x.w;
        }
      // k in order, as a k-ordered f32 product rounds
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a[i][kk], wv[kk][j], acc[i][j]);
    }
    __syncthreads();                         // the buffer is refilled next
  }

#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = row0 + kTR * ty + i;
    if (r >= n) continue;
    float* orow = out + static_cast<long long>(r) * fo;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = n0 + 64 * half + 4 * tx;
      float z[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        z[j] = acc[i][4 * half + j] + (c + j < fo ? __ldg(b + c + j) : 0.f);
        if (activate) z[j] = fmaxf(z[j], 0.f);
      }
      if (fo % 4 == 0 && c + 3 < fo) {
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(z[0], z[1], z[2], z[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < fo) orow[c + j] = z[j];
      }
    }
  }
}

}  // namespace

extern "C" const char* fused_gcn_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

// One row tile's launch. Above 48 KB a kernel must ask for its dynamic
// shared memory, once per device and instantiation (the call costs more
// host time than the launch).
template <int BM>
int launch_product(const float* agg, const float* wmat, const float* b,
                   float* out, int n, int f, int fo, int activate,
                   cudaStream_t stream) {
  constexpr int kDevices = 64;
  static bool ready[kDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && !(device < kDevices && ready[device])) {
    err = cudaFuncSetAttribute(fused_gcn_product<BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile<BM>::kSmemBytes);
    if (err == cudaSuccess && device < kDevices) ready[device] = true;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BM - 1) / BM, (fo + kBN - 1) / kBN);
  fused_gcn_product<BM><<<grid, Tile<BM>::kThreads, Tile<BM>::kSmemBytes,
                          stream>>>(agg, wmat, b, out, n, f, fo, activate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [n,fo] = act(agg [n,f] @ wmat [f,fo] + b [fo]); f32, contiguous, on
// the device; bm is the row tile, 32, 64 or 128. Returns the first CUDA
// error.
extern "C" int fused_gcn_product_f32(const float* agg, const float* wmat,
                                     const float* b, float* out, int n,
                                     int f, int fo, int activate, int bm,
                                     void* stream) {
  if (n <= 0 || fo <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 32:
      return launch_product<32>(agg, wmat, b, out, n, f, fo, activate, s);
    case 64:
      return launch_product<64>(agg, wmat, b, out, n, f, fo, activate, s);
    case 128:
      return launch_product<128>(agg, wmat, b, out, n, f, fo, activate, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
