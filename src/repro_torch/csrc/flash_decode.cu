// Single-token GQA decode attention, split-K over the cache (kernel D):
//
//     out[b, h] = softmax(q[b, h] . k[b, :filled[b], h/G]^T / sqrt(D))
//                 . v[b, :filled[b], h/G]
//
// Replaces: src/repro/kernels/flash_decode.py, _kernel (through
// flash_decode_pallas), the TPU kernel that walks the whole padded cache of
// ONE sequence in 512-long blocks, in order, carrying the online-softmax
// state (m, l, acc) in VMEM scratch from block to block; the reference
// vmaps it over the batch.
//
// Bound on the H100: memory. Every K and V element of the filled prefix is
// read once for ~2 flops per query row of its group; q and out are small.
//
// Design: blocks on the H100 run in no order, so nothing can carry from one
// block to the next. The cache is cut into `splits` stretches of `chunk`
// positions; grid (splits, Hkv * gchunks, B). One block owns one kv head's
// group of query rows (at most GMAX of them: a larger group is cut into
// chunks, each its own block) for one stretch, and stops at filled[b]: a
// stretch wholly past it exits at once and is never read, so the kernel
// reads only the filled prefix (the TPU kernel streams every padded block).
// Inside a block, a group of LPR = D/8 lanes owns one cache position at a
// time: each lane loads 8 neighbouring elements of the 2*D-byte (bf16) row
// with one 16-byte load, so a row is one coalesced transaction, and the
// lanes' partial dots are summed with xor shuffles inside the group. Each
// group takes P positions per step, keeps (m, l, acc[GMAX][8]) in
// registers, and rescales acc once per step. At the end the groups of a
// warp merge by shuffles and the warps by shared memory, and the block
// writes f32 partials (m, l, acc[D]) per query row. A second small kernel
// merges a row's non-empty stretches by log-sum-exp and divides by
// max(l, 1e-30). Masked positions take the reference's -1e30 (not -inf)
// and p = 0, so an all-masked state merges as weight 0 without NaNs.
// Length 0 gives 0, as the TPU kernel does. Math in f32; K, V, q and out
// in the cache type (bf16 or f32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// One block: query rows [g0, g0 + GMAX) of kv head `kv` (rows past the group
// are zero and never written), positions [split*chunk, (split+1)*chunk).
template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ filled,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int s_len, int h, int hkv,
                   int gchunks, int splits, int chunk) {
  constexpr int LPR = D / 8;             // lanes per cache row
  constexpr int NP = 32 / LPR;           // rows a warp reads at once
  constexpr int P = GMAX <= 4 ? 4 : 2;   // rows per lane group per step
  constexpr int TILE = kWarps * NP * P;  // positions per block step
  const int split = blockIdx.x;
  const int kv = blockIdx.y / gchunks;
  const int g0 = (blockIdx.y % gchunks) * GMAX;
  const int b = blockIdx.z;
  const int g = h / hkv;
  const int end = min(max(__ldg(filled + b), 0), s_len);
  const int s0 = split * chunk;
  if (s0 >= end) return;                 // uniform: the merge skips it
  const int s1 = min(s0 + chunk, end);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPR;            // lane group within the warp
  const int col = (lane % LPR) * 8;      // this lane's 8 elements of a row

  // q rows, pre-scaled by 1/sqrt(D) in f32 as the reference does
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  float qr[GMAX][8];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    const int row = g0 + gi;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      qr[gi][i] = row < g
          ? load1(q + (static_cast<long long>(b) * h + kv * g + row) * D
                  + col + i) * scale
          : 0.f;
  }

  float m[GMAX], l[GMAX], acc[GMAX][8];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    m[gi] = kMasked;
    l[gi] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[gi][i] = 0.f;
  }

  const long long row_stride = static_cast<long long>(hkv) * D;
  const long long base = (static_cast<long long>(b) * s_len) * row_stride
                         + static_cast<long long>(kv) * D + col;
  for (int t = s0; t < s1; t += TILE) {
    const int first = t + (warp * NP + grp) * P;
    float kx[P][8], vx[P][8];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int pos = first + j;
      if (pos < s1) {
        load8(k + base + pos * row_stride, kx[j]);
        load8(v + base + pos * row_stride, vx[j]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kx[j][i] = vx[j][i] = 0.f;
      }
    }
    float s[P][GMAX];
#pragma unroll
    for (int j = 0; j < P; ++j) {
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(qr[gi][i], kx[j][i], d);
#pragma unroll
        for (int off = LPR / 2; off > 0; off /= 2)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[j][gi] = first + j < s1 ? d : kMasked;
      }
    }
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) {
      float mt = m[gi];
#pragma unroll
      for (int j = 0; j < P; ++j) mt = fmaxf(mt, s[j][gi]);
      const float alpha = __expf(m[gi] - mt);
      l[gi] *= alpha;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[gi][i] *= alpha;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float p = first + j < s1 ? __expf(s[j][gi] - mt) : 0.f;
        l[gi] += p;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[gi][i] = fmaf(p, vx[j][i], acc[gi][i]);
      }
      m[gi] = mt;
    }
  }

  // merge the warp's lane groups (same columns, other positions)
#pragma unroll
  for (int off = LPR; off < 32; off *= 2) {
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[gi], off);
      const float mn = fmaxf(m[gi], mo);
      const float a = __expf(m[gi] - mn), c = __expf(mo - mn);
      l[gi] = l[gi] * a + lo * c;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[gi][i], off);
        acc[gi][i] = acc[gi][i] * a + ao * c;
      }
      m[gi] = mn;
    }
  }

  // merge the warps through shared memory and write the block's partials
  __shared__ float sm_m[kWarps][GMAX], sm_l[kWarps][GMAX];
  __shared__ float sm_acc[kWarps][GMAX][D];
  if (grp == 0) {
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) {
      if (lane == 0) {
        sm_m[warp][gi] = m[gi];
        sm_l[warp][gi] = l[gi];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) sm_acc[warp][gi][col + i] = acc[gi][i];
    }
  }
  __syncthreads();
  const int rows = min(GMAX, g - g0);
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int gi = idx / D, d = idx % D;
    float mx = kMasked;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][gi]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = __expf(sm_m[w][gi] - mx);
      a = fmaf(sm_acc[w][gi][d], e, a);
      lsum = fmaf(sm_l[w][gi], e, lsum);
    }
    const long long row =
        (static_cast<long long>(b) * h + kv * g + g0 + gi) * splits + split;
    part_acc[row * D + d] = a;
    if (d == 0) {
      part_m[row] = mx;
      part_l[row] = lsum;
    }
  }
}

// One block per (b, head), one thread per column: log-sum-exp over the
// non-empty stretches, then acc / max(l, 1e-30).
template <typename T>
__global__ void flash_decode_merge(const int* __restrict__ filled,
                                   const float* __restrict__ part_m,
                                   const float* __restrict__ part_l,
                                   const float* __restrict__ part_acc,
                                   T* __restrict__ out, int s_len, int h,
                                   int d_head, int splits, int chunk) {
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int d = threadIdx.x;
  const int end = min(max(__ldg(filled + b), 0), s_len);
  const int used = min(splits, (end + chunk - 1) / chunk);
  const long long row0 = static_cast<long long>(bh) * splits;
  float mx = kMasked;
  for (int j = 0; j < used; ++j) mx = fmaxf(mx, __ldg(part_m + row0 + j));
  float a = 0.f, lsum = 0.f;
  for (int j = 0; j < used; ++j) {
    const float e = __expf(__ldg(part_m + row0 + j) - mx);
    a = fmaf(__ldg(part_acc + (row0 + j) * d_head + d), e, a);
    lsum = fmaf(__ldg(part_l + row0 + j), e, lsum);
  }
  store(out + static_cast<long long>(bh) * d_head + d,
        a / fmaxf(lsum, 1e-30f));
}

template <typename T, int D, int GMAX>
void launch_split(const T* q, const T* k, const T* v, const int* filled,
                  float* pm, float* pl, float* pacc, int b, int s_len, int h,
                  int hkv, int splits, int chunk, cudaStream_t stream) {
  const int gchunks = (h / hkv + GMAX - 1) / GMAX;
  const dim3 grid(splits, hkv * gchunks, b);
  flash_decode_split<T, D, GMAX><<<grid, kThreads, 0, stream>>>(
      q, k, v, filled, pm, pl, pacc, s_len, h, hkv, gchunks, splits, chunk);
}

template <typename T, int D>
void launch_d(const T* q, const T* k, const T* v, const int* filled,
              float* pm, float* pl, float* pacc, int b, int s_len, int h,
              int hkv, int splits, int chunk, cudaStream_t stream) {
  const int g = h / hkv;
  if (g <= 1)
    launch_split<T, D, 1>(q, k, v, filled, pm, pl, pacc, b, s_len, h, hkv,
                          splits, chunk, stream);
  else if (g <= 2)
    launch_split<T, D, 2>(q, k, v, filled, pm, pl, pacc, b, s_len, h, hkv,
                          splits, chunk, stream);
  else if (g <= 4)
    launch_split<T, D, 4>(q, k, v, filled, pm, pl, pacc, b, s_len, h, hkv,
                          splits, chunk, stream);
  else
    launch_split<T, D, 8>(q, k, v, filled, pm, pl, pacc, b, s_len, h, hkv,
                          splits, chunk, stream);
}

template <typename T>
int run(const T* q, const T* k, const T* v, const int* filled, T* out,
        float* pm, float* pl, float* pacc, int b, int s_len, int h, int hkv,
        int d, int splits, int chunk, void* stream) {
  if (d != 64 && d != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (hkv <= 0 || h % hkv != 0 || splits <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b > 0 && s_len > 0) {
    if (d == 64)
      launch_d<T, 64>(q, k, v, filled, pm, pl, pacc, b, s_len, h, hkv,
                      splits, chunk, st);
    else
      launch_d<T, 128>(q, k, v, filled, pm, pl, pacc, b, s_len, h, hkv,
                       splits, chunk, st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (b > 0)
    flash_decode_merge<T><<<b * h, d, 0, st>>>(filled, pm, pl, pacc, out,
                                               s_len, h, d, splits, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* flash_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [b,h,d], k/v [b,s,hkv,d], out [b,h,d] in the cache type; filled [b]
// int32; part_m/part_l [b,h,splits], part_acc [b,h,splits,d] f32 scratch.
// All contiguous, on the device, 16-byte aligned. Returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it refuses).
extern "C" int flash_decode_f32(const float* q, const float* k,
                                const float* v, const int* filled, float* out,
                                float* part_m, float* part_l, float* part_acc,
                                int b, int s_len, int h, int hkv, int d,
                                int splits, int chunk, void* stream) {
  return run<float>(q, k, v, filled, out, part_m, part_l, part_acc, b, s_len,
                    h, hkv, d, splits, chunk, stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const int* filled, void* out, float* part_m,
                                 float* part_l, float* part_acc, int b,
                                 int s_len, int h, int hkv, int d, int splits,
                                 int chunk, void* stream) {
  using bf = __nv_bfloat16;
  return run<bf>(static_cast<const bf*>(q), static_cast<const bf*>(k),
                 static_cast<const bf*>(v), filled, static_cast<bf*>(out),
                 part_m, part_l, part_acc, b, s_len, h, hkv, d, splits,
                 chunk, stream);
}
