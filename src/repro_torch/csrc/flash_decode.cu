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
// read once for ~4 flops per query row of its group (~4 flops a byte at
// G = 4 in bf16), far below the ~295 flops a byte where the tensor cores
// would bound it; q and out are small. What the design does about it:
//
// - Split-K, one launch. Blocks run in no order, so the cache is cut into
//   `splits` stretches of `chunk` positions; grid (splits, Hkv * row
//   chunks, B). One block owns one kv head's group of query rows (at most
//   16; a larger group is cut into chunks of 16, each its own block) for
//   one stretch, and stops at filled[b]: a stretch wholly past it exits at
//   once, so only the filled prefix is read. Each block writes f32
//   partials (m, l, acc[D]) per query row to a workspace, then counts
//   itself in on an arrival counter; the last block of its (b, kv head,
//   row chunk) merges the stretches by log-sum-exp in split order (so two
//   calls are bitwise equal) and writes out, and resets the counter to 0.
//   One stretch skips the workspace. The workspace and counters are
//   allocated (counters zeroed) once per shape by the wrapper.
// - A ring of K/V tiles in shared memory. A block walks its stretch in
//   tiles of TP positions through a ring of 3 stages in dynamic shared
//   memory, filled with 16-byte cp.async copies in commit groups: while
//   tile i is used, tiles i+1 and i+2 are in flight. cp.async rather than
//   TMA: a K/V row of one kv head is D contiguous elements at a stride of
//   Hkv * D, which 16-byte copies by 128 threads read as whole coalesced
//   rows without a tensor map per cache shape, and its zero-fill masks
//   positions past filled[b] (whose stale or uninitialised contents could
//   be NaN, which 0 * NaN would carry into the sum).
// - bf16: products on tensor cores (mma.sync.m16n8k16, bf16 in, f32
//   accumulate). The group's query rows (zero past G) are the A operand,
//   held in registers for the whole stretch, so a group of up to 16 reads
//   K/V once. Each warp takes 16 positions of each 64-position tile: K
//   comes in by ldmatrix (rows XOR-swizzled in 16-byte chunks, so the 8
//   rows of a matrix hit 8 different bank groups), S = Q K^T, the f32
//   logits are scaled by 1/sqrt(D) after the product (q is not pre-scaled:
//   that would add a bf16 rounding), online softmax on the accumulator
//   fragment (row max by two quad shuffles; row sums kept per thread and
//   summed over the quad once at the end), P rounded to bf16 is the A
//   operand of P V with V in by ldmatrix.trans. The four warps' states
//   merge through shared memory at the end.
// - f32: tensor cores would mean TF32, which does not hold 3e-5, so the
//   f32 path keeps FMA math, on the same ring (32-position tiles, rows
//   padded by 16 bytes so float4 reads by consecutive positions miss each
//   other's banks) and with no per-position shuffle chains: one lane owns
//   a position for Q K^T (one max reduction per row and tile), then
//   threads own columns for P V.
//
// Head dims: 64, 96 and 128, each its own instantiation with its own
// 1/sqrt(D) (96 is phi-3-vision's 3,072 / 32; its bf16 rows need their own
// swizzle, TileB, and its f32 P V its own thread-to-column map).
//
// Masked positions take the reference's -1e30 (not -inf) and p = 0, so an
// all-masked state merges as weight 0 without NaNs; the sum l is divided
// out as acc / max(l, 1e-30). Length 0 gives 0, as the TPU kernel does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr int kMaxRows = 16;            // query rows one block holds
constexpr float kMasked = -1e30f;

template <int D>
struct Scale;
template <>
struct Scale<64> { static constexpr float value = 0.125f; };
template <>
struct Scale<96> { static constexpr float value = 0.10206207261596575f; };
template <>
struct Scale<128> { static constexpr float value = 0.08838834764831845f; };

// ---- shared-memory tiles ------------------------------------------------

// bf16: 64-position tiles, rows of 2*D bytes with their 16-byte chunks
// XOR-swizzled within the row, so that the 8 rows one ldmatrix matrix reads
// (8 consecutive rows, one chunk column) land in 8 different 16-byte bank
// groups. Row r starts at bank group (2*D/16 * r) % 8.
// - D 64 and 128 (8 and 16 chunks, rows of 128 and 256 bytes, every row at
//   group 0): chunk c goes to c ^ (r % 8).
// - D 96 (12 chunks, rows of 192 bytes: row r starts at group 4 * (r % 2),
//   so rows r and r + 2 alias unswizzled): chunks 0-7 go to c ^ (r % 8),
//   which stays in 0-7 and gives group (4r + (c ^ r)) % 8, distinct over
//   8 rows; chunks 8-11 go to c ^ ((r / 2) % 4), which stays in 8-11 (the
//   row's end) and gives the even rows groups 0-3 and the odd rows groups
//   4-7, each once. No padding: the ring stays 3 * 2 * 64 * 192 bytes.
template <int D>
struct TileB {
  static constexpr int TP = 64;
  static constexpr int CPR = D / 8;                 // 16-byte chunks a row
  static constexpr int ROW = D * 2;
  static constexpr int BYTES = TP * ROW;
  static constexpr int RING = kStages * 2 * BYTES;
  static_assert(CPR % 8 == 0 || CPR == 12, "a swizzle for this row width");
  __device__ static int off(int r, int c) {
    const int x = (CPR % 8 == 0 || c < 8) ? (r & 7) : ((r >> 1) & 3);
    return r * ROW + ((c ^ x) << 4);
  }
};

// f32: 32-position tiles, rows of 4*D bytes padded by 16.
template <int D>
struct TileF {
  static constexpr int TP = 32;
  static constexpr int CPR = D / 4;
  static constexpr int ROW = D * 4 + 16;
  static constexpr int BYTES = TP * ROW;
  static constexpr int RING = kStages * 2 * BYTES;
  __device__ static int off(int r, int c) { return r * ROW + (c << 4); }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  const int n = valid ? 16 : 0;          // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Positions [p0, p0 + TP) of one kv head into a stage; positions >= s1 are
// zero-filled (their source address is clamped to p0, which is < s1).
template <class Tile, typename T>
__device__ __forceinline__ void load_tile(uint8_t* sk, uint8_t* sv,
                                          const T* k, const T* v,
                                          long long base,
                                          long long row_stride, int p0,
                                          int s1) {
  constexpr int kChunks = Tile::TP * Tile::CPR;
  static_assert(kChunks % kThreads == 0, "whole chunks per thread");
  constexpr int kPerChunk = 16 / sizeof(T);
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / Tile::CPR, c = i % Tile::CPR;
    const int pos = p0 + r;
    const bool ok = pos < s1;
    const long long src =
        base + static_cast<long long>(ok ? pos : p0) * row_stride
        + c * kPerChunk;
    const int so = Tile::off(r, c);
    cp16(smem_u32(sk + so), k + src, ok);
    cp16(smem_u32(sv + so), v + src, ok);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---- the common end of a block -------------------------------------------
//
// The block's merged state for its `rows` query rows is in shared memory:
// fm[r], fl[r], facc[r * D + d]. One stretch: write out. Otherwise write
// the partials, count in, and let the last block merge all stretches in
// split order.
template <typename T, int D>
__device__ void finish(const float* fm, const float* fl, const float* facc,
                       int rows, T* out_rows, float* ws_ml, float* ws_acc,
                       int* counter, long long row0, int split, int splits,
                       int used) {
  __shared__ int last;
  if (used == 1) {
    for (int i = threadIdx.x; i < rows * D; i += kThreads)
      store(out_rows + i, facc[i] / fmaxf(fl[i / D], 1e-30f));
    return;
  }
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    ws_acc[((row0 + r) * splits + split) * D + d] = facc[i];
  }
  if (threadIdx.x < rows) {
    const long long j = ((row0 + threadIdx.x) * splits + split) * 2;
    ws_ml[j] = fm[threadIdx.x];
    ws_ml[j + 1] = fl[threadIdx.x];
  }
  __threadfence();                 // partials visible before the count
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == used - 1;
    if (last) atomicExch(counter, 0);      // ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // one pass over the stretches in split order, an online log-sum-exp
  // (a row's threads take the same steps, so they agree on its l); the
  // partials come from L2 (__ldcg: this SM's L1 never held them)
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const float2* ml = reinterpret_cast<const float2*>(ws_ml)
                       + (row0 + r) * splits;
    const float* part = ws_acc + (row0 + r) * splits * D + d;
    float mx = kMasked, a = 0.f, ls = 0.f;
#pragma unroll 4
    for (int j = 0; j < used; ++j) {
      const float2 p = __ldcg(ml + j);
      const float x = __ldcg(part + static_cast<long long>(j) * D);
      const float mn = fmaxf(mx, p.x);
      const float c0 = __expf(mx - mn), c1 = __expf(p.x - mn);
      a = fmaf(x, c1, a * c0);
      ls = fmaf(p.y, c1, ls * c0);
      mx = mn;
    }
    store(out_rows + i, a / fmaxf(ls, 1e-30f));
  }
}

// ---- bf16: tensor cores ----------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a . b, m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_decode_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const int* __restrict__ filled,
                         bf16* __restrict__ out, float* __restrict__ ws_ml,
                         float* __restrict__ ws_acc, int* __restrict__ cnt,
                         int s_len, int h, int hkv, int gchunks, int splits,
                         int chunk) {
  using Tile = TileB<D>;
  constexpr int TP = Tile::TP;
  constexpr int KS = D / 16;             // k-steps of Q K^T
  constexpr int NT = D / 8;              // n-tiles of P V
  extern __shared__ __align__(128) uint8_t smem[];

  const int split = blockIdx.x;
  const int kv = blockIdx.y / gchunks;
  const int g0 = (blockIdx.y % gchunks) * kMaxRows;
  const int b = blockIdx.z;
  const int g = h / hkv;
  const int rows = min(kMaxRows, g - g0);
  const long long row0 = static_cast<long long>(b) * h + kv * g + g0;
  bf16* out_rows = out + row0 * D;
  const int fill = __ldg(filled + b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;

  // Q as the A operand: rows gq and gq + 8, zero past the group (loaded
  // while filled[b] is in flight)
  uint32_t qa[KS][4];
  {
    const bf16* qr = q + row0 * D;
    const bool r0 = gq < rows, r1 = gq + 8 < rows;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = kk * 16 + 2 * tq;
      qa[kk][0] = r0 ? ld_pair(qr + gq * D + c) : 0u;
      qa[kk][1] = r1 ? ld_pair(qr + (gq + 8) * D + c) : 0u;
      qa[kk][2] = r0 ? ld_pair(qr + gq * D + c + 8) : 0u;
      qa[kk][3] = r1 ? ld_pair(qr + (gq + 8) * D + c + 8) : 0u;
    }
  }
  const int end = min(max(fill, 0), s_len);
  if (end == 0) {                        // length 0 gives 0
    if (split == 0)
      for (int i = threadIdx.x; i < rows * D; i += kThreads)
        out_rows[i] = __float2bfloat16(0.f);
    return;
  }
  const int s0 = split * chunk;
  if (s0 >= end) return;                 // uniform: not counted in `used`
  const int s1 = min(s0 + chunk, end);
  const int used = min(splits, (end + chunk - 1) / chunk);
  const int ntiles = (s1 - s0 + TP - 1) / TP;

  const long long row_stride = static_cast<long long>(hkv) * D;
  const long long base = static_cast<long long>(b) * s_len * row_stride
                         + static_cast<long long>(kv) * D;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles)
      load_tile<Tile>(smem + st * 2 * Tile::BYTES,
                      smem + st * 2 * Tile::BYTES + Tile::BYTES, k, v, base,
                      row_stride, s0 + st * TP, s1);
    cp_commit();
  }

  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_wait<kStages - 2>();              // tile t has landed (this thread)
    __syncthreads();                     // ... for all; tile t-1 is done
    {
      const int nt = t + kStages - 1;
      if (nt < ntiles) {
        uint8_t* st = smem + (nt % kStages) * 2 * Tile::BYTES;
        load_tile<Tile>(st, st + Tile::BYTES, k, v, base, row_stride,
                        s0 + nt * TP, s1);
      }
      cp_commit();
    }
    const uint8_t* sk = smem + (t % kStages) * 2 * Tile::BYTES;
    const uint8_t* sv = sk + Tile::BYTES;
    const int p0 = s0 + t * TP + warp * 16;   // this warp's 16 positions
    if (p0 >= s1) continue;                   // uniform across the warp

    // S = Q K^T over two n-tiles of 8 positions
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const int krow = warp * 16 + j * 8 + (lane & 7);
#pragma unroll
      for (int k2 = 0; k2 < D / 32; ++k2) {
        uint32_t kb[4];
        ldsm_x4(smem_u32(sk + Tile::off(krow, k2 * 4 + (lane >> 3))), kb);
        mma_bf16(sc[j], qa[2 * k2], kb[0], kb[1]);
        mma_bf16(sc[j], qa[2 * k2 + 1], kb[2], kb[3]);
      }
    }

    // scale, mask, online softmax on the fragment (rows gq and gq + 8)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = p0 + j * 8 + 2 * tq + e < s1;
        sc[j][e] = ok ? sc[j][e] * Scale<D>::value : kMasked;
        sc[j][2 + e] = ok ? sc[j][2 + e] * Scale<D>::value : kMasked;
        mx0 = fmaxf(mx0, sc[j][e]);
        mx1 = fmaxf(mx1, sc[j][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = __expf(m0 - mx0), a1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    uint32_t pa[4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = p0 + j * 8 + 2 * tq + e < s1;
        // rounded to bf16 here, so l sums what P V multiplies
        p[e] = ok ? __bfloat162float(__float2bfloat16(__expf(sc[j][e] - mx0)))
                  : 0.f;
        p[2 + e] = ok ? __bfloat162float(
                            __float2bfloat16(__expf(sc[j][2 + e] - mx1)))
                      : 0.f;
      }
      ps0 += p[0] + p[1];
      ps1 += p[2] + p[3];
      pa[2 * j] = pack_bf16(p[0], p[1]);
      pa[2 * j + 1] = pack_bf16(p[2], p[3]);
    }
    l0 = fmaf(l0, a0, ps0);
    l1 = fmaf(l1, a1, ps1);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }

    // O += P V, V by ldmatrix.trans, two n-tiles of 8 columns a load
    const int vrow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t vb[4];
      ldsm_x4_t(smem_u32(sv + Tile::off(vrow, n2 * 2 + (lane >> 4))), vb);
      mma_bf16(acc[2 * n2], pa, vb[0], vb[1]);
      mma_bf16(acc[2 * n2 + 1], pa, vb[2], vb[3]);
    }
  }
  cp_wait<0>();
  __syncthreads();                       // the ring is free

  // shared memory from here: facc [16][D], fm [16], fl [16] (the block's
  // state), then the warps' states wacc [4][16][D], wm, wl [4][16]
  float* facc = reinterpret_cast<float*>(smem);
  float* fm = facc + kMaxRows * D;
  float* fl = fm + kMaxRows;
  float* wacc = fl + kMaxRows;
  float* wm = wacc + kWarps * kMaxRows * D;
  float* wl = wm + kWarps * kMaxRows;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (tq == 0) {
    wm[warp * kMaxRows + gq] = m0;
    wm[warp * kMaxRows + gq + 8] = m1;
    wl[warp * kMaxRows + gq] = l0;
    wl[warp * kMaxRows + gq + 8] = l1;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float* w0 = wacc + (warp * kMaxRows + gq) * D + n * 8 + 2 * tq;
    float* w1 = w0 + 8 * D;
    w0[0] = acc[n][0];
    w0[1] = acc[n][1];
    w1[0] = acc[n][2];
    w1[1] = acc[n][3];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float mx = kMasked;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * kMaxRows + r]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = __expf(wm[w * kMaxRows + r] - mx);
      a = fmaf(wacc[(w * kMaxRows + r) * D + d], e, a);
      ls = fmaf(wl[w * kMaxRows + r], e, ls);
    }
    facc[i] = a;
    if (d == 0) {
      fm[r] = mx;
      fl[r] = ls;
    }
  }
  __syncthreads();
  finish<bf16, D>(fm, fl, facc, rows, out_rows, ws_ml, ws_acc,
                  cnt + static_cast<long long>(b) * gridDim.y + blockIdx.y,
                  row0, split, splits, used);
}

// ---- f32: FMA on CUDA cores ----------------------------------------------

template <int D, int R>
__global__ void __launch_bounds__(kThreads, 2)
flash_decode_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ filled,
                        float* __restrict__ out, float* __restrict__ ws_ml,
                        float* __restrict__ ws_acc, int* __restrict__ cnt,
                        int s_len, int h, int hkv, int gchunks, int splits,
                        int chunk) {
  using Tile = TileF<D>;
  constexpr int TP = Tile::TP;
  static_assert(TP == 32, "one lane a position");
  constexpr int RW = R / kWarps;         // rows a warp owns in Q K^T
  // P V: thread t < RS * D owns column t % D of rows t / D + RS * i. D 64
  // and 128 divide the block (RS 2 and 1: every thread owns a column); at
  // D 96 RS is 1 and threads 96-127 (warp 3) own none and sit P V out
  constexpr int RS = kThreads / D;       // threads a column in P V
  constexpr int NR = R / RS;             // rows a thread owns in P V
  static_assert(RS >= 1 && R % RS == 0, "whole rows per thread in P V");
  extern __shared__ __align__(128) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem + Tile::RING);   // [R][D]
  float* ps = qs + R * D;                                    // [R][TP]
  float* al = ps + R * TP;                                   // [R]

  const int split = blockIdx.x;
  const int kv = blockIdx.y / gchunks;
  const int g0 = (blockIdx.y % gchunks) * R;
  const int b = blockIdx.z;
  const int g = h / hkv;
  const int rows = min(R, g - g0);
  const long long row0 = static_cast<long long>(b) * h + kv * g + g0;
  float* out_rows = out + row0 * D;
  const int fill = __ldg(filled + b);
  for (int i = threadIdx.x; i < R * D; i += kThreads)
    qs[i] = i / D < rows ? __ldg(q + row0 * D + i) : 0.f;
  const int end = min(max(fill, 0), s_len);
  if (end == 0) {
    if (split == 0)
      for (int i = threadIdx.x; i < rows * D; i += kThreads) out_rows[i] = 0.f;
    return;
  }
  const int s0 = split * chunk;
  if (s0 >= end) return;
  const int s1 = min(s0 + chunk, end);
  const int used = min(splits, (end + chunk - 1) / chunk);
  const int ntiles = (s1 - s0 + TP - 1) / TP;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = threadIdx.x % D, rgrp = threadIdx.x / D;
  const bool pv = threadIdx.x < RS * D;  // owns a column in P V

  const long long row_stride = static_cast<long long>(hkv) * D;
  const long long base = static_cast<long long>(b) * s_len * row_stride
                         + static_cast<long long>(kv) * D;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles)
      load_tile<Tile>(smem + st * 2 * Tile::BYTES,
                      smem + st * 2 * Tile::BYTES + Tile::BYTES, k, v, base,
                      row_stride, s0 + st * TP, s1);
    cp_commit();
  }

  float m[RW], lp[RW], acc[NR];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    m[j] = kMasked;
    lp[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_wait<kStages - 2>();
    __syncthreads();                     // also: P V of tile t-1 is done
    {
      const int nt = t + kStages - 1;
      if (nt < ntiles) {
        uint8_t* st = smem + (nt % kStages) * 2 * Tile::BYTES;
        load_tile<Tile>(st, st + Tile::BYTES, k, v, base, row_stride,
                        s0 + nt * TP, s1);
      }
      cp_commit();
    }
    const uint8_t* sk = smem + (t % kStages) * 2 * Tile::BYTES;
    const uint8_t* sv = sk + Tile::BYTES;
    const bool ok = s0 + t * TP + lane < s1;

    // Q K^T: this lane's position against the warp's rows
    float s[RW];
#pragma unroll
    for (int j = 0; j < RW; ++j) s[j] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(sk + lane * Tile::ROW);
#pragma unroll 8
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kx = kr[d4];
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        const float4 qx =
            reinterpret_cast<const float4*>(qs + (warp + kWarps * j) * D)[d4];
        s[j] = fmaf(qx.x, kx.x, s[j]);
        s[j] = fmaf(qx.y, kx.y, s[j]);
        s[j] = fmaf(qx.z, kx.z, s[j]);
        s[j] = fmaf(qx.w, kx.w, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      const float x = ok ? s[j] * Scale<D>::value : kMasked;
      const float mx = fmaxf(m[j], warp_max(x));
      const float a = __expf(m[j] - mx);
      const float p = ok ? __expf(x - mx) : 0.f;
      lp[j] = fmaf(lp[j], a, p);
      m[j] = mx;
      const int r = warp + kWarps * j;
      ps[r * TP + lane] = p;
      if (lane == 0) al[r] = a;
    }
    __syncthreads();

    // P V: this thread's column against its rows
    if (pv) {
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[i] *= al[rgrp + RS * i];
#pragma unroll 4
      for (int pp = 0; pp < TP; ++pp) {
        const float vx =
            reinterpret_cast<const float*>(sv + pp * Tile::ROW)[col];
#pragma unroll
        for (int i = 0; i < NR; ++i)
          acc[i] = fmaf(ps[(rgrp + RS * i) * TP + pp], vx, acc[i]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  float* facc = reinterpret_cast<float*>(smem);
  float* fm = facc + kMaxRows * D;
  float* fl = fm + kMaxRows;
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const float l = warp_sum(lp[j]);
    if (lane == 0) {
      fm[warp + kWarps * j] = m[j];
      fl[warp + kWarps * j] = l;
    }
  }
  if (pv) {
#pragma unroll
    for (int i = 0; i < NR; ++i) facc[(rgrp + RS * i) * D + col] = acc[i];
  }
  __syncthreads();
  finish<float, D>(fm, fl, facc, rows, out_rows, ws_ml, ws_acc,
                   cnt + static_cast<long long>(b) * gridDim.y + blockIdx.y,
                   row0, split, splits, used);
}

// ---- launch --------------------------------------------------------------

// Dynamic shared memory of a kernel: the ring (whose bytes the block's
// state reuses at the end), and in f32 the q rows, p and the rescales.
template <int D>
constexpr int smem_bf16() { return TileB<D>::RING; }
template <int D, int R>
constexpr int smem_f32() {
  return TileF<D>::RING + (R * D + R * TileF<D>::TP + R) * 4;
}
// the bf16 block's state at the end (facc, fm, fl and the warps' wacc,
// wm, wl) in the ring's bytes, at every instantiated D
template <int D>
constexpr bool bf16_state_fits() {
  return (kMaxRows * 5 * D + 10 * kMaxRows) * 4 <= TileB<D>::RING;
}
static_assert(bf16_state_fits<64>() && bf16_state_fits<96>()
                  && bf16_state_fits<128>(),
              "the bf16 state fits the ring");

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned long long& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (ready >> dev & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) ready |= 1ull << dev;
  return err;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* filled;
  void* out;
  float* ws_ml;
  float* ws_acc;
  int* cnt;
  int b, s_len, h, hkv, splits, chunk;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_bf16(const Args& a, bool occupancy_only, int* blocks) {
  static unsigned long long ready = 0;
  constexpr int smem = smem_bf16<D>();
  const auto kernel = flash_decode_bf16_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem, ready);
  if (err != cudaSuccess) return err;
  if (occupancy_only)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                         kThreads, smem);
  const int gchunks = (a.h / a.hkv + kMaxRows - 1) / kMaxRows;
  const dim3 grid(a.splits, a.hkv * gchunks, a.b);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.filled, static_cast<bf16*>(a.out),
      a.ws_ml, a.ws_acc, a.cnt, a.s_len, a.h, a.hkv, gchunks, a.splits,
      a.chunk);
  return cudaGetLastError();
}

template <int D, int R>
cudaError_t launch_f32(const Args& a, bool occupancy_only, int* blocks) {
  static unsigned long long ready = 0;
  constexpr int smem = smem_f32<D, R>();
  const auto kernel = flash_decode_f32_kernel<D, R>;
  cudaError_t err = allow_smem(kernel, smem, ready);
  if (err != cudaSuccess) return err;
  if (occupancy_only)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                         kThreads, smem);
  const int gchunks = (a.h / a.hkv + R - 1) / R;
  const dim3 grid(a.splits, a.hkv * gchunks, a.b);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.filled, static_cast<float*>(a.out),
      a.ws_ml, a.ws_acc, a.cnt, a.s_len, a.h, a.hkv, gchunks, a.splits,
      a.chunk);
  return cudaGetLastError();
}

// The f32 path's rows per block: the group size rounded up to 4, 8 or 16.
int f32_rows(int g) { return g <= 4 ? 4 : g <= 8 ? 8 : 16; }

cudaError_t dispatch(bool is_bf16, int d, const Args& a, bool occupancy_only,
                     int* blocks) {
  if (d != 64 && d != 96 && d != 128) return cudaErrorInvalidValue;
  if (a.hkv <= 0 || a.h % a.hkv != 0) return cudaErrorInvalidValue;
  if (is_bf16)
    return d == 64   ? launch_bf16<64>(a, occupancy_only, blocks)
           : d == 96 ? launch_bf16<96>(a, occupancy_only, blocks)
                     : launch_bf16<128>(a, occupancy_only, blocks);
  switch (f32_rows(a.h / a.hkv) * 1000 + d) {
    case 4064: return launch_f32<64, 4>(a, occupancy_only, blocks);
    case 8064: return launch_f32<64, 8>(a, occupancy_only, blocks);
    case 16064: return launch_f32<64, 16>(a, occupancy_only, blocks);
    case 4096: return launch_f32<96, 4>(a, occupancy_only, blocks);
    case 8096: return launch_f32<96, 8>(a, occupancy_only, blocks);
    case 16096: return launch_f32<96, 16>(a, occupancy_only, blocks);
    case 4128: return launch_f32<128, 4>(a, occupancy_only, blocks);
    case 8128: return launch_f32<128, 8>(a, occupancy_only, blocks);
    default: return launch_f32<128, 16>(a, occupancy_only, blocks);
  }
}

}  // namespace

extern "C" const char* flash_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blocks of the kernel for (dtype, d, group size) one SM holds, into
// *blocks; sets the kernel's shared-memory limit on the current device.
extern "C" int flash_decode_occupancy(int is_bf16, int d, int group,
                                      int* blocks) {
  Args a{};
  a.h = group;
  a.hkv = 1;
  return static_cast<int>(dispatch(is_bf16 != 0, d, a, true, blocks));
}

// q [b,h,d], k/v [b,s,hkv,d], out [b,h,d] in one type (bf16 or f32);
// filled [b] int32; ws_ml [b,h,splits,2] and ws_acc [b,h,splits,d] f32
// scratch; cnt [b, hkv * row chunks] int32, zero before the first call and
// left zero by every call. All contiguous, on the current device, 16-byte
// aligned. Returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape it refuses).
extern "C" int flash_decode(int is_bf16, const void* q, const void* k,
                            const void* v, const int* filled, void* out,
                            float* ws_ml, float* ws_acc, int* cnt, int b,
                            int s_len, int h, int hkv, int d, int splits,
                            int chunk, void* stream) {
  if (splits <= 0 || chunk <= 0 || b < 0 || s_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaSuccess);
  if (s_len == 0) {                     // nothing to read: every row is 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(b) * h * d * (is_bf16 ? 2 : 4),
        static_cast<cudaStream_t>(stream)));
  }
  const Args a{q, k, v, filled, out, ws_ml, ws_acc, cnt,
               b, s_len, h, hkv, splits, chunk,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(is_bf16 != 0, d, a, false, nullptr));
}
