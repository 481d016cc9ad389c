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
// so no one-hot product and no edge-block skip are needed. The rows of a
// real graph are skewed (hub nodes; the training path's CSRs hold every
// weight-0 padding arc of a partition in one row, a third of its arcs), so
// the work is split by merge path (csr_rows.cuh): each warp walks at most
// K merged row ends and arcs, and a second small pass adds the partial
// sums of rows that span warps, in a fixed order. One warp walking a whole
// row made the kernel's time that of its longest row (7.6 ms against 0.08
// ms on the main path's partitions, NVIDIA H100 80GB HBM3). Ragged N, F and
// E are masked here; nothing is padded.
#include <cuda_runtime.h>

#include "csr_rows.cuh"

namespace {

using repro_torch::Split;

template <bool kVec>
__global__ void __launch_bounds__(repro_torch::kGatherThreads)
csr_aggregate_gather(const float* __restrict__ h, const int* __restrict__ src,
                     const int* __restrict__ row_ptr,
                     const float* __restrict__ w,
                     const float* __restrict__ inv, float* __restrict__ out,
                     float* __restrict__ tail, float* __restrict__ head,
                     int* __restrict__ head_row, int n, int e, int f,
                     Split split) {
  repro_torch::gather_pass<kVec>(h, src, row_ptr, w, inv, out, tail, head,
                                 head_row, n, e, f, split);
}

__global__ void __launch_bounds__(repro_torch::kFixupWarps * repro_torch::kWarp)
csr_aggregate_fixup(const int* __restrict__ row_ptr,
                    const float* __restrict__ inv,
                    const float* __restrict__ tail,
                    const float* __restrict__ head,
                    const int* __restrict__ head_row, float* __restrict__ out,
                    int f, Split split) {
  repro_torch::fixup_pass(row_ptr, inv, tail, head, head_row, out, f, split);
}

}  // namespace

extern "C" const char* csr_aggregate_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// h [n,f], src [e], row_ptr [n+1], w [e], inv [n] or null, out [n,f];
// scratch: tail and head [warps,f] f32, head_row [warps] int32, warps =
// ceil((n + e) / items). All contiguous, on the device. Returns
// cudaGetLastError().
extern "C" int csr_aggregate_f32(const float* h, const int* src,
                                 const int* row_ptr, const float* w,
                                 const float* inv, float* out, float* tail,
                                 float* head, int* head_row, int n, int e,
                                 int f, int items, int warps, void* stream) {
  if (items < 1 || items > repro_torch::kMaxItems)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && f > 0 && warps > 0) {
    const Split split{items, warps};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto gather = f % 4 == 0 ? csr_aggregate_gather<true>
                                   : csr_aggregate_gather<false>;
    gather<<<repro_torch::gather_grid(split, f),
                           repro_torch::kGatherThreads, 0, s>>>(
        h, src, row_ptr, w, inv, out, tail, head, head_row, n, e, f, split);
    csr_aggregate_fixup<<<repro_torch::fixup_grid(split),
                          repro_torch::kFixupWarps * repro_torch::kWarp, 0,
                          s>>>(row_ptr, inv, tail, head, head_row, out, f,
                               split);
  }
  return static_cast<int>(cudaGetLastError());
}
