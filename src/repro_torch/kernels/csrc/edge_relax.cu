// One fused, in-place relaxation of one HoD sweep-plan level, for sm_90a.
//
// Replaces: src/repro/kernels/edge_relax/kernel.py::relax_bucketed_pallas
// (body _relax_kernel) together with the gather and the scatter-min that
// its caller wraps around it, src/repro/core/query.py::_relax_level:
//
//   for each valid row m and each source s:
//     dist[s, dst[m]] = min(dist[s, dst[m]],
//                           min_k dist[s, src_idx[m, k]] + w[m, k])
//
// The TPU kernel had the gather dist[:, src_idx] hoisted out of it, into an
// [S, M, K] array in device memory, because in-kernel random access is slow
// there.  Here the kernel gathers from dist itself: at full size dist is
// [32, 40001] f32 (5.1 MB) and stays resident in the 50 MB L2, so no
// intermediate exists and each level reads only the plan rows and the
// L2-resident labels.
//
// What bounds it: bytes.  A level reads its plan rows (src_idx and w,
// 8 bytes per slot) and, at worst, dist once; it does one add and one min
// per (source, slot).  The gather is irregular: one warp serves one row m,
// its lanes are sources s, so a lane's loads land in different rows of
// dist (one 32-byte L2 sector each).  The plan row itself is read once per
// warp as a broadcast.  This is the simple layout; a faster one is later
// work.
//
// Correctness:
// * In place is race-free: a level's gathered nodes (src_idx) and its
//   written nodes (dst) are disjoint by construction of the plan (same-rank
//   nodes are never adjacent), so no warp reads a label another warp writes.
// * Rows of one destination repeat when a long in-edge list is split; they
//   merge by atomicMin on the int32 view of the fp32 bits.  That order
//   matches the float order because every label is +0.0, a positive float
//   or +inf (weights are positive, so -0.0 and NaN cannot arise).
// * Padding rows (row_valid false) return at once; padding slots point at
//   the sentinel column with +inf weight, so they never win and the
//   sentinel (scrap) column stays +inf.
// * Arithmetic is one fp32 add and fminf per slot, with no contraction
//   possible, so results equal the plain PyTorch version bit for bit.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry point returns cudaGetLastError() of the launch.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
relax_level_kernel(float* __restrict__ dist, const int* __restrict__ dst,
                   const int* __restrict__ src_idx,
                   const float* __restrict__ w,
                   const unsigned char* __restrict__ row_valid,
                   int n_sources, int n_rows, int k_slots,
                   long long ld_dist) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows || !row_valid[row]) return;
  const int d = dst[row];
  const int* idx = src_idx + static_cast<long long>(row) * k_slots;
  const float* wr = w + static_cast<long long>(row) * k_slots;
  for (int s = lane; s < n_sources; s += 32) {
    float* drow = dist + static_cast<long long>(s) * ld_dist;
    float best = __int_as_float(0x7f800000);  // +inf
    for (int k = 0; k < k_slots; ++k) {
      best = fminf(best, drow[idx[k]] + wr[k]);
    }
    // Labels only decrease, so a stale read can only be larger than the
    // current value: skipping the atomic when best is not smaller is safe.
    if (best < drow[d]) {
      atomicMin(reinterpret_cast<int*>(drow + d), __float_as_int(best));
    }
  }
}

}  // namespace

extern "C" int edge_relax_level(void* dist, const void* dst,
                                const void* src_idx, const void* w,
                                const void* row_valid, int n_sources,
                                int n_rows, int k_slots, long long ld_dist,
                                void* stream) {
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  relax_level_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(dist), static_cast<const int*>(dst),
      static_cast<const int*>(src_idx), static_cast<const float*>(w),
      static_cast<const unsigned char*>(row_valid), n_sources, n_rows,
      k_slots, ld_dist);
  return static_cast<int>(cudaGetLastError());
}
