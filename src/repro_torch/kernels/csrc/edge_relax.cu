// One whole HoD sweep of in-place edge relaxation, all its plan levels in
// one cooperative launch, on a node-major label state, for sm_90a.
//
// Replaces: src/repro/kernels/edge_relax/kernel.py::relax_bucketed_pallas
// (body _relax_kernel) together with the gather and the scatter-min that
// its caller wraps around it (src/repro/core/query.py::_relax_level) and
// the lax.scan over a sweep's levels (_run_plan):
//
//   for each level l, in order; for each row r of l; for each source s:
//     dist[row_dst[r], s] = min(dist[row_dst[r], s],
//                               min over slots e of r: dist[src[e], s] + w[e])
//
// Layout.  dist is node-major, [N, S] f32, rows contiguous: at S = 32 one
// node's labels are one 128-byte line, so the labels a slot needs arrive
// in whole sectors.  The sweep is packed once on the host
// (kernels/edge_relax/sweep.py::pack_sweep): per level, one CSR row per
// distinct destination, with only the slots of finite weight; levels are
// concatenated behind a level pointer.  The TPU kernel's bucketed plan
// padded every row to K = 16 slots (90% +inf padding on the forward sweep
// of the served index) and had dist[:, src_idx] gathered into device
// memory beforehand; here nothing is padded and nothing is staged.
//
// What bounds it: bytes in the bound, and at the served shapes the
// latency of each level.  A level reads its rows' CSR entries and, per
// slot, one node's S labels; it writes S labels a row.  Labels stay in
// the 50 MB L2 (5.1 MB at N = 40,001, S = 32).  A level is short
// (12,516-22,394 rows forward, 789-8,029 backward), so one launch a
// level would pay a launch and a ramp each time: the whole sweep is one
// cooperative launch with a grid barrier between levels.  On the H100
// the barrier and a level's dependent loads cost ~2.4 us a level
// whatever its size (PERF.md), the larger part of a served sweep.
//
// Mapping.  A row is served by `lanes` threads (a power of two, at most
// 32), each covering kVec consecutive labels at a time: 16-byte loads
// when S is a multiple of 4 and dist 16-byte aligned (8 lanes a row and
// 4 rows a warp at S = 32), else 4-byte loads; S wider than 32 x kVec
// loops over column chunks.  At a level with long rows, `ways` groups of
// lanes (lanes x ways within one warp) split each row's slots and merge
// their minima by shuffles: the backward sweep's first levels hold rows
// of 32-59 slots, which one thread would walk in turn.  The ways of each
// level come from the host (sweep.py::ways_of, which also sizes the
// grid), one int a level for this launch's lanes.  Rows are walked
// grid-stride within a level; the grid is sized to the widest level.
//
// Correctness:
// * In place is race-free within a level: its gathered nodes and its
//   written nodes are disjoint (same-rank nodes are never adjacent; the
//   packer checks it), and each destination has exactly one row, so each
//   label has one writer a level and no atomics are needed.
// * Across levels, dist is written inside the kernel, so it is never read
//   through the non-coherent path or L1: it is not `const __restrict__`,
//   and every load is __ldcg (L2 only).  grid.sync() orders one level's
//   stores before the next level's loads.
// * The sentinel node is never a destination, so its labels stay +inf.
// * Arithmetic is one fp32 add and fminf a slot, with no contraction
//   possible; min is exact in any order, so results equal the plain
//   PyTorch version (and the JAX level body) bit for bit.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry point returns the launch's error (a grid larger than the resident
// blocks is refused by the cooperative launch, and reported).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;

template <int kVec>
struct Labels;

template <>
struct Labels<4> {
  float4 v;
  static __device__ __forceinline__ Labels load(const float* p) {
    return {__ldcg(reinterpret_cast<const float4*>(p))};
  }
  static __device__ __forceinline__ Labels inf() {
    const float i = __int_as_float(0x7f800000);
    return {make_float4(i, i, i, i)};
  }
  __device__ __forceinline__ void store(float* p) const {
    __stcg(reinterpret_cast<float4*>(p), v);
  }
  __device__ __forceinline__ void relax(const Labels& o, float w) {
    v.x = fminf(v.x, o.v.x + w);
    v.y = fminf(v.y, o.v.y + w);
    v.z = fminf(v.z, o.v.z + w);
    v.w = fminf(v.w, o.v.w + w);
  }
};

template <>
struct Labels<1> {
  float v;
  static __device__ __forceinline__ Labels load(const float* p) {
    return {__ldcg(p)};
  }
  static __device__ __forceinline__ Labels inf() {
    return {__int_as_float(0x7f800000)};
  }
  __device__ __forceinline__ void store(float* p) const { __stcg(p, v); }
  __device__ __forceinline__ void relax(const Labels& o, float w) {
    v = fminf(v, o.v + w);
  }
};

template <int kVec>
__device__ __forceinline__ Labels<kVec> min_over_ways(Labels<kVec> v,
                                                     unsigned mask,
                                                     int lanes, int per_row);

template <>
__device__ __forceinline__ Labels<4> min_over_ways(Labels<4> v, unsigned mask,
                                                  int lanes, int per_row) {
  for (int off = lanes; off < per_row; off <<= 1) {
    v.v.x = fminf(v.v.x, __shfl_xor_sync(mask, v.v.x, off));
    v.v.y = fminf(v.v.y, __shfl_xor_sync(mask, v.v.y, off));
    v.v.z = fminf(v.v.z, __shfl_xor_sync(mask, v.v.z, off));
    v.v.w = fminf(v.v.w, __shfl_xor_sync(mask, v.v.w, off));
  }
  return v;
}

template <>
__device__ __forceinline__ Labels<1> min_over_ways(Labels<1> v, unsigned mask,
                                                  int lanes, int per_row) {
  for (int off = lanes; off < per_row; off <<= 1) {
    v.v = fminf(v.v, __shfl_xor_sync(mask, v.v, off));
  }
  return v;
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
relax_sweep_kernel(float* dist, const int* __restrict__ levels,
                   const int* __restrict__ level_ways, int n_levels,
                   const int* __restrict__ row_dst,
                   const int* __restrict__ row_ptr,
                   const int* __restrict__ src, const float* __restrict__ w,
                   int n_cols, int lanes) {
  const int chunks = n_cols / kVec;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int lane = tid % lanes;  // which labels of the row
  for (int l = 0; l < n_levels; ++l) {
    const int ways = level_ways[l];     // lanes x ways <= 32
    const int per_row = lanes * ways;   // a power of two, at most 32
    const int way = tid / lanes % ways;  // which of the row's slots
    const int group = tid / per_row;
    const int groups = gridDim.x * (kThreads / per_row);
    // The threads of one row that share `lane` (the shuffle partners).
    unsigned mask = 0;
    const int first = (threadIdx.x & 31 & ~(per_row - 1)) + lane;
    for (int k = 0; k < ways; ++k) mask |= 1u << (first + k * lanes);
    const int r_end = levels[l + 1];
    for (int r = levels[l] + group; r < r_end; r += groups) {
      const long long d = row_dst[r];
      const int e0 = row_ptr[r] + way;
      const int e1 = row_ptr[r + 1];
      for (int c = lane; c < chunks; c += lanes) {
        float* out = dist + d * n_cols + c * kVec;
        Labels<kVec> best = way == 0 ? Labels<kVec>::load(out)
                                     : Labels<kVec>::inf();
        // (An unroll of 4 made ptxas spill in the 16-byte form.)
#pragma unroll 2
        for (int e = e0; e < e1; e += ways) {
          best.relax(Labels<kVec>::load(
                         dist + static_cast<long long>(src[e]) * n_cols +
                         c * kVec),
                     w[e]);
        }
        best = min_over_ways(best, mask, lanes, per_row);
        if (way == 0) best.store(out);
      }
    }
    if (l + 1 < n_levels) cg::this_grid().sync();
  }
}

template <int kVec>
cudaError_t launch(float* dist, const int* levels, const int* ways,
                   int n_levels, const int* row_dst, const int* row_ptr,
                   const int* src, const float* w, int n_cols, int lanes,
                   int blocks, cudaStream_t stream) {
  void* args[] = {&dist, &levels, &ways, &n_levels, &row_dst,
                  &row_ptr, &src, &w, &n_cols, &lanes};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(relax_sweep_kernel<kVec>), dim3(blocks),
      dim3(kThreads), args, 0, stream);
}

}  // namespace

// out[0] = threads a block; out[1] = resident blocks an SM of both the
// 16-byte and the 4-byte form (a cooperative grid may not exceed them).
extern "C" int edge_relax_config(int* out) {
  int wide = 0, narrow = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &wide, relax_sweep_kernel<4>, kThreads, 0);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &narrow, relax_sweep_kernel<1>, kThreads, 0);
  }
  out[0] = kThreads;
  out[1] = wide < narrow ? wide : narrow;
  return static_cast<int>(err);
}

extern "C" int edge_relax_sweep(void* dist, const void* levels,
                                const void* ways, int n_levels,
                                const void* row_dst, const void* row_ptr,
                                const void* src, const void* w, int n_cols,
                                int vec, int lanes, int blocks,
                                void* stream) {
  auto* f = static_cast<float*>(dist);
  auto* lv = static_cast<const int*>(levels);
  auto* wy = static_cast<const int*>(ways);
  auto* rd = static_cast<const int*>(row_dst);
  auto* rp = static_cast<const int*>(row_ptr);
  auto* s = static_cast<const int*>(src);
  auto* wt = static_cast<const float*>(w);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec == 4 ? launch<4>(f, lv, wy, n_levels, rd, rp, s, wt, n_cols, lanes,
                           blocks, st)
               : launch<1>(f, lv, wy, n_levels, rd, rp, s, wt, n_cols, lanes,
                           blocks, st);
  const cudaError_t last = cudaGetLastError();  // and clear it
  return static_cast<int>(err != cudaSuccess ? err : last);
}
