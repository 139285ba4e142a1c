// Split-K SIMT min-plus (tropical) matrix product for sm_90a:
//
//   out[i, j] = min_k a[i, k] + b[k, j]
//
// Replaces: src/repro/kernels/tropical_matmul/kernel.py::minplus_pallas
// (body _minplus_kernel).  It is the core search of an HoD query
// (src/repro/core/query.py::_core_update): at full size a is the batch's
// core labels [32, C] and b the core closure [C, C], C = 15,722.  It also
// serves core_mode="bellman" (a = the running core labels, b = the core
// adjacency).
//
// What bounds it: operations at the FP32 issue rate.  The tensor cores
// cannot do (min, +), so every (add, min) pair is two instructions on the
// SIMT lanes: 2 x 32 x C^2 = 1.58e10 instructions against 132 SMs x 128
// lanes x 1.98 GHz = 33.5e12 a second, 0.472 ms; b's 0.99 GB read once take
// 0.295 ms of that at 3.35 TB/s, so the loads must overlap the arithmetic
// and cost no issue slots.
//
// Design.
// * Tile.  A block of 128 threads owns BM = 32 rows and BN = 128 columns of
//   out over one chunk of K.  Warp w holds rows 8w..8w+7, lane l columns
//   4l..4l+3: 32 independent running minima a thread.  Per 4-deep step of
//   K a thread reads its 8 rows of a as float4 broadcasts (all lanes of a
//   warp read one address) and 4 float4 rows of b (a warp reads 512
//   contiguous bytes: no bank conflict), 12 shared loads for 256 adds and
//   mins.  ptxas keeps it within 128 registers (__launch_bounds__(128, 4)),
//   with no spills.  (A 4-row tile, 256 threads and 32 x 256 tiles, two
//   blocks and 16 warps an SM, measured 10% slower.)
// * Ring.  K is walked in tiles of BK = 32 through a 2-stage cp.async ring
//   (a tile of a, 4 KB, and of b, 16 KB, a stage: 40 KB a block, 4 blocks
//   and 16 warps an SM).  One tile is in flight while the other computes:
//   the copies of tile kt+1 are issued right after the one barrier of tile
//   kt, and waited for (cp.async.wait_group 0) before tile kt+1 starts; no
//   thread stages data through registers.  A 3-stage ring (60 KB, 3 blocks
//   an SM) came first and ran slower at full size on an H100 (0.6981-0.7078
//   ms against 0.6832-0.6932 ms for 2 stages, PERF.md): with 4 resident
//   blocks an SM, the other three blocks' arithmetic can cover one block's
//   copy, so a fourth block an SM is worth more than a second tile in
//   flight.
//   Rows of b are 4*N bytes apart, which is not a multiple of 16 at
//   N = 15,722 (so neither 16-byte copies nor a TMA tensor map, whose
//   strides must be multiples of 16 bytes, can take b), so the copy width
//   (16, 8 or 4 bytes) is picked per call from the alignment of each
//   operand (template arguments VA, VB).  Interior tiles copy without
//   per-copy tests.  In the SASS of the full-size build (VA = VB = 8) a K
//   tile is ~2,210 instructions a thread as run, 2,048 of them the FADDs
//   and FMNMXs and 96 shared loads.
// * Split K.  The grid is (column tiles, K chunks, row tiles).  The
//   wrapper (ops.py::plan_split_k) sizes the chunks in whole K tiles so
//   that the blocks fill whole waves of the resident blocks (4 an SM on
//   the H100, asked of the runtime): at full size 123 column tiles x 17
//   chunks of 29 tiles (928 of K) = 2,091 blocks, 4 waves of 528.  Each
//   chunk's minima go to a [n_k, M, N] scratch the wrapper allocates
//   (34 MB at full size) and a second pass takes the min over the chunks
//   (13.7 us at full size).  A cluster reduction through distributed
//   shared memory was not chosen: 17 chunks exceed the portable cluster
//   size of 8, and a cluster's blocks must be co-scheduled, which fights
//   the wave fill.  With one chunk the block writes out directly and the
//   second pass is skipped.
//
// The TPU grid's sequential K axis (kernel.py, dimension "arbitrary")
// becomes the loop inside the block.  Ragged edges: a's columns past K
// hold +inf (absorbing under (min, +)); rows of b past K and columns past
// N are zero-filled by cp.async and meet +inf or are never stored; rows of
// a past M are never stored.  Arithmetic is a plain fp32 add and fminf;
// min is exact in any order, so results equal the plain PyTorch version
// bit for bit.  No atomics.
//
// The kernels allocate nothing (the wrapper passes the scratch) and launch
// on the caller's stream; the C entry point returns cudaGetLastError()
// after its launches.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int BM = 32;          // rows of out per block (all of a batch)
constexpr int BK = 32;          // K tile
constexpr int STAGES = 2;

constexpr int TM = 8;           // rows of out a thread (one warp's share)
constexpr int THREADS = 128;    // 4 warps x 32 lanes, 4 columns a lane
constexpr int BN = 128;         // columns of out per block
constexpr int A_TILE = BM * BK;                  // floats, As[m][k]
constexpr int B_TILE = BK * BN;                  // floats, Bs[k][n]
constexpr int STAGE = A_TILE + B_TILE;
constexpr size_t SMEM = sizeof(float) * STAGES * STAGE;   // 40,960 bytes
static_assert(BM == TM * THREADS / 32 && BN == 4 * 32, "tile mapping");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// V bytes global -> shared; src_bytes 0 zero-fills (nothing is read).
template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                 "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::
                 "r"(smem_u32(dst)), "l"(src), "n"(V), "r"(src_bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2));
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

template <int VA, int VB>
__global__ void __launch_bounds__(THREADS, 4)
minplus_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ dst, int M, int N, int K, long long lda,
               int chunk) {
  extern __shared__ __align__(16) float smem[];
  const float inf = __int_as_float(0x7f800000);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.y * chunk;
  const int kend = min(kbeg + chunk, K);
  const int m0 = blockIdx.z * BM;
  const int n_kt = (kend - kbeg + BK - 1) / BK;

  // Copies of one stage: a as [BM][BK] (VA-byte chunks along k), b as
  // [BK][BN] (VB-byte chunks along n).  VA/4 divides K and VB/4 divides
  // N, so a chunk never straddles the edge.  Copy r of a thread lands at
  // tile element c0 + r * THREADS * E: for a the same k and a fixed number
  // of rows further, for b the same column and a fixed number of rows
  // further, so each source address is the previous one plus a stride (no
  // per-copy address kept in registers across the K loop).
  constexpr int EA = VA / 4, EB = VB / 4;
  constexpr int A_CHUNKS = A_TILE / EA / THREADS;
  constexpr int B_CHUNKS = B_TILE / EB / THREADS;
  constexpr int A_ROWS = THREADS * EA / BK;     // rows between copies
  constexpr int B_ROWS = THREADS * EB / BN;
  static_assert(A_CHUNKS >= 1 && A_ROWS >= 1 && B_ROWS >= 1, "copy map");
  // Tiles wholly inside a, b and the chunk (all but the edges) copy
  // without per-copy tests: one address add and one cp.async a copy.
  const int am = tid * EA / BK, ak = tid * EA % BK;
  const int bk = tid * EB / BN, bn = tid * EB % BN;
  const bool a_rows_in = m0 + BM <= M;
  const bool b_cols_in = n0 + BN <= N;
  const bool bn_ok = n0 + bn < N;
  auto load_tile = [&](int stage, int kt) {
    float* as = smem + stage * STAGE + tid * EA;
    float* bs = smem + stage * STAGE + A_TILE + tid * EB;
    const int k0 = kbeg + kt * BK;
    const bool k_in = k0 + BK <= kend;
    const float* sa = a + (m0 + am) * lda + k0 + ak;
    if (k_in && a_rows_in) {
#pragma unroll
      for (int r = 0; r < A_CHUNKS; ++r, sa += A_ROWS * lda)
        cp_async<VA>(as + r * THREADS * EA, sa, VA);
    } else if (k0 + ak < kend) {
#pragma unroll
      for (int r = 0; r < A_CHUNKS; ++r, sa += A_ROWS * lda) {
        const bool ok = m0 + am + r * A_ROWS < M;
        cp_async<VA>(as + r * THREADS * EA, ok ? sa : a, ok ? VA : 0);
      }
    } else {
#pragma unroll
      for (int r = 0; r < A_CHUNKS; ++r)
#pragma unroll
        for (int e = 0; e < EA; ++e) as[r * THREADS * EA + e] = inf;
    }
    const float* sb = b + static_cast<long long>(k0 + bk) * N + n0 + bn;
    const long long b_step = static_cast<long long>(B_ROWS) * N;
    if (k_in && b_cols_in) {
#pragma unroll
      for (int r = 0; r < B_CHUNKS; ++r, sb += b_step)
        cp_async<VB>(bs + r * THREADS * EB, sb, VB);
    } else {
#pragma unroll
      for (int r = 0; r < B_CHUNKS; ++r, sb += b_step) {
        const bool ok = bn_ok && k0 + bk + r * B_ROWS < kend;
        cp_async<VB>(bs + r * THREADS * EB, ok ? sb : b, ok ? VB : 0);
      }
    }
  };

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = inf;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_kt) load_tile(s, s);
    cp_async_commit();              // empty groups keep the count aligned
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_stages();         // this thread's copies of tile kt
    __syncthreads();                // everyone's; and tile kt-1 is consumed
    const int nxt = kt + STAGES - 1;
    if (nxt < n_kt) load_tile(nxt % STAGES, nxt);
    cp_async_commit();
    const float* as = smem + (kt % STAGES) * STAGE + warp * TM * BK;
    const float* bs = smem + (kt % STAGES) * STAGE + A_TILE + lane * 4;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + i * BK + k4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 bv =
            *reinterpret_cast<const float4*>(bs + (k4 + j) * BN);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float ai = comp(av[i], j);
          acc[i][0] = fminf(acc[i][0], ai + bv.x);
          acc[i][1] = fminf(acc[i][1], ai + bv.y);
          acc[i][2] = fminf(acc[i][2], ai + bv.z);
          acc[i][3] = fminf(acc[i][3], ai + bv.w);
        }
      }
    }
  }

  // dst is out ([M, N]) or this chunk's slice of the scratch.
  float* d = dst + static_cast<long long>(blockIdx.y) * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + warp * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + lane * 4 + j;
      if (c < N) d[static_cast<long long>(r) * N + c] = acc[i][j];
    }
  }
}

// out = min over the n_k chunk slices of the scratch.
__global__ void __launch_bounds__(256)
minplus_combine_kernel(const float* __restrict__ part, float* __restrict__ out,
                       long long mn, int n_k) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < mn;
       i += static_cast<long long>(gridDim.x) * 256) {
    float v = part[i];
    for (int c = 1; c < n_k; ++c) v = fminf(v, part[c * mn + i]);
    out[i] = v;
  }
}

template <int VA, int VB>
cudaError_t launch(const float* a, const float* b, float* dst, int M, int N,
                   int K, long long lda, int n_k, int chunk,
                   cudaStream_t stream) {
  // Set on every call: the attribute is per device, and costs ~1 us of
  // host time against a launch of half a millisecond.
  const cudaError_t err = cudaFuncSetAttribute(
      minplus_kernel<VA, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, n_k, (M + BM - 1) / BM);
  minplus_kernel<VA, VB><<<grid, THREADS, SMEM, stream>>>(a, b, dst, M, N, K,
                                                          lda, chunk);
  return cudaGetLastError();
}

cudaError_t launch_widths(int va, int vb, const float* a, const float* b,
                          float* dst, int M, int N, int K, long long lda,
                          int n_k, int chunk, cudaStream_t st) {
#define MINPLUS_CASE(A, B)                                                  \
  if (va == A && vb == B)                                                   \
    return launch<A, B>(a, b, dst, M, N, K, lda, n_k, chunk, st);
  MINPLUS_CASE(16, 16) MINPLUS_CASE(16, 8) MINPLUS_CASE(16, 4)
  MINPLUS_CASE(8, 16) MINPLUS_CASE(8, 8) MINPLUS_CASE(8, 4)
  MINPLUS_CASE(4, 16) MINPLUS_CASE(4, 8) MINPLUS_CASE(4, 4)
#undef MINPLUS_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Resident blocks of the split pass on one SM, and its dynamic shared
// memory: out[0], out[1].  The wrapper sizes the split from them.
extern "C" int tropical_minplus_config(int* out) {
  const cudaError_t err = cudaFuncSetAttribute(
      minplus_kernel<4, 4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = static_cast<int>(SMEM);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], minplus_kernel<4, 4>, THREADS, SMEM));
}

// a [M, K] with row stride lda (rows contiguous), b [K, N] contiguous,
// out [M, N]; part [n_k, M, N] scratch when n_k > 1 (else unused).  va, vb:
// copy widths in bytes (16, 8 or 4) that the operands' alignment allows;
// chunk: K per split, a multiple of 32, with n_k = ceil(K / chunk).
extern "C" int tropical_minplus(const void* a, const void* b, void* out,
                                void* part, int M, int N, int K,
                                long long lda, int n_k, int chunk, int va,
                                int vb, void* stream) {
  if (M < 1 || N < 1 || K < 1 || n_k < 1 || chunk % BK != 0 ||
      static_cast<long long>(n_k - 1) * chunk >= K ||
      static_cast<long long>(n_k) * chunk < K)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* o = static_cast<float*>(out);
  float* dst = n_k > 1 ? static_cast<float*>(part) : o;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      launch_widths(va, vb, af, bf, dst, M, N, K, lda, n_k, chunk, st);
  if (err != cudaSuccess || n_k == 1) return static_cast<int>(err);
  const long long mn = static_cast<long long>(M) * N;
  const int grid = static_cast<int>(std::min((mn + 255) / 256, 132LL * 16));
  minplus_combine_kernel<<<grid, 256, 0, st>>>(dst, o, mn, n_k);
  return static_cast<int>(cudaGetLastError());
}
