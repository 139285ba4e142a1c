// Tiled SIMT min-plus (tropical) matrix product for sm_90a:
//
//   out[i, j] = min_k a[i, k] + b[k, j]
//
// Replaces: src/repro/kernels/tropical_matmul/kernel.py::minplus_pallas
// (body _minplus_kernel).  It is the core search of an HoD query
// (src/repro/core/query.py::_core_update): at full size a is the batch's
// core labels [32, C] and b the core closure [C, C], C = 15,722.
//
// What bounds it: operations, then bytes.  The tensor cores cannot do
// (min, +), so every (add, min) pair is two fp32 instructions on the SIMT
// lanes: 32 x C^2 pairs ~ 1.6e10 instructions, against ~0.99 GB of b to
// read once.  The design keeps b's traffic at one read: a block owns all
// 32 rows of a (BM = 32) and a 64-column strip of out, and walks K in
// tiles of 32 through shared memory, so each element of b is loaded from
// device memory by exactly one block.  Each thread keeps a 4 x 4 register
// tile of running minima (16 independent chains for latency hiding) and
// reads its operands as float4 broadcasts from shared memory: two shared
// loads feed 32 arithmetic instructions.  The next K tile is loaded into
// registers while the current one is consumed, which hides the global
// load latency that the low occupancy (few blocks per SM at M = 32) would
// otherwise expose.
//
// The TPU grid's sequential K axis (kernel.py, dimension "arbitrary")
// becomes the loop inside the block.  Ragged edges load +inf, which is
// absorbing under (min, +).  Arithmetic is a plain fp32 add and fminf;
// min is exact in any order, so results equal the plain PyTorch version
// bit for bit.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry point returns cudaGetLastError() of the launch.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;   // rows of out per block
constexpr int BN = 64;   // columns of out per block
constexpr int BK = 32;   // K tile
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);        // 128
constexpr int A_PER_THREAD = BM * BK / THREADS;       // 8
constexpr int B_PER_THREAD = BK * BN / THREADS;       // 16
constexpr int A_PAD = 4;  // keeps float4 alignment, cuts store conflicts

__global__ void __launch_bounds__(THREADS)
minplus_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ out, int M, int N, int K,
               long long lda) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];  // As[k][m]
  __shared__ __align__(16) float Bs[BK][BN];

  const float inf = __int_as_float(0x7f800000);
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = inf;

  float pa[A_PER_THREAD];
  float pb[B_PER_THREAD];
  // Tile element e of this thread: A as (m, k) with k fastest (coalesced
  // along a's rows), B as (k, n) with n fastest (coalesced along b's rows).
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int r = 0; r < A_PER_THREAD; ++r) {
      const int e = tid + r * THREADS;
      const int gm = row0 + e / BK;
      const int gk = k0 + e % BK;
      pa[r] = (gm < M && gk < K) ? a[gm * lda + gk] : inf;
    }
#pragma unroll
    for (int r = 0; r < B_PER_THREAD; ++r) {
      const int e = tid + r * THREADS;
      const int gk = k0 + e / BN;
      const int gn = col0 + e % BN;
      pb[r] = (gk < K && gn < N)
                  ? b[static_cast<long long>(gk) * N + gn] : inf;
    }
  };

  if (K > 0) load_tile(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < A_PER_THREAD; ++r) {
      const int e = tid + r * THREADS;
      As[e % BK][e / BK] = pa[r];
    }
#pragma unroll
    for (int r = 0; r < B_PER_THREAD; ++r) {
      const int e = tid + r * THREADS;
      Bs[e / BN][e % BN] = pb[r];
    }
    __syncthreads();
    if (k0 + BK < K) load_tile(k0 + BK);   // in flight during the compute
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float ar[TM] = {av.x, av.y, av.z, av.w};
      const float br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fminf(acc[i][j], ar[i] + br[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c < N) out[static_cast<long long>(r) * N + c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int tropical_minplus(const void* a, const void* b, void* out,
                                int M, int N, int K, long long lda,
                                void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  minplus_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), M, N, K, lda);
  return static_cast<int>(cudaGetLastError());
}
