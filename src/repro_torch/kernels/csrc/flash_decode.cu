// One-token GQA attention over a KV cache (flash decoding), for sm_90a.
//
// Replaces: src/repro/kernels/flash_decode/kernel.py::flash_decode_pallas
// (body _decode_kernel, per-(b, kh) call _decode_one), which
// src/repro/models/layers.py::attention_decode computes on the LM decode
// path:
//
//   out[b, kh*G+g, :] = sum_{s < n_valid} p[s] v[b, s, kh, :] / sum_s p[s]
//   p[s] = exp(q'[b, kh*G+g, :] . k[b, s, kh, :] - max),  n_valid = kv_len
//
// q' = q * q_scale rounded to q's dtype (JAX's rounding; q_scale is
// dh^-0.5 already rounded to that dtype), computed as the kernel loads q
// and widened to f32 (exact).  Caches are [B, S, Kh, dh], bf16 or f32,
// contiguous.  The output is f32 [B, H, dh], divided by max(l, 1e-30).
//
// Deliberate departure from the Pallas body: it casts p to the cache dtype
// before the PV product (kernel.py:50).  attention_decode (layers.py:333)
// and flash_decode_ref keep p in f32; so does this kernel.
//
// What bounds it: bytes.  A call reads the K and V rows below n_valid once
// (2*B*Kh*n_valid*dh elements: 1.07 GB, 0.32 ms at 3.35 TB/s for glm4's
// decode_32k layer).  The products are far below that on the tensor cores,
// so the design is about keeping enough bytes in flight, in long runs:
// at 3.35 TB/s and ~1.5 us of loaded memory latency that is ~5 MB on the
// card, ~38 KB an SM.
//
// Design.  The TPU kernel walked the KV blocks of one (b, kh) in order on
// one core, carrying (max, sum, acc) across grid steps.  Here the G query
// heads of one KV head are folded into the rows of its warps' products,
// so each K/V row is read once per (b, kh), and S is split across blocks:
// at decode_32k there are only B*Kh = 64 (b, kh) pairs for 132 SMs.  A
// block takes HB KV heads of one batch row (HB = 2 when Kh is even and
// dh <= 128, as glm4's 2): a position's K (and V) record of both heads is
// 512 contiguous bytes, so a 64-position tile is one 32 KB run, not two
// halves fetched by two blocks at two times.  The wrapper
// (ops.py::plan_splits) cuts [0, n_valid) into splits of whole 64-position
// tiles, as many as keep every block resident in one wave, all of one
// length: at decode_32k 4 splits of 128 tiles, 128 blocks, one an SM, so
// all of them stream from start to end together (more, shorter blocks
// measured slower).  Pass 1 (grid n_split x Kh/HB x B) writes each
// (split, kh)'s unnormalised acc with its (max, sum); pass 2 (a block per
// (b, kh, g)) rescales the splits to the global max and divides.
// Positions >= n_valid are never read: a split covers whole tiles of
// [0, n_valid), and the last tile's tail is zero-filled, scored -inf and
// meets p = 0.  All softmax arithmetic is f32 with expf (not __expf).
// Pass 1 comes in two forms:
//
// * bf16 caches, G <= 16, dh in {16, 32, 64, 128, 256} (the serving path
//   at every arch's head size): tensor cores, warp-specialised.  One
//   producer thread fills a ring of stages in shared memory, each one
//   64-position tile of K and of V for the block's heads, with TMA: a
//   3-d tensor map per cache (Kh*dh columns, n_valid positions, B rows;
//   encoded on the host for each call, so
//   positions >= n_valid lie outside it and are zero-filled, never read)
//   cut in boxes of 64 positions x 64 columns (HB*dh columns when the
//   block's heads span fewer: 16 or 32 at dh 16 and 32), swizzled over
//   the box's row (128, 64 or 32 bytes), so ldmatrix reads stay
//   conflict-free without padding.  A tile is HB*dh/64 box requests (4 at
//   decode_32k; one below 64 columns), each stage's K and V counted in bytes
//   on their own full mbarrier.  Four consumer warps a head wait on those
//   barriers and take 16 positions each; K's half is released on its empty
//   mbarrier right after Q K^T, V's as soon as the V fragments are read,
//   before the PV products; no block barrier in the loop.  A bf16 q's
//   fragments stay in registers.  The ring has as many stages (2-4) as fit
//   in the block's share of shared memory beside q: at dh 128, HB 2 and a
//   bf16 q, 3 stages of 64 KB, one block an SM.  What was tried first:
//   one bulk copy a 256-byte row (an SM's TMA unit served such small
//   copies at about one per 35 cycles; 0.59 ms), then 16-byte cp.async
//   copies from a producer warp into padded rows (0.377-0.395 ms, 5-7%
//   slower than SDPA: a block's rate fell as blocks were added, as if an
//   SM's outstanding 16-byte copies were capped whatever the ring's size;
//   TMA copies do not count against that).  QK^T is mma.m16n8k16 with
//   the G heads as the 16 rows (padded with zero rows).  p stays f32
//   because it is fed to the PV product as three bf16 terms
//   p = p1 + p2 + p3, which hold its 24 significant bits exactly: every
//   product with a bf16 V is exact in the f32 accumulator, so PV equals an
//   f32 PV up to the order of the sums.  An f32 q is split the same way
//   (one term when the caller's q was bf16).  Each warp keeps its own
//   running max, sum and acc in registers; a head's four merge in shared
//   memory at the end.
//   At dh 256 (gemma3) a block takes one KV head, and a 64-position stage
//   is the same 64 KB of TMA boxes as dh 128's two heads (4 boxes of 64
//   columns each for K and for V, 128-byte swizzle).  The block fills an
//   SM alone (launch bounds of one block, the whole 227 KB): 3 stages
//   with a bf16 q (8,448 B of q rows) and with an f32 q's three terms
//   (25,344 B).  Eight consumer warps: warps w and w + 4 take the same 16
//   positions, both run Q K^T over all 256 columns (a cheap product, its
//   max and sum come out alike in both), and each owns 128 of the output
//   columns, so a thread holds 64 accumulators and 32 V fragment
//   registers, as at dh 128.  q's fragments are read from shared memory
//   at each step (in registers they would be 64 more a thread).  ptxas:
//   168 registers, no spills.  Measured on an H100 80GB HBM3 at 700 W
//   (chip_smoke.py, tools/time_flash_decode.py): a decode_32k global
//   layer (q [16,16,256], caches [16,32768,8,256]) 1.357 ms against a
//   1.282 ms byte bound and SDPA's 1.453 (the SIMT form: 11.34); a full
//   1,024-slot rolling layer 0.058 ms against 0.040 (with 16 tiles a
//   block, presumably the ring's fill and the combine).  This form was the
//   first tried; a 32-position tile at two blocks an SM was not, as this
//   one leaves at most 6% to the bound on the long layers.
// * otherwise (f32 caches, G > 16, other dh such as 48 or 96): SIMT f32.
//   The tile of K and V is staged in shared memory as f32, the G x 64
//   scores are dot products from shared memory (four heads a thread, K
//   rows padded to dh+4 floats so the float4 reads are conflict-free),
//   one warp per head updates the running max and sum, and the PV
//   product accumulates into float4 registers (G*dh/256 of them a
//   thread).  It needs ~80% of the card's f32 FMA rate to keep up with
//   memory at G=16, dh=128 and does not.
//
// The kernels allocate nothing (the wrapper passes the split scratch) and
// launch on the caller's stream; the C entry point returns
// cudaGetLastError() after both launches.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;    // positions per staged tile (two per lane)
constexpr int kMaxAcc = 4;   // float4 accumulators a thread: G*dh <= 4096

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// q[i] * scale rounded to q's dtype (JAX's rounding of the scaled q),
// then widened to f32 (exact).  scale is dh^-0.5 already rounded to q's
// dtype, so for bf16 q the product of two bf16 values is exact in f32 and
// rounds once.
__device__ __forceinline__ float load_q(const void* q, long long i, int q_bf16,
                                        float scale) {
  if (q_bf16) {
    const float x = __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]);
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, scale)));
  }
  return __fmul_rn(static_cast<const float*>(q)[i], scale);
}

// 16 bytes of T at p, widened to f32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
decode_split_kernel(const void* __restrict__ q, int q_bf16, float q_scale,
                    const T* __restrict__ kc,
                    const T* __restrict__ vc, float* __restrict__ part_acc,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    int seq, int n_kv, int n_group, int dh, int n_valid,
                    int n_split, int split_len) {
  extern __shared__ float smem[];
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ldk = dh + 4;
  float* sq = smem;                       // [G][dh]
  float* sk = sq + n_group * dh;          // [kTile][dh + 4]
  float* sv = sk + kTile * ldk;           // [kTile][dh]
  float* sp = sv + kTile * dh;            // [G][kTile] scores, then p
  float* sm = sp + n_group * kTile;       // [G] running max
  float* sl = sm + n_group;               // [G] running sum
  float* sc = sl + n_group;               // [G] this tile's correction

  const long long bk = static_cast<long long>(b) * n_kv + kh;
  for (int i = tid; i < n_group * dh; i += kThreads)
    sq[i] = load_q(q, bk * n_group * dh + i, q_bf16, q_scale);
  for (int g = tid; g < n_group; g += kThreads) {
    sm[g] = neg_inf();
    sl[g] = 0.f;
  }

  // Accumulator j of this thread is item i = tid + j*kThreads: head i / (dh/4),
  // columns d0[j]..d0[j]+3 with d0[j] = (i % (dh/4)) * 4.  (d0[j] differs
  // between items unless dh/4 divides kThreads, as for dh = 48 or 96.)
  const int d4 = dh / 4;
  const int n_items = n_group * d4;
  int d0[kMaxAcc];
  float acc[kMaxAcc][4];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    d0[j] = ((tid + j * kThreads) % d4) * 4;
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  const long long row = static_cast<long long>(n_kv) * dh;  // between positions
  const T* kb = kc + static_cast<long long>(b) * seq * row + kh * dh;
  const T* vb = vc + static_cast<long long>(b) * seq * row + kh * dh;
  constexpr int E = 16 / sizeof(T);       // elements per 16-byte load
  const int vec_row = dh / E;
  const int lo = split * split_len;
  const int hi = min(lo + split_len, n_valid);

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int nt = min(kTile, hi - t0);
    __syncthreads();                      // the previous tile is consumed
#pragma unroll 4
    for (int i = tid; i < kTile * vec_row; i += kThreads) {
      const int t = i / vec_row, c = (i - t * vec_row) * E;
      float kf[E], vf[E];
      if (t < nt) {
        load16(kb + (t0 + t) * row + c, kf);
        load16(vb + (t0 + t) * row + c, vf);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        *reinterpret_cast<float4*>(sk + t * ldk + c + e) =
            make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
        *reinterpret_cast<float4*>(sv + t * dh + c + e) =
            make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
      }
    }
    __syncthreads();

    // Scores: item = (position t, four heads g0..g0+3).
    const int n_quads = (n_group + 3) / 4;
    for (int i = tid; i < n_quads * kTile; i += kThreads) {
      const int t = i % kTile, g0 = (i / kTile) * 4;
      const int ng = min(4, n_group - g0);
      const float* kr = sk + t * ldk;
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < dh; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < ng) {
            const float4 qv =
                *reinterpret_cast<const float4*>(sq + (g0 + j) * dh + d);
            s4[j] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < ng) sp[(g0 + j) * kTile + t] = t < nt ? s4[j] : neg_inf();
    }
    __syncthreads();

    // Online softmax, one warp per head: lane holds positions lane, lane+32.
    for (int g = warp; g < n_group; g += kThreads / 32) {
      float* pr = sp + g * kTile;
      const float x0 = pr[lane], x1 = pr[lane + 32];
      float mt = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, mt);
      const float m_safe = m_new == neg_inf() ? 0.f : m_new;
      const float p0 = expf(x0 - m_safe), p1 = expf(x1 - m_safe);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      float ps = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      if (lane == 0) {
        const float corr = m_old == neg_inf() ? 0.f : expf(m_old - m_safe);
        sl[g] = sl[g] * corr + ps;
        sm[g] = m_new;
        sc[g] = corr;
      }
    }
    __syncthreads();

    // PV: acc[g, d0..d0+3] = acc * corr[g] + sum_t p[g, t] v[t, d0..d0+3].
    float corr[kMaxAcc];
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int i = tid + j * kThreads;
      corr[j] = i < n_items ? sc[i / d4] : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[j];
    }
    for (int t = 0; t < nt; ++t) {
#pragma unroll
      for (int j = 0; j < kMaxAcc; ++j) {
        const int i = tid + j * kThreads;
        if (i < n_items) {
          const float4 vv =
              *reinterpret_cast<const float4*>(sv + t * dh + d0[j]);
          const float p = sp[(i / d4) * kTile + t];
          acc[j][0] += p * vv.x;
          acc[j][1] += p * vv.y;
          acc[j][2] += p * vv.z;
          acc[j][3] += p * vv.w;
        }
      }
    }
  }

  const long long part = bk * n_split + split;
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < n_items) {
      *reinterpret_cast<float4*>(part_acc + part * n_group * dh +
                                 (i / d4) * dh + d0[j]) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
  }
  for (int g = tid; g < n_group; g += kThreads) {
    part_m[part * n_group + g] = sm[g];
    part_l[part * n_group + g] = sl[g];
  }
}

// ---------------------------------------------------------------------------
// Pass 1 on tensor cores (bf16 caches, G <= 16, dh in {16, 32, 64, 128,
// 256}).

// A block takes HB KV heads of one batch row (HB = 2 when Kh is even and
// dh <= 128): 4 position warps a head, 16 positions of a tile each, and
// one producer warp.  With HB = 2 a tile's K (or V) rows of both heads
// are one run of 64 x 512 contiguous bytes.  At dh 256 each position warp
// has a twin (warps w and w + 4) that takes the same 16 positions: both
// compute Q K^T over all 256 columns, each owns half of the output
// columns, so a warp's accumulator and V fragments stay at dh-128 sizes.
template <int DH>
__host__ __device__ constexpr int tc_col_ways() { return DH > 128 ? 2 : 1; }
template <int DH, int HB>
__host__ __device__ constexpr int tc_threads() {
  return (4 * HB * tc_col_ways<DH>() + 1) * 32;
}
// Resident blocks an SM the form is laid out for: two when one head of
// dh <= 128 leaves a block half an SM's work, else one.
template <int DH, int HB>
__host__ __device__ constexpr int tc_blocks() {
  return HB == 1 && DH <= 128 ? 2 : 1;
}
constexpr int kMaxStages = 4;
// Shared memory a block may take: half an SM's 228 KB less the 1 KB the
// runtime reserves for each block when two blocks share an SM, a block's
// whole 227 KB when it fills the SM alone.
template <int DH, int HB>
constexpr int tc_budget() {
  return tc_blocks<DH, HB>() == 2 ? 232448 / 2 - 1024 : 232448;
}
constexpr int kBarBytes = 4 * kMaxStages * 8;
// A TMA box: kTile positions x BC columns, BC = 64 (128 bytes) or, when
// the block's heads span fewer, all HB*dh of them (64 or 32 bytes); laid
// out in shared memory with the swizzle of its row's width, which wants
// 1024-, 512- or 256-byte alignment.
template <int DH, int HB>
__host__ __device__ constexpr int box_cols() { return HB * DH < 64 ? HB * DH : 64; }
constexpr int kAlign = 1024;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::
               "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("{\n .reg .b64 state;\n"
               " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::
               "r"(smem_u32(bar)) : "memory");
}
// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::
      "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// One TMA box of a 3-d tensor map (column, position, batch row) into
// shared memory; its bytes complete as transactions on `bar`.  Boxes
// reaching past the map's extent are zero-filled, not read.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::
      "r"(smem_u32(dst)), "l"(reinterpret_cast<unsigned long long>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar)) : "memory");
}
// Byte offset of the 16-byte chunk holding column c (a multiple of 8) of
// row r in a staged tile: boxes of BC columns side by side, and within a
// box TMA's swizzle of its row width W (128, 64 or 32 bytes): bits 7 and
// up of the unswizzled offset, as many as pick a chunk of W, flip the
// chunk (for W = 128, chunk j of row r lands at j ^ (r % 8)), so the 8
// rows an ldmatrix reads fall in 8 different banks.
template <int BC>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int W = BC * 2;
  const int off = r * W + ((c % BC) >> 3) * 16;
  return (c / BC) * (W * kTile) + (off ^ (((off >> 7) & (W / 16 - 1)) << 4));
}
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x == t[0] + t[1] + t[2] exactly: three bf16 terms of 8 significant bits
// each hold an f32's 24 (each remainder is exact in f32).
__device__ __forceinline__ void split3(float x, __nv_bfloat16* t) {
  t[0] = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(t[0]);
  t[1] = __float2bfloat16_rn(r);
  t[2] = __float2bfloat16_rn(r - __bfloat162float(t[1]));
}
__device__ __forceinline__ unsigned pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<unsigned*>(&v);
}

// Shared memory of the tensor-core pass: the barriers, q's terms for each
// of the HB heads (rows padded by 16 bytes), and, 1024-byte aligned, a
// ring of `stages` stages of one K and one V tile, each HB*DH/BC TMA
// boxes of kTile rows of BC columns.
template <int DH, int HB>
constexpr int tc_q_bytes(int q_terms) {
  return HB * q_terms * 16 * (DH + 8) * 2;
}
template <int DH, int HB>
constexpr int tc_stage_bytes() { return 2 * HB * DH * 2 * kTile; }
template <int DH, int HB>
int tc_stages(int q_terms) {
  const int fit = (tc_budget<DH, HB>() - kBarBytes -
                   tc_q_bytes<DH, HB>(q_terms) - kAlign) /
                  tc_stage_bytes<DH, HB>();
  return fit < 2 ? 2 : (fit > kMaxStages ? kMaxStages : fit);
}
template <int DH, int HB>
size_t tc_smem(int q_terms) {
  return kBarBytes + tc_q_bytes<DH, HB>(q_terms) + kAlign +
         static_cast<size_t>(tc_stages<DH, HB>(q_terms)) *
             tc_stage_bytes<DH, HB>();
}

template <int DH, int HB>
__global__ void __launch_bounds__(tc_threads<DH, HB>(), tc_blocks<DH, HB>())
decode_split_tc_kernel(const void* __restrict__ q, int q_bf16, float q_scale,
                       const __grid_constant__ CUtensorMap tmap_k,
                       const __grid_constant__ CUtensorMap tmap_v,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       int n_kv, int n_group, int n_valid, int n_split,
                       int split_len, int stages) {
  constexpr int CW = tc_col_ways<DH>();  // warps sharing 16 positions
  constexpr int PW = 4 * HB;          // position warps: 16 positions each
  constexpr int C = PW * CW;          // consumer warps
  constexpr int THREADS = tc_threads<DH, HB>();
  constexpr int RQ = DH + 8;          // a staged q row: dh bf16 + 16 bytes
  constexpr int DW = DH / CW;         // output columns a warp owns
  constexpr int NT = DW / 8;          // its 8-column tiles
  // A bf16 q's fragments stay in registers up to dh 128; at dh 256 they
  // would take 64 registers a thread, so every term is read from shared
  // memory at each step.
  constexpr bool kQRegs = DH <= 128;
  constexpr int BC = box_cols<DH, HB>();
  constexpr int NB = HB * DH / BC;    // TMA boxes of a K or V tile
  constexpr int BOX = BC * 2 * kTile;  // bytes a box
  constexpr int STAGE = 2 * NB * BOX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Per stage, K and V each have a full barrier (their boxes landed) and
  // an empty one (the consumers are done reading them): K is released
  // after Q K^T, before the softmax, so it refills sooner.
  auto* full_k = reinterpret_cast<unsigned long long*>(smem_raw);
  auto* full_v = full_k + kMaxStages;
  auto* empty_k = full_v + kMaxStages;
  auto* empty_v = empty_k + kMaxStages;
  const int q_terms = q_bf16 ? 1 : 3;
  // sq: [HB][q_terms][16][RQ]; ring: [stages][K, V][NB boxes], aligned
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw + kBarBytes);
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<unsigned long long>(sq + HB * q_terms * 16 * RQ) +
       kAlign - 1) & ~static_cast<unsigned long long>(kAlign - 1));

  const int split = blockIdx.x, kh0 = blockIdx.y * HB, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;  // fragment row, column pair
  // A consumer warp's head in the block, its 16 positions of a tile, its
  // share of the columns, and its position warp's index in the block.
  const int h = warp / (4 * CW), pw = warp % 4, cw = warp / 4 % CW;
  const int pid = h * 4 + pw;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], C);
      mbar_init(&empty_v[s], C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const long long bk0 = static_cast<long long>(b) * n_kv + kh0;
  for (int i = tid; i < HB * 16 * DH; i += THREADS) {
    const int hq = i / (16 * DH), g = i / DH % 16, d = i % DH;
    __nv_bfloat16 t[3];
    split3(g < n_group ? load_q(q, ((bk0 + hq) * n_group + g) * DH + d,
                                q_bf16, q_scale)
                       : 0.f, t);
    for (int j = 0; j < q_terms; ++j)
      sq[((hq * q_terms + j) * 16 + g) * RQ + d] = t[j];
  }
  __syncthreads();                    // barriers and q visible to all warps

  const int lo = split * split_len;
  const int hi = min(lo + split_len, n_valid);
  const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
  if (warp == C && lane == 0) {
    // Producer: one thread keeps up to `stages` tiles in flight, each K
    // and V tile NB TMA boxes (a box: 64 positions x BC columns of the
    // block's heads), counted in bytes on its full barrier.  The maps end
    // at n_valid, so positions past it are zero-filled, never read: their
    // scores are set to -inf and their zero V meets p = 0.
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % stages, use = it / stages;
      const int t0 = lo + it * kTile;
      unsigned char* dk = ring + s * STAGE;
      if (use > 0) mbar_wait(&empty_k[s], (use - 1) & 1);
      mbar_arrive_expect_tx(&full_k[s], NB * BOX);
      for (int bx = 0; bx < NB; ++bx)
        tma_load(dk + bx * BOX, &tmap_k, kh0 * DH + bx * BC, t0, b,
                 &full_k[s]);
      if (use > 0) mbar_wait(&empty_v[s], (use - 1) & 1);
      mbar_arrive_expect_tx(&full_v[s], NB * BOX);
      for (int bx = 0; bx < NB; ++bx)
        tma_load(dk + (NB + bx) * BOX, &tmap_v, kh0 * DH + bx * BC, t0, b,
                 &full_v[s]);
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {neg_inf(), neg_inf()}, l_run[2] = {0.f, 0.f};

  if (warp < C) {
    const __nv_bfloat16* sqh = sq + h * q_terms * 16 * RQ;
    auto q_frag = [&](unsigned* qf, int j, int ks) {
      ldsm_x4(qf, sqh + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RQ +
                      ks * 16 + (lane >> 4) * 8);
    };
    // A bf16 q (one term, the serving path) stays in registers up to dh
    // 128.
    [[maybe_unused]] unsigned q1[kQRegs ? DH / 16 : 1][4];
    if constexpr (kQRegs) {
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) q_frag(q1[ks], 0, ks);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % stages;
      const unsigned parity = (it / stages) & 1;
      mbar_wait(&full_k[s], parity);
      const unsigned char* tk = ring + s * STAGE;
      const unsigned char* tv = tk + NB * BOX;

      // S[16 heads x 16 positions] = Q K^T, as two 8-position n-tiles.
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        unsigned kf[4];
        ldsm_x4(kf, tk + swz<BC>(pw * 16 + (lane & 7) + (lane >> 4) * 8,
                                 h * DH + ks * 16 + ((lane >> 3) & 1) * 8));
        if constexpr (kQRegs) {
          mma_bf16(sc[0], q1[ks], kf[0], kf[1]);
          mma_bf16(sc[1], q1[ks], kf[2], kf[3]);
        }
        for (int j = kQRegs ? 1 : 0; j < q_terms; ++j) {
          unsigned qf[4];
          q_frag(qf, j, ks);
          mma_bf16(sc[0], qf, kf[0], kf[1]);
          mma_bf16(sc[1], qf, kf[2], kf[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_k[s]);
      // Online softmax on rows gr (sc[.][0..1]) and gr + 8 (sc[.][2..3]);
      // the four lanes of a quad hold one row's 16 positions.
      const int pos0 = lo + it * kTile + pw * 16 + tg * 2;
      float mt[2] = {neg_inf(), neg_inf()};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (pos0 + n * 8 + e >= hi) sc[n][e] = sc[n][2 + e] = neg_inf();
          mt[0] = fmaxf(mt[0], sc[n][e]);
          mt[1] = fmaxf(mt[1], sc[n][2 + e]);
        }
      }
      float m_safe[2], corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m_run[r], mt[r]);
        m_safe[r] = m_new == neg_inf() ? 0.f : m_new;
        corr[r] = m_run[r] == neg_inf() ? 0.f : expf(m_run[r] - m_safe[r]);
        m_run[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[n][e] = expf(sc[n][e] - m_safe[0]);
          sc[n][2 + e] = expf(sc[n][2 + e] - m_safe[1]);
          ps[0] += sc[n][e];
          ps[1] += sc[n][2 + e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
        ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
        l_run[r] = l_run[r] * corr[r] + ps[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }

      // P as the A operand (k = position): a0 = sc[0][0..1], a1 = sc[0][2..3],
      // a2 = sc[1][0..1], a3 = sc[1][2..3], each as three exact bf16 terms.
      unsigned pf[3][4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float* src = &sc[f >> 1][(f & 1) * 2];
        __nv_bfloat16 lo3[3], hi3[3];
        split3(src[0], lo3);
        split3(src[1], hi3);
#pragma unroll
        for (int j = 0; j < 3; ++j) pf[j][f] = pack2(lo3[j], hi3[j]);
      }
      // All of this warp's V fragments first, so the stage's V is released
      // before the PV products run.
      mbar_wait(&full_v[s], parity);
      unsigned vf[DW / 16][4];
#pragma unroll
      for (int dp = 0; dp < DW / 16; ++dp)
        ldsm_x4_t(vf[dp],
                  tv + swz<BC>(pw * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                               h * DH + cw * DW + dp * 16 + (lane >> 4) * 8));
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_v[s]);
#pragma unroll
      for (int dp = 0; dp < DW / 16; ++dp) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          mma_bf16(acc[2 * dp], pf[j], vf[dp][0], vf[dp][1]);
          mma_bf16(acc[2 * dp + 1], pf[j], vf[dp][2], vf[dp][3]);
        }
      }
    }
  }

  // Merge each head's four position warps' (max, sum, acc) in shared
  // memory (the ring is idle now: every copy landed before its stage was
  // consumed), then write this split's partials.  Twin warps hold the
  // same max and sum (the same scores, computed alike); each writes its
  // own columns of acc.
  float* rm = reinterpret_cast<float*>(ring);  // [PW][16] max
  float* rl = rm + PW * 16;                    // [PW][16] sum
  float* ra = rl + PW * 16;                    // [PW][16][DH] acc
  static_assert((2 + DH) * PW * 16 * 4 <= 2 * STAGE, "merge outgrows ring");
  __syncthreads();
  if (warp < C) {
    if (cw == 0 && tg == 0) {
      rm[pid * 16 + gr] = m_run[0];
      rm[pid * 16 + gr + 8] = m_run[1];
      rl[pid * 16 + gr] = l_run[0];
      rl[pid * 16 + gr + 8] = l_run[1];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = cw * DW + n * 8 + tg * 2;
      ra[(pid * 16 + gr) * DH + d] = acc[n][0];
      ra[(pid * 16 + gr) * DH + d + 1] = acc[n][1];
      ra[(pid * 16 + gr + 8) * DH + d] = acc[n][2];
      ra[(pid * 16 + gr + 8) * DH + d + 1] = acc[n][3];
    }
  }
  __syncthreads();
  for (int i = tid; i < HB * n_group * DH; i += THREADS) {
    const int hm = i / (n_group * DH), e = i % (n_group * DH);
    const int g = e / DH, d = e % DH;
    const int w0 = hm * 4;
    float m = neg_inf();
#pragma unroll
    for (int w = w0; w < w0 + 4; ++w) m = fmaxf(m, rm[w * 16 + g]);
    const float m_safe = m == neg_inf() ? 0.f : m;
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = w0; w < w0 + 4; ++w) {
      const float mw = rm[w * 16 + g];
      const float sc = mw == neg_inf() ? 0.f : expf(mw - m_safe);
      a += sc * ra[(w * 16 + g) * DH + d];
      l += sc * rl[w * 16 + g];
    }
    const long long part = (bk0 + hm) * n_split + split;
    part_acc[part * n_group * DH + e] = a;
    if (d == 0) {
      part_m[part * n_group + g] = m;
      part_l[part * n_group + g] = l;
    }
  }
}

// One block per (b, kh, g), a thread per column: rescale each split to
// the global max and divide.
constexpr int kCombineThreads = 128;
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      float* __restrict__ out, int n_group, int dh,
                      int n_split) {
  const long long bk = blockIdx.x;
  const int g = blockIdx.y;
  const float* pm = part_m + bk * n_split * n_group + g;
  const float* pl = part_l + bk * n_split * n_group + g;
  float m = neg_inf();
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, pm[s * n_group]);
  const float m_safe = m == neg_inf() ? 0.f : m;
  for (int d = threadIdx.x; d < dh; d += kCombineThreads) {
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float ms = pm[s * n_group];
      const float w = ms == neg_inf() ? 0.f : expf(ms - m_safe);
      num += w * part_acc[((bk * n_split + s) * n_group + g) * dh + d];
      den += w * pl[s * n_group];
    }
    out[(bk * n_group + g) * dh + d] = num / fmaxf(den, 1e-30f);
  }
}

// Lift a kernel's dynamic shared memory limit to the largest size asked of
// it so far: one attribute call per kernel and size, not one per launch.
template <auto Kernel>
cudaError_t raise_smem_limit(size_t smem) {
  static size_t granted = 48 * 1024;   // one per kernel
  if (smem <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) granted = smem;
  return err;
}

size_t simt_smem(int n_group, int dh) {
  return sizeof(float) *
         (static_cast<size_t>(n_group) * dh + kTile * (dh + 4) + kTile * dh +
          n_group * kTile + 3 * n_group);
}

int combine(const float* part_acc, const float* part_ml, float* out,
            int batch, int n_kv, int n_group, int dh, int n_split,
            cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();       // pass 1's launch
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_part = static_cast<long long>(batch) * n_kv * n_split *
                           n_group;
  decode_combine_kernel<<<dim3(batch * n_kv, n_group), kCombineThreads, 0,
                          stream>>>(
      part_acc, part_ml, part_ml + n_part, out, n_group, dh, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_simt(const void* q, int q_bf16, float q_scale, const void* k,
                const void* v, float* out, float* part_acc, float* part_ml,
                int batch, int seq, int n_kv, int n_group, int dh,
                int n_valid, int n_split, int split_len, cudaStream_t stream) {
  const size_t smem = simt_smem(n_group, dh);
  cudaError_t err = raise_smem_limit<decode_split_kernel<T>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_part = static_cast<long long>(batch) * n_kv * n_split *
                           n_group;
  decode_split_kernel<T><<<dim3(n_split, n_kv, batch), kThreads, smem,
                           stream>>>(
      q, q_bf16, q_scale, static_cast<const T*>(k), static_cast<const T*>(v),
      part_acc, part_ml, part_ml + n_part, seq, n_kv, n_group, dh, n_valid,
      n_split, split_len);
  return combine(part_acc, part_ml, out, batch, n_kv, n_group, dh, n_split,
                 stream);
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda); null if the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A cache [B, S, Kh, dh] bf16 as a 3-d tensor (Kh*dh columns, n_valid
// positions, B rows) cut into boxes of box_cols columns (64, 32 or 16) x
// kTile positions, swizzled over the box's row: positions >= n_valid lie
// outside it.
bool cache_map(CUtensorMap* map, const void* cache, int batch, int seq,
               int n_kv, int dh, int n_valid, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(n_kv) * dh;
  const cuuint64_t dims[3] = {row, static_cast<cuuint64_t>(n_valid),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {row * 2, row * 2 * seq};   // bytes
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), kTile, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(cache), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, int HB>
int launch_tc(const void* q, int q_bf16, float q_scale, const void* k,
              const void* v, float* out, float* part_acc, float* part_ml,
              int batch, int seq, int n_kv, int n_group, int n_valid,
              int n_split, int split_len, cudaStream_t stream) {
  const int q_terms = q_bf16 ? 1 : 3;
  const size_t smem = tc_smem<DH, HB>(q_terms);
  cudaError_t err = raise_smem_limit<decode_split_tc_kernel<DH, HB>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_k, map_v;
  constexpr int BC = box_cols<DH, HB>();
  if (!cache_map(&map_k, k, batch, seq, n_kv, DH, n_valid, BC) ||
      !cache_map(&map_v, v, batch, seq, n_kv, DH, n_valid, BC))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_part = static_cast<long long>(batch) * n_kv * n_split *
                           n_group;
  decode_split_tc_kernel<DH, HB><<<dim3(n_split, n_kv / HB, batch),
                                   tc_threads<DH, HB>(), smem, stream>>>(
      q, q_bf16, q_scale, map_k, map_v, part_acc, part_ml, part_ml + n_part,
      n_kv, n_group, n_valid, n_split, split_len, tc_stages<DH, HB>(q_terms));
  return combine(part_acc, part_ml, out, batch, n_kv, n_group, DH, n_split,
                 stream);
}

template <int DH>
int launch_tc(int hb, const void* q, int q_bf16, float q_scale,
              const void* k, const void* v, float* out, float* part_acc,
              float* part_ml, int batch, int seq, int n_kv, int n_group,
              int n_valid, int n_split, int split_len, cudaStream_t stream) {
  return hb == 2
      ? launch_tc<DH, 2>(q, q_bf16, q_scale, k, v, out, part_acc, part_ml,
                         batch, seq, n_kv, n_group, n_valid, n_split,
                         split_len, stream)
      : launch_tc<DH, 1>(q, q_bf16, q_scale, k, v, out, part_acc, part_ml,
                         batch, seq, n_kv, n_group, n_valid, n_split,
                         split_len, stream);
}

// KV heads a block of the tensor-core form takes: two when Kh is even
// and dh <= 128 (at dh 256 one head's stage is already 64 KB).
int tc_heads(int n_kv, int dh) { return dh <= 128 && n_kv % 2 == 0 ? 2 : 1; }

// Which form a call takes: the tensor-core dh, or 0 for SIMT.
int tc_form(int kv_bf16, int n_group, int dh) {
  if (!kv_bf16 || n_group > 16) return 0;
  return (dh == 16 || dh == 32 || dh == 64 || dh == 128 || dh == 256) ? dh
                                                                      : 0;
}

template <int DH, int HB>
int tc_config(int q_terms, int* out) {
  const size_t smem = tc_smem<DH, HB>(q_terms);
  cudaError_t err = raise_smem_limit<decode_split_tc_kernel<DH, HB>>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], decode_split_tc_kernel<DH, HB>, tc_threads<DH, HB>(), smem);
  out[1] = static_cast<int>(smem);
  out[2] = tc_stages<DH, HB>(q_terms);
  out[3] = DH;
  out[4] = HB;
  return static_cast<int>(err);
}

template <int DH>
int tc_config(int hb, int q_terms, int* out) {
  return hb == 2 ? tc_config<DH, 2>(q_terms, out)
                 : tc_config<DH, 1>(q_terms, out);
}

template <typename T>
int simt_config(int n_group, int dh, int* out) {
  const size_t smem = simt_smem(n_group, dh);
  cudaError_t err = raise_smem_limit<decode_split_kernel<T>>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], decode_split_kernel<T>, kThreads, smem);
  out[1] = static_cast<int>(smem);
  out[2] = 1;
  out[3] = 0;
  out[4] = 1;
  return static_cast<int>(err);
}

}  // namespace

// The split pass a call takes, for sizing its splits: out[0] resident
// blocks an SM, out[1] dynamic shared memory a block, out[2] ring stages
// (1 for the SIMT form), out[3] the tensor-core form's dh or 0 for SIMT,
// out[4] the KV heads a block takes.
extern "C" int flash_decode_config(int kv_bf16, int q_bf16, int n_kv,
                                   int n_group, int dh, int* out) {
  const int hb = tc_heads(n_kv, dh), q_terms = q_bf16 ? 1 : 3;
  switch (tc_form(kv_bf16, n_group, dh)) {
    case 16: return tc_config<16>(hb, q_terms, out);
    case 32: return tc_config<32>(hb, q_terms, out);
    case 64: return tc_config<64>(hb, q_terms, out);
    case 128: return tc_config<128>(hb, q_terms, out);
    case 256: return tc_config<256, 1>(q_terms, out);
    default: break;
  }
  return kv_bf16 ? simt_config<__nv_bfloat16>(n_group, dh, out)
                 : simt_config<float>(n_group, dh, out);
}

// q [B, H, dh] (bf16 if q_bf16, else f32), scaled in the kernel by
// q_scale (dh^-0.5 rounded to q's dtype) and rounded to q's dtype;
// caches [B, S, Kh, dh] (bf16 if kv_bf16, else f32); out [B, H, dh] f32;
// part_acc [B*Kh*n_split*G*dh] and part_ml [2*B*Kh*n_split*G] scratch.
// Split i covers positions [i*split_len, min((i+1)*split_len, n_valid)).
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            void* out, void* part_acc, void* part_ml,
                            int kv_bf16, int q_bf16, float q_scale, int batch,
                            int seq, int n_kv, int n_group, int dh,
                            int n_valid, int n_split, int split_len,
                            void* stream) {
  if (dh % 8 != 0 || dh > 256 || split_len % kTile != 0 || n_valid < 1 ||
      n_valid > seq || n_split < 1 ||
      static_cast<long long>(n_split - 1) * split_len >= n_valid ||
      static_cast<long long>(n_split) * split_len < n_valid)
    return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  float* pa = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hb = tc_heads(n_kv, dh);
  switch (tc_form(kv_bf16, n_group, dh)) {
    case 16: return launch_tc<16>(hb, q, q_bf16, q_scale, k, v, o, pa, pml,
                                  batch, seq, n_kv, n_group, n_valid, n_split,
                                  split_len, st);
    case 32: return launch_tc<32>(hb, q, q_bf16, q_scale, k, v, o, pa, pml,
                                  batch, seq, n_kv, n_group, n_valid, n_split,
                                  split_len, st);
    case 64: return launch_tc<64>(hb, q, q_bf16, q_scale, k, v, o, pa, pml,
                                  batch, seq, n_kv, n_group, n_valid, n_split,
                                  split_len, st);
    case 128: return launch_tc<128>(hb, q, q_bf16, q_scale, k, v, o, pa, pml,
                                    batch, seq, n_kv, n_group, n_valid,
                                    n_split, split_len, st);
    case 256: return launch_tc<256, 1>(q, q_bf16, q_scale, k, v, o, pa, pml,
                                       batch, seq, n_kv, n_group, n_valid,
                                       n_split, split_len, st);
    default: break;
  }
  if (n_group * dh > kMaxAcc * 4 * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_bf16)
    return launch_simt<__nv_bfloat16>(q, q_bf16, q_scale, k, v, o, pa, pml,
                                      batch, seq, n_kv, n_group, dh, n_valid,
                                      n_split, split_len, st);
  return launch_simt<float>(q, q_bf16, q_scale, k, v, o, pa, pml, batch, seq,
                            n_kv, n_group, dh, n_valid, n_split, split_len,
                            st);
}
