// One-token GQA attention over a KV cache (flash decoding), for sm_90a.
//
// Replaces: src/repro/kernels/flash_decode/kernel.py::flash_decode_pallas
// (body _decode_kernel, per-(b, kh) call _decode_one), which
// src/repro/models/layers.py::attention_decode computes on the LM decode
// path:
//
//   out[b, kh*G+g, :] = sum_{s < n_valid} p[s] v[b, s, kh, :] / sum_s p[s]
//   p[s] = exp(q[b, kh*G+g, :] . k[b, s, kh, :] - max),  n_valid = kv_len
//
// q arrives pre-scaled by dh^-0.5 and rounded to the model's dtype by the
// wrapper, then widened to f32 (exact).  Caches are [B, S, Kh, dh], bf16 or
// f32, contiguous.  The output is f32 [B, H, dh], divided by max(l, 1e-30).
//
// Deliberate departure from the Pallas body: it casts p to the cache dtype
// before the PV product (kernel.py:50).  attention_decode (layers.py:333)
// and flash_decode_ref keep p in f32; so does this kernel.
//
// Design.  The TPU kernel walked the KV blocks of one (b, kh) in order on
// one core, carrying (max, sum, acc) across grid steps.  Here the G query
// heads of one KV head are folded into one block's rows, so each K/V row is
// read once per (b, kh), and S is split across blocks: at decode_32k there
// are only B*Kh = 64 (b, kh) pairs for 132 SMs.  Pass 1 (grid n_split x Kh
// x B) walks its split in tiles of 64 positions and writes its
// unnormalised acc with its (max, sum); pass 2 (one block per (b, kh))
// rescales the splits to the global max and divides.  Positions >= n_valid
// are never read: a split covers whole tiles of [0, n_valid), and the last
// tile's tail is scored -inf with zero V.  All softmax arithmetic is f32
// with expf (not __expf).  Pass 1 comes in two forms:
//
// * bf16 caches, G <= 16, dh in {16, 32, 64, 128} (the serving path): tensor
//   cores.  Four warps take 16 positions of a tile each; cp.async double-
//   buffers the K and V tiles into shared memory (rows padded by 16 bytes,
//   so ldmatrix is conflict-free) while the previous tile computes.  QK^T is
//   mma.m16n8k16 with the G heads as the 16 rows (padded with zero rows).
//   p stays f32 because it is fed to the PV product as three bf16 terms
//   p = p1 + p2 + p3, which hold its 24 significant bits exactly: every
//   product with a bf16 V is exact in the f32 accumulator, so PV equals an
//   f32 PV up to the order of the sums.  An f32 q is split the same way
//   (one term when the caller's q was bf16).  Each warp keeps its own
//   running max, sum and acc in registers; the four merge in shared memory.
// * otherwise (f32 caches, G > 16, other dh): SIMT f32.  The tile of K and
//   V is staged in shared memory as f32, the G x 64 scores are dot products
//   from shared memory (four heads a thread, K rows padded to dh+4 floats so
//   the float4 reads are conflict-free), one warp per head updates the
//   running max and sum, and the PV product accumulates into float4
//   registers (G*dh/256 of them a thread).
//
// What bounds it: bytes.  A step reads the K and V rows below n_valid once
// (2*B*Kh*n_valid*dh elements).  The tensor-core form issues, per 16
// positions and 8 columns of dh, one QK^T mma (three for an f32 q) and three
// PV mma, far below the byte time; the SIMT form needs ~80% of the card's
// f32 FMA rate to reach it at G=16, dh=128 and does not.
//
// The kernels allocate nothing (the wrapper passes the split scratch) and
// launch on the caller's stream; the C entry point returns
// cudaGetLastError() after both launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;    // positions per staged tile (two per lane)
constexpr int kMaxAcc = 4;   // float4 accumulators a thread: G*dh <= 4096

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

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
decode_split_kernel(const float* __restrict__ q, const T* __restrict__ kc,
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
  const float* qb = q + bk * n_group * dh;
  for (int i = tid; i < n_group * dh; i += kThreads) sq[i] = qb[i];
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
// Pass 1 on tensor cores (bf16 caches, G <= 16, dh in {16, 32, 64, 128}).

constexpr int kTcWarps = 4;                 // 16 positions of a tile each
constexpr int kTcThreads = kTcWarps * 32;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, zero-filled when !valid (nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
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

template <int DH>
__global__ void __launch_bounds__(kTcThreads, 2)
decode_split_tc_kernel(const float* __restrict__ q,
                       const __nv_bfloat16* __restrict__ kc,
                       const __nv_bfloat16* __restrict__ vc,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       int seq, int n_kv, int n_group, int n_valid,
                       int n_split, int split_len, int q_terms) {
  constexpr int RS = DH + 8;          // a staged row: dh bf16 + 16 bytes
  constexpr int CH = DH / 8;          // 16-byte chunks a row
  constexpr int NT = DH / 8;          // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [3][16][RS]
  __nv_bfloat16* sk = sq + 3 * 16 * RS;                  // [2][kTile][RS]
  __nv_bfloat16* sv = sk + 2 * kTile * RS;               // [2][kTile][RS]

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;  // fragment row, column pair

  const long long bk = static_cast<long long>(b) * n_kv + kh;
  const float* qb = q + bk * n_group * DH;
  for (int i = tid; i < 16 * DH; i += kTcThreads) {
    const int g = i / DH, d = i - g * DH;
    __nv_bfloat16 t[3];
    split3(g < n_group ? qb[g * DH + d] : 0.f, t);
#pragma unroll
    for (int j = 0; j < 3; ++j) sq[(j * 16 + g) * RS + d] = t[j];
  }

  const long long row = static_cast<long long>(n_kv) * DH;
  const __nv_bfloat16* kb = kc + static_cast<long long>(b) * seq * row + kh * DH;
  const __nv_bfloat16* vb = vc + static_cast<long long>(b) * seq * row + kh * DH;
  const int lo = split * split_len;
  const int hi = min(lo + split_len, n_valid);
  const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;

  auto load_tile = [&](int it) {
    const int t0 = lo + it * kTile;
    __nv_bfloat16* dk = sk + (it & 1) * kTile * RS;
    __nv_bfloat16* dv = sv + (it & 1) * kTile * RS;
    for (int i = tid; i < kTile * CH; i += kTcThreads) {
      const int t = i / CH, c = (i - t * CH) * 8;
      const bool ok = t0 + t < hi;
      const long long off = ok ? (t0 + t) * row + c : 0;
      cp_async16(dk + t * RS + c, kb + off, ok);
      cp_async16(dv + t * RS + c, vb + off, ok);
    }
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {neg_inf(), neg_inf()}, l_run[2] = {0.f, 0.f};

  if (n_tiles > 0) load_tile(0);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_tile(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                  // tile it (and q) visible to all warps
    const __nv_bfloat16* tk = sk + ((it & 1) * kTile + warp * 16) * RS;
    const __nv_bfloat16* tv = sv + ((it & 1) * kTile + warp * 16) * RS;

    // S[16 heads x 16 positions] = Q K^T, as two 8-position n-tiles.
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      unsigned kf[4];
      ldsm_x4(kf, tk + ((lane & 7) + (lane >> 4) * 8) * RS + ks * 16 +
                      ((lane >> 3) & 1) * 8);
      for (int j = 0; j < q_terms; ++j) {
        unsigned qf[4];
        ldsm_x4(qf, sq + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                        ks * 16 + (lane >> 4) * 8);
        mma_bf16(s[0], qf, kf[0], kf[1]);
        mma_bf16(s[1], qf, kf[2], kf[3]);
      }
    }

    // Online softmax on rows gr (s[.][0..1]) and gr + 8 (s[.][2..3]); the
    // four lanes of a quad hold one row's 16 positions.
    const int pos0 = lo + it * kTile + warp * 16 + tg * 2;
    float mt[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (pos0 + n * 8 + e >= hi) s[n][e] = s[n][2 + e] = neg_inf();
        mt[0] = fmaxf(mt[0], s[n][e]);
        mt[1] = fmaxf(mt[1], s[n][2 + e]);
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
        s[n][e] = expf(s[n][e] - m_safe[0]);
        s[n][2 + e] = expf(s[n][2 + e] - m_safe[1]);
        ps[0] += s[n][e];
        ps[1] += s[n][2 + e];
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

    // P as the A operand (k = position): a0 = s[0][0..1], a1 = s[0][2..3],
    // a2 = s[1][0..1], a3 = s[1][2..3], each as three exact bf16 terms.
    unsigned pf[3][4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float* src = &s[f >> 1][(f & 1) * 2];
      __nv_bfloat16 lo3[3], hi3[3];
      split3(src[0], lo3);
      split3(src[1], hi3);
#pragma unroll
      for (int j = 0; j < 3; ++j) pf[j][f] = pack2(lo3[j], hi3[j]);
    }
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      unsigned vf[4];
      ldsm_x4_t(vf, tv + ((lane & 7) + ((lane >> 3) & 1) * 8) * RS + dp * 16 +
                        (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        mma_bf16(acc[2 * dp], pf[j], vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pf[j], vf[2], vf[3]);
      }
    }
    __syncthreads();                  // this stage is free for tile it + 2
  }

  // Merge the four warps' (max, sum, acc) in shared memory (the staging
  // buffers are idle now), then write this split's partials.
  float* rm = reinterpret_cast<float*>(sk);   // [warps][16] max
  float* rl = rm + kTcWarps * 16;             // [warps][16] sum
  float* ra = rl + kTcWarps * 16;             // [warps][16][DH] acc
  __syncthreads();
  if (tg == 0) {
    rm[warp * 16 + gr] = m_run[0];
    rm[warp * 16 + gr + 8] = m_run[1];
    rl[warp * 16 + gr] = l_run[0];
    rl[warp * 16 + gr + 8] = l_run[1];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + tg * 2;
    ra[(warp * 16 + gr) * DH + d] = acc[n][0];
    ra[(warp * 16 + gr) * DH + d + 1] = acc[n][1];
    ra[(warp * 16 + gr + 8) * DH + d] = acc[n][2];
    ra[(warp * 16 + gr + 8) * DH + d + 1] = acc[n][3];
  }
  __syncthreads();
  const long long part = bk * n_split + split;
  for (int i = tid; i < n_group * DH; i += kTcThreads) {
    const int g = i / DH, d = i - g * DH;
    float m = neg_inf();
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) m = fmaxf(m, rm[w * 16 + g]);
    const float m_safe = m == neg_inf() ? 0.f : m;
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) {
      const float mw = rm[w * 16 + g];
      const float sc = mw == neg_inf() ? 0.f : expf(mw - m_safe);
      a += sc * ra[(w * 16 + g) * DH + d];
      l += sc * rl[w * 16 + g];
    }
    part_acc[part * n_group * DH + i] = a;
    if (d == 0) {
      part_m[part * n_group + g] = m;
      part_l[part * n_group + g] = l;
    }
  }
}

// One block per (b, kh): rescale each split to the global max and divide.
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      float* __restrict__ out, int n_group, int dh,
                      int n_split) {
  const long long bk = blockIdx.x;
  for (int i = threadIdx.x; i < n_group * dh; i += kThreads) {
    const int g = i / dh;
    const float* pm = part_m + bk * n_split * n_group + g;
    const float* pl = part_l + bk * n_split * n_group + g;
    float m = neg_inf();
    for (int s = 0; s < n_split; ++s) m = fmaxf(m, pm[s * n_group]);
    const float m_safe = m == neg_inf() ? 0.f : m;
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float ms = pm[s * n_group];
      const float w = ms == neg_inf() ? 0.f : expf(ms - m_safe);
      num += w * part_acc[(bk * n_split + s) * n_group * dh + i];
      den += w * pl[s * n_group];
    }
    out[bk * n_group * dh + i] = num / fmaxf(den, 1e-30f);
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

int combine(const float* part_acc, const float* part_ml, float* out,
            int batch, int n_kv, int n_group, int dh, int n_split,
            cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();       // pass 1's launch
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_part = static_cast<long long>(batch) * n_kv * n_split *
                           n_group;
  decode_combine_kernel<<<batch * n_kv, kThreads, 0, stream>>>(
      part_acc, part_ml, part_ml + n_part, out, n_group, dh, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_simt(const float* q, const void* k, const void* v, float* out,
                float* part_acc, float* part_ml, int batch, int seq, int n_kv,
                int n_group, int dh, int n_valid, int n_split, int split_len,
                cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(n_group) * dh + kTile * (dh + 4) + kTile * dh +
       n_group * kTile + 3 * n_group);
  cudaError_t err = raise_smem_limit<decode_split_kernel<T>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_part = static_cast<long long>(batch) * n_kv * n_split *
                           n_group;
  decode_split_kernel<T><<<dim3(n_split, n_kv, batch), kThreads, smem,
                           stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), part_acc,
      part_ml, part_ml + n_part, seq, n_kv, n_group, dh, n_valid, n_split,
      split_len);
  return combine(part_acc, part_ml, out, batch, n_kv, n_group, dh, n_split,
                 stream);
}

template <int DH>
int launch_tc(const float* q, const void* k, const void* v, float* out,
              float* part_acc, float* part_ml, int batch, int seq, int n_kv,
              int n_group, int n_valid, int n_split, int split_len,
              int q_terms, cudaStream_t stream) {
  constexpr int RS = DH + 8;
  const size_t smem = sizeof(__nv_bfloat16) * (3 * 16 * RS + 4 * kTile * RS);
  cudaError_t err = raise_smem_limit<decode_split_tc_kernel<DH>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_part = static_cast<long long>(batch) * n_kv * n_split *
                           n_group;
  decode_split_tc_kernel<DH><<<dim3(n_split, n_kv, batch), kTcThreads, smem,
                               stream>>>(
      q, static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), part_acc, part_ml,
      part_ml + n_part, seq, n_kv, n_group, n_valid, n_split, split_len,
      q_terms);
  return combine(part_acc, part_ml, out, batch, n_kv, n_group, DH, n_split,
                 stream);
}

}  // namespace

extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            void* out, void* part_acc, void* part_ml,
                            int is_bf16, int batch, int seq, int n_kv,
                            int n_group, int dh, int n_valid, int n_split,
                            int split_len, int q_terms, void* stream) {
  if (dh % 8 != 0 || dh > 256 || split_len % kTile != 0 || n_valid < 1 ||
      n_valid > seq || (q_terms != 1 && q_terms != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  float* o = static_cast<float*>(out);
  float* pa = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && n_group <= 16) {
    switch (dh) {
      case 16: return launch_tc<16>(qf, k, v, o, pa, pml, batch, seq, n_kv,
                                    n_group, n_valid, n_split, split_len,
                                    q_terms, st);
      case 32: return launch_tc<32>(qf, k, v, o, pa, pml, batch, seq, n_kv,
                                    n_group, n_valid, n_split, split_len,
                                    q_terms, st);
      case 64: return launch_tc<64>(qf, k, v, o, pa, pml, batch, seq, n_kv,
                                    n_group, n_valid, n_split, split_len,
                                    q_terms, st);
      case 128: return launch_tc<128>(qf, k, v, o, pa, pml, batch, seq, n_kv,
                                      n_group, n_valid, n_split, split_len,
                                      q_terms, st);
      default: break;
    }
  }
  if (n_group * dh > kMaxAcc * 4 * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch_simt<__nv_bfloat16>(qf, k, v, o, pa, pml, batch, seq, n_kv,
                                      n_group, dh, n_valid, n_split,
                                      split_len, st);
  return launch_simt<float>(qf, k, v, o, pa, pml, batch, seq, n_kv, n_group,
                            dh, n_valid, n_split, split_len, st);
}
