// Fused gather and masked bag-sum (EmbeddingBag, mode "sum"), for sm_90a.
//
// Replaces: src/repro/kernels/embedding_bag/kernel.py::bag_sum_pallas (body
// _bag_kernel) together with the gather that its wrapper
// src/repro/kernels/embedding_bag/ops.py::bag_sum hoists into XLA
// (jnp.take(table, ids, axis=0, fill_value=0)):
//
//   out[b, :] = sum_k mask[b, k] * table[ids[b, k], :]
//
// The TPU kernel took the gathered [B, K, D] block from device memory.  Here
// the kernel gathers the rows itself, so no intermediate exists: each table
// row a bag names is read once from device memory and summed in registers.
//
// Layout.  A group of D/VEC threads serves one bag, each thread VEC
// consecutive columns (16 bytes when the rows are 16-byte aligned, else one
// element); a block of 256 threads holds 256/(D/VEC) bags, so at D=64 f32 a
// warp reads two whole 256-byte rows per step.  The bag's id and mask are
// read once per k as a broadcast load of its group.
//
// Semantics kept exactly:
// * ids follow jnp.take(..., fill_value=0): a negative id wraps once
//   (id + V); an id outside [0, V) after that contributes a zero row.
// * Each product mask*row is rounded to the table's dtype (the JAX kernel
//   multiplies in that dtype), and the products are summed over k in order
//   in f32 with separate multiply and add (no FMA contraction), then cast
//   back: the plain version's order, so f32 results are bit-equal to it.
// * A slot whose mask is 0 reads no row: for a finite row its product is
//   +-0 and adding it to the running sum (which starts at +0) changes
//   nothing.
//
// What bounds it: bytes (the gathered rows, the ids and mask, the output);
// it does one multiply and one add per gathered element.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry point returns cudaGetLastError() of the launch.
//
// Backward (bag_sum_backward): the dense gradient of the table,
//
//   d_table[r, :] = sum over slots (b, k) naming row r of mask[b,k] * g[b, :]
//
// No TPU counterpart: on the TPU it is the gradient XLA derives from
// jnp.take (a scatter-add into a dense [V, D] zero array).  The wrapper
// zero-fills the output (a separate memset) and sorts the slots by row
// (torch.sort, stable: index preparation); this file does the reduction.
// Recommendation ids are Zipf-skewed: one row of a table can take ~18% of a
// batch's slots, so one atomicAdd a slot would serialize on that row and
// give another sum at every launch.  Instead:
// * pass 1 cuts the sorted slots into chunks of `chunk` slots, one group of
//   D/VEC threads a chunk (as the forward's layout).  The group walks its
//   chunk in order and sums each run of one row in f32 onto +0 with
//   separate multiply and add.  A run that starts and ends in the chunk is
//   written to its row; the first run of a chunk that continues one from
//   the chunk before goes to head[chunk], and a run that goes on into the
//   next chunk goes to head[chunk] (if it is the chunk's first run) or
//   tail[chunk];
// * pass 2 gives each run that crosses a chunk boundary to the chunk it
//   starts in, which adds its own part and then the head parts of the
//   chunks the run covers, in chunk order, and writes the row.
// So each touched row is written once, with no atomics, and a launch's
// bits do not depend on scheduling.  A run inside one chunk is summed in
// slot order, the plain version's order, so its bits equal it; a longer run
// is the same sum associated at chunk boundaries.
// What bounds it: bytes (grad_out's rows, each read once a slot that names
// it, the sorted rows and slots, the mask, and each touched row written
// once); one multiply and one add an element a slot.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC elements of T, moved as one aligned access.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bag_sum_kernel(const T* __restrict__ table, const int* __restrict__ ids,
               const T* __restrict__ mask, T* __restrict__ out,
               long long n_rows, int n_bags, int n_slots, int dim) {
  const int group = min((dim + VEC - 1) / VEC, kThreads);  // threads a bag
  const int per_block = kThreads / group;
  const int local = threadIdx.x / group;
  const int lane = threadIdx.x - local * group;
  const long long bag = static_cast<long long>(blockIdx.x) * per_block + local;
  if (local >= per_block || bag >= n_bags) return;
  const int* bag_ids = ids + bag * n_slots;
  const T* bag_mask = mask + bag * n_slots;
  for (int c = lane * VEC; c < dim; c += group * VEC) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int k = 0; k < n_slots; ++k) {
      const float m = to_f32(bag_mask[k]);
      long long id = bag_ids[k];
      if (id < 0) id += n_rows;
      if (m == 0.f || id < 0 || id >= n_rows) continue;
      const Pack<T, VEC> row =
          *reinterpret_cast<const Pack<T, VEC>*>(table + id * dim + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float prod = to_f32(from_f32<T>(__fmul_rn(m, to_f32(row.v[e]))));
        acc[e] = __fadd_rn(acc[e], prod);
      }
    }
    Pack<T, VEC> res;
#pragma unroll
    for (int e = 0; e < VEC; ++e) res.v[e] = from_f32<T>(acc[e]);
    *reinterpret_cast<Pack<T, VEC>*>(out + bag * dim + c) = res;
  }
}

template <typename T, int VEC>
int launch(const void* table, const void* ids, const void* mask, void* out,
           long long n_rows, int n_bags, int n_slots, int dim,
           cudaStream_t stream) {
  const int group = min((dim + VEC - 1) / VEC, kThreads);
  const int per_block = kThreads / group;
  const long long blocks = (static_cast<long long>(n_bags) + per_block - 1) /
                           per_block;
  bag_sum_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(ids),
      static_cast<const T*>(mask), static_cast<T*>(out), n_rows, n_bags,
      n_slots, dim);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* table, const void* ids, const void* mask, void* out,
             long long n_rows, int n_bags, int n_slots, int dim,
             cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = (dim * sizeof(T)) % 16 == 0 &&
                       reinterpret_cast<size_t>(table) % 16 == 0 &&
                       reinterpret_cast<size_t>(out) % 16 == 0;
  if (aligned)
    return launch<T, kVec>(table, ids, mask, out, n_rows, n_bags, n_slots,
                           dim, stream);
  return launch<T, 1>(table, ids, mask, out, n_rows, n_bags, n_slots, dim,
                      stream);
}

template <int VEC>
__device__ __forceinline__ void store_row(float* dst, const float (&acc)[VEC]) {
  Pack<float, VEC> p;
#pragma unroll
  for (int e = 0; e < VEC; ++e) p.v[e] = acc[e];
  *reinterpret_cast<Pack<float, VEC>*>(dst) = p;
}

// Pass 1: one group a chunk of sorted slots; runs inside the chunk to their
// rows, the parts of runs that cross its boundaries to head/tail.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bag_bwd_runs_kernel(const int* __restrict__ rows,
                    const long long* __restrict__ slots,
                    const float* __restrict__ mask,
                    const float* __restrict__ grad, float* __restrict__ out,
                    float* __restrict__ head, float* __restrict__ tail,
                    long long n, long long n_rows, int n_slots, int dim,
                    int chunk) {
  const int group = min((dim + VEC - 1) / VEC, kThreads);
  const int per_block = kThreads / group;
  const int local = threadIdx.x / group;
  const int lane = threadIdx.x - local * group;
  const long long ch = static_cast<long long>(blockIdx.x) * per_block + local;
  const long long s0 = ch * chunk;
  if (local >= per_block || s0 >= n) return;
  const long long s1 = min(s0 + chunk, n);
  const int first = rows[s0];
  if (first >= n_rows) return;          // only slots that gather nothing
  const bool prev_cont = s0 > 0 && rows[s0 - 1] == first;
  for (int c = lane * VEC; c < dim; c += group * VEC) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    int cur = first;
    bool first_run = true;
    for (long long p = s0; p < s1; ++p) {
      const int r = rows[p];
      if (r != cur) {                   // the run of `cur` ends in the chunk
        float* dst = (first_run && prev_cont)
                         ? head + ch * dim
                         : out + static_cast<long long>(cur) * dim;
        store_row<VEC>(dst + c, acc);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
        cur = r;
        first_run = false;
        if (r >= n_rows) break;         // sorted: the rest gathers nothing
      }
      const long long s = slots[p];
      const float m = mask[s];
      const Pack<float, VEC> g = *reinterpret_cast<const Pack<float, VEC>*>(
          grad + (s / n_slots) * dim + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[e] = __fadd_rn(acc[e], __fmul_rn(m, g.v[e]));
    }
    if (cur >= n_rows) continue;
    float* dst;
    if (s1 < n && rows[s1] == cur)      // the run goes on past the chunk
      dst = (first_run ? head : tail) + ch * dim;
    else
      dst = (first_run && prev_cont) ? head + ch * dim
                                     : out + static_cast<long long>(cur) * dim;
    store_row<VEC>(dst + c, acc);
  }
}

// Pass 2: the chunk a crossing run starts in adds the parts of the chunks
// it covers, in chunk order, and writes the row.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bag_bwd_carry_kernel(const int* __restrict__ rows,
                     const float* __restrict__ head,
                     const float* __restrict__ tail, float* __restrict__ out,
                     long long n, long long n_rows, int dim, int chunk) {
  const int group = min((dim + VEC - 1) / VEC, kThreads);
  const int per_block = kThreads / group;
  const int local = threadIdx.x / group;
  const int lane = threadIdx.x - local * group;
  const long long ch = static_cast<long long>(blockIdx.x) * per_block + local;
  const long long s0 = ch * chunk;
  if (local >= per_block || s0 >= n) return;
  const long long s1 = s0 + chunk;
  if (s1 >= n) return;                  // nothing follows the last chunk
  const int last = rows[s1 - 1];
  if (last >= n_rows || rows[s1] != last) return;   // no run crosses out
  const bool single = rows[s0] == last;
  if (single && s0 > 0 && rows[s0 - 1] == last) return;  // not its start
  long long lo = s1, hi = n;            // rows[lo] == last; rows[hi] != last
  while (hi - lo > 1) {
    const long long mid = lo + (hi - lo) / 2;
    if (rows[mid] == last) lo = mid; else hi = mid;
  }
  const long long ch_end = lo / chunk;  // the chunk of the run's last slot
  const float* own = (single ? head : tail) + ch * dim;
  for (int c = lane * VEC; c < dim; c += group * VEC) {
    const Pack<float, VEC> a0 =
        *reinterpret_cast<const Pack<float, VEC>*>(own + c);
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = a0.v[e];
#pragma unroll 4
    for (long long q = ch + 1; q <= ch_end; ++q) {
      const Pack<float, VEC> h =
          *reinterpret_cast<const Pack<float, VEC>*>(head + q * dim + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], h.v[e]);
    }
    store_row<VEC>(out + static_cast<long long>(last) * dim + c, acc);
  }
}

template <int VEC>
int launch_backward(const int* rows, const long long* slots,
                    const float* mask, const float* grad, float* out,
                    float* head, float* tail, long long n, long long n_rows,
                    int n_slots, int dim, int chunk, cudaStream_t stream) {
  const int group = min((dim + VEC - 1) / VEC, kThreads);
  const int per_block = kThreads / group;
  const long long n_chunks = (n + chunk - 1) / chunk;
  const long long blocks = (n_chunks + per_block - 1) / per_block;
  bag_bwd_runs_kernel<VEC><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(rows, slots, mask, grad, out, head,
                                       tail, n, n_rows, n_slots, dim, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bag_bwd_carry_kernel<VEC><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(rows, head, tail, out, n, n_rows, dim,
                                        chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bag_sum_backward(const void* rows, const void* slots,
                                const void* mask, const void* grad, void* out,
                                void* head, void* tail, long long n,
                                long long n_rows, int n_slots, int dim,
                                int chunk, void* stream) {
  if (n < 0 || n_rows < 0 || n_slots <= 0 || dim <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = dim % 4 == 0 &&
                       reinterpret_cast<size_t>(grad) % 16 == 0 &&
                       reinterpret_cast<size_t>(out) % 16 == 0 &&
                       reinterpret_cast<size_t>(head) % 16 == 0 &&
                       reinterpret_cast<size_t>(tail) % 16 == 0;
  const int* r = static_cast<const int*>(rows);
  const long long* s = static_cast<const long long*>(slots);
  const float* m = static_cast<const float*>(mask);
  const float* g = static_cast<const float*>(grad);
  float* o = static_cast<float*>(out);
  float* h = static_cast<float*>(head);
  float* t = static_cast<float*>(tail);
  if (aligned)
    return launch_backward<4>(r, s, m, g, o, h, t, n, n_rows, n_slots, dim,
                              chunk, st);
  return launch_backward<1>(r, s, m, g, o, h, t, n, n_rows, n_slots, dim,
                            chunk, st);
}

extern "C" int bag_sum(const void* table, const void* ids, const void* mask,
                       void* out, long long n_rows, int n_bags, int n_slots,
                       int dim, int is_bf16, void* stream) {
  if (n_bags < 0 || n_slots < 0 || dim <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(table, ids, mask, out, n_rows, n_bags,
                                   n_slots, dim, st);
  return dispatch<float>(table, ids, mask, out, n_rows, n_bags, n_slots, dim,
                         st);
}
