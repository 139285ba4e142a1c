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

}  // namespace

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
