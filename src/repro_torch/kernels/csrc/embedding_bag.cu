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

// ------------------------------------------------------------------ backward
//
// bag_sum_backward: the dense gradient of the table,
//
//   d_table[r, :] = sum over slots (b, k) naming row r of mask[b,k] * g[b, :]
//
// Replaces no TPU kernel: on the TPU it is the gradient XLA derives from
// jnp.take (src/repro/models/dlrm.py, a scatter-add into a dense [V, D]
// zero array).  The wrapper zero-fills the output (a separate memset, the
// dense gradient of the JAX design) and calls two C entry points: the index
// preparation (bag_bwd_sort) and the reduction (bag_bwd_reduce).  Ids are
// read as the forward reads them: a negative id wraps once, a row outside
// [0, n_rows) after that gets the key n_rows and adds nothing.
//
// What bounds it: bytes, 4*n*d + 8*n + 4*d*touched (grad_out's row read once
// a slot, the ids and mask, each touched row written once).  At dlrm-rm2's
// train_batch (n = 1,703,936 slots of Zipf(1.2) ids, d = 64, 26e6 rows)
// that is 0.154 ms at 3.35 TB/s, 0.130 ms of it grad_out's 436 MB.  The
// first hand-written form took 0.59 ms on the H100: a library sort
// (torch.sort over 32 bits with int64 keys and slots, 0.31 ms) and a walk
// that kept one grad_out load a thread in flight (~0.28 ms).  This form
// sorts by hand over the key's own width and keeps eight rows in flight a
// thread.
//
// Index preparation: a stable LSD radix sort of the slots by row, over
// n_rows.bit_length() key bits only (the key n_rows, the sentinel, must
// fit: 25 bits at 26e6 rows), in the fewest passes of at most 8 bits (256
// buckets, one a thread), whose widths the wrapper's planner
// (ops.plan_backward) gives: 7, 6, 6, 6 at the train shape.  (A 9-bit
// digit, two buckets a thread, makes 3 passes, but on the H100 its one
// pass took longer than two 8-bit passes.)
// * bag_bwd_hist_kernel reads the ids once, computes each key with the
//   wrap rule and counts every pass's digits (shared-memory counts, then
//   integer atomics into [passes][256] global counts);
// * bag_bwd_sort_pass_kernel, once a pass, is a one-sweep pass: a block
//   takes the next tile of 4352 keys (an atomic tile counter, so tiles run
//   in order of issue), ranks them stably by the pass's digit (each warp 544
//   consecutive keys, 32 at a time; one ballot a digit bit groups the lanes
//   of one digit, per-warp u16 counts in shared memory carry the order),
//   publishes its counts a bucket and looks back over the earlier tiles'
//   published counts (decoupled look-back, 8 tiles' words read at once) for
//   its global offsets, places the tile in shared memory in sorted order
//   and writes it out, runs of one bucket to consecutive addresses.  The
//   first pass computes the keys from the ids (the value is the slot index
//   b*K+k: no key or iota tensor exists); the last writes the wrapper's
//   rows and slots (int32).  Every placement follows slot order, so the
//   result is bit for bit the stable torch.sort of backward_plan.  A block
//   spins only on tiles issued before its own, whose blocks already run.
//   A pass's time is set by its slowest tile, and ranking is bound by
//   instruction issue, so the tile (17 keys a thread, 80 registers, three
//   blocks an SM) is sized for the train shape's 392 tiles to run at once
//   on 132 SMs: 416 tiles of 4096 left 20 SMs with four, or a second wave.
// Each pass moves 16 B a slot (27 MB at the train shape), which the 50 MB L2
// holds.
//
// Reduction:
// * bag_bwd_runs_kernel cuts the sorted slots into chunks of `chunk` slots
//   (the planner's), one group of D/VEC threads (rounded up to a power of
//   two, at most a warp) a chunk.  The group first brings the chunk's rows,
//   grad_out rows (slot / K) and masks into shared memory: rows and slots
//   with coalesced loads, the mask of each slot with one gather a lane.  It
//   then walks the chunk in order, kRunAhead slots at a time: it issues the
//   kRunAhead grad_out rows' loads (16 bytes a lane, ld.global.cs:
//   evict-first, since the 436 MB are read once and exceed the L2) before
//   it sums any of them, so each thread keeps 8 independent loads in
//   flight and each block up to 16 KB.  Each run of one row is summed in
//   f32 onto +0, one __fmul_rn and one __fadd_rn a slot in slot order.  A
//   run that starts and ends in the chunk is written to its row; the first
//   run of a chunk that continues one from the chunk before goes to
//   head[chunk], and a run that goes on into the next chunk goes to
//   head[chunk] (if it is the chunk's first run) or tail[chunk].  The loads
//   go straight into registers: a 1-D bulk copy (cp.async.bulk) a 256-byte
//   row into a shared ring would move each row through shared memory a
//   second time and add a producer/consumer handshake a row, for a copy
//   that is short already; registers keep the walk's order trivially and
//   the VEC = 1 path shares the code.  On the H100 the pass moves ~530 MB
//   (grad_out, the sorted slots, the mask, the touched rows) at ~2.7 TB/s.
// * bag_bwd_carry_kernel, a second launch (no float atomics, no block that
//   waits on another): each run that crosses a chunk boundary goes to the
//   chunk it starts in, which adds its own part and then the head parts of
//   the chunks the run covers, in chunk order, kRunAhead chunks' parts and
//   boundary rows loaded at a time, and writes the row.  With chunks of 128
//   slots, Zipf's hottest row (~11,800 slots) spans ~92.
// So each touched row is written once, with no float atomics, and a
// launch's bits do not depend on scheduling.  A run inside one chunk is
// summed in slot order, the plain version's order, so its bits equal it;
// a longer run is the same sum associated at chunk boundaries, in chunk
// order.
//
// One call makes passes + 4 launches: the memset of the sort's look-back
// words, counts and tile counters, the histogram, a sort pass a digit (4 at
// the train shape), the runs pass and the carry pass (8 at the train
// shape).  The passes, the runs pass and the carry pass are launched as
// programmatic dependents (launch_dependent): each may be scheduled while
// the kernel ahead of it ends and waits for its writes at its top, which
// hides most of the gaps between the launches.  bag_sum_backward.launches
// counts calls.

constexpr int kSortThreads = 256;                  // one bucket a thread
constexpr int kDigitBits = 8;                      // the widest digit
constexpr int kRadix = 1 << kDigitBits;            // its 256 buckets
constexpr int kSortItems = 17;                     // keys a thread ranks
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortBlocks = 3;                     // an SM, at 80 registers
constexpr int kWarpKeys = 32 * kSortItems;         // a warp's run of keys
constexpr int kTile = kSortThreads * kSortItems;   // 4352 keys a block
constexpr int kMaxPasses = 4;                      // 31 key bits, 8 a pass
constexpr int kLookback = 8;                       // status words read at once
constexpr unsigned long long kAggregate = 1ull << 62;   // the tile's count
constexpr unsigned long long kInclusive = 1ull << 63;   // ... and all before
constexpr unsigned long long kCountMask = 0xffffffffull;

constexpr int kRunGroups = 8;                      // chunks a block
constexpr int kRunAhead = 8;                       // rows a lane has in flight
constexpr int kMaxChunk = 512;                     // 48 KB of shared staging

// The key of slot value `id`: take_fill's rule, n_rows for a row that
// gathers nothing.
__device__ __forceinline__ int row_key(int id, long long n_rows) {
  long long r = id;
  if (r < 0) r += n_rows;
  return (r < 0 || r >= n_rows) ? static_cast<int>(n_rows)
                                : static_cast<int>(r);
}

// The shift of pass p's digit from the packed widths (a byte a pass).
__device__ __forceinline__ int digit_shift(int widths, int p) {
  int shift = 0;
  for (int q = 0; q < p; ++q) shift += (widths >> (8 * q)) & 0xff;
  return shift;
}

// Programmatic dependent launch: a kernel launched by launch_dependent()
// may start before the kernel ahead of it on the stream ends; it waits for
// that kernel's writes at its top (wait_for_previous), and the kernel ahead
// lets it launch once all of its own blocks run (allow_next).
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void allow_next() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), unsigned grid,
                             unsigned block, size_t smem, cudaStream_t st,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(block, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(word) = v;
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* word) {
  return *reinterpret_cast<const volatile unsigned long long*>(word);
}

// The lanes of the warp whose digit equals this lane's (`width` bits; a
// lane past the end of the keys matches only such lanes): one vote a bit,
// as CUB's MatchAny.  __match_any_sync, whose time grows with the distinct
// values of a warp, took ~10 us a pass on Zipf's low digits.
__device__ __forceinline__ unsigned match_digit(unsigned d, int width,
                                                bool valid) {
  unsigned peers = __ballot_sync(0xffffffffu, valid);
  if (!valid) peers = ~peers;
#pragma unroll
  for (int b = 0; b < kDigitBits; ++b) {
    if (b < width) {
      const bool bit = (d >> b) & 1u;
      const unsigned vote = __ballot_sync(0xffffffffu, bit);
      peers &= bit ? vote : ~vote;
    }
  }
  return peers;
}

// Exclusive prefix sum of one value a thread over the block (kSortThreads).
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v,
                                                         unsigned* s_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_tot[warp] = x;
  __syncthreads();
  unsigned off = 0;
  for (int w = 0; w < warp; ++w) off += s_tot[w];
  __syncthreads();
  return off + x - v;
}

// Every pass's digit counts over all keys, computed from the ids: a
// block a tile, each thread's kSortItems ids loaded before any is counted
// (independent loads, not one round trip each).
__global__ void __launch_bounds__(kSortThreads)
bag_bwd_hist_kernel(const int* __restrict__ ids, unsigned* __restrict__ hist,
                    long long n, long long n_rows, int passes, int widths) {
  __shared__ unsigned s_hist[kMaxPasses * kRadix];
  allow_next();
  for (int i = threadIdx.x; i < kMaxPasses * kRadix; i += kSortThreads)
    s_hist[i] = 0u;
  int shift[kMaxPasses];
  unsigned mask[kMaxPasses];
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    shift[p] = digit_shift(widths, p);
    mask[p] = (1u << ((widths >> (8 * p)) & 0xff)) - 1u;
  }
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  int key[kSortItems];
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const long long j = tile0 + i * kSortThreads + threadIdx.x;
    key[i] = j < n ? row_key(ids[j], n_rows) : -1;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    if (key[i] < 0) continue;
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p)
      if (p < passes)
        atomicAdd(&s_hist[p * kRadix +
                          ((static_cast<unsigned>(key[i]) >> shift[p]) &
                           mask[p])], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * kRadix; i += kSortThreads)
    if (s_hist[i]) atomicAdd(&hist[i], s_hist[i]);
}

// The keys before this tile a bucket (thread b's), from the earlier tiles'
// status words: add aggregates back to the first inclusive word.
__device__ __forceinline__ unsigned long long look_back(
    const unsigned long long* status, int tile, int b) {
  unsigned long long excl = 0;
  int k = tile - 1;
  while (true) {
    unsigned long long s[kLookback];
#pragma unroll
    for (int w = 0; w < kLookback; ++w)
      s[w] = k - w >= 0
                 ? peek(status + static_cast<long long>(k - w) * kRadix + b)
                 : kInclusive;          // before tile 0: nothing
    int used = kLookback;
#pragma unroll
    for (int w = 0; w < kLookback; ++w) {
      if (!(s[w] & (kAggregate | kInclusive))) {   // not published yet
        used = w;
        break;
      }
      excl += s[w] & kCountMask;
      if (s[w] & kInclusive) return excl;
    }
    k -= used;
  }
}

// One stable pass over the digit (key >> shift) & (2^width - 1).
template <bool kFirst>
__global__ void __launch_bounds__(kSortThreads, kSortBlocks)
bag_bwd_sort_pass_kernel(const int* __restrict__ ids,
                         const int* __restrict__ keys_in,
                         const int* __restrict__ vals_in,
                         int* __restrict__ keys_out,
                         int* __restrict__ vals_out,
                         unsigned long long* status,
                         const unsigned* __restrict__ hist,
                         unsigned* tile_counter, int n, int n_rows,
                         int shift, int width) {
  __shared__ int s_keys[kTile];
  __shared__ int s_vals[kTile];
  // a warp's keys of each digit: counts, then offsets (at most 544)
  __shared__ unsigned short s_warp[kSortWarps][kRadix];
  __shared__ int s_start[kRadix];   // a bucket's first place in the tile
  __shared__ int s_base[kRadix];    // its first place out, less s_start
  __shared__ unsigned s_tot[kSortWarps];
  __shared__ int s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  wait_for_previous();
  allow_next();
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(tile_counter, 1u));
  for (int i = tid; i < kSortWarps * kRadix; i += kSortThreads)
    s_warp[i / kRadix][i % kRadix] = 0;
  __syncthreads();
  const int tile = s_tile;
  // slot indices in 32 bits: n < 2^31, so j < 2^31 + kTile fits unsigned
  const unsigned tile0 = static_cast<unsigned>(tile) * kTile;
  const unsigned first_slot = tile0 + warp * kWarpKeys + lane;
  const unsigned digit_mask = (1u << width) - 1u;

  // Warp w ranks keys [tile0 + w*544, +544), lane l item i at 32*i + l, so
  // item order then lane order is slot order.  The values wait in memory
  // (an L2 hit) until the keys are placed, and two ranks (< 544) share a
  // register: a thread fits 80 registers, three blocks an SM, and the
  // train shape's 392 tiles are resident at once (a second wave of tiles
  // doubled a pass).
  int key[kSortItems];
  unsigned rank2[(kSortItems + 1) / 2];
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const unsigned j = first_slot + i * 32;
    key[i] = -1;                        // past the end
    if (j < static_cast<unsigned>(n))
      key[i] = kFirst ? row_key(ids[j], n_rows) : keys_in[j];
  }
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const bool valid = key[i] >= 0;
    const unsigned d = valid
        ? (static_cast<unsigned>(key[i]) >> shift) & digit_mask
        : 0u;
    const unsigned peers = match_digit(d, width, valid);
    const unsigned before = valid ? s_warp[warp][d] : 0u;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1)
      s_warp[warp][d] = static_cast<unsigned short>(before + __popc(peers));
    __syncwarp();
    const unsigned r = before + __popc(peers & lower);
    rank2[i / 2] = i % 2 ? rank2[i / 2] | r << 16 : r;
  }
  __syncthreads();

  // Thread b owns bucket b: the warps' offsets in it, its count, its
  // place among the tiles (published early, then looked back for).
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const unsigned c = s_warp[w][tid];
    s_warp[w][tid] = static_cast<unsigned short>(count);
    count += c;
  }
  unsigned long long* mine =
      status + static_cast<long long>(tile) * kRadix + tid;
  unsigned long long excl = 0;
  if (tile == 0) {
    publish(mine, kInclusive | count);
  } else {
    publish(mine, kAggregate | count);
    excl = look_back(status, tile, tid);
    publish(mine, kInclusive | (excl + count));
  }
  const unsigned start = block_exclusive_scan(count, s_tot);
  const unsigned before_digit = block_exclusive_scan(hist[tid], s_tot);
  s_start[tid] = static_cast<int>(start);
  s_base[tid] = static_cast<int>(before_digit + excl - start);
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    if (key[i] < 0) continue;
    const unsigned j = first_slot + i * 32;
    const unsigned d = (static_cast<unsigned>(key[i]) >> shift) & digit_mask;
    const int pos = s_start[d] + static_cast<int>(s_warp[warp][d]) +
                    static_cast<int>((rank2[i / 2] >> (16 * (i % 2))) &
                                     0xffffu);
    s_keys[pos] = key[i];
    s_vals[pos] = kFirst ? static_cast<int>(j) : vals_in[j];
  }
  __syncthreads();
  const int left = n - static_cast<int>(tile0);
  const int tile_n = left < kTile ? left : kTile;
  for (int j = tid; j < tile_n; j += kSortThreads) {
    const int k = s_keys[j];
    const unsigned d = (static_cast<unsigned>(k) >> shift) & digit_mask;
    const unsigned out = static_cast<unsigned>(s_base[d] + j);
    keys_out[out] = k;
    vals_out[out] = s_vals[j];
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(float* dst, const float (&acc)[VEC]) {
  Pack<float, VEC> p;
#pragma unroll
  for (int e = 0; e < VEC; ++e) p.v[e] = acc[e];
  *reinterpret_cast<Pack<float, VEC>*>(dst) = p;
}

// VEC floats of a row that is read once: evict-first in L1 and L2.
template <int VEC>
__device__ __forceinline__ void load_once(const float* src, float (&v)[VEC]);
template <>
__device__ __forceinline__ void load_once<4>(const float* src, float (&v)[4]) {
  const float4 x = __ldcs(reinterpret_cast<const float4*>(src));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
template <>
__device__ __forceinline__ void load_once<1>(const float* src, float (&v)[1]) {
  v[0] = __ldcs(src);
}

// Pass 1: one group a chunk of sorted slots; runs inside the chunk to their
// rows, the parts of runs that cross its boundaries to head/tail.
template <int VEC>
__global__ void __launch_bounds__(kRunGroups * 32)
bag_bwd_runs_kernel(const int* __restrict__ rows,
                    const int* __restrict__ slots,
                    const float* __restrict__ mask,
                    const float* __restrict__ grad, float* __restrict__ out,
                    float* __restrict__ head, float* __restrict__ tail,
                    long long n, long long n_rows, int n_slots, int dim,
                    int chunk, int group) {
  extern __shared__ int s_chunk[];      // [kRunGroups][rows, bags, mask]
  wait_for_previous();
  allow_next();
  const int local = threadIdx.x / group;
  const int lane = threadIdx.x - local * group;
  const int warp_lane = threadIdx.x & 31;
  const unsigned gmask =
      group == 32 ? 0xffffffffu
                  : ((1u << group) - 1u) << (warp_lane & ~(group - 1));
  const long long ch = static_cast<long long>(blockIdx.x) * kRunGroups + local;
  const long long s0 = ch * chunk;
  if (s0 >= n) return;                  // the whole group: one chunk
  const int len = static_cast<int>(n - s0 < chunk ? n - s0 : chunk);
  int* s_row = s_chunk + local * 3 * chunk;
  int* s_bag = s_row + chunk;           // grad_out's row of each slot
  float* s_mask = reinterpret_cast<float*>(s_bag + chunk);
  for (int i = lane; i < len; i += group) {
    const int r = rows[s0 + i];
    const int s = slots[s0 + i];
    s_row[i] = r;
    s_bag[i] = s / n_slots;
    s_mask[i] = r < n_rows ? mask[s] : 0.f;
  }
  __syncwarp(gmask);
  const int first = s_row[0];
  if (first >= n_rows) return;          // only slots that gather nothing
  const bool prev_cont = s0 > 0 && rows[s0 - 1] == first;
  const int after = s0 + len < n ? rows[s0 + len] : -1;   // the next row
  for (int c = lane * VEC; c < dim; c += group * VEC) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    int cur = first;
    bool first_run = true, done = false;
    for (int q = 0; q < len && !done; q += kRunAhead) {
      float v[kRunAhead][VEC];
#pragma unroll
      for (int u = 0; u < kRunAhead; ++u) {
        const int p = q + u;
        if (p < len && s_row[p] < n_rows) {
          load_once<VEC>(grad + static_cast<long long>(s_bag[p]) * dim + c,
                         v[u]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kRunAhead; ++u) {
        const int p = q + u;
        if (p >= len) break;
        const int r = s_row[p];
        if (r != cur) {                 // the run of `cur` ends in the chunk
          float* dst = (first_run && prev_cont)
                           ? head + ch * dim
                           : out + static_cast<long long>(cur) * dim;
          store_row<VEC>(dst + c, acc);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
          cur = r;
          first_run = false;
          if (r >= n_rows) {            // sorted: the rest gathers nothing
            done = true;
            break;
          }
        }
        const float m = s_mask[p];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(m, v[u][e]));
      }
    }
    if (cur >= n_rows) continue;
    float* dst;
    if (after == cur)                   // the run goes on past the chunk
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
  wait_for_previous();
  const int group = min((dim + VEC - 1) / VEC, kThreads);
  const int per_block = kThreads / group;
  const int local = threadIdx.x / group;
  const int lane = threadIdx.x - local * group;
  const long long ch = static_cast<long long>(blockIdx.x) * per_block + local;
  const long long s0 = ch * chunk;
  if (local >= per_block || s0 >= n) return;
  const long long s1 = s0 + chunk;
  if (s1 >= n) return;                  // nothing follows the last chunk
  const int last = rows[s1 - 1], next = rows[s1], first = rows[s0];
  const int before = s0 > 0 ? rows[s0 - 1] : -1;
  if (last >= n_rows || next != last) return;   // no run crosses out
  const bool single = first == last;
  if (single && before == last) return;         // not the run's start
  const float* own = (single ? head : tail) + ch * dim;
  const long long n_chunks = (n + chunk - 1) / chunk;
  for (int c = lane * VEC; c < dim; c += group * VEC) {
    const Pack<float, VEC> a0 =
        *reinterpret_cast<const Pack<float, VEC>*>(own + c);
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = a0.v[e];
    // Walk the chunks the run covers: kRunAhead chunks' head parts and the
    // rows after their ends are loaded at a time (a hot run covers ~92),
    // then the parts are added in chunk order up to the chunk it ends in.
    bool more = true;
    for (long long q0 = ch + 1; more; q0 += kRunAhead) {
      Pack<float, VEC> h[kRunAhead];
      int next[kRunAhead];
#pragma unroll
      for (int u = 0; u < kRunAhead; ++u) {
        const long long q = q0 + u;
        next[u] = -1;
        if (q < n_chunks) {
          h[u] = *reinterpret_cast<const Pack<float, VEC>*>(
              head + q * dim + c);
          if ((q + 1) * chunk < n) next[u] = rows[(q + 1) * chunk];
        }
      }
#pragma unroll
      for (int u = 0; u < kRunAhead; ++u) {
        if (more) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[e] = __fadd_rn(acc[e], h[u].v[e]);
          more = next[u] == last;       // the run goes on past chunk q
        }
      }
    }
    store_row<VEC>(out + static_cast<long long>(last) * dim + c, acc);
  }
}

// which: 1 the runs pass, 2 the carry pass, 3 both (a call).
template <int VEC>
int launch_reduce(const int* rows, const int* slots, const float* mask,
                  const float* grad, float* out, float* head, float* tail,
                  long long n, long long n_rows, int n_slots, int dim,
                  int chunk, int which, cudaStream_t stream) {
  const long long n_chunks = (n + chunk - 1) / chunk;
  if (which & 1) {
    const int lanes = (dim + VEC - 1) / VEC;
    int group = 1;                      // lanes a chunk: a power of two
    while (group < lanes && group < 32) group <<= 1;
    const long long blocks = (n_chunks + kRunGroups - 1) / kRunGroups;
    const size_t smem = sizeof(int) * 3 * kRunGroups * chunk;
    const cudaError_t err = launch_dependent(
        bag_bwd_runs_kernel<VEC>, static_cast<unsigned>(blocks),
        kRunGroups * group, smem, stream, rows, slots, mask, grad, out, head,
        tail, n, n_rows, n_slots, dim, chunk, group);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (which & 2) {
    const int group = min((dim + VEC - 1) / VEC, kThreads);
    const int per_block = kThreads / group;
    const long long blocks = (n_chunks + per_block - 1) / per_block;
    const cudaError_t err = launch_dependent(
        bag_bwd_carry_kernel<VEC>, static_cast<unsigned>(blocks), kThreads,
        0, stream, rows, head, tail, out, n, n_rows, dim, chunk);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The index preparation: rows (int32, ascending) and slots (int32, the
// flat slot b*K + k of each) of the n slots of `ids`, stably sorted by row
// key.  `keys`/`vals` are n-int scratch; `zero` holds zero_bytes of scratch
// that this call zeroes: the look-back words [passes][tiles][256] (u64),
// the digit counts [passes][256] and the tile counters [passes] (u32).
// `widths` packs each pass's digit width (1-8), a byte a pass, low digit
// first.
extern "C" int bag_bwd_sort(const void* ids, void* rows, void* slots,
                            void* keys, void* vals, void* zero,
                            long long zero_bytes, long long n,
                            long long n_rows, int tiles, int widths,
                            void* stream) {
  int passes = 0, bits = 0;
  for (int p = 0; p < kMaxPasses; ++p) {   // widths: 1-8, then zeros
    const int w = (widths >> (8 * p)) & 0xff;
    if (w > kDigitBits || (w && passes < p))
      return static_cast<int>(cudaErrorInvalidValue);
    if (w) {
      bits += w;
      ++passes;
    }
  }
  if (n <= 0 || n >= (1ll << 31) || n_rows < 0 || passes == 0 ||
      (n_rows >> bits) != 0 ||
      static_cast<long long>(tiles) != (n + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long status_words =
      static_cast<long long>(passes) * tiles * kRadix;
  const long long need = 8 * status_words + 4ll * passes * (kRadix + 1);
  if (zero_bytes < need) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* status = static_cast<unsigned long long*>(zero);
  unsigned* hist = reinterpret_cast<unsigned*>(status + status_words);
  unsigned* counters = hist + passes * kRadix;
  cudaError_t err = cudaMemsetAsync(zero, 0, static_cast<size_t>(need), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* id = static_cast<const int*>(ids);
  bag_bwd_hist_kernel<<<tiles, kSortThreads, 0, st>>>(id, hist, n, n_rows,
                                                      passes, widths);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int* out_k[2] = {static_cast<int*>(rows), static_cast<int*>(keys)};
  int* out_v[2] = {static_cast<int*>(slots), static_cast<int*>(vals)};
  int shift = 0;
  for (int p = 0; p < passes; ++p) {
    const int to = (passes - 1 - p) & 1;   // the last pass writes rows/slots
    const int from = 1 - to;
    const int width = (widths >> (8 * p)) & 0xff;
    unsigned long long* status_p =
        status + static_cast<long long>(p) * tiles * kRadix;
    const int* in_k = p == 0 ? nullptr : out_k[from];
    const int* in_v = p == 0 ? nullptr : out_v[from];
    err = launch_dependent(
        p == 0 ? bag_bwd_sort_pass_kernel<true>
               : bag_bwd_sort_pass_kernel<false>,
        tiles, kSortThreads, 0, st, id, in_k, in_v, out_k[to], out_v[to],
        status_p, static_cast<const unsigned*>(hist + p * kRadix),
        counters + p, static_cast<int>(n), static_cast<int>(n_rows), shift,
        width);
    if (err != cudaSuccess) return static_cast<int>(err);
    shift += width;
  }
  return 0;
}

// The reduction over sorted (rows, slots): `which` 1 runs the runs pass, 2
// the carry pass, 3 both.  head and tail are [ceil(n / chunk), dim] f32.
extern "C" int bag_bwd_reduce(const void* rows, const void* slots,
                              const void* mask, const void* grad, void* out,
                              void* head, void* tail, long long n,
                              long long n_rows, int n_slots, int dim,
                              int chunk, int which, void* stream) {
  if (n < 0 || n >= (1ll << 31) || n_rows < 0 || n_slots <= 0 || dim <= 0 ||
      chunk <= 0 || chunk > kMaxChunk || which < 1 || which > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = dim % 4 == 0 &&
                       reinterpret_cast<size_t>(grad) % 16 == 0 &&
                       reinterpret_cast<size_t>(out) % 16 == 0 &&
                       reinterpret_cast<size_t>(head) % 16 == 0 &&
                       reinterpret_cast<size_t>(tail) % 16 == 0;
  const int* r = static_cast<const int*>(rows);
  const int* s = static_cast<const int*>(slots);
  const float* m = static_cast<const float*>(mask);
  const float* g = static_cast<const float*>(grad);
  float* o = static_cast<float*>(out);
  float* h = static_cast<float*>(head);
  float* t = static_cast<float*>(tail);
  if (aligned)
    return launch_reduce<4>(r, s, m, g, o, h, t, n, n_rows, n_slots, dim,
                            chunk, which, st);
  return launch_reduce<1>(r, s, m, g, o, h, t, n, n_rows, n_slots, dim,
                          chunk, which, st);
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
