// moe_combine for Hopper (sm_90a): the combine of a mixture-of-experts
// layer on one device, as a plain C interface loaded with ctypes.
//
// Replaces no TPU kernel: the JAX package's combine (src/repro/models/
// moe.py) is plain jnp that XLA fuses. The port's plain version (ref.py:
// combine) is about eight launches: it gathers the rows of all B*S*k
// entries, zeroes the dropped ones by a select, multiplies each by its
// router weight in a broadcast and sums a token's k rows, so every entry's
// row crosses device memory four times over, kept or not. This kernel
// reads each kept row once and writes the output once.
//
// Function: for token t (of B*S) and its entries e = t*k + j, j < k,
//   out[t] = sum over j = 0 .. k-1 with slots[e] < C, in that order, of
//            T(eout_flat[ids[e]*C + slots[e]] * w[e])
// with eout [E, B*C, d] seen flat as [E*B*C, d] (ids e_x*B + b), the
// products rounded to T as the plain `rows * w` rounds them, the sum
// taken in f32 and rounded to T once. A dropped entry (slot at or past C:
// capacity drops, and entries of experts not held here, which the
// dispatch gives slot C) is skipped and its row never read, so nothing
// non-finite in it reaches the output; a token with every entry dropped
// gets zeros. T is float or bf16 (out, eout and w alike); ids and slots
// are int32 with ids[e]*C + slots[e] a row of eout for every kept entry.
// No atomics: each output element is one thread's sum in a fixed order,
// the same bits every run (fault F3). PyTorch's sum over k may group the
// terms otherwise, so the plain version can differ in the last place.
//
// Bound: bytes. The least time is (kept rows * d + B*S*d) * sizeof(T)
// plus the entries' ids, slots and weights over 3.35 TB/s (granite-4.0-
// h-small's prefill, 36 of 72 experts held, top 10, d 4096: about 163,000
// kept rows of 8 KB and 268 MB of output a call, 0.48 ms).
//
// Design: one block a token. Warp 0 reads the token's k (id, slot,
// weight) triples, and a ballot packs the kept ones, in order, into shared
// memory (the row's element offset and the weight as f32). Each thread
// then owns 16-byte column vectors of the row (8 bf16 or 4 f32; d a
// multiple of that), every MC_MAX_THREADS-th (2 a thread at d 2048, 4 at
// d 4096 in bf16): for each group of MC_GROUP
// kept rows it issues all the group's loads first (streaming, evict-first:
// a row is read once), then the multiply-adds in order. Occupancy is what
// keeps loads in flight: blocks of 128 threads at 62 registers, 8 of them
// (32 warps) on an SM, each a token, so one token's triples load while
// others' rows stream. Tried on the H100 (bf16, the two cells' shapes):
// loads of 8 rows a group took 98-105 registers, one 512-thread block an
// SM, and reached 57-62 % of the bound; 4 rows a group at 128 threads 85-88
// % (2, 3 or 4 rows, 128 or 256 threads: 82-88 %).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

#define MC_MAX_K 32        // a token's entries, one lane of warp 0 each
#define MC_MAX_THREADS 128 // a block's threads (fewer where d is small)
#define MC_MIN_BLOCKS 8    // blocks an SM holds at MC_MAX_THREADS
#define MC_GROUP 4         // kept rows a thread loads before it adds

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x * w rounded to T, as PyTorch's elementwise multiply rounds it (the f32
// product, then to T); kept apart from the add so that no FMA fuses them
template <typename T>
__device__ __forceinline__ float product(float x, float w) {
  return to_f32(from_f32<T>(__fmul_rn(x, w)));
}

// 16 bytes of a row: the unit of every load and store
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T>
__device__ __forceinline__ Vec<T> load_row(const T* p) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
  Vec<T> r;
  memcpy(&r, &u, 16);
  return r;
}

}  // namespace

// at global scope, so that a profiler names it "moe_combine_rows<...>"
template <typename T>
__global__ void __launch_bounds__(MC_MAX_THREADS, MC_MIN_BLOCKS)
moe_combine_rows(const T* __restrict__ eout, const int* __restrict__ ids,
                 const int* __restrict__ slots, const T* __restrict__ w,
                 T* __restrict__ out, int k, int d, int C) {
  constexpr int N = Vec<T>::N;
  __shared__ int64_t s_row[MC_MAX_K];   // element offset of each kept row
  __shared__ float s_w[MC_MAX_K];
  __shared__ int s_n;
  const int64_t t = blockIdx.x;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    bool kept = false;
    int64_t row = 0;
    float wt = 0.f;
    if (lane < k) {
      const int64_t e = t * k + lane;
      const int slot = __ldg(slots + e);
      kept = (unsigned)slot < (unsigned)C;
      if (kept) {
        row = ((int64_t)__ldg(ids + e) * C + slot) * d;
        wt = to_f32(w[e]);
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, kept);
    if (kept) {
      const int pos = __popc(mask & ((1u << lane) - 1u));
      s_row[pos] = row;
      s_w[pos] = wt;
    }
    if (lane == 0) s_n = __popc(mask);
  }
  __syncthreads();
  const int n = s_n;
  T* dst = out + t * d;
  for (int c = threadIdx.x; c < d / N; c += blockDim.x) {
    const int64_t col = (int64_t)c * N;
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    for (int j0 = 0; j0 < n; j0 += MC_GROUP) {
      Vec<T> x[MC_GROUP];
#pragma unroll
      for (int g = 0; g < MC_GROUP; ++g)
        if (j0 + g < n) x[g] = load_row(eout + s_row[j0 + g] + col);
#pragma unroll
      for (int g = 0; g < MC_GROUP; ++g) {
        if (j0 + g < n) {
          const float wt = s_w[j0 + g];
#pragma unroll
          for (int i = 0; i < N; ++i)
            acc[i] = __fadd_rn(acc[i], product<T>(to_f32(x[g].v[i]), wt));
        }
      }
    }
    Vec<T> o;
#pragma unroll
    for (int i = 0; i < N; ++i) o.v[i] = from_f32<T>(acc[i]);
    uint4 u;
    memcpy(&u, &o, 16);
    *reinterpret_cast<uint4*>(dst + col) = u;
  }
}

namespace {

template <typename T>
int launch(const void* eout, const void* ids, const void* slots,
           const void* w, void* out, int64_t tokens, int k, int d, int C,
           cudaStream_t stream) {
  if (d % Vec<T>::N != 0) return (int)cudaErrorInvalidValue;
  int threads = (d / Vec<T>::N + 31) / 32 * 32;
  if (threads > MC_MAX_THREADS) threads = MC_MAX_THREADS;
  moe_combine_rows<T><<<(unsigned)tokens, threads, 0, stream>>>(
      static_cast<const T*>(eout), static_cast<const int*>(ids),
      static_cast<const int*>(slots), static_cast<const T*>(w),
      static_cast<T*>(out), k, d, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int moe_combine_max_k() { return MC_MAX_K; }

const char* moe_combine_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype 0: eout, w and out are f32; 1: bf16. eout [rows, d] (rows = E*B*C),
// ids and slots [tokens*k] int32, w [tokens, k], out [tokens, d]; all
// contiguous on one device, eout and out 16-byte aligned, d a multiple of
// 16 bytes' worth. Runs one kernel on the stream; returns a cudaError_t
// (0 = launched).
int moe_combine(int dtype, const void* eout, const void* ids,
                const void* slots, const void* w, void* out, int64_t tokens,
                int k, int d, int C, void* stream) {
  if (tokens < 0 || tokens > 0x7fffffff || k < 1 || k > MC_MAX_K ||
      d < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  if (tokens == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(eout, ids, slots, w, out, tokens, k, d, C, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(eout, ids, slots, w, out, tokens, k, d, C,
                                 s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
