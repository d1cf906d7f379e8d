// partition_pack for Hopper (sm_90a): the stable partition-major pack of
// the §3.2 partitioned object, as a plain C interface loaded with ctypes.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/partition_pack/
// partition_pack.py: pack_pallas (count_slots_kernel + gather_pack_kernel).
// Same outputs: buf [n_parts, capacity, d] (zero-filled past a partition's
// count, rows past capacity dropped), counts [n_parts] (the offsets
// header) and slots [T] (a row's position inside its partition, in arrival
// order).
//
// The TPU kernel carries running per-partition counts across a sequential
// grid. CUDA blocks run in no order, so the carry becomes three passes:
//   1. pp_tile_hist   one block per tile of PP_TILE rows: a shared-memory
//                     histogram -> tile_counts[n_parts, n_tiles];
//   2. pp_tile_scan   one block per partition: exclusive scan of its row of
//                     tile_counts over tiles (in place -> tile_base) and the
//                     partition's total -> counts;
//   3. pp_slots       one warp per tile walks its rows 32 at a time in
//                     order; __match_any_sync groups the lanes of a
//                     partition, the rank among lower lanes plus the running
//                     count in shared memory gives the stable slot, and
//                     row_of[p, slot] = row where slot < capacity;
// then
//   4. pp_gather      a bit copy over the flattened (partition, slot,
//                     column) space: buf[p, c, :] = rows[row_of[p, c], :] or
//                     zeros where row_of is -1, templated on the element
//                     width (2, 4 or 8 bytes), so bf16, f32 and the int32 /
//                     int64 column views of a table all go through it.
//
// Bound: memory. It does no arithmetic worth counting; the least time is
// (bytes read + bytes written) / 3.35 TB/s: ids and rows read once; slots,
// counts and buf written once. The design reads the ids twice (passes 1
// and 3) and the small tile_counts / row_of maps a few times, and writes
// buf with consecutive threads on consecutive addresses; rows are read in
// arrival order within a partition, so the gather's reads stay mostly
// sequential. Decoupled look-back (one pass over the ids) and fusing the
// hash into pass 1 are left for later work.
//
// Limit: the running counts of one tile live in shared memory, so n_parts
// is at most PP_MAX_PARTS (8192 x 4 bytes = 32 KiB, inside the 48 KiB a
// block gets without opting in). Row indices are int32, so T < 2^31.
// Ids outside [0, n_parts) are counted nowhere, get slot -1 and are not
// packed.
#include <cuda_runtime.h>
#include <stdint.h>

#define PP_TILE 1024
#define PP_MAX_PARTS 8192
#define PP_SCAN_THREADS 256
#define PP_HIST_THREADS 256
#define PP_GATHER_THREADS 256

__global__ void pp_tile_hist(const int32_t* __restrict__ ids, int64_t T,
                             int n_parts, int n_tiles,
                             int32_t* __restrict__ tile_counts) {
  extern __shared__ int32_t hist[];
  const int tile = blockIdx.x;
  for (int p = threadIdx.x; p < n_parts; p += blockDim.x) hist[p] = 0;
  __syncthreads();
  const int64_t lo = (int64_t)tile * PP_TILE;
  const int64_t hi = min(lo + PP_TILE, T);
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int p = ids[i];
    if (p >= 0 && p < n_parts) atomicAdd(&hist[p], 1);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n_parts; p += blockDim.x)
    tile_counts[(int64_t)p * n_tiles + tile] = hist[p];
}

__global__ void pp_tile_scan(int32_t* __restrict__ tile_counts, int n_tiles,
                             int32_t* __restrict__ counts) {
  __shared__ int32_t warp_sums[32];
  __shared__ int32_t carry;
  int32_t* row = tile_counts + (int64_t)blockIdx.x * n_tiles;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n_tiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < n_tiles ? row[i] : 0;
    int x = v;                                   // inclusive scan in warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {                             // scan the warp totals
      int w = lane < n_warps ? warp_sums[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      if (lane < n_warps) warp_sums[lane] = w;
    }
    __syncthreads();
    const int before = carry + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (i < n_tiles) row[i] = before + x - v;    // exclusive
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry = before + x;
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = carry;
}

__global__ void pp_slots(const int32_t* __restrict__ ids, int64_t T,
                         int n_parts, int n_tiles, int capacity,
                         const int32_t* __restrict__ tile_base,
                         int32_t* __restrict__ slots,
                         int32_t* __restrict__ row_of) {
  extern __shared__ int32_t running[];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  for (int p = lane; p < n_parts; p += 32)
    running[p] = tile_base[(int64_t)p * n_tiles + tile];
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
  const int64_t lo = (int64_t)tile * PP_TILE;
  const int64_t hi = min(lo + PP_TILE, T);
  for (int64_t base = lo; base < hi; base += 32) {
    const int64_t i = base + lane;
    const int p = i < hi ? ids[i] : -1;
    const bool valid = p >= 0 && p < n_parts;
    const unsigned peers = __match_any_sync(0xffffffffu, valid ? p : -1);
    const int rank = __popc(peers & lower);
    const int start = valid ? running[p] : 0;
    __syncwarp();
    if (valid && rank == 0) running[p] = start + __popc(peers);
    __syncwarp();
    if (i < hi) {
      const int slot = valid ? start + rank : -1;
      slots[i] = slot;
      if (valid && slot < capacity)
        row_of[(int64_t)p * capacity + slot] = (int32_t)i;
    }
  }
}

template <typename E>
__global__ void pp_gather(const E* __restrict__ rows,
                          const int32_t* __restrict__ row_of,
                          E* __restrict__ buf, int64_t n_slots, int d) {
  const int64_t total = n_slots * d;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int64_t s = e / d;
    const int j = (int)(e - s * d);
    const int32_t r = row_of[s];
    buf[e] = r >= 0 ? rows[(int64_t)r * d + j] : E(0);
  }
}

extern "C" {

int pp_max_parts() { return PP_MAX_PARTS; }

int pp_tile_rows() { return PP_TILE; }

const char* pp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Passes 1-3. ids [T] int32; tile_counts [n_parts * n_tiles] int32 scratch;
// counts [n_parts], slots [T] int32; row_of [n_parts, capacity] int32 filled
// with -1 by the caller. Returns a cudaError_t (0 = launched).
int pp_count_slots(const void* ids, int64_t T, int n_parts, int capacity,
                   void* tile_counts, void* counts, void* slots,
                   void* row_of, void* stream) {
  if (T <= 0 || n_parts <= 0 || n_parts > PP_MAX_PARTS || capacity < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (int)((T + PP_TILE - 1) / PP_TILE);
  const size_t shm = (size_t)n_parts * sizeof(int32_t);
  pp_tile_hist<<<n_tiles, PP_HIST_THREADS, shm, s>>>(
      (const int32_t*)ids, T, n_parts, n_tiles, (int32_t*)tile_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pp_tile_scan<<<n_parts, PP_SCAN_THREADS, 0, s>>>(
      (int32_t*)tile_counts, n_tiles, (int32_t*)counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pp_slots<<<n_tiles, 32, shm, s>>>(
      (const int32_t*)ids, T, n_parts, n_tiles, capacity,
      (const int32_t*)tile_counts, (int32_t*)slots, (int32_t*)row_of);
  return (int)cudaGetLastError();
}

// Pass 4. rows [T, d] and buf [n_slots, d] of elem_bytes-wide elements;
// row_of [n_slots] int32.
int pp_gather(const void* rows, const void* row_of, void* buf,
              int64_t n_slots, int d, int elem_bytes, void* stream) {
  if (n_slots <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t total = n_slots * d;
  const int64_t want = (total + PP_GATHER_THREADS - 1) / PP_GATHER_THREADS;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  const int32_t* ro = (const int32_t*)row_of;
  switch (elem_bytes) {
    case 2:
      pp_gather<uint16_t><<<blocks, PP_GATHER_THREADS, 0, s>>>(
          (const uint16_t*)rows, ro, (uint16_t*)buf, n_slots, d);
      break;
    case 4:
      pp_gather<uint32_t><<<blocks, PP_GATHER_THREADS, 0, s>>>(
          (const uint32_t*)rows, ro, (uint32_t*)buf, n_slots, d);
      break;
    case 8:
      pp_gather<uint64_t><<<blocks, PP_GATHER_THREADS, 0, s>>>(
          (const uint64_t*)rows, ro, (uint64_t*)buf, n_slots, d);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
