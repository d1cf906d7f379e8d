// partition_pack for Hopper (sm_90a): the stable partition-major pack of
// the §3.2 partitioned object, as a plain C interface loaded with ctypes.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/partition_pack/
// partition_pack.py: pack_pallas (count_slots_kernel + gather_pack_kernel).
// Same outputs: buf [n_parts, capacity, d] per row group (zero past a
// partition's count, rows past capacity dropped), counts [n_parts] (the
// offsets header) and slots [T] (a row's position inside its partition, in
// arrival order; -1 for an id outside [0, n_parts)).
//
// Bound: memory. The least time is (bytes read + bytes written) / 3.35
// TB/s: ids and rows read once; slots, counts and buf written once (48.1 MB
// at the main shape, 857,316 rows of 24 bytes in 8 partitions: 0.0144 ms).
// So every row is read once from device memory and every output written
// once with coalesced stores, everything else stays on chip, and a call
// issues at most two launches: a call of the main path is host-bound
// (submission), not byte-bound.
//
// The TPU kernel carries running per-partition counts across a sequential
// grid. CUDA blocks run in no order; here the carry is a single pass with
// decoupled look-back (onesweep), pp_place<true>, one block of PP_THREADS
// threads per tile of PP_TILE rows:
//   1. the block takes its tile from a ticket counter (atomicAdd), so every
//      tile below it belongs to a block that is already running: the
//      look-back never waits on a tile that was not scheduled;
//   2. it loads its ids (8 a thread, all loads first); each warp ranks its
//      256 rows in order, 32 at a time: __match_any_sync groups the lanes
//      of a partition, and the rank among lower lanes plus the warp's own
//      running count (a per-warp 16-bit sub-histogram in shared memory)
//      gives the row's rank in the warp; no atomics, no contention. A scan
//      over the warps turns the sub-histograms into each warp's offset and
//      the tile's histogram, and a scan over the partitions gives each
//      partition's run in the tile: the rows' partition order (a 16-bit
//      permutation in shared memory);
//   3. it publishes the tile's aggregate, one status word a partition
//      (64 bits: the call's epoch, aggregate or inclusive, the value),
//      written and read whole with relaxed accesses, so no fence is needed.
//      Then G lanes a partition (G = 256 / n_parts, 32 down to 4) look
//      back: each lane loads 8 words at once (a window of 8 G tiles), and
//      the group takes rows of G words nearest first, waiting on a word
//      until it carries this call's epoch, and stops at the first row that
//      holds an inclusive prefix; it adds the values up to it, in further
//      windows if none did, and publishes the tile's inclusive prefix.
//      Words of an earlier call carry another epoch and read as "not yet
//      published", so the status words are never reset: they are zero-
//      filled once when the workspace grows (epochs start at 1);
//   4. slot = the tile's exclusive prefix + the warp's offset + the rank.
//      Every group is written in partition order: consecutive threads write
//      consecutive slots of one partition, in vectors of 16, 8, 4 or 2
//      bytes (the widest that divides the row and both pointers), four a
//      thread with the loads first. The tile's rows (48 KB at the main
//      shape) are prefetched into L1 during the look-back, after every
//      tile's ids have been asked for.
// The last tile's inclusive prefix is `counts`. Rows at slot >= capacity
// are dropped. Tails [count_p, capacity) are zero-filled by the second
// launch (pp_zero_tails), or in the same launch where the counts are known
// before it (after pp_hash_count, or on the multi-pass route).
//
// Launches a call, up to PP_LOOKBACK_MAX_PARTS = 64 partitions:
//   pack()         pp_place<true> (slots, counts, buf) + pp_zero_tails;
//   pack_by_key()  pp_hash_count, one block a tile: ids = splitmix64(key)
//                  mod n_parts in native uint64, the tile's histogram
//                  published straight into the look-back's status words as
//                  its aggregate, and atomics into a workspace vector that
//                  the last block (by ticket) moves to `counts`, leaving it
//                  zero; then pp_place<true> with the aggregates already
//                  out and the counts known, tails in the same launch. The
//                  wrapper reads `counts` to the host between the two, the
//                  call's only sync: it sizes capacity = max(counts).
// Above 64 partitions the route is multi-pass: pp_tile_hist (tile
// histograms; pack_by_key's pp_hash_count writes them instead), pp_tile_scan
// (one block per partition scans its tiles: exclusive offsets and counts),
// then pp_place<false>, which takes its offsets from the scan and zero-
// fills the tails itself. Three launches. Measured on the H100 at the main
// shape, the look-back's sums of 256 / n_parts lanes a partition stop
// paying there: the two routes tie at 64 partitions, and at 256 and 1024
// the multi-pass route is 2x-3x faster (PERF.md, launch/bench_pack.py).
//
// Tile: 2048 rows, 256 threads, 8 rows a thread, so a thread keeps its
// rows' partitions and ranks in registers and the 16-bit permutation and
// sub-histograms suffice. At the main shape that is 419 tiles, all resident
// at once on the 132 SMs (4 blocks an SM), so the whole pass is one wave:
// the look-back's latency (about 5-7 us) adds to the time rather than
// hiding behind other tiles' copies, the cost measured against the
// multi-pass place (PERF.md).
//
// Limits: n_parts <= PP_MAX_PARTS = 8192 (the per-warp sub-histograms and
// tile prefixes of one tile live in shared memory: 24 bytes a partition,
// 200 KB at 8192); T < 2^31 (int32 rows and counts); at most
// PP_MAX_GROUPS row groups a call.
#include <cuda_runtime.h>
#include <stdint.h>

#define PP_TILE 2048
#define PP_THREADS 256
#define PP_WARPS (PP_THREADS / 32)
#define PP_ROWS_PER_WARP (PP_TILE / PP_WARPS)
#define PP_STEPS (PP_ROWS_PER_WARP / 32)
#define PP_MAX_PARTS 8192
#define PP_LOOKBACK_MAX_PARTS 64
#define PP_MAX_GROUPS 8
#define PP_SCAN_THREADS 256
#define PP_NO_PART 0xFFFFu

#define PP_LB_WORDS 8             // status words a lane reads a round
#define PP_NONE 0x7fffffff
#define PP_CLOCKS 7               // phase clocks a tile (see pp_place)
#define PP_COPY_UNROLL 4
#define PP_FLAG_AGG 1ull
#define PP_FLAG_INCL 2ull

struct PPGroup {
  const char* src;       // rows [T, row_bytes]
  char* dst;             // buf [n_parts, capacity, row_bytes]
  int64_t vec_per_row;   // row_bytes / vec_bytes
  int vec_bytes;         // 16, 8, 4 or 2
};

struct PPGroups {
  PPGroup g[PP_MAX_GROUPS];
  int n;
};

// ------------------------------------------------------------ primitives
__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}

// A look-back status word: the call's epoch (31 bits), a flag (aggregate
// or inclusive) and the value (31 bits), published and read whole.
__device__ __forceinline__ uint64_t status_word(uint32_t epoch,
                                                uint64_t flag, int value) {
  return ((uint64_t)epoch << 33) | (flag << 31) | (uint64_t)(uint32_t)value;
}

// The device's global nanosecond clock (for the optional phase clocks).
__device__ __forceinline__ int64_t global_ns() {
  int64_t t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// Exclusive scan of in[0, n) into out[0, n) by the whole block (in and out
// may alias); -> the total, to every thread.
__device__ int block_exclusive_scan(const int* in, int* out, int n) {
  __shared__ int warp_tot[PP_THREADS / 32];
  __shared__ int total_s;
  const int chunk = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, (int)threadIdx.x * chunk);
  const int hi = min(n, lo + chunk);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += in[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int w = lane < nw ? warp_tot[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) warp_tot[lane] = w;
    if (lane == nw - 1) total_s = w;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? warp_tot[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int v = in[i];
    out[i] = run;
    run += v;
  }
  const int total = total_s;
  __syncthreads();
  return total;
}

// Zero vectors [lo, hi) of a group's flat buffer, by the whole block.
template <typename V>
__device__ __forceinline__ void zero_vecs(char* dst, int64_t lo, int64_t hi) {
  V* d = reinterpret_cast<V*>(dst);
  for (int64_t e = lo + threadIdx.x; e < hi; e += blockDim.x) d[e] = V{};
}

// Worker `worker` of n_workers zeroes its share of the partitions' tails
// [count_p, capacity): with at least as many partitions as workers, whole
// tails of the partitions p = worker (mod n_workers); with fewer, the tail
// of partition worker % n_parts, split by vectors among the workers that
// share it.
__device__ void zero_tails(const PPGroups& gs, const int32_t* counts,
                           int n_parts, int capacity, int worker,
                           int n_workers) {
  int p = worker, step = n_workers, share = 0, n_shares = 1;
  if (n_parts < n_workers) {
    p = worker % n_parts;
    step = n_parts;
    share = worker / n_parts;
    n_shares = (n_workers - p + n_parts - 1) / n_parts;
  }
  for (; p < n_parts; p += step) {
    const int64_t c0 = min(counts[p], capacity);
    if (c0 >= capacity) continue;
    for (int k = 0; k < gs.n; ++k) {
      const PPGroup& g = gs.g[k];
      const int64_t a = ((int64_t)p * capacity + c0) * g.vec_per_row;
      const int64_t b = ((int64_t)p + 1) * capacity * g.vec_per_row;
      const int64_t per = (b - a + n_shares - 1) / n_shares;
      const int64_t lo = a + share * per;
      const int64_t hi = min(lo + per, b);
      if (lo >= hi) continue;
      switch (g.vec_bytes) {
        case 16: zero_vecs<uint4>(g.dst, lo, hi); break;
        case 8: zero_vecs<uint2>(g.dst, lo, hi); break;
        case 4: zero_vecs<uint32_t>(g.dst, lo, hi); break;
        default: zero_vecs<uint16_t>(g.dst, lo, hi); break;
      }
    }
  }
}

// Rows of the tile in partition order -> their slots in the group's buf,
// PP_COPY_UNROLL vectors a thread at a time (all loads, then all stores).
template <typename V>
__device__ __forceinline__ void place_group(
    const PPGroup& g, int64_t tile_lo, int n_valid, int capacity,
    const uint16_t* perm, const uint16_t* part, const int* excl,
    const int* loff) {
  const V* __restrict__ src = reinterpret_cast<const V*>(g.src);
  V* __restrict__ dst = reinterpret_cast<V*>(g.dst);
  const int vpr = (int)g.vec_per_row;
  const int total = n_valid * vpr;
  for (int e0 = threadIdx.x; e0 < total;
       e0 += PP_COPY_UNROLL * blockDim.x) {
    V val[PP_COPY_UNROLL];
    int64_t to[PP_COPY_UNROLL];
#pragma unroll
    for (int u = 0; u < PP_COPY_UNROLL; ++u) {
      const int e = e0 + u * blockDim.x;
      to[u] = -1;
      if (e < total) {
        const int j = vpr == 1 ? e : e / vpr;
        const int v = e - j * vpr;
        const int r = perm[j];
        const int p = part[r];
        const int slot = excl[p] + (j - loff[p]);
        if (slot < capacity) {
          to[u] = ((int64_t)p * capacity + slot) * vpr + v;
          val[u] = src[(tile_lo + r) * vpr + v];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < PP_COPY_UNROLL; ++u)
      if (to[u] >= 0) dst[to[u]] = val[u];
  }
}

// Ask L1 for the tile's rows of every group (128-byte lines), so that the
// partition-order copy at the end finds them on chip.
__device__ __forceinline__ void prefetch_tile(const PPGroups& gs,
                                              int64_t tile_lo, int64_t T) {
  const int64_t rows = min((int64_t)PP_TILE, T - tile_lo);
  for (int k = 0; k < gs.n; ++k) {
    const PPGroup& g = gs.g[k];
    const int64_t row_bytes = g.vec_per_row * g.vec_bytes;
    const char* lo = g.src + tile_lo * row_bytes;
    const int64_t n_lines = (rows * row_bytes + 127) / 128;
    for (int64_t l = threadIdx.x; l < n_lines; l += blockDim.x)
      asm volatile("prefetch.global.L1 [%0];" :: "l"(lo + l * 128));
  }
}

// ------------------------------------------------------------- pp_place
// Shared memory (dynamic): int32 hx[n_parts] (tile histogram, then the
// tile's global exclusive prefix), int32 loff[n_parts] (offset of each
// partition's run inside the tile), uint16 sub[PP_WARPS][n_parts] (each
// warp's count, then its offset inside the partition's run), uint16
// part[PP_TILE] (partition of each row, PP_NO_PART if none), uint16
// perm[PP_TILE] (the tile's rows in partition order).
//
// LOOKBACK: tiles from the ticket counter, prefixes by look-back through
// `status` [n_tiles][n_parts] (its aggregates already there if
// `published`). Else: tile = blockIdx.x, prefixes from `tile_base`
// [n_parts, n_tiles] (pp_tile_scan).
// known_counts (nullable): the call's counts, known before the launch;
// then this launch zero-fills the tails. Else the last tile writes
// `counts`. slots (nullable) [T]. clocks (nullable) [n_tiles, PP_CLOCKS]:
// thread 0's %globaltimer at the block's start, once it has its tile,
// after the ranks, after the prefix (look-back or load), after the slots,
// after the rows, and at the end (tails included): a measurement aid.
template <bool LOOKBACK>
__global__ void __launch_bounds__(PP_THREADS)
pp_place(const int32_t* __restrict__ ids, int64_t T, int n_parts,
         int capacity, int n_tiles, PPGroups gs,
         const int32_t* __restrict__ known_counts, int32_t* counts,
         int32_t* __restrict__ slots, unsigned long long* ticket,
         unsigned long long ticket_base, uint32_t epoch, uint64_t* status,
         bool published, const int32_t* __restrict__ tile_base,
         int64_t* clocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* hx = reinterpret_cast<int*>(smem);
  int* loff = hx + n_parts;
  uint16_t* sub = reinterpret_cast<uint16_t*>(loff + n_parts);
  uint16_t* part = sub + PP_WARPS * n_parts;
  uint16_t* perm = part + PP_TILE;
  __shared__ int tile_s;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t_start = clocks ? global_ns() : 0;
  if (threadIdx.x == 0)
    tile_s = LOOKBACK ? (int)(atomicAdd(ticket, 1ull) - ticket_base)
                      : (int)blockIdx.x;
  for (int i = threadIdx.x; i < PP_WARPS * n_parts; i += blockDim.x)
    sub[i] = 0;
  __syncthreads();
  const int tile = tile_s;
  const int64_t tile_lo = (int64_t)tile * PP_TILE;
  int64_t* clk = clocks && threadIdx.x == 0 ? clocks + tile * PP_CLOCKS
                                            : nullptr;
  if (clk) {
    clk[0] = t_start;
    clk[1] = global_ns();
  }

  // 2. per-warp stable ranks
  int my_p[PP_STEPS], my_rank[PP_STEPS];
  uint16_t* wsub = sub + warp * n_parts;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < PP_STEPS; ++s) {           // all loads first
    const int64_t i = tile_lo + warp * PP_ROWS_PER_WARP + s * 32 + lane;
    my_p[s] = i < T ? ids[i] : -1;
  }
#pragma unroll
  for (int s = 0; s < PP_STEPS; ++s) {
    const int r = warp * PP_ROWS_PER_WARP + s * 32 + lane;
    const int p = my_p[s];
    const bool valid = p >= 0 && p < n_parts;
    part[r] = valid ? (uint16_t)p : (uint16_t)PP_NO_PART;
    const unsigned peers = __match_any_sync(0xffffffffu, valid ? p : -1);
    const int before = valid ? (int)wsub[p] : 0;
    __syncwarp();
    if (valid && (peers & lower) == 0)
      wsub[p] = (uint16_t)(before + __popc(peers));
    __syncwarp();
    my_p[s] = valid ? p : -1;
    my_rank[s] = before + __popc(peers & lower);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n_parts; p += blockDim.x) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < PP_WARPS; ++w) {
      const int c = sub[w * n_parts + p];
      sub[w * n_parts + p] = (uint16_t)run;
      run += c;
    }
    hx[p] = run;
  }
  __syncthreads();
  const int n_valid = block_exclusive_scan(hx, loff, n_parts);
#pragma unroll
  for (int s = 0; s < PP_STEPS; ++s) {
    const int p = my_p[s];
    if (p >= 0)
      perm[loff[p] + wsub[p] + my_rank[s]] =
          (uint16_t)(warp * PP_ROWS_PER_WARP + s * 32 + lane);
  }

  if (clk) clk[2] = global_ns();

  // 3. the tile's exclusive prefix of every partition
  if (LOOKBACK) {
    // publish the aggregate (tile 0: its inclusive prefix): one relaxed
    // 64-bit store a partition, value and flag in one word, no fence
    // (unless pp_hash_count published it already)
    uint64_t* mine = status + (int64_t)tile * n_parts;
    if (!published)
      for (int p = threadIdx.x; p < n_parts; p += blockDim.x)
        st_relaxed(mine + p, status_word(
            epoch, tile == 0 ? PP_FLAG_INCL : PP_FLAG_AGG, hx[p]));
    __syncthreads();                 // hx is rewritten below by other threads
    // the rows stream into L1 while the block looks back (not sooner: the
    // ids of every tile go first, so that every aggregate is out early)
    prefetch_tile(gs, tile_lo, T);
    if (tile > 0) {
      // then look back: G lanes a partition (G = 256 / n_parts rounded
      // down to a power of two, 32 down to 4) read PP_LB_WORDS status
      // words each, a window of G * PP_LB_WORDS preceding tiles a round,
      // all loads first, then waiting on each until it carries this call's
      // epoch; the group finds the nearest inclusive word and adds the
      // values up to it
      const int G = n_parts <= 8 ? 32 : n_parts <= 16 ? 16
                    : n_parts <= 32 ? 8 : 4;
      const int k = lane % G;
      const unsigned gmask = (G == 32 ? 0xffffffffu : ((1u << G) - 1u))
                             << (lane - k);
      const int window = G * PP_LB_WORDS;
      const int p = threadIdx.x / G;         // one partition a group
      if (p < n_parts) {
        int excl = 0;
        for (int base = tile - 1;; base -= window) {
          uint64_t w[PP_LB_WORDS];
#pragma unroll
          for (int i = 0; i < PP_LB_WORDS; ++i) {
            const int t = base - (k + i * G);
            w[i] = t >= 0 ? ld_relaxed(status + (int64_t)t * n_parts + p)
                          : status_word(epoch, PP_FLAG_INCL, 0);
          }
          // rows of G words, nearest first: wait for a row's words, stop
          // at the first row holding an inclusive one
          int near = PP_NONE, v = 0;
#pragma unroll
          for (int i = 0; i < PP_LB_WORDS; ++i) {
            if (near != PP_NONE) break;
            const int t = base - (k + i * G);
            while ((uint32_t)(w[i] >> 33) != epoch)
              w[i] = ld_relaxed(status + (int64_t)t * n_parts + p);
            const unsigned inc = __ballot_sync(
                gmask, ((w[i] >> 31) & 3ull) == PP_FLAG_INCL) & gmask;
            if (inc) near = i * G + __ffs(inc >> (lane - k)) - 1;
            if (near == PP_NONE || k + i * G <= near)
              v += (int)(w[i] & 0x7FFFFFFFull);
          }
          for (int o = G >> 1; o > 0; o >>= 1)
            v += __shfl_xor_sync(gmask, v, o, G);
          excl += v;
          if (near != PP_NONE) break;
        }
        if (k == 0) {
          st_relaxed(mine + p,
                     status_word(epoch, PP_FLAG_INCL, excl + hx[p]));
          hx[p] = excl;                       // only this thread owns p
        }
      }
    } else {
      for (int p = threadIdx.x; p < n_parts; p += blockDim.x) hx[p] = 0;
    }
  } else {
    prefetch_tile(gs, tile_lo, T);
    for (int p = threadIdx.x; p < n_parts; p += blockDim.x)
      hx[p] = tile_base[(int64_t)p * n_tiles + tile];
  }
  __syncthreads();
  if (clk) clk[3] = global_ns();
  // hx is now the tile's exclusive prefix; the last tile's + its own
  // histogram is the partition's count
  if (known_counts == nullptr && tile == n_tiles - 1) {
    for (int p = threadIdx.x; p < n_parts; p += blockDim.x) {
      const int own = (p + 1 < n_parts ? loff[p + 1] : n_valid) - loff[p];
      counts[p] = hx[p] + own;
    }
  }

  // 4. slots, then the rows in partition order
  if (clk) clk[4] = global_ns();
  if (slots != nullptr) {
#pragma unroll
    for (int s = 0; s < PP_STEPS; ++s) {
      const int64_t i = tile_lo + warp * PP_ROWS_PER_WARP + s * 32 + lane;
      const int p = my_p[s];
      if (i < T)
        slots[i] = p >= 0 ? hx[p] + wsub[p] + my_rank[s] : -1;
    }
  }
  for (int k = 0; k < gs.n; ++k) {
    const PPGroup& g = gs.g[k];
    switch (g.vec_bytes) {
      case 16: place_group<uint4>(g, tile_lo, n_valid, capacity, perm, part,
                                  hx, loff); break;
      case 8: place_group<uint2>(g, tile_lo, n_valid, capacity, perm, part,
                                 hx, loff); break;
      case 4: place_group<uint32_t>(g, tile_lo, n_valid, capacity, perm,
                                    part, hx, loff); break;
      default: place_group<uint16_t>(g, tile_lo, n_valid, capacity, perm,
                                     part, hx, loff); break;
    }
  }
  if (clk) clk[5] = global_ns();
  if (known_counts != nullptr)
    zero_tails(gs, known_counts, n_parts, capacity, tile, n_tiles);
  if (clk) clk[6] = global_ns();
}

__global__ void __launch_bounds__(PP_THREADS)
pp_zero_tails(PPGroups gs, const int32_t* __restrict__ counts, int n_parts,
              int capacity) {
  zero_tails(gs, counts, n_parts, capacity, blockIdx.x, gridDim.x);
}

// --------------------------------------------------------- pp_hash_count
// One block a tile of PP_TILE rows: ids[i] = splitmix64(key[i]) mod
// n_parts (uint64), the tile's histogram in shared memory (lanes of one
// partition merged by __match_any_sync, one shared atomic per partition and
// warp step), published for the pack that follows as the tile's look-back
// aggregate (status, with the pack's epoch; tile 0's as its inclusive
// prefix) or as its column of the multi-pass route's tile counts. Then
// atomics into acc [n_parts] (zero between calls); the last block (by
// ticket) moves acc into counts and zeroes it again.
__global__ void __launch_bounds__(PP_THREADS)
pp_hash_count(const int64_t* __restrict__ key, int64_t T, int n_parts,
              int32_t* __restrict__ ids, int32_t* acc, int32_t* counts,
              unsigned long long* ticket, unsigned long long ticket_base,
              uint64_t* status, uint32_t epoch, int32_t* tile_counts) {
  extern __shared__ int hist[];
  __shared__ bool last;
  for (int p = threadIdx.x; p < n_parts; p += blockDim.x) hist[p] = 0;
  __syncthreads();
  const int tile = blockIdx.x;
  const uint64_t n = (uint64_t)n_parts;
  const bool pow2 = (n & (n - 1)) == 0;
  const unsigned lower = (1u << (threadIdx.x & 31)) - 1u;
  const int64_t lo = (int64_t)tile * PP_TILE;
  uint64_t k[PP_TILE / PP_THREADS];
#pragma unroll
  for (int u = 0; u < PP_TILE / PP_THREADS; ++u) {  // all loads first
    const int64_t i = lo + u * PP_THREADS + threadIdx.x;
    k[u] = i < T ? (uint64_t)key[i] : 0;
  }
#pragma unroll
  for (int u = 0; u < PP_TILE / PP_THREADS; ++u) {
    const int64_t i = lo + u * PP_THREADS + threadIdx.x;
    int p = -1;
    if (i < T) {
      const uint64_t h = splitmix64(k[u]);
      p = (int)(pow2 ? (h & (n - 1)) : (h % n));
      ids[i] = p;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, p);
    if (p >= 0 && (peers & lower) == 0) atomicAdd(&hist[p], __popc(peers));
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n_parts; p += blockDim.x) {
    const int c = hist[p];
    if (status != nullptr)
      status[(int64_t)tile * n_parts + p] = status_word(
          epoch, tile == 0 ? PP_FLAG_INCL : PP_FLAG_AGG, c);
    if (tile_counts != nullptr)
      tile_counts[(int64_t)p * gridDim.x + tile] = c;
    if (c) atomicAdd(&acc[p], c);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1ull) - ticket_base == gridDim.x - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    for (int p = threadIdx.x; p < n_parts; p += blockDim.x)
      counts[p] = atomicExch(&acc[p], 0);
  }
}

// ------------------------------------------- multi-pass route (> 1024 parts)
__global__ void __launch_bounds__(PP_THREADS)
pp_tile_hist(const int32_t* __restrict__ ids, int64_t T, int n_parts,
             int n_tiles, int32_t* __restrict__ tile_counts) {
  extern __shared__ int hist[];
  const int tile = blockIdx.x;
  for (int p = threadIdx.x; p < n_parts; p += blockDim.x) hist[p] = 0;
  __syncthreads();
  const unsigned lower = (1u << (threadIdx.x & 31)) - 1u;
  const int64_t lo = (int64_t)tile * PP_TILE;
  for (int r = threadIdx.x; r < PP_TILE; r += blockDim.x) {
    const int64_t i = lo + r;
    int p = i < T ? ids[i] : -1;
    if (p >= n_parts) p = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, p);
    if (p >= 0 && (peers & lower) == 0) atomicAdd(&hist[p], __popc(peers));
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
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
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

// ------------------------------------------------------------ C interface
static size_t place_smem(int n_parts) {
  return (size_t)n_parts * (2 * sizeof(int32_t) + PP_WARPS * sizeof(uint16_t))
         + 2 * PP_TILE * sizeof(uint16_t);
}

static int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
        != cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

static int vec_bytes(int64_t row_bytes, const void* a, const void* b) {
  int v = 16;
  while (v > 2 && (row_bytes % v || (uintptr_t)a % v || (uintptr_t)b % v))
    v >>= 1;
  return v;
}

static int make_groups(int n_groups, const void* const* srcs,
                       void* const* dsts, const int64_t* row_bytes,
                       PPGroups* gs) {
  if (n_groups < 0 || n_groups > PP_MAX_GROUPS) return 0;
  gs->n = n_groups;
  for (int k = 0; k < n_groups; ++k) {
    if (row_bytes[k] < 0 || row_bytes[k] % 2 || row_bytes[k] > (1 << 20))
      return 0;
    const int v = vec_bytes(row_bytes[k], srcs[k], dsts[k]);
    if ((uintptr_t)srcs[k] % v || (uintptr_t)dsts[k] % v) return 0;
    gs->g[k].src = (const char*)srcs[k];
    gs->g[k].dst = (char*)dsts[k];
    gs->g[k].vec_bytes = v;
    gs->g[k].vec_per_row = row_bytes[k] / v;
  }
  return 1;
}

template <bool LOOKBACK>
static cudaError_t launch_place(const void* ids, int64_t T, int n_parts,
                                int capacity, int n_tiles,
                                const PPGroups& gs, const void* known,
                                void* counts, void* slots, void* ticket,
                                uint64_t ticket_base, uint32_t epoch,
                                void* status, bool published,
                                const void* tile_base, void* clocks,
                                cudaStream_t s) {
  const size_t shm = place_smem(n_parts);
  if (shm > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pp_place<LOOKBACK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (err != cudaSuccess) return err;
  }
  pp_place<LOOKBACK><<<n_tiles, PP_THREADS, shm, s>>>(
      (const int32_t*)ids, T, n_parts, capacity, n_tiles, gs,
      (const int32_t*)known, (int32_t*)counts, (int32_t*)slots,
      (unsigned long long*)ticket, (unsigned long long)ticket_base, epoch,
      (uint64_t*)status, published, (const int32_t*)tile_base,
      (int64_t*)clocks);
  return cudaGetLastError();
}

extern "C" {

int pp_max_parts() { return PP_MAX_PARTS; }

int pp_lookback_max_parts() { return PP_LOOKBACK_MAX_PARTS; }

int pp_tile_rows() { return PP_TILE; }

int pp_max_groups() { return PP_MAX_GROUPS; }

const char* pp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Blocks pp_hash_count runs for T rows, one a tile (the ticket advance of
// one call).
int pp_hash_blocks(int64_t T) { return (int)((T + PP_TILE - 1) / PP_TILE); }

// ids [T] int32 in [0, n_parts) (others: slot -1, not packed); groups:
// srcs [T, row_bytes], dsts [n_parts, capacity, row_bytes]; known_counts
// [n_parts] (nullable: then counts [n_parts] is written); slots [T]
// (nullable). lookback: 1 for the look-back route (n_parts <=
// PP_LOOKBACK_MAX_PARTS), 0 for the multi-pass route. Look-back: ticket
// (uint64, advanced by n_tiles), ticket_base (its value before the call),
// epoch (in [1, 2^31), new each call), status [n_tiles * n_parts] uint64
// (zero or of earlier epochs).
// Multi-pass route: tile_scratch [n_parts * (n_tiles + 1)] int32.
// published: 1 where pp_hash_count has put the tiles' histograms there
// already (status or tile_scratch), so this pack skips its own. clocks
// (nullable): pp_place's phase clocks, [n_tiles, PP_CLOCKS] int64. Returns
// a cudaError_t (0 = launched).
int pp_pack(const void* ids, int64_t T, int n_parts, int capacity,
            int n_groups, const void* const* srcs, void* const* dsts,
            const int64_t* row_bytes, const void* known_counts,
            void* counts, void* slots, void* ticket, uint64_t ticket_base,
            int lookback, uint32_t epoch, void* status, void* tile_scratch,
            int published, void* clocks, void* stream) {
  if (T <= 0 || T >= (1ll << 31) || n_parts <= 0 || n_parts > PP_MAX_PARTS
      || capacity < 0 || (known_counts == nullptr && counts == nullptr))
    return (int)cudaErrorInvalidValue;
  PPGroups gs;
  if (!make_groups(n_groups, srcs, dsts, row_bytes, &gs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (int)((T + PP_TILE - 1) / PP_TILE);
  cudaError_t err;
  const bool tails = capacity > 0 && n_groups > 0;
  if (lookback) {
    if (epoch == 0 || epoch >= (1u << 31) || n_parts > PP_LOOKBACK_MAX_PARTS)
      return (int)cudaErrorInvalidValue;
    err = launch_place<true>(ids, T, n_parts, capacity, n_tiles, gs,
                             known_counts, counts, slots, ticket,
                             ticket_base, epoch, status, published != 0,
                             nullptr, clocks, s);
    if (err != cudaSuccess || known_counts != nullptr || !tails)
      return (int)err;
    // every partition gets the same number of blocks (at least one)
    const int most = sm_count() * 8;
    const int blocks = n_parts >= most ? most : most / n_parts * n_parts;
    pp_zero_tails<<<blocks, PP_THREADS, 0, s>>>(
        gs, (const int32_t*)counts, n_parts, capacity);
    return (int)cudaGetLastError();
  }
  // multi-pass: histograms, scan (-> counts), place with tails
  int32_t* tc = (int32_t*)tile_scratch;
  int32_t* cnt = (int32_t*)(known_counts ? nullptr : counts);
  if (!published) {
    pp_tile_hist<<<n_tiles, PP_THREADS, (size_t)n_parts * sizeof(int32_t),
                   s>>>((const int32_t*)ids, T, n_parts, n_tiles, tc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // the scan's totals go to counts, or to a throwaway row when they are
  // known already (the scratch holds n_parts more entries for that)
  pp_tile_scan<<<n_parts, PP_SCAN_THREADS, 0, s>>>(
      tc, n_tiles, cnt ? cnt : tc + (int64_t)n_parts * n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_place<false>(
      ids, T, n_parts, capacity, n_tiles, gs,
      known_counts ? known_counts : counts, nullptr, slots, nullptr, 0, 0,
      nullptr, false, tc, clocks, s);
}

// key [T] int64 -> ids [T] int32 = splitmix64(key) mod n_parts and
// counts [n_parts] int32. acc [n_parts] int32 must be zero (it is left
// zero); ticket advances by pp_hash_blocks(T). The tiles' histograms go
// to status (nullable; the look-back's words of the pack that follows,
// with its epoch) and to tile_counts (nullable; the multi-pass route's
// [n_parts, n_tiles]); that pack is then launched with published = 1.
int pp_hash_count(const void* key, int64_t T, int n_parts, void* ids,
                  void* acc, void* counts, void* ticket,
                  uint64_t ticket_base, void* status, uint32_t epoch,
                  void* tile_counts, void* stream) {
  if (T <= 0 || T >= (1ll << 31) || n_parts <= 0 || n_parts > PP_MAX_PARTS
      || (status != nullptr && (epoch == 0 || epoch >= (1u << 31))))
    return (int)cudaErrorInvalidValue;
  pp_hash_count<<<pp_hash_blocks(T), PP_THREADS,
                  (size_t)n_parts * sizeof(int32_t), (cudaStream_t)stream>>>(
      (const int64_t*)key, T, n_parts, (int32_t*)ids, (int32_t*)acc,
      (int32_t*)counts, (unsigned long long*)ticket,
      (unsigned long long)ticket_base, (uint64_t*)status, epoch,
      (int32_t*)tile_counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
