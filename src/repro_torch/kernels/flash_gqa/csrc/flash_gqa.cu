// flash_gqa for Hopper (sm_90a): blockwise online-softmax attention with
// grouped kv heads, forward only, as a plain C interface loaded with ctypes.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_gqa/
// flash_gqa.py: flash_attention_pallas (body _flash_kernel) together with
// the host-side preparation of its wrapper ops.flash_gqa. Inputs in model
// layout: q [B,Sq,H,D], k [B,Skv,Hkv,D], v [B,Skv,Hkv,DV] and an int32 map
// kv_head [H] (query head h reads kv head kv_head[h]); q, k, v and the
// output o [B,Sq,H,DV] share one type (f32 or bf16). For each (b, h) and
// query row i < Sq:
//   o_i = sum_j softmax_j(q_i . k_j * scale) v_j over the keys j < Skv with
//   j <= i (causal) and j > i - window (window > 0),
// with scale 1/sqrt(D) from the wrapper. Sq differs from Skv only in a
// call with no mask at all (whisper's cross attention: the decoder's
// queries against the encoder's 1500 frames); a causal or windowed call
// has Sq == Skv, as the Pallas kernel has no query offset. The scale is
// that of the true head dim: D is never padded here, and q is never
// rescaled. Running max m, sum l and the accumulator are f32. DV equals
// D, except for MLA's prefill (deepseek-v2: q/k 192 = 128 nope + 64 rope,
// v 128), whose pair the Pallas kernel cannot take (its wrapper pads v
// with q's padding).
//
// Which body a call takes (the wrapper's flash_gqa.body picks by shape,
// with its split plan, and passes both to flash_gqa below):
//   wgmma  bf16 at (64, 64), (192, 128) and (256, 256), any mask and Sq:
//          whisper's encoder and its cross attention, smollm-135m's train
//          path, MLA's prefill (deepseek-v2-lite), recurrentgemma-9b's
//          local attention; with no mask it splits Skv for the blocks
//          past its last full wave (at Sq <= 16 it beat the split body
//          on an H100: 0.0092-0.0096 ms against 0.0102-0.0206 at
//          whisper's decode shapes, launch/bench_flash.py);
//   split  any other call with no mask, Sq <= FS_MAX_SQ (16), H <=
//          FS_MAX_H and Skv <= FS_MAX_CH * FS_MAX_SPLITS: whisper's cross
//          attention at a decode step in f32;
//   mma    bf16 at (16, 16), (32, 32) and (128, 128) (glm4-9b's prefill);
//   fma    f32 at every pair.
//
// Shared by the tiled bodies (fma, mma, wgmma). The TPU grid's
// sequential kv axis is a loop inside one block, with m, l and the
// accumulator in registers for the block's query rows. Blocks are
// numbered so that the last query tiles, which see the most keys under
// the causal mask, start first (with no mask every tile has the same work
// and the order does not matter), and consecutive blocks share a kv head,
// whose tiles then come from L2. The head repeat of the reference wrapper
// is never built: a block reads its kv head through kv_head, which is
// irregular when heads are padded (smollm-135m's padded query heads read
// kv head 0), so no h / rep is assumed. Only the kv tiles that hold an
// unmasked key for some row of the block are visited: those wholly above
// the diagonal or wholly before the window are skipped, which leaves m, l
// and the accumulator exactly as a fully masked tile would. Masked scores
// are -inf, and a row whose keys are all masked so far keeps m = -inf, l
// = 0 and a zero accumulator (the reference's -1e30 gives the same output
// once the row meets an unmasked key, which every row does: its own
// position, or with no mask any key). Query rows past Sq and keys past
// Skv are zero-filled on load; keys past Skv are masked, and rows past Sq
// are never stored.
//
// fma body (flash_gqa_fwd): f32 FMA from shared memory, as the tests hold
// f32 to 2e-5, which TF32 (about three digits) cannot meet. A block of 128
// threads per (b, h, 64 query rows, DVB output columns), DVB = DV up to
// 128; at DV = 256 each block computes one 128-column half of O and
// recomputes S = Q.K^T in full, so a pair costs 2 * 2 * 256 FLOP of S and
// 2 * 2 * 128 of P.V: 1.5 times the function's 2 * (256 + 256). K^T and
// V by plain loads (K transposed on the way), each thread a 4x8 score
// tile and a 4 x DVB/8 output tile, P through shared memory; 98 KB, two
// blocks an SM at D = 128; 134 KB, one block an SM, at (192, 128); 164 KB
// at (256, 256).
//
// mma body (flash_gqa_fwd_mma, bf16 at D <= 128): FA2-style on the tensor
// cores, a block of 128 threads per (b, h, 64 query rows); each of the 4
// warps owns 16 query rows. Per kv tile of 64 rows:
//   1. S = Q.K^T by mma.sync.m16n8k16 bf16 -> f32: Q's A fragments are
//      loaded once by ldmatrix and kept in registers (D/4 registers), K's
//      B fragments by ldmatrix from the tile in shared memory;
//   2. mask, online softmax in the log2 domain (scale * log2 e folded into
//      one multiply, exp2f); the row max is shared by the 4 threads of a
//      quad (two shuffles), l is kept per thread and summed once at the
//      end, from the f32 probabilities;
//   3. O += P.V by mma.sync.m16n8k16: the accumulator fragment of S is the
//      A fragment of P once rounded to bf16 (no trip through shared
//      memory); V's B fragments by ldmatrix.trans.
// K and V tiles come in by cp.async (16 bytes a thread, zero-filled past
// Skv) into a ring of two stages: tile t+1 loads while tile t is
// computed, one __syncthreads a tile. Rows of shared memory are D + 8
// elements, so the 8 rows an ldmatrix reads fall in distinct banks.
// Shared memory: ((64 + 2 * 64) * (D + 8) + 2 * 64 * (DV + 8)) * 2 bytes,
// 87,040 at D = DV = 128: two blocks an SM.
//
// wgmma body (flash_gqa_fwd_wgmma<D, DV>, bf16 at (64, 64), (192, 128)
// and (256, 256)): FA3's shape on wgmma with TMA. A block of 256 threads
// takes an item, 128 query rows of one (b, h): consumer warpgroup c (4
// warps) owns rows q0 + 64 c .. + 63.
//   - Q [128 x D] comes once by TMA (a 4-D map (column, head, row, batch),
//     boxes of 64 columns x 128 rows, 128-byte swizzle, zeros past Sq); K
//     and V tiles of BK rows the same way into rings of two stages, K and
//     V each with a full and an empty mbarrier a stage.
//   - S = Q.K^T once for each (64-row group, kv tile): D / 16 wgmma
//     m64nBKk16 with both operands in shared memory (K-major, descriptors
//     of the 128-byte swizzle), into BK / 2 f32 registers a thread.
//   - Softmax on the accumulator fragments in the log2 domain: p =
//     2^(s c - m c), c = scale * log2 e, one FFMA and one ex2.approx a
//     score; masks only on the tiles that need them, as a range of
//     columns a row (two compares a score).
//   - O += P.V by BK / 16 wgmma m64nDVk16: P rounded to bf16 stays in
//     registers as the A operand (the fragment layout of S's
//     accumulator), V [BK x DV] from shared memory, MN-major through the
//     transpose bit. O [64 x DV] f32 is DV / 2 registers a thread.
//   - Per tile i, S of tile i + 1 is issued before P.V of tile i, and the
//     softmax of tile i + 1 runs while P.V of tile i does (FA3's overlap
//     within a warpgroup); the two warpgroups overlap each other too. O is
//     rescaled only while no product is in flight, and the last tile's
//     P.V is peeled off the loop: with a branch or an O update between a
//     product and its wait, ptxas serialized every wgmma (its C7515 note,
//     at every pair; PERF.md has the times with and without).
//   - Each warpgroup has its own diagonal (its rows end 64 apart): the
//     block loads the union of the two ranges of tiles, and a warpgroup
//     waits for and releases a tile it does not compute, so the rings
//     stay in step; the window's first tiles differ the same way.
//   - Thread 0 issues every TMA load: Q and the first two tiles first,
//     then tile j + 2's K (V) into tile j's stage once both warpgroups
//     have released tile j's K (V). There is no producer warp: with one
//     beside the consumers (288 or 384 threads) ptxas allocates at most
//     168 registers a thread at (256, 256), and spills O, S and P; at
//     (64, 64) two blocks of 288 threads an SM would leave 113 registers
//     a thread, under the 118 the body uses. The
//     warpgroup index goes through a shuffle so that ptxas treats
//     branches on it as warp-uniform and does not serialize the products
//     (its C7518 note).
//   - O / l is rounded to bf16 and staged through the warpgroup's own
//     rows of the Q tile (16-byte chunks XOR-swizzled by row; D >= DV),
//     then stored 16 bytes a thread, rows of DV * 2 bytes.
//   Tile plans (FwTile), shared memory and ptxas registers (no spills):
//     (64, 64)    BK 64, two blocks an SM: 16 KB of Q + 2 x (8 + 8) KB of
//                 K and V, 50,248 bytes; 118 registers;
//     (192, 128)  BK 128, one block an SM: 48 KB of Q + 2 x (48 + 32) KB,
//                 214,088 bytes; 204 registers;
//     (256, 256)  BK 64, one block an SM: 64 KB of Q + 2 x (32 + 32) KB,
//                 197,704 bytes; 224 registers.
//   Timed and not kept (launch/bench_flash.py, before the loop was
//   peeled; PERF.md): at (64, 64) four stages, kv tiles of 128 rows (165
//   registers, one block an SM) and one block an SM were all within 3 %
//   of the plan above at the encoder; at (192, 128) kv tiles of 64 rows
//   (150 registers) were 6 % slower. Tried earlier at (256, 256) and
//   not kept either: the warpgroups taking turns at the tensor cores
//   by named barriers (slower), two heads that share a kv head packed
//   into a block (barely faster), rescaling O only when a row's max moved
//   (no faster).
//   Items and splits. Blocks run in waves of MINB an SM; whisper's
//   encoder (B = 4, 1500 rows, 6 heads) has 288 items for 264 places,
//   and its last 24 items ran alone after the first wave, which made it
//   half again as slow as the same items at a head count that fills one
//   wave exactly (PERF.md). In a call with no mask (the only kind whose
//   items all cost the same), the items past the last full wave, where
//   they fill at most half a wave, are split over Skv (the wrapper's
//   wgmma_split_plan decides which items and into how many splits, and
//   the launch takes both as given): each of their blocks takes a run of
//   whole kv tiles and writes the run's unnormalized (m, l, o) in f32, and
//   flash_gqa_merge_tiles adds each row's runs in order, with no atomics.
//   The encoder runs 264 items whole and 24 in 8 splits of 192 keys;
//   cross attention at the prefill (Sq = 64: 24 items) all in 8 splits.
//   Work at recurrentgemma-9b's prefill (B=4, S=512, 16 heads over 1,
//   causal): each 64-row group g = 0..7 of a head visits g + 1 tiles,
//   147,456 (query, key) pairs a head, so the body does 2 * (256 + 256) *
//   147,456 * 64 = 9.66 GFLOP: ops.work's 8.61 GFLOP plus the masked
//   halves of the 8 diagonal tiles. At MLA's prefill (BK 128) group g
//   visits g / 2 + 1 tiles: 163,840 pairs a head, 6.71 GFLOP for ops.work's
//   5.38.
//
// split body (flash_gqa_split + flash_gqa_merge, no mask, Sq <= 16, but
// bf16 at the wgmma body's pairs): at whisper's decode in f32 a tiled
// block would compute 64 query rows to use one, and B * H = 24 blocks
// would hold 132 SMs. Instead:
//   - first pass, grid (split, kv head, b): a block of 128 threads takes
//     ceil(Skv / n_split) <= 128 keys of its kv head and every query row
//     (i, h) whose head maps to it (up to 16 rows a pass), so it reads its
//     K and V rows once for all of those heads. Scores in f32 (a thread a
//     key), the chunk's max and sum by warp reductions, and P.V over the
//     V rows that cp.async brought to shared memory while the scores ran
//     (keys split over 4 thread groups at DV = 64, their sums added in a
//     fixed order); it writes the chunk's unnormalized (m, l, o) in f32 to
//     scratch that the wrapper allocates;
//   - second pass: each output element merges its row's n_split partials
//     in split order, with no atomics, so the same inputs give the same
//     bits every run, and writes o in the call's dtype.
//   The wrapper picks n_split for about two first-pass blocks an SM:
//   whisper's decode (B = 4, 6 heads over 6, Skv = 1500) has 12 splits of
//   125 keys, 288 blocks. The call is bound by its bytes (k and v read
//   once, 18.4 MB in f32 at that shape); its time is mostly the two
//   launches' fixed cost.
//
// Bounds (ops.work: the pairs the masks leave, each input read once and
// each output written once). The dense serve path's shape (B=4, S=512,
// H=32, Hkv=2, D=128, causal) needs, over the causal triangle (512*513/2 =
// 131,328 pairs a head), 2 products of 2*128 FLOP a pair for 128 (b, h):
// 8.61 GFLOP; it moves q and o (33.6 MB in bf16) and k and v (2.1 MB). In
// bf16 that is 0.0107 ms of memory at 3.35 TB/s (8.61 GFLOP take 0.0087 ms
// at 989 TFLOP/s); in f32 0.129 ms of f32 FMA at 67 TFLOP/s, above its
// 0.021 ms of memory. MLA prefill (deepseek-v2-lite: B=4, S=512, H=Hkv=16,
// D=192, DV=128, causal): 5.38 GFLOP; 41.9 MB in bf16, 0.0125 ms at 3.35
// TB/s, against 0.0054 ms for the FLOP. recurrentgemma-9b prefill (B=4,
// S=512, 16 heads over 1, D = DV = 256, causal): 8.61 GFLOP, 0.0087 ms at
// 989 TFLOP/s, under its 35.7 MB of q, k, v and o (0.0107 ms); at 4096
// tokens with its window of 2048, 103.1 GFLOP, 0.1042 ms, bound by
// operations. whisper-tiny's encoder (B=4, S=1500, 6 heads of 64, no
// mask): 13.8 GFLOP, 0.0140 ms at 989 TFLOP/s, over its 18.4 MB (0.0055
// ms); its cross attention (64 queries against 1500 frames): bound by
// the 9.2 MB of k and v, 0.0029 ms. smollm-135m's train shape (B=4,
// S=512, 16 padded heads over 4 of 64, causal): 2.15 GFLOP (0.0022 ms)
// under its 10.5 MB (0.0031 ms).
// ptxas (-Xptxas=-v, sm_90a): registers, shared memory and spills of each
// instantiation are printed by chip_smoke.py. Times: PERF.md.
// Left to do: glm4-9b's (128, 128) on the wgmma body (the mma body's
// 0.063 ms is 2x cuDNN's time); a persistent wgmma body whose next item's
// loads overlap this one's epilogue; K and V tiles multicast to the
// blocks of heads that share them; the split body's two passes in one
// launch; at Sq <= 16 a wgmma tile of fewer query rows (its kv split
// computes 128 rows a block to use one at whisper's decode).
//
// Limits: (D, DV) in {(16, 16), (32, 32), (64, 64), (128, 128), (192,
// 128), (256, 256)}; Sq, Skv >= 1; Sq == Skv unless causal == 0 and
// window == 0; every kv_head[h] in [0, Hkv) (the wrapper checks the map).
// Anything else is cudaErrorInvalidValue.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

#define FA_THREADS 128
#define FA_BQ 64                    // query rows a block
#define FA_BK 64                    // kv rows a tile
#define FA_LDK (FA_BK + 4)          // row of K^T and of P in shared memory
#define FA_MAX_D 256
#define FA_DVB 128                  // output columns a block, at most

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// VEC consecutive floats of shared memory (VEC = 2 or 4, aligned)
template <int VEC>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  }
}

// VEC consecutive outputs
template <int VEC>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
// the output columns a block computes: all of DV up to FA_DVB, else one
// FA_DVB-column slice (DV a multiple of it)
template <int DV>
__host__ __device__ constexpr int dv_block() {
  return DV > FA_DVB ? FA_DVB : DV;
}

static inline size_t smem_bytes(int D, int DVB) {
  const int kt_rows = D > FA_BQ ? D : FA_BQ;   // K^T [D][..], then P [64][..]
  return ((size_t)D * FA_BQ + (size_t)kt_rows * FA_LDK
          + (size_t)FA_BK * DVB) * sizeof(float);
}

// The block's place in the grid: query tile qt (the last first), (b, h),
// and the first output column vc0 of its slice of DV; the slices of one
// (b, h, qt) are consecutive blocks.
struct Tile {
  int qt, b, h, vc0;
};
template <int DV>
__device__ __forceinline__ Tile tile_of(int Sq, int H, int BH) {
  constexpr int NSL = DV / dv_block<DV>();      // slices of the output
  const int n_qt = (Sq + FA_BQ - 1) / FA_BQ;
  const int x = (int)(blockIdx.x / NSL);
  const int bh = x % BH;
  return {n_qt - 1 - x / BH, bh / H, bh % H,
          (int)(blockIdx.x % NSL) * dv_block<DV>()};
}

template <int D, int DV>
__global__ void __launch_bounds__(FA_THREADS, 2)
flash_gqa_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ kv_head,
              float* __restrict__ o, int Sq, int Skv, int H, int Hkv, int BH,
              int causal, int window, float scale) {
  constexpr int DVB = dv_block<DV>();           // output columns a block
  constexpr int VEC = DVB >= 32 ? 4 : 2;        // output columns a chunk
  constexpr int NCH = DVB / (8 * VEC);          // chunks a thread owns
  constexpr int DO = VEC * NCH;                 // output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                             // [D][FA_BQ]
  float* Kt = Qt + D * FA_BQ;                   // [D][FA_LDK], then P
  float* Vs = Kt + (D > FA_BQ ? D : FA_BQ) * FA_LDK;   // [FA_BK][DVB]

  const Tile tl = tile_of<DV>(Sq, H, BH);
  const int h = tl.h, b = tl.b;
  const int hk = kv_head[h];
  const int q0 = tl.qt * FA_BQ;
  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;

  const int64_t qs = (int64_t)H * D, ks = (int64_t)Hkv * D;   // row strides
  const int64_t vs = (int64_t)Hkv * DV;
  const float* qb = q + ((int64_t)b * Sq * H + h) * D;
  const float* kb = k + ((int64_t)b * Skv * Hkv + hk) * D;
  const float* vb = v + ((int64_t)b * Skv * Hkv + hk) * DV + tl.vc0;

  // Q^T, rows fastest across threads (conflict-free transposed stores)
  for (int e = tid; e < FA_BQ * (D / 4); e += FA_THREADS) {
    const int r = e % FA_BQ, d = (e / FA_BQ) * 4;
    const float4 t = q0 + r < Sq ? load4(qb + (q0 + r) * qs + d)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    Qt[(d + 0) * FA_BQ + r] = t.x;
    Qt[(d + 1) * FA_BQ + r] = t.y;
    Qt[(d + 2) * FA_BQ + r] = t.z;
    Qt[(d + 3) * FA_BQ + r] = t.w;
  }

  float m[4], l[4], acc[4][DO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DO; ++c) acc[i][c] = 0.f;
  }

  // the kv tiles holding an unmasked key for some row q0..q_end-1
  // (causal and window imply Sq == Skv)
  const int q_end = min(Sq, q0 + FA_BQ);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_end : Skv;                     // exclusive
  for (int kt = k_lo / FA_BK; kt <= (k_hi - 1) / FA_BK; ++kt) {
    const int k0 = kt * FA_BK;
    __syncthreads();            // the previous tile's P and V are consumed
    for (int e = tid; e < FA_BK * (D / 4); e += FA_THREADS) {
      const int r = e % FA_BK, d = (e / FA_BK) * 4;
      const float4 t = k0 + r < Skv ? load4(kb + (k0 + r) * ks + d)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      Kt[(d + 0) * FA_LDK + r] = t.x;
      Kt[(d + 1) * FA_LDK + r] = t.y;
      Kt[(d + 2) * FA_LDK + r] = t.z;
      Kt[(d + 3) * FA_LDK + r] = t.w;
    }
    for (int e = tid; e < FA_BK * (DVB / 4); e += FA_THREADS) {
      const int r = e / (DVB / 4), d = (e % (DVB / 4)) * 4;
      const float4 t = k0 + r < Skv ? load4(vb + (k0 + r) * vs + d)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(Vs + r * DVB + d) = t;
    }
    __syncthreads();

    // 2. scores of rows 4*rg+i against columns 4*cg + 32*j + e
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + d * FA_BQ
                                                         + rg * 4);
      const float4 k0v = *reinterpret_cast<const float4*>(Kt + d * FA_LDK
                                                          + cg * 4);
      const float4 k1v = *reinterpret_cast<const float4*>(Kt + d * FA_LDK
                                                          + 32 + cg * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[8] = {k0v.x, k0v.y, k0v.z, k0v.w,
                           k1v.x, k1v.y, k1v.z, k1v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[i][c] = fmaf(qa[i], ka[c], s[i][c]);
    }

    // 3. mask, online softmax over the row group's 8 threads
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int kpos = k0 + cg * 4 + (c >> 2) * 32 + (c & 3);
        const bool ok = kpos < Skv && (!causal || kpos <= qpos)
                        && (window <= 0 || kpos > qpos - window);
        s[i][c] = ok ? s[i][c] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      // no unmasked key for this row yet: nothing changes
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[i][c] = s[i][c] == -INFINITY ? 0.f : expf(s[i][c] - m_new);
        sum += s[i][c];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DO; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();            // every read of K^T is done
    float* P = Kt;              // P [FA_BQ][FA_LDK] over K^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<float4*>(P + (rg * 4 + i) * FA_LDK + j * 32
                                   + cg * 4) =
            make_float4(s[i][4 * j], s[i][4 * j + 1], s[i][4 * j + 2],
                        s[i][4 * j + 3]);
    __syncthreads();

    // 4. O += P.V: rows 4*rg+i, columns cg*VEC + 8*VEC*jj + e
#pragma unroll 2
    for (int kk = 0; kk < FA_BK; kk += 4) {
      float pa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(
            P + (rg * 4 + i) * FA_LDK + kk);
        pa[i][0] = t.x; pa[i][1] = t.y; pa[i][2] = t.z; pa[i][3] = t.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[DO];
#pragma unroll
        for (int jj = 0; jj < NCH; ++jj)
          lds<VEC>(Vs + (kk + e) * DVB + cg * VEC + 8 * VEC * jj,
                   vv + jj * VEC);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DO; ++c)
            acc[i][c] = fmaf(pa[i][e], vv[c], acc[i][c]);
      }
    }
  }

  // o = acc / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + (((int64_t)b * Sq + r) * H + h) * DV + tl.vc0;
#pragma unroll
    for (int jj = 0; jj < NCH; ++jj) {
      float w[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) w[e] = acc[i][jj * VEC + e] / den;
      store<VEC>(orow + cg * VEC + 8 * VEC * jj, w);
    }
  }
}

// ------------------------------------------------------------ bf16 body
#define FM_LD(D) ((D) + 8)          // row of Q, K and V in shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zeros where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a.b, a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows row0.. row0+63 of a [S, stride] bf16 array into a tile [64][LD]
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* base,
                                          int64_t stride, int row0, int S,
                                          int tid) {
  constexpr int CH = D / 8;                     // 16-byte chunks a row
  for (int e = tid; e < FA_BK * CH; e += FA_THREADS) {
    const int r = e / CH, c = (e % CH) * 8;
    const bool ok = row0 + r < S;
    cp_async16(smem_addr(tile + r * FM_LD(D) + c),
               base + (ok ? (int64_t)(row0 + r) * stride + c : 0), ok);
  }
}

static inline size_t smem_bytes_mma(int D, int DVB) {
  return ((size_t)(FA_BQ + 2 * FA_BK) * FM_LD(D)
          + (size_t)2 * FA_BK * FM_LD(DVB)) * sizeof(__nv_bfloat16);
}

template <int D, int DV>
__global__ void __launch_bounds__(FA_THREADS, 2)
flash_gqa_fwd_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ kv_head,
                  __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H,
                  int Hkv, int BH, int causal, int window,
                  float scale_log2) {
  constexpr int DVB = dv_block<DV>();           // output columns a block
  constexpr int LD = FM_LD(D), LDV = FM_LD(DVB);
  constexpr int KS = D / 16;                    // k-steps of Q.K^T
  constexpr int NO = DVB / 8;                   // n-tiles of O
  constexpr int NS = FA_BK / 8;                 // n-tiles of S
  static_assert(D <= 128, "Q's fragments stay in registers");
  extern __shared__ __align__(16) __nv_bfloat16 smb[];
  __nv_bfloat16* Qs = smb;                      // [64][LD]
  __nv_bfloat16* Ks = Qs + FA_BQ * LD;          // [2][64][LD]
  __nv_bfloat16* Vs = Ks + 2 * FA_BK * LD;      // [2][64][LDV]

  const Tile tl = tile_of<DV>(Sq, H, BH);
  const int h = tl.h, b = tl.b;
  const int hk = kv_head[h];
  const int q0 = tl.qt * FA_BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;        // fragment row, column pair

  const int64_t qs = (int64_t)H * D, ks = (int64_t)Hkv * D;   // row strides
  const int64_t vs = (int64_t)Hkv * DV;
  const __nv_bfloat16* qb = q + ((int64_t)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((int64_t)b * Skv * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((int64_t)b * Skv * Hkv + hk) * DV + tl.vc0;

  // the kv tiles holding an unmasked key for some row q0..q_end-1
  // (causal and window imply Sq == Skv)
  const int q_end = min(Sq, q0 + FA_BQ);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_end : Skv;                     // exclusive
  const int kt0 = k_lo / FA_BK, n_kt = (k_hi - 1) / FA_BK - kt0 + 1;

  load_tile<D>(Qs, qb, qs, q0, Sq, tid);
  load_tile<D>(Ks, kb, ks, kt0 * FA_BK, Skv, tid);
  load_tile<DVB>(Vs, vb, vs, kt0 * FA_BK, Skv, tid);
  cp_async_commit();

  // rows of this thread: r0 (fragment rows 0-7) and r0 + 8
  const int r0 = q0 + warp * 16 + g;
  uint32_t qf[KS][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    cp_async_wait_all();
    __syncthreads();            // tile it landed; stage (it+1)&1 is free
    if (it + 1 < n_kt) {
      const int st = (it + 1) & 1, row0 = (kt0 + it + 1) * FA_BK;
      load_tile<D>(Ks + st * FA_BK * LD, kb, ks, row0, Skv, tid);
      load_tile<DVB>(Vs + st * FA_BK * LDV, vb, vs, row0, Skv, tid);
    }
    cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], smem_addr(Qs + (warp * 16 + (lane & 15)) * LD
                                  + kk * 16 + (lane >> 4) * 8));
    }
    const __nv_bfloat16* Kt = Ks + (it & 1) * FA_BK * LD;
    const __nv_bfloat16* Vt = Vs + (it & 1) * FA_BK * LDV;
    const int k0 = (kt0 + it) * FA_BK;

    // 1. S = Q.K^T
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t* qa = qf[kk];
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t kf[4];
        ldsm_x4(kf, smem_addr(Kt + (n * 8 + ((lane >> 4) << 3) + (lane & 7))
                                       * LD
                              + kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[n], qa, kf[0], kf[1]);
        mma_bf16(s[n + 1], qa, kf[2], kf[3]);
      }
    }

    // 2. mask, online softmax (log2 domain)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = r0 + (e >> 1) * 8;
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        const bool ok = kpos < Skv && (!causal || kpos <= qpos)
                        && (window <= 0 || kpos > qpos - window);
        s[n][e] = ok ? s[n][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // no unmasked key for this row yet: nothing changes
      alpha[i] = m_new == -INFINITY ? 1.f : exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        s[n][e] = s[n][e] == -INFINITY ? 0.f : exp2f(s[n][e] - m[i]);
        l[i] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }

    // 3. O += P.V, P rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < FA_BK / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vf[4];
        ldsm_x4_t(vf, smem_addr(Vt + (kk * 16 + ((lane >> 3) & 1) * 8
                                      + (lane & 7)) * LDV
                                + n * 8 + (lane >> 4) * 8));
        mma_bf16(acc[n], pf, vf[0], vf[1]);
        mma_bf16(acc[n + 1], pf, vf[2], vf[3]);
      }
    }
  }

  // o = acc / max(l, 1e-30), rounded to bf16 once
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r0 + i * 8;
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = o + (((int64_t)b * Sq + r) * H + h) * DV + tl.vc0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

// ------------------------- bf16 wgmma body: (64, 64), (192, 128), (256, 256)
#define FW_BQ 128                   // query rows a block: 2 consumers x 64
#define FW_THREADS 256              // 2 consumer warpgroups
#define FW_BOX 64                   // columns a TMA box (128 bytes)
#define FW_Q_BOX (FW_BQ * FW_BOX * 2)         // 16,384 bytes
#define FW_ST 2                     // stages of the K and V rings

// Each pair's tile plan: kv rows a tile, blocks an SM (the launch bound:
// 2 caps ptxas at 128 registers)
template <int D, int DV>
struct FwTile;
template <>
struct FwTile<64, 64> { static constexpr int BK = 64, MINB = 2; };
template <>
struct FwTile<192, 128> { static constexpr int BK = 128, MINB = 1; };
template <>
struct FwTile<256, 256> { static constexpr int BK = 64, MINB = 1; };

// shared memory and mbarriers of a pair: Q (D / 64 boxes of [128][64]),
// then FW_ST stages of K (D / 64 boxes of [BK][64]) and of V (DV / 64),
// then the mbarriers: Q full, and K full, V full, K empty, V empty a stage
template <int D, int DV>
struct Fw : FwTile<D, DV> {
  using FwTile<D, DV>::BK;
  static constexpr int KV_BOX = BK * FW_BOX * 2;
  static constexpr int Q_BYTES = D / FW_BOX * FW_Q_BOX;
  static constexpr int K_BYTES = D / FW_BOX * KV_BOX;     // one stage
  static constexpr int V_BYTES = DV / FW_BOX * KV_BOX;
  static constexpr int BAR_OFF = Q_BYTES + FW_ST * (K_BYTES + V_BYTES);
  // slack to align to the swizzle's 1024-byte period, the tiles, barriers
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 4 * FW_ST);
};

// the kv tiles [lo, hi] of BK rows holding an unmasked key for some query
// row of [qa, qa + 64) and lying in [t_lo, t_hi] (the block's split);
// empty (hi < lo) where the rows start past Sq
struct KvTiles {
  int lo, hi;
};
template <int BK>
__device__ __forceinline__ KvTiles kv_tiles(int qa, int Sq, int Skv,
                                            int causal, int window, int t_lo,
                                            int t_hi) {
  if (qa >= Sq) return {0, -1};
  const int qb = min(Sq, qa + 64);
  const int k_lo = window > 0 ? max(0, qa - window + 1) : 0;
  const int k_hi = causal ? qb : Skv;                        // exclusive
  return {max(k_lo / BK, t_lo), min((k_hi - 1) / BK, t_hi)};
}

// S = Q.K^T of one kv tile of BK rows for this warpgroup's 64 rows: D / 16
// k-steps of m64nBKk16, both operands in shared memory (K-major); issued,
// not waited
template <int D, int BK>
__device__ __forceinline__ void qk_issue(float (&s)[BK / 2], uint32_t qrows,
                                         uint32_t kb) {
  constexpr int KV_BOX = BK * FW_BOX * 2;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(s,
             sw128_desc(qrows + (kk >> 2) * FW_Q_BOX + (kk & 3) * 32, 16,
                        1024),
             sw128_desc(kb + (kk >> 2) * KV_BOX + (kk & 3) * 32, 16, 1024),
             kk > 0);
  wgmma_commit();
}

// O += P.V of one kv tile of BK rows: P (bf16, the A fragments of S's
// accumulator) from registers, V [BK x DV] from shared memory, MN-major
// through the transpose bit (lbo: the bytes between its 64-column boxes);
// issued, not waited
template <int BK, int N>
__device__ __forceinline__ void pv_issue(float (&acc)[N],
                                         const uint32_t (&pf)[BK / 16][4],
                                         uint32_t vb) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs_tb(acc, pf[kk],
                sw128_desc(vb + kk * 16 * 128, BK * FW_BOX * 2, 1024), 1);
  wgmma_commit();
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Items are (b, h, query tile): item x has (b, h) = x % BH and query tile
// n_qt - 1 - x / BH (the last, longest under the causal mask, first;
// consecutive items share kv heads). Blocks 0 .. whole - 1 take items 0 ..
// whole - 1 whole and write o in bf16. Above whole (only a call with no
// mask has any), block whole + n_split j + sp takes kv split sp (kv tiles
// sp * split_tiles .. + split_tiles - 1) of item whole + j and writes its
// unnormalized (m, l, o) in f32 to po and pml at slot (j * FW_BQ + row of
// the tile) * n_split + sp, which flash_gqa_merge_tiles adds up.
template <int D, int DV>
__global__ void __launch_bounds__(FW_THREADS, FwTile<D, DV>::MINB)
flash_gqa_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const int* __restrict__ kv_head,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ po,
                    float* __restrict__ pml, int Sq, int Skv, int H, int BH,
                    int causal, int window, float scale_log2, int whole,
                    int n_split, int split_tiles) {
  using C = Fw<D, DV>;
  constexpr int BK = C::BK, ST = FW_ST;
  constexpr int NS = BK / 2, NO = DV / 2;          // S and O floats a thread
  extern __shared__ __align__(16) uint8_t fw_raw[];
  const uint32_t raw = smem_u32(fw_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;    // the swizzle's period
  uint8_t* gbase = fw_raw + (base - raw);          // generic address of base
  const uint32_t sQ = base;
  const uint32_t sK = sQ + C::Q_BYTES;             // ST stages of K
  const uint32_t sV = sK + ST * C::K_BYTES;        // ST stages of V
  const uint32_t q_full = base + C::BAR_OFF;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * ST;
  const uint32_t k_empty = v_full + 8 * ST, v_empty = k_empty + 8 * ST;

  // the block's item and kv split
  const int x = (int)blockIdx.x;
  const bool split = x >= whole;
  const int item = split ? whole + (x - whole) / n_split : x;
  const int sp = split ? (x - whole) % n_split : 0;
  const int n_qt = (Sq + FW_BQ - 1) / FW_BQ;
  const int bh = item % BH, b = bh / H, h = bh % H;
  const int q0 = (n_qt - 1 - item / BH) * FW_BQ;
  const int hk = kv_head[h];
  const int t_lo = sp * split_tiles;
  const int t_hi = split ? t_lo + split_tiles - 1 : 0x7fffffff;
  const KvTiles t1 = kv_tiles<BK>(q0, Sq, Skv, causal, window, t_lo, t_hi);
  const KvTiles t2 = kv_tiles<BK>(q0 + 64, Sq, Skv, causal, window, t_lo,
                                  t_hi);
  const int lo = t1.lo, hi = max(t1.hi, t2.hi), n_kt = hi - lo + 1;

  // the warpgroup index through a shuffle, so that ptxas sees every
  // branch on it as warp-uniform and keeps the products unserialized
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);        // every warp arrives
      mbar_init(v_empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // ---- consumers: warpgroup cw owns query rows qa .. qa + 63
  const int cw = wg, ct = tid - 128 * wg;
  const int warp = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;          // fragment row, column pair
  const int qa = q0 + cw * 64;
  const KvTiles mine = cw == 0 ? t1 : t2;
  const int r0 = qa + warp * 16 + g;              // rows r0 and r0 + 8
  const int q_end = min(Sq, qa + 64);
  const uint32_t qrows = sQ + cw * (FW_Q_BOX / 2);   // in each Q box
  // the block's tiles ia .. ib (of 0 .. n_kt - 1) are this warpgroup's
  const bool any = mine.hi >= mine.lo;
  const int ia = any ? mine.lo - lo : n_kt, ib = any ? mine.hi - lo : -1;
  // tile i's stage is i % ST, in its (i / ST)-th use; a warp releases a
  // stage once its last product that reads it is done
  auto wait_k = [&](int i) {
    mbar_wait(k_full + 8 * (i % ST), (i / ST) & 1);
  };
  auto wait_v = [&](int i) {
    mbar_wait(v_full + 8 * (i % ST), (i / ST) & 1);
  };
  // Thread 0 loads: Q and the first ST tiles first; tile j + ST's K (V)
  // into tile j's stage once it has released tile j's K (V) itself and the
  // other warpgroup has too (no producer warp: the note above says why)
  const bool loader = tid == 0;
  auto load = [&](uint32_t ring, int bytes, int boxes, uint32_t full,
                  uint32_t empty, const CUtensorMap* map, int j) {
    if (j >= n_kt) return;
    const int st = j % ST;
    mbar_wait(empty + 8 * st, ((j / ST) & 1) ^ 1);     // stage read by all
    mbar_expect_tx(full + 8 * st, bytes);
    for (int c = 0; c < boxes; ++c)
      tma_load_4d(ring + st * bytes + c * C::KV_BOX, map, full + 8 * st,
                  c * FW_BOX, hk, (lo + j) * BK, b);
  };
  auto load_k = [&](int j) {
    load(sK, C::K_BYTES, D / FW_BOX, k_full, k_empty, &tk, j);
  };
  auto load_v = [&](int j) {
    load(sV, C::V_BYTES, DV / FW_BOX, v_full, v_empty, &tv, j);
  };
  auto free_k = [&](int i) {
    if (lane == 0) mbar_arrive(k_empty + 8 * (i % ST));
    if (loader) load_k(i + ST);
  };
  auto free_v = [&](int i) {
    if (lane == 0) mbar_arrive(v_empty + 8 * (i % ST));
    if (loader) load_v(i + ST);
  };
  if (loader) {
    mbar_expect_tx(q_full, C::Q_BYTES);
    for (int c = 0; c < D / FW_BOX; ++c)
      tma_load_4d(sQ + c * FW_Q_BOX, &tq, q_full, c * FW_BOX, h, q0, b);
    for (int j = 0; j < ST; ++j) {
      load_k(j);
      load_v(j);
    }
  }

  float acc[NO];                  // O [64 x DV]: DV / 8 n-tiles of 8 x 4
  float s[NS];                    // S [64 x BK]: BK / 8 n-tiles of 8 x 4
  uint32_t pf[BK / 16][4];        // P in bf16: the A fragments of P.V
#pragma unroll
  for (int e = 0; e < NO; ++e) acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < NS; ++e) s[e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float alpha[2] = {1.f, 1.f};
  mbar_wait(q_full, 0);

  // mask (only where tile i needs it) and online softmax of tile i's S in
  // the log2 domain: p = 2^(s c - m c), c = scale * log2 e, m the raw row
  // max; alpha rescales O
  auto softmax = [&](int i) {
    const int k0 = (lo + i) * BK;
    const bool masked = k0 + BK > Skv
                        || (causal && k0 + BK - 1 > qa)
                        || (window > 0 && k0 <= q_end - 1 - window);
    if (masked) {
      // element e holds key k0 + 2t + c, c = 8 (e >> 2) + (e & 1), of row
      // r0 + 8 ((e >> 1) & 1); the keys that count are c in [c_lo, c_hi)
      int c_lo[2], c_hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int d = r0 + 8 * r - k0 - 2 * t;       // qpos - (k0 + 2t)
        c_hi[r] = min(Skv - k0 - 2 * t, causal ? d + 1 : BK);
        c_lo[r] = window > 0 ? d - window + 1 : 0;
      }
#pragma unroll
      for (int e = 0; e < NS; ++e) {
        const int c = (e >> 2) * 8 + (e & 1), r = (e >> 1) & 1;
        if (c < c_lo[r] || c >= c_hi[r]) s[e] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY}, mc[2];
#pragma unroll
    for (int e = 0; e < NS; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // no unmasked key for this row yet: nothing changes
      alpha[r] = m_new == -INFINITY ? 1.f
                                    : ex2((m[r] - m_new) * scale_log2);
      mc[r] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      const int r = (e >> 1) & 1;
      s[e] = ex2(fmaf(s[e], scale_log2, -mc[r]));    // masked: 2^-inf = 0
      l[r] += s[e];
    }
  };
  auto pack_p = [&]() {           // P rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pf[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  // tiles of the block before this warpgroup's: released unread
  for (int i = 0; i < min(ia, n_kt); ++i) {
    wait_k(i); free_k(i); wait_v(i); free_v(i);
  }
  // O rescaled by the last softmax's alpha while no product is in flight
  auto rescale = [&]() {
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      acc[4 * n] *= alpha[0]; acc[4 * n + 1] *= alpha[0];
      acc[4 * n + 2] *= alpha[1]; acc[4 * n + 3] *= alpha[1];
    }
    fence_regs(acc);
  };
  if (any) {
    wait_k(ia);
    qk_issue<D, BK>(s, qrows, sK + (ia % ST) * C::K_BYTES);
    wgmma_wait<0>();
    fence_regs(s);
    free_k(ia);
    softmax(ia);
    rescale();
    pack_p();
    // Per tile i < ib (P of tile i in registers, O rescaled, nothing in
    // flight): S of tile i + 1 and then P.V of tile i go to the tensor
    // cores back to back; the softmax of tile i + 1 runs while P.V of tile
    // i does. The last tile's P.V is peeled off, so that no branch lies
    // between a product and its wait.
    for (int i = ia; i < ib; ++i) {
      wait_k(i + 1);
      qk_issue<D, BK>(s, qrows, sK + ((i + 1) % ST) * C::K_BYTES);
      wait_v(i);
      pv_issue<BK>(acc, pf, sV + (i % ST) * C::V_BYTES);
      wgmma_wait<1>();            // S of tile i + 1 (committed first)
      fence_regs(s);
      free_k(i + 1);
      softmax(i + 1);
      wgmma_wait<0>();            // P.V of tile i
      fence_regs(acc);
      free_v(i);
      rescale();
      pack_p();
    }
    wait_v(ib);
    pv_issue<BK>(acc, pf, sV + (ib % ST) * C::V_BYTES);
    wgmma_wait<0>();
    fence_regs(acc);
    free_v(ib);
  }
  // tiles of the block after this warpgroup's: released unread
  for (int i = max(ib + 1, ia); i < n_kt; ++i) {
    wait_k(i); free_k(i); wait_v(i); free_v(i);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (split) {
    // the split's partials: o unnormalized, m in the log2 domain, l
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= Sq) continue;
      const int64_t slot =
          ((int64_t)(item - whole) * FW_BQ + row - q0) * n_split + sp;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
        *reinterpret_cast<float2*>(po + slot * DV + 8 * n + 2 * t) =
            make_float2(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(pml + slot * 2) = make_float2(
            m[r] == -INFINITY ? -INFINITY : m[r] * scale_log2, l[r]);
    }
    return;
  }
  // o = acc / max(l, 1e-30), rounded to bf16 once, staged through this
  // warpgroup's rows of the Q tile (no longer read; D >= DV): row r of 128
  // bytes a box, 16-byte chunk c at c ^ (r & 7), then 16-byte coalesced
  // stores
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = 1.f / fmaxf(l[r], 1e-30f);
  uint8_t* stage = gbase + (qrows - base);
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;        // within the 64
      *reinterpret_cast<uint32_t*>(
          stage + (n >> 3) * FW_Q_BOX + row * 128
          + (((n & 7) ^ (row & 7)) << 4) + 4 * t) =
          pack_bf16(acc[4 * n + 2 * r] * l[r],
                    acc[4 * n + 2 * r + 1] * l[r]);
    }
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
  constexpr int CH = DV / 8;                        // 16-byte chunks a row
  for (int e = ct; e < 64 * CH; e += 128) {
    const int row = e / CH, c = e % CH;
    if (qa + row >= Sq) break;                      // rows ascend with e
    const uint4 val = *reinterpret_cast<const uint4*>(
        stage + (c >> 3) * FW_Q_BOX + row * 128
        + (((c & 7) ^ (row & 7)) << 4));
    *reinterpret_cast<uint4*>(
        o + (((int64_t)b * Sq + qa + row) * H + h) * DV + c * 8) = val;
  }
}

// ------------------------------------- split body: no mask, Sq <= 16
#define FS_THREADS 128
#define FS_RG 16                    // query rows a pass
#define FS_MAX_SQ 16                // Sq up to which a call may split
#define FS_MAX_CH 128               // keys a split, at most: one a thread
#define FS_MAX_SPLITS 128           // splits a call, at most
#define FS_MAX_H 256                // query heads, at most
#define FS_V_BYTES 32768            // V rows in shared memory, at most

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// 8 consecutive values (16-byte aligned) as f32
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 c = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = c.x; out[5] = c.y; out[6] = c.z; out[7] = c.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
// 2 consecutive values (aligned) as f32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// scores of the pass's first RG query rows (Qs, log2 domain) against keys
// c0 .. c0 + nk - 1 (nk <= FS_MAX_CH), a thread a key, into Ps
template <typename T, int D, int RG>
__device__ __forceinline__ void split_scores(float (*Qs)[D],
                                             float (*Ps)[FS_MAX_CH + 1],
                                             const T* kb, int64_t ks, int nk,
                                             int nr) {
  const int j = threadIdx.x;
  if (j < nk) {
    float s[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) s[r] = 0.f;
    const T* kr = kb + j * ks;
#pragma unroll 2
    for (int d = 0; d < D; d += 8) {
      float kv[8];
      load8(kr + d, kv);
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) s[r] = fmaf(Qs[r][d + e], kv[e], s[r]);
    }
#pragma unroll
    for (int r = 0; r < RG; ++r)
      if (r < nr) Ps[r][j] = s[r];
  }
}

// the keys of one V tile in shared memory: FS_V_BYTES at most
template <typename T, int DV>
__host__ __device__ constexpr int split_v_keys() {
  return FS_V_BYTES / (DV * (int)sizeof(T)) < FS_MAX_CH
             ? FS_V_BYTES / (DV * (int)sizeof(T)) : FS_MAX_CH;
}

// keys j0 .. j0 + nv - 1 of the chunk's V rows into Vs [nv][DV], by
// cp.async (16 bytes a thread), committed as one group
template <typename T, int DV>
__device__ __forceinline__ void split_load_v(T* Vs, const T* vb, int64_t vs,
                                             int j0, int nv) {
  constexpr int CPR = DV * (int)sizeof(T) / 16;     // 16-byte chunks a row
  for (int e = threadIdx.x; e < nv * CPR; e += FS_THREADS) {
    const int j = e / CPR, c = e % CPR;
    cp_async16(smem_addr(reinterpret_cast<uint4*>(Vs + j * DV) + c),
               reinterpret_cast<const uint4*>(vb + (j0 + j) * vs) + c, true);
  }
  cp_async_commit();
}

// P.V of the pass's first RG query rows over the split's keys: thread
// (ks, cp) sums columns 2 cp, 2 cp + 1 over the keys j = ks (mod KS) of
// each V tile, into Red[ks] (rows past nr are computed from stale P and
// never read)
template <typename T, int DV, int RG>
__device__ __forceinline__ void split_pv(float (*Ps)[FS_MAX_CH + 1],
                                         float (*Red)[FS_RG][DV], T* Vs,
                                         const T* vb, int64_t vs, int nk,
                                         int nr, int rg0) {
  constexpr int NCP = DV / 2, KS = FS_THREADS / NCP;
  constexpr int VT = split_v_keys<T, DV>();
  const int cp = threadIdx.x % NCP, ks = threadIdx.x / NCP;
  float a[RG][2];
#pragma unroll
  for (int r = 0; r < RG; ++r) a[r][0] = a[r][1] = 0.f;
  for (int j0 = 0; j0 < nk; j0 += VT) {
    const int nv = min(VT, nk - j0);
    // the first tile stays loaded for the next pass where it is all
    if (j0 > 0 || (rg0 > 0 && nk > VT)) {
      __syncthreads();          // the previous tile is consumed
      split_load_v<T, DV>(Vs, vb, vs, j0, nv);
    }
    cp_async_wait_all();
    __syncthreads();            // the tile, and P, ms and ls are in place
    for (int j = ks; j < nv; j += KS) {
      const float2 vv = load2(Vs + j * DV + 2 * cp);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const float p = Ps[r][j0 + j];
        a[r][0] = fmaf(p, vv.x, a[r][0]);
        a[r][1] = fmaf(p, vv.y, a[r][1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RG; ++r)
    if (r < nr)
      *reinterpret_cast<float2*>(&Red[ks][r][2 * cp]) =
          make_float2(a[r][0], a[r][1]);
}

// First pass: block (split, kv head, b) takes keys [c0, c0 + chunk) of
// its kv head and every query row (i, h) with kv_head[h] == that head, and
// writes each row's unnormalized partial (m, l, o) of the chunk, in f32:
// po [B*Sq*H, n_split, DV], pml [B*Sq*H, n_split, 2], row (b*Sq + i)*H + h.
// The chunk's first V tile loads (cp.async) while the scores are computed;
// a chunk of more keys than a V tile holds loads its later tiles in turn.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(FS_THREADS)
flash_gqa_split(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ kv_head,
                float* __restrict__ po, float* __restrict__ pml, int Sq,
                int Skv, int H, int Hkv, int n_split, int chunk,
                float scale_log2) {
  constexpr int VT = split_v_keys<T, DV>();
  __shared__ __align__(16) float Qs[FS_RG][D];
  __shared__ float Ps[FS_RG][FS_MAX_CH + 1];
  __shared__ int heads[FS_MAX_H];
  __shared__ float ms[FS_RG], ls[FS_RG];
  __shared__ __align__(16) float Red[FS_THREADS / (DV / 2)][FS_RG][DV];
  __shared__ int n_heads;
  extern __shared__ __align__(16) uint8_t fs_dyn[];
  T* Vs = reinterpret_cast<T*>(fs_dyn);             // [VT][DV]
  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int c0 = sp * chunk, nk = min(Skv, c0 + chunk) - c0;   // >= 1
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t ks = (int64_t)Hkv * D, vs = (int64_t)Hkv * DV;
  const T* kb = k + ((int64_t)b * Skv + c0) * ks + (int64_t)hk * D;
  const T* vb = v + ((int64_t)b * Skv + c0) * vs + (int64_t)hk * DV;
  split_load_v<T, DV>(Vs, vb, vs, 0, min(VT, nk));
  if (warp == 0) {              // the query heads of kv head hk, in order
    int n = 0;
    for (int h0 = 0; h0 < H; h0 += 32) {
      const bool mine = h0 + lane < H && kv_head[h0 + lane] == hk;
      const unsigned bits = __ballot_sync(0xffffffffu, mine);
      if (mine) heads[n + __popc(bits & ((1u << lane) - 1))] = h0 + lane;
      n += __popc(bits);
    }
    if (lane == 0) n_heads = n;
  }
  __syncthreads();
  const int R = n_heads * Sq;
  for (int rg0 = 0; rg0 < R; rg0 += FS_RG) {
    const int nr = min(FS_RG, R - rg0);
    for (int e = tid; e < nr * D; e += FS_THREADS) {
      const int r = e / D, d = e % D, rho = rg0 + r;
      const int h = heads[rho / Sq], i = rho % Sq;
      Qs[r][d] = to_f(q[(((int64_t)b * Sq + i) * H + h) * D + d])
                 * scale_log2;
    }
    __syncthreads();
    if (nr == 1)
      split_scores<T, D, 1>(Qs, Ps, kb, ks, nk, nr);
    else if (nr <= 4)
      split_scores<T, D, 4>(Qs, Ps, kb, ks, nk, nr);
    else
      split_scores<T, D, FS_RG>(Qs, Ps, kb, ks, nk, nr);
    __syncthreads();
    for (int r = warp; r < nr; r += FS_THREADS / 32) {
      float mx = -INFINITY;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, Ps[r][j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = exp2f(Ps[r][j] - mx);
        Ps[r][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        ms[r] = mx;
        ls[r] = sum;
      }
    }
    if (nr == 1)
      split_pv<T, DV, 1>(Ps, Red, Vs, vb, vs, nk, nr, rg0);
    else if (nr <= 4)
      split_pv<T, DV, 4>(Ps, Red, Vs, vb, vs, nk, nr, rg0);
    else
      split_pv<T, DV, FS_RG>(Ps, Red, Vs, vb, vs, nk, nr, rg0);
    __syncthreads();
    // the KS partial sums of each output, added in order (the same bits
    // every run), and the row's m and l
    constexpr int NCP = DV / 2, KS = FS_THREADS / NCP;
    for (int e = tid; e < nr * NCP; e += FS_THREADS) {
      const int r = e / NCP, c = e % NCP;
      float2 sum = make_float2(0.f, 0.f);
#pragma unroll
      for (int x = 0; x < KS; ++x) {
        const float2 part =
            *reinterpret_cast<const float2*>(&Red[x][r][2 * c]);
        sum.x += part.x;
        sum.y += part.y;
      }
      const int rho = rg0 + r, h = heads[rho / Sq], i = rho % Sq;
      const int64_t row = ((int64_t)b * Sq + i) * H + h;
      *reinterpret_cast<float2*>(po + (row * n_split + sp) * DV + 2 * c) = sum;
      if (c == 0)
        *reinterpret_cast<float2*>(pml + (row * n_split + sp) * 2) =
            make_float2(ms[r], ls[r]);
    }
    __syncthreads();            // Qs, Ps, Red, ms and ls are free
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Column d of partial row `row`'s n_split splits (po [rows, n_split, DV],
// pml [rows, n_split, 2]: unnormalized o, m in the log2 domain, l) merged
// in split order (no atomics: the same bits every run)
template <int DV>
__device__ __forceinline__ float merge_splits(const float* po,
                                              const float* pml, int64_t row,
                                              int d, int n_split) {
  const float* ml = pml + row * n_split * 2;
  float mx = -INFINITY;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml[2 * s]);
  float l = 0.f, acc = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const float w = ml[2 * s] == -INFINITY ? 0.f : exp2f(ml[2 * s] - mx);
    l = fmaf(w, ml[2 * s + 1], l);
    acc = fmaf(w, po[(row * n_split + s) * DV + d], acc);
  }
  return acc / fmaxf(l, 1e-30f);
}

// Second pass: each output element merges its row's n_split partials
// (row (b*Sq + i)*H + h)
template <typename T, int DV>
__global__ void __launch_bounds__(256)
flash_gqa_merge(const float* __restrict__ po, const float* __restrict__ pml,
                T* __restrict__ o, int64_t rows, int n_split) {
  const int64_t e = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= rows * DV) return;
  store1(o + e, merge_splits<DV>(po, pml, e / DV, (int)(e % DV), n_split));
}

// The wgmma body's second pass: each output element of a split item
// merges its partials (row j * FW_BQ + r: item whole + j, row r of the
// item's query tile; rows past Sq have none)
template <int DV>
__global__ void __launch_bounds__(256)
flash_gqa_merge_tiles(const float* __restrict__ po,
                      const float* __restrict__ pml,
                      __nv_bfloat16* __restrict__ o, int Sq, int H, int BH,
                      int whole, int n_split, int64_t n_el) {
  const int64_t e = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= n_el) return;
  const int64_t row = e / DV;
  const int item = whole + (int)(row / FW_BQ);
  const int n_qt = (Sq + FW_BQ - 1) / FW_BQ;
  const int q = (n_qt - 1 - item / BH) * FW_BQ + (int)(row % FW_BQ);
  if (q >= Sq) return;
  const int bh = item % BH, d = (int)(e % DV);
  o[(((int64_t)(bh / H) * Sq + q) * H + bh % H) * DV + d] =
      __float2bfloat16(merge_splits<DV>(po, pml, row, d, n_split));
}

// ---------------------------------------------------------------- launch
// the CUDA functions the last flash_gqa call on this thread launched
// ("" after a refusal), which fa_last_launch returns
static thread_local const char* last_launch = "";

// the launch error, if any; else records fns as the call's launches
static int record(const char* fns) {
  const int err = (int)cudaGetLastError();
  if (!err) last_launch = fns;
  return err;
}

static int set_smem(const void* fn, size_t shm) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

// [B, S, Hx, cols] bf16 as a 4-D TMA map (column, head, row, batch) with
// boxes of 64 columns x `rows` rows of one head, 128-byte swizzle, zeros
// out of bounds (rows past S). cuTensorMapEncodeTiled comes through the
// runtime's entry-point query, so the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    if (err != cudaSuccess || got != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = (EncodeTiled)p;
  }
  return fn;
}

static int tile_map(CUtensorMap* map, const void* ptr, int B, int S, int Hx,
                    int cols, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)Hx,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)Hx * cols * 2,
                                 (cuuint64_t)S * Hx * cols * 2};
  const cuuint32_t box[4] = {FW_BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, one,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The wgmma body. n_split > 1 (a call with no mask) splits Skv for the
// items from `whole` on (the wrapper's wgmma_split_plan decides both) into
// n_split runs of ceil(kv tiles / n_split) whole kv tiles, none empty;
// flash_gqa_merge_tiles adds their partials in order, from the f32 scratch
// of (items - whole) * FW_BQ * n_split * (DV + 2) floats that the caller
// allocates. n_split 0 runs every item whole.
template <int D, int DV>
static int launch_wgmma(const void* q, const void* k, const void* v,
                        const void* kv_head, void* o, int B, int Sq, int Skv,
                        int H, int Hkv, int causal, int window, float scale,
                        float* scratch, int n_split, int whole,
                        cudaStream_t stream) {
  using C = Fw<D, DV>;
  const int kv_t = (Skv + C::BK - 1) / C::BK;
  const int64_t items = (int64_t)B * H * ((Sq + FW_BQ - 1) / FW_BQ);
  if (items > 0x7fffffff / FW_BQ) return (int)cudaErrorInvalidValue;
  int tiles = kv_t, ns = 1;             // kv tiles a split, splits
  if (n_split > 1) {
    tiles = (kv_t + n_split - 1) / n_split;
    ns = n_split;
    if (causal || window || scratch == nullptr || whole < 0
        || whole >= items || (int64_t)(ns - 1) * tiles >= kv_t)
      return (int)cudaErrorInvalidValue;
  } else {
    whole = (int)items;
  }
  const int64_t blocks = whole + (items - whole) * ns;
  const int64_t rows = (items - whole) * FW_BQ;  // partial rows
  if (blocks > 0x7fffffff || rows * DV > 0x7fffffffLL * 256)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = tile_map(&tq, q, B, Sq, H, D, FW_BQ);
  if (!err) err = tile_map(&tk, k, B, Skv, Hkv, D, C::BK);
  if (!err) err = tile_map(&tv, v, B, Skv, Hkv, DV, C::BK);
  if (!err) err = set_smem((const void*)flash_gqa_fwd_wgmma<D, DV>, C::SMEM);
  if (err) return err;
  float* po = scratch;
  float* pml = rows > 0 ? scratch + rows * ns * DV : nullptr;
  flash_gqa_fwd_wgmma<D, DV><<<(unsigned)blocks, FW_THREADS, C::SMEM,
                               stream>>>(
      tq, tk, tv, (const int*)kv_head, (__nv_bfloat16*)o, po, pml, Sq, Skv,
      H, B * H, causal, window, scale * 1.4426950408889634f, whole, ns,
      tiles);
  if (rows == 0) return record("flash_gqa_fwd_wgmma");
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_gqa_merge_tiles<DV><<<(unsigned)((rows * DV + 255) / 256), 256, 0,
                              stream>>>(po, pml, (__nv_bfloat16*)o, Sq, H,
                                        B * H, whole, ns, rows * DV);
  return record("flash_gqa_fwd_wgmma flash_gqa_merge_tiles");
}

template <typename T, int D, int DV>
static int launch_split_t(const void* q, const void* k, const void* v,
                          const void* kv_head, void* o, int B, int Sq,
                          int Skv, int H, int Hkv, float scale,
                          float* scratch, int n_split, cudaStream_t stream) {
  const int chunk = (Skv + n_split - 1) / n_split;
  if (scratch == nullptr || chunk > FS_MAX_CH
      || (int64_t)(n_split - 1) * chunk >= Skv || Hkv > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)B * Sq * H;
  float* po = scratch;
  float* pml = scratch + rows * n_split * DV;
  // V rows in shared memory: a tile, or the whole split where it is less
  const size_t shm = (size_t)min(split_v_keys<T, DV>(), chunk) * DV
                     * sizeof(T);
  int err = set_smem((const void*)flash_gqa_split<T, D, DV>, shm);
  if (err) return err;
  flash_gqa_split<T, D, DV><<<dim3(n_split, Hkv, B), FS_THREADS, shm,
                              stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)kv_head, po, pml, Sq,
      Skv, H, Hkv, n_split, chunk, scale * 1.4426950408889634f);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int64_t blocks = (rows * DV + 255) / 256;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_gqa_merge<T, DV><<<(unsigned)blocks, 256, 0, stream>>>(
      po, pml, (T*)o, rows, n_split);
  return record("flash_gqa_split flash_gqa_merge");
}

// The body the wrapper picked (flash_gqa.body): n_split > 0 with whole <
// 0 the split body, n_split > 1 with whole >= 0 the wgmma body split from
// item `whole` on, n_split 0 the tiled body of the dtype and head dims
// (wgmma, mma or fma) unsplit.
template <int D, int DV>
static int launch(int dtype, const void* q, const void* k, const void* v,
                  const void* kv_head, void* o, int B, int Sq, int Skv,
                  int H, int Hkv, int causal, int window, float scale,
                  float* scratch, int n_split, int whole,
                  cudaStream_t stream) {
  if (n_split > 0 && whole < 0) {
    if (Sq > FS_MAX_SQ || H > FS_MAX_H || Skv > FS_MAX_CH * FS_MAX_SPLITS)
      return (int)cudaErrorInvalidValue;
    return dtype == 0
        ? launch_split_t<float, D, DV>(q, k, v, kv_head, o, B, Sq, Skv, H,
                                       Hkv, scale, scratch, n_split, stream)
        : launch_split_t<__nv_bfloat16, D, DV>(q, k, v, kv_head, o, B, Sq,
                                               Skv, H, Hkv, scale, scratch,
                                               n_split, stream);
  }
  constexpr bool WGMMA = (D == 64 && DV == 64) || (D == 192 && DV == 128)
                        || (D == 256 && DV == 256);
  if constexpr (WGMMA) {
    if (dtype == 1)
      return launch_wgmma<D, DV>(q, k, v, kv_head, o, B, Sq, Skv, H, Hkv,
                                 causal, window, scale, scratch, n_split,
                                 whole, stream);
  }
  if (n_split > 0) return (int)cudaErrorInvalidValue;
  constexpr int DVB = dv_block<DV>();
  const int64_t blocks =
      (int64_t)B * H * ((Sq + FA_BQ - 1) / FA_BQ) * (DV / DVB);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    const size_t shm = smem_bytes(D, DVB);
    const int err = set_smem((const void*)flash_gqa_fwd<D, DV>, shm);
    if (err) return err;
    flash_gqa_fwd<D, DV><<<(unsigned)blocks, FA_THREADS, shm, stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const int*)kv_head, (float*)o, Sq, Skv, H, Hkv, B * H, causal,
        window, scale);
  } else if constexpr (!WGMMA) {
    const size_t shm = smem_bytes_mma(D, DVB);
    const int err = set_smem((const void*)flash_gqa_fwd_mma<D, DV>, shm);
    if (err) return err;
    flash_gqa_fwd_mma<D, DV><<<(unsigned)blocks, FA_THREADS, shm, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const int*)kv_head, (__nv_bfloat16*)o, Sq,
        Skv, H, Hkv, B * H, causal, window, scale * 1.4426950408889634f);
  }
  return record(dtype == 0 ? "flash_gqa_fwd" : "flash_gqa_fwd_mma");
}

extern "C" {

int fa_max_head_dim() { return FA_MAX_D; }

const char* fa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// the CUDA functions (names without template arguments, space-separated)
// that the last flash_gqa call on this thread launched; "" if it launched
// none
const char* fa_last_launch() { return last_launch; }

// dtype 0: q, k, v, o are f32; 1: bf16. q [B,Sq,H,D], k [B,Skv,Hkv,D],
// v [B,Skv,Hkv,Dv], o [B,Sq,H,Dv], kv_head [H] int32, all contiguous on
// one device; scale multiplies q.k; Sq == Skv unless causal == 0 and
// window == 0. n_split and whole name the body (launch above), which the
// wrapper picks: n_split > 0 with whole < 0 the split body (no mask, Sq
// <= FS_MAX_SQ, H <= FS_MAX_H), with f32 scratch of B*Sq*H*n_split*(Dv +
// 2) floats and splits of ceil(Skv / n_split) <= FS_MAX_CH keys, none
// empty; n_split > 1 with whole >= 0 the wgmma body (bf16 at its pairs, no
// mask) with the items from `whole` on split over Skv, with the scratch
// launch_wgmma names; n_split == 0 the tiled body of the dtype and head
// dims. Returns a cudaError_t (0 = launched).
int flash_gqa(int dtype, const void* q, const void* k, const void* v,
              const void* kv_head, void* o, int B, int Sq, int Skv, int H,
              int Hkv, int D, int Dv, int causal, int window, float scale,
              void* scratch, int n_split, int whole, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || Hkv <= 0 || window < 0 ||
      (Sq != Skv && (causal || window)) || (dtype != 0 && dtype != 1) ||
      n_split < 0 || (n_split > 0 && (causal || window)))
    return (int)cudaErrorInvalidValue;
  last_launch = "";
  cudaStream_t s = (cudaStream_t)stream;
#define FA_CASE(d, dv)                                                      \
  if (D == d && Dv == dv)                                                   \
    return launch<d, dv>(dtype, q, k, v, kv_head, o, B, Sq, Skv, H, Hkv,    \
                         causal, window, scale, (float*)scratch, n_split,   \
                         whole, s);
  FA_CASE(16, 16)
  FA_CASE(32, 32)
  FA_CASE(64, 64)
  FA_CASE(128, 128)
  FA_CASE(192, 128)
  FA_CASE(256, 256)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
