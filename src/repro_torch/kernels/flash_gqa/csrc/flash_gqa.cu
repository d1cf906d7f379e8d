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
// Shared by both bodies. The TPU grid's sequential kv axis is a loop
// inside one block of 128 threads per (b, h, 64 query rows, DVB output
// columns), with m, l and the accumulator in registers for the whole row
// range. DVB is DV up to 128; at DV = 256 (recurrentgemma-9b: 16 heads
// over 1 kv head of 256) each block computes one 128-column half of O and
// recomputes S = Q.K^T in full, so the accumulator stays the D = 128
// body's (two blocks read the same Q and K tiles, back to back, from L2).
// Blocks are numbered so that the last query tiles, which see the most
// keys under the causal mask, start first (with no mask every tile has
// the same work and the order does not matter), and consecutive blocks
// share a kv head, whose tiles then come from L2. The head repeat of the
// reference wrapper is never built: a block reads its kv head through
// kv_head, which is irregular when heads are padded (padded query heads
// read kv head 0), so no h / rep is assumed. Only the kv tiles of 64 rows
// that hold an unmasked key for some row of the block are visited: those
// wholly above the diagonal or wholly before the window are skipped,
// which leaves m, l and the accumulator exactly as a fully masked tile
// would. Masked scores are -inf, and a row whose keys are all masked so
// far keeps m = -inf, l = 0 and a zero accumulator (the reference's -1e30
// gives the same output once the row meets an unmasked key, which every
// row does: its own position, or with no mask any key). Query rows past
// Sq and keys past Skv are zero-filled on load; keys past Skv are masked,
// and rows past Sq are never stored.
//
// bf16 body (flash_gqa_fwd_mma, the serve path): FA2-style on the tensor
// cores. Each of the 4 warps owns 16 query rows. Per kv tile:
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
// At D = 192 Q's fragments would take 48 registers a thread on top of the
// 64 of the [16 x 128] accumulator and the 32 of S (the D = 128 build
// already uses about 204), so above D = 128 they are not kept: each k-step
// loads its fragment from the Q tile in shared memory by ldmatrix, 12 (at
// D = 256, 16) more ldmatrix a kv tile and warp.
// K and V tiles come in by cp.async (16 bytes a thread, zero-filled past
// Skv) into a ring of two stages: tile t+1 loads while tile t is
// computed, one __syncthreads a tile. V's tile holds only the block's DVB
// columns. Rows of shared memory are D + 8 (V: DVB + 8) elements, so the
// 8 rows an ldmatrix reads fall in distinct banks. Shared memory:
// ((64 + 2 * 64) * (D + 8) + 2 * 64 * (DVB + 8)) * 2 bytes: 87,040 at
// D = DV = 128 and 111,616 at (192, 128), two blocks an SM either way;
// 136,192 at (256, 256), one block an SM (opt-in above 48 KB).
// f32 body (flash_gqa_fwd): f32 FMA from shared memory, as the tests hold
// f32 to 2e-5, which TF32 (about three digits) cannot meet: K^T and V by
// plain loads (K transposed on the way), each thread a 4x8 score tile and
// a 4 x DVB/8 output tile, P through shared memory; 98 KB, two blocks an
// SM at D = 128; 134 KB, one block an SM, at (192, 128); 164 KB at
// (256, 256) with the same 128-column halves of O.
//
// Bound. At the serve path's shape (B=4, S=512, H=32, Hkv=2, D=128,
// causal) the function needs, over the causal triangle (512*513/2 =
// 131,328 pairs a head), 2 products of 2*128 FLOP a pair for 128 (b, h):
// 8.61 GFLOP; it moves q and o (33.6 MB in bf16) and k and v (2.1 MB).
// In bf16 that is 0.0107 ms of memory at 3.35 TB/s (8.61 GFLOP take
// 0.0087 ms at 989 TFLOP/s); in f32 0.129 ms of f32 FMA at 67 TFLOP/s,
// above its 0.021 ms of memory. Both bodies compute whole 64x64 tiles on
// the diagonal (9.66 GFLOP at that shape). ptxas (-Xptxas=-v, CUDA 12.8,
// sm_90a): registers, shared memory and spills of each instantiation are
// printed by chip_smoke.py and written in PERF.md. Left to do: wgmma with
// TMA and a producer warp (FA3), and an epilogue through shared memory
// for coalesced stores. 128-row query tiles of 8 warps were tried: at two
// blocks an SM the 128-register cap spills at D = 128, and they ran
// slower.
//
// MLA prefill (deepseek-v2-lite: B=4, S=512, H=Hkv=16, D=192, DV=128,
// causal): 4 * 16 * 131,328 pairs of 2 * (192 + 128) FLOP, 5.38 GFLOP;
// q, k (2 * 12.6 MB), v and o (2 * 8.4 MB) in bf16: 41.9 MB, 0.0125 ms at
// 3.35 TB/s, against 0.0054 ms for the FLOP at 989 TFLOP/s.
// recurrentgemma-9b prefill (B=4, S=512, 16 heads over 1, D = DV = 256,
// causal): 8.61 GFLOP, 0.0087 ms at 989 TFLOP/s, under its 35.7 MB of
// q, k, v and o (0.0107 ms at 3.35 TB/s); the S recomputed by the second
// half of O adds a quarter to the FLOP the kernel does. whisper-tiny (6 heads of 64, no
// mask): the encoder's 1500 x 1500 pairs a head and the cross
// attention's 64 (prefill) or 1 (decode) query rows against 1500 frames;
// at Sq = 1 a block computes 64 query rows for one, so such a call is
// bound by the k and v it reads (2.3 MB in bf16 at B = 4), not by FLOP.
//
// Limits: (D, DV) in {(16, 16), (32, 32), (64, 64), (128, 128), (192,
// 128), (256, 256)}; Sq, Skv >= 1; Sq == Skv unless causal == 0 and
// window == 0; every kv_head[h] in [0, Hkv) (the wrapper checks the map).
// Anything else is cudaErrorInvalidValue.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  constexpr bool QREG = D <= 128;               // Q's fragments in registers
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
  uint32_t qf[QREG ? KS : 1][4];
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
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldsm_x4(qf[kk], smem_addr(Qs + (warp * 16 + (lane & 15)) * LD
                                    + kk * 16 + (lane >> 4) * 8));
      }
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
      if constexpr (!QREG)      // this k-step's Q fragment from the tile
        ldsm_x4(qf[0], smem_addr(Qs + (warp * 16 + (lane & 15)) * LD
                                 + kk * 16 + (lane >> 4) * 8));
      const uint32_t* qa = qf[QREG ? kk : 0];
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

// ---------------------------------------------------------------- launch
static int set_smem(const void* fn, size_t shm) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

template <int D, int DV>
static int launch(int dtype, const void* q, const void* k, const void* v,
                  const void* kv_head, void* o, int B, int Sq, int Skv,
                  int H, int Hkv, int causal, int window, float scale,
                  cudaStream_t stream) {
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
  } else {
    const size_t shm = smem_bytes_mma(D, DVB);
    const int err = set_smem((const void*)flash_gqa_fwd_mma<D, DV>, shm);
    if (err) return err;
    flash_gqa_fwd_mma<D, DV><<<(unsigned)blocks, FA_THREADS, shm, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const int*)kv_head, (__nv_bfloat16*)o, Sq,
        Skv, H, Hkv, B * H, causal, window, scale * 1.4426950408889634f);
  }
  return (int)cudaGetLastError();
}

extern "C" {

int fa_max_head_dim() { return FA_MAX_D; }

const char* fa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype 0: q, k, v, o are f32; 1: bf16. q [B,Sq,H,D], k [B,Skv,Hkv,D],
// v [B,Skv,Hkv,Dv], o [B,Sq,H,Dv], kv_head [H] int32, all contiguous on
// one device; scale multiplies q.k; Sq == Skv unless causal == 0 and
// window == 0. Returns a cudaError_t (0 = launched).
int flash_gqa(int dtype, const void* q, const void* k, const void* v,
              const void* kv_head, void* o, int B, int Sq, int Skv, int H,
              int Hkv, int D, int Dv, int causal, int window, float scale,
              void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || Hkv <= 0 || window < 0 ||
      (Sq != Skv && (causal || window)) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FA_CASE(d, dv)                                                      \
  if (D == d && Dv == dv)                                                   \
    return launch<d, dv>(dtype, q, k, v, kv_head, o, B, Sq, Skv, H, Hkv,    \
                         causal, window, scale, s);
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
