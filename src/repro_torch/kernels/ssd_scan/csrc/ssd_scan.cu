// ssd_scan for Hopper (sm_90a): the Mamba-2 SSD chunk scan, forward, as a
// plain C interface loaded with ctypes.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan/ssd_scan.py:
// ssd_pallas (body _ssd_kernel) together with the host-side preparation of
// its wrapper ops.ssd. Inputs in model layout: x [B,S,H,P], dt [B,S,H]
// (post-softplus, f32), A [H] (f32), Bm/Cm [B,S,G,N]; x, Bm, Cm and y share
// one type (f32 or bf16). Outputs y [B,S,H,P] and the final state
// [B,H,P,N] (f32). For each (b, h), chunks of Q rows in order:
//   cs     = cumsum(dt*A) within the chunk
//   y      = ((C.B^T) o L).(x*dt) + exp(cs) o (C.state),
//            L[i,j] = exp(cs_i - cs_j) for j <= i, else 0
//   state' = exp(cs_last).state + B^T.(exp(cs_last - cs) o x*dt)
// with the state before the chunk's update in y.
//
// Design: the SSD split of Mamba-2 [arXiv:2405.21060], in four launches on
// one stream, so that the chunks of a sequence work in parallel and C.B^T
// is computed once per (b, chunk, group), not per head:
//   1. ssd_cb: C.B^T [Q,Q] per (b, chunk, group), the 64x64 tiles on or
//      below the diagonal, into scratch cb [B,nc,G,Q,Q];
//   2. ssd_chunk_state: the chunk's own state B^T.(exp(cs_last - cs) o
//      x*dt) [P,N] per (b, chunk, head, 64 columns of P) into scratch
//      states [B,nc,H,P,N], and cs_last into csl [B,H,nc];
//   3. ssd_state_pass: per (b, head) the short sequential pass across
//      chunks, elementwise f32: states[c] becomes the state entering
//      chunk c, and the last one is the output state;
//   4. ssd_chunk_scan: y = exp(cs) o (C.states[c]) + ((C.B^T) o L).(x*dt)
//      per (b, chunk, head, 64 columns of P), the second product only over
//      j <= i (the causal triangle in 16-row bands).
// Kernels 2 and 4 give a block a run of heads of one group (chosen at
// launch so the blocks fill the card once): B, or C and C.B^T, are loaded
// once for the run, and the next head's x, dt (and entering state) are
// gathered into registers while this head's products run. Kernel 2 runs
// 8 warps a block, two blocks an SM (108 KB of shared memory each);
// kernel 4 16 warps, one block an SM (207 KB). The scratch is allocated
// by the wrapper; the kernels allocate nothing. cs is a block scan (a warp
// shuffle scan per 32 rows, then the warps' totals), computed alike in
// kernels 2 and 4. B and C are read at group layout (head h reads group
// h / (H/G)); x*dt and dt*A are folded on load.
//
// Precision: the tests hold y and the state to 2e-4 in f32 (and bf16 y to
// one bf16 step), which TF32 alone (about three digits) cannot meet, so
// every product runs on the tensor cores as mma.sync.m16n8k8 with a
// 3xTF32 split by truncation (tf32_mma.cuh), f32 accumulate. bf16 inputs
// are exact in TF32, so their low part is zero and its pass is skipped:
//   product                  f32 inputs   bf16 inputs (the serve path)
//   C.B^T                    3 passes     1 pass (both operands exact)
//   B^T.(decay o x*dt)       3            2 (B exact)
//   C.state                  3            2 (C exact)
//   ((C.B^T) o L).(x*dt)     3            3 (both operands f32)
// The state pass and the exp(cs) and L scalings stay f32 FMA: they are
// elementwise, not products. Their exponentials are __expf (ex2.approx of
// a product with log2 e: a few 1e-6 relative at |cs| up to 100).
//
// Bound: operations. At the serve path's shape (B=4, S=512, H=80, P=64,
// G=1, N=128, Q=128) the function needs, counting the causal triangle
// only (Q(Q+1)/2 = 8256 pairs): C.B^T once per (b, group, chunk),
// 2*8256*128 FLOP over 16 such triples; per (b*h, chunk) 2*8256*64
// (S.xdt) + 2*2*128*128*64 (C.state, B^T.xdt) = 5.25 MFLOP over 1280
// pairs. That is 6.76 GFLOP: 0.101 ms at 67 TFLOP/s (f32 FMA), or 0.041
// ms at 495/3 TFLOP/s (3xTF32 on the tensor cores), against about 54 MB
// of inputs and outputs (0.016 ms at 3.35 TB/s). The split adds the
// chunk states, 42 MB at that shape, written, read and rewritten by the
// pass, and read again. ptxas's registers, shared memory and spills are
// printed by chip_smoke.py and written in PERF.md, with the time of each
// kernel. Left to do: the causal product's exponentials are computed by
// both warps that share a row band; the chunk states' round trips;
// fragments by scalar shared loads (ldmatrix needs 16-bit data: bf16 mma
// with a split for the f32 operands); no TMA.
//
// Limits: Q <= 128 and N <= 128; S a multiple of Q; G divides H. Anything
// else is cudaErrorInvalidValue.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

#define SSD_THREADS 128
#define SSD_MAX_Q 128
#define SSD_MAX_N 128
#define SSD_PS 64                   // columns of P a block owns
#define SSD_LDR 132                 // [m][k] rows of 128 (4 mod 32 banks)
#define SSD_LDN 136                 // [k][n] rows of 128 (8 mod 32 banks)
#define SSD_LDP 72                  // [k][p] rows of 64 (8 mod 32 banks)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T>
constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;

// 16 bytes of global memory (V values of T) as f32
template <typename T, int V>
__device__ __forceinline__ void load16(const T* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  if constexpr (kExact<T>) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
    const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = f[k];
  }
}

// dst[r][c] = f(r, c, src[r * stride + c]) for r < rows, c < cols, and 0
// elsewhere in the rows_pad x cols_pad tile (cols_pad a multiple of 16 /
// sizeof(T)), as f32 in shared memory with rows of ld floats (ld a
// multiple of 4). 16-byte loads where the rows allow them.
template <int NT = SSD_THREADS, typename T, class F>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t stride, int rows,
                                          int cols, int rows_pad,
                                          int cols_pad, F f) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = cols % V == 0 && stride % V == 0
                   && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const int cv = cols_pad / V;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows_pad * cv; e += NT) {
    const int r = e / cv, c0 = (e - r * cv) * V;
    float v[V];
    if (r < rows && c0 < cols) {
      if (vec) {
        load16<T, V>(src + r * stride + c0, v);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          v[k] = c0 + k < cols ? to_f(src[r * stride + c0 + k]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < V; ++k)
        v[k] = c0 + k < cols ? f(r, c0 + k, v[k]) : 0.f;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<float4*>(dst + r * ld + c0 + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}

struct Same {
  __device__ float operator()(int, int, float v) const { return v; }
};

// dst[r * stride + c] = src[r][c] (rows of ld floats in shared memory) for
// r < rows, c < cols, rounded to T; 16-byte stores where the rows allow.
template <typename T, int NT = SSD_THREADS>
__device__ __forceinline__ void store_rows(T* dst, int64_t stride,
                                           const float* src, int ld,
                                           int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = cols % V == 0 && stride % V == 0
                   && reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  if (!vec) {
    for (int e = threadIdx.x; e < rows * cols; e += NT) {
      const int r = e / cols, c = e - r * cols;
      dst[r * stride + c] = from_f<T>(src[r * ld + c]);
    }
    return;
  }
  const int cv = cols / V;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * cv; e += NT) {
    const int r = e / cv, c0 = (e - r * cv) * V;
    alignas(16) T out[V];
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = from_f<T>(src[r * ld + c0 + k]);
    *reinterpret_cast<uint4*>(dst + r * stride + c0) =
        *reinterpret_cast<const uint4*>(out);
  }
}

// the chunk's dt of head h for this thread's row (0 past Q)
__device__ __forceinline__ float chunk_dt(const float* __restrict__ dt,
                                          int64_t r0, int H, int h, int Q) {
  return (int)threadIdx.x < Q ? dt[(r0 + threadIdx.x) * H + h] : 0.f;
}

// cs[i] = sum_{j <= i} dt_j * a over the chunk's rows and dts[i] = dt_i,
// from d = chunk_dt(..) of each thread: a warp shuffle scan, then the
// warps' totals (at least 4 warps, wsum one float a warp; cs stays at
// cs[Q-1] past Q).
__device__ __forceinline__ void chunk_cumsum(float d, float a, float* cs,
                                             float* dts, float* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float v = d * a;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += wsum[w];
  if (tid < SSD_MAX_Q) {
    cs[tid] = v;
    dts[tid] = d;
  }
  __syncthreads();
}

// A rows_pad x cols_pad tile of global memory (row stride `stride`, rows
// < rows and columns < cols valid, zeros elsewhere; cols_pad a multiple
// of V = 16 / sizeof(T)) held in registers between gather, which starts
// the loads, and scatter, which converts to f32, applies f(r, c, v) and
// writes shared memory: the loads of the next head fly while this head's
// products run. ITERS x NT threads x V covers the tile.
template <typename T, int ITERS, int NT>
struct TileFetch {
  static constexpr int V = 16 / sizeof(T);
  uint4 raw[ITERS];

  __device__ __forceinline__ void gather(const T* src, int64_t stride,
                                         int rows, int cols, int rows_pad,
                                         int cols_pad) {
    const bool vec = cols % V == 0 && stride % V == 0
                     && reinterpret_cast<uintptr_t>(src) % 16 == 0;
    const int cv = cols_pad / V;
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int e = threadIdx.x + k * NT, r = e / cv, c0 = (e - r * cv) * V;
      raw[k] = make_uint4(0u, 0u, 0u, 0u);
      if (r >= rows || c0 >= cols) continue;
      if (vec) {
        raw[k] = *reinterpret_cast<const uint4*>(src + r * stride + c0);
      } else {
        T* t = reinterpret_cast<T*>(&raw[k]);
#pragma unroll
        for (int kk = 0; kk < V; ++kk)
          if (c0 + kk < cols) t[kk] = src[r * stride + c0 + kk];
      }
    }
  }

  template <class F>
  __device__ __forceinline__ void scatter(float* dst, int ld, int rows,
                                          int cols, int rows_pad,
                                          int cols_pad, F f) const {
    const int cv = cols_pad / V;
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int e = threadIdx.x + k * NT, r = e / cv, c0 = (e - r * cv) * V;
      if (r >= rows_pad) continue;
      const T* t = reinterpret_cast<const T*>(&raw[k]);
      float v[V];
#pragma unroll
      for (int kk = 0; kk < V; ++kk)
        v[kk] = r < rows && c0 + kk < cols ? f(r, c0 + kk, to_f(t[kk]))
                                           : 0.f;
#pragma unroll
      for (int kk = 0; kk < V; kk += 4)
        *reinterpret_cast<float4*>(dst + r * ld + c0 + kk) =
            make_float4(v[kk], v[kk + 1], v[kk + 2], v[kk + 3]);
    }
  }
};

// ------------------------------------------------------------ 1. C.B^T
template <typename T>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_cb(const T* __restrict__ Bm, const T* __restrict__ Cm,
       float* __restrict__ cb, int S, int G, int N, int Q, int nc,
       int pairs) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                             // [64][SSD_LDR]: C rows i
  float* Bs = Cs + 64 * SSD_LDR;                // [64][SSD_LDR]: B rows j
  int pair = blockIdx.x % pairs, ti = 0;
  while (pair > ti) pair -= ++ti;               // tile (ti, tj), tj <= ti
  const int tj = pair;
  const int bcg = blockIdx.x / pairs;
  const int g = bcg % G, c = (bcg / G) % nc, b = bcg / G / nc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int npad = (N + 7) / 8 * 8;
  const int64_t r0 = (int64_t)b * S + (int64_t)c * Q;

  const int64_t gs = (int64_t)G * N;            // row stride of B and C
  load_tile(Cs, SSD_LDR, Cm + ((r0 + ti * 64) * G + g) * N, gs,
            min(64, Q - ti * 64), N, 64, npad, Same());
  load_tile(Bs, SSD_LDR, Bm + ((r0 + tj * 64) * G + g) * N, gs,
            min(64, Q - tj * 64), N, 64, npad, Same());
  __syncthreads();
  const int rows = min(64, Q - ti * 64), cols = min(64, Q - tj * 64);
  if (warp * 16 >= rows) return;
  float acc[1][8][4] = {};
  const float* Cw = Cs + warp * 16 * SSD_LDR;
  warp_mma_3xtf32<1, 8, kExact<T>, kExact<T>>(
      acc, [&](int m, int k) { return Cw[m * SSD_LDR + k]; },
      [&](int k, int n) { return Bs[n * SSD_LDR + k]; }, npad,
      (cols + 7) / 8, lane);
  float* out = cb + ((int64_t)(b * nc + c) * G + g) * Q * Q;
  const int gi = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = warp * 16 + gi + (e >> 1) * 8;
      const int col = nt * 8 + 2 * t + (e & 1);
      if (r < rows && col < cols)
        out[(int64_t)(ti * 64 + r) * Q + tj * 64 + col] = acc[0][nt][e];
    }
}

// ------------------------------------------------- 2. the chunks' states
// One block per (b, chunk, run of heads of one group, 64 columns of P):
// B is loaded once and serves every head of the run; the next head's
// x and dt are gathered into registers while this head's product runs.
// Warp w owns rows 16 (w % 4).. of P and columns 64 (w / 4).. of N.
#define SSD_STATE_THREADS 256
#define SSD_XITERS(T) \
  (SSD_MAX_Q * SSD_PS * (int)sizeof(T) / 16 / SSD_STATE_THREADS)
template <typename T>
__global__ void __launch_bounds__(SSD_STATE_THREADS, 2)
ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                float* __restrict__ states, float* __restrict__ csl, int S,
                int H, int P, int G, int N, int Q, int nc, int nps,
                int hb, int nhb) {
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;                             // [128][SSD_LDN]: B
  float* Xs = Bs + SSD_MAX_Q * SSD_LDN;         // [128][SSD_LDP]: decay*x*dt
  float* cs = Xs + SSD_MAX_Q * SSD_LDP;         // [128]
  float* dts = cs + SSD_MAX_Q;                  // [128]
  float* dec = dts + SSD_MAX_Q;                 // [128]: exp(cs_last - cs)
  float* wsum = dec + SSD_MAX_Q;                // [8]
  int rest = blockIdx.x;
  const int ps = rest % nps; rest /= nps;
  const int j = rest % nhb; rest /= nhb;
  const int g = rest % G; rest /= G;
  const int c = rest % nc, b = rest / nc;
  const int R = H / G, h0 = g * R + j * hb, h1 = min(g * R + R, h0 + hb);
  const int p0 = ps * SSD_PS, pv = min(SSD_PS, P - p0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = lane >> 2, t = lane & 3;
  const int kpad = (Q + 7) / 8 * 8, npad = (N + 7) / 8 * 8;
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 64;
  const int ntv = min(8, max(0, (npad - n0) / 8));   // n-tiles of the warp
  const int64_t r0 = (int64_t)b * S + (int64_t)c * Q;
  const int64_t xs = (int64_t)H * P;            // row stride of x

  TileFetch<T, SSD_XITERS(T), SSD_STATE_THREADS> xf;
  xf.gather(x + (r0 * H + h0) * P + p0, xs, Q, pv, kpad, SSD_PS);
  float d = chunk_dt(dt, r0, H, h0, Q);
  load_tile<SSD_STATE_THREADS>(Bs, SSD_LDN, Bm + (r0 * G + g) * N,
                               (int64_t)G * N, Q, N, kpad, npad, Same());
  for (int h = h0; h < h1; ++h) {
    chunk_cumsum(d, A[h], cs, dts, wsum);
    const float cl = cs[Q - 1];
    if (ps == 0 && tid == 0) csl[((int64_t)b * H + h) * nc + c] = cl;
    if (tid < SSD_MAX_Q) dec[tid] = __expf(cl - cs[tid]);
    __syncthreads();
    xf.scatter(Xs, SSD_LDP, Q, pv, kpad, SSD_PS,
               [&](int i, int, float v) { return v * dts[i] * dec[i]; });
    __syncthreads();
    if (h + 1 < h1) {
      xf.gather(x + (r0 * H + h + 1) * P + p0, xs, Q, pv, kpad, SSD_PS);
      d = chunk_dt(dt, r0, H, h + 1, Q);
    }
    // state^T [p][n] = sum_i xdec[i][p] B[i][n]
    float acc[1][8][4] = {};
    if (m0 < pv)
      warp_mma_3xtf32<1, 8, false, kExact<T>>(
          acc, [&](int m, int k) { return Xs[k * SSD_LDP + m0 + m]; },
          [&](int k, int n) { return Bs[k * SSD_LDN + n0 + n]; }, kpad, ntv,
          lane);
    __syncthreads();                      // Xs is free for the state^T
    float* St = Xs;                       // [64][SSD_LDN]
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(St + (m0 + gi + hf * 8) * SSD_LDN + n0
                                   + nt * 8 + 2 * t) =
            make_float2(acc[0][nt][2 * hf], acc[0][nt][2 * hf + 1]);
    __syncthreads();
    store_rows<float, SSD_STATE_THREADS>(
        states + ((((int64_t)b * nc + c) * H + h) * P + p0) * N, N, St,
        SSD_LDN, pv, N);
  }
}

// ------------------------------------------- 3. the pass across chunks
// one thread per 4 elements of one (b, h) state [P,N] (blockIdx.x = b*H+h,
// blockIdx.y the run of 1024 elements); every chunk's state is loaded
// before the recurrence runs
#define SSD_PASS_UNROLL 8
__global__ void __launch_bounds__(256)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ csl,
               float* __restrict__ state_out, int H, int PN, int nc) {
  const int bh = blockIdx.x, h = bh % H, b = bh / H;
  const int e = (blockIdx.y * 256 + threadIdx.x) * 4;
  if (e >= PN) return;
  const bool vec = PN % 4 == 0;
  const int ne = min(4, PN - e);
  const float* cl = csl + (int64_t)bh * nc;
  const int64_t cstride = (int64_t)H * PN;      // one chunk further
  float* p = states + ((int64_t)b * nc * H + h) * PN + e;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < nc; c0 += SSD_PASS_UNROLL) {
    float own[SSD_PASS_UNROLL][4];
#pragma unroll
    for (int k = 0; k < SSD_PASS_UNROLL; ++k) {
      const float* q = p + (c0 + k) * cstride;
      if (c0 + k < nc && vec) {
        const float4 v = *reinterpret_cast<const float4*>(q);
        own[k][0] = v.x; own[k][1] = v.y; own[k][2] = v.z; own[k][3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          own[k][i] = c0 + k < nc && i < ne ? q[i] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < SSD_PASS_UNROLL; ++k) {
      if (c0 + k >= nc) break;
      float* q = p + (c0 + k) * cstride;        // the state entering c
      if (vec) {
        *reinterpret_cast<float4*>(q) = make_float4(s[0], s[1], s[2], s[3]);
      } else {
        for (int i = 0; i < ne; ++i) q[i] = s[i];
      }
      const float ec = __expf(cl[c0 + k]);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = ec * s[i] + own[k][i];
    }
  }
  float* o = state_out + (int64_t)bh * PN + e;
  for (int i = 0; i < ne; ++i) o[i] = s[i];
}

// ------------------------------------------------------------ 4. outputs
// One block of 8 warps per (b, chunk, run of heads of one group, 64
// columns of P): C and C.B^T are loaded once for the run; per head the
// state entering the chunk and x*dt, the next head's gathered into
// registers during this head's products. L is applied as the A fragments
// of C.B^T are read. Warp w owns rows 16 (w % 8).. of the chunk and
// columns 32 (w / 8).. of the P slice.
#define SSD_SCAN_THREADS 512
#define SSD_SITERS (SSD_PS * SSD_MAX_N * 4 / 16 / SSD_SCAN_THREADS)
#define SSD_SXITERS(T) \
  (SSD_MAX_Q * SSD_PS * (int)sizeof(T) / 16 / SSD_SCAN_THREADS)
template <typename T>
__global__ void __launch_bounds__(SSD_SCAN_THREADS, 1)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Cm,
               const float* __restrict__ cb,
               const float* __restrict__ states, T* __restrict__ y, int S,
               int H, int P, int G, int N, int Q, int nc, int nps, int hb,
               int nhb) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                             // [128][SSD_LDR]: C
  float* CB = Cs + SSD_MAX_Q * SSD_LDR;         // [128][SSD_LDR]: C.B^T
  float* Ss = CB + SSD_MAX_Q * SSD_LDR;         // [64][SSD_LDR]: state
  float* Xs = Ss + SSD_PS * SSD_LDR;            // [128][SSD_LDP]: x*dt, y
  float* cs = Xs + SSD_MAX_Q * SSD_LDP;         // [128]
  float* dts = cs + SSD_MAX_Q;                  // [128]
  float* wsum = dts + SSD_MAX_Q;                // [16]
  int rest = blockIdx.x;
  const int ps = rest % nps; rest /= nps;
  const int j = rest % nhb; rest /= nhb;
  const int g = rest % G; rest /= G;
  const int c = rest % nc, b = rest / nc;
  const int R = H / G, h0 = g * R + j * hb, h1 = min(g * R + R, h0 + hb);
  const int p0 = ps * SSD_PS, pv = min(SSD_PS, P - p0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gi = lane >> 2, t = lane & 3;
  const int kpad = (Q + 7) / 8 * 8, npad = (N + 7) / 8 * 8;
  const int qpad = (Q + 15) / 16 * 16;
  const int i0 = (warp & 7) * 16, n0 = (warp >> 3) * 32;
  const int ntv = min(4, max(0, ((pv + 7) / 8 * 8 - n0) / 8));
  const int64_t r0 = (int64_t)b * S + (int64_t)c * Q;
  const int64_t xs = (int64_t)H * P;            // row stride of x and y
  const float* st = states + ((int64_t)b * nc + c) * H * P * N
                    + (int64_t)p0 * N;          // + h * P * N
  const bool rows = i0 < Q;                     // this warp owns rows

  TileFetch<float, SSD_SITERS, SSD_SCAN_THREADS> sf;
  TileFetch<T, SSD_SXITERS(T), SSD_SCAN_THREADS> xf;
  sf.gather(st + (int64_t)h0 * P * N, N, pv, N, SSD_PS, npad);
  xf.gather(x + (r0 * H + h0) * P + p0, xs, Q, pv, kpad, SSD_PS);
  float d = chunk_dt(dt, r0, H, h0, Q);
  load_tile<SSD_SCAN_THREADS>(Cs, SSD_LDR, Cm + (r0 * G + g) * N,
                              (int64_t)G * N, Q, N, qpad, npad, Same());
  load_tile<SSD_SCAN_THREADS>(
      CB, SSD_LDR, cb + ((int64_t)(b * nc + c) * G + g) * Q * Q, (int64_t)Q,
      Q, Q, qpad, kpad, Same());
  for (int h = h0; h < h1; ++h) {
    chunk_cumsum(d, A[h], cs, dts, wsum);
    sf.scatter(Ss, SSD_LDR, pv, N, SSD_PS, npad, Same());
    xf.scatter(Xs, SSD_LDP, Q, pv, kpad, SSD_PS,
               [&](int i, int, float v) { return v * dts[i]; });
    __syncthreads();
    if (h + 1 < h1) {
      sf.gather(st + (int64_t)(h + 1) * P * N, N, pv, N, SSD_PS, npad);
      xf.gather(x + (r0 * H + h + 1) * P + p0, xs, Q, pv, kpad, SSD_PS);
      d = chunk_dt(dt, r0, H, h + 1, Q);
    }
    float acc[1][4][4] = {};
    if (rows) {
      // y = exp(cs) o (C.state^T)
      warp_mma_3xtf32<1, 4, kExact<T>, false>(
          acc, [&](int m, int k) { return Cs[(i0 + m) * SSD_LDR + k]; },
          [&](int k, int n) { return Ss[(n0 + n) * SSD_LDR + k]; }, npad,
          ntv, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ec = __expf(cs[i0 + gi + (e >> 1) * 8]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) acc[0][nt][e] *= ec;
      }
      // y += ((C.B^T) o L).(x*dt) over j <= the warp's last row
      warp_mma_3xtf32<1, 4, false, false>(
          acc,
          [&](int m, int k) {
            const int i = i0 + m;
            return k <= i ? CB[i * SSD_LDR + k] * __expf(cs[i] - cs[k])
                          : 0.f;
          },
          [&](int k, int n) { return Xs[k * SSD_LDP + n0 + n]; },
          min(kpad, i0 + 16), ntv, lane);
    }
    __syncthreads();                      // Xs is free for y
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(Xs + (i0 + gi + hf * 8) * SSD_LDP + n0
                                   + nt * 8 + 2 * t) =
            make_float2(acc[0][nt][2 * hf], acc[0][nt][2 * hf + 1]);
    __syncthreads();
    store_rows<T, SSD_SCAN_THREADS>(y + (r0 * H + h) * P + p0, xs, Xs,
                                    SSD_LDP, Q, pv);
  }
}

// ---------------------------------------------------------------- launch
static const size_t kCbSmem = 2 * 64 * SSD_LDR * sizeof(float);
static const size_t kStateSmem =
    (SSD_MAX_Q * (SSD_LDN + SSD_LDP) + 3 * SSD_MAX_Q + 8) * sizeof(float);
static const size_t kScanSmem =
    (2 * SSD_MAX_Q * SSD_LDR + SSD_PS * SSD_LDR + SSD_MAX_Q * SSD_LDP
     + 2 * SSD_MAX_Q + 16) * sizeof(float);

static int set_smem(const void* fn, size_t shm) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
}

// Heads a block runs (hb) and runs a group (nhb), so that the blocks of
// (b, chunk, group, P slice) x runs fill the card's resident blocks once
// where they can: longer runs share more loads, more runs more SMs.
static int head_runs(const void* fn, int threads, size_t shm, int R,
                     int64_t base, int* hb, int* nhb) {
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        threads, shm);
  if (err != cudaSuccess) return (int)err;
  int64_t n = (int64_t)sms * per_sm / base;
  n = n < 1 ? 1 : (n > R ? R : n);
  *hb = (int)((R + n - 1) / n);
  *nhb = (R + *hb - 1) / *hb;
  return 0;
}

template <typename T>
static int launch(const void* x, const void* dt, const void* A,
                  const void* Bm, const void* Cm, void* y, void* state,
                  void* cb, void* states, void* csl, int Bsz, int S, int H,
                  int P, int G, int N, int Q, cudaStream_t stream) {
  const void* k_state = (const void*)ssd_chunk_state<T>;
  const void* k_scan = (const void*)ssd_chunk_scan<T>;
  int err;
  if ((err = set_smem((const void*)ssd_cb<T>, kCbSmem)) ||
      (err = set_smem(k_state, kStateSmem)) ||
      (err = set_smem(k_scan, kScanSmem)))
    return err;
  const int nc = S / Q, nps = (P + SSD_PS - 1) / SSD_PS, R = H / G;
  const int tiles = (Q + 63) / 64, pairs = tiles * (tiles + 1) / 2;
  const int64_t base = (int64_t)Bsz * nc * G * nps;
  int hb_state, nhb_state, hb_scan, nhb_scan;
  if ((err = head_runs(k_state, SSD_STATE_THREADS, kStateSmem, R, base,
                       &hb_state, &nhb_state)) ||
      (err = head_runs(k_scan, SSD_SCAN_THREADS, kScanSmem, R, base,
                       &hb_scan, &nhb_scan)))
    return err;
  const int nx = (P * N + 1023) / 1024;          // state pass blocks a head
  if (base * R > 0x7fffffff || (int64_t)Bsz * H > 0x7fffffff || nx > 65535)
    return (int)cudaErrorInvalidValue;

  ssd_cb<T><<<(unsigned)(Bsz * nc * G * pairs), SSD_THREADS, kCbSmem,
              stream>>>((const T*)Bm, (const T*)Cm, (float*)cb, S, G, N, Q,
                        nc, pairs);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_chunk_state<T><<<(unsigned)(base * nhb_state), SSD_STATE_THREADS,
                       kStateSmem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (float*)states, (float*)csl, S, H, P, G, N, Q, nc, nps, hb_state,
      nhb_state);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_state_pass<<<dim3((unsigned)(Bsz * H), (unsigned)nx), 256, 0,
                   stream>>>((float*)states, (const float*)csl,
                             (float*)state, H, P * N, nc);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_chunk_scan<T><<<(unsigned)(base * nhb_scan), SSD_SCAN_THREADS,
                      kScanSmem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Cm,
      (const float*)cb, (const float*)states, (T*)y, S, H, P, G, N, Q, nc,
      nps, hb_scan, nhb_scan);
  return (int)cudaGetLastError();
}

extern "C" {

int ssd_max_chunk() { return SSD_MAX_Q; }

int ssd_max_state() { return SSD_MAX_N; }

const char* ssd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype 0: x, Bm, Cm, y are f32; 1: bf16. dt [B,S,H], A [H] and the state
// [B,H,P,N] are f32. Scratch, f32: cb [B,S/Q,G,Q,Q], states [B,S/Q,H,P,N],
// csl [B,H,S/Q]. All contiguous, on one device. Runs four kernels on the
// stream; returns a cudaError_t (0 = launched).
int ssd_scan(int dtype, const void* x, const void* dt, const void* A,
             const void* Bm, const void* Cm, void* y, void* state,
             void* cb, void* states, void* csl, int Bsz, int S, int H,
             int P, int G, int N, int Q, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 ||
      Q <= 0 || Q > SSD_MAX_Q || N > SSD_MAX_N || S % Q != 0 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(x, dt, A, Bm, Cm, y, state, cb, states, csl, Bsz,
                           S, H, P, G, N, Q, s);
    case 1:
      return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, cb, states,
                                   csl, Bsz, S, H, P, G, N, Q, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
