// flash_gqa for Hopper (sm_90a): blockwise online-softmax attention with
// grouped kv heads, forward only, as a plain C interface loaded with ctypes.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_gqa/
// flash_gqa.py: flash_attention_pallas (body _flash_kernel) together with
// the host-side preparation of its wrapper ops.flash_gqa. Inputs in model
// layout: q [B,S,H,D], k/v [B,S,Hkv,D] and an int32 map kv_head [H] (query
// head h reads kv head kv_head[h]); q, k, v and the output o [B,S,H,D]
// share one type (f32 or bf16). For each (b, h) and query row i:
//   o_i = sum_j softmax_j(q_i . k_j / sqrt(D)) v_j over the keys j with
//   j <= i (causal), j > i - window (window > 0), j < S.
// The scale is that of the true head dim: D is never padded here, and q is
// never rescaled. Running max m, sum l and the accumulator are f32, and
// every product is f32 FMA: the tests hold the f32 kernel to 2e-5, which
// TF32 (about three digits) cannot meet. bf16 inputs are widened on load
// and the output is rounded once on store.
//
// Design. The TPU grid's sequential kv axis is a loop inside one block,
// with m, l and the accumulator in registers for the whole row range. One
// block of 128 threads per (b, h, 64 query rows); blocks are numbered so
// that the last query tiles, which see the most keys under the causal
// mask, start first, and consecutive blocks share a kv head, whose tiles
// then come from L2. The head repeat of the reference wrapper is never
// built: a block reads its kv head through kv_head, which is irregular
// when heads are padded (padded query heads read kv head 0), so no h / rep
// is assumed. Only the kv tiles that hold an unmasked key for some row of
// the block are visited: those wholly above the diagonal or wholly before
// the window are skipped, which leaves m, l and the accumulator exactly as
// a fully masked tile would. Per kv tile of 64 rows:
//   1. K^T [D][64] and V [64][D] into shared memory (Q^T [D][64] was
//      loaded once, before the loop);
//   2. scores: each thread a 4x8 tile (rows 4*rg.., columns 4*cg + 32*j),
//      one float4 of Q^T and two of K^T per 32 FMA; scaled, masked;
//   3. online softmax: the 8 threads of a row group share the row max and
//      sum by warp shuffles; the accumulator rows are rescaled by alpha;
//   4. P [64][64] over K^T (read in full by then), then O += P.V, each
//      thread 4 rows x D/8 columns, P and V read as float4.
// Masked scores are -inf, and a row whose keys are all masked so far keeps
// m = -inf, l = 0 and a zero accumulator (the reference's -1e30 gives the
// same output once the row meets an unmasked key, which every row does:
// its own position).
//
// Bound. At the serve path's shape (B=4, S=512, H=32, Hkv=2, D=128,
// causal) the function needs, over the causal triangle (512*513/2 =
// 131,328 pairs a head), 2 products of 2*128 FLOP a pair for 128 (b, h):
// 8.61 GFLOP; it moves q and o (33.6 MB in bf16) and k and v (2.1 MB).
// In bf16 that is 0.0107 ms of memory at 3.35 TB/s (8.61 GFLOP would take
// 0.0087 ms on the tensor cores); in f32 0.129 ms of f32 FMA at 67
// TFLOP/s, above its 0.021 ms of memory. This kernel computes whole 64x64
// tiles on the diagonal (9.66 GFLOP at that shape) on the f32 pipes in
// either type; bf16 on tensor cores (mma / wgmma), TMA and a pipelined
// tile ring are later work.
//
// Limits: D in {16, 32, 64, 128}; S >= 1; every kv_head[h] in [0, Hkv)
// (the wrapper checks the map). Anything else is cudaErrorInvalidValue.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FA_THREADS 128
#define FA_BQ 64                    // query rows a block
#define FA_BK 64                    // kv rows a tile
#define FA_LDK (FA_BK + 4)          // row of K^T and of P in shared memory
#define FA_MAX_D 128

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
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

// VEC consecutive outputs, rounded to T once
template <int VEC>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  if constexpr (VEC == 4) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&a);
    u.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = a;
  }
}

static inline size_t smem_bytes(int D) {
  const int kt_rows = D > FA_BQ ? D : FA_BQ;   // K^T [D][..], then P [64][..]
  return ((size_t)D * FA_BQ + (size_t)kt_rows * FA_LDK
          + (size_t)FA_BK * D) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS, 2)
flash_gqa_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_head,
              T* __restrict__ o, int S, int H, int Hkv, int BH, int causal,
              int window, float scale) {
  constexpr int VEC = D >= 32 ? 4 : 2;          // output columns a chunk
  constexpr int NCH = D / (8 * VEC);            // chunks a thread owns
  constexpr int DO = VEC * NCH;                 // output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                             // [D][FA_BQ]
  float* Kt = Qt + D * FA_BQ;                   // [D][FA_LDK], then P
  float* Vs = Kt + (D > FA_BQ ? D : FA_BQ) * FA_LDK;   // [FA_BK][D]

  const int n_qt = (S + FA_BQ - 1) / FA_BQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);  // heaviest tiles first
  const int bh = (int)(blockIdx.x % BH);
  const int h = bh % H, b = bh / H;
  const int hk = kv_head[h];
  const int q0 = qt * FA_BQ;
  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;

  const int64_t qs = (int64_t)H * D, ks = (int64_t)Hkv * D;   // row strides
  const T* qb = q + ((int64_t)b * S * H + h) * D;
  const T* kb = k + ((int64_t)b * S * Hkv + hk) * D;
  const T* vb = v + ((int64_t)b * S * Hkv + hk) * D;

  // Q^T, rows fastest across threads (conflict-free transposed stores)
  for (int e = tid; e < FA_BQ * (D / 4); e += FA_THREADS) {
    const int r = e % FA_BQ, d = (e / FA_BQ) * 4;
    const float4 t = q0 + r < S ? load4(qb + (q0 + r) * qs + d)
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
  const int q_end = min(S, q0 + FA_BQ);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_end : S;                       // exclusive
  for (int kt = k_lo / FA_BK; kt <= (k_hi - 1) / FA_BK; ++kt) {
    const int k0 = kt * FA_BK;
    __syncthreads();            // the previous tile's P and V are consumed
    for (int e = tid; e < FA_BK * (D / 4); e += FA_THREADS) {
      const int r = e % FA_BK, d = (e / FA_BK) * 4;
      const float4 t = k0 + r < S ? load4(kb + (k0 + r) * ks + d)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      Kt[(d + 0) * FA_LDK + r] = t.x;
      Kt[(d + 1) * FA_LDK + r] = t.y;
      Kt[(d + 2) * FA_LDK + r] = t.z;
      Kt[(d + 3) * FA_LDK + r] = t.w;
    }
    for (int e = tid; e < FA_BK * (D / 4); e += FA_THREADS) {
      const int r = e / (D / 4), d = (e % (D / 4)) * 4;
      const float4 t = k0 + r < S ? load4(vb + (k0 + r) * ks + d)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(Vs + r * D + d) = t;
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
        const bool ok = kpos < S && (!causal || kpos <= qpos)
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
          lds<VEC>(Vs + (kk + e) * D + cg * VEC + 8 * VEC * jj,
                   vv + jj * VEC);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DO; ++c)
            acc[i][c] = fmaf(pa[i][e], vv[c], acc[i][c]);
      }
    }
  }

  // o = acc / max(l, 1e-30), rounded to T once
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (((int64_t)b * S + r) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < NCH; ++jj) {
      float w[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) w[e] = acc[i][jj * VEC + e] / den;
      store<VEC>(orow + cg * VEC + 8 * VEC * jj, w);
    }
  }
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v,
                  const void* kv_head, void* o, int B, int S, int H,
                  int Hkv, int causal, int window, float scale,
                  cudaStream_t stream) {
  const size_t shm = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_gqa_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_gqa_fwd<T, D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)B * H * ((S + FA_BQ - 1) / FA_BQ);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_gqa_fwd<T, D><<<(unsigned)blocks, FA_THREADS, shm, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)kv_head, (T*)o, S,
      H, Hkv, B * H, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(int D, const void* q, const void* k, const void* v,
                    const void* kv_head, void* o, int B, int S, int H,
                    int Hkv, int causal, int window, float scale,
                    cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, kv_head, o, B, S, H, Hkv, causal,
                           window, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, kv_head, o, B, S, H, Hkv, causal,
                           window, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, kv_head, o, B, S, H, Hkv, causal,
                           window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, kv_head, o, B, S, H, Hkv, causal,
                            window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

int fa_max_head_dim() { return FA_MAX_D; }

const char* fa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype 0: q, k, v, o are f32; 1: bf16. q/o [B,S,H,D], k/v [B,S,Hkv,D],
// kv_head [H] int32, all contiguous on one device; scale multiplies q.k.
// Returns a cudaError_t (0 = launched).
int flash_gqa(int dtype, const void* q, const void* k, const void* v,
              const void* kv_head, void* o, int B, int S, int H, int Hkv,
              int D, int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return dispatch<float>(D, q, k, v, kv_head, o, B, S, H, Hkv, causal,
                             window, scale, s);
    case 1:
      return dispatch<__nv_bfloat16>(D, q, k, v, kv_head, o, B, S, H, Hkv,
                                     causal, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
