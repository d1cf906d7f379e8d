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
// with the state before the chunk's update in y. All arithmetic is f32
// FMA: the tests hold it to 2e-4, which TF32 (about three digits) cannot.
//
// Design. The TPU grid's sequential chunk axis is a loop inside one block;
// the state [N, 32] lives in shared memory for the whole sequence. One
// block per (b, h, 32-column slice of P): the y and state columns of a
// slice depend only on the x columns of that slice, while C.B^T and L do
// not depend on P, so splitting P halves the shared memory a block needs
// and doubles the blocks (640 at B=4, H=80, P=64) at the price of
// computing C.B^T once per slice. B and C are read at group layout (head h
// reads group h / (H/G)); the head repeat of the reference wrapper is never
// built. x*dt and dt*A are folded here, on load, not in the wrapper. Per
// chunk, with 256 threads:
//   1. load B^T, C^T [N, Q] (transposed, so the products below read four
//      consecutive rows at once), x*dt [Q, 32] and dt*A; thread 0 takes the
//      cumsum in order; exp(cs) and exp(cs_last - cs) per row;
//   2. y  = C.state (lanes over p, 16 rows a warp), before the update;
//   3. C.B^T into registers, 8x8 scores a thread (rows ty*4.., 64+ty*4..;
//      the block i < 64 <= j is all above the diagonal and skipped), then
//      scaled by L and stored over C^T once every thread has read it;
//   4. y += S.(x*dt) over j <= the warp's last row, y written in x's type;
//   5. state = exp(cs_last).state + B^T.(exp(cs_last - cs) o x*dt).
// After the last chunk the state is written out [P, N]-major through
// shared memory so the stores run along N.
//
// Bound: operations. At the serve path's shape (B=4, S=512, H=80, P=64,
// G=1, N=128, Q=128) the function needs, counting the causal triangle
// only (Q(Q+1)/2 = 8256 pairs): C.B^T once per (b, group, chunk),
// 2*8256*128 FLOP over 16 such triples, as it does not depend on the
// head; per (b*h, chunk) 2*8256*64 (S.xdt) + 2*2*128*128*64 (C.state,
// B^T.xdt) = 5.25 MFLOP over 1280 pairs. That is 6.76 GFLOP, 0.101 ms at
// 67 TFLOP/s (f32, no tensor cores), against about 54 MB moved (0.016 ms
// at 3.35 TB/s). This kernel computes C.B^T once per (head, P slice),
// 3/4 of the square each time, with one block of 8 warps an SM; a C.B^T
// shared across heads, mma with a 3xTF32 split, TMA and a chunk-parallel
// state pass are later work.
//
// Limits: Q <= 128 and N <= 128 (shared memory: 170 KB at Q = N = 128);
// S a multiple of Q; G divides H. Anything else is cudaErrorInvalidValue.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SSD_THREADS 256
#define SSD_MAX_Q 128
#define SSD_MAX_N 128
#define SSD_PS 32                   // columns of P a block owns
#define SSD_STP (SSD_PS + 1)        // padded row of the state in shared memory

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

static inline int tile_rows(int Q) { return Q <= 64 ? 64 : SSD_MAX_Q; }

// floats of shared memory: B^T, C^T / S, x*dt, state, cs, exp(cs), decay
static inline size_t smem_floats(int N, int Q) {
  const int qt = tile_rows(Q), ld = qt + 4;
  return (size_t)N * ld + (size_t)(N > qt ? N : qt) * ld
         + (size_t)qt * SSD_PS + (size_t)N * SSD_STP + 3 * (size_t)qt;
}

template <typename T>
__global__ void __launch_bounds__(SSD_THREADS, 1)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, T* __restrict__ y,
               float* __restrict__ state_out, int S, int H, int P, int G,
               int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int qt = Q <= 64 ? 64 : SSD_MAX_Q;     // rows of the score tile
  const bool hi = qt > 64;                      // second 64-row half in use
  const int ld = qt + 4;                        // keeps rows 16-byte aligned
  float* Bt = smem;                             // [N][ld]
  float* CS = Bt + (size_t)N * ld;              // C^T [N][ld], then S [qt][ld]
  float* xdt = CS + (size_t)(N > qt ? N : qt) * ld;   // [qt][SSD_PS]
  float* st = xdt + qt * SSD_PS;                // [N][SSD_STP]
  float* cs = st + N * SSD_STP;                 // [qt]
  float* ecs = cs + qt;                         // exp(cs_i)
  float* dec = ecs + qt;                        // exp(cs_last - cs_i)

  const int nps = (P + SSD_PS - 1) / SSD_PS;
  const int slice = blockIdx.x % nps;
  const int bh = blockIdx.x / nps;
  const int h = bh % H, b = bh / H;
  const int g = h / (H / G);
  const int p0 = slice * SSD_PS;
  const int pv = min(SSD_PS, P - p0);           // valid columns of the slice
  const float a = A[h];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int i0 = warp * 16;                     // y rows / state rows of a warp

  for (int e = tid; e < N * SSD_STP; e += SSD_THREADS) st[e] = 0.f;

  for (int c = 0; c < S / Q; ++c) {
    const int64_t r0 = (int64_t)b * S + (int64_t)c * Q;   // first (b, s) row
    // 1. load; rows Q..qt-1 are zeros, so every loop below may run to a
    //    multiple of 4 rows
    for (int e = tid; e < qt * N; e += SSD_THREADS) {
      const int i = e / N, n = e - i * N;
      float bv = 0.f, cv = 0.f;
      if (i < Q) {
        const int64_t off = ((r0 + i) * G + g) * N + n;
        bv = to_f(Bm[off]);
        cv = to_f(Cm[off]);
      }
      Bt[n * ld + i] = bv;
      CS[n * ld + i] = cv;
    }
    for (int e = tid; e < qt * SSD_PS; e += SSD_THREADS) {
      const int i = e / SSD_PS, p = e - i * SSD_PS;
      float v = 0.f;
      if (i < Q && p < pv) {
        const int64_t r = r0 + i;
        v = to_f(x[(r * H + h) * P + p0 + p]) * dt[r * H + h];
      }
      xdt[e] = v;
    }
    for (int i = tid; i < Q; i += SSD_THREADS) cs[i] = dt[(r0 + i) * H + h] * a;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int i = 0; i < Q; ++i) { s += cs[i]; cs[i] = s; }
    }
    __syncthreads();
    const float cl = cs[Q - 1];
    for (int i = tid; i < qt; i += SSD_THREADS) {
      ecs[i] = i < Q ? expf(cs[i]) : 0.f;
      dec[i] = i < Q ? expf(cl - cs[i]) : 0.f;
    }

    // 2. y = C.state with the state before this chunk (scaled by exp(cs)
    //    after the next barrier, which also publishes ecs)
    float yacc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) yacc[k] = 0.f;
    if (i0 < Q) {
      for (int n = 0; n < N; ++n) {
        const float sv = st[n * SSD_STP + lane];
        const float4* cp = reinterpret_cast<const float4*>(CS + n * ld + i0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 cv = cp[q];
          yacc[4 * q + 0] += cv.x * sv;
          yacc[4 * q + 1] += cv.y * sv;
          yacc[4 * q + 2] += cv.z * sv;
          yacc[4 * q + 3] += cv.w * sv;
        }
      }
    }

    // 3. scores C.B^T: thread rows {ty*4+r} u {64+ty*4+r}, same for columns
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float* cr = CS + n * ld;
      const float* br = Bt + n * ld;
      const float4 cl4 = *reinterpret_cast<const float4*>(cr + ty * 4);
      const float4 bl4 = *reinterpret_cast<const float4*>(br + tx * 4);
      const float cv[4] = {cl4.x, cl4.y, cl4.z, cl4.w};
      const float bv[4] = {bl4.x, bl4.y, bl4.z, bl4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] += cv[r] * bv[s];
      if (hi) {
        const float4 ch4 = *reinterpret_cast<const float4*>(cr + 64 + ty * 4);
        const float4 bh4 = *reinterpret_cast<const float4*>(br + 64 + tx * 4);
        const float cw[4] = {ch4.x, ch4.y, ch4.z, ch4.w};
        const float bw[4] = {bh4.x, bh4.y, bh4.z, bh4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            acc[4 + r][s] += cw[r] * bv[s];
            acc[4 + r][4 + s] += cw[r] * bw[s];
          }
      }
    }
    __syncthreads();          // every read of C^T and of the state is done

    if (i0 < Q) {
#pragma unroll
      for (int k = 0; k < 16; ++k) yacc[k] *= ecs[i0 + k];
    }
    float* Sm = CS;           // S [qt][ld] over C^T
#pragma unroll
    for (int rb = 0; rb < 2; ++rb)
#pragma unroll
      for (int sb = 0; sb < 2; ++sb) {
        if ((rb || sb) && !hi) continue;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = rb * 64 + ty * 4 + r;
          const float csi = cs[i < Q ? i : 0];
          float v[4];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int j = sb * 64 + tx * 4 + s;
            // j <= i < Q; the block i < 64 <= j was never summed
            v[s] = (j <= i && i < Q)
                       ? acc[rb * 4 + r][sb * 4 + s] * expf(csi - cs[j])
                       : 0.f;
          }
          *reinterpret_cast<float4*>(Sm + i * ld + sb * 64 + tx * 4) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    __syncthreads();

    // 4. y += S.(x*dt); S[i][j] = 0 for j > i, so a warp stops at its last row
    if (i0 < Q) {
      const int jend = min(i0 + 16, Q);
      for (int j = 0; j < jend; j += 4) {
        const float x0 = xdt[(j + 0) * SSD_PS + lane];
        const float x1 = xdt[(j + 1) * SSD_PS + lane];
        const float x2 = xdt[(j + 2) * SSD_PS + lane];
        const float x3 = xdt[(j + 3) * SSD_PS + lane];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const float4 sv =
              *reinterpret_cast<const float4*>(Sm + (i0 + k) * ld + j);
          yacc[k] += sv.x * x0 + sv.y * x1 + sv.z * x2 + sv.w * x3;
        }
      }
      if (lane < pv) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int i = i0 + k;
          if (i < Q) y[((r0 + i) * H + h) * P + p0 + lane] = from_f<T>(yacc[k]);
        }
      }
    }

    // 5. state = exp(cs_last).state + B^T.(exp(cs_last - cs) o x*dt); each
    //    thread owns state rows i0.. of column lane
    if (i0 < N) {
      float sacc[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) sacc[k] = 0.f;
      for (int j = 0; j < Q; j += 4) {
        const float x0 = xdt[(j + 0) * SSD_PS + lane] * dec[j + 0];
        const float x1 = xdt[(j + 1) * SSD_PS + lane] * dec[j + 1];
        const float x2 = xdt[(j + 2) * SSD_PS + lane] * dec[j + 2];
        const float x3 = xdt[(j + 3) * SSD_PS + lane] * dec[j + 3];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          if (i0 + k < N) {
            const float4 bv =
                *reinterpret_cast<const float4*>(Bt + (i0 + k) * ld + j);
            sacc[k] += bv.x * x0 + bv.y * x1 + bv.z * x2 + bv.w * x3;
          }
        }
      }
      const float ecl = expf(cl);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (i0 + k < N) {
          float* sp = st + (i0 + k) * SSD_STP + lane;
          *sp = ecl * *sp + sacc[k];
        }
      }
    }
    __syncthreads();          // before the next chunk overwrites the tiles
  }

  for (int e = tid; e < pv * N; e += SSD_THREADS) {
    const int p = e / N, n = e - p * N;
    state_out[(((int64_t)b * H + h) * P + p0 + p) * N + n] = st[n * SSD_STP + p];
  }
}

template <typename T>
static int launch(const void* x, const void* dt, const void* A,
                  const void* Bm, const void* Cm, void* y, void* state,
                  int Bsz, int S, int H, int P, int G, int N, int Q,
                  cudaStream_t stream) {
  const size_t shm = smem_floats(N, Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks =
      (int64_t)Bsz * H * ((P + SSD_PS - 1) / SSD_PS);
  ssd_chunk_scan<T><<<(unsigned)blocks, SSD_THREADS, shm, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (T*)y, (float*)state, S, H, P, G, N, Q);
  return (int)cudaGetLastError();
}

extern "C" {

int ssd_max_chunk() { return SSD_MAX_Q; }

int ssd_max_state() { return SSD_MAX_N; }

const char* ssd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype 0: x, Bm, Cm, y are f32; 1: bf16. dt [B,S,H], A [H] and the state
// [B,H,P,N] are f32. All contiguous, on one device. Returns a cudaError_t
// (0 = launched).
int ssd_scan(int dtype, const void* x, const void* dt, const void* A,
             const void* Bm, const void* Cm, void* y, void* state, int Bsz,
             int S, int H, int P, int G, int N, int Q, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 ||
      Q <= 0 || Q > SSD_MAX_Q || N > SSD_MAX_N || S % Q != 0 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P, G, N,
                           Q, s);
    case 1:
      return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, Bsz, S, H,
                                   P, G, N, Q, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
