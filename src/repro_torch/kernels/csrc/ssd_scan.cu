// Chunked Mamba2 SSD prefill scan for Hopper (sm_90a), in fp32 and bf16.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd/ssd.py:ssd_scan
// and computes what its oracle ref.py:ssd_scan_ref computes, for one B/C
// group: per (batch, head) the recurrence
//   h_t = h_{t-1} * exp(dt_t * a) + dt_t * x_t (outer) b_t ,  y_t = h_t . c_t
// over the (P, N) fp32 state, returning y (B, S, H, P) in x's dtype and the
// final state (B, H, P, N) fp32. x, b and c come in the compute dtype
// (fp32 or bf16), dt (B, S, H) and a (H,) in fp32. S is a multiple of the
// chunk Q = 64: the wrapper pads with dt = 0 rows, which leave the state
// alone (decay 1, weight 0).
//
// The recurrence is evaluated chunk by chunk, as the Pallas kernel does:
// within a chunk of Q tokens, with cum the inclusive cumsum of dt * a,
//   y_i = sum_{j <= i} (c_i . b_j) exp(cum_i - cum_j) dt_j x_j
//       + exp(cum_i) c_i . S                           (S: state before the chunk)
//   S  <- S exp(cum_Q) + sum_j exp(cum_Q - cum_j) dt_j x_j (outer) b_j .
// The causal mask sits inside the exponent: exp is taken only for j <= i,
// where cum_i - cum_j <= 0 (for j > i it is large and positive).
//
// What bounds it on this card: operations. Per token and head the chunked
// form does about 2 N P (inter-chunk term) + 2 N P (state pass) + Q P
// (intra-chunk term) fp32 FMAs against P (x) + P (y) elements of traffic:
// at P = 64, N = 128 in bf16, ~130 flops per byte, far above the ~20 flops
// per byte that the CUDA cores' fp32 rate allows over HBM bandwidth.
//
// What the design does about it:
// - Parallelism. The TPU grid (B, H / 8, S / Q) is 10 programs at B = 1,
//   H = 80, and its chunk axis runs in order. Here a loop over the chunks
//   inside the CTA carries the state, and the grid is (P / 32, H, B): each
//   CTA owns 32 rows of one head's (P, N) state (rows of the state update
//   independently, given the shared c.b and decay terms), 160 CTAs for
//   mamba2-4b, two resident per SM.
// - c_i . b_j is the same for every head (one group), so a first kernel
//   computes it once per chunk, (B, S / Q, Q, Q) fp32 in a scratch buffer,
//   and the scan kernel reads it: it would otherwise cost each CTA as much
//   as its own work.
// - Each chunk's b, c, x slice and c.b tile are staged in shared memory as
//   fp32; the intra- and inter-chunk terms are register-tiled (one output
//   row i, 8 state rows per thread; shared rows padded to avoid bank
//   conflicts), and the state pass keeps each thread's 2 x N/16 block of the
//   state in registers for the whole sequence, with a transposed copy in
//   shared memory for the next chunk's inter-chunk term.
// - The chunk is 64, not the model's 256: the Q x Q fp32 tile of a 256
//   chunk alone is 256 KB, over the 227 KB a block can use. The chunked
//   decomposition is exact for any chunk.
// - The next redesign: the three products on tensor cores (mma.sync /
//   wgmma, tf32 or bf16 inputs with fp32 accumulation).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;         // chunk length
constexpr int PS = 32;        // state rows (head-dim slice) per CTA
constexpr int THREADS = 256;
static_assert(THREADS == Q * PS / 8, "y pass: one row and 8 state rows per thread");
static_assert(THREADS == 16 * PS / 2, "state pass: 2 state rows x N/16 columns per thread");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                            pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

template <int N>
constexpr size_t cb_smem_bytes() { return sizeof(float) * 2 * Q * (N + 1); }

template <int N>
constexpr size_t scan_smem_bytes() {
  return sizeof(float) * (Q * N          // b rows
                          + Q * (N + 1)  // c rows, padded
                          + Q * (Q + 1)  // decay-weighted c.b tile, padded
                          + Q * PS       // x slice (then x scaled by u)
                          + N * PS       // state, transposed
                          + 4 * Q);      // cum, dt, u, exp(cum)
}

// cb[b, z, i, j] = c[b, zQ + i] . b[b, zQ + j]; grid (S / Q, B)
template <typename T, int N>
__global__ void __launch_bounds__(THREADS) ssd_cb_kernel(const T* __restrict__ bm,
                                                         const T* __restrict__ cm,
                                                         float* __restrict__ cb, int S) {
  extern __shared__ float smem[];
  float* sB = smem;                // Q x (N + 1)
  float* sC = smem + Q * (N + 1);  // Q x (N + 1)
  const int z = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const size_t base = ((size_t)bi * S + (size_t)z * Q) * N;
  for (int e = tid; e < Q * N; e += THREADS) {
    const int r = e / N, n = e % N;
    sB[r * (N + 1) + n] = to_f(bm[base + e]);
    sC[r * (N + 1) + n] = to_f(cm[base + e]);
  }
  __syncthreads();
  // thread: column j (consecutive in a warp), rows i = ig + 4m
  const int j = tid % Q, ig = tid / Q;
  float acc[Q / 4];
#pragma unroll
  for (int m = 0; m < Q / 4; ++m) acc[m] = 0.f;
  for (int n = 0; n < N; ++n) {
    const float bv = sB[j * (N + 1) + n];
#pragma unroll
    for (int m = 0; m < Q / 4; ++m) acc[m] = fmaf(sC[(ig + 4 * m) * (N + 1) + n], bv, acc[m]);
  }
  float* out = cb + ((size_t)bi * (S / Q) + z) * Q * Q;
#pragma unroll
  for (int m = 0; m < Q / 4; ++m) out[(ig + 4 * m) * Q + j] = acc[m];
}

// grid (P / PS, H, B)
template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 2) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ bm, const T* __restrict__ cm, const float* __restrict__ cb,
    T* __restrict__ y, float* __restrict__ fs, int S, int H, int P) {
  constexpr int NV = N / 16;             // state columns per thread in the state pass
  constexpr int VW = NV < 4 ? NV : 4;    // ... read VW at a time
  constexpr int NM = NV / VW;
  extern __shared__ float smem[];
  float* sB = smem;                      // Q x N
  float* sC = sB + Q * N;                // Q x (N + 1)
  float* sW = sC + Q * (N + 1);          // Q x (Q + 1)
  float* sX = sW + Q * (Q + 1);          // Q x PS
  float* sSt = sX + Q * PS;              // N x PS
  float* sCum = sSt + N * PS;            // Q
  float* sDt = sCum + Q;                 // Q
  float* sU = sDt + Q;                   // Q
  float* sE = sU + Q;                    // Q

  const int p_base = blockIdx.x * PS, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int nc = S / Q;
  const float a_h = a[h];

  // y pass: output row yi, state rows yp .. yp + 7
  const int yi = tid % Q, yp = (tid / Q) * 8;
  // state pass: state rows p2, p2 + 1; columns VW * ng + 16 * VW * m + e
  const int ng = tid % 16, p2 = (tid / 16) * 2;
  float st[2][NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) st[0][v] = st[1][v] = 0.f;
  for (int e = tid; e < N * PS; e += THREADS) sSt[e] = 0.f;

  for (int z = 0; z < nc; ++z) {
    const size_t tok0 = (size_t)bi * S + (size_t)z * Q;   // first token row of the chunk
    // ---- stage the chunk
    if (tid < Q) sDt[tid] = dt[(tok0 + tid) * H + h];
    for (int e = tid; e < Q * N; e += THREADS) {
      const int r = e / N, n = e % N;
      sB[e] = to_f(bm[tok0 * N + e]);
      sC[r * (N + 1) + n] = to_f(cm[tok0 * N + e]);
    }
    for (int e = tid; e < Q * PS; e += THREADS) {
      const int r = e / PS, p = e % PS;
      sX[e] = to_f(x[((tok0 + r) * H + h) * P + p_base + p]);
    }
    __syncthreads();
    // ---- inclusive cumsum of dt * a over the chunk: warp 0, two tokens a lane
    if (tid < 32) {
      const float v0 = sDt[2 * tid] * a_h, v1 = sDt[2 * tid + 1] * a_h;
      float s = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, s, off);
        if (tid >= off) s += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) excl = 0.f;
      sCum[2 * tid] = excl + v0;
      sCum[2 * tid + 1] = excl + v0 + v1;
    }
    __syncthreads();
    const float cum_last = sCum[Q - 1];
    // ---- decay-weighted tile W[i][j] = cb[i][j] exp(cum_i - cum_j) dt_j, j <= i
    const float* cbz = cb + ((size_t)bi * nc + z) * Q * Q;
    for (int e = tid; e < Q * Q; e += THREADS) {
      const int i = e / Q, j = e % Q;
      float w = 0.f;
      if (j <= i) w = cbz[e] * expf(sCum[i] - sCum[j]) * sDt[j];
      sW[i * (Q + 1) + j] = w;
    }
    if (tid < Q) {
      sU[tid] = expf(cum_last - sCum[tid]) * sDt[tid];
      sE[tid] = expf(sCum[tid]);
    }
    __syncthreads();
    // ---- y rows: intra-chunk term + exp(cum_i) c_i . S
    {
      float acc[8], inter[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = inter[k] = 0.f;
      const float* wrow = sW + yi * (Q + 1);
      for (int j = 0; j <= yi; ++j) {
        const float w = wrow[j];
        const float4 x0 = *reinterpret_cast<const float4*>(sX + j * PS + yp);
        const float4 x1 = *reinterpret_cast<const float4*>(sX + j * PS + yp + 4);
        acc[0] = fmaf(w, x0.x, acc[0]);
        acc[1] = fmaf(w, x0.y, acc[1]);
        acc[2] = fmaf(w, x0.z, acc[2]);
        acc[3] = fmaf(w, x0.w, acc[3]);
        acc[4] = fmaf(w, x1.x, acc[4]);
        acc[5] = fmaf(w, x1.y, acc[5]);
        acc[6] = fmaf(w, x1.z, acc[6]);
        acc[7] = fmaf(w, x1.w, acc[7]);
      }
      const float* crow = sC + yi * (N + 1);
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float c = crow[n];
        const float4 s0 = *reinterpret_cast<const float4*>(sSt + n * PS + yp);
        const float4 s1 = *reinterpret_cast<const float4*>(sSt + n * PS + yp + 4);
        inter[0] = fmaf(c, s0.x, inter[0]);
        inter[1] = fmaf(c, s0.y, inter[1]);
        inter[2] = fmaf(c, s0.z, inter[2]);
        inter[3] = fmaf(c, s0.w, inter[3]);
        inter[4] = fmaf(c, s1.x, inter[4]);
        inter[5] = fmaf(c, s1.y, inter[5]);
        inter[6] = fmaf(c, s1.z, inter[6]);
        inter[7] = fmaf(c, s1.w, inter[7]);
      }
      const float e = sE[yi];
      float out[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) out[k] = fmaf(e, inter[k], acc[k]);
      store8(y + ((tok0 + yi) * H + h) * P + p_base + yp, out);
    }
    __syncthreads();
    // ---- state pass: S <- S exp(cum_Q) + sum_j (u_j x_j) (outer) b_j
    for (int e = tid; e < Q * PS; e += THREADS) sX[e] *= sU[e / PS];
    __syncthreads();
    const float decay = expf(cum_last);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      st[0][v] *= decay;
      st[1][v] *= decay;
    }
    for (int j = 0; j < Q; ++j) {
      const float2 xu = *reinterpret_cast<const float2*>(sX + j * PS + p2);
      const float* brow = sB + j * N + VW * ng;
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        float bv[VW];
        if constexpr (VW == 4) {
          const float4 t = *reinterpret_cast<const float4*>(brow + 16 * VW * m);
          bv[0] = t.x; bv[1] = t.y; bv[2] = t.z; bv[3] = t.w;
        } else {
#pragma unroll
          for (int e = 0; e < VW; ++e) bv[e] = brow[16 * VW * m + e];
        }
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          st[0][m * VW + e] = fmaf(xu.x, bv[e], st[0][m * VW + e]);
          st[1][m * VW + e] = fmaf(xu.y, bv[e], st[1][m * VW + e]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int n = VW * ng + 16 * VW * m + e;
        *reinterpret_cast<float2*>(sSt + n * PS + p2) =
            make_float2(st[0][m * VW + e], st[1][m * VW + e]);
      }
    __syncthreads();
  }
  // ---- final state (B, H, P, N)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = fs + (((size_t)bi * H + h) * P + p_base + p2 + r) * N;
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int e = 0; e < VW; ++e) row[VW * ng + 16 * VW * m + e] = st[r][m * VW + e];
  }
}

template <typename T, int N>
int launch_n(const void* x, const void* dt, const void* a, const void* b, const void* c,
             void* cb, void* y, void* fs, int B, int S, int H, int P, cudaStream_t stream) {
  // above 48 KB a kernel's dynamic shared memory must be opted into, once
  static const cudaError_t attr_cb = cudaFuncSetAttribute(
      ssd_cb_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cb_smem_bytes<N>());
  static const cudaError_t attr_scan =
      cudaFuncSetAttribute(ssd_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)scan_smem_bytes<N>());
  if (attr_cb != cudaSuccess) return (int)attr_cb;
  if (attr_scan != cudaSuccess) return (int)attr_scan;
  ssd_cb_kernel<T, N><<<dim3(S / Q, B), THREADS, cb_smem_bytes<N>(), stream>>>(
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<float*>(cb), S);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T, N><<<dim3(P / PS, H, B), THREADS, scan_smem_bytes<N>(), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<const float*>(cb),
      static_cast<T*>(y), static_cast<float*>(fs), S, H, P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c, void* cb,
           void* y, void* fs, int B, int S, int H, int P, int N, cudaStream_t stream) {
  if (B < 1 || S < Q || S % Q || H < 1 || P < PS || P % PS) return (int)cudaErrorInvalidValue;
  switch (N) {
    case 16: return launch_n<T, 16>(x, dt, a, b, c, cb, y, fs, B, S, H, P, stream);
    case 32: return launch_n<T, 32>(x, dt, a, b, c, cb, y, fs, B, S, H, P, stream);
    case 64: return launch_n<T, 64>(x, dt, a, b, c, cb, y, fs, B, S, H, P, stream);
    case 128: return launch_n<T, 128>(x, dt, a, b, c, cb, y, fs, B, S, H, P, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B,S,H,P), dt (B,S,H) fp32, a (H,) fp32, b/c (B,S,N), cb scratch
// (B, S/64, 64, 64) fp32 -> y (B,S,H,P) in x's dtype, fs (B,H,P,N) fp32.
// Returns cudaGetLastError() after the launches (0 on success).
#define SSD_SCAN_LAUNCHER(NAME, T)                                                             \
  extern "C" int NAME(const void* x, const void* dt, const void* a, const void* b,            \
                      const void* c, void* cb, void* y, void* fs, int B, int S, int H, int P, \
                      int N, void* stream) {                                                  \
    return launch<T>(x, dt, a, b, c, cb, y, fs, B, S, H, P, N,                               \
                     static_cast<cudaStream_t>(stream));                                       \
  }

SSD_SCAN_LAUNCHER(ssd_scan_f32, float)
SSD_SCAN_LAUNCHER(ssd_scan_bf16, __nv_bfloat16)
