// Chunked Mamba2 SSD prefill scan for Hopper (sm_90a), in fp32 and bf16.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd/ssd.py:ssd_scan
// and computes what its oracle ref.py:ssd_scan_ref computes, for G B/C
// groups (the Pallas kernel takes one): per (batch, head) the recurrence
//   h_t = h_{t-1} * exp(dt_t * a) + dt_t * x_t (outer) b_t ,  y_t = h_t . c_t
// over the (P, N) fp32 state, returning y (B, S, H, P) in x's dtype and the
// final state (B, H, P, N) fp32. x, b and c come in the compute dtype
// (fp32 or bf16), dt (B, S, H) and a (H,) in fp32; b and c are (B, S, G, N)
// and head h reads group g = h / (H / G) (G = 1: (B, S, N), the same launch). S is a multiple of the
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
// What bounds it on this card: bytes. At mamba2-4b's prefill of 512 tokens
// (H = 80, P = 64, N = 128, bf16) the call must move 13.5 MB (x and y, b
// and c, dt, the fp32 final state), 0.0040 ms at 3.35 TB/s; its ~1.5 GFLOP
// of chunked products take 0.0015 ms at the bf16 tensor-core rate. What it
// costs in practice is the sequential chunk loop: 8 chunks, each a chain of
// staging, three products and a state update, per CTA.
//
// 1. bf16: ssd_tc_kernel, on the tensor cores. Grid (P / PS, H, B), PS = 64
//   state rows a CTA where 64 divides P (80 CTAs for mamba2-4b), else 32;
//   the chunk loop runs inside the CTA, the state stays on chip across
//   chunks.
// - Four compute warps, warp w owning chunk rows 16w .. 16w + 15, run every
//   product on mma.sync.m16n8k16 (bf16 in, fp32 accumulate): c.b = C B^T
//   (computed in the CTA, no pre-pass), its accumulator scaled by the decay
//   weights into W directly in the A-operand layout; y = W x + diag(2^cum)
//   C H^T; and H <- 2^cum_Q H + (u x)^T b with the state held in fp32
//   accumulator registers for the whole sequence, a bf16 copy in shared
//   memory (double-buffered) the operand of the next chunk's C H^T. b and x
//   are staged token-major and come through ldmatrix.trans where a
//   fragment needs them the other way round. Every warp computes all of
//   c.b's column tiles, the masked ones included: a warp-dependent branch in
//   the unrolled loops cost more than the extra products.
// - A fifth warp stages chunk z + 1 (b, c, the x slice and dt by cp.async,
//   into the other of two buffers) and computes its cumsum and u while the
//   compute warps work on chunk z; the two sides meet at one named barrier
//   a chunk. Issuing ~2,600 16-byte copies a chunk had stalled the compute
//   warps for about a fifth of the chunk. (TMA bulk copies, one per row,
//   were slower.) The compute warps take W's decay weights, 2^cum_i and u
//   from shared memory before the first product, so their exps overlap it.
// - Precision: x, b and c are bf16 already; W (fp32 c.b times fp32 decay
//   weights) is rounded once to bf16, and so is H for the inter-chunk
//   product -- both feed y, which is bf16. u x, which feeds the fp32 state,
//   is split into two bf16 halves (hi + lo, ~2^-16 relative) and multiplied
//   twice, so that the final state holds to the fp32 tolerance.
//
// 2. fp32: ssd_cb_kernel + ssd_scan_kernel, the first design on the CUDA
//   cores (fp32 would need 3xTF32 to hold its 2e-4 tolerance on the tensor
//   cores). A first kernel computes c_i . b_j once per chunk and group into a
//   scratch buffer (the same for every head of the group); the scan kernel's grid is
//   (P / 32, H, B), each chunk's b, c, x slice and c.b tile staged as fp32
//   in shared memory, the intra- and inter-chunk terms register-tiled and
//   each thread's 2 x N/16 block of the state in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr int Q = 64;         // chunk length
constexpr int PS = 32;        // state rows (head-dim slice) per CTA
constexpr int THREADS = 256;
static_assert(THREADS == Q * PS / 8, "y pass: one row and 8 state rows per thread");
static_assert(THREADS == 16 * PS / 2, "state pass: 2 state rows x N/16 columns per thread");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
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

// cb[b, g, z, i, j] = c[b, zQ + i, g] . b[b, zQ + j, g]; grid (S / Q, G, B)
template <typename T, int N>
__global__ void __launch_bounds__(THREADS) ssd_cb_kernel(const T* __restrict__ bm,
                                                         const T* __restrict__ cm,
                                                         float* __restrict__ cb, int S,
                                                         int G) {
  extern __shared__ float smem[];
  float* sB = smem;                // Q x (N + 1)
  float* sC = smem + Q * (N + 1);  // Q x (N + 1)
  const int z = blockIdx.x, g = blockIdx.y, bi = blockIdx.z, tid = threadIdx.x;
  const size_t tok0 = (size_t)bi * S + (size_t)z * Q;
  for (int e = tid; e < Q * N; e += THREADS) {
    const int r = e / N, n = e % N;
    const size_t at = ((tok0 + r) * G + g) * N + n;
    sB[r * (N + 1) + n] = to_f(bm[at]);
    sC[r * (N + 1) + n] = to_f(cm[at]);
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
  float* out = cb + (((size_t)bi * G + g) * (S / Q) + z) * Q * Q;
#pragma unroll
  for (int m = 0; m < Q / 4; ++m) out[(ig + 4 * m) * Q + j] = acc[m];
}

// grid (P / PS, H, B)
template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 2) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ bm, const T* __restrict__ cm, const float* __restrict__ cb,
    T* __restrict__ y, float* __restrict__ fs, int S, int H, int P, int G) {
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
  const int g = h / (H / G);  // this head's B/C group
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
      const size_t at = ((tok0 + r) * G + g) * N + n;
      sB[e] = to_f(bm[at]);
      sC[r * (N + 1) + n] = to_f(cm[at]);
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
    const float* cbz = cb + (((size_t)bi * G + g) * nc + z) * Q * Q;
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
             void* cb, void* y, void* fs, int B, int S, int H, int P, int G,
             cudaStream_t stream) {
  // above 48 KB a kernel's dynamic shared memory must be opted into, once
  static const cudaError_t attr_cb = cudaFuncSetAttribute(
      ssd_cb_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cb_smem_bytes<N>());
  static const cudaError_t attr_scan =
      cudaFuncSetAttribute(ssd_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)scan_smem_bytes<N>());
  if (attr_cb != cudaSuccess) return (int)attr_cb;
  if (attr_scan != cudaSuccess) return (int)attr_scan;
  ssd_cb_kernel<T, N><<<dim3(S / Q, G, B), THREADS, cb_smem_bytes<N>(), stream>>>(
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<float*>(cb), S, G);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T, N><<<dim3(P / PS, H, B), THREADS, scan_smem_bytes<N>(), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<const float*>(cb),
      static_cast<T*>(y), static_cast<float*>(fs), S, H, P, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c, void* cb,
           void* y, void* fs, int B, int S, int H, int P, int N, int G, cudaStream_t stream) {
  if (B < 1 || S < Q || S % Q || H < 1 || P < PS || P % PS || G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
  switch (N) {
    case 16: return launch_n<T, 16>(x, dt, a, b, c, cb, y, fs, B, S, H, P, G, stream);
    case 32: return launch_n<T, 32>(x, dt, a, b, c, cb, y, fs, B, S, H, P, G, stream);
    case 64: return launch_n<T, 64>(x, dt, a, b, c, cb, y, fs, B, S, H, P, G, stream);
    case 128: return launch_n<T, 128>(x, dt, a, b, c, cb, y, fs, B, S, H, P, G, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
namespace tc {

using namespace sm90;
using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

// Q-token chunks, PS state rows (head-dim slice) a CTA, state dim N: compute
// warp w owns chunk rows 16w .. 16w + 15, and one more warp stages the next
// chunk.
template <int PS, int N>
struct Tile {
  static constexpr int WARPS = Q / 16;            // compute warps
  static constexpr int THREADS = 32 * (WARPS + 1);  // and the staging warp, WARPS
  static constexpr int LDN = N + 8, LDX = PS + 8;  // padded rows: conflict-free ldmatrix
  static constexpr int MT = PS / 16, NT = N / 8;  // the state's 16x8 tiles ...
  static constexpr int TPW = (MT * NT + WARPS - 1) / WARPS;  // ... and a warp's share
  // one staged chunk: b, c (Q x N), x (Q x PS) in bf16; dt, cum, u (Q) in fp32
  static constexpr int BUF = (2 * Q * LDN + Q * LDX) * 2 + 3 * Q * 4;
  static constexpr int HBUF = PS * LDN * 2;       // bf16 copy of the state slice
  static constexpr int BYTES = 2 * BUF + 2 * HBUF;
  static_assert(Q % 32 == 0 && PS % 16 == 0 && N % 16 == 0, "tile shapes");
  static_assert(TPW == 1 || (NT % TPW == 0 && TPW % 2 == 0), "a warp's state tiles share a row");
};

// x scaled by u (fp32), as bf16 hi + lo: hi + lo = x u to ~2^-16
__device__ __forceinline__ void split(uint32_t xv, float u0, float u1, uint32_t& hi,
                                      uint32_t& lo) {
  const float2 v = unpack(xv);
  const float a = v.x * u0, b = v.y * u1;
  hi = pack(a, b);
  const float2 h = unpack(hi);
  lo = pack(a - h.x, b - h.y);
}

// grid (P / PS, H, B)
template <int PS, int N>
__global__ void __launch_bounds__(Tile<PS, N>::THREADS) ssd_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const bf16* __restrict__ bm, const bf16* __restrict__ cm, bf16* __restrict__ y,
    float* __restrict__ fs, int S, int H, int P, int G) {
  using T = Tile<PS, N>;
  constexpr int WARPS = T::WARPS, THREADS = T::THREADS, LDN = T::LDN, LDX = T::LDX;
  constexpr int NT = T::NT, TPW = T::TPW, YN = PS / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* const smem = tc_smem;
  const int p_base = blockIdx.x * PS, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (H / G);  // this head's B/C group
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = S / Q;
  bf16* sH = reinterpret_cast<bf16*>(smem + 2 * T::BUF);  // (2, PS, LDN)
  // chunk z's tiles in buffer z & 1
  auto tiles = [&](int z, bf16*& tb, bf16*& tcm, bf16*& tx, float*& td) {
    tb = reinterpret_cast<bf16*>(smem + (z & 1) * T::BUF);
    tcm = tb + Q * LDN;
    tx = tcm + Q * LDN;
    td = reinterpret_cast<float*>(tx + Q * LDX);  // dt, then cum, then u
  };
  // the staging warp and the compute warps meet here once a chunk, from
  // different places in the code: named barrier 1 over every thread
  auto meet = [] { asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory"); };

  if (warp == WARPS) {
    // ---- the staging warp: chunk z's b, c, x slice and dt by cp.async, then
    // its inclusive cumsum of dt * a (log2 units) and u_j = 2^(cum_Q - cum_j) dt_j
    const float a_h = a[h] * LOG2E;
    auto stage = [&](int z) {
      bf16 *tb, *tcm, *tx;
      float* td;
      tiles(z, tb, tcm, tx, td);
      const size_t tok0 = (size_t)bi * S + (size_t)z * Q;
      constexpr int CN = N / 8, CX = PS / 8;
      for (int e = lane; e < Q * CN; e += 32) {
        const int r = e / CN, c = e % CN;
        cp_async16(tb + r * LDN + 8 * c, bm + ((tok0 + r) * G + g) * N + 8 * c);
        cp_async16(tcm + r * LDN + 8 * c, cm + ((tok0 + r) * G + g) * N + 8 * c);
      }
      for (int e = lane; e < Q * CX; e += 32) {
        const int r = e / CX, c = e % CX;
        cp_async16(tx + r * LDX + 8 * c, x + ((tok0 + r) * H + h) * P + p_base + 8 * c);
      }
      for (int e = lane; e < Q; e += 32) cp_async4(td + e, dt + (tok0 + e) * H + h);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      constexpr int TL = Q / 32;
      float v[TL], cum[TL], run = 0.f;
#pragma unroll
      for (int t = 0; t < TL; ++t) {
        v[t] = td[TL * lane + t] * a_h;
        run += v[t];
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += o;
      }
      float c = __shfl_up_sync(0xffffffffu, run, 1);
      if (lane == 0) c = 0.f;
#pragma unroll
      for (int t = 0; t < TL; ++t) {
        c += v[t];
        cum[t] = c;
        td[Q + TL * lane + t] = c;
      }
      const float last = __shfl_sync(0xffffffffu, c, 31);
#pragma unroll
      for (int t = 0; t < TL; ++t)
        td[2 * Q + TL * lane + t] = exp2f(last - cum[t]) * td[TL * lane + t];
    };
    stage(0);
    for (int z = 0; z < nc; ++z) {
      meet();  // chunk z is staged; the compute warps are done with chunk z - 1
      if (z + 1 < nc) stage(z + 1);
    }
    return;
  }

  // ---- the compute warps
  const int r0 = lane >> 2, c0 = (lane & 3) * 2;
  // the row tile: warp itself, but written so that the compiler knows it is
  // below WARPS (it then keeps more in registers: on an H100, 0.026 against
  // 0.031 ms a call at the mamba2-4b shape)
  const int mw = warp % WARPS;
  const int i0 = 16 * mw + r0, i1 = i0 + 8;  // this lane's chunk rows
  // this warp's state tiles: m-tile smt, n-tiles snt .. snt + TPW - 1
  const int t0 = warp * TPW;
  const bool has_state = t0 < T::MT * NT;
  const int smt = t0 / NT, snt = t0 % NT;
  float st[TPW][4];
#pragma unroll
  for (int k = 0; k < TPW; ++k) st[k][0] = st[k][1] = st[k][2] = st[k][3] = 0.f;
  for (int e = tid; e < PS * LDN / 8; e += 32 * WARPS)  // H is zero before the first chunk
    reinterpret_cast<uint4*>(sH)[e] = make_uint4(0, 0, 0, 0);

  for (int z = 0; z < nc; ++z) {
    meet();  // chunk z is staged, and every warp is done with chunk z - 1
    bf16 *sb, *sc, *sx;
    float* sdt;
    tiles(z, sb, sc, sx, sdt);
    const float* scum = sdt + Q;
    const float* su = scum + Q;

    // ---- what needs only dt, ahead of the products so that it overlaps them:
    // W's decay weights 2^(cum_i - cum_j) dt_j (0 for j > i; the mask sits
    // inside the exponent), 2^cum_i, the state pass's u
    const float ci0 = scum[i0], ci1 = scum[i1], cum_last = scum[Q - 1];
    float ew[2 * WARPS][4];
#pragma unroll
    for (int t = 0; t < 2 * WARPS; ++t) {
      const int j = 8 * t + c0;
      const float cj0 = scum[j], cj1 = scum[j + 1], d0 = sdt[j], d1 = sdt[j + 1];
      ew[t][0] = j <= i0 ? exp2f(ci0 - cj0) * d0 : 0.f;
      ew[t][1] = j + 1 <= i0 ? exp2f(ci0 - cj1) * d1 : 0.f;
      ew[t][2] = j <= i1 ? exp2f(ci1 - cj0) * d0 : 0.f;
      ew[t][3] = j + 1 <= i1 ? exp2f(ci1 - cj1) * d1 : 0.f;
    }
    float us[Q / 16][4];
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      us[kk][0] = su[16 * kk + c0];
      us[kk][1] = su[16 * kk + c0 + 1];
      us[kk][2] = su[16 * kk + c0 + 8];
      us[kk][3] = su[16 * kk + c0 + 9];
    }
    const float e0 = exp2f(ci0), e1 = exp2f(ci1), decay = exp2f(cum_last);

    // ---- c.b for this warp's rows, every column tile: the work of the last
    // row tile for every warp, but no warp-dependent branch in the unrolled
    // loops (the masked entries come out 0 below)
    float cb[2 * WARPS][4];
#pragma unroll
    for (int t = 0; t < 2 * WARPS; ++t) cb[t][0] = cb[t][1] = cb[t][2] = cb[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, sc + (16 * mw + (lane & 15)) * LDN + 16 * kk + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < WARPS; ++jp) {
        uint32_t bf[4];
        ldsm_x4(bf, sb + (16 * jp + (lane >> 4) * 8 + (lane & 7)) * LDN + 16 * kk +
                        ((lane >> 3) & 1) * 8);
        mma(cb[2 * jp], af, bf[0], bf[1]);
        mma(cb[2 * jp + 1], af, bf[2], bf[3]);
      }
    }
    // ---- W = c.b * decay weights, as bf16 A fragments
    uint32_t wf[WARPS][4];
#pragma unroll
    for (int jp = 0; jp < WARPS; ++jp) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = 2 * jp + hh;
        wf[jp][2 * hh] = pack(cb[t][0] * ew[t][0], cb[t][1] * ew[t][1]);
        wf[jp][2 * hh + 1] = pack(cb[t][2] * ew[t][2], cb[t][3] * ew[t][3]);
      }
    }
    // ---- y = W x (intra-chunk) + 2^cum_i c_i . H (inter-chunk)
    float yv[YN][4];
#pragma unroll
    for (int t = 0; t < YN; ++t) yv[t][0] = yv[t][1] = yv[t][2] = yv[t][3] = 0.f;
#pragma unroll
    for (int jp = 0; jp < WARPS; ++jp) {
#pragma unroll
      for (int np = 0; np < YN / 2; ++np) {
        uint32_t xb[4];
        ldsm_x4_t(xb, sx + (16 * jp + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDX + 16 * np +
                          (lane >> 4) * 8);
        mma(yv[2 * np], wf[jp], xb[0], xb[1]);
        mma(yv[2 * np + 1], wf[jp], xb[2], xb[3]);
      }
    }
    {
      const bf16* hs = sH + (z & 1) * PS * LDN;
      float ye[YN][4];
#pragma unroll
      for (int t = 0; t < YN; ++t) ye[t][0] = ye[t][1] = ye[t][2] = ye[t][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, sc + (16 * mw + (lane & 15)) * LDN + 16 * kk + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < YN / 2; ++np) {
          uint32_t hb[4];
          ldsm_x4(hb, hs + (16 * np + (lane >> 4) * 8 + (lane & 7)) * LDN + 16 * kk +
                          ((lane >> 3) & 1) * 8);
          mma(ye[2 * np], af, hb[0], hb[1]);
          mma(ye[2 * np + 1], af, hb[2], hb[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < YN; ++t) {
        yv[t][0] = fmaf(e0, ye[t][0], yv[t][0]);
        yv[t][1] = fmaf(e0, ye[t][1], yv[t][1]);
        yv[t][2] = fmaf(e1, ye[t][2], yv[t][2]);
        yv[t][3] = fmaf(e1, ye[t][3], yv[t][3]);
      }
    }
    {
      const size_t tok0 = (size_t)bi * S + (size_t)z * Q;
      bf16* y0 = y + ((tok0 + i0) * H + h) * P + p_base + c0;
      bf16* y1 = y + ((tok0 + i1) * H + h) * P + p_base + c0;
#pragma unroll
      for (int t = 0; t < YN; ++t) {
        *reinterpret_cast<uint32_t*>(y0 + 8 * t) = pack(yv[t][0], yv[t][1]);
        *reinterpret_cast<uint32_t*>(y1 + 8 * t) = pack(yv[t][2], yv[t][3]);
      }
    }
    // ---- H <- 2^cum_Q H + (u x)^T b, u x as bf16 hi + lo; then H's bf16 copy
    if (has_state) {
#pragma unroll
      for (int k = 0; k < TPW; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[k][e] *= decay;
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        uint32_t xa[4], hi[4], lo[4];
        ldsm_x4_t(xa, sx + (16 * kk + (lane >> 4) * 8 + (lane & 7)) * LDX + 16 * smt +
                          ((lane >> 3) & 1) * 8);
        split(xa[0], us[kk][0], us[kk][1], hi[0], lo[0]);
        split(xa[1], us[kk][0], us[kk][1], hi[1], lo[1]);
        split(xa[2], us[kk][2], us[kk][3], hi[2], lo[2]);
        split(xa[3], us[kk][2], us[kk][3], hi[3], lo[3]);
        const bf16* brow = sb + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDN;
        if constexpr (TPW % 2 == 0) {
#pragma unroll
          for (int k = 0; k < TPW; k += 2) {
            uint32_t bb[4];
            ldsm_x4_t(bb, brow + 8 * (snt + k) + (lane >> 4) * 8);
            mma(st[k], hi, bb[0], bb[1]);
            mma(st[k + 1], hi, bb[2], bb[3]);
            mma(st[k], lo, bb[0], bb[1]);
            mma(st[k + 1], lo, bb[2], bb[3]);
          }
        } else {
          uint32_t bb[2];
          ldsm_x2_t(bb, brow + 8 * snt);
          mma(st[0], hi, bb[0], bb[1]);
          mma(st[0], lo, bb[0], bb[1]);
        }
      }
      if (z + 1 < nc) {
        bf16* hn = sH + ((z + 1) & 1) * PS * LDN + (16 * smt + r0) * LDN + c0;
#pragma unroll
        for (int k = 0; k < TPW; ++k) {
          *reinterpret_cast<uint32_t*>(hn + 8 * (snt + k)) = pack(st[k][0], st[k][1]);
          *reinterpret_cast<uint32_t*>(hn + 8 * LDN + 8 * (snt + k)) = pack(st[k][2], st[k][3]);
        }
      }
    }
  }
  // ---- final state (B, H, P, N)
  if (has_state) {
    float* row = fs + (((size_t)bi * H + h) * P + p_base + 16 * smt + r0) * N + c0;
#pragma unroll
    for (int k = 0; k < TPW; ++k) {
      *reinterpret_cast<float2*>(row + 8 * (snt + k)) = make_float2(st[k][0], st[k][1]);
      *reinterpret_cast<float2*>(row + 8 * N + 8 * (snt + k)) = make_float2(st[k][2], st[k][3]);
    }
  }
}

template <int PS, int N>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c, void* y,
           void* fs, int B, int S, int H, int P, int G, cudaStream_t stream) {
  using T = Tile<PS, N>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_tc_kernel<PS, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  ssd_tc_kernel<PS, N><<<dim3(P / PS, H, B), T::THREADS, T::BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const bf16*>(b), static_cast<const bf16*>(c), static_cast<bf16*>(y),
      static_cast<float*>(fs), S, H, P, G);
  return (int)cudaGetLastError();
}

// PS = 64 state rows a CTA where 64 divides P, else 32
template <int N>
int launch_n(const void* x, const void* dt, const void* a, const void* b, const void* c, void* y,
             void* fs, int B, int S, int H, int P, int G, cudaStream_t stream) {
  return P % 64 ? launch<32, N>(x, dt, a, b, c, y, fs, B, S, H, P, G, stream)
                : launch<64, N>(x, dt, a, b, c, y, fs, B, S, H, P, G, stream);
}

int launch_bf16(const void* x, const void* dt, const void* a, const void* b, const void* c,
                void* y, void* fs, int B, int S, int H, int P, int N, int G,
                cudaStream_t stream) {
  if (B < 1 || S < Q || S % Q || H < 1 || P < 32 || P % 32 || G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
  switch (N) {
    case 16: return launch_n<16>(x, dt, a, b, c, y, fs, B, S, H, P, G, stream);
    case 32: return launch_n<32>(x, dt, a, b, c, y, fs, B, S, H, P, G, stream);
    case 64: return launch_n<64>(x, dt, a, b, c, y, fs, B, S, H, P, G, stream);
    case 128: return launch_n<128>(x, dt, a, b, c, y, fs, B, S, H, P, G, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// x (B,S,H,P), dt (B,S,H) fp32, a (H,) fp32, b/c (B,S,G,N) (G dividing H),
// cb scratch (B, G, S/64, 64, 64) fp32 (fp32 only; bf16 takes none) -> y
// (B,S,H,P) in x's dtype, fs (B,H,P,N) fp32. P is a multiple of 32.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* a, const void* b,
                            const void* c, void* cb, void* y, void* fs, int B, int S, int H,
                            int P, int N, int G, void* stream) {
  return launch<float>(x, dt, a, b, c, cb, y, fs, B, S, H, P, N, G,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* a, const void* b,
                             const void* c, void* cb, void* y, void* fs, int B, int S, int H,
                             int P, int N, int G, void* stream) {
  (void)cb;
  return tc::launch_bf16(x, dt, a, b, c, y, fs, B, S, H, P, N, G,
                         static_cast<cudaStream_t>(stream));
}
