// Backward of the chunked Mamba2 SSD scan for Hopper (sm_90a), in fp32 and
// bf16 inputs, computing in fp32.
//
// Replaces no TPU kernel: the Pallas kernel src/repro/kernels/ssd/ssd.py
// (ssd_scan) has no backward, and the JAX package differentiates its jnp
// scan (src/repro/models/ssm.py:ssd_chunked). The port's forward on the
// card is the kernel of ssd_scan.cu, so its gradient is a kernel too: this
// one computes what ref.py:ssd_scan_bwd_ref computes, for one B/C group,
// per (batch, head) over the (P, N) fp32 state
//   G_t = exp(dt_{t+1} a) G_{t+1} + dy_t c_t^T   (G_{S-1} = dfinal + dy c^T)
// and every input's gradient from G and the forward's states: dx (B,S,H,P)
// in x's dtype, and fp32 partials the wrapper sums in a fixed order: ddt
// (B,S,H,P/PS), da (B,H,P/PS), db and dc (B,S,H*P/PS,N). No float atomics:
// two calls give the same bits.
//
// Design: one CTA per (batch, head, PS = 32 state rows), rows being
// independent. Chunks of Q = 64 tokens, the forward's chunk, in the closed
// form of the forward kernel. Phase 1 runs the forward's state pass, chunk
// by chunk, and writes the state that enters each chunk to a global scratch
// (B,H,S/Q,P,N) fp32; it leaves ssd_scan.cu's kernels alone. Phase 2 walks
// the chunks backwards with the state cotangent dH (its value at the
// chunk's end) in registers. Per chunk, with cum the inclusive cumsum of
// dt a, e_i = exp(cum_i), w_j = exp(cum_Q - cum_j) dt_j, L_ij = exp(cum_i -
// cum_j) (j <= i), CB = C B^T, dM = dY X^T (this CTA's rows),
//   M = CB.L.dt_j ,  Pm = dM.L.dt_j ,  K = dM.CB.L
//   dX = M^T dY + diag(w) B dH^T
//   dC = Pm B + diag(e) dY H0         dB = Pm^T C + diag(w) X dH
//   dcum_i = sum_j K_ij dt_j - dt_i sum_i' K_i'i + e_i dY_i.(H0 c_i)
//            - w_i x_i^T dH b_i   (+ e_Q <dH, H0> + sum_j w_j x_j^T dH b_j at i = Q-1)
//   ddt_j = sum_i K_ij + exp(cum_Q - cum_j) x_j^T dH b_j + a sum_{i >= j} dcum_i
//   da += sum_i dcum_i sum_{k <= i} dt_k
//   dH <- e_Q dH + dY^T diag(e) C
// All of it is a sum over this CTA's rows, hence partials over row blocks.
// The closed form was chosen over per-token reverse steps because the
// per-token form needs every token's state (the (P, N) state per token of a
// chunk does not fit on chip) and reductions across threads at every token;
// per chunk here everything is a product of tiles staged in shared memory.
//
// What bounds it on this card: bytes, at least 20x below its time. At
// mamba2-780m's training shape (B 8, S 512, H 48, P 64, N 128) the call
// must read x, dy, b, c, dt, a and dfinal and write dx, ddt, da, db and dc
// (~0.1 GB in bf16: 0.03 ms at 3.35 TB/s); its ~26 GFLOP of fp32 products
// on the CUDA cores take ~0.4 ms at 67 TFLOP/s. This first design is the
// simple one: every product is a loop over shared memory on the CUDA cores
// (one CTA an SM, 168 KB of shared memory at N = 128), c.b recomputed per
// CTA. The tensor cores (the forward's bf16 design) are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;          // chunk length (the forward's)
constexpr int PS = 32;         // state rows per CTA
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
static_assert(THREADS == 16 * PS / 2, "state registers: 2 rows x N/16 columns per thread");
static_assert(PS == 32, "the dX pass puts one state row on each lane");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// shared memory, in floats; rows padded to an odd stride where a warp reads
// a column
template <int N>
struct Smem {
  static constexpr int XS = PS + 1;    // x, dy rows
  static constexpr int NS = N + 1;     // b, c, h0, dh rows
  static constexpr int QS = Q + 1;     // the Q x Q tiles
  static constexpr int X = 0;
  static constexpr int DY = X + Q * XS;
  static constexpr int B = DY + Q * XS;
  static constexpr int C = B + Q * NS;
  static constexpr int H0 = C + Q * NS;
  static constexpr int DH = H0 + PS * NS;
  static constexpr int M = DH + PS * NS;
  static constexpr int PM = M + Q * QS;
  static constexpr int K = PM + Q * QS;
  static constexpr int DT = K + Q * QS;       // Q-vectors from here
  static constexpr int CS = DT + Q;           // inclusive cumsum of dt
  static constexpr int CUM = CS + Q;          // a * CS
  static constexpr int E = CUM + Q;           // exp(cum)
  static constexpr int W = E + Q;             // exp(cum_Q - cum) dt
  static constexpr int V = W + Q;             // x_j^T dH b_j
  static constexpr int QV = V + Q;            // dy_i . (H0 c_i)
  static constexpr int ROWK = QV + Q;
  static constexpr int COLK = ROWK + Q;
  static constexpr int RED = COLK + Q;        // one slot a warp
  static constexpr int FLOATS = RED + WARPS;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

// dt of the chunk into sDt, its inclusive cumsum into sCs and a times it
// into sCum; warp 0, two tokens a lane
__device__ __forceinline__ void chunk_cumsum(float* sDt, float* sCs, float* sCum, float a_h,
                                             int lane) {
  const float d0 = sDt[2 * lane], d1 = sDt[2 * lane + 1];
  float s = d0 + d1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) excl = 0.f;
  sCs[2 * lane] = excl + d0;
  sCs[2 * lane + 1] = excl + d0 + d1;
  sCum[2 * lane] = a_h * (excl + d0);
  sCum[2 * lane + 1] = a_h * (excl + d0 + d1);
}

// grid (P / PS, H, B)
template <typename T, int N>
__global__ void __launch_bounds__(THREADS) ssd_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ bm, const T* __restrict__ cm, const T* __restrict__ dy,
    const float* __restrict__ dfinal, float* hs, T* __restrict__ dx,
    float* __restrict__ ddt_part, float* __restrict__ da_part, float* __restrict__ db_part,
    float* __restrict__ dc_part, int S, int H, int P) {
  using L = Smem<N>;
  constexpr int NV = N / 16;           // state columns per thread
  extern __shared__ float smem[];
  float* sX = smem + L::X;
  float* sDY = smem + L::DY;
  float* sB = smem + L::B;
  float* sC = smem + L::C;
  float* sH0 = smem + L::H0;
  float* sDH = smem + L::DH;
  float* sM = smem + L::M;
  float* sP = smem + L::PM;
  float* sK = smem + L::K;
  float* sDt = smem + L::DT;
  float* sCs = smem + L::CS;
  float* sCum = smem + L::CUM;
  float* sE = smem + L::E;
  float* sW = smem + L::W;
  float* sV = smem + L::V;
  float* sQv = smem + L::QV;
  float* sRowK = smem + L::ROWK;
  float* sColK = smem + L::COLK;
  float* sRed = smem + L::RED;

  const int pb = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int p_base = pb * PS, npb = P / PS, nc = S / Q;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float a_h = a[h];
  // state registers: rows p2, p2 + 1; columns ng + 16 v
  const int ng = tid % 16, p2 = (tid / 16) * 2;
  float st[2][NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) st[0][v] = st[1][v] = 0.f;
  float* hs_bh = hs + ((size_t)bi * H + h) * nc * P * N;

  // ---- phase 1: the state entering each chunk, into the scratch
  for (int z = 0; z < nc; ++z) {
    const size_t tok0 = (size_t)bi * S + (size_t)z * Q;
    float* hz = hs_bh + ((size_t)z * P + p_base) * N;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int v = 0; v < NV; ++v) hz[(p2 + r) * N + ng + 16 * v] = st[r][v];
    if (tid < Q) sDt[tid] = dt[(tok0 + tid) * H + h];
    for (int e = tid; e < Q * PS; e += THREADS) {
      const int i = e / PS, p = e % PS;
      sX[i * L::XS + p] = to_f(x[((tok0 + i) * H + h) * P + p_base + p]);
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int i = e / N, n = e % N;
      sB[i * L::NS + n] = to_f(bm[tok0 * N + e]);
    }
    __syncthreads();
    if (warp == 0) chunk_cumsum(sDt, sCs, sCum, a_h, lane);
    __syncthreads();
    const float cum_last = sCum[Q - 1];
    if (tid < Q) sW[tid] = expf(cum_last - sCum[tid]) * sDt[tid];
    __syncthreads();
    const float decay = expf(cum_last);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      st[0][v] *= decay;
      st[1][v] *= decay;
    }
    for (int j = 0; j < Q; ++j) {
      const float w = sW[j];
      const float x0 = w * sX[j * L::XS + p2], x1 = w * sX[j * L::XS + p2 + 1];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float bv = sB[j * L::NS + ng + 16 * v];
        st[0][v] = fmaf(x0, bv, st[0][v]);
        st[1][v] = fmaf(x1, bv, st[1][v]);
      }
    }
    __syncthreads();
  }

  // ---- phase 2: the chunks backwards; st now holds dH at the chunk's end
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int v = 0; v < NV; ++v)
      st[r][v] = dfinal == nullptr
                     ? 0.f
                     : dfinal[(((size_t)bi * H + h) * P + p_base + p2 + r) * N + ng + 16 * v];
  float da_acc = 0.f;
  for (int z = nc - 1; z >= 0; --z) {
    const size_t tok0 = (size_t)bi * S + (size_t)z * Q;
    const float* hz = hs_bh + ((size_t)z * P + p_base) * N;
    // stage the chunk, H0 and dH
    if (tid < Q) sDt[tid] = dt[(tok0 + tid) * H + h];
    for (int e = tid; e < Q * PS; e += THREADS) {
      const int i = e / PS, p = e % PS;
      const size_t g = ((tok0 + i) * H + h) * P + p_base + p;
      sX[i * L::XS + p] = to_f(x[g]);
      sDY[i * L::XS + p] = to_f(dy[g]);
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int i = e / N, n = e % N;
      sB[i * L::NS + n] = to_f(bm[tok0 * N + e]);
      sC[i * L::NS + n] = to_f(cm[tok0 * N + e]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int o = (p2 + r) * L::NS + ng + 16 * v;
        sH0[o] = hz[(p2 + r) * N + ng + 16 * v];   // this thread wrote it in phase 1
        sDH[o] = st[r][v];
      }
    __syncthreads();
    if (warp == 0) chunk_cumsum(sDt, sCs, sCum, a_h, lane);
    __syncthreads();
    const float cum_last = sCum[Q - 1];
    if (tid < Q) {
      sE[tid] = expf(sCum[tid]);
      sW[tid] = expf(cum_last - sCum[tid]) * sDt[tid];
    }
    // CB = C B^T and dM = dY X^T, then M, Pm and K (zero above the diagonal):
    // thread column j, rows i0 + 4m
    {
      const int j = tid % Q, i0 = tid / Q;
      float cb[Q / 4], dm[Q / 4];
#pragma unroll
      for (int m = 0; m < Q / 4; ++m) cb[m] = dm[m] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float bv = sB[j * L::NS + n];
#pragma unroll
        for (int m = 0; m < Q / 4; ++m) cb[m] = fmaf(sC[(i0 + 4 * m) * L::NS + n], bv, cb[m]);
      }
      for (int p = 0; p < PS; ++p) {
        const float xv = sX[j * L::XS + p];
#pragma unroll
        for (int m = 0; m < Q / 4; ++m) dm[m] = fmaf(sDY[(i0 + 4 * m) * L::XS + p], xv, dm[m]);
      }
      const float dtj = sDt[j], cumj = sCum[j];
#pragma unroll
      for (int m = 0; m < Q / 4; ++m) {
        const int i = i0 + 4 * m;
        float mv = 0.f, pv = 0.f, kv = 0.f;
        if (j <= i) {
          const float l = expf(sCum[i] - cumj);
          mv = cb[m] * l * dtj;
          pv = dm[m] * l * dtj;
          kv = dm[m] * cb[m] * l;
        }
        sM[i * L::QS + j] = mv;
        sP[i * L::QS + j] = pv;
        sK[i * L::QS + j] = kv;
      }
    }
    __syncthreads();
    // dX = M^T dY + diag(w) B dH^T, v_j = x_j . (dH b_j), q_i = dy_i . (H0 c_i):
    // lane = state row, warp-strided tokens
    for (int j = warp; j < Q; j += WARPS) {
      float acc = 0.f, bdh = 0.f, ch0 = 0.f;
      for (int i = j; i < Q; ++i) acc = fmaf(sM[i * L::QS + j], sDY[i * L::XS + lane], acc);
      for (int n = 0; n < N; ++n) {
        bdh = fmaf(sB[j * L::NS + n], sDH[lane * L::NS + n], bdh);
        ch0 = fmaf(sC[j * L::NS + n], sH0[lane * L::NS + n], ch0);
      }
      dx[((tok0 + j) * H + h) * P + p_base + lane] = from_f<T>(fmaf(sW[j], bdh, acc));
      const float v = warp_sum(sX[j * L::XS + lane] * bdh);
      const float qv = warp_sum(sDY[j * L::XS + lane] * ch0);
      if (lane == 0) {
        sV[j] = v;
        sQv[j] = qv;
      }
    }
    // dC = Pm B + diag(e) dY H0 and dB = Pm^T C + diag(w) X dH: thread (i, n)
    {
      const size_t gh = (size_t)H * npb, col = (size_t)h * npb + pb;
      for (int e = tid; e < Q * N; e += THREADS) {
        const int i = e / N, n = e % N;
        float dc = 0.f, db = 0.f, dch = 0.f, dbh = 0.f;
        for (int j = 0; j <= i; ++j) dc = fmaf(sP[i * L::QS + j], sB[j * L::NS + n], dc);
        for (int k = i; k < Q; ++k) db = fmaf(sP[k * L::QS + i], sC[k * L::NS + n], db);
        for (int p = 0; p < PS; ++p) {
          dch = fmaf(sDY[i * L::XS + p], sH0[p * L::NS + n], dch);
          dbh = fmaf(sX[i * L::XS + p], sDH[p * L::NS + n], dbh);
        }
        const size_t o = ((tok0 + i) * gh + col) * N + n;
        dc_part[o] = fmaf(sE[i], dch, dc);
        db_part[o] = fmaf(sW[i], dbh, db);
      }
    }
    // K's row sums (weighted by dt) and column sums
    if (tid < Q) {
      float s = 0.f;
      for (int j = 0; j <= tid; ++j) s = fmaf(sK[tid * L::QS + j], sDt[j], s);
      sRowK[tid] = s;
    } else if (tid < 2 * Q) {
      const int j = tid - Q;
      float s = 0.f;
      for (int i = j; i < Q; ++i) s += sK[i * L::QS + j];
      sColK[j] = s;
    }
    // <dH, H0>
    {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int v = 0; v < NV; ++v) s = fmaf(st[r][v], sH0[(p2 + r) * L::NS + ng + 16 * v], s);
      s = warp_sum(s);
      if (lane == 0) sRed[warp] = s;
    }
    __syncthreads();
    const float e_last = expf(cum_last);
    if (tid == 0) {
      float hh = 0.f, wv = 0.f;
      for (int w = 0; w < WARPS; ++w) hh += sRed[w];
      for (int j = 0; j < Q; ++j) wv = fmaf(sW[j], sV[j], wv);
      float run = 0.f;
      for (int i = Q - 1; i >= 0; --i) {
        float dcum = sRowK[i] - sDt[i] * sColK[i] + sE[i] * sQv[i] - sW[i] * sV[i];
        if (i == Q - 1) dcum += e_last * hh + wv;
        run += dcum;
        ddt_part[((tok0 + i) * H + h) * npb + pb] =
            sColK[i] + expf(cum_last - sCum[i]) * sV[i] + a_h * run;
        da_acc = fmaf(dcum, sCs[i], da_acc);
      }
    }
    // dH <- e_Q dH + dY^T diag(e) C, in registers
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      st[0][v] *= e_last;
      st[1][v] *= e_last;
    }
    for (int i = 0; i < Q; ++i) {
      const float ei = sE[i];
      const float y0 = ei * sDY[i * L::XS + p2], y1 = ei * sDY[i * L::XS + p2 + 1];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float cv = sC[i * L::NS + ng + 16 * v];
        st[0][v] = fmaf(y0, cv, st[0][v]);
        st[1][v] = fmaf(y1, cv, st[1][v]);
      }
    }
    __syncthreads();
  }
  if (tid == 0) da_part[((size_t)bi * H + h) * npb + pb] = da_acc;
}

template <typename T, int N>
int launch_n(const void* x, const void* dt, const void* a, const void* b, const void* c,
             const void* dy, const void* dfinal, void* hs, void* dx, void* ddt, void* da,
             void* db, void* dc, int B, int S, int H, int P, cudaStream_t stream) {
  // above 48 KB a kernel's dynamic shared memory must be opted into, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_bwd_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<N>::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  ssd_bwd_kernel<T, N><<<dim3(P / PS, H, B), THREADS, Smem<N>::BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<const T*>(dy),
      static_cast<const float*>(dfinal), static_cast<float*>(hs), static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(da), static_cast<float*>(db),
      static_cast<float*>(dc), S, H, P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           const void* dy, const void* dfinal, void* hs, void* dx, void* ddt, void* da, void* db,
           void* dc, int B, int S, int H, int P, int N, cudaStream_t stream) {
  if (B < 1 || S < Q || S % Q || H < 1 || P < PS || P % PS) return (int)cudaErrorInvalidValue;
#define SSD_BWD_N(NN)                                                                        \
  case NN:                                                                                  \
    return launch_n<T, NN>(x, dt, a, b, c, dy, dfinal, hs, dx, ddt, da, db, dc, B, S, H, P,  \
                           stream);
  switch (N) {
    SSD_BWD_N(16)
    SSD_BWD_N(32)
    SSD_BWD_N(64)
    SSD_BWD_N(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSD_BWD_N
}

}  // namespace

// x (B,S,H,P), dt (B,S,H) fp32, a (H,) fp32, b/c (B,S,N), dy (B,S,H,P) in
// x's dtype, dfinal (B,H,P,N) fp32 or null (a zero cotangent), hs scratch
// (B,H,S/64,P,N) fp32 -> dx (B,S,H,P) in x's dtype and fp32 partials over
// the P/32 row blocks: ddt (B,S,H,P/32), da (B,H,P/32), db and dc
// (B,S,H*P/32,N). S a multiple of 64, P of 32, N in {16,32,64,128}. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ssd_scan_bwd_f32(const void* x, const void* dt, const void* a, const void* b,
                                const void* c, const void* dy, const void* dfinal, void* hs,
                                void* dx, void* ddt, void* da, void* db, void* dc, int B, int S,
                                int H, int P, int N, void* stream) {
  return launch<float>(x, dt, a, b, c, dy, dfinal, hs, dx, ddt, da, db, dc, B, S, H, P, N,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int ssd_scan_bwd_bf16(const void* x, const void* dt, const void* a, const void* b,
                                 const void* c, const void* dy, const void* dfinal, void* hs,
                                 void* dx, void* ddt, void* da, void* db, void* dc, int B, int S,
                                 int H, int P, int N, void* stream) {
  return launch<__nv_bfloat16>(x, dt, a, b, c, dy, dfinal, hs, dx, ddt, da, db, dc, B, S, H, P,
                               N, static_cast<cudaStream_t>(stream));
}
