// Backward of the chunked Mamba2 SSD scan for Hopper (sm_90a): bf16 on the
// tensor cores, fp32 on the CUDA cores.
//
// Replaces no TPU kernel: the Pallas kernel src/repro/kernels/ssd/ssd.py
// (ssd_scan) has no backward, and the JAX package differentiates its jnp
// scan (jax.grad of src/repro/models/ssm.py:ssd_chunked). The port's forward
// on the card is the kernel of ssd_scan.cu, so its gradient is a kernel too:
// this one computes what ref.py:ssd_scan_bwd_ref computes, for G B/C
// groups (head h reads group h / (H / G); b and c (B, S, G, N)), per
// (batch, head) over the (P, N) state
//   G_t = exp(dt_{t+1} a) G_{t+1} + dy_t c_t^T   (G_{S-1} = dfinal + dy c^T)
// and every input's gradient from G and the forward's states: dx (B,S,H,P)
// in x's dtype, and fp32 partials the wrapper sums in a fixed order: ddt
// (B,S,H,P/PS), da (B,H,P/PS), db and dc (B,S,H*P/PS,N), each head's
// columns summed within its group by the wrapper. No float atomics: two
// calls give the same bits.
//
// Both kernels take chunks of Q = 64 tokens, the forward's chunk, in the
// closed form that ref.py:ssd_scan_bwd_chunked_ref writes out. A first
// pass runs the forward's state pass chunk by chunk and keeps the state that
// enters each chunk in a global scratch hs (B,H,S/Q,P,N); it leaves
// ssd_scan.cu's kernels alone. The second walks the chunks backwards with
// the state cotangent dH (its value at the chunk's end) in registers. Per
// chunk, with cum the inclusive cumsum of dt a, e_i = exp(cum_i), u_j =
// exp(cum_Q - cum_j), w_j = u_j dt_j, L_ij = exp(cum_i - cum_j) (j <= i),
// CB = C B^T, dM = dY X^T (this CTA's rows), H0 the entering state:
//   M = CB.L.dt_j ,  Pm = dM.L.dt_j ,  K = dM.CB.L
//   dX = M^T dY + diag(w) B dH^T        v_j = x_j^T dH b_j
//   dC = Pm B + diag(e) dY H0           q_i = dy_i . (H0 c_i)
//   dB = Pm^T C + diag(w) X dH
//   dcum_i = sum_j K_ij dt_j - dt_i sum_i' K_i'i + e_i q_i - w_i v_i
//            (+ e_Q <dH, H0> + sum_j w_j v_j at i = Q-1)
//   ddt_j = sum_i K_ij + u_j v_j + a sum_{i >= j} dcum_i
//   da += sum_i dcum_i sum_{k <= i} dt_k
//   dH <- e_Q dH + dY^T diag(e) C
// All of it is a sum over this CTA's rows, hence partials over row blocks.
// The closed form was chosen over per-token reverse steps because the
// per-token form needs every token's state (the (P, N) state per token of a
// chunk does not fit on chip) and reductions across threads at every token;
// per chunk here everything is a product of tiles staged in shared memory.
//
// What bounds it on this card: neither operations nor bytes, both far
// below its time. At mamba2-780m's training shape (B 8, S 512, H 48, P 64,
// N 128, bf16) the call must read x, dy, b, c, dt, a and write dx, ddt, da,
// db and dc (~81 MB: 0.024 ms at 3.35 TB/s); its ~22 GFLOP of products take
// 0.022 ms at the bf16 tensor-core rate. What the design adds to that: the
// scratch hs (S/Q - 2 entering states in bf16, 38 MB here, written once and
// read once), the db / dc partials (201 MB written here, read back by the
// wrapper's sums) and, inside a CTA, the
// chain of dependent steps a chunk. Measured on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py --against the CUDA-core design, one call; the
// wrapper's call, sums included): 0.354 ms against 4.628 ms, 14.6x the
// bound.
//
// 1. bf16: ssd_bwd_tc_kernel, on the tensor cores.
// - Grid (P / PS, H, B), PS = 64 state rows a CTA where 64 divides P (one
//   CTA a head at mamba2-780m and zamba2-1.2b: 384 and 512 CTAs), else 32.
//   C B^T is computed once a CTA and chunk, so 48 times a (batch, chunk) at
//   mamba2-780m where the CUDA-core kernel's 32-row CTAs took 96.
// - Eight compute warps run every product on mma.sync.m16n8k16 (bf16 in, fp32
//   accumulate). Warp w takes rows 16 (w % 4) .. + 15 of each Q-row product
//   and half its columns (w / 4): C B^T, dY X^T, M^T dY, B dH^T, dY H0,
//   Pm B, X dH and Pm^T C; and 1/8 of the state's 16 x 8 tiles for the two
//   state passes, H <- e_Q H + (w X)^T B and dH <- e_Q dH + (e dY)^T C,
//   with H and then dH in fp32 accumulator registers for the whole sweep.
//   M and Pm go through shared memory in bf16, to be read both ways; every
//   operand the other way round (M^T, Pm^T, X^T, dY^T, B and C as [k][n])
//   comes through ldmatrix.trans, rows padded by 16 bytes so that no
//   ldmatrix meets a bank conflict. v and q come out of the accumulators of
//   B dH^T and dY H0, before those are scaled into dX and dC; <dH, H0> is
//   taken from dH's fp32 registers against H0 in shared memory; K's row and
//   column sums are reduced across lanes and, through shared memory, across
//   the warps; one warp then runs the per-token tail (dcum, its suffix sums
//   for ddt, da) in fp32.
// - A ninth warp stages the next step's chunk with cp.async into the other
//   of two buffers (x, b and dt for the first pass; x, dy, b, c, dt and the
//   entering state from hs for the second) and computes its cumsum, e, u and
//   w, while the compute warps work on the current one; the two sides meet at
//   one named barrier a step. The first pass skips the last chunk (its
//   output state is not needed), and the second takes that chunk's entering
//   state from the compute warps' registers, so hs holds S/Q - 2 states.
// - Precision: x, dy, b and c are bf16 already; M, Pm, dH, H0 (hs is bf16),
//   e dY and w X are each rounded once to bf16 as a product's operand, and
//   every sum stays fp32. ref.py:ssd_scan_bwd_chunked_ref(bf16=True) rounds
//   at the same points: on the CPU every gradient stays within 5e-3 of max
//   |twin| at mamba2-780m's widths, as close as the rounding of dx, db and
//   dc to bf16 alone, so no hi + lo split (ssd_scan.cu) is needed.
// - Shared memory: two staged chunks (x, dy, b, c, H0 and six Q-vectors) and
//   M, Pm and dH's bf16 copy, 178.5 KB at PS 64 and N 128; so one CTA an SM,
//   of nine warps. Two CTAs of 113 KB would need single-buffered staging,
//   and the staging warp's overlap is what the double buffer buys.
//
// 2. fp32: ssd_bwd_kernel, the first design on the CUDA cores (fp32 would
//   need 3xTF32 to hold its 2e-4 tolerance on the tensor cores). One CTA per
//   (batch, head, PS = 32 state rows); hs in fp32; every product is a loop
//   over shared memory (one CTA an SM, 168 KB of shared memory at N = 128),
//   c.b recomputed per CTA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr int Q = 64;          // chunk length (the forward's)
constexpr int PS = 32;         // state rows per CTA
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
static_assert(THREADS == 16 * PS / 2, "state registers: 2 rows x N/16 columns per thread");
static_assert(PS == 32, "the dX pass puts one state row on each lane");

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

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
    float* __restrict__ dc_part, int S, int H, int P, int G) {
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
  const int grp = h / (H / G);  // this head's B/C group
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
      sB[i * L::NS + n] = to_f(bm[((tok0 + i) * G + grp) * N + n]);
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
      const size_t at = ((tok0 + i) * G + grp) * N + n;
      sB[i * L::NS + n] = to_f(bm[at]);
      sC[i * L::NS + n] = to_f(cm[at]);
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
             void* db, void* dc, int B, int S, int H, int P, int G, cudaStream_t stream) {
  // above 48 KB a kernel's dynamic shared memory must be opted into, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_bwd_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<N>::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  ssd_bwd_kernel<T, N><<<dim3(P / PS, H, B), THREADS, Smem<N>::BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<const T*>(dy),
      static_cast<const float*>(dfinal), static_cast<float*>(hs), static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(da), static_cast<float*>(db),
      static_cast<float*>(dc), S, H, P, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           const void* dy, const void* dfinal, void* hs, void* dx, void* ddt, void* da, void* db,
           void* dc, int B, int S, int H, int P, int N, int G, cudaStream_t stream) {
  if (B < 1 || S < Q || S % Q || H < 1 || P < PS || P % PS || G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
#define SSD_BWD_N(NN)                                                                        \
  case NN:                                                                                  \
    return launch_n<T, NN>(x, dt, a, b, c, dy, dfinal, hs, dx, ddt, da, db, dc, B, S, H, P,  \
                           G, stream);
  switch (N) {
    SSD_BWD_N(16)
    SSD_BWD_N(32)
    SSD_BWD_N(64)
    SSD_BWD_N(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSD_BWD_N
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
namespace tc {

using namespace sm90;
using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int CW = 8;                     // compute warps
constexpr int THREADS = 32 * (CW + 1);    // and the staging warp, CW

// PS state rows (head-dim slice) a CTA, state dim N; byte offsets in shared
// memory
template <int PS, int N>
struct Tile {
  static constexpr int LDX = PS + 8, LDN = N + 8, LDQ = Q + 8;  // padded rows
  static constexpr int MT = PS / 16, NT = N / 8;  // the state's 16x8 tiles ...
  static constexpr int TPW = (MT * NT + CW - 1) / CW;  // ... and a warp's share
  // one staged chunk: x, dy (Q x PS), b, c (Q x N) and the entering state
  // (PS x N) in bf16; dt, cumsum(dt), e, u, w (Q) in fp32
  static constexpr int X = 0, DY = X + Q * LDX * 2, B = DY + Q * LDX * 2, C = B + Q * LDN * 2,
                       H0 = C + Q * LDN * 2, V = H0 + PS * LDN * 2, BUF = V + 5 * Q * 4;
  // two staged chunks, M and Pm (Q x Q) and dH (PS x N) in bf16, then fp32
  // partial sums: K's row sums (2 x Q) and column sums (4 x Q), v and q
  // (2 x Q each), <dH, H0> (one a warp)
  static constexpr int M = 2 * BUF, PM = M + Q * LDQ * 2, DH = PM + Q * LDQ * 2,
                       F = DH + PS * LDN * 2, BYTES = F + (10 * Q + CW) * 4;
  static_assert(Q == 64 && CW == 8,
                "warp w: rows 16 (w % 4), column half w / 4; the tail: 2 tokens a lane");
  static_assert(PS % 32 == 0 && N % 16 == 0, "tile shapes");
  static_assert(TPW == 1 || NT % TPW == 0, "a warp's state tiles share a row");
  static_assert(BYTES <= 232448, "shared memory");
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
// sum over the four lanes of a quad (one accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ uint32_t scale2(uint32_t v, float s0, float s1) {
  const float2 f = unpack(v);
  return pack(f.x * s0, f.y * s1);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void st32(bf16* p, uint32_t v) { *reinterpret_cast<uint32_t*>(p) = v; }

// A fragment (16 x 16) at (m0, k0) of a row-major [m][k] tile, or (AT) of
// A = S^T with S a row-major [k][m] tile
template <bool AT>
__device__ __forceinline__ void load_a(uint32_t* f, const bf16* s, int ld, int m0, int k0,
                                       int lane) {
  if constexpr (AT)
    ldsm_x4_t(f, s + (k0 + (lane >> 4) * 8 + (lane & 7)) * ld + m0 + ((lane >> 3) & 1) * 8);
  else
    ldsm_x4(f, s + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
// B fragments of two n8 tiles (f[0..1] at n0, f[2..3] at n0 + 8) over k0 ..
// k0 + 15, from a row-major [k][n] tile (KN) or from B = T^T with T a
// row-major [n][k] tile
template <bool KN>
__device__ __forceinline__ void load_b2(uint32_t* f, const bf16* s, int ld, int k0, int n0,
                                        int lane) {
  if constexpr (KN)
    ldsm_x4_t(f, s + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0 + (lane >> 4) * 8);
  else
    ldsm_x4(f, s + (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
}
// ... and of one n8 tile of a row-major [k][n] tile (lanes 0-15 give the
// addresses)
__device__ __forceinline__ void load_b1(uint32_t* f, const bf16* s, int ld, int k0, int n0,
                                        int lane) {
  ldsm_x2_t(f, s + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0);
}
// acc[t] (the 16 x 8 tile at rows m0, columns n0 + 8t) += A . B over K = 16 KT
template <int KT, int NTL, bool AT, bool KN>
__device__ __forceinline__ void strip(float (*acc)[4], const bf16* a, int lda, int m0,
                                      const bf16* b, int ldb, int n0, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t af[4];
    load_a<AT>(af, a, lda, m0, 16 * kk, lane);
#pragma unroll
    for (int t = 0; t + 1 < NTL; t += 2) {
      uint32_t bf[4];
      load_b2<KN>(bf, b, ldb, 16 * kk, n0 + 8 * t, lane);
      mma(acc[t], af, bf[0], bf[1]);
      mma(acc[t + 1], af, bf[2], bf[3]);
    }
    if constexpr (NTL % 2) {
      static_assert(KN, "an odd tile count only from a row-major [k][n] B");
      uint32_t bf[2];
      load_b1(bf, b, ldb, 16 * kk, n0 + 8 * (NTL - 1), lane);
      mma(acc[NTL - 1], af, bf[0], bf[1]);
    }
  }
}
// a state pass: acc (rows m0 of the state, columns n0 + 8t) += (diag(ws) S)^T
// . B over the chunk, S a row-major [token][row] tile, B a row-major
// [token][n] tile, the weights ws (Q, fp32) applied to A's bf16 fragments
template <int NTL>
__device__ __forceinline__ void state_pass(float (*acc)[4], const bf16* s, int lds, int m0,
                                           const float* ws, const bf16* b, int ldb, int n0,
                                           int lane) {
  const int c0 = (lane & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < Q / 16; ++kk) {
    uint32_t af[4];
    load_a<true>(af, s, lds, m0, 16 * kk, lane);
    const float w0 = ws[16 * kk + c0], w1 = ws[16 * kk + c0 + 1];
    const float w8 = ws[16 * kk + c0 + 8], w9 = ws[16 * kk + c0 + 9];
    af[0] = scale2(af[0], w0, w1);
    af[1] = scale2(af[1], w0, w1);
    af[2] = scale2(af[2], w8, w9);
    af[3] = scale2(af[3], w8, w9);
#pragma unroll
    for (int t = 0; t + 1 < NTL; t += 2) {
      uint32_t bf[4];
      load_b2<true>(bf, b, ldb, 16 * kk, n0 + 8 * t, lane);
      mma(acc[t], af, bf[0], bf[1]);
      mma(acc[t + 1], af, bf[2], bf[3]);
    }
    if constexpr (NTL % 2) {
      uint32_t bf[2];
      load_b1(bf, b, ldb, 16 * kk, n0 + 8 * (NTL - 1), lane);
      mma(acc[NTL - 1], af, bf[0], bf[1]);
    }
  }
}

// one staged chunk
struct Staged {
  bf16 *x, *dy, *b, *c, *h0;
  float *dt, *cs, *e, *u, *w;
};

// grid (P / PS, H, B)
template <int PS, int N>
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const bf16* __restrict__ bm, const bf16* __restrict__ cm, const bf16* __restrict__ dy,
    const float* __restrict__ dfinal, bf16* hs, bf16* __restrict__ dx,
    float* __restrict__ ddt_part, float* __restrict__ da_part, float* __restrict__ db_part,
    float* __restrict__ dc_part, int S, int H, int P, int G) {
  using T = Tile<PS, N>;
  constexpr int LDX = T::LDX, LDN = T::LDN, LDQ = T::LDQ, NT = T::NT, TPW = T::TPW;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* const smem = tc_smem;
  const int pb = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int p_base = pb * PS, npb = P / PS, nc = S / Q;
  const int grp = h / (H / G);  // this head's B/C group
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // step s runs the first pass over chunk s for s < nc - 1, then the second
  // over chunk 2 nc - 2 - s; its chunk is staged in buffer s & 1
  const int steps = 2 * nc - 1;
  auto chunk_of = [nc](int s) { return s < nc - 1 ? s : 2 * nc - 2 - s; };
  auto staged = [smem](int s) {
    unsigned char* base = smem + (s & 1) * T::BUF;
    Staged v;
    v.x = reinterpret_cast<bf16*>(base + T::X);
    v.dy = reinterpret_cast<bf16*>(base + T::DY);
    v.b = reinterpret_cast<bf16*>(base + T::B);
    v.c = reinterpret_cast<bf16*>(base + T::C);
    v.h0 = reinterpret_cast<bf16*>(base + T::H0);
    v.dt = reinterpret_cast<float*>(base + T::V);
    v.cs = v.dt + Q;
    v.e = v.cs + Q;
    v.u = v.e + Q;
    v.w = v.u + Q;
    return v;
  };
  // the entering states of this (batch, head): (S / Q, P, N)
  bf16* const hs_bh = hs + ((size_t)bi * H + h) * nc * P * N;
  // the staging warp and the compute warps meet here once a step, from
  // different places in the code: named barrier 1 over every thread
  auto meet = [] { asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory"); };

  if (warp == CW) {
    // ---- the staging warp
    const float a2 = a[h] * LOG2E;
    auto stage = [&](int s) {
      const Staged v = staged(s);
      const bool second = s >= nc - 1;
      const int z = chunk_of(s);
      const size_t tok0 = (size_t)bi * S + (size_t)z * Q;
      constexpr int CN = N / 8, CX = PS / 8;
      for (int e = lane; e < Q * CN; e += 32) {
        const int r = e / CN, c = e % CN;
        const size_t at = ((tok0 + r) * G + grp) * N + 8 * c;
        cp_async16(v.b + r * LDN + 8 * c, bm + at);
        if (second) cp_async16(v.c + r * LDN + 8 * c, cm + at);
      }
      for (int e = lane; e < Q * CX; e += 32) {
        const int r = e / CX, c = e % CX;
        const size_t g = ((tok0 + r) * H + h) * P + p_base + 8 * c;
        cp_async16(v.x + r * LDX + 8 * c, x + g);
        if (second) cp_async16(v.dy + r * LDX + 8 * c, dy + g);
      }
      // the state entering chunk z (zeros for chunk 0); the compute warps
      // write chunk nc - 1's from their registers
      if (second && z < nc - 1) {
        const bf16* src = hs_bh + ((size_t)z * P + p_base) * N;
        for (int e = lane; e < PS * CN; e += 32) {
          const int r = e / CN, c = e % CN;
          cp_async16(v.h0 + r * LDN + 8 * c, src + r * N + 8 * c, z > 0);
        }
      }
      for (int e = lane; e < Q; e += 32) cp_async4(v.dt + e, dt + (tok0 + e) * H + h);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      // inclusive cumsum of dt, two tokens a lane; e_i = exp(a cs_i), u_i =
      // exp(a (cs_Q - cs_i)), w_i = u_i dt_i
      const float d0 = v.dt[2 * lane], d1 = v.dt[2 * lane + 1];
      float run = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += o;
      }
      const float last = __shfl_sync(0xffffffffu, run, 31);
      const float cs1 = run, cs0 = run - d1;
      v.cs[2 * lane] = cs0;
      v.cs[2 * lane + 1] = cs1;
      v.e[2 * lane] = exp2f(a2 * cs0);
      v.e[2 * lane + 1] = exp2f(a2 * cs1);
      const float u0 = exp2f(a2 * (last - cs0)), u1 = exp2f(a2 * (last - cs1));
      v.u[2 * lane] = u0;
      v.u[2 * lane + 1] = u1;
      v.w[2 * lane] = u0 * d0;
      v.w[2 * lane + 1] = u1 * d1;
    };
    stage(0);
    for (int s = 0; s < steps; ++s) {
      meet();  // step s is staged; the compute warps are done with step s - 1
      if (s + 1 < steps) stage(s + 1);
    }
    return;
  }

  // ---- the compute warps
  const int r0 = lane >> 2, c0 = (lane & 3) * 2;
  // the warp, written so that the compiler knows it is below CW
  const int cw = warp % CW;
  const int rt = cw & 3, hf = cw >> 2;       // row tile, column half
  const int i0 = 16 * rt + r0, i1 = i0 + 8;  // this lane's rows of a Q-row product
  const float a_h = a[h], a2 = a_h * LOG2E;
  // this warp's state tiles: m-tile smt, n-tiles snt .. snt + TPW - 1
  const int t0 = cw * TPW;
  const bool has_state = t0 < T::MT * NT;
  const int smt = t0 / NT, snt = t0 % NT;
  const int sp0 = 16 * smt + r0;             // this lane's state rows sp0, sp0 + 8
  float st[TPW][4];
#pragma unroll
  for (int k = 0; k < TPW; ++k) st[k][0] = st[k][1] = st[k][2] = st[k][3] = 0.f;
  bf16* const sM = reinterpret_cast<bf16*>(smem + T::M);
  bf16* const sPm = reinterpret_cast<bf16*>(smem + T::PM);
  bf16* const sDH = reinterpret_cast<bf16*>(smem + T::DH);
  float* const fRowK = reinterpret_cast<float*>(smem + T::F);  // [column half][i]
  float* const fColK = fRowK + 2 * Q;                          // [row tile][j]
  float* const fV = fColK + 4 * Q;                             // [column half][j]
  float* const fQ = fV + 2 * Q;                                // [column half][i]
  float* const fHH = fQ + 2 * Q;                               // [warp]
  // the compute warps' own barrier
  auto sync_compute = [] { asm volatile("bar.sync 2, %0;\n" ::"n"(32 * CW) : "memory"); };
  float da_acc = 0.f;

  for (int s = 0; s < steps; ++s) {
    meet();  // step s is staged, and every warp is done with step s - 1
    const Staged v = staged(s);
    const int z = chunk_of(s);
    const size_t tok0 = (size_t)bi * S + (size_t)z * Q;

    if (s < nc - 1) {
      // ---- first pass: H <- e_Q H + (w X)^T B, kept as the state entering
      // chunk z + 1 (bf16) unless that chunk is the last
      if (has_state) {
        const float eq = v.e[Q - 1];
#pragma unroll
        for (int k = 0; k < TPW; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[k][e] *= eq;
        state_pass<TPW>(st, v.x, LDX, 16 * smt, v.w, v.b, LDN, 8 * snt, lane);
        if (z + 1 < nc - 1) {
          bf16* hz = hs_bh + ((size_t)(z + 1) * P + p_base + sp0) * N + 8 * snt + c0;
#pragma unroll
          for (int k = 0; k < TPW; ++k) {
            st32(hz + 8 * k, pack(st[k][0], st[k][1]));
            st32(hz + 8 * N + 8 * k, pack(st[k][2], st[k][3]));
          }
        }
      }
      continue;
    }

    // ---- second pass over chunk z
    if (has_state) {
      const int o = sp0 * LDN + 8 * snt + c0;
      if (s == nc - 1) {
        // the last chunk's entering state is in the registers; then dH
        // starts from dfinal
#pragma unroll
        for (int k = 0; k < TPW; ++k) {
          st32(v.h0 + o + 8 * k, pack(st[k][0], st[k][1]));
          st32(v.h0 + o + 8 * LDN + 8 * k, pack(st[k][2], st[k][3]));
        }
        const float* df = dfinal + (((size_t)bi * H + h) * P + p_base + sp0) * N + 8 * snt + c0;
#pragma unroll
        for (int k = 0; k < TPW; ++k) {
          float2 lo = make_float2(0.f, 0.f), hi = lo;
          if (dfinal != nullptr) {
            lo = *reinterpret_cast<const float2*>(df + 8 * k);
            hi = *reinterpret_cast<const float2*>(df + 8 * N + 8 * k);
          }
          st[k][0] = lo.x;
          st[k][1] = lo.y;
          st[k][2] = hi.x;
          st[k][3] = hi.y;
        }
      }
      // dH's bf16 copy, the operand of B dH^T and X dH; <dH, H0> from the
      // fp32 registers
      float hh = 0.f;
#pragma unroll
      for (int k = 0; k < TPW; ++k) {
        st32(sDH + o + 8 * k, pack(st[k][0], st[k][1]));
        st32(sDH + o + 8 * LDN + 8 * k, pack(st[k][2], st[k][3]));
        const float2 h0a = unpack(ld32(v.h0 + o + 8 * k));
        const float2 h0b = unpack(ld32(v.h0 + o + 8 * LDN + 8 * k));
        hh += st[k][0] * h0a.x + st[k][1] * h0a.y + st[k][2] * h0b.x + st[k][3] * h0b.y;
      }
      hh = warp_sum(hh);
      if (lane == 0) fHH[cw] = hh;
    } else if (lane == 0) {
      fHH[cw] = 0.f;
    }

    // ---- C B^T and dY X^T at rows 16 rt, columns 32 hf .. + 31; then M,
    // Pm (bf16, shared memory) and K's partial row and column sums
    {
      float cb[4][4], dm[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[t][e] = dm[t][e] = 0.f;
      strip<N / 16, 4, false, false>(cb, v.c, LDN, 16 * rt, v.b, LDN, 32 * hf, lane);
      strip<PS / 16, 4, false, false>(dm, v.dy, LDX, 16 * rt, v.x, LDX, 32 * hf, lane);
      const float csi[2] = {v.cs[i0], v.cs[i1]};
      float rk[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 32 * hf + 8 * t + c0;
        float mv[4], pv[4], ck[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? i0 : i1, jj = j + (e & 1);
          const float l = jj <= i ? exp2f(a2 * (csi[e >> 1] - v.cs[jj])) : 0.f;
          const float d = v.dt[jj];
          const float kv = dm[t][e] * cb[t][e] * l;
          mv[e] = cb[t][e] * l * d;
          pv[e] = dm[t][e] * l * d;
          rk[e >> 1] += kv * d;
          ck[e & 1] += kv;
        }
        st32(sM + i0 * LDQ + j, pack(mv[0], mv[1]));
        st32(sM + i1 * LDQ + j, pack(mv[2], mv[3]));
        st32(sPm + i0 * LDQ + j, pack(pv[0], pv[1]));
        st32(sPm + i1 * LDQ + j, pack(pv[2], pv[3]));
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          ck[0] += __shfl_xor_sync(0xffffffffu, ck[0], off);
          ck[1] += __shfl_xor_sync(0xffffffffu, ck[1], off);
        }
        if (r0 == 0) {
          fColK[rt * Q + j] = ck[0];
          fColK[rt * Q + j + 1] = ck[1];
        }
      }
      rk[0] = quad_sum(rk[0]);
      rk[1] = quad_sum(rk[1]);
      if ((lane & 3) == 0) {
        fRowK[hf * Q + i0] = rk[0];
        fRowK[hf * Q + i1] = rk[1];
      }
    }
    sync_compute();  // M, Pm, dH's copy and the entering state are in shared memory

    // ---- dX = M^T dY + diag(w) B dH^T at rows 16 rt, columns PS/2 hf ..;
    // v_j = x_j . (dH b_j) from B dH^T
    {
      constexpr int XT = PS / 16;
      const int n0 = hf * (PS / 2);
      float mt[XT][4], bd[XT][4];
#pragma unroll
      for (int t = 0; t < XT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) mt[t][e] = bd[t][e] = 0.f;
      strip<Q / 16, XT, true, true>(mt, sM, LDQ, 16 * rt, v.dy, LDX, n0, lane);
      strip<N / 16, XT, false, false>(bd, v.b, LDN, 16 * rt, sDH, LDN, n0, lane);
      const float w0 = v.w[i0], w1 = v.w[i1];
      float vv[2] = {0.f, 0.f};
      bf16* d0 = dx + ((tok0 + i0) * H + h) * P + p_base + n0 + c0;
      bf16* d1 = dx + ((tok0 + i1) * H + h) * P + p_base + n0 + c0;
#pragma unroll
      for (int t = 0; t < XT; ++t) {
        const float2 xa = unpack(ld32(v.x + i0 * LDX + n0 + 8 * t + c0));
        const float2 xb = unpack(ld32(v.x + i1 * LDX + n0 + 8 * t + c0));
        vv[0] += xa.x * bd[t][0] + xa.y * bd[t][1];
        vv[1] += xb.x * bd[t][2] + xb.y * bd[t][3];
        st32(d0 + 8 * t, pack(fmaf(w0, bd[t][0], mt[t][0]), fmaf(w0, bd[t][1], mt[t][1])));
        st32(d1 + 8 * t, pack(fmaf(w1, bd[t][2], mt[t][2]), fmaf(w1, bd[t][3], mt[t][3])));
      }
      vv[0] = quad_sum(vv[0]);
      vv[1] = quad_sum(vv[1]);
      if ((lane & 3) == 0) {
        fV[hf * Q + i0] = vv[0];
        fV[hf * Q + i1] = vv[1];
      }
    }
    // ---- dC = Pm B + diag(e) dY H0 and dB = Pm^T C + diag(w) X dH at rows
    // 16 rt, columns N/2 hf ..; q_i = dy_i . (H0 c_i) from dY H0
    {
      constexpr int CT = N / 16;
      const int n0 = hf * (N / 2);
      const size_t gh = (size_t)H * npb, col = (size_t)h * npb + pb;
      float acc[CT][4];
#pragma unroll
      for (int t = 0; t < CT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
      strip<PS / 16, CT, false, true>(acc, v.dy, LDX, 16 * rt, v.h0, LDN, n0, lane);
      const float e0 = v.e[i0], e1 = v.e[i1];
      float qv[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        const float2 ca = unpack(ld32(v.c + i0 * LDN + n0 + 8 * t + c0));
        const float2 cb = unpack(ld32(v.c + i1 * LDN + n0 + 8 * t + c0));
        qv[0] += ca.x * acc[t][0] + ca.y * acc[t][1];
        qv[1] += cb.x * acc[t][2] + cb.y * acc[t][3];
        acc[t][0] *= e0;
        acc[t][1] *= e0;
        acc[t][2] *= e1;
        acc[t][3] *= e1;
      }
      qv[0] = quad_sum(qv[0]);
      qv[1] = quad_sum(qv[1]);
      if ((lane & 3) == 0) {
        fQ[hf * Q + i0] = qv[0];
        fQ[hf * Q + i1] = qv[1];
      }
      strip<Q / 16, CT, false, true>(acc, sPm, LDQ, 16 * rt, v.b, LDN, n0, lane);
      float* g0 = dc_part + ((tok0 + i0) * gh + col) * N + n0 + c0;
      float* g1 = dc_part + ((tok0 + i1) * gh + col) * N + n0 + c0;
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        *reinterpret_cast<float2*>(g0 + 8 * t) = make_float2(acc[t][0], acc[t][1]);
        *reinterpret_cast<float2*>(g1 + 8 * t) = make_float2(acc[t][2], acc[t][3]);
      }

#pragma unroll
      for (int t = 0; t < CT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
      strip<PS / 16, CT, false, true>(acc, v.x, LDX, 16 * rt, sDH, LDN, n0, lane);
      const float w0 = v.w[i0], w1 = v.w[i1];
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        acc[t][0] *= w0;
        acc[t][1] *= w0;
        acc[t][2] *= w1;
        acc[t][3] *= w1;
      }
      strip<Q / 16, CT, true, true>(acc, sPm, LDQ, 16 * rt, v.c, LDN, n0, lane);
      g0 = db_part + ((tok0 + i0) * gh + col) * N + n0 + c0;
      g1 = db_part + ((tok0 + i1) * gh + col) * N + n0 + c0;
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        *reinterpret_cast<float2*>(g0 + 8 * t) = make_float2(acc[t][0], acc[t][1]);
        *reinterpret_cast<float2*>(g1 + 8 * t) = make_float2(acc[t][2], acc[t][3]);
      }
    }
    // ---- dH <- e_Q dH + (e dY)^T C, in registers (the other warps read the
    // old dH's copy in shared memory)
    if (has_state) {
      const float eq = v.e[Q - 1];
#pragma unroll
      for (int k = 0; k < TPW; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[k][e] *= eq;
      state_pass<TPW>(st, v.dy, LDX, 16 * smt, v.e, v.c, LDN, 8 * snt, lane);
    }
    sync_compute();  // the partial sums are in shared memory

    // ---- the per-token tail, two tokens a lane: dcum, its suffix sums for
    // ddt, and da
    if (cw == 0) {
      float dcum[2], colk[2], vs[2], wv = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 2 * lane + u;
        const float rowk = fRowK[i] + fRowK[Q + i];
        colk[u] = fColK[i] + fColK[Q + i] + fColK[2 * Q + i] + fColK[3 * Q + i];
        vs[u] = fV[i] + fV[Q + i];
        const float qs = fQ[i] + fQ[Q + i];
        dcum[u] = rowk - v.dt[i] * colk[u] + v.e[i] * qs - v.w[i] * vs[u];
        wv += v.w[i] * vs[u];
      }
      wv = warp_sum(wv);
      if (lane == 31) {
        float hh = 0.f;
#pragma unroll
        for (int w = 0; w < CW; ++w) hh += fHH[w];
        dcum[1] += v.e[Q - 1] * hh + wv;
      }
      // suffix sums: within the lane, then over the lanes above
      const float mine = dcum[0] + dcum[1];
      float run = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, run, off);
        if (lane + off < 32) run += o;
      }
      const float above = run - mine;
      const float suf[2] = {above + mine, above + dcum[1]};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 2 * lane + u;
        ddt_part[((tok0 + i) * H + h) * npb + pb] = colk[u] + v.u[i] * vs[u] + a_h * suf[u];
        da_acc = fmaf(dcum[u], v.cs[i], da_acc);
      }
    }
  }
  if (cw == 0) {
    da_acc = warp_sum(da_acc);
    if (lane == 0) da_part[((size_t)bi * H + h) * npb + pb] = da_acc;
  }
}

template <int PS, int N>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           const void* dy, const void* dfinal, void* hs, void* dx, void* ddt, void* da, void* db,
           void* dc, int B, int S, int H, int P, int G, cudaStream_t stream) {
  using T = Tile<PS, N>;
  // above 48 KB a kernel's dynamic shared memory must be opted into, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_bwd_tc_kernel<PS, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  ssd_bwd_tc_kernel<PS, N><<<dim3(P / PS, H, B), THREADS, T::BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const bf16*>(b), static_cast<const bf16*>(c), static_cast<const bf16*>(dy),
      static_cast<const float*>(dfinal), static_cast<bf16*>(hs), static_cast<bf16*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(da), static_cast<float*>(db),
      static_cast<float*>(dc), S, H, P, G);
  return (int)cudaGetLastError();
}

// PS = 64 state rows a CTA where 64 divides P, else 32
template <int N>
int launch_n(const void* x, const void* dt, const void* a, const void* b, const void* c,
             const void* dy, const void* dfinal, void* hs, void* dx, void* ddt, void* da,
             void* db, void* dc, int B, int S, int H, int P, int G, cudaStream_t stream) {
  return P % 64 ? launch<32, N>(x, dt, a, b, c, dy, dfinal, hs, dx, ddt, da, db, dc, B, S, H, P,
                                G, stream)
                : launch<64, N>(x, dt, a, b, c, dy, dfinal, hs, dx, ddt, da, db, dc, B, S, H, P,
                                G, stream);
}

int launch_bf16(const void* x, const void* dt, const void* a, const void* b, const void* c,
                const void* dy, const void* dfinal, void* hs, void* dx, void* ddt, void* da,
                void* db, void* dc, int B, int S, int H, int P, int N, int G,
                cudaStream_t stream) {
  if (B < 1 || S < Q || S % Q || H < 1 || P < 32 || P % 32 || G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
#define SSD_BWD_TC_N(NN)                                                                     \
  case NN:                                                                                  \
    return launch_n<NN>(x, dt, a, b, c, dy, dfinal, hs, dx, ddt, da, db, dc, B, S, H, P, G,  \
                        stream);
  switch (N) {
    SSD_BWD_TC_N(16)
    SSD_BWD_TC_N(32)
    SSD_BWD_TC_N(64)
    SSD_BWD_TC_N(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSD_BWD_TC_N
}

}  // namespace tc

}  // namespace

// x (B,S,H,P), dt (B,S,H) fp32, a (H,) fp32, b/c (B,S,G,N), dy (B,S,H,P) in
// x's dtype, dfinal (B,H,P,N) fp32 or null (a zero cotangent), hs scratch
// (B,H,S/64,P,N) in x's dtype -> dx (B,S,H,P) in x's dtype and fp32 partials
// over the P/PS row blocks: ddt (B,S,H,P/PS), da (B,H,P/PS), db and dc
// (B,S,H*P/PS,N), PS = 32 in fp32 and in bf16 64 where it divides P, else
// 32. S a multiple of 64, P of 32, N in {16,32,64,128}; in bf16 x, b, c and
// dy 16-byte aligned. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int ssd_scan_bwd_f32(const void* x, const void* dt, const void* a, const void* b,
                                const void* c, const void* dy, const void* dfinal, void* hs,
                                void* dx, void* ddt, void* da, void* db, void* dc, int B, int S,
                                int H, int P, int N, int G, void* stream) {
  return launch<float>(x, dt, a, b, c, dy, dfinal, hs, dx, ddt, da, db, dc, B, S, H, P, N, G,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int ssd_scan_bwd_bf16(const void* x, const void* dt, const void* a, const void* b,
                                 const void* c, const void* dy, const void* dfinal, void* hs,
                                 void* dx, void* ddt, void* da, void* db, void* dc, int B, int S,
                                 int H, int P, int N, int G, void* stream) {
  return tc::launch_bf16(x, dt, a, b, c, dy, dfinal, hs, dx, ddt, da, db, dc, B, S, H, P, N, G,
                         static_cast<cudaStream_t>(stream));
}
