// Backward of the gated-delta-rule scan for Hopper (sm_90a), fp32 and bf16
// inputs, in the chunked (WY / UT-transform) form with every product on the
// tensor cores.
//
// Replaces no TPU kernel: the Pallas kernel src/repro/kernels/gdn/gdn.py
// (gdn_scan) has no backward, and the JAX package differentiates its jnp
// scan (jax.grad of src/repro/models/gdn.py:gdn_scan). The port's forward on
// the card is the kernel of gdn_scan.cu, so its gradient is a kernel too:
// this one computes what ref.py:gdn_scan_bwd_ref computes (the reverse
// scan), in the closed form that ref.py:gdn_scan_bwd_chunked_ref writes out.
//
// The algebra. gdn_scan.cu's notation: chunks of C = 32 tokens, gamma the
// cumsum of the floored log alpha inside the chunk, g = exp(gamma), Gamma_ti
// = exp(gamma_t - gamma_i) for i <= t, A = I + L with L_ti = beta_t
// Gamma_ti k_t.k_i (i < t), A U~ = diag(beta) V, A W = diag(beta g) K, M =
// (Q K^T) . Gamma, K~ = diag(Gamma_C.) K; per chunk, S0 the entry state and
// U = U~ - W S0, dS the cotangent of the exit state (dfinal at the last
// chunk, else the next chunk's dS0):
//   1. dU = M^T dY + K~ dS;  dS0 = g_C dS + (diag(g) Q)^T dY - W^T dU
//   2. dM = dY U^T, dK~ = U dS^T, d(gQ) = dY S0^T, dW = -dU S0^T,
//      dg_C += <dS, S0>
//   3. A^T Zu = dU, A^T Zw = dW (back substitution); dV = diag(beta) Zu,
//      dbeta += rowsum(Zu.V) + g rowsum(Zw.K), dK += diag(beta g) Zw,
//      dg += beta rowsum(Zw.K)
//   4. dA = -(Zu U~^T + Zw W^T) on the strict lower triangle: dbeta_t +=
//      sum_i dA_ti Gamma_ti k_t.k_i; with D = dA . beta Gamma, dK += D K +
//      D^T K; dGamma += dA . beta K K^T
//   5. E = dM . Gamma: dQ = E K + diag(g) d(gQ), dK += E^T Q, dGamma +=
//      dM . Q K^T, dg += rowsum(d(gQ).Q)
//   6. dK += diag(Gamma_C.) dK~, dGamma_C,i += rowsum(dK~.K)_i
//   7. P = dGamma . Gamma: dgamma = rowsum(P) - colsum(P) + dg g (dg_C on
//      the last row); dlog alpha is its reverse cumsum in the chunk; dalpha
//      = dlog alpha / alpha, 0 below the floor exp(-80) (the floor's
//      derivative).
// Only step 1 runs across chunks, and it is separable over value columns,
// as the forward's state is; every other step needs one whole chunk.
//
// What bounds it on this card: bytes. At gdn-4b's training shape (B 4, S
// 512, H 20, K 128, fp32) the call must read q, k, v, dy, beta, alpha and
// write dq, dk, dv, dbeta and dalpha (0.148 GB: 0.044 ms at 3.35 TB/s); its
// operations, three times the forward's chunked count, take ~0.035 ms at the
// TF32 tensor-core rate. What the design adds to the bytes: the scratches
// (S0 and dS each chunk, 84 MB each at gdn-4b; U and dU, 21 MB each; the
// operand images, 97 MB), written once, the images read by three kernels.
// What it adds in time: two chains of S / C dependent steps, and the post
// kernel's phases, which one CTA an SM cannot overlap. The per-token kernel
// it replaces walked the S tokens three times, each token a dependent chain
// of warp shuffles on the CUDA cores: 2.93 ms. This one: 0.60 ms on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md, chip_smoke.py --against).
//
// 1. gdn_bwd_prep_kernel, grid (S / C, H, B): gdn_scan.cu's prep, for every
//   chunk in parallel: the cumsum, K K^T and Q K^T on the tensor cores, the
//   forward substitution for U~ and W in fp32 (one thread a column), and the
//   operand image of both chains (W, K~, diag(g) Q, M as fp16 hi + lo; U~^T
//   fp32). Also the largest |dy| and |dfinal| of each (batch, head), by an
//   integer atomicMax on their bits (exact and order-free).
// 2. gdn_bwd_chain_kernel, grid (2 K / VC, H, B): the two chains, side by
//   side, both from the image. The first K / VC CTAs of a head run the
//   forward chain (gdn_scan.cu's gdn_chain_kernel without y: S^T in
//   accumulator registers, U^T = U~^T - S0^T W^T, S^T <- g_C S0^T + U^T K~)
//   and write each chunk's S0 and U. The others run the reverse chain from
//   dfinal: dS^T in accumulator registers, column-sliced as S is, per chunk
//   dU^T = dY^T M + dS^T K~^T and dS^T <- g_C dS^T + dY^T (diag(g) Q) -
//   dU^T W, and write each chunk's exit dS and dU. A CTA takes VC = 64 value
//   columns (8 warps: 32-column CTAs, and 128-column ones, were slower); a
//   pair of warps holds 16 of them, each warp half of the keys, and the
//   halves add their partial U^T / dU^T through shared memory. Each chunk's
//   operands arrive by TMA bulk copies into one of two buffers (the reverse
//   chain also gets its 32 rows of dy, one copy a lane). The chains are
//   bound by their bytes: each step moves ~85-105 KB an SM (the images in,
//   S0 or dS out).
// 3. gdn_bwd_post_kernel, grid (S / C, H, B), 8 warps: steps 2-7 for one
//   chunk. q, k, dy, U, dU, W and U~ as fp16 hi + lo tiles, all loaded in
//   one round; S0 and dS stream through in blocks of 64 keys, the next in
//   registers while the last one's products run; each warp owns the same
//   16 x 8 tiles of every C x C and C x K result, so dq and dk stay in its
//   registers from the first product to the store, and loads each A
//   fragment once for all of them. The back substitution for Zu and Zw
//   runs in fp32 on the CUDA cores, one thread a column. One warp sums the
//   gates. It writes dq, dk, dv (in the inputs' dtype), dbeta and dalpha
//   once each. 214 KB of shared memory: one CTA an SM, whose load and
//   compute phases do not overlap.
// The chain and the post kernel are launched with programmatic dependent
// launch (griddepcontrol), all three on the caller's stream, each grid
// releasing its dependent late (at its end, or its last chain step): an
// early release lets the waiting CTAs hold SMs the grid still needs.
//
// - Precision: every product splits both fp32 operands into fp16 hi + lo and
//   sums hi.hi + hi.lo + lo.hi on mma.sync.m16n8k16 (fp16 in, fp32
//   accumulate), as gdn_scan.cu does: on the CPU a single rounding of the
//   chain's products (fp16 or TF32) broke fp32's 2e-4. The cotangents are
//   scaled, per (batch, head), by the power of two that brings max(|dy|,
//   |dfinal|) into [0.5, 1), and every gradient is scaled back (they are
//   linear in the cotangents): unscaled, training's small cotangents fall
//   below fp16's normal range and the split loses precision (~2e-3 of max
//   |twin| at |dy| ~ 1e-5 on the CPU). bf16 inputs take the same kernels.
// - No float atomics and a fixed summation order: two calls give the same
//   bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;
using f16 = __half;  // the hi and lo parts of the split operands

constexpr int C = 32;                  // tokens a chunk: one lane a token in the cumsum
constexpr int LDM = C + 8;             // padded row of a C x C fp16 tile
constexpr int LDU = C + 4;             // padded row of U~^T (fp32)
constexpr int THREADS = 256;           // prep and post kernels
constexpr float LOG_ALPHA_MIN = -80.f;
constexpr float ALPHA_MIN = 1.8048513e-35f;  // exp(-80)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack(a, b);
}

// x as fp16 hi + lo: hi + lo = x to ~2^-22 relative (within fp16's range)
__device__ __forceinline__ void split1(float x, f16& hi, f16& lo) {
  hi = __float2half_rn(x);
  lo = __float2half_rn(x - __half2float(hi));
}
// four consecutive elements as floats (16-byte aligned fp32, 8-byte aligned bf16)
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x;
  out[1] = t.y;
  out[2] = t.z;
  out[3] = t.w;
}
__device__ __forceinline__ void load4(const bf16* p, float* out) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = unpack(t.x), b = unpack(t.y);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}
// two floats as packed fp16x2 hi and lo parts
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_f16(a, b);
  const float2 h = unpack_f16(hi);
  lo = pack_f16(a - h.x, b - h.y);
}
// four floats as fp16 hi and lo parts at hi[0..3], lo[0..3] (8-byte aligned)
__device__ __forceinline__ void store_split4(const float* x, f16* hi, f16* lo) {
  uint2 h, l;
  split2(x[0], x[1], h.x, l.x);
  split2(x[2], x[3], h.y, l.y);
  *reinterpret_cast<uint2*>(hi) = h;
  *reinterpret_cast<uint2*>(lo) = l;
}
// two adjacent elements of a split tile, as floats
__device__ __forceinline__ float2 join2(const f16* hi, const f16* lo) {
  const float2 h = unpack_f16(*reinterpret_cast<const uint32_t*>(hi));
  const float2 l = unpack_f16(*reinterpret_cast<const uint32_t*>(lo));
  return make_float2(h.x + l.x, h.y + l.y);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
// sum over the four lanes of a quad (one accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// sum over the eight lanes that share a column of an accumulator tile
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}
// The cotangents' scale from the bits of max(|dy|, |dfinal|): the power of
// two that brings it into [0.5, 1); 1 where it is 0 or not finite
// (ref.py:cotangent_scale)
__device__ __forceinline__ float cot_scale(uint32_t bits) {
  const float m = __uint_as_float(bits);
  if (!(m > 0.f) || !isfinite(m)) return 1.f;
  int e;
  frexpf(m, &e);
  return ldexpf(1.f, -min(max(e, -125), 125));
}

// One chunk's operand image, in scratch and in the chains' shared memory: W,
// K~ (the forward chain's), diag(g) Q (C x LD fp16, hi then lo each), M (C x
// LDM fp16, hi then lo: with the former, the reverse chain's), then U~^T (K x
// LDU fp32; the forward chain takes its VC rows).
template <int K>
struct Layout {
  static constexpr int LD = K + 8;
  static constexpr int TILE = C * LD;                 // elements of one C x K half
  static constexpr int FWD = 2 * 4 * TILE;            // bytes of W and K~
  static constexpr int REV = FWD + 2 * (2 * TILE + 2 * C * LDM);  // + diag(g) Q and M
  static constexpr int CHUNK = REV + K * LDU * 4;     // + U~^T: bytes a chunk
  static constexpr int VC = K < 64 ? K : 64;          // value columns a chain CTA
  static constexpr int NCB = K / VC;                  // chain CTAs a head and chain
  // chain warps: a pair for each 16 value columns, each half of the pair
  // holding half of the keys (one warp where K = 16)
  static constexpr int SPLIT = K >= 32 ? 2 : 1;
  static constexpr int WARPS = SPLIT * VC / 16;
  static constexpr int DYS = VC * 4 + 16;             // bytes a row of dy in a reverse buffer
  static constexpr int FBUF = FWD + VC * LDU * 4;     // bytes of a forward-chain buffer
  static constexpr int RBUF = REV + C * DYS;          // ... of a reverse-chain buffer
  static constexpr int CHAIN_SMEM = 2 * (FBUF > RBUF ? FBUF : RBUF);
  static_assert(FWD % 16 == 0 && REV % 16 == 0 && CHUNK % 16 == 0 && DYS % 16 == 0 &&
                    (LDU * 4) % 16 == 0,
                "TMA alignment");
};

// Scratch, in this order: S0 and dS each chunk ((B, H, S / C) of K x K fp32,
// [value][key]), U and dU ((B, S, H, K) fp32), the operand images, the
// chunks' decay g_C (fp32), max(|dy|, |dfinal|) a (batch, head) (bits).
template <int K>
struct Scratch {
  float *s0, *ds, *u, *du, *g_last;
  unsigned char* image;
  uint32_t* cmax;
  __host__ Scratch(void* base, int B, int S, int H) {
    const size_t chunks = (size_t)B * H * (S / C), toks = (size_t)B * S * H * K;
    s0 = static_cast<float*>(base);
    ds = s0 + chunks * K * K;
    u = ds + chunks * K * K;
    du = u + toks;
    image = reinterpret_cast<unsigned char*>(du + toks);
    g_last = reinterpret_cast<float*>(image + chunks * Layout<K>::CHUNK);
    cmax = reinterpret_cast<uint32_t*>(g_last + chunks);
  }
  static long long bytes(int B, int S, int H) {
    const long long chunks = (long long)B * H * (S / C), toks = (long long)B * S * H * K;
    return 4 * (2 * chunks * K * K + 2 * toks) + chunks * Layout<K>::CHUNK + 4 * chunks +
           4LL * B * H;
  }
};

// ---------------------------------------------------------------- prep
// grid (S / C, H, B)
template <typename T, int K>
__global__ void __launch_bounds__(THREADS, 3) gdn_bwd_prep_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ beta, const float* __restrict__ alpha, const T* __restrict__ dy,
    const float* __restrict__ dfinal, unsigned char* __restrict__ image,
    float* __restrict__ g_last, uint32_t* __restrict__ cmax, int S, int H) {
  using Lay = Layout<K>;
  constexpr int LD = Lay::LD;
  __shared__ __align__(16) f16 sKh[C * LD];
  __shared__ __align__(16) f16 sKl[C * LD];
  __shared__ __align__(16) f16 sQh[C * LD];
  __shared__ __align__(16) f16 sQl[C * LD];
  __shared__ __align__(16) float sL[C][C + 4];
  __shared__ float sGam[C], sG[C], sBeta[C], sMax[THREADS / 32];

  const int z = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nz = S / C;
  const size_t tok0 = (size_t)b * S + (size_t)z * C;
  const size_t chunk = ((size_t)b * H + h) * nz + z;
  unsigned char* base = image + chunk * Lay::CHUNK;
  f16* oW = reinterpret_cast<f16*>(base);       // W hi, lo
  f16* oK = oW + 2 * Lay::TILE;                  // diag(Gamma_C.) K hi, lo
  f16* oQ = oK + 2 * Lay::TILE;                  // diag(g) Q hi, lo
  f16* oM = oQ + 2 * Lay::TILE;                  // M hi, lo
  float* oU = reinterpret_cast<float*>(base + Lay::REV);  // U~^T

  // ---- every global load first: q, k and dy rows (4 consecutive elements a
  // thread a round) and the solve's right-hand column (v or k)
  constexpr int RQ = (C * K / 4 + THREADS - 1) / THREADS;
  float qv[RQ][4], kv[RQ][4];
  float amax = 0.f;
#pragma unroll
  for (int m = 0; m < RQ; ++m) {
    const int e = 4 * (tid + m * THREADS);
    if (e < C * K) {
      const size_t i = ((tok0 + e / K) * H + h) * K + e % K;
      float d[4];
      load4(q + i, qv[m]);
      load4(k + i, kv[m]);
      load4(dy + i, d);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(d[0]), fabsf(d[1])), fmaxf(fabsf(d[2]), fabsf(d[3]))));
    }
  }
  static_assert(2 * K <= THREADS, "one right-hand column a thread");
  const bool is_v = tid < K;
  const int col = is_v ? tid : tid - K;
  float x[C];
  if (tid < 2 * K) {
#pragma unroll
    for (int t = 0; t < C; ++t) x[t] = to_f((is_v ? v : k)[((tok0 + t) * H + h) * K + col]);
  }
  // this chunk's share of dfinal for the head's max
  if (dfinal != nullptr) {
    const float* df = dfinal + ((size_t)b * H + h) * K * K;
    for (int e = z * THREADS + tid; e < K * K; e += nz * THREADS) amax = fmaxf(amax, fabsf(df[e]));
  }
  amax = warp_max(amax);
  if (lane == 0) sMax[warp] = amax;
  // ---- cumsum of log alpha, one lane a token
  if (warp == 0) {
    const size_t i = (tok0 + lane) * H + h;
    float s = fmaxf(logf(alpha[i]), LOG_ALPHA_MIN);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += o;
    }
    sGam[lane] = s;
    sG[lane] = expf(s);
    sBeta[lane] = beta[i];
    if (lane == C - 1) g_last[chunk] = expf(s);
  }
  // ---- q, k rows as fp16 hi + lo for the products
#pragma unroll
  for (int m = 0; m < RQ; ++m) {
    const int e = 4 * (tid + m * THREADS);
    if (e < C * K) {
      const int o = (e / K) * LD + e % K;
      store_split4(qv[m], sQh + o, sQl + o);
      store_split4(kv[m], sKh + o, sKl + o);
    }
  }
  __syncthreads();
  if (tid == 0) {
    float mx = sMax[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) mx = fmaxf(mx, sMax[w]);
    atomicMax(cmax + (size_t)b * H + h, __float_as_uint(mx));  // bits of a float >= 0
  }
  // ---- diag(g) Q and diag(Gamma_C.) K for the chains
  const float gam_last = sGam[C - 1];
#pragma unroll
  for (int m = 0; m < RQ; ++m) {
    const int e = 4 * (tid + m * THREADS);
    if (e < C * K) {
      const int t = e / K, o = t * LD + e % K;
      const float gq = sG[t], gk = expf(gam_last - sGam[t]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[m][i] *= gq;
        kv[m][i] *= gk;
      }
      store_split4(qv[m], oQ + o, oQ + Lay::TILE + o);
      store_split4(kv[m], oK + o, oK + Lay::TILE + o);
    }
  }
  // ---- K K^T (warps 0-3) and Q K^T (warps 4-7): warp = (product, row tile,
  // column pair); hi.hi + hi.lo + lo.hi
  {
    const int prod = warp >> 2, mt = (warp >> 1) & 1, np = warp & 1;
    const f16* ah_s = prod ? sQh : sKh;
    const f16* al_s = prod ? sQl : sKl;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      uint32_t ah[4], al[4], bh[4], bl[4];
      const int arow = (16 * mt + (lane & 15)) * LD + 16 * kk + (lane >> 4) * 8;
      const int brow = (16 * np + (lane >> 4) * 8 + (lane & 7)) * LD + 16 * kk +
                       ((lane >> 3) & 1) * 8;
      ldsm_x4(ah, ah_s + arow);
      ldsm_x4(al, al_s + arow);
      ldsm_x4(bh, sKh + brow);
      ldsm_x4(bl, sKl + brow);
      mma_f16(acc[0], ah, bh[0], bh[1]);
      mma_f16(acc[1], ah, bh[2], bh[3]);
      mma_f16(acc[0], ah, bl[0], bl[1]);
      mma_f16(acc[1], ah, bl[2], bl[3]);
      mma_f16(acc[0], al, bh[0], bh[1]);
      mma_f16(acc[1], al, bh[2], bh[3]);
    }
    const int r0 = lane >> 2, c0 = (lane & 3) * 2;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = 16 * mt + r0 + 8 * hh, i = 16 * np + 8 * nt + c0;
        float gm[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          gm[e] = i + e <= t ? expf(sGam[t] - sGam[i + e]) * acc[nt][2 * hh + e] : 0.f;
        if (prod == 0) {
          sL[t][i] = i < t ? sBeta[t] * gm[0] : 0.f;
          sL[t][i + 1] = i + 1 < t ? sBeta[t] * gm[1] : 0.f;
        } else {
          uint32_t hi, lo;
          split2(gm[0], gm[1], hi, lo);
          *reinterpret_cast<uint32_t*>(oM + t * LDM + i) = hi;
          *reinterpret_cast<uint32_t*>(oM + C * LDM + t * LDM + i) = lo;
        }
      }
  }
  __syncthreads();
  // ---- (I + L) [U~ | W] = diag(beta) [V | diag(g) K], one thread a column
  if (tid < 2 * K) {
#pragma unroll
    for (int t = 0; t < C; ++t) x[t] *= is_v ? sBeta[t] : sBeta[t] * sG[t];
#pragma unroll
    for (int t = 1; t < C; ++t) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < t; i += 4) {
        const float4 l = *reinterpret_cast<const float4*>(&sL[t][i]);
        a[0] = fmaf(l.x, x[i], a[0]);
        a[1] = fmaf(l.y, x[i + 1], a[1]);
        a[2] = fmaf(l.z, x[i + 2], a[2]);
        a[3] = fmaf(l.w, x[i + 3], a[3]);
      }
      x[t] -= (a[0] + a[1]) + (a[2] + a[3]);
    }
    if (is_v) {
      float4* row = reinterpret_cast<float4*>(oU + col * LDU);
#pragma unroll
      for (int t = 0; t < C; t += 4) row[t / 4] = make_float4(x[t], x[t + 1], x[t + 2], x[t + 3]);
    } else {
#pragma unroll
      for (int t = 0; t < C; ++t) split1(x[t], oW[t * LD + col], oW[Lay::TILE + t * LD + col]);
    }
  }
  // the chain kernel may be scheduled once every CTA is here (earlier, its
  // CTAs would hold SMs that the last of these need); it waits for this
  // grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---------------------------------------------------------------- chains
// A fragments (16 x 16, over 16 keys) of this warp's state slice: the
// accumulators of two adjacent n8 tiles, split
__device__ __forceinline__ void state_frag(const float (*st)[4], uint32_t* ah, uint32_t* al) {
  split2(st[0][0], st[0][1], ah[0], al[0]);
  split2(st[0][2], st[0][3], ah[1], al[1]);
  split2(st[1][0], st[1][1], ah[2], al[2]);
  split2(st[1][2], st[1][3], ah[3], al[3]);
}
// the accumulators of C tokens (C / 8 n8 tiles) as A fragments over the
// chunk's tokens, hi and lo, times sign
__device__ __forceinline__ void token_frags(const float (*u)[4], float sign, uint32_t (*uh)[4],
                                            uint32_t (*ul)[4]) {
#pragma unroll
  for (int kt = 0; kt < C / 16; ++kt) {
    split2(sign * u[2 * kt][0], sign * u[2 * kt][1], uh[kt][0], ul[kt][0]);
    split2(sign * u[2 * kt][2], sign * u[2 * kt][3], uh[kt][1], ul[kt][1]);
    split2(sign * u[2 * kt + 1][0], sign * u[2 * kt + 1][1], uh[kt][2], ul[kt][2]);
    split2(sign * u[2 * kt + 1][2], sign * u[2 * kt + 1][3], uh[kt][3], ul[kt][3]);
  }
}
// acc += A . B on one 16-deep step, A and B split into hi and lo:
// hi.hi + hi.lo + lo.hi
__device__ __forceinline__ void mma3(float* acc, const uint32_t* ah, const uint32_t* al,
                                     const uint32_t* bh, const uint32_t* bl) {
  mma_f16(acc, ah, bh[0], bh[1]);
  mma_f16(acc, ah, bl[0], bl[1]);
  mma_f16(acc, al, bh[0], bh[1]);
}
// ... for two adjacent n8 tiles acc[0], acc[1], their B fragments from one
// ldmatrix.x4 (bh[0..1] and bh[2..3])
__device__ __forceinline__ void mma3x2(float (*acc)[4], const uint32_t* ah, const uint32_t* al,
                                       const uint32_t* bh, const uint32_t* bl) {
  mma3(acc[0], ah, al, bh, bl);
  mma3(acc[1], ah, al, bh + 2, bl + 2);
}

// The two halves of a pair add each other's partial over the keys (read
// before the barrier that ends the chunk).
template <int K>
__device__ __forceinline__ void pair_add(float (*u)[4], float4 (*xch)[C / 8][32], int warp,
                                         int pair, int lane) {
  if constexpr (Layout<K>::SPLIT > 1) {
#pragma unroll
    for (int n = 0; n < C / 8; ++n) xch[warp][n][lane] = make_float4(u[n][0], u[n][1], u[n][2], u[n][3]);
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + pair), "n"(64) : "memory");
#pragma unroll
    for (int n = 0; n < C / 8; ++n) {
      const float4 a = xch[warp ^ 1][n][lane];
      u[n][0] += a.x;
      u[n][1] += a.y;
      u[n][2] += a.z;
      u[n][3] += a.w;
    }
  }
}

// the state slice st (rows: value columns v0 + vr (+ 8); columns: keys k0 +
// 8 n + c0 (+1)) into a K x K [value][key] fp32 block
template <int NT>
__device__ __forceinline__ void store_state(float* dst, const float (*st)[4], int K, int v,
                                            int k0, int c0) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int key = k0 + 8 * n + c0;
    store2(dst + (size_t)v * K + key, st[n][0], st[n][1]);
    store2(dst + (size_t)(v + 8) * K + key, st[n][2], st[n][3]);
  }
}
// token tiles n (n % SPLIT == half) of U^T / dU^T into a (B, S, H, K) fp32 tensor
template <int SPLIT>
__device__ __forceinline__ void store_tokens(float* dst, const float (*u)[4], size_t tok0, int H,
                                             int K, int h, int v, int half, int c0) {
#pragma unroll
  for (int n = 0; n < C / 8; ++n) {
    if (n % SPLIT != half) continue;
    float* o = dst + ((tok0 + 8 * n + c0) * H + h) * K + v;
    const size_t row = (size_t)H * K;
    o[0] = u[n][0];
    o[row] = u[n][1];
    o[8] = u[n][2];
    o[row + 8] = u[n][3];
  }
}

// grid (2 K / VC, H, B), 32 * WARPS threads: the forward chain in the first
// K / VC CTAs of a head, the reverse chain in the others
template <typename T, int K>
__global__ void __launch_bounds__(32 * Layout<K>::WARPS) gdn_bwd_chain_kernel(
    const unsigned char* __restrict__ image, const float* __restrict__ g_last,
    const uint32_t* __restrict__ cmax, const T* __restrict__ dy,
    const float* __restrict__ dfinal, float* __restrict__ s0_out, float* __restrict__ ds_out,
    float* __restrict__ u_out, float* __restrict__ du_out, int S, int H) {
  using Lay = Layout<K>;
  constexpr int LD = Lay::LD, VC = Lay::VC, SPLIT = Lay::SPLIT, KH = K / SPLIT;
  constexpr int NT = KH / 8;       // n8 key tiles of this warp's state slice
  extern __shared__ __align__(16) unsigned char chain_smem[];
  __shared__ __align__(8) uint64_t full[2];
  __shared__ float4 xch[SPLIT > 1 ? Lay::WARPS : 1][C / 8][32];
  // the post kernel may be scheduled once every CTA has begun its last
  // step; it waits for this grid's writes
  auto last_step = [] { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); };
  const bool rev = blockIdx.x >= Lay::NCB;
  const int v0 = (blockIdx.x % Lay::NCB) * VC, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pair = warp / SPLIT, half = warp % SPLIT;
  const int r0 = lane >> 2, c0 = (lane & 3) * 2;
  const int nz = S / C;
  const size_t bh = (size_t)b * H + h, chunk0 = bh * nz;
  const int k0 = half * KH;        // this warp's keys k0 .. k0 + KH - 1
  const int vr = 16 * pair + r0;   // local value column of accumulator rows r0 (and + 8)

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init_fence();
  }
  __syncthreads();
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the prep kernel's writes

  float st[NT][4];                 // S^T or dS^T: 16 value columns x KH keys
  if (!rev) {
    // ---------------- forward chain: chunk z -> buffer z & 1
    auto issue = [&](int z) {
      unsigned char* buf = chain_smem + (z & 1) * Lay::FBUF;
      const unsigned char* src = image + (chunk0 + z) * Lay::CHUNK;
      fence_proxy_async();  // the buffer's last reads (chunk z - 2) come first
      mbar_expect_tx(&full[z & 1], Lay::FBUF);
      bulk_copy(buf, src, Lay::FWD, &full[z & 1]);
      bulk_copy(buf + Lay::FWD, src + Lay::REV + (size_t)v0 * LDU * 4, VC * LDU * 4,
                &full[z & 1]);
    };
    if (tid == 0) {
      issue(0);
      if (nz > 1) issue(1);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
    for (int z = 0; z < nz; ++z) {
      if (z == nz - 1) last_step();
      const float gc = __ldg(g_last + chunk0 + z);
      mbar_wait(&full[z & 1], (z >> 1) & 1);
      const unsigned char* buf = chain_smem + (z & 1) * Lay::FBUF;
      const f16* Wh = reinterpret_cast<const f16*>(buf);
      const f16* Wl = Wh + Lay::TILE;
      const f16* Kh = Wl + Lay::TILE;
      const f16* Kl = Kh + Lay::TILE;
      const float* Ut = reinterpret_cast<const float*>(buf + Lay::FWD);
      store_state<NT>(s0_out + (chunk0 + z) * K * K, st, K, v0 + vr, k0, c0);
      // ---- U^T = U~^T - S0^T W^T over this warp's keys (U~^T added by half 0)
      float u[C / 8][4];
#pragma unroll
      for (int n = 0; n < C / 8; ++n) {
        if (half == 0) {
          const float2 a = *reinterpret_cast<const float2*>(Ut + vr * LDU + 8 * n + c0);
          const float2 c = *reinterpret_cast<const float2*>(Ut + (vr + 8) * LDU + 8 * n + c0);
          u[n][0] = a.x;
          u[n][1] = a.y;
          u[n][2] = c.x;
          u[n][3] = c.y;
        } else {
          u[n][0] = u[n][1] = u[n][2] = u[n][3] = 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < KH / 16; ++kk) {
        uint32_t ah[4], al[4];
        state_frag(st + 2 * kk, ah, al);
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // -S0^T: flip the sign bits
          ah[e] ^= 0x80008000u;
          al[e] ^= 0x80008000u;
        }
#pragma unroll
        for (int np = 0; np < C / 16; ++np) {
          const int row = (16 * np + (lane >> 4) * 8 + (lane & 7)) * LD + k0 + 16 * kk +
                          ((lane >> 3) & 1) * 8;
          uint32_t bh[4], bl[4];
          ldsm_x4(bh, Wh + row);
          ldsm_x4(bl, Wl + row);
          mma3x2(u + 2 * np, ah, al, bh, bl);
        }
      }
      pair_add<K>(u, xch, warp, pair, lane);
      store_tokens<SPLIT>(u_out, u, (size_t)b * S + (size_t)z * C, H, K, h, v0 + vr, half, c0);
      // ---- S^T <- g_C S0^T + U^T K~ over this warp's keys (not after the last chunk)
      if (z + 1 < nz) {
        uint32_t uh[C / 16][4], ul[C / 16][4];
        token_frags(u, 1.f, uh, ul);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] *= gc;
#pragma unroll
        for (int kt = 0; kt < C / 16; ++kt) {
          const int row =
              (16 * kt + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + k0 + (lane >> 4) * 8;
#pragma unroll
          for (int n2 = 0; n2 < KH / 16; ++n2) {
            uint32_t bh[4], bl[4];
            ldsm_x4_t(bh, Kh + row + 16 * n2);
            ldsm_x4_t(bl, Kl + row + 16 * n2);
            mma3x2(st + 2 * n2, uh[kt], ul[kt], bh, bl);
          }
        }
      }
      __syncthreads();  // every warp is done with buffer z & 1
      if (tid == 0 && z + 2 < nz) issue(z + 2);
    }
    return;
  }
  // ---------------- reverse chain: step i = chunk nz - 1 - i -> buffer i & 1
  const float sc = cot_scale(cmax[bh]);
  auto issue = [&](int i) {  // by warp 0: the shared operands, and one row of dy a lane
    const int z = nz - 1 - i;
    unsigned char* buf = chain_smem + (i & 1) * Lay::RBUF;
    const unsigned char* src = image + (chunk0 + z) * Lay::CHUNK;
    fence_proxy_async();  // the buffer's last reads (step i - 2) come first
    if (lane == 0) mbar_expect_tx(&full[i & 1], Lay::REV + C * VC * (int)sizeof(T));
    __syncwarp();
    if (lane == 0) bulk_copy(buf, src, Lay::REV, &full[i & 1]);
    const size_t tok = (size_t)b * S + (size_t)z * C + lane;
    bulk_copy(buf + Lay::REV + lane * Lay::DYS, dy + (tok * H + h) * K + v0, VC * sizeof(T),
              &full[i & 1]);
  };
  static_assert(C == 32, "one row of dy a lane of warp 0");
  if (warp == 0) {
    issue(0);
    if (nz > 1) issue(1);
  }
  // dS^T from dfinal (B, H, K, K) [key][value], scaled
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (dfinal == nullptr) {
      st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
    } else {
      const float* df = dfinal + bh * K * K + v0 + vr;
      const int key = k0 + 8 * n + c0;
      st[n][0] = sc * df[(size_t)key * K];
      st[n][1] = sc * df[(size_t)(key + 1) * K];
      st[n][2] = sc * df[(size_t)key * K + 8];
      st[n][3] = sc * df[(size_t)(key + 1) * K + 8];
    }
  }
  for (int i = 0; i < nz; ++i) {
    const int z = nz - 1 - i;
    if (i == nz - 1) last_step();
    const float gc = __ldg(g_last + chunk0 + z);
    mbar_wait(&full[i & 1], (i >> 1) & 1);
    const unsigned char* buf = chain_smem + (i & 1) * Lay::RBUF;
    const f16* Wh = reinterpret_cast<const f16*>(buf);
    const f16* Wl = Wh + Lay::TILE;
    const f16* Kh = Wl + Lay::TILE;
    const f16* Kl = Kh + Lay::TILE;
    const f16* Qh = Kl + Lay::TILE;
    const f16* Ql = Qh + Lay::TILE;
    const f16* Mh = Ql + Lay::TILE;
    const f16* Ml = Mh + C * LDM;
    const unsigned char* dyb = buf + Lay::REV;
    store_state<NT>(ds_out + (chunk0 + z) * K * K, st, K, v0 + vr, k0, c0);
    // ---- dY^T (scaled) as A fragments over the chunk's tokens
    uint32_t yh[C / 16][4], yl[C / 16][4];
    {
      auto d = [&](int t, int vv) {
        return sc * to_f(reinterpret_cast<const T*>(dyb + t * Lay::DYS)[vv]);
      };
#pragma unroll
      for (int kt = 0; kt < C / 16; ++kt) {
        const int t = 16 * kt + c0;
        split2(d(t, vr), d(t + 1, vr), yh[kt][0], yl[kt][0]);
        split2(d(t, vr + 8), d(t + 1, vr + 8), yh[kt][1], yl[kt][1]);
        split2(d(t + 8, vr), d(t + 9, vr), yh[kt][2], yl[kt][2]);
        split2(d(t + 8, vr + 8), d(t + 9, vr + 8), yh[kt][3], yl[kt][3]);
      }
    }
    // ---- dU^T = dS^T K~^T over this warp's keys + dY^T M for its token blocks
    float u[C / 8][4];
#pragma unroll
    for (int n = 0; n < C / 8; ++n) u[n][0] = u[n][1] = u[n][2] = u[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KH / 16; ++kk) {
      uint32_t ah[4], al[4];
      state_frag(st + 2 * kk, ah, al);
#pragma unroll
      for (int np = 0; np < C / 16; ++np) {
        const int row = (16 * np + (lane >> 4) * 8 + (lane & 7)) * LD + k0 + 16 * kk +
                        ((lane >> 3) & 1) * 8;
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, Kh + row);
        ldsm_x4(bl, Kl + row);
        mma3x2(u + 2 * np, ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int np = 0; np < C / 16; ++np) {
      if (np % SPLIT != half) continue;
      // M[s][t] is 0 for s < t: token blocks kt < np add nothing
#pragma unroll
      for (int kt = np; kt < C / 16; ++kt) {
        const int row =
            (16 * kt + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDM + 16 * np + (lane >> 4) * 8;
        uint32_t bh[4], bl[4];
        ldsm_x4_t(bh, Mh + row);
        ldsm_x4_t(bl, Ml + row);
        mma3x2(u + 2 * np, yh[kt], yl[kt], bh, bl);
      }
    }
    pair_add<K>(u, xch, warp, pair, lane);
    store_tokens<SPLIT>(du_out, u, (size_t)b * S + (size_t)z * C, H, K, h, v0 + vr, half, c0);
    // ---- dS^T <- g_C dS^T + dY^T (diag(g) Q) - dU^T W over this warp's keys
    if (i + 1 < nz) {
      uint32_t nh[C / 16][4], nl[C / 16][4];
      token_frags(u, -1.f, nh, nl);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] *= gc;
#pragma unroll
      for (int kt = 0; kt < C / 16; ++kt) {
        const int row =
            (16 * kt + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + k0 + (lane >> 4) * 8;
#pragma unroll
        for (int n2 = 0; n2 < KH / 16; ++n2) {
          uint32_t bh[4], bl[4];
          ldsm_x4_t(bh, Qh + row + 16 * n2);
          ldsm_x4_t(bl, Ql + row + 16 * n2);
          mma3x2(st + 2 * n2, yh[kt], yl[kt], bh, bl);
          ldsm_x4_t(bh, Wh + row + 16 * n2);
          ldsm_x4_t(bl, Wl + row + 16 * n2);
          mma3x2(st + 2 * n2, nh[kt], nl[kt], bh, bl);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer i & 1
    if (warp == 0 && i + 2 < nz) issue(i + 2);
  }
}

// ---------------------------------------------------------------- post
// A fragment (16 x 16) at (m0, k0) of a row-major [m][k] tile, or (AT) of
// A = S^T with S a row-major [k][m] tile
template <bool AT>
__device__ __forceinline__ void load_a(uint32_t* f, const f16* s, int ld, int m0, int k0,
                                       int lane) {
  if constexpr (AT)
    ldsm_x4_t(f, s + (k0 + (lane >> 4) * 8 + (lane & 7)) * ld + m0 + ((lane >> 3) & 1) * 8);
  else
    ldsm_x4(f, s + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
// B fragment of one n8 tile at n0 over k0 .. k0 + 15, from a row-major [k][n]
// tile (KN) or from B = T^T with T a row-major [n][k] tile (lanes 0-15 give
// the addresses)
template <bool KN>
__device__ __forceinline__ void load_b(uint32_t* f, const f16* s, int ld, int k0, int n0,
                                       int lane) {
  if constexpr (KN)
    ldsm_x2_t(f, s + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0);
  else
    ldsm_x2(f, s + (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
}
// acc (the 16 x 8 tile at rows m0, columns n0) += A . B over KT 16-deep
// steps, A and B split tiles (hi, and lo at + alo / + blo elements)
template <int KT, bool AT, bool KN>
__device__ __forceinline__ void mm3(float* acc, const f16* a, int alo, int lda, int m0,
                                    const f16* b, int blo, int ldb, int n0, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t ah[4], al[4], bh[2], bl[2];
    load_a<AT>(ah, a, lda, m0, 16 * kk, lane);
    load_a<AT>(al, a + alo, lda, m0, 16 * kk, lane);
    load_b<KN>(bh, b, ldb, 16 * kk, n0, lane);
    load_b<KN>(bl, b + blo, ldb, 16 * kk, n0, lane);
    mma3(acc, ah, al, bh, bl);
  }
}

// the post kernel's shared memory, in bytes
template <int K>
struct Post {
  static constexpr int LD = K + 8;                  // row of a split C x K tile
  static constexpr int TILE = C * LD;               // elements of one half
  static constexpr int KB = K < 64 ? K : 64;        // keys a block of S0 / dS
  static constexpr int JB = KB >= 32 ? KB / 32 : 1;  // n8 tiles a warp and block
  static constexpr int LDB = KB + 8;                // row of a block ([value][key])
  static constexpr int BT = K * LDB;                // elements of one half of a block
  static constexpr int NTW = K >= 32 ? K / 32 : 1;  // C x K n8 tiles a warp
  static constexpr int LDF = K + 4;                 // row of an fp32 C x K tile
  static constexpr int SPLIT_BYTES = 4 * TILE;      // a split C x K tile, hi and lo
  // split C x K tiles: q, k, dy (scaled), U, dU, W, U~ (Zu and Zw later in
  // dy's and U's)
  static constexpr int Q_ = 0, K_ = Q_ + SPLIT_BYTES, DY = K_ + SPLIT_BYTES,
                       U = DY + SPLIT_BYTES, DU = U + SPLIT_BYTES, W = DU + SPLIT_BYTES,
                       UT = W + SPLIT_BYTES, BLK = UT + SPLIT_BYTES;
  // the S0 and dS blocks (split), later dW / Zw and Zu in fp32 (C x LDF each)
  static constexpr int BLK_BYTES =
      4 * 2 * BT > 2 * C * LDF * 4 ? 4 * 2 * BT : 2 * C * LDF * 4;
  // E and D (split C x C), L^T (fp32 C x (C + 4)), per-token vectors
  // (gamma, g, beta, alpha), partial sums (7 x 4 x C) and <dS, S0> a warp
  static constexpr int E = BLK + BLK_BYTES, D = E + 4 * C * LDM, LT = D + 4 * C * LDM,
                       F = LT + C * (C + 4) * 4, PART = F + 4 * C * 4, DGC = PART + 7 * 4 * C * 4,
                       BYTES = DGC + 8 * 4;
  static_assert(K % KB == 0 && (LDF * 4) % 16 == 0, "tile shapes");
  static_assert(BYTES <= 232448, "shared memory");
};

// grid (S / C, H, B), 8 warps: warp (mt = warp & 1, cg = warp >> 1) owns
// rows 16 mt .. 16 mt + 15 of every result, columns 8 cg .. of the C x C
// ones and the n8 tiles 4 i + cg of the C x K ones
template <typename T, int K>
__global__ void __launch_bounds__(THREADS, 1) gdn_bwd_post_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ beta, const float* __restrict__ alpha, const T* __restrict__ dy,
    const unsigned char* __restrict__ image, const uint32_t* __restrict__ cmax,
    const float* __restrict__ s0g, const float* __restrict__ dsg, const float* __restrict__ ug,
    const float* __restrict__ dug, T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ dbeta, float* __restrict__ dalpha, int S, int H) {
  using P = Post<K>;
  using Lay = Layout<K>;
  constexpr int LD = P::LD, TILE = P::TILE, KB = P::KB, LDB = P::LDB, LDF = P::LDF;
  constexpr int NTW = P::NTW, KT = K / 16, JB = P::JB;
  extern __shared__ __align__(16) unsigned char post_smem[];
  f16* sQ = reinterpret_cast<f16*>(post_smem + P::Q_);
  f16* sK = reinterpret_cast<f16*>(post_smem + P::K_);
  f16* sDY = reinterpret_cast<f16*>(post_smem + P::DY);
  f16* sU = reinterpret_cast<f16*>(post_smem + P::U);
  f16* sDU = reinterpret_cast<f16*>(post_smem + P::DU);
  f16* sW = reinterpret_cast<f16*>(post_smem + P::W);
  f16* sUT = reinterpret_cast<f16*>(post_smem + P::UT);
  f16* sS0 = reinterpret_cast<f16*>(post_smem + P::BLK);
  f16* sDS = sS0 + 2 * P::BT;
  float* sRW = reinterpret_cast<float*>(post_smem + P::BLK);  // dW, then Zw (after the blocks)
  float* sZU = sRW + C * LDF;                                  // Zu
  f16* sE = reinterpret_cast<f16*>(post_smem + P::E);
  f16* sD = reinterpret_cast<f16*>(post_smem + P::D);
  float(*sLT)[C + 4] = reinterpret_cast<float(*)[C + 4]>(post_smem + P::LT);
  float* sGam = reinterpret_cast<float*>(post_smem + P::F);
  float* sG = sGam + C;
  float* sBeta = sG + C;
  float* sAl = sBeta + C;
  // partial sums, [quantity][column group or row tile][token]: rowsum(Zu.V),
  // rowsum(Zw.K), rowsum(d(gQ).Q), rowsum(dK~.K), the dA term of dbeta,
  // rowsum(P), colsum(P)
  float(*sPart)[4][C] = reinterpret_cast<float(*)[4][C]>(post_smem + P::PART);
  float* sDgc = reinterpret_cast<float*>(post_smem + P::DGC);

  const int z = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp & 1, cg = warp >> 1;
  const int r0 = lane >> 2, c0 = (lane & 3) * 2;
  const int nz = S / C;
  const size_t bh = (size_t)b * H + h, tok0 = (size_t)b * S + (size_t)z * C;
  const size_t chunk = bh * nz + z;
  const int t0 = 16 * mt + r0;     // this lane's accumulator rows t0, t0 + 8

  // ---- the gates (inputs: before the wait)
  if (warp == 0) {
    const size_t i = (tok0 + lane) * H + h;
    float s = fmaxf(logf(alpha[i]), LOG_ALPHA_MIN);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += o;
    }
    sGam[lane] = s;
    sG[lane] = expf(s);
    sBeta[lane] = beta[i];
    sAl[lane] = alpha[i];
  }
  // ---- every load of the chunk's tiles in one round: q, k and v (inputs:
  // before the wait), then dy, U, dU, W and U~^T; 4 elements a thread and
  // round of a C x K tile
  constexpr int RQ = (C * K / 4 + THREADS - 1) / THREADS;
  constexpr int RW = (4 * TILE / 16 + THREADS - 1) / THREADS;  // W: 16 bytes a round
  constexpr int RU = (K * C / 4 + THREADS - 1) / THREADS;      // U~: 4 columns of a token
  const bool owns = 8 * cg < KB;   // K = 16: warps of column groups 2, 3 own no C x K tile
  float x[5][RQ][4];               // q, k, dy, U, dU
  float uu[RU][4];
  uint4 ww[RW];
#pragma unroll
  for (int m = 0; m < RQ; ++m) {
    const int e = 4 * (tid + m * THREADS);
    if (e < C * K) {
      const size_t i = ((tok0 + e / K) * H + h) * K + e % K;
      load4(q + i, x[0][m]);
      load4(k + i, x[1][m]);
    }
  }
  // v at this lane's C x K positions, for rowsum(Zu.V)
  float vx[NTW][2][2];
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const T* vp = v + ((tok0 + t0 + 8 * hh) * H + h) * K + (owns ? 8 * (4 * i + cg) + c0 : 0);
      vx[i][hh][0] = to_f(vp[0]);
      vx[i][hh][1] = to_f(vp[1]);
    }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the chains' (and the prep's) writes
  const float sc = cot_scale(cmax[bh]), inv = 1.f / sc;
  const unsigned char* img = image + chunk * Lay::CHUNK;
  const float* ut = reinterpret_cast<const float*>(img + Lay::REV);
#pragma unroll
  for (int m = 0; m < RQ; ++m) {
    const int e = 4 * (tid + m * THREADS);
    if (e < C * K) {
      const size_t i = ((tok0 + e / K) * H + h) * K + e % K;
      load4(dy + i, x[2][m]);
      load4(ug + i, x[3][m]);
      load4(dug + i, x[4][m]);
    }
  }
#pragma unroll
  for (int m = 0; m < RW; ++m) {
    const int e = tid + m * THREADS;
    if (e < 4 * TILE / 16) ww[m] = reinterpret_cast<const uint4*>(img)[e];
  }
#pragma unroll
  for (int m = 0; m < RU; ++m) {
    const int e = tid + m * THREADS;
    if (e < K * C / 4) {
      const int s_ = e / (K / 4), j = 4 * (e % (K / 4));
#pragma unroll
      for (int i = 0; i < 4; ++i) uu[m][i] = ut[(j + i) * LDU + s_];
    }
  }
  // ... into shared memory, as fp16 hi + lo (dy scaled)
#pragma unroll
  for (int m = 0; m < RQ; ++m) {
    const int e = 4 * (tid + m * THREADS);
    if (e < C * K) {
      const int o = (e / K) * LD + e % K;
#pragma unroll
      for (int j = 0; j < 4; ++j) x[2][m][j] *= sc;
      store_split4(x[0][m], sQ + o, sQ + TILE + o);
      store_split4(x[1][m], sK + o, sK + TILE + o);
      store_split4(x[2][m], sDY + o, sDY + TILE + o);
      store_split4(x[3][m], sU + o, sU + TILE + o);
      store_split4(x[4][m], sDU + o, sDU + TILE + o);
    }
  }
#pragma unroll
  for (int m = 0; m < RW; ++m) {
    const int e = tid + m * THREADS;
    if (e < 4 * TILE / 16) reinterpret_cast<uint4*>(sW)[e] = ww[m];  // the image's split tile
  }
#pragma unroll
  for (int m = 0; m < RU; ++m) {
    const int e = tid + m * THREADS;
    if (e < K * C / 4) {
      const int o = (e / (K / 4)) * LD + 4 * (e % (K / 4));
      store_split4(uu[m], sUT + o, sUT + TILE + o);
    }
  }
  // the S0 and dS blocks: the next one loads into registers while the
  // products before it run
  constexpr int RB = (K * KB / 4 + THREADS - 1) / THREADS;
  float pf[2][RB][4];
  auto fetch = [&](int kb) {
#pragma unroll
    for (int m = 0; m < RB; ++m) {
      const int e = tid + m * THREADS;
      if (e < K * KB / 4) {
        const size_t o = chunk * K * K + (size_t)(e / (KB / 4)) * K + kb * KB + 4 * (e % (KB / 4));
        load4(s0g + o, pf[0][m]);
        load4(dsg + o, pf[1][m]);
      }
    }
  };
  fetch(0);
  __syncthreads();

  // ---- the C x C tiles (mt, cg): K K^T, Q K^T, dM = dY U^T; L^T for the solve
  const int ci = 8 * cg + c0;      // this lane's C x C columns ci, ci + 1
  float kk[4] = {0.f, 0.f, 0.f, 0.f}, qk[4] = {0.f, 0.f, 0.f, 0.f}, dm[4] = {0.f, 0.f, 0.f, 0.f};
  mm3<KT, false, false>(kk, sK, TILE, LD, 16 * mt, sK, TILE, LD, 8 * cg, lane);
  mm3<KT, false, false>(qk, sQ, TILE, LD, 16 * mt, sK, TILE, LD, 8 * cg, lane);
  mm3<KT, false, false>(dm, sDY, TILE, LD, 16 * mt, sU, TILE, LD, 8 * cg, lane);
  float gmm[4];                    // Gamma at this lane's four C x C elements
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = t0 + 8 * (e >> 1), i = ci + (e & 1);
    gmm[e] = i <= t ? expf(sGam[t] - sGam[i]) : 0.f;
    sLT[i][t] = i < t ? sBeta[t] * gmm[e] * kk[e] : 0.f;
  }

  // ---- the key blocks of S0 and dS: dK~, d(gQ) and dW for the warp's n8
  // tiles of each block, <dS, S0>
  float acc_q[NTW][4], acc_k[NTW][4], acc_w[NTW][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_q[i][e] = acc_k[i][e] = acc_w[i][e] = 0.f;
  float r_gq[2] = {0.f, 0.f}, r_kt[2] = {0.f, 0.f}, dgc = 0.f;
  const float glast[2] = {expf(sGam[C - 1] - sGam[t0]), expf(sGam[C - 1] - sGam[t0 + 8])};
  const float gt[2] = {sG[t0], sG[t0 + 8]};
#pragma unroll
  for (int kb = 0; kb < K / KB; ++kb) {
    __syncthreads();               // the previous block's reads are done
#pragma unroll
    for (int m = 0; m < RB; ++m) {
      const int e = tid + m * THREADS;
      if (e < K * KB / 4) {
        const int o = (e / (KB / 4)) * LDB + 4 * (e % (KB / 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) dgc = fmaf(pf[0][m][i], pf[1][m][i], dgc);
        store_split4(pf[0][m], sS0 + o, sS0 + P::BT + o);
        store_split4(pf[1][m], sDS + o, sDS + P::BT + o);
      }
    }
    if (kb + 1 < K / KB) fetch(kb + 1);
    __syncthreads();
    if (!owns) continue;
    // U dS^T, dY S0^T and dU S0^T for the warp's n8 tiles of the block: each
    // A fragment loaded once a 16-deep step, each B fragment once for both
    // products that take it
    float dkt[JB][4], dgq[JB][4], dwn[JB][4];
#pragma unroll
    for (int j = 0; j < JB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dkt[j][e] = dgq[j][e] = dwn[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ah[3][4], al[3][4];
      load_a<false>(ah[0], sU, LD, 16 * mt, 16 * kk, lane);
      load_a<false>(al[0], sU + TILE, LD, 16 * mt, 16 * kk, lane);
      load_a<false>(ah[1], sDY, LD, 16 * mt, 16 * kk, lane);
      load_a<false>(al[1], sDY + TILE, LD, 16 * mt, 16 * kk, lane);
      load_a<false>(ah[2], sDU, LD, 16 * mt, 16 * kk, lane);
      load_a<false>(al[2], sDU + TILE, LD, 16 * mt, 16 * kk, lane);
#pragma unroll
      for (int j = 0; j < JB; ++j) {
        const int nl = 8 * (4 * j + cg);
        uint32_t dh[2], dl[2], sh[2], sl[2];
        load_b<true>(dh, sDS, LDB, 16 * kk, nl, lane);
        load_b<true>(dl, sDS + P::BT, LDB, 16 * kk, nl, lane);
        load_b<true>(sh, sS0, LDB, 16 * kk, nl, lane);
        load_b<true>(sl, sS0 + P::BT, LDB, 16 * kk, nl, lane);
        mma3(dkt[j], ah[0], al[0], dh, dl);
        mma3(dgq[j], ah[1], al[1], sh, sl);
        mma3(dwn[j], ah[2], al[2], sh, sl);
      }
    }
#pragma unroll
    for (int j = 0; j < JB; ++j) {
      const int ti = kb * JB + j;
      const int a = kb * KB + 8 * (4 * j + cg) + c0;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + 8 * hh;
        const float2 kx = join2(sK + t * LD + a, sK + TILE + t * LD + a);
        const float2 qx = join2(sQ + t * LD + a, sQ + TILE + t * LD + a);
        r_kt[hh] += dkt[j][2 * hh] * kx.x + dkt[j][2 * hh + 1] * kx.y;
        r_gq[hh] += dgq[j][2 * hh] * qx.x + dgq[j][2 * hh + 1] * qx.y;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc_k[ti][2 * hh + e] = glast[hh] * dkt[j][2 * hh + e];
          acc_q[ti][2 * hh + e] = gt[hh] * dgq[j][2 * hh + e];
          acc_w[ti][2 * hh + e] = -dwn[j][2 * hh + e];
        }
      }
    }
  }
  // the back substitution's right-hand column: dU's loads go out now
  const bool is_u = tid < K;
  const int jc = is_u ? tid : tid - K;
  float xs[C];
  if (is_u) {
#pragma unroll
    for (int t = 0; t < C; ++t) xs[t] = dug[((tok0 + t) * H + h) * K + jc];
  }
  dgc = warp_sum(dgc);
  if (lane == 0) sDgc[warp] = dgc;
  __syncthreads();                 // the blocks are read: their space takes dW, Zw and Zu
  if (owns) {
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      const int a = 8 * (4 * i + cg) + c0;
      store2(sRW + t0 * LDF + a, acc_w[i][0], acc_w[i][1]);
      store2(sRW + (t0 + 8) * LDF + a, acc_w[i][2], acc_w[i][3]);
    }
  }
  __syncthreads();

  // ---- A^T [Zu | Zw] = [dU | dW] by back substitution, one thread a column
  // (A^T is unit upper triangular: Z_t = R_t - sum_{s > t} L_st Z_s)
  if (tid < 2 * K) {
    const int j = jc;
    float* x = xs;
    if (!is_u) {
#pragma unroll
      for (int t = 0; t < C; ++t) x[t] = sRW[t * LDF + j];
    }
#pragma unroll
    for (int t = C - 2; t >= 0; --t) {
      float a4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = (t + 1) & ~3; s < C; s += 4) {  // L^T_ts = 0 for s <= t
        const float4 l = *reinterpret_cast<const float4*>(&sLT[t][s]);
        a4[0] = fmaf(l.x, x[s], a4[0]);
        a4[1] = fmaf(l.y, x[s + 1], a4[1]);
        a4[2] = fmaf(l.z, x[s + 2], a4[2]);
        a4[3] = fmaf(l.w, x[s + 3], a4[3]);
      }
      x[t] -= (a4[0] + a4[1]) + (a4[2] + a4[3]);
    }
    // Zu into dy's tile and sZU, Zw into U's tile and sRW (its own column)
    f16* zs = is_u ? sDY : sU;
    float* zf = is_u ? sZU : sRW;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      split1(x[t], zs[t * LD + j], zs[TILE + t * LD + j]);
      zf[t * LDF + j] = x[t];
    }
    if (is_u) {
#pragma unroll
      for (int t = 0; t < C; ++t) store1(dv + ((tok0 + t) * H + h) * K + j, inv * sBeta[t] * x[t]);
    }
  }
  __syncthreads();

  // ---- dA = -(Zu U~^T + Zw W^T) on the tile (mt, cg), strictly lower; E, D
  // and the sums of P and of dbeta's dA term
  {
    float da[4] = {0.f, 0.f, 0.f, 0.f};
    mm3<KT, false, false>(da, sDY, TILE, LD, 16 * mt, sUT, TILE, LD, 8 * cg, lane);
    mm3<KT, false, false>(da, sU, TILE, LD, 16 * mt, sW, TILE, LD, 8 * cg, lane);
    float pe[4], ev[4], dv_[4], rb[2] = {0.f, 0.f}, rp[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1, t = t0 + 8 * hh, i = ci + (e & 1);
      const float dav = i < t ? -da[e] : 0.f;
      const float bt = sBeta[t];
      rb[hh] += dav * gmm[e] * kk[e];
      dv_[e] = dav * bt * gmm[e];
      ev[e] = dm[e] * gmm[e];
      pe[e] = (i <= t ? dm[e] * qk[e] : 0.f) * gmm[e] + dav * bt * kk[e] * gmm[e];
      rp[hh] += pe[e];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t0 + 8 * hh;
      uint32_t hi, lo;
      split2(ev[2 * hh], ev[2 * hh + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(sE + t * LDM + ci) = hi;
      *reinterpret_cast<uint32_t*>(sE + C * LDM + t * LDM + ci) = lo;
      split2(dv_[2 * hh], dv_[2 * hh + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(sD + t * LDM + ci) = hi;
      *reinterpret_cast<uint32_t*>(sD + C * LDM + t * LDM + ci) = lo;
      rb[hh] = quad_sum(rb[hh]);
      rp[hh] = quad_sum(rp[hh]);
      if ((lane & 3) == 0) {
        sPart[4][cg][t] = rb[hh];
        sPart[5][cg][t] = rp[hh];
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float cs = col_sum(pe[e] + pe[2 + e]);
      if (r0 == 0) sPart[6][mt][ci + e] = cs;
    }
  }
  // ---- diag(beta g) Zw into dk, rowsum(Zw.K) and rowsum(Zu.V)
  float r_zk[2] = {0.f, 0.f}, r_zv[2] = {0.f, 0.f};
  if (owns) {
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      const int a = 8 * (4 * i + cg) + c0;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + 8 * hh;
        const float2 zw = *reinterpret_cast<const float2*>(sRW + t * LDF + a);
        const float2 zu = *reinterpret_cast<const float2*>(sZU + t * LDF + a);
        const float2 kx = join2(sK + t * LD + a, sK + TILE + t * LD + a);
        const float bg = sBeta[t] * sG[t];
        acc_k[i][2 * hh] += bg * zw.x;
        acc_k[i][2 * hh + 1] += bg * zw.y;
        r_zk[hh] += zw.x * kx.x + zw.y * kx.y;
        r_zv[hh] += zu.x * vx[i][hh][0] + zu.y * vx[i][hh][1];
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float a = quad_sum(r_zv[hh]), bq = quad_sum(r_zk[hh]), c = quad_sum(r_gq[hh]),
                d = quad_sum(r_kt[hh]);
    if ((lane & 3) == 0) {
      const int t = t0 + 8 * hh;
      sPart[0][cg][t] = a;
      sPart[1][cg][t] = bq;
      sPart[2][cg][t] = c;
      sPart[3][cg][t] = d;
    }
  }
  __syncthreads();                 // E and D are written

  // ---- dq += E K; dk += E^T Q + D K + D^T K; then dq, dk
  if (owns) {
    // E, E^T, D and D^T fragments loaded once a 16-deep step for all the
    // warp's n8 tiles
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      uint32_t ah[4][4], al[4][4];
      load_a<false>(ah[0], sE, LDM, 16 * mt, 16 * kk, lane);
      load_a<false>(al[0], sE + C * LDM, LDM, 16 * mt, 16 * kk, lane);
      load_a<true>(ah[1], sE, LDM, 16 * mt, 16 * kk, lane);
      load_a<true>(al[1], sE + C * LDM, LDM, 16 * mt, 16 * kk, lane);
      load_a<false>(ah[2], sD, LDM, 16 * mt, 16 * kk, lane);
      load_a<false>(al[2], sD + C * LDM, LDM, 16 * mt, 16 * kk, lane);
      load_a<true>(ah[3], sD, LDM, 16 * mt, 16 * kk, lane);
      load_a<true>(al[3], sD + C * LDM, LDM, 16 * mt, 16 * kk, lane);
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        const int n0 = 8 * (4 * i + cg);
        uint32_t kh[2], kl[2], qh[2], ql[2];
        load_b<true>(kh, sK, LD, 16 * kk, n0, lane);
        load_b<true>(kl, sK + TILE, LD, 16 * kk, n0, lane);
        load_b<true>(qh, sQ, LD, 16 * kk, n0, lane);
        load_b<true>(ql, sQ + TILE, LD, 16 * kk, n0, lane);
        mma3(acc_q[i], ah[0], al[0], kh, kl);   // E K
        mma3(acc_k[i], ah[1], al[1], qh, ql);   // E^T Q
        mma3(acc_k[i], ah[2], al[2], kh, kl);   // D K
        mma3(acc_k[i], ah[3], al[3], kh, kl);   // D^T K
      }
    }
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      const int n0 = 8 * (4 * i + cg);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const size_t o = ((tok0 + t0 + 8 * hh) * H + h) * K + n0 + c0;
        store2(dq + o, inv * acc_q[i][2 * hh], inv * acc_q[i][2 * hh + 1]);
        store2(dk + o, inv * acc_k[i][2 * hh], inv * acc_k[i][2 * hh + 1]);
      }
    }
  }

  // ---- the gates, one lane a token
  if (warp == 0) {
    const int t = lane;
    float part[7];
#pragma unroll
    for (int qn = 0; qn < 6; ++qn)
      part[qn] = ((sPart[qn][0][t] + sPart[qn][1][t]) + sPart[qn][2][t]) + sPart[qn][3][t];
    part[6] = sPart[6][0][t] + sPart[6][1][t];
    float dgc_all = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) dgc_all += sDgc[w];
    const float gam_t = sGam[t], g_t = sG[t], b_t = sBeta[t];
    // dGamma_C,i += rowsum(dK~.K)_i: the last row of P
    const float xk = part[3] * expf(sGam[C - 1] - gam_t);
    const float last = warp_sum(xk);
    const float prow = part[5] + (t == C - 1 ? last : 0.f);
    const float pcol = part[6] + xk;
    const float dg = b_t * part[1] + part[2] + (t == C - 1 ? dgc_all : 0.f);
    float s = prow - pcol + dg * g_t;
    // dlog alpha: the reverse cumsum of dgamma
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, s, off);
      if (lane + off < 32) s += o;
    }
    const float al = sAl[t];
    const size_t o = (tok0 + t) * H + h;
    dbeta[o] = inv * (part[0] + g_t * part[1] + part[4]);
    dalpha[o] = al < ALPHA_MIN ? 0.f : inv * s / al;
  }
}

// ---------------------------------------------------------------- launch
template <typename T, int K>
int launch_k(const void* q, const void* k, const void* v, const void* beta, const void* alpha,
             const void* dy, const void* dfinal, void* scratch, void* dq, void* dk, void* dv,
             void* dbeta, void* dalpha, int B, int S, int H, cudaStream_t stream) {
  using Lay = Layout<K>;
  const int nz = S / C;
  const Scratch<K> scr(scratch, B, S, H);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdy = static_cast<const T*>(dy);
  const float* fb = static_cast<const float*>(beta);
  const float* fa = static_cast<const float*>(alpha);
  const float* fdf = static_cast<const float*>(dfinal);
  cudaError_t err = cudaMemsetAsync(scr.cmax, 0, sizeof(uint32_t) * B * H, stream);
  if (err != cudaSuccess) return (int)err;
  // as much shared memory as the SM has, so that its CTAs fit side by side
  static const cudaError_t carve = cudaFuncSetAttribute(
      gdn_bwd_prep_kernel<T, K>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (carve != cudaSuccess) return (int)carve;
  gdn_bwd_prep_kernel<T, K><<<dim3(nz, H, B), THREADS, 0, stream>>>(
      tq, tk, tv, fb, fa, tdy, fdf, scr.image, scr.g_last, scr.cmax, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // above 48 KB a kernel's dynamic shared memory must be opted into, once
  static const cudaError_t attr_chain = cudaFuncSetAttribute(
      gdn_bwd_chain_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::CHAIN_SMEM);
  if (attr_chain != cudaSuccess) return (int)attr_chain;
  static const cudaError_t attr_post = cudaFuncSetAttribute(
      gdn_bwd_post_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, Post<K>::BYTES);
  if (attr_post != cudaSuccess) return (int)attr_post;
  // each kernel may launch while the one before runs (programmatic dependent
  // launch): its griddepcontrol.wait holds it until that grid's writes land
  cudaLaunchAttribute serial[1];
  serial[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  serial[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * Lay::NCB, H, B);
  cfg.blockDim = dim3(32 * Lay::WARPS);
  cfg.dynamicSmemBytes = Lay::CHAIN_SMEM;
  cfg.stream = stream;
  cfg.attrs = serial;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gdn_bwd_chain_kernel<T, K>,
                           static_cast<const unsigned char*>(scr.image),
                           static_cast<const float*>(scr.g_last),
                           static_cast<const uint32_t*>(scr.cmax), tdy, fdf, scr.s0, scr.ds,
                           scr.u, scr.du, S, H);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3(nz, H, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Post<K>::BYTES;
  return (int)cudaLaunchKernelEx(
      &cfg, gdn_bwd_post_kernel<T, K>, tq, tk, tv, fb, fa, tdy,
      static_cast<const unsigned char*>(scr.image), static_cast<const uint32_t*>(scr.cmax),
      static_cast<const float*>(scr.s0), static_cast<const float*>(scr.ds),
      static_cast<const float*>(scr.u), static_cast<const float*>(scr.du), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dbeta),
      static_cast<float*>(dalpha), S, H);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* beta, const void* alpha,
           const void* dy, const void* dfinal, void* scratch, void* dq, void* dk, void* dv,
           void* dbeta, void* dalpha, int B, int S, int H, int K, cudaStream_t stream) {
  if (B < 1 || S < C || S % C || H < 1) return (int)cudaErrorInvalidValue;
#define GDN_BWD_K(KK)                                                                        \
  case KK:                                                                                   \
    return launch_k<T, KK>(q, k, v, beta, alpha, dy, dfinal, scratch, dq, dk, dv, dbeta,    \
                           dalpha, B, S, H, stream);
  switch (K) {
    GDN_BWD_K(16)
    GDN_BWD_K(32)
    GDN_BWD_K(64)
    GDN_BWD_K(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef GDN_BWD_K
}

}  // namespace

// Bytes of the scratch the launchers take at (B, S, H, K) (S a multiple of
// 32): S0 and dS a chunk, U and dU, the operand images, the chunks' decays
// and the cotangents' maxima; 0 for a K they refuse.
extern "C" long long gdn_scan_bwd_scratch_bytes(int B, int S, int H, int K) {
  switch (K) {
    case 16: return Scratch<16>::bytes(B, S, H);
    case 32: return Scratch<32>::bytes(B, S, H);
    case 64: return Scratch<64>::bytes(B, S, H);
    case 128: return Scratch<128>::bytes(B, S, H);
    default: return 0;
  }
}

// q, k, v, dy (B,S,H,K) in one dtype, beta, alpha (B,S,H) fp32, dfinal
// (B,H,K,K) fp32 or null (a zero cotangent), scratch of
// gdn_scan_bwd_scratch_bytes -> dq, dk, dv (B,S,H,K) in q's dtype, dbeta and
// dalpha (B,S,H) fp32. S a multiple of 32. Returns the first launch error (0
// on success).
#define GDN_SCAN_BWD_LAUNCHER(NAME, T)                                                         \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* beta,          \
                      const void* alpha, const void* dy, const void* dfinal, void* scratch,   \
                      void* dq, void* dk, void* dv, void* dbeta, void* dalpha, int B, int S,  \
                      int H, int K, void* stream) {                                           \
    return launch<T>(q, k, v, beta, alpha, dy, dfinal, scratch, dq, dk, dv, dbeta, dalpha, B,  \
                     S, H, K, static_cast<cudaStream_t>(stream));                              \
  }

GDN_SCAN_BWD_LAUNCHER(gdn_scan_bwd_f32, float)
GDN_SCAN_BWD_LAUNCHER(gdn_scan_bwd_bf16, __nv_bfloat16)
