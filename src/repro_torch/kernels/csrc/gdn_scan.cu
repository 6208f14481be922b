// Gated-delta-rule prefill scan for Hopper (sm_90a), in fp32 and bf16, in
// the chunked (WY / UT-transform) form with its products on the tensor cores.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gdn/gdn.py:gdn_scan
// and computes what its oracle ref.py:gdn_scan_ref computes: per (batch,
// head), token by token over the (K, K) fp32 state S (S_{-1} = 0),
//   S_t = alpha_t (S_{t-1} - beta_t k_t (k_t^T S_{t-1})) + beta_t k_t v_t^T
//   y_t = S_t^T q_t
// returning y (B, S, H, K) in q's dtype and the final state (B, H, K, K)
// fp32. q, k, v come in one dtype (fp32 as the model calls it, or bf16);
// beta and alpha (B, S, H) in fp32. K == V. S is a multiple of the chunk
// C = 32: the wrapper pads with beta = 0, alpha = 1 rows, which leave the
// state alone.
//
// The chunked form (kernels/gdn/ref.py:gdn_chunked_ref is its plain
// version). Per chunk of C tokens entering with state S0, gamma_t the
// cumulative sum of log alpha inside the chunk, g_t = exp(gamma_t) and
// Gamma_ti = exp(gamma_t - gamma_i) for i <= t (0 above; every entry <= 1):
//   (I + L) U~ = diag(beta) V,  (I + L) W = diag(beta g) K,
//       L_ti = beta_t Gamma_ti k_t.k_i  (i < t)
//   U   = U~ - W S0                        (u_t = beta_t (v_t - alpha_t S_{t-1}^T k_t))
//   Y   = diag(g) Q S0 + (Q K^T . Gamma) U
//   S_C = g_C S0 + (diag(Gamma_C.) K)^T U
// U~, W and M = Q K^T . Gamma do not depend on S0: they are computed for
// every chunk at once. Only three products a chunk form the chain across
// chunks, S / C steps instead of S tokens. log alpha is floored at -80 so
// that an alpha that underflowed to 0 decays by e^-80 instead of giving NaN.
//
// What bounds it on this card: bytes. At gdn-4b's 512-token prefill (H = 20,
// K = 128, fp32) the call must move 22.4 MB (q, k, v, beta, alpha, y and the
// fp32 final state), 0.0067 ms at 3.35 TB/s; its ~1.85 GFLOP in the chunked
// form take 0.0037 ms at the TF32 tensor-core rate. What it costs in
// practice is the chain: S / C steps of dependent products per CTA.
//
// 1. gdn_prep_kernel, grid (S / C, H, B), 8 warps: everything that does not
//   depend on S0, for every chunk in parallel. The cumsum of log alpha (one
//   lane a token), K K^T and Q K^T on mma.sync.m16n8k16, the triangular
//   solves for U~ and W by forward substitution in fp32 on the CUDA cores
//   (one thread a right-hand column), and the chunk's operands of the chain
//   written to a scratch buffer exactly as the chain kernel's shared memory
//   holds them (rows padded by 8 elements, conflict-free ldmatrix): W,
//   diag(g) Q, diag(Gamma_C.) K and M as fp16 hi + lo pairs, U~^T in fp32.
// 2. gdn_chain_kernel, grid (K / VC, H, B), VC = 32 value columns a CTA (80
//   CTAs for gdn-4b): the chain. The columns of S are independent, so each
//   pair of warps holds the 16 x K slice of S^T for 16 value columns in fp32
//   accumulator registers for the whole sequence, each warp of the pair half
//   of the keys, and computes the products transposed (U^T = U~^T - S0^T
//   W^T, Y^T = S0^T (diag(g) Q)^T + U^T M^T, S^T <- g_C S0^T + U^T
//   (diag(Gamma_C.) K)), so that S0^T and U^T, the A operands, come straight
//   from accumulators (two adjacent n8 tiles are one A fragment). The two
//   halves add each other's partial U^T and Y^T through shared memory
//   behind one named barrier a chunk (one warp a pair took 0.0296 ms
//   against 0.0259 for the chain alone). Each chunk's operands arrive as two
//   TMA bulk copies (the shared part and the CTA's slice of U~^T) into one
//   of two buffers, the next chunk's in flight while one is used. It is
//   launched with programmatic dependent launch and waits for the prep
//   kernel with griddepcontrol.wait. (A cluster of a head's CTAs sharing
//   each chunk's copy by multicast was slower: 0.0515 ms for the chain.)
// - Precision: every product splits both fp32 operands into fp16 hi + lo
//   (hi + lo = x to ~2^-22 relative: fp16 keeps 11 bits, bf16 only 8) and
//   sums hi.hi + hi.lo + lo.hi on mma.sync.m16n8k16 (fp16 in, fp32
//   accumulate), so y and the state hold the fp32 tolerance. A bf16 hi + lo
//   split (~2^-16) held each scan to it, but the 36-layer fp32 gdn-4b
//   prefill then ended 1.7e-3 from the plain path in the logits, past
//   chip_smoke.py's 1e-3. Every operand lies well inside fp16's range (q, k
//   unit, the gates and decays <= 1, the state and U of the order of v); a
//   part below fp16's normal range loses relative, not absolute, precision.
//   bf16 inputs take the same kernels.

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
constexpr int LDM = C + 8;             // padded row of M (fp16)
constexpr int LDU = C + 4;             // padded row of U~^T (fp32)
constexpr int PREP_THREADS = 256;
constexpr float LOG_ALPHA_MIN = -80.f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16(v); }

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

// One chunk's operands of the chain, as laid out in scratch and in the chain
// kernel's shared memory: W, diag(g) Q and diag(Gamma_C.) K (C x LD fp16, hi
// then lo), M (C x LDM fp16, hi then lo), then U~^T (K x LDU fp32).
template <int K>
struct Layout {
  static constexpr int LD = K + 8;
  static constexpr int TILE = C * LD;             // elements of one C x K operand half
  static constexpr int SHARED = 2 * (6 * TILE + 2 * C * LDM);  // bytes read by every CTA
  static constexpr int UT = K * LDU * 4;          // bytes of U~^T
  static constexpr int CHUNK = SHARED + UT;       // bytes a chunk in scratch
  static constexpr int VC = K < 32 ? K : 32;      // value columns a chain CTA
  // chain warps: a pair for each 16 value columns, each half of the pair
  // holding half of the keys (one warp where K = 16)
  static constexpr int SPLIT = K >= 32 ? 2 : 1;
  static constexpr int WARPS = SPLIT * VC / 16;
  static constexpr int BUF = SHARED + VC * LDU * 4;  // bytes of one chain buffer
  static_assert(SHARED % 16 == 0 && UT % 16 == 0 && (LDU * 4) % 16 == 0, "TMA alignment");
};

// grid (S / C, H, B)
template <typename T, int K>
__global__ void __launch_bounds__(PREP_THREADS, 3) gdn_prep_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ beta, const float* __restrict__ alpha,
    unsigned char* __restrict__ scratch, float* __restrict__ g_last, int S, int H) {
  using Lay = Layout<K>;
  constexpr int LD = Lay::LD;
  __shared__ __align__(16) f16 sKh[C * LD];
  __shared__ __align__(16) f16 sKl[C * LD];
  __shared__ __align__(16) f16 sQh[C * LD];
  __shared__ __align__(16) f16 sQl[C * LD];
  __shared__ __align__(16) float sL[C][C + 4];
  __shared__ float sGam[C], sG[C], sBeta[C];
  // the chain kernel may be scheduled now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int z = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nz = S / C;
  const size_t tok0 = (size_t)b * S + (size_t)z * C;
  const size_t chunk = ((size_t)b * H + h) * nz + z;
  unsigned char* base = scratch + chunk * Lay::CHUNK;
  f16* oW = reinterpret_cast<f16*>(base);       // W hi, lo
  f16* oQ = oW + 2 * Lay::TILE;                  // diag(g) Q hi, lo
  f16* oK = oQ + 2 * Lay::TILE;                  // diag(Gamma_C.) K hi, lo
  f16* oM = oK + 2 * Lay::TILE;                  // M hi, lo
  float* oU = reinterpret_cast<float*>(base + Lay::SHARED);  // U~^T

  // ---- every global load first, all in flight at once: the chunk's q and k
  // rows (4 consecutive elements a thread a round) and the solve's
  // right-hand column (v or k, one column a thread)
  constexpr int RQ = (C * K / 4 + PREP_THREADS - 1) / PREP_THREADS;
  float qv[RQ][4], kv[RQ][4];
#pragma unroll
  for (int m = 0; m < RQ; ++m) {
    const int e = 4 * (tid + m * PREP_THREADS);
    if (e < C * K) {
      const size_t i = ((tok0 + e / K) * H + h) * K + e % K;
      load4(q + i, qv[m]);
      load4(k + i, kv[m]);
    }
  }
  static_assert(2 * K <= PREP_THREADS, "one right-hand column a thread");
  const bool is_v = tid < K;
  const int col = is_v ? tid : tid - K;
  float x[C];
  if (tid < 2 * K) {
#pragma unroll
    for (int t = 0; t < C; ++t) x[t] = to_f((is_v ? v : k)[((tok0 + t) * H + h) * K + col]);
  }
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
    const int e = 4 * (tid + m * PREP_THREADS);
    if (e < C * K) {
      const int o = (e / K) * LD + e % K;
      store_split4(qv[m], sQh + o, sQl + o);
      store_split4(kv[m], sKh + o, sKl + o);
    }
  }
  __syncthreads();
  // ---- diag(g) Q and diag(Gamma_C.) K for the chain
  const float gam_last = sGam[C - 1];
#pragma unroll
  for (int m = 0; m < RQ; ++m) {
    const int e = 4 * (tid + m * PREP_THREADS);
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
  // (no loop around it: the compiler would hoist all of L's loads out of one)
  if (tid < 2 * K) {
    const int jj = col;
#pragma unroll
    for (int t = 0; t < C; ++t) x[t] *= is_v ? sBeta[t] : sBeta[t] * sG[t];
    // L_ti = 0 for i >= t: whole groups of 4 up to t read zeros past it
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
      float4* row = reinterpret_cast<float4*>(oU + jj * LDU);
#pragma unroll
      for (int t = 0; t < C; t += 4) row[t / 4] = make_float4(x[t], x[t + 1], x[t + 2], x[t + 3]);
    } else {
#pragma unroll
      for (int t = 0; t < C; ++t) split1(x[t], oW[t * LD + jj], oW[Lay::TILE + t * LD + jj]);
    }
  }
}

// grid (K / VC, H, B), 32 * WARPS threads
template <typename T, int K>
__global__ void __launch_bounds__(32 * Layout<K>::WARPS) gdn_chain_kernel(
    const unsigned char* __restrict__ scratch, const float* __restrict__ g_last,
    T* __restrict__ y, float* __restrict__ fs, int S, int H) {
  using Lay = Layout<K>;
  constexpr int LD = Lay::LD, VC = Lay::VC, SPLIT = Lay::SPLIT, KH = K / SPLIT;
  constexpr int NT = KH / 8;       // n8 key tiles of this warp's state slice
  extern __shared__ __align__(16) unsigned char chain_smem[];
  __shared__ __align__(8) uint64_t full[2];
  // the two halves of a pair swap their partial U^T and Y^T here (read
  // before the barrier that ends the chunk)
  __shared__ float4 xch[SPLIT > 1 ? Lay::WARPS : 1][2][C / 8][32];
  const int v0 = blockIdx.x * VC, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pair = warp / SPLIT, half = warp % SPLIT;
  const int r0 = lane >> 2, c0 = (lane & 3) * 2;
  const int nz = S / C;
  const size_t chunk0 = ((size_t)b * H + h) * nz;

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init_fence();
  }
  __syncthreads();
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the prep kernel's writes

  // chunk z -> buffer z & 1: the shared operands and this CTA's rows of U~^T
  auto issue = [&](int z) {
    unsigned char* buf = chain_smem + (z & 1) * Lay::BUF;
    const unsigned char* src = scratch + (chunk0 + z) * Lay::CHUNK;
    fence_proxy_async();  // the buffer's last reads (chunk z - 2) come first
    mbar_expect_tx(&full[z & 1], Lay::BUF);
    bulk_copy(buf, src, Lay::SHARED, &full[z & 1]);
    bulk_copy(buf + Lay::SHARED, src + Lay::SHARED + (size_t)v0 * LDU * 4, VC * LDU * 4,
              &full[z & 1]);
  };
  if (tid == 0) {
    issue(0);
    if (nz > 1) issue(1);
  }

  // this warp's slice of S^T: 16 rows (value columns v0 + 16 pair + ...) by
  // the KH keys k0 .. k0 + KH - 1, in NT n8 tiles
  const int k0 = half * KH;
  float st[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
  const int vr = 16 * pair + r0;  // local value column of accumulator rows r0 (and + 8)

  for (int z = 0; z < nz; ++z) {
    const float gc = __ldg(g_last + chunk0 + z);
    mbar_wait(&full[z & 1], (z >> 1) & 1);
    const unsigned char* buf = chain_smem + (z & 1) * Lay::BUF;
    const f16* Wh = reinterpret_cast<const f16*>(buf);
    const f16* Wl = Wh + Lay::TILE;
    const f16* Qh = Wl + Lay::TILE;
    const f16* Ql = Qh + Lay::TILE;
    const f16* Kh = Ql + Lay::TILE;
    const f16* Kl = Kh + Lay::TILE;
    const f16* Mh = Kl + Lay::TILE;
    const f16* Ml = Mh + C * LDM;
    const float* Ut = reinterpret_cast<const float*>(buf + Lay::SHARED);

    // ---- U^T = U~^T - S0^T W^T and Y^T = S0^T (diag(g) Q)^T over this
    // warp's keys (U~^T added by half 0)
    float u[C / 8][4], yv[C / 8][4];
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
      yv[n][0] = yv[n][1] = yv[n][2] = yv[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KH / 16; ++kk) {
      uint32_t ah[4], al[4], nh[4], nl[4];
      split2(st[2 * kk][0], st[2 * kk][1], ah[0], al[0]);
      split2(st[2 * kk][2], st[2 * kk][3], ah[1], al[1]);
      split2(st[2 * kk + 1][0], st[2 * kk + 1][1], ah[2], al[2]);
      split2(st[2 * kk + 1][2], st[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // -S0^T: flip the sign bits
        nh[e] = ah[e] ^ 0x80008000u;
        nl[e] = al[e] ^ 0x80008000u;
      }
#pragma unroll
      for (int np = 0; np < C / 16; ++np) {
        const int row = (16 * np + (lane >> 4) * 8 + (lane & 7)) * LD + k0 + 16 * kk +
                        ((lane >> 3) & 1) * 8;
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, Wh + row);
        ldsm_x4(bl, Wl + row);
        mma_f16(u[2 * np], nh, bh[0], bh[1]);
        mma_f16(u[2 * np + 1], nh, bh[2], bh[3]);
        mma_f16(u[2 * np], nh, bl[0], bl[1]);
        mma_f16(u[2 * np + 1], nh, bl[2], bl[3]);
        mma_f16(u[2 * np], nl, bh[0], bh[1]);
        mma_f16(u[2 * np + 1], nl, bh[2], bh[3]);
        ldsm_x4(bh, Qh + row);
        ldsm_x4(bl, Ql + row);
        mma_f16(yv[2 * np], ah, bh[0], bh[1]);
        mma_f16(yv[2 * np + 1], ah, bh[2], bh[3]);
        mma_f16(yv[2 * np], ah, bl[0], bl[1]);
        mma_f16(yv[2 * np + 1], ah, bl[2], bl[3]);
        mma_f16(yv[2 * np], al, bh[0], bh[1]);
        mma_f16(yv[2 * np + 1], al, bh[2], bh[3]);
      }
    }
    if constexpr (SPLIT > 1) {  // add the other half's keys
      float4(*mine)[32] = xch[warp][0];
#pragma unroll
      for (int n = 0; n < C / 8; ++n) {
        mine[n][lane] = make_float4(u[n][0], u[n][1], u[n][2], u[n][3]);
        xch[warp][1][n][lane] = make_float4(yv[n][0], yv[n][1], yv[n][2], yv[n][3]);
      }
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + pair), "n"(64) : "memory");
      const int other = warp ^ 1;
#pragma unroll
      for (int n = 0; n < C / 8; ++n) {
        const float4 a = xch[other][0][n][lane], c = xch[other][1][n][lane];
        u[n][0] += a.x;
        u[n][1] += a.y;
        u[n][2] += a.z;
        u[n][3] += a.w;
        yv[n][0] += c.x;
        yv[n][1] += c.y;
        yv[n][2] += c.z;
        yv[n][3] += c.w;
      }
    }
    // ---- U^T as A fragments over the chunk's tokens, hi and lo
    uint32_t uh[C / 16][4], ul[C / 16][4];
#pragma unroll
    for (int kt = 0; kt < C / 16; ++kt) {
      split2(u[2 * kt][0], u[2 * kt][1], uh[kt][0], ul[kt][0]);
      split2(u[2 * kt][2], u[2 * kt][3], uh[kt][1], ul[kt][1]);
      split2(u[2 * kt + 1][0], u[2 * kt + 1][1], uh[kt][2], ul[kt][2]);
      split2(u[2 * kt + 1][2], u[2 * kt + 1][3], uh[kt][3], ul[kt][3]);
    }
    // ---- Y^T += U^T M^T for this warp's token blocks np (M is lower
    // triangular: token blocks kt > np are 0), then y
    {
      const size_t tok0 = (size_t)b * S + (size_t)z * C;
      T* yo = y + (tok0 * H + h) * K + v0 + vr;
#pragma unroll
      for (int np = 0; np < C / 16; ++np) {
        if (np % SPLIT != half) continue;
#pragma unroll
        for (int kt = 0; kt <= np; ++kt) {
          const int row = (16 * np + (lane >> 4) * 8 + (lane & 7)) * LDM + 16 * kt +
                          ((lane >> 3) & 1) * 8;
          uint32_t bh[4], bl[4];
          ldsm_x4(bh, Mh + row);
          ldsm_x4(bl, Ml + row);
          mma_f16(yv[2 * np], uh[kt], bh[0], bh[1]);
          mma_f16(yv[2 * np + 1], uh[kt], bh[2], bh[3]);
          mma_f16(yv[2 * np], uh[kt], bl[0], bl[1]);
          mma_f16(yv[2 * np + 1], uh[kt], bl[2], bl[3]);
          mma_f16(yv[2 * np], ul[kt], bh[0], bh[1]);
          mma_f16(yv[2 * np + 1], ul[kt], bh[2], bh[3]);
        }
#pragma unroll
        for (int n = 2 * np; n < 2 * np + 2; ++n) {
          const size_t t0 = (size_t)(8 * n + c0) * H * K;
          store1(yo + t0, yv[n][0]);
          store1(yo + t0 + (size_t)H * K, yv[n][1]);
          store1(yo + t0 + 8, yv[n][2]);
          store1(yo + t0 + (size_t)H * K + 8, yv[n][3]);
        }
      }
    }
    // ---- S^T <- g_C S0^T + U^T (diag(Gamma_C.) K) over this warp's keys
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
        mma_f16(st[2 * n2], uh[kt], bh[0], bh[1]);
        mma_f16(st[2 * n2 + 1], uh[kt], bh[2], bh[3]);
        mma_f16(st[2 * n2], uh[kt], bl[0], bl[1]);
        mma_f16(st[2 * n2 + 1], uh[kt], bl[2], bl[3]);
        mma_f16(st[2 * n2], ul[kt], bh[0], bh[1]);
        mma_f16(st[2 * n2 + 1], ul[kt], bh[2], bh[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer z & 1
    if (tid == 0 && z + 2 < nz) issue(z + 2);
  }
  // ---- final state (B, H, K, K): row = key dim, column = value dim
  float* fo = fs + ((size_t)b * H + h) * K * K + v0 + vr;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int key = k0 + 8 * n + c0;
    fo[(size_t)key * K] = st[n][0];
    fo[(size_t)(key + 1) * K] = st[n][1];
    fo[(size_t)key * K + 8] = st[n][2];
    fo[(size_t)(key + 1) * K + 8] = st[n][3];
  }
}

template <typename T, int K>
int launch_k(const void* q, const void* k, const void* v, const void* beta, const void* alpha,
             void* y, void* fs, void* scratch, int B, int S, int H, cudaStream_t stream) {
  using Lay = Layout<K>;
  const int nz = S / C;
  unsigned char* scr = static_cast<unsigned char*>(scratch);
  float* g_last = reinterpret_cast<float*>(scr + (size_t)B * H * nz * Lay::CHUNK);
  // as much shared memory as the SM has, so that its CTAs fit side by side
  static const cudaError_t carve = cudaFuncSetAttribute(
      gdn_prep_kernel<T, K>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (carve != cudaSuccess) return (int)carve;
  gdn_prep_kernel<T, K><<<dim3(nz, H, B), PREP_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(beta), static_cast<const float*>(alpha), scr, g_last, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // above 48 KB a kernel's dynamic shared memory must be opted into, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      gdn_chain_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * Lay::BUF);
  if (attr != cudaSuccess) return (int)attr;
  // the chain may launch while the prep kernel runs (programmatic dependent
  // launch): its griddepcontrol.wait holds it until the operands are written
  cudaLaunchAttribute serial[1];
  serial[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  serial[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K / Lay::VC, H, B);
  cfg.blockDim = dim3(32 * Lay::WARPS);
  cfg.dynamicSmemBytes = 2 * Lay::BUF;
  cfg.stream = stream;
  cfg.attrs = serial;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, gdn_chain_kernel<T, K>,
                                 static_cast<const unsigned char*>(scr),
                                 static_cast<const float*>(g_last), static_cast<T*>(y),
                                 static_cast<float*>(fs), S, H);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* beta, const void* alpha,
           void* y, void* fs, void* scratch, int B, int S, int H, int K, cudaStream_t stream) {
  if (B < 1 || S < C || S % C || H < 1) return (int)cudaErrorInvalidValue;
  switch (K) {
    case 16: return launch_k<T, 16>(q, k, v, beta, alpha, y, fs, scratch, B, S, H, stream);
    case 32: return launch_k<T, 32>(q, k, v, beta, alpha, y, fs, scratch, B, S, H, stream);
    case 64: return launch_k<T, 64>(q, k, v, beta, alpha, y, fs, scratch, B, S, H, stream);
    case 128: return launch_k<T, 128>(q, k, v, beta, alpha, y, fs, scratch, B, S, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int K>
long long scratch_k(int B, int S, int H) {
  const long long chunks = (long long)B * H * (S / C);
  return chunks * Layout<K>::CHUNK + 4 * chunks;
}

}  // namespace

// Bytes of the scratch buffer a call at (B, S, H, K) needs (the chunks'
// operands of the chain, then one fp32 decay a chunk); -1 for a K with no
// instance.
extern "C" long long gdn_scan_scratch_bytes(int B, int S, int H, int K) {
  switch (K) {
    case 16: return scratch_k<16>(B, S, H);
    case 32: return scratch_k<32>(B, S, H);
    case 64: return scratch_k<64>(B, S, H);
    case 128: return scratch_k<128>(B, S, H);
    default: return -1;
  }
}

// q, k, v (B,S,H,K), beta, alpha (B,S,H) fp32, scratch of
// gdn_scan_scratch_bytes -> y (B,S,H,K) in q's dtype, fs (B,H,K,K) fp32.
// Returns cudaGetLastError() after the launches.
#define GDN_SCAN_LAUNCHER(NAME, T)                                                             \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* beta,          \
                      const void* alpha, void* y, void* fs, void* scratch, int B, int S,      \
                      int H, int K, void* stream) {                                           \
    return launch<T>(q, k, v, beta, alpha, y, fs, scratch, B, S, H, K,                        \
                     static_cast<cudaStream_t>(stream));                                       \
  }

GDN_SCAN_LAUNCHER(gdn_scan_f32, float)
GDN_SCAN_LAUNCHER(gdn_scan_bf16, __nv_bfloat16)
