// Backward of the gated-delta-rule scan for Hopper (sm_90a), fp32 and bf16
// inputs, computing in fp32.
//
// Replaces no TPU kernel: the Pallas kernel src/repro/kernels/gdn/gdn.py
// (gdn_scan) has no backward, and the JAX package differentiates its jnp
// scan (src/repro/models/gdn.py:gdn_scan). The port's forward on the card is
// the kernel of gdn_scan.cu, so its gradient is a kernel too: this one
// computes what ref.py:gdn_scan_bwd_ref computes, per (batch, head) over the
// (K, K) fp32 state S (rows key dims, columns value dims),
//   S_t = alpha_t (S_{t-1} - beta_t k_t (k_t^T S_{t-1})) + beta_t k_t v_t^T
//   dS_{t-1} = alpha_t (dS_t - beta_t k_t (k_t^T dS_t)) + q_{t-1} dy_{t-1}^T
// from dfinal + q dy^T at the last token, and per token, with g = dS_t^T k_t,
// ks = S_{t-1}^T k_t and w = v_t - alpha_t ks:
//   dq_t = S_t dy_t, dv_t = beta_t g, dbeta_t = g . w,
//   dk_t = beta_t dS_t w - alpha_t beta_t S_{t-1} g,
//   dalpha_t = <dS_t, S_{t-1} - beta_t k_t ks^T>.
// alpha is floored at exp(-80) as gdn_scan.cu floors log(alpha) (dalpha 0
// there, the floor's derivative). dv is written in the inputs' dtype; dq,
// dk, dbeta and dalpha are fp32 partials over column blocks (NB, B, S, H[,K])
// that the wrapper sums in a fixed order. No float atomics: two calls give
// the same bits.
//
// Design: every operation above acts on the state column by column (k^T S,
// the update and the pullback of dS), so one CTA owns (batch, head, 16
// columns): 8 warps of 2 columns, each lane 4 rows (K = 128) of S and dS in
// registers; the reductions over rows are warp shuffles, those over a warp's
// columns stay in the thread. The gradient is taken by per-token reverse
// steps, not the chunked (WY) form of the forward kernel: the chunked
// backward needs the pullback through the triangular solve, where the
// per-token form is the recurrence above and nothing else. Phase 1 runs the
// forward recurrence and writes the state every T = 8 tokens to a global
// scratch of (B, H, S/8) states of K x K fp32 (in this kernel's own order);
// gdn_scan.cu's kernels are left alone. Phase 2 walks the 8-token pieces
// backwards: it reloads the piece's entry state, recomputes the piece's 8
// states into registers, and takes the 8 reverse steps. Partials of dq and
// dk from the 8 warps go through shared memory and are summed in warp order.
//
// What bounds it on this card: bytes, far below its time. At gdn-4b's
// training shape (B 4, S 512, H 20, K 128, fp32) the call must read q, k,
// v, dy, beta, alpha and dfinal and write dq, dk, dv, dbeta and dalpha
// (~0.07 GB: 0.02 ms at 3.35 TB/s); its ~3 GFLOP (about 14 flops a state
// element a token) take ~0.05 ms on the CUDA cores. What it costs is the
// sequential token loop: per token a warp runs a dependent chain of
// shuffles (5 for k^T S, 15 for g and dalpha).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 8;                  // tokens between stored states
constexpr int VW = 2;                 // state columns a warp
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int COLS = VW * WARPS;      // state columns a CTA
constexpr float ALPHA_MIN = 1.8048513e-35f;   // exp(-80), gdn_scan.cu's floor of log(alpha)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename Tin>
__device__ __forceinline__ Tin from_f(float v);
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

// rows a lane (lane + 32 i); K = 16 leaves lanes 16..31 on zero rows
template <int K>
struct Rows {
  static constexpr int R = K >= 32 ? K / 32 : 1;
  static constexpr int KP = 32 * R;
};

template <int K>
struct Smem {
  static constexpr int KP = Rows<K>::KP;
  static constexpr int SK = 0;                      // T x KP: k rows
  static constexpr int SQ = SK + T * KP;            // T x KP: q rows
  static constexpr int SV = SQ + T * KP;            // T x COLS: v, this CTA's columns
  static constexpr int SDY = SV + T * COLS;         // T x COLS: dy
  static constexpr int SB = SDY + T * COLS;         // T: beta
  static constexpr int SA = SB + T;                 // T: alpha, floored
  static constexpr int SF = SA + T;                 // T: 1 where floored
  static constexpr int RQ = SF + T;                 // T x WARPS x KP: dq partials
  static constexpr int RK = RQ + T * WARPS * KP;    // dk partials
  static constexpr int RB = RK + T * WARPS * KP;    // T x WARPS: dbeta partials
  static constexpr int RA = RB + T * WARPS;         // dalpha partials
  static constexpr int FLOATS = RA + T * WARPS;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

// floats of scratch: per (batch, head, piece) a state in this kernel's
// order (column block, warp, row group, lane, column)
template <int K>
size_t scratch_floats(int B, int S, int H) {
  return (size_t)B * H * (S / T) * (K / COLS) * WARPS * Rows<K>::R * 32 * VW;
}

// one forward step on a warp's slice: ks = k^T S (all lanes), then S update
template <int R>
__device__ __forceinline__ void fwd_step(float (&s)[R][VW], float (&ks)[VW], const float (&kr)[R],
                                         const float (&vv)[VW], float be, float al) {
#pragma unroll
  for (int c = 0; c < VW; ++c) {
    float p = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) p = fmaf(kr[i], s[i][c], p);
    ks[c] = warp_sum(p);
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < VW; ++c)
      s[i][c] = al * (s[i][c] - be * (kr[i] * ks[c])) + be * (kr[i] * vv[c]);
}

// grid (K / COLS, H, B)
template <typename Tin, int K>
__global__ void __launch_bounds__(THREADS) gdn_bwd_kernel(
    const Tin* __restrict__ q, const Tin* __restrict__ k, const Tin* __restrict__ v,
    const float* __restrict__ beta, const float* __restrict__ alpha, const Tin* __restrict__ dy,
    const float* __restrict__ dfinal, float* hs, float* __restrict__ dq_part,
    float* __restrict__ dk_part, Tin* __restrict__ dv, float* __restrict__ dbeta_part,
    float* __restrict__ dalpha_part, int B, int S, int H) {
  constexpr int R = Rows<K>::R, KP = Rows<K>::KP;
  using L = Smem<K>;
  extern __shared__ float smem[];
  float* sk = smem + L::SK;
  float* sq = smem + L::SQ;
  float* sv = smem + L::SV;
  float* sdy = smem + L::SDY;
  float* sb = smem + L::SB;
  float* sa = smem + L::SA;
  float* sf = smem + L::SF;
  float* rq = smem + L::RQ;
  float* rk = smem + L::RK;
  float* rb = smem + L::RB;
  float* ra = smem + L::RA;

  const int cb = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nz = S / T, nb = K / COLS;
  const int col0 = cb * COLS;                 // this CTA's first column
  const int wc = warp * VW;                   // this warp's first column within the CTA
  // this lane's slice of the scratch: piece z at hs_lane + z * piece
  const size_t piece = (size_t)nb * WARPS * R * 32 * VW;
  float* hs_lane = hs + ((size_t)bi * H + h) * nz * piece +
                   ((size_t)(cb * WARPS + warp) * R * 32 + lane) * VW;

  // stage the piece of tokens z*T .. z*T + T-1 (q and dy only when `bwd`)
  auto stage = [&](int z, bool bwd) {
    const size_t tok0 = (size_t)bi * S + (size_t)z * T;
    for (int e = tid; e < T * KP; e += THREADS) {
      const int t = e / KP, r = e % KP;
      const size_t g = ((tok0 + t) * H + h) * K + r;
      sk[e] = r < K ? to_f(k[g]) : 0.f;
      if (bwd) sq[e] = r < K ? to_f(q[g]) : 0.f;
    }
    for (int e = tid; e < T * COLS; e += THREADS) {
      const int t = e / COLS, c = e % COLS;
      const size_t g = ((tok0 + t) * H + h) * K + col0 + c;
      sv[e] = to_f(v[g]);
      if (bwd) sdy[e] = to_f(dy[g]);
    }
    if (tid < T) {
      const size_t g = (tok0 + tid) * H + h;
      const float al = alpha[g];
      sb[tid] = beta[g];
      sa[tid] = al < ALPHA_MIN ? ALPHA_MIN : al;
      sf[tid] = al < ALPHA_MIN ? 1.f : 0.f;
    }
  };

  // ---- phase 1: the forward recurrence, the state every T tokens to the scratch
  float s[R][VW];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < VW; ++c) s[i][c] = 0.f;
  for (int z = 0; z < nz; ++z) {
    float* out = hs_lane + (size_t)z * piece;
#pragma unroll
    for (int i = 0; i < R; ++i)
      *reinterpret_cast<float2*>(out + (size_t)i * 32 * VW) = make_float2(s[i][0], s[i][1]);
    __syncthreads();
    stage(z, false);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float kr[R], vv[VW], ks[VW];
#pragma unroll
      for (int i = 0; i < R; ++i) kr[i] = sk[t * KP + lane + 32 * i];
#pragma unroll
      for (int c = 0; c < VW; ++c) vv[c] = sv[t * COLS + wc + c];
      fwd_step<R>(s, ks, kr, vv, sb[t], sa[t]);
    }
  }

  // ---- phase 2: the pieces backwards; ds is dS at the piece's end
  float ds[R][VW];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = lane + 32 * i;
#pragma unroll
    for (int c = 0; c < VW; ++c)
      ds[i][c] = (dfinal == nullptr || r >= K)
                     ? 0.f
                     : dfinal[(((size_t)bi * H + h) * K + r) * K + col0 + wc + c];
  }
  for (int z = nz - 1; z >= 0; --z) {
    const size_t tok0 = (size_t)bi * S + (size_t)z * T;
    __syncthreads();
    stage(z, true);
    __syncthreads();
    // the piece's states: st[t] enters token t, st[T] leaves the piece
    float st[T + 1][R][VW], kss[T][VW];
    {
      const float* in = hs_lane + (size_t)z * piece;   // this lane wrote it in phase 1
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float2 p = *reinterpret_cast<const float2*>(in + (size_t)i * 32 * VW);
        st[0][i][0] = p.x;
        st[0][i][1] = p.y;
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float kr[R], vv[VW];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        kr[i] = sk[t * KP + lane + 32 * i];
#pragma unroll
        for (int c = 0; c < VW; ++c) st[t + 1][i][c] = st[t][i][c];
      }
#pragma unroll
      for (int c = 0; c < VW; ++c) vv[c] = sv[t * COLS + wc + c];
      fwd_step<R>(st[t + 1], kss[t], kr, vv, sb[t], sa[t]);
    }
    // the reverse steps
#pragma unroll
    for (int t = T - 1; t >= 0; --t) {
      const float be = sb[t], al = sa[t];
      float kr[R], qr[R], vv[VW], dd[VW];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        kr[i] = sk[t * KP + lane + 32 * i];
        qr[i] = sq[t * KP + lane + 32 * i];
      }
#pragma unroll
      for (int c = 0; c < VW; ++c) {
        vv[c] = sv[t * COLS + wc + c];
        dd[c] = sdy[t * COLS + wc + c];
      }
      float gp[VW], ap = 0.f;
#pragma unroll
      for (int c = 0; c < VW; ++c) gp[c] = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float dqp = 0.f;
#pragma unroll
        for (int c = 0; c < VW; ++c) {
          ds[i][c] = fmaf(qr[i], dd[c], ds[i][c]);
          dqp = fmaf(st[t + 1][i][c], dd[c], dqp);
          gp[c] = fmaf(kr[i], ds[i][c], gp[c]);
          ap = fmaf(ds[i][c], st[t][i][c] - be * (kr[i] * kss[t][c]), ap);
        }
        rq[(t * WARPS + warp) * KP + lane + 32 * i] = dqp;
      }
      float g[VW], w[VW], dbp = 0.f;
#pragma unroll
      for (int c = 0; c < VW; ++c) {
        g[c] = warp_sum(gp[c]);
        w[c] = vv[c] - al * kss[t][c];
        dbp = fmaf(g[c], w[c], dbp);
      }
      ap = warp_sum(ap);
      if (lane < VW) {
        const float gl = lane == 0 ? g[0] : g[1];
        dv[((tok0 + t) * H + h) * K + col0 + wc + lane] = from_f<Tin>(be * gl);
      }
      if (lane == 0) {
        rb[t * WARPS + warp] = dbp;
        ra[t * WARPS + warp] = ap;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float a1 = 0.f, a2 = 0.f;
#pragma unroll
        for (int c = 0; c < VW; ++c) {
          a1 = fmaf(ds[i][c], w[c], a1);
          a2 = fmaf(st[t][i][c], g[c], a2);
        }
        rk[(t * WARPS + warp) * KP + lane + 32 * i] = be * a1 - al * be * a2;
#pragma unroll
        for (int c = 0; c < VW; ++c) ds[i][c] = al * (ds[i][c] - be * (kr[i] * g[c]));
      }
    }
    __syncthreads();
    // the CTA's partials, summed over its warps in warp order
    const size_t part0 = ((size_t)cb * B + bi) * S;   // (NB, B, S, ...) row of token 0
    for (int e = tid; e < T * K; e += THREADS) {
      const int t = e / K, r = e % K;
      float sq_ = 0.f, sk_ = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        sq_ += rq[(t * WARPS + w) * KP + r];
        sk_ += rk[(t * WARPS + w) * KP + r];
      }
      const size_t o = ((part0 + (size_t)z * T + t) * H + h) * K + r;
      dq_part[o] = sq_;
      dk_part[o] = sk_;
    }
    if (tid < T) {
      float b_ = 0.f, a_ = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        b_ += rb[tid * WARPS + w];
        a_ += ra[tid * WARPS + w];
      }
      const size_t o = (part0 + (size_t)z * T + tid) * H + h;
      dbeta_part[o] = b_;
      dalpha_part[o] = sf[tid] != 0.f ? 0.f : a_;
    }
  }
}

template <typename Tin, int K>
int launch_k(const void* q, const void* k, const void* v, const void* beta, const void* alpha,
             const void* dy, const void* dfinal, void* hs, void* dq, void* dk, void* dv,
             void* dbeta, void* dalpha, int B, int S, int H, cudaStream_t stream) {
  // above 48 KB a kernel's dynamic shared memory must be opted into, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      gdn_bwd_kernel<Tin, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<K>::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  gdn_bwd_kernel<Tin, K><<<dim3(K / COLS, H, B), THREADS, Smem<K>::BYTES, stream>>>(
      static_cast<const Tin*>(q), static_cast<const Tin*>(k), static_cast<const Tin*>(v),
      static_cast<const float*>(beta), static_cast<const float*>(alpha),
      static_cast<const Tin*>(dy), static_cast<const float*>(dfinal), static_cast<float*>(hs),
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<Tin*>(dv),
      static_cast<float*>(dbeta), static_cast<float*>(dalpha), B, S, H);
  return (int)cudaGetLastError();
}

template <typename Tin>
int launch(const void* q, const void* k, const void* v, const void* beta, const void* alpha,
           const void* dy, const void* dfinal, void* hs, void* dq, void* dk, void* dv,
           void* dbeta, void* dalpha, int B, int S, int H, int K, cudaStream_t stream) {
  if (B < 1 || S < T || S % T || H < 1) return (int)cudaErrorInvalidValue;
#define GDN_BWD_K(KK)                                                                       \
  case KK:                                                                                  \
    return launch_k<Tin, KK>(q, k, v, beta, alpha, dy, dfinal, hs, dq, dk, dv, dbeta,      \
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

// Bytes of the state scratch the launchers take (K in {16,32,64,128}, S a
// multiple of 8); 0 for a K they refuse.
extern "C" long long gdn_scan_bwd_scratch_bytes(int B, int S, int H, int K) {
  switch (K) {
    case 16: return (long long)(sizeof(float) * scratch_floats<16>(B, S, H));
    case 32: return (long long)(sizeof(float) * scratch_floats<32>(B, S, H));
    case 64: return (long long)(sizeof(float) * scratch_floats<64>(B, S, H));
    case 128: return (long long)(sizeof(float) * scratch_floats<128>(B, S, H));
    default: return 0;
  }
}

// q, k, v, dy (B,S,H,K) in one dtype, beta, alpha (B,S,H) fp32, dfinal
// (B,H,K,K) fp32 or null (a zero cotangent), hs the scratch above -> dv
// (B,S,H,K) in q's dtype and fp32 partials over the K/16 column blocks: dq
// and dk (K/16,B,S,H,K), dbeta and dalpha (K/16,B,S,H). S a multiple of 8.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gdn_scan_bwd_f32(const void* q, const void* k, const void* v, const void* beta,
                                const void* alpha, const void* dy, const void* dfinal, void* hs,
                                void* dq, void* dk, void* dv, void* dbeta, void* dalpha, int B,
                                int S, int H, int K, void* stream) {
  return launch<float>(q, k, v, beta, alpha, dy, dfinal, hs, dq, dk, dv, dbeta, dalpha, B, S,
                       H, K, static_cast<cudaStream_t>(stream));
}

extern "C" int gdn_scan_bwd_bf16(const void* q, const void* k, const void* v, const void* beta,
                                 const void* alpha, const void* dy, const void* dfinal, void* hs,
                                 void* dq, void* dk, void* dv, void* dbeta, void* dalpha, int B,
                                 int S, int H, int K, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, beta, alpha, dy, dfinal, hs, dq, dk, dv, dbeta, dalpha,
                               B, S, H, K, static_cast<cudaStream_t>(stream));
}
