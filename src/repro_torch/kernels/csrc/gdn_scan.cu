// Gated-delta-rule prefill scan for Hopper (sm_90a), in fp32 and bf16.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gdn/gdn.py:gdn_scan
// and computes what its oracle ref.py:gdn_scan_ref computes: per (batch,
// head), token by token over the (K, K) fp32 state S (S_{-1} = 0),
//   ks_t = k_t^T S_{t-1}
//   S_t  = alpha_t (S_{t-1} - beta_t k_t ks_t) + beta_t k_t v_t^T
//   y_t  = S_t^T q_t
// returning y (B, S, H, K) in q's dtype and the final state (B, H, K, K)
// fp32. q, k, v come in one dtype (fp32 as the model calls it, or bf16);
// beta and alpha (B, S, H) in fp32. K == V. S is a multiple of the staged
// chunk TT = 32: the wrapper pads with beta = 0, alpha = 1 rows, which
// leave the state alone.
//
// What bounds it on this card: operations, and in practice their latency.
// Per token and head the rule does about 7 K^2 fp32 flops (k^T S, the
// rank-1 update, S^T q) against 3 K loaded and K stored elements: at
// K = 128 in fp32, ~220 flops per byte, far above the ~20 flops per byte the
// CUDA cores' fp32 rate allows over HBM bandwidth. The recurrence is
// order-dependent, so each token waits on the previous one: the chain of
// two reductions over K per token sets the pace.
//
// What the design does about it:
// - Parallelism. The TPU grid (B, H, S / Q) is 20 programs at B = 1 for
//   gdn-4b, its chunk axis in order. Every column j of S updates on its own:
//   ks_j = k^T S[:, j], S[:, j] <- alpha (S[:, j] - beta k ks_j) + beta k v_j,
//   y_j = S[:, j] . q. So the grid is (K / 16, H, B): each CTA owns 16
//   columns of one head's state for the whole sequence, in registers, and a
//   loop inside the CTA walks the tokens; 160 CTAs of 128 threads for
//   gdn-4b.
// - Within a CTA, 8 lanes share a column, each holding K / 8 of its rows,
//   so a column reduction is 3 shuffles. S_t^T q_t and k_{t+1}^T S_t read the
//   same state, so the two dot products of consecutive tokens are formed and
//   reduced together: one pass over the state and one interleaved set of
//   shuffles a token. The update is written
//   S <- alpha S + k (beta (v - alpha ks)), one multiply and one FMA an entry.
// - Reads. q, k, v, beta and alpha are read once from HBM: chunks of TT
//   tokens are copied to shared memory with cp.async, double-buffered so
//   that the next chunk is in flight while this one is used (each CTA of a
//   head reads the head's q and k rows; the copies after the first come
//   from L2).
// - The next redesign: the chunked (WY / UT-transform) form of the delta
//   rule, which turns most of the work into matrix products for the tensor
//   cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TT = 32;                  // tokens per staged chunk
constexpr int COLS = 16;                // state columns per CTA
constexpr int LANES = 8;                // lanes per column
constexpr int THREADS = COLS * LANES;   // 128

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// VW consecutive elements at p (VW * sizeof(T) bytes, aligned) as floats
template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
    static_assert(VW == 2, "VW is 2 or 4");
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  }
}
template <int VW>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < VW / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    out[2 * i] = t.x;
    out[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one staged chunk: k rows, q rows (TT, K), this CTA's v columns (TT, COLS),
// beta, alpha (TT,)
template <typename T, int K>
struct Chunk {
  static constexpr size_t kq_bytes = (size_t)TT * K * sizeof(T);
  static constexpr size_t v_bytes = (size_t)TT * COLS * sizeof(T);
  static constexpr size_t bytes = 2 * kq_bytes + v_bytes + 2 * TT * sizeof(float);
  static_assert(kq_bytes % 16 == 0 && v_bytes % 16 == 0, "16-byte aligned parts");
  T* k;
  T* q;
  T* v;
  float* beta;
  float* alpha;
  __device__ explicit Chunk(unsigned char* base)
      : k(reinterpret_cast<T*>(base)),
        q(reinterpret_cast<T*>(base + kq_bytes)),
        v(reinterpret_cast<T*>(base + 2 * kq_bytes)),
        beta(reinterpret_cast<float*>(base + 2 * kq_bytes + v_bytes)),
        alpha(reinterpret_cast<float*>(base + 2 * kq_bytes + v_bytes) + TT) {}
};

// copy tokens [tok0, tok0 + TT) of head h into `c`, as one commit group
template <typename T, int K>
__device__ void stage(const Chunk<T, K>& c, const T* q, const T* k, const T* v,
                      const float* beta, const float* alpha, size_t tok0, int H, int h, int c0,
                      int tid) {
  constexpr int EP = 16 / sizeof(T);          // elements per 16-byte piece
  constexpr int RP = K / EP;                  // pieces per q / k row
  constexpr int VP = COLS / EP;               // pieces per v row slice
  for (int e = tid; e < TT * RP; e += THREADS) {
    const int tt = e / RP, pc = e % RP;
    const size_t row = ((tok0 + tt) * H + h) * K + pc * EP;
    cp_async16(c.k + tt * K + pc * EP, k + row);
    cp_async16(c.q + tt * K + pc * EP, q + row);
  }
  for (int e = tid; e < TT * VP; e += THREADS) {
    const int tt = e / VP, pc = e % VP;
    cp_async16(c.v + tt * COLS + pc * EP, v + ((tok0 + tt) * H + h) * K + c0 + pc * EP);
  }
  if (tid < TT) {
    cp_async4(c.beta + tid, beta + (tok0 + tid) * H + h);
  } else if (tid < 2 * TT) {
    cp_async4(c.alpha + tid - TT, alpha + (tok0 + tid - TT) * H + h);
  }
  cp_async_commit();
}

// the sum over the LANES lanes of a column, in every one of them
__device__ __forceinline__ void col_reduce2(float& a, float& b) {
#pragma unroll
  for (int m = 1; m < LANES; m <<= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, m);
    b += __shfl_xor_sync(0xffffffffu, b, m);
  }
}

// grid (K / COLS, H, B)
template <typename T, int K>
__global__ void __launch_bounds__(THREADS) gdn_scan_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ beta, const float* __restrict__ alpha, T* __restrict__ y,
    float* __restrict__ fs, int S, int H) {
  constexpr int R = K / LANES;          // state rows per thread
  constexpr int VW = R < 4 ? R : 4;     // read VW consecutive rows at a time
  constexpr int NM = R / VW;            // rows VW * rg + LANES * VW * m + e
  extern __shared__ __align__(16) unsigned char smem[];

  const int c0 = blockIdx.x * COLS, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, rg = tid % LANES, col = tid / LANES;
  const size_t tokb = (size_t)bi * S;
  const int n_chunks = S / TT;

  float st[R], qprev[R];
#pragma unroll
  for (int r = 0; r < R; ++r) st[r] = qprev[r] = 0.f;

  stage<T, K>(Chunk<T, K>(smem), q, k, v, beta, alpha, tokb, H, h, c0, tid);
  for (int ch = 0; ch < n_chunks; ++ch) {
    // the other buffer was released by the barrier that ended the last chunk
    if (ch + 1 < n_chunks) {
      stage<T, K>(Chunk<T, K>(smem + ((ch + 1) & 1) * Chunk<T, K>::bytes), q, k, v, beta, alpha,
                  tokb + (size_t)(ch + 1) * TT, H, h, c0, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Chunk<T, K> c(smem + (ch & 1) * Chunk<T, K>::bytes);
    for (int tt = 0; tt < TT; ++tt) {
      const int t = ch * TT + tt;
      float kt[R], qt[R];
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        load_vec<VW>(c.k + tt * K + VW * rg + LANES * VW * m, kt + m * VW);
        load_vec<VW>(c.q + tt * K + VW * rg + LANES * VW * m, qt + m * VW);
      }
      // S_{t-1}^T q_{t-1} and k_t^T S_{t-1}, two partial sums each
      float py0 = 0.f, py1 = 0.f, pk0 = 0.f, pk1 = 0.f;
#pragma unroll
      for (int r = 0; r < R; r += 2) {
        pk0 = fmaf(kt[r], st[r], pk0);
        py0 = fmaf(qprev[r], st[r], py0);
        pk1 = fmaf(kt[r + 1], st[r + 1], pk1);
        py1 = fmaf(qprev[r + 1], st[r + 1], py1);
      }
      float pk = pk0 + pk1, py = py0 + py1;
      col_reduce2(pk, py);
      if (t > 0 && rg == 0) store1(y + ((tokb + t - 1) * H + h) * K + c0 + col, py);
      const float at = c.alpha[tt];
      const float coef = c.beta[tt] * (to_f(c.v[tt * COLS + col]) - at * pk);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        st[r] = fmaf(coef, kt[r], at * st[r]);
        qprev[r] = qt[r];
      }
    }
    __syncthreads();
  }
  // y of the last token, from the final state
  float py0 = 0.f, py1 = 0.f;
#pragma unroll
  for (int r = 0; r < R; r += 2) {
    py0 = fmaf(qprev[r], st[r], py0);
    py1 = fmaf(qprev[r + 1], st[r + 1], py1);
  }
  float py = py0 + py1, unused = 0.f;
  col_reduce2(py, unused);
  if (rg == 0) store1(y + ((tokb + S - 1) * H + h) * K + c0 + col, py);
  // final state (B, H, K, K): row = key dim, column = value dim
  float* fsh = fs + ((size_t)bi * H + h) * K * K + c0 + col;
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < VW; ++e) fsh[(size_t)(VW * rg + LANES * VW * m + e) * K] = st[m * VW + e];
}

template <typename T, int K>
int launch_k(const void* q, const void* k, const void* v, const void* beta, const void* alpha,
             void* y, void* fs, int B, int S, int H, cudaStream_t stream) {
  constexpr size_t smem = 2 * Chunk<T, K>::bytes;
  // above 48 KB a kernel's dynamic shared memory must be opted into, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      gdn_scan_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  gdn_scan_kernel<T, K><<<dim3(K / COLS, H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(beta), static_cast<const float*>(alpha), static_cast<T*>(y),
      static_cast<float*>(fs), S, H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* beta, const void* alpha,
           void* y, void* fs, int B, int S, int H, int K, cudaStream_t stream) {
  if (B < 1 || S < TT || S % TT || H < 1) return (int)cudaErrorInvalidValue;
  switch (K) {
    case 16: return launch_k<T, 16>(q, k, v, beta, alpha, y, fs, B, S, H, stream);
    case 32: return launch_k<T, 32>(q, k, v, beta, alpha, y, fs, B, S, H, stream);
    case 64: return launch_k<T, 64>(q, k, v, beta, alpha, y, fs, B, S, H, stream);
    case 128: return launch_k<T, 128>(q, k, v, beta, alpha, y, fs, B, S, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v (B,S,H,K), beta, alpha (B,S,H) fp32 -> y (B,S,H,K) in q's dtype,
// fs (B,H,K,K) fp32. Returns cudaGetLastError() after the launch.
#define GDN_SCAN_LAUNCHER(NAME, T)                                                             \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* beta,          \
                      const void* alpha, void* y, void* fs, int B, int S, int H, int K,       \
                      void* stream) {                                                         \
    return launch<T>(q, k, v, beta, alpha, y, fs, B, S, H, K,                                 \
                     static_cast<cudaStream_t>(stream));                                       \
  }

GDN_SCAN_LAUNCHER(gdn_scan_f32, float)
GDN_SCAN_LAUNCHER(gdn_scan_bf16, __nv_bfloat16)
