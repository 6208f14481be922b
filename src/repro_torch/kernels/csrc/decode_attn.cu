// Single-query GQA flash decode over a dense or a paged KV cache, for Hopper
// (sm_90a), in fp32 and bf16.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/decode_attn/decode_attn.py:decode_attention        (dense)
//   src/repro/kernels/decode_attn/decode_attn.py:paged_decode_attention  (paged)
// and computes what their oracles in ref.py compute: for each request b and
// query head h = kh * G + g, softmax over keys kpos < valid_len[b] of
// scale * q.k, times v; m, l and the accumulator in fp32; Dk != Dv allowed.
// The paged form reads key kpos from page block_tables[b, kpos / bs], row
// kpos % bs; page 0 is the null page.
//
// What bounds it on this card: bytes. Each request's K and V rows below
// valid_len are read once, (Dk + Dv) * KV * elem bytes per key; one decode
// query does 2 * G multiply-adds per element read, far below the ~295 ops
// per byte at which an H100 stops being memory bound.
//
// What the design does about it:
// - The key loop stops at valid_len. The Pallas kernel streams every
//   block_k tile of the max_seq_len cache and masks; here the bytes read are
//   the bytes the request needs. The paged kernel reads block-table entries
//   only below ceil(valid_len / bs) and no page past them.
// - At decode batch sizes B * KV is far below the 132 SMs, so the key axis
//   is split across CTAs (flash-decoding): CTA (split, b * KV + kh) covers
//   keys [split * split_len, (split + 1) * split_len), and a second kernel
//   merges the splits' (m, l, acc) when there is more than one: one CTA per
//   output row, the splits' weights in shared memory, threads over Dv.
// - Inside a CTA each of the 4 warps takes KEYS keys at a time; every lane
//   loads 16 bytes of each key's K and V row, all issued before any is used,
//   so several rows are in flight per warp. The G query rows sit in shared
//   memory as fp32; m, l and the accumulator stay in registers, and the
//   warps merge through shared memory in a fixed order (deterministic).
// - p stays fp32 in the P.V product at bf16 too; the JAX model casts the
//   probabilities to the value dtype first (models/attention.py:_attend).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_D = 256;

struct Params {
  const void* q;           // (B, H, Dk)
  const void* k;           // dense (B, L, KV, Dk) | paged (P, bs, KV, Dk)
  const void* v;           // dense (B, L, KV, Dv) | paged (P, bs, KV, Dv)
  const int* valid_len;    // (B,)
  const int* block_tables; // (B, nb), paged only
  void* out;               // (B, H, Dv), q's dtype
  float* part_m;           // (B * KV, n_split, G), n_split > 1 only
  float* part_l;           // (B * KV, n_split, G)
  float* part_acc;         // (B * KV, n_split, G, Dv)
  int B, H, KV, Dk, Dv;
  int L;                   // logical key extent: dense L, or nb * bs
  int bs, nb;              // paged only
  int split_len, n_split;
  float scale;
};

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;  // elements per 16-byte load
  __device__ static void to_float(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static float load1(const float* p) { return *p; }
  __device__ static void store1(float* p, float x) { *p = x; }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void to_float(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
};

template <typename T, bool PAGED, int G_MAX, int KEYS>
__global__ void __launch_bounds__(THREADS) split_kernel(Params p) {
  using V = Vec<T>;
  constexpr int VN = V::N;
  constexpr int CH = (MAX_D / VN + 31) / 32;  // 16-byte chunks per lane
  constexpr int EPL = CH * VN;                // row elements per lane

  const int bk = blockIdx.y, split = blockIdx.x;
  const int b = bk / p.KV, kh = bk % p.KV;
  const int G = p.H / p.KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = min(p.valid_len[b], p.L);
  const int s0 = split * p.split_len;
  const int s1 = min(s0 + p.split_len, n);
  T* out = static_cast<T*>(p.out) + ((long long)b * p.H + kh * G) * p.Dv;
  const long long part = (long long)bk * p.n_split + split;

  if (s0 >= s1) {  // no key of this request falls in this split; the
                   // combine pass reads only splits below ceil(n / split_len)
    if (p.n_split == 1)
      for (int i = tid; i < G * p.Dv; i += THREADS) V::store1(out + i, 0.f);
    return;
  }

  extern __shared__ float smem[];
  float* sq = smem;                 // (G, Dk) query rows, fp32
  float* sacc = smem + G * p.Dk;    // (G, Dv) merged accumulator
  __shared__ float sm_m[WARPS][G_MAX], sm_l[WARPS][G_MAX];
  __shared__ float s_max[G_MAX], s_sum[G_MAX];

  const T* q = static_cast<const T*>(p.q) + ((long long)b * p.H + kh * G) * p.Dk;
  for (int i = tid; i < G * p.Dk; i += THREADS) sq[i] = V::load1(q + i);
  for (int i = tid; i < G * p.Dv; i += THREADS) sacc[i] = 0.f;
  __syncthreads();

  const T* K = static_cast<const T*>(p.k);
  const T* Vv = static_cast<const T*>(p.v);
  const int kch = p.Dk / VN, vch = p.Dv / VN;

  float m[G_MAX], l[G_MAX], acc[G_MAX][EPL];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int base = s0 + warp * KEYS; base < s1; base += WARPS * KEYS) {
    uint4 kr[KEYS][CH], vr[KEYS][CH];
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      const int pos = base + j;
      long long row = 0;
      if (pos < s1) {
        if (PAGED) {
          const int page = p.block_tables[(long long)b * p.nb + pos / p.bs];
          row = (long long)page * p.bs + pos % p.bs;
        } else {
          row = (long long)b * p.L + pos;
        }
      }
      const uint4* krow = reinterpret_cast<const uint4*>(K + (row * p.KV + kh) * p.Dk);
      const uint4* vrow = reinterpret_cast<const uint4*>(Vv + (row * p.KV + kh) * p.Dv);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int ch = lane + 32 * c;
        kr[j][c] = (pos < s1 && ch < kch) ? __ldg(krow + ch) : make_uint4(0, 0, 0, 0);
        vr[j][c] = (pos < s1 && ch < vch) ? __ldg(vrow + ch) : make_uint4(0, 0, 0, 0);
      }
    }

    // scores: q row g (fp32, read from shared memory once per g) against
    // the KEYS keys, each lane over its slice of the head dim
    float kf[KEYS][EPL];
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
#pragma unroll
      for (int c = 0; c < CH; ++c) V::to_float(kr[j][c], kf[j] + c * VN);
    }
    float s[KEYS][G_MAX];
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      float qf[EPL];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int ch = lane + 32 * c;
        const float4* qq = reinterpret_cast<const float4*>(sq + g * p.Dk + ch * VN);
#pragma unroll
        for (int e4 = 0; e4 < VN / 4; ++e4) {
          const float4 t = (g < G && ch < kch) ? qq[e4] : make_float4(0.f, 0.f, 0.f, 0.f);
          qf[c * VN + 4 * e4 + 0] = t.x;
          qf[c * VN + 4 * e4 + 1] = t.y;
          qf[c * VN + 4 * e4 + 2] = t.z;
          qf[c * VN + 4 * e4 + 3] = t.w;
        }
      }
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qf[e], kf[j][e], d);
        s[j][g] = d;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
#pragma unroll
        for (int g = 0; g < G_MAX; ++g) s[j][g] += __shfl_xor_sync(0xffffffffu, s[j][g], off);
      }
    }

    float vf[KEYS][EPL];
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
#pragma unroll
      for (int c = 0; c < CH; ++c) V::to_float(vr[j][c], vf[j] + c * VN);
    }
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      if (g >= G) continue;
      float sc[KEYS];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        sc[j] = (base + j < s1) ? s[j][g] * p.scale : -INFINITY;
        mx = fmaxf(mx, sc[j]);
      }
      const float m_new = fmaxf(m[g], mx);  // finite: key `base` is valid
      const float corr = expf(m[g] - m_new);
      float pj[KEYS];
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        pj[j] = expf(sc[j] - m_new);
        psum += pj[j];
      }
      l[g] = l[g] * corr + psum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[g][e] * corr;
#pragma unroll
        for (int j = 0; j < KEYS; ++j) a = fmaf(pj[j], vf[j][e], a);
        acc[g][e] = a;
      }
      m[g] = m_new;
    }
  }

  // merge the 4 warps' states through shared memory, in warp order
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  float wscale[G_MAX];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    wscale[g] = l[g] > 0.f ? expf(m[g] - mx) : 0.f;
    if (tid == 0 && g < G) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        if (sm_l[w][g] > 0.f) sum += sm_l[w][g] * expf(sm_m[w][g] - mx);
      s_max[g] = mx;
      s_sum[g] = sum;
    }
  }
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) {
        if (g >= G) continue;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int ch = lane + 32 * c;
          if (ch < vch) {
            float* dst = sacc + g * p.Dv + ch * VN;
#pragma unroll
            for (int e = 0; e < VN; ++e) dst[e] = fmaf(wscale[g], acc[g][c * VN + e], dst[e]);
          }
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < G * p.Dv; i += THREADS) {
    const int g = i / p.Dv;
    if (p.n_split == 1) {
      V::store1(out + i, sacc[i] / fmaxf(s_sum[g], 1e-30f));
    } else {
      p.part_acc[part * G * p.Dv + i] = sacc[i];
      if (i % p.Dv == 0) {
        p.part_m[part * G + g] = s_max[g];
        p.part_l[part * G + g] = s_sum[g];
      }
    }
  }
}

// Sum (max) of v over the CTA; every thread gets the result.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : (MAX ? -INFINITY : 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, off);
      v = MAX ? fmaxf(v, o) : v + o;
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// Merge the n_split partial states of one output row (b, kh, g): one CTA
// per row, the splits' weights in shared memory, threads over Dv.
template <typename T>
__global__ void combine_kernel(Params p) {
  extern __shared__ float w[];  // (n_split,) weight of each split
  __shared__ float red[32];
  const int G = p.H / p.KV;
  const int row = blockIdx.x;   // (b * KV + kh) * G + g
  const int bk = row / G, g = row % G;
  const int b = bk / p.KV, kh = bk % p.KV;
  const long long base = (long long)bk * p.n_split;
  // only the splits that hold keys of this request wrote a partial state
  const int n = min(p.valid_len[b], p.L);
  const int n_used = min(p.n_split, (n + p.split_len - 1) / p.split_len);

  float mx = -INFINITY;
  for (int s = threadIdx.x; s < n_used; s += blockDim.x)
    mx = fmaxf(mx, p.part_m[(base + s) * G + g]);
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int s = threadIdx.x; s < n_used; s += blockDim.x) {
    const float ws = expf(p.part_m[(base + s) * G + g] - mx);
    w[s] = ws;
    sum = fmaf(p.part_l[(base + s) * G + g], ws, sum);
  }
  sum = block_reduce<false>(sum, red);  // its barriers also publish w[]

  T* out = static_cast<T*>(p.out) + ((long long)b * p.H + kh * G + g) * p.Dv;
  const float* acc = p.part_acc + (base * G + g) * p.Dv;
  for (int d = threadIdx.x; d < p.Dv; d += blockDim.x) {
    float a = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_used; ++s) a = fmaf(w[s], acc[(long long)s * G * p.Dv + d], a);
    Vec<T>::store1(out + d, a / fmaxf(sum, 1e-30f));
  }
}

template <typename T, bool PAGED>
int launch(const Params& p, cudaStream_t stream) {
  const int G = p.H / p.KV;
  const dim3 grid(p.n_split, p.B * p.KV);
  const size_t smem = (size_t)G * (p.Dk + p.Dv) * sizeof(float);
  if (G <= 1) {
    split_kernel<T, PAGED, 1, 4><<<grid, THREADS, smem, stream>>>(p);
  } else if (G <= 4) {
    split_kernel<T, PAGED, 4, 4><<<grid, THREADS, smem, stream>>>(p);
  } else if (G <= 8) {
    split_kernel<T, PAGED, 8, 4><<<grid, THREADS, smem, stream>>>(p);
  } else if (G <= 16) {
    split_kernel<T, PAGED, 16, 2><<<grid, THREADS, smem, stream>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return (int)err;
  combine_kernel<T><<<p.B * p.KV * G, 128, p.n_split * sizeof(float), stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

#define DECODE_ATTN_LAUNCHER(NAME, T, PAGED)                                            \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* valid_len, \
                      const void* block_tables, void* out, void* part_m, void* part_l,   \
                      void* part_acc, int B, int H, int KV, int Dk, int Dv, int L, int bs, \
                      int nb, int split_len, int n_split, float scale, void* stream) {   \
    Params p;                                                                           \
    p.q = q;                                                                            \
    p.k = k;                                                                            \
    p.v = v;                                                                            \
    p.valid_len = static_cast<const int*>(valid_len);                                   \
    p.block_tables = static_cast<const int*>(block_tables);                             \
    p.out = out;                                                                        \
    p.part_m = static_cast<float*>(part_m);                                             \
    p.part_l = static_cast<float*>(part_l);                                             \
    p.part_acc = static_cast<float*>(part_acc);                                         \
    p.B = B;                                                                            \
    p.H = H;                                                                            \
    p.KV = KV;                                                                          \
    p.Dk = Dk;                                                                          \
    p.Dv = Dv;                                                                          \
    p.L = L;                                                                            \
    p.bs = bs;                                                                          \
    p.nb = nb;                                                                          \
    p.split_len = split_len;                                                            \
    p.n_split = n_split;                                                                \
    p.scale = scale;                                                                    \
    return launch<T, PAGED>(p, static_cast<cudaStream_t>(stream));                      \
  }

DECODE_ATTN_LAUNCHER(decode_attention_f32, float, false)
DECODE_ATTN_LAUNCHER(decode_attention_bf16, __nv_bfloat16, false)
DECODE_ATTN_LAUNCHER(paged_decode_attention_f32, float, true)
DECODE_ATTN_LAUNCHER(paged_decode_attention_bf16, __nv_bfloat16, true)
