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
// Two options of the model that the Pallas kernels leave to jnp around them
// (src/repro/models/attention.py:_decode_attend) are taken inside:
// - softcap > 0: each score is softcap * tanh(scale * q.k / softcap), after
//   the scale and before the mask (gemma2's attention softcap);
// - window > 0: only keys valid_len - window <= kpos < valid_len are
//   attended (the sliding window of a local layer).
// A window only raises the first key of a request, lo: each split starts its
// key loop at max(its first key, lo), so every split, warp and 16-key step
// still begins at a valid key, and a split that lies wholly below lo writes
// nothing; the combine merges the splits lo / split_len to the last.
//
// What bounds it on this card: bytes. Each request's K and V rows below
// valid_len are read once, (Dk + Dv) * KV * elem bytes per key; one decode
// query does 2 * G multiply-adds per element read, far below the ~295 ops
// per byte at which an H100 stops being memory bound. At the gemma-2b
// shape (B = 8, G = 8, D = 256, ragged valid_len up to 1024) that is ~4 MB,
// 0.0011-0.0013 ms at 3.35 TB/s; what a call costs in practice is latency:
// a few CTAs per request, each a chain of dependent loads, products and
// merges, and a second launch.
//
// 1. bf16, dense and paged: tc_split_kernel<DMAX, PAGED, CAPPED> + tc_combine_kernel,
//   on the tensor cores.
// - Both products on mma.sync.m16n8k16 (bf16 in, fp32 accumulate), in the
//   FlashAttention-2 register layout. The G <= 16 query rows of one KV head
//   are the 16 rows of one tile (zero rows pad G < 16), so S = Q.K^T for 16
//   keys is two n8 tiles whose accumulator layout is the A-operand layout of
//   O += P.V: p never leaves registers. K comes through ldmatrix, V through
//   ldmatrix.trans; the row max and row sum take two quad shuffles a row.
// - Each of the 4 warps streams its own 16-key steps (keys warp, warp + 4,
//   ... of the CTA's 64-key tiles) through a ring of 2 slots in shared
//   memory: one TMA bulk copy a K or V row, issued by the warp's own lanes
//   and completing on the slot's mbarrier, so the next step is in flight
//   while one is reduced. The K/V copies start before the query is staged;
//   the key loop has no CTA-wide barrier. Rows are padded by 16 bytes
//   (conflict-free ldmatrix) and zero past the head dim, so the unrolled
//   loops run to a fixed width (64, 128 or 256) with no branch in them; a
//   head dim that is a multiple of 8 but not of 16 is zero-padded, not
//   refused.
// - A key row's address comes from tc::key_row: dense b * L + pos; paged
//   page table[pos / bs - first], row pos % bs. The paged kernel copies the
//   entries its split reads, first = s0 / bs to (s1 - 1) / bs, from the
//   block table to shared memory once, before the barriers are set up, so
//   no TMA copy waits on a load from global memory; entries at or past
//   ceil(valid_len / bs) are never read, and a 16-key step may span pages
//   (bs = 8) or lie inside one (bs >= 16).
// - Splits of whole 64-key tiles, 64 keys at least (decode_attn.py:
//   plan). A CTA merges its warps through shared memory behind one
//   barrier; a request with one split is written directly, one with more
//   writes an fp32 partial (m, l, acc) a split that tc_combine_kernel merges
//   -- one CTA per output row, every partial's loads in flight at once,
//   launched with programmatic dependent launch so that it starts while the
//   split kernel runs. (Merging in the last CTA of a request to finish, by a
//   ticket, was slower: one CTA reads all the request's partials.)
// - Precision: q, k and v are bf16 already; p is rounded once to bf16 as
//   the A operand of P.V (the JAX model casts p to the value dtype too,
//   models/attention.py:_attend); m, l and every accumulator stay fp32.
// - Times at the gemma-2b shape (H100 80GB HBM3 at 700 W, CUDA-graph device
//   ms a call, medians of chip_smoke.py --against the first design): dense
//   0.0093; paged 0.0095, against 0.0257 when the paged form ran the first
//   design below. The paged kernel's extra ~0.2 us is the dependent read of
//   its table entries, which must follow valid_len.
//
// 2. fp32 (dense and paged): split_kernel + combine_kernel, the first
//   design, on the CUDA cores in fp32. fp32 would need 3xTF32 to hold its
//   5e-5 tolerance on the tensor cores; only the fp32 gates run it. CTA
//   (split, b * KV + kh) covers keys [split * split_len, ...); a second
//   kernel merges the splits' (m, l, acc): one CTA per output row, the
//   splits' weights in shared memory, threads over Dv. Inside a CTA each of
//   the 4 warps takes KEYS keys at a time, every lane 16 bytes of each
//   key's K and V row, all in flight before any is used; the G query rows
//   sit in shared memory, m, l and the accumulator in registers, and the
//   warps merge through shared memory in a fixed order.
//
// The log-sum-exp (lse, optional): with a non-null lse pointer each output
// row (b, h) also gets the natural-log log-sum-exp of its attended scores,
// mx + log(l) of the merged state, written where the row's output is
// written (the split kernel for a request of one split, else the combine).
// A row with no attended key (n <= 0, or a window starting at or past n: a
// shard of a cache split over ranks that holds none of the row's keys)
// gets output 0 and lse -inf, so a cross-rank combine weighs it 0. The
// window's first key is taken from the raw valid_len, which may exceed L
// on such a shard (the keys past L live on the next rank).
//
// Both stop the key loop at valid_len: the Pallas kernel streams every
// block_k tile of the max_seq_len cache and masks, here the bytes read are
// the bytes the request needs. The paged kernels read block-table entries
// only below ceil(valid_len / bs) and no page past them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"

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
  float* lse;              // (B, H) log-sum-exp, or null
  float* part_m;           // (B * KV, n_split, G), n_split > 1 only
  float* part_l;           // (B * KV, n_split, G)
  float* part_acc;         // (B * KV, n_split, G, Dv)
  int B, H, KV, Dk, Dv;
  int L;                   // logical key extent: dense L, or nb * bs
  int bs, nb;              // paged only
  int split_len, n_split;
  float scale;
  float softcap;           // 0: none
  int window;              // 0: none
};

// The first key a request of valid length vl attends: vl - window under a
// window (vl may exceed L: see the log-sum-exp note above).
__device__ __forceinline__ int first_key(const Params& p, int vl) {
  return p.window > 0 ? max(vl - p.window, 0) : 0;
}

// The first split holding a key of a request of valid length vl
// (split_len keys a split): 0 without a window, with no division on that path.
__device__ __forceinline__ int first_split(const Params& p, int vl) {
  return p.window > 0 ? first_key(p, vl) / p.split_len : 0;
}

// lse of a merged state (max in natural-log units, sum of exponentials)
__device__ __forceinline__ float merged_lse(float mx, float sum) {
  return sum > 0.f ? mx + logf(sum) : -INFINITY;
}

// scale * q.k, through the softcap when there is one
__device__ __forceinline__ float scaled_score(const Params& p, float dot) {
  const float s = dot * p.scale;
  return p.softcap > 0.f ? p.softcap * tanhf(s / p.softcap) : s;
}

// four floats of a 16-byte load
__device__ __forceinline__ void to_float(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

template <bool PAGED, int G_MAX, int KEYS>
__global__ void __launch_bounds__(THREADS) split_kernel(Params p) {
  constexpr int VN = 4;                       // floats per 16-byte load
  constexpr int CH = (MAX_D / VN + 31) / 32;  // 16-byte chunks per lane
  constexpr int EPL = CH * VN;                // row elements per lane

  const int bk = blockIdx.y, split = blockIdx.x;
  const int b = bk / p.KV, kh = bk % p.KV;
  const int G = p.H / p.KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vl = p.valid_len[b];
  const int n = min(vl, p.L);
  const int s0 = max(split * p.split_len, first_key(p, vl));
  const int s1 = min(split * p.split_len + p.split_len, n);
  float* out = static_cast<float*>(p.out) + ((long long)b * p.H + kh * G) * p.Dv;
  const long long part = (long long)bk * p.n_split + split;

  if (s0 >= s1) {  // no key of this request falls in this split; the combine
                   // pass reads only splits first_key / split_len to
                   // ceil(n / split_len) - 1
    if (p.n_split == 1) {
      for (int i = tid; i < G * p.Dv; i += THREADS) out[i] = 0.f;
      if (p.lse && tid < G) p.lse[(long long)b * p.H + kh * G + tid] = -INFINITY;
    }
    return;
  }

  extern __shared__ float smem[];
  float* sq = smem;                 // (G, Dk) query rows
  float* sacc = smem + G * p.Dk;    // (G, Dv) merged accumulator
  __shared__ float sm_m[WARPS][G_MAX], sm_l[WARPS][G_MAX];
  __shared__ float s_max[G_MAX], s_sum[G_MAX];

  const float* q = static_cast<const float*>(p.q) + ((long long)b * p.H + kh * G) * p.Dk;
  for (int i = tid; i < G * p.Dk; i += THREADS) sq[i] = q[i];
  for (int i = tid; i < G * p.Dv; i += THREADS) sacc[i] = 0.f;
  __syncthreads();

  const float* K = static_cast<const float*>(p.k);
  const float* Vv = static_cast<const float*>(p.v);
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

    // scores: q row g (read from shared memory once per g) against
    // the KEYS keys, each lane over its slice of the head dim
    float kf[KEYS][EPL];
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
#pragma unroll
      for (int c = 0; c < CH; ++c) to_float(kr[j][c], kf[j] + c * VN);
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
      for (int c = 0; c < CH; ++c) to_float(vr[j][c], vf[j] + c * VN);
    }
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      if (g >= G) continue;
      float sc[KEYS];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        sc[j] = (base + j < s1) ? scaled_score(p, s[j][g]) : -INFINITY;
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
      out[i] = sacc[i] / fmaxf(s_sum[g], 1e-30f);
      if (p.lse && i % p.Dv == 0)
        p.lse[(long long)b * p.H + kh * G + g] = merged_lse(s_max[g], s_sum[g]);
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
__global__ void combine_kernel(Params p) {
  extern __shared__ float w[];  // (n_split,) weight of each split
  __shared__ float red[32];
  const int G = p.H / p.KV;
  const int row = blockIdx.x;   // (b * KV + kh) * G + g
  const int bk = row / G, g = row % G;
  const int b = bk / p.KV, kh = bk % p.KV;
  const long long base = (long long)bk * p.n_split;
  // only the splits that hold keys of this request wrote a partial state
  const int vl = p.valid_len[b];
  const int n = min(vl, p.L);
  const int s_first = first_split(p, vl);
  // no key at all (the window starts at or past n): nothing to merge
  const int n_used = first_key(p, vl) < n ? min(p.n_split, (n + p.split_len - 1) / p.split_len)
                                          : s_first;

  float mx = -INFINITY;
  for (int s = s_first + threadIdx.x; s < n_used; s += blockDim.x)
    mx = fmaxf(mx, p.part_m[(base + s) * G + g]);
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int s = s_first + threadIdx.x; s < n_used; s += blockDim.x) {
    const float ws = expf(p.part_m[(base + s) * G + g] - mx);
    w[s] = ws;
    sum = fmaf(p.part_l[(base + s) * G + g], ws, sum);
  }
  sum = block_reduce<false>(sum, red);  // its barriers also publish w[]

  float* out = static_cast<float*>(p.out) + ((long long)b * p.H + kh * G + g) * p.Dv;
  const float* acc = p.part_acc + (base * G + g) * p.Dv;
  for (int d = threadIdx.x; d < p.Dv; d += blockDim.x) {
    float a = 0.f;
#pragma unroll 4
    for (int s = s_first; s < n_used; ++s) a = fmaf(w[s], acc[(long long)s * G * p.Dv + d], a);
    out[d] = a / fmaxf(sum, 1e-30f);
  }
  if (p.lse && threadIdx.x == 0) p.lse[(long long)b * p.H + kh * G + g] = merged_lse(mx, sum);
}

// ---------------------------------------------------------------------------
// 1. bf16 dense and paged on the tensor cores
namespace tc {

using namespace sm90;
using bf16 = __nv_bfloat16;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WK = 16;                 // keys a warp takes a step: the k16 of P.V
constexpr int STAGES = 2;              // slots in a warp's ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Row of key pos of request b in the (rows, KV, D) cache. Dense: b * L +
// pos. Paged: page table[pos / bs - first], row pos % bs, where `table` holds
// the request's block-table entries from entry `first` on (a copy in shared
// memory).
template <bool PAGED>
__device__ __forceinline__ long long key_row(const Params& p, const int* table, int first, int b,
                                             int pos) {
  if constexpr (PAGED)
    return (long long)table[pos / p.bs - first] * p.bs + pos % p.bs;
  else
    return (long long)b * p.L + pos;
}

// Shared memory: the 16-row query tile, then each warp's STAGES slots of WK
// K rows and WK V rows, every row DMAX wide (zero past the head dim, so the
// unrolled loops need no bound) and padded by 8 elements; after the key loop
// the slots hold the warps' fp32 accumulators (WARPS x 16 x DMAX fp32, less
// than the slots' bytes). The paged kernel keeps its split's block-table
// entries after them (table_bytes).
__host__ __device__ constexpr size_t smem_bytes(int dmax) {
  return (16 + WARPS * STAGES * WK * 2) * (dmax + 8) * sizeof(bf16);
}
// bytes of the block-table copy of a split of split_len keys
inline size_t table_bytes(int split_len, int bs) { return (size_t)(split_len / bs + 2) * 4; }
constexpr int MAX_SMEM = 200 * 1024;  // the dynamic shared memory a split CTA may ask for

// grid (n_split, B * KV); DMAX >= max(Dk, Dv), a multiple of 16; CAPPED: the
// scores go through the softcap (a template flag, so that the loop without
// one is the loop that was timed without it)
template <int DMAX, bool PAGED, bool CAPPED>
__global__ void __launch_bounds__(THREADS, 1) tc_split_kernel(Params p) {
  const int bk = blockIdx.y, split = blockIdx.x;
  const int b = bk / p.KV, kh = bk % p.KV;
  const int G = p.H / p.KV, dk = p.Dk, dv = p.Dv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // tc_combine_kernel may start
  const int vl = p.valid_len[b];
  const int n = min(vl, p.L);
  const int lo = first_key(p, vl);
  const int s0 = max(split * p.split_len, lo), s1 = min(split * p.split_len + p.split_len, n);
  // splits with keys of b: lo / split_len to ceil(n / split_len) - 1
  const int n_used = (n + p.split_len - 1) / p.split_len - first_split(p, vl);
  bf16* out = static_cast<bf16*>(p.out) + ((long long)b * p.H + kh * G) * dv;
  if (s0 >= s1) {  // no key of this request here (below the window, or past n)
    if (lo >= n && split == 0) {  // none anywhere: 0, and lse -inf
      for (int i = tid; i < G * dv; i += THREADS) out[i] = __float2bfloat16(0.f);
      if (p.lse && tid < G) p.lse[(long long)b * p.H + kh * G + tid] = -INFINITY;
    }
    return;
  }
  // one CTA for the request: write the output; else an fp32 partial state,
  // merged by tc_combine_kernel
  const bool direct = n_used == 1;

  constexpr int LD = DMAX + 8;  // row stride of every tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* const smem = tc_smem;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + 16 * LD;
  bf16* myK = sK + warp * STAGES * WK * LD;
  bf16* myV = sK + (WARPS + warp) * STAGES * WK * LD;
  int* table = reinterpret_cast<int*>(smem + smem_bytes(DMAX));  // paged only
  __shared__ float s_m[WARPS][16], s_l[WARPS][16];

  const bf16* K = static_cast<const bf16*>(p.k);
  const bf16* V = static_cast<const bf16*>(p.v);
  const int kc = dk >> 3, vc = dv >> 3;               // 16-byte chunks of a row
  const int steps = (s1 - s0 + WK - 1) / WK;          // the CTA's 16-key steps
  const int nw = steps > warp ? (steps - warp + WARPS - 1) / WARPS : 0;  // this warp's
  __shared__ __align__(8) uint64_t kv_bar[WARPS][STAGES];  // a warp's slots land here
  // the query (rows >= G and columns >= Dk zero) by cp.async
  const uint4 zero = make_uint4(0, 0, 0, 0);
  auto stage_query = [&]() {
    const bf16* q = static_cast<const bf16*>(p.q) + ((long long)b * p.H + kh * G) * dk;
    for (int e = tid; e < 16 * (DMAX / 8); e += THREADS) {
      const int r = e / (DMAX / 8), c = e % (DMAX / 8);
      if (r < G && c < kc)
        cp_async16(sQ + r * LD + 8 * c, q + r * dk + 8 * c, true);
      else
        *reinterpret_cast<uint4*>(sQ + r * LD + 8 * c) = zero;
    }
    cp_async_commit();
  };
  int first = 0;  // the split's first block-table entry
  if constexpr (PAGED) {
    stage_query();  // in flight while the table entries are read
    // the entries the split reads, all below ceil(n / bs), to shared memory
    first = s0 / p.bs;
    const int* bt = p.block_tables + (long long)b * p.nb + first;
    for (int j = tid; j <= (s1 - 1) / p.bs - first; j += THREADS) table[j] = bt[j];
  }
  if (tid == 0) {
    for (int i = 0; i < WARPS * STAGES; ++i) mbar_init(&kv_bar[0][0] + i, 1);
    mbar_init_fence();
  }
  __syncthreads();  // the barriers are initialised, the table entries copied

  // this warp's step i (keys s0 + (warp + i * WARPS) * WK + [0, WK)) -> slot
  // i % STAGES: lane r < WK copies K row r, lane WK + r V row r, one TMA bulk
  // copy each; a key past s1 copies key s1 - 1 instead (masked below)
  auto load = [&](int i) {
    const int slot = i % STAGES, r = lane % WK;
    uint64_t* bar = &kv_bar[warp][slot];
    if (lane == 0) mbar_expect_tx(bar, WK * (dk + dv) * sizeof(bf16));
    fence_proxy_async();  // the slot's last reads (step i - STAGES) come first
    const long long row =
        key_row<PAGED>(p, table, first, b, min(s0 + (warp + i * WARPS) * WK + r, s1 - 1)) * p.KV +
        kh;
    if (lane < WK)
      bulk_copy(myK + (slot * WK + r) * LD, K + row * dk, dk * sizeof(bf16), bar);
    else
      bulk_copy(myV + (slot * WK + r) * LD, V + row * dv, dv * sizeof(bf16), bar);
  };

  // dense: K/V first, then the query
  for (int i = 0; i < STAGES - 1 && i < nw; ++i) load(i);
  if constexpr (!PAGED) stage_query();
  // the columns past the head dims, once (the copies write the others)
  for (int e = lane; e < STAGES * WK * (DMAX / 8); e += 32) {
    const int r = e / (DMAX / 8), c = e % (DMAX / 8);
    if (c >= kc) *reinterpret_cast<uint4*>(myK + r * LD + 8 * c) = zero;
    if (c >= vc) *reinterpret_cast<uint4*>(myV + r * LD + 8 * c) = zero;
  }
  cp_async_wait<0>();
  __syncthreads();  // the query tile, from every thread's copies

  const int r0 = lane >> 2, c0 = (lane & 3) * 2;  // accumulator rows r0, r0 + 8
  const float sl2 = p.scale * LOG2E;               // scores in log2 units
  // CAPPED: softcap * tanh(s * scale / softcap), then log2 units
  const float cap_l2 = p.softcap * LOG2E, cap_in = CAPPED ? p.scale / p.softcap : 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < nw; ++i) {
    if (i + STAGES - 1 < nw) load(i + STAGES - 1);
    mbar_wait(&kv_bar[warp][i % STAGES], (i / STAGES) & 1);  // step i has landed
    const bf16* tk = myK + (i % STAGES) * WK * LD;
    const bf16* tv = myV + (i % STAGES) * WK * LD;

    // S = Q K^T: rows = query heads, two n8 tiles of keys
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      uint32_t a[4], kb[4];
      ldsm_x4(a, sQ + (lane & 15) * LD + 16 * kk + (lane >> 4) * 8);
      ldsm_x4(kb, tk + ((lane >> 4) * 8 + (lane & 7)) * LD + 16 * kk + ((lane >> 3) & 1) * 8);
      mma(s[0], a, kb[0], kb[1]);
      mma(s[1], a, kb[2], kb[3]);
    }
    // in [max(lo, split start), s1): the step's first key is valid
    const int base = s0 + (warp + i * WARPS) * WK;
    if constexpr (CAPPED) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[t][e] = base + 8 * t + c0 + (e & 1) < s1 ? cap_l2 * tanhf(s[t][e] * cap_in)
                                                     : -INFINITY;
    } else {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[t][e] = base + 8 * t + c0 + (e & 1) < s1 ? s[t][e] * sl2 : -INFINITY;
    }
    float mx0 = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    float mx1 = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite
    const float cr0 = exp2f(m0 - mn0), cr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float pr[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      pr[t][0] = exp2f(s[t][0] - mn0);
      pr[t][1] = exp2f(s[t][1] - mn0);
      pr[t][2] = exp2f(s[t][2] - mn1);
      pr[t][3] = exp2f(s[t][3] - mn1);
    }
    l0 = l0 * cr0 + (pr[0][0] + pr[0][1] + pr[1][0] + pr[1][1]);  // this lane's share
    l1 = l1 * cr1 + (pr[0][2] + pr[0][3] + pr[1][2] + pr[1][3]);
    const uint32_t pa[4] = {pack(pr[0][0], pr[0][1]), pack(pr[0][2], pr[0][3]),
                            pack(pr[1][0], pr[1][1]), pack(pr[1][2], pr[1][3])};
    // O = O * corr + P V
#pragma unroll
    for (int j2 = 0; j2 < DMAX / 16; ++j2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[2 * j2 + h][0] *= cr0;
        acc[2 * j2 + h][1] *= cr0;
        acc[2 * j2 + h][2] *= cr1;
        acc[2 * j2 + h][3] *= cr1;
      }
      uint32_t vb[4];
      ldsm_x4_t(vb, tv + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + 16 * j2 + (lane >> 4) * 8);
      mma(acc[2 * j2], pa, vb[0], vb[1]);
      mma(acc[2 * j2 + 1], pa, vb[2], vb[3]);
    }
    __syncwarp();  // every lane is done with the slot before it is refilled
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // merge the warps: raw accumulators and (m, l) to shared memory, one barrier
  __syncthreads();  // every warp is out of its slots
  float* sO = reinterpret_cast<float*>(sK);  // (WARPS, 16, DMAX)
  if ((lane & 3) == 0) {
    s_m[warp][r0] = m0;
    s_m[warp][r0 + 8] = m1;
    s_l[warp][r0] = l0;
    s_l[warp][r0 + 8] = l1;
  }
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    float* o = sO + (warp * 16 + r0) * DMAX + 8 * j + c0;
    *reinterpret_cast<float2*>(o) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(o + 8 * DMAX) = make_float2(acc[j][2], acc[j][3]);
  }
  __syncthreads();
  const long long part = (long long)bk * p.n_split + split;
  for (int e = tid; e < G * dv / 4; e += THREADS) {
    const int g = 4 * e / dv, d = 4 * e - g * dv;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, s_m[w][g]);
    float sum = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = s_l[w][g] > 0.f ? exp2f(s_m[w][g] - mx) : 0.f;
      const float4 a = *reinterpret_cast<const float4*>(sO + (w * 16 + g) * DMAX + d);
      sum = fmaf(wt, s_l[w][g], sum);
      o.x = fmaf(wt, a.x, o.x);
      o.y = fmaf(wt, a.y, o.y);
      o.z = fmaf(wt, a.z, o.z);
      o.w = fmaf(wt, a.w, o.w);
    }
    if (direct) {
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      *reinterpret_cast<uint2*>(out + g * dv + d) =
          make_uint2(pack(o.x * inv, o.y * inv), pack(o.z * inv, o.w * inv));
      if (p.lse && d == 0)  // mx in log2 units
        p.lse[(long long)b * p.H + kh * G + g] = merged_lse(mx * LN2, sum);
    } else {
      *reinterpret_cast<float4*>(p.part_acc + (part * G + g) * dv + d) = o;
      if (d == 0) {
        p.part_m[part * G + g] = mx * LN2;  // natural-log units
        p.part_l[part * G + g] = sum;
      }
    }
  }
}

constexpr int COMBINE_THREADS = 64;  // 4 columns a thread: Dv <= 256
constexpr int COMBINE_UNROLL = 16;   // up to this many splits, all loads in flight at once

// Merge the partial states of one output row (b, kh, g) of a request with
// more than one split: one CTA per row, 4 columns a thread. Launched with
// programmatic stream serialization it may start while the split kernel
// runs; griddepcontrol.wait holds it until the partials are written.
__global__ void __launch_bounds__(COMBINE_THREADS) tc_combine_kernel(Params p) {
  const int G = p.H / p.KV, row = blockIdx.x;  // b * H + kh * G + g
  const int bk = row / G, g = row - bk * G, b = bk / p.KV;
  const int d = 4 * threadIdx.x;
  const int vl = p.valid_len[b];
  const int n = min(vl, p.L);
  // the splits with keys of b: s_first to s_first + n_used - 1
  const int s_first = first_split(p, vl);
  const int n_used = min(p.n_split, (n + p.split_len - 1) / p.split_len) - s_first;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (n_used <= 1 || d >= p.Dv) return;  // one split wrote the row itself
  const long long first = (long long)bk * p.n_split + s_first;
  auto acc_at = [&](int s) {
    return __ldcg(reinterpret_cast<const float4*>(p.part_acc + ((first + s) * G + g) * p.Dv + d));
  };
  float mx = -INFINITY, sum = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n_used <= COMBINE_UNROLL) {
    // every load in flight at once: splits past n_used read the last one again,
    // and weigh 0
    float m[COMBINE_UNROLL], l[COMBINE_UNROLL];
    float4 a[COMBINE_UNROLL];
#pragma unroll
    for (int s = 0; s < COMBINE_UNROLL; ++s) {
      const int t = min(s, n_used - 1);
      m[s] = __ldcg(p.part_m + (first + t) * G + g);
      l[s] = __ldcg(p.part_l + (first + t) * G + g);
      a[s] = acc_at(t);
      mx = fmaxf(mx, m[s]);
    }
#pragma unroll
    for (int s = 0; s < COMBINE_UNROLL; ++s) {
      const float w = s < n_used ? expf(m[s] - mx) : 0.f;
      sum = fmaf(w, l[s], sum);
      o.x = fmaf(w, a[s].x, o.x);
      o.y = fmaf(w, a[s].y, o.y);
      o.z = fmaf(w, a[s].z, o.z);
      o.w = fmaf(w, a[s].w, o.w);
    }
  } else {
    for (int s = 0; s < n_used; ++s) mx = fmaxf(mx, __ldcg(p.part_m + (first + s) * G + g));
    for (int s = 0; s < n_used; ++s) {
      const float w = expf(__ldcg(p.part_m + (first + s) * G + g) - mx);
      const float4 a = acc_at(s);
      sum = fmaf(w, __ldcg(p.part_l + (first + s) * G + g), sum);
      o.x = fmaf(w, a.x, o.x);
      o.y = fmaf(w, a.y, o.y);
      o.z = fmaf(w, a.z, o.z);
      o.w = fmaf(w, a.w, o.w);
    }
  }
  const float inv = 1.f / fmaxf(sum, 1e-30f);
  *reinterpret_cast<uint2*>(static_cast<bf16*>(p.out) + (long long)row * p.Dv + d) =
      make_uint2(pack(o.x * inv, o.y * inv), pack(o.z * inv, o.w * inv));
  if (p.lse && threadIdx.x == 0) p.lse[row] = merged_lse(mx, sum);
}

template <int DMAX, bool PAGED, bool CAPPED>
int launch_d(const Params& p, cudaStream_t stream) {
  // above 48 KB a kernel's dynamic shared memory must be opted into, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      tc_split_kernel<DMAX, PAGED, CAPPED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  size_t smem = smem_bytes(DMAX);
  if constexpr (PAGED) smem += table_bytes(p.split_len, p.bs);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  tc_split_kernel<DMAX, PAGED, CAPPED>
      <<<dim3(p.n_split, p.B * p.KV), THREADS, smem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return (int)err;
  // the combine may launch while the split kernel runs (programmatic dependent
  // launch): its griddepcontrol.wait holds it until the partials are written
  cudaLaunchAttribute serial[1];
  serial[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  serial[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.H);
  cfg.blockDim = dim3(COMBINE_THREADS);
  cfg.stream = stream;
  cfg.attrs = serial;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, tc_combine_kernel, p);
}

template <bool PAGED, bool CAPPED>
int launch_c(const Params& p, cudaStream_t stream) {
  const int d = p.Dk > p.Dv ? p.Dk : p.Dv;
  if (d <= 64) return launch_d<64, PAGED, CAPPED>(p, stream);
  if (d <= 128) return launch_d<128, PAGED, CAPPED>(p, stream);
  if (d <= 256) return launch_d<256, PAGED, CAPPED>(p, stream);
  return (int)cudaErrorInvalidValue;
}

template <bool PAGED>
int launch(const Params& p, cudaStream_t stream) {
  if (p.H % p.KV || p.H / p.KV > 16 || p.Dk % 8 || p.Dv % 8 || p.split_len % (WARPS * WK))
    return (int)cudaErrorInvalidValue;
  return p.softcap > 0.f ? launch_c<PAGED, true>(p, stream) : launch_c<PAGED, false>(p, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// 2. fp32 on the first design
template <bool PAGED>
int launch_f32(const Params& p, cudaStream_t stream) {
  const int G = p.H / p.KV;
  const dim3 grid(p.n_split, p.B * p.KV);
  const size_t smem = (size_t)G * (p.Dk + p.Dv) * sizeof(float);
  if (G <= 1) {
    split_kernel<PAGED, 1, 4><<<grid, THREADS, smem, stream>>>(p);
  } else if (G <= 4) {
    split_kernel<PAGED, 4, 4><<<grid, THREADS, smem, stream>>>(p);
  } else if (G <= 8) {
    split_kernel<PAGED, 8, 4><<<grid, THREADS, smem, stream>>>(p);
  } else if (G <= 16) {
    split_kernel<PAGED, 16, 2><<<grid, THREADS, smem, stream>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return (int)err;
  combine_kernel<<<p.B * p.KV * G, 128, p.n_split * sizeof(float), stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

#define DECODE_ATTN_LAUNCHER(NAME, LAUNCH)                                              \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* valid_len, \
                      const void* block_tables, void* out, void* lse, void* part_m,      \
                      void* part_l,                                                      \
                      void* part_acc, int B, int H, int KV, int Dk, int Dv, int L, int bs, \
                      int nb, int split_len, int n_split, float scale, float softcap,    \
                      int window, void* stream) {                                        \
    Params p;                                                                           \
    p.q = q;                                                                            \
    p.k = k;                                                                            \
    p.v = v;                                                                            \
    p.valid_len = static_cast<const int*>(valid_len);                                   \
    p.block_tables = static_cast<const int*>(block_tables);                             \
    p.out = out;                                                                        \
    p.lse = static_cast<float*>(lse);                                                   \
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
    p.softcap = softcap;                                                                \
    p.window = window;                                                                  \
    return LAUNCH(p, static_cast<cudaStream_t>(stream));                                \
  }

DECODE_ATTN_LAUNCHER(decode_attention_f32, launch_f32<false>)
DECODE_ATTN_LAUNCHER(decode_attention_bf16, tc::launch<false>)
DECODE_ATTN_LAUNCHER(paged_decode_attention_f32, launch_f32<true>)
DECODE_ATTN_LAUNCHER(paged_decode_attention_bf16, tc::launch<true>)
