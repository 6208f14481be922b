// Absorbed-MLA latent decode over a dense or a paged compressed cache, for
// Hopper (sm_90a), in fp32 and bf16.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/mla_decode/mla_decode.py:mla_latent_decode        (dense)
//   src/repro/kernels/mla_decode/mla_decode.py:mla_paged_latent_decode  (paged)
// and computes what their oracles in ref.py compute: MQA over one shared
// latent head. For request b and query head h, the score of key kpos is
// scale * (q_lat[b,h] . ckv[kpos] + q_rope[b,h] . kr[kpos]); softmax over
// kpos < valid_len[b]; the context is the probability-weighted sum of the
// ckv rows, (B, H, R) in q's dtype. m, l and the accumulator are fp32. The
// paged form reads key kpos from page block_tables[b, kpos / bs], row
// kpos % bs; page 0 is the null page. ckv and kr are separate operands in
// both forms: the dense Pallas wrapper concatenates them on the host, which
// copies the whole cache on every call; this kernel reads each once.
//
// The log-sum-exp (lse, optional): with a non-null lse pointer each output
// row (b, h) also gets the natural-log log-sum-exp of its scores, mx +
// log(l) of the merged state, written where the row's output is written
// (the split kernel for one split, else the combine); -inf, and output 0,
// for a row with no key (valid_len 0: a shard of a cache split over ranks
// holding none of the row's keys), so a cross-rank combine weighs it 0.
//
// What bounds it on this card: bytes. Every key costs 2 * H * (R + P + R)
// flops (scores over R + P features, context over R) against (R + P) * elem
// bytes: at H = 24, R = 512, P = 64 in bf16 about 45 flops per byte, far
// below the ~295 at which the tensor cores stop being fed by HBM. On the
// CUDA cores (~20 flops per byte in fp32) the same FMAs are the limit.
//
// 1. bf16, dense and paged: tc::mla_tc_split_kernel<RMAX, NH, PAGED> +
//   tc::mla_tc_combine_kernel, on the tensor cores.
// - Both products on mma.sync.m16n8k16 (bf16 in, fp32 accumulate), with the
//   keys on the M side of the scores: S^T (keys x heads) = [ckv | kr] .
//   [q_lat | q_rope]^T, so that HG = 8, 16 or 24 heads are one, two or three
//   n8 tiles (24 heads: none padded) and share one read of every key row;
//   the context is O^T (latent x heads) = ckv^T P^T, its A operand the same
//   shared-memory key rows through ldmatrix.trans (ckv is both the key's
//   latent part and the value).
// - A CTA (4 warps) takes a split of 64 keys, 32 a step. Each warp scores
//   the step's keys over a quarter of the 576 features (its Q^T fragments
//   stay in registers for the whole split), the four partial scores meet in
//   shared memory behind one barrier a step, and every warp then runs the
//   same online softmax down the heads' columns; p is rounded once to bf16
//   (as the JAX model casts the probabilities to the cache dtype,
//   models/mla.py:_attend_absorbed) into a per-warp P^T tile, the B operand
//   of the context. The H x 512 fp32 accumulator is split over the warps by
//   latent rows: 128 a warp, 96 registers a thread at H = 24.
// - Key rows arrive by TMA bulk copies, one per row's ckv and one per its kr
//   part, into a 2-slot ring of 32-key steps with an mbarrier a slot; every
//   warp issues the copies of 8 rows (one warp issuing all 64 serialised
//   them: 0.0164 against 0.0121 ms a call). A key row's address comes from
//   tc::key_row: dense b * L + pos; paged page table[pos / bs - first], row
//   pos % bs, the block-table entries the split can touch copied to shared
//   memory once, while valid_len is read. The dense instantiation has no
//   table, no division by bs and no table bytes: they are left out at
//   compile time. The query rows come by cp.async, issued first. Rows are
//   padded by 16 bytes (conflict-free ldmatrix) and zero past R and P, so
//   every loop runs to a fixed width (64 or 512 latent columns, 64 rope
//   features).
// - A request with more than one split writes fp32 partial (m, l, acc)
//   states that tc::mla_tc_combine_kernel merges -- one CTA per output row,
//   every partial's loads in flight at once, launched with programmatic
//   dependent launch. (Merging the splits in a thread-block cluster through
//   distributed shared memory, with 128-key splits, was slower: 0.0219 ms.)
// - Times at the minitron-4b-mla shape (H100 80GB HBM3 at 700 W, CUDA-graph
//   device ms a call, medians of chip_smoke.py --against the first
//   design): paged 0.0124, dense 0.0123, against 0.0268 when the dense form
//   ran the first design below. A dense variant that loaded each 32-key
//   step as 9 boxes of 32 rows x 64 features by 2-D TMA tensor maps
//   (128-byte swizzle in place of the row padding, rows past valid_len
//   zeroed before P.V) instead of 64 row copies was slower: 0.0128 against
//   0.0122 ms in one call, 0.0127 with the maps' descriptors prefetched.
//
// 2. fp32 (dense and paged): mla_split_kernel + mla_combine_kernel, the
//   first design, on the CUDA cores in fp32; only the fp32 gates run it.
//   - The key loop stops at valid_len, and the paged kernel reads block-table
//     entries only below ceil(valid_len / bs): the operations done are the
//     ones the request needs.
//   - The key axis is split across CTAs (flash-decoding): CTA (split, b, hg)
//     covers keys [split * split_len, (split + 1) * split_len) for HG heads
//     (HG in 4, 8, 16, chosen by the wrapper to pad H least), so that B = 8
//     rows still fill the 132 SMs; a second kernel merges the splits'
//     (m, l, acc), one CTA per output row.
//   - Latency: keys go through shared memory in tiles of TK = 32 rows
//     [ckv; kr], copied with cp.async and double-buffered, so the next tile's
//     rows are in flight while this one is used; the query rows are fetched
//     16 bytes a thread with every load issued before any is used; registers
//     are held to 128 a thread so that two CTAs share an SM.
//   - The accumulator is HG x R fp32 per CTA (16 x 512 x 4 B = 32 KB): too
//     large for one warp's registers, so it is spread over the whole CTA.
//     Thread t owns latent columns 2t and 2t + 1 for all HG heads (2 * HG
//     registers); R <= 512 = 2 * 256 threads.
//   - Per tile: (1) each scoring warp takes 32 / HG keys at a time; every lane
//     dots its 16-byte chunks of their rows with the HG query rows (in
//     shared memory), and one reduce-scatter of the warp's 32 (key, head)
//     partial sums (31 shuffles) leaves lane L with score L. (2) one warp per
//     head updates m and l over the tile and turns the scores into
//     probabilities. (3) each thread rescales its accumulator columns and adds
//     p * ckv over the tile's keys, the probabilities read as float4
//     broadcasts and the ckv rows from the same shared-memory tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_RANK = 512;
constexpr int MAX_ROPE = 64;
constexpr int MAX_D = MAX_RANK + MAX_ROPE;
constexpr int COLS = 2;  // latent columns each thread accumulates
constexpr int TK = 32;   // keys per tile: one lane per key in the softmax pass
static_assert(THREADS * COLS == MAX_RANK, "one column pair per thread");

struct Params {
  const void* q_lat;       // (B, H, R)
  const void* q_rope;      // (B, H, P)
  const void* ckv;         // dense (B, L, R) | paged (Pg, bs, R)
  const void* kr;          // dense (B, L, P) | paged (Pg, bs, P)
  const int* valid_len;    // (B,)
  const int* block_tables; // (B, nb), paged only
  void* out;               // (B, H, R), q's dtype
  float* lse;              // (B, H) log-sum-exp, or null
  float* part_m;           // (B, n_split, H), n_split > 1 only
  float* part_l;           // (B, n_split, H)
  float* part_acc;         // (B, n_split, H, R)
  int B, H, R, P;
  int L;                   // logical key extent: dense L, or nb * bs
  int bs, nb;              // paged only
  int split_len, n_split;
  float scale;
};

constexpr int VN = 4;  // floats per 16-byte load

// lse of a merged state (max in natural-log units, sum of exponentials)
__device__ __forceinline__ float merged_lse(float mx, float sum) {
  return sum > 0.f ? mx + logf(sum) : -INFINITY;
}

// the four floats of a 16-byte load
__device__ __forceinline__ void to_float(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// 16-byte asynchronous copy global -> shared; copies zeros when !full
__device__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// One step of a reduce-scatter of 32 values over the warp: lanes with bit
// HALF set keep the upper HALF values, the others the lower, each adding its
// partner's copy of the half it keeps. After the steps 16, 8, 4, 2, 1, lane
// L holds the warp's sum of value L. HALF is a template argument so that
// every index into s is a constant and s stays in registers (a loop over
// the steps left s[] in local memory); the selection is an explicit selp,
// since a ?: between two elements of s becomes a load through a selected
// address, which has the same effect.
template <int HALF>
__device__ __forceinline__ void reduce_scatter_step(float (&s)[32], int lane) {
  const int up = lane & HALF;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    float send, keep;
    asm("{\n .reg .pred q;\n setp.ne.s32 q, %4, 0;\n selp.f32 %0, %2, %3, q;\n"
        " selp.f32 %1, %3, %2, q;\n}"
        : "=f"(send), "=f"(keep) : "f"(s[i]), "f"(s[i + HALF]), "r"(up));
    s[i] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
  }
}

__device__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Copy the rows [ckv; kr] of keys [t0, t0 + TK) of request b into the
// shared-memory tile `dst` (TK, R + P) with cp.async, as one commit group:
// warp w takes keys w, w + 8, ..., each lane 16-byte chunks of them; keys at
// or past s1 read as zeros.
template <bool PAGED>
__device__ __forceinline__ void issue_tile(const Params& p, float* dst, int b, int t0, int s1) {
  constexpr int CH = (MAX_D / VN + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = p.R + p.P, nch = D / VN, rch = p.R / VN;
  const float* ckv = static_cast<const float*>(p.ckv);
  const float* kr = static_cast<const float*>(p.kr);
#pragma unroll
  for (int jj = 0; jj < TK / WARPS; ++jj) {
    const int j = warp + WARPS * jj, pos = t0 + j;
    const bool ok = pos < s1;
    long long row = 0;
    if (ok) {
      if (PAGED) {
        const int page = p.block_tables[(long long)b * p.nb + pos / p.bs];
        row = (long long)page * p.bs + pos % p.bs;
      } else {
        row = (long long)b * p.L + pos;
      }
    }
#pragma unroll
    for (int cc = 0; cc < CH; ++cc) {
      const int c = lane + 32 * cc;
      if (c < nch)
        cp_async16(dst + j * D + c * VN,
                   c < rch ? ckv + row * p.R + c * VN : kr + row * p.P + (c - rch) * VN, ok);
    }
  }
  cp_async_commit();
}

template <int HG>
constexpr size_t smem_bytes(int R, int P) {
  return (2 * (size_t)TK + HG) * (R + P) * sizeof(float) + (size_t)TK * HG * sizeof(float);
}

template <bool PAGED, int HG>
__global__ void __launch_bounds__(THREADS, 2) mla_split_kernel(Params p) {
  constexpr int CH = (MAX_D / VN + 31) / 32;  // 16-byte chunks of a key row per lane
  constexpr int KG = 32 / HG;                 // keys per warp step: KG * HG = 32 scores
  constexpr int PW = WARPS < TK / KG ? WARPS : TK / KG;  // warps that score
  constexpr int NG = TK / (PW * KG);          // warp steps per tile
  constexpr int QCH = (HG * (MAX_D / VN) + THREADS - 1) / THREADS;
  static_assert(KG * HG == 32 && NG * PW * KG == TK, "HG must divide 32");

  const int split = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * HG;
  const int nh = min(HG, p.H - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = min(p.valid_len[b], p.L);
  const int s0 = split * p.split_len;
  const int s1 = min(s0 + p.split_len, n);
  const int D = p.R + p.P;
  const int nch = D / VN, rch = p.R / VN;
  const int col = tid * COLS;
  const bool own = col < p.R;

  if (s0 >= s1) {  // no key of this request falls in this split; the
                   // combine pass reads only splits below ceil(n / split_len)
    if (p.n_split == 1 && own) {
      for (int g = 0; g < nh; ++g) {
        float* o = static_cast<float*>(p.out) + ((long long)b * p.H + h0 + g) * p.R + col;
        o[0] = 0.f;
        o[1] = 0.f;
      }
    }
    if (p.n_split == 1 && p.lse && tid < nh) p.lse[(long long)b * p.H + h0 + tid] = -INFINITY;
    return;
  }

  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);           // (2, TK, D) rows [ckv; kr]
  // (HG, nch, 4): query rows, chunk-major so that lane i's float4 reads of
  // chunk i are consecutive (no bank conflicts)
  float* sq = reinterpret_cast<float*>(kt + 2 * TK * D);
  float* ss = sq + HG * D;                               // (TK, HG) scores, then p
  __shared__ float s_m[HG], s_l[HG], s_corr[HG];

  issue_tile<PAGED>(p, kt, b, s0, s1);

  {  // the HG query rows, 16 bytes a thread, all loads issued before any is used
    const float* ql = static_cast<const float*>(p.q_lat) + ((long long)b * p.H + h0) * p.R;
    const float* qr = static_cast<const float*>(p.q_rope) + ((long long)b * p.H + h0) * p.P;
    uint4 raw[QCH];
#pragma unroll
    for (int k = 0; k < QCH; ++k) {
      const int i = tid + k * THREADS, g = i / nch, c = i - g * nch;
      raw[k] = make_uint4(0, 0, 0, 0);  // heads past H score 0 and are never written
      if (g < nh)
        raw[k] = c < rch ? __ldg(reinterpret_cast<const uint4*>(ql + g * p.R) + c)
                         : __ldg(reinterpret_cast<const uint4*>(qr + g * p.P) + (c - rch));
    }
    float4* sq4 = reinterpret_cast<float4*>(sq);
#pragma unroll
    for (int k = 0; k < QCH; ++k) {
      const int i = tid + k * THREADS, g = i / nch, c = i - g * nch;
      if (g < HG) {
        float f[VN];
        to_float(raw[k], f);
        sq4[g * nch + c] = make_float4(f[0], f[1], f[2], f[3]);
      }
    }
    if (tid < HG) {
      s_m[tid] = -INFINITY;
      s_l[tid] = 0.f;
    }
  }

  const float4* sq4 = reinterpret_cast<const float4*>(sq);
  float acc[HG][COLS];
#pragma unroll
  for (int g = 0; g < HG; ++g) {
    acc[g][0] = 0.f;
    acc[g][1] = 0.f;
  }

  for (int t = 0, t0 = s0; t0 < s1; ++t, t0 += TK) {
    const int nt = min(TK, s1 - t0);
    // the next tile's copies fly while this one is used; its buffer was last
    // read before the previous iteration's final barrier
    if (t0 + TK < s1) {
      issue_tile<PAGED>(p, kt + ((t + 1) & 1) * TK * D, b, t0 + TK, s1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tile = kt + (t & 1) * TK * D;

    // (1) scores: each scoring warp takes KG keys at a time; the 32 partial
    // (key, head) dot products of a lane's chunks, then one reduce-scatter
    if (warp < PW) {
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        const int kw = (warp * NG + gi) * KG;  // first key of this warp step in the tile
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int ch = lane + 32 * c;
          if (ch >= nch) continue;  // diverges only in the last chunk
          float kf[KG][VN];
#pragma unroll
          for (int j = 0; j < KG; ++j)
            to_float(reinterpret_cast<const uint4*>(tile + (kw + j) * D)[ch], kf[j]);
#pragma unroll
          for (int g = 0; g < HG; ++g) {
            const float4 q4 = sq4[g * nch + ch];
            const float qf[VN] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
            for (int j = 0; j < KG; ++j) {
              float d = s[j * HG + g];
#pragma unroll
              for (int e = 0; e < VN; ++e) d = fmaf(qf[e], kf[j][e], d);
              s[j * HG + g] = d;
            }
          }
        }
        reduce_scatter_step<16>(s, lane);  // lane L ends with score L = j * HG + g
        reduce_scatter_step<8>(s, lane);
        reduce_scatter_step<4>(s, lane);
        reduce_scatter_step<2>(s, lane);
        reduce_scatter_step<1>(s, lane);
        ss[kw * HG + lane] = (kw + lane / HG < nt) ? s[0] * p.scale : -INFINITY;
      }
    }
    __syncthreads();

    // (2) online softmax over the tile, one warp per head, one lane per key
    for (int g = warp; g < HG; g += WARPS) {
      const float x = ss[lane * HG + g];
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, warp_max(x));  // finite: key t0 is valid
      const float e = expf(x - m_new);
      ss[lane * HG + g] = e;
      const float sum = warp_sum(e);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s_corr[g] = corr;
        s_l[g] = s_l[g] * corr + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    // (3) acc = acc * corr + p . ckv over the tile's valid keys
    if (own) {
#pragma unroll
      for (int g = 0; g < HG; ++g) {
        const float corr = s_corr[g];
        acc[g][0] *= corr;
        acc[g][1] *= corr;
      }
      for (int j = 0; j < nt; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(tile + j * D + col);
        const float4* pj = reinterpret_cast<const float4*>(ss + j * HG);
#pragma unroll
        for (int g4 = 0; g4 < HG / 4; ++g4) {
          const float4 w = pj[g4];
          acc[4 * g4 + 0][0] = fmaf(w.x, v.x, acc[4 * g4 + 0][0]);
          acc[4 * g4 + 0][1] = fmaf(w.x, v.y, acc[4 * g4 + 0][1]);
          acc[4 * g4 + 1][0] = fmaf(w.y, v.x, acc[4 * g4 + 1][0]);
          acc[4 * g4 + 1][1] = fmaf(w.y, v.y, acc[4 * g4 + 1][1]);
          acc[4 * g4 + 2][0] = fmaf(w.z, v.x, acc[4 * g4 + 2][0]);
          acc[4 * g4 + 2][1] = fmaf(w.z, v.y, acc[4 * g4 + 2][1]);
          acc[4 * g4 + 3][0] = fmaf(w.w, v.x, acc[4 * g4 + 3][0]);
          acc[4 * g4 + 3][1] = fmaf(w.w, v.y, acc[4 * g4 + 3][1]);
        }
      }
    }
    __syncthreads();  // ss and this tile's buffer are rewritten next
  }

  if (own) {
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      if (g >= nh) continue;
      const long long hrow = (long long)b * p.H + h0 + g;
      if (p.n_split == 1) {
        const float inv = 1.f / fmaxf(s_l[g], 1e-30f);
        float* o = static_cast<float*>(p.out) + hrow * p.R + col;
        o[0] = acc[g][0] * inv;
        o[1] = acc[g][1] * inv;
      } else {
        float* pa = p.part_acc +
                    (((long long)b * p.n_split + split) * p.H + h0 + g) * p.R + col;
        pa[0] = acc[g][0];
        pa[1] = acc[g][1];
      }
    }
  }
  if (p.n_split > 1 && tid < nh) {
    const long long i = ((long long)b * p.n_split + split) * p.H + h0 + tid;
    p.part_m[i] = s_m[tid];
    p.part_l[i] = s_l[tid];
  }
  if (p.n_split == 1 && p.lse && tid < nh)
    p.lse[(long long)b * p.H + h0 + tid] = merged_lse(s_m[tid], s_l[tid]);
}

// Sum (max) of v over the CTA; every thread gets the result.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  v = MAX ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : (MAX ? -INFINITY : 0.f);
    v = MAX ? warp_max(v) : warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// Merge the n_split partial states of one output row (b, h): one CTA per
// row; each split's m and l are read once into shared memory, then its
// weight; threads over the latent.
__global__ void mla_combine_kernel(Params p) {
  extern __shared__ float sh[];  // (2, n_split): m then l, then (n_split,) weights in m's place
  __shared__ float red[32];
  float* sm = sh;
  float* sl = sh + p.n_split;
  const int row = blockIdx.x;   // b * H + h
  const int b = row / p.H, h = row % p.H;
  const long long base = (long long)b * p.n_split;
  // only the splits that hold keys of this request wrote a partial state
  const int n = min(p.valid_len[b], p.L);
  const int n_used = min(p.n_split, (n + p.split_len - 1) / p.split_len);

  float mx = -INFINITY;
  for (int s = threadIdx.x; s < n_used; s += blockDim.x) {
    const float m = p.part_m[(base + s) * p.H + h];
    sm[s] = m;
    sl[s] = p.part_l[(base + s) * p.H + h];
    mx = fmaxf(mx, m);
  }
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int s = threadIdx.x; s < n_used; s += blockDim.x) {
    const float ws = expf(sm[s] - mx);
    sm[s] = ws;
    sum = fmaf(sl[s], ws, sum);
  }
  sum = block_reduce<false>(sum, red);  // its barriers also publish the weights

  float* out = static_cast<float*>(p.out) + (long long)row * p.R;
  const float* acc = p.part_acc + (base * p.H + h) * p.R;
  const long long stride = (long long)p.H * p.R;  // one split to the next
  for (int d = threadIdx.x; d < p.R; d += blockDim.x) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_used; ++s) a = fmaf(sm[s], acc[s * stride + d], a);
    out[d] = a / fmaxf(sum, 1e-30f);
  }
  if (p.lse && threadIdx.x == 0) p.lse[row] = merged_lse(mx, sum);
}

// ---------------------------------------------------------------------------
// 1. bf16 dense and paged on the tensor cores
namespace tc {

using namespace sm90;
using bf16 = __nv_bfloat16;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WK = 32;                 // keys a step: two m16 tiles of the scores
constexpr int KT = WK / 16;
constexpr int STAGES = 2;              // slots in the CTA's ring of key steps: a 64-key split
constexpr int PMAX = MAX_ROPE;         // rope features, zero-padded to this width
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Row of key pos of request b in the (rows, R) / (rows, P) caches. Dense:
// b * L + pos. Paged: page table[pos / bs - first], row pos % bs, where
// `table` holds the request's block-table entries from entry `first` on (a
// copy in shared memory).
template <bool PAGED>
__device__ __forceinline__ long long key_row(const Params& p, const int* table, int first, int b,
                                             int pos) {
  if constexpr (PAGED)
    return (long long)table[pos / p.bs - first] * p.bs + pos % p.bs;
  else
    return (long long)b * p.L + pos;
}

// Shared memory of mla_tc_split_kernel<RMAX, NH> (HG = 8 NH heads): rows
// [ckv | kr] RMAX + PMAX wide (zero past R and past P) padded by 8 elements:
// the HG query rows, then STAGES slots of WK key rows; each warp's
// probabilities P^T (HG x WK, padded by 8); the warps' partial scores (two
// rounds); then, paged only, the split's block-table entries (table_bytes).
template <int RMAX, int NH>
struct Smem {
  static constexpr int HG = 8 * NH;
  static constexpr int LDK = RMAX + PMAX + 8;
  static constexpr int LDP = WK + 8;
  static constexpr size_t Q = (size_t)HG * LDK * 2;
  static constexpr size_t RING = (size_t)STAGES * WK * LDK * 2;
  static constexpr size_t P = (size_t)WARPS * HG * LDP * 2;
  static constexpr size_t XS = (size_t)2 * WARPS * KT * NH * 32 * 16;
  static constexpr size_t BYTES = Q + RING + P + XS;
};

// bytes of the block-table copy of a split of split_len keys
__host__ __device__ inline size_t table_bytes(int split_len, int bs) {
  return (size_t)(split_len / bs + 2) * 4;
}
constexpr int MAX_SMEM = 200 * 1024;  // the dynamic shared memory a split CTA may ask for

// grid (n_split, B, ceil(H / HG)); R <= RMAX, P <= PMAX, multiples of 8
template <int RMAX, int NH, bool PAGED>
__global__ void __launch_bounds__(THREADS) mla_tc_split_kernel(Params p) {
  using Sm = Smem<RMAX, NH>;
  constexpr int HG = Sm::HG, LDK = Sm::LDK, LDP = Sm::LDP;
  constexpr int KS = (RMAX + PMAX) / 16;   // k16 steps of a score
  constexpr int KSW = KS / WARPS;          // ... that each warp takes
  constexpr int MT = RMAX / 16 / WARPS;    // latent m16 tiles of each warp's context
  static_assert(KS % WARPS == 0 && MT >= 1, "widths");
  const int split = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * HG;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = lane >> 2, c0 = (lane & 3) * 2;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the combine may start
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* const smem = tc_smem;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + Sm::Q);
  bf16* sP = reinterpret_cast<bf16*>(smem + Sm::Q + Sm::RING) + warp * HG * LDP;
  float4* xs = reinterpret_cast<float4*>(smem + Sm::Q + Sm::RING + Sm::P);  // (2, WARPS, KT, NH, 32)
  int* table = reinterpret_cast<int*>(smem + Sm::BYTES);  // paged only
  __shared__ __align__(8) uint64_t bar[STAGES];
  const uint4 zero = make_uint4(0, 0, 0, 0);
  constexpr int CW = (RMAX + PMAX) / 8;  // 16-byte chunks of a row

  // the query rows [q_lat | q_rope] by cp.async (heads past H and columns
  // past R, P zero), in flight while valid_len and the table are read
  {
    const bf16* ql = static_cast<const bf16*>(p.q_lat) + ((long long)b * p.H + h0) * p.R;
    const bf16* qr = static_cast<const bf16*>(p.q_rope) + ((long long)b * p.H + h0) * p.P;
    for (int e = tid; e < HG * CW; e += THREADS) {
      const int g = e / CW, c = 8 * (e % CW);
      bf16* dst = sQ + g * LDK + c;
      const bool live = h0 + g < p.H;
      if (live && c < p.R)
        cp_async16(dst, ql + g * p.R + c, true);
      else if (live && c >= RMAX && c - RMAX < p.P)
        cp_async16(dst, qr + g * p.P + c - RMAX, true);
      else
        *reinterpret_cast<uint4*>(dst) = zero;
    }
    cp_async_commit();
  }
  const int s0 = split * p.split_len;
  int first = 0;  // the split's first block-table entry
  const int vl = p.valid_len[b];
  if constexpr (PAGED) {
    // the block-table entries the split can touch, read while valid_len is
    first = s0 / p.bs;
    if (warp == 0) {
      const int* bt = p.block_tables + (long long)b * p.nb;
      const int last = min(p.nb - 1, (s0 + p.split_len - 1) / p.bs);
      for (int j = lane; j <= last - first; j += 32) table[j] = bt[first + j];
    }
  }
  const int n = min(vl, p.L);
  const int s1 = min(s0 + p.split_len, n);
  const int n_used = (n + p.split_len - 1) / p.split_len;  // splits with keys of b
  if (s0 >= s1) {  // no key of this request here; only n <= 0 leaves split 0 empty
    if (split == 0) {
      for (int i = tid; i < HG * p.R; i += THREADS) {
        const int g = i / p.R;
        if (h0 + g < p.H)
          static_cast<bf16*>(p.out)[((long long)b * p.H + h0) * p.R + i] = __float2bfloat16(0.f);
      }
      if (p.lse && tid < HG && h0 + tid < p.H) p.lse[(long long)b * p.H + h0 + tid] = -INFINITY;
    }
    cp_async_wait<0>();
    return;
  }
  const bool direct = n_used == 1;
  const bf16* ckv = static_cast<const bf16*>(p.ckv);
  const bf16* kr = static_cast<const bf16*>(p.kr);
  const int steps = (s1 - s0 + WK - 1) / WK;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  // the ring's columns past R and P, once (the copies write the others)
  if (p.R < RMAX || p.P < PMAX)
    for (int e = tid; e < STAGES * WK * CW; e += THREADS) {
      const int r = e / CW, c = 8 * (e % CW);
      if ((c >= p.R && c < RMAX) || c >= RMAX + p.P)
        *reinterpret_cast<uint4*>(ring + r * LDK + c) = zero;
    }
  __syncthreads();  // the barriers are initialised (paged: the table entries read)

  // step i (keys s0 + WK i + [0, WK)) -> slot i % STAGES, by every warp:
  // lane r < 8 of warp w copies the ckv part of row 8 w + r, lane 8 + r its
  // kr part, one TMA bulk copy each; a key past s1 copies key s1 - 1 instead
  // (masked below)
  static_assert(WK == 8 * WARPS, "eight key rows a warp");
  auto load = [&](int i) {
    const int slot = i % STAGES, r = 8 * warp + (lane & 7);
    if (tid == 0) mbar_expect_tx(&bar[slot], WK * (p.R + p.P) * sizeof(bf16));
    fence_proxy_async();  // the slot's last reads (step i - STAGES) come first
    const long long row = key_row<PAGED>(p, table, first, b, min(s0 + i * WK + r, s1 - 1));
    bf16* dst = ring + (slot * WK + r) * LDK;
    if (lane < 8)
      bulk_copy(dst, ckv + row * p.R, p.R * sizeof(bf16), &bar[slot]);
    else if (lane < 16)
      bulk_copy(dst + RMAX, kr + row * p.P, p.P * sizeof(bf16), &bar[slot]);
  };
  for (int i = 0; i < STAGES && i < steps; ++i) load(i);  // every slot is free
  cp_async_wait<0>();
  __syncthreads();  // the query rows, from every thread's copies

  // this warp's B fragments of Q^T (k = features, n = heads): k16 steps
  // warp, warp + WARPS, ...
  uint32_t qf[KSW][NH][2];
#pragma unroll
  for (int jj = 0; jj < KSW; ++jj)
#pragma unroll
    for (int nt = 0; nt < NH; ++nt)
      ldsm_x2(qf[jj][nt],
              sQ + (8 * nt + (lane & 7)) * LDK + 16 * (warp + WARPS * jj) + ((lane >> 3) & 1) * 8);

  const float sl2 = p.scale * LOG2E;  // scores in log2 units
  float m[NH][2], l[NH][2];
  float acc[MT][NH][4];
#pragma unroll
  for (int nt = 0; nt < NH; ++nt) {
    m[nt][0] = m[nt][1] = -INFINITY;
    l[nt][0] = l[nt][1] = 0.f;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) acc[mi][nt][0] = acc[mi][nt][1] = acc[mi][nt][2] = acc[mi][nt][3] = 0.f;
  }

  for (int i = 0; i < steps; ++i) {
    const int slot = i % STAGES;
    mbar_wait(&bar[slot], (i / STAGES) & 1);  // step i has landed
    const bf16* kt = ring + slot * WK * LDK;
    // ---- S^T (keys x heads, KT m16 tiles of keys) over this warp's
    // features, then the sum of the warps' partials
    float s[KT][NH][4];
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int nt = 0; nt < NH; ++nt) s[t][nt][0] = s[t][nt][1] = s[t][nt][2] = s[t][nt][3] = 0.f;
#pragma unroll
    for (int jj = 0; jj < KSW; ++jj)
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        uint32_t a[4];
        ldsm_x4(a, kt + (16 * t + (lane & 15)) * LDK + 16 * (warp + WARPS * jj) + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < NH; ++nt) mma(s[t][nt], a, qf[jj][nt][0], qf[jj][nt][1]);
      }
    float4* xr = xs + (i & 1) * WARPS * KT * NH * 32;
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int nt = 0; nt < NH; ++nt)
        xr[((warp * KT + t) * NH + nt) * 32 + lane] =
            make_float4(s[t][nt][0], s[t][nt][1], s[t][nt][2], s[t][nt][3]);
    // every warp's partial is written, and every warp is done with step i - 1
    // and its slot
    asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
    if (i > 0 && i - 1 + STAGES < steps) load(i - 1 + STAGES);
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int nt = 0; nt < NH; ++nt) {
        s[t][nt][0] = s[t][nt][1] = s[t][nt][2] = s[t][nt][3] = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const float4 v = xr[((w * KT + t) * NH + nt) * 32 + lane];
          s[t][nt][0] += v.x;
          s[t][nt][1] += v.y;
          s[t][nt][2] += v.z;
          s[t][nt][3] += v.w;
        }
      }
    // ---- online softmax down each head's column of WK keys
    const int base = s0 + i * WK;
    float corr[NH][2];
#pragma unroll
    for (int nt = 0; nt < NH; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x[KT][2], mx = -INFINITY;
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          x[t][0] = base + 16 * t + r0 < s1 ? s[t][nt][e] * sl2 : -INFINITY;
          x[t][1] = base + 16 * t + r0 + 8 < s1 ? s[t][nt][2 + e] * sl2 : -INFINITY;
          mx = fmaxf(mx, fmaxf(x[t][0], x[t][1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float mn = fmaxf(m[nt][e], mx);  // finite: key base is valid
        corr[nt][e] = exp2f(m[nt][e] - mn);
        m[nt][e] = mn;
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          const float p0 = exp2f(x[t][0] - mn), p1 = exp2f(x[t][1] - mn);
          sum += p0 + p1;
          // P^T (heads x keys) for the context's B operand, rounded once to bf16
          sP[(8 * nt + c0 + e) * LDP + 16 * t + r0] = __float2bfloat16(p0);
          sP[(8 * nt + c0 + e) * LDP + 16 * t + r0 + 8] = __float2bfloat16(p1);
        }
        l[nt][e] = l[nt][e] * corr[nt][e] + sum;  // this lane's share
      }
    }
    __syncwarp();
    uint32_t pb[KT][NH][2];
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int nt = 0; nt < NH; ++nt)
        ldsm_x2(pb[t][nt], sP + (8 * nt + (lane & 7)) * LDP + 16 * t + ((lane >> 3) & 1) * 8);
    // ---- O^T (latent x heads) = O^T * corr + V^T P^T over this warp's latent tiles
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int nt = 0; nt < NH; ++nt) {
        acc[mi][nt][0] *= corr[nt][0];
        acc[mi][nt][1] *= corr[nt][1];
        acc[mi][nt][2] *= corr[nt][0];
        acc[mi][nt][3] *= corr[nt][1];
      }
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        uint32_t va[4];
        ldsm_x4_t(va, kt + (16 * t + (lane >> 4) * 8 + (lane & 7)) * LDK + 16 * (warp * MT + mi) +
                          ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int nt = 0; nt < NH; ++nt) mma(acc[mi][nt], va, pb[t][nt][0], pb[t][nt][1]);
      }
    }
    __syncwarp();  // sP is rewritten next step
  }
#pragma unroll
  for (int nt = 0; nt < NH; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[nt][e] += __shfl_xor_sync(0xffffffffu, l[nt][e], 4);
      l[nt][e] += __shfl_xor_sync(0xffffffffu, l[nt][e], 8);
      l[nt][e] += __shfl_xor_sync(0xffffffffu, l[nt][e], 16);
    }

  // ---- every warp holds the same (m, l) and its own latent rows: write them
  const long long part = (long long)b * p.n_split + split;
#pragma unroll
  for (int nt = 0; nt < NH; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int g = h0 + 8 * nt + c0 + e;
      if (g >= p.H) continue;
      const float inv = 1.f / fmaxf(l[nt][e], 1e-30f);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int d = 16 * (warp * MT + mi) + r0 + 8 * hh;
          if (d >= p.R) continue;
          const float v = acc[mi][nt][2 * hh + e];
          if (direct)
            static_cast<bf16*>(p.out)[((long long)b * p.H + g) * p.R + d] = __float2bfloat16(v * inv);
          else
            p.part_acc[(part * p.H + g) * p.R + d] = v;
        }
      if (!direct && warp == 0 && r0 == 0) {
        p.part_m[part * p.H + g] = m[nt][e] * LN2;  // natural-log units
        p.part_l[part * p.H + g] = l[nt][e];
      }
      if (direct && p.lse && warp == 0 && r0 == 0)
        p.lse[(long long)b * p.H + g] = merged_lse(m[nt][e] * LN2, l[nt][e]);
    }
}

constexpr int COMBINE_THREADS = 128;  // 4 columns a thread: R <= 512
constexpr int COMBINE_UNROLL = 16;    // up to this many splits, all loads in flight at once

// Merge the partial states of one output row (b, h) of a request with more
// than one split: one CTA per row, 4 columns a thread. Launched with
// programmatic stream serialization it may start while the split kernel
// runs; griddepcontrol.wait holds it until the partials are written.
__global__ void __launch_bounds__(COMBINE_THREADS) mla_tc_combine_kernel(Params p) {
  const int row = blockIdx.x;  // b * H + h
  const int b = row / p.H, h = row - b * p.H;
  const int d = 4 * threadIdx.x;
  const int n = min(p.valid_len[b], p.L);
  const int n_used = min(p.n_split, (n + p.split_len - 1) / p.split_len);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (n_used <= 1 || d >= p.R) return;  // one split wrote the row itself
  const long long first = (long long)b * p.n_split;
  auto acc_at = [&](int s) {
    return __ldcg(reinterpret_cast<const float4*>(p.part_acc + ((first + s) * p.H + h) * p.R + d));
  };
  float mx = -INFINITY, sum = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n_used <= COMBINE_UNROLL) {
    // every load in flight at once: splits past n_used read the last one again,
    // and weigh 0
    float ms[COMBINE_UNROLL], ls[COMBINE_UNROLL];
    float4 a[COMBINE_UNROLL];
#pragma unroll
    for (int s = 0; s < COMBINE_UNROLL; ++s) {
      const int t = min(s, n_used - 1);
      ms[s] = __ldcg(p.part_m + (first + t) * p.H + h);
      ls[s] = __ldcg(p.part_l + (first + t) * p.H + h);
      a[s] = acc_at(t);
      mx = fmaxf(mx, ms[s]);
    }
#pragma unroll
    for (int s = 0; s < COMBINE_UNROLL; ++s) {
      const float w = s < n_used ? expf(ms[s] - mx) : 0.f;
      sum = fmaf(w, ls[s], sum);
      o.x = fmaf(w, a[s].x, o.x);
      o.y = fmaf(w, a[s].y, o.y);
      o.z = fmaf(w, a[s].z, o.z);
      o.w = fmaf(w, a[s].w, o.w);
    }
  } else {
    for (int s = 0; s < n_used; ++s) mx = fmaxf(mx, __ldcg(p.part_m + (first + s) * p.H + h));
    for (int s = 0; s < n_used; ++s) {
      const float w = expf(__ldcg(p.part_m + (first + s) * p.H + h) - mx);
      const float4 a = acc_at(s);
      sum = fmaf(w, __ldcg(p.part_l + (first + s) * p.H + h), sum);
      o.x = fmaf(w, a.x, o.x);
      o.y = fmaf(w, a.y, o.y);
      o.z = fmaf(w, a.z, o.z);
      o.w = fmaf(w, a.w, o.w);
    }
  }
  const float inv = 1.f / fmaxf(sum, 1e-30f);
  *reinterpret_cast<uint2*>(static_cast<bf16*>(p.out) + (long long)row * p.R + d) =
      make_uint2(pack(o.x * inv, o.y * inv), pack(o.z * inv, o.w * inv));
  if (p.lse && threadIdx.x == 0) p.lse[row] = merged_lse(mx, sum);
}

template <int RMAX, int NH, bool PAGED>
int launch_rn(const Params& p, cudaStream_t stream) {
  using Sm = Smem<RMAX, NH>;
  // above 48 KB a kernel's dynamic shared memory must be opted into, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      mla_tc_split_kernel<RMAX, NH, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  size_t smem = Sm::BYTES;
  if constexpr (PAGED) smem += table_bytes(p.split_len, p.bs);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const dim3 grid(p.n_split, p.B, (p.H + Sm::HG - 1) / Sm::HG);
  mla_tc_split_kernel<RMAX, NH, PAGED><<<grid, THREADS, smem, stream>>>(p);
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
  return (int)cudaLaunchKernelEx(&cfg, mla_tc_combine_kernel, p);
}

// hg: heads a CTA, 8, 16 or 24 (the wrapper's head_group over TC_HEAD_GROUPS)
template <int RMAX, bool PAGED>
int launch_r(const Params& p, int hg, cudaStream_t stream) {
  switch (hg) {
    case 8: return launch_rn<RMAX, 1, PAGED>(p, stream);
    case 16: return launch_rn<RMAX, 2, PAGED>(p, stream);
    case 24: return launch_rn<RMAX, 3, PAGED>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool PAGED>
int launch(const Params& p, int hg, cudaStream_t stream) {
  if (p.R > MAX_RANK || p.P > PMAX || p.R % 8 || p.P % 8 || p.split_len % WK)
    return (int)cudaErrorInvalidValue;
  return p.R <= 64 ? launch_r<64, PAGED>(p, hg, stream)
                   : launch_r<MAX_RANK, PAGED>(p, hg, stream);
}

}  // namespace tc

// 2. fp32 on the first design
template <bool PAGED, int HG>
int launch_split(const Params& p, cudaStream_t stream) {
  // above 48 KB a kernel's dynamic shared memory must be opted into, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      mla_split_kernel<PAGED, HG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<HG>(MAX_RANK, MAX_ROPE));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(p.n_split, p.B, (p.H + HG - 1) / HG);
  mla_split_kernel<PAGED, HG><<<grid, THREADS, smem_bytes<HG>(p.R, p.P), stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool PAGED>
int launch_f32(const Params& p, int hg, cudaStream_t stream) {
  if (p.R > MAX_RANK || p.P > MAX_ROPE || p.R % VN || p.P % VN) return (int)cudaErrorInvalidValue;
  int err;
  if (hg == 4) {
    err = launch_split<PAGED, 4>(p, stream);
  } else if (hg == 8) {
    err = launch_split<PAGED, 8>(p, stream);
  } else if (hg == 16) {
    err = launch_split<PAGED, 16>(p, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || p.n_split == 1) return err;
  mla_combine_kernel<<<p.B * p.H, 128, 2 * p.n_split * sizeof(float), stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

#define MLA_DECODE_LAUNCHER(NAME, LAUNCH)                                                    \
  extern "C" int NAME(const void* q_lat, const void* q_rope, const void* ckv, const void* kr, \
                      const void* valid_len, const void* block_tables, void* out, void* lse,  \
                      void* part_m, void* part_l, void* part_acc, int B, int H, int R, int P, \
                      int L, int bs, int nb, int split_len, int n_split, int hg, float scale, \
                      void* stream) {                                                        \
    Params p;                                                                                \
    p.q_lat = q_lat;                                                                         \
    p.q_rope = q_rope;                                                                       \
    p.ckv = ckv;                                                                             \
    p.kr = kr;                                                                               \
    p.valid_len = static_cast<const int*>(valid_len);                                        \
    p.block_tables = static_cast<const int*>(block_tables);                                  \
    p.out = out;                                                                             \
    p.lse = static_cast<float*>(lse);                                                        \
    p.part_m = static_cast<float*>(part_m);                                                  \
    p.part_l = static_cast<float*>(part_l);                                                  \
    p.part_acc = static_cast<float*>(part_acc);                                              \
    p.B = B;                                                                                 \
    p.H = H;                                                                                 \
    p.R = R;                                                                                 \
    p.P = P;                                                                                 \
    p.L = L;                                                                                 \
    p.bs = bs;                                                                               \
    p.nb = nb;                                                                               \
    p.split_len = split_len;                                                                 \
    p.n_split = n_split;                                                                     \
    p.scale = scale;                                                                         \
    return LAUNCH(p, hg, static_cast<cudaStream_t>(stream));                                 \
  }

MLA_DECODE_LAUNCHER(mla_latent_decode_f32, launch_f32<false>)
MLA_DECODE_LAUNCHER(mla_latent_decode_bf16, tc::launch<false>)
MLA_DECODE_LAUNCHER(mla_paged_latent_decode_f32, launch_f32<true>)
MLA_DECODE_LAUNCHER(mla_paged_latent_decode_bf16, tc::launch<true>)
