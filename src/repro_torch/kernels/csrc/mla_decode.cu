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
// What bounds it on this card: operations. Every key costs
// 2 * H * (R + P + R) flops (scores over R + P features, context over R)
// against (R + P) * elem bytes: at H = 24, R = 512, P = 64 in bf16 that is
// about 45 flops per byte. The kernel does its products on the CUDA cores
// in fp32 (no tensor cores), which keep up with only ~20 flops per byte of
// HBM bandwidth, so its FMAs, not its bytes, bound it -- once the loads'
// latency is hidden, which is what most of the design is about.
//
// What the design does about it:
// - The key loop stops at valid_len, and the paged kernel reads block-table
//   entries only below ceil(valid_len / bs): the operations done are the
//   ones the request needs.
// - The key axis is split across CTAs (flash-decoding): CTA (split, b, hg)
//   covers keys [split * split_len, (split + 1) * split_len) for HG heads
//   (HG in 4, 8, 16, chosen by the wrapper to pad H least), so that B = 8
//   rows still fill the 132 SMs; a second kernel merges the splits'
//   (m, l, acc), one CTA per output row.
// - Latency: keys go through shared memory in tiles of TK = 32 rows
//   [ckv; kr], copied with cp.async and double-buffered, so the next tile's
//   rows are in flight while this one is used; the query rows are fetched
//   16 bytes a thread with every load issued before any is used; registers
//   are held to 128 a thread so that two CTAs share an SM.
// - The accumulator is HG x R fp32 per CTA (16 x 512 x 4 B = 32 KB): too
//   large for one warp's registers, so it is spread over the whole CTA.
//   Thread t owns latent columns 2t and 2t + 1 for all HG heads (2 * HG
//   registers); R <= 512 = 2 * 256 threads.
// - Per tile: (1) each scoring warp takes 32 / HG keys at a time; every lane
//   dots its 16-byte chunks of their rows with the HG query rows (fp32 in
//   shared memory), and one reduce-scatter of the warp's 32 (key, head)
//   partial sums (31 shuffles) leaves lane L with score L. (2) one warp per
//   head updates m and l over the tile and turns the scores into
//   probabilities. (3) each thread rescales its accumulator columns and adds
//   p * ckv over the tile's keys, the probabilities read as float4
//   broadcasts and the ckv rows from the same shared-memory tile.
// - p stays fp32 in the P.V product at bf16 too; the JAX model casts the
//   probabilities to the cache dtype first (models/mla.py:_attend_absorbed).
// - The next redesign: the two products as mma.sync / wgmma over
//   (heads x 576) . (576 x keys) tiles, which moves the bound to the bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  float* part_m;           // (B, n_split, H), n_split > 1 only
  float* part_l;           // (B, n_split, H)
  float* part_acc;         // (B, n_split, H, R)
  int B, H, R, P;
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
  __device__ static float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
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
  __device__ static float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
};

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
template <typename T, bool PAGED>
__device__ __forceinline__ void issue_tile(const Params& p, T* dst, int b, int t0, int s1) {
  constexpr int VN = Vec<T>::N;
  constexpr int CH = (MAX_D / VN + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = p.R + p.P, nch = D / VN, rch = p.R / VN;
  const T* ckv = static_cast<const T*>(p.ckv);
  const T* kr = static_cast<const T*>(p.kr);
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

template <typename T, int HG>
constexpr size_t smem_bytes(int R, int P) {
  return 2 * (size_t)TK * (R + P) * sizeof(T) + (size_t)HG * (R + P) * sizeof(float) +
         (size_t)TK * HG * sizeof(float);
}

template <typename T, bool PAGED, int HG>
__global__ void __launch_bounds__(THREADS, 2) mla_split_kernel(Params p) {
  using V = Vec<T>;
  constexpr int VN = V::N;
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
        T* o = static_cast<T*>(p.out) + ((long long)b * p.H + h0 + g) * p.R + col;
        V::store1(o, 0.f);
        V::store1(o + 1, 0.f);
      }
    }
    return;
  }

  extern __shared__ float4 smem4[];
  T* kt = reinterpret_cast<T*>(smem4);                   // (2, TK, D) rows [ckv; kr]
  // (HG, VN / 4, nch, 4): query rows in fp32, chunk-major so that lane i's
  // float4 reads of chunk i are consecutive (no bank conflicts)
  float* sq = reinterpret_cast<float*>(kt + 2 * TK * D);
  float* ss = sq + HG * D;                               // (TK, HG) scores, then p
  __shared__ float s_m[HG], s_l[HG], s_corr[HG];

  issue_tile<T, PAGED>(p, kt, b, s0, s1);

  {  // the HG query rows, 16 bytes a thread, all loads issued before any is used
    const T* ql = static_cast<const T*>(p.q_lat) + ((long long)b * p.H + h0) * p.R;
    const T* qr = static_cast<const T*>(p.q_rope) + ((long long)b * p.H + h0) * p.P;
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
        V::to_float(raw[k], f);
#pragma unroll
        for (int h4 = 0; h4 < VN / 4; ++h4)
          sq4[(g * (VN / 4) + h4) * nch + c] =
              make_float4(f[4 * h4], f[4 * h4 + 1], f[4 * h4 + 2], f[4 * h4 + 3]);
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
      issue_tile<T, PAGED>(p, kt + ((t + 1) & 1) * TK * D, b, t0 + TK, s1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tile = kt + (t & 1) * TK * D;

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
            V::to_float(reinterpret_cast<const uint4*>(tile + (kw + j) * D)[ch], kf[j]);
#pragma unroll
          for (int g = 0; g < HG; ++g) {
            float qf[VN];
#pragma unroll
            for (int h4 = 0; h4 < VN / 4; ++h4) {
              const float4 q4 = sq4[(g * (VN / 4) + h4) * nch + ch];
              qf[4 * h4 + 0] = q4.x;
              qf[4 * h4 + 1] = q4.y;
              qf[4 * h4 + 2] = q4.z;
              qf[4 * h4 + 3] = q4.w;
            }
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
        const float2 v = V::load2(tile + j * D + col);
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
        T* o = static_cast<T*>(p.out) + hrow * p.R + col;
        V::store1(o, acc[g][0] * inv);
        V::store1(o + 1, acc[g][1] * inv);
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
template <typename T>
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

  T* out = static_cast<T*>(p.out) + (long long)row * p.R;
  const float* acc = p.part_acc + (base * p.H + h) * p.R;
  const long long stride = (long long)p.H * p.R;  // one split to the next
  for (int d = threadIdx.x; d < p.R; d += blockDim.x) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_used; ++s) a = fmaf(sm[s], acc[s * stride + d], a);
    Vec<T>::store1(out + d, a / fmaxf(sum, 1e-30f));
  }
}

template <typename T, bool PAGED, int HG>
int launch_split(const Params& p, cudaStream_t stream) {
  // above 48 KB a kernel's dynamic shared memory must be opted into, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      mla_split_kernel<T, PAGED, HG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<T, HG>(MAX_RANK, MAX_ROPE));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(p.n_split, p.B, (p.H + HG - 1) / HG);
  mla_split_kernel<T, PAGED, HG>
      <<<grid, THREADS, smem_bytes<T, HG>(p.R, p.P), stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool PAGED>
int launch(const Params& p, int hg, cudaStream_t stream) {
  if (p.R > MAX_RANK || p.P > MAX_ROPE || p.R % Vec<T>::N || p.P % Vec<T>::N)
    return (int)cudaErrorInvalidValue;
  int err;
  if (hg == 4) {
    err = launch_split<T, PAGED, 4>(p, stream);
  } else if (hg == 8) {
    err = launch_split<T, PAGED, 8>(p, stream);
  } else if (hg == 16) {
    err = launch_split<T, PAGED, 16>(p, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || p.n_split == 1) return err;
  mla_combine_kernel<T><<<p.B * p.H, 128, 2 * p.n_split * sizeof(float), stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

#define MLA_DECODE_LAUNCHER(NAME, T, PAGED)                                                  \
  extern "C" int NAME(const void* q_lat, const void* q_rope, const void* ckv, const void* kr, \
                      const void* valid_len, const void* block_tables, void* out,             \
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
    return launch<T, PAGED>(p, hg, static_cast<cudaStream_t>(stream));                       \
  }

MLA_DECODE_LAUNCHER(mla_latent_decode_f32, float, false)
MLA_DECODE_LAUNCHER(mla_latent_decode_bf16, __nv_bfloat16, false)
MLA_DECODE_LAUNCHER(mla_paged_latent_decode_f32, float, true)
MLA_DECODE_LAUNCHER(mla_paged_latent_decode_bf16, __nv_bfloat16, true)
