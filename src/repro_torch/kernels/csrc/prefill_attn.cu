// Causal GQA flash-attention forward for prefill, for Hopper (sm_90a), bf16.
//
// Replaces no Pallas kernel: the JAX package computes prefill attention in
// jnp, and this is the counterpart of its blocked branch,
//   src/repro/models/flash.py:flash_attention (_flash_fwd_impl),
// which src/repro/models/flash.py:attention_prefill_auto takes for long
// prompts. For each request b and query head h = kh * G + g at position
// qpos, over keys kpos < L with kpos <= qpos (and qpos - kpos < window when
// window > 0):
//   s = scale * q.k (bf16 products summed in fp32), then
//   s = softcap * tanh(s / softcap) when softcap > 0, then the mask;
//   online softmax in fp32 (running max m and sum l); the unnormalised
//   probabilities exp(s - m) rounded to bf16 for P.V, summed in fp32; one
//   division by l at the end, the output rounded to bf16.
// A row with no key gives 0. Dk == Dv == D, D in {64, 128, 256}.
//
// What bounds it on this card: operations. A layer does 2 (Dk + Dv) H
// multiply-adds for every (query, key) pair it attends, S (S + 1) / 2 pairs
// for a causal prompt of S tokens: minitron-4b at S = 4096 does 103 GFLOP
// over 25 MB of q, k, v and output, ~4 000 operations a byte, far above the
// ~295 at which an H100 stops being bound by memory. The design:
// - Both products on the tensor cores (mma.sync.m16n8k16, bf16 in, fp32
//   accumulators in registers), in the FlashAttention-2 register layout: the
//   score accumulators of two adjacent n8 tiles, packed to bf16, are the A
//   operand of P.V, so P never leaves registers; the running max and sum take
//   two quad shuffles a row. Q and K come through ldmatrix, V through
//   ldmatrix.trans, from rows padded by 16 bytes (conflict-free).
// - One block takes BM query rows of one (request, KV head): the G query
//   heads of that KV head are packed into the rows (row i is position i / G,
//   head kh * G + i % G), so each K/V tile is read once for the whole group
//   and the tile spans only BM / G positions (less of it masked on the
//   diagonal). Each warp owns MT m16 tiles of rows; the block streams 64-key
//   K/V tiles through a two-stage cp.async ring in shared memory, the next
//   tile in flight while one is reduced.
// - Only the key tiles some row of the block attends are visited: tiles
//   wholly above the diagonal or wholly before the window are skipped, and
//   only tiles that cross the diagonal, the window's edge or L are masked
//   (one block-uniform test a tile); the others run without a compare.
// - The grid is ordered longest rows first (the last row tile of every
//   (request, KV head) is scheduled first), so the causal triangle's short
//   tiles fill the card's 132 SMs at the end instead of leaving a tail.
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90_mma.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BN = 64;       // keys a K/V tile
constexpr int STAGES = 2;    // K/V tiles in flight

// 2^x on the special-function unit (2 ulp; -inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Params {
  const bf16* q;  // (B, S, H, D)
  const bf16* k;  // (B, L, KV, D)
  const bf16* v;  // (B, L, KV, D)
  bf16* out;      // (B, S, H, D)
  int B, S, L, H, KV, D;
  float scale, softcap;
  int window;
};

// warps a block, m16 tiles of query rows a warp, blocks an SM (registers:
// the accumulators of MT x 16 rows x D columns and of MT x 16 x BN scores)
template <int D>
struct Shape;
template <>
struct Shape<64> {
  static constexpr int WARPS = 4, MT = 2, MIN_BLOCKS = 2;
};
template <>
struct Shape<128> {
  static constexpr int WARPS = 4, MT = 2, MIN_BLOCKS = 2;
};
template <>
struct Shape<256> {
  static constexpr int WARPS = 8, MT = 1, MIN_BLOCKS = 1;
};

template <int D>
__host__ __device__ constexpr int block_rows() {
  return 16 * Shape<D>::MT * Shape<D>::WARPS;
}

// Shared memory: the block's BM query rows (later its output rows), then
// STAGES K tiles and STAGES V tiles of BN rows, every row D + 8 wide.
template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(block_rows<D>() + 2 * STAGES * BN) * (D + 8) * sizeof(bf16);
}

// grid (n_tiles * B * KV): block x takes row tile n_tiles - 1 - x / (B * KV)
// of (request, KV head) x % (B * KV). CAPPED: the scores go through the
// softcap (a template flag, so that the loop without one has no tanh).
template <int D, bool CAPPED>
__global__ void __launch_bounds__(Shape<D>::WARPS * 32, Shape<D>::MIN_BLOCKS)
    prefill_attn_kernel(Params p) {
  constexpr int WARPS = Shape<D>::WARPS, MT = Shape<D>::MT, BM = block_rows<D>();
  constexpr int THREADS = WARPS * 32, LD = D + 8, CH = D / 8;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char pa_smem[];
  bf16* const sQ = reinterpret_cast<bf16*>(pa_smem);
  bf16* const sK = sQ + BM * LD;
  bf16* const sV = sK + STAGES * BN * LD;

  const int G = p.H / p.KV, R = p.S * G;  // query rows of one (request, KV head)
  const int bkv = p.B * p.KV, n_tiles = (R + BM - 1) / BM;
  const int tile = n_tiles - 1 - (int)(blockIdx.x / bkv);
  const int bk = blockIdx.x % bkv, b = bk / p.KV, kh = bk % p.KV;
  const int r_begin = tile * BM, r_end = min(r_begin + BM, R);
  const int p_first = r_begin / G, p_last = (r_end - 1) / G;  // the tile's positions
  // the keys some row of the tile attends: [k_lo, k_hi]
  const int k_hi = min(p_last, p.L - 1);
  const int k_lo = p.window > 0 ? max(0, p_first - p.window + 1) : 0;
  const int t_hi = k_hi / BN, t_lo = k_lo / BN;
  const int n_kt = k_hi >= k_lo ? t_hi - t_lo + 1 : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // element offset of query (and output) row i of this (request, KV head)
  auto row_offset = [&](int i) -> long long {
    const int pos = i / G;
    return (((long long)b * p.S + pos) * p.H + kh * G + (i - pos * G)) * D;
  };
  // the query rows (rows past R zero)
  for (int e = tid; e < BM * CH; e += THREADS) {
    const int r = e / CH, c = e % CH, i = r_begin + r;
    bf16* dst = sQ + r * LD + 8 * c;
    if (i < R)
      cp_async16(dst, p.q + row_offset(i) + 8 * c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();
  // the loop's step j visits keys (t_hi - j) * BN + [0, BN), through stage
  // j % STAGES; keys past L are zero (and masked)
  auto load_kv = [&](int j) {
    const int k0 = (t_hi - j) * BN;
    bf16* dk = sK + (j % STAGES) * BN * LD;
    bf16* dv = sV + (j % STAGES) * BN * LD;
    for (int e = tid; e < BN * CH; e += THREADS) {
      const int r = e / CH, c = e % CH, kpos = k0 + r;
      const bool in = kpos < p.L;
      const long long off = (((long long)b * p.L + (in ? kpos : 0)) * p.KV + kh) * D + 8 * c;
      cp_async16(dk + r * LD + 8 * c, p.k + off, in);
      cp_async16(dv + r * LD + 8 * c, p.v + off, in);
    }
    cp_async_commit();
  };
  if (n_kt > 0) load_kv(0);

  const int r0 = lane >> 2, c0 = (lane & 3) * 2;  // accumulator rows r0, r0 + 8
  const int wrow = warp * MT * 16;                 // the warp's first row in the tile
  int qpos[MT][2];                                 // positions of this thread's rows
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) qpos[mi][h] = (r_begin + wrow + mi * 16 + r0 + 8 * h) / G;
  // scores s times `mul` are in log2 units: uncapped, the raw product (the
  // scale is folded into the exponent's multiply-add); CAPPED, softcap *
  // tanh(s * scale / softcap) in log2 units
  const float mul = CAPPED ? 1.f : p.scale * LOG2E;
  const float cap_l2 = p.softcap * LOG2E, cap_in = CAPPED ? p.scale / p.softcap : 0.f;
  float m[MT][2], l[MT][2], o[MT][D / 8][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    m[mi][0] = m[mi][1] = -INFINITY;
    l[mi][0] = l[mi][1] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[mi][j][0] = o[mi][j][1] = o[mi][j][2] = o[mi][j][3] = 0.f;
  }

  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) {
      load_kv(j + 1);
      cp_async_wait<1>();  // the query and step j have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies
    const bf16* tk = sK + (j % STAGES) * BN * LD;
    const bf16* tv = sV + (j % STAGES) * BN * LD;
    const int k0 = (t_hi - j) * BN;

    // S = Q K^T: MT m16 tiles of rows by BN / 8 n8 tiles of keys
    float s[MT][BN / 8][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int t = 0; t < BN / 8; ++t) s[mi][t][0] = s[mi][t][1] = s[mi][t][2] = s[mi][t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldsm_x4(a[mi], sQ + (wrow + mi * 16 + (lane & 15)) * LD + 16 * kk + (lane >> 4) * 8);
#pragma unroll
      for (int nn = 0; nn < BN / 16; ++nn) {
        uint32_t kb[4];
        ldsm_x4(kb, tk + (16 * nn + (lane >> 4) * 8 + (lane & 7)) * LD + 16 * kk +
                        ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma(s[mi][2 * nn], a[mi], kb[0], kb[1]);
          mma(s[mi][2 * nn + 1], a[mi], kb[2], kb[3]);
        }
      }
    }
    // cap; mask only a tile that crosses the diagonal, the window's edge or
    // L for some row of the block
    const bool whole = k0 + BN - 1 <= p_first && k0 + BN <= p.L &&
                       (p.window == 0 || p_last - k0 < p.window);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int t = 0; t < BN / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = CAPPED ? cap_l2 * tanhf(s[mi][t][e] * cap_in) : s[mi][t][e];
          if (!whole) {
            const int kpos = k0 + 8 * t + c0 + (e & 1), pos = qpos[mi][e >> 1];
            if (kpos > pos || kpos >= p.L || (p.window > 0 && pos - kpos >= p.window))
              x = -INFINITY;
          }
          s[mi][t][e] = x;
        }
    // online softmax: rows r0 (elements 0, 1) and r0 + 8 (elements 2, 3)
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int t = 0; t < BN / 8; ++t) mx = fmaxf(mx, fmaxf(s[mi][t][2 * h], s[mi][t][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[mi][h], mx * mul);  // log2 units
        const float base = mn == -INFINITY ? 0.f : mn;  // a row with no key yet
        const float cr = ex2(m[mi][h] - base);
        m[mi][h] = mn;
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < BN / 8; ++t) {
          s[mi][t][2 * h] = ex2(fmaf(s[mi][t][2 * h], mul, -base));
          s[mi][t][2 * h + 1] = ex2(fmaf(s[mi][t][2 * h + 1], mul, -base));
          sum += s[mi][t][2 * h] + s[mi][t][2 * h + 1];
        }
        l[mi][h] = l[mi][h] * cr + sum;  // this lane's share of the row
#pragma unroll
        for (int d = 0; d < D / 8; ++d) {
          o[mi][d][2 * h] *= cr;
          o[mi][d][2 * h + 1] *= cr;
        }
      }
    // O += P V, 16 keys a step; P packed from the score accumulators
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        pa[mi][0] = pack(s[mi][2 * kk][0], s[mi][2 * kk][1]);
        pa[mi][1] = pack(s[mi][2 * kk][2], s[mi][2 * kk][3]);
        pa[mi][2] = pack(s[mi][2 * kk + 1][0], s[mi][2 * kk + 1][1]);
        pa[mi][3] = pack(s[mi][2 * kk + 1][2], s[mi][2 * kk + 1][3]);
      }
#pragma unroll
      for (int j2 = 0; j2 < D / 16; ++j2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, tv + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + 16 * j2 +
                          (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma(o[mi][2 * j2], pa[mi], vb[0], vb[1]);
          mma(o[mi][2 * j2 + 1], pa[mi], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with the stage before it is refilled
  }
  cp_async_wait<0>();  // the query's copies, where no key tile was visited

  // O / l, rounded to bf16, staged in the warp's own query rows, then
  // written 16 bytes a lane
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[mi][h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      bf16* row = sQ + (wrow + mi * 16 + r0 + 8 * h) * LD + c0;
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
        *reinterpret_cast<uint32_t*>(row + 8 * d) =
            pack(o[mi][d][2 * h] * inv, o[mi][d][2 * h + 1] * inv);
    }
  __syncwarp();
  for (int e = lane; e < MT * 16 * CH; e += 32) {
    const int r = e / CH, c = e % CH, i = r_begin + wrow + r;
    if (i < R)
      *reinterpret_cast<uint4*>(p.out + row_offset(i) + 8 * c) =
          *reinterpret_cast<const uint4*>(sQ + (wrow + r) * LD + 8 * c);
  }
}

template <int D, bool CAPPED>
int launch_d(const Params& p, cudaStream_t stream) {
  // above 48 KB a kernel's dynamic shared memory must be opted into, once
  static const cudaError_t attr =
      cudaFuncSetAttribute(prefill_attn_kernel<D, CAPPED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<D>());
  if (attr != cudaSuccess) return (int)attr;
  const long long tiles = ((long long)p.S * (p.H / p.KV) + block_rows<D>() - 1) / block_rows<D>();
  const long long blocks = tiles * p.B * p.KV;
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  prefill_attn_kernel<D, CAPPED>
      <<<(unsigned)blocks, Shape<D>::WARPS * 32, smem_bytes<D>(), stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool CAPPED>
int launch_c(const Params& p, cudaStream_t stream) {
  switch (p.D) {
    case 64: return launch_d<64, CAPPED>(p, stream);
    case 128: return launch_d<128, CAPPED>(p, stream);
    case 256: return launch_d<256, CAPPED>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int prefill_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                      int B, int S, int L, int H, int KV, int D, float scale,
                                      float softcap, int window, void* stream) {
  if (B < 0 || S < 0 || L < 0 || KV <= 0 || H % KV || window < 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.out = static_cast<bf16*>(out);
  p.B = B;
  p.S = S;
  p.L = L;
  p.H = H;
  p.KV = KV;
  p.D = D;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return softcap > 0.f ? launch_c<true>(p, s) : launch_c<false>(p, s);
}
