// What the ring-attention forward (attention.cu) and backward
// (attention_bwd.cu) share, and with them their forms for head dims above
// 256 (attention_wide.cu, attention_bwd_wide.cu): the geometry of a launch,
// the ring-order walks of a query tile over the K/V tiles and of a K/V
// tile over the query tiles, cp.async staging of bf16 (swizzled) and
// float32 (padded) tiles, the online-softmax fold of a tile's scores, the
// backward's P and dS of a score entry, and the float32 fragment helpers of
// the TF32 products.  The backward runs one warpgroup (or four warps) per
// block, the forward several; the staging loops take the block's thread
// count.
#pragma once

#include <math.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kThreads = 128;  // one warpgroup, or four warps
constexpr float kMasked = -1e30f;  // pallas_attention.py:109
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Geo {
  const int* groups;  // [ngroups, g] world ranks in ring order
  int g, hq, hkv, sb;
  float scale;
  int causal;
};

// a block of rank r and q-tile [q0, q0 + qrows) (the forward, attn_bwd_dq):
// arrivals a = 0, 1, ... (block (r - a) mod g; under causal only blocks
// <= r), then k-tiles of `rows` rows (on the diagonal up to the one holding
// the tile's last row)
struct DqWalk {
  int nk, first, total;
  __device__ DqWalk(const Geo& geo, int r, int q0, int qrows, int rows) {
    nk = (geo.sb + rows - 1) / rows;
    first = geo.causal ? min(nk, (q0 + qrows - 1) / rows + 1) : nk;
    total = first + ((geo.causal ? r + 1 : geo.g) - 1) * nk;
  }
  __device__ void at(int i, int& arr, int& kt) const {
    if (i < first) {
      arr = 0; kt = i;
      return;
    }
    i -= first;
    arr = 1 + i / nk; kt = i % nk;
  }
};

// attn_bwd_dkv, block of owner j and k-tile k0: arrivals a = 0, 1, ... (rank
// (j + a) mod g; under causal only ranks >= j), the GQA heads in increasing
// order, then q-tiles of `rows` rows (on the diagonal from the first that
// reaches k0)
struct DkvWalk {
  int nq, qs, first, per, total;
  __device__ DkvWalk(const Geo& geo, int j, int k0, int rows) {
    const int rep = geo.hq / geo.hkv;
    nq = (geo.sb + rows - 1) / rows;
    qs = geo.causal ? k0 / rows : 0;
    first = rep * (nq - qs);
    per = rep * nq;
    total = first + ((geo.causal ? geo.g - j : geo.g) - 1) * per;
  }
  __device__ void at(int i, int& arr, int& t, int& qt) const {
    if (i < first) {
      arr = 0; t = i / (nq - qs); qt = qs + i % (nq - qs);
      return;
    }
    i -= first;
    arr = 1 + i / per; i %= per;
    t = i / nq; qt = i % nq;
  }
};

// -- the forms above d = 256 (attention_wide.cu, attention_bwd_wide.cu) -----------
constexpr int kChunk = 128;  // the output chunk: columns of an output a block owns

// acc (an m64n64 accumulator) += A B^T over one KC-column d-chunk (KC 64 or
// 128): KC / 16 m64n64k16 wgmmas with A and B swizzled 64 x KC bf16 tiles
// read K-major (at a and b), summed on the tensor core into a fresh
// accumulator, which is then added to acc (or, for the first chunk, is acc)
// by round-to-nearest float32 adds.  The tensor core's sums round toward
// zero (mma_3xtf32, hopper.cuh): one chain over the whole of a wide d would
// drift, a chunk's chain is no longer than the d = 128 kernels' one.
template <int KC = kChunk>
__device__ __forceinline__ void chunk_product(float (&acc)[32], uint32_t a, uint32_t b,
                                              bool first) {
  float p[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) p[e] = 0.f;
  reg_fence(p);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks) {
    const uint32_t off = (ks / 4) * (64 * 128) + (ks % 4) * 32;
    wgmma_m64n64k16_ss(p, desc_kmajor(a + off), desc_kmajor(b + off));
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(p);
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = first ? p[e] : acc[e] + p[e];
}

// a block of the forward or attn_bwd_dq: x = (q-tile, output chunk c), the
// heaviest blocks first (the last rank of a group, its last q-tile), y =
// query head, z = (group, rank)
struct QueryBlock {
  int c, qt, r, h, kvh;
  const int* G;
  long long row0;  // the first row of the rank's query head
  __device__ QueryBlock(const Geo& geo, int nd) {
    c = blockIdx.x % nd;
    qt = gridDim.x / nd - 1 - blockIdx.x / nd;
    r = geo.g - 1 - blockIdx.z % geo.g;
    G = geo.groups + blockIdx.z / geo.g * geo.g;
    h = blockIdx.y;
    kvh = h / (geo.hq / geo.hkv);
    row0 = ((long long)G[r] * geo.hq + h) * geo.sb;
  }
  // the first row of arrival arr's k-tile kt of `rows` rows
  __device__ long long kv_row(const Geo& geo, int arr, int kt, int rows) const {
    const int jb = (r - arr + geo.g) % geo.g;
    return ((long long)G[jb] * geo.hkv + kvh) * geo.sb + (long long)kt * rows;
  }
};

// a block of attn_bwd_dkv: x = (k-tile, output chunk c), y = K/V head,
// z = (group, owner j)
struct KvBlock {
  int c, kt, j, kvh, rep;
  const int* G;
  long long kv_row0;  // the first row of the owner's K/V head
  __device__ KvBlock(const Geo& geo, int nd) {
    c = blockIdx.x % nd;
    kt = blockIdx.x / nd;
    j = blockIdx.z % geo.g;
    G = geo.groups + (blockIdx.z - j);
    kvh = blockIdx.y;
    rep = geo.hq / geo.hkv;
    kv_row0 = ((long long)G[j] * geo.hkv + kvh) * geo.sb;
  }
  // the first row of GQA head t of the rank that arrival arr visits
  __device__ long long q_row(const Geo& geo, int arr, int t) const {
    const int r = (j + arr) % geo.g;
    return ((long long)G[r] * geo.hq + kvh * rep + t) * geo.sb;
  }
};

// -- staging ------------------------------------------------------------------
// rows [0, R) of a row-major [*, D] bf16 block into a swizzled tile, zeros
// beyond `valid` rows (NT threads copy)
template <int R, int D, int NT = kThreads>
__device__ __forceinline__ void stage_bf16(uint8_t* dst, const bf16* src, int valid) {
  constexpr int C = D / 8;
  for (int idx = threadIdx.x; idx < R * C; idx += NT) {
    const int r = idx / C, c = (idx % C) * 8;
    const bool ok = r < valid;
    cp_async16(dst + sw128_offset(r, c, R), ok ? src + (long long)r * D + c : src, ok);
  }
}
// rows [0, R) of a row-major [*, D] float32 block into a tile of row stride
// D + 4, zeros beyond `valid` rows (NT threads copy)
template <int R, int D, int NT = kThreads>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int valid) {
  constexpr int C = D / 4;
  for (int idx = threadIdx.x; idx < R * C; idx += NT) {
    const int r = idx / C, c = (idx % C) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * (D + 4) + c, ok ? src + (long long)r * D + c : src, ok);
  }
}

// The forms above d = 256 stage column chunks of a row-major [*, ld] block,
// ld the head dim at run time (the d <= 256 kernels keep the two above,
// whose row stride is their compile-time D): rows [0, R) of the C columns
// that start at src into a swizzled [R x C] bf16 tile, or into a float32
// tile of row stride C + 4, zeros beyond `valid` rows (NT threads copy)
template <int R, int C, int NT>
__device__ __forceinline__ void stage_bf16_cols(uint8_t* dst, const bf16* src, long long ld,
                                                int valid) {
  constexpr int CC = C / 8;
  for (int idx = threadIdx.x; idx < R * CC; idx += NT) {
    const int r = idx / CC, c = (idx % CC) * 8;
    const bool ok = r < valid;
    cp_async16(dst + sw128_offset(r, c, R), ok ? src + r * ld + c : src, ok);
  }
}
template <int R, int C, int NT>
__device__ __forceinline__ void stage_f32_cols(float* dst, const float* src, long long ld,
                                               int valid) {
  constexpr int CC = C / 4;
  for (int idx = threadIdx.x; idx < R * CC; idx += NT) {
    const int r = idx / CC, c = (idx % CC) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * (C + 4) + c, ok ? src + r * ld + c : src, ok);
  }
}
// N float32 values (lse or delta of a tile's rows), zeros beyond `valid`
// (a multiple of 8)
template <int N>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int valid) {
  for (int idx = threadIdx.x; idx < N / 4; idx += kThreads) {
    const bool ok = 4 * idx < valid;
    cp_async16(dst + 4 * idx, ok ? src + 4 * idx : src, ok);
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// -- the softmax of a tile ----------------------------------------------------------
// One tile's scores (NC groups of 8 columns in the m16n8 accumulator layout:
// s[n][2i + c] = S[row g + 8i][8n + 2t + c]) folded into the online-softmax
// state of the thread's two rows, in place: s becomes P = 2^(x - m'), where
// x = S scale log2(e), or -1e30 where the diagonal block masks it, or -inf
// past the block's rows; m (log2 units) and l are updated and alpha =
// 2^(m - m') is what the O accumulator must be rescaled by.
template <int NC>
__device__ __forceinline__ void fold_scores(float (&s)[NC][4], float (&m)[2], float (&l)[2],
                                            float (&alpha)[2], int qi0, int kj0, int sb,
                                            bool diag, float scale2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = qi0 + 8 * (e >> 1), kj = kj0 + 8 * n + (e & 1);
      float x = s[n][e] * scale2;
      if (kj >= sb) x = -INFINITY;            // past the block's rows
      else if (diag && kj > qi) x = kMasked;  // _causal_mask
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    alpha[i] = exp2f(m[i] - m_new);  // 0 on the first tile (m = -inf)
    m[i] = m_new;
  }
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[n][e] - m[e >> 1]);
      s[n][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    l[i] = l[i] * alpha[i] + sum[i];
  }
}

// P and dS of one score entry, in place (s: the raw product, dp: dO.V)
__device__ __forceinline__ void grad_entry(float& s, float& dp, float lse, float delta,
                                           float scale, bool masked) {
  const float p = masked ? 0.f : expf(s * scale - lse);
  s = p;
  dp = p * (dp - delta) * scale;
}

// -- float32 fragments of m16n8k8 -------------------------------------------------
// A fragment of a 16-row strip (rows 16w.., columns c0 and c0 + 4), split
__device__ __forceinline__ void frag_rows(const float* strip, int ld, int g4, int c0,
                                          Tf32x2 (&a)[4]) {
  a[0] = split(strip[g4 * ld + c0]);
  a[1] = split(strip[(g4 + 8) * ld + c0]);
  a[2] = split(strip[g4 * ld + c0 + 4]);
  a[3] = split(strip[(g4 + 8) * ld + c0 + 4]);
}
// an m16n8 accumulator as the A operand of the next product, k permuted
// (k = t <-> column 2t, k = t + 4 <-> column 2t + 1), split
__device__ __forceinline__ void frag_acc(const float (&c)[4], Tf32x2 (&a)[4]) {
  a[0] = split(c[0]);
  a[1] = split(c[2]);
  a[2] = split(c[1]);
  a[3] = split(c[3]);
}

// -- launches -------------------------------------------------------------------
template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

Geo make_geo(const void* groups, int g, int hq, int hkv, int sb, float scale, int causal) {
  Geo geo;
  geo.groups = static_cast<const int*>(groups);
  geo.g = g; geo.hq = hq; geo.hkv = hkv; geo.sb = sb;
  geo.scale = scale; geo.causal = causal;
  return geo;
}

constexpr int kBadShape = 1000;  // a head dim or dtype the kernels were not built for

}  // namespace
