// What the ring-attention forward (attention.cu) and backward
// (attention_bwd.cu) share, and with them their forms for head dims above
// 256 (attention_wide.cu, attention_bwd_wide.cu): the geometry of a launch,
// the ring-order walks of a query tile over the K/V tiles and of a K/V
// tile over the query tiles, cp.async staging of float32 (padded) tiles,
// the online-softmax fold of a tile's scores, the backward's P and dS of a
// score entry, the float32 fragment helpers of the TF32 products, what the
// forms that run in thread-block clusters share (the cluster's size, its
// launch, the float32 tensor maps and output products), and what the bf16
// forward and backward at d <= 256 share (their shared memory, their TMA
// producer, the stepped walk of a query block, the tile product S = Q K^T,
// exponentials by ex2, the pin of an in-flight register operand).  The
// float32 forward runs several warpgroups of four warps (cp.async staging,
// its loops take the block's thread count); the backward at every d, the
// forms above d = 256 and the bf16 forward a producer and two consumer
// warpgroups.
#pragma once

#include <cuda.h>
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

// acc (an m64n64 accumulator) += A B^T over one 128-column d-chunk: eight
// m64n64k16 wgmmas with A and B swizzled 64 x 128 bf16 tiles read K-major
// (at a and b), summed on the tensor core into a fresh accumulator, which is
// then added to acc (or, for the first chunk, is acc) by round-to-nearest
// float32 adds.  The tensor core's sums round toward zero (mma_3xtf32,
// hopper.cuh): one chain over the whole of a wide d would drift, a chunk's
// chain is no longer than the d = 128 kernels' one.
__device__ __forceinline__ void chunk_product(float (&acc)[32], uint32_t a, uint32_t b,
                                              bool first) {
  float p[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) p[e] = 0.f;
  reg_fence(p);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kChunk / 16; ++ks) {
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
  // the [P Hkv] plane of arrival arr's K/V head (a tensor map's third
  // coordinate)
  __device__ int kv_plane(const Geo& geo, int arr) const {
    return G[(r - arr + geo.g) % geo.g] * geo.hkv + kvh;
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

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// -- the softmax of a tile ----------------------------------------------------------
// 2^x by ex2.approx (within 2 ulp; results below 2^-126 flush to 0); above
// 2^-126 exp2f's value (exp2f takes the same MUFU.EX2 there, and around it
// tests and scales for results below)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
template <bool Ex2>
__device__ __forceinline__ float pow2(float x) {
  if constexpr (Ex2) return ex2(x);
  else return exp2f(x);
}

// One tile's scores (NC groups of 8 columns in the m16n8 accumulator layout:
// s[n][2i + c] = S[row g + 8i][8n + 2t + c]) folded into the online-softmax
// state of the thread's two rows, in place: s becomes P = 2^(x - m'), where
// x = S scale log2(e), or -1e30 where the diagonal block masks it, or -inf
// past the block's rows; m (log2 units) and l are updated and alpha =
// 2^(m - m') is what the O accumulator must be rescaled by.  Masks = false
// is for a tile the caller knows to hold no masked entry and no column
// past the block's rows: the same values without the tests.  Ex2: the
// exponentials by ex2, not exp2f.
template <int NC, bool Masks = true, bool Ex2 = false>
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
      if constexpr (Masks) {
        if (kj >= sb) x = -INFINITY;            // past the block's rows
        else if (diag && kj > qi) x = kMasked;  // _causal_mask
      }
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    alpha[i] = pow2<Ex2>(m[i] - m_new);  // 0 on the first tile (m = -inf)
    m[i] = m_new;
  }
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = pow2<Ex2>(s[n][e] - m[e >> 1]);
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

// -- the thread-block cluster forms above d = 256 --------------------------------
// The forward (attention_wide.cu) and the backward (attention_bwd_wide.cu)
// in both dtypes run the C blocks of one (rank, head, own tile) as a
// cluster: each block forms the partial products of its own chunks of d,
// and every block sums the cluster's partials over distributed shared
// memory in rank order 0..C-1.
// The cluster at head dim D: C blocks, the largest divisor of D / 128 that
// is at most 8 (the portable cluster size), each taking M passes over its
// walk, one output chunk a pass
template <int D> struct WideCluster {
  static constexpr int ND = D / 128, C = ND % 8 == 0 ? 8 : ND % 7 == 0 ? 7 : ND % 6 == 0 ? 6 : ND % 5 == 0 ? 5 : ND % 4 == 0 ? 4 : ND % 3 == 0 ? 3 : ND % 2 == 0 ? 2 : 1, M = ND / C;
};
// its C at run time (nd = d / 128)
__host__ __device__ constexpr int cluster_blocks(int nd) {
  return nd % 8 == 0 ? 8 : nd % 7 == 0 ? 7 : nd % 6 == 0 ? 6 : nd % 5 == 0 ? 5 : nd % 4 == 0 ? 4
       : nd % 3 == 0 ? 3 : nd % 2 == 0 ? 2 : 1;
}
template <int ND = 3> constexpr bool clusters_agree() {
  if constexpr (ND > 64) {
    return true;
  } else {
    using Cluster = WideCluster<ND * 128>;
    return Cluster::C == cluster_blocks(ND) && Cluster::C * Cluster::M == ND &&
           clusters_agree<ND + 1>();
  }
}
static_assert(clusters_agree(), "WideCluster and cluster_blocks disagree");

// the threads of the float32 forms above d = 256 and of the bf16 backward
// (at every d): consumer warpgroups and a producer warpgroup that keeps
// their TMA loads in flight
constexpr int kConsumers = 256;                   // two consumer warpgroups
constexpr int kClusterThreads = kConsumers + 128;  // and a producer warpgroup
// registers a thread after setmaxnreg (an SM sub-partition holds one warp
// of each warpgroup: 40 + 2 x 232 of its 512 a lane)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kNoCluster = 1001;   // cudaOccupancyMaxActiveClusters found no room for a cluster
constexpr int kNoEncoder = 1002;   // the CUDA driver's cuTensorMapEncodeTiled was not found
constexpr int kBadMap = 1003;      // cuTensorMapEncodeTiled refused a tensor

// -- the bf16 forms at d <= 256 (attention.cu's forward, attention_bwd.cu's backward) --
// A producer warpgroup, one thread of which issues every TMA load, and two
// consumer warpgroups (kClusterThreads threads, no cluster; setmaxnreg
// moves the producers' registers to the consumers).  The block's shared
// memory, in the plan's order (1024-byte aligned, the swizzle's need): the
// own tiles, NS stages of the streamed tiles, the exchange region (dK/dV),
// the lse and delta rows of each stage (dK/dV), the mbarriers.
template <typename Plan>
struct Bf16Smem {
  uint8_t* own;        // [2][T x D]: Q and dO (dq), K and V (dkv); [T x D]: Q (the forward)
  uint8_t* stage;      // NS x [2][TS x D]: K and V (dq), Q and dO (dkv); K or V (the forward)
  uint8_t* xch;        // dkv at d = 256: P of two tile parities
  float* rows;         // NS x [2][TS]: lse and delta of a stage's q rows (dkv)
  uint64_t* full;      // [NS]: a stage's loads landed
  uint64_t* empty;     // [NS]: the consumers are done with a stage
  uint64_t* own_full;  // the own tiles landed
  __device__ explicit Bf16Smem(uint8_t* raw) {
    own = align1024(raw);
    stage = own + Plan::OWN;
    xch = stage + Plan::NS * Plan::STAGE;
    rows = reinterpret_cast<float*>(xch + Plan::XCH);
    full = reinterpret_cast<uint64_t*>(xch + Plan::XCH + Plan::NS * Plan::ROWS);
    empty = full + Plan::NS;
    own_full = empty + Plan::NS;
  }
  // one thread, before anything else
  __device__ void init() const {
    for (int s = 0; s < Plan::NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    mbar_init(own_full, 1);
    fence_mbar_init();
  }
};

// The producer: thread kConsumers loads the own tiles (`own`), then unit n
// of the walk into stage n % NS (`unit`) once the consumers have released
// the unit the stage held before.  (produce, above, also passes the
// cluster forms' barriers: these blocks have none.)
template <int NS, typename Own, typename Unit>
__device__ __forceinline__ void stream_tiles(int tiles, uint64_t* empty, Own own, Unit unit) {
  if (threadIdx.x != kConsumers) return;
  own();
  for (int n = 0; n < tiles; ++n) {
    const int s = n % NS;
    if (n >= NS) mbar_wait(empty + s, (n / NS - 1) & 1);
    unit(n, s);
  }
}

// v, opaque to the compiler: descriptors built from it are built again at
// each use, not hoisted out of the loop into registers
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// pins an A operand's registers (hi or lo fragments, bf16 or TF32) until
// here, the wait that retires the wgmma reading them: a wgmma reads its
// register operands after it is issued, and a value the compiler holds in
// them before its wait_group (the operand being dead once the wgmma is
// issued, as far as the compiler knows) is what the tensor core reads (a
// variant that loaded the next block's operands under a block's products
// came out wrong).  Every register-A operand in flight across other code
// is kept to its wait.
template <int K>
__device__ __forceinline__ void keep(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// acc (m64nN) = A B^T over d: A the warpgroup's 64 rows of an own tile of
// T rows (at a), B a streamed tile of N rows (at b), both K-major; one
// tensor-core chain over d
template <int D, int T, int N>
__device__ __forceinline__ void rows_product(float (&acc)[N / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint64_t da = desc_kmajor(opaque(a) + (ks / 4) * (T * 128) + (ks % 4) * 32);
    const uint64_t db = desc_kmajor(b + (ks / 4) * (N * 128) + (ks % 4) * 32);
    if constexpr (N == 128) wgmma_m64n128k16_ss(acc, da, db, ks > 0);
    else if constexpr (N == 64) wgmma_m64n64k16_ss(acc, da, db, ks > 0);
    else wgmma_m64n32k16_ss(acc, da, db, ks > 0);
  }
}

// The walk of a query block (DqWalk), stepped a tile at a time (DqWalk::at
// divides)
struct DqCursor {
  int arr = 0, kt = 0;
  __device__ void next(const DqWalk& w) {
    if (++kt < (arr == 0 ? w.first : w.nk)) return;
    kt = 0;
    ++arr;
  }
};

// P of a score entry, 2^(s scale log2(e) - lse log2(e)) by ex2, from
// scale2 = scale log2(e) and lse2 = lse log2(e); 0 where masked
__device__ __forceinline__ float prob(float s, float scale2, float lse2, bool masked) {
  const float p = ex2(s * scale2 - lse2);
  return masked ? 0.f : p;
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) x[e] = 0.f;
  reg_fence(x);
}

// word (row, col) of a float32 tile in the 128-byte swizzle (sw128_f32)
__device__ __forceinline__ float ld_f32(const uint8_t* tile, int row, int col, int rows) {
  return *reinterpret_cast<const float*>(tile + sw128_f32(row, col, rows));
}

// f (m64n64: 64 columns of a chunk from m0, by the T own rows) = A B^T over
// the tile's TS streamed rows: A = columns m0.. of the streamed tile at `s`
// transposed (split in registers), B the block's own T x TS tile (hi at
// bh, lo at bl); one chain of each kind
template <int TS>
__device__ __forceinline__ void output_half(float (&f)[32], const uint8_t* s, int m0, uint32_t bh,
                                            uint32_t bl, int w, int g4, int t4) {
  const int c0 = m0 + 16 * w + g4;
  uint32_t ah[TS / 8][4], al[TS / 8][4];
#pragma unroll
  for (int kk = 0; kk < TS / 8; ++kk) {
    const int r = 8 * kk + t4;
    const float x[4] = {ld_f32(s, r, c0, TS), ld_f32(s, r, c0 + 8, TS), ld_f32(s, r + 4, c0, TS),
                        ld_f32(s, r + 4, c0 + 8, TS)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Tf32x2 sp = split(x[e]);
      ah[kk][e] = sp.hi;
      al[kk][e] = sp.lo;
    }
  }
  float small[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) f[e] = small[e] = 0.f;
  reg_fence(f);
  reg_fence(small);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TS / 8; ++kk) {
    const uint64_t h = desc_kmajor(bh + kk * 32), l = desc_kmajor(bl + kk * 32);
    wgmma_m64n64k8_tf32(small, al[kk], h, kk > 0);
    wgmma_m64n64k8_tf32(small, ah[kk], l, 1);
    wgmma_m64n64k8_tf32(f, ah[kk], h, kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(f);
  reg_fence(small);
#pragma unroll
  for (int e = 0; e < 32; ++e) f[e] += small[e];
}

// A partial is the float32 accumulator of a block's product, NV float4s a
// thread, float4 j of the thread at `at + 128 j` of its slot
template <int NV>
__device__ __forceinline__ void store_partial(float* slot, const float (&f)[4 * NV], int at) {
#pragma unroll
  for (int j = 0; j < NV; ++j)
    reinterpret_cast<float4*>(slot)[at + 128 * j] =
        make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2], f[4 * j + 3]);
}

// entries (row, col) and (row, col + 1) of a T x TS B tile as hi and lo
template <int T>
__device__ __forceinline__ void put_split2(uint8_t* hi, uint8_t* lo, int row, int col, float x,
                                           float y) {
  const uint32_t off = sw128_f32(row, col, T);
  const Tf32x2 a = split(x), b = split(y);
  *reinterpret_cast<float2*>(hi + off) = make_float2(__uint_as_float(a.hi), __uint_as_float(b.hi));
  *reinterpret_cast<float2*>(lo + off) = make_float2(__uint_as_float(a.lo), __uint_as_float(b.lo));
}

// The producer warpgroup: one thread issues the loads.  Unit n = (tile nt,
// chunk u of the block's m) goes to stage n % NS; `own(n)` loads the own
// tiles of unit n (once at m = 1, every unit above), `unit(n, s)` the
// streamed tiles into stage s.  Every thread takes part in every cluster
// barrier, as late as the stages allow: before it fills a stage for tile
// nt it has passed barrier nt - 1 - lag.  At m = 1 the lag is LAG1, the
// tiles between the one whose outputs free tile nt's stage and tile nt:
// the backward's 1 (tile nt - 2's outputs); the forward's NS - 2 (tile
// nt - NS's output runs after its consumers arrive at the barrier of tile
// nt - NS + 1 and before they wait there, so a producer that arrived only
// after filling that stage would wait on the output run beside it).  Above
// m = 1, where a tile's later units reuse stages of its own earlier ones,
// 0.
template <int NS, int LAG1, typename Own, typename Unit>
__device__ __forceinline__ void produce(int tiles, int m, uint64_t* full, uint64_t* empty,
                                        uint64_t* own_full, uint64_t* own_empty, Own own,
                                        Unit unit) {
  const bool lead = threadIdx.x == kConsumers;
  const int lag = m == 1 ? LAG1 : 0;
  int done = 0;
  if (lead && m == 1) own(0);
  for (int nt = 0; nt < tiles; ++nt) {
    for (; done < nt - lag; ++done) cluster_sync();
    if (lead) {
      for (int u = 0; u < m; ++u) {
        const int n = nt * m + u, s = n % NS;
        if (m > 1) {
          if (n > 0) mbar_wait(own_empty, (n - 1) & 1);
          own(n);
        }
        if (n >= NS) mbar_wait(empty + s, (n / NS - 1) & 1);
        unit(n, s);
      }
    }
    __syncwarp();
  }
  for (; done < tiles; ++done) cluster_sync();
  cluster_sync();  // the consumers' last one
}

// lo = x - hi of the BLOCKS 32-column blocks from `first` of a streamed TS
// x 128 tile into a tile of the same layout (hi is x itself, as the tensor
// core reads it); one warpgroup
template <int TS, int BLOCKS>
__device__ __forceinline__ void write_lo(uint8_t* dst, const uint8_t* src, int first, int t) {
  const int base = first * TS * 8;  // the float4s of the blocks before `first`
  for (int i = t; i < BLOCKS * TS * 8; i += 128) {
    float4 x = reinterpret_cast<const float4*>(src)[base + i];
    x.x -= __uint_as_float(__float_as_uint(x.x) & 0xFFFFE000u);
    x.y -= __uint_as_float(__float_as_uint(x.y) & 0xFFFFE000u);
    x.z -= __uint_as_float(__float_as_uint(x.z) & 0xFFFFE000u);
    x.w -= __uint_as_float(__float_as_uint(x.w) & 0xFFFFE000u);
    reinterpret_cast<float4*>(dst)[base + i] = x;
  }
}

// The tensor core's TF32 sums lose bits with every product a chain adds
// (measured on an H100: chains over a whole 128-column chunk used 1.5 times
// the float32 allowance where chains of four k steps use 0.48): every chain
// below is four k steps of the hi x hi products, and beside it one of the
// small ones (a_lo b_hi, a_hi b_lo), added by round-to-nearest float32
// adds.

// f (m64n32: the T own rows by the tile's TS streamed rows) = A B^T over the
// BLOCKS 32-column blocks from `first` of a 128-column chunk (the backward
// all 4, each of the forward's warpgroups 2): A the own tile at `a` (T x
// 128, split in registers), B the streamed tile (raw words at `b`, its lo
// tile at `blo`); one swizzle block a chain.  The loop over them stays rolled: unrolled,
// the compiler hoists every block's operand loads and spills the output
// accumulators instead (1.1-1.4 KB; 45% longer on an H100)
template <int T, int TS, int BLOCKS>
__device__ __forceinline__ void partial_blocks(float (&f)[16], const uint8_t* a, uint32_t b,
                                               uint32_t blo, int first, int w, int g4, int t4) {
  const int r0 = 16 * w + g4;
#pragma unroll 1
  for (int h = 0; h < BLOCKS; ++h) {
    const int cb = first + h;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int col = 32 * cb + 8 * kk + t4;
      const float x[4] = {ld_f32(a, r0, col, T), ld_f32(a, r0 + 8, col, T),
                          ld_f32(a, r0, col + 4, T), ld_f32(a, r0 + 8, col + 4, T)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const Tf32x2 sp = split(x[e]);
        ah[kk][e] = sp.hi;
        al[kk][e] = sp.lo;
      }
    }
    float big[16], small[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) big[e] = small[e] = 0.f;
    reg_fence(big);
    reg_fence(small);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t off = cb * TS * 128 + kk * 32;
      const uint64_t bh = desc_kmajor(b + off), bl = desc_kmajor(blo + off);
      wgmma_m64n32k8_tf32(small, al[kk], bh, kk > 0);
      wgmma_m64n32k8_tf32(small, ah[kk], bl, 1);
      wgmma_m64n32k8_tf32(big, ah[kk], bh, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(big);
    reg_fence(small);
#pragma unroll
    for (int e = 0; e < 16; ++e) f[e] = h == 0 ? big[e] + small[e] : f[e] + (big[e] + small[e]);
  }
}

// The CUDA driver's cuTensorMapEncodeTiled, reached through the runtime (so
// nothing links libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [planes, sb, d] tensor of `bytes`-byte elements as a 3-D tensor map
// whose box is 128 bytes of columns x `rows` rows of one plane, 128-byte
// swizzle: rows past sb (the ragged tile of a block) read as zeros
int tile_map(CUtensorMap* map, CUtensorMapDataType type, int bytes, const void* base, int d,
             int sb, int planes, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)sb, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)d * bytes, (cuuint64_t)sb * d * bytes};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / bytes), (cuuint32_t)rows, 1}, unit[3] = {1, 1, 1};
  const CUresult r = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadMap;
}
// float32 in boxes of 32 columns, bf16 in boxes of 64
int f32_map(CUtensorMap* map, const void* base, int d, int sb, int planes, int rows) {
  return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, d, sb, planes, rows);
}
int bf16_map(CUtensorMap* map, const void* base, int d, int sb, int planes, int rows) {
  return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, d, sb, planes, rows);
}

// a kernel in clusters of C blocks of `threads` along x: refused
// (kNoCluster) where no such cluster fits the card, else launched with its
// error
template <typename Plan, typename... Args>
int launch_cluster(void (*kernel)(Args...), dim3 grid, int threads, int C, cudaStream_t s,
                   Args... args) {
  int err = set_smem(kernel, Plan::SMEM);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = Plan::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = (int)cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (err) return err;
  if (clusters == 0) return kNoCluster;
  void* argv[] = {static_cast<void*>(&args)...};
  err = (int)cudaLaunchKernelExC(&cfg, (const void*)kernel, argv);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace
