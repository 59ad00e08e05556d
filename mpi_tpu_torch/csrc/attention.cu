// Ring attention over P virtual ranks held in one device memory: the
// forward (attn_fwd), on the tensor cores.  The backward is
// csrc/attention_bwd.cu.
//
// Replaces the Pallas TPU kernel _kernel (mpi_tpu/tpu/pallas_attention.py
// :367, fold _online_fold :116, mask _causal_mask :134), launched by
// _kernel_call (:1059).
//
// What it computes.  Rank r (position r of a group of g ranks) holds
// Q [Hq, Sb, d] and K, V [Hkv, Sb, d]; on the TPU, arrival a = 0..g-1
// brings K/V block (r - a) mod g and is folded into the online-softmax
// state (m, l, o), all float32: S = (Q K^T) * scale, masked with -1e30 on
// the diagonal block under causal (later blocks are skipped), m' =
// max(m, rowmax S), l' = l e^(m-m') + rowsum e^(S-m'), o' = o e^(m-m') +
// e^(S-m') V; out = o / l, rounded once to the input type, lse = m + log l.
// Query head h reads K/V head h / (Hq / Hkv).
//
// What bounds it.  Each unmasked score entry costs 4d flops (Q K^T and
// P V): at long sequences the work is far above the card's bytes-to-flops
// line, so it is bound by arithmetic.  The numerics are the reference's:
// S, m, l, o and P are float32.
//   bf16 inputs: Q K^T multiplies bf16 by bf16, exact in a float32
//   accumulator: one wgmma.  P is float32: it is split into hi = bf16(P)
//   and lo = bf16(P - hi) (hopper.cuh, split_bf16x2), and P V is two
//   wgmmas.  Three bf16 products per entry where the bound counts two: the
//   design floor is 1.5 times the bf16 bound.
//   float32 inputs: both products as split TF32 on mma.sync.m16n8k8, at a
//   third of the TF32 rate, each product's partial added to its float32
//   accumulator outside the tensor core (hopper.cuh, mma_3xtf32): the
//   design floor is the split-TF32 bound.
// The exponentials are exp2 of scores scaled by scale log2(e) (one multiply
// and the special-function unit), m kept in the same units; lse converts
// back with ln 2.
//
// Design.  On one card all ranks' blocks share one memory, so no K/V block
// travels: a block reads the blocks its ring would have delivered, in the
// order it would have delivered them (DqWalk, ring_attention.cuh); the
// RDMA slots, credits and barriers of the TPU design have no counterpart.
// One block per (rank, query head, tile of 64 W Q rows): W warpgroups (or
// groups of four warps), each with its own 64 Q rows resident, share every
// K/V tile that streams through shared memory, so a K/V tile is copied from
// L2 once per 64 W query rows (that copy, not the products, bounded the
// first tensor-core form; PERF.md).  Every block owns its outputs.  Under
// causal masking rank g-1 has g arrivals and rank 0 one, so the grid
// starts the heaviest blocks first (last rank, last q-tile).  Tiles that
// causal masking empties for the whole block are skipped: future blocks,
// and k-tiles past the one holding the block's last row; a warpgroup
// whose rows end before such a tile folds it all masked (P = 0, alpha =
// 1: no change).  The softmax state of a row lives in the four threads
// that hold its scores in the accumulator fragment (m16n8 layout: row g,
// columns 2t, 2t + 1 of each 8-column group), which reduce with two
// shuffles.
//   bf16 (W = 3 at d = 128, 2 at d = 256; 128 threads a warpgroup): tiles
//   of 64 rows in the 128-byte swizzle, staged by cp.async one tile ahead.
//   S = Q K^T is an m64n64k16 wgmma over d/16 steps, both operands K-major
//   in shared memory; the scores become P in registers, and its accumulator
//   fragment, split hi/lo, is the A operand of m64n128k16 wgmmas whose B is
//   the V tile read MN-major with the transpose bit (two 128-column halves
//   at d = 256).  A tile's S is issued with the previous tile's P V behind
//   it, so the softmax overlaps P V; the O accumulator (64 registers a
//   thread per 128 columns) is rescaled by e^(m-m') once that P V is done,
//   and V stays staged one tile longer than K.  Shared memory 1 KB
//   alignment + (W + 2 + 3) tiles of 64 x d bf16 (Q, two stages of K,
//   three of V): 132 096 bytes at d = 128, 230 400 at d = 256; one block
//   an SM.
//   float32 (W = 3 at d = 128, 1 at d = 256): Q resident in 64 W rows, K
//   and V in 32-row tiles, two stages, row stride d + 4 (conflict-free
//   fragment reads): (64 W + 4 x 32)(d + 4) x 4 = 168 960 bytes at
//   d = 128, 199 680 at d = 256.  P's accumulator is the A operand of P V
//   with its k index permuted, as in attn_bwd_dq.

#include <math.h>

#include <type_traits>

#include "ring_attention.cuh"

namespace {

constexpr float kMasked = -1e30f;  // pallas_attention.py:109
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// W warpgroups (four warps each), each with its own 64 Q rows, share every
// staged K/V tile.  bf16: two stages of K and three of V (V of a tile is
// read one iteration after its K); float32: two stages of both.
template <int D> struct FwdBf16Plan {
  static constexpr int W = D == 128 ? 3 : 2;
  static constexpr int T = 64, TILE = T * D * 2, THREADS = 128 * W;
  static constexpr int SMEM = 1024 + (W + 2 + 3) * TILE;
};
template <int D> struct FwdF32Plan {
  static constexpr int W = D == 128 ? 3 : 1;
  static constexpr int T = 64, TS = 32, LD = D + 4, THREADS = 128 * W;
  static constexpr int SMEM = (W * T + 4 * TS) * LD * 4;
};

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

// out = o / l for the thread's two rows (o: NC groups of 8 columns from
// column 0, layout as above), lse = m ln 2 + log l; rows past Sb are
// never written
template <int NC, typename E>
__device__ __forceinline__ void write_rows(const float (&o)[NC][4], const float (&m)[2],
                                           const float (&l)[2], E* out, float* lse,
                                           long long row0, int qi0, int sb, int t4) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qi0 + 8 * i;
    if (qi >= sb) continue;
    E* dst = out + (row0 + qi) * (NC * 8) + 2 * t4;
#pragma unroll
    for (int n = 0; n < NC; ++n) store2(dst + 8 * n, o[n][2 * i] / l[i], o[n][2 * i + 1] / l[i]);
    if (t4 == 0) lse[row0 + qi] = m[i] * kLn2 + logf(l[i]);
  }
}

// ------------------------------------------------------------------- bf16
// O += P V over one 64-row V tile (P split hi/lo), one 128-column half of
// O at a time; committed as one wgmma group
template <int NH>
__device__ __forceinline__ void issue_pv(float (&acc)[NH][64], const uint32_t (&ph)[4][4],
                                         const uint32_t (&pl)[4][4], uint32_t va) {
  constexpr int T = 64;
#pragma unroll
  for (int nh = 0; nh < NH; ++nh)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bv = desc_mnmajor(va + 2 * nh * (T * 128) + kk * 2048, T);
      wgmma_m64n128k16_rs_tb(acc[nh], pl[kk], bv);
      wgmma_m64n128k16_rs_tb(acc[nh], ph[kk], bv);
    }
  wgmma_commit();
}

template <int D>
__device__ __forceinline__ void fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                         const bf16* __restrict__ v, bf16* __restrict__ out,
                                         float* __restrict__ lse, Geo geo) {
  using Plan = FwdBf16Plan<D>;
  constexpr int T = Plan::T, TILE = Plan::TILE, NH = D / 128, W = Plan::W;
  constexpr int NT = Plan::THREADS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);  // warpgroup w's 64 rows at Qs + w TILE
  uint8_t* Ks = Qs + W * TILE;  // tile i's K at stage i % 2
  uint8_t* Vs = Ks + 2 * TILE;  // tile i's V at stage i % 3
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int g4 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  // the heaviest blocks first: the last rank of a group, its last q-tile
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int grp = blockIdx.z / geo.g, r = geo.g - 1 - blockIdx.z % geo.g;
  const int* G = geo.groups + grp * geo.g;
  const int h = blockIdx.y, kvh = h / (geo.hq / geo.hkv), sb = geo.sb, q0 = qt * W * T;
  const long long row0 = ((long long)G[r] * geo.hq + h) * sb;
  const int qi0 = q0 + T * wg + 16 * warp + g4;
  const float scale2 = geo.scale * kLog2e;
  // the block's walk; a warpgroup below the diagonal's last k-tile folds
  // it too, all masked (P = 0, alpha = 1)
  const DqWalk walk(geo, r, q0, W * T, T);

#pragma unroll
  for (int w = 0; w < W; ++w)
    stage_bf16<T, D, NT>(Qs + w * TILE, q + (row0 + q0 + w * T) * D, sb - q0 - w * T);
  auto fetch = [&](int i) {
    int arr, kt;
    walk.at(i, arr, kt);
    const int jb = (r - arr + geo.g) % geo.g;
    const long long kv = ((long long)G[jb] * geo.hkv + kvh) * sb + kt * T;
    stage_bf16<T, D, NT>(Ks + (i & 1) * TILE, k + kv * D, sb - kt * T);
    stage_bf16<T, D, NT>(Vs + (i % 3) * TILE, v + kv * D, sb - kt * T);
    cp_async_commit();
  };
  fetch(0);  // Q travels in the first group

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NH][64];
#pragma unroll
  for (int nh = 0; nh < NH; ++nh)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[nh][e] = 0.f;
  uint32_t ph[4][4], pl[4][4];  // the previous tile's P, split
  const uint32_t qa = smem_addr(Qs + wg * TILE);
  // Tile i's S = Q K^T is issued with the previous tile's P V behind it:
  // the softmax of tile i runs while P V is on the tensor cores.  Tile i + 1
  // is fetched meanwhile, into the K stage of tile i - 1 and the V stage of
  // tile i - 2, both done before this iteration's barrier.
  for (int i = 0; i < walk.total; ++i) {
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();
    if (i + 1 < walk.total) fetch(i + 1);
    int arr, kt;
    walk.at(i, arr, kt);
    const uint32_t ka = smem_addr(Ks + (i & 1) * TILE);

    float s[8][4];
    float(&sf)[32] = reinterpret_cast<float(&)[32]>(s);
#pragma unroll
    for (int e = 0; e < 32; ++e) sf[e] = 0.f;
    reg_fence(sf);
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) reg_fence(acc[nh]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks / 4) * (T * 128) + (ks % 4) * 32;
      wgmma_m64n64k16_ss(sf, desc_kmajor(qa + off), desc_kmajor(ka + off));
    }
    wgmma_commit();
    if (i > 0) {
      issue_pv(acc, ph, pl, smem_addr(Vs + ((i - 1) % 3) * TILE));
      wgmma_wait<1>();  // S is ready; P V may still run
    } else {
      wgmma_wait<0>();
    }
    reg_fence(sf);

    float alpha[2];
    fold_scores(s, m, l, alpha, qi0, kt * T + 2 * t4, sb, geo.causal && arr == 0, scale2);
    wgmma_wait<0>();  // the previous P V is done: O, ph and pl are free
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) {
      reg_fence(acc[nh]);
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[nh][e] *= alpha[(e >> 1) & 1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_frag(sf, kk, ph[kk], pl[kk]);
  }
#pragma unroll
  for (int nh = 0; nh < NH; ++nh) reg_fence(acc[nh]);
  wgmma_fence();
  issue_pv(acc, ph, pl, smem_addr(Vs + ((walk.total - 1) % 3) * TILE));
  wgmma_wait<0>();
#pragma unroll
  for (int nh = 0; nh < NH; ++nh) reg_fence(acc[nh]);

  float o[D / 8][4];
#pragma unroll
  for (int nh = 0; nh < NH; ++nh)
#pragma unroll
    for (int e = 0; e < 64; ++e) o[16 * nh + e / 4][e % 4] = acc[nh][e];
  write_rows(o, m, l, out, lse, row0, qi0, sb, t4);
}

// ---------------------------------------------------------------- float32
template <int D>
__device__ __forceinline__ void fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                                        const float* __restrict__ v, float* __restrict__ out,
                                        float* __restrict__ lse, Geo geo) {
  using Plan = FwdF32Plan<D>;
  constexpr int T = Plan::T, TS = Plan::TS, LD = Plan::LD, W = Plan::W, NT = Plan::THREADS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // W T rows
  float* St = Qs + W * T * LD;  // stage s: K at St + 2s TS LD, V TS LD later
  const int warp = threadIdx.x / 32, g4 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int grp = blockIdx.z / geo.g, r = geo.g - 1 - blockIdx.z % geo.g;
  const int* G = geo.groups + grp * geo.g;
  const int h = blockIdx.y, kvh = h / (geo.hq / geo.hkv), sb = geo.sb, q0 = qt * W * T;
  const long long row0 = ((long long)G[r] * geo.hq + h) * sb;
  const int qi0 = q0 + 16 * warp + g4;
  const float scale2 = geo.scale * kLog2e;
  const DqWalk walk(geo, r, q0, W * T, TS);

  stage_f32<W * T, D, NT>(Qs, q + (row0 + q0) * D, sb - q0);
  auto fetch = [&](int i) {
    int arr, kt;
    walk.at(i, arr, kt);
    const int jb = (r - arr + geo.g) % geo.g;
    const long long kv = ((long long)G[jb] * geo.hkv + kvh) * sb + kt * TS;
    float* Ks = St + 2 * (i & 1) * TS * LD;
    stage_f32<TS, D, NT>(Ks, k + kv * D, sb - kt * TS);
    stage_f32<TS, D, NT>(Ks + TS * LD, v + kv * D, sb - kt * TS);
    cp_async_commit();
  };
  fetch(0);  // Q travels in the first group
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float* Qw = Qs + 16 * warp * LD;
  for (int i = 0; i < walk.total; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // tile i has landed; tile i - 1's stage is free
    if (i + 1 < walk.total) fetch(i + 1);
    int arr, kt;
    walk.at(i, arr, kt);
    const int k0 = kt * TS;
    const float* Ks = St + 2 * (i & 1) * TS * LD;
    const float* Vs = Ks + TS * LD;

    // S = Q K^T (rows: this warp's 16 q, columns: 32 k)
    float s[TS / 8][4];
#pragma unroll
    for (int n = 0; n < TS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < D / 8; ++ks) {
      const int c0 = 8 * ks + t4;
      Tf32x2 qa[4];
      frag_rows(Qw, LD, g4, c0, qa);
#pragma unroll
      for (int n = 0; n < TS / 8; ++n) {
        const float* kr = Ks + (8 * n + g4) * LD + c0;
        mma_3xtf32(s[n], qa, split(kr[0]), split(kr[4]));
      }
    }

    float alpha[2];
    fold_scores(s, m, l, alpha, qi0, k0 + 2 * t4, sb, geo.causal && arr == 0, scale2);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V over the tile's 32 k rows
#pragma unroll
    for (int kk = 0; kk < TS / 8; ++kk) {
      Tf32x2 pa[4];
      frag_acc(s[kk], pa);
      const float* vr = Vs + (8 * kk + 2 * t4) * LD + g4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        mma_3xtf32(acc[n], pa, split(vr[8 * n]), split(vr[LD + 8 * n]));
    }
  }
  write_rows(acc, m, l, out, lse, row0, qi0, sb, t4);
}

// ----------------------------------------------------------------- launches
template <typename E, int D> struct FwdThreads {
  static constexpr int value =
      std::is_same<E, bf16>::value ? FwdBf16Plan<D>::THREADS : FwdF32Plan<D>::THREADS;
};

template <typename E, int D>
__global__ void __launch_bounds__(FwdThreads<E, D>::value)
attn_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                E* __restrict__ out, float* __restrict__ lse, Geo geo) {
  if constexpr (std::is_same<E, bf16>::value) fwd_bf16<D>(q, k, v, out, lse, geo);
  else fwd_f32<D>(q, k, v, out, lse, geo);
}

template <typename E, int D>
int fwd(const void* q, const void* k, const void* v, void* out, float* lse, Geo geo,
        int ngroups, cudaStream_t s) {
  constexpr int bytes =
      std::is_same<E, bf16>::value ? FwdBf16Plan<D>::SMEM : FwdF32Plan<D>::SMEM;
  int err = set_smem(attn_fwd_kernel<E, D>, bytes);
  if (err) return err;
  constexpr int threads = FwdThreads<E, D>::value, rows = 64 * (threads / 128);
  dim3 grid((geo.sb + rows - 1) / rows, geo.hq, ngroups * geo.g);
  attn_fwd_kernel<E, D><<<grid, threads, bytes, s>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<E*>(out), lse, geo);
  return (int)cudaGetLastError();
}

}  // namespace

// q [P, Hq, Sb, d], k/v [P, Hkv, Sb, d] (dtype: 0 float32, 1 bfloat16);
// out like q; lse [P, Hq, Sb] float32; groups [ngroups, g] int32.  Every
// pointer 16-byte aligned.  Returns the launch's cudaError_t (0 on success).
extern "C" int attn_fwd(const void* q, const void* k, const void* v, void* out,
                        void* lse, const void* groups, int ngroups, int g, int hq,
                        int hkv, int sb, int d, float scale, int causal, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geo geo = make_geo(groups, g, hq, hkv, sb, scale, causal);
  float* L = static_cast<float*>(lse);
  if (dtype == 0 && d == 128) return fwd<float, 128>(q, k, v, out, L, geo, ngroups, s);
  if (dtype == 0 && d == 256) return fwd<float, 256>(q, k, v, out, L, geo, ngroups, s);
  if (dtype == 1 && d == 128) return fwd<bf16, 128>(q, k, v, out, L, geo, ngroups, s);
  if (dtype == 1 && d == 256) return fwd<bf16, 256>(q, k, v, out, L, geo, ngroups, s);
  return kBadShape;
}
