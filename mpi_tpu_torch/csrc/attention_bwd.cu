// The backward of ring attention over P virtual ranks held in one device
// memory, on the tensor cores: attn_bwd_dq and attn_bwd_dkv.
//
// Replaces the Pallas TPU kernel _bwd_kernel (mpi_tpu/tpu/pallas_attention.py
// :617, algebra _pair_grad_tile :217), launched by _bwd_kernel_call (:1130):
// its local dQ and its circulating dK/dV.
//
// What they compute.  Rank r (position r of a group of g ranks) holds Q, dO
// [Hq, Sb, d], K, V [Hkv, Sb, d] and, from the forward, lse [Hq, Sb];
// delta = rowsum(dO O) is computed before the launch, as the reference
// computes it outside its kernel.  For query block r and K/V block j the
// backward recomputes S = Q K^T, P = exp(S scale - lse) (masked to 0 above
// the diagonal of block r under causal; blocks j > r are skipped), dP =
// dO V^T, dS = P (dP - delta) scale, and sums dQ += dS K over arrivals
// j = r, r-1, ... (ring order), dV += P^T dO and dK += dS^T Q into block
// j's accumulators as the block visits ranks j, j+1, ..., j+g-1, query
// heads of the GQA group in increasing order (query head h reads K/V head
// h / (Hq / Hkv)).  All sums are float32, rounded once to the output type.
//
// What bounds them.  Each unmasked score entry costs 6d flops in attn_bwd_dq
// (QK^T, dO V^T, dS K) and 8d in attn_bwd_dkv (QK^T, dO V^T, P^T dO, dS^T Q)
// against 10d for the whole backward: at long sequences both are bound by
// arithmetic.  The numerics are the reference's: P and dS stay float32.
//   bf16 inputs: QK^T and dO V^T multiply bf16 by bf16, exact in a float32
//   accumulator, so they are one wgmma each.  P and dS are float32 operands:
//   each is split into hi = bf16(x) and lo = bf16(x - hi) (hi + lo within
//   2^-16 |x|), and a product with them is two wgmmas.  Ten bf16 products per
//   entry over both kernels, where the bound counts five: the design floor
//   is twice the bf16 bound.
//   float32 inputs: every operand is split into TF32 hi and lo and a product
//   is a_lo b_hi + a_hi b_lo + a_hi b_hi (within about 3 x 2^-20 relative;
//   plain TF32 would leave the float32 tolerance), on mma.sync.m16n8k8 TF32
//   at a third of the TF32 rate, each product's partial added to its float32
//   accumulator outside the tensor core (hopper.cuh, mma_3xtf32).  wgmma's
//   TF32 form has no transpose bit, so P^T dO, dS^T Q and dS K would need
//   their B tile staged transposed, and
//   the hi and lo copies of every tile in shared memory: at d = 256 the
//   dK/dV block would hold K, V (2 x 64 x 256 x 4 x 2 = 256 KB with both
//   copies) before any Q tile, over the 227 KB a block may use.  mma.sync
//   takes both operands from registers: one float32 tile in shared memory
//   (row stride d + 4 floats, conflict-free for the fragment reads), split
//   in registers as it is read.
//
// Design.  On one card all ranks' blocks share one memory, so no block
// travels: a thread block reads the blocks its ring would have delivered,
// in the order it would have delivered them.  Every block owns its outputs
// (no atomics, deterministic sums).
//   attn_bwd_dkv: one block per (owner block j, K/V head, 64-row K tile,
//   128-column half of d).  K and V stay resident; the block walks the
//   visiting ranks, the GQA heads and the Q/dO tiles (on the diagonal only
//   q-tiles that reach the k-tile), staged by cp.async.  dK and dV
//   accumulate in registers (64 x 128 float32 each: 64 registers a thread)
//   and are written once.  At d = 256 the two column halves are two blocks,
//   each recomputing S^T and dP^T: a 64 x 256 tile would need 128 registers
//   a thread for each of dK and dV.
//   attn_bwd_dq: one block per (rank, query head, 64-row Q tile); Q and dO
//   stay resident, the K/V tiles of the arrivals stream through in ring
//   order.  Under causal masking rank g-1 has g arrivals and rank 0 one, so
//   the grid starts the heaviest blocks first (last rank, last q-tile).
//   bf16 (one warpgroup of 128 threads): tiles of 64 rows in the 128-byte
//   swizzle (hopper.cuh), two stages of the streamed tiles.  S^T = K Q^T
//   (dkv) or S = Q K^T (dq) and the dP products are m64n64k16 wgmmas with
//   both operands K-major in shared memory; P and dS never leave registers:
//   their accumulator fragments are split into hi/lo A operands of
//   m64n128k16 wgmmas whose B (dO, Q or K, MN-major for this product) is the
//   same swizzled tile read with the transpose bit.  Shared memory 1 KB
//   alignment + 6 tiles of 64 x d bf16 + 1 KB of lse/delta rows: 100 352
//   bytes at d = 128 (two blocks an SM), 198 656 at d = 256.
//   float32 (four warps of 16 rows): resident tiles of 64 rows and one stage
//   of 32-row streamed tiles, row stride d + 4: (2 x 64 + 2 x 32) (d + 4) x 4
//   + 256 bytes = 101 632 at d = 128 (two blocks an SM), 199 936 at d = 256.
//   The accumulator of P or dS is the A operand of the next m16n8k8 with its
//   k index permuted (k = t <-> column 2t, k = t + 4 <-> 2t + 1); the B rows
//   are read in the same permutation.

#include <math.h>

#include <type_traits>

#include "ring_attention.cuh"

namespace {

template <int D> struct Bf16Plan {
  static constexpr int T = 64, TILE = T * D * 2;
  static constexpr int SMEM = 1024 + 6 * TILE + 4 * T * 4;
};
template <int D> struct F32Plan {
  static constexpr int T = 64, TS = 32, LD = D + 4;
  static constexpr int SMEM = (2 * T + 2 * TS) * LD * 4 + 2 * TS * 4;
};

// ----------------------------------------------------------- bf16: dK, dV
template <int D>
__device__ __forceinline__ void dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                         const bf16* __restrict__ v,
                                         const bf16* __restrict__ dout,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, bf16* __restrict__ dk,
                                         bf16* __restrict__ dv, Geo geo) {
  constexpr int T = Bf16Plan<D>::T, TILE = Bf16Plan<D>::TILE, NH = D / 128;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + TILE;
  uint8_t* St = Vs + TILE;  // stage s: Q at St + 2s TILE, dO one TILE later
  float* Rows = reinterpret_cast<float*>(St + 4 * TILE);  // stage s: lse at 2sT, delta T later
  const int warp = threadIdx.x / 32, g4 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int kt = blockIdx.x / NH, n0 = (blockIdx.x % NH) * 128;
  const int member = blockIdx.z, j = member % geo.g;  // the K/V block's owner
  const int* G = geo.groups + (member - j);
  const int kvh = blockIdx.y, rep = geo.hq / geo.hkv, sb = geo.sb, k0 = kt * T;
  const long long kv_row0 = ((long long)G[j] * geo.hkv + kvh) * sb + k0;
  const DkvWalk walk(geo, j, k0, T);

  stage_bf16<T, D>(Ks, k + kv_row0 * D, sb - k0);
  stage_bf16<T, D>(Vs, v + kv_row0 * D, sb - k0);
  auto fetch = [&](int i) {
    int arr, t, qt;
    walk.at(i, arr, t, qt);
    const int r = (j + arr) % geo.g, q0 = qt * T, s = i & 1;
    const long long row0 = ((long long)G[r] * geo.hq + kvh * rep + t) * sb + q0;
    stage_bf16<T, D>(St + 2 * s * TILE, q + row0 * D, sb - q0);
    stage_bf16<T, D>(St + (2 * s + 1) * TILE, dout + row0 * D, sb - q0);
    stage_rows<T>(Rows + 2 * s * T, lse + row0, sb - q0);
    stage_rows<T>(Rows + (2 * s + 1) * T, delta + row0, sb - q0);
    cp_async_commit();
  };
  fetch(0);  // K and V travel in the first group

  float adk[64], adv[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) adk[e] = adv[e] = 0.f;
  const uint32_t ka = smem_addr(Ks), va = smem_addr(Vs);
  for (int i = 0; i < walk.total; ++i) {
    if (i + 1 < walk.total) {
      fetch(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    int arr, t, qt;
    walk.at(i, arr, t, qt);
    const int s = i & 1, q0 = qt * T;
    const bool diag = geo.causal && arr == 0;
    const uint32_t qa = smem_addr(St + 2 * s * TILE), oa = qa + TILE;

    // S^T = K Q^T, dP^T = V dO^T (rows: k, columns: q)
    float st[32], dpt[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
    reg_fence(st);
    reg_fence(dpt);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks / 4) * (T * 128) + (ks % 4) * 32;
      wgmma_m64n64k16_ss(st, desc_kmajor(ka + off), desc_kmajor(qa + off));
      wgmma_m64n64k16_ss(dpt, desc_kmajor(va + off), desc_kmajor(oa + off));
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(st);
    reg_fence(dpt);

    const float* L = Rows + 2 * s * T;
    const float* Dl = L + T;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * jj + 2 * t4 + c, qi = q0 + col;
        const float lq = L[col], dq = Dl[col];
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int e = 4 * jj + 2 * ii + c, kj = k0 + 16 * warp + g4 + 8 * ii;
          grad_entry(st[e], dpt[e], lq, dq, geo.scale, qi >= sb || (diag && kj > qi));
        }
      }
    uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_frag(st, kk, ph[kk], pl[kk]);
      acc_to_frag(dpt, kk, dh[kk], dl[kk]);
    }

    // dV += P^T dO, dK += dS^T Q over this tile's 64 q rows (the k steps)
    reg_fence(adk);
    reg_fence(adv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t off = (n0 / 64) * (T * 128) + kk * 2048;
      const uint64_t bo = desc_mnmajor(oa + off, T), bq = desc_mnmajor(qa + off, T);
      wgmma_m64n128k16_rs_tb(adv, pl[kk], bo);
      wgmma_m64n128k16_rs_tb(adv, ph[kk], bo);
      wgmma_m64n128k16_rs_tb(adk, dl[kk], bq);
      wgmma_m64n128k16_rs_tb(adk, dh[kk], bq);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(adk);
    reg_fence(adv);
    __syncthreads();  // this stage is free for the tile after next
  }
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int row = 16 * warp + g4 + 8 * ii, e = 4 * jj + 2 * ii;
      if (k0 + row >= sb) continue;
      const long long at = (kv_row0 + row) * D + n0 + 8 * jj + 2 * t4;
      store2(dk + at, adk[e], adk[e + 1]);
      store2(dv + at, adv[e], adv[e + 1]);
    }
}

// --------------------------------------------------------------- bf16: dQ
template <int D>
__device__ __forceinline__ void dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                        const bf16* __restrict__ v,
                                        const bf16* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta, bf16* __restrict__ dq,
                                        Geo geo) {
  constexpr int T = Bf16Plan<D>::T, TILE = Bf16Plan<D>::TILE, NH = D / 128;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Os = Qs + TILE;
  uint8_t* St = Os + TILE;  // stage s: K at St + 2s TILE, V one TILE later
  const int warp = threadIdx.x / 32, g4 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  // the heaviest blocks first: the last rank of a group, its last q-tile
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int grp = blockIdx.z / geo.g, r = geo.g - 1 - blockIdx.z % geo.g;
  const int* G = geo.groups + grp * geo.g;
  const int h = blockIdx.y, kvh = h / (geo.hq / geo.hkv), sb = geo.sb, q0 = qt * T;
  const long long row0 = ((long long)G[r] * geo.hq + h) * sb;
  const DqWalk walk(geo, r, q0, T, T);

  stage_bf16<T, D>(Qs, q + (row0 + q0) * D, sb - q0);
  stage_bf16<T, D>(Os, dout + (row0 + q0) * D, sb - q0);
  auto fetch = [&](int i) {
    int arr, kt;
    walk.at(i, arr, kt);
    const int jb = (r - arr + geo.g) % geo.g, s = i & 1;
    const long long kv = ((long long)G[jb] * geo.hkv + kvh) * sb + kt * T;
    stage_bf16<T, D>(St + 2 * s * TILE, k + kv * D, sb - kt * T);
    stage_bf16<T, D>(St + (2 * s + 1) * TILE, v + kv * D, sb - kt * T);
    cp_async_commit();
  };
  fetch(0);  // Q and dO travel in the first group

  float L[2], Dl[2];
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int qi = q0 + 16 * warp + g4 + 8 * ii;
    L[ii] = qi < sb ? lse[row0 + qi] : 0.f;
    Dl[ii] = qi < sb ? delta[row0 + qi] : 0.f;
  }
  float adq[NH][64];
#pragma unroll
  for (int nh = 0; nh < NH; ++nh)
#pragma unroll
    for (int e = 0; e < 64; ++e) adq[nh][e] = 0.f;
  const uint32_t qa = smem_addr(Qs), oa = smem_addr(Os);
  for (int i = 0; i < walk.total; ++i) {
    if (i + 1 < walk.total) {
      fetch(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    int arr, kt;
    walk.at(i, arr, kt);
    const int k0 = kt * T;
    const bool diag = geo.causal && arr == 0;
    const uint32_t ka = smem_addr(St + 2 * (i & 1) * TILE), va = ka + TILE;

    // S = Q K^T, dP = dO V^T (rows: q, columns: k)
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks / 4) * (T * 128) + (ks % 4) * 32;
      wgmma_m64n64k16_ss(s, desc_kmajor(qa + off), desc_kmajor(ka + off));
      wgmma_m64n64k16_ss(dp, desc_kmajor(oa + off), desc_kmajor(va + off));
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    reg_fence(dp);

#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int qi = q0 + 16 * warp + g4 + 8 * ii;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * jj + 2 * ii + c, kj = k0 + 8 * jj + 2 * t4 + c;
          grad_entry(s[e], dp[e], L[ii], Dl[ii], geo.scale,
                     kj >= sb || qi >= sb || (diag && kj > qi));
        }
      }
    uint32_t dh[4][4], dl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_frag(dp, kk, dh[kk], dl[kk]);

    // dQ += dS K over this tile's 64 k rows, one 128-column half at a time
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) reg_fence(adq[nh]);
    wgmma_fence();
#pragma unroll
    for (int nh = 0; nh < NH; ++nh)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bk = desc_mnmajor(ka + 2 * nh * (T * 128) + kk * 2048, T);
        wgmma_m64n128k16_rs_tb(adq[nh], dl[kk], bk);
        wgmma_m64n128k16_rs_tb(adq[nh], dh[kk], bk);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) reg_fence(adq[nh]);
    __syncthreads();
  }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int qi = q0 + 16 * warp + g4 + 8 * ii;
    if (qi >= sb) continue;
#pragma unroll
    for (int nh = 0; nh < NH; ++nh)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int e = 4 * jj + 2 * ii;
        store2(dq + (row0 + qi) * D + 128 * nh + 8 * jj + 2 * t4, adq[nh][e], adq[nh][e + 1]);
      }
  }
}

// -------------------------------------------------------- float32: dK, dV
template <int D>
__device__ __forceinline__ void dkv_f32(const float* __restrict__ q,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const float* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta, float* __restrict__ dk,
                                        float* __restrict__ dv, Geo geo) {
  constexpr int T = F32Plan<D>::T, TS = F32Plan<D>::TS, LD = F32Plan<D>::LD, NH = D / 128;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + T * LD;
  float* Qs = Vs + T * LD;
  float* Os = Qs + TS * LD;
  float* L = Os + TS * LD;
  float* Dl = L + TS;
  const int warp = threadIdx.x / 32, g4 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int kt = blockIdx.x / NH, n0 = (blockIdx.x % NH) * 128;
  const int member = blockIdx.z, j = member % geo.g;
  const int* G = geo.groups + (member - j);
  const int kvh = blockIdx.y, rep = geo.hq / geo.hkv, sb = geo.sb, k0 = kt * T;
  const long long kv_row0 = ((long long)G[j] * geo.hkv + kvh) * sb + k0;
  const DkvWalk walk(geo, j, k0, TS);

  stage_f32<T, D>(Ks, k + kv_row0 * D, sb - k0);
  stage_f32<T, D>(Vs, v + kv_row0 * D, sb - k0);
  float adk[16][4], adv[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  const float* Kw = Ks + 16 * warp * LD;
  const float* Vw = Vs + 16 * warp * LD;
  for (int i = 0; i < walk.total; ++i) {
    int arr, t, qt;
    walk.at(i, arr, t, qt);
    const int r = (j + arr) % geo.g, q0 = qt * TS;
    const bool diag = geo.causal && arr == 0;
    const long long row0 = ((long long)G[r] * geo.hq + kvh * rep + t) * sb + q0;
    stage_f32<TS, D>(Qs, q + row0 * D, sb - q0);
    stage_f32<TS, D>(Os, dout + row0 * D, sb - q0);
    stage_rows<TS>(L, lse + row0, sb - q0);
    stage_rows<TS>(Dl, delta + row0, sb - q0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // S^T = K Q^T, dP^T = V dO^T (rows: this warp's 16 k, columns: 32 q)
    float st[TS / 8][4], dpt[TS / 8][4];
#pragma unroll
    for (int n = 0; n < TS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < D / 8; ++ks) {
      const int c0 = 8 * ks + t4;
      Tf32x2 ka[4], va[4];
      frag_rows(Kw, LD, g4, c0, ka);
      frag_rows(Vw, LD, g4, c0, va);
#pragma unroll
      for (int n = 0; n < TS / 8; ++n) {
        const float* qr = Qs + (8 * n + g4) * LD + c0;
        const float* orow = Os + (8 * n + g4) * LD + c0;
        mma_3xtf32(st[n], ka, split(qr[0]), split(qr[4]));
        mma_3xtf32(dpt[n], va, split(orow[0]), split(orow[4]));
      }
    }
#pragma unroll
    for (int n = 0; n < TS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t4 + (e & 1), qi = q0 + col;
        const int kj = k0 + 16 * warp + g4 + 8 * (e >> 1);
        grad_entry(st[n][e], dpt[n][e], L[col], Dl[col], geo.scale,
                   qi >= sb || (diag && kj > qi));
      }

    // dV += P^T dO, dK += dS^T Q over the tile's 32 q rows
#pragma unroll
    for (int kq = 0; kq < TS / 8; ++kq) {
      Tf32x2 pa[4], da[4];
      frag_acc(st[kq], pa);
      frag_acc(dpt[kq], da);
      const float* o0 = Os + (8 * kq + 2 * t4) * LD + n0 + g4;
      const float* qq0 = Qs + (8 * kq + 2 * t4) * LD + n0 + g4;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        mma_3xtf32(adv[n], pa, split(o0[8 * n]), split(o0[LD + 8 * n]));
        mma_3xtf32(adk[n], da, split(qq0[8 * n]), split(qq0[LD + 8 * n]));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int row = 16 * warp + g4 + 8 * ii;
      if (k0 + row >= sb) continue;
      const long long at = (kv_row0 + row) * D + n0 + 8 * n + 2 * t4;
      store2(dk + at, adk[n][2 * ii], adk[n][2 * ii + 1]);
      store2(dv + at, adv[n][2 * ii], adv[n][2 * ii + 1]);
    }
}

// ------------------------------------------------------------ float32: dQ
template <int D>
__device__ __forceinline__ void dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                                       const float* __restrict__ v,
                                       const float* __restrict__ dout,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ delta, float* __restrict__ dq,
                                       Geo geo) {
  constexpr int T = F32Plan<D>::T, TS = F32Plan<D>::TS, LD = F32Plan<D>::LD, NT = D / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Os = Qs + T * LD;
  float* Ks = Os + T * LD;
  float* Vs = Ks + TS * LD;
  const int warp = threadIdx.x / 32, g4 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int grp = blockIdx.z / geo.g, r = geo.g - 1 - blockIdx.z % geo.g;
  const int* G = geo.groups + grp * geo.g;
  const int h = blockIdx.y, kvh = h / (geo.hq / geo.hkv), sb = geo.sb, q0 = qt * T;
  const long long row0 = ((long long)G[r] * geo.hq + h) * sb;
  const DqWalk walk(geo, r, q0, T, TS);

  stage_f32<T, D>(Qs, q + (row0 + q0) * D, sb - q0);
  stage_f32<T, D>(Os, dout + (row0 + q0) * D, sb - q0);
  float L[2], Dl[2];
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int qi = q0 + 16 * warp + g4 + 8 * ii;
    L[ii] = qi < sb ? lse[row0 + qi] : 0.f;
    Dl[ii] = qi < sb ? delta[row0 + qi] : 0.f;
  }
  float adq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.f;
  const float* Qw = Qs + 16 * warp * LD;
  const float* Ow = Os + 16 * warp * LD;
  for (int i = 0; i < walk.total; ++i) {
    int arr, kt;
    walk.at(i, arr, kt);
    const int jb = (r - arr + geo.g) % geo.g, k0 = kt * TS;
    const bool diag = geo.causal && arr == 0;
    const long long kv = ((long long)G[jb] * geo.hkv + kvh) * sb + k0;
    stage_f32<TS, D>(Ks, k + kv * D, sb - k0);
    stage_f32<TS, D>(Vs, v + kv * D, sb - k0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T, dP = dO V^T (rows: this warp's 16 q, columns: 32 k)
    float s[TS / 8][4], dp[TS / 8][4];
#pragma unroll
    for (int n = 0; n < TS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < D / 8; ++ks) {
      const int c0 = 8 * ks + t4;
      Tf32x2 qa[4], oa[4];
      frag_rows(Qw, LD, g4, c0, qa);
      frag_rows(Ow, LD, g4, c0, oa);
#pragma unroll
      for (int n = 0; n < TS / 8; ++n) {
        const float* kr = Ks + (8 * n + g4) * LD + c0;
        const float* vr = Vs + (8 * n + g4) * LD + c0;
        mma_3xtf32(s[n], qa, split(kr[0]), split(kr[4]));
        mma_3xtf32(dp[n], oa, split(vr[0]), split(vr[4]));
      }
    }
#pragma unroll
    for (int n = 0; n < TS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + 16 * warp + g4 + 8 * (e >> 1);
        const int kj = k0 + 8 * n + 2 * t4 + (e & 1);
        grad_entry(s[n][e], dp[n][e], L[e >> 1], Dl[e >> 1], geo.scale,
                   kj >= sb || qi >= sb || (diag && kj > qi));
      }

    // dQ += dS K over the tile's 32 k rows
#pragma unroll
    for (int kk = 0; kk < TS / 8; ++kk) {
      Tf32x2 da[4];
      frag_acc(dp[kk], da);
      const float* kr = Ks + (8 * kk + 2 * t4) * LD + g4;
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_3xtf32(adq[n], da, split(kr[8 * n]), split(kr[LD + 8 * n]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int qi = q0 + 16 * warp + g4 + 8 * ii;
    if (qi >= sb) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      store2(dq + (row0 + qi) * D + 8 * n + 2 * t4, adq[n][2 * ii], adq[n][2 * ii + 1]);
  }
}

// ----------------------------------------------------------------- launches
template <typename E, int D> constexpr int smem_bytes() {
  return std::is_same<E, bf16>::value ? Bf16Plan<D>::SMEM : F32Plan<D>::SMEM;
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                   const E* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, E* __restrict__ dq, Geo geo) {
  if constexpr (std::is_same<E, bf16>::value) dq_bf16<D>(q, k, v, dout, lse, delta, dq, geo);
  else dq_f32<D>(q, k, v, dout, lse, delta, dq, geo);
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                    const E* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, E* __restrict__ dk, E* __restrict__ dv,
                    Geo geo) {
  if constexpr (std::is_same<E, bf16>::value) dkv_bf16<D>(q, k, v, dout, lse, delta, dk, dv, geo);
  else dkv_f32<D>(q, k, v, dout, lse, delta, dk, dv, geo);
}

template <typename E, int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, Geo geo, int ngroups, cudaStream_t s) {
  constexpr int bytes = smem_bytes<E, D>();
  int err = set_smem(attn_bwd_dq_kernel<E, D>, bytes);
  if (err) return err;
  dim3 grid((geo.sb + 63) / 64, geo.hq, ngroups * geo.g);
  attn_bwd_dq_kernel<E, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const E*>(dout), lse, delta, static_cast<E*>(dq), geo);
  return (int)cudaGetLastError();
}

template <typename E, int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, void* dk, void* dv, Geo geo, int ngroups, cudaStream_t s) {
  constexpr int bytes = smem_bytes<E, D>();
  int err = set_smem(attn_bwd_dkv_kernel<E, D>, bytes);
  if (err) return err;
  dim3 grid((geo.sb + 63) / 64 * (D / 128), geo.hkv, ngroups * geo.g);
  attn_bwd_dkv_kernel<E, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const E*>(dout), lse, delta, static_cast<E*>(dk), static_cast<E*>(dv), geo);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout [P, Hq, Sb, d], k/v [P, Hkv, Sb, d] (dtype: 0 float32, 1 bfloat16);
// lse, delta [P, Hq, Sb] float32; groups [ngroups, g] int32; dq like q.
// Every pointer 16-byte aligned.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int attn_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta,
                           void* dq, const void* groups, int ngroups, int g, int hq,
                           int hkv, int sb, int d, float scale, int causal,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geo geo = make_geo(groups, g, hq, hkv, sb, scale, causal);
  const float* L = static_cast<const float*>(lse);
  const float* Dl = static_cast<const float*>(delta);
  if (dtype == 0 && d == 128) return bwd_dq<float, 128>(q, k, v, dout, L, Dl, dq, geo, ngroups, s);
  if (dtype == 0 && d == 256) return bwd_dq<float, 256>(q, k, v, dout, L, Dl, dq, geo, ngroups, s);
  if (dtype == 1 && d == 128) return bwd_dq<bf16, 128>(q, k, v, dout, L, Dl, dq, geo, ngroups, s);
  if (dtype == 1 && d == 256) return bwd_dq<bf16, 256>(q, k, v, dout, L, Dl, dq, geo, ngroups, s);
  return kBadShape;
}

// dk, dv like k, v.
extern "C" int attn_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta,
                            void* dk, void* dv, const void* groups, int ngroups,
                            int g, int hq, int hkv, int sb, int d, float scale,
                            int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geo geo = make_geo(groups, g, hq, hkv, sb, scale, causal);
  const float* L = static_cast<const float*>(lse);
  const float* Dl = static_cast<const float*>(delta);
  if (dtype == 0 && d == 128)
    return bwd_dkv<float, 128>(q, k, v, dout, L, Dl, dk, dv, geo, ngroups, s);
  if (dtype == 0 && d == 256)
    return bwd_dkv<float, 256>(q, k, v, dout, L, Dl, dk, dv, geo, ngroups, s);
  if (dtype == 1 && d == 128)
    return bwd_dkv<bf16, 128>(q, k, v, dout, L, Dl, dk, dv, geo, ngroups, s);
  if (dtype == 1 && d == 256)
    return bwd_dkv<bf16, 256>(q, k, v, dout, L, Dl, dk, dv, geo, ngroups, s);
  return kBadShape;
}
