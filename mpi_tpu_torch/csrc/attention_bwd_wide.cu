// The backward of ring attention (attn_bwd_dq, attn_bwd_dkv) for head dims
// above 256: any d that is a multiple of 128, given at run time.  The forms
// for d = 128 and 256 are csrc/attention_bwd.cu.
//
// Replaces the Pallas TPU kernel _bwd_kernel (mpi_tpu/tpu/pallas_attention.py
// :617, algebra _pair_grad_tile :217), launched by _bwd_kernel_call (:1130),
// at the head dims attention_bwd.cu's plans do not fit: what it computes,
// and the walks, are written there.  Every block owns its outputs: no
// atomics, and every sum is in a fixed order.
//
// bf16: the chunks and the unit pipeline of attention_wide.cu.  A block
// owns one 128-column chunk c of its outputs (dQ, or dK and dV), so every
// accumulator is one m64n128, 64 registers a thread, at every d.  S = Q K^T
// and dP = dO V^T sum over the d-chunks, streamed a chunk of each of their
// four operands a unit through a ring of NS stages; at a tile's last unit
// the block forms P and dS (grad_entry) and adds its output products with
// the tile's chunk-c operands (OB below says how they are buffered): K_c
// for dQ += dS K_c; Q_c and dO_c (and the tile's lse and delta rows) for
// dV_c += P^T dO_c and dK_c += dS^T Q_c.
//   attn_bwd_dq: one block per (rank, query head, 64-row Q tile, chunk c),
//   walking the K/V tiles of the arrivals in ring order (DqWalk).
//   attn_bwd_dkv: one block per (owner block j, K/V head, 64-row K tile,
//   chunk c), walking the visiting ranks, the GQA heads and the Q/dO tiles
//   (DkvWalk).
//   One warpgroup, NS = 2: a stage holds four 64 x KC tiles in the
//   128-byte swizzle (KC 64 in attn_bwd_dq, 128 in attn_bwd_dkv); S and dP
//   (or S^T and dP^T) are m64n64k16 wgmmas over the chunks (chunk_product,
//   ring_attention.cuh), P and dS are split hi/lo into the A operands of
//   m64n128k16 wgmmas with B the chunk-c tile read MN-major.  The dq plan
//   keeps a block under half of an SM's shared memory, so that two blocks
//   share an SM and each hides the other's waits; dkv, whose two m64n128
//   accumulators leave no registers to spare, keeps one block an SM.
//   Shared memory 1 KB alignment + 8 chunk tiles + the chunk-c tiles (+ 1
//   KB of lse/delta rows): 99 328 bytes (dq), 198 656 (dkv).
//   Bound: against the reference's 6d (dq) and 8d (dkv) flops an unmasked
//   score entry, every block recomputes S and dP: dq 4d (d / 128) + 2 x 2d
//   (dS K_c split), dkv 4d (d / 128) + 2 x 4d, the design floors
//   chip_smoke.py counts.
//
// float32: a thread-block cluster forms S and dP once a tile.  The C blocks
// of a cluster (WideCluster, ring_attention.cuh: C the largest divisor of
// d / 128 that is at most 8) are the chunks of one (rank, head, own 64-row
// tile); block c owns output chunks c m .. c m + m - 1 (m = d / 128 / C: 1
// at every d <= 1024), one a pass over its walk.  For each streamed 32-row
// tile of the other side, block c forms the partials S_c = Q_c K_c^T and
// dP_c = dO_c V_c^T (attn_bwd_dkv: S^T_c = K_c Q_c^T, dP^T_c = V_c dO_c^T)
// over its own m chunks only, writes them to its shared memory, and after
// one cluster barrier every block sums the C partials over distributed
// shared memory in rank order 0..C-1, so all blocks form bit-identical P
// and dS; the partials are double-buffered by tile parity, so one barrier a
// tile suffices.  The chunk-c operands of the output products are the tile
// the partials read, so a block loads each byte of its columns once a pass.
//   Products: TF32 wgmma (sm_90a), each product three of them (a_lo b_hi +
//   a_hi b_lo + a_hi b_hi, hi = x with the low 13 bits cleared, lo = x - hi:
//   hopper.cuh's split).  A 32-bit operand is read from shared memory
//   K-major only, so the streamed tiles are B of the partials (read raw as
//   their hi, their lo written once a tile beside them) and the own tile is
//   A, split in registers; the outputs are formed transposed, dQ_c^T =
//   K_c^T dS^T, dV_c^T = dO_c^T P, dK_c^T = Q_c^T dS, with the chunk operand
//   as A (split in registers) and B the block's own P / dS tile, written
//   K-major as hi and lo tiles after the reduction.  Every chain of tensor-
//   core sums is four k steps long (32 columns of a partial, a tile of an
//   output), the hi x hi products in one and the small ones in another,
//   added by round-to-nearest float32 adds (mma_3xtf32's reason).
//   Copies: one thread of a producer warpgroup keeps TMA loads (3-D tensor
//   maps, rows past the block read as zeros, 128-byte swizzle) of the next
//   stage in flight, completing on mbarriers; two consumer warpgroups take
//   the partials S and dP, and then the outputs (dQ: 64 columns of the
//   chunk each; dK/dV: dV_c and dK_c, one accumulator each); setmaxnreg
//   gives the producers' registers to the consumers.  No __syncthreads()
//   after the set-up.
//   Shared memory (WideDqF32Plan, WideDkvF32Plan): 1 KB alignment, the own
//   tiles (2 x 64 x 128), NS = 2 stages of two 32 x 128 streamed tiles, their
//   lo tiles, the partials (2 parities x 2 x 64 x 32), the B tiles (dq: dS
//   hi and lo; dkv: P and dS, hi and lo), the mbarriers: 214 080 bytes (dq),
//   230 464 (dkv); one block of 384 threads an SM.
//   Bound: the reference's 6d (dq) and 8d (dkv) flops an entry, three TF32
//   products each: a design floor of 3 (4m + 2) d and 3 (4m + 4) d, the
//   bound at m = 1.

#include <cooperative_groups.h>
#include <math.h>

#include "ring_attention.cuh"

namespace cg = cooperative_groups;

namespace {

// KC: the product chunk's columns; NS: stages of the unit ring; OB: buffers
// of the tile's chunk-c operands, by the tile's parity, staged with its
// first unit
struct WideDqBf16Plan {
  static constexpr int T = 64, KC = 64, CT = T * KC * 2, TILE = T * 128 * 2, NS = 2, OB = 2;
  static constexpr int SMEM = 1024 + 4 * NS * CT + OB * TILE;
};
struct WideDkvBf16Plan {
  static constexpr int T = 64, KC = 128, CT = T * KC * 2, TILE = T * 128 * 2, NS = 2, OB = 2;
  static constexpr int SMEM = 1024 + 4 * NS * CT + 2 * OB * TILE + 2 * OB * T * 4;
};
// float32: T own rows, TS streamed rows a tile, NS stages; the regions of
// the shared memory in bytes, in order (OWN: two T x 128 tiles; STAGE: two
// TS x 128 tiles; LO: their lo tiles; PART: the S and dP partials of two
// tile parities; BT: the B tiles of the outputs; BARS: the mbarriers)
struct WideDqF32Plan {
  static constexpr int T = 64, TS = 32, NS = 2, OWN = 2 * T * 128 * 4, STAGE = 2 * TS * 128 * 4,
      LO = 2 * TS * 128 * 4, PART = 2 * 2 * T * TS * 4, BT = 2 * T * TS * 4, BARS = 64;
  static constexpr int SMEM = 1024 + OWN + NS * STAGE + LO + PART + BT + BARS;
};
struct WideDkvF32Plan {
  static constexpr int T = 64, TS = 32, NS = 2, OWN = 2 * T * 128 * 4, STAGE = 2 * TS * 128 * 4,
      LO = 2 * TS * 128 * 4, PART = 2 * 2 * T * TS * 4, BT = 4 * T * TS * 4, BARS = 64;
  static constexpr int SMEM = 1024 + OWN + NS * STAGE + LO + PART + BT + BARS;
};

// ----------------------------------------------------------- bf16: dQ
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_wide_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dq, Geo geo, int d) {
  using Plan = WideDqBf16Plan;
  constexpr int T = Plan::T, KC = Plan::KC, CT = Plan::CT, TILE = Plan::TILE, NS = Plan::NS;
  constexpr int OB = Plan::OB, STAGE = 4 * CT;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* St = align1024(smem_raw);  // unit u: Q, dO, K, V chunks at St + (u % NS) STAGE
  uint8_t* Kc = St + NS * STAGE;      // tile i's K_c at Kc + (i % OB) TILE
  const int nd = d / kChunk, nk = d / KC;
  const QueryBlock b(geo, nd);
  const int warp = threadIdx.x / 32, g4 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int sb = geo.sb, q0 = b.qt * T;
  const DqWalk walk(geo, b.r, q0, T, T);
  const int units = walk.total * nk;

  auto fetch = [&](int u) {
    const int i = u / nk, dc = u % nk;
    int arr, kt;
    walk.at(i, arr, kt);
    const long long kv = b.kv_row(geo, arr, kt, T), qrow = b.row0 + q0;
    uint8_t* s = St + (u % NS) * STAGE;
    stage_bf16_cols<T, KC, kThreads>(s, q + qrow * d + dc * KC, d, sb - q0);
    stage_bf16_cols<T, KC, kThreads>(s + CT, dout + qrow * d + dc * KC, d, sb - q0);
    stage_bf16_cols<T, KC, kThreads>(s + 2 * CT, k + kv * d + dc * KC, d, sb - kt * T);
    stage_bf16_cols<T, KC, kThreads>(s + 3 * CT, v + kv * d + dc * KC, d, sb - kt * T);
    if (dc == 0)
      stage_bf16_cols<T, kChunk, kThreads>(Kc + (i % OB) * TILE, k + kv * d + b.c * kChunk, d,
                                           sb - kt * T);
  };
  for (int u = 0; u < NS - 1; ++u) {
    if (u < units) fetch(u);
    cp_async_commit();
  }

  float L[2], Dl[2];
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int qi = q0 + 16 * warp + g4 + 8 * ii;
    L[ii] = qi < sb ? lse[b.row0 + qi] : 0.f;
    Dl[ii] = qi < sb ? delta[b.row0 + qi] : 0.f;
  }
  float adq[64], s[32], dp[32];
#pragma unroll
  for (int e = 0; e < 64; ++e) adq[e] = 0.f;
  for (int u = 0; u < units; ++u) {
    cp_async_wait<NS - 2>();
    fence_async_shared();
    __syncthreads();
    if (u + NS - 1 < units) fetch(u + NS - 1);
    cp_async_commit();
    const int i = u / nk, dc = u % nk;
    const uint32_t qa = smem_addr(St + (u % NS) * STAGE), oa = qa + CT;
    const uint32_t ka = qa + 2 * CT, va = qa + 3 * CT;

    // S += Q_dc K_dc^T, dP += dO_dc V_dc^T (rows: q, columns: k)
    chunk_product<KC>(s, qa, ka, dc == 0);
    chunk_product<KC>(dp, oa, va, dc == 0);
    if (dc < nk - 1) continue;

    int arr, kt;
    walk.at(i, arr, kt);
    const int k0 = kt * T;
    const bool diag = geo.causal && arr == 0;
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

    // dQ_c += dS K_c over this tile's 64 k rows
    const uint32_t kca = smem_addr(Kc + (i % OB) * TILE);
    reg_fence(adq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bk = desc_mnmajor(kca + kk * 2048, T);
      wgmma_m64n128k16_rs_tb(adq, dl[kk], bk);
      wgmma_m64n128k16_rs_tb(adq, dh[kk], bk);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(adq);
  }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int qi = q0 + 16 * warp + g4 + 8 * ii;
    if (qi >= sb) continue;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int e = 4 * jj + 2 * ii;
      store2(dq + (b.row0 + qi) * d + b.c * kChunk + 8 * jj + 2 * t4, adq[e], adq[e + 1]);
    }
  }
}

// ------------------------------------------------------- bf16: dK, dV
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_wide_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, Geo geo, int d) {
  using Plan = WideDkvBf16Plan;
  constexpr int T = Plan::T, KC = Plan::KC, CT = Plan::CT, TILE = Plan::TILE, NS = Plan::NS;
  constexpr int OB = Plan::OB, STAGE = 4 * CT;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* St = align1024(smem_raw);  // unit u: K, V, Q, dO chunks at St + (u % NS) STAGE
  uint8_t* Oc = St + NS * STAGE;      // tile i's Q_c, dO_c at Oc + 2 (i % OB) TILE
  // tile i's lse and delta rows at Rows + 2 (i % OB) T
  float* Rows = reinterpret_cast<float*>(Oc + 2 * OB * TILE);
  const int nd = d / kChunk, nk = d / KC;
  const KvBlock b(geo, nd);
  const int warp = threadIdx.x / 32, g4 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int sb = geo.sb, k0 = b.kt * T;
  const DkvWalk walk(geo, b.j, k0, T);
  const int units = walk.total * nk;
  const long long kvrow = b.kv_row0 + k0;

  auto fetch = [&](int u) {
    const int i = u / nk, dc = u % nk;
    int arr, t, qt;
    walk.at(i, arr, t, qt);
    const int q0 = qt * T;
    const long long row0 = b.q_row(geo, arr, t) + q0;
    uint8_t* s = St + (u % NS) * STAGE;
    stage_bf16_cols<T, KC, kThreads>(s, k + kvrow * d + dc * KC, d, sb - k0);
    stage_bf16_cols<T, KC, kThreads>(s + CT, v + kvrow * d + dc * KC, d, sb - k0);
    stage_bf16_cols<T, KC, kThreads>(s + 2 * CT, q + row0 * d + dc * KC, d, sb - q0);
    stage_bf16_cols<T, KC, kThreads>(s + 3 * CT, dout + row0 * d + dc * KC, d, sb - q0);
    if (dc == 0) {
      uint8_t* o = Oc + 2 * (i % OB) * TILE;
      stage_bf16_cols<T, kChunk, kThreads>(o, q + row0 * d + b.c * kChunk, d, sb - q0);
      stage_bf16_cols<T, kChunk, kThreads>(o + TILE, dout + row0 * d + b.c * kChunk, d, sb - q0);
      stage_rows<T>(Rows + 2 * (i % OB) * T, lse + row0, sb - q0);
      stage_rows<T>(Rows + (2 * (i % OB) + 1) * T, delta + row0, sb - q0);
    }
  };
  for (int u = 0; u < NS - 1; ++u) {
    if (u < units) fetch(u);
    cp_async_commit();
  }

  float adk[64], adv[64], st[32], dpt[32];
#pragma unroll
  for (int e = 0; e < 64; ++e) adk[e] = adv[e] = 0.f;
  for (int u = 0; u < units; ++u) {
    cp_async_wait<NS - 2>();
    fence_async_shared();
    __syncthreads();
    if (u + NS - 1 < units) fetch(u + NS - 1);
    cp_async_commit();
    const int i = u / nk, dc = u % nk;
    const uint32_t ka = smem_addr(St + (u % NS) * STAGE), va = ka + CT;
    const uint32_t qa = ka + 2 * CT, oa = ka + 3 * CT;

    // S^T += K_dc Q_dc^T, dP^T += V_dc dO_dc^T (rows: k, columns: q)
    chunk_product<KC>(st, ka, qa, dc == 0);
    chunk_product<KC>(dpt, va, oa, dc == 0);
    if (dc < nk - 1) continue;

    int arr, t, qt;
    walk.at(i, arr, t, qt);
    const int q0 = qt * T;
    const bool diag = geo.causal && arr == 0;
    const float* L = Rows + 2 * (i % OB) * T;
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

    // dV_c += P^T dO_c, dK_c += dS^T Q_c over this tile's 64 q rows
    const uint32_t qca = smem_addr(Oc + 2 * (i % OB) * TILE), oca = qca + TILE;
    reg_fence(adk);
    reg_fence(adv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bo = desc_mnmajor(oca + kk * 2048, T), bq = desc_mnmajor(qca + kk * 2048, T);
      wgmma_m64n128k16_rs_tb(adv, pl[kk], bo);
      wgmma_m64n128k16_rs_tb(adv, ph[kk], bo);
      wgmma_m64n128k16_rs_tb(adk, dl[kk], bq);
      wgmma_m64n128k16_rs_tb(adk, dh[kk], bq);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(adk);
    reg_fence(adv);
  }
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int row = 16 * warp + g4 + 8 * ii, e = 4 * jj + 2 * ii;
      if (k0 + row >= sb) continue;
      const long long at = (kvrow + row) * d + b.c * kChunk + 8 * jj + 2 * t4;
      store2(dk + at, adk[e], adk[e + 1]);
      store2(dv + at, adv[e], adv[e + 1]);
    }
}

// ------------------------------------------------------------ float32
// the regions of a float32 block's shared memory (the plan's order)
template <typename Plan>
struct F32Smem {
  uint8_t* own;    // [2][T x 128]: own[wg] is warpgroup wg's A operand of the partials
  uint8_t* stage;  // NS x [2][TS x 128]: the streamed tiles of a unit
  uint8_t* lo;     // [2][TS x 128]: lo[wg], the lo of stage operand wg, written by warpgroup wg
  float* part;     // [tile parity][S, dP][q 4][thread 128][4]: a warpgroup's m64n32 partial
  uint8_t* bt;     // [T x TS] B tiles of the outputs, 128-byte rows: hi, lo (x2 in dK/dV)
  uint64_t* full;  // [NS]: a stage's TMA loads landed
  uint64_t* empty;     // [NS]: the consumers are done with a stage
  uint64_t* own_full;  // the own tiles landed
  uint64_t* own_empty;  // the consumers are done with them (m > 1: reloaded every unit)
  __device__ explicit F32Smem(uint8_t* raw) {
    own = align1024(raw);
    stage = own + Plan::OWN;
    lo = stage + Plan::NS * Plan::STAGE;
    part = reinterpret_cast<float*>(lo + Plan::LO);
    bt = lo + Plan::LO + Plan::PART;
    full = reinterpret_cast<uint64_t*>(bt + Plan::BT);
    empty = full + Plan::NS;
    own_full = empty + Plan::NS;
    own_empty = own_full + 1;
  }
  // one thread, before anything else
  __device__ void init() const {
    for (int s = 0; s < Plan::NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kF32Consumers);
    }
    mbar_init(own_full, 1);
    mbar_init(own_empty, kF32Consumers);
    fence_mbar_init();
  }
};


// this warpgroup's partial (m64n32 accumulator) into its slot of the
// tile's parity, float4 q of thread t at [q][t]
__device__ __forceinline__ void put_partial(float* slot, const float (&f)[16], int t) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    reinterpret_cast<float4*>(slot)[q * 128 + t] =
        make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
}

// The tile's S and dP entries of consumer thread (wg, t): float4s 2 wg and
// 2 wg + 1 of accumulator thread t (entry 4 h + l: row 16 w + g + 8 (l / 2),
// column 8 (2 wg + h) + 2 t4 + l % 2), summed over the cluster's C
// partials in rank order
__device__ __forceinline__ void cluster_sum(float (&s8)[8], float (&p8)[8], const float* part,
                                            int C, int wg, int t) {
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int at = (2 * wg + h) * 128 + t;
    float4 s, p;
    for (int r = 0; r < C; ++r) {
      const float4* peer = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(const_cast<float*>(part), r));
      const float4 a = peer[at], b = peer[512 + at];
      if (r == 0) {
        s = a;
        p = b;
      } else {
        s.x += a.x; s.y += a.y; s.z += a.z; s.w += a.w;
        p.x += b.x; p.y += b.y; p.z += b.z; p.w += b.w;
      }
    }
    s8[4 * h] = s.x; s8[4 * h + 1] = s.y; s8[4 * h + 2] = s.z; s8[4 * h + 3] = s.w;
    p8[4 * h] = p.x; p8[4 * h + 1] = p.y; p8[4 * h + 2] = p.z; p8[4 * h + 3] = p.w;
  }
}

// ------------------------------------------------------------ float32: dQ
// A cluster per (rank, query head, 64-row Q tile); own Q and dO, streamed
// K and V in 32-row tiles (DqWalk).  Partials: warpgroup 0 S, warpgroup 1
// dP; output: dQ_c^T = K_c^T dS^T, warpgroup wg the chunk's columns
// 64 wg .. 64 wg + 63.
__global__ void __launch_bounds__(kF32Threads, 1)
attn_bwd_dq_wide_f32(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mo,
                     const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, Geo geo, int d) {
  using Plan = WideDqF32Plan;
  constexpr int T = Plan::T, TS = Plan::TS, NS = Plan::NS, HALF = Plan::STAGE / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const F32Smem<Plan> sm(smem_raw);
  const int C = cluster_blocks(d / kChunk), m = d / kChunk / C;
  const QueryBlock b(geo, C);  // b.c: the block's rank in the cluster
  const int sb = geo.sb, q0 = b.qt * T;
  const DqWalk walk(geo, b.r, q0, T, TS);
  const int tiles = m * walk.total;
  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  // unit n's chunk: the pass's output chunk comes last, so its stage holds
  // the output product's operand
  auto chunk_of = [&](int n) {
    const int nt = n / m, pass = nt / walk.total;
    return b.c * m + (pass + 1 + n % m) % m;
  };
  if (threadIdx.x >= kF32Consumers) {
    setmaxnreg_dec<kF32ProducerRegs>();
    const int zq = (int)(b.row0 / sb);
    produce<NS, 1>(tiles, m, sm.full, sm.empty, sm.own_full, sm.own_empty,
                [&](int n) {
                  const int col = chunk_of(n) * kChunk;
                  mbar_expect_tx(sm.own_full, Plan::OWN);
                  for (int cb = 0; cb < 4; ++cb) {
                    tma_load_3d(sm.own + cb * T * 128, &mq, sm.own_full, col + 32 * cb, q0, zq);
                    tma_load_3d(sm.own + (4 + cb) * T * 128, &mo, sm.own_full, col + 32 * cb, q0, zq);
                  }
                },
                [&](int n, int s) {
                  int arr, kt;
                  walk.at(n / m % walk.total, arr, kt);
                  const long long row = b.kv_row(geo, arr, kt, TS);
                  const int col = chunk_of(n) * kChunk, z = (int)(row / sb), y = (int)(row % sb);
                  uint8_t* st = sm.stage + s * Plan::STAGE;
                  mbar_expect_tx(sm.full + s, Plan::STAGE);
                  for (int cb = 0; cb < 4; ++cb) {
                    tma_load_3d(st + cb * TS * 128, &mk, sm.full + s, col + 32 * cb, y, z);
                    tma_load_3d(st + HALF + cb * TS * 128, &mv, sm.full + s, col + 32 * cb, y, z);
                  }
                });
  } else {
    setmaxnreg_inc<kF32ConsumerRegs>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128, w = t / 32, g4 = (t % 32) / 4,
              t4 = t % 4;
    float L[2], Dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + 16 * w + g4 + 8 * i;
      L[i] = qi < sb ? lse[b.row0 + qi] : 0.f;
      Dl[i] = qi < sb ? delta[b.row0 + qi] : 0.f;
    }
    const uint32_t bh = smem_addr(sm.bt), bl = bh + T * TS * 4;
    for (int pass = 0; pass < m; ++pass) {
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      for (int i = 0; i < walk.total; ++i) {
        const int nt = pass * walk.total + i;
        float part[16];
        int s = 0;
        for (int u = 0; u < m; ++u) {
          const int n = nt * m + u;
          s = n % NS;
          if (m > 1 || n == 0) mbar_wait(sm.own_full, m > 1 ? n & 1 : 0);
          mbar_wait(sm.full + s, (n / NS) & 1);
          const uint8_t* st = sm.stage + s * Plan::STAGE + wg * HALF;
          uint8_t* lo = sm.lo + wg * HALF;
          named_sync(2 + wg, 128);  // the warpgroup's last reads of lo are done
          write_lo<TS, 4>(lo, st, 0, t);
          fence_async_shared();
          named_sync(2 + wg, 128);
          float f[16];
          partial_blocks<T, TS, 4>(f, sm.own + wg * (Plan::OWN / 2), smem_addr(st), smem_addr(lo), 0, w,
                               g4, t4);
#pragma unroll
          for (int e = 0; e < 16; ++e) part[e] = u == 0 ? f[e] : part[e] + f[e];
          if (m > 1) mbar_arrive(sm.own_empty);
          if (u < m - 1) mbar_arrive(sm.empty + s);
        }
        float* slot = sm.part + (nt & 1) * (2 * T * TS);
        put_partial(slot + wg * T * TS, part, t);
        cluster_sync();

        // P and dS of this thread's 8 entries, from the summed partials
        int arr, kt;
        walk.at(i, arr, kt);
        const int k0 = kt * TS;
        const bool diag = geo.causal && arr == 0;
        float s8[8], p8[8];
        cluster_sum(s8, p8, slot, C, wg, t);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            const int row = 16 * w + g4 + 8 * i2, col = 8 * (2 * wg + h) + 2 * t4;
            const int qi = q0 + row;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * h + 2 * i2 + c, kj = k0 + col + c;
              grad_entry(s8[e], p8[e], L[i2], Dl[i2], geo.scale,
                         kj >= sb || qi >= sb || (diag && kj > qi));
            }
            put_split2<T>(sm.bt, sm.bt + T * TS * 4, row, col, p8[4 * h + 2 * i2],
                          p8[4 * h + 2 * i2 + 1]);
          }
        fence_async_shared();
        named_sync(1, kF32Consumers);

        // dQ_c^T (this warpgroup's 64 columns) += K_c^T dS^T
        float f[32];
        output_half<TS>(f, sm.stage + s * Plan::STAGE, 64 * wg, bh, bl, w, g4, t4);
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] += f[e];
        mbar_arrive(sm.empty + s);
      }
      // acc[4j + 2i + c] = dQ[q0 + 8j + 2 t4 + c][chunk column 64 wg + 16 w + g4 + 8i]
      const int col0 = (b.c * m + pass) * kChunk + 64 * wg + 16 * w + g4;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = q0 + 8 * j + 2 * t4 + c;
          if (qi >= sb) continue;
          float* out = dq + (b.row0 + qi) * d + col0;
          out[0] = acc[4 * j + c];
          out[8] = acc[4 * j + 2 + c];
        }
    }
    cluster_sync();  // no block leaves while a peer may read its partials
  }
}

// -------------------------------------------------------- float32: dK, dV
// A cluster per (owner j, K/V head, 64-row K tile); own K and V, streamed
// Q and dO in 32-row tiles with their lse and delta (DkvWalk).  Partials:
// warpgroup 0 S^T, warpgroup 1 dP^T; outputs: warpgroup 0 dV_c^T = dO_c^T P,
// warpgroup 1 dK_c^T = Q_c^T dS, each the chunk's 128 columns in two halves.
__global__ void __launch_bounds__(kF32Threads, 1)
attn_bwd_dkv_wide_f32(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mo,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, Geo geo, int d) {
  using Plan = WideDkvF32Plan;
  constexpr int T = Plan::T, TS = Plan::TS, NS = Plan::NS, HALF = Plan::STAGE / 2;
  constexpr int BTILE = T * TS * 4;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const F32Smem<Plan> sm(smem_raw);
  const int C = cluster_blocks(d / kChunk), m = d / kChunk / C;
  const KvBlock b(geo, C);  // b.c: the block's rank in the cluster
  const int sb = geo.sb, k0 = b.kt * T;
  const DkvWalk walk(geo, b.j, k0, TS);
  const int tiles = m * walk.total;
  const long long kvrow = b.kv_row0 + k0;
  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  auto chunk_of = [&](int n) {
    const int nt = n / m, pass = nt / walk.total;
    return b.c * m + (pass + 1 + n % m) % m;
  };
  if (threadIdx.x >= kF32Consumers) {
    setmaxnreg_dec<kF32ProducerRegs>();
    const int zk = (int)(b.kv_row0 / sb);
    produce<NS, 1>(tiles, m, sm.full, sm.empty, sm.own_full, sm.own_empty,
                [&](int n) {
                  const int col = chunk_of(n) * kChunk;
                  mbar_expect_tx(sm.own_full, Plan::OWN);
                  for (int cb = 0; cb < 4; ++cb) {
                    tma_load_3d(sm.own + cb * T * 128, &mk, sm.own_full, col + 32 * cb, k0, zk);
                    tma_load_3d(sm.own + (4 + cb) * T * 128, &mv, sm.own_full, col + 32 * cb, k0, zk);
                  }
                },
                [&](int n, int s) {
                  int arr, ht, qt;
                  walk.at(n / m % walk.total, arr, ht, qt);
                  const int z = (int)(b.q_row(geo, arr, ht) / sb), y = qt * TS;
                  const int col = chunk_of(n) * kChunk;
                  uint8_t* st = sm.stage + s * Plan::STAGE;
                  mbar_expect_tx(sm.full + s, Plan::STAGE);
                  for (int cb = 0; cb < 4; ++cb) {
                    tma_load_3d(st + cb * TS * 128, &mq, sm.full + s, col + 32 * cb, y, z);
                    tma_load_3d(st + HALF + cb * TS * 128, &mo, sm.full + s, col + 32 * cb, y, z);
                  }
                });
  } else {
    setmaxnreg_inc<kF32ConsumerRegs>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128, w = t / 32, g4 = (t % 32) / 4,
              t4 = t % 4;
    // warpgroup 0: P (B of dV), A = dO (stage operand 1); warpgroup 1: dS, A = Q (operand 0)
    const uint32_t bh = smem_addr(sm.bt) + 2 * wg * BTILE, bl = bh + BTILE;
    for (int pass = 0; pass < m; ++pass) {
      float acc[2][32];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[h][e] = 0.f;
      for (int i = 0; i < walk.total; ++i) {
        const int nt = pass * walk.total + i;
        int arr, ht, qt;
        walk.at(i, arr, ht, qt);
        const int q0 = qt * TS;
        const long long qrow = b.q_row(geo, arr, ht) + q0;
        // lse and delta of this thread's columns (q rows), fetched early
        float L[2][2], Dl[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * (2 * wg + h) + 2 * t4 + c;
            const bool ok = q0 + col < sb;
            L[h][c] = ok ? lse[qrow + col] : 0.f;
            Dl[h][c] = ok ? delta[qrow + col] : 0.f;
          }
        float part[16];
        int s = 0;
        for (int u = 0; u < m; ++u) {
          const int n = nt * m + u;
          s = n % NS;
          if (m > 1 || n == 0) mbar_wait(sm.own_full, m > 1 ? n & 1 : 0);
          mbar_wait(sm.full + s, (n / NS) & 1);
          const uint8_t* st = sm.stage + s * Plan::STAGE + wg * HALF;
          uint8_t* lo = sm.lo + wg * HALF;
          named_sync(2 + wg, 128);  // the warpgroup's last reads of lo are done
          write_lo<TS, 4>(lo, st, 0, t);
          fence_async_shared();
          named_sync(2 + wg, 128);
          float f[16];
          partial_blocks<T, TS, 4>(f, sm.own + wg * (Plan::OWN / 2), smem_addr(st), smem_addr(lo), 0, w,
                               g4, t4);
#pragma unroll
          for (int e = 0; e < 16; ++e) part[e] = u == 0 ? f[e] : part[e] + f[e];
          if (m > 1) mbar_arrive(sm.own_empty);
          if (u < m - 1) mbar_arrive(sm.empty + s);
        }
        float* slot = sm.part + (nt & 1) * (2 * T * TS);
        put_partial(slot + wg * T * TS, part, t);
        cluster_sync();

        // P and dS (rows: k, columns: q) of this thread's 8 entries
        const bool diag = geo.causal && arr == 0;
        float s8[8], p8[8];
        cluster_sum(s8, p8, slot, C, wg, t);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            const int row = 16 * w + g4 + 8 * i2, col = 8 * (2 * wg + h) + 2 * t4;
            const int kj = k0 + row;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * h + 2 * i2 + c, qi = q0 + col + c;
              grad_entry(s8[e], p8[e], L[h][c], Dl[h][c], geo.scale,
                         qi >= sb || (diag && kj > qi));
            }
            const int e = 4 * h + 2 * i2;
            put_split2<T>(sm.bt, sm.bt + BTILE, row, col, s8[e], s8[e + 1]);
            put_split2<T>(sm.bt + 2 * BTILE, sm.bt + 3 * BTILE, row, col, p8[e], p8[e + 1]);
          }
        fence_async_shared();
        named_sync(1, kF32Consumers);

        // warpgroup 0: dV_c^T += dO_c^T P; warpgroup 1: dK_c^T += Q_c^T dS
        const uint8_t* a = sm.stage + s * Plan::STAGE + (1 - wg) * HALF;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float f[32];
          output_half<TS>(f, a, 64 * h, bh, bl, w, g4, t4);
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[h][e] += f[e];
        }
        mbar_arrive(sm.empty + s);
      }
      // acc[h][4j + 2i + c] = dX[k0 + 8j + 2 t4 + c][chunk column 64 h + 16 w + g4 + 8i]
      float* out = wg == 0 ? dv : dk;
      const int col0 = (b.c * m + pass) * kChunk + 16 * w + g4;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int row = 8 * j + 2 * t4 + c;
          if (k0 + row >= sb) continue;
          float* o = out + (kvrow + row) * d + col0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            o[64 * h] = acc[h][4 * j + c];
            o[64 * h + 8] = acc[h][4 * j + 2 + c];
          }
        }
    }
    cluster_sync();  // no block leaves while a peer may read its partials
  }
}

// ------------------------------------------- wgmma's reading of a raw word
// D = A B^T with A the 64 x 8 matrix whose first 8 rows are the identity
// (exact in TF32) and B = b, 32 x 8 raw float32 words in shared memory: out
// (64 x 32) holds in out[k][n] (k < 8) the value b[n][k] as the tensor core
// read it, and zeros below
__global__ void __launch_bounds__(128) wgmma_tf32_probe_kernel(const float* __restrict__ b,
                                                               float* __restrict__ out) {
  __shared__ __align__(16) uint8_t raw[32 * 128 + 1024];
  uint8_t* tile = align1024(raw);
  const int t = threadIdx.x, w = t / 32, g4 = (t % 32) / 4, t4 = t % 4;
  for (int i = t; i < 32 * 32; i += 128)
    *reinterpret_cast<float*>(tile + sw128_f32(i / 32, i % 32, 32)) = i % 32 < 8 ? b[i / 32 * 8 + i % 32] : 0.f;
  fence_async_shared();
  __syncthreads();
  const int r = 16 * w + g4;
  const uint32_t one = __float_as_uint(1.f);
  const uint32_t a[4] = {r == t4 ? one : 0u, r + 8 == t4 ? one : 0u, r == t4 + 4 ? one : 0u,
                         r + 8 == t4 + 4 ? one : 0u};
  float f[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) f[e] = 0.f;
  reg_fence(f);
  wgmma_fence();
  wgmma_m64n32k8_tf32(f, a, desc_kmajor(smem_addr(tile)), 0);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(f);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) out[(r + 8 * i) * 32 + 8 * j + 2 * t4 + c] = f[4 * j + 2 * i + c];
}

// ----------------------------------------------------------------- launches
template <typename E, typename Plan, typename K>
int launch_dq(K kernel, const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, Geo geo, int ngroups, int d,
              cudaStream_t s) {
  int err = set_smem(kernel, Plan::SMEM);
  if (err) return err;
  dim3 grid((geo.sb + Plan::T - 1) / Plan::T * (d / kChunk), geo.hq, ngroups * geo.g);
  kernel<<<grid, kThreads, Plan::SMEM, s>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const E*>(dout), lse, delta, static_cast<E*>(dq), geo, d);
  return (int)cudaGetLastError();
}

template <typename E, typename Plan, typename K>
int launch_dkv(K kernel, const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, Geo geo, int ngroups,
               int d, cudaStream_t s) {
  int err = set_smem(kernel, Plan::SMEM);
  if (err) return err;
  dim3 grid((geo.sb + Plan::T - 1) / Plan::T * (d / kChunk), geo.hkv, ngroups * geo.g);
  kernel<<<grid, kThreads, Plan::SMEM, s>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const E*>(dout), lse, delta, static_cast<E*>(dk), static_cast<E*>(dv), geo,
      d);
  return (int)cudaGetLastError();
}

// the float32 forms' four tensor maps: own operands in boxes of T rows,
// streamed ones in boxes of TS
template <typename Plan>
int f32_maps(CUtensorMap (&maps)[4], const void* own0, const void* own1, int own_heads,
             const void* str0, const void* str1, int str_heads, int nranks, int sb, int d) {
  int err = f32_map(&maps[0], own0, d, sb, nranks * own_heads, Plan::T);
  if (!err) err = f32_map(&maps[1], own1, d, sb, nranks * own_heads, Plan::T);
  if (!err) err = f32_map(&maps[2], str0, d, sb, nranks * str_heads, Plan::TS);
  if (!err) err = f32_map(&maps[3], str1, d, sb, nranks * str_heads, Plan::TS);
  return err;
}

}  // namespace

// The arguments of attn_bwd_dq / attn_bwd_dkv (csrc/attention_bwd.cu), d a
// multiple of 128 above 256.
extern "C" int attn_bwd_dq_wide(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, const void* groups, int ngroups, int g, int hq,
                                int hkv, int sb, int d, float scale, int causal,
                                int dtype, void* stream) {
  if (d <= 256 || d % kChunk) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geo geo = make_geo(groups, g, hq, hkv, sb, scale, causal);
  const float* L = static_cast<const float*>(lse);
  const float* Dl = static_cast<const float*>(delta);
  if (dtype == 0) {
    using Plan = WideDqF32Plan;
    CUtensorMap maps[4];
    const int err = f32_maps<Plan>(maps, q, dout, hq, k, v, hkv, ngroups * g, sb, d);
    if (err) return err;
    const int C = cluster_blocks(d / kChunk);
    const dim3 grid((sb + Plan::T - 1) / Plan::T * C, hq, ngroups * g);
    return launch_cluster<Plan>(attn_bwd_dq_wide_f32, grid, kF32Threads, C, s, maps[0], maps[1], maps[2],
                                maps[3], L, Dl, static_cast<float*>(dq), geo, d);
  }
  if (dtype == 1)
    return launch_dq<bf16, WideDqBf16Plan>(attn_bwd_dq_wide_bf16, q, k, v, dout, L, Dl, dq,
                                            geo, ngroups, d, s);
  return kBadShape;
}

extern "C" int attn_bwd_dkv_wide(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, const void* groups, int ngroups,
                                 int g, int hq, int hkv, int sb, int d, float scale,
                                 int causal, int dtype, void* stream) {
  if (d <= 256 || d % kChunk) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geo geo = make_geo(groups, g, hq, hkv, sb, scale, causal);
  const float* L = static_cast<const float*>(lse);
  const float* Dl = static_cast<const float*>(delta);
  if (dtype == 0) {
    using Plan = WideDkvF32Plan;
    CUtensorMap maps[4];
    const int err = f32_maps<Plan>(maps, k, v, hkv, q, dout, hq, ngroups * g, sb, d);
    if (err) return err;
    const int C = cluster_blocks(d / kChunk);
    const dim3 grid((sb + Plan::T - 1) / Plan::T * C, hkv, ngroups * g);
    return launch_cluster<Plan>(attn_bwd_dkv_wide_f32, grid, kF32Threads, C, s, maps[0], maps[1], maps[2],
                                maps[3], L, Dl, static_cast<float*>(dk), static_cast<float*>(dv),
                                geo, d);
  }
  if (dtype == 1)
    return launch_dkv<bf16, WideDkvBf16Plan>(attn_bwd_dkv_wide_bf16, q, k, v, dout, L, Dl, dk,
                                             dv, geo, ngroups, d, s);
  return kBadShape;
}

// out (64 x 32 float32) = the probe's product of b (32 x 8 float32): rows 0-7
// hold b transposed as TF32 wgmma read its raw words
extern "C" int wgmma_tf32_probe(const void* b, void* out, void* stream) {
  wgmma_tf32_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
