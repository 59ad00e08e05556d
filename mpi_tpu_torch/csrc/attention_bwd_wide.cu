// The backward of ring attention (attn_bwd_dq, attn_bwd_dkv) for head dims
// above 256: any d that is a multiple of 128, given at run time.  The forms
// for d = 128 and 256 are csrc/attention_bwd.cu.
//
// Replaces the Pallas TPU kernel _bwd_kernel (mpi_tpu/tpu/pallas_attention.py
// :617, algebra _pair_grad_tile :217), launched by _bwd_kernel_call (:1130),
// at the head dims attention_bwd.cu's plans do not fit: what it computes,
// and the walks, are written there.
//
// Design: the chunks and the unit pipeline of attention_wide.cu.  A block
// owns one 128-column chunk c of its outputs (dQ, or dK and dV), so every
// accumulator is one m64n128 (bf16) or 16 m16n8 fragments (float32), 64
// registers a thread each, at every d.  S = Q K^T and dP = dO V^T sum over
// the d-chunks, streamed a chunk of each of their four operands a unit
// through a ring of NS stages; at a tile's last unit the block forms P and
// dS (grad_entry) and adds its output products with the tile's chunk-c
// operands (OB below says how they are buffered): K_c for dQ += dS K_c;
// Q_c and dO_c (and the tile's lse and delta rows) for dV_c += P^T dO_c and
// dK_c += dS^T Q_c.  Every block owns its outputs: no atomics, and the sums
// are in a fixed order.
//   attn_bwd_dq: one block per (rank, query head, 64-row Q tile, chunk c),
//   walking the K/V tiles of the arrivals in ring order (DqWalk).
//   attn_bwd_dkv: one block per (owner block j, K/V head, 64-row K tile,
//   chunk c), walking the visiting ranks, the GQA heads and the Q/dO tiles
//   (DkvWalk).
//   The plans (below) keep a block under half of an SM's shared memory
//   where that was faster on the card at d = 512, so that two blocks share
//   an SM and each hides the other's waits; the bf16 attn_bwd_dkv, whose
//   two m64n128 accumulators leave no registers to spare, spilled more and
//   ran longer in such a plan, and keeps one block an SM.
//   bf16 (one warpgroup; NS = 2): a stage holds four 64 x KC tiles in the
//   128-byte swizzle (KC 64 in attn_bwd_dq, 128 in attn_bwd_dkv); S and dP
//   (or S^T and dP^T) are m64n64k16 wgmmas over the chunks (chunk_product,
//   ring_attention.cuh), P and dS are split hi/lo into the A operands of
//   m64n128k16 wgmmas with B the chunk-c tile read MN-major.  Shared memory
//   1 KB alignment + 8 chunk tiles + the chunk-c tiles (+ 1 KB of lse/delta
//   rows): 99 328 bytes (dq), 198 656 (dkv).
//   float32 (four warps of 16 rows of the block's own side, 64 rows; the
//   other side in 32-row tiles; 32-column product chunks of row stride 36;
//   chunk-c tiles of 32 rows at row stride 132; NS = 2): attn_bwd_dq
//   2 x 2 x (64 + 32) x 36 x 4 + 2 x 32 x 132 x 4 = 89 088 bytes,
//   attn_bwd_dkv with one buffer of its two chunk-c operands and rows
//   2 x 2 x (64 + 32) x 36 x 4 + 2 x 32 x 132 x 4 + 2 x 32 x 4 = 89 344.
//
// What bounds them.  Against the reference's 6d (dq) and 8d (dkv) flops an
// unmasked score entry, every block recomputes S and dP: dq 4d (d / 128) +
// 2 x 2d (dS K_c split), dkv 4d (d / 128) + 2 x 4d in bf16 products; in
// float32 3 x (4d (d / 128) + 2d) and 3 x (4d (d / 128) + 4d) at the TF32
// rate: the design floors chip_smoke.py counts.

#include <math.h>

#include "ring_attention.cuh"

namespace {

// KC: the product chunk's columns; NS: stages of the unit ring; OB: buffers
// of the tile's chunk-c operands (2: by the tile's parity, staged with its
// first unit; 1: staged with its second unit, once the tile before has
// used them, which needs NS <= 2)
struct WideDqBf16Plan {
  static constexpr int T = 64, KC = 64, CT = T * KC * 2, TILE = T * 128 * 2, NS = 2, OB = 2;
  static constexpr int SMEM = 1024 + 4 * NS * CT + OB * TILE;
};
struct WideDkvBf16Plan {
  static constexpr int T = 64, KC = 128, CT = T * KC * 2, TILE = T * 128 * 2, NS = 2, OB = 2;
  static constexpr int SMEM = 1024 + 4 * NS * CT + 2 * OB * TILE + 2 * OB * T * 4;
};
struct WideDqF32Plan {
  static constexpr int T = 64, TS = 32, KC = 32, LDC = KC + 4, LDO = 128 + 4, NS = 2, OB = 2;
  static constexpr int SMEM = (NS * 2 * (T + TS) * LDC + OB * TS * LDO) * 4;
};
struct WideDkvF32Plan {
  static constexpr int T = 64, TS = 32, KC = 32, LDC = KC + 4, LDO = 128 + 4, NS = 2, OB = 1;
  static constexpr int SMEM = (NS * 2 * (T + TS) * LDC + 2 * OB * TS * LDO + 2 * OB * TS) * 4;
};

// the unit of a tile that stages its chunk-c operands, by buffering
template <typename Plan> __host__ __device__ constexpr int operand_unit() {
  static_assert(Plan::OB == 2 || Plan::NS <= 2, "one operand buffer needs NS <= 2");
  return Plan::OB == 2 ? 0 : 1;
}

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
    if (dc == operand_unit<Plan>())
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
    if (dc == operand_unit<Plan>()) {
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

// ------------------------------------------------------------ float32: dQ
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_wide_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, Geo geo, int d) {
  using Plan = WideDqF32Plan;
  constexpr int T = Plan::T, TS = Plan::TS, KC = Plan::KC, LDC = Plan::LDC, LDO = Plan::LDO;
  constexpr int NS = Plan::NS, OB = Plan::OB, STAGE = 2 * (T + TS) * LDC;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* St = reinterpret_cast<float*>(smem_raw);  // unit u: Q, dO (T rows), K, V (TS rows)
  float* Kc = St + NS * STAGE;                     // tile i's K_c at Kc + (i % OB) TS LDO
  const int nd = d / kChunk, nk = d / KC;
  const QueryBlock b(geo, nd);
  const int warp = threadIdx.x / 32, g4 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int sb = geo.sb, q0 = b.qt * T;
  const DqWalk walk(geo, b.r, q0, T, TS);
  const int units = walk.total * nk;

  auto fetch = [&](int u) {
    const int i = u / nk, dc = u % nk;
    int arr, kt;
    walk.at(i, arr, kt);
    const long long kv = b.kv_row(geo, arr, kt, TS), qrow = b.row0 + q0;
    float* s = St + (u % NS) * STAGE;
    stage_f32_cols<T, KC, kThreads>(s, q + qrow * d + dc * KC, d, sb - q0);
    stage_f32_cols<T, KC, kThreads>(s + T * LDC, dout + qrow * d + dc * KC, d, sb - q0);
    stage_f32_cols<TS, KC, kThreads>(s + 2 * T * LDC, k + kv * d + dc * KC, d, sb - kt * TS);
    stage_f32_cols<TS, KC, kThreads>(s + (2 * T + TS) * LDC, v + kv * d + dc * KC, d,
                                     sb - kt * TS);
    if (dc == operand_unit<Plan>())
      stage_f32_cols<TS, kChunk, kThreads>(Kc + (i % OB) * TS * LDO, k + kv * d + b.c * kChunk,
                                           d, sb - kt * TS);
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
  float adq[16][4], s[TS / 8][4], dp[TS / 8][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.f;
  for (int u = 0; u < units; ++u) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (u + NS - 1 < units) fetch(u + NS - 1);
    cp_async_commit();
    const int i = u / nk, dc = u % nk;
    const float* Qw = St + (u % NS) * STAGE + 16 * warp * LDC;
    const float* Ow = Qw + T * LDC;
    const float* Ks = St + (u % NS) * STAGE + 2 * T * LDC;
    const float* Vs = Ks + TS * LDC;

    // S += Q_dc K_dc^T, dP += dO_dc V_dc^T (rows: this warp's 16 q, columns: 32 k)
    if (dc == 0) {
#pragma unroll
      for (int n = 0; n < TS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll 2
    for (int ks = 0; ks < KC / 8; ++ks) {
      const int c0 = 8 * ks + t4;
      Tf32x2 qa[4], oa[4];
      frag_rows(Qw, LDC, g4, c0, qa);
      frag_rows(Ow, LDC, g4, c0, oa);
#pragma unroll
      for (int n = 0; n < TS / 8; ++n) {
        const float* kr = Ks + (8 * n + g4) * LDC + c0;
        const float* vr = Vs + (8 * n + g4) * LDC + c0;
        mma_3xtf32(s[n], qa, split(kr[0]), split(kr[4]));
        mma_3xtf32(dp[n], oa, split(vr[0]), split(vr[4]));
      }
    }
    if (dc < nk - 1) continue;

    int arr, kt;
    walk.at(i, arr, kt);
    const int k0 = kt * TS;
    const bool diag = geo.causal && arr == 0;
#pragma unroll
    for (int n = 0; n < TS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + 16 * warp + g4 + 8 * (e >> 1);
        const int kj = k0 + 8 * n + 2 * t4 + (e & 1);
        grad_entry(s[n][e], dp[n][e], L[e >> 1], Dl[e >> 1], geo.scale,
                   kj >= sb || qi >= sb || (diag && kj > qi));
      }

    // dQ_c += dS K_c over the tile's 32 k rows
    const float* Kt = Kc + (i % OB) * TS * LDO;
#pragma unroll
    for (int kk = 0; kk < TS / 8; ++kk) {
      Tf32x2 da[4];
      frag_acc(dp[kk], da);
      const float* kr = Kt + (8 * kk + 2 * t4) * LDO + g4;
#pragma unroll
      for (int n = 0; n < 16; ++n) mma_3xtf32(adq[n], da, split(kr[8 * n]), split(kr[LDO + 8 * n]));
    }
  }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int qi = q0 + 16 * warp + g4 + 8 * ii;
    if (qi >= sb) continue;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      store2(dq + (b.row0 + qi) * d + b.c * kChunk + 8 * n + 2 * t4, adq[n][2 * ii],
             adq[n][2 * ii + 1]);
  }
}

// -------------------------------------------------------- float32: dK, dV
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_wide_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, Geo geo, int d) {
  using Plan = WideDkvF32Plan;
  constexpr int T = Plan::T, TS = Plan::TS, KC = Plan::KC, LDC = Plan::LDC, LDO = Plan::LDO;
  constexpr int NS = Plan::NS, OB = Plan::OB, STAGE = 2 * (T + TS) * LDC;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* St = reinterpret_cast<float*>(smem_raw);  // unit u: K, V (T rows), Q, dO (TS rows)
  float* Oc = St + NS * STAGE;                     // tile i's Q_c, dO_c at Oc + 2 (i % OB) TS LDO
  float* Rows = Oc + 2 * OB * TS * LDO;            // tile i's lse, delta at Rows + 2 (i % OB) TS
  const int nd = d / kChunk, nk = d / KC;
  const KvBlock b(geo, nd);
  const int warp = threadIdx.x / 32, g4 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int sb = geo.sb, k0 = b.kt * T;
  const DkvWalk walk(geo, b.j, k0, TS);
  const int units = walk.total * nk;
  const long long kvrow = b.kv_row0 + k0;

  auto fetch = [&](int u) {
    const int i = u / nk, dc = u % nk;
    int arr, t, qt;
    walk.at(i, arr, t, qt);
    const int q0 = qt * TS;
    const long long row0 = b.q_row(geo, arr, t) + q0;
    float* s = St + (u % NS) * STAGE;
    stage_f32_cols<T, KC, kThreads>(s, k + kvrow * d + dc * KC, d, sb - k0);
    stage_f32_cols<T, KC, kThreads>(s + T * LDC, v + kvrow * d + dc * KC, d, sb - k0);
    stage_f32_cols<TS, KC, kThreads>(s + 2 * T * LDC, q + row0 * d + dc * KC, d, sb - q0);
    stage_f32_cols<TS, KC, kThreads>(s + (2 * T + TS) * LDC, dout + row0 * d + dc * KC, d,
                                     sb - q0);
    if (dc == operand_unit<Plan>()) {
      float* o = Oc + 2 * (i % OB) * TS * LDO;
      stage_f32_cols<TS, kChunk, kThreads>(o, q + row0 * d + b.c * kChunk, d, sb - q0);
      stage_f32_cols<TS, kChunk, kThreads>(o + TS * LDO, dout + row0 * d + b.c * kChunk, d,
                                           sb - q0);
      stage_rows<TS>(Rows + 2 * (i % OB) * TS, lse + row0, sb - q0);
      stage_rows<TS>(Rows + (2 * (i % OB) + 1) * TS, delta + row0, sb - q0);
    }
  };
  for (int u = 0; u < NS - 1; ++u) {
    if (u < units) fetch(u);
    cp_async_commit();
  }

  float adk[16][4], adv[16][4], st[TS / 8][4], dpt[TS / 8][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  for (int u = 0; u < units; ++u) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (u + NS - 1 < units) fetch(u + NS - 1);
    cp_async_commit();
    const int i = u / nk, dc = u % nk;
    const float* Kw = St + (u % NS) * STAGE + 16 * warp * LDC;
    const float* Vw = Kw + T * LDC;
    const float* Qs = St + (u % NS) * STAGE + 2 * T * LDC;
    const float* Os = Qs + TS * LDC;

    // S^T += K_dc Q_dc^T, dP^T += V_dc dO_dc^T (rows: this warp's 16 k, columns: 32 q)
    if (dc == 0) {
#pragma unroll
      for (int n = 0; n < TS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    }
#pragma unroll 2
    for (int ks = 0; ks < KC / 8; ++ks) {
      const int c0 = 8 * ks + t4;
      Tf32x2 ka[4], va[4];
      frag_rows(Kw, LDC, g4, c0, ka);
      frag_rows(Vw, LDC, g4, c0, va);
#pragma unroll
      for (int n = 0; n < TS / 8; ++n) {
        const float* qr = Qs + (8 * n + g4) * LDC + c0;
        const float* orow = Os + (8 * n + g4) * LDC + c0;
        mma_3xtf32(st[n], ka, split(qr[0]), split(qr[4]));
        mma_3xtf32(dpt[n], va, split(orow[0]), split(orow[4]));
      }
    }
    if (dc < nk - 1) continue;

    int arr, t, qt;
    walk.at(i, arr, t, qt);
    const int q0 = qt * TS;
    const bool diag = geo.causal && arr == 0;
    const float* L = Rows + 2 * (i % OB) * TS;
    const float* Dl = L + TS;
#pragma unroll
    for (int n = 0; n < TS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t4 + (e & 1), qi = q0 + col;
        const int kj = k0 + 16 * warp + g4 + 8 * (e >> 1);
        grad_entry(st[n][e], dpt[n][e], L[col], Dl[col], geo.scale,
                   qi >= sb || (diag && kj > qi));
      }

    // dV_c += P^T dO_c, dK_c += dS^T Q_c over the tile's 32 q rows
    const float* Qt = Oc + 2 * (i % OB) * TS * LDO;
    const float* Ot = Qt + TS * LDO;
#pragma unroll
    for (int kq = 0; kq < TS / 8; ++kq) {
      Tf32x2 pa[4], da[4];
      frag_acc(st[kq], pa);
      frag_acc(dpt[kq], da);
      const float* o0 = Ot + (8 * kq + 2 * t4) * LDO + g4;
      const float* qq0 = Qt + (8 * kq + 2 * t4) * LDO + g4;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        mma_3xtf32(adv[n], pa, split(o0[8 * n]), split(o0[LDO + 8 * n]));
        mma_3xtf32(adk[n], da, split(qq0[8 * n]), split(qq0[LDO + 8 * n]));
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int row = 16 * warp + g4 + 8 * ii;
      if (k0 + row >= sb) continue;
      const long long at = (kvrow + row) * d + b.c * kChunk + 8 * n + 2 * t4;
      store2(dk + at, adk[n][2 * ii], adk[n][2 * ii + 1]);
      store2(dv + at, adv[n][2 * ii], adv[n][2 * ii + 1]);
    }
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
  if (dtype == 0)
    return launch_dq<float, WideDqF32Plan>(attn_bwd_dq_wide_f32, q, k, v, dout, L, Dl, dq, geo,
                                           ngroups, d, s);
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
  if (dtype == 0)
    return launch_dkv<float, WideDkvF32Plan>(attn_bwd_dkv_wide_f32, q, k, v, dout, L, Dl, dk,
                                             dv, geo, ngroups, d, s);
  if (dtype == 1)
    return launch_dkv<bf16, WideDkvBf16Plan>(attn_bwd_dkv_wide_bf16, q, k, v, dout, L, Dl, dk,
                                             dv, geo, ngroups, d, s);
  return kBadShape;
}
