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
// (no atomics, deterministic sums).  attn_bwd_dkv's block holds a K/V tile
// and walks the visiting ranks, the GQA heads and the Q/dO tiles (on the
// diagonal only q-tiles that reach the k-tile); attn_bwd_dq's holds a Q/dO
// tile and walks the arrivals' K/V tiles in ring order, the heaviest blocks
// first (under causal masking rank g-1 has g arrivals and rank 0 one).
//   bf16 (attn_bwd_dq_bf16_kernel, attn_bwd_dkv_bf16_kernel): 384 threads,
//   one block an SM.  A producer warpgroup gives its registers to the two
//   consumer warpgroups (setmaxnreg, 40 and 232 a thread), and one of its
//   threads keeps the streamed tiles in flight by TMA (3-D tensor maps,
//   128-byte swizzle, rows past Sb read as zeros; lse and delta by 1-D
//   maps) into NS stages with full and empty mbarriers; the consumers issue
//   no copy and pass no block-wide barrier.  S (S^T) and dP (dP^T) are
//   m64nTS wgmmas with both tiles K-major in shared memory; P and dS are
//   split into hi and lo bf16 A operands of m64n128k16 wgmmas whose B (dO,
//   Q or K, MN-major for this product) is the streamed tile read with the
//   transpose bit.  Products stay in flight under the gradient math, in
//   each warpgroup: tile i's S and dP products are issued before tile
//   i - 1's output products, so while the warpgroup turns tile i's S and dP
//   into P and dS, the tensor core runs tile i - 1's output products
//   (wgmma_wait<1>, then wgmma_wait<0> before tile i's fragments are
//   written; see the consumers' loop); the two warpgroups,
//   each on its own tiles, fill each other's gaps.  The other way,
//   ping-pong of the warpgroups on named barriers, orders the two
//   warpgroups' math against each other's products but leaves each
//   warpgroup's own products waiting on its math; here a warpgroup's
//   products run under its own math, with no barrier a tile.
//   attn_bwd_dq: 128 Q rows a block, 64 a warpgroup (dQ: 64 or 128
//   registers a thread), K/V tiles of TS = 64 rows (d = 128, NS = 4) or 32
//   (d = 256, NS = 3, so that 128 rows of Q and dO fit beside them); dS
//   stays in registers (the A operand of dS K).
//   attn_bwd_dkv: Q/dO tiles of TS = 32 rows with their lse and delta,
//   NS = 4: S^T and dP^T (32 registers a thread), the output accumulators
//   (128) and tile i - 1's P and dS fragments in flight (32) fit the
//   consumers' 232 registers (with 64-row tiles they spilled).  At d = 128:
//   128 K rows a block, 64 a warpgroup with its dK and dV.  At d = 256 a
//   64 x 256 float32 accumulator is 128 registers
//   a thread, so the block keeps 64 K rows and gives each warpgroup one
//   output: warpgroup 0 forms S^T, P and dV += P^T dO, warpgroup 1 dP^T,
//   dS and dK += dS^T Q, so S^T and dP^T are formed once a K tile (the
//   earlier form ran a block for each 128-column half, each forming both);
//   P goes to warpgroup 1 through shared memory (two tile parities, named
//   barriers).
//   The order of every sum is the earlier one-warpgroup form's: S and dP one
//   tensor-core chain over d; an output one tensor-core accumulator over
//   the whole walk, per 16-row k step its lo then hi product.  A 128-row
//   block adds exact zeros where its rows lie past the diagonal or Sb.
//   Bound: the reference's 6d (dq) and 8d (dkv) flops an entry; the hi/lo
//   split doubles the output products, a design floor of 8d and 12d, 1.33x
//   and 1.5x the bound (2x over both kernels' 10d).  Shared memory
//   (DqBf16Plan, DkvBf16Plan): 197 696 / 230 464 bytes (dq, d = 128 / 256),
//   133 184 / 215 104 (dkv).
//   float32 (four warps of 16 rows): one block per (rank, head, 64-row
//   tile) for dq and per (owner, K/V head, 64-row K tile, 128-column half
//   of d) for dkv (dK and dV, 64 x 128 float32 each: 64 registers a
//   thread); resident tiles of 64 rows and one stage of 32-row streamed
//   tiles staged by cp.async, row stride d + 4: (2 x 64 + 2 x 32) (d + 4) x
//   4 + 256 bytes = 101 632 at d = 128 (two blocks an SM), 199 936 at d =
//   256.  The accumulator of P or dS is the A operand of the next m16n8k8
//   with its k index permuted (k = t <-> column 2t, k = t + 4 <-> 2t + 1);
//   the B rows are read in the same permutation.

#include <math.h>

#include <type_traits>

#include "ring_attention.cuh"

namespace {

template <int D> struct F32Plan {
  static constexpr int T = 64, TS = 32, LD = D + 4;
  static constexpr int SMEM = (2 * T + 2 * TS) * LD * 4 + 2 * TS * 4;
};

// ------------------------------------------------------------------- bf16
// The bf16 kernels: ring_attention.cuh's producer and consumers (Bf16Smem,
// stream_tiles, rows_product, DqCursor, prob); the dK/dV block's walk,
// stepped a tile at a time (DkvWalk::at divides)
struct DkvCursor {
  int arr, t, qt;
  __device__ explicit DkvCursor(const DkvWalk& w) : arr(0), t(0), qt(w.qs) {}
  __device__ void next(const DkvWalk& w, int rep) {
    if (++qt < w.nq) return;
    qt = arr == 0 ? w.qs : 0;
    if (++t < rep) return;
    t = qt = 0;
    ++arr;
  }
};

// The consumers' loop, in each bf16 form: iteration i issues tile i's S
// and dP products, then tile i - 1's output products, one commit group
// each; wgmma_wait<1> finds S and dP done and leaves the outputs running on
// the tensor core while the warpgroup turns S and dP into P and dS (the
// exponentials, the masks); wgmma_wait<0> then frees tile i - 1's stage and
// fragments, and P and dS are split into tile i's.  No group is in flight across the loop's back edge: where one
// was (tile i + 1's S and dP issued before tile i's outputs), ptxas
// serialised every wgmma of the kernel (C7514, on the first builds).

// --------------------------------------------------------------- bf16: dQ
// A block per (rank, query head, 128-row Q tile), the heaviest first (the
// last rank of a group, its last q-tile); warpgroup wg owns Q rows 64 wg ..
// 64 wg + 63 and their dQ (NH x 64 registers a thread).  K and V stream in
// TS-row tiles (DqWalk).
template <int D> struct DqBf16Plan {
  static constexpr int T = 128, TS = D == 128 ? 64 : 32, NS = D == 128 ? 4 : 3,
      OWN = 2 * T * D * 2, STAGE = 2 * TS * D * 2, XCH = 0, ROWS = 0, BARS = 64;
  static constexpr int SMEM = 1024 + OWN + NS * STAGE + XCH + NS * ROWS + BARS;
};

template <int D>
__global__ void __launch_bounds__(kClusterThreads, 1)
attn_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mo,
                        const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, Geo geo) {
  using Plan = DqBf16Plan<D>;
  constexpr int T = Plan::T, TS = Plan::TS, NS = Plan::NS, NH = D / 128, NB = D / 64;
  constexpr int OWN1 = Plan::OWN / 2, HALF = Plan::STAGE / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Bf16Smem<Plan> sm(smem_raw);
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int grp = blockIdx.z / geo.g, r = geo.g - 1 - blockIdx.z % geo.g;
  const int* G = geo.groups + grp * geo.g;
  const int h = blockIdx.y, kvh = h / (geo.hq / geo.hkv), sb = geo.sb, q0 = qt * T;
  const int zq = G[r] * geo.hq + h;  // the query head's plane
  const long long row0 = (long long)zq * sb;
  const DqWalk walk(geo, r, q0, T, TS);
  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    stream_tiles<NS>(
        walk.total, sm.empty,
        [&] {
          mbar_expect_tx(sm.own_full, Plan::OWN);
          for (int cb = 0; cb < NB; ++cb) {
            tma_load_3d(sm.own + cb * T * 128, &mq, sm.own_full, 64 * cb, q0, zq);
            tma_load_3d(sm.own + OWN1 + cb * T * 128, &mo, sm.own_full, 64 * cb, q0, zq);
          }
        },
        [&](int n, int s) {
          int arr, kt;
          walk.at(n, arr, kt);
          const int z = G[(r - arr + geo.g) % geo.g] * geo.hkv + kvh, y = kt * TS;
          uint8_t* st = sm.stage + s * Plan::STAGE;
          mbar_expect_tx(sm.full + s, Plan::STAGE);
          for (int cb = 0; cb < NB; ++cb) {
            tma_load_3d(st + cb * TS * 128, &mk, sm.full + s, 64 * cb, y, z);
            tma_load_3d(st + HALF + cb * TS * 128, &mv, sm.full + s, 64 * cb, y, z);
          }
        });
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128, w = t / 32, g4 = (t % 32) / 4,
              t4 = t % 4;
    const int qw = q0 + 64 * wg;  // the warpgroup's first row
    float L[2], Dl[2];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int qi = qw + 16 * w + g4 + 8 * ii;
      L[ii] = qi < sb ? lse[row0 + qi] : 0.f;
      Dl[ii] = qi < sb ? delta[row0 + qi] : 0.f;
    }
    float adq[NH][64];
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) zero(adq[nh]);
    const uint32_t qa = smem_addr(sm.own) + wg * 64 * 128, oa = qa + OWN1;
    float s[TS / 2], dp[TS / 2];     // S = Q K^T, dP = dO V^T (rows: q, columns: k)
    uint32_t dh[TS / 16][4], dl[TS / 16][4];  // dS, hi and lo
    auto products = [&](int i) {
      mbar_wait(sm.full + i % NS, (i / NS) & 1);
      const uint32_t ka = smem_addr(sm.stage + (i % NS) * Plan::STAGE);
      wgmma_fence();
      rows_product<D, T, TS>(s, qa, ka);
      rows_product<D, T, TS>(dp, oa, ka + HALF);
      wgmma_commit();
    };
    const float scale2 = geo.scale * kLog2e, L2[2] = {L[0] * kLog2e, L[1] * kLog2e};
    DqCursor cur;
    auto grads = [&] {  // tile `cur`'s P and dS, in place; masks only where a tile needs them
      const int k0 = cur.kt * TS;
      const bool diag = geo.causal && cur.arr == 0;
      auto entries = [&](auto edge) {
        constexpr bool masks = decltype(edge)::value;
#pragma unroll
        for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int qi = qw + 16 * w + g4 + 8 * ii;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * jj + 2 * ii + c, kj = k0 + 8 * jj + 2 * t4 + c;
              s[e] = prob(s[e], scale2, L2[ii],
                          masks && (kj >= sb || qi >= sb || (diag && kj > qi)));
              dp[e] = s[e] * (dp[e] - Dl[ii]) * geo.scale;
            }
          }
      };
      if (diag || k0 + TS > sb || qw + 64 > sb) entries(std::true_type());
      else entries(std::false_type());
      cur.next(walk);
    };
    auto output = [&](int i) {  // dQ += dS K over tile i's TS k rows, by 128-column half
      const uint32_t ka = smem_addr(sm.stage + (i % NS) * Plan::STAGE);
      wgmma_fence();
#pragma unroll
      for (int nh = 0; nh < NH; ++nh)
#pragma unroll
        for (int kk = 0; kk < TS / 16; ++kk) {
          const uint64_t bk = desc_mnmajor(ka + 2 * nh * (TS * 128) + kk * 2048, TS);
          wgmma_m64n128k16_rs_tb(adq[nh], dl[kk], bk);
          wgmma_m64n128k16_rs_tb(adq[nh], dh[kk], bk);
        }
      wgmma_commit();
    };
    mbar_wait(sm.own_full, 0);
    products(0);
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    grads();
#pragma unroll
    for (int kk = 0; kk < TS / 16; ++kk) acc_to_frag(dp, kk, dh[kk], dl[kk]);
#pragma unroll 1
    for (int i = 1; i < walk.total; ++i) {
      products(i);
      output(i - 1);
      wgmma_wait<1>();  // tile i's S and dP; tile i - 1's dQ product runs on
      reg_fence(s);
      reg_fence(dp);
      grads();
      wgmma_wait<0>();
#pragma unroll
      for (int nh = 0; nh < NH; ++nh) reg_fence(adq[nh]);
      mbar_arrive(sm.empty + (i - 1) % NS);
#pragma unroll
      for (int kk = 0; kk < TS / 16; ++kk) acc_to_frag(dp, kk, dh[kk], dl[kk]);
    }
    output(walk.total - 1);
    wgmma_wait<0>();
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) reg_fence(adq[nh]);
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int qi = qw + 16 * w + g4 + 8 * ii;
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
}

// ------------------------------------------------------------ bf16: dK, dV
// A block per (owner j, K/V head, K tile), owners in order (owner 0 visits
// the most ranks under causal).  Q and dO stream in TS-row tiles with their
// lse and delta rows (DkvWalk).
//   d = 128: a 128-row K tile; warpgroup wg owns K rows 64 wg .. 64 wg + 63
//   and their dK and dV, and forms S^T and dP^T of its rows.
//   d = 256: a 64-row K tile both warpgroups share, one output each (a
//   64 x 256 float32 accumulator is 128 registers a thread): warpgroup 0
//   forms S^T, then P, hands P to warpgroup 1 through the exchange region
//   (two tile parities, named barriers 4 + parity "P is there" and 6 +
//   parity "its slot is free") and sums dV += P^T dO; warpgroup 1 forms
//   dP^T, then dS = P (dP^T - delta) scale, and sums dK += dS^T Q.
template <int D> struct DkvBf16Plan {
  static constexpr int T = D == 128 ? 128 : 64, TS = 32, NS = 4, OWN = 2 * T * D * 2,
      STAGE = 2 * TS * D * 2, XCH = D == 128 ? 0 : 2 * 64 * TS * 4, ROWS = 2 * TS * 4,
      BARS = 64;
  static constexpr int SMEM = 1024 + OWN + NS * STAGE + XCH + NS * ROWS + BARS;
};

template <int D>
__global__ void __launch_bounds__(kClusterThreads, 1)
attn_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mo,
                         const __grid_constant__ CUtensorMap ml, const __grid_constant__ CUtensorMap md,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, Geo geo) {
  using Plan = DkvBf16Plan<D>;
  constexpr int T = Plan::T, TS = Plan::TS, NS = Plan::NS, NB = D / 64;
  constexpr int OWN1 = Plan::OWN / 2, HALF = Plan::STAGE / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Bf16Smem<Plan> sm(smem_raw);
  const int kt = blockIdx.x, member = blockIdx.z, j = member % geo.g;  // the K/V block's owner
  const int* G = geo.groups + (member - j);
  const int kvh = blockIdx.y, rep = geo.hq / geo.hkv, sb = geo.sb, k0 = kt * T;
  const int zk = G[j] * geo.hkv + kvh;  // the K/V head's plane
  const long long kv_row0 = (long long)zk * sb + k0;
  const DkvWalk walk(geo, j, k0, TS);
  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    stream_tiles<NS>(
        walk.total, sm.empty,
        [&] {
          mbar_expect_tx(sm.own_full, Plan::OWN);
          for (int cb = 0; cb < NB; ++cb) {
            tma_load_3d(sm.own + cb * T * 128, &mk, sm.own_full, 64 * cb, k0, zk);
            tma_load_3d(sm.own + OWN1 + cb * T * 128, &mv, sm.own_full, 64 * cb, k0, zk);
          }
        },
        [&](int n, int s) {
          int arr, ht, qt;
          walk.at(n, arr, ht, qt);
          const int z = G[(j + arr) % geo.g] * geo.hq + kvh * rep + ht, y = qt * TS;
          uint8_t* st = sm.stage + s * Plan::STAGE;
          float* rw = sm.rows + s * 2 * TS;
          mbar_expect_tx(sm.full + s, Plan::STAGE + Plan::ROWS);
          for (int cb = 0; cb < NB; ++cb) {
            tma_load_3d(st + cb * TS * 128, &mq, sm.full + s, 64 * cb, y, z);
            tma_load_3d(st + HALF + cb * TS * 128, &mo, sm.full + s, 64 * cb, y, z);
          }
          tma_load_1d(rw, &ml, sm.full + s, z * sb + y);
          tma_load_1d(rw + TS, &md, sm.full + s, z * sb + y);
        });
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, w = t / 32, g4 = (t % 32) / 4,
            t4 = t % 4;
  if constexpr (D == 128) {
    const int kw = k0 + 64 * wg;  // the warpgroup's first row
    const uint32_t ka = smem_addr(sm.own) + wg * 64 * 128, va = ka + OWN1;
    float adk[64], adv[64];
    zero(adk);
    zero(adv);
    float st[TS / 2], dpt[TS / 2];  // S^T = K Q^T, dP^T = V dO^T (rows: k, columns: q)
    auto products = [&](int i) {
      mbar_wait(sm.full + i % NS, (i / NS) & 1);
      const uint32_t qa = smem_addr(sm.stage + (i % NS) * Plan::STAGE);
      wgmma_fence();
      rows_product<D, T, TS>(st, ka, qa);
      rows_product<D, T, TS>(dpt, va, qa + HALF);
      wgmma_commit();
    };
    const float scale2 = geo.scale * kLog2e;
    DkvCursor cur(walk);
    auto grads = [&](int i) {  // tile i's P^T and dS^T, in place
      const int q0 = cur.qt * TS;
      const bool diag = geo.causal && cur.arr == 0;
      const float* L = sm.rows + (i % NS) * 2 * TS;
      const float* Dl = L + TS;
      auto entries = [&](auto edge) {
        constexpr bool masks = decltype(edge)::value;
#pragma unroll
        for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * jj + 2 * t4 + c, qi = q0 + col;
            const float l2 = L[col] * kLog2e, dl = Dl[col];
#pragma unroll
            for (int ii = 0; ii < 2; ++ii) {
              const int e = 4 * jj + 2 * ii + c, kj = kw + 16 * w + g4 + 8 * ii;
              st[e] = prob(st[e], scale2, l2, masks && (qi >= sb || (diag && kj > qi)));
              dpt[e] = st[e] * (dpt[e] - dl) * geo.scale;
            }
          }
      };
      if (diag || q0 + TS > sb) entries(std::true_type());
      else entries(std::false_type());
      cur.next(walk, rep);
    };
    uint32_t ph[TS / 16][4], pl[TS / 16][4], dh[TS / 16][4], dl[TS / 16][4];
    auto frags = [&] {  // P^T and dS^T, hi and lo, as A fragments
#pragma unroll
      for (int kk = 0; kk < TS / 16; ++kk) {
        acc_to_frag(st, kk, ph[kk], pl[kk]);
        acc_to_frag(dpt, kk, dh[kk], dl[kk]);
      }
    };
    auto outputs = [&](int i) {  // dV += P^T dO, dK += dS^T Q over tile i's TS q rows
      const uint32_t qa = smem_addr(sm.stage + (i % NS) * Plan::STAGE), oa = qa + HALF;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TS / 16; ++kk) {
        const uint64_t bo = desc_mnmajor(oa + kk * 2048, TS), bq = desc_mnmajor(qa + kk * 2048, TS);
        wgmma_m64n128k16_rs_tb(adv, pl[kk], bo);
        wgmma_m64n128k16_rs_tb(adv, ph[kk], bo);
        wgmma_m64n128k16_rs_tb(adk, dl[kk], bq);
        wgmma_m64n128k16_rs_tb(adk, dh[kk], bq);
      }
      wgmma_commit();
    };
    mbar_wait(sm.own_full, 0);
    products(0);
    wgmma_wait<0>();
    reg_fence(st);
    reg_fence(dpt);
    grads(0);
    frags();
#pragma unroll 1
    for (int i = 1; i < walk.total; ++i) {
      products(i);
      outputs(i - 1);
      wgmma_wait<1>();  // tile i's S^T and dP^T; tile i - 1's outputs run on
      reg_fence(st);
      reg_fence(dpt);
      grads(i);
      wgmma_wait<0>();  // tile i - 1's fragments and stage are free
      reg_fence(adk);
      reg_fence(adv);
      mbar_arrive(sm.empty + (i - 1) % NS);
      frags();
    }
    outputs(walk.total - 1);
    wgmma_wait<0>();
    reg_fence(adk);
    reg_fence(adv);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int row = 64 * wg + 16 * w + g4 + 8 * ii, e = 4 * jj + 2 * ii;
        if (k0 + row >= sb) continue;
        const long long at_out = (kv_row0 + row) * D + 8 * jj + 2 * t4;
        store2(dk + at_out, adk[e], adk[e + 1]);
        store2(dv + at_out, adv[e], adv[e + 1]);
      }
  } else {
    const uint32_t xa = smem_addr(sm.own + wg * OWN1);  // K (warpgroup 0) or V
    float* px = reinterpret_cast<float*>(sm.xch);       // P of parity p at px + p 64 TS
    float acc[2][64];                                   // dV or dK, by 128-column half
    zero(acc[0]);
    zero(acc[1]);
    float x[TS / 2];  // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T
    uint32_t fh[TS / 16][4], fl[TS / 16][4];  // P or dS, hi and lo
    auto products = [&](int i) {
      mbar_wait(sm.full + i % NS, (i / NS) & 1);
      wgmma_fence();
      rows_product<D, T, TS>(x, xa, smem_addr(sm.stage + (i % NS) * Plan::STAGE + wg * HALF));
      wgmma_commit();
    };
    const float scale2 = geo.scale * kLog2e;
    DkvCursor cur(walk);
    auto grads = [&](int i) {  // warpgroup 0: P, handed over; warpgroup 1: dS; in place
      const int q0 = cur.qt * TS, par = i & 1;
      const bool diag = geo.causal && cur.arr == 0;
      cur.next(walk, rep);
      const float* R = sm.rows + (i % NS) * 2 * TS + wg * TS;  // lse or delta
      float4* slot = reinterpret_cast<float4*>(px + par * 64 * TS);
      if (wg == 0) {
        auto entries = [&](auto edge) {
          constexpr bool masks = decltype(edge)::value;
#pragma unroll
          for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col = 8 * jj + 2 * t4 + c, qi = q0 + col;
              const float l2 = R[col] * kLog2e;
#pragma unroll
              for (int ii = 0; ii < 2; ++ii) {
                const int e = 4 * jj + 2 * ii + c, kj = k0 + 16 * w + g4 + 8 * ii;
                x[e] = prob(x[e], scale2, l2, masks && (qi >= sb || (diag && kj > qi)));
              }
            }
        };
        if (diag || q0 + TS > sb) entries(std::true_type());
        else entries(std::false_type());
        if (i >= 2) named_sync(6 + par, 256);  // warpgroup 1 has read tile i - 2's P
#pragma unroll
        for (int q = 0; q < TS / 8; ++q)
          slot[q * 128 + t] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
        named_arrive(4 + par, 256);
      } else {
        named_sync(4 + par, 256);  // tile i's P is there
#pragma unroll
        for (int q = 0; q < TS / 8; ++q) {
          const float4 p = slot[q * 128 + t];
          const float pe[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = 4 * q + u, col = 8 * q + 2 * t4 + (u & 1);
            x[e] = pe[u] * (x[e] - R[col]) * geo.scale;
          }
        }
        if (i + 2 < walk.total) named_arrive(6 + par, 256);
      }
    };
    auto output = [&](int i) {  // warpgroup 0: dV += P^T dO; 1: dK += dS^T Q, by half
      const uint32_t b = smem_addr(sm.stage + (i % NS) * Plan::STAGE + (1 - wg) * HALF);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TS / 16; ++kk)
#pragma unroll
        for (int nh = 0; nh < 2; ++nh) {
          const uint64_t bb = desc_mnmajor(b + 2 * nh * (TS * 128) + kk * 2048, TS);
          wgmma_m64n128k16_rs_tb(acc[nh], fl[kk], bb);
          wgmma_m64n128k16_rs_tb(acc[nh], fh[kk], bb);
        }
      wgmma_commit();
    };
    mbar_wait(sm.own_full, 0);
    products(0);
    wgmma_wait<0>();
    reg_fence(x);
    grads(0);
#pragma unroll
    for (int kk = 0; kk < TS / 16; ++kk) acc_to_frag(x, kk, fh[kk], fl[kk]);
#pragma unroll 1
    for (int i = 1; i < walk.total; ++i) {
      products(i);
      output(i - 1);
      wgmma_wait<1>();  // tile i's S^T (dP^T); tile i - 1's output product runs on
      reg_fence(x);
      grads(i);
      wgmma_wait<0>();
      reg_fence(acc[0]);
      reg_fence(acc[1]);
      mbar_arrive(sm.empty + (i - 1) % NS);
#pragma unroll
      for (int kk = 0; kk < TS / 16; ++kk) acc_to_frag(x, kk, fh[kk], fl[kk]);
    }
    output(walk.total - 1);
    wgmma_wait<0>();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    bf16* out = wg == 0 ? dv : dk;
#pragma unroll
    for (int nh = 0; nh < 2; ++nh)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int row = 16 * w + g4 + 8 * ii, e = 4 * jj + 2 * ii;
          if (k0 + row >= sb) continue;
          store2(out + (kv_row0 + row) * D + 128 * nh + 8 * jj + 2 * t4, acc[nh][e], acc[nh][e + 1]);
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
// float32 (E is float: the bf16 forms are the kernels above)
template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                   const E* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, E* __restrict__ dq, Geo geo) {
  dq_f32<D>(q, k, v, dout, lse, delta, dq, geo);
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                    const E* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, E* __restrict__ dk, E* __restrict__ dv,
                    Geo geo) {
  dkv_f32<D>(q, k, v, dout, lse, delta, dk, dv, geo);
}

template <int D>
int bwd_dq_f32(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dq, Geo geo, int ngroups, cudaStream_t s) {
  constexpr int bytes = F32Plan<D>::SMEM;
  int err = set_smem(attn_bwd_dq_kernel<float, D>, bytes);
  if (err) return err;
  dim3 grid((geo.sb + 63) / 64, geo.hq, ngroups * geo.g);
  attn_bwd_dq_kernel<float, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), geo);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dkv_f32(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dk, void* dv, Geo geo, int ngroups, cudaStream_t s) {
  constexpr int bytes = F32Plan<D>::SMEM;
  int err = set_smem(attn_bwd_dkv_kernel<float, D>, bytes);
  if (err) return err;
  dim3 grid((geo.sb + 63) / 64 * (D / 128), geo.hkv, ngroups * geo.g);
  attn_bwd_dkv_kernel<float, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), geo);
  return (int)cudaGetLastError();
}

// lse or delta, [n] float32, as a 1-D tensor map in boxes of `rows`: a box
// past the end reads zeros
int rows_map(CUtensorMap* map, const float* base, long long n, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[1] = {(cuuint64_t)n}, strides[1] = {(cuuint64_t)n * 4};
  const cuuint32_t box[1] = {(cuuint32_t)rows}, unit[1] = {1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadMap;
}

template <int D>
int bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dq, Geo geo, int ngroups, cudaStream_t s) {
  using Plan = DqBf16Plan<D>;
  const int planes = ngroups * geo.g;
  CUtensorMap mq, mo, mk, mv;
  int err = bf16_map(&mq, q, D, geo.sb, planes * geo.hq, Plan::T);
  if (!err) err = bf16_map(&mo, dout, D, geo.sb, planes * geo.hq, Plan::T);
  if (!err) err = bf16_map(&mk, k, D, geo.sb, planes * geo.hkv, Plan::TS);
  if (!err) err = bf16_map(&mv, v, D, geo.sb, planes * geo.hkv, Plan::TS);
  if (!err) err = set_smem(attn_bwd_dq_bf16_kernel<D>, Plan::SMEM);
  if (err) return err;
  dim3 grid((geo.sb + Plan::T - 1) / Plan::T, geo.hq, planes);
  attn_bwd_dq_bf16_kernel<D><<<grid, kClusterThreads, Plan::SMEM, s>>>(
      mq, mo, mk, mv, lse, delta, static_cast<bf16*>(dq), geo);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* delta, void* dk, void* dv, Geo geo, int ngroups, cudaStream_t s) {
  using Plan = DkvBf16Plan<D>;
  const int planes = ngroups * geo.g;
  CUtensorMap mk, mv, mq, mo, ml, md;
  int err = bf16_map(&mk, k, D, geo.sb, planes * geo.hkv, Plan::T);
  if (!err) err = bf16_map(&mv, v, D, geo.sb, planes * geo.hkv, Plan::T);
  if (!err) err = bf16_map(&mq, q, D, geo.sb, planes * geo.hq, Plan::TS);
  if (!err) err = bf16_map(&mo, dout, D, geo.sb, planes * geo.hq, Plan::TS);
  if (!err) err = rows_map(&ml, lse, (long long)planes * geo.hq * geo.sb, Plan::TS);
  if (!err) err = rows_map(&md, delta, (long long)planes * geo.hq * geo.sb, Plan::TS);
  if (!err) err = set_smem(attn_bwd_dkv_bf16_kernel<D>, Plan::SMEM);
  if (err) return err;
  dim3 grid((geo.sb + Plan::T - 1) / Plan::T, geo.hkv, planes);
  attn_bwd_dkv_bf16_kernel<D><<<grid, kClusterThreads, Plan::SMEM, s>>>(
      mk, mv, mq, mo, ml, md, static_cast<bf16*>(dk), static_cast<bf16*>(dv), geo);
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
  if (dtype == 0 && d == 128) return bwd_dq_f32<128>(q, k, v, dout, L, Dl, dq, geo, ngroups, s);
  if (dtype == 0 && d == 256) return bwd_dq_f32<256>(q, k, v, dout, L, Dl, dq, geo, ngroups, s);
  if (dtype == 1 && d == 128) return bwd_dq_bf16<128>(q, k, v, dout, L, Dl, dq, geo, ngroups, s);
  if (dtype == 1 && d == 256) return bwd_dq_bf16<256>(q, k, v, dout, L, Dl, dq, geo, ngroups, s);
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
  if (dtype == 0 && d == 128) return bwd_dkv_f32<128>(q, k, v, dout, L, Dl, dk, dv, geo, ngroups, s);
  if (dtype == 0 && d == 256) return bwd_dkv_f32<256>(q, k, v, dout, L, Dl, dk, dv, geo, ngroups, s);
  if (dtype == 1 && d == 128) return bwd_dkv_bf16<128>(q, k, v, dout, L, Dl, dk, dv, geo, ngroups, s);
  if (dtype == 1 && d == 256) return bwd_dkv_bf16<256>(q, k, v, dout, L, Dl, dk, dv, geo, ngroups, s);
  return kBadShape;
}
