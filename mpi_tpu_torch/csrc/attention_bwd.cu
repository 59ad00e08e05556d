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
//   float32 inputs: every operand is split into TF32 hi = x with its low 13
//   bits cleared and lo = x - hi, and a product is a_lo b_hi + a_hi b_lo +
//   a_hi b_hi (within about 3 x 2^-20 relative; plain TF32 would leave the
//   float32 tolerance): three TF32 products an entry's product, so the
//   bound is 6d and 8d flops an entry at a third of the TF32 rate.
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
//   written; see the consumers' loop; the fragments in flight are pinned
//   to that wait, keep in ring_attention.cuh); the two warpgroups,
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
//   float32 (attn_bwd_dq_f32_kernel, attn_bwd_dkv_f32_kernel): the same
//   producer and two consumer warpgroups on TF32 wgmma (m64nNk8), 64 own
//   rows a block, streamed tiles of TS = 32 rows.  wgmma reads a 32-bit
//   operand from shared memory K-major only, so, as the forms above d = 256
//   (attention_bwd_wide.cu) do:
//     S (S^T) and dP (dP^T): A the own tile (its lo read by ldmatrix, whose
//     b16 layout is the TF32 A fragment's, and split in registers); B the
//     streamed tile read raw (the tensor core takes a raw word's TF32 bits,
//     truncated) with its lo rows, which the producer's warps 1-3 write once
//     it landed, right after each 32-column block's raw rows, so that one
//     m64n64 wgmma over [b_hi; b_lo] forms a_hi b_hi and a_hi b_lo together.
//     Warpgroup 0 forms S (S^T) and P, warpgroup 1 dP (dP^T) and dS; P goes
//     to warpgroup 1 through shared memory (dq: in the dS tiles, where dS is
//     written over it), named barriers between them, no block-wide barrier
//     a tile.
//     Outputs formed transposed, dQ^T = K^T dS^T, dV^T = dO^T P, dK^T =
//     Q^T dS: A the streamed tile transposed, split once a staging, B the
//     block's own P or dS tile, written K-major as hi rows then lo rows.
//   At d = 128 (DqF32Plan, DkvF32Plan: 230 464 / 230 976 bytes) the own
//   tiles' hi comes from the same ldmatrix (a_hi [b_hi; b_lo] one
//   register-A wgmma) and the streamed tiles land whole in two stages, each
//   output's A taking its lo from the stage: dQ, each warpgroup 64 of the
//   128 columns, a_hi [b_hi; b_lo] as one m64n128 wgmma, tile i - 1's
//   product issued after tile i's S (dP) and in flight under tile i's P
//   (dS); dK/dV: warpgroup 0 dV, 1 dK, each in two 64-column halves after
//   the tile's P (dS), in 64 accumulator registers (the merged product's 96
//   beside dV^T's 64 spilled; with a half in flight under the next tile's P
//   a warpgroup would need more than its 232 registers).
//   At d = 256 (DqF32UnitPlan, DkvF32UnitPlan) the own 64-row tiles alone
//   are 131 072 bytes and a stage of two streamed 32-row tiles with their lo
//   rows another 131 072, past the 232 448 a block may use, so the streamed
//   side comes as column-chunk units through one ring of four 16 384-byte
//   slots: 1 024 alignment + 131 072 own + 65 536 ring + 32 768 B tiles
//   (+ 512 dK/dV's lse and delta rows) + 104 of mbarriers = 230 504 (dq) /
//   231 016 (dK/dV) bytes.  A forming unit is one operand's 32 rows x 64
//   columns with its lo rows (S, dP: two 32-column blocks of d, chained in
//   order, so a tile's chunks are taken one after another and the whole
//   tile is never needed at once); an output unit its 32 rows x 128
//   columns raw, the A of two m64 blocks (128 columns of d), split once by
//   the one warpgroup that reads it.  The ring alternates the warpgroups'
//   units (unit n is warpgroup n & 1's), a tile's forming units first and
//   its output units after them, the chunks streamed a second time from
//   L2; the next tile's first units land under the outputs.  The own
//   tile's hi is read by the tensor core from shared memory (a_hi
//   [b_hi; b_lo] with A K-major in shared memory), its lo by ldmatrix.
//   dq: the 128 columns of dQ a warpgroup as two m64 blocks in
//   out_issue_small's chains (64 registers), one tile behind S and dP
//   (tile i - 1's after tile i's P and dS: warpgroup 0 never waits for
//   dS); 240 registers a consumer thread, 24 the producer's.  dK/dV: S^T and dP^T
//   once a K tile (the four-warp form formed them once per 128-column half
//   of d), warpgroup 0 dV^T and 1 dK^T over the whole of d (128 accumulator
//   registers a thread), an m64 block at a time in two halves of the own
//   rows (32 registers each); 232 registers.  The outputs are not in
//   flight under the next tile's gradient math: the registers do not allow
//   it (no spill at these splits, with the addresses of a unit's words four
//   registers and the lse and delta rows read from shared memory; 128
//   accumulators and one m64 block's A and products left no room).
//   Every chain of tensor-core sums is four k steps long (a 32-column block
//   of S and dP, a 32-row tile of an output): a_hi b_hi one chain, the small
//   products one or two more, added as a_hi b_hi + (a_lo b_hi + a_hi b_lo)
//   by round-to-nearest float32 adds (PR 18 measured 0.475 of the float32
//   allowance at four k steps and 1.49 over a 128-column chain); an output
//   is a float32 running sum over the block's walk; the order of sums is the
//   same at d = 128 and 256.  Tiles with no masked entry and no row past Sb
//   take an unmasked path; the consumers step their walks (dq: DqCursor;
//   dK/dV: its q-tile alone, the diagonal's tiles being the first
//   walk.first); P is 2^(S scale log2(e) - lse log2(e)) by ex2.approx.
//   Bound: the reference's 6d and 8d flops an entry, three TF32 products
//   each, and this form multiplies no more (the design floor is the
//   bound); at d = 256 it reads more: the streamed tiles twice from L2 (the
//   second time for the outputs: dq K again, 32 KB a tile beside the first
//   64 KB of K and V; dK/dV Q and dO again, 64 KB beside 64 KB), and dK/dV's
//   outputs issue m64n32 products (twice the instructions of m64n64 for the
//   same flops).
//   What the four-warp form that the float32 kernels replaced waited on, and
//   what this form does about it: its products ran as warp products at a
//   third of mma.sync's TF32 rate (here wgmma, a_hi meeting b_hi and b_lo
//   in one); no copy overlapped the products (here TMA into a ring from a
//   producer); every warp split the same streamed tile again (here its lo
//   is written once a staging, each own tile split once a tile by the one
//   warpgroup that reads it, an output's A once by the one that reads it);
//   its float32 adds joined one k step's partials (here chains of four); at
//   d = 256 dK/dV formed S^T and dP^T once per 128-column half (here once a
//   K tile); every entry tested the mask and every tile divided (here an
//   unmasked path and stepped walks).

#include <math.h>

#include <type_traits>

#include "ring_attention.cuh"

namespace {

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
// fragments (their registers pinned to it by keep: the compiler may not give
// them another value while the tensor core reads them), and P and dS are
// split into tile i's.  No group is in flight across the loop's back edge: where one
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
      keep(dh);  // tile i - 1's dS, in flight under grads(): its registers to here
      keep(dl);
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
      keep(ph);  // in flight under grads(i): their registers to here
      keep(pl);
      keep(dh);
      keep(dl);
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
      keep(fh);  // tile i - 1's P (dS), in flight under grads(i): its registers to here
      keep(fl);
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

// ----------------------------------------------------- float32 at d = 128
// A TMA producer warpgroup and two consumer warpgroups (kClusterThreads
// threads, one block an SM), TF32 wgmma.  T = 64 own rows a block, shared
// by both consumer warpgroups; streamed tiles of TS = 32 rows in NS = 2
// stages.  A stage holds each streamed operand as D / 32 column blocks of
// its TS raw rows (TMA) followed by their TS lo rows (x - hi, written by
// the producer's warps 1-3 once the block landed), so one 2TS-row B
// operand gives a product's a_hi b_hi and a_hi b_lo in one wgmma.  The
// output products' B tiles (P, dS: hi then lo, K-major, 64 rows each)
// follow.
template <int D> struct DqF32Plan {
  static constexpr int T = 64, TS = 32, NS = 2, OWN = 2 * T * D * 4, STAGE = 2 * 2 * TS * D * 4,
      BT = 2 * 2 * T * TS * 4, ROWS = 0, BARS = 64;
  static constexpr int SMEM = 1024 + OWN + NS * STAGE + BT + NS * ROWS + BARS;
};
template <int D> struct DkvF32Plan {
  static constexpr int T = 64, TS = 32, NS = 2, OWN = 2 * T * D * 4, STAGE = 2 * 2 * TS * D * 4,
      BT = 2 * 2 * T * TS * 4, ROWS = 2 * TS * 4, BARS = 64;
  static constexpr int SMEM = 1024 + OWN + NS * STAGE + BT + NS * ROWS + BARS;
};

// the regions of the block's shared memory, in the plan's order
template <typename Plan>
struct F32Smem {
  static constexpr int kOp = Plan::STAGE / 2;        // a streamed operand in a stage
  static constexpr int kBlock = 2 * Plan::TS * 128;  // a column block: raw rows, then lo rows
  static constexpr int kLoWriters = 96;              // the producer's warps 1-3
  uint8_t* own;        // [2][D / 32][T x 128 bytes]: Q and dO (dq), K and V (dkv)
  uint8_t* stage;      // NS x [2][D / 32][raw, lo][TS x 128 bytes]: K and V (dq), Q and dO (dkv)
  uint8_t* bt;         // the outputs' B tiles, T x TS, hi then lo
  float* rows;         // dkv: NS x [2][TS] lse and delta of a stage's q rows
  uint64_t* full;      // [NS]: a stage's loads landed
  uint64_t* empty;     // [NS]: the consumers are done with a stage
  uint64_t* own_full;  // the own tiles landed
  uint64_t* lo_full;   // [NS]: a stage's lo rows are written
  __device__ explicit F32Smem(uint8_t* raw) {
    own = align1024(raw);
    stage = own + Plan::OWN;
    bt = stage + Plan::NS * Plan::STAGE;
    rows = reinterpret_cast<float*>(bt + Plan::BT);
    full = reinterpret_cast<uint64_t*>(bt + Plan::BT + Plan::NS * Plan::ROWS);
    empty = full + Plan::NS;
    own_full = empty + Plan::NS;
    lo_full = own_full + 1;
  }
  // one thread, before anything else
  __device__ void init() const {
    for (int s = 0; s < Plan::NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
      mbar_init(lo_full + s, kLoWriters);
    }
    mbar_init(own_full, 1);
    fence_mbar_init();
  }
  // until tile n's stage holds its raw and lo rows
  __device__ void wait_lo(int n) const {
    mbar_wait(lo_full + n % Plan::NS, (n / Plan::NS) & 1);
    mbar_wait(full + n % Plan::NS, (n / Plan::NS) & 1);
  }
};

// The producer's warps 1-3: once stage n % NS's loads have landed, the lo
// rows (x - hi of every word, in the raw rows' layout) after each column
// block's raw rows
template <typename Plan>
__device__ __forceinline__ void write_stage_lo(const F32Smem<Plan>& sm, int tiles) {
  constexpr int Q4 = Plan::TS * 128 / 16, N4 = Plan::STAGE / 32,  // float4s: a block's raw, a stage's
      NW = F32Smem<Plan>::kLoWriters;
  const int t = threadIdx.x - kConsumers - 32;
  for (int n = 0; n < tiles; ++n) {
    const int s = n % Plan::NS;
    mbar_wait(sm.full + s, (n / Plan::NS) & 1);
    float4* st = reinterpret_cast<float4*>(sm.stage + s * Plan::STAGE);
    for (int i = t; i < N4; i += NW) {
      float4* raw = st + (i / Q4) * 2 * Q4 + i % Q4;
      float4 x = *raw;
      x.x -= __uint_as_float(__float_as_uint(x.x) & 0xFFFFE000u);
      x.y -= __uint_as_float(__float_as_uint(x.y) & 0xFFFFE000u);
      x.z -= __uint_as_float(__float_as_uint(x.z) & 0xFFFFE000u);
      x.w -= __uint_as_float(__float_as_uint(x.w) & 0xFFFFE000u);
      raw[Q4] = x;
    }
    fence_async_shared();
    mbar_arrive(sm.lo_full + s);
  }
}

// four 8 x 4 tiles of 32-bit words from shared memory, lane L giving the
// address of row L % 8 of tile L / 8: thread i gets word i % 4 of row i / 4
// of each (ldmatrix's b16 layout, two b16 a word), which is the A fragment
// layout of a TF32 m64nNk8 product when the tiles are (rows 0-7, k 0-3),
// (8-15, 0-3), (0-7, 4-7), (8-15, 4-7) of the warp's 16 rows
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// f (m64n32: the T own rows by the tile's TS streamed rows) = A B^T over
// the BLOCKS 32-column blocks of d: A the own T-row tile at `a` (read by
// ldmatrix, split in registers), B the streamed operand at `b` (each
// column block its raw rows, then its lo rows).  A block's chains, four k
// steps each: a_hi [b_hi; b_lo] (m64n64: a_hi b_hi in columns 0-31, a_hi
// b_lo in 32-63) and a_lo b_hi; its part a_hi b_hi + (a_lo b_hi + a_hi
// b_lo) by round-to-nearest float32 adds, the blocks' parts added in order
template <int T, int TS, int BLOCKS>
__device__ __forceinline__ void form_blocks(float (&f)[16], uint32_t a, uint32_t b, int w,
                                            int lane) {
  // the lane's row of the warp's 16 and its chunk's offset in a k step
  const int rr = lane % 8, row = 16 * w + rr + 8 * ((lane / 8) & 1), half = lane / 16;
  const uint32_t arow = a + row * 128;
#pragma unroll 1
  for (int cb = 0; cb < BLOCKS; ++cb) {
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldsm_x4(ah[kk], arow + cb * (T * 128) + (((2 * kk + half) ^ rr) << 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t x = ah[kk][e];
        ah[kk][e] = x & 0xFFFFE000u;
        al[kk][e] = __float_as_uint(__uint_as_float(x) - __uint_as_float(ah[kk][e]));
      }
    }
    float hh[32], lh[16];  // a_hi [b_hi; b_lo], a_lo b_hi
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bb = desc_kmajor(b + cb * 2 * TS * 128 + kk * 32);
      wgmma_m64n64k8_tf32(hh, ah[kk], bb, kk > 0);
      wgmma_m64n32k8_tf32(lh, al[kk], bb, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(hh);
    reg_fence(lh);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float part = hh[e] + (lh[e] + hh[16 + e]);
      f[e] = cb == 0 ? part : f[e] + part;
    }
  }
}

// word (row, col) of a streamed operand at `op` (column blocks of TS raw
// rows then TS lo rows; `lo` 1 for the lo word)
template <int TS>
__device__ __forceinline__ uint32_t stage_word(uint32_t op, int row, int col, int lo) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n"
               : "=r"(v)
               : "r"(op + (col >> 5) * (2 * TS * 128) + lo * TS * 128 + row * 128 +
                     ((((col >> 2) & 7) ^ (row & 7)) << 4) + (col & 3) * 4));
  return v;
}

// The A operand of an output product formed transposed (m64, k = the TS
// streamed rows): columns m0 + 16 w + g4 (+ 8) of a streamed operand, rows
// 8 kk + t4 (+ 4); hi the raw word (the tensor core reads its TF32 bits),
// lo the stage's lo word
template <int TS>
__device__ __forceinline__ void out_frags(uint32_t (&ah)[TS / 8][4], uint32_t (&al)[TS / 8][4],
                                          uint32_t op, int m0, int w, int g4, int t4) {
  const int c0 = m0 + 16 * w + g4;
#pragma unroll
  for (int kk = 0; kk < TS / 8; ++kk) {
    const int r = 8 * kk + t4;
    const int rc[4][2] = {{r, c0}, {r, c0 + 8}, {r + 4, c0}, {r + 4, c0 + 8}};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ah[kk][e] = stage_word<TS>(op, rc[e][0], rc[e][1], 0) & 0xFFFFE000u;
      al[kk][e] = stage_word<TS>(op, rc[e][0], rc[e][1], 1);
    }
  }
}

// An output product over the tile's TS streamed rows, formed transposed
// (m64: 64 output columns; n: the T = 64 own rows), A from out_frags, B the
// block's own T x TS tile hi (at bh) and its lo after it, issued as one
// commit group of two chains: a_hi [b_hi; b_lo] into hh (m64n128) and a_lo
// b_hi into lh (m64n64); the first product of a chain does not read its
// accumulator
template <int TS>
__device__ __forceinline__ void out_issue(float (&hh)[64], float (&lh)[32],
                                          const uint32_t (&ah)[TS / 8][4],
                                          const uint32_t (&al)[TS / 8][4], uint32_t bh) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TS / 8; ++kk) {
    const uint64_t bb = desc_kmajor(bh + kk * 32);
    wgmma_m64n128k8_tf32(hh, ah[kk], bb, kk > 0);
    wgmma_m64n64k8_tf32(lh, al[kk], bb, kk > 0);
  }
  wgmma_commit();
}

// acc += a_hi b_hi + (a_lo b_hi + a_hi b_lo), once their group has completed
__device__ __forceinline__ void out_add(float (&acc)[32], float (&hh)[64], float (&lh)[32]) {
  reg_fence(hh);
  reg_fence(lh);
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] += hh[e] + (lh[e] + hh[32 + e]);
}
// The same product in 64 accumulator registers where 96 do not fit (dK/dV):
// a_hi b_hi into f, and a_lo b_hi then a_hi b_lo, a k step at a time, into
// one chain `small` (output_half's chains); acc += f + small
template <int TS>
__device__ __forceinline__ void out_issue_small(float (&f)[32], float (&small)[32],
                                                const uint32_t (&ah)[TS / 8][4],
                                                const uint32_t (&al)[TS / 8][4], uint32_t bh) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TS / 8; ++kk) {
    const uint64_t h = desc_kmajor(bh + kk * 32), l = desc_kmajor(bh + 64 * 128 + kk * 32);
    wgmma_m64n64k8_tf32(small, al[kk], h, kk > 0);
    wgmma_m64n64k8_tf32(small, ah[kk], l, 1);
    wgmma_m64n64k8_tf32(f, ah[kk], h, kk > 0);
  }
  wgmma_commit();
}
__device__ __forceinline__ void out_add_small(float (&acc)[32], float (&f)[32], float (&small)[32]) {
  reg_fence(f);
  reg_fence(small);
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] += f[e] + small[e];
}

// ------------------------------------------------ float32 at d = 128: dQ
// A block per (rank, query head, 64-row Q tile), the heaviest first; K and
// V stream in 32-row tiles (DqWalk).  Warpgroup 0 forms S = Q K^T and P,
// warpgroup 1 dP = dO V^T and dS, each over all 64 rows.  P goes to
// warpgroup 1 in the dS tiles of the tile's parity (named barrier 4 +
// parity "P is there"), where warpgroup 1 turns it into dS, hi and lo, in
// place (8 + parity "dS is there"; 10 + parity "warpgroup 1's product of
// the tile two back is done", before warpgroup 0 writes P there).
// Output: dQ^T = K^T dS^T, warpgroup wg the columns 64 wg .. 64 wg + 63
// of dQ (32 registers a thread), tile i - 1's issued after tile i's S
// (dP) and in flight under tile i's P (dS).
template <int D>
__global__ void __launch_bounds__(kClusterThreads, 1)
attn_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mo,
                       const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, Geo geo) {
  using Plan = DqF32Plan<D>;
  using Smem = F32Smem<Plan>;
  constexpr int T = Plan::T, TS = Plan::TS, NS = Plan::NS, NB = D / 32;
  constexpr int OWN1 = Plan::OWN / 2, BTILE = T * TS * 4;
  static_assert(D == 128 && T == 64 && TS == 32, "form_blocks and out_issue read these tiles");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem sm(smem_raw);
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
    if (threadIdx.x >= kConsumers + 32) {
      write_stage_lo(sm, walk.total);
      return;
    }
    DqCursor at;
    stream_tiles<NS>(
        walk.total, sm.empty,
        [&] {
          mbar_expect_tx(sm.own_full, Plan::OWN);
          for (int cb = 0; cb < NB; ++cb) {
            tma_load_3d(sm.own + cb * T * 128, &mq, sm.own_full, 32 * cb, q0, zq);
            tma_load_3d(sm.own + OWN1 + cb * T * 128, &mo, sm.own_full, 32 * cb, q0, zq);
          }
        },
        [&](int, int s) {
          const int z = G[(r - at.arr + geo.g) % geo.g] * geo.hkv + kvh, y = at.kt * TS;
          at.next(walk);
          uint8_t* st = sm.stage + s * Plan::STAGE;
          mbar_expect_tx(sm.full + s, Plan::STAGE / 2);
          for (int cb = 0; cb < NB; ++cb) {
            tma_load_3d(st + cb * Smem::kBlock, &mk, sm.full + s, 32 * cb, y, z);
            tma_load_3d(st + Smem::kOp + cb * Smem::kBlock, &mv, sm.full + s, 32 * cb, y, z);
          }
        });
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, w = t / 32, g4 = (t % 32) / 4,
            t4 = t % 4;
  float L2[2], Dl[2];  // lse log2(e) and delta of the thread's two rows
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int qi = q0 + 16 * w + g4 + 8 * ii;
    L2[ii] = qi < sb ? lse[row0 + qi] * kLog2e : 0.f;
    Dl[ii] = qi < sb ? delta[row0 + qi] : 0.f;
  }
  const float scale2 = geo.scale * kLog2e;
  const uint32_t bt = smem_addr(sm.bt);  // dS (P) of parity p: hi at bt + 2 p BTILE, lo after it
  float acc[32];  // dQ^T: columns 64 wg + 16 w + g4 (+ 8) of dQ, its 64 rows
  zero(acc);
  float x[TS / 2];  // warpgroup 0: S, then P; warpgroup 1: dP, then dS (rows q, columns k)
  uint32_t ah[TS / 8][4], al[TS / 8][4];  // A of the output in flight (K^T, hi and lo)
  float hh[64], lh[32];
  DqCursor cur;
  // tile i's S (dP) into x
  auto form = [&](int i) {
    sm.wait_lo(i);
    form_blocks<T, TS, NB>(x, smem_addr(sm.own + wg * OWN1),
                           smem_addr(sm.stage + i % NS * Plan::STAGE) + wg * Smem::kOp, w, t % 32);
  };
  // the A of tile i's output (K^T: its columns 64 wg ..); its stage released
  auto load_a = [&](int i) {
    out_frags<TS>(ah, al, smem_addr(sm.stage + i % NS * Plan::STAGE), 64 * wg, w, g4, t4);
    mbar_arrive(sm.empty + i % NS);
  };
  // tile i's P (warpgroup 0) into the dS tiles of parity i & 1, or dS
  // (warpgroup 1) from it, hi and lo, in place
  auto grads = [&](int i) {
    const int par = i & 1;
    uint8_t* hi = sm.bt + 2 * par * BTILE;
    if (wg == 0) {
      const int k0 = cur.kt * TS;
      const bool diag = geo.causal && cur.arr == 0;
      cur.next(walk);
      auto entries = [&](auto edge) {
        constexpr bool masks = decltype(edge)::value;
#pragma unroll
        for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int qi = q0 + 16 * w + g4 + 8 * ii;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * jj + 2 * ii + c, kj = k0 + 8 * jj + 2 * t4 + c;
              x[e] = prob(x[e], scale2, L2[ii],
                          masks && (kj >= sb || qi >= sb || (diag && kj > qi)));
            }
          }
      };
      if (diag || k0 + TS > sb || q0 + T > sb) entries(std::true_type());
      else entries(std::false_type());
      if (i >= 2) named_sync(10 + par, 256);  // warpgroup 1's tile i - 2 product is done
#pragma unroll
      for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int e = 4 * jj + 2 * ii;
          *reinterpret_cast<float2*>(hi + sw128_f32(16 * w + g4 + 8 * ii, 8 * jj + 2 * t4, T)) =
              make_float2(x[e], x[e + 1]);
        }
      named_arrive(4 + par, 256);
    } else {
      named_sync(4 + par, 256);  // tile i's P is there
#pragma unroll
      for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int e = 4 * jj + 2 * ii, row = 16 * w + g4 + 8 * ii, col = 8 * jj + 2 * t4;
          const float2 p = *reinterpret_cast<const float2*>(hi + sw128_f32(row, col, T));
          x[e] = p.x * (x[e] - Dl[ii]) * geo.scale;
          x[e + 1] = p.y * (x[e + 1] - Dl[ii]) * geo.scale;
          put_split2<T>(hi, hi + BTILE, row, col, x[e], x[e + 1]);
        }
      fence_async_shared();
      named_sync(3, 128);  // the warpgroup's own product reads them next
      named_arrive(8 + par, 256);
    }
  };
  // tile i's dQ^T product (A in ah, al), issued; then waited and added
  auto issue = [&](int i) {
    if (wg == 0) named_sync(8 + (i & 1), 256);  // tile i's dS is there
    out_issue<TS>(hh, lh, ah, al, bt + 2 * (i & 1) * BTILE);
  };
  auto retire = [&](int i) {
    wgmma_wait<0>();
    keep(ah);  // in flight under grads(i): no other value may take their registers
    keep(al);
    out_add(acc, hh, lh);
    if (wg == 1 && i + 2 < walk.total) named_arrive(10 + (i & 1), 256);  // its tiles are free
  };
  mbar_wait(sm.own_full, 0);
  form(0);
  grads(0);
  load_a(0);
#pragma unroll 1
  for (int i = 1; i < walk.total; ++i) {
    form(i);
    issue(i - 1);  // in flight under tile i's P (dS)
    grads(i);
    retire(i - 1);
    load_a(i);  // stage i is held to here: stage i + 2 still has a tile's time to land
  }
  issue(walk.total - 1);
  retire(walk.total - 1);
  // acc[4j + 2i + c] = dQ[q0 + 8j + 2 t4 + c][64 wg + 16 w + g4 + 8i]
  const int col0 = 64 * wg + 16 * w + g4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int qi = q0 + 8 * j + 2 * t4 + c;
      if (qi >= sb) continue;
      float* out = dq + (row0 + qi) * D + col0;
      out[0] = acc[4 * j + c];
      out[8] = acc[4 * j + 2 + c];
    }
}

// -------------------------------------------- float32 at d = 128: dK, dV
// A block per (owner j, K/V head, 64-row K tile), owners in order; Q and dO
// stream in 32-row tiles with their lse and delta rows (DkvWalk).
// Warpgroup 0 forms S^T = K Q^T and P^T, warpgroup 1 dP^T = V dO^T and
// dS^T, each over all 64 K rows; P goes into the P tiles (hi and lo),
// which warpgroup 1 reads back (hi + lo is P) for dS (named barriers 4 "P
// is there", 6 "its tiles are free"), dS into the dS tiles.  Outputs:
// warpgroup 0 dV^T = dO^T P, warpgroup 1 dK^T = Q^T dS, each the 128
// columns in two halves of 64 (acc[2][32]), one half after the other once
// the tile's P (dS) is in its tiles, A read from the stage just before its
// product, in 64 accumulator registers (out_issue_small: the merged form's
// 96 spilled beside dV^T's 64): with a half in flight under the next
// tile's P (dS) a warpgroup would hold the next tile's A beside it, over
// its 232 registers.
template <int D>
__global__ void __launch_bounds__(kClusterThreads, 1)
attn_bwd_dkv_f32_kernel(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                        const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mo,
                        const __grid_constant__ CUtensorMap ml, const __grid_constant__ CUtensorMap md,
                        float* __restrict__ dk, float* __restrict__ dv, Geo geo) {
  using Plan = DkvF32Plan<D>;
  using Smem = F32Smem<Plan>;
  constexpr int T = Plan::T, TS = Plan::TS, NS = Plan::NS, NB = D / 32;
  constexpr int OWN1 = Plan::OWN / 2, BTILE = T * TS * 4;
  static_assert(D == 128 && T == 64 && TS == 32, "form_blocks and out_issue read these tiles");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem sm(smem_raw);
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
    if (threadIdx.x >= kConsumers + 32) {
      write_stage_lo(sm, walk.total);
      return;
    }
    stream_tiles<NS>(
        walk.total, sm.empty,
        [&] {
          mbar_expect_tx(sm.own_full, Plan::OWN);
          for (int cb = 0; cb < NB; ++cb) {
            tma_load_3d(sm.own + cb * T * 128, &mk, sm.own_full, 32 * cb, k0, zk);
            tma_load_3d(sm.own + OWN1 + cb * T * 128, &mv, sm.own_full, 32 * cb, k0, zk);
          }
        },
        [&](int n, int s) {  // DkvWalk::at: a cursor's state spilled in 40 registers
          int arr, ht, qt;
          walk.at(n, arr, ht, qt);
          const int z = G[(j + arr) % geo.g] * geo.hq + kvh * rep + ht, y = qt * TS;
          uint8_t* st = sm.stage + s * Plan::STAGE;
          float* rw = sm.rows + s * 2 * TS;
          mbar_expect_tx(sm.full + s, Plan::STAGE / 2 + Plan::ROWS);
          for (int cb = 0; cb < NB; ++cb) {
            tma_load_3d(st + cb * Smem::kBlock, &mq, sm.full + s, 32 * cb, y, z);
            tma_load_3d(st + Smem::kOp + cb * Smem::kBlock, &mo, sm.full + s, 32 * cb, y, z);
          }
          tma_load_1d(rw, &ml, sm.full + s, z * sb + y);
          tma_load_1d(rw + TS, &md, sm.full + s, z * sb + y);
        });
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, w = t / 32, g4 = (t % 32) / 4,
            t4 = t % 4;
  const float scale2 = geo.scale * kLog2e;
  // the B tiles: P (hi, lo), then dS (hi, lo)
  uint8_t* pt = sm.bt;
  uint8_t* dst = sm.bt + 2 * BTILE;
  float acc[2][32];  // dV^T (warpgroup 0) or dK^T (1), by 64-column half
  zero(acc[0]);
  zero(acc[1]);
  float x[TS / 2];  // warpgroup 0: S^T, then P^T; warpgroup 1: dP^T, then dS^T (rows k, columns q)
  uint32_t ah[TS / 8][4], al[TS / 8][4];  // A of an output half: dO^T (0) or Q^T (1)
  float of[32], os[32];
  // the walk stepped a tile at a time, as much of it as the consumers
  // read: the q-tile (tiles before walk.first are the diagonal's)
  int qt = walk.qs;
  mbar_wait(sm.own_full, 0);
#pragma unroll 1
  for (int i = 0; i < walk.total; ++i) {
    const int s = i % NS;
    sm.wait_lo(i);
    const uint32_t st = smem_addr(sm.stage + s * Plan::STAGE);
    form_blocks<T, TS, NB>(x, smem_addr(sm.own + wg * OWN1), st + wg * Smem::kOp, w, t % 32);
    float R[TS / 8][2];  // lse (warpgroup 0) or delta (1) of the thread's columns
    const float* rw = sm.rows + s * 2 * TS + wg * TS;
#pragma unroll
    for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c) R[jj][c] = rw[8 * jj + 2 * t4 + c];
    if (wg == 0) {  // P^T into the P tiles
      const int q0 = qt * TS;
      const bool diag = geo.causal && i < walk.first;
      auto entries = [&](auto edge) {
        constexpr bool masks = decltype(edge)::value;
#pragma unroll
        for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qi = q0 + 8 * jj + 2 * t4 + c;
            const float l2 = R[jj][c] * kLog2e;
#pragma unroll
            for (int ii = 0; ii < 2; ++ii) {
              const int e = 4 * jj + 2 * ii + c, kj = k0 + 16 * w + g4 + 8 * ii;
              x[e] = prob(x[e], scale2, l2, masks && (qi >= sb || (diag && kj > qi)));
            }
          }
      };
      if (diag || q0 + TS > sb) entries(std::true_type());
      else entries(std::false_type());
      if (i >= 1) named_sync(6, 256);  // warpgroup 1 has read tile i - 1's P
#pragma unroll
      for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int e = 4 * jj + 2 * ii;
          put_split2<T>(pt, pt + BTILE, 16 * w + g4 + 8 * ii, 8 * jj + 2 * t4, x[e], x[e + 1]);
        }
      fence_async_shared();
      named_sync(2, 128);  // the warpgroup's own products read them next
      named_arrive(4, 256);
    } else {  // dS^T = P^T (dP^T - delta) scale into the dS tiles
      named_sync(4, 256);  // tile i's P is there
#pragma unroll
      for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int e = 4 * jj + 2 * ii;
          const uint32_t off = sw128_f32(16 * w + g4 + 8 * ii, 8 * jj + 2 * t4, T);
          const float2 h2 = *reinterpret_cast<const float2*>(pt + off);
          const float2 l2 = *reinterpret_cast<const float2*>(pt + BTILE + off);
          x[e] = (h2.x + l2.x) * (x[e] - R[jj][0]) * geo.scale;
          x[e + 1] = (h2.y + l2.y) * (x[e + 1] - R[jj][1]) * geo.scale;
        }
      if (i + 1 < walk.total) named_arrive(6, 256);
#pragma unroll
      for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int e = 4 * jj + 2 * ii;
          put_split2<T>(dst, dst + BTILE, 16 * w + g4 + 8 * ii, 8 * jj + 2 * t4, x[e], x[e + 1]);
        }
      fence_async_shared();
      named_sync(3, 128);  // the warpgroup's own products read them next
    }
    if (++qt == walk.nq) qt = i + 1 < walk.first ? walk.qs : 0;
    // warpgroup 0: dV^T += dO^T P; 1: dK^T += Q^T dS, by half
    const uint32_t other = st + (1 - wg) * Smem::kOp;  // dO (warpgroup 0) or Q (1)
    const uint32_t bh = smem_addr(wg == 0 ? pt : dst);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      out_frags<TS>(ah, al, other, 64 * hf, w, g4, t4);
      out_issue_small<TS>(of, os, ah, al, bh);
      wgmma_wait<0>();
      out_add_small(acc[hf], of, os);
    }
    mbar_arrive(sm.empty + s);
  }
  // acc[hf][4j + 2i + c] = dX[k0 + 8j + 2 t4 + c][64 hf + 16 w + g4 + 8i]
  float* out = wg == 0 ? dv : dk;
  const int col0 = 16 * w + g4;
#pragma unroll
  for (int jq = 0; jq < 8; ++jq)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int row = 8 * jq + 2 * t4 + c;
      if (k0 + row >= sb) continue;
      float* o = out + (kv_row0 + row) * D + col0;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        o[64 * hf] = acc[hf][4 * jq + c];
        o[64 * hf + 8] = acc[hf][4 * jq + 2 + c];
      }
    }
}

// ----------------------------------------------------- float32 at d = 256
// The d = 128 form's producer and two consumer warpgroups, its chains and
// its outputs formed transposed, with the own 64-row tiles resident (two of
// 64 x 256, 131 072 bytes) and the streamed operands as column-chunk units
// through one ring of NS = 4 slots of 16 384 bytes:
//   a forming unit: one operand's TS = 32 rows x 64 columns, each of its
//   two 32-column blocks its raw rows (TMA) then its lo rows (written once
//   by the producer's warps 1-3), the B of S (S^T) and dP (dP^T) over
//   those 64 columns of d;
//   an output unit: one operand's 32 rows x 128 columns, raw (TMA), the A
//   of two m64 blocks (128 columns of d) of an output formed transposed,
//   split in registers by the one warpgroup that reads it.
// The ring alternates the warpgroups' units (unit n is warpgroup n & 1's,
// in slots n % 4), so each warpgroup counts its own and every slot has one
// reader.  A tile's forming units come first, K (Q) and V (dO) chunk by
// chunk; then the output units, for which the producer streams the tile's
// chunks a second time (from L2); the next tile's first chunks land under
// the outputs.
template <int D> struct DqF32UnitPlan {
  static constexpr int T = 64, TS = 32, NS = 4, OWN = 2 * T * D * 4, UNIT = 2 * TS * 64 * 4,
      BT = 2 * 2 * T * TS * 4, ROWS = 0, BARS = 8 * (3 * NS + 1);
  static constexpr int SMEM = 1024 + OWN + NS * UNIT + BT + NS * ROWS + BARS;
};
template <int D> struct DkvF32UnitPlan {
  static constexpr int T = 64, TS = 32, NS = 4, OWN = 2 * T * D * 4, UNIT = 2 * TS * 64 * 4,
      BT = 2 * 2 * T * TS * 4, ROWS = TS * 4, BARS = 8 * (3 * NS + 1);
  static constexpr int SMEM = 1024 + OWN + NS * UNIT + BT + NS * ROWS + BARS;
};

// the regions of the block's shared memory, in the plan's order
template <typename Plan>
struct F32UnitSmem {
  static constexpr int kLoWriters = 96;  // the producer's warps 1-3
  uint8_t* own;        // [2][D / 32][T x 128 bytes]: Q and dO (dq), K and V (dkv)
  uint8_t* ring;       // NS units
  uint8_t* bt;         // the outputs' B tiles, T x TS, hi then lo
  float* rows;         // dkv: NS x [TS]: lse (delta) of the last Q (dO) forming unit of a tile
  uint64_t* full;      // [NS]: a unit's loads landed
  uint64_t* empty;     // [NS]: its warpgroup is done with it
  uint64_t* lo_full;   // [NS]: its lo rows are written (an output unit: passed)
  uint64_t* own_full;  // the own tiles landed
  __device__ explicit F32UnitSmem(uint8_t* raw) {
    own = align1024(raw);
    ring = own + Plan::OWN;
    bt = ring + Plan::NS * Plan::UNIT;
    rows = reinterpret_cast<float*>(bt + Plan::BT);
    full = reinterpret_cast<uint64_t*>(bt + Plan::BT + Plan::NS * Plan::ROWS);
    empty = full + Plan::NS;
    lo_full = empty + Plan::NS;
    own_full = lo_full + Plan::NS;
  }
  // one thread, before anything else
  __device__ void init() const {
    for (int s = 0; s < Plan::NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128);
      mbar_init(lo_full + s, kLoWriters);
    }
    mbar_init(own_full, 1);
    fence_mbar_init();
  }
  __device__ uint8_t* slot(int n) const { return ring + n % Plan::NS * Plan::UNIT; }
  // until unit n is in its slot, with its lo rows
  __device__ void wait(int n) const {
    mbar_wait(lo_full + n % Plan::NS, (n / Plan::NS) & 1);
    mbar_wait(full + n % Plan::NS, (n / Plan::NS) & 1);
  }
  // the producer's thread: unit n's slot, once the unit before it there is
  // released, its full barrier expecting `bytes`
  __device__ uint8_t* claim(int n, uint32_t bytes) const {
    const int s = n % Plan::NS;
    if (n >= Plan::NS) mbar_wait(empty + s, (n / Plan::NS - 1) & 1);
    mbar_expect_tx(full + s, bytes);
    return ring + s * Plan::UNIT;
  }
};

// a forming unit: columns c0 .. c0 + 63 of the TS rows at (y, z), each
// 32-column block's raw rows before the room of its lo rows
template <int TS>
__device__ __forceinline__ void load_forming(uint8_t* slot, const CUtensorMap* map, uint64_t* bar,
                                             int c0, int y, int z) {
  tma_load_3d(slot, map, bar, c0, y, z);
  tma_load_3d(slot + 2 * TS * 128, map, bar, c0 + 32, y, z);
}
// an output unit: columns c0 .. c0 + 127, raw
template <int TS>
__device__ __forceinline__ void load_output(uint8_t* slot, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int y, int z) {
#pragma unroll
  for (int b = 0; b < 4; ++b) tma_load_3d(slot + b * TS * 128, map, bar, c0 + 32 * b, y, z);
}

// The producer's warps 1-3, unit n of the ring once it landed: a forming
// unit's lo rows (x - hi of every word, after each block's raw rows); an
// output unit is passed (its lo_full phase keeps the slots' phases in step,
// so that no writer is lapped)
template <typename Plan>
__device__ __forceinline__ void unit_lo(const F32UnitSmem<Plan>& sm, int n, bool forming) {
  constexpr int Q4 = Plan::TS * 128 / 16, NW = F32UnitSmem<Plan>::kLoWriters;  // float4s of a block's raw rows
  const int t = threadIdx.x - kConsumers - 32;
  mbar_wait(sm.full + n % Plan::NS, (n / Plan::NS) & 1);
  if (forming) {
    float4* u = reinterpret_cast<float4*>(sm.slot(n));
    for (int i = t; i < 2 * Q4; i += NW) {
      float4* raw = u + (i / Q4) * 2 * Q4 + i % Q4;
      float4 x = *raw;
      x.x -= __uint_as_float(__float_as_uint(x.x) & 0xFFFFE000u);
      x.y -= __uint_as_float(__float_as_uint(x.y) & 0xFFFFE000u);
      x.z -= __uint_as_float(__float_as_uint(x.z) & 0xFFFFE000u);
      x.w -= __uint_as_float(__float_as_uint(x.w) & 0xFFFFE000u);
      raw[Q4] = x;
    }
    fence_async_shared();
  }
  mbar_arrive(sm.lo_full + n % Plan::NS);
}

// f (m64n32: the T own rows by a unit's TS streamed rows) over the unit's
// two 32-column blocks, blocks cb0 and cb0 + 1 of d: A the own tile at `a`
// (its hi the raw words, which the tensor core reads as TF32, from shared
// memory; its lo by ldmatrix, split in registers), B the unit at `b` (each
// block's raw rows, then its lo rows).  A block's chains, four k steps
// each, as form_blocks': a_hi [b_hi; b_lo] (m64n64) and a_lo b_hi
// (m64n32), its part a_hi b_hi + (a_lo b_hi + a_hi b_lo) by round-to-nearest
// float32 adds; the blocks' parts added in order (block 0 of d starts f)
template <int T, int TS>
__device__ __forceinline__ void form_unit(float (&f)[16], uint32_t a, uint32_t b, int cb0, int w,
                                          int lane) {
  const int rr = lane % 8, row = 16 * w + rr + 8 * ((lane / 8) & 1), half = lane / 16;
  const uint32_t arow = a + row * 128;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    const int cb = cb0 + h;
    uint32_t al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldsm_x4(al[kk], arow + cb * (T * 128) + (((2 * kk + half) ^ rr) << 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t x = al[kk][e];
        al[kk][e] = __float_as_uint(__uint_as_float(x) - __uint_as_float(x & 0xFFFFE000u));
      }
    }
    float hh[32], lh[16];  // a_hi [b_hi; b_lo], a_lo b_hi
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // descriptors built at each use (opaque bases)
      const uint64_t bb = desc_kmajor(opaque(b) + h * 2 * TS * 128 + kk * 32);
      wgmma_m64n64k8_tf32_ss(hh, desc_kmajor(opaque(a) + cb * (T * 128) + kk * 32), bb, kk > 0);
      wgmma_m64n32k8_tf32(lh, al[kk], bb, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    keep(al);
    reg_fence(hh);
    reg_fence(lh);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float part = hh[e] + (lh[e] + hh[16 + e]);
      f[e] = cb == 0 ? part : f[e] + part;
    }
  }
}

// The byte offsets in an output unit (TS rows x 128 columns, 32-column
// blocks in the 128-byte swizzle) of the four words a thread reads for the
// first m64 block's first k step: (row t4 (+ 4), column 16 w + g4 (+ 8)).
// Its other words are these plus 8 192 a block of 64 columns (two column
// blocks on) and 1 024 a k step (eight rows on): the swizzle's row and
// chunk bits do not change, so four registers address the unit
template <int TS>
__device__ __forceinline__ void unit_offsets(uint32_t (&off)[4], int w, int g4, int t4) {
#pragma unroll
  for (int e = 0; e < 4; ++e) off[e] = sw128_f32(t4 + 4 * (e >> 1), 16 * w + g4 + 8 * (e & 1), TS);
}
// The A operand of an output product formed transposed (m64: columns
// 64 mb .. 64 mb + 63 of an output unit at `u`; k: its TS rows), each word
// split once, in registers: rows 8 kk + t4 (+ 4), columns 64 mb + 16 w + g4
// (+ 8) (`off` from unit_offsets)
template <int TS>
__device__ __forceinline__ void unit_frags(uint32_t (&ah)[TS / 8][4], uint32_t (&al)[TS / 8][4],
                                           uint32_t u, const uint32_t (&off)[4], int mb) {
#pragma unroll
  for (int kk = 0; kk < TS / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t x;
      asm volatile("ld.shared.b32 %0, [%1];\n"
                   : "=r"(x)
                   : "r"(u + off[e] + 2 * mb * TS * 128 + kk * 1024));
      ah[kk][e] = x & 0xFFFFE000u;
      al[kk][e] = __float_as_uint(__uint_as_float(x) - __uint_as_float(ah[kk][e]));
    }
}

// out_issue_small's chains for 32 of the 64 own rows (B from `bh`, the hi
// rows of that half, its lo rows 64 rows on) in 32 registers, each k step's
// descriptors built just before its wgmmas (an opaque base) rather than all
// held at once; out_add_quarter: acc's columns 32 nh .. 32 nh + 31 +=
// f + small
template <int TS>
__device__ __forceinline__ void out_issue_quarter(float (&f)[16], float (&small)[16],
                                                  const uint32_t (&ah)[TS / 8][4],
                                                  const uint32_t (&al)[TS / 8][4], uint32_t bh) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TS / 8; ++kk) {
    const uint32_t hb = opaque(bh) + kk * 32;
    const uint64_t h = desc_kmajor(hb), l = desc_kmajor(hb + 64 * 128);
    wgmma_m64n32k8_tf32(small, al[kk], h, kk > 0);
    wgmma_m64n32k8_tf32(small, ah[kk], l, 1);
    wgmma_m64n32k8_tf32(f, ah[kk], h, kk > 0);
  }
  wgmma_commit();
}
__device__ __forceinline__ void out_add_quarter(float (&acc)[32], int nh, float (&f)[16],
                                                float (&small)[16]) {
  reg_fence(f);
  reg_fence(small);
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[16 * nh + e] += f[e] + small[e];
}

// ------------------------------------------------ float32 at d = 256: dQ
// Registers a thread after setmaxnreg: dq's consumers take 240 and its
// producer warpgroup 24 (its consumers spill at 232; its producer fits in
// 24).  A block's warps start at 168 (65 536 / 384, rounded down to 8), so
// the pool is 12 x 168 a lane: 4 x 24 + 8 x 240 fits it exactly, where
// 4 x 32 + 8 x 240 would leave the consumers waiting on setmaxnreg forever.
// dK/dV keeps kProducerRegs and kConsumerRegs (40, 232).
constexpr int kDqProducerRegs = 24, kDqConsumerRegs = 240;
static_assert(4 * kDqProducerRegs + 8 * kDqConsumerRegs <= 12 * 168, "the block's register pool");

// A block per (rank, query head, 64-row Q tile), the heaviest first; K and
// V stream in 32-row tiles (DqWalk), each as four forming units and, for
// dQ, two output units.  Warpgroup 0 forms S = Q K^T and P, warpgroup 1
// dP = dO V^T and dS, as at d = 128 (P handed over in the dS tiles of the
// tile's parity, named barriers 4 + parity "P is there", 8 + parity "dS is
// there", 10 + parity "warpgroup 1's product of the tile two back is
// done").  Output: dQ^T = K^T dS^T, warpgroup wg the columns 128 wg ..
// 128 wg + 127 of dQ as two m64 blocks (64 registers a thread), each in
// out_issue_small's chains (64 registers); one tile behind: tile i - 1's
// after tile i's P (dS), so that warpgroup 0 does not wait for dS; the ring
// carries tile i - 1's output units after tile i's forming units.
template <>
__global__ void __launch_bounds__(kClusterThreads, 1)
attn_bwd_dq_f32_kernel<256>(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mo,
                            const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, Geo geo) {
  constexpr int D = 256;
  using Plan = DqF32UnitPlan<D>;
  using Smem = F32UnitSmem<Plan>;
  constexpr int T = Plan::T, TS = Plan::TS, NB = D / 32;
  constexpr int OWN1 = Plan::OWN / 2, BTILE = T * TS * 4, FORM = 2 * TS * 64 * 4 / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem sm(smem_raw);
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
    setmaxnreg_dec<kDqProducerRegs>();
    if (threadIdx.x >= kConsumers + 32) {  // tile i's forming units, then tile i - 1's output units
      for (int i = 0, n = 0; i <= walk.total; ++i) {
        if (i < walk.total)
          for (int u = 0; u < 8; ++u) unit_lo(sm, n++, true);
        if (i > 0)
          for (int u = 0; u < 2; ++u) unit_lo(sm, n++, false);
      }
      return;
    }
    if (threadIdx.x != kConsumers) return;
    mbar_expect_tx(sm.own_full, Plan::OWN);
    for (int cb = 0; cb < NB; ++cb) {
      tma_load_3d(sm.own + cb * T * 128, &mq, sm.own_full, 32 * cb, q0, zq);
      tma_load_3d(sm.own + OWN1 + cb * T * 128, &mo, sm.own_full, 32 * cb, q0, zq);
    }
    DqCursor at;
    int zp = 0, yp = 0;  // tile i - 1's plane and first row
    for (int i = 0, n = 0; i <= walk.total; ++i) {
      int z = 0, y = 0;
      if (i < walk.total) {
        z = G[(r - at.arr + geo.g) % geo.g] * geo.hkv + kvh;
        y = at.kt * TS;
        at.next(walk);
        for (int c = 0; c < 4; ++c) {
          load_forming<TS>(sm.claim(n, FORM), &mk, sm.full + n % Plan::NS, 64 * c, y, z);
          ++n;
          load_forming<TS>(sm.claim(n, FORM), &mv, sm.full + n % Plan::NS, 64 * c, y, z);
          ++n;
        }
      }
      if (i > 0)
        for (int c = 0; c < 2; ++c, ++n)
          load_output<TS>(sm.claim(n, Plan::UNIT), &mk, sm.full + n % Plan::NS, 128 * c, yp, zp);
      zp = z;
      yp = y;
    }
    return;
  }
  setmaxnreg_inc<kDqConsumerRegs>();
  // the warpgroup a compile-time constant: its shared addresses and the
  // descriptors built from them are then uniform (uniform registers),
  // not per-thread values
  auto consumer = [&](auto which) {
    constexpr int wg = decltype(which)::value;
    const int t = threadIdx.x % 128, w = t / 32, g4 = (t % 32) / 4, t4 = t % 4;
    float L2[2], Dl[2];  // lse log2(e) and delta of the thread's two rows
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int qi = q0 + 16 * w + g4 + 8 * ii;
      L2[ii] = qi < sb ? lse[row0 + qi] * kLog2e : 0.f;
      Dl[ii] = qi < sb ? delta[row0 + qi] : 0.f;
    }
    const float scale2 = geo.scale * kLog2e;
    uint32_t woff[4];  // the thread's words in an output unit
    unit_offsets<TS>(woff, w, g4, t4);
    const uint32_t bt = smem_addr(sm.bt);  // dS (P) of parity p: hi at bt + 2 p BTILE, lo after it
    const uint32_t own = smem_addr(sm.own + wg * OWN1);  // Q (warpgroup 0) or dO
    float acc[2][32];  // dQ^T: columns 128 wg + 64 mb + 16 w + g4 (+ 8) of dQ, its 64 rows
    zero(acc[0]);
    zero(acc[1]);
    float x[TS / 2];  // warpgroup 0: S, then P; warpgroup 1: dP, then dS (rows q, columns k)
    int k = 0;        // the warpgroup's units so far: its next is unit 2 k + wg
    DqCursor cur;
    // tile i's S (dP) into x, over the tile's four forming units of K (V);
    // x's last value is dead from here (zeroed, so the compiler does not
    // hold it through the outputs: form_unit's first block overwrites it)
    auto form = [&] {
      zero(x);
#pragma unroll 1
      for (int c = 0; c < 4; ++c, ++k) {
        const int n = 2 * k + wg;
        sm.wait(n);
        form_unit<T, TS>(x, own, smem_addr(sm.slot(n)), 2 * c, w, t % 32);
        mbar_arrive(sm.empty + n % Plan::NS);
      }
    };
    // tile i's P (warpgroup 0) into the dS tiles of parity i & 1, or dS
    // (warpgroup 1) from it, hi and lo, in place
    auto grads = [&](int i) {
      const int par = i & 1;
      uint8_t* hi = sm.bt + 2 * par * BTILE;
      if (wg == 0) {
        const int k0 = cur.kt * TS;
        const bool diag = geo.causal && cur.arr == 0;
        cur.next(walk);
        auto entries = [&](auto edge) {
          constexpr bool masks = decltype(edge)::value;
#pragma unroll
          for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
            for (int ii = 0; ii < 2; ++ii) {
              const int qi = q0 + 16 * w + g4 + 8 * ii;
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int e = 4 * jj + 2 * ii + c, kj = k0 + 8 * jj + 2 * t4 + c;
                x[e] = prob(x[e], scale2, L2[ii],
                            masks && (kj >= sb || qi >= sb || (diag && kj > qi)));
              }
            }
        };
        if (diag || k0 + TS > sb || q0 + T > sb) entries(std::true_type());
        else entries(std::false_type());
        if (i >= 2) named_sync(10 + par, 256);  // warpgroup 1's tile i - 2 product is done
#pragma unroll
        for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int e = 4 * jj + 2 * ii;
            *reinterpret_cast<float2*>(hi + sw128_f32(16 * w + g4 + 8 * ii, 8 * jj + 2 * t4, T)) =
                make_float2(x[e], x[e + 1]);
          }
        named_arrive(4 + par, 256);
      } else {
        named_sync(4 + par, 256);  // tile i's P is there
#pragma unroll
        for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int e = 4 * jj + 2 * ii, row = 16 * w + g4 + 8 * ii, col = 8 * jj + 2 * t4;
            const float2 p = *reinterpret_cast<const float2*>(hi + sw128_f32(row, col, T));
            x[e] = p.x * (x[e] - Dl[ii]) * geo.scale;
            x[e + 1] = p.y * (x[e + 1] - Dl[ii]) * geo.scale;
            put_split2<T>(hi, hi + BTILE, row, col, x[e], x[e + 1]);
          }
        fence_async_shared();
        named_sync(3, 128);  // the warpgroup's own products read them next
        named_arrive(8 + par, 256);
      }
    };
    // tile i's dQ^T += K^T dS^T over its output unit, one m64 block at a time
    auto output = [&](int i) {
      const int par = i & 1, n = 2 * k + wg;
      if (wg == 0) named_sync(8 + par, 256);  // tile i's dS is there
      sm.wait(n);
      const uint32_t u = smem_addr(sm.slot(n));
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        uint32_t ah[TS / 8][4], al[TS / 8][4];
        float of[32], os[32];
        unit_frags<TS>(ah, al, u, woff, mb);
        out_issue_small<TS>(of, os, ah, al, bt + 2 * par * BTILE);
        wgmma_wait<0>();
        keep(ah);
        keep(al);
        out_add_small(acc[mb], of, os);
      }
      mbar_arrive(sm.empty + n % Plan::NS);
      ++k;
      if (wg == 1 && i + 2 < walk.total) named_arrive(10 + par, 256);  // its tiles are free
    };
    mbar_wait(sm.own_full, 0);
#pragma unroll 1
    for (int i = 0; i < walk.total; ++i) {
      form();
      grads(i);
      if (i > 0) output(i - 1);
    }
    output(walk.total - 1);
    // acc[mb][4j + 2i + c] = dQ[q0 + 8j + 2 t4 + c][128 wg + 64 mb + 16 w + g4 + 8i]
    const int col0 = 128 * wg + 16 * w + g4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = q0 + 8 * j + 2 * t4 + c;
        if (qi >= sb) continue;
        float* out = dq + (row0 + qi) * D + col0;
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          out[64 * mb] = acc[mb][4 * j + c];
          out[64 * mb + 8] = acc[mb][4 * j + 2 + c];
        }
      }
  };
  if (threadIdx.x < 128) consumer(std::integral_constant<int, 0>());
  else consumer(std::integral_constant<int, 1>());
}

// -------------------------------------------- float32 at d = 256: dK, dV
// A block per (owner j, K/V head, 64-row K tile), owners in order; Q and dO
// stream in 32-row tiles (DkvWalk), each as four forming units (the last
// of Q with the tile's lse rows, of dO with its delta rows) and four output
// units.  Warpgroup 0 forms S^T = K Q^T and P^T, warpgroup 1 dP^T = V dO^T
// and dS^T, once a K tile; P goes into the P tiles (hi and lo), which
// warpgroup 1 reads back (hi + lo is P) for dS (named barriers 4 "P is
// there", 6 "its tiles are free"), dS into the dS tiles.  Outputs:
// warpgroup 0 dV^T = dO^T P, warpgroup 1 dK^T = Q^T dS, each the whole of
// d as four m64 blocks (128 registers a thread), after the tile's P (dS),
// one m64 block at a time, each half of the own rows in 32 registers
// (out_issue_quarter).
template <>
__global__ void __launch_bounds__(kClusterThreads, 1)
attn_bwd_dkv_f32_kernel<256>(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                             const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mo,
                             const __grid_constant__ CUtensorMap ml, const __grid_constant__ CUtensorMap md,
                             float* __restrict__ dk, float* __restrict__ dv, Geo geo) {
  constexpr int D = 256;
  using Plan = DkvF32UnitPlan<D>;
  using Smem = F32UnitSmem<Plan>;
  constexpr int T = Plan::T, TS = Plan::TS, NB = D / 32;
  constexpr int OWN1 = Plan::OWN / 2, BTILE = T * TS * 4, FORM = 2 * TS * 64 * 4 / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem sm(smem_raw);
  const int kt = blockIdx.x, member = blockIdx.z, j = member % geo.g;  // the K/V block's owner
  const int* G = geo.groups + (member - j);
  const int kvh = blockIdx.y, rep = geo.hq / geo.hkv, sb = geo.sb, k0 = kt * T;
  const int zk = G[j] * geo.hkv + kvh;  // the K/V head's plane
  const DkvWalk walk(geo, j, k0, TS);
  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= kConsumers + 32) {  // a tile's eight forming units, then its four output units
      for (int i = 0, n = 0; i < walk.total; ++i)
        for (int u = 0; u < 12; ++u) unit_lo(sm, n++, u < 8);
      return;
    }
    if (threadIdx.x != kConsumers) return;
    mbar_expect_tx(sm.own_full, Plan::OWN);
    for (int cb = 0; cb < NB; ++cb) {
      tma_load_3d(sm.own + cb * T * 128, &mk, sm.own_full, 32 * cb, k0, zk);
      tma_load_3d(sm.own + OWN1 + cb * T * 128, &mv, sm.own_full, 32 * cb, k0, zk);
    }
    DkvCursor at(walk);
    for (int i = 0, n = 0; i < walk.total; ++i) {
      const int z = G[(j + at.arr) % geo.g] * geo.hq + kvh * rep + at.t, y = at.qt * TS;
      at.next(walk, rep);
      for (int c = 0; c < 4; ++c) {
        const int rows = c == 3 ? Plan::ROWS : 0;
        uint8_t* s = sm.claim(n, FORM + rows);
        load_forming<TS>(s, &mq, sm.full + n % Plan::NS, 64 * c, y, z);
        if (rows) tma_load_1d(sm.rows + n % Plan::NS * TS, &ml, sm.full + n % Plan::NS, z * sb + y);
        ++n;
        s = sm.claim(n, FORM + rows);
        load_forming<TS>(s, &mo, sm.full + n % Plan::NS, 64 * c, y, z);
        if (rows) tma_load_1d(sm.rows + n % Plan::NS * TS, &md, sm.full + n % Plan::NS, z * sb + y);
        ++n;
      }
      for (int c = 0; c < 2; ++c) {  // dO for dV^T (warpgroup 0), Q for dK^T (1)
        load_output<TS>(sm.claim(n, Plan::UNIT), &mo, sm.full + n % Plan::NS, 128 * c, y, z);
        ++n;
        load_output<TS>(sm.claim(n, Plan::UNIT), &mq, sm.full + n % Plan::NS, 128 * c, y, z);
        ++n;
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  // the warpgroup a compile-time constant: its shared addresses and the
  // descriptors built from them are then uniform (uniform registers),
  // not per-thread values
  auto consumer = [&](auto which) {
    constexpr int wg = decltype(which)::value;
    const int t = threadIdx.x % 128, w = t / 32, g4 = (t % 32) / 4, t4 = t % 4;
    const float scale2 = geo.scale * kLog2e;
    uint32_t woff[4];  // the thread's words in an output unit
    unit_offsets<TS>(woff, w, g4, t4);
    // the B tiles: P (hi, lo), then dS (hi, lo)
    uint8_t* pt = sm.bt;
    uint8_t* dst = sm.bt + 2 * BTILE;
    const uint32_t own = smem_addr(sm.own + wg * OWN1);  // K (warpgroup 0) or V
    const uint32_t bh = smem_addr(wg == 0 ? pt : dst);
    float acc[4][32];  // dV^T (warpgroup 0) or dK^T (1), by 64-column block of d
#pragma unroll
    for (int b = 0; b < 4; ++b) zero(acc[b]);
    float x[TS / 2];  // warpgroup 0: S^T, then P^T; warpgroup 1: dP^T, then dS^T (rows k, columns q)
    int k = 0;        // the warpgroup's units so far: its next is unit 2 k + wg
    // the walk stepped a tile at a time, as much of it as the consumers
    // read: the q-tile (tiles before walk.first are the diagonal's)
    int qt = walk.qs;
    mbar_wait(sm.own_full, 0);
#pragma unroll 1
    for (int i = 0; i < walk.total; ++i) {
      // this tile's lse (warpgroup 0) or delta (1) rows: in the rows of its
      // last forming unit, which no later load overwrites before the tile's
      // gradients are formed
      const float* Rs = sm.rows + (2 * (k + 3) + wg) % Plan::NS * TS + 2 * t4;
      zero(x);  // its last value dead (the first block overwrites it): not held through the outputs
#pragma unroll 1
      for (int c = 0; c < 4; ++c, ++k) {
        const int n = 2 * k + wg;
        sm.wait(n);
        form_unit<T, TS>(x, own, smem_addr(sm.slot(n)), 2 * c, w, t % 32);
        mbar_arrive(sm.empty + n % Plan::NS);
      }
      if (wg == 0) {  // P^T into the P tiles
        const int q0 = qt * TS;
        const bool diag = geo.causal && i < walk.first;
        auto entries = [&](auto edge) {
          constexpr bool masks = decltype(edge)::value;
#pragma unroll
          for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int qi = q0 + 8 * jj + 2 * t4 + c;
              const float l2 = Rs[8 * jj + c] * kLog2e;
#pragma unroll
              for (int ii = 0; ii < 2; ++ii) {
                const int e = 4 * jj + 2 * ii + c, kj = k0 + 16 * w + g4 + 8 * ii;
                x[e] = prob(x[e], scale2, l2, masks && (qi >= sb || (diag && kj > qi)));
              }
            }
        };
        if (diag || q0 + TS > sb) entries(std::true_type());
        else entries(std::false_type());
        if (i >= 1) named_sync(6, 256);  // warpgroup 1 has read tile i - 1's P
#pragma unroll
        for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int e = 4 * jj + 2 * ii;
            put_split2<T>(pt, pt + BTILE, 16 * w + g4 + 8 * ii, 8 * jj + 2 * t4, x[e], x[e + 1]);
          }
        fence_async_shared();
        named_sync(2, 128);  // the warpgroup's own products read them next
        named_arrive(4, 256);
      } else {  // dS^T = P^T (dP^T - delta) scale into the dS tiles
        named_sync(4, 256);  // tile i's P is there
#pragma unroll
        for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int e = 4 * jj + 2 * ii;
            const uint32_t off = sw128_f32(16 * w + g4 + 8 * ii, 8 * jj + 2 * t4, T);
            const float2 h2 = *reinterpret_cast<const float2*>(pt + off);
            const float2 l2 = *reinterpret_cast<const float2*>(pt + BTILE + off);
            x[e] = (h2.x + l2.x) * (x[e] - Rs[8 * jj]) * geo.scale;
            x[e + 1] = (h2.y + l2.y) * (x[e + 1] - Rs[8 * jj + 1]) * geo.scale;
          }
        if (i + 1 < walk.total) named_arrive(6, 256);
#pragma unroll
        for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int e = 4 * jj + 2 * ii;
            put_split2<T>(dst, dst + BTILE, 16 * w + g4 + 8 * ii, 8 * jj + 2 * t4, x[e], x[e + 1]);
          }
        fence_async_shared();
        named_sync(3, 128);  // the warpgroup's own products read them next
      }
      if (++qt == walk.nq) qt = i + 1 < walk.first ? walk.qs : 0;
      // warpgroup 0: dV^T += dO^T P; 1: dK^T += Q^T dS, over its two output
      // units, one m64 block at a time
#pragma unroll
      for (int c = 0; c < 2; ++c, ++k) {
        const int n = 2 * k + wg;
        sm.wait(n);
        const uint32_t u = smem_addr(sm.slot(n));
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          uint32_t ah[TS / 8][4], al[TS / 8][4];
          unit_frags<TS>(ah, al, u, woff, mb);
#pragma unroll
          for (int nh = 0; nh < 2; ++nh) {  // K rows 32 nh .. 32 nh + 31: 32 temporaries
            float of[16], os[16];
            out_issue_quarter<TS>(of, os, ah, al, bh + nh * 32 * 128);
            wgmma_wait<0>();
            out_add_quarter(acc[2 * c + mb], nh, of, os);
          }
          keep(ah);  // in flight across the first half's sums
          keep(al);
        }
        mbar_arrive(sm.empty + n % Plan::NS);
      }
    }
    // acc[b][4j + 2i + c] = dX[k0 + 8j + 2 t4 + c][64 b + 16 w + g4 + 8i]
    float* out = wg == 0 ? dv : dk;
    const int col0 = 16 * w + g4;
    const long long kv_row0 = (long long)zk * sb + k0;  // formed here: not held through the walk
#pragma unroll
    for (int jq = 0; jq < 8; ++jq)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int row = 8 * jq + 2 * t4 + c;
        if (k0 + row >= sb) continue;
        float* o = out + (kv_row0 + row) * D + col0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          o[64 * b] = acc[b][4 * jq + c];
          o[64 * b + 8] = acc[b][4 * jq + 2 + c];
        }
      }
  };
  if (threadIdx.x < 128) consumer(std::integral_constant<int, 0>());
  else consumer(std::integral_constant<int, 1>());
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

// the float32 forms at d = 128 and 256 (their plans)
template <int D>
int bwd_dq_f32_wg(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                  const float* delta, void* dq, Geo geo, int ngroups, cudaStream_t s) {
  using Plan = std::conditional_t<D == 128, DqF32Plan<D>, DqF32UnitPlan<D>>;
  const int planes = ngroups * geo.g;
  CUtensorMap mq, mo, mk, mv;
  int err = f32_map(&mq, q, D, geo.sb, planes * geo.hq, Plan::T);
  if (!err) err = f32_map(&mo, dout, D, geo.sb, planes * geo.hq, Plan::T);
  if (!err) err = f32_map(&mk, k, D, geo.sb, planes * geo.hkv, Plan::TS);
  if (!err) err = f32_map(&mv, v, D, geo.sb, planes * geo.hkv, Plan::TS);
  if (!err) err = set_smem(attn_bwd_dq_f32_kernel<D>, Plan::SMEM);
  if (err) return err;
  dim3 grid((geo.sb + Plan::T - 1) / Plan::T, geo.hq, planes);
  attn_bwd_dq_f32_kernel<D><<<grid, kClusterThreads, Plan::SMEM, s>>>(
      mq, mo, mk, mv, lse, delta, static_cast<float*>(dq), geo);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dkv_f32_wg(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, void* dk, void* dv, Geo geo, int ngroups, cudaStream_t s) {
  using Plan = std::conditional_t<D == 128, DkvF32Plan<D>, DkvF32UnitPlan<D>>;
  const int planes = ngroups * geo.g;
  CUtensorMap mk, mv, mq, mo, ml, md;
  int err = f32_map(&mk, k, D, geo.sb, planes * geo.hkv, Plan::T);
  if (!err) err = f32_map(&mv, v, D, geo.sb, planes * geo.hkv, Plan::T);
  if (!err) err = f32_map(&mq, q, D, geo.sb, planes * geo.hq, Plan::TS);
  if (!err) err = f32_map(&mo, dout, D, geo.sb, planes * geo.hq, Plan::TS);
  if (!err) err = rows_map(&ml, lse, (long long)planes * geo.hq * geo.sb, Plan::TS);
  if (!err) err = rows_map(&md, delta, (long long)planes * geo.hq * geo.sb, Plan::TS);
  if (!err) err = set_smem(attn_bwd_dkv_f32_kernel<D>, Plan::SMEM);
  if (err) return err;
  dim3 grid((geo.sb + Plan::T - 1) / Plan::T, geo.hkv, planes);
  attn_bwd_dkv_f32_kernel<D><<<grid, kClusterThreads, Plan::SMEM, s>>>(
      mk, mv, mq, mo, ml, md, static_cast<float*>(dk), static_cast<float*>(dv), geo);
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
  if (dtype == 0 && d == 128) return bwd_dq_f32_wg<128>(q, k, v, dout, L, Dl, dq, geo, ngroups, s);
  if (dtype == 0 && d == 256) return bwd_dq_f32_wg<256>(q, k, v, dout, L, Dl, dq, geo, ngroups, s);
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
  if (dtype == 0 && d == 128) return bwd_dkv_f32_wg<128>(q, k, v, dout, L, Dl, dk, dv, geo, ngroups, s);
  if (dtype == 0 && d == 256) return bwd_dkv_f32_wg<256>(q, k, v, dout, L, Dl, dk, dv, geo, ngroups, s);
  if (dtype == 1 && d == 128) return bwd_dkv_bf16<128>(q, k, v, dout, L, Dl, dk, dv, geo, ngroups, s);
  if (dtype == 1 && d == 256) return bwd_dkv_bf16<256>(q, k, v, dout, L, Dl, dk, dv, geo, ngroups, s);
  return kBadShape;
}
