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
//   wgmmas.  Three bf16 products per entry where the bound counts two (4d
//   flops an entry): the design floor is 1.5 times the bf16 bound.
//   float32 inputs: every operand split into TF32 hi and lo (hopper.cuh),
//   a product a_lo b_hi + a_hi b_hi + a_hi b_lo on TF32 wgmma in chains of
//   four k steps added by float32 adds (hopper.cuh's TF32 note): three TF32
//   products an entry's product, so the design floor is the split-TF32
//   bound (the bound's 4d flops at a third of the TF32 rate).
// The exponentials are exp2 of scores scaled by scale log2(e) (one multiply
// and the special-function unit), m kept in the same units; lse converts
// back with ln 2.
//
// Design.  On one card all ranks' blocks share one memory, so no K/V block
// travels: a block reads the blocks its ring would have delivered, in the
// order it would have delivered them (DqWalk, ring_attention.cuh); the
// RDMA slots, credits and barriers of the TPU design have no counterpart.
// Every block owns its outputs.  Under causal masking rank g-1 has g
// arrivals and rank 0 one, so the grid starts the heaviest blocks first
// (last rank, last q-tile).  Tiles that causal masking empties for the
// whole block are skipped: future blocks, and k-tiles past the one holding
// the block's last row; rows that end before such a tile fold it all
// masked (P = 0, alpha = 1: exact zeros).  The softmax state of a row
// lives in the four threads that hold its scores in the accumulator
// fragment (m16n8 layout: row g, columns 2t, 2t + 1 of each 8-column
// group), which reduce with two shuffles.
//   bf16 (attn_fwd_bf16_kernel): a block per (rank, query head, 128 Q
//   rows), 384 threads, one block an SM.  A producer warpgroup gives its
//   registers to two consumer warpgroups (setmaxnreg, 40 and 232 a
//   thread); one of its threads loads the block's Q tile, then keeps the
//   walk's K and V tiles (TS = 128 rows at d = 128, 64 at d = 256) in
//   flight by TMA (3-D tensor maps, 128-byte swizzle, rows past Sb read as
//   zeros) through a ring of NS one-tile stages with full and empty
//   mbarriers: unit 2i is tile i's K, unit 2i + 1 its V (ring_attention.cuh,
//   Bf16Smem and stream_tiles, the backward's).  Each consumer warpgroup
//   owns 64 Q rows and their O (64 registers a thread per 128 columns).
//   S = Q K^T is an m64nTS k16 wgmma chain over d/16 steps, both operands
//   K-major in shared memory; the scores become P in registers, and its
//   accumulator fragment, split hi/lo, is the A operand of m64n128k16
//   wgmmas whose B is the V tile read MN-major with the transpose bit (per
//   16-row k step its lo, then its hi product; two 128-column halves at
//   d = 256).  Iteration i issues tile i's S, then tile i - 1's P V, one
//   commit group each; wgmma_wait<1> finds S done (K's stage is released)
//   and leaves P V on the tensor core while the warpgroup folds tile i's
//   scores; wgmma_wait<0> releases V's stage (and tile i - 1's P
//   fragments, whose registers are pinned to it by keep:
//   ring_attention.cuh), O is rescaled by e^(m - m'), and P is split.  No
//   group is in flight across the loop's back edge (ptxas then serialises
//   every wgmma: the backward's first builds, C7514).  The two warpgroups
//   run on their own, each filling the other's gaps: no barrier a tile
//   between them.  (A ping-pong of the two on
//   named barriers orders one's softmax against the other's products but
//   leaves each one's own products waiting on its softmax; the backward's
//   builds measured no gain from it.)  TS: at d = 128 a 128-row tile halves
//   the per-tile work around the softmax (the waits, the shuffles of the
//   row maxima and sums, the rescale) and reads Q once for 128 columns of
//   S; at d = 256, O (128 registers a thread), S and P's fragments of a
//   128-row tile would pass the consumers' 232.  Shared memory
//   (FwdBf16Plan): 1 KB alignment, Q 128 x d, NS = 6 (d = 128) or 5
//   (d = 256) stages of TS x d, the mbarriers: 230 504 and 230 488 bytes.
//   What it does about the earlier form's waits (the math threads staged
//   every tile by cp.async and met at a block-wide barrier each tile, which
//   kept the warpgroups' tensor-core gaps in step): the producer stages,
//   the consumers issue no copy and pass no block-wide barrier; tiles with
//   no masked entry and no column past Sb (all but a warp's last diagonal
//   tiles and a ragged last tile) fold unmasked; the walk is stepped
//   (DqCursor), never divided; O's rescale is skipped where alpha is 1 for
//   every row of a warp (a warp-uniform vote), which changes no bit; P and
//   alpha are ex2's (exp2f's value above 2^-126, 0 below).  The order of
//   every sum is the earlier form's (S one chain over d, O one tensor-core
//   accumulator over the walk) and a 128-row block only adds all-masked
//   tiles (exact zeros): at d = 256 out and lse are its bits; at d = 128
//   the running maximum steps every 128 columns, not 64, so P rounds at
//   other places (ROADMAP, recorded differences).
//   float32 (attn_fwd_f32_kernel): the same producer and two consumer
//   warpgroups (setmaxnreg 40 and 232), TF32 wgmma.  A 32-bit operand is
//   read from shared memory K-major only, and V lands row-major, so O is
//   formed transposed, O^T = V^T P^T, as in the forms above d = 256
//   (attention_wide.cu): A is V read transposed from its landed tile and
//   split in registers, B the warpgroup's P, written K-major after the fold
//   as hi rows then lo rows (put_split2), and the rescale scales columns of
//   O^T, its alpha by row through shared memory (one named barrier of the
//   warpgroup, whose OR of alpha != 1 is the vote that skips it).  S = Q
//   K^T as in the float32 backward (form_rows, after form_blocks): A the own Q
//   rows read by ldmatrix and split in registers, B the streamed K tile
//   read raw beside its lo rows, which the producer's warps 1-3 write once
//   it lands, so a_hi [b_hi; b_lo] is one m64n64 wgmma; two commit groups a
//   32-column block and two blocks' accumulators, so the tensor core has
//   the next block while a block's parts are added.  P V: per 64 columns of
//   O, over the 32-row tile, a_hi b_hi one chain and a_lo b_hi + a_hi b_lo
//   another, added to O by float32 adds.  K and V stream in 32-row tiles as units of 128
//   columns.  At d = 128 a block is 128 Q rows, warpgroup wg rows 64 wg ..
//   and all of O's columns (64 accumulator registers a thread), two slots
//   of whole tiles.  At d = 256, O's 64 rows by 256 columns would be 128
//   registers a thread, so a block is 64 Q rows and warpgroup wg owns O's
//   columns 128 wg ..; each forms S over its own half of d from its own K
//   unit, and the two halves' sums are added through shared memory (two
//   tile parities, a named barrier of both warpgroups), the same bits in
//   both, which fold alike; one slot of a tile's two units, each released
//   by its warpgroup alone, so a half reloads under the rest of its tile.
//   Shared memory (FwdF32Plan): 1 KB alignment, Q 65 536, K units with lo
//   rows 32 768 and V units 16 384 in two slots, the P tiles 32 768, at
//   d = 256 the parts of S 32 768, the rows' alpha 512, 88 of mbarriers:
//   198 232 and 231 000 bytes.
//   What the earlier form (three or one warpgroups of four warps, split
//   TF32 m16n8k8 warp products, per-thread asynchronous copies) waited on,
//   and what this one does about it: its products ran at a third of the
//   warp products' TF32 rate (here wgmma); no copy overlapped the products
//   and every tile ended at a block-wide barrier (here a TMA producer and
//   mbarriers, no block-wide barrier a tile); every warp split the same
//   streamed words again (here K's lo once a staging, V split once by the
//   warpgroup that reads it); every entry tested the mask and every tile
//   divided (here an unmasked path and stepped walks).  The form that kept
//   O in rows (P as a register A operand, the producer's warps writing each
//   V tile's transpose, hi and lo) was measured on the card first: its
//   warps 1-3 spent the whole tile transposing, and the consumers waited on
//   them (PERF.md, Findings).

#include <math.h>

#include <type_traits>

#include "ring_attention.cuh"

namespace {

// bf16: 128 Q rows a block, 64 a consumer warpgroup; NS one-tile stages of
// K or V tiles.  float32: T Q rows a block, consumer warpgroup wg's own
// rows from WROWS wg and its 128 columns of O from WCOLS wg (d = 128: rows
// 64 wg .., every column; d = 256: the block's 64 rows, columns 128 wg ..);
// a tile's K and V as U units of 128 columns, NS tiles of them (KU: a
// 32-row K unit with its lo rows; VU: a V unit); PT: the warpgroups' P
// tiles, hi and lo; XCH: d = 256, two parities of the warpgroups' parts of
// S; RB: the rows' alpha.
template <int D> struct FwdBf16Plan {
  static constexpr int T = 128, TS = D == 128 ? 128 : 64, NS = D == 128 ? 6 : 5, OWN = T * D * 2,
      STAGE = TS * D * 2, XCH = 0, ROWS = 0, BARS = 8 * (2 * NS + 1);
  static constexpr int SMEM = 1024 + OWN + NS * STAGE + XCH + NS * ROWS + BARS;
};
template <int D> struct FwdF32Plan {
  static constexpr int T = D == 128 ? 128 : 64, WROWS = D == 128 ? 64 : 0, WCOLS = D == 128 ? 0 : 128,
      TS = 32, U = D / 128, NS = D == 128 ? 2 : 1, OWN = T * D * 4, KU = 2 * TS * 128 * 4,
      VU = TS * 128 * 4, PT = 2 * 2 * 64 * TS * 4, XCH = D == 128 ? 0 : 2 * 2 * 64 * TS * 4,
      RB = 2 * 64 * 4, BARS = 8 * (5 * NS * U + 1);
  static constexpr int SMEM = 1024 + OWN + NS * U * (KU + VU) + PT + XCH + RB + BARS;
};

// out = o / l for the thread's two rows (o: NC groups of 8 columns from
// column 0, layout as fold_scores'), lse = m ln 2 + log l, m ln 2 rounded
// on its own, never contracted with the add into one fma (the bits of the
// bf16 forward's earlier form's lse); rows past Sb are never written
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
    if (t4 == 0) lse[row0 + qi] = __fmul_rn(m[i], kLn2) + logf(l[i]);
  }
}

// ------------------------------------------------------------------- bf16
// O += P V over one V tile of TS = 16 KS rows (P split hi/lo), one
// 128-column half of O at a time, per 16-row k step its lo then its hi
// product; committed as one wgmma group
template <int NH, int KS>
__device__ __forceinline__ void issue_pv(float (&acc)[NH][64], const uint32_t (&ph)[KS][4],
                                         const uint32_t (&pl)[KS][4], uint32_t va) {
  constexpr int TS = 16 * KS;
#pragma unroll
  for (int nh = 0; nh < NH; ++nh)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t bv = desc_mnmajor(va + 2 * nh * (TS * 128) + kk * 2048, TS);
      wgmma_m64n128k16_rs_tb(acc[nh], pl[kk], bv);
      wgmma_m64n128k16_rs_tb(acc[nh], ph[kk], bv);
    }
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kClusterThreads, 1)
attn_fwd_bf16_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, bf16* __restrict__ out,
                     float* __restrict__ lse, Geo geo) {
  using Plan = FwdBf16Plan<D>;
  constexpr int T = Plan::T, TS = Plan::TS, NS = Plan::NS, NH = D / 128, NB = D / 64;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Bf16Smem<Plan> sm(smem_raw);
  // the heaviest blocks first: the last rank of a group, its last q-tile
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
    DqCursor at;  // the tile of the next K/V pair
    stream_tiles<NS>(
        2 * walk.total, sm.empty,
        [&] {
          mbar_expect_tx(sm.own_full, Plan::OWN);
          for (int cb = 0; cb < NB; ++cb)
            tma_load_3d(sm.own + cb * T * 128, &mq, sm.own_full, 64 * cb, q0, zq);
        },
        [&](int n, int s) {  // unit 2i: tile i's K; 2i + 1: its V
          const int z = G[(r - at.arr + geo.g) % geo.g] * geo.hkv + kvh, y = at.kt * TS;
          uint8_t* st = sm.stage + s * Plan::STAGE;
          mbar_expect_tx(sm.full + s, Plan::STAGE);
          for (int cb = 0; cb < NB; ++cb)
            tma_load_3d(st + cb * TS * 128, n & 1 ? &mv : &mk, sm.full + s, 64 * cb, y, z);
          if (n & 1) at.next(walk);
        });
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, w = t / 32, g4 = (t % 32) / 4,
            t4 = t % 4;
  const int qw = q0 + 64 * wg + 16 * w, qi0 = qw + g4;  // the warp's, the thread's first row
  const uint32_t qa = smem_addr(sm.own) + wg * 64 * 128;
  const float scale2 = geo.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float acc[NH][64];
#pragma unroll
  for (int nh = 0; nh < NH; ++nh) zero(acc[nh]);
  float s[TS / 8][4];  // tile i's S, then its P
  float(&sf)[TS / 2] = reinterpret_cast<float(&)[TS / 2]>(s);
  uint32_t ph[TS / 16][4], pl[TS / 16][4];  // tile i - 1's P, split
  auto stage = [&](int n) { return smem_addr(sm.stage + (n % NS) * Plan::STAGE); };
  auto landed = [&](int n) { mbar_wait(sm.full + n % NS, (n / NS) & 1); };
  auto scores = [&](int i) {  // S = Q K^T of tile i
    landed(2 * i);
    wgmma_fence();
    rows_product<D, T, TS>(sf, qa, stage(2 * i));
    wgmma_commit();
  };
  DqCursor cur;  // the tile being folded
  auto fold = [&] {  // its scores into P and the state; masks only where the warp's rows need them
    const int k0 = cur.kt * TS;
    const bool diag = geo.causal && cur.arr == 0;
    if (k0 + TS > sb || (diag && k0 + TS - 1 > qw))
      fold_scores<TS / 8, true, true>(s, m, l, alpha, qi0, k0 + 2 * t4, sb, diag, scale2);
    else
      fold_scores<TS / 8, false, true>(s, m, l, alpha, qi0, k0 + 2 * t4, sb, diag, scale2);
    cur.next(walk);
  };
  auto split_p = [&] {  // tile i's P as hi and lo A fragments
#pragma unroll
    for (int kk = 0; kk < TS / 16; ++kk) acc_to_frag(sf, kk, ph[kk], pl[kk]);
  };
  mbar_wait(sm.own_full, 0);
  scores(0);
  wgmma_wait<0>();
  reg_fence(sf);
  mbar_arrive(sm.empty);  // tile 0's K is read
  fold();  // O is 0: no rescale
  split_p();
#pragma unroll 1
  for (int i = 1; i < walk.total; ++i) {
    landed(2 * i - 1);  // tile i - 1's V
    scores(i);
    issue_pv(acc, ph, pl, stage(2 * i - 1));
    wgmma_wait<1>();  // tile i's S; tile i - 1's P V runs on
    reg_fence(sf);
    mbar_arrive(sm.empty + (2 * i) % NS);  // its K is read
    fold();
    wgmma_wait<0>();
    keep(ph);  // tile i - 1's P, in flight under fold(): its registers to here
    keep(pl);
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) reg_fence(acc[nh]);
    mbar_arrive(sm.empty + (2 * i - 1) % NS);  // tile i - 1's V is read
    // where alpha is 1 for every row of the warp, the rescale changes no bit
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int nh = 0; nh < NH; ++nh)
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[nh][e] *= alpha[(e >> 1) & 1];
    }
    split_p();
  }
  landed(2 * walk.total - 1);
  wgmma_fence();
  issue_pv(acc, ph, pl, stage(2 * walk.total - 1));
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
// The regions of the float32 kernel's shared memory, in the plan's order
// (1024-byte aligned: the swizzle's need), and its mbarriers.  A tile's K
// and V come as U units of 128 columns (d = 128: one, both warpgroups'; d =
// 256: two, unit u warpgroup u's), unit u of tile n in slot (n % NS) U + u:
// K's loads landed (k_full) and its lo rows written (k_lo), its readers
// done with it (k_empty); V's loads landed (v_full), its readers done
// (v_empty); the own tile landed.
template <typename Plan>
struct FwdF32Smem {
  static constexpr int kWriters = 96, kSlots = Plan::NS * Plan::U;  // writers: the producer's warps 1-3
  uint8_t* own;  // Q: [D / 32][T x 128 bytes]
  uint8_t* kt;   // kSlots x [4][raw, lo][TS x 128 bytes]: K units
  uint8_t* v;    // kSlots x [4][TS x 128 bytes]: V units
  uint8_t* pt;   // [2][hi, lo][64 x 128 bytes]: each warpgroup's P, the B of O^T
  uint8_t* xch;  // d = 256: [2 parities][2][64 x TS floats]: each warpgroup's part of S
  float* rows;   // [2][64]: each warpgroup's alpha of a tile's rows (at the end, l)
  uint64_t *k_full, *k_lo, *k_empty, *v_full, *v_empty, *own_full;
  __device__ explicit FwdF32Smem(uint8_t* raw) {
    own = align1024(raw);
    kt = own + Plan::OWN;
    v = kt + kSlots * Plan::KU;
    pt = v + kSlots * Plan::VU;
    xch = pt + Plan::PT;
    rows = reinterpret_cast<float*>(xch + Plan::XCH);
    k_full = reinterpret_cast<uint64_t*>(xch + Plan::XCH + Plan::RB);
    k_lo = k_full + kSlots;
    k_empty = k_lo + kSlots;
    v_full = k_empty + kSlots;
    v_empty = v_full + kSlots;
    own_full = v_empty + kSlots;
  }
  // one thread, before anything else
  __device__ void init() const {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(k_lo + s, kWriters);
      mbar_init(k_empty + s, kConsumers / Plan::U);
      mbar_init(v_full + s, 1);
      mbar_init(v_empty + s, kConsumers / Plan::U);
    }
    mbar_init(own_full, 1);
    fence_mbar_init();
  }
};

// The producer's warps 1-3: once a K unit has landed, its lo rows after
// each 32-column block's raw rows
template <typename Plan>
__device__ __forceinline__ void fwd_f32_lo(const FwdF32Smem<Plan>& sm, int tiles) {
  constexpr int NS = Plan::NS, U = Plan::U, Q4 = Plan::TS * 128 / 16, N4 = 4 * Q4,
      NW = FwdF32Smem<Plan>::kWriters;  // float4s: a block's raw rows, a unit's
  const int t = threadIdx.x - kConsumers - 32;
  for (int n = 0; n < tiles; ++n)
    for (int u = 0; u < U; ++u) {
      const int s = n % NS * U + u;
      mbar_wait(sm.k_full + s, (n / NS) & 1);
      float4* k = reinterpret_cast<float4*>(sm.kt + s * Plan::KU);
      for (int i = t; i < N4; i += NW) {
        float4* raw = k + (i / Q4) * 2 * Q4 + i % Q4;
        const float4 x = *raw;
        raw[Q4] = make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
      }
      fence_async_shared();
      mbar_arrive(sm.k_lo + s);
    }
}

// f (m64nTS: the warpgroup's 64 own rows at `a`, in a T-row tile, by the
// tile's TS streamed rows) = A B^T over four 32-column blocks of d: A read
// by ldmatrix and split in registers (hi: the word with its low 13 bits
// cleared; lo: the rest), B a K unit at `b` (each block's raw rows, then
// its lo rows).  A block's chains, four k steps each: a_hi [b_hi; b_lo]
// (m64n2TS: a_hi b_hi in columns 0 .. TS - 1, a_hi b_lo after them) and
// a_lo b_hi (m64nTS); its part a_hi b_hi + (a_lo b_hi + a_hi b_lo) by
// round-to-nearest float32 adds, the blocks' parts added in order.  Two
// commit groups a block (k steps 0-1, 2-3: the A registers of one group)
// and two blocks' accumulators, so that the tensor core has the next
// group while a block's parts are added: at most two groups in flight,
// every group waited within the call
template <int T, int TS>
__device__ __forceinline__ void form_rows(float (&f)[TS / 2], uint32_t a, uint32_t b, int w,
                                          int lane) {
  static_assert(TS == 32, "an m64n64 a_hi [b_hi; b_lo] product");
  constexpr int NB = 4;
  const int rr = lane % 8, row = 16 * w + rr + 8 * ((lane / 8) & 1), half = lane / 16;
  const uint32_t arow = a + row * 128;
  uint32_t ah[2][2][4], al[2][2][4];  // [group of a block][k step of it][]
  float hh[2][TS], lh[2][TS / 2];     // [block parity]
  using I0 = std::integral_constant<int, 0>;
  using I1 = std::integral_constant<int, 1>;
  // block cb's k steps 2 p, 2 p + 1 (A set p) into the accumulators of parity x
  auto issue = [&](auto xc, auto pc, int cb) {
    constexpr int x = decltype(xc)::value, p = decltype(pc)::value;
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2) {
      ldsm_x4(ah[p][k2], arow + cb * (T * 128) + (((2 * (2 * p + k2) + half) ^ rr) << 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t v = ah[p][k2][e];
        ah[p][k2][e] = v & 0xFFFFE000u;
        al[p][k2][e] = __float_as_uint(tf32_lo(__uint_as_float(v)));
      }
    }
    wgmma_fence();
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2) {
      const int kk = 2 * p + k2;
      const uint64_t bb = desc_kmajor(opaque(b) + cb * 2 * TS * 128 + kk * 32);
      wgmma_m64n64k8_tf32(hh[x], ah[p][k2], bb, kk > 0);
      wgmma_m64n32k8_tf32(lh[x], al[p][k2], bb, kk > 0);
    }
    wgmma_commit();
  };
  auto add = [&](auto xc, int cb) {
    constexpr int x = decltype(xc)::value;
    reg_fence(hh[x]);
    reg_fence(lh[x]);
#pragma unroll
    for (int e = 0; e < TS / 2; ++e) {
      const float part = hh[x][e] + (lh[x][e] + hh[x][TS / 2 + e]);
      f[e] = cb == 0 ? part : f[e] + part;
    }
  };
  issue(I0(), I0(), 0);
  issue(I0(), I1(), 0);
#pragma unroll
  for (int cb = 0; cb < NB; ++cb) {
    auto step = [&](auto xc, auto yc) {  // x: block cb's parity, y: the next block's
      wgmma_wait<1>();  // block cb's first group
      keep(ah[0]);
      keep(al[0]);
      if (cb + 1 < NB) {
        issue(yc, I0(), cb + 1);
        wgmma_wait<1>();  // block cb's second group
      } else {
        wgmma_wait<0>();
      }
      keep(ah[1]);
      keep(al[1]);
      add(xc, cb);
      if (cb + 1 < NB) issue(yc, I1(), cb + 1);
    };
    if (cb % 2 == 0) step(I0(), I1());
    else step(I1(), I0());
  }
}

// A block per (rank, query head, T-row Q tile), the heaviest first; K and V
// stream in 32-row tiles (DqWalk).  Consumer warpgroup wg: S = Q K^T for
// its 64 own rows (from WROWS wg; at d = 256 over its half of d, the other
// half's part of S taken from warpgroup 1 - wg), the fold, P into its B
// tile; O^T = V^T P^T for its 128 columns of O (from WCOLS wg), two m64
// blocks of 64 columns.
template <int D>
__global__ void __launch_bounds__(kClusterThreads, 1)
attn_fwd_f32_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv, float* __restrict__ out,
                    float* __restrict__ lse, Geo geo) {
  using Plan = FwdF32Plan<D>;
  using Smem = FwdF32Smem<Plan>;
  constexpr int T = Plan::T, TS = Plan::TS, NS = Plan::NS, U = Plan::U, PT1 = Plan::PT / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem sm(smem_raw);
  // the heaviest blocks first: the last rank of a group, its last q-tile
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
      fwd_f32_lo(sm, walk.total);
      return;
    }
    if (threadIdx.x != kConsumers) return;
    mbar_expect_tx(sm.own_full, Plan::OWN);
    for (int cb = 0; cb < D / 32; ++cb)
      tma_load_3d(sm.own + cb * T * 128, &mq, sm.own_full, 32 * cb, q0, zq);
    DqCursor at;  // the tile of the next K/V pair
    for (int n = 0; n < walk.total; ++n) {
      const int z = G[(r - at.arr + geo.g) % geo.g] * geo.hkv + kvh, y = at.kt * TS;
      const uint32_t par = (n / NS - 1) & 1;
      at.next(walk);
      for (int u = 0; u < U; ++u) {
        const int s = n % NS * U + u;
        if (n >= NS) mbar_wait(sm.k_empty + s, par);
        mbar_expect_tx(sm.k_full + s, TS * 128 * 4);
        for (int cb = 0; cb < 4; ++cb)
          tma_load_3d(sm.kt + s * Plan::KU + cb * 2 * TS * 128, &mk, sm.k_full + s,
                      128 * u + 32 * cb, y, z);
      }
      for (int u = 0; u < U; ++u) {
        const int s = n % NS * U + u;
        if (n >= NS) mbar_wait(sm.v_empty + s, par);
        mbar_expect_tx(sm.v_full + s, Plan::VU);
        for (int cb = 0; cb < 4; ++cb)
          tma_load_3d(sm.v + s * Plan::VU + cb * TS * 128, &mv, sm.v_full + s, 128 * u + 32 * cb,
                      y, z);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, w = t / 32, lane = t % 32,
            g4 = lane / 4, t4 = lane % 4;
  const int r0 = Plan::WROWS * wg, c0 = Plan::WCOLS * wg;  // the warpgroup's first row, column
  const int u = U == 2 ? wg : 0;                         // and the unit of a tile it reads
  const int qw = q0 + r0 + 16 * w, qi0 = qw + g4;  // the warp's, the thread's first row
  const uint32_t qa = smem_addr(sm.own) + r0 * 128 + u * 4 * (T * 128), kb = smem_addr(sm.kt),
                 vb = smem_addr(sm.v), pb = smem_addr(sm.pt) + wg * PT1;
  uint8_t* pt = sm.pt + wg * PT1;  // P: hi rows, then lo rows
  float* rows = sm.rows + 64 * wg;
  const float scale2 = geo.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  // O^T: acc[32 mb + 4 j + 2 i + c] = O[row 8 j + 2 t4 + c][column c0 + 64 mb + 16 w + g4 + 8 i]
  float acc[64];
  zero(acc);
  float s[TS / 8][4];  // the tile's S, then its P
  float(&sf)[TS / 2] = reinterpret_cast<float(&)[TS / 2]>(s);
  uint32_t voff[4];  // at d = 256 formed at each tile (the parts of S take the registers)
  if constexpr (U == 1) unit_offsets<TS>(voff, w, g4, t4);
  DqCursor cur;  // the tile being folded
  mbar_wait(sm.own_full, 0);
#pragma unroll 1
  for (int i = 0; i < walk.total; ++i) {
    const int st = i % NS * U + u;
    const uint32_t par = (i / NS) & 1;
    mbar_wait(sm.k_lo + st, par);
    mbar_wait(sm.k_full + st, par);
    form_rows<T, TS>(sf, qa, kb + st * Plan::KU, w, lane);
    mbar_arrive(sm.k_empty + st);  // the K unit is read
    if constexpr (U == 2) {
      // S = the two warpgroups' parts added, the same bits in both
      float4* x = reinterpret_cast<float4*>(sm.xch + (i & 1) * (Plan::XCH / 2));
#pragma unroll
      for (int j = 0; j < TS / 8; ++j)
        x[wg * 512 + j * 128 + t] = make_float4(sf[4 * j], sf[4 * j + 1], sf[4 * j + 2], sf[4 * j + 3]);
      named_sync(3, kConsumers);
#pragma unroll
      for (int j = 0; j < TS / 8; ++j) {
        const float4 y = x[(1 - wg) * 512 + j * 128 + t];
        sf[4 * j] += y.x;
        sf[4 * j + 1] += y.y;
        sf[4 * j + 2] += y.z;
        sf[4 * j + 3] += y.w;
      }
    }
    // the fold; masks only where the warp's rows need them
    const int k0 = cur.kt * TS;
    const bool diag = geo.causal && cur.arr == 0;
    if (k0 + TS > sb || (diag && k0 + TS - 1 > qw))
      fold_scores<TS / 8, true, true>(s, m, l, alpha, qi0, k0 + 2 * t4, sb, diag, scale2);
    else
      fold_scores<TS / 8, false, true>(s, m, l, alpha, qi0, k0 + 2 * t4, sb, diag, scale2);
    cur.next(walk);
    // P, hi and lo, into the warpgroup's B tile (K-major: 64 rows by the
    // tile's TS columns), alpha by row; the last tile's products have read
    // both (every warp of the warpgroup has passed their wait)
#pragma unroll
    for (int jj = 0; jj < TS / 8; ++jj)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii)
        put_split2<64>(pt, pt + PT1 / 2, 16 * w + g4 + 8 * ii, 8 * jj + 2 * t4, s[jj][2 * ii],
                       s[jj][2 * ii + 1]);
    if (t4 == 0) {
      rows[16 * w + g4] = alpha[0];
      rows[16 * w + g4 + 8] = alpha[1];
    }
    fence_async_shared();
    // O^T's columns are rows of O: their alpha from shared memory; where
    // alpha is 1 for every row of the warpgroup, the rescale changes no bit
    if (named_sync_or(1 + wg, 128, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 a = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t4);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            float* o = acc + 32 * mb + 4 * j + 2 * ii;
            o[0] = __fmul_rn(o[0], a.x);
            o[1] = __fmul_rn(o[1], a.y);
          }
      }
    }
    mbar_wait(sm.v_full + st, par);
    const uint32_t vs = vb + st * Plan::VU;
    if constexpr (U == 2) unit_offsets<TS>(voff, opaque(w), opaque(g4), opaque(t4));
    // O^T += V^T P^T, an m64 block (64 columns of O) at a time: A the V
    // unit's columns read transposed and split in registers, B the P tile;
    // over the tile's four k steps a_hi b_hi one chain and a_lo b_hi +
    // a_hi b_lo another (64 registers: the m64n128 a_hi [b_hi; b_lo] and an
    // m64n64 a_lo b_hi took 96 and spilled), added as a_hi b_hi + (a_lo
    // b_hi + a_hi b_lo)
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      uint32_t ah[TS / 8][4], al[TS / 8][4];
#pragma unroll
      for (int kk = 0; kk < TS / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t x;
          asm volatile("ld.shared.b32 %0, [%1];\n"
                       : "=r"(x)
                       : "r"(vs + voff[e] + 2 * mb * TS * 128 + kk * 1024));
          ah[kk][e] = x & 0xFFFFE000u;
          al[kk][e] = __float_as_uint(tf32_lo(__uint_as_float(x)));
        }
      if (mb == 1) mbar_arrive(sm.v_empty + st);  // the V unit is read
      float big[32], small[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TS / 8; ++kk) {
        const uint32_t hb = opaque(pb) + kk * 32;
        const uint64_t bh = desc_kmajor(hb), bl = desc_kmajor(hb + 64 * 128);
        wgmma_m64n64k8_tf32(small, al[kk], bh, kk > 0);
        wgmma_m64n64k8_tf32(small, ah[kk], bl, 1);
        wgmma_m64n64k8_tf32(big, ah[kk], bh, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      keep(ah);
      keep(al);
      reg_fence(big);
      reg_fence(small);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[32 * mb + e] += big[e] + small[e];
    }
  }
  // l by row through shared memory (every reader of the last alpha has
  // passed the last tile's products); out = o / l, lse = m ln 2 + log l
  // (the product rounded apart); at d = 256 both warpgroups hold the same m
  // and l, and warpgroup 0 writes the lse
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int qi = qi0 + 8 * ii;
    if (t4 == 0) {
      rows[16 * w + g4 + 8 * ii] = l[ii];
      if (qi < sb && (Plan::WROWS > 0 || wg == 0))
        lse[row0 + qi] = __fmul_rn(m[ii], kLn2) + logf(l[ii]);
    }
  }
  named_sync(1 + wg, 128);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int row = 8 * j + 2 * t4 + c, qi = q0 + r0 + row;
      if (qi >= sb) continue;
      const float li = rows[row];
      float* dst = out + (row0 + qi) * D + c0 + 16 * w + g4;
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        dst[64 * mb] = acc[32 * mb + 4 * j + c] / li;
        dst[64 * mb + 8] = acc[32 * mb + 4 * j + 2 + c] / li;
      }
    }
}

// ----------------------------------------------------------------- launches
template <int D>
int fwd_f32_launch(const void* q, const void* k, const void* v, void* out, float* lse, Geo geo,
                   int ngroups, cudaStream_t s) {
  using Plan = FwdF32Plan<D>;
  const int planes = ngroups * geo.g;
  CUtensorMap mq, mk, mv;
  int err = f32_map(&mq, q, D, geo.sb, planes * geo.hq, Plan::T);
  if (!err) err = f32_map(&mk, k, D, geo.sb, planes * geo.hkv, Plan::TS);
  if (!err) err = f32_map(&mv, v, D, geo.sb, planes * geo.hkv, Plan::TS);
  if (!err) err = set_smem(attn_fwd_f32_kernel<D>, Plan::SMEM);
  if (err) return err;
  dim3 grid((geo.sb + Plan::T - 1) / Plan::T, geo.hq, planes);
  attn_fwd_f32_kernel<D><<<grid, kClusterThreads, Plan::SMEM, s>>>(mq, mk, mv,
                                                                  static_cast<float*>(out), lse, geo);
  return (int)cudaGetLastError();
}

template <int D>
int fwd_bf16_launch(const void* q, const void* k, const void* v, void* out, float* lse, Geo geo,
                    int ngroups, cudaStream_t s) {
  using Plan = FwdBf16Plan<D>;
  const int planes = ngroups * geo.g;
  CUtensorMap mq, mk, mv;
  int err = bf16_map(&mq, q, D, geo.sb, planes * geo.hq, Plan::T);
  if (!err) err = bf16_map(&mk, k, D, geo.sb, planes * geo.hkv, Plan::TS);
  if (!err) err = bf16_map(&mv, v, D, geo.sb, planes * geo.hkv, Plan::TS);
  if (!err) err = set_smem(attn_fwd_bf16_kernel<D>, Plan::SMEM);
  if (err) return err;
  dim3 grid((geo.sb + Plan::T - 1) / Plan::T, geo.hq, planes);
  attn_fwd_bf16_kernel<D><<<grid, kClusterThreads, Plan::SMEM, s>>>(mq, mk, mv,
                                                                   static_cast<bf16*>(out), lse, geo);
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
  if (dtype == 0 && d == 128) return fwd_f32_launch<128>(q, k, v, out, L, geo, ngroups, s);
  if (dtype == 0 && d == 256) return fwd_f32_launch<256>(q, k, v, out, L, geo, ngroups, s);
  if (dtype == 1 && d == 128) return fwd_bf16_launch<128>(q, k, v, out, L, geo, ngroups, s);
  if (dtype == 1 && d == 256) return fwd_bf16_launch<256>(q, k, v, out, L, geo, ngroups, s);
  return kBadShape;
}
