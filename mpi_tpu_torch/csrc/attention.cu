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
//   float32 (W = 3 at d = 128, 1 at d = 256): Q resident in 64 W rows, K
//   and V in 32-row tiles, two stages, staged by cp.async, row stride
//   d + 4 (conflict-free fragment reads): (64 W + 4 x 32)(d + 4) x 4 =
//   168 960 bytes at d = 128, 199 680 at d = 256.  P's accumulator is the
//   A operand of P V with its k index permuted, as in attn_bwd_dq.

#include <math.h>

#include "ring_attention.cuh"

namespace {

// bf16: 128 Q rows a block, 64 a consumer warpgroup; NS one-tile stages of
// 64-row K or V tiles.  float32: W warpgroups (four warps each), each with
// its own 64 Q rows, share two stages of 32-row K and V tiles.
template <int D> struct FwdBf16Plan {
  static constexpr int T = 128, TS = D == 128 ? 128 : 64, NS = D == 128 ? 6 : 5, OWN = T * D * 2,
      STAGE = TS * D * 2, XCH = 0, ROWS = 0, BARS = 8 * (2 * NS + 1);
  static constexpr int SMEM = 1024 + OWN + NS * STAGE + XCH + NS * ROWS + BARS;
};
template <int D> struct FwdF32Plan {
  static constexpr int W = D == 128 ? 3 : 1;
  static constexpr int T = 64, TS = 32, LD = D + 4, THREADS = 128 * W;
  static constexpr int SMEM = (W * T + 4 * TS) * LD * 4;
};

// out = o / l for the thread's two rows (o: NC groups of 8 columns from
// column 0, layout as fold_scores'), lse = m ln 2 + log l; rows past Sb are
// never written.  Apart: m ln 2 rounded on its own, never contracted with
// the add into one fma (the bf16 forward: the bits of its earlier form's
// lse, whose compiled code, like the float32 forward's, rounded it apart)
template <bool Apart = false, int NC, typename E>
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
    if constexpr (Apart) {
      if (t4 == 0) lse[row0 + qi] = __fmul_rn(m[i], kLn2) + logf(l[i]);
    } else {
      if (t4 == 0) lse[row0 + qi] = m[i] * kLn2 + logf(l[i]);
    }
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
  write_rows<true>(o, m, l, out, lse, row0, qi0, sb, t4);
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
// float32 (E is float: the bf16 form is the kernel above)
template <typename E, int D>
__global__ void __launch_bounds__(FwdF32Plan<D>::THREADS)
attn_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                E* __restrict__ out, float* __restrict__ lse, Geo geo) {
  fwd_f32<D>(q, k, v, out, lse, geo);
}

template <int D>
int fwd_f32_launch(const void* q, const void* k, const void* v, void* out, float* lse, Geo geo,
                   int ngroups, cudaStream_t s) {
  using Plan = FwdF32Plan<D>;
  int err = set_smem(attn_fwd_kernel<float, D>, Plan::SMEM);
  if (err) return err;
  dim3 grid((geo.sb + 64 * Plan::W - 1) / (64 * Plan::W), geo.hq, ngroups * geo.g);
  attn_fwd_kernel<float, D><<<grid, Plan::THREADS, Plan::SMEM, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
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
