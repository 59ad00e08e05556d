// The ring-attention forward (attn_fwd) for head dims above 256: any d that
// is a multiple of 128, given at run time.  The forms for d = 128 and 256
// are csrc/attention.cu; the backward for d above 256 is
// csrc/attention_bwd_wide.cu.
//
// Replaces the Pallas TPU kernel _kernel (mpi_tpu/tpu/pallas_attention.py
// :367, fold _online_fold :116, mask _causal_mask :134), launched by
// _kernel_call (:1059), at the head dims the reference's VMEM plan
// (attention_vmem_plan :290) tiles and csrc/attention.cu's plans do not fit:
// what it computes is written there.
//
// Why another form.  attention.cu keeps a block's Q rows and each staged
// K/V tile whole in shared memory and its O rows in registers, 64 registers
// a thread per 128 columns.  Above d = 256 that is more shared memory than a
// block may use (232 448 bytes) and, at d = 512, more registers than a
// thread has.  So d is cut into 128-column chunks, and the blocks of one
// (rank, query head, 64-row Q tile) run as a thread-block cluster that forms
// S = Q K^T once a K/V tile (in the per-chunk form it replaced, every block
// of a row recomputed all of S for its one output chunk):
//   - the cluster is C blocks (WideCluster, ring_attention.cuh: C the
//     largest divisor of d / 128 that is at most 8); block c owns output
//     chunks c m .. c m + m - 1 (m = d / 128 / C: 1 at every d <= 1024),
//     one a pass over its walk of the K/V tiles (DqWalk), so each block's
//     accumulator is one 128-column chunk at every d;
//   - for each streamed K/V tile, block c forms the partial S_c = Q_c K_c^T
//     over its own m chunks only and writes it to its shared memory,
//     double-buffered by the tile's parity; the cluster sums the C partials
//     over distributed shared memory, every element in rank order 0..C-1,
//     so all blocks fold bit-identical S into bit-identical m, l and P;
//   - then block c adds O_c = O_c alpha + P V_c, V_c the tile's chunk c of
//     V.  The operands of its partial and of its output product are its own
//     columns, so a block loads each byte of its columns once a pass.
//   - At m = 1 a tile's output product runs in the next tile, between the
//     arrive and the wait of its cluster barrier, where it hides the wait;
//     the operations on O keep their order.
// The lse is written by the block of chunk 0.  Numerics as attention.cu: S,
// m, l, o and P float32.
//
// What bounds it.  The reference's work is 4d flops an unmasked score
// entry.  The partials form Q K^T m times (once a pass): bf16 (2m + 2 x 2)
// d flops an entry (P V split hi/lo, two bf16 products), float32 3 (2m + 2)
// d at the TF32 rate (three TF32 products a product).  At m = 1 (every
// d <= 1024) that is 1.5x the bf16 bound and the float32 bound (counted at
// a third of the TF32 rate): the design floors chip_smoke.py counts.  At
// long sequences a tile's cluster barrier, its reads across the cluster and
// the waits between its phases, not the flops, set the time (measured with
// clock stamps per phase, PERF.md).
//
// bf16 (attn_fwd_wide_bf16; one warpgroup, WideFwdBf16Plan).  The partial is
// chunk_product (ring_attention.cuh), 64-row K tiles, a fresh m64n64
// accumulator a chunk added by float32 adds; at m = 1 it is the per-chunk
// product of the form it replaced and the rank-order sums are that form's
// order of adds, so S, P, O and lse are bitwise those of the per-chunk form
// (d = 384, 512, 640, 768, 896, 1024).  The sum is a reduce-scatter (block j
// sums its 1/C share of the partials, a second cluster barrier, every block
// reads the C summed shares): half the bytes over distributed shared memory
// of every block reading all C partials, and faster in bf16 (PERF.md).  P,
// split hi/lo, is the A operand of m64n128k16 wgmmas whose B is V_c read
// MN-major, as in attention.cu.  Copies: thread 0 issues TMA loads (3-D
// tensor maps, rows past the block read as zeros, 128-byte swizzle: the
// layout chunk_product reads) into a ring of NS = 2 stages of units
// u = (tile, chunk), each on an mbarrier: a stage holds the unit's K chunk
// and either the tile's V_c (the tile's last unit, whose chunk is the
// pass's own) or, at m > 1, the unit's Q chunk; the pass's own Q chunk is
// resident, loaded with the pass's second unit, after the last reader of
// the previous one.  Shared memory 1 KB alignment + 5 64 x 128 tiles + 2
// parities of the 64 x 64 float32 partial = 115 712 bytes (the mbarriers in
// the alignment's slack): two blocks an SM.
//
// float32 (attn_fwd_wide_f32; WideFwdF32Plan): the design of the float32
// backward's attn_bwd_dq_wide_f32 without dP.
//   Products: TF32 wgmma, three a product (hopper.cuh's split), every chain
//   of tensor-core sums four k steps long with the hi x hi products apart
//   (the backward's finding: chain length sets the float32 error).  A 32-bit
//   operand is read from shared memory K-major only, so in the partial the
//   streamed K chunk is B, read raw as its hi beside its lo tile (written
//   once a tile), and the own Q chunk is A, split in registers; 32-row K/V
//   tiles; warpgroup wg forms the partial over the chunk's 32-column blocks
//   2 wg and 2 wg + 1 (m64n32k8), and warpgroup 0 adds the two halves.  The
//   sum reads all C partials, every load in flight at once, after one
//   cluster barrier (the reduce-scatter's second barrier cost more than its
//   bytes saved here).  The output is formed transposed, O_c^T = V_c^T P^T:
//   V_c is A (split in registers), P is B, written K-major as hi and lo tiles
//   after the fold; warpgroup wg owns the chunk's columns 64 wg .. 64 wg +
//   63, and the online rescale by alpha scales columns of O^T (the tile's
//   alpha by row goes through shared memory, as do the two warpgroups' row
//   maxima and sums).
//   Copies: one thread of a producer warpgroup keeps TMA loads of the next
//   stage in flight on mbarriers; the two consumer warpgroups run with
//   setmaxnreg; no __syncthreads() after the set-up.  At m > 1 the own Q
//   chunk is reloaded every unit, as in the backward.
//   Shared memory: 1 KB alignment, the own 64 x 128 tile, NS = 2 stages of
//   the 32 x 128 K and V chunks, the K chunk's lo tile, two parities of the
//   64 x 32 partial, the 64 x 32 P tiles (hi, lo), warpgroup 1's half of the
//   partial, the rows' maxima, sums and rescale, the mbarriers: 158 000
//   bytes; one block of 384 threads an SM.

#include <cooperative_groups.h>
#include <math.h>

#include "ring_attention.cuh"

namespace cg = cooperative_groups;

namespace {

// T Q rows (and bf16 K/V rows) a tile; NS stages of the unit ring (a stage
// holds two 64 x 128 tiles); PART: the S partials of two tile parities
struct WideFwdBf16Plan {
  static constexpr int T = 64, TILE = T * 128 * 2, THREADS = 128, NS = 2, PART = 2 * T * T * 4;
  static constexpr int SMEM = 1024 + TILE + NS * 2 * TILE + PART;
};
// float32: T own rows, TS streamed rows a tile, NS stages; the regions of
// the shared memory in bytes, in order (OWN: the T x 128 Q chunk; STAGE: the
// TS x 128 K and V chunks; LO: the K chunk's lo; PART: the S partials of two
// tile parities; BT: P as hi and lo; XB: warpgroup 1's half of the partial;
// ROWS: the rows' maxima and sums of the two warpgroups and the tile's
// rescale; BARS: the mbarriers)
struct WideFwdF32Plan {
  static constexpr int T = 64, TS = 32, NS = 2, OWN = T * 128 * 4, STAGE = 2 * TS * 128 * 4,
      LO = TS * 128 * 4, PART = 2 * T * TS * 4, BT = 2 * T * TS * 4, XB = T * TS * 4,
      ROWS = 5 * T * 4, BARS = 8 * (2 * NS + 2);
  static constexpr int SMEM = 1024 + OWN + NS * STAGE + LO + PART + BT + XB + ROWS + BARS;
};
// out[row, c0 .. c0 + 127] = o / l for the thread's two rows (o: 16 groups
// of 8 columns, the layout of fold_scores), and with write_lse the row's
// lse = m ln 2 + log l; rows past Sb are never written
template <typename E>
__device__ __forceinline__ void write_chunk(const float (&o)[16][4], const float (&m)[2],
                                            const float (&l)[2], E* out, float* lse,
                                            long long row0, int qi0, int sb, int t4, int d,
                                            int c0, bool write_lse) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qi0 + 8 * i;
    if (qi >= sb) continue;
    E* dst = out + (row0 + qi) * d + c0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < 16; ++n) store2(dst + 8 * n, o[n][2 * i] / l[i], o[n][2 * i + 1] / l[i]);
    if (write_lse && t4 == 0) lse[row0 + qi] = m[i] * kLn2 + logf(l[i]);
  }
}

// -- the cluster's sum of a tile's partials ------------------------------------------
// A partial (store_partial, ring_attention.cuh) is the float32 accumulator of
// a block's S_c.  Every element is summed in rank order 0..C-1 (v = p_0,
// v += p_1, ...).

__device__ __forceinline__ const float4* peer_slot(const float* slot, int r) {
  return reinterpret_cast<const float4*>(
      cg::this_cluster().map_shared_rank(const_cast<float*>(slot), r));
}

// s (+)= a, the components in order
__device__ __forceinline__ void add4(float4& s, float4 a) {
  s.x += a.x; s.y += a.y; s.z += a.z; s.w += a.w;
}
__device__ __forceinline__ void put4(float* v, float4 a) {
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// the float32 form: after the partials' barrier every block reads all C
// partials of its threads' elements, every load in flight before the sums
template <int NV>
__device__ __forceinline__ void sum_partials(float (&v)[4 * NV], const float* slot, int at, int C) {
  float4 a[8][NV];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (r < C) {
      const float4* peer = peer_slot(slot, r);
#pragma unroll
      for (int j = 0; j < NV; ++j) a[r][j] = peer[at + 128 * j];
    }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int r = 1; r < 8; ++r)
      if (r < C) add4(a[0][j], a[r][j]);
    put4(v + 4 * j, a[0][j]);
  }
}

// The bf16 form, a reduce-scatter: after the partials' barrier block j of C
// sums float4s [ceil(j N / C), ceil((j + 1) N / C)) of the slot's N over the
// C partials, in place in its own slot (no peer reads that share of it),
// two float4s a thread at a time; after a second barrier every thread reads
// its float4s from their owners.  Half the bytes over distributed shared
// memory of every block reading all C partials.
template <int N, int NTH>
__device__ __forceinline__ void reduce_share(float* slot, int C, int j, int tid) {
  const int lo = (j * N + C - 1) / C, hi = ((j + 1) * N + C - 1) / C;
  for (int x = lo + tid; x < hi; x += 2 * NTH) {
    const int y = x + NTH < hi ? x + NTH : x;
    float4 a[8], b[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < C) {
        const float4* peer = peer_slot(slot, r);
        a[r] = peer[x];
        b[r] = peer[y];
      }
#pragma unroll
    for (int r = 1; r < 8; ++r)
      if (r < C) {
        add4(a[0], a[r]);
        add4(b[0], b[r]);
      }
    reinterpret_cast<float4*>(slot)[x] = a[0];
    reinterpret_cast<float4*>(slot)[y] = b[0];
  }
}
template <int N, int NV>
__device__ __forceinline__ void gather_shares(float (&v)[4 * NV], const float* slot, int at,
                                              int C) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int x = at + 128 * j;
    put4(v + 4 * j, peer_slot(slot, x * C / N)[x]);
  }
}

// ------------------------------------------------------------------- bf16
// A cluster per (rank, query head, 64-row Q tile), one warpgroup a block.
// Unit n = (tile nt, chunk u of the block's m); the pass's output chunk
// comes last in a tile, so its stage holds V_c.  Thread 0 issues the TMA
// loads of unit n + 1 once every thread is done with unit n - 1, the last
// reader of its stage (NS = 2).
__global__ void __launch_bounds__(WideFwdBf16Plan::THREADS)
attn_fwd_wide_bf16(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, bf16* __restrict__ out,
                   float* __restrict__ lse, Geo geo, int d) {
  using Plan = WideFwdBf16Plan;
  constexpr int T = Plan::T, TILE = Plan::TILE, NT = Plan::THREADS, NS = Plan::NS;
  constexpr int STAGE = 2 * TILE;
  static_assert(NS == 2, "a unit's loads are issued one unit ahead");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* Qo = align1024(smem_raw);  // the pass's own Q chunk
  uint8_t* St = Qo + TILE;  // unit n: K chunk, then V_c or a Q chunk, at St + (n % NS) STAGE
  float* Part = reinterpret_cast<float*>(St + NS * STAGE);  // tile nt's partial at (nt % 2) T T
  // the mbarriers (a stage's loads, the own chunk's): in the alignment's
  // slack, or after the partials where the slack is too small
  uint64_t* full = reinterpret_cast<uint64_t*>(Qo - smem_raw >= 8 * (NS + 1) ? smem_raw
                                               : reinterpret_cast<uint8_t*>(Part + 2 * T * T));
  uint64_t* own_full = full + NS;
  const int C = cluster_blocks(d / kChunk), m = d / kChunk / C;
  const QueryBlock b(geo, C);  // b.c: the block's rank in the cluster
  const int warp = threadIdx.x / 32, g4 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int sb = geo.sb, q0 = b.qt * T, qi0 = q0 + 16 * warp + g4;
  const int zq = (int)(b.row0 / sb);
  const float scale2 = geo.scale * kLog2e;
  const DqWalk walk(geo, b.r, q0, T, T);
  const int units = m * m * walk.total;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(full + s, 1);
    mbar_init(own_full, 1);
    fence_mbar_init();
  }
  __syncthreads();

  // 64 x 128 chunk `col` of a plane (rows from y) into a swizzled tile: two
  // boxes of 64 columns
  auto load = [&](uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int col, int y, int z) {
    tma_load_3d(dst, map, bar, col, y, z);
    tma_load_3d(dst + T * 128, map, bar, col + 64, y, z);
  };
  auto fetch = [&](int n) {  // thread 0
    const int nt = n / m, u = n % m, pass = nt / walk.total, i = nt % walk.total;
    int arr, kt;
    walk.at(i, arr, kt);
    const int col = (b.c * m + (pass + 1 + u) % m) * kChunk, z = b.kv_plane(geo, arr), y = kt * T;
    uint8_t* s = St + (n % NS) * STAGE;
    uint64_t* bar = full + n % NS;
    mbar_expect_tx(bar, STAGE);
    load(s, &mk, bar, col, y, z);
    if (u == m - 1)
      load(s + TILE, &mv, bar, col, y, z);
    else
      load(s + TILE, &mq, bar, col, q0, zq);
    // the pass's own Q chunk: with unit 0, or (pass > 0) with the pass's
    // unit 1, issued after the barrier that ends the last unit to read the
    // previous pass's chunk
    if (i == 0 && u == (pass > 0 ? 1 : 0)) {
      mbar_expect_tx(own_full, TILE);
      load(Qo, &mq, own_full, (b.c * m + pass) * kChunk, q0, zq);
    }
  };
  if (threadIdx.x == 0) fetch(0);

  float mr[2], l[2], acc[64], alpha[2];
  uint32_t ph[4][4], pl[4][4];  // the folded tile's P, hi and lo
  float s[8][4];
  float(&sf)[32] = reinterpret_cast<float(&)[32]>(s);
  // O_c = O_c alpha + P V_c for the folded tile (V_c at va); the pass's last
  // tile writes the chunk
  auto pv = [&](uint32_t va, bool last, int pass) {
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] *= alpha[(e >> 1) & 1];
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bv = desc_mnmajor(va + kk * 2048, T);
      wgmma_m64n128k16_rs_tb(acc, pl[kk], bv);
      wgmma_m64n128k16_rs_tb(acc, ph[kk], bv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    if (last) {
      float o[16][4];
#pragma unroll
      for (int e = 0; e < 64; ++e) o[e / 4][e % 4] = acc[e];
      const int c = b.c * m + pass;
      write_chunk(o, mr, l, out, lse, b.row0, qi0, sb, t4, d, c * kChunk, c == 0);
    }
  };
  // At m = 1 a tile's P V runs in the next tile, between the arrive and the
  // wait of its first cluster barrier (the operations on O keep their order,
  // so the result is bitwise the same); the next unit's loads then go into
  // the stage that P V has released.  At m > 1 they are issued at the top of
  // a unit, after the barrier that ends the last reader of their stage.
  const bool defer = m == 1;
  for (int n = 0; n < units; ++n) {
    if (!defer || n == 0) {
      if (n > 0) __syncthreads();  // every thread is done with unit n - 1
      if (threadIdx.x == 0 && n + 1 < units) fetch(n + 1);
    }
    const int nt = n / m, u = n % m, pass = nt / walk.total, i = nt % walk.total;
    if (i == 0 && u == 0) {  // a pass begins
      mr[0] = mr[1] = -INFINITY;
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    }
    mbar_wait(full + n % NS, (n / NS) & 1);
    if (i == 0 && u == m - 1) mbar_wait(own_full, pass & 1);
    const uint32_t ka = smem_addr(St + (n % NS) * STAGE), xa = ka + TILE;
    chunk_product(sf, u == m - 1 ? smem_addr(Qo) : xa, ka, u == 0);  // S_c += Q_u K_u^T
    if (u < m - 1) continue;

    // the tile's S (the reduce-scatter), then the fold
    float* slot = Part + (nt & 1) * (T * T);
    store_partial<8>(slot, sf, threadIdx.x);
    cluster_arrive();
    if (defer && n > 0) {
      pv(smem_addr(St + ((n - 1) % NS) * STAGE) + TILE, false, 0);
      __syncthreads();  // every thread is done with unit n - 1's stage
      if (threadIdx.x == 0 && n + 1 < units) fetch(n + 1);
    }
    cluster_wait();
    reduce_share<T * T / 4, NT>(slot, C, b.c, threadIdx.x);
    cluster_sync();
    gather_shares<T * T / 4, 8>(sf, slot, threadIdx.x, C);
    int arr, kt;
    walk.at(i, arr, kt);
    fold_scores(s, mr, l, alpha, qi0, kt * T + 2 * t4, sb, geo.causal && arr == 0, scale2);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_frag(sf, kk, ph[kk], pl[kk]);
    if (!defer) pv(xa, i == walk.total - 1, pass);
  }
  if (defer) pv(smem_addr(St + ((units - 1) % NS) * STAGE) + TILE, true, 0);
  cluster_sync();  // no block leaves while a peer may read its partials
}

// ---------------------------------------------------------------- float32
// A cluster per (rank, query head, 64-row Q tile); own Q, streamed K and V
// in 32-row tiles (DqWalk).  Partial: warpgroup wg the chunk's 32-column
// blocks 2 wg, 2 wg + 1, the halves added in shared memory; output: O_c^T =
// V_c^T P^T, warpgroup wg the chunk's columns 64 wg .. 64 wg + 63.  At m = 1
// a tile's output product runs after the next tile's partial, between the
// cluster barrier's arrive and wait.
__global__ void __launch_bounds__(kClusterThreads, 1)
attn_fwd_wide_f32(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv, float* __restrict__ out,
                  float* __restrict__ lse, Geo geo, int d) {
  using Plan = WideFwdF32Plan;
  constexpr int T = Plan::T, TS = Plan::TS, NS = Plan::NS, HALF = Plan::STAGE / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* own = align1024(smem_raw);
  uint8_t* stage = own + Plan::OWN;  // stage s: K chunk, then V_c, at stage + s STAGE
  uint8_t* lo = stage + NS * Plan::STAGE;
  float* part = reinterpret_cast<float*>(lo + Plan::LO);  // tile nt's partial at (nt % 2) T TS
  uint8_t* bt = lo + Plan::LO + Plan::PART;               // P: hi, then lo
  float* xbuf = reinterpret_cast<float*>(bt + Plan::BT);
  float* rows = xbuf + T * TS;
  // [NS]: a stage landed
  uint64_t* full = reinterpret_cast<uint64_t*>(bt + Plan::BT + Plan::XB + Plan::ROWS);
  uint64_t* empty = full + NS;          // [NS]: the consumers are done with a stage
  uint64_t* own_full = empty + NS;      // the own chunk landed
  uint64_t* own_empty = own_full + 1;   // the consumers are done with it (m > 1)
  const int C = cluster_blocks(d / kChunk), m = d / kChunk / C;
  const QueryBlock b(geo, C);  // b.c: the block's rank in the cluster
  const int sb = geo.sb, q0 = b.qt * T;
  const DqWalk walk(geo, b.r, q0, T, TS);
  const int tiles = m * walk.total;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    mbar_init(own_full, 1);
    mbar_init(own_empty, kConsumers);
    fence_mbar_init();
  }
  __syncthreads();

  // unit n's chunk: the pass's output chunk comes last
  auto chunk_of = [&](int n) {
    const int nt = n / m, pass = nt / walk.total;
    return b.c * m + (pass + 1 + n % m) % m;
  };
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    const int zq = (int)(b.row0 / sb);
    produce<NS, NS - 2>(tiles, m, full, empty, own_full, own_empty,
                    [&](int n) {
                      const int col = chunk_of(n) * kChunk;
                      mbar_expect_tx(own_full, Plan::OWN);
                      for (int cb = 0; cb < 4; ++cb)
                        tma_load_3d(own + cb * T * 128, &mq, own_full, col + 32 * cb, q0, zq);
                    },
                    [&](int n, int s) {
                      int arr, kt;
                      walk.at(n / m % walk.total, arr, kt);
                      const int col = chunk_of(n) * kChunk, z = b.kv_plane(geo, arr), y = kt * TS;
                      const bool last = n % m == m - 1;
                      uint8_t* st = stage + s * Plan::STAGE;
                      mbar_expect_tx(full + s, last ? Plan::STAGE : HALF);
                      for (int cb = 0; cb < 4; ++cb) {
                        tma_load_3d(st + cb * TS * 128, &mk, full + s, col + 32 * cb, y, z);
                        if (last)
                          tma_load_3d(st + HALF + cb * TS * 128, &mv, full + s, col + 32 * cb, y,
                                      z);
                      }
                    });
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128, w = t / 32, g4 = (t % 32) / 4,
              t4 = t % 4;
    const uint32_t bh = smem_addr(bt), bl = bh + T * TS * 4;
    const float scale2 = geo.scale * kLog2e;
    float* mx_of = rows;            // [2][T]: each warpgroup's row maxima (at a pass's end, l)
    float* sum_of = rows + 2 * T;   // [2][T]: each warpgroup's row sums
    float* alpha_of = rows + 4 * T;  // [T]: the tile's rescale of each row
    float acc[32];
    // O_c^T (this warpgroup's 64 columns) = O_c^T alpha + V_c^T P^T for the
    // tile in stage s (P in the B tiles, its alpha by row in alpha_of), then
    // the stage is free; acc[4 j + 2 ii + c] is O_c^T[64 wg + 16 w + g4 +
    // 8 ii][q 8 j + 2 t4 + c]
    auto output = [&](int s) {
      float f[32];
      output_half<TS>(f, stage + s * Plan::STAGE + HALF, 64 * wg, bh, bl, w, g4, t4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 a = *reinterpret_cast<const float2*>(alpha_of + 8 * j + 2 * t4);
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int e = 4 * j + 2 * ii;
          acc[e] = acc[e] * a.x + f[e];
          acc[e + 1] = acc[e + 1] * a.y + f[e + 1];
        }
      }
      mbar_arrive(empty + s);
    };
    for (int pass = 0; pass < m; ++pass) {
      float mr[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      int pending = -1;  // the stage of the tile whose output product is still to run
      for (int i = 0; i < walk.total; ++i) {
        const int nt = pass * walk.total + i;
        float sv[8], hv[16];
        int s = 0;
        for (int u = 0; u < m; ++u) {
          const int n = nt * m + u;
          s = n % NS;
          if (m > 1 || n == 0) mbar_wait(own_full, m > 1 ? n & 1 : 0);
          mbar_wait(full + s, (n / NS) & 1);
          const uint8_t* st = stage + s * Plan::STAGE;
          named_sync(2 + wg, 128);  // the warpgroup's last reads of its lo blocks are done
          write_lo<TS, 2>(lo, st, 2 * wg, t);
          fence_async_shared();
          named_sync(2 + wg, 128);
          float f[16];
          partial_blocks<T, TS, 2>(f, own, smem_addr(st), smem_addr(lo), 2 * wg, w, g4, t4);
#pragma unroll
          for (int e = 0; e < 16; ++e) hv[e] = u == 0 ? f[e] : hv[e] + f[e];
          if (m > 1) mbar_arrive(own_empty);
          if (u < m - 1) mbar_arrive(empty + s);
        }
        // the block's partial: warpgroup 0 adds warpgroup 1's half to its
        // own and stores float4 j of each thread (S columns 8 j ..) where the
        // thread of warpgroup j / 2 that folds them reads it; the last tile's
        // output product while the cluster's blocks arrive; then the C
        // partials
        float* slot = part + (nt & 1) * (T * TS);
        if (wg == 1) store_partial<4>(xbuf, hv, t);
        named_sync(1, kConsumers);
        if (wg == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float4 x = reinterpret_cast<const float4*>(xbuf)[j * 128 + t];
            x = make_float4(hv[4 * j] + x.x, hv[4 * j + 1] + x.y, hv[4 * j + 2] + x.z,
                            hv[4 * j + 3] + x.w);
            reinterpret_cast<float4*>(slot)[(j / 2) * 256 + (j % 2) * 128 + t] = x;
          }
        }
        cluster_arrive();
        if (pending >= 0) output(pending);
        cluster_wait();
        sum_partials<2>(sv, slot, wg * 256 + t, C);

        // the fold: entry e = 4 j + 2 ii + c is S[row 16 w + g4 + 8 ii][column
        // 16 wg + 8 j + 2 t4 + c]; the row maxima and sums of the two
        // warpgroups meet in shared memory (the first barrier also ends both
        // warpgroups' reads of P and alpha_of for the last tile)
        int arr, kt;
        walk.at(i, arr, kt);
        const int kj0 = kt * TS + 16 * wg + 2 * t4;
        const bool diag = geo.causal && arr == 0;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ii = (e >> 1) & 1, qi = q0 + 16 * w + g4 + 8 * ii;
          const int kj = kj0 + 8 * (e >> 2) + (e & 1);
          float x = sv[e] * scale2;
          if (kj >= sb) x = -INFINITY;            // past the block's rows
          else if (diag && kj > qi) x = kMasked;  // _causal_mask
          sv[e] = x;
          mx[ii] = fmaxf(mx[ii], x);
        }
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 1));
          mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 2));
          if (t4 == 0) mx_of[wg * T + 16 * w + g4 + 8 * ii] = mx[ii];
        }
        named_sync(1, kConsumers);
        float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int row = 16 * w + g4 + 8 * ii;
          const float m_new = fmaxf(mr[ii], fmaxf(mx_of[row], mx_of[T + row]));
          alpha[ii] = exp2f(mr[ii] - m_new);  // 0 on the first tile (m = -inf)
          mr[ii] = m_new;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float p = exp2f(sv[e] - mr[(e >> 1) & 1]);
          sv[e] = p;
          sum[(e >> 1) & 1] += p;
        }
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int row = 16 * w + g4 + 8 * ii;
          sum[ii] += __shfl_xor_sync(0xffffffffu, sum[ii], 1);
          sum[ii] += __shfl_xor_sync(0xffffffffu, sum[ii], 2);
          if (t4 == 0) {
            sum_of[wg * T + row] = sum[ii];
            if (wg == 0) alpha_of[row] = alpha[ii];
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
            put_split2<T>(bt, bt + T * TS * 4, row, 16 * wg + 8 * j + 2 * t4, sv[4 * j + 2 * ii],
                          sv[4 * j + 2 * ii + 1]);
        }
        fence_async_shared();
        named_sync(1, kConsumers);
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int row = 16 * w + g4 + 8 * ii;
          l[ii] = l[ii] * alpha[ii] + (sum_of[row] + sum_of[T + row]);
        }
        // at m > 1 the next tile's units would wait for this stage: no deferral
        if (m == 1 && i < walk.total - 1) {
          pending = s;
        } else {
          output(s);
        }
      }
      // the pass's chunk is whole: l through shared memory (every reader of
      // the row maxima has passed the last tile's second barrier), o / l
      if (t4 == 0 && wg == 0) {
        mx_of[16 * w + g4] = l[0];
        mx_of[16 * w + g4 + 8] = l[1];
      }
      named_sync(1, kConsumers);
      const int chunk = b.c * m + pass;
      if (chunk == 0 && wg == 0 && t4 == 0) {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int qi = q0 + 16 * w + g4 + 8 * ii;
          if (qi < sb) lse[b.row0 + qi] = mr[ii] * kLn2 + logf(l[ii]);
        }
      }
      const int col0 = chunk * kChunk + 64 * wg + 16 * w + g4;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int row = 8 * j + 2 * t4 + c;
          if (q0 + row >= sb) continue;
          const float li = mx_of[row];
          float* o = out + (b.row0 + q0 + row) * d + col0;
          o[0] = acc[4 * j + c] / li;
          o[8] = acc[4 * j + 2 + c] / li;
        }
    }
    cluster_sync();  // no block leaves while a peer may read its partials
  }
}

}  // namespace

// q [P, Hq, Sb, d], k/v [P, Hkv, Sb, d] (dtype: 0 float32, 1 bfloat16);
// out like q; lse [P, Hq, Sb] float32; groups [ngroups, g] int32; d a
// multiple of 128 above 256.  Every pointer 16-byte aligned.  Returns the
// launch's cudaError_t (0 on success), or a refusal code of
// ring_attention.cuh.
extern "C" int attn_fwd_wide(const void* q, const void* k, const void* v, void* out,
                             void* lse, const void* groups, int ngroups, int g, int hq,
                             int hkv, int sb, int d, float scale, int causal, int dtype,
                             void* stream) {
  if (d <= 256 || d % kChunk) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geo geo = make_geo(groups, g, hq, hkv, sb, scale, causal);
  float* L = static_cast<float*>(lse);
  const int C = cluster_blocks(d / kChunk);
  const int planes = ngroups * g;
  CUtensorMap maps[3];
  if (dtype == 1) {
    using Plan = WideFwdBf16Plan;
    int err = bf16_map(&maps[0], q, d, sb, planes * hq, Plan::T);
    if (!err) err = bf16_map(&maps[1], k, d, sb, planes * hkv, Plan::T);
    if (!err) err = bf16_map(&maps[2], v, d, sb, planes * hkv, Plan::T);
    if (err) return err;
    const dim3 grid((sb + Plan::T - 1) / Plan::T * C, hq, planes);
    return launch_cluster<Plan>(attn_fwd_wide_bf16, grid, Plan::THREADS, C, s, maps[0], maps[1],
                                maps[2], static_cast<bf16*>(out), L, geo, d);
  }
  if (dtype == 0) {
    using Plan = WideFwdF32Plan;
    int err = f32_map(&maps[0], q, d, sb, planes * hq, Plan::T);
    if (!err) err = f32_map(&maps[1], k, d, sb, planes * hkv, Plan::TS);
    if (!err) err = f32_map(&maps[2], v, d, sb, planes * hkv, Plan::TS);
    if (err) return err;
    const dim3 grid((sb + Plan::T - 1) / Plan::T * C, hq, planes);
    return launch_cluster<Plan>(attn_fwd_wide_f32, grid, kClusterThreads, C, s, maps[0], maps[1],
                                maps[2], static_cast<float*>(out), L, geo, d);
  }
  return kBadShape;
}
