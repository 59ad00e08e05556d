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
// Both dtypes: a thread-block cluster forms S and dP once a tile.  The C
// blocks of a cluster (WideCluster, ring_attention.cuh: C the largest
// divisor of d / 128 that is at most 8) are the chunks of one (rank, head,
// own 64-row tile); block c owns output chunks c m .. c m + m - 1 (m = d /
// 128 / C: 1 at every d <= 1024), one a pass over its walk.  For each
// streamed tile of the other side (TS rows: 32 in float32, 64 in bf16),
// block c forms the partials S_c = Q_c K_c^T and dP_c = dO_c V_c^T
// (attn_bwd_dkv: S^T_c = K_c Q_c^T, dP^T_c = V_c dO_c^T) over its own m
// chunks only, writes them to its shared memory, and after
// one cluster barrier every block sums the C partials over distributed
// shared memory in rank order 0..C-1, so all blocks form bit-identical P
// and dS; the partials are double-buffered by tile parity, so one barrier a
// tile suffices.  The chunk-c operands of the output products are the tile
// the partials read, so a block loads each byte of its columns once a pass.
//   Copies: one thread of a producer warpgroup keeps TMA loads (3-D tensor
//   maps, rows past the block read as zeros, 128-byte swizzle) of the next
//   stage in flight, completing on mbarriers (produce, ring_attention.cuh);
//   two consumer warpgroups take the partials S and dP (S^T and dP^T), and
//   then the outputs (dQ: 64 columns of the chunk each; dK/dV: dV_c and
//   dK_c, one accumulator each); setmaxnreg gives the producers' registers
//   to the consumers.  No __syncthreads() after the set-up.  Every output
//   is a float32 running sum to which each tile adds its product, one chain
//   of tensor-core sums a tile long, by round-to-nearest float32 adds (the
//   tensor core's own sums round toward zero: over a block's whole walk
//   they drift, in bf16 past the allowance of one bf16 rounding).
//
// float32 (attn_bwd_dq_wide_f32, attn_bwd_dkv_wide_f32).
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
//   added by round-to-nearest float32 adds (hopper.cuh's TF32 note).
//   Shared memory (WideDqF32Plan, WideDkvF32Plan): 1 KB alignment, the own
//   tiles (2 x 64 x 128), NS = 2 stages of two 32 x 128 streamed tiles, their
//   lo tiles, the partials (2 parities x 2 x 64 x 32), the B tiles (dq: dS
//   hi and lo; dkv: P and dS, hi and lo), the mbarriers: 214 080 bytes (dq),
//   230 464 (dkv); one block of 384 threads an SM.
//   Bound: the reference's 6d (dq) and 8d (dkv) flops an entry, three TF32
//   products each: a design floor of 3 (4m + 2) d and 3 (4m + 4) d, the
//   bound at m = 1.
//
// bf16 (attn_bwd_dq_wide_bf16, attn_bwd_dkv_wide_bf16): the same clusters,
// producer and walks with bf16 products, as the bf16 forward
// (attention_wide.cu) forms them.
//   Products: a partial is chunk_product (ring_attention.cuh) over each of
//   the block's m chunks, 64-row tiles, m64n64k16 wgmmas with both tiles
//   read K-major (bf16 x bf16 products are exact in float32, so no split).
//   After the sum, P and dS (P^T and dS^T) are split into three bf16 terms,
//   hi, mid and lo (hopper.cuh's split3_bf16x2), in 64 x 64 A tiles, K-major
//   in the 128-byte swizzle, and the outputs are formed as they are
//   written, dQ_c += dS K_c, dV_c += P^T dO_c, dK_c += dS^T Q_c, with B the
//   chunk tile of the stage read MN-major: a tile's chain is its lo, mid and
//   hi products over its 64 rows.  The three terms are the entry itself;
//   two (hi and lo) leave up to 2^-17 of it, and where an output sums large
//   products of P or dS that cancel, that passed the absolute 1e-5 of the
//   float32 allowance (measured on an H100).
//   Shared memory (WideDqBf16Plan, WideDkvBf16Plan): 1 KB alignment, the
//   own tiles (2 x 64 x 128), NS = 2 stages of two 64 x 128 streamed tiles,
//   the partials (2 parities x 2 x 64 x 64 float32), the A tiles (dq: dS hi,
//   mid and lo; dkv: P and dS, hi, mid and lo), the mbarriers: 189 504
//   bytes (dq), 214 080 (dkv); one block of 384 threads an SM.
//   Bound: the reference's 6d (dq) and 8d (dkv) flops an entry; the design
//   floor (4m + 6) d and (4m + 12) d (the products with P and dS three
//   times), 1.67x and 2x the bound at m = 1.

#include <cooperative_groups.h>
#include <math.h>

#include "ring_attention.cuh"

namespace cg = cooperative_groups;

namespace {

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
// bf16: the same regions, with no lo tiles and, in BT, the A tiles of the
// outputs (64 x TS bf16: dS, hi, mid and lo; dK/dV: P and dS)
struct WideDqBf16Plan {
  static constexpr int T = 64, TS = 64, NS = 2, OWN = 2 * T * 128 * 2, STAGE = 2 * TS * 128 * 2,
      LO = 0, PART = 2 * 2 * T * TS * 4, BT = 3 * T * TS * 2, BARS = 64;
  static constexpr int SMEM = 1024 + OWN + NS * STAGE + LO + PART + BT + BARS;
};
struct WideDkvBf16Plan {
  static constexpr int T = 64, TS = 64, NS = 2, OWN = 2 * T * 128 * 2, STAGE = 2 * TS * 128 * 2,
      LO = 0, PART = 2 * 2 * T * TS * 4, BT = 6 * T * TS * 2, BARS = 64;
  static constexpr int SMEM = 1024 + OWN + NS * STAGE + LO + PART + BT + BARS;
};

// -------------------------------------------------- both dtypes' skeleton
// the regions of a block's shared memory (the plan's order)
template <typename Plan>
struct WideSmem {
  uint8_t* own;    // [2][T x 128]: own[wg] is warpgroup wg's A operand of the partials
  uint8_t* stage;  // NS x [2][TS x 128]: the streamed tiles of a unit
  uint8_t* lo;     // float32: [2][TS x 128], lo[wg] the lo of stage operand wg, written by warpgroup wg
  float* part;     // [tile parity][S, dP][q][thread 128][4]: a warpgroup's m64nTS partial
  uint8_t* bt;     // the outputs' operand tiles (float32: B, hi and lo; bf16: A, hi, mid and
                   // lo), x2 in dK/dV
  uint64_t* full;  // [NS]: a stage's TMA loads landed
  uint64_t* empty;     // [NS]: the consumers are done with a stage
  uint64_t* own_full;  // the own tiles landed
  uint64_t* own_empty;  // the consumers are done with them (m > 1: reloaded every unit)
  __device__ explicit WideSmem(uint8_t* raw) {
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
      mbar_init(empty + s, kConsumers);
    }
    mbar_init(own_full, 1);
    mbar_init(own_empty, kConsumers);
    fence_mbar_init();
  }
};

// The tile's S and dP entries of consumer thread (wg, t), NV float4s of
// each: float4s first .. first + NV - 1 of accumulator thread t (S at
// `part`, dP DP float4s after it; entry 4 h + l: row 16 w + g + 8 (l / 2),
// column 8 (first + h) + 2 t4 + l % 2), summed over the cluster's C
// partials in rank order
template <int NV, int DP>
__device__ __forceinline__ void cluster_sum(float (&s8)[4 * NV], float (&p8)[4 * NV],
                                            const float* part, int C, int first, int t) {
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int h = 0; h < NV; ++h) {
    const int at = (first + h) * 128 + t;
    float4 s, p;
    for (int r = 0; r < C; ++r) {
      const float4* peer = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(const_cast<float*>(part), r));
      const float4 a = peer[at], b = peer[DP + at];
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
__global__ void __launch_bounds__(kClusterThreads, 1)
attn_bwd_dq_wide_f32(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mo,
                     const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, Geo geo, int d) {
  using Plan = WideDqF32Plan;
  constexpr int T = Plan::T, TS = Plan::TS, NS = Plan::NS, HALF = Plan::STAGE / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const WideSmem<Plan> sm(smem_raw);
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
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
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
    setmaxnreg_inc<kConsumerRegs>();
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
        store_partial<4>(slot + wg * T * TS, part, t);
        cluster_sync();

        // P and dS of this thread's 8 entries, from the summed partials
        int arr, kt;
        walk.at(i, arr, kt);
        const int k0 = kt * TS;
        const bool diag = geo.causal && arr == 0;
        float s8[8], p8[8];
        cluster_sum<2, 512>(s8, p8, slot, C, 2 * wg, t);
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
        named_sync(1, kConsumers);

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
__global__ void __launch_bounds__(kClusterThreads, 1)
attn_bwd_dkv_wide_f32(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mo,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, Geo geo, int d) {
  using Plan = WideDkvF32Plan;
  constexpr int T = Plan::T, TS = Plan::TS, NS = Plan::NS, HALF = Plan::STAGE / 2;
  constexpr int BTILE = T * TS * 4;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const WideSmem<Plan> sm(smem_raw);
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
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
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
    setmaxnreg_inc<kConsumerRegs>();
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
        store_partial<4>(slot + wg * T * TS, part, t);
        cluster_sync();

        // P and dS (rows: k, columns: q) of this thread's 8 entries
        const bool diag = geo.causal && arr == 0;
        float s8[8], p8[8];
        cluster_sum<2, 512>(s8, p8, slot, C, 2 * wg, t);
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
        named_sync(1, kConsumers);

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

// ------------------------------------------------------------ bf16
// entries (row, col) and (row, col + 1) (col even) of a 64 x 64 A tile,
// bf16 in the 128-byte swizzle, as hi, mid and lo in the three tiles from
// `tiles` (ATILE bytes apart)
template <int ATILE>
__device__ __forceinline__ void put_bf16_split3(uint8_t* tiles, int row, int col, float x,
                                                float y) {
  const uint32_t off = sw128_offset(row, col, 64) + (col & 7) * 2;
  uint32_t h, m, l;
  split3_bf16x2(x, y, h, m, l);
  *reinterpret_cast<uint32_t*>(tiles + off) = h;
  *reinterpret_cast<uint32_t*>(tiles + ATILE + off) = m;
  *reinterpret_cast<uint32_t*>(tiles + 2 * ATILE + off) = l;
}

// ------------------------------------------------------------- bf16: dQ
// A cluster per (rank, query head, 64-row Q tile); own Q and dO, streamed
// K and V in 64-row tiles (DqWalk).  Partials: warpgroup 0 S, warpgroup 1
// dP; output: dQ_c += dS K_c, warpgroup wg the chunk's columns 64 wg ..
// 64 wg + 63.
__global__ void __launch_bounds__(kClusterThreads, 1)
attn_bwd_dq_wide_bf16(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mo,
                      const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dq, Geo geo, int d) {
  using Plan = WideDqBf16Plan;
  constexpr int T = Plan::T, TS = Plan::TS, NS = Plan::NS, HALF = Plan::STAGE / 2;
  constexpr int OWN1 = Plan::OWN / 2, ATILE = T * TS * 2;
  static_assert(T == 64 && TS == 64, "chunk_product reads 64-row tiles");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const WideSmem<Plan> sm(smem_raw);
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
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    const int zq = (int)(b.row0 / sb);
    produce<NS, 1>(tiles, m, sm.full, sm.empty, sm.own_full, sm.own_empty,
                   [&](int n) {
                     const int col = chunk_of(n) * kChunk;
                     mbar_expect_tx(sm.own_full, Plan::OWN);
                     for (int cb = 0; cb < 2; ++cb) {
                       tma_load_3d(sm.own + cb * T * 128, &mq, sm.own_full, col + 64 * cb, q0, zq);
                       tma_load_3d(sm.own + OWN1 + cb * T * 128, &mo, sm.own_full, col + 64 * cb, q0,
                                   zq);
                     }
                   },
                   [&](int n, int s) {
                     int arr, kt;
                     walk.at(n / m % walk.total, arr, kt);
                     const int col = chunk_of(n) * kChunk, z = b.kv_plane(geo, arr), y = kt * TS;
                     uint8_t* st = sm.stage + s * Plan::STAGE;
                     mbar_expect_tx(sm.full + s, Plan::STAGE);
                     for (int cb = 0; cb < 2; ++cb) {
                       tma_load_3d(st + cb * TS * 128, &mk, sm.full + s, col + 64 * cb, y, z);
                       tma_load_3d(st + HALF + cb * TS * 128, &mv, sm.full + s, col + 64 * cb, y, z);
                     }
                   });
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128, w = t / 32, g4 = (t % 32) / 4,
              t4 = t % 4;
    float L[2], Dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + 16 * w + g4 + 8 * i;
      L[i] = qi < sb ? lse[b.row0 + qi] : 0.f;
      Dl[i] = qi < sb ? delta[b.row0 + qi] : 0.f;
    }
    uint8_t* ds = sm.bt;  // dS: hi, mid, lo
    for (int pass = 0; pass < m; ++pass) {
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      for (int i = 0; i < walk.total; ++i) {
        const int nt = pass * walk.total + i;
        float part[32];
        int s = 0;
        for (int u = 0; u < m; ++u) {
          const int n = nt * m + u;
          s = n % NS;
          if (m > 1 || n == 0) mbar_wait(sm.own_full, m > 1 ? n & 1 : 0);
          mbar_wait(sm.full + s, (n / NS) & 1);
          // warpgroup 0: S += Q_u K_u^T; warpgroup 1: dP += dO_u V_u^T
          chunk_product(part, smem_addr(sm.own + wg * OWN1),
                        smem_addr(sm.stage + s * Plan::STAGE + wg * HALF), u == 0);
          if (m > 1) mbar_arrive(sm.own_empty);
          if (u < m - 1) mbar_arrive(sm.empty + s);
        }
        float* slot = sm.part + (nt & 1) * (2 * T * TS);
        store_partial<8>(slot + wg * T * TS, part, t);
        cluster_sync();

        // P and dS of this thread's 16 entries (columns 32 wg ..), from the
        // summed partials; dS into the A tiles
        int arr, kt;
        walk.at(i, arr, kt);
        const int k0 = kt * TS;
        const bool diag = geo.causal && arr == 0;
        float s16[16], p16[16];
        cluster_sum<4, T * TS / 4>(s16, p16, slot, C, 4 * wg, t);
#pragma unroll
        for (int h = 0; h < 4; ++h)
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            const int row = 16 * w + g4 + 8 * i2, col = 8 * (4 * wg + h) + 2 * t4;
            const int qi = q0 + row;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * h + 2 * i2 + c, kj = k0 + col + c;
              grad_entry(s16[e], p16[e], L[i2], Dl[i2], geo.scale,
                         kj >= sb || qi >= sb || (diag && kj > qi));
            }
            put_bf16_split3<ATILE>(ds, row, col, p16[4 * h + 2 * i2], p16[4 * h + 2 * i2 + 1]);
          }
        fence_async_shared();
        named_sync(1, kConsumers);

        // dQ_c (this warpgroup's 64 columns) += dS K_c: a chain a tile long
        // into f, then a float32 add
        const uint32_t kc = smem_addr(sm.stage + s * Plan::STAGE) + wg * TS * 128;
        const uint32_t ah = smem_addr(ds);
        float f[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) f[e] = 0.f;
        reg_fence(f);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TS / 16; ++kk) {
          const uint64_t bk = desc_mnmajor(kc + kk * 2048, TS);
          wgmma_m64n64k16_ss_tb(f, desc_kmajor(ah + 2 * ATILE + kk * 32), bk, kk > 0);
          wgmma_m64n64k16_ss_tb(f, desc_kmajor(ah + ATILE + kk * 32), bk, 1);
          wgmma_m64n64k16_ss_tb(f, desc_kmajor(ah + kk * 32), bk, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(f);
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] += f[e];
        mbar_arrive(sm.empty + s);
      }
      // acc[4j + 2i + c] = dQ[q0 + 16 w + g4 + 8i][chunk column 64 wg + 8j + 2 t4 + c]
      const int col0 = (b.c * m + pass) * kChunk + 64 * wg + 2 * t4;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = q0 + 16 * w + g4 + 8 * i;
        if (qi >= sb) continue;
        bf16* out = dq + (b.row0 + qi) * d + col0;
#pragma unroll
        for (int j = 0; j < 8; ++j) store2(out + 8 * j, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
    cluster_sync();  // no block leaves while a peer may read its partials
  }
}

// --------------------------------------------------------- bf16: dK, dV
// A cluster per (owner j, K/V head, 64-row K tile); own K and V, streamed
// Q and dO in 64-row tiles with their lse and delta (DkvWalk).  Partials:
// warpgroup 0 S^T, warpgroup 1 dP^T; outputs: warpgroup 0 dV_c += P^T dO_c,
// warpgroup 1 dK_c += dS^T Q_c, each the chunk's 128 columns.
__global__ void __launch_bounds__(kClusterThreads, 1)
attn_bwd_dkv_wide_bf16(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mo,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, Geo geo, int d) {
  using Plan = WideDkvBf16Plan;
  constexpr int T = Plan::T, TS = Plan::TS, NS = Plan::NS, HALF = Plan::STAGE / 2;
  constexpr int OWN1 = Plan::OWN / 2, ATILE = T * TS * 2;
  static_assert(T == 64 && TS == 64, "chunk_product reads 64-row tiles");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const WideSmem<Plan> sm(smem_raw);
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
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    const int zk = (int)(b.kv_row0 / sb);
    produce<NS, 1>(tiles, m, sm.full, sm.empty, sm.own_full, sm.own_empty,
                   [&](int n) {
                     const int col = chunk_of(n) * kChunk;
                     mbar_expect_tx(sm.own_full, Plan::OWN);
                     for (int cb = 0; cb < 2; ++cb) {
                       tma_load_3d(sm.own + cb * T * 128, &mk, sm.own_full, col + 64 * cb, k0, zk);
                       tma_load_3d(sm.own + OWN1 + cb * T * 128, &mv, sm.own_full, col + 64 * cb, k0,
                                   zk);
                     }
                   },
                   [&](int n, int s) {
                     int arr, ht, qt;
                     walk.at(n / m % walk.total, arr, ht, qt);
                     const int z = (int)(b.q_row(geo, arr, ht) / sb), y = qt * TS;
                     const int col = chunk_of(n) * kChunk;
                     uint8_t* st = sm.stage + s * Plan::STAGE;
                     mbar_expect_tx(sm.full + s, Plan::STAGE);
                     for (int cb = 0; cb < 2; ++cb) {
                       tma_load_3d(st + cb * TS * 128, &mq, sm.full + s, col + 64 * cb, y, z);
                       tma_load_3d(st + HALF + cb * TS * 128, &mo, sm.full + s, col + 64 * cb, y, z);
                     }
                   });
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128, w = t / 32, g4 = (t % 32) / 4,
              t4 = t % 4;
    // the A tiles: P (warpgroup 0's) and dS (warpgroup 1's), hi, mid, lo
    uint8_t* at = sm.bt;
    for (int pass = 0; pass < m; ++pass) {
      float acc[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      for (int i = 0; i < walk.total; ++i) {
        const int nt = pass * walk.total + i;
        int arr, ht, qt;
        walk.at(i, arr, ht, qt);
        const int q0 = qt * TS;
        const long long qrow = b.q_row(geo, arr, ht) + q0;
        // lse and delta of this thread's columns (q rows), fetched early
        float L[4][2], Dl[4][2];
#pragma unroll
        for (int h = 0; h < 4; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * (4 * wg + h) + 2 * t4 + c;
            const bool ok = q0 + col < sb;
            L[h][c] = ok ? lse[qrow + col] : 0.f;
            Dl[h][c] = ok ? delta[qrow + col] : 0.f;
          }
        float part[32];
        int s = 0;
        for (int u = 0; u < m; ++u) {
          const int n = nt * m + u;
          s = n % NS;
          if (m > 1 || n == 0) mbar_wait(sm.own_full, m > 1 ? n & 1 : 0);
          mbar_wait(sm.full + s, (n / NS) & 1);
          // warpgroup 0: S^T += K_u Q_u^T; warpgroup 1: dP^T += V_u dO_u^T
          chunk_product(part, smem_addr(sm.own + wg * OWN1),
                        smem_addr(sm.stage + s * Plan::STAGE + wg * HALF), u == 0);
          if (m > 1) mbar_arrive(sm.own_empty);
          if (u < m - 1) mbar_arrive(sm.empty + s);
        }
        float* slot = sm.part + (nt & 1) * (2 * T * TS);
        store_partial<8>(slot + wg * T * TS, part, t);
        cluster_sync();

        // P and dS (rows: k, columns: q) of this thread's 16 entries, into
        // the A tiles
        const bool diag = geo.causal && arr == 0;
        float s16[16], p16[16];
        cluster_sum<4, T * TS / 4>(s16, p16, slot, C, 4 * wg, t);
#pragma unroll
        for (int h = 0; h < 4; ++h)
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            const int row = 16 * w + g4 + 8 * i2, col = 8 * (4 * wg + h) + 2 * t4;
            const int kj = k0 + row;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * h + 2 * i2 + c, qi = q0 + col + c;
              grad_entry(s16[e], p16[e], L[h][c], Dl[h][c], geo.scale,
                         qi >= sb || (diag && kj > qi));
            }
            const int e = 4 * h + 2 * i2;
            put_bf16_split3<ATILE>(at, row, col, s16[e], s16[e + 1]);
            put_bf16_split3<ATILE>(at + 3 * ATILE, row, col, p16[e], p16[e + 1]);
          }
        fence_async_shared();
        named_sync(1, kConsumers);

        // warpgroup 0: dV_c += P^T dO_c; warpgroup 1: dK_c += dS^T Q_c: a
        // chain a tile long into f, then a float32 add
        const uint32_t bo = smem_addr(sm.stage + s * Plan::STAGE + (1 - wg) * HALF);
        const uint32_t ah = smem_addr(at + 3 * wg * ATILE);
        float f[64];
#pragma unroll
        for (int e = 0; e < 64; ++e) f[e] = 0.f;
        reg_fence(f);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TS / 16; ++kk) {
          const uint64_t bb = desc_mnmajor(bo + kk * 2048, TS);
          wgmma_m64n128k16_ss_tb(f, desc_kmajor(ah + 2 * ATILE + kk * 32), bb, kk > 0);
          wgmma_m64n128k16_ss_tb(f, desc_kmajor(ah + ATILE + kk * 32), bb, 1);
          wgmma_m64n128k16_ss_tb(f, desc_kmajor(ah + kk * 32), bb, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(f);
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] += f[e];
        mbar_arrive(sm.empty + s);
      }
      // acc[4j + 2i + c] = dX[k0 + 16 w + g4 + 8i][chunk column 8j + 2 t4 + c]
      bf16* out = wg == 0 ? dv : dk;
      const int col0 = (b.c * m + pass) * kChunk + 2 * t4;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 16 * w + g4 + 8 * i;
        if (k0 + row >= sb) continue;
        bf16* o = out + (kvrow + row) * d + col0;
#pragma unroll
        for (int j = 0; j < 16; ++j) store2(o + 8 * j, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
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
// the four tensor maps of a cluster form: own operands in boxes of T rows,
// streamed ones in boxes of TS
template <typename Plan>
int wide_maps(CUtensorMap (&maps)[4], int (*map)(CUtensorMap*, const void*, int, int, int, int),
              const void* own0, const void* own1, int own_heads, const void* str0,
              const void* str1, int str_heads, int nranks, int sb, int d) {
  int err = map(&maps[0], own0, d, sb, nranks * own_heads, Plan::T);
  if (!err) err = map(&maps[1], own1, d, sb, nranks * own_heads, Plan::T);
  if (!err) err = map(&maps[2], str0, d, sb, nranks * str_heads, Plan::TS);
  if (!err) err = map(&maps[3], str1, d, sb, nranks * str_heads, Plan::TS);
  return err;
}

// attn_bwd_dq_wide's kernel for element type E (float32 or bf16)
template <typename E, typename Plan>
int launch_dq(void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, const float*,
                             const float*, E*, Geo, int),
              int (*map)(CUtensorMap*, const void*, int, int, int, int), const void* q,
              const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, Geo geo, int ngroups, int d, cudaStream_t s) {
  CUtensorMap maps[4];
  const int err = wide_maps<Plan>(maps, map, q, dout, geo.hq, k, v, geo.hkv, ngroups * geo.g,
                                  geo.sb, d);
  if (err) return err;
  const int C = cluster_blocks(d / kChunk);
  const dim3 grid((geo.sb + Plan::T - 1) / Plan::T * C, geo.hq, ngroups * geo.g);
  return launch_cluster<Plan>(kernel, grid, kClusterThreads, C, s, maps[0], maps[1], maps[2],
                              maps[3], lse, delta, static_cast<E*>(dq), geo, d);
}

template <typename E, typename Plan>
int launch_dkv(void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, const float*,
                              const float*, E*, E*, Geo, int),
               int (*map)(CUtensorMap*, const void*, int, int, int, int), const void* q,
               const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, Geo geo, int ngroups, int d,
               cudaStream_t s) {
  CUtensorMap maps[4];
  const int err = wide_maps<Plan>(maps, map, k, v, geo.hkv, q, dout, geo.hq, ngroups * geo.g,
                                  geo.sb, d);
  if (err) return err;
  const int C = cluster_blocks(d / kChunk);
  const dim3 grid((geo.sb + Plan::T - 1) / Plan::T * C, geo.hkv, ngroups * geo.g);
  return launch_cluster<Plan>(kernel, grid, kClusterThreads, C, s, maps[0], maps[1], maps[2],
                              maps[3], lse, delta, static_cast<E*>(dk), static_cast<E*>(dv), geo,
                              d);
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
    return launch_dq<float, WideDqF32Plan>(attn_bwd_dq_wide_f32, f32_map, q, k, v, dout, L, Dl,
                                           dq, geo, ngroups, d, s);
  if (dtype == 1)
    return launch_dq<bf16, WideDqBf16Plan>(attn_bwd_dq_wide_bf16, bf16_map, q, k, v, dout, L, Dl,
                                           dq, geo, ngroups, d, s);
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
    return launch_dkv<float, WideDkvF32Plan>(attn_bwd_dkv_wide_f32, f32_map, q, k, v, dout, L,
                                             Dl, dk, dv, geo, ngroups, d, s);
  if (dtype == 1)
    return launch_dkv<bf16, WideDkvBf16Plan>(attn_bwd_dkv_wide_bf16, bf16_map, q, k, v, dout, L,
                                             Dl, dk, dv, geo, ngroups, d, s);
  return kBadShape;
}

// out (64 x 32 float32) = the probe's product of b (32 x 8 float32): rows 0-7
// hold b transposed as TF32 wgmma read its raw words
extern "C" int wgmma_tf32_probe(const void* b, void* out, void* stream) {
  wgmma_tf32_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
