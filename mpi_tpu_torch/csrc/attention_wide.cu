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
// thread has.  Here d is cut into 128-column chunks:
//   - O is cut across blocks: a block owns one 128-column chunk c of its
//     rows' output, so its accumulator is one m64n128 (64 registers a
//     thread) at every d;
//   - S = Q K^T sums over d-chunks (128 columns in bf16, 32 in float32):
//     for each K/V tile the block streams the Q and K chunks of every
//     d-chunk through shared memory (a ring of NS stages, one chunk pair a
//     stage), so shared memory does not grow with d;
//   - then the block folds S into its softmax state and adds P V_c, V_c the
//     tile's chunk c of V, staged with the tile's first chunk pair (two
//     buffers, by the tile's parity).
// Every block of a row recomputes the same S and the same softmax state, in
// the same order, so all chunks of a row divide by the same l; the lse is
// written by the blocks of chunk 0 only.  Numerics as attention.cu: S, m,
// l, o and P float32; bf16 Q K^T one bf16 product (exact in float32), P V
// with P split hi/lo, two; float32 products split TF32 (mma_3xtf32).
//
// The unit pipeline (the backward's too).  A block's work is a sequence of
// units u = (tile i, d-chunk dc), dc fastest.  The prologue issues units 0
// .. NS-2, one cp.async group each.  Unit u waits until at most NS-2
// groups are pending (its own group has landed), then a barrier, then it
// issues unit u + NS - 1 into the stage of unit u - 1 (read before the
// barrier) and commits a group even when there is none left to issue (the
// count of pending groups stays exact).  A tile's operand of the output
// product is issued with its unit (i, 0) into buffer i % 2, whose last
// reader was the tile i - 2 at unit (i - 1) nd - 1: before the issue at
// unit i nd - NS + 1 whenever NS < nd + 2 (nd the units of a tile), which
// every plan here keeps at d >= 384.
//
// What bounds it.  The reference's work is 4d flops an unmasked score
// entry; this form recomputes Q K^T once per output chunk, d / 128 times:
// bf16 2d (d / 128) + 2 x 2d (P V split) per entry, float32 3 x (2d (d /
// 128) + 2d) at the TF32 rate.  At d = 512 that is 3 times the bf16 bound
// and 2.5 times the float32 one (counted at a third of the TF32 rate): the
// design floor chip_smoke.py counts.  At long sequences it is bound by
// arithmetic, as attention.cu.
//
// Layout.  Both dtypes keep a block at 64 Q rows and under half of an SM's
// shared memory, so two blocks share an SM and each hides the other's waits
// (plans of one block an SM, with W = 2 warpgroups or 64-column float32
// chunks and NS = 3 stages, ran longer on the card at d = 512).
//   bf16 (one warpgroup, W = 1; NS = 2): a stage holds a Q and a K chunk,
//   64 x 128 bf16 tiles in the 128-byte swizzle; S accumulates m64n64k16
//   wgmmas over the chunks (chunk_product, ring_attention.cuh); P's
//   fragment, split hi/lo, is the A operand of m64n128k16 wgmmas whose B is
//   the V_c tile read MN-major.  Shared memory 1 KB alignment + (2 (W + 1)
//   + 2) tiles = 99 328 bytes.
//   float32 (four warps of 16 Q rows, 64-row K tiles, 32-column product
//   chunks, NS = 2): a stage holds a Q and a K chunk of row stride 36
//   (conflict-free fragment reads), V_c 64 x 128 at row stride 132;
//   2 x 2 x 64 x 36 x 4 + 2 x 64 x 132 x 4 = 104 448 bytes.  P's accumulator
//   is the A operand of P V with its k index permuted, as in attention.cu.

#include <math.h>

#include "ring_attention.cuh"

namespace {

struct WideFwdBf16Plan {
  static constexpr int W = 1, T = 64, TILE = T * 128 * 2, THREADS = 128 * W, NS = 2;
  static constexpr int SMEM = 1024 + (NS * (W + 1) + 2) * TILE;
};
struct WideFwdF32Plan {
  static constexpr int T = 64, KC = 32, LDC = KC + 4, LDO = 128 + 4, THREADS = 128, NS = 2;
  static constexpr int SMEM = (NS * 2 * T * LDC + 2 * T * LDO) * 4;
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

// ------------------------------------------------------------------- bf16
__global__ void __launch_bounds__(WideFwdBf16Plan::THREADS)
attn_fwd_wide_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out,
                   float* __restrict__ lse, Geo geo, int d) {
  using Plan = WideFwdBf16Plan;
  constexpr int T = Plan::T, TILE = Plan::TILE, W = Plan::W, NT = Plan::THREADS, NS = Plan::NS;
  constexpr int STAGE = (W + 1) * TILE;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // unit u: W Q chunks, then the K chunk, at St + (u % NS) STAGE
  uint8_t* St = align1024(smem_raw);
  uint8_t* Vs = St + NS * STAGE;      // tile i's V_c at Vs + (i % 2) TILE
  const int nd = d / kChunk;
  const QueryBlock b(geo, nd);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int g4 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int sb = geo.sb, q0 = b.qt * W * T;
  const int qi0 = q0 + T * wg + 16 * warp + g4;
  const float scale2 = geo.scale * kLog2e;
  const DqWalk walk(geo, b.r, q0, W * T, T);
  const int units = walk.total * nd;

  auto fetch = [&](int u) {
    const int i = u / nd, dc = u % nd;
    int arr, kt;
    walk.at(i, arr, kt);
    const long long kv = b.kv_row(geo, arr, kt, T);
    uint8_t* s = St + (u % NS) * STAGE;
#pragma unroll
    for (int w = 0; w < W; ++w)
      stage_bf16_cols<T, kChunk, NT>(s + w * TILE, q + (b.row0 + q0 + w * T) * d + dc * kChunk,
                                     d, sb - q0 - w * T);
    stage_bf16_cols<T, kChunk, NT>(s + W * TILE, k + kv * d + dc * kChunk, d, sb - kt * T);
    if (dc == 0)
      stage_bf16_cols<T, kChunk, NT>(Vs + (i & 1) * TILE, v + kv * d + b.c * kChunk, d,
                                     sb - kt * T);
  };
  for (int u = 0; u < NS - 1; ++u) {
    if (u < units) fetch(u);
    cp_async_commit();
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  float s[8][4];
  float(&sf)[32] = reinterpret_cast<float(&)[32]>(s);
  for (int u = 0; u < units; ++u) {
    cp_async_wait<NS - 2>();
    fence_async_shared();
    __syncthreads();
    if (u + NS - 1 < units) fetch(u + NS - 1);
    cp_async_commit();
    const int i = u / nd, dc = u % nd;
    const uint32_t qa = smem_addr(St + (u % NS) * STAGE + wg * TILE);
    const uint32_t ka = smem_addr(St + (u % NS) * STAGE + W * TILE);

    chunk_product(sf, qa, ka, dc == 0);  // S += Q_dc K_dc^T
    if (dc < nd - 1) continue;

    // the tile's S is whole: fold it, then O_c += P V_c
    int arr, kt;
    walk.at(i, arr, kt);
    float alpha[2];
    fold_scores(s, m, l, alpha, qi0, kt * T + 2 * t4, sb, geo.causal && arr == 0, scale2);
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] *= alpha[(e >> 1) & 1];
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_frag(sf, kk, ph[kk], pl[kk]);
    const uint32_t va = smem_addr(Vs + (i & 1) * TILE);
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
  }

  float o[16][4];
#pragma unroll
  for (int e = 0; e < 64; ++e) o[e / 4][e % 4] = acc[e];
  write_chunk(o, m, l, out, lse, b.row0, qi0, sb, t4, d, b.c * kChunk, b.c == 0);
}

// ---------------------------------------------------------------- float32
__global__ void __launch_bounds__(WideFwdF32Plan::THREADS)
attn_fwd_wide_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, Geo geo, int d) {
  using Plan = WideFwdF32Plan;
  constexpr int T = Plan::T, KC = Plan::KC, LDC = Plan::LDC, LDO = Plan::LDO;
  constexpr int NT = Plan::THREADS, NS = Plan::NS, STAGE = 2 * T * LDC;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // unit u: the Q chunk, then the K chunk, at St + (u % NS) STAGE
  float* St = reinterpret_cast<float*>(smem_raw);
  float* Vs = St + NS * STAGE;                     // tile i's V_c at Vs + (i % 2) T LDO
  const int nd = d / kChunk, nk = d / KC;
  const QueryBlock b(geo, nd);
  const int warp = threadIdx.x / 32, g4 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int sb = geo.sb, q0 = b.qt * T;
  const int qi0 = q0 + 16 * warp + g4;
  const float scale2 = geo.scale * kLog2e;
  const DqWalk walk(geo, b.r, q0, T, T);
  const int units = walk.total * nk;

  auto fetch = [&](int u) {
    const int i = u / nk, dc = u % nk;
    int arr, kt;
    walk.at(i, arr, kt);
    const long long kv = b.kv_row(geo, arr, kt, T);
    float* s = St + (u % NS) * STAGE;
    stage_f32_cols<T, KC, NT>(s, q + (b.row0 + q0) * d + dc * KC, d, sb - q0);
    stage_f32_cols<T, KC, NT>(s + T * LDC, k + kv * d + dc * KC, d, sb - kt * T);
    if (dc == 0)
      stage_f32_cols<T, kChunk, NT>(Vs + (i & 1) * T * LDO, v + kv * d + b.c * kChunk, d,
                                    sb - kt * T);
  };
  for (int u = 0; u < NS - 1; ++u) {
    if (u < units) fetch(u);
    cp_async_commit();
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[16][4], s[8][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int u = 0; u < units; ++u) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (u + NS - 1 < units) fetch(u + NS - 1);
    cp_async_commit();
    const int i = u / nk, dc = u % nk;
    const float* Qw = St + (u % NS) * STAGE + 16 * warp * LDC;
    const float* Ks = St + (u % NS) * STAGE + T * LDC;

    // S += Q_dc K_dc^T (rows: this warp's 16 q, columns: 64 k)
    if (dc == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
#pragma unroll 2
    for (int ks = 0; ks < KC / 8; ++ks) {
      const int c0 = 8 * ks + t4;
      Tf32x2 qa[4];
      frag_rows(Qw, LDC, g4, c0, qa);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float* kr = Ks + (8 * n + g4) * LDC + c0;
        mma_3xtf32(s[n], qa, split(kr[0]), split(kr[4]));
      }
    }
    if (dc < nk - 1) continue;

    // the tile's S is whole: fold it, then O_c += P V_c over its 64 k rows
    int arr, kt;
    walk.at(i, arr, kt);
    float alpha[2];
    fold_scores(s, m, l, alpha, qi0, kt * T + 2 * t4, sb, geo.causal && arr == 0, scale2);
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    const float* Vt = Vs + (i & 1) * T * LDO;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      Tf32x2 pa[4];
      frag_acc(s[kk], pa);
      const float* vr = Vt + (8 * kk + 2 * t4) * LDO + g4;
#pragma unroll
      for (int n = 0; n < 16; ++n)
        mma_3xtf32(acc[n], pa, split(vr[8 * n]), split(vr[LDO + 8 * n]));
    }
  }
  write_chunk(acc, m, l, out, lse, b.row0, qi0, sb, t4, d, b.c * kChunk, b.c == 0);
}

}  // namespace

// q [P, Hq, Sb, d], k/v [P, Hkv, Sb, d] (dtype: 0 float32, 1 bfloat16);
// out like q; lse [P, Hq, Sb] float32; groups [ngroups, g] int32; d a
// multiple of 128 above 256.  Every pointer 16-byte aligned.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int attn_fwd_wide(const void* q, const void* k, const void* v, void* out,
                             void* lse, const void* groups, int ngroups, int g, int hq,
                             int hkv, int sb, int d, float scale, int causal, int dtype,
                             void* stream) {
  if (d <= 256 || d % kChunk) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geo geo = make_geo(groups, g, hq, hkv, sb, scale, causal);
  float* L = static_cast<float*>(lse);
  const int nd = d / kChunk;
  if (dtype == 1) {
    using Plan = WideFwdBf16Plan;
    int err = set_smem(attn_fwd_wide_bf16, Plan::SMEM);
    if (err) return err;
    const int rows = Plan::W * Plan::T;
    dim3 grid((sb + rows - 1) / rows * nd, hq, ngroups * g);
    attn_fwd_wide_bf16<<<grid, Plan::THREADS, Plan::SMEM, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), L, geo, d);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    using Plan = WideFwdF32Plan;
    int err = set_smem(attn_fwd_wide_f32, Plan::SMEM);
    if (err) return err;
    dim3 grid((sb + Plan::T - 1) / Plan::T * nd, hq, ngroups * g);
    attn_fwd_wide_f32<<<grid, Plan::THREADS, Plan::SMEM, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), L, geo, d);
    return (int)cudaGetLastError();
  }
  return kBadShape;
}
