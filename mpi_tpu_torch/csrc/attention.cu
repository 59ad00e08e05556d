// Ring attention over P virtual ranks held in one device memory: the
// forward (attn_fwd).  The backward is csrc/attention_bwd.cu.
//
// Replaces the Pallas TPU kernel _kernel (mpi_tpu/tpu/pallas_attention.py
// :367), launched by _kernel_call (:1059).
//
// What it computes.  Rank r (position r of a group of g ranks) holds
// Q [Hq, Sb, d] and K, V [Hkv, Sb, d]; on the TPU, arrival a = 0..g-1
// brings K/V block (r - a) mod g and is folded into the online-softmax
// state (m, l, o), all float32: S = (Q K^T) * scale, masked with -1e30 on
// the diagonal block under causal (later blocks are skipped), m' =
// max(m, rowmax S), l' = l e^(m-m') + rowsum e^(S-m'), o' = o e^(m-m') +
// e^(S-m') V; out = o / l, lse = m + log l.  Query head h reads K/V head
// h / (Hq / Hkv).  bf16 inputs are widened to float32 at the load (the
// reference upcasts at the product); outputs are rounded once at the end.
//
// What bounds it.  Each score entry costs 4d flops (two products), over
// every unmasked entry: at long sequences the work is far above the card's
// bytes-to-flops line, so it is bound by arithmetic.  The products run on
// the float32 FMA units (67 TFLOP/s).
//
// Design.  On one card all ranks' blocks share one memory, so no K/V
// block travels: a rank's thread block reads the blocks its ring would
// have delivered, in the order it would have delivered them.  The RDMA
// slots, credits and barriers of the TPU design have no counterpart.  One
// thread block of 256 threads (16 x 16) per (rank, head, tile of T rows),
// T = 64 at d = 128 and 32 at d = 256.  Tiles are staged in shared
// memory as float32 with a row stride of d + 4 floats, which keeps
// 16-byte loads aligned and spreads the rows a warp reads over the banks.
// Each thread owns a (T/16) x (T/16) piece of the score tile (rows
// ty + 16a, columns tx + 16b, so a row's 16 owners are one half-warp and
// reduce with shuffles) and (T/16) x (d/16) accumulators (columns
// 4 tx + 64 b + e, read as 16-byte vectors).  The softmax state of a row
// lives in registers.  Every block owns its outputs.  Tiles that causal
// masking empties are skipped: future blocks, and k-tiles above the
// diagonal.  This is the simple first form; the tensor-core design of the
// backward (hopper.cuh) is the next step for it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;  // pallas_attention.py:109

template <int D> struct Tile { static constexpr int T = D <= 128 ? 64 : 32; };

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// rows [0, T) of a row-major [*, D] block into shared memory (stride D+4),
// zero beyond the `valid` rows
template <typename E, int D, int T>
__device__ __forceinline__ void load_tile(float* dst, const E* src, int valid) {
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < T * C4; idx += kThreads) {
    const int r = idx / C4, c = (idx % C4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) v = load4(src + (long long)r * D + c);
    store4(dst + r * (D + 4) + c, v);
  }
}

__device__ __forceinline__ float4 fma4(float a, float4 b, float4 c) {
  return make_float4(fmaf(a, b.x, c.x), fmaf(a, b.y, c.y), fmaf(a, b.z, c.z),
                     fmaf(a, b.w, c.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// s[a][b] = A[ty+16a] . B[tx+16b] over D (A, B in shared memory)
template <int D, int RA>
__device__ __forceinline__ void tile_dot(float (&s)[RA][RA], const float* A,
                                         const float* B, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < RA; ++b) s[a][b] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D; kk += 4) {
    float4 x[RA], y[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) x[a] = load4(A + (ty + 16 * a) * (D + 4) + kk);
#pragma unroll
    for (int b = 0; b < RA; ++b) y[b] = load4(B + (tx + 16 * b) * (D + 4) + kk);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < RA; ++b) s[a][b] = dot4(x[a], y[b], s[a][b]);
  }
}

// acc[a][c] += sum_j W[ty+16a][j] * M[j][c] (W: T x (T+4), M: T x (D+4))
template <int D, int T, int RA, int NC>
__device__ __forceinline__ void tile_mul(float4 (&acc)[RA][NC], const float* W,
                                         const float* M, int ty, int tx) {
#pragma unroll 2
  for (int j = 0; j < T; j += 4) {
    float4 w[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) w[a] = load4(W + (ty + 16 * a) * (T + 4) + j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* row = M + (j + e) * (D + 4) + 4 * tx;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 m = load4(row + 64 * c);
#pragma unroll
        for (int a = 0; a < RA; ++a) {
          const float wv = e == 0 ? w[a].x : e == 1 ? w[a].y : e == 2 ? w[a].z : w[a].w;
          acc[a][c] = fma4(wv, m, acc[a][c]);
        }
      }
    }
  }
}

struct Geo {
  const int* groups;  // [ngroups, g] world ranks in ring order
  int g, hq, hkv, sb;
  float scale;
  int causal;
};

// ---------------------------------------------------------------- forward
template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                const E* __restrict__ v, E* __restrict__ out,
                float* __restrict__ lse, Geo geo) {
  constexpr int T = Tile<D>::T, RA = T / 16, NC = D / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + T * (D + 4);
  float* Vs = Ks + T * (D + 4);
  float* Ps = Vs + T * (D + 4);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int member = blockIdx.z, r = member % geo.g;
  const int* G = geo.groups + (member - r);
  const int w = G[r], h = blockIdx.y, kvh = h / (geo.hq / geo.hkv);
  const int sb = geo.sb, q0 = blockIdx.x * T;
  const long long plane = (long long)sb * D;

  load_tile<E, D, T>(Qs, q + ((long long)w * geo.hq + h) * plane + (long long)q0 * D,
                     sb - q0);
  float m[RA], l[RA];
  float4 acc[RA][NC];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int nk = (sb + T - 1) / T;
  for (int arr = 0; arr < geo.g; ++arr) {
    const int j = (r - arr + geo.g) % geo.g;
    if (geo.causal && j > r) continue;  // a future block: no contribution
    const bool diag = geo.causal && j == r;
    const long long kv_off = ((long long)G[j] * geo.hkv + kvh) * plane;
    const int nk_eff = diag ? min(nk, (int)blockIdx.x + 1) : nk;
    for (int kt = 0; kt < nk_eff; ++kt) {
      const int k0 = kt * T;
      __syncthreads();  // the previous tile's readers are done
      load_tile<E, D, T>(Ks, k + kv_off + (long long)k0 * D, sb - k0);
      load_tile<E, D, T>(Vs, v + kv_off + (long long)k0 * D, sb - k0);
      __syncthreads();
      float s[RA][RA];
      tile_dot<D, RA>(s, Qs, Ks, ty, tx);
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int qi = q0 + ty + 16 * a;
        float mx = -INFINITY;
#pragma unroll
        for (int b = 0; b < RA; ++b) {
          const int kj = k0 + tx + 16 * b;
          float x = s[a][b] * geo.scale;
          if (kj >= sb) x = -INFINITY;           // past the block's rows
          else if (diag && kj > qi) x = kMasked;  // _causal_mask
          s[a][b] = x;
          mx = fmaxf(mx, x);
        }
        const float m_new = fmaxf(m[a], half_warp_max(mx));
        const float alpha = expf(m[a] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int b = 0; b < RA; ++b) {
          const float p = expf(s[a][b] - m_new);
          Ps[(ty + 16 * a) * (T + 4) + tx + 16 * b] = p;
          sum += p;
        }
        l[a] = l[a] * alpha + half_warp_sum(sum);
        m[a] = m_new;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[a][c].x *= alpha; acc[a][c].y *= alpha;
          acc[a][c].z *= alpha; acc[a][c].w *= alpha;
        }
      }
      __syncthreads();
      tile_mul<D, T, RA, NC>(acc, Ps, Vs, ty, tx);
    }
  }
  const long long o_off = ((long long)w * geo.hq + h) * plane;
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi >= sb) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 o = acc[a][c];
      store4(out + o_off + (long long)qi * D + 4 * tx + 64 * c,
             make_float4(o.x / l[a], o.y / l[a], o.z / l[a], o.w / l[a]));
    }
    if (tx == 0)
      lse[((long long)w * geo.hq + h) * sb + qi] = m[a] + logf(l[a]);
  }
}

template <int D> constexpr int row_bytes() { return Tile<D>::T * (D + 4) * 4; }
template <int D> constexpr int score_bytes() {
  return Tile<D>::T * (Tile<D>::T + 4) * 4;
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
}

Geo make_geo(const void* groups, int g, int hq, int hkv, int sb, float scale,
             int causal) {
  Geo geo;
  geo.groups = static_cast<const int*>(groups);
  geo.g = g; geo.hq = hq; geo.hkv = hkv; geo.sb = sb;
  geo.scale = scale; geo.causal = causal;
  return geo;
}

template <typename E, int D>
int fwd(const void* q, const void* k, const void* v, void* out, float* lse, Geo geo,
        int ngroups, cudaStream_t s) {
  constexpr int T = Tile<D>::T;
  const int bytes = 3 * row_bytes<D>() + score_bytes<D>();
  int err = set_smem(attn_fwd_kernel<E, D>, bytes);
  if (err) return err;
  dim3 grid((geo.sb + T - 1) / T, geo.hq, ngroups * geo.g);
  attn_fwd_kernel<E, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<E*>(out), lse, geo);
  return (int)cudaGetLastError();
}

constexpr int kBadShape = 1000;  // a head dim or dtype the kernels were not built for

}  // namespace

// q [P, Hq, Sb, d], k/v [P, Hkv, Sb, d] (dtype: 0 float32, 1 bfloat16);
// out like q; lse [P, Hq, Sb] float32; groups [ngroups, g] int32.
// Returns the launch's cudaError_t (0 on success).
extern "C" int attn_fwd(const void* q, const void* k, const void* v, void* out,
                        void* lse, const void* groups, int ngroups, int g, int hq,
                        int hkv, int sb, int d, float scale, int causal, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geo geo = make_geo(groups, g, hq, hkv, sb, scale, causal);
  float* L = static_cast<float*>(lse);
  if (dtype == 0 && d == 128) return fwd<float, 128>(q, k, v, out, L, geo, ngroups, s);
  if (dtype == 0 && d == 256) return fwd<float, 256>(q, k, v, out, L, geo, ngroups, s);
  if (dtype == 1 && d == 128)
    return fwd<__nv_bfloat16, 128>(q, k, v, out, L, geo, ngroups, s);
  if (dtype == 1 && d == 256)
    return fwd<__nv_bfloat16, 256>(q, k, v, out, L, geo, ngroups, s);
  return kBadShape;
}
