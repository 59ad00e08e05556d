// What the ring-attention forward (attention.cu) and backward
// (attention_bwd.cu) share: the geometry of a launch, the ring-order walk
// of a query tile over the K/V tiles, cp.async staging of bf16 (swizzled)
// and float32 (padded) tiles, and the float32 fragment helpers of the TF32
// products.  The backward runs one warpgroup (or four warps) per block, the
// forward several; the staging loops take the block's thread count.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kThreads = 128;  // one warpgroup, or four warps

struct Geo {
  const int* groups;  // [ngroups, g] world ranks in ring order
  int g, hq, hkv, sb;
  float scale;
  int causal;
};

// a block of rank r and q-tile [q0, q0 + qrows) (the forward, attn_bwd_dq):
// arrivals a = 0, 1, ... (block (r - a) mod g; under causal only blocks
// <= r), then k-tiles of `rows` rows (on the diagonal up to the one holding
// the tile's last row)
struct DqWalk {
  int nk, first, total;
  __device__ DqWalk(const Geo& geo, int r, int q0, int qrows, int rows) {
    nk = (geo.sb + rows - 1) / rows;
    first = geo.causal ? min(nk, (q0 + qrows - 1) / rows + 1) : nk;
    total = first + ((geo.causal ? r + 1 : geo.g) - 1) * nk;
  }
  __device__ void at(int i, int& arr, int& kt) const {
    if (i < first) {
      arr = 0; kt = i;
      return;
    }
    i -= first;
    arr = 1 + i / nk; kt = i % nk;
  }
};

// -- staging ------------------------------------------------------------------
// rows [0, R) of a row-major [*, D] bf16 block into a swizzled tile, zeros
// beyond `valid` rows (NT threads copy)
template <int R, int D, int NT = kThreads>
__device__ __forceinline__ void stage_bf16(uint8_t* dst, const bf16* src, int valid) {
  constexpr int C = D / 8;
  for (int idx = threadIdx.x; idx < R * C; idx += NT) {
    const int r = idx / C, c = (idx % C) * 8;
    const bool ok = r < valid;
    cp_async16(dst + sw128_offset(r, c, R), ok ? src + (long long)r * D + c : src, ok);
  }
}
// rows [0, R) of a row-major [*, D] float32 block into a tile of row stride
// D + 4, zeros beyond `valid` rows (NT threads copy)
template <int R, int D, int NT = kThreads>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int valid) {
  constexpr int C = D / 4;
  for (int idx = threadIdx.x; idx < R * C; idx += NT) {
    const int r = idx / C, c = (idx % C) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * (D + 4) + c, ok ? src + (long long)r * D + c : src, ok);
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// -- float32 fragments of m16n8k8 -------------------------------------------------
// A fragment of a 16-row strip (rows 16w.., columns c0 and c0 + 4), split
__device__ __forceinline__ void frag_rows(const float* strip, int ld, int g4, int c0,
                                          Tf32x2 (&a)[4]) {
  a[0] = split(strip[g4 * ld + c0]);
  a[1] = split(strip[(g4 + 8) * ld + c0]);
  a[2] = split(strip[g4 * ld + c0 + 4]);
  a[3] = split(strip[(g4 + 8) * ld + c0 + 4]);
}
// an m16n8 accumulator as the A operand of the next product, k permuted
// (k = t <-> column 2t, k = t + 4 <-> column 2t + 1), split
__device__ __forceinline__ void frag_acc(const float (&c)[4], Tf32x2 (&a)[4]) {
  a[0] = split(c[0]);
  a[1] = split(c[2]);
  a[2] = split(c[1]);
  a[3] = split(c[3]);
}

// -- launches -------------------------------------------------------------------
template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

Geo make_geo(const void* groups, int g, int hq, int hkv, int sb, float scale, int causal) {
  Geo geo;
  geo.groups = static_cast<const int*>(groups);
  geo.g = g; geo.hq = hq; geo.hkv = hkv; geo.sb = sb;
  geo.scale = scale; geo.causal = causal;
  return geo;
}

constexpr int kBadShape = 1000;  // a head dim or dtype the kernels were not built for

}  // namespace
